"""Keras HDF5 and ``.keras`` import -> MultiLayerNetwork / ComputationGraph:
the port of ``deeplearning4j_tpu/imports/keras_import.py`` (the reference's
deeplearning4j-modelimport ``KerasModelImport.java`` and its per-layer
mapping classes, ``KerasDense``, ``KerasConvolution2D``,
``KerasBatchNormalization``, ...).

Scope, the reference's: Dense, Conv1D/2D/3D (+Separable/Depthwise/
Transpose), pooling (1D/2D/3D/global), Flatten (2D/3D feature maps and
static-length 1-D), Reshape/Permute (keras channels-last semantics),
Dropout (+Spatial/Gaussian/Alpha variants), GaussianNoise, Activation
(+parameterized classes), BatchNormalization, LayerNormalization,
MultiHeadAttention (self-attention), TimeDistributed (Dense and CNN inner
layers, incl. Flatten), LSTM/GRU/SimpleRNN, Bidirectional (both
return_sequences modes), Embedding, Upsampling/ZeroPadding/Cropping, and
the keras-3 ``.keras`` archive.  The port's own HDF5 reader
(``imports/hdf5.py``) reads the files, so neither h5py nor keras is
needed; weights are re-laid-out to this framework's conventions:

- Conv2D kernels: Keras HWIO -> OIHW.
- Dense after Flatten of a conv feature map: Keras flattens channels-last
  (h, w, c) while this framework flattens NCHW (c, h, w) -- kernel rows are
  permuted accordingly (the reference's KerasFlatten/preprocessor does the
  same reordering).
- LSTM kernels: Keras gate order (i, f, g, o) -> ours (i, f, o, g).

The nets are built on ``device`` (``cuda`` unless the caller asks for
another); the weights are copied onto it after the layout changes.  A
reference fault kept on purpose (ROADMAP C8): ``_KERAS2_SEMANTICS`` is
never set, so a keras-2 file's ``hard_sigmoid`` imports with keras 3's
meaning.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.imports import hdf5

__all__ = ["KerasModelImport"]


def _cfg(layer: Dict) -> Dict:
    return layer.get("config", {})


_ACT = {"relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
        "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
        "softplus": "softplus", "softsign": "softsign", "swish": "swish",
        "gelu": "gelu",
        "hard_silu": "hardswish", "hard_swish": "hardswish",
        "leaky_relu": "leakyrelu", "relu6": "relu6", "exponential": "exp"}

#: keras 2 defines hard_sigmoid as clip(0.2x+0.5) (the framework's native
#: "hardsigmoid"); keras 3 redefined it as relu6(x+3)/6.  Set per import
#: from the file's keras_version (h5 attr; ".keras" archives are keras 3).
_KERAS2_SEMANTICS = False


def _act(name: Optional[str]) -> str:
    if not name:
        return "identity"
    if name == "hard_sigmoid":
        return "hardsigmoid" if _KERAS2_SEMANTICS else "hardsigmoid6"
    return _ACT.get(name, name)


class _WeightStore:
    """Finds per-layer weight arrays in a Keras .h5 (tf.keras layout)."""

    def __init__(self, f):
        self.f = f
        root = f["model_weights"] if "model_weights" in f else f
        self.root = root

    def get(self, layer_name: str) -> List[np.ndarray]:
        if layer_name not in self.root:
            return []
        g = self.root[layer_name]
        names = g.attrs.get("weight_names")
        out = []
        if names is not None:
            for n in names:
                n = n.decode() if isinstance(n, bytes) else str(n)
                out.append(np.asarray(g[n]))
            return out
        # fallback: recursive in-order collect
        def visit(name, obj):
            if isinstance(obj, hdf5.Dataset):
                out.append(np.asarray(obj))
        g.visititems(visit)
        return out


def _to_snake_case(name: str) -> str:
    """keras.src.utils.naming.to_snake_case — checkpoint group names in the
    ``.keras`` weights file derive from CLASS names, not layer names."""
    import re
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    name = re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()
    return name


#: sub-layer visit order inside one checkpoint group, so collected arrays
#: line up with keras ``get_weights()`` order (alphabetical would put
#: backward before forward and key before query)
_V3_CHILD_ORDER = {"forward_layer": 0, "backward_layer": 1,
                   "query_dense": 0, "key_dense": 1, "value_dense": 2,
                   "output_dense": 3}


class _WeightStoreV3:
    """Weights from a keras-3 ``.keras`` archive (``model.weights.h5``).

    Checkpoint groups are STRUCTURE-based: ``snake_case(class_name)``
    uniquified by a per-name counter over the top-level layers in config
    order (``layers/dense``, ``layers/dense_1``, …) — layer NAMES do not
    appear, so the group map is reconstructed from the config."""

    def __init__(self, h5file, layers_cfg: List[Dict]):
        self.f = h5file
        self.root = h5file["layers"] if "layers" in h5file else h5file
        self._group: Dict[str, str] = {}
        counts: Dict[str, int] = {}
        for lk in layers_cfg:
            base = _to_snake_case(lk["class_name"])
            n = counts.get(base, 0)
            counts[base] = n + 1
            name = lk.get("config", {}).get("name", lk.get("name"))
            self._group[name] = base if n == 0 else f"{base}_{n}"
        if layers_cfg and len(self.root.keys()) \
                and not any(g in self.root for g in self._group.values()):
            raise ValueError(
                "Unrecognized .keras weights layout (keras-2-saved "
                "archives store by layer name; only keras-3 archives "
                "are supported — re-save with keras 3 or export h5)")

    def get(self, layer_name: str) -> List[np.ndarray]:
        g = self._group.get(layer_name)
        if g is None or g not in self.root:
            # v3 group names are deterministic; a missing group for a
            # weight-carrying layer means the layout was not produced by
            # keras 3 — importing with init weights would be silently wrong
            raise ValueError(
                f"Keras import: no checkpoint group {g!r} for layer "
                f"{layer_name!r} in the .keras weights file (keras-2-saved "
                "archive? re-save with keras 3 or export h5)")
        out: List[np.ndarray] = []

        def key(k):
            return (_V3_CHILD_ORDER.get(k, 50),
                    int(k) if k.isdigit() else -1, k)

        def collect(grp):
            for k in sorted(grp.keys(), key=key):
                if k == "seed_generator":   # RNG state, not a weight
                    continue
                obj = grp[k]
                if isinstance(obj, hdf5.Dataset):
                    out.append(np.asarray(obj))
                else:
                    collect(obj)
        collect(self.root[g])
        return out


#: class_name -> factory(cfg) -> our Layer (or (layer, kind, out_channels))
_CUSTOM_LAYERS: Dict[str, Any] = {}
#: keras layer NAME -> our Layer (Lambda layers carry no portable code)
_LAMBDA_LAYERS: Dict[str, Any] = {}


class KerasModelImport:
    """Reference facade: ``importKerasSequentialModelAndWeights`` /
    ``importKerasModelAndWeights`` over a keras ``.h5`` file or a keras-3
    ``.keras`` archive, building the net on ``device`` (``cuda`` unless
    the caller asks for another)."""

    @staticmethod
    def registerCustomLayer(className: str, factory) -> None:
        """Reference: ``KerasLayer.registerCustomLayer`` — map a custom
        Keras layer class to a framework layer.  ``factory(cfg_dict)``
        returns a Layer (treated as weight-less) or a full
        ``(layer, kind, out_channels)`` mapping tuple."""
        _CUSTOM_LAYERS[className] = factory

    @staticmethod
    def registerLambdaLayer(layerName: str, layer) -> None:
        """Reference: ``KerasLayer.registerLambdaLayer`` — Keras Lambda
        layers serialize no portable code, so the import substitutes a
        pre-registered framework layer (any layer of the port) by the
        LAYER NAME."""
        _LAMBDA_LAYERS[layerName] = layer

    @staticmethod
    def importKerasSequentialModelAndWeights(
            path: str, enforceTrainingConfig: bool = False, device=None):
        import zipfile

        if zipfile.is_zipfile(path):   # keras-3 native ".keras" archive
            return KerasModelImport._importKerasV3(
                path, enforceTrainingConfig, device=device)
        with hdf5.File(path, "r") as f:
            raw = f.attrs.get("model_config")
            if raw is None:
                raise ValueError("No model_config in h5 (not a Keras model?)")
            if isinstance(raw, bytes):
                raw = raw.decode()
            model_cfg = json.loads(raw)
            cls = model_cfg.get("class_name")
            layers_cfg = model_cfg["config"]
            if isinstance(layers_cfg, dict):
                layers_cfg = layers_cfg.get("layers", [])
            store = _WeightStore(f)
            updater = _training_config_updater(f, enforceTrainingConfig)
            return _build_net(cls, model_cfg["config"], layers_cfg, store,
                              updater, device=device)

    @staticmethod
    def _importKerasV3(path: str, enforceTrainingConfig: bool = False,
                       device=None):
        """The keras-3 ``.keras`` zip (config.json + model.weights.h5) —
        beyond the reference's Keras 1.x/2.x h5 coverage (SURVEY §2.5):
        keras 3 saves this format by default, so "any stock Keras model
        imports" requires it."""
        import io
        import zipfile

        with zipfile.ZipFile(path) as z:
            top = json.loads(z.read("config.json"))
            weights_raw = z.read("model.weights.h5")
        cls = top.get("class_name")
        model_cfg = top.get("config", {})
        layers_cfg = model_cfg.get("layers", []) \
            if isinstance(model_cfg, dict) else model_cfg
        compile_cfg = top.get("compile_config") or None   # uncompiled: {}
        if compile_cfg is None and enforceTrainingConfig:
            raise ValueError(
                "enforceTrainingConfig=True but the .keras archive carries "
                "no compile_config (model was saved uncompiled)")
        updater = None
        if compile_cfg:
            updater = _updater_from_optimizer_cfg(
                compile_cfg.get("optimizer") or {}, enforceTrainingConfig)

        with hdf5.File(io.BytesIO(weights_raw), "r") as wf:
            store = _WeightStoreV3(wf, layers_cfg)
            return _build_net(cls, model_cfg, layers_cfg, store, updater,
                              device=device)

    # parity name (reference: KerasModelImport.importKerasModelAndWeights):
    # linear Functional chains come back as MultiLayerNetwork, branching
    # topologies (merge/residual) as ComputationGraph — like the reference.
    importKerasModelAndWeights = importKerasSequentialModelAndWeights


def _training_config_updater(f, enforce: bool):
    """Map the h5's ``training_config`` (keras ``model.compile`` state) to
    this framework's updater, so a fine-tune continues with the source
    model's optimizer and learning rate.  Reference:
    ``KerasModelImport.importKerasSequentialModelAndWeights(path,
    enforceTrainingConfig)`` — enforce=True errors when the model was
    never compiled."""
    raw = f.attrs.get("training_config")
    if raw is None:
        if enforce:
            raise ValueError(
                "enforceTrainingConfig=True but the h5 carries no "
                "training_config (model was saved uncompiled)")
        return None
    if isinstance(raw, bytes):
        raw = raw.decode()
    opt = (json.loads(raw).get("optimizer_config") or {})
    return _updater_from_optimizer_cfg(opt, enforce)


def _updater_from_optimizer_cfg(opt: Dict, enforce: bool):
    """keras optimizer {class_name, config} -> framework updater; shared by
    the h5 ``training_config`` and the ``.keras`` ``compile_config``."""
    # tf_keras (legacy keras 2) prefixes registered classes: "Custom>Adam"
    ocls = opt.get("class_name", "").split(">")[-1]
    ocfg = opt.get("config", {})
    lr = ocfg.get("learning_rate", 1e-3)
    if not isinstance(lr, (int, float)):    # LR schedules: use the base LR
        lr = (lr.get("config", {}) or {}).get("initial_learning_rate", 1e-3)
    from deeplearning4j_tpu_torch import learning as L
    if ocls in ("Adam", "AdamW"):
        kw = dict(beta1=ocfg.get("beta_1", 0.9),
                  beta2=ocfg.get("beta_2", 0.999),
                  epsilon=ocfg.get("epsilon", 1e-8))
        if ocls == "AdamW":
            return L.AdamW(float(lr),
                           weightDecay=float(ocfg.get("weight_decay")
                                             or 0.0), **kw)
        if ocfg.get("amsgrad"):
            return L.AMSGrad(float(lr), **kw)
        return L.Adam(float(lr), **kw)
    if ocls == "Nadam":
        return L.Nadam(float(lr), beta1=ocfg.get("beta_1", 0.9),
                       beta2=ocfg.get("beta_2", 0.999))
    if ocls == "SGD":
        mom = float(ocfg.get("momentum", 0.0) or 0.0)
        if mom:   # DL4J parity: all momentum SGD maps to Nesterovs
            return L.Nesterovs(float(lr), momentum=mom)
        return L.Sgd(float(lr))
    if ocls == "RMSprop":
        return L.RmsProp(float(lr), rmsDecay=ocfg.get("rho", 0.9))
    if ocls == "Adagrad":
        return L.AdaGrad(float(lr))
    if ocls == "Adadelta":
        return L.AdaDelta(rho=ocfg.get("rho", 0.95))
    if enforce:
        raise ValueError(f"Keras import: optimizer {ocls!r} has no "
                         "updater mapping")
    return None


def _build_net(cls: Optional[str], model_cfg, layers_cfg: List[Dict],
               store, updater, device=None):
    """Shared model-class dispatch + updater wiring for the h5 and
    ``.keras`` import paths: Sequential / linear-Functional ->
    MultiLayerNetwork, branching Functional -> ComputationGraph, on
    ``device``.  ``store.get(keras layer name)`` gives the layer's weight
    arrays in keras's order."""
    from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType, NeuralNetConfiguration)

    if cls in ("Functional", "Model"):
        chain = _linearize_functional(layers_cfg)
        if chain is None:   # branching -> ComputationGraph
            full = model_cfg if isinstance(model_cfg, dict) else {}
            net = _build_graph(full, layers_cfg, store, device)
        else:
            net = _build_sequential(chain, store, InputType,
                                    NeuralNetConfiguration,
                                    MultiLayerNetwork, device)
    elif cls == "Sequential":
        net = _build_sequential(layers_cfg, store, InputType,
                                NeuralNetConfiguration, MultiLayerNetwork,
                                device)
    else:
        raise ValueError(f"Unsupported Keras model class: {cls}")
    if updater is not None:
        net.conf.globalConf["updater"] = updater
        net._initOptState()   # rebuild for the new updater
    return net


def _inbound_edges(layers_cfg: List[Dict]) -> Dict[str, List[str]]:
    """keras layer name -> list of source layer names (keras2 + keras3)."""
    inbound: Dict[str, List[str]] = {}
    for lk in layers_cfg:
        name = _cfg(lk).get("name", lk.get("name"))
        srcs = []
        for node in lk.get("inbound_nodes", []):
            if isinstance(node, dict):    # keras3 format
                args = node.get("args", [])

                def walk(a):
                    if isinstance(a, dict) and "config" in a and \
                            isinstance(a["config"], dict) and \
                            "keras_history" in a["config"]:
                        srcs.append(a["config"]["keras_history"][0])
                    elif isinstance(a, (list, tuple)):
                        for x in a:
                            walk(x)
                walk(args)
            elif isinstance(node, (list, tuple)):  # keras2: [[name,0,0,{}]..]
                for entry in node:
                    if entry and isinstance(entry, (list, tuple)):
                        srcs.append(entry[0])
                        # keras2 records extra call-arg tensors (e.g. the
                        # MultiHeadAttention value/key) in the call-kwargs
                        # slot as ["layer", node_idx, tensor_idx]
                        if len(entry) > 3 and isinstance(entry[3], dict):
                            def walk2(kw):
                                if isinstance(kw, (list, tuple)):
                                    if len(kw) >= 3 and \
                                            isinstance(kw[0], str):
                                        srcs.append(kw[0])
                                    else:   # e.g. initial_state=[h, c]
                                        for sub in kw:
                                            walk2(sub)
                            for kw in entry[3].values():
                                walk2(kw)
        inbound[name] = srcs
    return inbound


def _inbound_scalars(layers_cfg: List[Dict]) -> Dict[str, List[Tuple[int,
                                                                     float]]]:
    """keras-3 functional configs can pass plain python scalars to merge
    layers (``x + 3.0`` → Add with a literal in args).  Returns
    layer name -> [(arg position, value)], so the importer can fold them
    instead of silently dropping them."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for lk in layers_cfg:
        name = _cfg(lk).get("name", lk.get("name"))
        lits: List[Tuple[int, float]] = []
        for node in lk.get("inbound_nodes", []):
            if not isinstance(node, dict):
                continue
            args = node.get("args", [])
            flat = list(args[0]) if len(args) == 1 and \
                isinstance(args[0], (list, tuple)) else list(args)
            for i, a in enumerate(flat):
                if isinstance(a, (int, float)) and not isinstance(a, bool):
                    lits.append((i, float(a)))
        if lits:
            out[name] = lits
    return out


def _linearize_functional(layers_cfg: List[Dict]) -> Optional[List[Dict]]:
    """Order a Functional model's layers as a linear chain via inbound_nodes;
    returns None on branching topologies (those import as ComputationGraph)."""
    inbound = _inbound_edges(layers_cfg)
    if any(len(s) > 1 for s in inbound.values()):
        return None
    # scalar-operand merges (x + 3.0) only the graph path can fold
    if any(lk["class_name"] in _MERGE_CLASSES for lk in layers_cfg):
        return None
    by_name = {_cfg(lk).get("name", lk.get("name")): lk for lk in layers_cfg}
    succ = {s[0]: n for n, s in inbound.items() if s}
    starts = [n for n, s in inbound.items() if not s]
    if len(starts) != 1:
        return None          # multiple inputs -> graph path
    order, cur = [], starts[0]
    while cur is not None:
        order.append(by_name[cur])
        cur = succ.get(cur)
    if len(order) != len(by_name):
        # fan-out with no merge (multi-head outputs): succ kept only one
        # consumer per source — not a chain; import as a graph instead
        return None
    return order


def _track_shape(cur, lay, out_channels):
    """Track the Keras-side (h, w, c) feature-map shape through conv/pool
    layers using the layer's own shape inference (keeps the Flatten->Dense
    kernel permutation consistent with actual output sizes)."""
    if cur is None:
        return None
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as IT
    h, w, c = cur
    out = lay.getOutputType(IT.convolutional(h, w, c))
    return (out.height, out.width,
            out_channels if out_channels is not None else c)


def _input_type(cfg: Dict, InputType):
    shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
    if shape is None:
        return None
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return InputType.feedForward(int(dims[0]))
    if len(dims) == 3:          # Keras default channels_last (h, w, c)
        h, w, c = dims
        return InputType.convolutional(int(h), int(w), int(c))
    if len(dims) == 2:          # (t, features) -> our recurrent (n, t)
        t, n = dims
        return InputType.recurrent(int(n), int(t) if t else -1)
    if len(dims) == 4:          # (t_or_d, h, w, c) -> NCDHW (depth = time)
        d, h, w, c = dims
        return InputType.convolutional3D(int(d), int(h), int(w), int(c))
    raise ValueError(f"Unsupported input shape {shape}")


#: kinds that carry weights (their keras name is kept for the weight store)
_WEIGHTY = {"dense", "conv", "conv1d", "bn", "lstm", "bilstm", "embedding",
            "sepconv", "dwconv", "deconv", "simplernn", "gru", "ln", "mha",
            "conv3d", "prelu", "deconv3d", "lc2d", "lc1d", "staticnorm"}
#: kinds whose output stays in CNN format (conv-shape tracking continues)
_CNN_KINDS = {"conv", "pool", "upsample", "zeropad", "crop", "sepconv",
              "dwconv", "deconv", "lc2d", "globalpoolkeep"}


def _is_weighty(kind: str) -> bool:
    return kind in _WEIGHTY or \
        (kind.startswith("td") and kind[2:] in _WEIGHTY)


def _pad3_spec(p):
    """keras 3D padding/cropping spec -> ((d0,d1),(h0,h1),(w0,w1))."""
    if isinstance(p, int):
        return ((p, p), (p, p), (p, p))
    out = []
    for v in p:
        out.append((int(v), int(v)) if isinstance(v, int)
                   else (int(v[0]), int(v[1])))
    return tuple(out)


def _check_norm_axis(lay, rank: int) -> None:
    """keras Normalization normalizes the axis it was adapted over; only
    the trailing (channels-last) axis maps onto this framework's
    channel-first layouts."""
    ax = getattr(lay, "_kerasAxis", -1)
    if ax not in (-1, rank - 1):
        raise ValueError(
            f"Keras import: Normalization axis={ax} on a rank-{rank} "
            "input is unsupported (channels-last axis only)")


def _fix_prelu_axes(lay, ctx: str) -> None:
    """Convert keras PReLU ``shared_axes`` (1-based, channels-last
    per-example layout) to this framework's channels-first layout."""
    ka = getattr(lay, "_kerasSharedAxes", ())
    if not ka:
        lay.sharedAxes = ()
        return
    m = {"cnn": {1: 2, 2: 3, 3: 1},          # (h, w, c) -> (c, h, w)
         "cnn3d": {1: 2, 2: 3, 3: 4, 4: 1},  # (d, h, w, c) -> (c, d, h, w)
         "rnn": {1: 2, 2: 1},                # (t, f) -> (f, t)
         "ff": {1: 1}}[ctx]
    try:
        lay.sharedAxes = tuple(sorted(m[a] for a in ka))
    except KeyError:
        raise ValueError(f"Keras import: PReLU shared_axes={ka} invalid "
                         f"for a rank-{len(m)} input")


def _map_keras_layer(cls: str, cfg: Dict, is_last: bool = False):
    """One Keras layer config -> ``(our_layer, kind, out_channels)``.

    ``out_channels``: int = new channel count; None = channels unchanged;
    ``("mult", m)`` = multiply current channels (depthwise).  Returns None
    for unsupported classes.  Shared by the Sequential and the
    ComputationGraph (branching Functional) import paths.
    """
    from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                   BatchNormalization,
                                                   ConvolutionLayer,
                                                   DenseLayer, DropoutLayer,
                                                   EmbeddingSequenceLayer,
                                                   GlobalPoolingLayer,
                                                   OutputLayer,
                                                   SubsamplingLayer)
    if cls in _CUSTOM_LAYERS:
        out = _CUSTOM_LAYERS[cls](cfg)
        return out if isinstance(out, tuple) else (out, "custom", None)
    if cls == "Lambda":
        name = cfg.get("name")
        if name in _LAMBDA_LAYERS:
            return _LAMBDA_LAYERS[name], "lambda", None
        raise ValueError(
            f"Keras import: Lambda layer {name!r} carries no portable "
            "code; register a framework substitute first with "
            "KerasModelImport.registerLambdaLayer(name, layer)")
    if cls in ("Dropout", "SpatialDropout2D", "SpatialDropout1D"):
        # SpatialDropout imports as element-wise dropout: inference is
        # identical (identity); FINE-TUNING regularization differs from
        # keras's whole-channel dropping
        rate = float(cfg.get("rate", 0.5))
        return DropoutLayer(dropOut=1.0 - rate), "dropout", None
    if cls == "Activation":
        return (ActivationLayer(activation=_act(cfg.get("activation"))),
                "activation", None)
    if cls == "LeakyReLU":
        from deeplearning4j_tpu_torch.nn.conf.layers import LeakyReLULayer
        # keras stores the slope as alpha (newer: negative_slope)
        a = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))
        return LeakyReLULayer(alpha=a), "activation", None
    if cls == "ELU":
        from deeplearning4j_tpu_torch.nn.conf.layers import ELULayer
        return (ELULayer(alpha=float(cfg.get("alpha", 1.0))),
                "activation", None)
    if cls == "ReLU" and not cfg.get("threshold"):
        slope = float(cfg.get("negative_slope", 0.0) or 0.0)
        mv = cfg.get("max_value")
        if mv is not None and not slope:    # MobileNet-style capped relu
            mv = float(mv)
            act = "relu6" if mv == 6.0 else f"clippedrelu:{mv}"
            return ActivationLayer(activation=act), "activation", None
        if slope and mv is None:
            from deeplearning4j_tpu_torch.nn.conf.layers import LeakyReLULayer
            return LeakyReLULayer(alpha=slope), "activation", None
        if mv is None:
            return ActivationLayer(activation="relu"), "activation", None
    if cls == "Dense":
        units = int(cfg["units"])
        act = _act(cfg.get("activation"))
        if is_last and act == "softmax":
            lay = OutputLayer.builder("mcxent").nOut(units) \
                .activation("softmax").build()
        else:
            lay = DenseLayer(nOut=units, activation=act)
        return lay, "dense", None
    if cls == "Conv2D":
        if cfg.get("data_format") == "channels_first":
            raise ValueError("Keras import: channels_first Conv2D is "
                             "not supported (save as channels_last)")
        k = cfg.get("kernel_size", [3, 3])
        s = cfg.get("strides", [1, 1])
        d = cfg.get("dilation_rate", [1, 1])
        same = cfg.get("padding", "valid") == "same"
        lay = ConvolutionLayer(
            nOut=int(cfg["filters"]), kernelSize=tuple(int(x) for x in k),
            stride=tuple(int(x) for x in s),
            dilation=tuple(int(x) for x in d),
            convolutionMode="Same" if same else "Truncate",
            activation=_act(cfg.get("activation")),
            hasBias=bool(cfg.get("use_bias", True)))
        return lay, "conv", int(cfg["filters"])
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        k = cfg.get("pool_size", [2, 2])
        s = cfg.get("strides") or k
        same = cfg.get("padding", "valid") == "same"
        lay = SubsamplingLayer(
            kernelSize=tuple(int(x) for x in k),
            stride=tuple(int(x) for x in s),
            convolutionMode="Same" if same else "Truncate",
            poolingType="MAX" if cls == "MaxPooling2D" else "AVG")
        return lay, "pool", None
    if cls == "BatchNormalization":
        return (BatchNormalization(eps=float(cfg.get("epsilon", 1e-3))),
                "bn", None)
    if cls == "Conv1D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional import \
            Convolution1DLayer
        k = cfg.get("kernel_size", [3])
        st = cfg.get("strides", [1])
        d = cfg.get("dilation_rate", [1])
        same = cfg.get("padding", "valid") == "same"
        lay = Convolution1DLayer(
            nOut=int(cfg["filters"]), kernelSize=int(k[0]),
            stride=int(st[0]), dilation=int(d[0]),
            convolutionMode="Same" if same else "Truncate",
            activation=_act(cfg.get("activation")),
            hasBias=bool(cfg.get("use_bias", True)))
        return lay, "conv1d", None
    if cls in ("MaxPooling1D", "AveragePooling1D"):
        from deeplearning4j_tpu_torch.nn.conf.convolutional import \
            Subsampling1DLayer
        k = cfg.get("pool_size", [2])
        st = cfg.get("strides") or k
        lay = Subsampling1DLayer(
            poolingType="MAX" if cls == "MaxPooling1D" else "AVG",
            kernelSize=int(k[0] if isinstance(k, (list, tuple)) else k),
            stride=int(st[0] if isinstance(st, (list, tuple)) else st))
        return lay, "pool", None
    if cls in ("GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPoolingLayer
        if cfg.get("keepdims"):
            raise ValueError(f"Keras import: {cls} keepdims=True is "
                             "unsupported on sequences")
        return (GlobalPoolingLayer(
            poolingType="MAX" if "Max" in cls else "AVG"),
            "globalpool", None)
    if cls == "Bidirectional":
        from deeplearning4j_tpu_torch.nn.conf.recurrent import (LSTM,
                                                          Bidirectional,
                                                          LastTimeStep)
        inner_cfg = cfg.get("layer", {})
        inner_cls = inner_cfg.get("class_name")
        if inner_cls not in ("LSTM", "GRU", "SimpleRNN"):
            raise ValueError("Keras import: Bidirectional supports "
                             "LSTM/GRU/SimpleRNN wrapped layers only")
        icfg = inner_cfg.get("config", {})
        merge = cfg.get("merge_mode", "concat")
        mode = {"concat": "CONCAT", "sum": "ADD", "ave": "AVERAGE",
                "mul": "MUL"}.get(merge)
        if mode is None:
            raise ValueError(f"Bidirectional merge_mode {merge!r} "
                             "unsupported")
        if inner_cls == "LSTM":
            inner = LSTM(nOut=int(icfg["units"]),
                         activation=_act(icfg.get("activation", "tanh")))
        elif inner_cls == "GRU":
            from deeplearning4j_tpu_torch.nn.conf.recurrent import (
                GRU as OurGRU)
            inner = OurGRU(nOut=int(icfg["units"]),
                           activation=_act(icfg.get("activation", "tanh")),
                           resetAfter=bool(icfg.get("reset_after", True)))
        else:
            from deeplearning4j_tpu_torch.nn.conf.recurrent import SimpleRnn
            inner = SimpleRnn(nOut=int(icfg["units"]),
                              activation=_act(icfg.get("activation",
                                                       "tanh")))
        # keras return_sequences=False merges fwd[T-1] with the BACKWARD
        # scan's own last output (original position 0) — Bidirectional
        # implements exactly that via returnSequences=False
        rs = bool(icfg.get("return_sequences", False))
        return (Bidirectional(mode, inner, returnSequences=rs),
                "bilstm", None)
    if cls == "LSTM":
        from deeplearning4j_tpu_torch.nn.conf.recurrent import (
            LSTM, LastTimeStep)
        lstm = LSTM(nOut=int(cfg["units"]),
                    activation=_act(cfg.get("activation", "tanh")))
        lay = lstm if cfg.get("return_sequences", False) \
            else LastTimeStep(lstm)
        return lay, "lstm", None
    if cls == "Embedding":
        return (EmbeddingSequenceLayer(nIn=int(cfg["input_dim"]),
                                       nOut=int(cfg["output_dim"])),
                "embedding", None)
    if cls == "UpSampling2D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional import Upsampling2D
        interp = cfg.get("interpolation", "nearest")
        if interp != "nearest":
            raise ValueError(
                f"Keras import: UpSampling2D interpolation={interp!r} "
                "is unsupported (only 'nearest'); importing it silently "
                "would change the numerics")
        sz = cfg.get("size", [2, 2])
        return Upsampling2D(size=tuple(int(x) for x in sz)), "upsample", None
    if cls == "ZeroPadding2D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional import (
            ZeroPaddingLayer)
        p = cfg.get("padding", [[1, 1], [1, 1]])
        if isinstance(p, int):
            pad = (p, p, p, p)
        elif isinstance(p[0], (list, tuple)):
            pad = (int(p[0][0]), int(p[0][1]), int(p[1][0]), int(p[1][1]))
        else:
            pad = (int(p[0]), int(p[0]), int(p[1]), int(p[1]))
        return ZeroPaddingLayer(padding=pad), "zeropad", None
    if cls == "Cropping2D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional import Cropping2D
        p = cfg.get("cropping", [[0, 0], [0, 0]])
        if isinstance(p[0], (list, tuple)):
            crop = (int(p[0][0]), int(p[0][1]), int(p[1][0]), int(p[1][1]))
        else:
            crop = (int(p[0]), int(p[0]), int(p[1]), int(p[1]))
        return Cropping2D(cropping=crop), "crop", None
    if cls in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
        from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPoolingLayer
        pt = "AVG" if "Average" in cls else "MAX"
        if cfg.get("keepdims"):
            # keras keepdims == reference collapseDimensions=false: the
            # (b, c, 1, 1) map feeds SE-style broadcast multiplies
            return (GlobalPoolingLayer(poolingType=pt,
                                       collapseDimensions=False),
                    "globalpoolkeep", None)
        return GlobalPoolingLayer(poolingType=pt), "globalpool", None
    if cls in ("SeparableConv2D", "DepthwiseConv2D"):
        from deeplearning4j_tpu_torch.nn.conf.convolutional import (
            DepthwiseConvolution2D, SeparableConvolution2D)
        k = cfg.get("kernel_size", [3, 3])
        s = cfg.get("strides", [1, 1])
        same = cfg.get("padding", "valid") == "same"
        dm = int(cfg.get("depth_multiplier", 1))
        common = dict(kernelSize=tuple(int(x) for x in k),
                      stride=tuple(int(x) for x in s),
                      depthMultiplier=dm,
                      convolutionMode="Same" if same else "Truncate",
                      activation=_act(cfg.get("activation")),
                      hasBias=bool(cfg.get("use_bias", True)))
        if cls == "SeparableConv2D":
            return (SeparableConvolution2D(nOut=int(cfg["filters"]),
                                           **common),
                    "sepconv", int(cfg["filters"]))
        return DepthwiseConvolution2D(**common), "dwconv", ("mult", dm)
    if cls == "Conv2DTranspose":
        from deeplearning4j_tpu_torch.nn.conf.convolutional import (
            Deconvolution2D)
        k = cfg.get("kernel_size", [2, 2])
        s = cfg.get("strides", [2, 2])
        same = cfg.get("padding", "valid") == "same"
        lay = Deconvolution2D(
            nOut=int(cfg["filters"]),
            kernelSize=tuple(int(x) for x in k),
            stride=tuple(int(x) for x in s),
            convolutionMode="Same" if same else "Truncate",
            activation=_act(cfg.get("activation")),
            hasBias=bool(cfg.get("use_bias", True)))
        return lay, "deconv", int(cfg["filters"])
    if cls == "SimpleRNN":
        from deeplearning4j_tpu_torch.nn.conf.recurrent import (LastTimeStep,
                                                          SimpleRnn)
        rnn = SimpleRnn(nOut=int(cfg["units"]),
                        activation=_act(cfg.get("activation", "tanh")))
        lay = rnn if cfg.get("return_sequences", False) \
            else LastTimeStep(rnn)
        return lay, "simplernn", None
    if cls == "GRU":
        from deeplearning4j_tpu_torch.nn.conf.recurrent import (GRU as OurGRU,
                                                          LastTimeStep)
        gru = OurGRU(nOut=int(cfg["units"]),
                     activation=_act(cfg.get("activation", "tanh")),
                     resetAfter=bool(cfg.get("reset_after", True)))
        lay = gru if cfg.get("return_sequences", False) \
            else LastTimeStep(gru)
        return lay, "gru", None
    if cls == "LayerNormalization":
        from deeplearning4j_tpu_torch.nn.conf.misc import LayerNormalization
        axis = cfg.get("axis", -1)
        ax_list = list(axis) if isinstance(axis, (list, tuple)) else [axis]
        if len(ax_list) != 1:
            raise ValueError(f"Keras import: LayerNormalization axis="
                             f"{axis} unsupported (single trailing axis "
                             "only)")
        # a positive trailing axis is validated against the input rank in
        # LayerNormalization.getOutputType (rank is unknown here)
        return (LayerNormalization(eps=float(cfg.get("epsilon", 1e-3)),
                                   axis=int(ax_list[0])), "ln", None)
    if cls == "MultiHeadAttention":
        from deeplearning4j_tpu_torch.nn.conf.attention import \
            KerasMultiHeadAttention
        out_shape = cfg.get("output_shape")
        n_out = 0
        if out_shape is not None:
            if isinstance(out_shape, (list, tuple)):
                if len(out_shape) != 1:
                    raise ValueError("Keras import: MultiHeadAttention "
                                     f"output_shape={out_shape} unsupported")
                n_out = int(out_shape[0])
            else:
                n_out = int(out_shape)
        lay = KerasMultiHeadAttention(
            nHeads=int(cfg["num_heads"]), keyDim=int(cfg["key_dim"]),
            valueDim=int(cfg.get("value_dim") or cfg["key_dim"]),
            nOut=n_out, hasBias=bool(cfg.get("use_bias", True)))
        return lay, "mha", None
    if cls == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.conf.misc import GaussianNoiseLayer
        return (GaussianNoiseLayer(stddev=float(cfg.get("stddev", 0.1))),
                "noise", None)
    if cls == "GaussianDropout":
        from deeplearning4j_tpu_torch.nn.conf.misc import GaussianDropoutLayer
        return (GaussianDropoutLayer(rate=float(cfg.get("rate", 0.5))),
                "noise", None)
    if cls == "AlphaDropout":
        from deeplearning4j_tpu_torch.nn.conf.misc import AlphaDropoutLayer
        return (AlphaDropoutLayer(rate=float(cfg.get("rate", 0.1))),
                "noise", None)
    if cls == "Reshape":
        from deeplearning4j_tpu_torch.nn.conf.misc import ReshapeLayer
        return (ReshapeLayer(targetShape=tuple(
            int(v) for v in cfg["target_shape"])), "reshape", None)
    if cls == "Permute":
        from deeplearning4j_tpu_torch.nn.conf.misc import PermuteLayer
        return (PermuteLayer(dims=tuple(int(v) for v in cfg["dims"])),
                "reshape", None)
    if cls == "Conv3D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import (
            Convolution3D)
        if cfg.get("data_format") == "channels_first":
            raise ValueError("Keras import: channels_first Conv3D is "
                             "not supported (save as channels_last)")
        k = cfg.get("kernel_size", [3, 3, 3])
        s = cfg.get("strides", [1, 1, 1])
        d = cfg.get("dilation_rate", [1, 1, 1])
        same = cfg.get("padding", "valid") == "same"
        lay = Convolution3D(
            nOut=int(cfg["filters"]), kernelSize=tuple(int(x) for x in k),
            stride=tuple(int(x) for x in s),
            dilation=tuple(int(x) for x in d),
            convolutionMode="Same" if same else "Truncate",
            activation=_act(cfg.get("activation")),
            hasBias=bool(cfg.get("use_bias", True)))
        return lay, "conv3d", int(cfg["filters"])
    if cls in ("MaxPooling3D", "AveragePooling3D"):
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import \
            Subsampling3DLayer
        k = cfg.get("pool_size", [2, 2, 2])
        s = cfg.get("strides") or k
        same = cfg.get("padding", "valid") == "same"
        lay = Subsampling3DLayer(
            kernelSize=tuple(int(x) for x in k),
            stride=tuple(int(x) for x in s),
            convolutionMode="Same" if same else "Truncate",
            poolingType="MAX" if cls == "MaxPooling3D" else "AVG")
        return lay, "pool3d", None
    if cls == "Cropping1D":
        from deeplearning4j_tpu_torch.nn.conf.misc import Cropping1D
        # the layer's __post_init__ normalizes int/tuple forms
        return (Cropping1D(cropping=cfg.get("cropping", (1, 1))),
                "crop1d", None)
    if cls == "ZeroPadding1D":
        from deeplearning4j_tpu_torch.nn.conf.misc import ZeroPadding1DLayer
        return (ZeroPadding1DLayer(padding=cfg.get("padding", 1)),
                "pad1d", None)
    if cls == "Softmax":
        axis = cfg.get("axis", -1)
        ax_list = list(axis) if isinstance(axis, (list, tuple)) else [axis]
        if ax_list != [-1]:
            raise ValueError(f"Keras import: Softmax axis={axis} "
                             "unsupported (last axis only)")
        # keras axis -1 is the feature/channel axis (channels-last); in
        # this framework's channel-first layouts that is axis 1 for any
        # rank>2 input — the builder paths patch the activation to
        # "softmax:1" when the input is a sequence / feature map
        return ActivationLayer(activation="softmax"), "softmaxfix", None
    if cls == "ThresholdedReLU":
        theta = float(cfg.get("theta", 1.0))
        name = "thresholdedrelu" if theta == 1.0 \
            else f"thresholdedrelu:{theta}"
        return ActivationLayer(activation=name), "activation", None
    if cls == "PReLU":
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import PReLULayer
        sa = cfg.get("shared_axes") or ()
        if isinstance(sa, int):
            sa = (sa,)
        lay = PReLULayer()
        # keras-layout 1-based axes; converted to ours once the input
        # rank is known (_fix_prelu_axes in the builder paths)
        lay._kerasSharedAxes = tuple(int(a) for a in sa)
        return lay, "prelu", None
    if cls == "RepeatVector":
        from deeplearning4j_tpu_torch.nn.conf.misc import RepeatVector
        return (RepeatVector(repetitionFactor=int(cfg["n"])),
                "repeat", None)
    if cls == "Masking":
        from deeplearning4j_tpu_torch.nn.conf.misc import MaskingLayer
        return (MaskingLayer(maskValue=float(cfg.get("mask_value", 0.0))),
                "masking", None)
    if cls == "UpSampling1D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional import Upsampling1D
        return Upsampling1D(size=cfg.get("size", 2)), "upsample1d", None
    if cls == "UpSampling3D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import (
            Upsampling3D)
        sz = cfg.get("size", [2, 2, 2])
        return (Upsampling3D(size=tuple(int(x) for x in sz)),
                "upsample3d", None)
    if cls == "ZeroPadding3D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import \
            ZeroPadding3DLayer
        p = _pad3_spec(cfg.get("padding", 1))
        return (ZeroPadding3DLayer(padDepth=p[0], padHeight=p[1],
                                   padWidth=p[2]), "pad3d", None)
    if cls == "Cropping3D":
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import Cropping3D
        p = _pad3_spec(cfg.get("cropping", 1))
        return (Cropping3D(cropDepth=p[0], cropHeight=p[1], cropWidth=p[2]),
                "crop3d", None)
    if cls == "Conv3DTranspose":
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import (
            Deconvolution3D)
        if cfg.get("data_format") == "channels_first":
            raise ValueError("Keras import: channels_first Conv3DTranspose "
                             "is not supported (save as channels_last)")
        k = cfg.get("kernel_size", [2, 2, 2])
        s = cfg.get("strides", [2, 2, 2])
        same = cfg.get("padding", "valid") == "same"
        lay = Deconvolution3D(
            nOut=int(cfg["filters"]), kernelSize=tuple(int(x) for x in k),
            stride=tuple(int(x) for x in s),
            convolutionMode="Same" if same else "Truncate",
            activation=_act(cfg.get("activation")),
            hasBias=bool(cfg.get("use_bias", True)))
        return lay, "deconv3d", int(cfg["filters"])
    if cls in ("LocallyConnected2D", "LocallyConnected1D"):
        from deeplearning4j_tpu_torch.nn.conf.convolutional3d import (
            LocallyConnected1D, LocallyConnected2D)
        if cfg.get("implementation", 1) != 1:
            raise ValueError("Keras import: LocallyConnected implementation"
                             f"={cfg.get('implementation')} unsupported "
                             "(dense per-position kernels only, impl 1)")
        if cfg.get("padding", "valid") != "valid":
            raise ValueError("Keras import: LocallyConnected padding="
                             f"{cfg.get('padding')!r} unsupported")
        if cfg.get("data_format") == "channels_first":
            raise ValueError("Keras import: channels_first LocallyConnected"
                             " is not supported (save as channels_last)")
        common = dict(nOut=int(cfg["filters"]),
                      activation=_act(cfg.get("activation")),
                      hasBias=bool(cfg.get("use_bias", True)))
        if cls == "LocallyConnected2D":
            k = cfg.get("kernel_size", [3, 3])
            s = cfg.get("strides", [1, 1])
            lay = LocallyConnected2D(
                kernelSize=tuple(int(x) for x in k),
                stride=tuple(int(x) for x in s), **common)
            return lay, "lc2d", int(cfg["filters"])
        k = cfg.get("kernel_size", [3])
        s = cfg.get("strides", [1])
        lay = LocallyConnected1D(kernelSize=int(k[0]), stride=int(s[0]),
                                 **common)
        return lay, "lc1d", None
    if cls == "Rescaling":
        from deeplearning4j_tpu_torch.nn.conf.misc import RescaleLayer
        scale, offset = cfg.get("scale", 1.0), cfg.get("offset", 0.0)
        if isinstance(scale, (list, tuple)) \
                or isinstance(offset, (list, tuple)):
            raise ValueError("Keras import: per-channel Rescaling is "
                             "unsupported (scalar scale/offset only)")
        return (RescaleLayer(scale=float(scale), offset=float(offset)),
                "activation", None)
    if cls == "Normalization":
        from deeplearning4j_tpu_torch.nn.conf.misc import (
            StaticNormalizationLayer)
        if cfg.get("invert"):
            raise ValueError("Keras import: Normalization(invert=True) "
                             "(denormalization) is unsupported")
        axis = cfg.get("axis", -1)
        ax_list = list(axis) if isinstance(axis, (list, tuple)) else [axis]
        if len(ax_list) != 1:
            raise ValueError(f"Keras import: Normalization axis={axis} "
                             "unsupported (single channels-last axis)")
        mv = cfg.get("mean")      # constructor-supplied stats live in the
        vv = cfg.get("variance")  # CONFIG (no weight variables created)
        lay = StaticNormalizationLayer(
            mean=tuple(np.asarray(mv if mv is not None else ())
                       .reshape(-1).tolist()),
            variance=tuple(np.asarray(vv if vv is not None else ())
                           .reshape(-1).tolist()))
        # positive axes are validated against the input rank by the
        # builder paths (only the trailing/channel axis is representable)
        lay._kerasAxis = int(ax_list[0])
        return lay, "staticnorm", None
    if cls == "TimeDistributed":
        from deeplearning4j_tpu_torch.nn.conf.recurrent import (
            TimeDistributed, TimeDistributedFlatten)
        inner = cfg.get("layer", {})
        inner_cls = inner.get("class_name")
        if inner_cls == "Flatten":
            return TimeDistributedFlatten(), "tdflatten", None
        mapped = _map_keras_layer(inner_cls, inner.get("config", {}))
        if mapped is None:
            raise ValueError(f"Keras import: TimeDistributed({inner_cls}) "
                             "unsupported")
        ilay, ikind, out_c = mapped
        if ikind not in ("dense", "conv", "pool", "bn", "activation",
                         "dropout", "sepconv", "dwconv", "deconv", "ln",
                         "noise"):
            raise ValueError(f"Keras import: TimeDistributed({inner_cls}) "
                             "unsupported")
        return TimeDistributed(ilay), "td" + ikind, out_c
    return None


def _out_channels(out_c, cur_shape):
    if isinstance(out_c, tuple):     # ("mult", m): depthwise
        return cur_shape[2] * out_c[1] if cur_shape else None
    return out_c


def _build_sequential(layers_cfg, store, InputType, NeuralNetConfiguration,
                      MultiLayerNetwork, device=None):
    builder = NeuralNetConfiguration.builder().list()
    input_type = None
    # (layer, keras name, kind)
    our_layers: List[Tuple[Any, Optional[str], str]] = []
    kcfgs: Dict[str, Dict] = {}        # keras layer name -> its config dict
    pending_flatten: Dict[int, Tuple[int, int, int]] = {}
    cur_conv_shape: Optional[Tuple[int, int, int]] = None  # (h, w, c) Keras

    n_layers = len(layers_cfg)
    cur_rnn = False
    cur_seq: Optional[Tuple[int, int]] = None    # (features, t) RNN shape
    cur_3d = None                                # InputType CNN3D tracking
    cur_ff: Optional[int] = None                 # FF feature count
    for li, lk in enumerate(layers_cfg):
        cls = lk["class_name"]
        cfg = _cfg(lk)
        kname = cfg.get("name", lk.get("name"))
        if kname:
            kcfgs[kname] = cfg
        if input_type is None:
            it = _input_type(cfg, InputType)
            if it is not None:
                input_type = it
                if it.kind == "CNN":
                    cur_conv_shape = (it.height, it.width, it.channels)
                elif it.kind == "RNN":
                    cur_rnn = True
                    cur_seq = (it.size, it.timeSeriesLength)
                elif it.kind == "CNN3D":
                    cur_3d = it
                elif it.kind == "FF":
                    cur_ff = it.size
        if cls == "InputLayer":
            continue
        if cls == "Flatten":
            if cur_conv_shape is not None \
                    and cur_conv_shape[0] * cur_conv_shape[1] == 1:
                # (b, c, 1, 1) -> (b, c): a pure squeeze — safe for ANY
                # consumer, no kernel-row permutation needed
                from deeplearning4j_tpu_torch.nn.conf.misc import ReshapeLayer
                c = cur_conv_shape[2]
                our_layers.append((ReshapeLayer(targetShape=(int(c),)),
                                   None, "reshape"))
                cur_conv_shape = None
                cur_ff = int(c)
                continue
            if cur_conv_shape is not None:
                pending_flatten[len(our_layers)] = cur_conv_shape
                continue
            if cur_3d is not None:
                # keras flattens (d, h, w, c); ours (c, d, h, w) — 4-tuple
                # marks the 3D kernel-row permutation for the next Dense
                pending_flatten[len(our_layers)] = (
                    cur_3d.depth, cur_3d.height, cur_3d.width,
                    cur_3d.channels)
                cur_3d = None
                continue
            if cur_rnn and cur_seq is not None and cur_seq[1] \
                    and cur_seq[1] > 0:
                # keras flattens (t, c): emit a keras-order ReshapeLayer so
                # downstream Dense kernels line up without permutation
                from deeplearning4j_tpu_torch.nn.conf.misc import ReshapeLayer
                f, t = cur_seq
                our_layers.append((ReshapeLayer(
                    targetShape=(int(t) * int(f),)), None, "reshape"))
                cur_rnn, cur_seq = False, None
                continue
            if cur_rnn:
                raise ValueError(
                    "Keras import: Flatten after 1-D/recurrent features "
                    "needs a statically-known sequence length (set the "
                    "Input shape) — or use GlobalMaxPooling1D/"
                    "GlobalAveragePooling1D heads")
            continue
        mapped = _map_keras_layer(cls, cfg, is_last=(li == n_layers - 1))
        if mapped is None:
            raise ValueError(f"Keras import: unsupported layer {cls}")
        lay, kind, out_c = mapped
        # a pending Flatten kernel-row permutation is keyed to THIS index:
        # only a Dense can absorb it; elementwise layers propagate it to
        # the next index (they run on the unflattened map, which is
        # numerically identical for elementwise ops); anything else would
        # silently mis-order features — refuse, like the graph path
        if len(our_layers) in pending_flatten and kind != "dense":
            if kind in ("dropout", "activation", "noise") \
                    and "softmax" not in str(getattr(lay, "activation", "")):
                pending_flatten[len(our_layers) + 1] = \
                    pending_flatten.pop(len(our_layers))
            else:
                raise ValueError(
                    f"Keras import: {cls} between Flatten and Dense is "
                    "unsupported (keras (h,w,c) vs our (c,h,w) flatten "
                    "order would silently mis-order features)")
        if kind == "prelu":
            _fix_prelu_axes(lay, "cnn" if cur_conv_shape is not None
                            else "cnn3d" if cur_3d is not None
                            else "rnn" if cur_rnn else "ff")
        if kind == "softmaxfix":
            if cur_conv_shape is not None or cur_3d is not None or cur_rnn:
                lay.activation = "softmax:1"   # channel-first feature axis
            kind = "activation"
        if kind == "staticnorm":
            rank = 4 if cur_conv_shape is not None else \
                5 if cur_3d is not None else 3 if cur_rnn else 2
            _check_norm_axis(lay, rank)
        if kind == "embedding" and getattr(lay, "inputLength", 0) < 0 \
                and cur_ff:
            # a 1-D integer Input: its size IS the sequence length
            lay.inputLength = int(cur_ff)
        if kind == "dense" and cur_rnn:
            # keras Dense on (b, t, f) applies per step.  A FINAL softmax
            # Dense becomes RnnOutputLayer (per-step softmax + loss, so
            # fit() still works); any other Dense wraps in TimeDistributed
            # so the output STAYS a sequence — same rules as the graph path
            from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
            from deeplearning4j_tpu_torch.nn.conf.recurrent import (
                RnnOutputLayer, TimeDistributed)
            if isinstance(lay, OutputLayer):
                lay = RnnOutputLayer(lossFunction="mcxent", nOut=lay.nOut,
                                     activation="softmax")
            else:
                lay, kind = TimeDistributed(lay), "tddense"
        our_layers.append((lay, kname if _is_weighty(kind) else None, kind))
        # track whether the CURRENT feature map is recurrent-shaped: a
        # last-step RNN, dense or global-pool head reduces to FF (the
        # graph path tracks the same via its rnn set)
        if kind in ("dense", "globalpool") \
                or type(lay).__name__ == "LastTimeStep" \
                or (kind == "bilstm"
                    and not getattr(lay, "returnSequences", True)):
            cur_rnn = False
            cur_seq = None
        elif kind in ("lstm", "bilstm", "simplernn", "gru", "embedding"):
            cur_rnn = True
            if cur_seq is not None or kind == "embedding":
                t = cur_seq[1] if cur_seq is not None else -1
                out_t = lay.getOutputType(
                    InputType.recurrent(cur_seq[0] if cur_seq else 0, t))
                cur_seq = (out_t.size, out_t.timeSeriesLength) \
                    if out_t.kind == "RNN" else None
        elif kind == "repeat":
            cur_rnn = True
            cur_seq = (int(cur_ff), lay.repetitionFactor) if cur_ff else None
        if kind in ("dense", "globalpool"):
            cur_conv_shape = None
        elif kind in _CNN_KINDS and cur_conv_shape is not None:
            cur_conv_shape = _track_shape(
                cur_conv_shape, lay, _out_channels(out_c, cur_conv_shape))
        if kind in ("conv1d", "pool", "crop1d", "pad1d", "upsample1d",
                    "lc1d") \
                and cur_seq is not None and cur_conv_shape is None:
            out_t = lay.getOutputType(InputType.recurrent(*cur_seq))
            cur_seq = (out_t.size, out_t.timeSeriesLength) \
                if out_t.kind == "RNN" else None
        if (kind in ("conv3d", "pool3d", "pad3d", "crop3d", "deconv3d",
                     "upsample3d") or kind.startswith("td")) \
                and cur_3d is not None:
            out_t = lay.getOutputType(cur_3d)
            if out_t.kind == "CNN3D":
                cur_3d = out_t
            elif out_t.kind == "RNN":      # tdflatten / tddense
                cur_3d = None
                cur_rnn = True
                cur_seq = (out_t.size, out_t.timeSeriesLength)
        elif (kind.startswith("td") or kind == "mha") \
                and cur_seq is not None:
            # TimeDistributed / MHA over (b, f, t): features may change
            out_t = lay.getOutputType(InputType.recurrent(*cur_seq))
            cur_rnn = True
            cur_seq = (out_t.size, out_t.timeSeriesLength)
        if kind == "dense":
            cur_ff = getattr(lay, "nOut", None)
        elif kind not in ("noise", "activation", "dropout", "ln", "bn",
                          "prelu", "masking", "staticnorm"):
            cur_ff = None
        if kind == "reshape":
            cur_in = None
            if cur_conv_shape is not None:
                cur_in = InputType.convolutional(*cur_conv_shape)
            elif cur_seq is not None:
                cur_in = InputType.recurrent(*cur_seq)
            elif cur_3d is not None:
                cur_in = cur_3d
            if cur_in is None and cls != "Flatten":
                # FF input: output type derivable from the target alone
                from deeplearning4j_tpu_torch.nn.conf.misc import \
                    _type_from_keras_dims
                tgt = getattr(lay, "targetShape", None)
                if tgt is None or -1 in tgt:
                    raise ValueError(
                        f"Keras import: {cls} needs statically-known "
                        "input dims here")
                out_t = _type_from_keras_dims(tgt)
            else:
                out_t = lay.getOutputType(cur_in)
            cur_conv_shape, cur_seq, cur_3d = None, None, None
            cur_rnn = False
            if out_t.kind == "CNN":
                # keras-side (h, w, c) == our-side dims
                cur_conv_shape = (out_t.height, out_t.width, out_t.channels)
            elif out_t.kind == "RNN":
                cur_rnn = True
                cur_seq = (out_t.size, out_t.timeSeriesLength)
            elif out_t.kind == "CNN3D":
                cur_3d = out_t

    for lay, _k, _kind in our_layers:
        builder = builder.layer(lay)
    if input_type is not None:
        builder = builder.setInputType(input_type)
    conf = builder.build()
    net = MultiLayerNetwork(conf, device=device)
    net.init()

    # ---- weights ----
    for i, (lay, kname, kind) in enumerate(our_layers):
        if kname is None:
            continue
        ws = store.get(kname)
        if not ws:
            continue
        li = str(i)
        _load_layer_weights(net.params_.get(li), net.state_.get(li),
                            kind, ws, kcfgs.get(kname, {}),
                            flatten_shape=pending_flatten.get(i))
    return _placed(net)


def _lstm_weights_into(sub, kern, rec, bias):
    """Keras LSTM gate order (i, f, g, o) -> ours (i, f, o, g)."""
    u = rec.shape[0]

    def reorder(m):
        i_, f_, g_, o_ = (m[..., 0*u:1*u], m[..., 1*u:2*u],
                          m[..., 2*u:3*u], m[..., 3*u:4*u])
        return np.concatenate([i_, f_, o_, g_], axis=-1)
    sub["W"] = _put(reorder(kern))
    sub["RW"] = _put(reorder(rec))
    if bias is not None:
        sub["b"] = _put(reorder(bias))


def _gru_weights_into(sub, kern, rec, bias):
    """Keras GRU gate order (z, r, h) -> ours (r, u=z, c=h)."""
    u = rec.shape[0]

    def reorder(m):
        z_, r_, h_ = (m[..., 0*u:1*u], m[..., 1*u:2*u], m[..., 2*u:3*u])
        return np.concatenate([r_, z_, h_], axis=-1)
    sub["W"] = _put(reorder(kern))
    sub["RW"] = _put(reorder(rec))
    if bias is not None:
        if bias.ndim == 2:   # reset_after: (2, 3u) input/recurrent biases
            sub["b"] = _put(reorder(bias[0]))
            sub["b2"] = _put(reorder(bias[1]))
        else:
            sub["b"] = _put(reorder(bias))


def _simplernn_weights_into(sub, kern, rec, bias):
    sub["W"] = _put(kern)
    sub["RW"] = _put(rec)
    if bias is not None:
        sub["b"] = _put(bias)


_RNN_LOADERS = {"LSTM": _lstm_weights_into, "GRU": _gru_weights_into,
                "SimpleRNN": _simplernn_weights_into}


def _put(a) -> torch.Tensor:
    """A re-laid-out keras weight as a float32 host tensor; :func:`_placed`
    moves it onto the net's device."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _placed(net):
    """``net`` with every parameter and state leaf on its device (the
    loaded weights arrive on the host)."""
    def move(tree):
        return {k: move(v) if isinstance(v, dict) else
                v.to(net.device) if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}
    net.params_ = move(net.params_)
    net.state_ = move(net.state_)
    return net


def _load_layer_weights(p, s, kind, ws, kcfg, flatten_shape=None):
    """Write one Keras layer's weight list into this framework's param/state
    dicts (mutated in place), re-laid-out per the module docstring.  Shared
    by the Sequential and ComputationGraph import paths (the reference's
    per-layer ``KerasLayer.setWeights`` — SURVEY §2.5)."""
    if p is None and s is None:
        return
    p = {} if p is None else p
    if kind.startswith("td") and kind != "tdflatten":
        # TimeDistributed wrapper: params ARE the inner layer's params;
        # the keras h5 group likewise stores the inner layer's weights
        kind = kind[2:]
        kcfg = kcfg.get("layer", {}).get("config", kcfg)
    if kind == "dense":
        kern, bias = ws[0], (ws[1] if len(ws) > 1 else None)
        if flatten_shape is not None and len(flatten_shape) == 4:
            d, h, w, c = flatten_shape
            # rows are (d, h, w, c)-ordered; ours expect (c, d, h, w)
            kern = kern.reshape(d, h, w, c, -1).transpose(3, 0, 1, 2, 4) \
                .reshape(d * h * w * c, -1)
        elif flatten_shape is not None:
            h, w, c = flatten_shape
            # rows are (h, w, c)-ordered; ours expect (c, h, w)
            kern = kern.reshape(h, w, c, -1).transpose(2, 0, 1, 3) \
                .reshape(h * w * c, -1)
        p["W"] = _put(kern)
        if bias is not None and "b" in p:
            p["b"] = _put(bias)
    elif kind == "conv":
        kern = ws[0]                      # HWIO
        p["W"] = _put(kern.transpose(3, 2, 0, 1))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1])
    elif kind == "conv1d":
        kern = ws[0]                      # keras (k, in, out) -> (O, I, k)
        p["W"] = _put(kern.transpose(2, 1, 0))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1])
    elif kind == "bn":
        # keras order: [gamma if scale][beta if center] mean, variance
        idx = 0
        if kcfg.get("scale", True):
            p["gamma"] = _put(ws[idx])
            idx += 1
        if kcfg.get("center", True):
            p["beta"] = _put(ws[idx])
            idx += 1
        s["mean"] = _put(ws[idx])
        s["var"] = _put(ws[idx + 1])
    elif kind == "lstm":
        _lstm_weights_into(p, ws[0], ws[1], ws[2] if len(ws) > 2 else None)
    elif kind == "bilstm":
        # keras weight order: forward [kern, rec, (bias)], backward [...]
        inner_cls = (kcfg.get("layer") or {}).get("class_name", "LSTM")
        into = _RNN_LOADERS[inner_cls]
        half = len(ws) // 2
        into(p["fwd"], *(list(ws[:half]) + [None] * (3 - half)))
        into(p["bwd"], *(list(ws[half:]) + [None] * (3 - half)))
    elif kind == "embedding":
        p["W"] = _put(ws[0])
    elif kind in ("sepconv", "dwconv"):
        # depthwise kernel (kh, kw, in, dm) -> (in*dm, 1, kh, kw)
        dk = ws[0]
        kh, kw, cin, dm = dk.shape
        p["W"] = _put(
            dk.transpose(2, 3, 0, 1).reshape(cin * dm, 1, kh, kw))
        rest = 1
        if kind == "sepconv":
            # pointwise (1, 1, in*dm, out) -> (out, in*dm, 1, 1)
            p["pW"] = _put(ws[1].transpose(3, 2, 0, 1))
            rest = 2
        if len(ws) > rest and "b" in p:
            p["b"] = _put(ws[rest])
    elif kind == "deconv":
        # Keras kernel (kh, kw, out, in) -> ours (out, in, kh, kw)
        p["W"] = _put(ws[0].transpose(2, 3, 0, 1))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1])
    elif kind == "simplernn":
        _simplernn_weights_into(p, ws[0], ws[1],
                                ws[2] if len(ws) > 2 else None)
    elif kind == "ln":
        idx = 0
        if kcfg.get("scale", True):
            p["gamma"] = _put(ws[idx])
            idx += 1
        if kcfg.get("center", True):
            p["beta"] = _put(ws[idx])
    elif kind == "mha":
        # keras order: query/kernel+bias, key/..., value/...,
        # attention_output/kernel+bias — shapes match our params directly
        if len(ws) == 8:
            (p["Wq"], p["bq"], p["Wk"], p["bk"], p["Wv"], p["bv"],
             p["Wo"], p["bo"]) = (_put(w) for w in ws)
        else:
            p["Wq"], p["Wk"], p["Wv"], p["Wo"] = (_put(w)
                                                  for w in ws)
    elif kind == "conv3d":
        # keras (kd, kh, kw, in, out) -> ours OIDHW
        p["W"] = _put(ws[0].transpose(4, 3, 0, 1, 2))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1])
    elif kind == "gru":
        _gru_weights_into(p, ws[0], ws[1], ws[2] if len(ws) > 2 else None)
    elif kind == "prelu":
        a = ws[0]                         # keras channels-last alpha
        if a.ndim == 4:                   # (d, h, w, c) -> (c, d, h, w)
            a = a.transpose(3, 0, 1, 2)
        elif a.ndim == 3:                 # (h, w, c) -> (c, h, w)
            a = a.transpose(2, 0, 1)
        elif a.ndim == 2:                 # (t, f) -> (f, t)
            a = a.transpose(1, 0)
        p["alpha"] = _put(a)
    elif kind == "deconv3d":
        # keras (kd, kh, kw, out, in) -> ours (O, I, kd, kh, kw)
        p["W"] = _put(ws[0].transpose(3, 4, 0, 1, 2))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1])
    elif kind == "lc2d":
        # keras (P, kh*kw*c, f) patch order (kh, kw, c) -> ours (c, kh, kw);
        # keras bias is PER-POSITION (oh, ow, f) — ours broadcasts (P, f)
        kern = ws[0]
        kh, kw = (int(v) for v in kcfg.get("kernel_size", [3, 3]))
        P, kkc, f_ = kern.shape
        c = kkc // (kh * kw)
        p["W"] = _put(
            kern.reshape(P, kh, kw, c, f_).transpose(0, 3, 1, 2, 4)
            .reshape(P, c * kh * kw, f_))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1].reshape(P, f_))
    elif kind == "staticnorm":
        # keras Normalization weights: mean, variance[, count] — adapt()
        # statistics, held as STATE (never trained)
        s["mean"] = _put(np.asarray(ws[0]).reshape(-1))
        s["var"] = _put(np.asarray(ws[1]).reshape(-1))
    elif kind == "lc1d":
        # keras (ot, k*c, f) patch order (k, c) -> ours (c, k)
        kern = ws[0]
        ksz = kcfg.get("kernel_size", [3])
        k = int(ksz[0] if isinstance(ksz, (list, tuple)) else ksz)
        ot, kc, f_ = kern.shape
        c = kc // k
        p["W"] = _put(
            kern.reshape(ot, k, c, f_).transpose(0, 2, 1, 3)
            .reshape(ot, c * k, f_))
        if len(ws) > 1 and "b" in p:
            p["b"] = _put(ws[1].reshape(ot, f_))


#: Keras merge-layer class -> graph vertex construction
_MERGE_CLASSES = {"Add": "Add", "Subtract": "Subtract",
                  "Multiply": "Product", "Average": "Average",
                  "Maximum": "Max", "Minimum": "Min", "Concatenate": None}


def _build_graph(full_cfg: Dict, layers_cfg: List[Dict], store,
                 device=None):
    """Branching Functional Keras model → ComputationGraph.

    Reference: ``KerasModel``'s Functional handling (deeplearning4j-
    modelimport ``.../keras/KerasModel.java``, SURVEY §2.5): layers are
    topologically ordered via ``inbound_nodes``; merge layers become graph
    vertices (Add/Subtract/Multiply/Average/Maximum → ElementWiseVertex,
    Concatenate → MergeVertex); everything else reuses the Sequential
    path's per-layer mapping (``_map_keras_layer``) and weight re-layout
    (``_load_layer_weights``)."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph
    from deeplearning4j_tpu_torch.models.graph_conf import (ElementWiseVertex,
                                                      MergeVertex)
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType, NeuralNetConfiguration)

    inbound = _inbound_edges(layers_cfg)
    scalars = _inbound_scalars(layers_cfg)
    by_name: Dict[str, Dict] = {}
    for lk in layers_cfg:
        by_name[_cfg(lk).get("name", lk.get("name"))] = lk

    # Kahn topo sort (keras serializes in topo order already; be robust)
    indeg = {n: len([s for s in srcs if s in by_name])
             for n, srcs in inbound.items()}
    consumers: Dict[str, List[str]] = {n: [] for n in by_name}
    for n, srcs in inbound.items():
        for s in srcs:
            if s in consumers:
                consumers[s].append(n)
    ready = sorted(n for n, d in indeg.items() if d == 0)
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for d in consumers[n]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(by_name):
        raise ValueError("Keras import: cyclic Functional topology")

    # output nodes: model config's output_layers, else no-consumer nodes
    outputs: List[str] = []
    for entry in full_cfg.get("output_layers", []):
        if isinstance(entry, (list, tuple)):
            outputs.append(entry[0])
        elif isinstance(entry, dict):      # keras3 keras_history form
            outputs.append(entry.get("config", {})
                           .get("keras_history", [None])[0])
    outputs = [o for o in outputs if o] or \
        [n for n in order if not consumers[n]]

    gb = NeuralNetConfiguration.builder().graphBuilder()
    input_types: List = []
    alias: Dict[str, str] = {}          # skipped node -> effective source
    shapes: Dict[str, Optional[Tuple[int, int, int]]] = {}  # keras (h,w,c)
    rnn: set = set()                    # nodes with 3D (b, t, f) output
    vol: set = set()                    # nodes with CNN3D (NCDHW) output
    flat_of: Dict[str, Tuple[int, int, int]] = {}  # node -> conv shape its
    # flattened output came from (propagated through layout-preserving nodes)
    weighty: List[Tuple[str, str]] = []  # (node name, kind)
    kcfgs: Dict[str, Dict] = {}
    pending_flatten: Dict[str, Tuple[int, int, int]] = {}

    def src_of(name: str) -> List[str]:
        return [alias.get(s, s) for s in inbound.get(name, [])]

    for name in order:
        lk = by_name[name]
        cls = lk["class_name"]
        cfg = _cfg(lk)
        kcfgs[name] = cfg
        raw_srcs = inbound.get(name, [])
        srcs = src_of(name)
        if cls == "InputLayer":
            gb.addInputs(name)
            it = _input_type(cfg, InputType)
            if it is None:
                raise ValueError(
                    f"Keras import: InputLayer {name!r} lacks batch_shape")
            input_types.append(it)
            if it.kind == "CNN":
                shapes[name] = (it.height, it.width, it.channels)
            else:
                shapes[name] = None
                if it.kind == "RNN":
                    rnn.add(name)
                elif it.kind == "CNN3D":
                    vol.add(name)
            continue
        if cls == "Flatten":
            s0 = shapes.get(srcs[0])
            if s0 is not None and s0[0] * s0[1] == 1:
                # (b, c, 1, 1) -> (b, c): a pure squeeze — safe for ANY
                # consumer (no (h,w,c)-order permutation involved)
                from deeplearning4j_tpu_torch.nn.conf.misc import ReshapeLayer
                gb.addLayer(name, ReshapeLayer(targetShape=(s0[2],)),
                            srcs[0])
                shapes[name] = None
                continue
            alias[name] = srcs[0]
            if s0 is not None:
                flat_of[name] = s0
            shapes[name] = None
            continue
        # Keras flattens (h, w, c)-order; our CnnToFF flattens (c, h, w).
        # Only a Dense consumer can absorb that by kernel-row permutation;
        # Dropout/Activation preserve the layout (propagate), anything else
        # would silently mis-order features -> reject.
        flat_src = next((flat_of[s] for s in raw_srcs if s in flat_of), None)
        if cls in _MERGE_CLASSES:
            if flat_src is not None:
                raise ValueError(
                    f"Keras import: {cls} over a Flatten of a conv map is "
                    "unsupported (keras (h,w,c) vs our (c,h,w) flatten "
                    "order would silently mis-order features)")
            lits = scalars.get(name)
            if lits:
                # keras-3 scalar operands (x + 3.0, x * (1/6) — the
                # MobileNetV3 hard-sigmoid pattern) fold into an affine
                # layer; dropping them would silently change the model
                from deeplearning4j_tpu_torch.nn.conf.misc import RescaleLayer
                vals = [v for _i, v in lits]
                if len(srcs) != 1:
                    raise ValueError(
                        f"Keras import: {cls} mixing scalar and multiple "
                        "tensor operands is unsupported")
                if cls == "Add":
                    lay = RescaleLayer(scale=1.0, offset=float(sum(vals)))
                elif cls == "Multiply":
                    lay = RescaleLayer(scale=float(np.prod(vals)))
                elif cls == "Subtract" and lits[0][0] != 0:
                    lay = RescaleLayer(scale=1.0, offset=-float(vals[0]))
                else:
                    raise ValueError(
                        f"Keras import: {cls} with scalar operands "
                        f"{vals} is unsupported")
                gb.addLayer(name, lay, srcs[0])
                shapes[name] = shapes.get(srcs[0])
                if srcs[0] in rnn:
                    rnn.add(name)
                if srcs[0] in vol:
                    vol.add(name)
                continue
            op = _MERGE_CLASSES[cls]
            if op is None:
                axis = cfg.get("axis", -1)
                s0 = shapes.get(srcs[0])
                if any(s in rnn for s in srcs):   # (b, t, f): f is 2 / -1
                    ok = axis in (-1, 2)
                elif s0 is not None:              # (b, h, w, c): c is 3 / -1
                    ok = axis in (-1, 3)
                else:                             # (b, f)
                    ok = axis in (-1, 1)
                if not ok:
                    raise ValueError(
                        f"Keras import: Concatenate axis={axis} unsupported "
                        "(only the channel/feature axis)")
                gb.addVertex(name, MergeVertex(), *srcs)
                if all(shapes.get(s) is not None for s in srcs):
                    h, w, _ = shapes[srcs[0]]
                    shapes[name] = (h, w,
                                    sum(shapes[s][2] for s in srcs))
                else:
                    shapes[name] = None
            else:
                gb.addVertex(name, ElementWiseVertex(op), *srcs)
                shapes[name] = shapes.get(srcs[0])
            if any(s in rnn for s in srcs):
                rnn.add(name)
            if any(s in vol for s in srcs):
                vol.add(name)
            continue
        mapped = _map_keras_layer(cls, cfg, is_last=(name in outputs))
        if mapped is None:
            raise ValueError(f"Keras import: unsupported layer {cls}")
        lay, kind, out_c = mapped
        if kind == "prelu":
            _fix_prelu_axes(lay, "cnn" if shapes.get(srcs[0]) is not None
                            else "cnn3d" if srcs[0] in vol
                            else "rnn" if srcs[0] in rnn else "ff")
        if kind == "softmaxfix":
            if shapes.get(srcs[0]) is not None or srcs[0] in rnn \
                    or srcs[0] in vol:
                lay.activation = "softmax:1"   # channel-first feature axis
            kind = "activation"
        if kind == "staticnorm":
            rank = 4 if shapes.get(srcs[0]) is not None else \
                5 if srcs[0] in vol else 3 if srcs[0] in rnn else 2
            _check_norm_axis(lay, rank)
        if kind == "mha":
            # keras calls MHA with (query, value[, key]); self-attention
            # repeats one source — the only form a single-input layer node
            # can represent
            if len(set(srcs)) != 1:
                raise ValueError(
                    "Keras import: MultiHeadAttention with distinct "
                    "query/value sources (cross-attention) is unsupported; "
                    "self-attention (mha(x, x)) imports")
            srcs = srcs[:1]
        if flat_src is not None:
            if kind == "dense":
                # (h, w, c)->(c, h, w) kernel-row permutation
                pending_flatten[name] = flat_src
            elif kind in ("dropout", "activation"):
                flat_of[name] = flat_src       # layout-preserving: propagate
            else:
                raise ValueError(
                    f"Keras import: {cls} consuming a Flatten of a conv "
                    "map is unsupported (flatten-order mismatch would "
                    "silently mis-order features)")
        if kind == "dense" and srcs[0] in rnn:
            # keras Dense on (b, t, f) applies per step; a FINAL softmax
            # Dense becomes RnnOutputLayer (keeps a loss layer for fit);
            # others wrap in TimeDistributed so the RNN format survives
            # the vertex (a bare Dense would round-trip (b*t, f)
            # preprocessors and break downstream merges)
            from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
            from deeplearning4j_tpu_torch.nn.conf.recurrent import (
                RnnOutputLayer, TimeDistributed)
            if isinstance(lay, OutputLayer):
                lay = RnnOutputLayer(lossFunction="mcxent", nOut=lay.nOut,
                                     activation="softmax")
            else:
                lay, kind = TimeDistributed(lay), "tddense"
        gb.addLayer(name, lay, *srcs)
        if _is_weighty(kind):
            weighty.append((name, kind))
        if kind == "tddense":
            shapes[name] = None
            rnn.add(name)
        elif kind in ("lstm", "simplernn", "gru"):
            shapes[name] = None
            if cfg.get("return_sequences", False):
                rnn.add(name)
        elif kind in ("embedding", "mha", "repeat"):
            shapes[name] = None
            rnn.add(name)                      # sequence output: (b,t,f)
        elif kind in ("dense", "globalpool"):
            shapes[name] = None
        elif kind in _CNN_KINDS:
            cur = shapes.get(srcs[0])
            shapes[name] = _track_shape(cur, lay, _out_channels(out_c, cur))
        elif kind in ("conv3d", "pool3d", "pad3d", "crop3d", "deconv3d",
                      "upsample3d"):
            shapes[name] = None
            vol.add(name)
        else:                               # bn / ln / activation / dropout
            shapes[name] = shapes.get(srcs[0])
            if srcs[0] in rnn:
                rnn.add(name)
            if srcs[0] in vol:
                vol.add(name)

    gb.setInputTypes(*input_types)
    gb.setOutputs(*[alias.get(o, o) for o in outputs])
    net = ComputationGraph(gb.build(), device=device)
    net.init()

    for name, kind in weighty:
        ws = store.get(name)
        if not ws:
            continue
        _load_layer_weights(net.params_.get(name), net.state_.get(name),
                            kind, ws, kcfgs.get(name, {}),
                            flatten_shape=pending_flatten.get(name))
    return _placed(net)
