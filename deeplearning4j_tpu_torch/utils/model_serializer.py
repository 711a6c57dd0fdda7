"""Model checkpoint serialization — the port of
``deeplearning4j_tpu/utils/model_serializer.py`` (deeplearning4j-nn's
``ModelSerializer.java``).

The zip is the reference's, entry for entry, so a model written by
either package restores in the other:

- ``configuration.json``: the configuration's JSON (byte-equal between
  the packages);
- ``coefficients.bin``: the flat parameter vector, little-endian float32,
  in ``params()`` order;
- ``updaterState.bin`` (with ``saveUpdater``): the updater state's leaves
  in sorted key order, concatenated, little-endian float32;
- ``arrays.npz``: every tensor under its path, ``params/<layer>/<name>``,
  ``state/<layer>/<name>`` (BatchNormalization's running statistics) and
  ``updater/<layer>/<param>/<slot>`` — the path restore reads;
- ``meta.json``: the model's type and its iteration and epoch counts;
- ``normalizer.npz`` (with a normalizer): its kind and statistics.

The entries are stored, not deflated (the reference deflates; either
package reads both): float32 parameters and updater state barely
compress, and deflate is the slow part of writing a large model.  A
restore places the model on ``cuda`` unless the caller passes another
device.
"""
from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

__all__ = ["ModelSerializer"]

CONFIG_JSON = "configuration.json"
COEFFICIENTS_BIN = "coefficients.bin"
UPDATER_BIN = "updaterState.bin"
ARRAYS_NPZ = "arrays.npz"
NORMALIZER_NPZ = "normalizer.npz"
META_JSON = "meta.json"


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _flatten_tree(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            _flatten_tree(f"{prefix}/{k}" if prefix else str(k), tree[k], out)
    elif tree is not None:
        out[prefix] = _host(tree)


def _unflatten(arrays, section: str) -> dict:
    """The ``section/...`` entries as a nested dict of numpy arrays."""
    root: dict = {}
    for key, a in arrays.items():
        parts = key.split("/")
        if parts[0] != section:
            continue
        d = root
        for p in parts[1:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = a
    return root


class ModelSerializer:
    @staticmethod
    def writeModel(model, path, saveUpdater: bool = True,
                   normalizer=None) -> None:
        arrays: dict = {}
        _flatten_tree("params", model.params_ or {}, arrays)
        _flatten_tree("state", model.state_ or {}, arrays)
        if saveUpdater and model.optState_:
            _flatten_tree("updater", model.optState_, arrays)
        npz_buf = io.BytesIO()
        np.savez(npz_buf, **arrays)
        meta = {"modelType": type(model).__name__,
                "iterationCount": getattr(model, "iterationCount", 0),
                "epochCount": getattr(model, "epochCount", 0),
                "framework": "deeplearning4j_tpu_torch"}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            z.writestr(CONFIG_JSON, model.conf.toJson())
            z.writestr(COEFFICIENTS_BIN,
                       _host(model.params()).astype("<f4").tobytes())
            if saveUpdater and model.optState_ is not None:
                upd: dict = {}
                _flatten_tree("", model.optState_, upd)
                flat = np.concatenate([v.ravel() for v in upd.values()]) \
                    if upd else np.zeros(0, np.float32)
                z.writestr(UPDATER_BIN, flat.astype("<f4").tobytes())
            z.writestr(ARRAYS_NPZ, npz_buf.getvalue())
            z.writestr(META_JSON, json.dumps(meta))
            if normalizer is not None:
                nbuf = io.BytesIO()
                if hasattr(normalizer, "mean"):
                    np.savez(nbuf, kind="standardize", mean=normalizer.mean,
                             std=normalizer.std)
                elif hasattr(normalizer, "dataMin"):
                    np.savez(nbuf, kind="minmax", dataMin=normalizer.dataMin,
                             dataMax=normalizer.dataMax,
                             range=[normalizer.minRange, normalizer.maxRange])
                else:
                    np.savez(nbuf, kind="image",
                             range=[normalizer.minRange, normalizer.maxRange,
                                    normalizer.maxPixelVal])
                z.writestr(NORMALIZER_NPZ, nbuf.getvalue())

    @staticmethod
    def restoreMultiLayerNetwork(path, loadUpdater: bool = True,
                                 device=None):
        from deeplearning4j_tpu_torch.models.multilayer import \
            MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
        with zipfile.ZipFile(path, "r") as z:
            conf = MultiLayerConfiguration.fromJson(
                z.read(CONFIG_JSON).decode())
            net = MultiLayerNetwork(conf, device=device)
            ModelSerializer._restoreInto(net, z, loadUpdater)
        return net

    @staticmethod
    def restoreComputationGraph(path, loadUpdater: bool = True, device=None):
        from deeplearning4j_tpu_torch.models.graph import ComputationGraph
        from deeplearning4j_tpu_torch.models.graph_conf import \
            ComputationGraphConfiguration
        with zipfile.ZipFile(path, "r") as z:
            conf = ComputationGraphConfiguration.fromJson(
                z.read(CONFIG_JSON).decode())
            net = ComputationGraph(conf, device=device)
            ModelSerializer._restoreInto(net, z, loadUpdater)
        return net

    @staticmethod
    def _restoreInto(net, z: zipfile.ZipFile, loadUpdater: bool):
        with np.load(io.BytesIO(z.read(ARRAYS_NPZ)),
                     allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
        net.init(params=_unflatten(arrays, "params"))
        state = _unflatten(arrays, "state")
        for key, st in state.items():
            net.state_[key] = {k: torch.from_numpy(v).to(net.device)
                               for k, v in st.items()}
        if loadUpdater and any(k.startswith("updater/") for k in arrays):
            # fill the fresh updater state slot by slot: its layout is
            # {layer: {param path: {slot: tensor}}}, and a param path may
            # hold a "/" (a Bidirectional half)
            for key, per_param in net.optState_.items():
                for path, slots in per_param.items():
                    for slot in slots:
                        name = f"updater/{key}/{path}/{slot}"
                        if name not in arrays:
                            raise ValueError(
                                f"the zip's updater state lacks {name}")
                        slots[slot] = torch.from_numpy(
                            arrays[name]).to(net.device)
        meta = json.loads(z.read(META_JSON).decode()) \
            if META_JSON in z.namelist() else {}
        net.iterationCount = meta.get("iterationCount", 0)
        net.epochCount = meta.get("epochCount", 0)

    @staticmethod
    def restoreNormalizer(path):
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            ImagePreProcessingScaler, NormalizerMinMaxScaler,
            NormalizerStandardize)
        with zipfile.ZipFile(path, "r") as z:
            if NORMALIZER_NPZ not in z.namelist():
                return None
            with np.load(io.BytesIO(z.read(NORMALIZER_NPZ)),
                         allow_pickle=False) as npz:
                kind = str(npz["kind"])
                if kind == "standardize":
                    n = NormalizerStandardize()
                    n.mean, n.std = npz["mean"], npz["std"]
                    return n
                if kind == "minmax":
                    n = NormalizerMinMaxScaler(*npz["range"].tolist())
                    n.dataMin, n.dataMax = npz["dataMin"], npz["dataMax"]
                    return n
                r = npz["range"].tolist()
                return ImagePreProcessingScaler(r[0], r[1], r[2])
