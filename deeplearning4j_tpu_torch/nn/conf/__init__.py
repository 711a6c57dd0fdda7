"""Declarative network configuration DSL — the port of
``deeplearning4j_tpu/nn/conf/__init__.py`` (the reference's
``NeuralNetConfiguration`` / ``MultiLayerConfiguration``): fluent builders,
global defaults flowing into per-layer configs, InputType-driven nIn
inference and automatic preprocessor insertion, and the JSON round trip.
For the layers the port has, ``toJson()`` writes the same JSON as the JAX
package, so one JSON builds both nets.

``graphBuilder()`` returns the ComputationGraph builder of
``models/graph_conf.py``.  Every layer module of the reference is here,
the SameDiff layers (``SameDiffLayer``, ``SameDiffLambdaLayer``,
``SDLayerParams``) among them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.learning.config import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_json
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    Cnn3DToFeedForwardPreProcessor, CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor, FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor, InputPreProcessor, RnnToCnnPreProcessor,
    RnnToFeedForwardPreProcessor)

__all__ = ["NeuralNetConfiguration", "MultiLayerConfiguration",
           "GradientNormalization", "BackpropType", "InputType",
           "WorkspaceMode"]


class GradientNormalization:
    None_ = "None"
    RenormalizeL2PerLayer = "RenormalizeL2PerLayer"
    RenormalizeL2PerParamType = "RenormalizeL2PerParamType"
    ClipElementWiseAbsoluteValue = "ClipElementWiseAbsoluteValue"
    ClipL2PerLayer = "ClipL2PerLayer"
    ClipL2PerParamType = "ClipL2PerParamType"


class BackpropType:
    Standard = "Standard"
    TruncatedBPTT = "TruncatedBPTT"


class WorkspaceMode:
    """Accepted for parity (the configuration's workspace keys); PyTorch's
    caching allocator owns the buffers, so no mode changes anything."""
    ENABLED = "ENABLED"
    NONE = "NONE"
    SINGLE = "SINGLE"


_GLOBAL_KEYS = ["seed", "updater", "biasUpdater", "weightInit", "activation",
                "l1", "l2", "weightDecay", "biasInit", "dropOut",
                "convolutionMode", "gradientNormalization",
                "gradientNormalizationThreshold", "miniBatch", "dataType",
                "optimizationAlgo", "trainingWorkspaceMode",
                "inferenceWorkspaceMode", "cacheMode", "cudnnAlgoMode",
                "maxNumLineSearchIterations"]


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()`` (DL4J:
    ``new NeuralNetConfiguration.Builder()``)."""

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()

    class Builder:
        def __init__(self):
            self._g: Dict[str, Any] = {"seed": 123, "updater": Sgd(1e-2)}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            if name not in _GLOBAL_KEYS:
                raise AttributeError(
                    f"Unknown global config option {name!r}; known: "
                    f"{_GLOBAL_KEYS}")

            def setter(*args):
                self._g[name] = args[0] if len(args) == 1 else tuple(args)
                return self

            return setter

        def list(self) -> "ListBuilder":
            return ListBuilder(dict(self._g))

        def graphBuilder(self):
            from deeplearning4j_tpu_torch.models.graph_conf import \
                GraphBuilder
            return GraphBuilder(dict(self._g))


class ListBuilder:
    """DL4J ``NeuralNetConfiguration.ListBuilder``."""

    def __init__(self, global_conf: Dict[str, Any]):
        self._g = global_conf
        self._layers: List[Layer] = []
        self._inputType: Optional[InputType] = None
        self._preprocs: Dict[int, InputPreProcessor] = {}
        self._backpropType = BackpropType.Standard
        self._tbpttFwd = 20
        self._tbpttBack = 20

    def layer(self, idx_or_layer, maybe_layer: Optional[Layer] = None):
        self._layers.append(maybe_layer if maybe_layer is not None
                            else idx_or_layer)
        return self

    def setInputType(self, it: InputType):
        self._inputType = it
        return self

    def inputPreProcessor(self, idx: int, p: InputPreProcessor):
        self._preprocs[int(idx)] = p
        return self

    def backpropType(self, bt: str):
        self._backpropType = bt
        return self

    def tBPTTForwardLength(self, n: int):
        self._tbpttFwd = int(n)
        return self

    def tBPTTBackwardLength(self, n: int):
        self._tbpttBack = int(n)
        return self

    def tBPTTLength(self, n: int):
        self._tbpttFwd = self._tbpttBack = int(n)
        return self

    def validateOutputLayerConfig(self, v: bool):
        """Accepted as the reference accepts it, which never reads it."""
        return self

    def pipelineStages(self, n: int):
        raise NotImplementedError(
            "GPipe pipeline stages are not ported yet (ROADMAP A10)")

    def build(self) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=self._layers, globalConf=self._g, inputType=self._inputType,
            preProcessors=dict(self._preprocs),
            backpropType=self._backpropType, tbpttFwdLength=self._tbpttFwd,
            tbpttBackLength=self._tbpttBack)


def _auto_preprocessor(cur: InputType, want: Optional[str]
                       ) -> Optional[InputPreProcessor]:
    """DL4J ``InputType.getPreProcessorForInputType`` logic."""
    if want is None:
        return None
    k = cur.kind
    if want == "FF":
        if k == "CNN":
            return CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                                cur.channels)
        if k == "CNN3D":
            return Cnn3DToFeedForwardPreProcessor(
                cur.depth, cur.height, cur.width, cur.channels)
        if k == "RNN":
            return RnnToFeedForwardPreProcessor()
    elif want == "CNN":
        if k == "CNNFlat":
            return FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                                cur.channels)
        if k == "FF":
            raise ValueError("Cannot infer CNN input from FF input type; "
                             "set an explicit preprocessor")
    elif want == "RNN":
        if k == "FF":
            return FeedForwardToRnnPreProcessor()
        if k == "CNN":
            return CnnToRnnPreProcessor(cur.height, cur.width, cur.channels)
    return None


class MultiLayerConfiguration:
    """Reference: ``MultiLayerConfiguration.java``."""

    def __init__(self, layers: List[Layer], globalConf: Dict[str, Any],
                 inputType: Optional[InputType] = None,
                 preProcessors: Optional[Dict[int, InputPreProcessor]] = None,
                 backpropType: str = BackpropType.Standard,
                 tbpttFwdLength: int = 20, tbpttBackLength: int = 20):
        self.layers = layers
        self.globalConf = globalConf
        self.inputType = inputType
        self.preProcessors = preProcessors or {}
        self.backpropType = backpropType
        self.tbpttFwdLength = tbpttFwdLength
        self.tbpttBackLength = tbpttBackLength
        self.layerInputTypes: List[Optional[InputType]] = []
        self._resolve()

    def _resolve(self) -> None:
        """Apply global defaults, insert preprocessors, infer nIn per layer."""
        cur = self.inputType
        for i, layer in enumerate(self.layers):
            layer.applyGlobalDefaults(self.globalConf)
            if layer.name is None:
                layer.name = f"layer{i}"
            if cur is not None:
                if i not in self.preProcessors:
                    p = _auto_preprocessor(cur, layer.preferredFormat())
                    if p is not None:
                        self.preProcessors[i] = p
                if i in self.preProcessors:
                    cur = self.preProcessors[i].getOutputType(cur)
                layer.inferNIn(cur)
                self.layerInputTypes.append(cur)
                cur = layer.getOutputType(cur)
            else:
                self.layerInputTypes.append(None)

    # -- serde -----------------------------------------------------------
    def toJson(self) -> str:
        g = {k: v.toJson() if isinstance(v, IUpdater) else v
             for k, v in self.globalConf.items()}
        return json.dumps({
            "globalConf": g,
            "layers": [l.toJson() for l in self.layers],
            "inputType": self.inputType.toJson() if self.inputType else None,
            "preProcessors": {str(k): v.toJson()
                              for k, v in self.preProcessors.items()},
            "backpropType": self.backpropType,
            "tbpttFwdLength": self.tbpttFwdLength,
            "tbpttBackLength": self.tbpttBackLength,
        }, indent=2, default=_json_default)

    @staticmethod
    def fromJson(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        g = dict(d["globalConf"])
        for k in ("updater", "biasUpdater"):
            if isinstance(g.get(k), dict):
                g[k] = IUpdater.fromJson(g[k])
        layers = [layer_from_json(ld) for ld in d["layers"]]
        it = InputType.fromJson(d["inputType"]) if d.get("inputType") \
            else None
        pps = {int(k): InputPreProcessor.fromJson(v)
               for k, v in (d.get("preProcessors") or {}).items()}
        return MultiLayerConfiguration(
            layers=layers, globalConf=g, inputType=it, preProcessors=pps,
            backpropType=d.get("backpropType", BackpropType.Standard),
            tbpttFwdLength=d.get("tbpttFwdLength", 20),
            tbpttBackLength=d.get("tbpttBackLength", 20))

    def __len__(self):
        return len(self.layers)


def _json_default(o):
    if hasattr(o, "toJson"):
        return o.toJson()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    return str(o)


# importing these registers their layers with ``layer_from_json``
from deeplearning4j_tpu_torch.nn.conf import attention  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.conf.autoencoder import AutoEncoder  # noqa: E402,F401,E501
from deeplearning4j_tpu_torch.nn.conf import convolutional  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.conf import convolutional3d  # noqa: E402,F401,E501
from deeplearning4j_tpu_torch.nn.conf import embedding  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.conf import misc  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.conf import recurrent  # noqa: E402,F401
from deeplearning4j_tpu_torch.nn.conf.variational import (  # noqa: E402,F401
    VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.conf.samediff_layer import (  # noqa: E402,F401,E501
    SameDiffLambdaLayer, SameDiffLayer, SDLayerParams)
