"""Layer configurations and their forward functions — the port of the core
of ``deeplearning4j_tpu/nn/conf/layers.py`` (the reference's
``conf/layers/*.java`` config side and ``nn/layers/**`` forward side).

Each layer config carries a pure ``forward(params, x, train, gen, state)``
over a dict of parameter tensors; autograd of the composed network gives
backprop.  ``gen`` is the ``torch.Generator`` (on the activations' device)
that input dropout draws from, or None (no dropout).

Ported so far: ``Layer``, ``BaseLayer``, ``DenseLayer`` and the
``_Builder``/``register_layer``/``layer_from_json`` machinery; the
attention and RNN output layers register from their own modules.  The
other layers (convolution, subsampling, batch norm, output, embedding,
pooling, ...) wait for ROADMAP A4.

Data formats (DL4J conventions): FF ``(b, n)``; CNN ``(b, c, h, w)``;
RNN ``(b, n, t)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.learning.config import IUpdater
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["Layer", "BaseLayer", "DenseLayer", "register_layer",
           "layer_from_json"]


class _Builder:
    """Generic fluent builder: any method call sets the same-named field."""

    def __init__(self, cls, **kw):
        self._cls = cls
        self._kw = kw

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def setter(*args):
            self._kw[name] = args[0] if len(args) == 1 else tuple(args)
            return self

        return setter

    def build(self):
        fields = {f.name for f in dataclasses.fields(self._cls)}
        unknown = set(self._kw) - fields
        if unknown:
            raise ValueError(f"{self._cls.__name__}: unknown config "
                             f"option(s) {sorted(unknown)}")
        return self._cls(**self._kw)


@dataclasses.dataclass
class Layer:
    """Base layer config (reference: ``conf/layers/Layer.java``)."""
    name: Optional[str] = None

    # -- builder --------------------------------------------------------
    @classmethod
    def builder(cls, *args, **kw):
        b = _Builder(cls, **kw)
        if args:  # e.g. RnnOutputLayer.builder("mse")
            cls._builderArgs(b, *args)
        return b

    @classmethod
    def _builderArgs(cls, b, *args):
        raise TypeError(f"{cls.__name__}.builder takes no positional args")

    # -- config resolution ----------------------------------------------
    def applyGlobalDefaults(self, g: Dict[str, Any]) -> None:
        for field in ("activation", "weightInit", "updater", "biasUpdater",
                      "l1", "l2", "weightDecay", "biasInit", "dropOut",
                      "convolutionMode", "gradientNormalization",
                      "gradientNormalizationThreshold"):
            if hasattr(self, field) and getattr(self, field) is None \
                    and g.get(field) is not None:
                setattr(self, field, g[field])

    # -- shape inference -------------------------------------------------
    def preferredFormat(self) -> Optional[str]:
        """FF / CNN / RNN / None (= passthrough)."""
        return None

    def inferNIn(self, inputType: InputType) -> None:
        pass

    def getOutputType(self, inputType: InputType) -> InputType:
        return inputType

    # -- params ----------------------------------------------------------
    def initParams(self, gen: torch.Generator, inputType: InputType,
                   dtype=torch.float32, device=None) -> Dict:
        """Parameters drawn from ``gen`` (a CPU generator) onto ``device``
        (``cuda`` unless the caller asks for another)."""
        return {}

    def weightParamKeys(self):
        """Param names treated as weights for regularization (not biases)."""
        return ("W",)

    # -- forward ---------------------------------------------------------
    def forward(self, params: Dict, x, train: bool, gen, state: Dict
                ) -> Tuple[Any, Dict]:
        return x, state

    def hasLoss(self) -> bool:
        return False

    # -- serde -----------------------------------------------------------
    def toJson(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.toJson() if isinstance(v, IUpdater) else v
        d["@class"] = type(self).__name__
        return d


@dataclasses.dataclass
class BaseLayer(Layer):
    """Layer with params + the shared hyper-params every DL4J layer carries."""
    activation: Optional[str] = None
    weightInit: Optional[str] = None
    biasInit: Optional[float] = None
    updater: Optional[IUpdater] = None
    biasUpdater: Optional[IUpdater] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    weightDecay: Optional[float] = None
    dropOut: Optional[float] = None  # DL4J semantics: RETAIN probability
    gradientNormalization: Optional[str] = None
    gradientNormalizationThreshold: Optional[float] = None

    def _dropin(self, x, train, gen):
        """Input dropout (DL4J applies IDropout to the layer's input):
        keep each element with probability ``dropOut`` and scale it by
        1/dropOut."""
        if train and self.dropOut is not None and 0.0 < self.dropOut < 1.0 \
                and gen is not None:
            keep = self.dropOut
            mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
            return torch.where(mask, x / keep, 0.0)
        return x


@dataclasses.dataclass
class DenseLayer(BaseLayer):
    """Reference: ``conf/layers/DenseLayer.java`` — preOutput = x·W + b,
    W shape (nIn, nOut)."""
    nIn: int = 0
    nOut: int = 0
    hasBias: bool = True

    def preferredFormat(self):
        return "FF"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size

    def getOutputType(self, inputType):
        return InputType.feedForward(self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        p = {"W": init_weight(gen, (self.nIn, self.nOut), self.nIn,
                              self.nOut, self.weightInit or "XAVIER", dtype,
                              dev)}
        if self.hasBias:
            p["b"] = torch.full((self.nOut,), float(self.biasInit or 0.0),
                                dtype=dtype, device=dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        y = x @ params["W"]
        if self.hasBias:
            y = y + params["b"]
        return get_activation(self.activation or "sigmoid")(y), state


# ---------------------------------------------------------------------------
_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


register_layer(DenseLayer)


def layer_from_json(d: dict) -> Layer:
    d = dict(d)
    name = d.pop("@class")
    if name not in _LAYER_REGISTRY:
        raise NotImplementedError(
            f"layer {name} is not ported yet (ROADMAP A4 and later)")
    for k in ("updater", "biasUpdater"):
        if d.get(k):
            d[k] = IUpdater.fromJson(d[k])
    return _LAYER_REGISTRY[name](**d)
