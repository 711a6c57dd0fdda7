"""Layer configurations and their forward functions — the port of the core
of ``deeplearning4j_tpu/nn/conf/layers.py`` (the reference's
``conf/layers/*.java`` config side and ``nn/layers/**`` forward side).

Each layer config carries a pure ``forward(params, x, train, gen, state)``
over a dict of parameter tensors; autograd of the composed network gives
backprop.  ``gen`` is the ``torch.Generator`` (on the activations' device)
that input dropout draws from, or None (no dropout).

Every layer of the reference module is here: ``DenseLayer``, the CNN
layers (``ConvolutionLayer``/``Convolution2D``, ``SubsamplingLayer``,
``BatchNormalization``, ``ActivationLayer``, ``ELULayer``,
``LeakyReLULayer``, ``DropoutLayer``, ``GlobalPoolingLayer``,
``LocalResponseNormalization``), ``EmbeddingLayer``,
``EmbeddingSequenceLayer``, ``OutputLayer`` and ``LossLayer``, with the
``_Builder``/``register_layer``/``layer_from_json`` machinery; the
attention, recurrent, convolutional, 3-D and misc layers register from
their own modules.

Convolutions are ``torch.nn.functional.conv2d`` (NCHW input, OIHW weights),
as the reference leaves them to XLA.  ``ConvolutionMode.Same`` pads as
``lax``'s ``"SAME"`` does — the output is ceil(in/stride) and an odd total
puts the extra pixel at the end — so the padding is explicit (``F.pad``:
zeros for convolutions and sums, -inf for MAX) wherever it is asymmetric.

Data formats (DL4J conventions): FF ``(b, n)``; CNN ``(b, c, h, w)``;
RNN ``(b, n, t)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.learning.config import IUpdater
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.lossfunctions import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["Layer", "BaseLayer", "DenseLayer", "ConvolutionLayer",
           "Convolution2D", "SubsamplingLayer", "BatchNormalization",
           "ActivationLayer", "ELULayer", "LeakyReLULayer", "DropoutLayer",
           "EmbeddingLayer", "EmbeddingSequenceLayer", "GlobalPoolingLayer",
           "LocalResponseNormalization", "OutputLayer", "LossLayer",
           "PoolingType", "ConvolutionMode", "register_layer",
           "layer_from_json"]


class ConvolutionMode:
    Strict = "Strict"
    Truncate = "Truncate"
    Same = "Same"


class PoolingType:
    MAX = "MAX"
    AVG = "AVG"
    SUM = "SUM"
    PNORM = "PNORM"


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


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """``lax.padtype_to_pads(..., "SAME")`` along one spatial axis: the
    output is ceil(size/s), and an odd total puts the extra pixel at the
    end."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pad2d(x, pads, value=0.0):
    """Pad the two spatial axes of NCHW ``x`` by ``((top, bottom), (left,
    right))``."""
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


def _conv2d(x, w, stride, padding, same: bool, dilation=(1, 1),
            groups: int = 1):
    """``lax.conv_general_dilated`` over NCHW ``x`` and OIHW ``w``:
    ``padding`` (ph, pw) on both sides, or SAME's pads (the extra pixel of an
    odd total at the end, padded explicitly)."""
    if same:
        pads = [_same_pads(x.shape[2 + a], w.shape[2 + a], stride[a],
                           dilation[a]) for a in (0, 1)]
        if all(lo == hi for lo, hi in pads):
            padding = (pads[0][0], pads[1][0])
        else:
            x, padding = _pad2d(x, pads), (0, 0)
    return F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


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

@dataclasses.dataclass
class ConvolutionLayer(BaseLayer):
    """2D convolution.  Reference: ``conf/layers/ConvolutionLayer.java``;
    NCHW input, OIHW weights ``(nOut, nIn, kh, kw)``."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolutionMode: Optional[str] = None
    hasBias: bool = True

    def __post_init__(self):
        self.kernelSize = _pair(self.kernelSize)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def preferredFormat(self):
        return "CNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels

    def _same(self) -> bool:
        return (self.convolutionMode or ConvolutionMode.Truncate) \
            == ConvolutionMode.Same

    def _outSpatial(self, inH, inW):
        if self._same():
            return -(-inH // self.stride[0]), -(-inW // self.stride[1])
        (kh, kw), (sh, sw) = self.kernelSize, self.stride
        (dh, dw), (ph, pw) = self.dilation, self.padding
        eh, ew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        return (inH + 2 * ph - eh) // sh + 1, (inW + 2 * pw - ew) // sw + 1

    def getOutputType(self, inputType):
        oh, ow = self._outSpatial(inputType.height, inputType.width)
        return InputType.convolutional(oh, ow, self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        kh, kw = self.kernelSize
        p = {"W": init_weight(gen, (self.nOut, self.nIn, kh, kw),
                              self.nIn * kh * kw, self.nOut * kh * kw,
                              self.weightInit or "XAVIER", dtype, dev)}
        if self.hasBias:
            p["b"] = torch.full((self.nOut,), float(self.biasInit or 0.0),
                                dtype=dtype, device=dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        y = _conv2d(x, params["W"], self.stride, self.padding, self._same(),
                    self.dilation)
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1, 1)
        return get_activation(self.activation or "identity")(y), state


Convolution2D = ConvolutionLayer


@dataclasses.dataclass
class SubsamplingLayer(BaseLayer):
    """Pooling.  Reference: ``conf/layers/SubsamplingLayer.java``.  MAX pads
    with -inf; AVG divides a border window by its count of valid cells
    unless ``avgPoolIncludePadInDivisor`` (the reference's default is
    False, as keras/TF)."""
    poolingType: str = PoolingType.MAX
    kernelSize: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolutionMode: Optional[str] = None
    pnorm: int = 2
    avgPoolIncludePadInDivisor: bool = False

    def __post_init__(self):
        self.kernelSize = _pair(self.kernelSize)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def preferredFormat(self):
        return "CNN"

    def _same(self) -> bool:
        return (self.convolutionMode or ConvolutionMode.Truncate) \
            == ConvolutionMode.Same

    def getOutputType(self, inputType):
        (kh, kw), (sh, sw) = self.kernelSize, self.stride
        if self._same():
            oh, ow = -(-inputType.height // sh), -(-inputType.width // sw)
        else:
            ph, pw = self.padding
            oh = (inputType.height + 2 * ph - kh) // sh + 1
            ow = (inputType.width + 2 * pw - kw) // sw + 1
        return InputType.convolutional(oh, ow, inputType.channels)

    def _pads(self, inH, inW):
        if self._same():
            return (_same_pads(inH, self.kernelSize[0], self.stride[0]),
                    _same_pads(inW, self.kernelSize[1], self.stride[1]))
        ph, pw = self.padding
        return (ph, ph), (pw, pw)

    def _window_sum(self, x, pads):
        """Sum over each window of zero-padded ``x``."""
        return F.avg_pool2d(_pad2d(x, pads), self.kernelSize, self.stride,
                            divisor_override=1)

    def forward(self, params, x, train, gen, state):
        pads = self._pads(x.shape[2], x.shape[3])
        pt = self.poolingType.upper()
        if pt == PoolingType.MAX:
            y = F.max_pool2d(_pad2d(x, pads, float("-inf")), self.kernelSize,
                             self.stride)
        elif pt == PoolingType.SUM:
            y = self._window_sum(x, pads)
        elif pt == PoolingType.AVG:
            y = self._window_sum(x, pads)
            kh, kw = self.kernelSize
            if self.avgPoolIncludePadInDivisor or \
                    all(p == (0, 0) for p in pads):
                y = y / (kh * kw)
            else:
                ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                  device=x.device)
                y = y / self._window_sum(ones, pads)
        elif pt == PoolingType.PNORM:
            p = float(self.pnorm)
            y = self._window_sum(torch.abs(x) ** p, pads) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {self.poolingType}")
        return y, state


@dataclasses.dataclass
class BatchNormalization(BaseLayer):
    """Reference: ``conf/layers/BatchNormalization.java`` — per-feature (FF)
    or per-channel (CNN) normalization.  The running statistics live in the
    model's layer state (``initState``), updated DL4J's way, ``new =
    decay*old + (1-decay)*batch``, with the biased batch variance
    E[x²]−mean² reduced in float32 and clamped at 0.  Under bf16 compute
    the batch mean and variance are rounded to x's dtype before they
    normalise, while the running statistics accumulate in the float32
    state.  ``torch.nn.BatchNorm2d``'s update (reverse momentum, unbiased
    variance) is not this one and is not used."""
    nIn: int = 0
    nOut: int = 0
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0          # init value
    beta: float = 0.0           # init value
    lockGammaBeta: bool = False

    def preferredFormat(self):
        return None  # operates on FF or CNN

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels if inputType.kind == "CNN" \
                else inputType.size
        self.nOut = self.nIn

    def getOutputType(self, inputType):
        return inputType

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        if self.lockGammaBeta:
            return {}
        return {"gamma": torch.full((self.nIn,), float(self.gamma),
                                    dtype=dtype, device=dev),
                "beta": torch.full((self.nIn,), float(self.beta),
                                   dtype=dtype, device=dev)}

    def initState(self, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return {"mean": torch.zeros((self.nIn,), dtype=dtype, device=dev),
                "var": torch.ones((self.nIn,), dtype=dtype, device=dev)}

    def weightParamKeys(self):
        return ()  # no l1/l2 on gamma/beta (the reference's default)

    def forward(self, params, x, train, gen, state):
        cnn = x.dim() == 4
        axes = (0, 2, 3) if cnn else (0,)
        shape = (1, -1, 1, 1) if cnn else (1, -1)
        sdt = state["mean"].dtype
        if train:
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                              min=0.0)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
            # the state is data, not part of the graph
            new_state = {
                "mean": (self.decay * state["mean"]
                         + (1 - self.decay) * mean.detach().to(sdt)),
                "var": (self.decay * state["var"]
                        + (1 - self.decay) * var.detach().to(sdt))}
        else:
            mean, var = state["mean"].to(x.dtype), state["var"].to(x.dtype)
            new_state = state
        xh = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                    + self.eps)
        xh = xh.to(x.dtype)
        if not self.lockGammaBeta:
            xh = xh * params["gamma"].reshape(shape) \
                + params["beta"].reshape(shape)
        return get_activation(self.activation or "identity")(xh), new_state


@dataclasses.dataclass
class ActivationLayer(BaseLayer):
    def forward(self, params, x, train, gen, state):
        return get_activation(self.activation or "identity")(x), state


@dataclasses.dataclass
class ELULayer(ActivationLayer):
    """Parameterized ELU (the keras ``ELU(alpha)`` import target; the string
    activation table is fixed at alpha 1.0)."""
    alpha: float = 1.0

    def forward(self, params, x, train, gen, state):
        return F.elu(x, self.alpha), state


@dataclasses.dataclass
class LeakyReLULayer(ActivationLayer):
    """Parameterized leaky ReLU (the keras ``LeakyReLU`` import target; the
    string activation table is fixed at alpha 0.01)."""
    alpha: float = 0.3

    def forward(self, params, x, train, gen, state):
        return F.leaky_relu(x, self.alpha), state


@dataclasses.dataclass
class DropoutLayer(BaseLayer):
    """Input dropout as a layer; ``dropOut`` (the RETAIN probability)
    defaults to 0.5.  It draws from the model's generator, so its bits are
    not the reference's; at inference it is the identity."""

    def __post_init__(self):
        if self.dropOut is None:
            self.dropOut = 0.5

    def forward(self, params, x, train, gen, state):
        return self._dropin(x, train, gen), state


def _embedding_params(layer, gen, dtype, device):
    dev = resolve_device(device)
    p = {"W": init_weight(gen, (layer.nIn, layer.nOut), layer.nIn,
                          layer.nOut, layer.weightInit or "XAVIER", dtype,
                          dev)}
    if layer.hasBias:
        p["b"] = torch.full((layer.nOut,), float(layer.biasInit or 0.0),
                            dtype=dtype, device=dev)
    return p


def _lookup(W, x):
    """Rows of ``W`` at the integer part of ``x``, by ``jnp.take``'s rules
    (the reference's lookup): an index in [-n, 0) counts from the end, one
    outside [-n, n) gives a row of NaN."""
    from deeplearning4j_tpu_torch.autodiff.samediff import _take
    return _take(W, x.long(), axis=0)


@dataclasses.dataclass
class EmbeddingLayer(BaseLayer):
    """Index lookup.  Reference: ``conf/layers/EmbeddingLayer.java`` —
    input (b,) or (b, 1) integer indices, output (b, nOut)."""
    nIn: int = 0
    nOut: int = 0
    hasBias: bool = False

    def preferredFormat(self):
        return "FF"

    def getOutputType(self, inputType):
        return InputType.feedForward(self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return _embedding_params(self, gen, dtype, device)

    def forward(self, params, x, train, gen, state):
        y = _lookup(params["W"], x.reshape(x.shape[0], -1)[:, 0])
        if self.hasBias:
            y = y + params["b"]
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class EmbeddingSequenceLayer(BaseLayer):
    """Sequence lookup: (b, t) or (b, 1, t) indices -> RNN format
    (b, nOut, t).  Reference: ``conf/layers/EmbeddingSequenceLayer.java``."""
    nIn: int = 0
    nOut: int = 0
    inputLength: int = -1
    hasBias: bool = False

    def preferredFormat(self):
        return None

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, self.inputLength)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return _embedding_params(self, gen, dtype, device)

    def forward(self, params, x, train, gen, state):
        if x.dim() == 3:  # (b, 1, t)
            x = x[:, 0, :]
        y = _lookup(params["W"], x)                     # (b, t, nOut)
        if self.hasBias:
            y = y + params["b"]
        return y.transpose(1, 2), state                 # (b, nOut, t)


@dataclasses.dataclass
class GlobalPoolingLayer(BaseLayer):
    """Pool the CNN spatial axes or the RNN time axis to FF.  Reference:
    ``conf/layers/GlobalPoolingLayer.java`` (mask-aware over time)."""
    poolingType: str = PoolingType.MAX
    pnorm: int = 2
    collapseDimensions: bool = True

    acceptsMask = True

    def getOutputType(self, inputType):
        if inputType.kind == "CNN":
            if not self.collapseDimensions:   # keep (b, c, 1, 1)
                return InputType.convolutional(1, 1, inputType.channels)
            return InputType.feedForward(inputType.channels)
        if inputType.kind == "RNN":
            if not self.collapseDimensions:   # keep (b, f, 1)
                return InputType.recurrent(inputType.size, 1)
            return InputType.feedForward(inputType.size)
        return inputType

    def forward(self, params, x, train, gen, state, mask=None):
        if not self.collapseDimensions:
            y, state = GlobalPoolingLayer(
                poolingType=self.poolingType, pnorm=self.pnorm,
                collapseDimensions=True).forward(params, x, train, gen,
                                                 state, mask=mask)
            return y.reshape(tuple(y.shape) + (1,) * (x.dim() - y.dim())), \
                state
        if x.dim() == 4:
            axes = (2, 3)
        elif x.dim() == 3:
            axes = (2,)
        else:
            return x, state
        pt = self.poolingType.upper()
        if mask is not None and x.dim() == 3:
            m = mask[:, None, :]
            if pt == PoolingType.MAX:
                x = torch.where(m > 0, x, float("-inf"))
                return torch.amax(x, dim=axes), state
            s = torch.sum(x * m, dim=axes)
            if pt == PoolingType.SUM:
                return s, state
            cnt = torch.clamp(torch.sum(m, dim=axes), min=1.0)
            return s / cnt, state
        if pt == PoolingType.MAX:
            return torch.amax(x, dim=axes), state
        if pt == PoolingType.AVG:
            return torch.mean(x, dim=axes), state
        if pt == PoolingType.SUM:
            return torch.sum(x, dim=axes), state
        if pt == PoolingType.PNORM:
            p = float(self.pnorm)
            return torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p), state
        raise ValueError(self.poolingType)


@dataclasses.dataclass
class LocalResponseNormalization(BaseLayer):
    """Reference: ``conf/layers/LocalResponseNormalization.java`` (AlexNet's
    LRN): x / (k + alpha·Σx²)^beta, the sum over a window of ``int(n)``
    channels zero-padded by ``n // 2`` on each side.  alpha is not divided
    by n, so ``F.local_response_norm`` (which divides) is not this."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def preferredFormat(self):
        return "CNN"

    def forward(self, params, x, train, gen, state):
        half, n = int(self.n) // 2, int(self.n)
        padded = F.pad(x * x, (0, 0, 0, 0, half, half))
        ssum = sum(padded[:, i:i + x.shape[1]] for i in range(n))
        return x / (self.k + self.alpha * ssum) ** self.beta, state


@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + activation + loss.  Reference: ``conf/layers/OutputLayer.java``
    / ``layers/BaseOutputLayer.java``."""
    lossFunction: str = "mcxent"

    @classmethod
    def _builderArgs(cls, b, *args):
        if args:
            b._kw["lossFunction"] = args[0]

    def hasLoss(self) -> bool:
        return True

    def computeScore(self, labels, output, mask=None):
        return get_loss(self.lossFunction)(labels, output, mask)

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        y = x @ params["W"]
        if self.hasBias:
            y = y + params["b"]
        return get_activation(self.activation or "softmax")(y), state


@dataclasses.dataclass
class LossLayer(BaseLayer):
    """Loss without params.  Reference: ``conf/layers/LossLayer.java``."""
    lossFunction: str = "mcxent"

    @classmethod
    def _builderArgs(cls, b, *args):
        if args:
            b._kw["lossFunction"] = args[0]

    def hasLoss(self) -> bool:
        return True

    def computeScore(self, labels, output, mask=None):
        return get_loss(self.lossFunction)(labels, output, mask)

    def forward(self, params, x, train, gen, state):
        return get_activation(self.activation or "identity")(x), state


# ---------------------------------------------------------------------------
_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


for _cls in (DenseLayer, ConvolutionLayer, SubsamplingLayer,
             BatchNormalization, ActivationLayer, ELULayer, LeakyReLULayer,
             DropoutLayer, EmbeddingLayer, EmbeddingSequenceLayer,
             GlobalPoolingLayer, LocalResponseNormalization, OutputLayer,
             LossLayer):
    register_layer(_cls)


def layer_from_json(d: dict) -> Layer:
    d = dict(d)
    name = d.pop("@class")
    if name in ("FeatureInteractionLayer", "DotProductScorer"):
        # the recommender layers register when their module loads
        import deeplearning4j_tpu_torch.models.recsys  # noqa: F401
    if name == "PixelShuffleLayer":     # SRGAN's, registered by the zoo
        import deeplearning4j_tpu_torch.zoo.models3  # noqa: F401
    if name not in _LAYER_REGISTRY:
        # a user's SameDiffLayer subclass registers when it is defined, as
        # the reference's does
        raise KeyError(f"layer class {name} is not registered: import the "
                       f"module that defines it first")
    for k in ("updater", "biasUpdater"):
        if d.get(k):
            d[k] = IUpdater.fromJson(d[k])
    for k in ("kernelSize", "stride", "padding", "dilation"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    cls = _LAYER_REGISTRY[name]
    if hasattr(cls, "_fromJsonDict"):  # wrappers with nested layers
        return cls._fromJsonDict(d)
    return cls(**d)
