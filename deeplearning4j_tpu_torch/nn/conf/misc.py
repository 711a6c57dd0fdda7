"""Small utility layers — the port of ``deeplearning4j_tpu/nn/conf/misc.py``
(the reference's ``conf/layers/{util/MaskLayer,
misc/ElementWiseMultiplicationLayer, misc/RepeatVector,
convolutional/{Cropping1D,ZeroPadding1DLayer}, OCNNOutputLayer}`` and the
keras-import targets: masking, rescaling, static normalization, layer
normalization, the noise and dropout layers, reshape and permute).

The noise and dropout layers draw from the model's generator, so their
bits are not the reference's; at inference each is the identity.
OCNN's quantile ``r`` is layer state (like BatchNormalization's running
statistics), updated once per training forward and never differentiated.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["MaskLayer", "MaskingLayer", "RescaleLayer",
           "StaticNormalizationLayer", "RepeatVector",
           "ElementWiseMultiplicationLayer",
           "Cropping1D", "ZeroPadding1DLayer", "OCNNOutputLayer",
           "LayerNormalization", "GaussianNoiseLayer",
           "GaussianDropoutLayer", "AlphaDropoutLayer", "ReshapeLayer",
           "PermuteLayer"]


@dataclasses.dataclass
class MaskLayer(BaseLayer):
    """Zeroes masked timesteps (reference: util/MaskLayer — downstream
    layers see exact zeros at padded positions)."""
    acceptsMask = True

    def getOutputType(self, inputType):
        return inputType

    def forward(self, params, x, train, gen, state, mask=None):
        if mask is None:
            return x, state
        return x * mask[:, None, :].to(x.dtype), state


@dataclasses.dataclass
class MaskingLayer(BaseLayer):
    """Computes a timestep mask from the data: a step whose features all
    equal ``maskValue`` is masked for every downstream mask-aware layer
    (recurrent scans keep their carry, LastTimeStep picks the last valid
    step).  Values pass through unchanged — keras ``Masking`` semantics;
    the mask rides the forward's mask channel."""
    maskValue: float = 0.0

    #: the models' forward replaces the active mask with computeMask's
    producesMask = True

    def getOutputType(self, inputType):
        return inputType

    def computeMask(self, x, mask):
        # x: (b, f, t) — a step is valid if any feature differs from the
        # sentinel; an incoming mask ANDs in (keras: masks AND up)
        m = (x != self.maskValue).any(dim=1).float()
        if mask is not None:
            m = m * mask.to(m.dtype)
        return m

    def forward(self, params, x, train, gen, state):
        return x, state


@dataclasses.dataclass
class RescaleLayer(BaseLayer):
    """``x * scale + offset`` — keras preprocessing ``Rescaling``."""
    scale: float = 1.0
    offset: float = 0.0

    def getOutputType(self, inputType):
        return inputType

    def forward(self, params, x, train, gen, state):
        return x * self.scale + self.offset, state


@dataclasses.dataclass
class StaticNormalizationLayer(BaseLayer):
    """Per-channel ``(x - mean) / sqrt(var)`` with fixed statistics held in
    the layer state, never trained — keras preprocessing
    ``Normalization``.  ``mean`` / ``variance`` seed the state."""
    nIn: int = 0
    mean: Tuple[float, ...] = ()
    variance: Tuple[float, ...] = ()

    def __post_init__(self):
        self.mean = tuple(float(v) for v in (self.mean or ()))
        self.variance = tuple(float(v) for v in (self.variance or ()))

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels or inputType.size

    def getOutputType(self, inputType):
        return inputType

    def initState(self, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        n = int(self.nIn)
        mean = torch.tensor(self.mean, dtype=dtype) if self.mean \
            else torch.zeros((n,), dtype=dtype)
        var = torch.tensor(self.variance, dtype=dtype) if self.variance \
            else torch.ones((n,), dtype=dtype)
        return {"mean": mean.expand(n).clone().to(dev),
                "var": var.expand(n).clone().to(dev)}

    def forward(self, params, x, train, gen, state):
        shape = (1, -1) + (1,) * (x.dim() - 2)   # channel-first broadcast
        mean = state["mean"].reshape(shape)
        var = state["var"].reshape(shape)
        return (x - mean) / torch.sqrt(torch.clamp(var, min=1e-12)), state


@dataclasses.dataclass
class RepeatVector(BaseLayer):
    """(b, n) -> (b, n, t): repeat a feed-forward vector across time
    (reference: misc/RepeatVector)."""
    repetitionFactor: int = 1

    def getOutputType(self, inputType):
        return InputType.recurrent(inputType.size, self.repetitionFactor)

    def forward(self, params, x, train, gen, state):
        return x[:, :, None].repeat_interleave(self.repetitionFactor, 2), \
            state


@dataclasses.dataclass
class ElementWiseMultiplicationLayer(BaseLayer):
    """out = activation(x * w + b) with a per-feature weight vector
    (reference: misc/ElementWiseMultiplicationLayer)."""
    nIn: int = 0
    nOut: int = 0

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size
        self.nOut = self.nIn

    def getOutputType(self, inputType):
        return InputType.feedForward(self.nIn)

    def weightParamKeys(self):
        return ("W",)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return {"W": torch.ones((self.nIn,), dtype=dtype, device=dev),
                "b": torch.zeros((self.nIn,), dtype=dtype, device=dev)}

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        y = x * params["W"] + params["b"]
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class Cropping1D(BaseLayer):
    """Crop the time axis of (b, c, t) (reference: Cropping1D)."""
    cropping: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.cropping = tuple(self.cropping) \
            if isinstance(self.cropping, (tuple, list)) \
            else (int(self.cropping),) * 2

    def preferredFormat(self):
        return "RNN"

    def getOutputType(self, inputType):
        t = inputType.timeSeriesLength
        if t and t > 0:
            t = t - self.cropping[0] - self.cropping[1]
        return InputType.recurrent(inputType.size, t)

    def forward(self, params, x, train, gen, state):
        a, b = self.cropping
        return x[:, :, a:x.shape[2] - b], state


@dataclasses.dataclass
class ZeroPadding1DLayer(BaseLayer):
    """Zero-pad the time axis of (b, c, t) (reference:
    ZeroPadding1DLayer)."""
    padding: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.padding = tuple(self.padding) \
            if isinstance(self.padding, (tuple, list)) \
            else (int(self.padding),) * 2

    def preferredFormat(self):
        return "RNN"

    def getOutputType(self, inputType):
        t = inputType.timeSeriesLength
        if t and t > 0:
            t = t + self.padding[0] + self.padding[1]
        return InputType.recurrent(inputType.size, t)

    def forward(self, params, x, train, gen, state):
        return F.pad(x, tuple(self.padding)), state


@dataclasses.dataclass
class LayerNormalization(BaseLayer):
    """Per-example normalization over the feature/channel axis (axis 1 of
    (b, n), (b, n, t) and (b, c, h, w)) with learned gamma/beta and the
    biased variance — the keras ``LayerNormalization`` import target."""
    nIn: int = 0
    eps: float = 1e-3
    axis: int = -1       # keras channels-last axis; must be the trailing one

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size if inputType.kind in ("FF", "RNN") \
                else inputType.channels

    def getOutputType(self, inputType):
        if self.axis != -1:
            rank = len(_keras_dims_of(inputType)) + 1   # + batch
            if self.axis != rank - 1:
                raise ValueError(
                    f"LayerNormalization axis={self.axis} unsupported "
                    "(only the trailing feature axis)")
        return inputType

    def weightParamKeys(self):
        return ()

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return {"gamma": torch.ones((self.nIn,), dtype=dtype, device=dev),
                "beta": torch.zeros((self.nIn,), dtype=dtype, device=dev)}

    def forward(self, params, x, train, gen, state):
        ax = 1 if x.dim() > 2 else -1
        mu = x.mean(dim=ax, keepdim=True)
        var = x.var(dim=ax, unbiased=False, keepdim=True)
        xn = (x - mu) / torch.sqrt(var + self.eps)
        shape = [1] * x.dim()
        shape[ax] = -1
        return xn * params["gamma"].reshape(shape) \
            + params["beta"].reshape(shape), state


def _noise_on(train, gen) -> bool:
    return train and gen is not None


@dataclasses.dataclass
class GaussianNoiseLayer(BaseLayer):
    """Additive zero-mean Gaussian noise at train time (keras
    ``GaussianNoise``)."""
    stddev: float = 0.1

    def getOutputType(self, inputType):
        return inputType

    def forward(self, params, x, train, gen, state):
        if _noise_on(train, gen) and self.stddev > 0:
            x = x + self.stddev * torch.randn(x.shape, generator=gen,
                                              device=x.device, dtype=x.dtype)
        return x, state


@dataclasses.dataclass
class GaussianDropoutLayer(BaseLayer):
    """Multiplicative 1-mean Gaussian noise (keras ``GaussianDropout``):
    x · N(1, sqrt(rate/(1-rate))) at train time."""
    rate: float = 0.5

    def getOutputType(self, inputType):
        return inputType

    def forward(self, params, x, train, gen, state):
        if _noise_on(train, gen) and 0.0 < self.rate < 1.0:
            sd = (self.rate / (1.0 - self.rate)) ** 0.5
            x = x * (1.0 + sd * torch.randn(x.shape, generator=gen,
                                            device=x.device, dtype=x.dtype))
        return x, state


@dataclasses.dataclass
class AlphaDropoutLayer(BaseLayer):
    """SELU-preserving dropout (keras ``AlphaDropout``): a dropped unit
    becomes alpha' = -alpha·scale of SELU, with the affine correction
    a·(.) + b that keeps the mean and variance."""
    rate: float = 0.1

    def getOutputType(self, inputType):
        return inputType

    def forward(self, params, x, train, gen, state):
        if not (_noise_on(train, gen) and 0.0 < self.rate < 1.0):
            return x, state
        alpha_p = -1.7580993408473766     # -alpha*scale of SELU
        keep = 1.0 - self.rate
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return a * torch.where(mask, x, alpha_p) + b, state


# the port's layout <-> keras channels-last layout (batch axis excluded)
_TO_KERAS_PERM = {3: (0, 2, 1),          # (b,f,t)   -> (b,t,f)
                  4: (0, 2, 3, 1),       # (b,c,h,w) -> (b,h,w,c)
                  5: (0, 2, 3, 4, 1)}    # (b,c,d,h,w)->(b,d,h,w,c)
_FROM_KERAS_PERM = {3: (0, 2, 1),
                    4: (0, 3, 1, 2),
                    5: (0, 4, 1, 2, 3)}


def _keras_dims_of(inputType):
    """InputType -> its keras channels-last per-example dims."""
    k = inputType.kind
    if k == "FF":
        return (inputType.size,)
    if k == "RNN":
        return (inputType.timeSeriesLength, inputType.size)
    if k == "CNN":
        return (inputType.height, inputType.width, inputType.channels)
    if k == "CNN3D":
        return (inputType.depth, inputType.height, inputType.width,
                inputType.channels)
    raise ValueError(f"unsupported input kind {k}")


def _type_from_keras_dims(dims):
    if len(dims) == 1:
        return InputType.feedForward(dims[0])
    if len(dims) == 2:                    # (t, f)
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:                    # (h, w, c)
        return InputType.convolutional(*dims)
    if len(dims) == 4:                    # (d, h, w, c)
        return InputType.convolutional3D(*dims)
    raise ValueError(f"unsupported target rank {len(dims)}")


def _to_keras(x):
    return x.permute(_TO_KERAS_PERM[x.dim()]) if x.dim() > 2 else x


def _from_keras(y):
    return y.permute(_FROM_KERAS_PERM[y.dim()]) if y.dim() > 2 else y


@dataclasses.dataclass
class ReshapeLayer(BaseLayer):
    """Reshape with keras channels-last semantics: the input is viewed in
    keras layout, reshaped to ``targetShape`` (keras dims, -1 allowed) and
    turned back to the port's layout (keras ``Reshape`` / ``Flatten``)."""
    targetShape: Tuple[int, ...] = ()

    def __post_init__(self):
        self.targetShape = tuple(int(v) for v in self.targetShape)

    def getOutputType(self, inputType):
        dims = list(self.targetShape)
        n_in = 1
        for d in _keras_dims_of(inputType):
            if not (d and d > 0):
                raise ValueError(
                    "ReshapeLayer requires statically-known input dims "
                    f"(got {inputType})")
            n_in *= d
        if -1 in dims:
            known = 1
            for d in dims:
                if d != -1:
                    known *= d
            dims[dims.index(-1)] = n_in // known
        n_out = 1
        for d in dims:
            n_out *= d
        if n_out != n_in:
            raise ValueError(f"ReshapeLayer: cannot reshape {n_in} elements "
                             f"to {tuple(dims)}")
        return _type_from_keras_dims(dims)

    def forward(self, params, x, train, gen, state):
        y = _to_keras(x).reshape((x.shape[0],) + self.targetShape)
        return _from_keras(y), state


@dataclasses.dataclass
class PermuteLayer(BaseLayer):
    """Permute the per-example axes with keras semantics: ``dims`` is
    1-indexed over the keras channels-last layout (keras ``Permute``)."""
    dims: Tuple[int, ...] = ()

    def __post_init__(self):
        self.dims = tuple(int(v) for v in self.dims)

    def getOutputType(self, inputType):
        kdims = _keras_dims_of(inputType)
        if len(self.dims) != len(kdims):
            raise ValueError(f"PermuteLayer dims {self.dims} rank-mismatch "
                             f"input {inputType}")
        return _type_from_keras_dims([kdims[d - 1] for d in self.dims])

    def forward(self, params, x, train, gen, state):
        y = _to_keras(x).permute((0,) + self.dims)
        return _from_keras(y), state


@dataclasses.dataclass
class OCNNOutputLayer(BaseLayer):
    """One-class neural network output (reference: OCNNOutputLayer.java,
    Chalapathy et al.): score = w · sigmoid(V x), output score - r, with r
    the running nu-quantile of the scores (0.9·r + 0.1·q per training
    forward, layer state); the loss is the one-class hinge relu(r -
    score)/nu, the ||V||² and ||w||² terms riding the l2 machinery."""
    nIn: int = 0
    hiddenSize: int = 10
    nu: float = 0.04
    windowSize: int = 10000          # accepted for parity (r is an EMA)
    initialRValue: float = 0.1

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size

    def getOutputType(self, inputType):
        return InputType.feedForward(1)

    def weightParamKeys(self):
        return ("V", "w")

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        scheme = self.weightInit or "XAVIER"
        return {"V": init_weight(gen, (self.nIn, self.hiddenSize), self.nIn,
                                 self.hiddenSize, scheme, dtype, dev),
                "w": init_weight(gen, (self.hiddenSize,), self.hiddenSize,
                                 1, scheme, dtype, dev)}

    def initState(self, inputType, dtype=torch.float32, device=None):
        return {"r": torch.tensor(self.initialRValue, dtype=dtype,
                                  device=resolve_device(device))}

    def forward(self, params, x, train, gen, state):
        s = torch.sigmoid(x @ params["V"]) @ params["w"]
        r = state.get("r")
        if r is None:
            r = torch.tensor(self.initialRValue, dtype=s.dtype,
                             device=s.device)
        if train:
            q = torch.quantile(s, self.nu)
            r = (0.9 * r + 0.1 * q).detach()
            state = dict(state, r=r)
        return (s - r.detach())[:, None], state

    def hasLoss(self) -> bool:
        return True

    def computeScore(self, labels, output, mask=None):
        """Per-example one-class hinge on the (score - r) decision value
        (labels unused)."""
        return torch.relu(-output[:, 0]) / self.nu


for _c in (MaskLayer, MaskingLayer, RescaleLayer, StaticNormalizationLayer,
           RepeatVector, ElementWiseMultiplicationLayer, Cropping1D,
           ZeroPadding1DLayer, OCNNOutputLayer, LayerNormalization,
           GaussianNoiseLayer, GaussianDropoutLayer, AlphaDropoutLayer,
           ReshapeLayer, PermuteLayer):
    register_layer(_c)
