"""The 3-D convolutional family, the locally-connected layers and PReLU —
the port of ``deeplearning4j_tpu/nn/conf/convolutional3d.py`` (the
reference's ``conf/layers/{Convolution3D,Subsampling3DLayer,Upsampling3D,
Cropping3D,ZeroPadding3DLayer,Deconvolution3D,LocallyConnected1D,
LocallyConnected2D,PReLULayer}.java``).  NCDHW layout, OIDHW weights.

SAME pads as ``lax``'s "SAME" (the extra pixel of an odd total at the end);
the transposed convolution is ``convolutional._transposed_conv``, the
reference's lowering.  A locally-connected layer extracts patches in the
reference's order (channel outermost, then the kernel offsets, as
``lax.conv_general_dilated_patches`` and ``F.unfold`` both lay them out)
and contracts them with one weight matrix per output position.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    _bias, _pair, _same_mode, _transposed_conv, _transposed_pads)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayer, PoolingType,
                                                     _same_pads,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["Convolution3D", "Subsampling3DLayer", "Upsampling3D",
           "Cropping3D", "ZeroPadding3DLayer", "Deconvolution3D",
           "PReLULayer", "LocallyConnected2D", "LocallyConnected1D"]


def _triple(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(i) for i in v)
    return (int(v), int(v), int(v))


def _out_dim(size, k, s, d, pad, same):
    if same:
        return -(-size // s)
    return (size + 2 * pad - (k - 1) * d - 1) // s + 1


def _pad3d(x, pads, value=0.0):
    """Pad the three spatial axes of NCDHW ``x`` by (lo, hi) per axis."""
    if not any(lo or hi for lo, hi in pads):
        return x
    return F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
                 value=value)


def _pool_pads(layer, x):
    if _same_mode(layer.convolutionMode):
        return [_same_pads(s, k, st) for s, k, st in
                zip(x.shape[2:], layer.kernelSize, layer.stride)]
    return [(p, p) for p in layer.padding]


@dataclasses.dataclass
class Convolution3D(BaseLayer):
    """3D convolution, NCDHW (reference: Convolution3D.java, conv3d.cpp)."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    dilation: Tuple[int, int, int] = (1, 1, 1)
    convolutionMode: Optional[str] = None
    hasBias: bool = True

    def __post_init__(self):
        self.kernelSize = _triple(self.kernelSize)
        self.stride = _triple(self.stride)
        self.padding = _triple(self.padding)
        self.dilation = _triple(self.dilation)

    def preferredFormat(self):
        return "CNN3D"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels

    def getOutputType(self, inputType):
        same = _same_mode(self.convolutionMode)
        od, oh, ow = (
            _out_dim(s, k, st, d, p, same)
            for s, k, st, d, p in zip(
                (inputType.depth, inputType.height, inputType.width),
                self.kernelSize, self.stride, self.dilation, self.padding))
        return InputType.convolutional3D(od, oh, ow, self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        n = math.prod(self.kernelSize)
        p = {"W": init_weight(gen, (self.nOut, self.nIn) + self.kernelSize,
                              self.nIn * n, self.nOut * n,
                              self.weightInit or "XAVIER", dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nOut, dtype, dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        padding = self.padding
        if _same_mode(self.convolutionMode):
            x = _pad3d(x, [_same_pads(s, k, st, d) for s, k, st, d in zip(
                x.shape[2:], self.kernelSize, self.stride, self.dilation)])
            padding = 0
        y = F.conv3d(x, params["W"], stride=self.stride, padding=padding,
                     dilation=self.dilation)
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1, 1, 1)
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class Subsampling3DLayer(BaseLayer):
    """3D max/avg pooling (reference: Subsampling3DLayer.java,
    maxpool3d/avgpool3d.cpp).  As in the reference, only the exact
    ``"MAX"`` selects max pooling; an average's border window divides by
    its count of valid cells."""
    poolingType: str = PoolingType.MAX
    kernelSize: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Tuple[int, int, int] = (0, 0, 0)
    convolutionMode: Optional[str] = None

    def __post_init__(self):
        self.kernelSize = _triple(self.kernelSize)
        self.stride = _triple(self.stride)
        self.padding = _triple(self.padding)

    def preferredFormat(self):
        return "CNN3D"

    def getOutputType(self, inputType):
        same = _same_mode(self.convolutionMode)
        od, oh, ow = (
            _out_dim(s, k, st, 1, p, same)
            for s, k, st, p in zip(
                (inputType.depth, inputType.height, inputType.width),
                self.kernelSize, self.stride, self.padding))
        return InputType.convolutional3D(od, oh, ow, inputType.channels)

    def _window_sum(self, x, pads):
        return F.avg_pool3d(_pad3d(x, pads), self.kernelSize, self.stride,
                            divisor_override=1)

    def forward(self, params, x, train, gen, state):
        pads = _pool_pads(self, x)
        if self.poolingType == PoolingType.MAX:
            return F.max_pool3d(_pad3d(x, pads, float("-inf")),
                                self.kernelSize, self.stride), state
        y = self._window_sum(x, pads)
        if _same_mode(self.convolutionMode) or any(self.padding):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            return y / self._window_sum(ones, pads), state
        return y / float(math.prod(self.kernelSize)), state


@dataclasses.dataclass
class Upsampling3D(BaseLayer):
    """Nearest-neighbour 3D upsampling (reference: Upsampling3D.java)."""
    size: Tuple[int, int, int] = (2, 2, 2)

    def __post_init__(self):
        self.size = _triple(self.size)

    def preferredFormat(self):
        return "CNN3D"

    def getOutputType(self, inputType):
        sd_, sh, sw = self.size
        return InputType.convolutional3D(
            inputType.depth * sd_, inputType.height * sh,
            inputType.width * sw, inputType.channels)

    def forward(self, params, x, train, gen, state):
        sd_, sh, sw = self.size
        return (x.repeat_interleave(sd_, 2).repeat_interleave(sh, 3)
                .repeat_interleave(sw, 4)), state


@dataclasses.dataclass
class Cropping3D(BaseLayer):
    """Crop NCDHW spatial dims (reference: Cropping3D.java)."""
    cropDepth: Tuple[int, int] = (0, 0)
    cropHeight: Tuple[int, int] = (0, 0)
    cropWidth: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.cropDepth = tuple(self.cropDepth)
        self.cropHeight = tuple(self.cropHeight)
        self.cropWidth = tuple(self.cropWidth)

    def preferredFormat(self):
        return "CNN3D"

    def getOutputType(self, inputType):
        return InputType.convolutional3D(
            inputType.depth - sum(self.cropDepth),
            inputType.height - sum(self.cropHeight),
            inputType.width - sum(self.cropWidth), inputType.channels)

    def forward(self, params, x, train, gen, state):
        (d0, d1), (h0, h1), (w0, w1) = \
            self.cropDepth, self.cropHeight, self.cropWidth
        return x[:, :, d0:x.shape[2] - d1 or None,
                 h0:x.shape[3] - h1 or None,
                 w0:x.shape[4] - w1 or None], state


@dataclasses.dataclass
class ZeroPadding3DLayer(BaseLayer):
    """Zero-pad NCDHW spatial dims (reference: ZeroPadding3DLayer.java)."""
    padDepth: Tuple[int, int] = (0, 0)
    padHeight: Tuple[int, int] = (0, 0)
    padWidth: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.padDepth = tuple(self.padDepth)
        self.padHeight = tuple(self.padHeight)
        self.padWidth = tuple(self.padWidth)

    def preferredFormat(self):
        return "CNN3D"

    def getOutputType(self, inputType):
        return InputType.convolutional3D(
            inputType.depth + sum(self.padDepth),
            inputType.height + sum(self.padHeight),
            inputType.width + sum(self.padWidth), inputType.channels)

    def forward(self, params, x, train, gen, state):
        return _pad3d(x, (self.padDepth, self.padHeight, self.padWidth)), \
            state


@dataclasses.dataclass
class Deconvolution3D(BaseLayer):
    """Transposed 3D conv (reference: Deconvolution3D.java, deconv3d.cpp):
    W (nOut, nIn, kd, kh, kw), the flipped kernel over the input dilated by
    the stride."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    convolutionMode: Optional[str] = None
    hasBias: bool = True

    def __post_init__(self):
        self.kernelSize = _triple(self.kernelSize)
        self.stride = _triple(self.stride)
        self.padding = _triple(self.padding)

    def preferredFormat(self):
        return "CNN3D"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels

    def getOutputType(self, inputType):
        sizes = (inputType.depth, inputType.height, inputType.width)
        if _same_mode(self.convolutionMode):
            od, oh, ow = (s * st for s, st in zip(sizes, self.stride))
        else:
            od, oh, ow = ((s - 1) * st + k - 2 * p for s, st, k, p in zip(
                sizes, self.stride, self.kernelSize, self.padding))
        return InputType.convolutional3D(od, oh, ow, self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        n = math.prod(self.kernelSize)
        p = {"W": init_weight(gen, (self.nOut, self.nIn) + self.kernelSize,
                              self.nIn * n, self.nOut * n,
                              self.weightInit or "XAVIER", dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nOut, dtype, dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        pads = _transposed_pads(x.shape[2:], self.kernelSize, self.stride,
                                self.padding,
                                _same_mode(self.convolutionMode))
        y = _transposed_conv(x, params["W"], self.stride, pads)
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1, 1, 1)
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class PReLULayer(BaseLayer):
    """Parametric ReLU with a learned per-element (or shared-axis) alpha,
    initialised to 0 (reference: PReLULayer.java, libnd4j prelu.cpp)."""
    inputShape: Tuple[int, ...] = ()    # per-example shape, set or inferred
    sharedAxes: Tuple[int, ...] = ()    # 1-based per-example axes to share

    def __post_init__(self):
        self.inputShape = tuple(self.inputShape or ())
        self.sharedAxes = tuple(self.sharedAxes or ())

    def preferredFormat(self):
        return None

    def inferNIn(self, inputType):
        if not self.inputShape:
            self.inputShape = tuple(inputType.getShape(1)[1:])

    def getOutputType(self, inputType):
        return inputType

    def _alphaShape(self):
        shape = list(self.inputShape)
        for ax in self.sharedAxes:
            shape[ax - 1] = 1
        return tuple(shape)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return {"alpha": torch.zeros(self._alphaShape(), dtype=dtype,
                                     device=resolve_device(device))}

    def forward(self, params, x, train, gen, state):
        return torch.where(x >= 0, x, params["alpha"][None] * x), state


class _LocallyConnectedBase(BaseLayer):
    """A conv with unshared weights: patches, then one contraction per
    output position (``einsum("bcp,pco->bpo")``)."""


def _locally_connected(layer, params, patches):
    """``patches`` (b, c·k, P) through W (P, c·k, nOut) and the bias, to
    (b, nOut, P)."""
    y = torch.einsum("bcp,pco->bpo", patches, params["W"])
    if layer.hasBias:
        y = y + params["b"]
    return get_activation(layer.activation or "identity")(y.transpose(1, 2))


@dataclasses.dataclass
class LocallyConnected2D(_LocallyConnectedBase):
    """Unshared 2D conv (reference: LocallyConnected2D.java)."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    inputSize: Tuple[int, int] = ()      # (h, w), inferred
    hasBias: bool = True

    def __post_init__(self):
        self.kernelSize = _pair(self.kernelSize)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.inputSize = tuple(self.inputSize or ())

    def preferredFormat(self):
        return "CNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels
        if not self.inputSize:
            self.inputSize = (inputType.height, inputType.width)

    def _outSpatial(self, size=None):
        (h, w) = size or self.inputSize
        (kh, kw), (sh, sw) = self.kernelSize, self.stride
        ph, pw = self.padding
        return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1

    def getOutputType(self, inputType):
        # a query before the layer is bound reads the passed type, without
        # binding it (inferNIn owns the binding)
        oh, ow = self._outSpatial(
            self.inputSize or (inputType.height, inputType.width))
        return InputType.convolutional(oh, ow, self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        kh, kw = self.kernelSize
        oh, ow = self._outSpatial()
        p = {"W": init_weight(gen, (oh * ow, self.nIn * kh * kw, self.nOut),
                              self.nIn * kh * kw, self.nOut,
                              self.weightInit or "XAVIER", dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nOut, dtype, dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        ph, pw = self.padding
        patches = F.unfold(x, self.kernelSize, padding=(ph, pw),
                           stride=self.stride)           # (b, c·kh·kw, P)
        oh = (x.shape[2] + 2 * ph - self.kernelSize[0]) // self.stride[0] + 1
        y = _locally_connected(self, params, patches)
        return y.reshape(x.shape[0], self.nOut, oh, -1), state


@dataclasses.dataclass
class LocallyConnected1D(_LocallyConnectedBase):
    """Unshared 1D conv over RNN-format (b, c, t) input (reference:
    LocallyConnected1D.java)."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: int = 2
    stride: int = 1
    padding: int = 0
    inputSize: int = 0                   # t, inferred
    hasBias: bool = True

    def __post_init__(self):
        if isinstance(self.kernelSize, (tuple, list)):
            self.kernelSize = int(self.kernelSize[0])
        if isinstance(self.stride, (tuple, list)):
            self.stride = int(self.stride[0])
        if isinstance(self.padding, (tuple, list)):
            self.padding = int(self.padding[0])

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size
        if not self.inputSize:
            self.inputSize = inputType.timeSeriesLength

    def _outT(self, size=None):
        return ((size or self.inputSize) + 2 * self.padding
                - self.kernelSize) // self.stride + 1

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, self._outT(
            self.inputSize or inputType.timeSeriesLength))

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        k = self.kernelSize
        p = {"W": init_weight(gen, (self._outT(), self.nIn * k, self.nOut),
                              self.nIn * k, self.nOut,
                              self.weightInit or "XAVIER", dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nOut, dtype, dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)                  # (b, c, t)
        if self.padding:
            x = F.pad(x, (self.padding, self.padding))
        w = x.unfold(2, self.kernelSize, self.stride)    # (b, c, ot, k)
        patches = w.permute(0, 1, 3, 2).reshape(x.shape[0], -1, w.shape[2])
        return _locally_connected(self, params, patches), state


for _c in (Convolution3D, Subsampling3DLayer, Upsampling3D, Cropping3D,
           ZeroPadding3DLayer, Deconvolution3D, PReLULayer,
           LocallyConnected1D, LocallyConnected2D):
    register_layer(_c)
