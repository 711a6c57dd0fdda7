"""The extended convolutional layer family — the port of
``deeplearning4j_tpu/nn/conf/convolutional.py`` (the reference's
``conf/layers/{Upsampling2D,Upsampling1D,ZeroPaddingLayer,Cropping2D,
Deconvolution2D,DepthwiseConvolution2D,SeparableConvolution2D,
Convolution1DLayer,Subsampling1DLayer,SpaceToDepthLayer,CnnLossLayer}.java``
and ``objdetect/Yolo2OutputLayer.java``).  NCHW / NCW layouts as in DL4J.

Lowerings, each the reference's function:
- depthwise and separable convolutions are grouped ``F.conv2d`` (group g
  owns output channels g·dm .. g·dm + dm - 1, as ``feature_group_count``);
- the transposed convolution keeps the reference's weight layout
  (nOut, nIn, kh, kw) and its lowering — the input dilated by the stride,
  padded (a negative pad crops) and convolved with the flipped kernel —
  rather than ``F.conv_transpose2d``, which wants (nIn, nOut, ...) and pads
  otherwise (``_transposed_conv``, shared with ``Deconvolution3D``);
- space-to-depth puts the block offset outermost: output channel
  (i·bs + j)·c + ch, where ``F.pixel_unshuffle`` puts ch outermost.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayer,
                                                     ConvolutionMode,
                                                     PoolingType, _conv2d,
                                                     _same_pads,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.lossfunctions import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["Upsampling2D", "Upsampling1D", "ZeroPaddingLayer", "Cropping2D",
           "Deconvolution2D", "DepthwiseConvolution2D",
           "SeparableConvolution2D", "Convolution1DLayer",
           "Subsampling1DLayer", "SpaceToDepthLayer", "CnnLossLayer",
           "Yolo2OutputLayer"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _same_mode(mode, default=ConvolutionMode.Truncate) -> bool:
    return (mode or default) == ConvolutionMode.Same


def _bias(layer, n, dtype, dev):
    return torch.full((n,), float(layer.biasInit or 0.0), dtype=dtype,
                      device=dev)


def _transposed_conv(x, w, stride, pads):
    """``lax.conv_general_dilated(x, flip(w), window_strides=1,
    padding=pads, lhs_dilation=stride)`` over 2 or 3 spatial axes: ``x``
    dilated by ``stride``, padded by ``pads`` ((lo, hi) per axis; a
    negative pad crops) and convolved with ``w`` flipped spatially."""
    nd = len(stride)
    size = tuple((s - 1) * st + 1 for s, st in zip(x.shape[2:], stride))
    xd = x.new_zeros(tuple(x.shape[:2]) + size)
    xd[(slice(None), slice(None))
       + tuple(slice(None, None, st) for st in stride)] = x
    xd = F.pad(xd, [p for lo_hi in reversed(pads) for p in lo_hi])
    conv = F.conv2d if nd == 2 else F.conv3d
    return conv(xd, torch.flip(w, tuple(range(2, 2 + nd))))


def _transposed_pads(sizes, kernel, stride, padding, same):
    """The reference's pads of a transposed convolution: SAME (output
    in·stride) splits the residual with its odd pixel at the start; else
    k - 1 - p on both sides."""
    if same:
        pads = []
        for s, st, k in zip(sizes, stride, kernel):
            tot = (s - 1) * st + k - s * st
            pads.append(((k - 1) - tot // 2 - tot % 2, (k - 1) - tot // 2))
        return pads
    return [(k - 1 - p, k - 1 - p) for k, p in zip(kernel, padding)]


def _window_reduce(x, k, s, pads, op):
    """Max or sum over windows ``k`` at stride ``s`` of the last axis of
    ``x`` padded by ``pads`` (-inf for max, zeros for sum)."""
    fill = float("-inf") if op == "max" else 0.0
    x = F.pad(x, pads, value=fill) if any(pads) else x
    w = x.unfold(-1, k, s)
    return w.amax(-1) if op == "max" else w.sum(-1)


@dataclasses.dataclass
class Upsampling2D(BaseLayer):
    """Nearest-neighbour upsampling (reference: Upsampling2D.java)."""
    size: Tuple[int, int] = (2, 2)

    def __post_init__(self):
        self.size = _pair(self.size)

    def preferredFormat(self):
        return "CNN"

    def getOutputType(self, inputType):
        sh, sw = self.size
        return InputType.convolutional(inputType.height * sh,
                                       inputType.width * sw,
                                       inputType.channels)

    def forward(self, params, x, train, gen, state):
        sh, sw = self.size
        return x.repeat_interleave(sh, 2).repeat_interleave(sw, 3), state


@dataclasses.dataclass
class Upsampling1D(BaseLayer):
    """Repeat each timestep of a (b, f, t) sequence ``size`` times
    (reference: Upsampling1D.java)."""
    size: int = 2

    def __post_init__(self):
        if isinstance(self.size, (tuple, list)):
            self.size = int(self.size[0])

    def preferredFormat(self):
        return "RNN"

    def getOutputType(self, inputType):
        t = inputType.timeSeriesLength
        return InputType.recurrent(
            inputType.size, t * self.size if t and t > 0 else -1)

    def forward(self, params, x, train, gen, state):
        return x.repeat_interleave(self.size, 2), state


@dataclasses.dataclass
class ZeroPaddingLayer(BaseLayer):
    """Zero padding (reference: ZeroPaddingLayer.java) — padding = (top,
    bottom, left, right) or a (h, w) pair."""
    padding: Tuple[int, ...] = (1, 1, 1, 1)

    def __post_init__(self):
        p = tuple(self.padding) if isinstance(self.padding, (tuple, list)) \
            else (int(self.padding),) * 4
        if len(p) == 2:
            p = (p[0], p[0], p[1], p[1])
        self.padding = p

    def preferredFormat(self):
        return "CNN"

    def getOutputType(self, inputType):
        t, b, l, r = self.padding
        return InputType.convolutional(inputType.height + t + b,
                                       inputType.width + l + r,
                                       inputType.channels)

    def forward(self, params, x, train, gen, state):
        t, b, l, r = self.padding
        return F.pad(x, (l, r, t, b)), state


@dataclasses.dataclass
class Cropping2D(BaseLayer):
    """Spatial crop (reference: convolutional/Cropping2D.java) — cropping =
    (top, bottom, left, right) or a (h, w) pair."""
    cropping: Tuple[int, ...] = (0, 0, 0, 0)

    def __post_init__(self):
        c = tuple(self.cropping) if isinstance(self.cropping, (tuple, list)) \
            else (int(self.cropping),) * 4
        if len(c) == 2:
            c = (c[0], c[0], c[1], c[1])
        self.cropping = c

    def preferredFormat(self):
        return "CNN"

    def getOutputType(self, inputType):
        t, b, l, r = self.cropping
        return InputType.convolutional(inputType.height - t - b,
                                       inputType.width - l - r,
                                       inputType.channels)

    def forward(self, params, x, train, gen, state):
        t, b, l, r = self.cropping
        h, w = x.shape[2], x.shape[3]
        return x[:, :, t:h - b or h, l:w - r or w], state


@dataclasses.dataclass
class Deconvolution2D(BaseLayer):
    """Transposed convolution (reference: Deconvolution2D.java, libnd4j
    deconv2d.cpp); W is (nOut, nIn, kh, kw).  Output spatial (Truncate):
    (in - 1)·stride + kernel - 2·padding; Same: in·stride."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolutionMode: Optional[str] = None
    hasBias: bool = True

    def __post_init__(self):
        self.kernelSize = _pair(self.kernelSize)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def preferredFormat(self):
        return "CNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels

    def getOutputType(self, inputType):
        (kh, kw), (sh, sw) = self.kernelSize, self.stride
        if _same_mode(self.convolutionMode):
            return InputType.convolutional(inputType.height * sh,
                                           inputType.width * sw, self.nOut)
        ph, pw = self.padding
        return InputType.convolutional(
            (inputType.height - 1) * sh + kh - 2 * ph,
            (inputType.width - 1) * sw + kw - 2 * pw, self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        kh, kw = self.kernelSize
        p = {"W": init_weight(gen, (self.nOut, self.nIn, kh, kw),
                              self.nIn * kh * kw, self.nOut * kh * kw,
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
            y = y + params["b"].reshape(1, -1, 1, 1)
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class DepthwiseConvolution2D(BaseLayer):
    """Depthwise conv (reference: DepthwiseConvolution2D.java) — each input
    channel convolved with depthMultiplier filters; W (nIn·dm, 1, kh, kw),
    groups = nIn."""
    nIn: int = 0
    nOut: int = 0                  # = nIn * depthMultiplier (derived)
    depthMultiplier: int = 1
    kernelSize: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolutionMode: Optional[str] = None
    hasBias: bool = True

    def __post_init__(self):
        self.kernelSize = _pair(self.kernelSize)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def preferredFormat(self):
        return "CNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels
        self.nOut = self.nIn * self.depthMultiplier

    def _outSpatial(self, inH, inW):
        (kh, kw), (sh, sw) = self.kernelSize, self.stride
        if _same_mode(self.convolutionMode):
            return -(-inH // sh), -(-inW // sw)
        ph, pw = self.padding
        return (inH + 2 * ph - kh) // sh + 1, (inW + 2 * pw - kw) // sw + 1

    def getOutputType(self, inputType):
        oh, ow = self._outSpatial(inputType.height, inputType.width)
        return InputType.convolutional(oh, ow,
                                       self.nIn * self.depthMultiplier)

    def _depthwiseParams(self, gen, dtype, dev):
        kh, kw = self.kernelSize
        dm = self.depthMultiplier
        return init_weight(gen, (self.nIn * dm, 1, kh, kw), kh * kw,
                           dm * kh * kw, self.weightInit or "XAVIER", dtype,
                           dev)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        p = {"W": self._depthwiseParams(gen, dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nIn * self.depthMultiplier, dtype, dev)
        return p

    def _depthwise(self, params, x):
        return _conv2d(x, params["W"], self.stride, self.padding,
                       _same_mode(self.convolutionMode), groups=self.nIn)

    def forward(self, params, x, train, gen, state):
        y = self._depthwise(params, self._dropin(x, train, gen))
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1, 1)
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class SeparableConvolution2D(DepthwiseConvolution2D):
    """Depthwise then a 1x1 pointwise conv (reference:
    SeparableConvolution2D.java, libnd4j sconv2d.cpp); pW is
    (nOut, nIn·dm, 1, 1)."""
    nOut: int = 0                  # pointwise output channels

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.channels

    def getOutputType(self, inputType):
        oh, ow = self._outSpatial(inputType.height, inputType.width)
        return InputType.convolutional(oh, ow, self.nOut)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        dm = self.depthMultiplier
        p = {"W": self._depthwiseParams(gen, dtype, dev),
             "pW": init_weight(gen, (self.nOut, self.nIn * dm, 1, 1),
                               self.nIn * dm, self.nOut,
                               self.weightInit or "XAVIER", dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nOut, dtype, dev)
        return p

    def weightParamKeys(self):
        return ("W", "pW")

    def forward(self, params, x, train, gen, state):
        y = self._depthwise(params, self._dropin(x, train, gen))
        y = F.conv2d(y, params["pW"])
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1, 1)
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class Convolution1DLayer(BaseLayer):
    """1D conv over RNN-format (b, c, t) input (reference:
    Convolution1DLayer.java); the default mode is Same."""
    nIn: int = 0
    nOut: int = 0
    kernelSize: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolutionMode: Optional[str] = None
    hasBias: bool = True

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size

    def _same(self):
        return _same_mode(self.convolutionMode, ConvolutionMode.Same)

    def _outT(self, t):
        if t < 0:
            return -1
        k, s, d = self.kernelSize, self.stride, self.dilation
        if self._same():
            return -(-t // s)
        return (t + 2 * self.padding - (k - 1) * d - 1) // s + 1

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut,
                                   self._outT(inputType.timeSeriesLength))

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        k = self.kernelSize
        p = {"W": init_weight(gen, (self.nOut, self.nIn, k), self.nIn * k,
                              self.nOut * k, self.weightInit or "XAVIER",
                              dtype, dev)}
        if self.hasBias:
            p["b"] = _bias(self, self.nOut, dtype, dev)
        return p

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        padding = self.padding
        if self._same():
            x = F.pad(x, _same_pads(x.shape[2], self.kernelSize, self.stride,
                                    self.dilation))
            padding = 0
        y = F.conv1d(x, params["W"], stride=self.stride, padding=padding,
                     dilation=self.dilation)
        if self.hasBias:
            y = y + params["b"].reshape(1, -1, 1)
        return get_activation(self.activation or "identity")(y), state


@dataclasses.dataclass
class Subsampling1DLayer(BaseLayer):
    """1D pooling over (b, c, t) (reference: Subsampling1DLayer.java): MAX,
    AVG (a border window averages over its valid cells), any other type a
    window sum."""
    poolingType: str = PoolingType.MAX
    kernelSize: int = 2
    stride: int = 2
    padding: int = 0

    def preferredFormat(self):
        return "RNN"

    def getOutputType(self, inputType):
        t = inputType.timeSeriesLength
        if t >= 0:
            t = (t + 2 * self.padding - self.kernelSize) // self.stride + 1
        return InputType.recurrent(inputType.size, t)

    def forward(self, params, x, train, gen, state):
        k, s, p = self.kernelSize, self.stride, self.padding
        pt = self.poolingType.upper()
        if pt == PoolingType.MAX:
            return _window_reduce(x, k, s, (p, p), "max"), state
        y = _window_reduce(x, k, s, (p, p), "sum")
        if pt == PoolingType.AVG:
            if p:   # border windows average over VALID cells only
                ones = torch.ones((1, 1, x.shape[2]), dtype=x.dtype,
                                  device=x.device)
                y = y / _window_reduce(ones, k, s, (p, p), "sum")
            else:
                y = y / k
        return y, state


@dataclasses.dataclass
class SpaceToDepthLayer(BaseLayer):
    """(reference: SpaceToDepthLayer.java) — block-rearrange HxW into C,
    output channel (i·bs + j)·c + ch (the reference's order)."""
    blockSize: int = 2

    def preferredFormat(self):
        return "CNN"

    def getOutputType(self, inputType):
        bs = self.blockSize
        return InputType.convolutional(inputType.height // bs,
                                       inputType.width // bs,
                                       inputType.channels * bs * bs)

    def forward(self, params, x, train, gen, state):
        b, c, h, w = x.shape
        bs = self.blockSize
        y = x.reshape(b, c, h // bs, bs, w // bs, bs)
        y = y.permute(0, 3, 5, 1, 2, 4).reshape(b, c * bs * bs, h // bs,
                                                w // bs)
        return y, state


@dataclasses.dataclass
class CnnLossLayer(BaseLayer):
    """Per-pixel loss over (b, c, h, w) (reference: CnnLossLayer.java) —
    segmentation-style heads; the loss averages over pixels, with an
    optional (b, 1|c, h, w) or (b, h, w) mask."""
    lossFunction: str = "mcxent"

    @classmethod
    def _builderArgs(cls, b, *args):
        if args:
            b._kw["lossFunction"] = args[0]

    def preferredFormat(self):
        return "CNN"

    def hasLoss(self) -> bool:
        return True

    def forward(self, params, x, train, gen, state):
        if (self.activation or "").lower() == "softmax":
            return torch.softmax(x, dim=1), state  # over channels
        return get_activation(self.activation or "identity")(x), state

    def computeScore(self, labels, output, mask=None):
        # flatten pixels into the batch: (b, c, h, w) -> (b*h*w, c)
        b, c, h, w = output.shape
        o = output.permute(0, 2, 3, 1).reshape(-1, c)
        y = labels.permute(0, 2, 3, 1).reshape(-1, c)
        m = None
        if mask is not None:
            if mask.dim() == 4:
                # a pixel counts if ANY channel is unmasked
                m = (mask.amax(dim=1) > 0).to(output.dtype).reshape(-1)
            else:  # (b, h, w)
                m = mask.reshape(-1)
        per = get_loss(self.lossFunction)(y, o, m)
        return per.reshape(b, h * w).mean(dim=1)


_FLOAT = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _anchor_array(boxes) -> np.ndarray:
    """``boundingBoxes`` as a (B, 2) float array: from an array, a nested
    list, or the numpy ``str`` of an array — what the reference's JSON
    holds, since its ``json.dumps`` falls back to ``str`` for an ndarray
    (ROADMAP C16)."""
    if isinstance(boxes, str):
        return np.asarray([float(v) for v in _FLOAT.findall(boxes)],
                          np.float64).reshape(-1, 2)
    return np.asarray(boxes, np.float64).reshape(-1, 2)


@dataclasses.dataclass
class Yolo2OutputLayer(BaseLayer):
    """YOLOv2 detection loss (reference: objdetect/Yolo2OutputLayer.java).

    Input (b, B·(5+C), H, W): per anchor box [tx, ty, tw, th, to, classes].
    Labels (b, 4+C, H, W), DL4J's format: the box [x1, y1, x2, y2] in GRID
    units and a one-hot class, zero where no object.  Loss = lambdaCoord ·
    position (sigmoid xy, sqrt of anchor·exp(wh) against the box) +
    confidence (the shape IOU as target, detached; lambdaNoObj on the other
    anchors and cells) + class cross-entropy, for the anchor whose shape IOU
    with the box is largest (the first on a tie, as ``jnp.argmax``).

    ``boundingBoxes`` keeps what it was given, so the configuration's JSON
    is the reference's byte for byte; the loss reads it through
    ``_anchor_array``, which also parses the reference's string form."""
    boundingBoxes: Optional[np.ndarray] = None   # (B, 2) anchor (h, w)
    lambdaCoord: float = 5.0
    lambdaNoObj: float = 0.5

    def preferredFormat(self):
        return "CNN"

    def hasLoss(self) -> bool:
        return True

    def anchors(self) -> np.ndarray:
        return _anchor_array(self.boundingBoxes)

    def _split(self, x):
        b, ch, h, w = x.shape
        nB = len(self.anchors())
        x = x.reshape(b, nB, ch // nB, h, w)
        return (torch.sigmoid(x[:, :, 0:2]), x[:, :, 2:4],
                torch.sigmoid(x[:, :, 4]), torch.softmax(x[:, :, 5:], dim=2))

    def forward(self, params, x, train, gen, state):
        return x, state  # raw activations; loss/decoding interpret them

    def computeScore(self, labels, output, mask=None):
        anchors = torch.as_tensor(self.anchors(), dtype=output.dtype,
                                  device=output.device)     # (B, 2) h, w
        xy, wh, conf, cls = self._split(output)
        b, nB, _, h, w = xy.shape
        nC = cls.shape[2]
        lab = labels.to(output.dtype).reshape(b, 4 + nC, h, w)
        x1, y1, x2, y2 = lab[:, 0], lab[:, 1], lab[:, 2], lab[:, 3]
        obj = ((x2 - x1) > 0).to(output.dtype)              # (b, h, w)
        cx = (x1 + x2) / 2 - torch.floor((x1 + x2) / 2)     # offset in cell
        cy = (y1 + y2) / 2 - torch.floor((y1 + y2) / 2)
        tw = torch.clamp(x2 - x1, min=1e-6)                 # grid units
        th = torch.clamp(y2 - y1, min=1e-6)

        # the responsible anchor: best shape IOU with the label box
        aw = anchors[:, 1].reshape(1, nB, 1, 1)
        ah = anchors[:, 0].reshape(1, nB, 1, 1)
        inter = torch.minimum(tw[:, None], aw) * torch.minimum(th[:, None],
                                                               ah)
        union = tw[:, None] * th[:, None] + aw * ah - inter
        an_iou = inter / torch.clamp(union, min=1e-9)       # (b, nB, h, w)
        resp = F.one_hot(torch.argmax(an_iou, dim=1), nB).permute(
            0, 3, 1, 2).to(output.dtype) * obj[:, None]     # (b, nB, h, w)

        # predicted boxes (grid units) for the confidence IOU target
        pw = aw * torch.exp(wh[:, :, 0])
        ph = ah * torch.exp(wh[:, :, 1])
        iw = torch.minimum(pw, tw[:, None]) * torch.minimum(ph, th[:, None])
        iou_wh = iw / torch.clamp(pw * ph + (tw * th)[:, None] - iw, min=1e-9)

        pos = ((xy[:, :, 0] - cx[:, None]) ** 2
               + (xy[:, :, 1] - cy[:, None]) ** 2
               + (torch.sqrt(pw) - torch.sqrt(tw)[:, None]) ** 2
               + (torch.sqrt(ph) - torch.sqrt(th)[:, None]) ** 2)
        loss_pos = self.lambdaCoord * (resp * pos).sum(dim=(1, 2, 3))

        conf_t = iou_wh.detach()
        loss_conf = (resp * (conf - conf_t) ** 2).sum(dim=(1, 2, 3)) \
            + self.lambdaNoObj * ((1 - resp) * conf ** 2).sum(dim=(1, 2, 3))

        cls_t = lab[:, 4:]                                  # (b, nC, h, w)
        ce = -(cls_t[:, None] * torch.log(torch.clamp(cls, min=1e-9))
               ).sum(dim=2)                                 # (b, nB, h, w)
        loss_cls = (resp * ce).sum(dim=(1, 2, 3))
        return loss_pos + loss_conf + loss_cls


for _c in (Upsampling2D, Upsampling1D, ZeroPaddingLayer, Cropping2D,
           Deconvolution2D, DepthwiseConvolution2D, SeparableConvolution2D,
           Convolution1DLayer, Subsampling1DLayer, SpaceToDepthLayer,
           CnnLossLayer, Yolo2OutputLayer):
    register_layer(_c)
