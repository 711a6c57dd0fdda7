"""SameDiff — define-by-graph autodiff; the port of
``deeplearning4j_tpu/autodiff/samediff.py`` (the reference's
``org/nd4j/autodiff/samediff/SameDiff.java``, its op namespaces and
``TrainingConfig``).

The graph is a light Python DAG, as in the JAX package: variables,
constants, placeholders and op nodes whose ``(op, attrs)`` pairs are the
serde boundary (``graph.json``).  Where the JAX package stages the graph
into one function and ``jax.jit`` compiles it, the port stages it into the
same pure function of (placeholders, variables, iteration) and runs it
eagerly on the graph's device (``cuda`` unless the caller asks for
another); gradients are ``torch.autograd.grad`` over the variables as
leaves.  Every array of a graph lives on its device.

Mixed precision follows the reference's train step exactly: under a
BFLOAT16 ``TrainingConfig`` the float32 variables, float32 placeholders
and float32 graph constants are cast to bf16 for the forward, each loss
output is summed in float32, the L1/L2 penalties act on the float32
masters, and the gradients arrive in float32 for the updater.

The ``ops_ext`` modules register the extended ops the TF and ONNX
importers emit.
Not ported yet, and raising where they are called: the control-flow ops
(``whileLoop`` / ``ifCond`` / ``forLoop``), the rest of the ``ops_ext``
families with ``sd.image()`` / ``sd.rnn()`` / ``sd.linalg()``,
``execDebug``, ``stepCostAnalysis`` and ``invokeGraphOn`` (ROADMAP A12b).
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.autodiff.listeners import At, Loss
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet, MultiDataSet,
                                                     _tensor)
from deeplearning4j_tpu_torch.learning.config import Adam, IUpdater
from deeplearning4j_tpu_torch.nn.conf.layers import _pad2d, _same_pads
from deeplearning4j_tpu_torch.optimize.listeners import notifyListeners

__all__ = ["SameDiff", "SDVariable", "VariableType", "TrainingConfig",
           "History", "register_op", "OP_IMPLS"]

_A12B = ("the control-flow ops, the ops_ext families, execDebug, "
         "stepCostAnalysis and invokeGraphOn are not ported yet "
         "(ROADMAP A12b)")


class VariableType:
    VARIABLE = "VARIABLE"        # trainable parameter
    CONSTANT = "CONSTANT"        # fixed array
    PLACEHOLDER = "PLACEHOLDER"  # fed at exec time
    ARRAY = "ARRAY"              # op output


_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a
    name."""
    if isinstance(dt, torch.dtype):
        return dt
    name = str(dt).replace("torch.", "")
    return _DTYPES[name] if name in _DTYPES else _DTYPES[np.dtype(dt).name]


def _dtype_name(dt) -> str:
    """The dtype's numpy name, as ``graph.json`` stores it."""
    return str(_torch_dtype(dt)).replace("torch.", "")


def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Op registry: op name -> (attrs -> callable(*tensors) -> tensor | tuple).
# The registry is the serde boundary: graph.json stores (op, attrs) under
# the reference's names, so a graph saved by either package loads in the
# other.
# ---------------------------------------------------------------------------
OP_IMPLS: Dict[str, Callable[..., Callable]] = {}


def register_op(name: str):
    def deco(factory):
        OP_IMPLS[name] = factory
        return factory
    return deco


def _simple(name, fn):
    OP_IMPLS[name] = lambda **attrs: fn


def _axes(x, dims) -> Tuple[int, ...]:
    if dims is None:
        return tuple(range(x.dim()))
    if isinstance(dims, int):
        dims = (dims,)
    return tuple(int(d) % x.dim() for d in dims)


def _reduce_axes(fn, x, dims, keep):
    """``fn(x, dim, keepdim)`` over each axis of ``dims`` (all when None),
    the last first so the earlier indices stay valid."""
    for d in sorted(_axes(x, dims), reverse=True):
        x = fn(x, d, keep)
    return x


def _axis_op(name, fn):
    def factory(dims=None, keepDims=False, **_):
        return lambda x: _reduce_axes(fn, x, dims, bool(keepDims))
    OP_IMPLS[name] = factory


def _moment_op(name, fn):
    """Reductions that do not split by axis (mean, std, variance)."""
    def factory(dims=None, keepDims=False, **_):
        def f(x):
            if not x.is_floating_point():
                x = x.to(torch.get_default_dtype())
            ax = _axes(x, dims)
            return fn(x, ax, bool(keepDims)) if ax else x
        return f
    OP_IMPLS[name] = factory


def _fill_value(dtype):
    """``jnp.take``'s fill for an out-of-range index."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _wrap_index(idx, n):
    """``jnp.take``'s index rules: [-n, 0) counts from the end; the mask of
    indices inside [-n, n); the index clamped into range for the read."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), ok


def _take(x, idx, axis=0):
    """``jnp.take(x, idx, axis)`` in its default ("fill") mode: an index in
    [-n, 0) wraps once, one outside [-n, n) gives a row of NaN (floats).
    ``torch.index_select`` would raise on the CPU and assert on CUDA."""
    axis = axis % x.dim()
    n = x.shape[axis]
    safe, ok = _wrap_index(idx, n)
    out = torch.index_select(x, axis, safe.reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    ok = ok.reshape((1,) * axis + tuple(idx.shape)
                    + (1,) * (x.dim() - axis - 1))
    return torch.where(ok, out, _fill_value(x.dtype))


def _take_along_last(x, idx):
    """``jnp.take_along_axis(x, idx[..., None], -1)[..., 0]``, same rules."""
    safe, ok = _wrap_index(idx, x.shape[-1])
    out = torch.gather(x, -1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.where(ok, out, _fill_value(x.dtype))


def _abs(x):
    """|x| with the reference's gradient at 0 (``jnp.abs`` gives 1 there,
    ``torch.abs`` 0)."""
    return torch.where(x >= 0, x, -x)


# arithmetic / pairwise --------------------------------------------------
_simple("add", torch.add)
_simple("sub", torch.sub)
_simple("mul", torch.mul)
_simple("div", torch.true_divide)
_simple("rsub", lambda x, y: y - x)
_simple("rdiv", lambda x, y: y / x)
_simple("pow", torch.pow)
_simple("floordiv", torch.floor_divide)
_simple("mod", torch.remainder)
_simple("squaredDifference", lambda x, y: (x - y) ** 2)
_simple("max_pairwise", torch.maximum)
_simple("min_pairwise", torch.minimum)
_simple("atan2", torch.atan2)
# transforms -------------------------------------------------------------
for _n, _f in [("neg", torch.neg), ("exp", torch.exp), ("log", torch.log),
               ("log1p", torch.log1p), ("sqrt", torch.sqrt),
               ("square", torch.square), ("abs", _abs),
               ("sign", torch.sign), ("floor", torch.floor),
               ("ceil", torch.ceil), ("round", torch.round),
               ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
               ("asin", torch.asin), ("acos", torch.acos),
               ("atan", torch.atan), ("sinh", torch.sinh),
               ("cosh", torch.cosh), ("tanh", torch.tanh),
               ("erf", torch.erf), ("erfc", torch.erfc),
               ("sigmoid", torch.sigmoid), ("softplus", F.softplus),
               ("softsign", F.softsign),
               ("relu6", lambda x: torch.clamp(x, 0.0, 6.0)),
               ("elu", F.elu), ("selu", F.selu), ("swish", F.silu),
               ("mish", F.mish),
               # jax.nn.hard_sigmoid: relu6(x + 3) / 6
               ("hardSigmoid", lambda x: torch.clamp(x + 3.0, 0.0, 6.0) / 6),
               ("hardTanh", lambda x: torch.clamp(x, -1.0, 1.0)),
               ("reciprocal", torch.reciprocal), ("rsqrt", torch.rsqrt),
               ("identity", lambda x: x), ("logSigmoid", F.logsigmoid),
               ("isNaN", torch.isnan), ("isInf", torch.isinf),
               ("isFinite", torch.isfinite)]:
    _simple(_n, _f)


@register_op("gelu")
def _gelu_op(approximate=True, **_):
    # the tanh form by default (BERT's and the reference's convention);
    # an imported exact-erf Gelu passes approximate=False
    mode = "tanh" if approximate else "none"
    return lambda x: F.gelu(x, approximate=mode)


@register_op("relu")
def _relu(cutoff=0.0, **_):
    return lambda x: torch.where(x > cutoff, x, 0.0)


@register_op("leakyRelu")
def _leaky(alpha=0.01, **_):
    return lambda x: F.leaky_relu(x, alpha)


@register_op("clipByValue")
def _clipv(clipValueMin=0.0, clipValueMax=0.0, **_):
    return lambda x: torch.clamp(x, clipValueMin, clipValueMax)


@register_op("softmax")
def _softmax(dimension=-1, **_):
    return lambda x: torch.softmax(x, dim=dimension)


@register_op("logSoftmax")
def _logsoftmax(dimension=-1, **_):
    return lambda x: torch.log_softmax(x, dim=dimension)


@register_op("cast")
def _cast(dtype="float32", **_):
    dt = _torch_dtype(dtype)
    return lambda x: x.to(dt)


# reductions -------------------------------------------------------------
_axis_op("sum", torch.sum)
_axis_op("reduce_max", torch.amax)
_axis_op("reduce_min", torch.amin)
_axis_op("prod", torch.prod)
_axis_op("any", torch.any)
_axis_op("all", torch.all)
_moment_op("mean", torch.mean)
# Nd4j std/variance default to biasCorrected=true (ddof=1), unlike numpy
_moment_op("std", lambda x, ax, k: torch.std(x, dim=ax, correction=1,
                                             keepdim=k))
_moment_op("variance", lambda x, ax, k: torch.var(x, dim=ax, correction=1,
                                                  keepdim=k))


@register_op("countNonZero")
def _count_nz(dims=None, keepDims=False, **_):
    return lambda x: _reduce_axes(torch.sum, (x != 0).to(torch.int32), dims,
                                  bool(keepDims))


@register_op("norm1")
def _norm1(dims=None, keepDims=False, **_):
    return lambda x: _reduce_axes(torch.sum, _abs(x), dims, bool(keepDims))


@register_op("norm2")
def _norm2(dims=None, keepDims=False, **_):
    return lambda x: torch.sqrt(_reduce_axes(torch.sum, x * x, dims,
                                             bool(keepDims)))


@register_op("normMax")
def _normmax(dims=None, keepDims=False, **_):
    return lambda x: _reduce_axes(torch.amax, _abs(x), dims, bool(keepDims))


@register_op("argmax")
def _argmax(dimension=0, keepDims=False, **_):
    return lambda x: torch.argmax(x, dim=dimension, keepdim=bool(keepDims))


@register_op("argmin")
def _argmin(dimension=0, keepDims=False, **_):
    return lambda x: torch.argmin(x, dim=dimension, keepdim=bool(keepDims))


@register_op("cumsum")
def _cumsum(axis=0, **_):
    return lambda x: torch.cumsum(x, dim=axis)


@register_op("cumprod")
def _cumprod(axis=0, **_):
    return lambda x: torch.cumprod(x, dim=axis)


# blas -------------------------------------------------------------------
@register_op("mmul")
def _mmul(transposeA=False, transposeB=False, **_):
    def fn(a, b):
        if transposeA:
            a = a.transpose(-1, -2)
        if transposeB:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return fn


_simple("tensorMmul", torch.matmul)
_simple("dot", lambda a, b: torch.sum(a * b, dim=-1))


# shape ------------------------------------------------------------------
@register_op("reshape")
def _reshape(shape=(), **_):
    shp = tuple(int(s) for s in shape)
    return lambda x: torch.reshape(x, shp)


@register_op("permute")
def _permute(dims=(), **_):
    return lambda x: x.permute(*dims)


_simple("transpose", lambda x: x.transpose(-1, -2) if x.dim() >= 2 else x)


@register_op("expandDims")
def _expand(axis=0, **_):
    return lambda x: torch.unsqueeze(x, axis)


@register_op("squeeze")
def _squeeze(axis=None, **_):
    if axis is None:
        return torch.squeeze
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)
    return lambda x: torch.squeeze(x, ax)


@register_op("concat")
def _concat(dimension=0, **_):
    return lambda *xs: torch.cat(xs, dim=dimension)


@register_op("stack")
def _stack(axis=0, **_):
    return lambda *xs: torch.stack(xs, dim=axis)


@register_op("unstack")
def _unstack(axis=0, num=None, **_):
    return lambda x: tuple(torch.unbind(x, dim=axis))


@register_op("tile")
def _tile(reps=(), **_):
    return lambda x: torch.tile(x, tuple(reps))


@register_op("slice")
def _slice(begin=(), size=(), **_):
    def fn(x):
        ends = [b + s if s >= 0 else x.shape[i]
                for i, (b, s) in enumerate(zip(begin, size))]
        return x[tuple(slice(b, e) for b, e in zip(begin, ends))]
    return fn


@register_op("stridedSlice")
def _strided(begin=(), end=(), strides=None, axes=None, **_):
    def fn(x):
        st = strides or [1] * len(begin)
        ax = axes if axes is not None else list(range(len(begin)))
        sl = [slice(None)] * x.dim()
        for a, b, e, s_ in zip(ax, begin, end, st):
            # None = open end (TF mask semantics); non-negative ends clamp
            # to the dim (ONNX INT64_MAX "to the end" sentinels)
            if e is not None:
                e = min(int(e), x.shape[int(a)]) if int(e) >= 0 else int(e)
            b = None if b is None else int(b)
            sl[int(a)] = slice(b, e, int(s_))
        # torch slices take positive steps only: a negative one becomes
        # the same index range, selected
        rev = [(a, s) for a, s in enumerate(sl)
               if s.step is not None and s.step < 0]
        x = x[tuple(slice(None) if s.step is not None and s.step < 0 else s
                    for s in sl)]
        for a, s in rev:
            idx = torch.arange(*s.indices(x.shape[a]), device=x.device)
            x = torch.index_select(x, a, idx)
        return x
    return fn


@register_op("gather")
def _gather(axis=0, **_):
    return lambda x, idx: _take(x, idx, axis)


@register_op("scatterUpdate")
def _scatter_upd(**_):
    return lambda ref, idx, upd: torch.index_put(ref, (idx.long(),), upd)


@register_op("scatterAdd")
def _scatter_add(**_):
    return lambda ref, idx, upd: torch.index_put(ref, (idx.long(),), upd,
                                                 accumulate=True)


@register_op("reverse")
def _reverse(dims=(0,), **_):
    return lambda x: torch.flip(x, dims=tuple(dims))


@register_op("pad")
def _pad(paddings=(), constant=0.0, mode="CONSTANT", **_):
    m = {"CONSTANT": "constant", "REFLECT": "reflect",
         "SYMMETRIC": "symmetric"}[mode]
    pw = [tuple(int(v) for v in p) for p in paddings]

    def fn(x):
        if m == "constant":
            flat = [v for lo_hi in reversed(pw) for v in lo_hi]
            return F.pad(x, flat, value=constant)
        # numpy's padding of an index range gives the source index of
        # every padded position
        for a, (lo, hi) in enumerate(pw):
            idx = np.pad(np.arange(x.shape[a]), (lo, hi), mode=m)
            x = torch.index_select(x, a, torch.as_tensor(idx,
                                                         device=x.device))
        return x
    return fn


@register_op("oneHot")
def _onehot(depth=2, on=1.0, off=0.0, axis=-1, **_):
    def fn(x):
        oh = (x.long().unsqueeze(-1)
              == torch.arange(depth, device=x.device)).to(
                  torch.get_default_dtype())
        if axis != -1:
            oh = torch.movedim(oh, -1, axis)
        return oh * (on - off) + off
    return fn


_simple("shape_of", lambda x: torch.tensor(list(x.shape), dtype=torch.int64,
                                           device=x.device))
_simple("size", lambda x: torch.tensor(x.numel(), dtype=torch.int64,
                                       device=x.device))
_simple("rank", lambda x: torch.tensor(x.dim(), dtype=torch.int32,
                                       device=x.device))
_simple("zerosLike", torch.zeros_like)
_simple("onesLike", torch.ones_like)


# ops without inputs build on the CPU; the staged function moves them to
# the graph's device
@register_op("fill")
def _fill(shape=(), value=0.0, dtype="float32", **_):
    return lambda: torch.full(tuple(shape), value, dtype=_torch_dtype(dtype))


@register_op("range")
def _range(start=0.0, limit=1.0, delta=1.0, dtype="float32", **_):
    return lambda: torch.arange(start, limit, delta,
                                dtype=_torch_dtype(dtype))


@register_op("linspace")
def _linspace(start=0.0, stop=1.0, num=10, **_):
    return lambda: torch.linspace(start, stop, num)


@register_op("eye")
def _eye(rows=1, cols=None, **_):
    return lambda: torch.eye(rows, rows if cols is None else cols)


# comparison / select ----------------------------------------------------
_simple("eq", torch.eq)
_simple("neq", torch.ne)
_simple("gt", torch.gt)
_simple("gte", torch.ge)
_simple("lt", torch.lt)
_simple("lte", torch.le)
_simple("and_", torch.logical_and)
_simple("or_", torch.logical_or)
_simple("xor", torch.logical_xor)
_simple("not_", torch.logical_not)


def _where(c, x, y):
    return torch.where(c if c.dtype == torch.bool else c != 0, x, y)


_simple("where", _where)
_simple("select", _where)


# misc -------------------------------------------------------------------
@register_op("matrixDiag")
def _mdiag(**_):
    return torch.diag


@register_op("trace")
def _trace(**_):
    return lambda x: torch.diagonal(x, 0, 0, 1).sum(-1)


# nn ---------------------------------------------------------------------
@register_op("linear")
def _linear(**_):
    return lambda x, w, b: torch.matmul(x, w) + b


@register_op("reluLayer")
def _relu_layer(**_):
    return lambda x, w, b: torch.relu(torch.matmul(x, w) + b)


@register_op("layerNorm")
def _layernorm(axis=-1, eps=1e-5, noBias=False, **_):
    # the reference's eps (1e-5, not BERT's 1e-12) and biased variance
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def fn(x, g, *b):
        mu = torch.mean(x, dim=ax, keepdim=True)
        var = torch.var(x, dim=ax, correction=0, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps) * g
        return y if (noBias or not b) else y + b[0]
    return fn


@register_op("batchNorm")
def _batchnorm(axis=1, eps=1e-5, **_):
    def fn(x, mean, var, gamma, beta):
        shp = [1] * x.dim()
        shp[axis] = -1
        rs = lambda a: torch.reshape(a, shp)
        return (x - rs(mean)) * torch.rsqrt(rs(var) + eps) * rs(gamma) \
            + rs(beta)
    return fn


@register_op("dropout")
def _dropout(p=0.5, seed=0, **_):
    # p is the RETAIN probability (ND4J DropOutInverted).  The staged
    # function passes the iteration, so each train step draws a fresh mask
    # from a generator seeded with (seed, iteration); identity at inference
    def fn(x, it):
        gen = torch.Generator(device=x.device).manual_seed(
            ((int(seed) & 0x7FFFFFFF) << 32) | (int(it) & 0xFFFFFFFF))
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p
        return torch.where(keep, x / p, 0.0)
    return fn


RNG_TRAIN_OPS = {"dropout"}  # identity at inference; fresh mask per step


@register_op("conv2d")
def _conv2d(kH=1, kW=1, sH=1, sW=1, pH=0, pW=0, dH=1, dW=1,
            isSameMode=False, dataFormat="NCHW", **_):
    def fn(x, w, *b):
        # w: (kH, kW, inC, outC) — ND4J's conv weight layout for SameDiff
        if dataFormat == "NHWC":
            x = x.permute(0, 3, 1, 2)
        if isSameMode:      # the kernel's size is w's, whatever kH/kW say
            x = _pad2d(x, (_same_pads(x.shape[2], w.shape[0], sH, dH),
                           _same_pads(x.shape[3], w.shape[1], sW, dW)))
            pad = 0
        else:
            pad = (pH, pW)
        y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=(sH, sW),
                     padding=pad, dilation=(dH, dW))
        if b:
            y = y + b[0].reshape(1, -1, 1, 1)
        return y.permute(0, 2, 3, 1) if dataFormat == "NHWC" else y
    return fn


def _pool2d(kind, kH, kW, sH, sW, pH, pW, isSameMode, dataFormat):
    """``lax.reduce_window`` max / mean pooling, SAME or explicit padding;
    the mean divides by the window's count of real (unpadded) inputs."""
    def fn(x):
        if dataFormat == "NHWC":
            x = x.permute(0, 3, 1, 2)
        pads = ((_same_pads(x.shape[2], kH, sH), _same_pads(x.shape[3], kW,
                                                            sW))
                if isSameMode else ((pH, pH), (pW, pW)))
        if kind == "max":
            y = F.max_pool2d(_pad2d(x, pads, float("-inf")), (kH, kW),
                             (sH, sW))
        else:
            ones = torch.ones_like(x[:1, :1])
            y = F.avg_pool2d(_pad2d(x, pads), (kH, kW), (sH, sW)) \
                / F.avg_pool2d(_pad2d(ones, pads), (kH, kW), (sH, sW))
        return y.permute(0, 2, 3, 1) if dataFormat == "NHWC" else y
    return fn


@register_op("maxPooling2d")
def _maxpool2d(kH=2, kW=2, sH=2, sW=2, pH=0, pW=0, isSameMode=False,
               dataFormat="NCHW", **_):
    return _pool2d("max", kH, kW, sH, sW, pH, pW, isSameMode, dataFormat)


@register_op("avgPooling2d")
def _avgpool2d(kH=2, kW=2, sH=2, sW=2, pH=0, pW=0, isSameMode=False,
               dataFormat="NCHW", **_):
    return _pool2d("avg", kH, kW, sH, sW, pH, pW, isSameMode, dataFormat)


@register_op("embeddingLookup")
def _embed(**_):
    return lambda table, ids: _take(table, ids, 0)


def _scale(scores, d):
    """scores / sqrt(d), the root taken in the scores' dtype as the
    reference's ``jnp.sqrt(jnp.asarray(d, scores.dtype))``."""
    return scores / float(torch.tensor(float(d), dtype=scores.dtype).sqrt())


@register_op("dotProductAttention")
def _dpa(scaled=True, withWeights=False, **_):
    # Reference: libnd4j ops/declarable/generic/nn/dot_product_attention.cpp
    def fn(q, k, v, *mask):
        scores = torch.matmul(q, k.transpose(-1, -2))
        if scaled:
            scores = _scale(scores, q.shape[-1])
        if mask:
            scores = torch.where(mask[0] != 0, scores, -1e9)
        w = torch.softmax(scores, dim=-1)
        out = torch.matmul(w, v)
        return (out, w) if withWeights else out
    return fn


@register_op("multiHeadDotProductAttention")
def _mhdpa(nHeads=1, scaled=True, **_):
    # Reference: libnd4j multi_head_dot_product_attention.cpp.  Inputs
    # q, k, v: (b, t, dModel); Wq/Wk/Wv: (dModel, nHeads*dHead); Wo:
    # (nHeads*dHead, dModel).  Plain ops, never the flash kernels: a key
    # mask fills with -1e9 (not -inf), so a fully masked row gives uniform
    # weights as the reference's does.
    def fn(q, k, v, Wq, Wk, Wv, Wo, *mask):
        b, tq, _ = q.shape
        tk = k.shape[1]

        def proj(x, w):
            y = torch.matmul(x, w)
            return y.reshape(b, x.shape[1], nHeads, -1).transpose(1, 2)
        qh, kh, vh = proj(q, Wq), proj(k, Wk), proj(v, Wv)
        scores = torch.matmul(qh, kh.transpose(-1, -2))
        if scaled:
            scores = _scale(scores, qh.shape[-1])
        if mask:
            m = (mask[0] != 0).reshape(b, 1, 1, tk)
            scores = torch.where(m, scores, -1e9)
        w = torch.softmax(scores, dim=-1)
        out = torch.matmul(w, vh)
        out = out.transpose(1, 2).reshape(b, tq, -1)
        return torch.matmul(out, Wo)
    return fn


# losses -----------------------------------------------------------------
def _reduce_loss(per_ex, reduction, w=None):
    """LossReduce semantics (reference: org/nd4j/autodiff/loss/LossReduce).

    With weights, MEAN_BY_NONZERO_WEIGHT_COUNT divides by the number of
    non-zero weights (the masked-LM convention; at least 1),
    MEAN_BY_WEIGHT by sum(w)."""
    if w is not None:
        per_ex = per_ex * w
        w = torch.broadcast_to(w, per_ex.shape)  # count broadcast elements
    if reduction == "NONE":
        return per_ex
    if reduction == "SUM":
        return torch.sum(per_ex)
    if w is None:
        return torch.mean(per_ex)
    if reduction == "MEAN_BY_WEIGHT":
        return torch.sum(per_ex) / torch.clamp(torch.sum(w), min=1e-9)
    nz = torch.sum((w != 0).to(per_ex.dtype))
    return torch.sum(per_ex) / torch.clamp(nz, min=1.0)


@register_op("softmaxCrossEntropy")
def _sce(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", labelSmoothing=0.0, **_):
    def fn(logits, labels, *w):
        if labelSmoothing:
            n = labels.shape[-1]
            labels = labels * (1.0 - labelSmoothing) + labelSmoothing / n
        per = -torch.sum(labels * torch.log_softmax(logits, -1), dim=-1)
        return _reduce_loss(per, reduction, w[0] if w else None)
    return fn


@register_op("sparseSoftmaxCrossEntropy")
def _ssce(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    # labels arrive as int32; the per-token loss stays in the logits'
    # dtype (bf16 under BFLOAT16 compute, as the reference's)
    def fn(logits, labels, *w):
        per = -_take_along_last(torch.log_softmax(logits, -1), labels)
        return _reduce_loss(per, reduction, w[0] if w else None)
    return fn


@register_op("sigmoidCrossEntropy")
def _sigce(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def fn(logits, labels, *w):
        per = torch.mean(
            torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-_abs(logits))), dim=-1)
        return _reduce_loss(per, reduction, w[0] if w else None)
    return fn


@register_op("meanSquaredError")
def _mse_loss(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def fn(pred, labels, *w):
        per = torch.mean((pred - labels) ** 2, dim=-1)
        return _reduce_loss(per, reduction, w[0] if w else None)
    return fn


@register_op("absoluteDifference")
def _l1_loss(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def fn(pred, labels, *w):
        per = torch.mean(_abs(pred - labels), dim=-1)
        return _reduce_loss(per, reduction, w[0] if w else None)
    return fn


@register_op("huberLoss")
def _huber(delta=1.0, reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def fn(pred, labels, *w):
        # weights are accepted and unused, as in the reference
        e = _abs(pred - labels)
        per = torch.mean(torch.where(e <= delta, 0.5 * e * e,
                                     delta * e - 0.5 * delta * delta), dim=-1)
        return _reduce_loss(per, reduction)
    return fn


@register_op("logLoss")
def _logloss(eps=1e-7, reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def fn(pred, labels):
        p = torch.clamp(pred, eps, 1.0 - eps)
        per = -torch.mean(labels * torch.log(p)
                          + (1 - labels) * torch.log(1 - p), dim=-1)
        return _reduce_loss(per, reduction)
    return fn


@register_op("cosineDistance")
def _cosdist(dimension=-1, reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def fn(pred, labels):
        per = 1.0 - torch.sum(pred * labels, dim=dimension)
        return _reduce_loss(per, reduction)
    return fn


# random (seeded per node: the same values on every call and device; not
# the reference's bits, which come from jax.random) ----------------------
def _gen(seed):
    return torch.Generator().manual_seed(int(seed))


@register_op("random_normal")
def _rnormal(shape=(), seed=0, mean=0.0, stddev=1.0, **_):
    return lambda: mean + stddev * torch.randn(tuple(shape),
                                               generator=_gen(seed))


@register_op("random_uniform")
def _runiform(shape=(), seed=0, minVal=0.0, maxVal=1.0, **_):
    return lambda: minVal + (maxVal - minVal) * torch.rand(
        tuple(shape), generator=_gen(seed))


@register_op("random_bernoulli")
def _rbern(shape=(), seed=0, p=0.5, **_):
    return lambda: (torch.rand(tuple(shape), generator=_gen(seed)) < p).to(
        torch.float32)


# ---------------------------------------------------------------------------
# SDVariable
# ---------------------------------------------------------------------------
class SDVariable:
    """Symbolic variable (reference: org/nd4j/autodiff/samediff/SDVariable)."""

    def __init__(self, sd: "SameDiff", name: str, varType: str,
                 shape=None, dtype=None):
        self.sd = sd
        self._name = name
        self.variableType = varType
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    def name(self) -> str:
        return self._name

    def rename(self, newName: str) -> "SDVariable":
        return self.sd.renameVariable(self._name, newName)

    # -- arithmetic (each records a graph op) --
    def _bin(self, op, other, rev=False):
        o = other if isinstance(other, SDVariable) else self.sd.constant(other)
        a, b = (o, self) if rev else (self, o)
        return self.sd._op(op, [a, b])

    def add(self, o): return self._bin("add", o)
    def sub(self, o): return self._bin("sub", o)
    def mul(self, o): return self._bin("mul", o)
    def div(self, o): return self._bin("div", o)
    def rsub(self, o): return self._bin("sub", o, rev=True)
    def rdiv(self, o): return self._bin("div", o, rev=True)
    def pow(self, o): return self._bin("pow", o)
    __add__ = add
    __radd__ = add
    __sub__ = sub
    __rsub__ = rsub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __rtruediv__ = rdiv
    __pow__ = pow

    def __neg__(self): return self.sd._op("neg", [self])

    def neg(self): return -self

    def mmul(self, o, transposeA=False, transposeB=False):
        return self.sd._op("mmul", [self, o], {"transposeA": transposeA,
                                              "transposeB": transposeB})

    def __matmul__(self, o): return self.mmul(o)

    # comparisons
    def eq(self, o): return self._bin("eq", o)
    def neq(self, o): return self._bin("neq", o)
    def gt(self, o): return self._bin("gt", o)
    def gte(self, o): return self._bin("gte", o)
    def lt(self, o): return self._bin("lt", o)
    def lte(self, o): return self._bin("lte", o)

    # reductions / transforms
    def _red(self, op, dims, keepDims):
        if dims is not None and not isinstance(dims, (list, tuple)):
            dims = (dims,)
        return self.sd._op(op, [self], {"dims": dims, "keepDims": keepDims})

    def sum(self, *dims, keepDims=False):
        return self._red("sum", dims or None, keepDims)

    def mean(self, *dims, keepDims=False):
        return self._red("mean", dims or None, keepDims)

    def max(self, *dims, keepDims=False):
        return self._red("reduce_max", dims or None, keepDims)

    def min(self, *dims, keepDims=False):
        return self._red("reduce_min", dims or None, keepDims)

    def std(self, *dims, keepDims=False):
        return self._red("std", dims or None, keepDims)

    def prod(self, *dims, keepDims=False):
        return self._red("prod", dims or None, keepDims)

    def norm1(self, *dims): return self._red("norm1", dims or None, False)
    def norm2(self, *dims): return self._red("norm2", dims or None, False)

    def argmax(self, dimension=0):
        return self.sd._op("argmax", [self], {"dimension": dimension})

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self], {"shape": shape})

    def permute(self, *dims):
        return self.sd._op("permute", [self], {"dims": dims})

    def transpose(self):
        return self.sd._op("transpose", [self])

    def castTo(self, dtype):
        return self.sd._op("cast", [self], {"dtype": _dtype_name(dtype)})

    def get(self, *slices):
        """Static slicing (NDArrayIndex.interval analogue)."""
        begin, end, strides = [], [], []
        for s in slices:
            if isinstance(s, slice):
                begin.append(s.start or 0)
                end.append(s.stop)
                strides.append(s.step or 1)
            else:
                begin.append(int(s))
                end.append(int(s) + 1)
                strides.append(1)
        return self.sd._op("stridedSlice", [self],
                           {"begin": begin, "end": end, "strides": strides})

    __getitem__ = get

    # -- graph state --
    def markAsLoss(self):
        self.sd.setLossVariables(self._name, extend=True)
        return self

    def getArr(self) -> Optional[torch.Tensor]:
        return self.sd._arrays.get(self._name)

    def setArray(self, arr):
        self.sd.setArrayForVariable(self._name, arr)

    def eval(self, placeholders: Optional[Dict] = None) -> torch.Tensor:
        return self.sd.output(placeholders or {}, self._name)[self._name]

    def gradient(self) -> Optional[torch.Tensor]:
        return self.sd._last_grads.get(self._name)

    def __repr__(self):
        return (f"SDVariable(name={self._name!r}, "
                f"type={self.variableType}, shape={self.shape})")


# ---------------------------------------------------------------------------
# Op namespaces (sd.math() etc. — reference org/nd4j/autodiff/samediff/ops/)
# ---------------------------------------------------------------------------
class _Namespace:
    def __init__(self, sd: "SameDiff"):
        self.sd = sd


def _ns_unary(op):
    def m(self, x: SDVariable, name: str = None):
        return self.sd._op(op, [x], name=name)
    return m


def _ns_binary(op):
    def m(self, x: SDVariable, y, name: str = None):
        y = y if isinstance(y, SDVariable) else self.sd.constant(y)
        return self.sd._op(op, [x, y], name=name)
    return m


class SDMath(_Namespace):
    for _o in ["exp", "log", "log1p", "sqrt", "square", "abs", "sign",
               "floor", "ceil", "round", "sin", "cos", "tan", "asin", "acos",
               "atan", "sinh", "cosh", "tanh", "erf", "erfc", "neg",
               "reciprocal", "rsqrt", "isNaN", "isInf", "isFinite",
               "cumsum", "cumprod", "trace"]:
        locals()[_o] = _ns_unary(_o)
    for _o in ["add", "sub", "mul", "div", "pow", "atan2", "mod",
               "squaredDifference"]:
        locals()[_o] = _ns_binary(_o)
    max = _ns_binary("max_pairwise")
    min = _ns_binary("min_pairwise")
    and_ = _ns_binary("and_")
    or_ = _ns_binary("or_")
    xor = _ns_binary("xor")
    not_ = _ns_unary("not_")
    del _o

    def clipByValue(self, x, lo, hi, name=None):
        return self.sd._op("clipByValue", [x],
                           {"clipValueMin": lo, "clipValueMax": hi}, name=name)


class SDNN(_Namespace):
    for _o in ["sigmoid", "softplus", "softsign", "elu", "selu", "swish",
               "mish", "gelu", "relu6", "hardSigmoid", "hardTanh",
               "logSigmoid", "tanh"]:
        locals()[_o] = _ns_unary(_o)
    del _o

    def relu(self, x, cutoff=0.0, name=None):
        return self.sd._op("relu", [x], {"cutoff": cutoff}, name=name)

    def leakyRelu(self, x, alpha=0.01, name=None):
        return self.sd._op("leakyRelu", [x], {"alpha": alpha}, name=name)

    def softmax(self, x, dimension=-1, name=None):
        return self.sd._op("softmax", [x], {"dimension": dimension}, name=name)

    def logSoftmax(self, x, dimension=-1, name=None):
        return self.sd._op("logSoftmax", [x], {"dimension": dimension},
                           name=name)

    def linear(self, x, w, b, name=None):
        return self.sd._op("linear", [x, w, b], name=name)

    def reluLayer(self, x, w, b, name=None):
        return self.sd._op("reluLayer", [x, w, b], name=name)

    def layerNorm(self, x, gain, bias=None, axis=-1, name=None):
        ins = [x, gain] + ([bias] if bias is not None else [])
        return self.sd._op("layerNorm", ins,
                           {"axis": axis, "noBias": bias is None}, name=name)

    def batchNorm(self, x, mean, var, gamma, beta, eps=1e-5, axis=1,
                  name=None):
        return self.sd._op("batchNorm", [x, mean, var, gamma, beta],
                           {"axis": axis, "eps": eps}, name=name)

    def dropout(self, x, keepProb=0.5, seed=0, name=None):
        return self.sd._op("dropout", [x], {"p": keepProb, "seed": seed},
                           name=name)

    def dotProductAttention(self, q, k, v, mask=None, scaled=True, name=None):
        ins = [q, k, v] + ([mask] if mask is not None else [])
        return self.sd._op("dotProductAttention", ins, {"scaled": scaled},
                           name=name)

    def multiHeadDotProductAttention(self, q, k, v, Wq, Wk, Wv, Wo,
                                     mask=None, nHeads=1, scaled=True,
                                     name=None):
        ins = [q, k, v, Wq, Wk, Wv, Wo] + ([mask] if mask is not None else [])
        return self.sd._op("multiHeadDotProductAttention", ins,
                           {"nHeads": nHeads, "scaled": scaled}, name=name)

    def embeddingLookup(self, table, ids, name=None):
        return self.sd._op("embeddingLookup", [table, ids], name=name)

    def pad(self, x, paddings, constant=0.0, mode="CONSTANT", name=None):
        return self.sd._op("pad", [x], {"paddings": paddings,
                                        "constant": constant, "mode": mode},
                           name=name)


class SDCNN(_Namespace):
    def conv2d(self, x, w, b=None, kH=None, kW=None, sH=1, sW=1, pH=0, pW=0,
               dH=1, dW=1, isSameMode=False, dataFormat="NCHW", name=None):
        if kH is None:
            kH, kW = int(w.shape[0]), int(w.shape[1])
        ins = [x, w] + ([b] if b is not None else [])
        return self.sd._op("conv2d", ins,
                           {"kH": kH, "kW": kW, "sH": sH, "sW": sW,
                            "pH": pH, "pW": pW, "dH": dH, "dW": dW,
                            "isSameMode": isSameMode,
                            "dataFormat": dataFormat}, name=name)

    def maxPooling2d(self, x, kH=2, kW=2, sH=2, sW=2, pH=0, pW=0,
                     isSameMode=False, name=None):
        return self.sd._op("maxPooling2d", [x],
                           {"kH": kH, "kW": kW, "sH": sH, "sW": sW,
                            "pH": pH, "pW": pW, "isSameMode": isSameMode},
                           name=name)

    def avgPooling2d(self, x, kH=2, kW=2, sH=2, sW=2, pH=0, pW=0,
                     isSameMode=False, name=None):
        return self.sd._op("avgPooling2d", [x],
                           {"kH": kH, "kW": kW, "sH": sH, "sW": sW,
                            "pH": pH, "pW": pW, "isSameMode": isSameMode},
                           name=name)


class SDLoss(_Namespace):
    def softmaxCrossEntropy(self, label, logits, weights=None,
                            labelSmoothing=0.0, name=None):
        ins = [logits, label] + ([weights] if weights is not None else [])
        return self.sd._op("softmaxCrossEntropy", ins,
                           {"labelSmoothing": labelSmoothing},
                           name=name).markAsLoss()

    def sparseSoftmaxCrossEntropy(self, logits, labels, weights=None,
                                  name=None):
        ins = [logits, labels] + ([weights] if weights is not None else [])
        return self.sd._op("sparseSoftmaxCrossEntropy", ins,
                           name=name).markAsLoss()

    def sigmoidCrossEntropy(self, label, logits, weights=None, name=None):
        ins = [logits, label] + ([weights] if weights is not None else [])
        return self.sd._op("sigmoidCrossEntropy", ins, name=name).markAsLoss()

    def meanSquaredError(self, label, pred, weights=None, name=None):
        ins = [pred, label] + ([weights] if weights is not None else [])
        return self.sd._op("meanSquaredError", ins, name=name).markAsLoss()

    def absoluteDifference(self, label, pred, weights=None, name=None):
        ins = [pred, label] + ([weights] if weights is not None else [])
        return self.sd._op("absoluteDifference", ins, name=name).markAsLoss()

    def huberLoss(self, label, pred, delta=1.0, name=None):
        return self.sd._op("huberLoss", [pred, label], {"delta": delta},
                           name=name).markAsLoss()

    def logLoss(self, label, pred, name=None):
        return self.sd._op("logLoss", [pred, label], name=name).markAsLoss()

    def cosineDistance(self, label, pred, dimension=-1, name=None):
        return self.sd._op("cosineDistance", [pred, label],
                           {"dimension": dimension}, name=name).markAsLoss()


class SDRandom(_Namespace):
    def normal(self, mean, stddev, shape, seed=0, name=None):
        return self.sd._op("random_normal", [],
                           {"shape": shape, "seed": seed, "mean": mean,
                            "stddev": stddev}, name=name)

    def uniform(self, minVal, maxVal, shape, seed=0, name=None):
        return self.sd._op("random_uniform", [],
                           {"shape": shape, "seed": seed, "minVal": minVal,
                            "maxVal": maxVal}, name=name)

    def bernoulli(self, p, shape, seed=0, name=None):
        return self.sd._op("random_bernoulli", [],
                           {"shape": shape, "seed": seed, "p": p}, name=name)


# ---------------------------------------------------------------------------
# TrainingConfig
# ---------------------------------------------------------------------------
class TrainingConfig:
    """Reference: org/nd4j/autodiff/samediff/TrainingConfig.java."""

    def __init__(self, updater: Optional[IUpdater] = None,
                 dataSetFeatureMapping: Sequence[str] = (),
                 dataSetLabelMapping: Sequence[str] = (),
                 l1: float = 0.0, l2: float = 0.0,
                 minimize: bool = True, dataType: str = "FLOAT"):
        self.updater = updater or Adam()
        self.dataSetFeatureMapping = list(dataSetFeatureMapping)
        self.dataSetLabelMapping = list(dataSetLabelMapping)
        self.l1 = l1
        self.l2 = l2
        self.minimize = minimize
        # "BFLOAT16"/"HALF": bf16 compute with f32 master variables (the
        # same mixed-precision contract as MultiLayerNetwork's dataType)
        self.dataType = dataType

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def dataSetFeatureMapping(self, *names):
            self._kw["dataSetFeatureMapping"] = list(names)
            return self

        def dataSetLabelMapping(self, *names):
            self._kw["dataSetLabelMapping"] = list(names)
            return self

        def dataType(self, dt: str):
            self._kw["dataType"] = dt
            return self

        def l1(self, v):
            self._kw["l1"] = v
            return self

        def l2(self, v):
            self._kw["l2"] = v
            return self

        def minimize(self, v=True):
            self._kw["minimize"] = v
            return self

        def build(self):
            return TrainingConfig(**self._kw)


def _fetch_curve(losses: List[torch.Tensor]) -> List[float]:
    """One stacked device-to-host copy for a loss curve, not one per
    step."""
    return torch.stack(losses).tolist() if losses else []


class History:
    """Reference: org/nd4j/autodiff/listeners/records/History.java."""

    def __init__(self, losses: List[float]):
        self._losses = losses

    def lossCurve(self) -> List[float]:
        return list(self._losses)

    def finalTrainingLoss(self) -> float:
        return self._losses[-1] if self._losses else float("nan")


# ---------------------------------------------------------------------------
# SameDiff
# ---------------------------------------------------------------------------
class _OpNode:
    __slots__ = ("op", "name", "inputs", "outputs", "attrs")

    def __init__(self, op, name, inputs, outputs, attrs):
        self.op = op
        self.name = name
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs


_HALF_TYPES = ("BFLOAT16", "HALF", "FLOAT16")


class SameDiff:
    """The graph container (reference: org/nd4j/autodiff/samediff/SameDiff).
    Its arrays live on ``device`` (``cuda`` unless the caller asks for
    another)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._ops: List[_OpNode] = []
        self._producer: Dict[str, Tuple[_OpNode, int]] = {}
        self._arrays: Dict[str, torch.Tensor] = {}  # VARIABLE/CONSTANT values
        self._loss_vars: List[str] = []
        self._counter = 0
        self._fn_cache: Dict[Any, Any] = {}
        self._train_step = None
        self._opt_state = None
        self._training_config: Optional[TrainingConfig] = None
        self._last_grads: Dict[str, torch.Tensor] = {}
        self.iterationCount = 0
        self._listeners: List = []
        self._math = SDMath(self)
        self._nn = SDNN(self)
        self._cnn = SDCNN(self)
        self._loss = SDLoss(self)
        self._random = SDRandom(self)

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    # namespaces
    def math(self): return self._math
    def nn(self): return self._nn
    def cnn(self): return self._cnn
    def loss(self): return self._loss
    def random(self): return self._random

    def image(self):
        raise NotImplementedError(f"sd.image(): {_A12B}")

    def rnn(self):
        raise NotImplementedError(f"sd.rnn(): {_A12B}")

    def linalg(self):
        raise NotImplementedError(f"sd.linalg(): {_A12B}")

    # ---------------- variable management ----------------
    def _unique(self, base: str) -> str:
        if base not in self._vars:
            return base
        i = 1
        while f"{base}_{i}" in self._vars:
            i += 1
        return f"{base}_{i}"

    def _register(self, name, varType, shape=None, dtype=None) -> SDVariable:
        dt = _torch_dtype(dtype) if dtype is not None else None
        v = SDVariable(self, name, varType, shape, dt)
        self._vars[name] = v
        return v

    def placeholder(self, name: str, dtype=torch.float32,
                    shape: Sequence[Optional[int]] = None) -> SDVariable:
        return self._register(self._unique(name), VariableType.PLACEHOLDER,
                              shape, dtype)

    def var(self, name: str, arr=None, shape=None,
            dtype=torch.float32) -> SDVariable:
        """Trainable variable; ``arr`` gives the initial value."""
        name = self._unique(name)
        a = _tensor(arr).to(self.device) if arr is not None else \
            torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                        device=self.device)
        self._arrays[name] = a
        return self._register(name, VariableType.VARIABLE, a.shape, a.dtype)

    def constant(self, value, name: str = None) -> SDVariable:
        name = self._unique(name or f"const_{self._counter}")
        self._counter += 1
        # bare Python scalars become float32 / int32 (int64 past int32's
        # range), as the reference's: one float64 constant would promote
        # its whole subgraph
        if type(value) is float:
            a = torch.tensor(value, dtype=torch.float32)
        elif isinstance(value, bool):
            a = torch.tensor(value)
        elif isinstance(value, int):
            a = torch.tensor(value, dtype=torch.int32
                             if -(2**31) <= value < 2**31 else torch.int64)
        else:
            a = _tensor(value)
        a = a.to(self.device)
        self._arrays[name] = a
        return self._register(name, VariableType.CONSTANT, a.shape, a.dtype)

    def zero(self, name, *shape):
        return self.constant(np.zeros(shape, np.float32), name=name)

    def one(self, name, *shape):
        return self.constant(np.ones(shape, np.float32), name=name)

    def getVariable(self, name: str) -> SDVariable:
        return self._vars[name]

    def hasVariable(self, name: str) -> bool:
        return name in self._vars

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def variableMap(self) -> Dict[str, SDVariable]:
        return dict(self._vars)

    def renameVariable(self, old: str, new: str) -> SDVariable:
        v = self._vars.pop(old)
        v._name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        for node in self._ops:
            node.inputs = [new if i == old else i for i in node.inputs]
            node.outputs = [new if o == old else o for o in node.outputs]
        self._producer = {}
        for node in self._ops:
            for i, o in enumerate(node.outputs):
                self._producer[o] = (node, i)
        self._loss_vars = [new if n == old else n for n in self._loss_vars]
        self._invalidate()
        return v

    def _invalidate(self):
        self._fn_cache.clear()
        self._train_step = None

    def setArrayForVariable(self, name: str, arr):
        self._arrays[name] = _tensor(arr).to(self.device)
        self._invalidate()

    def convertToConstant(self, var: SDVariable):
        var.variableType = VariableType.CONSTANT
        self._invalidate()
        return var

    def convertToVariable(self, var: SDVariable):
        var.variableType = VariableType.VARIABLE
        self._invalidate()
        return var

    def setLossVariables(self, *names, extend=False):
        names = [n.name() if isinstance(n, SDVariable) else n for n in names]
        if extend:
            self._loss_vars.extend(n for n in names
                                   if n not in self._loss_vars)
        else:
            self._loss_vars = list(names)

    def getLossVariables(self) -> List[str]:
        return list(self._loss_vars)

    # ---------------- graph building ----------------
    def _op(self, op: str, inputs: Sequence[SDVariable],
            attrs: Optional[Dict] = None, n_out: int = 1,
            name: str = None) -> Union[SDVariable, List[SDVariable]]:
        if op not in OP_IMPLS:
            raise ValueError(f"Unknown op: {op} ({_A12B})")
        attrs = dict(attrs or {})
        base = name or op
        out_names = [self._unique(base if (i == 0 and n_out == 1)
                                  else f"{base}:{i}") for i in range(n_out)]
        node = _OpNode(op, out_names[0], [v.name() for v in inputs],
                       out_names, attrs)
        self._ops.append(node)
        outs = [self._register(nm, VariableType.ARRAY) for nm in out_names]
        for i, nm in enumerate(out_names):
            self._producer[nm] = (node, i)
        self._invalidate()
        return outs[0] if n_out == 1 else outs

    def whileLoop(self, loopVars, cond, body, name: str = None):
        raise NotImplementedError(f"whileLoop: {_A12B}")

    def ifCond(self, inputs, cond, trueBody, falseBody, name: str = None):
        raise NotImplementedError(f"ifCond: {_A12B}")

    def forLoop(self, nIterations, loopVars, body, name: str = None):
        raise NotImplementedError(f"forLoop: {_A12B}")

    def _graph_payload(self) -> Dict:
        """JSON-able description of the graph (``graph.json``; the arrays
        go to ``arrays.npz``)."""
        return {
            "variables": [
                {"name": v.name(), "type": v.variableType,
                 "shape": list(v.shape) if v.shape else None,
                 "dtype": (_dtype_name(v.dtype)
                           if v.dtype is not None else None)}
                for v in self._vars.values()],
            "ops": [{"op": n.op, "name": n.name, "inputs": n.inputs,
                     "outputs": n.outputs, "attrs": dict(n.attrs)}
                    for n in self._ops],
            "lossVariables": list(self._loss_vars),
        }

    def _apply_graph_payload(self, g: Dict) -> None:
        """Reconstruct variables, ops and loss markers from a payload."""
        missing = sorted({o["op"] for o in g["ops"]} - set(OP_IMPLS))
        if missing:
            raise NotImplementedError(
                f"the graph uses ops the port lacks: {missing}; {_A12B}")
        for v in g["variables"]:
            self._register(v["name"], v["type"], v.get("shape"),
                           v.get("dtype") or None)
        for o in g["ops"]:
            node = _OpNode(o["op"], o["name"], o["inputs"], o["outputs"],
                           o["attrs"])
            self._ops.append(node)
            for i, out in enumerate(node.outputs):
                self._producer[out] = (node, i)
        self._loss_vars = g.get("lossVariables", [])

    # ---------------- shape / array ops (reference: SDBaseOps on the
    # SameDiff class itself — sd.concat/gather/tile/...) ----------------
    def concat(self, dimension: int, *vars, name=None):
        return self._op("concat", list(vars), {"dimension": dimension},
                        name=name)

    def stack(self, axis: int, *vars, name=None):
        return self._op("stack", list(vars), {"axis": axis}, name=name)

    def unstack(self, var, axis: int, num: int, name=None):
        return self._op("unstack", [var], {"axis": axis, "num": num},
                        n_out=num, name=name)

    def gather(self, x, indices, axis=0, name=None):
        ix = indices if isinstance(indices, SDVariable) \
            else self.constant(np.asarray(indices))
        return self._op("gather", [x, ix], {"axis": axis}, name=name)

    def tile(self, x, reps, name=None):
        return self._op("tile", [x], {"reps": tuple(reps)}, name=name)

    def reverse(self, x, *dims, name=None):
        return self._op("reverse", [x], {"dims": dims or (0,)}, name=name)

    def slice(self, x, begin, size, name=None):
        return self._op("slice", [x], {"begin": tuple(begin),
                                       "size": tuple(size)}, name=name)

    def stridedSlice(self, x, begin, end, strides=None, name=None):
        return self._op("stridedSlice", [x],
                        {"begin": tuple(begin), "end": tuple(end),
                         "strides": tuple(strides) if strides else None},
                        name=name)

    def oneHot(self, indices, depth, on=1.0, off=0.0, axis=-1, name=None):
        return self._op("oneHot", [indices],
                        {"depth": depth, "on": on, "off": off, "axis": axis},
                        name=name)

    def where(self, cond, x, y, name=None):
        return self._op("where", [cond, x, y], name=name)

    def zerosLike(self, x, name=None):
        return self._op("zerosLike", [x], name=name)

    def onesLike(self, x, name=None):
        return self._op("onesLike", [x], name=name)

    def invokeGraphOn(self, other: "SameDiff"):
        raise NotImplementedError(f"invokeGraphOn: {_A12B}")

    # ---------------- staging: graph -> pure function ----------------
    def _needed_nodes(self, out_names: Sequence[str]) -> List[_OpNode]:
        """Reverse-reachability prune + topological order."""
        needed: List[_OpNode] = []
        seen = set()

        def visit(name):
            if name in seen:
                return
            seen.add(name)
            prod = self._producer.get(name)
            if prod is None:
                return
            node, _ = prod
            for i in node.inputs:
                visit(i)
            if node not in needed:
                needed.append(node)

        for n in out_names:
            visit(n)
        return needed

    def _build_fn(self, out_names: Tuple[str, ...], training: bool = False,
                  compute_dtype=None):
        """Stage the graph into a pure fn(placeholders, variables, it) ->
        outs.  ``it`` is the iteration: train-time RNG ops (dropout) seed
        their mask with it; at inference they are identity (ND4J
        DropOutInverted's train/test semantics)."""
        nodes = self._needed_nodes(out_names)
        compiled = [(node, None if node.op in RNG_TRAIN_OPS and not training
                     else OP_IMPLS[node.op](**node.attrs)) for node in nodes]
        consts = {n: a for n, a in self._arrays.items()
                  if self._vars[n].variableType == VariableType.CONSTANT}
        if compute_dtype is not None:
            # graph constants follow the compute dtype, as the reference's
            consts = {n: (a.to(compute_dtype) if a.dtype == torch.float32
                          else a) for n, a in consts.items()}
        device = self.device

        def fn(placeholders: Dict[str, torch.Tensor],
               variables: Dict[str, torch.Tensor], it=0):
            env = dict(consts)
            env.update(placeholders)
            env.update(variables)
            for node, impl in compiled:
                if impl is None:
                    env[node.outputs[0]] = env[node.inputs[0]]
                    continue
                args = [env[i] for i in node.inputs]
                if node.op in RNG_TRAIN_OPS:
                    res = impl(*args, it)
                else:
                    res = impl(*args)
                if not node.inputs:     # factories build on the CPU
                    res = res.to(device)
                if isinstance(res, (tuple, list)):
                    for nm, r in zip(node.outputs, res):
                        env[nm] = r
                else:
                    env[node.outputs[0]] = res
            return {n: env[n] for n in out_names}
        return fn

    def _var_values(self) -> Dict[str, torch.Tensor]:
        return {n: a for n, a in self._arrays.items()
                if self._vars[n].variableType == VariableType.VARIABLE}

    def _cached_fn(self, key, build):
        if key not in self._fn_cache:
            self._fn_cache[key] = build()
        return self._fn_cache[key]

    # ---------------- execution ----------------
    def output(self, placeholders: Dict[str, Any],
               *outputs) -> Dict[str, torch.Tensor]:
        """Inference: the named outputs (the loss variables when none is
        named) for the fed placeholders, as tensors on the graph's
        device."""
        out_names = tuple(o.name() if isinstance(o, SDVariable) else o
                          for o in outputs) or tuple(self._loss_vars)
        ph = {k: _tensor(v).to(self.device)
              for k, v in (placeholders or {}).items()}
        fn = self._cached_fn(("output", out_names),
                             lambda: self._build_fn(out_names))
        with torch.no_grad():
            return fn(ph, self._var_values())

    # aliases matching the reference API surface
    exec = output
    batchOutput = output

    def outputSingle(self, placeholders, output) -> torch.Tensor:
        name = output.name() if isinstance(output, SDVariable) else output
        return self.output(placeholders, name)[name]

    def calculateGradients(self, placeholders: Dict[str, Any],
                           *wrt) -> Dict[str, torch.Tensor]:
        """d(sum of loss variables)/d(wrt), all variables when none is
        named; ``torch.autograd.grad`` with the floating-point variables as
        leaves (a variable the loss does not reach gets zeros)."""
        if not self._loss_vars:
            raise ValueError("No loss variables set (markAsLoss / "
                             "setLossVariables)")
        wrt_names = [w.name() if isinstance(w, SDVariable) else w for w in wrt]
        if not wrt_names:
            wrt_names = [n for n, v in self._vars.items()
                         if v.variableType == VariableType.VARIABLE]
        ph = {k: _tensor(v).to(self.device) for k, v in placeholders.items()}
        loss_names = tuple(self._loss_vars)
        fn = self._cached_fn(("grad", loss_names), lambda: self._build_fn(
            loss_names, training=True))
        variables, leaves = self._leaves(self._var_values())
        outs = fn(ph, variables)
        loss = sum(torch.sum(v) for v in outs.values())
        grads = self._grads(loss, leaves)
        self._last_grads = grads
        return {n: grads[n] for n in wrt_names if n in grads}

    grad = calculateGradients

    @staticmethod
    def _leaves(variables):
        """(variables with each floating-point one a fresh autograd leaf,
        those leaves by name)."""
        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in variables.items() if v.is_floating_point()}
        return {**variables, **leaves}, leaves

    @staticmethod
    def _grads(loss, leaves) -> Dict[str, torch.Tensor]:
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        return {n: torch.zeros_like(v) if g is None else g
                for (n, v), g in zip(leaves.items(), gs)}

    # ---------------- training ----------------
    def setTrainingConfig(self, cfg: TrainingConfig):
        old = self._training_config
        if old is not None and type(cfg.updater) is not type(old.updater):
            self._opt_state = None  # updater changed: old state is meaningless
        self._training_config = cfg
        self._train_step = None

    def stepCostAnalysis(self, ds) -> Dict[str, float]:
        raise NotImplementedError(
            f"stepCostAnalysis is XLA's cost analysis; {_A12B}")

    def _make_train_step(self):
        cfg = self._training_config
        updater = cfg.updater
        minimize = cfg.minimize
        cdt = torch.bfloat16 if str(cfg.dataType).upper() in _HALF_TYPES \
            else torch.float32
        fn = self._build_fn(tuple(self._loss_vars), training=True,
                            compute_dtype=None if cdt == torch.float32
                            else cdt)

        def cast_compute(tree):
            if cdt == torch.float32:
                return tree
            return {k: (v.to(cdt) if v.dtype == torch.float32 else v)
                    for k, v in tree.items()}

        def loss_fn(variables, leaves, ph, it):
            outs = fn(cast_compute(ph), cast_compute(variables), it)
            # loss reductions in f32 under bf16 compute
            loss = sum(torch.sum(v.float() if v.dtype == cdt else v)
                       for v in outs.values())
            if cfg.l2:
                # 0.5*l2*sum(w^2) on the f32 masters — DL4J's convention
                loss = loss + 0.5 * cfg.l2 * sum(
                    torch.sum(v * v) for v in leaves.values())
            if cfg.l1:
                loss = loss + cfg.l1 * sum(
                    torch.sum(_abs(v)) for v in leaves.values())
            return loss

        def step(variables, opt_state, ph, it: int):
            """One step of forward, backward and updater; returns the new
            variables, the new updater state and the loss (on the
            device)."""
            variables_l, leaves = self._leaves(variables)
            loss = loss_fn(variables_l, leaves, ph, it)
            grads = self._grads(loss, leaves)
            lr = updater.currentLr(it, 0)
            new_vars, new_state = dict(variables), dict(opt_state)
            with torch.no_grad():
                for n, g in grads.items():
                    upd, st = updater.apply(g if minimize else -g,
                                            opt_state[n], lr, it,
                                            param=variables[n])
                    new_vars[n] = variables[n] - upd
                    new_state[n] = st
            return new_vars, new_state, loss.detach()

        self._train_step = step

    def fit(self, data=None, epochs: int = 1) -> History:
        """Train (reference: SameDiff.fit / TrainingSession).

        ``data`` is a DataSet, a MultiDataSet or an iterable of them;
        features and labels bind to placeholders through the
        TrainingConfig's mappings.  The losses stay on the device and are
        fetched once at the end, unless listeners are attached (their
        contract is a Python float per iteration)."""
        if self._training_config is None:
            raise ValueError("setTrainingConfig first")
        cfg = self._training_config
        if self._train_step is None:
            self._make_train_step()
        variables = self._var_values()
        if self._opt_state is None:
            self._opt_state = {}
        for n, v in variables.items():
            if n not in self._opt_state and v.is_floating_point():
                # extends the state for variables added after a fit
                self._opt_state[n] = cfg.updater.init(v)
        losses, curve = [], []
        for ep in range(int(epochs)):
            notifyListeners(self._listeners, "epochStart", self,
                            At(epoch=ep, iteration=self.iterationCount))
            if isinstance(data, (DataSet, MultiDataSet)):
                batches = [data]
            else:
                if hasattr(data, "reset"):
                    data.reset()
                batches = data
            for ds in batches:
                at = At(epoch=ep, iteration=self.iterationCount)
                notifyListeners(self._listeners, "iterationStart", self,
                                at, ds)
                variables, self._opt_state, loss = self._train_step(
                    variables, self._opt_state, self._bind(ds, cfg),
                    self.iterationCount)
                self.iterationCount += 1
                losses.append(loss)
                if self._listeners:
                    notifyListeners(
                        self._listeners, "iterationDone", self, at, ds,
                        Loss(["loss"], [float(losses[-1])]))
            if self._listeners:
                curve = _fetch_curve(losses)
                notifyListeners(self._listeners, "epochEnd", self,
                                At(epoch=ep, iteration=self.iterationCount),
                                loss_curve=curve)
        self._arrays.update(variables)
        if self._listeners and len(curve) == len(losses):
            return History(curve)
        return History(_fetch_curve(losses))

    def _bind(self, ds, cfg) -> Dict[str, torch.Tensor]:
        if isinstance(ds, MultiDataSet):
            feats, labs = ds.features, ds.labels
        else:
            feats, labs = [ds.features], [ds.labels]
        ph = {}
        for n, a in zip(cfg.dataSetFeatureMapping, feats):
            ph[n] = _tensor(a).to(self.device)
        for n, a in zip(cfg.dataSetLabelMapping, labs):
            ph[n] = _tensor(a).to(self.device)
        return ph

    def evaluate(self, iterator, outputVariable, evaluation=None):
        """Reference: SameDiff.evaluate(DataSetIterator, outputVariable,
        IEvaluation) — features bind through the TrainingConfig's feature
        mapping, labels come from each DataSet, predictions from
        ``outputVariable`` (one device-to-host copy per batch)."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        if self._training_config is None:
            raise ValueError("setTrainingConfig first (feature mappings)")
        cfg = self._training_config
        ev = evaluation or Evaluation()
        name = outputVariable.name() if isinstance(outputVariable,
                                                   SDVariable) \
            else outputVariable
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            ph = self._bind(ds, cfg)
            out = self.outputSingle(
                {k: v for k, v in ph.items()
                 if k in cfg.dataSetFeatureMapping}, name)
            labels = ds.labels[0] if isinstance(ds.labels, list) \
                else ds.labels
            lmask = getattr(ds, "labelsMasks", None)   # MultiDataSet plural
            if isinstance(lmask, list):
                lmask = lmask[0] if lmask else None
            if lmask is None:
                lmask = getattr(ds, "labelsMask", None)
            ev.eval(labels, out.cpu(), lmask)
        return ev

    # ---------------- listeners (reference: BaseListener SPI) ----------
    def setListeners(self, *listeners) -> None:
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        self._listeners = list(listeners)

    def addListeners(self, *listeners) -> None:
        self._listeners.extend(listeners)

    def execDebug(self, placeholders: Dict[str, Any], *outputs):
        raise NotImplementedError(f"execDebug: {_A12B}")

    # ---------------- serde ----------------
    def save(self, path: str, saveUpdaterState: bool = False):
        """The reference's zip: ``graph.json``, ``arrays.npz`` and, with
        ``saveUpdaterState``, ``updater.npz`` (keys ``<variable>/<state>``),
        so a graph saved by either package loads in the other."""
        buf = io.BytesIO()
        np.savez(buf, **{n: _np(a) for n, a in self._arrays.items()})
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("graph.json", json.dumps(self._graph_payload(),
                                                default=str))
            z.writestr("arrays.npz", buf.getvalue())
            if saveUpdaterState and self._opt_state is not None:
                sbuf = io.BytesIO()
                np.savez(sbuf, **{f"{n}/{k}": _np(a)
                                  for n, st in self._opt_state.items()
                                  for k, a in st.items()
                                  if isinstance(a, torch.Tensor)})
                z.writestr("updater.npz", sbuf.getvalue())

    @staticmethod
    def load(path: str, loadUpdaterState: bool = False,
             device=None) -> "SameDiff":
        """Read a zip written by ``save`` (of either package) onto
        ``device``.  A graph whose ops the port lacks raises, naming
        them."""
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as z:
            sd._apply_graph_payload(json.loads(z.read("graph.json")))
            arrays = np.load(io.BytesIO(z.read("arrays.npz")))
            for n in arrays.files:
                sd._arrays[n] = torch.from_numpy(arrays[n]).to(sd.device)
            if loadUpdaterState and "updater.npz" in z.namelist():
                st = np.load(io.BytesIO(z.read("updater.npz")))
                opt: Dict[str, Dict] = {}
                for key in st.files:
                    n, k = key.rsplit("/", 1)
                    opt.setdefault(n, {})[k] = torch.from_numpy(
                        st[key]).to(sd.device)
                sd._opt_state = opt
        return sd

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} variables, "
                 f"{len(self._ops)} ops"]
        for v in self._vars.values():
            if v.variableType != VariableType.ARRAY:
                lines.append(f"  {v.variableType:<12} {v.name():<24} "
                             f"{v.shape}")
        for n in self._ops:
            lines.append(f"  OP {n.op:<24} {n.inputs} -> {n.outputs}")
        return "\n".join(lines)


# The ops of the reference's ops_ext families that the TF and ONNX importers
# emit register themselves into OP_IMPLS on import (the rest is ROADMAP
# A12b).
from deeplearning4j_tpu_torch.autodiff import ops_ext  # noqa: E402,F401  isort:skip
from deeplearning4j_tpu_torch.autodiff import ops_ext2  # noqa: E402,F401  isort:skip
from deeplearning4j_tpu_torch.autodiff import ops_ext3  # noqa: E402,F401  isort:skip
from deeplearning4j_tpu_torch.autodiff import ops_ext4  # noqa: E402,F401  isort:skip
from deeplearning4j_tpu_torch.autodiff import ops_ext5  # noqa: E402,F401  isort:skip
