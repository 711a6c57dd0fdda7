"""Extended SameDiff ops, part 1: the port of the ops of
``deeplearning4j_tpu/autodiff/ops_ext.py`` that the TF and ONNX
importers' rules emit (math, segment, scatter/gather, shape surgery, top-k,
linalg, image; ``hardSwish``, ``logSumExp``, ``prelu``,
``thresholdRelu``, ``standardize``, ``takeAlongAxis``, ``putAlongAxis``
and ``split`` for ONNX).

Only those ops come over; the rest of the file (its other ops and the
``sd.image()`` / ``sd.rnn()`` / ``sd.linalg()`` namespaces) waits for
ROADMAP A12b.  Each op keeps the reference's name, attrs and semantics, so
``graph.json`` stays the serde boundary between the packages.  Imported for
its registrations at the bottom of ``samediff.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, _axis_op,
                                                        _simple, register_op)
from deeplearning4j_tpu_torch.nn.conf.layers import _pad2d, _same_pads

# ---------------------------------------------------------------------------
# math (reference: generic/transforms, parity_ops)
# ---------------------------------------------------------------------------
_simple("expm1", torch.expm1)
# jnp.rint rounds half to even, as torch.round does
_simple("rint", torch.round)
_simple("lgamma", torch.lgamma)
_simple("digamma", torch.digamma)
_simple("igamma", torch.special.gammainc)
_simple("igammac", torch.special.gammaincc)
_simple("invertPermutation",
        lambda p: torch.argsort(p.to(torch.int32), stable=True).to(
            torch.int32))


# ---------------------------------------------------------------------------
# segment ops (reference: generic/parity_ops/segment_*.cpp; an id outside
# [0, numSegments) is dropped, an empty segment holds the reduction's
# identity, as jax.ops.segment_* give)
# ---------------------------------------------------------------------------
def _identity(dtype, how):
    if how == "sum":
        return 0
    if how == "prod":
        return 1
    if dtype.is_floating_point:
        return float("-inf") if how == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if how == "amax" else info.max


def _seg_reduce(d, ids, n, how):
    ids = ids.long()
    keep = (ids >= 0) & (ids < n)
    if not bool(keep.all()):
        d, ids = d[keep], ids[keep]
    out = torch.full((n,) + tuple(d.shape[1:]), _identity(d.dtype, how),
                     dtype=d.dtype, device=d.device)
    if how == "sum":
        return out.index_add(0, ids, d)
    return out.index_reduce(0, ids, d, how, include_self=True)


def _seg_count(d, ids, n):
    ones = torch.ones(d.shape[:1], dtype=d.dtype, device=d.device)
    cnt = _seg_reduce(ones, ids, n, "sum").clamp(min=1)
    return cnt.reshape((n,) + (1,) * (d.dim() - 1))


def _segment(name, seg_fn):
    def factory(numSegments=None, **_):
        if numSegments is None:
            raise ValueError(f"{name}: numSegments attr is required "
                             "(static output shape)")
        n = int(numSegments)
        return lambda data, ids: seg_fn(data, ids, n)
    OP_IMPLS[name] = factory


_segment("segmentSum", lambda d, i, n: _seg_reduce(d, i, n, "sum"))
_segment("segmentMean", lambda d, i, n: _seg_reduce(d, i, n, "sum")
         / _seg_count(d, i, n))
_segment("segmentMax", lambda d, i, n: _seg_reduce(d, i, n, "amax"))
_segment("segmentMin", lambda d, i, n: _seg_reduce(d, i, n, "amin"))
_segment("segmentProd", lambda d, i, n: _seg_reduce(d, i, n, "prod"))
# the unsorted forms share the lowering: nothing needs sorted ids
for _u, _s in [("unsortedSegmentSum", "segmentSum"),
               ("unsortedSegmentMax", "segmentMax"),
               ("unsortedSegmentMin", "segmentMin"),
               ("unsortedSegmentProd", "segmentProd")]:
    OP_IMPLS[_u] = OP_IMPLS[_s]


# ---------------------------------------------------------------------------
# N-d scatter / gather: the index's last axis addresses the leading dims
# ---------------------------------------------------------------------------
def _nd_index(idx):
    return tuple(idx.long().movedim(-1, 0))


@register_op("scatterNd")
def _scatter_nd(shape=None, **_):
    def f(idx, upd):
        out = torch.zeros(tuple(int(s) for s in shape), dtype=upd.dtype,
                          device=upd.device)
        return out.index_put(_nd_index(idx), upd, accumulate=True)
    return f


@register_op("scatterNdAdd")
def _scatter_nd_add(**_):
    return lambda ref, idx, upd: ref.index_put(_nd_index(idx), upd,
                                               accumulate=True)


@register_op("scatterNdSub")
def _scatter_nd_sub(**_):
    return lambda ref, idx, upd: ref.index_put(_nd_index(idx), -upd,
                                               accumulate=True)


@register_op("scatterNdUpdate")
def _scatter_nd_update(**_):
    return lambda ref, idx, upd: ref.index_put(_nd_index(idx), upd)


@register_op("gatherNd")
def _gather_nd(**_):
    return lambda x, idx: x[_nd_index(idx)]


# ---------------------------------------------------------------------------
# shape surgery (reference: generic/shape, generic/parity_ops)
# ---------------------------------------------------------------------------
@register_op("reverseSequence")
def _reverse_sequence(seqAxis=1, batchAxis=0, **_):
    def f(x, lengths):
        t = x.shape[seqAxis]
        idx = torch.arange(t, device=x.device)
        lens = lengths.long().reshape(-1, 1)
        # per row: positions < len are mirrored, the rest stay
        gi = torch.where(idx < lens, lens - 1 - idx, idx)     # (b, t)
        xm = torch.movedim(x, (batchAxis, seqAxis), (0, 1))
        gi = gi.reshape(gi.shape + (1,) * (xm.dim() - 2)).expand(xm.shape)
        out = torch.gather(xm, 1, gi)
        return torch.movedim(out, (0, 1), (batchAxis, seqAxis))
    return f


@register_op("spaceToDepth")
def _space_to_depth(blockSize=2, dataFormat="NCHW", **_):
    bs = int(blockSize)

    def f(x):
        if dataFormat == "NHWC":
            b, h, w, c = x.shape
            x = x.reshape(b, h // bs, bs, w // bs, bs, c)
            return x.permute(0, 1, 3, 2, 4, 5).reshape(
                b, h // bs, w // bs, c * bs * bs)
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // bs, bs, w // bs, bs)
        return x.permute(0, 3, 5, 1, 2, 4).reshape(
            b, c * bs * bs, h // bs, w // bs)
    return f


@register_op("depthToSpace")
def _depth_to_space(blockSize=2, dataFormat="NCHW", **_):
    bs = int(blockSize)

    def f(x):
        if dataFormat == "NHWC":
            b, h, w, c = x.shape
            x = x.reshape(b, h, w, bs, bs, c // (bs * bs))
            return x.permute(0, 1, 3, 2, 4, 5).reshape(
                b, h * bs, w * bs, c // (bs * bs))
        b, c, h, w = x.shape
        x = x.reshape(b, bs, bs, c // (bs * bs), h, w)
        return x.permute(0, 3, 4, 1, 5, 2).reshape(
            b, c // (bs * bs), h * bs, w * bs)
    return f


@register_op("bincount")
def _bincount(maxLength=None, **_):
    """``maxLength`` is the exact output length; as ``jnp.bincount(...,
    length=n)``, a value outside [0, n) counts nowhere."""
    def f(x):
        n = int(maxLength) if maxLength is not None else 0
        if n <= 0:
            raise ValueError("bincount: static maxLength attr required")
        v = x.reshape(-1).long()
        v = v[(v >= 0) & (v < n)]
        return torch.bincount(v, minlength=n).to(torch.int32)
    return f


def _top_k(x, k):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


@register_op("topK")
def _topk(k=1, sorted=True, **_):
    # sorted=False only relaxes the output order; the sorted output is a
    # valid "arbitrary order"
    return lambda x: list(_top_k(x, int(k)))


@register_op("inTopK")
def _in_topk(k=1, **_):
    def f(pred, targets):
        _, idx = _top_k(pred, int(k))
        return (idx == targets.to(torch.int32)[:, None]).any(dim=-1)
    return f


# ---------------------------------------------------------------------------
# linalg (reference: generic/blas + parity_ops matrix ops)
# ---------------------------------------------------------------------------
_simple("matrixInverse", torch.linalg.inv)
_simple("matrixDeterminant", torch.linalg.det)
_simple("cholesky", torch.linalg.cholesky)
_simple("solve", torch.linalg.solve)
_simple("matrixDiagPart", lambda x: torch.diagonal(x, dim1=-2, dim2=-1))


@register_op("triangularSolve")
def _triangular_solve(lower=True, adjoint=False, **_):
    def f(a, b):
        if adjoint:     # solve aᵀ x = b: aᵀ is upper when a is lower
            return torch.linalg.solve_triangular(a.mT, b, upper=bool(lower))
        return torch.linalg.solve_triangular(a, b, upper=not lower)
    return f


@register_op("matrixBandPart")
def _band_part(numLower=-1, numUpper=-1, **_):
    def f(x):
        m, n = x.shape[-2], x.shape[-1]
        i = torch.arange(m, device=x.device)[:, None]
        j = torch.arange(n, device=x.device)[None, :]
        keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
        if int(numLower) >= 0:
            keep &= (i - j) <= int(numLower)
        if int(numUpper) >= 0:
            keep &= (j - i) <= int(numUpper)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
    return f


@register_op("matrixSetDiag")
def _set_diag(**_):
    return lambda x, d: torch.diagonal_scatter(x, d.to(x.dtype), dim1=-2,
                                               dim2=-1)


# ---------------------------------------------------------------------------
# image ops (reference: generic/images/*.cpp).  The half-pixel forms are
# ``jax.image.resize`` (antialiased when shrinking), the align_corners
# forms the reference's own grid.
# ---------------------------------------------------------------------------
def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    # R. G. Keys, cubic convolution interpolation (a = -0.5)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _lanczos(radius):
    def k(x):
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2,
                                                  1.0), 1.0)
        return np.where(x > radius, 0.0, out)
    return k


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _weight_mat(m: int, n: int, kernel) -> np.ndarray:
    """``jax.image``'s (in m × out n) resampling weights at scale n/m,
    computed in float64 as the reference's x64 mode does."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)          # antialias when shrinking
    sample_f = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float64)[:, None]) \
        / kernel_scale
    w = kernel(x)
    tot = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _jax_resize(x, oh: int, ow: int, method: str):
    """``jax.image.resize(x, (b, oh, ow, c), method)`` for NHWC ``x``."""
    if method == "nearest":
        for d, n in ((1, oh), (2, ow)):
            m = x.shape[d]
            if m == n:
                continue
            off = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long().to(x.device)
            x = torch.index_select(x, d, off)
        return x
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d, n in ((1, oh), (2, ow)):
        m = x.shape[d]
        if m == n:
            continue
        w = torch.from_numpy(_weight_mat(m, n, _KERNELS[method])).to(
            dtype=x.dtype, device=x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w, 1),
                          -1, d)
    return x


def _resize_align_corners(x, oh, ow, method):
    """align_corners sampling grid: out pixel i ↦ in coord i*(in-1)/(out-1)
    (the reference's own, as its resize_bilinear / resize_nearest honour
    align_corners)."""
    b, h, w, c = x.shape
    ys = torch.linspace(0.0, h - 1.0, oh, dtype=torch.float64)
    xs = torch.linspace(0.0, w - 1.0, ow, dtype=torch.float64)
    if method == "nearest":
        # TF/libnd4j round half away from zero (roundf), not half to even
        yi = torch.floor(ys + 0.5).long().to(x.device)
        xi = torch.floor(xs + 0.5).long().to(x.device)
        return x[:, yi][:, :, xi]
    # interpolate in float (TF ResizeBilinear outputs float32 even for
    # integer images)
    xf = x if x.is_floating_point() else x.to(torch.float32)
    y0 = torch.floor(ys).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wy = (ys - y0).to(xf.dtype).to(x.device)[None, :, None, None]
    x0 = torch.floor(xs).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wx = (xs - x0).to(xf.dtype).to(x.device)[None, None, :, None]
    y0, y1, x0, x1 = (t.to(x.device) for t in (y0, y1, x0, x1))
    top = xf[:, y0][:, :, x0] * (1 - wx) + xf[:, y0][:, :, x1] * wx
    bot = xf[:, y1][:, :, x0] * (1 - wx) + xf[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize(name, method):
    def factory(height=None, width=None, alignCorners=False, **_):
        if alignCorners and method == "cubic":
            raise ValueError(f"{name}: alignCorners=True is unsupported "
                             "for bicubic (would silently change numerics)")

        def f(x):  # NHWC
            if alignCorners:
                return _resize_align_corners(x, int(height), int(width),
                                             method)
            return _jax_resize(x, int(height), int(width), method)
        return f
    OP_IMPLS[name] = factory


_resize("resizeBilinear", "linear")
_resize("resizeNearestNeighbor", "nearest")
_resize("resizeBicubic", "cubic")


@register_op("cropAndResize")
def _crop_and_resize(cropHeight=None, cropWidth=None, method="bilinear",
                     **_):
    ch, cw = int(cropHeight), int(cropWidth)
    nearest = method != "bilinear"

    def f(img, boxes, boxIdx):
        # img NHWC; boxes (n, 4) normalized y1, x1, y2, x2; boxIdx (n,)
        _, h, w, c = img.shape
        src = img[boxIdx.long()]                          # (n, h, w, c)
        y1, x1, y2, x2 = boxes.unbind(-1)
        ar_h = torch.arange(ch, dtype=boxes.dtype, device=boxes.device)
        ar_w = torch.arange(cw, dtype=boxes.dtype, device=boxes.device)
        ys = y1[:, None] * (h - 1) + ar_h * (y2 - y1)[:, None] * (h - 1) \
            / max(ch - 1, 1)
        xs = x1[:, None] * (w - 1) + ar_w * (x2 - x1)[:, None] * (w - 1) \
            / max(cw - 1, 1)
        nb = torch.arange(src.shape[0], device=img.device)[:, None, None]

        def at(yi, xi):                                   # (n, ch, cw, c)
            return src[nb, yi[:, :, None], xi[:, None, :]]
        if nearest:
            yi = torch.clamp(torch.round(ys).long(), 0, h - 1)
            xi = torch.clamp(torch.round(xs).long(), 0, w - 1)
            return at(yi, xi)
        y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
        y1i = torch.clamp(y0 + 1, 0, h - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
        x1i = torch.clamp(x0 + 1, 0, w - 1)
        wy = (ys - y0)[:, :, None, None]
        wx = (xs - x0)[:, None, :, None]
        return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy)
                * wx + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return f


_GRAY = (0.2989, 0.5870, 0.1140)


def _gray(x):
    return torch.sum(x * torch.tensor(_GRAY, dtype=x.dtype,
                                      device=x.device), dim=-1, keepdim=True)


@register_op("adjustContrast")
def _adjust_contrast(factor=1.0, **_):
    def f(x):
        mu = torch.mean(x, dim=(-3, -2), keepdim=True)
        return (x - mu) * factor + mu
    return f


@register_op("adjustSaturation")
def _adjust_saturation(factor=1.0, **_):
    def f(x):
        gray = _gray(x)
        return torch.clamp(gray + (x - gray) * factor, 0.0, 1.0)
    return f


@register_op("extractImagePatches")
def _extract_patches(kH=3, kW=3, sH=1, sW=1, isSameMode=False, **_):
    kh, kw, sh, sw = int(kH), int(kW), int(sH), int(sW)

    def f(x):  # NHWC -> (b, oh, ow, kh*kw*c), patch position major
        b, h, w, c = x.shape
        xn = x.permute(0, 3, 1, 2)
        if isSameMode:
            xn = _pad2d(xn, (_same_pads(h, kh, sh), _same_pads(w, kw, sw)))
        oh = (xn.shape[2] - kh) // sh + 1
        ow = (xn.shape[3] - kw) // sw + 1
        p = F.unfold(xn, (kh, kw), stride=(sh, sw))    # (b, c*kh*kw, L)
        p = p.reshape(b, c, kh * kw, oh, ow)
        return p.permute(0, 3, 4, 2, 1).reshape(b, oh, ow, kh * kw * c)
    return f


# ---------------------------------------------------------------------------
# the ops the ONNX importer's rules emit (HardSwish, ReduceLogSumExp, PRelu,
# ThresholdedRelu, MeanVarianceNormalization, GatherElements,
# ScatterElements, Split)
# ---------------------------------------------------------------------------
_simple("hardSwish", lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
_axis_op("logSumExp", torch.logsumexp)


@register_op("prelu")
def _prelu(**_):
    return lambda x, alpha: torch.where(x >= 0, x, alpha * x)


@register_op("thresholdRelu")
def _threshold_relu(cutoff=0.0, **_):
    return lambda x: torch.where(x > cutoff, x, 0.0)


@register_op("standardize")
def _standardize(dims=None, **_):
    ax = tuple(dims) if dims is not None else (-1,)

    def f(x):
        mu = torch.mean(x, dim=ax, keepdim=True)
        sd = torch.std(x, dim=ax, correction=0, keepdim=True)
        return (x - mu) / torch.clamp(sd, min=1e-12)
    return f


@register_op("takeAlongAxis")
def _take_along_axis(axis=-1, **_):
    def f(x, i):
        # numpy's rules: a negative index wraps, and x and the indices
        # broadcast against each other in every dim but ``axis``
        ax = int(axis) % x.dim()
        i = i.to(torch.int64)
        i = torch.where(i < 0, i + x.shape[ax], i)
        rest = torch.broadcast_shapes(
            tuple(1 if d == ax else n for d, n in enumerate(x.shape)),
            tuple(1 if d == ax else n for d, n in enumerate(i.shape)))
        xs, ix = list(rest), list(rest)
        xs[ax], ix[ax] = x.shape[ax], i.shape[ax]
        return torch.gather(x.expand(xs), ax, i.expand(ix))
    return f


@register_op("putAlongAxis")
def _put_along_axis(axis=-1, reduction="none", **_):
    """Element-wise scatter (np.put_along_axis / ONNX ScatterElements):
    out[..., idx[i,j], ...] = upd[i,j] along ``axis``, any rank."""
    def f(x, idx, upd):
        ax = int(axis) % x.dim()
        idx = idx.to(torch.int64)
        idx = torch.where(idx < 0, idx + x.shape[ax], idx)
        upd = upd.to(x.dtype).expand(idx.shape)
        if reduction == "add":
            return x.scatter_add(ax, idx, upd)
        if reduction == "mul":
            return x.scatter_reduce(ax, idx, upd, "prod")
        return x.scatter(ax, idx, upd)
    return f


@register_op("split")
def _split(numSplit=2, dimension=0, **_):
    def f(x):
        d, n = int(dimension), int(numSplit)
        if x.shape[d] % n:
            raise ValueError(f"split: {x.shape[d]} does not divide into "
                             f"{n} equal parts")
        return list(torch.split(x, x.shape[d] // n, dim=d))
    return f
