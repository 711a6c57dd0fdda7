"""Extended SameDiff ops, part 1: the port of
``deeplearning4j_tpu/autodiff/ops_ext.py`` (the reference's libnd4j
``generic/**`` breadth beyond the core set): math, summary statistics, the
reduce3 distances, segment, scatter and gather, shape surgery, top-k and
sorting, linalg, image, the recurrent cells and sequences, and the
``sd.image()`` / ``sd.rnn()`` / ``sd.linalg()`` namespaces.

Each op keeps the reference's name, attrs and semantics, so
``graph.json`` stays the serde boundary between the packages.  The
sequence forms (``gru``, ``lstmLayer``, ``simpleRnnLayer``), a
``lax.scan`` in the reference, are a Python loop over the time-major
input under autograd.  Imported for its registrations at the bottom of
``samediff.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, SDMath,
                                                        SDNN, _abs, _axes,
                                                        _axis_op,
                                                        _Namespace,
                                                        _ns_binary,
                                                        _ns_unary, _simple,
                                                        register_op)
from deeplearning4j_tpu_torch.nn.conf.layers import _pad2d, _same_pads

_CORE_OPS = set(OP_IMPLS)   # what samediff.py itself registered

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
_simple("log2", torch.log2)
_simple("log10", torch.log10)
_simple("cbrt", lambda x: torch.sign(x) * torch.pow(_abs(x), 1.0 / 3.0))
_simple("cube", lambda x: x * x * x)
_simple("oneMinus", lambda x: 1.0 - x)
_simple("timesOneMinus", lambda x: x * (1.0 - x))
_simple("step", lambda x: (x > 0).to(x.dtype))
_simple("trunc", torch.trunc)
_simple("frac", lambda x: x - torch.trunc(x))
_simple("rationalTanh", lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0))
_simple("rectifiedTanh", lambda x: torch.clamp(torch.tanh(x), min=0.0))
_simple("logAddExp", torch.logaddexp)
_simple("heavyside", lambda x: torch.where(
    x > 0, 1.0, torch.where(x < 0, 0.0, 0.5)).to(
        x.dtype if x.is_floating_point() else torch.get_default_dtype()))


@register_op("clipByNorm")
def _clip_by_norm(clipValue=1.0, dims=None, **_):
    ax = tuple(dims) if dims else None

    def f(x):
        n = torch.sqrt(torch.sum(x * x, dim=ax, keepdim=ax is not None))
        return x * torch.clamp(clipValue / torch.clamp(n, min=1e-12),
                               max=1.0)
    return f


# ---------------------------------------------------------------------------
# summary statistics (reference: loops/summarystats + parity entropy ops);
# each reduces over ``dims`` (all axes when None) at once
# ---------------------------------------------------------------------------
def _stat_op(name, fn):
    def factory(dims=None, keepDims=False, **_):
        return lambda x: fn(x, _axes(x, dims), bool(keepDims))
    OP_IMPLS[name] = factory


def _entropy(x, ax, k):
    return -torch.sum(x * torch.log(torch.clamp(x, min=1e-30)), dim=ax,
                      keepdim=k)


_stat_op("amean", lambda x, ax, k: torch.mean(_abs(x), dim=ax, keepdim=k))
_stat_op("amax", lambda x, ax, k: torch.amax(_abs(x), dim=ax, keepdim=k))
_stat_op("amin", lambda x, ax, k: torch.amin(_abs(x), dim=ax, keepdim=k))
_stat_op("asum", lambda x, ax, k: torch.sum(_abs(x), dim=ax, keepdim=k))
_stat_op("entropy", _entropy)
_stat_op("logEntropy", lambda x, ax, k: torch.log(torch.clamp(
    _entropy(x, ax, k), min=1e-30)))
_stat_op("shannonEntropy", lambda x, ax, k: -torch.sum(
    x * torch.log2(torch.clamp(x, min=1e-30)), dim=ax, keepdim=k))
_stat_op("zeroFraction", lambda x, ax, k: torch.mean(
    (x == 0).to(torch.float32), dim=ax, keepdim=k))


def _moment(x, ax, k, power):
    mu = torch.mean(x, dim=ax, keepdim=True)
    sd = torch.std(x, dim=ax, correction=0, keepdim=True)
    z = (x - mu) / torch.clamp(sd, min=1e-12)
    return torch.mean(z ** power, dim=ax, keepdim=k)


_stat_op("skewness", lambda x, ax, k: _moment(x, ax, k, 3))
_stat_op("kurtosis", lambda x, ax, k: _moment(x, ax, k, 4) - 3.0)


# ---------------------------------------------------------------------------
# reduce3 / distance family (reference: loops/reduce3, generic distances)
# ---------------------------------------------------------------------------
def _dist_op(name, fn):
    def factory(dims=None, keepDims=False, **_):
        return lambda x, y: fn(x, y, _axes(torch.broadcast_tensors(x, y)[0],
                                           dims), bool(keepDims))
    OP_IMPLS[name] = factory


def _sum(x, ax, k):
    return torch.sum(x, dim=ax, keepdim=k)


_dist_op("euclideanDistance",
         lambda x, y, ax, k: torch.sqrt(_sum((x - y) ** 2, ax, k)))
_dist_op("manhattanDistance", lambda x, y, ax, k: _sum(_abs(x - y), ax, k))
_dist_op("hammingDistance",
         lambda x, y, ax, k: _sum((x != y).to(torch.float32), ax, k))
_dist_op("cosineSimilarity", lambda x, y, ax, k: _sum(x * y, ax, k)
         / torch.clamp(torch.sqrt(_sum(x * x, ax, k))
                       * torch.sqrt(_sum(y * y, ax, k)), min=1e-12))
_dist_op("jaccardDistance", lambda x, y, ax, k: 1.0 - _sum(
    torch.minimum(x, y), ax, k) / torch.clamp(_sum(torch.maximum(x, y), ax,
                                                   k), min=1e-12))
_dist_op("dot_reduce", lambda x, y, ax, k: _sum(x * y, ax, k))


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
_segment("segmentSqrtN", lambda d, i, n: _seg_reduce(d, i, n, "sum")
         / torch.sqrt(_seg_count(d, i, n)))
# the unsorted forms share the lowering: nothing needs sorted ids
for _u, _s in [("unsortedSegmentSum", "segmentSum"),
               ("unsortedSegmentMean", "segmentMean"),
               ("unsortedSegmentSqrtN", "segmentSqrtN"),
               ("unsortedSegmentMax", "segmentMax"),
               ("unsortedSegmentMin", "segmentMin"),
               ("unsortedSegmentProd", "segmentProd")]:
    OP_IMPLS[_u] = OP_IMPLS[_s]


# ---------------------------------------------------------------------------
# scatter family (reference: generic/parity_ops/scatter_*.cpp): dim-0 slices
# of ``ref`` at ``idx`` combine with ``upd``; a repeated index applies each
# of its updates, as ``.at[idx].op(upd)`` does
# ---------------------------------------------------------------------------
def _scatter(name, how, prep=lambda u: u):
    def factory(**_):
        def f(ref, idx, upd):
            i = idx.long().reshape(-1)
            i = torch.where(i < 0, i + ref.shape[0], i)
            u = prep(upd.to(ref.dtype)).reshape((-1,) + tuple(ref.shape[1:]))
            if how == "sum":
                return ref.index_add(0, i, u)
            return ref.index_reduce(0, i, u, how, include_self=True)
        return f
    OP_IMPLS[name] = factory


_scatter("scatterSub", "sum", torch.neg)
_scatter("scatterMul", "prod")
_scatter("scatterDiv", "prod", torch.reciprocal)   # jax: x * (1/u) per hit
_scatter("scatterMax", "amax")
_scatter("scatterMin", "amin")


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


@register_op("repeat")
def _repeat(repeats=1, axis=0, **_):
    return lambda x: torch.repeat_interleave(x, int(repeats), dim=int(axis))


@register_op("batchToSpace")
def _batch_to_space(blocks=(2, 2), crops=((0, 0), (0, 0)), **_):
    b0, b1 = int(blocks[0]), int(blocks[1])
    (ct0, cb0), (ct1, cb1) = crops

    def f(x):
        n, h, w, c = x.shape
        x = x.reshape(b0, b1, n // (b0 * b1), h, w, c)
        x = x.permute(2, 3, 0, 4, 1, 5).reshape(
            n // (b0 * b1), h * b0, w * b1, c)
        return x[:, ct0:x.shape[1] - cb0, ct1:x.shape[2] - cb1, :]
    return f


@register_op("spaceToBatch")
def _space_to_batch(blocks=(2, 2), pads=((0, 0), (0, 0)), **_):
    b0, b1 = int(blocks[0]), int(blocks[1])
    (p0a, p0b), (p1a, p1b) = pads

    def f(x):
        x = F.pad(x, (0, 0, p1a, p1b, p0a, p0b))
        n, h, w, c = x.shape
        x = x.reshape(n, h // b0, b0, w // b1, b1, c)
        return x.permute(2, 4, 0, 1, 3, 5).reshape(
            n * b0 * b1, h // b0, w // b1, c)
    return f


@register_op("sequenceMask")
def _sequence_mask(maxLen=None, dtype="float32", **_):
    from deeplearning4j_tpu_torch.autodiff.samediff import _torch_dtype
    if maxLen is None:
        raise ValueError("sequenceMask: maxLen attr required")
    t, dt = int(maxLen), _torch_dtype(dtype)
    return lambda lengths: (torch.arange(t, device=lengths.device)[None, :]
                            < lengths.long()[:, None]).to(dt)


@register_op("confusionMatrix")
def _confusion_matrix(numClasses=None, **_):
    n = int(numClasses)

    def f(labels, pred):
        idx = (labels.long() * n + pred.long()).reshape(-1)
        idx = idx[(idx >= 0) & (idx < n * n)]   # jnp.bincount drops these
        return torch.bincount(idx, minlength=n * n).to(torch.int32).reshape(
            n, n)
    return f


@register_op("sortAlongAxis")
def _sort_axis(axis=-1, descending=False, **_):
    def f(x):
        s = torch.sort(x, dim=int(axis)).values
        return torch.flip(s, (int(axis),)) if descending else s
    return f


@register_op("argsortAlongAxis")
def _argsort_axis(axis=-1, descending=False, **_):
    def f(x):
        s = torch.argsort(x, dim=int(axis), stable=True)
        return torch.flip(s, (int(axis),)) if descending else s
    return f


@register_op("meshgrid")
def _meshgrid(indexing="xy", **_):
    return lambda *xs: list(torch.meshgrid(*xs, indexing=indexing))


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
_simple("logdet", lambda x: torch.linalg.slogdet(x)[1])
_simple("diag", lambda x: torch.diagflat(x).reshape(x.shape + x.shape)
        if x.dim() > 1 else torch.diag(x))


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


_simple("imageFlipLeftRight", lambda x: torch.flip(x, (-2,)))
_simple("imageFlipUpDown", lambda x: torch.flip(x, (-3,)))
_simple("rgbToGrayscale", lambda x: _gray(x))


@register_op("adjustBrightness")
def _adjust_brightness(delta=0.0, **_):
    return lambda x: x + torch.tensor(delta, dtype=x.dtype, device=x.device)


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


# ---------------------------------------------------------------------------
# recurrent cells and sequences (reference: generic/nn/recurrent/
# {gruCell,lstmCell,lstmLayer}.cpp).  The sequences take a time-major x
# (t, b, nIn) and return every step's h (t, b, nOut); the reference's
# lax.scan is a loop over t here, under autograd.
# ---------------------------------------------------------------------------
def _gru_step(x, h, Wru, Wc, bru, bc):
    ru = torch.sigmoid(torch.cat([x, h], dim=-1) @ Wru + bru)
    r, u = torch.chunk(ru, 2, dim=-1)
    c = torch.tanh(torch.cat([x, r * h], dim=-1) @ Wc + bc)
    return u * h + (1.0 - u) * c


def _lstm_step(x, h, c, W, b):
    z = torch.cat([x, h], dim=-1) @ W + b
    i, fg, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


@register_op("gruCell")
def _gru_cell(**_):
    return _gru_step


@register_op("lstmCell")
def _lstm_cell(**_):
    return lambda x, hLast, cLast, W, b: list(_lstm_step(x, hLast, cLast,
                                                         W, b))


@register_op("gru")
def _gru_seq(**_):
    def f(x, h0, Wru, Wc, bru, bc):
        h, hs = h0, []
        for xt in x:
            h = _gru_step(xt, h, Wru, Wc, bru, bc)
            hs.append(h)
        return torch.stack(hs)
    return f


@register_op("lstmLayer")
def _lstm_layer(**_):
    def f(x, h0, c0, W, b):
        h, c, hs = h0, c0, []
        for xt in x:
            h, c = _lstm_step(xt, h, c, W, b)
            hs.append(h)
        return torch.stack(hs)
    return f


@register_op("simpleRnnLayer")
def _simple_rnn_layer(**_):
    def f(x, h0, Wx, Wh, b):
        h, hs = h0, []
        for xt in x:
            h = torch.tanh(xt @ Wx + h @ Wh + b)
            hs.append(h)
        return torch.stack(hs)
    return f


# ---------------------------------------------------------------------------
# namespaces (reference: org/nd4j/autodiff/samediff/ops/{SDImage,SDRNN,
# SDLinalg}.java)
# ---------------------------------------------------------------------------
class SDImage(_Namespace):
    def resizeBilinear(self, x, height, width, name=None):
        return self.sd._op("resizeBilinear", [x],
                           {"height": height, "width": width}, name=name)

    def resizeNearestNeighbor(self, x, height, width, name=None):
        return self.sd._op("resizeNearestNeighbor", [x],
                           {"height": height, "width": width}, name=name)

    def resizeBiCubic(self, x, height, width, name=None):
        return self.sd._op("resizeBicubic", [x],
                           {"height": height, "width": width}, name=name)

    def cropAndResize(self, img, boxes, boxIdx, cropHeight, cropWidth,
                      method="bilinear", name=None):
        return self.sd._op("cropAndResize", [img, boxes, boxIdx],
                           {"cropHeight": cropHeight, "cropWidth": cropWidth,
                            "method": method}, name=name)

    def adjustBrightness(self, x, delta, name=None):
        return self.sd._op("adjustBrightness", [x], {"delta": delta},
                           name=name)

    def adjustContrast(self, x, factor, name=None):
        return self.sd._op("adjustContrast", [x], {"factor": factor},
                           name=name)

    def adjustSaturation(self, x, factor, name=None):
        return self.sd._op("adjustSaturation", [x], {"factor": factor},
                           name=name)

    def flipLeftRight(self, x, name=None):
        return self.sd._op("imageFlipLeftRight", [x], name=name)

    def flipUpDown(self, x, name=None):
        return self.sd._op("imageFlipUpDown", [x], name=name)

    def rgbToGrayscale(self, x, name=None):
        return self.sd._op("rgbToGrayscale", [x], name=name)

    def extractImagePatches(self, x, kH, kW, sH=1, sW=1, sameMode=False,
                            name=None):
        return self.sd._op("extractImagePatches", [x],
                           {"kH": kH, "kW": kW, "sH": sH, "sW": sW,
                            "isSameMode": sameMode}, name=name)


class SDRNN(_Namespace):
    def gruCell(self, x, hLast, Wru, Wc, bru, bc, name=None):
        return self.sd._op("gruCell", [x, hLast, Wru, Wc, bru, bc], name=name)

    def lstmCell(self, x, hLast, cLast, W, b, name=None):
        return self.sd._op("lstmCell", [x, hLast, cLast, W, b], n_out=2,
                           name=name)

    def gru(self, x, h0, Wru, Wc, bru, bc, name=None):
        """Full sequence, time-major x (t, b, nIn) -> (t, b, nOut)."""
        return self.sd._op("gru", [x, h0, Wru, Wc, bru, bc], name=name)

    def lstmLayer(self, x, h0, c0, W, b, name=None):
        """Full sequence, time-major x (t, b, nIn) -> (t, b, nOut)."""
        return self.sd._op("lstmLayer", [x, h0, c0, W, b], name=name)

    def simpleRnn(self, x, h0, Wx, Wh, b, name=None):
        return self.sd._op("simpleRnnLayer", [x, h0, Wx, Wh, b], name=name)


class SDLinalg(_Namespace):
    def inverse(self, x, name=None):
        return self.sd._op("matrixInverse", [x], name=name)

    def det(self, x, name=None):
        return self.sd._op("matrixDeterminant", [x], name=name)

    def logdet(self, x, name=None):
        return self.sd._op("logdet", [x], name=name)

    def cholesky(self, x, name=None):
        return self.sd._op("cholesky", [x], name=name)

    def solve(self, a, b, name=None):
        return self.sd._op("solve", [a, b], name=name)

    def triangularSolve(self, a, b, lower=True, adjoint=False, name=None):
        return self.sd._op("triangularSolve", [a, b],
                           {"lower": lower, "adjoint": adjoint}, name=name)

    def matrixBandPart(self, x, numLower, numUpper, name=None):
        return self.sd._op("matrixBandPart", [x],
                           {"numLower": numLower, "numUpper": numUpper},
                           name=name)

    def diagPart(self, x, name=None):
        return self.sd._op("matrixDiagPart", [x], name=name)

    def mmul(self, a, b, transposeA=False, transposeB=False, name=None):
        return self.sd._op("mmul", [a, b], {"transposeA": transposeA,
                                            "transposeB": transposeB},
                           name=name)


# sd.math() / sd.nn() gain the elementwise breadth, as the reference's
for _n in ["expm1", "log2", "log10", "cbrt", "cube", "oneMinus",
           "timesOneMinus", "step", "trunc", "rint", "frac", "lgamma",
           "digamma", "logSumExp", "entropy", "shannonEntropy", "amean",
           "amax", "amin", "asum", "skewness", "kurtosis", "standardize",
           "invertPermutation"]:
    setattr(SDMath, _n, _ns_unary(_n))
for _n in ["logAddExp", "igamma", "igammac", "euclideanDistance",
           "manhattanDistance", "hammingDistance", "cosineSimilarity",
           "jaccardDistance"]:
    setattr(SDMath, _n, _ns_binary(_n))
for _n in ["rationalTanh", "rectifiedTanh", "hardSwish"]:
    setattr(SDNN, _n, _ns_unary(_n))
del _n

#: names THIS module added to the registry (coverage-gate bookkeeping:
#: distinguishes "ops_ext battery didn't run" from "op lacks a test")
OPS_EXT_NAMES = set(OP_IMPLS) - _CORE_OPS
