"""Extended SameDiff ops, part 2: the port of
``deeplearning4j_tpu/autodiff/ops_ext2.py`` (math stragglers, bitwise, fft,
decompositions, im2col / col2im, CTC loss, the bounded dynamic ops,
histogram, losses, the 1-D and 3-D convolutions and pools, random, colour
spaces, non-max suppression) and ``sd.bitwise()``.

The bounded dynamic ops keep the reference's static-shape convention:
outputs are padded to the input's size with 0 (data) or -1 (indices).
One op departs from the reference on purpose: ``unique`` keeps
first-occurrence order, as TF's ``Unique`` and libnd4j's ``unique`` do,
where ``jnp.unique`` sorts (ROADMAP C10).  ``eig`` runs where torch runs
it (the reference's ``jnp.linalg.eig`` runs on the host only); the random
ops draw on their tensor's device, seeded per node, with torch's bits, not
``jax.random``'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, SDMath,
                                                        SDNN, SameDiff,
                                                        _abs, _axes, _gen,
                                                        _Namespace,
                                                        _ns_binary,
                                                        _ns_unary, _simple,
                                                        register_op)
from deeplearning4j_tpu_torch.autodiff.ops_ext import SDLinalg
from deeplearning4j_tpu_torch.nn.conf.layers import _same_pads
from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    _transposed_conv, _transposed_pads)

# ---------------------------------------------------------------------------
# math (generic/transforms + parity_ops stragglers)
# ---------------------------------------------------------------------------
_simple("asinh", torch.asinh)
_simple("acosh", torch.acosh)
_simple("atanh", torch.atanh)
_simple("erfinv", torch.erfinv)
_simple("nextAfter", torch.nextafter)
_simple("fmod", torch.fmod)
_simple("zeta", torch.special.zeta)
_simple("divNoNan", lambda x, y: torch.where(y == 0, torch.zeros_like(x / y),
                                             x / y))
_simple("safeDivide", lambda x, y: torch.where(
    y == 0, torch.zeros_like(x / y), x / y))
_simple("sinc", torch.sinc)
_simple("hypot", torch.hypot)
_simple("copySign", torch.copysign)
_simple("toDegrees", torch.rad2deg)
_simple("toRadians", torch.deg2rad)
_simple("stopGradient", lambda x: x.detach())
_simple("assign", lambda x, y: y)          # reference: assign(target, src)
_simple("crelu", lambda x: torch.cat([torch.relu(x), torch.relu(-x)],
                                     dim=-1))
_simple("ravel", lambda x: x.reshape(-1))
_simple("kron", torch.kron)
_simple("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))


def _swish_derivative(x):
    """d/dx of x·sigmoid(x), as the reference's ``jax.grad`` of swish."""
    s = torch.sigmoid(x)
    return s + x * s * (1.0 - s)


_simple("swishDerivative", _swish_derivative)


def _betainc(a, b, x, iters: int = 200):
    """The regularized incomplete beta I_x(a, b): Lentz's continued
    fraction (Numerical Recipes' ``betacf``), on the side of x where it
    converges fast, as ``jax.scipy.special.betainc`` evaluates it."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1) / (a + b + 2)
    a, b, x = (torch.where(swap, b, a), torch.where(swap, a, b),
               torch.where(swap, 1 - x, x))
    tiny = 1e-30
    qab, qap, qam = a + b, a + 1, a - 1
    c = torch.ones_like(x)
    d = 1 - qab * x / qap
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1 / d
    h = d
    for m in range(1, iters + 1):
        m2 = 2 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1 + aa * d
            d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
            c = 1 + aa / c
            c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
            d = 1 / d
            h = h * d * c
    lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    front = torch.exp(a * torch.log(x) + b * torch.log1p(-x) - lbeta) / a
    out = front * h
    out = torch.where(swap, 1 - out, out)
    out = torch.where(x <= 0, torch.where(swap, torch.ones_like(out),
                                          torch.zeros_like(out)), out)
    return out


_simple("betainc", _betainc)


@register_op("polygamma")
def _polygamma(**_):
    def f(n, x):
        # jax.scipy.special.polygamma: digamma at n = 0, else
        # (-1)^(n+1) n! zeta(n+1, x)
        n = n.to(x.dtype) if isinstance(n, torch.Tensor) else \
            torch.tensor(float(n), dtype=x.dtype, device=x.device)
        sign = torch.where(torch.remainder(n, 2) == 0, -1.0, 1.0).to(x.dtype)
        rest = sign * torch.exp(torch.lgamma(n + 1)) * \
            torch.special.zeta(n + 1, x)
        return torch.where(n == 0, torch.digamma(x), rest)
    return f


@register_op("broadcastTo")
def _broadcast_to(shape=(), **_):
    return lambda x: torch.broadcast_to(x, tuple(int(s) for s in shape))


@register_op("mirrorPad")
def _mirror_pad(mode="REFLECT", paddings=None, **_):
    # paddings are static metadata (the importer folds the TF paddings
    # input into this attr); numpy's "reflect" / "symmetric" along each axis
    reflect = str(mode).upper() == "REFLECT"

    def f(x, *_ignored_pad_input):
        for ax, (lo, hi) in enumerate(np.asarray(paddings).tolist()):
            lo, hi = int(lo), int(hi)
            if not (lo or hi):
                continue
            n = x.shape[ax]
            off = 1 if reflect else 0
            left = torch.arange(lo + off - 1, off - 1, -1, device=x.device)
            right = torch.arange(n - 1 - off, n - 1 - off - hi, -1,
                                 device=x.device)
            idx = torch.cat([left, torch.arange(n, device=x.device), right])
            x = torch.index_select(x, ax, idx)
        return x
    return f


@register_op("roll")
def _roll(shift=0, dims=None, **_):
    sh = tuple(int(s) for s in shift) if isinstance(shift, (tuple, list)) \
        else int(shift)
    if dims is None:
        return lambda x: torch.roll(x, sh)
    ax = tuple(int(d) for d in dims)
    if isinstance(sh, int):
        sh = (sh,) * len(ax)
    return lambda x: torch.roll(x, sh, ax)


# ---------------------------------------------------------------------------
# bitwise
# ---------------------------------------------------------------------------
_simple("bitwiseAnd", torch.bitwise_and)
_simple("bitwiseOr", torch.bitwise_or)
_simple("bitwiseXor", torch.bitwise_xor)
_simple("bitwiseNot", torch.bitwise_not)
_simple("leftShift", torch.bitwise_left_shift)
_simple("rightShift", torch.bitwise_right_shift)

_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int64)


def _bit_count(x):
    """``lax.population_count``: set bits of each element's own width,
    in its own dtype."""
    nbytes = torch.iinfo(x.dtype).bits // 8
    v = x.long()
    table = _POPCOUNT8.to(x.device)
    out = torch.zeros_like(v)
    for i in range(nbytes):
        out = out + table[(v >> (8 * i)) & 0xFF]
    return out.to(x.dtype)


_simple("bitCount", _bit_count)


# ---------------------------------------------------------------------------
# fft
# ---------------------------------------------------------------------------
# (the inverse transforms come back as lazily conjugated views: resolved,
# so their callers can copy them out)
_simple("fft", lambda x: torch.fft.fft(x))
_simple("ifft", lambda x: torch.fft.ifft(x).resolve_conj())
_simple("rfft", lambda x: torch.fft.rfft(x))
_simple("fft2d", lambda x: torch.fft.fft2(x))
_simple("ifft2d", lambda x: torch.fft.ifft2(x).resolve_conj())


@register_op("irfft")
def _irfft(n=None, **_):
    return lambda x: torch.fft.irfft(x, n=int(n) if n else None)


# ---------------------------------------------------------------------------
# decompositions (reference: generic/blas + parity_ops)
# ---------------------------------------------------------------------------
@register_op("svd")
def _svd(fullUV=False, computeUv=True, **_):
    def f(x):
        if not computeUv:
            return torch.linalg.svdvals(x)
        u, s, vh = torch.linalg.svd(x, full_matrices=bool(fullUV))
        # the reference's Svd outputs (s, u, v), v not conj-transposed
        return [s, u, vh.mT]
    return f


@register_op("qr")
def _qr(fullMatrices=False, **_):
    def f(x):
        q, r = torch.linalg.qr(x, mode="complete" if fullMatrices
                               else "reduced")
        return [q, r]
    return f


_simple("cross", lambda a, b: torch.linalg.cross(a, b, dim=-1))


# ---------------------------------------------------------------------------
# dynamic partition / stitch / unique / listdiff (bounded static shapes)
# ---------------------------------------------------------------------------
def _compact(x, mask, fill=0):
    """Stable-move the rows where ``mask`` holds to the front; the rest of
    the rows become ``fill``."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    gathered = torch.index_select(x, 0, order)
    keep = torch.arange(x.shape[0], device=x.device) < mask.sum()
    keep = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, gathered, torch.full_like(gathered, fill))


@register_op("dynamicPartition")
def _dyn_partition(numPartitions=2, **_):
    k = int(numPartitions)
    return lambda x, partitions: [_compact(x, partitions == i)
                                  for i in range(k)]


@register_op("dynamicStitch")
def _dyn_stitch(numPartitions=2, **_):
    k = int(numPartitions)

    def f(*args):
        idx, data = args[:k], args[k:2 * k]
        total = sum(d.shape[0] for d in data)
        out = torch.zeros((total,) + tuple(data[0].shape[1:]),
                          dtype=data[0].dtype, device=data[0].device)
        for i, d in zip(idx, data):
            # a negative (padded) index or one past the end is dropped
            i = i.long().reshape(-1)
            d = d.reshape((i.shape[0],) + tuple(d.shape[i.dim():]))
            ok = (i >= 0) & (i < total)
            out = out.index_put((i[ok],), d[ok])
        return out
    return f


def _first_occurrence_unique(x):
    """(values in first-occurrence order padded with 0 to x's size, each
    element's index into them, each value's count padded with 0)."""
    flat = x.reshape(-1)
    n = flat.numel()
    vals, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                                  return_counts=True)
    first = torch.full((vals.numel(),), n, dtype=torch.long,
                       device=x.device)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=x.device),
                                 "amin")
    order = torch.argsort(first)                  # sorted -> first seen
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=x.device)
    pad = n - vals.numel()
    out_vals = torch.cat([vals[order], vals.new_zeros(pad)])
    out_cnt = torch.cat([cnt[order], cnt.new_zeros(pad)]).to(torch.int32)
    return out_vals, rank[inv].reshape(x.shape).to(torch.int32), out_cnt


@register_op("unique")
def _unique(**_):
    return lambda x: list(_first_occurrence_unique(x)[:2])


@register_op("uniqueWithCounts")
def _unique_counts(**_):
    return lambda x: list(_first_occurrence_unique(x))


@register_op("listDiff")
def _listdiff(**_):
    def f(x, y):
        mask = ~torch.isin(x, y)
        idx = torch.arange(x.shape[0], device=x.device)
        return [_compact(x, mask, fill=0),
                _compact(idx, mask, fill=-1).to(torch.int32)]
    return f


@register_op("histogramFixedWidth")
def _hist_fixed(numBins=100, **_):
    n = int(numBins)

    def f(x, valueRange):
        lo, hi = valueRange[0], valueRange[1]
        idx = torch.clamp(((x - lo) / (hi - lo) * n).to(torch.int32),
                          0, n - 1)
        return torch.bincount(idx.reshape(-1).long(), minlength=n)
    return f


@register_op("l2Loss")
def _l2loss(**_):
    return lambda x: 0.5 * torch.sum(x * x)


@register_op("localResponseNormalization")
def _lrn(depth=5, bias=1.0, alpha=1e-4, beta=0.75, dataFormat="NCHW", **_):
    # across-channel LRN; TF graphs are NHWC (channel last), DL4J NCHW
    ch_axis = 1 if str(dataFormat).upper() == "NCHW" else -1

    def f(x):
        half = int(depth) // 2
        sq = torch.movedim(x * x, ch_axis, 1)
        c = sq.shape[1]
        pad = [0, 0] * (sq.dim() - 2) + [half, half]
        padded = torch.nn.functional.pad(sq, pad)
        acc = sum(padded[:, i:i + c] for i in range(int(depth)))
        return x / torch.pow(bias + alpha * torch.movedim(acc, 1, ch_axis),
                             beta)
    return f


# ---------------------------------------------------------------------------
# random (seeded per node: the same draw on every call; not the
# reference's bits, which come from jax.random)
# ---------------------------------------------------------------------------
@register_op("random_shuffle")
def _rshuffle(seed=0, **_):
    def f(x):
        perm = torch.randperm(x.shape[0], generator=_gen(seed, x.device),
                              device=x.device)
        return torch.index_select(x, 0, perm)
    return f


@register_op("random_multinomial")
def _rmultinomial(numSamples=1, seed=0, **_):
    def f(logits):
        p = torch.softmax(logits.double(), dim=-1)
        draws = torch.multinomial(p, int(numSamples), replacement=True,
                                  generator=_gen(seed, logits.device))
        return draws.to(torch.int32)    # (batch, samples)
    return f


@register_op("random_truncated_normal")
def _rtrunc(shape=(), seed=0, mean=0.0, stddev=1.0, **_):
    def f():
        # inverse CDF of the standard normal over [-2, 2]
        lo, hi = (0.5 * (1 + math.erf(v / math.sqrt(2))) for v in (-2, 2))
        u = lo + (hi - lo) * torch.rand(tuple(shape), generator=_gen(seed))
        return mean + stddev * math.sqrt(2) * torch.erfinv(2 * u - 1)
    return f


# ---------------------------------------------------------------------------
# colour spaces
# ---------------------------------------------------------------------------
@register_op("rgbToHsv")
def _rgb_to_hsv(**_):
    def f(x):  # (..., 3) in [0, 1]
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        mx = torch.maximum(torch.maximum(r, g), b)
        mn = torch.minimum(torch.minimum(r, g), b)
        d = mx - mn
        safe = torch.where(d == 0, torch.ones_like(d), d)
        h = torch.where(
            mx == r, torch.remainder((g - b) / safe, 6.0),
            torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
        h = torch.where(d == 0, torch.zeros_like(h), h) / 6.0
        s = torch.where(mx == 0, torch.zeros_like(d),
                        d / torch.where(mx == 0, torch.ones_like(mx), mx))
        return torch.stack([h, s, mx], dim=-1)
    return f


@register_op("hsvToRgb")
def _hsv_to_rgb(**_):
    def f(x):
        h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
        i = torch.floor(h)
        fr = h - i
        p = v * (1 - s)
        q = v * (1 - s * fr)
        t = v * (1 - s * (1 - fr))
        i = torch.remainder(i.to(torch.int32), 6)

        def pick(*choices):
            out = choices[-1]
            for k in range(4, -1, -1):
                out = torch.where(i == k, choices[k], out)
            return out
        return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                            pick(p, p, t, v, v, q)], dim=-1)
    return f


@register_op("adjustHue")
def _adjust_hue(delta=0.0, **_):
    to_hsv = OP_IMPLS["rgbToHsv"]()
    to_rgb = OP_IMPLS["hsvToRgb"]()

    def f(x):
        hsv = to_hsv(x)
        h = torch.remainder(hsv[..., 0] + delta, 1.0)
        return to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    return f


# ---------------------------------------------------------------------------
# non-max suppression (greedy, static k outputs padded with -1)
# ---------------------------------------------------------------------------
@register_op("nonMaxSuppression")
def _nms(maxOutputSize=10, iouThreshold=0.5, scoreThreshold=-math.inf,
         **_):
    k = int(maxOutputSize)

    def iou(box, boxes):
        y1 = torch.maximum(box[0], boxes[:, 0])
        x1 = torch.maximum(box[1], boxes[:, 1])
        y2 = torch.minimum(box[2], boxes[:, 2])
        x2 = torch.minimum(box[3], boxes[:, 3])
        inter = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
        a1 = (box[2] - box[0]) * (box[3] - box[1])
        a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / torch.clamp(a1 + a2 - inter, min=1e-12)

    def f(boxes, scores):
        live = scores > scoreThreshold
        ar = torch.arange(scores.shape[0], device=scores.device)
        out = []
        for _i in range(k):
            masked = torch.where(live, scores,
                                 torch.full_like(scores, -math.inf))
            best = torch.argmax(masked)
            ok = masked[best] > -math.inf
            out.append(torch.where(ok, best, torch.full_like(best, -1)))
            overlaps = iou(boxes[best], boxes) > iouThreshold
            live = live & ~overlaps & (ar != best) & ok
        return torch.stack(out).to(torch.int32)
    return f


# ---------------------------------------------------------------------------
# the ops the ONNX importer's rules emit (LpNormalization, Trilu,
# ConvTranspose)
# ---------------------------------------------------------------------------
@register_op("l2Normalize")
def _l2_normalize(dims=None, **_):
    # axis-aware (ONNX LpNormalization passes dims); default last axis
    ax = tuple(dims) if dims is not None else (-1,)
    return lambda x: x / torch.clamp(
        torch.sqrt(torch.sum(x * x, dim=ax, keepdim=True)), min=1e-12)


_simple("triu", torch.triu)
_simple("tril", torch.tril)

# the ONNX rules call these through sd.math(), as the reference's
# ops_ext2 adds them there
for _n in ["asinh", "acosh", "atanh"]:
    setattr(SDMath, _n, _ns_unary(_n))
del _n


@register_op("deconv2d")
def _deconv2d(sH=1, sW=1, pH=0, pW=0, isSameMode=False, **_):
    def f(x, w, *bias):   # w (o, i, kh, kw)
        # the reference's lowering, as Deconvolution2D's
        stride = (int(sH), int(sW))
        pads = _transposed_pads(x.shape[2:], w.shape[2:], stride,
                                (int(pH), int(pW)), isSameMode)
        y = _transposed_conv(x, w, stride, pads)
        if bias:
            y = y + bias[0].reshape(1, -1, 1, 1)
        return y
    return f


# ---------------------------------------------------------------------------
# the rest of the reference's math and reduction stragglers
# ---------------------------------------------------------------------------
@register_op("checkNumerics")
def _checknum(message="", **_):
    # a non-finite input taints the output with NaN, as the reference's
    # lax.cond does; no host round trip
    return lambda x: torch.where(torch.isfinite(x).all(), x, x * math.nan)


@register_op("rot90")
def _rot90(k=1, axes=(0, 1), **_):
    return lambda x: torch.rot90(x, int(k), [int(a) for a in axes])


@register_op("isMax")
def _ismax(**_):
    def f(x):
        flat = x.reshape(-1)
        hot = torch.arange(flat.numel(), device=x.device) == torch.argmax(flat)
        return hot.reshape(x.shape).to(x.dtype)
    return f


@register_op("clipByAvgNorm")
def _clip_avg_norm(clipValue=1.0, **_):
    def f(x):
        avg = torch.sqrt(torch.sum(x * x)) / x.numel()
        return torch.where(avg > clipValue, x * (clipValue / avg), x)
    return f


@register_op("tri")
def _tri(row=1, column=None, diag=0, **_):
    return lambda: torch.ones(int(row), int(column) if column else int(row),
                              dtype=torch.float32).tril(int(diag))


def _cum_extreme(name, fn, identity):
    def factory(dims=0, exclusive=False, reverse=False, **_):
        ax = int(dims[0]) if isinstance(dims, (tuple, list)) else int(dims)

        def f(x):
            y = torch.flip(x, (ax,)) if reverse else x
            if exclusive:   # scan over [identity, y[:-1]], as TF's cumsum
                n = y.shape[ax]
                pad = torch.full_like(y.narrow(ax, 0, 1), identity)
                y = torch.cat([pad, y.narrow(ax, 0, n - 1)], dim=ax)
            y = fn(y, ax).values
            return torch.flip(y, (ax,)) if reverse else y
        return f
    OP_IMPLS[name] = factory


_cum_extreme("cumMax", torch.cummax, -math.inf)
_cum_extreme("cumMin", torch.cummin, math.inf)


def _last_axes(x, dims):
    """``x`` with the axes of ``dims`` (all when None) moved to the end
    and flattened into one, and the shape keepdims would give."""
    ax = _axes(x, dims)
    rest = [d for d in range(x.dim()) if d not in ax]
    y = x.permute(*rest, *ax).reshape([x.shape[d] for d in rest] + [-1])
    keep = [1 if d in ax else x.shape[d] for d in range(x.dim())]
    return y, keep


def _quantile(x, q, dims, keep, midpoint=False):
    """``jnp.percentile`` / ``jnp.median`` by a sort: linear interpolation
    between the order statistics (the two middle values averaged for the
    median).  ``torch.quantile`` would refuse inputs past 2**24 elements
    and reduce only one axis."""
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    y, kshape = _last_axes(x, dims)
    s = torch.sort(y, dim=-1).values
    n = s.shape[-1]
    pos = q * (n - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    a, b = s[..., lo], s[..., hi]
    out = (a + b) / 2 if midpoint else a + (b - a) * (pos - lo)
    return out.reshape(kshape) if keep else out


@register_op("percentile")
def _percentile(percentile=50.0, dims=None, keepDims=False, **_):
    return lambda x: _quantile(x, float(percentile) / 100.0, dims,
                               bool(keepDims))


@register_op("median")
def _median(dims=None, keepDims=False, **_):
    # jnp.median averages the two middle values; torch.median would give
    # the lower one
    return lambda x: _quantile(x, 0.5, dims, bool(keepDims), midpoint=True)


@register_op("moments")
def _moments(dims=None, keepDims=False, **_):
    def f(x):
        ax = _axes(x, dims)
        return [torch.mean(x, dim=ax, keepdim=bool(keepDims)),
                torch.var(x, dim=ax, correction=0, keepdim=bool(keepDims))]
    return f


@register_op("normalizeMoments")
def _normalize_moments(shift=0.0, **_):
    def f(counts, meanSS, varSS):
        mu = meanSS / counts
        return [mu + shift, varSS / counts - mu ** 2]
    return f


@register_op("matrixPower")
def _matrix_power(n=1, **_):
    return lambda x: torch.linalg.matrix_power(x, int(n))


# ---------------------------------------------------------------------------
# bitwise stragglers.  Shifts by the element's width or more give 0, as
# XLA's do; the right shifts of the rotations are logical (torch's ``>>``
# is arithmetic on signed integers), so the bits go through int64 masked
# to the element's width.
# ---------------------------------------------------------------------------
_simple("toggleBits", torch.bitwise_not)


def _nbits(x):
    return torch.iinfo(x.dtype).bits


def _to_width(v, n, dtype):
    """The low ``n`` bits of int64 ``v`` as ``dtype`` (two's complement)."""
    if n == 64:
        return v
    v = v & ((1 << n) - 1)
    if dtype.is_signed:
        v = torch.where(v >= 1 << (n - 1), v - (1 << n), v)
    return v.to(dtype)


def _shl(x, s, n):
    v = x.long() << torch.clamp(s, 0, 63)
    return torch.where(s >= n, torch.zeros_like(v), v)


def _lsr(x, s, n):
    v = x.long()
    if n < 64:
        v = v & ((1 << n) - 1)
        return torch.where(s >= n, torch.zeros_like(v),
                           v >> torch.clamp(s, 0, 63))
    r = torch.clamp(s, 1, 63)
    out = (v >> r) & ((torch.ones_like(v) << (64 - r)) - 1)
    return torch.where(s <= 0, v, torch.where(s >= 64, torch.zeros_like(v),
                                              out))


def _rotate(left):
    def factory(**_):
        def f(x, s):
            n = _nbits(x)
            s = torch.remainder(torch.as_tensor(s, device=x.device).long(),
                                n)
            a, b = (_shl(x, s, n), _lsr(x, n - s, n)) if left else \
                (_lsr(x, s, n), _shl(x, n - s, n))
            return _to_width(a | b, n, x.dtype)
        return f
    return factory


OP_IMPLS["cyclicShiftLeft"] = _rotate(True)
OP_IMPLS["cyclicShiftRight"] = _rotate(False)


@register_op("bitsHammingDistance")
def _bits_hamming(**_):
    return lambda x, y: torch.sum(_bit_count(torch.bitwise_xor(x, y)).long())


# ---------------------------------------------------------------------------
# decompositions
# ---------------------------------------------------------------------------
@register_op("lu")
def _lu(**_):
    def f(x):
        lu, piv = torch.linalg.lu_factor(x)
        # lax.linalg.lu's pivots are 0-based; LAPACK's (torch's) 1-based
        return [lu, (piv - 1).to(torch.int32)]
    return f


@register_op("eig")
def _eig(**_):
    # complex eigenpairs, in LAPACK's order; torch computes them on the
    # host for a CUDA input, as JAX runs jnp.linalg.eig on the host only
    return lambda x: list(torch.linalg.eig(x))


@register_op("selfAdjointEig")
def _eigh(**_):
    return lambda x: list(torch.linalg.eigh(x))


@register_op("lstsq")
def _lstsq(fast=True, l2Regularizer=0.0, **_):
    def f(a, b):
        if l2Regularizer:
            ata = a.mT @ a + l2Regularizer * torch.eye(
                a.shape[-1], dtype=a.dtype, device=a.device)
            return torch.linalg.solve(ata, a.mT @ b)
        return torch.linalg.lstsq(a, b).solution
    return f


@register_op("batchMmul")
def _batch_mmul(transposeA=False, transposeB=False, **_):
    def f(a, b):
        if transposeA:
            a = a.transpose(-1, -2)
        if transposeB:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return f


# ---------------------------------------------------------------------------
# im2col / col2im (reference: generic/convo/im2col.cpp, col2im.cpp): the
# patches in nd4j's (b, c, kh, kw, oh, ow) layout; col2im is im2col's
# adjoint (overlapping patches add)
# ---------------------------------------------------------------------------
def _patch_pads(h, w, kh, kw, sh, sw, ph, pw, dh, dw, same):
    if same:
        return _same_pads(h, kh, sh, dh), _same_pads(w, kw, sw, dw)
    return (ph, ph), (pw, pw)


@register_op("im2col")
def _im2col(kH=2, kW=2, sH=1, sW=1, pH=0, pW=0, dH=1, dW=1,
            isSameMode=False, **_):
    kh, kw, sh, sw = int(kH), int(kW), int(sH), int(sW)
    dh, dw = int(dH), int(dW)

    def f(x):
        b, c, h, w = x.shape
        (pt, pb), (pl, pr) = _patch_pads(h, w, kh, kw, sh, sw, int(pH),
                                         int(pW), dh, dw, bool(isSameMode))
        xp = F.pad(x, (pl, pr, pt, pb))
        oh = (xp.shape[2] - (kh - 1) * dh - 1) // sh + 1
        ow = (xp.shape[3] - (kw - 1) * dw - 1) // sw + 1
        cols = F.unfold(xp, (kh, kw), dilation=(dh, dw), stride=(sh, sw))
        return cols.reshape(b, c, kh, kw, oh, ow)
    return f


@register_op("col2im")
def _col2im(sH=1, sW=1, pH=0, pW=0, imgH=1, imgW=1, dH=1, dW=1,
            isSameMode=False, **_):
    sh, sw, dh, dw = int(sH), int(sW), int(dH), int(dW)
    ih, iw = int(imgH), int(imgW)

    def f(cols):
        b, c, kh, kw, oh, ow = cols.shape
        (pt, pb), (pl, pr) = _patch_pads(ih, iw, kh, kw, sh, sw, int(pH),
                                         int(pW), dh, dw, bool(isSameMode))
        img = F.fold(cols.reshape(b, c * kh * kw, oh * ow),
                     (ih + pt + pb, iw + pl + pr), (kh, kw),
                     dilation=(dh, dw), stride=(sh, sw))
        return img[:, :, pt:pt + ih, pl:pl + iw]
    return f


# ---------------------------------------------------------------------------
# CTC loss (reference: generic/loss/ctcLoss.cpp — the alpha recursion in
# log space over the blank-extended labels, a loop over time here;
# gradients by autograd)
# ---------------------------------------------------------------------------
@register_op("ctcLoss")
def _ctc_loss(blankIndex=0, **_):
    def f(targetLabels, logitInput, targetLabelLengths, logitInputLengths):
        """targetLabels (b, S) int; logitInput (b, T, C) raw logits;
        lengths (b,) int.  Returns each example's negative log
        likelihood."""
        labels = targetLabels.long()
        lab_len = targetLabelLengths.long()
        log_len = logitInputLengths.long()
        dt = logitInput.dtype if logitInput.is_floating_point() \
            else torch.float32
        logp = torch.log_softmax(logitInput.to(dt), dim=-1)
        b, t_max, _c = logp.shape
        s_max = labels.shape[1]
        dev = logp.device
        blank = int(blankIndex)
        neg_inf = torch.tensor(-1e30, dtype=dt, device=dev)
        # extended sequence: blank, l1, blank, l2, ..., blank (2S + 1)
        ext_len = 2 * s_max + 1
        pos = torch.arange(ext_len, device=dev)
        lab_idx = torch.clamp(pos // 2, max=s_max - 1).expand(b, ext_len)
        lab_at = torch.gather(labels, 1, lab_idx)
        ext = torch.where(pos[None, :] % 2 == 0, blank, lab_at)
        valid_ext = pos[None, :] < (2 * lab_len[:, None] + 1)
        # a skip from s - 2 lands only on a non-blank differing label
        ext_m2 = torch.cat([torch.full((b, 2), blank, dtype=ext.dtype,
                                       device=dev), ext[:, :-2]], dim=1)
        can_skip = (pos[None, :] % 2 == 1) & (ext != ext_m2)
        alpha = torch.full((b, ext_len), -1e30, dtype=dt, device=dev)
        alpha = torch.cat([logp[:, 0, blank][:, None],
                           torch.gather(logp[:, 0, :], 1, labels[:, :1]),
                           alpha[:, 2:]], dim=1)
        alpha = torch.where(valid_ext, alpha, neg_inf)
        pad1 = neg_inf.expand(b, 1)
        pad2 = neg_inf.expand(b, 2)
        for t in range(1, t_max):
            shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
            shift2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
            shift2 = torch.where(can_skip, shift2, neg_inf)
            merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
            new = merged + torch.gather(logp[:, t, :], 1, ext)
            new = torch.where(valid_ext, new, neg_inf)
            # alpha freezes past each example's logit length
            alpha = torch.where((t < log_len)[:, None], new, alpha)
        iL = 2 * lab_len
        aL = torch.gather(alpha, 1, iL[:, None])[:, 0]
        aLm1 = torch.gather(alpha, 1, torch.clamp(iL - 1, min=0)[:, None])[:,
                                                                           0]
        # a zero-length label has only the all-blank path (aL)
        aLm1 = torch.where(iL > 0, aLm1, neg_inf)
        return -torch.logaddexp(aL, aLm1)
    return f


# ---------------------------------------------------------------------------
# histogram and the losses (reference: generic/parity_ops/histogram*.cpp,
# generic/loss/**)
# ---------------------------------------------------------------------------
@register_op("histogram")
def _histogram(numBins=10, **_):
    n = int(numBins)

    def f(x):
        lo, hi = torch.min(x), torch.max(x)
        width = torch.clamp(hi - lo, min=1e-12)
        idx = torch.clamp(((x - lo) / width * n).to(torch.int32), 0, n - 1)
        return torch.bincount(idx.reshape(-1).long(), minlength=n)
    return f


def _reduce_loss2(per, reduction):
    if reduction in ("MEAN", "MEAN_BY_NONZERO_WEIGHT_COUNT",
                     "MEAN_BY_WEIGHT"):
        return torch.mean(per)
    if reduction == "SUM":
        return torch.sum(per)
    return per


@register_op("hingeLoss")
def _hinge(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    # labels {0, 1} -> {-1, 1}, as the reference's
    return lambda labels, pred: _reduce_loss2(
        torch.relu(1.0 - (2.0 * labels - 1.0) * pred), reduction)


@register_op("squaredHingeLoss")
def _sq_hinge(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    return lambda labels, pred: _reduce_loss2(
        torch.relu(1.0 - (2.0 * labels - 1.0) * pred) ** 2, reduction)


@register_op("poissonLoss")
def _poisson(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", full=False, **_):
    def f(labels, pred):
        per = pred - labels * torch.log(torch.clamp(pred, min=1e-12))
        if full:
            per = per + (labels * torch.log(torch.clamp(labels, min=1e-12))
                         - labels + 0.5 * torch.log(
                             torch.clamp(2 * math.pi * labels, min=1e-12)))
        return _reduce_loss2(per, reduction)
    return f


@register_op("weightedCrossEntropyWithLogits")
def _weighted_ce(**_):
    def f(targets, logits, weights):
        log_w = 1 + (weights - 1) * targets
        return torch.mean((1 - targets) * logits + log_w * (
            torch.log1p(torch.exp(-_abs(logits))) + torch.relu(-logits)))
    return f


@register_op("klDivergence")
def _kld(reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    def f(labels, pred):
        per = torch.sum(labels * (torch.log(torch.clamp(labels, min=1e-12))
                                  - torch.log(torch.clamp(pred, min=1e-12))),
                        dim=-1)
        return _reduce_loss2(per, reduction)
    return f


@register_op("cosineDistanceLoss")
def _cos_loss(dimension=-1, reduction="MEAN_BY_NONZERO_WEIGHT_COUNT", **_):
    return lambda labels, pred: _reduce_loss2(
        1.0 - torch.sum(labels * pred, dim=dimension), reduction)


# ---------------------------------------------------------------------------
# convolution breadth as graph ops (reference: generic/convo/conv{1,3}d.cpp,
# pooling3d.cpp, depthwiseConv2d.cpp, sconv2d.cpp).  SAME pads as lax's
# "SAME" does (an odd total puts the extra pixel at the end).
# ---------------------------------------------------------------------------
def _pad_same(x, kernel, strides, value=0.0):
    """Pad the trailing spatial axes of ``x`` for SAME."""
    pads = [_same_pads(x.shape[x.dim() - len(kernel) + i], int(k), int(s))
            for i, (k, s) in enumerate(zip(kernel, strides))]
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _bias_add(y, bias):
    return y + bias[0].reshape((1, -1) + (1,) * (y.dim() - 2)) if bias else y


@register_op("conv1d")
def _conv1d(s=1, p=0, isSameMode=False, **_):
    def f(x, w, *bias):   # x (b, c, t); w (o, i, k)
        if isSameMode:
            y = F.conv1d(_pad_same(x, (w.shape[2],), (int(s),)), w,
                         stride=int(s))
        else:
            y = F.conv1d(x, w, stride=int(s), padding=int(p))
        return _bias_add(y, bias)
    return f


@register_op("conv3d")
def _conv3d(sD=1, sH=1, sW=1, isSameMode=False, **_):
    st = (int(sD), int(sH), int(sW))

    def f(x, w, *bias):   # x (b, c, d, h, w); w (o, i, kd, kh, kw)
        if isSameMode:
            x = _pad_same(x, w.shape[2:], st)
        return _bias_add(F.conv3d(x, w, stride=st), bias)
    return f


@register_op("depthwiseConv2d")
def _depthwise2d(sH=1, sW=1, isSameMode=False, **_):
    st = (int(sH), int(sW))

    def f(x, w, *bias):   # w (c*m, 1, kh, kw)
        if isSameMode:
            x = _pad_same(x, w.shape[2:], st)
        return _bias_add(F.conv2d(x, w, stride=st, groups=x.shape[1]), bias)
    return f


@register_op("sconv2d")
def _sepconv2d(sH=1, sW=1, isSameMode=False, **_):
    st = (int(sH), int(sW))

    def f(x, dw, pw, *bias):
        if isSameMode:
            x = _pad_same(x, dw.shape[2:], st)
        y = F.conv2d(x, dw, stride=st, groups=x.shape[1])
        return _bias_add(F.conv2d(y, pw), bias)
    return f


def _pool3d(kind):
    def factory(kD=2, kH=2, kW=2, sD=None, sH=None, sW=None,
                isSameMode=False, **_):
        k = (int(kD), int(kH), int(kW))
        st = (int(sD or k[0]), int(sH or k[1]), int(sW or k[2]))

        def f(x):
            if kind == "max":
                if isSameMode:
                    x = _pad_same(x, k, st, -math.inf)
                return F.max_pool3d(x, k, st)
            if not isSameMode:
                return F.avg_pool3d(x, k, st)
            # the window's mean over its real (unpadded) inputs
            ones = torch.ones_like(x[:1, :1])
            return F.avg_pool3d(_pad_same(x, k, st), k, st) \
                / F.avg_pool3d(_pad_same(ones, k, st), k, st)
        return f
    return factory


OP_IMPLS["maxPooling3d"] = _pool3d("max")
OP_IMPLS["avgPooling3d"] = _pool3d("avg")


@register_op("upsampling2d")
def _upsampling2d(scaleH=2, scaleW=2, **_):
    return lambda x: torch.repeat_interleave(
        torch.repeat_interleave(x, int(scaleH), dim=2), int(scaleW), dim=3)


@register_op("upsampling3d")
def _upsampling3d(scaleD=2, scaleH=2, scaleW=2, **_):
    def f(x):
        for d, s in ((2, scaleD), (3, scaleH), (4, scaleW)):
            x = torch.repeat_interleave(x, int(s), dim=d)
        return x
    return f


# ---------------------------------------------------------------------------
# random breadth (seeded per node: the same draw on every call; torch's
# bits, not jax.random's — held to shape, dtype, determinism and moments)
# ---------------------------------------------------------------------------
@register_op("random_exponential")
def _rexp(shape=(), seed=0, lambda_=1.0, **attrs):
    lam = float(attrs.get("lambda", lambda_))
    return lambda: torch.empty(tuple(shape)).exponential_(
        generator=_gen(seed)) / lam


@register_op("random_gamma")
def _rgamma(shape=(), seed=0, alpha=1.0, beta=1.0, **_):
    return lambda: torch._standard_gamma(
        torch.full(tuple(shape), float(alpha)), generator=_gen(seed)) / beta


@register_op("random_poisson")
def _rpoisson(shape=(), seed=0, lam=1.0, **_):
    return lambda: torch.poisson(torch.full(tuple(shape), float(lam)),
                                 generator=_gen(seed)).to(torch.float32)


@register_op("random_gumbel")
def _rgumbel(shape=(), seed=0, **_):
    def f():
        u = torch.rand(tuple(shape), generator=_gen(seed))
        return -torch.log(-torch.log(torch.clamp(
            u, min=torch.finfo(torch.float32).tiny)))
    return f


# ---------------------------------------------------------------------------
# YUV (reference: generic/images/rgb_to_yuv.cpp)
# ---------------------------------------------------------------------------
_YUV = np.array([[0.299, 0.587, 0.114],
                 [-0.14714119, -0.28886916, 0.43601035],
                 [0.61497538, -0.51496512, -0.10001026]], np.float32)


def _colour_matrix(m):
    def factory(**_):
        return lambda x: x @ torch.from_numpy(np.ascontiguousarray(m.T)).to(
            dtype=x.dtype, device=x.device)
    return factory


OP_IMPLS["rgbToYuv"] = _colour_matrix(_YUV)
OP_IMPLS["yuvToRgb"] = _colour_matrix(np.linalg.inv(_YUV).astype(np.float32))


# ---------------------------------------------------------------------------
# namespaces (reference: SDBitwise, and SDLinalg's decompositions)
# ---------------------------------------------------------------------------
class SDBitwise(_Namespace):
    """Reference: org/nd4j/autodiff/samediff/ops/SDBitwise.java."""

    def and_(self, x, y, name=None):
        return self.sd._op("bitwiseAnd", [x, y], name=name)

    def or_(self, x, y, name=None):
        return self.sd._op("bitwiseOr", [x, y], name=name)

    def xor(self, x, y, name=None):
        return self.sd._op("bitwiseXor", [x, y], name=name)

    def leftShift(self, x, s, name=None):
        return self.sd._op("leftShift", [x, s], name=name)

    def rightShift(self, x, s, name=None):
        return self.sd._op("rightShift", [x, s], name=name)

    def leftShiftCyclic(self, x, s, name=None):
        return self.sd._op("cyclicShiftLeft", [x, s], name=name)

    def rightShiftCyclic(self, x, s, name=None):
        return self.sd._op("cyclicShiftRight", [x, s], name=name)

    def bitsHammingDistance(self, x, y, name=None):
        return self.sd._op("bitsHammingDistance", [x, y], name=name)


def _sd_bitwise(self) -> SDBitwise:
    return SDBitwise(self)


SameDiff.bitwise = _sd_bitwise


def _linalg_svd(self, x, fullUV=False, computeUv=True, name=None):
    return self.sd._op("svd", [x], {"fullUV": fullUV,
                                    "computeUv": computeUv},
                       n_out=3 if computeUv else 1, name=name)


def _linalg_qr(self, x, fullMatrices=False, name=None):
    return self.sd._op("qr", [x], {"fullMatrices": fullMatrices},
                       n_out=2, name=name)


def _linalg_lu(self, x, name=None):
    return self.sd._op("lu", [x], n_out=2, name=name)


def _linalg_eig(self, x, name=None):
    return self.sd._op("selfAdjointEig", [x], n_out=2, name=name)


def _linalg_lstsq(self, a, b, l2Regularizer=0.0, fast=True, name=None):
    return self.sd._op("lstsq", [a, b],
                       {"l2Regularizer": l2Regularizer, "fast": fast},
                       name=name)


def _linalg_cross(self, a, b, name=None):
    return self.sd._op("cross", [a, b], name=name)


SDLinalg.svd = _linalg_svd
SDLinalg.qr = _linalg_qr
SDLinalg.lu = _linalg_lu
SDLinalg.eig = _linalg_eig
SDLinalg.lstsq = _linalg_lstsq
SDLinalg.cross = _linalg_cross

for _n in ["sinc", "erfinv", "toDegrees", "toRadians", "isMax", "median",
           "triu", "tril"]:
    setattr(SDMath, _n, _ns_unary(_n))
for _n in ["hypot", "copySign", "nextAfter", "fmod", "polygamma", "zeta",
           "kron", "outer"]:
    setattr(SDMath, _n, _ns_binary(_n))
for _n in ["crelu", "l2Normalize"]:
    setattr(SDNN, _n, _ns_unary(_n))
del _n
