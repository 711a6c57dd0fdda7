"""Extended SameDiff ops, part 2: the port of the ops of
``deeplearning4j_tpu/autodiff/ops_ext2.py`` that the TF and ONNX
importers' rules emit (math stragglers, bitwise, fft, decompositions, the
bounded dynamic ops, histogram, LRN, random, colour spaces, non-max
suppression; ``l2Normalize``, ``triu``, ``tril`` and ``deconv2d`` for
ONNX).

Only those ops come over; the rest waits for ROADMAP A12b.  The bounded
dynamic ops keep the reference's static-shape convention: outputs are
padded to the input's size with 0 (data) or -1 (indices).  One op departs
from the reference on purpose: ``unique`` keeps first-occurrence order, as
TF's ``Unique`` and libnd4j's ``unique`` do, where ``jnp.unique`` sorts
(ROADMAP C10).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, SDMath,
                                                        _gen, _ns_unary,
                                                        _simple, register_op)
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
        perm = torch.randperm(x.shape[0], generator=_gen(seed))
        return torch.index_select(x, 0, perm.to(x.device))
    return f


@register_op("random_multinomial")
def _rmultinomial(numSamples=1, seed=0, **_):
    def f(logits):
        p = torch.softmax(logits.double(), dim=-1).cpu()
        draws = torch.multinomial(p, int(numSamples), replacement=True,
                                  generator=_gen(seed))
        return draws.to(torch.int32).to(logits.device)  # (batch, samples)
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
