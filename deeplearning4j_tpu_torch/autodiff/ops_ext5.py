"""Extended SameDiff ops, part 5: the port of
``deeplearning4j_tpu/autodiff/ops_ext5.py`` — the recurrent variants (SRU,
TF's block LSTM, the dynamic / static RNNs), normalization, the conv and
pool extras (``dilation2d``, ``maxPoolWithArgmax``), the tensor-scatter
family, ``einsum`` and the shape utilities, losses, random extras, image
extras, the dtype casts, the tensor-list ops, the t-SNE helpers, the CTC
greedy decoder and the reference's alias names.

The recurrences are loops over the time-major input under autograd (the
reference's ``lax.scan``).  The compaction ops (``choose``,
``ctcGreedyDecoder``, ``barnesSymmetrized``) keep the reference's bounded
shapes: the selected values front-packed, padded, with their count.
``printVariable`` and ``Assert`` copy their input to the host to print it,
as the reference's ``jax.debug.print`` does, and pass it through;
``Assert`` never raises (the reference's cannot, inside a compiled
program: ROADMAP C27).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.ops_ext import (_jax_resize,
                                                       _nd_index)
from deeplearning4j_tpu_torch.autodiff.ops_ext4 import _cond
from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, _abs,
                                                        _gen, _np, _simple,
                                                        _take,
                                                        _torch_dtype,
                                                        register_op)


# ---------------------------------------------------------------------------
# SRU (Lei et al. 2017; generic/nn/recurrent/sru*.cpp)
# ---------------------------------------------------------------------------
def _sru_step(xt, c, Wpack, b, nIn):
    """One SRU step: Wpack packs [W | Wf | Wr] (nIn, 3 nIn); b packs
    [bf | br] (2 nIn)."""
    z = xt @ Wpack
    xh, f_in, r_in = z[..., :nIn], z[..., nIn:2 * nIn], z[..., 2 * nIn:]
    f = torch.sigmoid(f_in + b[:nIn])
    r = torch.sigmoid(r_in + b[nIn:])
    c2 = f * c + (1.0 - f) * xh
    return r * torch.tanh(c2) + (1.0 - r) * xt, c2


@register_op("sruCell")
def _sru_cell(**_):
    return lambda xt, cLast, W, b: list(_sru_step(xt, cLast, W, b,
                                                  xt.shape[-1]))


def _sru_seq(x, W, b, c0, *mask):
    # x: (t, b, nIn) time-major; the carry in x's dtype
    c, hs, cs = c0.to(x.dtype), [], []
    for xt in x:
        h, c = _sru_step(xt, c, W, b, x.shape[-1])
        hs.append(h)
        cs.append(c)
    hs, cs = torch.stack(hs), torch.stack(cs)
    if mask:  # (t, b): padded steps' outputs are zero
        hs = hs * mask[0][..., None]
    return [hs, cs]


@register_op("sru")
def _sru(**_):
    return _sru_seq


@register_op("sruBI")
def _sru_bi(**_):
    def f(x, W, b, c0, *mask):
        # W: (nIn, 6 nIn) forward | backward halves; b: (4 nIn); c0 (2, b, n)
        n = x.shape[-1]
        fw = _sru_seq(x, W[:, :3 * n], b[:2 * n], c0[0], *mask)
        bwm = [torch.flip(mask[0], (0,))] if mask else []
        bw = _sru_seq(torch.flip(x, (0,)), W[:, 3 * n:], b[2 * n:], c0[1],
                      *bwm)
        return [torch.cat([fw[0], torch.flip(bw[0], (0,))], dim=-1),
                torch.cat([fw[1], torch.flip(bw[1], (0,))], dim=-1)]
    return f


# ---------------------------------------------------------------------------
# TF's block LSTM (generic/nn/recurrent/lstmBlock*.cpp)
# ---------------------------------------------------------------------------
def _lstm_block_gates(xt, h, c, W, Wci, Wcf, Wco, b, forgetBias, peephole):
    """TF BlockLSTMCell gate math: gates i, g, f, o from [x, h] @ W + b."""
    z = torch.cat([xt, h], dim=-1) @ W + b
    i_in, g_in, f_in, o_in = torch.chunk(z, 4, dim=-1)
    if peephole:
        i = torch.sigmoid(i_in + c * Wci)
        f = torch.sigmoid(f_in + forgetBias + c * Wcf)
    else:
        i = torch.sigmoid(i_in)
        f = torch.sigmoid(f_in + forgetBias)
    g = torch.tanh(g_in)
    c2 = f * c + i * g
    o = torch.sigmoid(o_in + (c2 * Wco if peephole else 0.0))
    h2 = o * torch.tanh(c2)
    return i, c2, f, o, g, h2


@register_op("lstmBlockCell")
def _lstm_block_cell(forgetBias=1.0, peephole=False, **_):
    def f(xt, cLast, hLast, W, Wci, Wcf, Wco, b):
        i, c2, fg, o, g, h2 = _lstm_block_gates(
            xt, hLast, cLast, W, Wci, Wcf, Wco, b, forgetBias, peephole)
        # reference output order: [i, c, f, o, z(g), h(cell out), y(h)]
        return [i, c2, fg, o, g, torch.tanh(c2), h2]
    return f


@register_op("lstmBlock")
def _lstm_block(forgetBias=1.0, peephole=False, **_):
    def f(x, cLast, hLast, W, Wci, Wcf, Wco, b):
        h, c = hLast.to(x.dtype), cLast.to(x.dtype)
        steps = []
        for xt in x:                    # time-major (t, b, nIn)
            i, c, fg, o, g, h = _lstm_block_gates(
                xt, h, c, W, Wci, Wcf, Wco, b, forgetBias, peephole)
            steps.append((i, c, fg, o, g, torch.tanh(c), h))
        return [torch.stack(s) for s in zip(*steps)]
    return f


def _rnn_seq(x, Wx, Wh, b, h0):
    h, hs = h0, []
    for xt in x:
        h = torch.tanh(xt @ Wx + h @ Wh + b)
        hs.append(h)
    return torch.stack(hs), h


@register_op("dynamicRnn")
def _dynamic_rnn(**_):
    return lambda x, Wx, Wh, b, h0: list(_rnn_seq(x, Wx, Wh, b, h0))


@register_op("dynamicBidirectionalRnn")
def _dynamic_bi_rnn(**_):
    def f(x, WxF, WhF, bF, h0F, WxB, WhB, bB, h0B):
        hsF, hTF = _rnn_seq(x, WxF, WhF, bF, h0F)
        hsB, hTB = _rnn_seq(torch.flip(x, (0,)), WxB, WhB, bB, h0B)
        return [hsF, torch.flip(hsB, (0,)), hTF, hTB]
    return f


# the reference's "static" variants unroll at graph build; both forms are
# the same loop here
OP_IMPLS["staticRnn"] = OP_IMPLS["dynamicRnn"]
OP_IMPLS["staticBidirectionalRnn"] = OP_IMPLS["dynamicBidirectionalRnn"]


# ---------------------------------------------------------------------------
# the tensor-scatter family: add/sub/update share the scatterNd* lowerings
# ---------------------------------------------------------------------------
def _tensor_scatter(how):
    def factory(**_):
        def f(x, indices, updates):
            idx = indices.long()
            k = idx.shape[-1]
            lead = x.shape[:k]
            lin = torch.zeros(idx.shape[:-1], dtype=torch.long,
                              device=x.device)
            for d in range(k):
                lin = lin * lead[d] + idx[..., d]
            flat = x.reshape((-1,) + tuple(x.shape[k:]))
            upd = updates.reshape((-1,) + tuple(x.shape[k:]))
            return flat.index_reduce(0, lin.reshape(-1), upd, how,
                                     include_self=True).reshape(x.shape)
        return f
    return factory


OP_IMPLS["tensorScatterAdd"] = OP_IMPLS["scatterNdAdd"]
OP_IMPLS["tensorScatterSub"] = OP_IMPLS["scatterNdSub"]
OP_IMPLS["tensorScatterUpdate"] = OP_IMPLS["scatterNdUpdate"]
OP_IMPLS["tensorScatterMax"] = _tensor_scatter("amax")
OP_IMPLS["tensorScatterMin"] = _tensor_scatter("amin")


# ---------------------------------------------------------------------------
# einsum / searchsorted / bucketize / shape utilities
# ---------------------------------------------------------------------------
@register_op("einsum")
def _einsum(equation="", **_):
    return lambda *xs: torch.einsum(equation, *xs)


@register_op("searchsorted")
def _searchsorted(right=False, **_):
    def f(sorted_seq, values):
        if sorted_seq.dim() > 1:
            sorted_seq = sorted_seq.contiguous()
            values = values.contiguous()
        return torch.searchsorted(sorted_seq, values, right=bool(right)).to(
            torch.int32)
    return f


@register_op("bucketize")
def _bucketize(boundaries=(), **_):
    bs = tuple(float(b) for b in boundaries)

    def f(x):
        out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        for b in bs:  # static, small
            out = out + (x >= b).to(torch.int32)
        return out
    return f


@register_op("unravelIndex")
def _unravel_index(**_):
    def f(indices, shape):
        dims = [int(s) for s in shape.reshape(-1).tolist()]
        idx = indices.long()
        out = []
        for d in reversed(dims):
            out.append(torch.remainder(idx, d))
            idx = torch.div(idx, d, rounding_mode="floor")
        return torch.stack(out[::-1], dim=-1).to(torch.int32)
    return f


@register_op("sparseToDense")
def _sparse_to_dense(defaultValue=0.0, **_):
    def f(indices, shape, values):
        dims = tuple(int(s) for s in shape.reshape(-1).tolist())
        out = torch.full(dims, defaultValue, dtype=values.dtype,
                         device=values.device)
        return out.index_put(_nd_index(indices), values)
    return f


@register_op("broadcastDynamicShape")
def _broadcast_dynamic_shape(**_):
    def f(a, b):
        n = max(a.shape[0], b.shape[0])
        pa = torch.cat([a.new_ones(n - a.shape[0]), a])
        pb = torch.cat([b.new_ones(n - b.shape[0]), b])
        return torch.where(pa == 1, pb, pa)
    return f


@register_op("shapeN")
def _shape_n(**_):
    return lambda *xs: [torch.tensor(list(x.shape), dtype=torch.int64,
                                     device=x.device) for x in xs]


_simple("truncateDiv", lambda x, y: torch.trunc(x / y))
_simple("diagPart", lambda x: torch.diagonal(x, dim1=-2, dim2=-1))


@register_op("imageResize")
def _image_resize(height=0, width=0, method="bilinear", **_):
    table = {"bilinear": "linear", "bicubic": "cubic", "nearest": "nearest",
             "lanczos3": "lanczos3", "lanczos5": "lanczos5"}

    def f(x):
        h, w = int(height), int(width)
        if str(method) == "area":
            # true area averaging for integer downsample factors (TF's area
            # kernel); other ratios fall back to linear, which only
            # approximates area weighting
            ih, iw = x.shape[1], x.shape[2]
            if ih % h == 0 and iw % w == 0 and ih >= h and iw >= w:
                fh, fw = ih // h, iw // w
                s = torch.nn.functional.avg_pool2d(
                    x.permute(0, 3, 1, 2), (fh, fw), (fh, fw))
                return s.permute(0, 2, 3, 1)
            return _jax_resize(x, h, w, "linear")
        return _jax_resize(x, h, w, table[str(method)])
    return f


OP_IMPLS["multinomial"] = OP_IMPLS["random_multinomial"]


# ---------------------------------------------------------------------------
# the ops the ONNX importer's rules emit (InstanceNormalization,
# GroupNormalization, LpPool, Split with sizes)
# ---------------------------------------------------------------------------
@register_op("instanceNorm")
def _instance_norm(epsilon=1e-5, **_):
    def f(x, gamma, beta):
        # x: (b, c, *spatial) — normalize each (b, c) over spatial dims
        ax = tuple(range(2, x.dim()))
        mu = torch.mean(x, dim=ax, keepdim=True)
        var = torch.var(x, dim=ax, correction=0, keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mu) * torch.rsqrt(var + epsilon)
                * gamma.reshape(shape) + beta.reshape(shape))
    return f


@register_op("groupNorm")
def _group_norm(numGroups=2, epsilon=1e-5, **_):
    def f(x, gamma, beta):
        b, c = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        g = x.reshape((b, numGroups, c // numGroups) + spatial)
        ax = tuple(range(2, g.dim()))
        mu = torch.mean(g, dim=ax, keepdim=True)
        var = torch.var(g, dim=ax, correction=0, keepdim=True)
        g = (g - mu) * torch.rsqrt(var + epsilon)
        shape = (1, -1) + (1,) * len(spatial)
        return g.reshape(x.shape) * gamma.reshape(shape) + beta.reshape(shape)
    return f


@register_op("pnormPool2d")
def _pnorm_pool2d(kH=2, kW=2, sH=2, sW=2, pnorm=2, **_):
    def f(x):
        # x: (b, c, h, w) NCHW (DL4J PnormLayer convention); the window's
        # sum of |x|^p (an average pool that divides by 1), VALID
        p = float(pnorm)
        s = F.avg_pool2d(torch.abs(x) ** p, (int(kH), int(kW)),
                         (int(sH), int(sW)), divisor_override=1)
        return s ** (1.0 / p)
    return f


@register_op("splitV")
def _split_v(sizes=(), axis=0, **_):
    sz = [int(s) for s in sizes]
    return lambda x: list(torch.split(x, sz, dim=int(axis)))


# ---------------------------------------------------------------------------
# normalization (torch-style renorm; generic/nn/fusedBatchNorm.cpp)
# ---------------------------------------------------------------------------
@register_op("renorm")
def _renorm(p=2.0, dim=0, maxnorm=1.0, **_):
    def f(x):
        ax = tuple(i for i in range(x.dim()) if i != dim)
        n = torch.sum(_abs(x) ** p, dim=ax, keepdim=True) ** (1.0 / p)
        scale = torch.where(n > maxnorm,
                            maxnorm / torch.clamp(n, min=1e-12), 1.0)
        return x * scale
    return f


@register_op("fusedBatchNorm")
def _fused_batch_norm(epsilon=1e-3, dataFormat="NHWC", isTraining=True, **_):
    def f(x, scale, offset, *running):
        cax = 3 if dataFormat == "NHWC" else 1
        ax = tuple(i for i in range(x.dim()) if i != cax)
        if isTraining or not running:
            mu = torch.mean(x, dim=ax)
            var = torch.var(x, dim=ax, correction=0)
        else:
            mu, var = running
        shape = tuple(-1 if i == cax else 1 for i in range(x.dim()))
        y = ((x - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)
             * scale.reshape(shape) + offset.reshape(shape))
        return [y, mu, var]
    return f


# ---------------------------------------------------------------------------
# conv / pool extras (NHWC): the kernel's taps unrolled, each a strided
# slice, as the reference's
# ---------------------------------------------------------------------------
def _same_nhwc(x, eh, ew, sh, sw, value):
    oh, ow = -(-x.shape[1] // sh), -(-x.shape[2] // sw)
    ph = max((oh - 1) * sh + eh - x.shape[1], 0)
    pw = max((ow - 1) * sw + ew - x.shape[2], 0)
    pt, pl = ph // 2, pw // 2
    return F.pad(x, (0, 0, pl, pw - pl, pt, ph - pt), value=value), oh, ow, \
        pt, pl


@register_op("dilation2d")
def _dilation2d(strides=(1, 1), rates=(1, 1), isSameMode=True, **_):
    sh, sw = (strides[1], strides[2]) if len(strides) == 4 else strides
    rh, rw = (rates[1], rates[2]) if len(rates) == 4 else rates

    def f(x, w):
        # x (b, h, w, c), w (kh, kw, c): out = max over taps of patch + w
        kh, kw, _ = w.shape
        eh, ew = (kh - 1) * rh + 1, (kw - 1) * rw + 1
        if isSameMode:
            x, oh, ow, _, _ = _same_nhwc(x, eh, ew, sh, sw, -math.inf)
        else:
            oh = (x.shape[1] - eh) // sh + 1
            ow = (x.shape[2] - ew) // sw + 1
        out = None
        for i in range(kh):
            for j in range(kw):
                tap = x[:, i * rh:i * rh + (oh - 1) * sh + 1:sh,
                        j * rw:j * rw + (ow - 1) * sw + 1:sw, :] + w[i, j]
                out = tap if out is None else torch.maximum(out, tap)
        return out
    return f


@register_op("maxPoolWithArgmax")
def _max_pool_with_argmax(kH=2, kW=2, sH=2, sW=2, isSameMode=False, **_):
    def f(x):
        # x (b, h, w, c); the argmax is TF's flattened (y * w + x) * c + ch
        # of the unpadded input, the first tap on a tie
        b, h, w, c = x.shape
        if isSameMode:
            xp, oh, ow, pt, pl = _same_nhwc(x, kH, kW, sH, sW, -math.inf)
        else:
            oh, ow = (h - kH) // sH + 1, (w - kW) // sW + 1
            xp, pt, pl = x, 0, 0
        best = best_tap = None
        for i in range(kH):
            for j in range(kW):
                tap = xp[:, i:i + (oh - 1) * sH + 1:sH,
                         j:j + (ow - 1) * sW + 1:sW, :]
                tid = i * kW + j
                if best is None:
                    best = tap
                    best_tap = torch.full(tap.shape, tid, dtype=torch.int64,
                                          device=x.device)
                else:
                    take = tap > best
                    best = torch.where(take, tap, best)
                    best_tap = torch.where(take, tid, best_tap)
        dev = x.device
        rows = (torch.arange(oh, device=dev)[None, :, None, None] * sH - pt) \
            + best_tap // kW
        cols = (torch.arange(ow, device=dev)[None, None, :, None] * sW - pl) \
            + best_tap % kW
        chan = torch.arange(c, device=dev)[None, None, None, :]
        return [best, (rows * w + cols) * c + chan]
    return f


@register_op("pointwiseConv2d")
def _pointwise_conv2d(**_):
    def f(x, w, *b):
        # x (b, h, w, cIn), w (1, 1, cIn, cOut) or (cIn, cOut)
        y = x @ w.reshape(w.shape[-2], w.shape[-1])
        return y + b[0] if b else y
    return f


# ---------------------------------------------------------------------------
# shape utilities
# ---------------------------------------------------------------------------
@register_op("reshapeAs")
def _reshape_as(**_):
    return lambda x, y: x.reshape(y.shape)


_simple("parallelStack", lambda *xs: torch.stack(xs, dim=0))


@register_op("tear")
def _tear(dimension=0, **_):
    return lambda x: list(torch.unbind(x, dim=int(dimension)))


@register_op("choose")
def _choose(mode="GT", scalar=0.0, **_):
    c = _cond(mode, scalar)

    def f(x):
        flat = x.reshape(-1)
        keep = c(flat)
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        n = torch.sum(keep)
        packed = torch.where(torch.arange(flat.numel(), device=x.device) < n,
                             flat[order], torch.zeros_like(flat))
        return [packed, n.to(torch.int64)]
    return f


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@register_op("meanPairwiseSquaredError")
def _mpse(**_):
    def f(predictions, labels, *w):
        # TF's mean_pairwise_squared_error per sample over its elements:
        # sum_ij (d_i - d_j)^2 = 2n sum d^2 - 2 (sum d)^2, over n(n - 1)
        d = (predictions - labels).reshape(predictions.shape[0], -1)
        n = d.shape[1]
        per = 2.0 * (n * torch.sum(d * d, -1) - torch.sum(d, -1) ** 2) \
            / max(n * (n - 1), 1)
        if w:
            ww = w[0].reshape(-1)
            return torch.sum(per * ww) / torch.clamp(
                torch.sum((ww != 0).to(per.dtype)), min=1.0)
        return torch.mean(per)
    return f


@register_op("logPoissonLoss")
def _log_poisson(full=False, **_):
    def f(logPredictions, labels, *w):
        per = torch.exp(logPredictions) - labels * logPredictions
        if full:  # Stirling's log(t!), 0 for t in [0, 1] (TF's convention)
            stirling = (labels * torch.log(torch.clamp(labels, min=1e-8))
                        - labels + 0.5 * torch.log(
                            2.0 * math.pi * torch.clamp(labels, min=1.0)))
            per = per + torch.where((labels >= 0) & (labels <= 1), 0.0,
                                    stirling)
        if w:
            per = per * w[0]
        return torch.mean(per)
    return f


# ---------------------------------------------------------------------------
# random extras (seeded per node; torch's bits)
# ---------------------------------------------------------------------------
@register_op("randomCrop")
def _random_crop(shape=(), seed=0, **_):
    tgt = tuple(int(s) for s in shape)

    def f(x):
        # the offsets are drawn on the host: slicing needs them as ints,
        # and a draw on the card would wait for it
        gen = _gen(seed, "cpu")
        starts = [int(torch.randint(0, full - want + 1, (), generator=gen))
                  for full, want in zip(x.shape, tgt)]
        return x[tuple(slice(s, s + t) for s, t in zip(starts, tgt))]
    return f


@register_op("alphaDropout")
def _alpha_dropout(p=0.05, seed=0, **_):
    # SELU-consistent dropout (Klambauer et al.): a dropped unit goes to
    # alpha' = -lambda alpha, and an affine correction keeps the moments
    alpha_p = -1.7580993408473766

    def f(x):
        keep = 1.0 - p
        mask = torch.rand(x.shape, generator=_gen(seed, x.device),
                          device=x.device) < keep
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        return a * torch.where(mask, x, alpha_p) + b
    return f


@register_op("randomBinomial")
def _random_binomial(trials=1, prob=0.5, shape=(), seed=0, **_):
    return lambda: torch.binomial(
        torch.full(tuple(shape), float(trials)),
        torch.full(tuple(shape), float(prob)),
        generator=_gen(seed)).to(torch.float32)


# ---------------------------------------------------------------------------
# image extras
# ---------------------------------------------------------------------------
_YIQ = np.array([[0.299, 0.587, 0.114],
                 [0.5959, -0.2746, -0.3213],
                 [0.2115, -0.5227, 0.3112]], np.float32)


def _matmul_const(m):
    def f(x):
        return x @ torch.from_numpy(np.ascontiguousarray(m)).to(
            dtype=x.dtype, device=x.device)
    return f


_simple("rgbToYiq", _matmul_const(_YIQ.T))
_simple("yiqToRgb", _matmul_const(np.linalg.inv(_YIQ).T.astype(np.float32)))


@register_op("drawBoundingBoxes")
def _draw_bounding_boxes(**_):
    def f(images, boxes, colors):
        # images (b, h, w, c); boxes (b, n, 4) [ymin, xmin, ymax, xmax]
        # normalized; colors (m, c); each box's border drawn in turn
        b, h, w, c = images.shape
        dev = images.device
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] \
            / max(h - 1, 1)
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] \
            / max(w - 1, 1)
        t, tx = 1.5 / max(h - 1, 1), 1.5 / max(w - 1, 1)
        out = images
        for i in range(boxes.shape[1]):
            y0, x0, y1, x1 = (boxes[:, i, k][:, None, None] for k in range(4))
            inside = (ys >= y0) & (ys <= y1) & (xs >= x0) & (xs <= x1)
            interior = ((ys >= y0 + t) & (ys <= y1 - t) & (xs >= x0 + tx)
                        & (xs <= x1 - tx))
            border = (inside & ~interior)[..., None]
            color = colors[i % colors.shape[0]].reshape(1, 1, 1, c)
            out = torch.where(border, color.to(out.dtype), out)
        return out
    return f


@register_op("nonMaxSuppressionOverlaps")
def _nms_overlaps(maxOutputSize=10, overlapThreshold=0.5,
                  scoreThreshold=-math.inf, **_):
    def f(overlaps, scores):
        n = scores.shape[0]
        ar = torch.arange(n, device=scores.device)
        banned = ~(scores > scoreThreshold)
        picks = []
        for _i in range(int(maxOutputSize)):
            masked = torch.where(banned, -math.inf, scores)
            best = torch.argmax(masked)
            ok = masked[best] > -math.inf
            banned = banned | (overlaps[best] > overlapThreshold) \
                | (ar == best)
            picks.append(torch.where(ok, best, -1))
        return torch.stack(picks).to(torch.int32)
    return f


def _fake_quant(x, mn, mx, numBits, narrowRange):
    qmin = 1.0 if narrowRange else 0.0
    qmax = float(2 ** numBits - 1)
    scale = (mx - mn) / (qmax - qmin)
    nudged_zero = torch.clamp(torch.round(qmin - mn / scale), qmin, qmax)
    nudged_min = (qmin - nudged_zero) * scale
    nudged_max = (qmax - nudged_zero) * scale
    clamped = torch.minimum(torch.maximum(x, nudged_min), nudged_max)
    return torch.round((clamped - nudged_min) / scale) * scale + nudged_min


@register_op("fakeQuantWithMinMaxVars")
def _fake_quant_op(numBits=8, narrowRange=False, **_):
    return lambda x, mn, mx: _fake_quant(x, mn, mx, numBits, narrowRange)


@register_op("fakeQuantWithMinMaxVarsPerChannel")
def _fake_quant_pc(numBits=8, narrowRange=False, **_):
    # min / max per last-axis channel, broadcast against x
    return lambda x, mn, mx: _fake_quant(x, mn, mx, numBits, narrowRange)


# ---------------------------------------------------------------------------
# math / linalg extras
# ---------------------------------------------------------------------------
@register_op("axpy")
def _axpy(alpha=1.0, **_):
    return lambda x, y: alpha * x + y


@register_op("norm")
def _norm_op(p=2.0, dims=None, **_):
    ax = tuple(dims) if dims is not None else None

    def f(x):
        a = _abs(x)
        if p == math.inf:
            return torch.amax(a, dim=ax if ax is not None else ())
        if p == 1.0:
            return torch.sum(a, dim=ax)
        return torch.sum(a ** p, dim=ax) ** (1.0 / p)
    return f


@register_op("bitcast")
def _bitcast(dtype="int32", **_):
    dt = _torch_dtype(dtype)

    def f(x):
        # lax.bitcast_convert_type: a narrower type adds a trailing axis
        # of (old size / new size), a wider one consumes the trailing axis
        # of (new size / old size); Tensor.view(dtype) resizes the last
        # axis instead
        src, dst = x.element_size(), torch.empty((), dtype=dt).element_size()
        x = x.contiguous()
        if src == dst:
            return x.view(dt)
        if dst < src:
            return x.reshape(x.shape + (1,)).view(dt)
        return x.view(dt).squeeze(-1)
    return f


@register_op("stabilize")
def _stabilize(realMin=1e-5, **_):
    return lambda x: torch.where(_abs(x) < realMin, torch.sign(x) * realMin
                                 + (x == 0) * realMin, x)


_M64 = (1 << 64) - 1


def _pow31(n: int) -> torch.Tensor:
    """31^(n-1), ..., 31^0 mod 2^64 as int64 (two's complement), computed on
    the host in exact integers once per size."""
    p, out = 1, []
    for _i in range(n):
        out.append(p)
        p = (p * 31) & _M64
    out.reverse()
    arr = np.array(out, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(arr)


@register_op("hashCode")
def _hash_code(**_):
    def f(x):
        # Java Arrays.hashCode's polynomial h = 31 h + v from h = 1 over the
        # exact bit pattern (floats bitcast to int32 / int64), in int64 with
        # wraparound: 31^n + sum v_i 31^(n-1-i), one product and one sum on
        # the device, not a loop over the elements
        if x.is_floating_point():
            x = x.contiguous().view(torch.int32 if x.element_size() <= 4
                                    else torch.int64)
        v = x.reshape(-1).long()
        n = v.numel()
        p = _pow31(n + 1)                     # 31^n, ..., 31^0
        return p[0].to(v.device) + torch.sum(v * p[1:].to(v.device))
    return f


@register_op("biasAdd")
def _bias_add(nchw=False, **_):
    def f(x, b):
        if nchw:
            return x + b.reshape((1, -1) + (1,) * (x.dim() - 2))
        return x + b
    return f


@register_op("xwPlusB")
def _xw_plus_b(transposeW=False, **_):
    return lambda x, w, b: x @ (w.mT if transposeW else w) + b


# ---------------------------------------------------------------------------
# debug ops: each copies its input to the host to print it (the reference's
# jax.debug.print does the same) and passes it through
# ---------------------------------------------------------------------------
@register_op("printVariable")
def _print_variable(message="", **_):
    def f(x):
        print(f"{message}{_np(x)}")
        return x
    return f


@register_op("Assert")
def _assert_op(message="assertion failed", **_):
    def f(cond):
        # never raises: the reference's cannot inside a compiled program,
        # and reports through a debug print instead (ROADMAP C27)
        print(f"Assert: {bool(torch.all(cond != 0))} ({message})")
        return cond
    return f


# ---------------------------------------------------------------------------
# dtype casts (the reference registers each as its own declarable).  torch's
# uint32 / uint64 take few ops beyond the cast itself.
# ---------------------------------------------------------------------------
for _name, _dt in [("toDouble", torch.float64), ("toFloat16", torch.float16),
                   ("toFloat32", torch.float32), ("toInt32", torch.int32),
                   ("toInt64", torch.int64), ("toUint32", torch.uint32),
                   ("toUint64", torch.uint64)]:
    _simple(_name, (lambda dt: lambda x: x.to(dt))(_dt))


# ---------------------------------------------------------------------------
# tensor-list (TensorArray) ops: a list is a stacked leading axis, as in
# the reference
# ---------------------------------------------------------------------------
_simple("stackList", lambda x: x)
_simple("cloneList", lambda x: x)


@register_op("unstackList")
def _unstack_list(**_):
    return lambda x: list(torch.unbind(x, dim=0))


@register_op("readList")
def _read_list(index=0, **_):
    return lambda x: x[int(index)]


@register_op("writeList")
def _write_list(index=0, **_):
    def f(x, v):
        idx = torch.tensor([int(index)], device=x.device)
        return x.index_put((idx,), v.to(x.dtype).unsqueeze(0))
    return f


@register_op("gatherList")
def _gather_list(**_):
    return lambda x, idx: _take(x, idx, 0)


@register_op("scatterList")
def _scatter_list(**_):
    def f(indices, values, shape0):
        # the list's length is static metadata in the reference (read with
        # np.asarray at trace time); here one scalar read
        n = int(shape0)
        out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                          device=values.device)
        return out.index_put((indices.long(),), values)
    return f


@register_op("sizeList")
def _size_list(**_):
    return lambda x: torch.tensor(x.shape[0], dtype=torch.int64,
                                  device=x.device)


@register_op("splitList")
def _split_list(sizes=(), **_):
    sz = [int(s) for s in sizes]
    return lambda x: list(torch.split(x[:sum(sz)], sz, dim=0))


# ---------------------------------------------------------------------------
# t-SNE helpers (reference: generic/parity_ops/barnes_*.cpp, knn_mindistance,
# cell_contains — deeplearning4j-nearestneighbors' BarnesHutTsne)
# ---------------------------------------------------------------------------
@register_op("barnesGains")
def _barnes_gains(**_):
    def f(gains, gradient, yIncs):
        same = torch.sign(gradient) == torch.sign(yIncs)
        return torch.clamp(torch.where(same, gains * 0.8, gains + 0.2),
                           min=0.01)
    return f


def _csr_rows(rowP, nnz):
    return torch.searchsorted(rowP.to(torch.int32).contiguous(),
                              torch.arange(nnz, dtype=torch.int32,
                                           device=rowP.device),
                              right=True).long() - 1


@register_op("barnesEdgeForces")
def _barnes_edge_forces(**_):
    def f(rowP, colP, valP, y):
        # CSR edges: rowP offsets (n + 1,), colP targets (nnz,), valP (nnz,)
        rows = _csr_rows(rowP, colP.shape[0])
        diff = y[rows] - y[colP.long()]
        q = valP / (1.0 + torch.sum(diff * diff, dim=-1))
        return torch.zeros_like(y).index_add(0, rows, q[:, None] * diff)
    return f


@register_op("barnesSymmetrized")
def _barnes_symmetrized(**_):
    def f(rowP, colP, valP):
        # P_sym = (P + P^T) / 2 re-extracted row-major, front-packed to the
        # 2 nnz bound with its count
        n, nnz = rowP.shape[0] - 1, colP.shape[0]
        rows = _csr_rows(rowP, nnz)
        dense = torch.zeros((n, n), dtype=valP.dtype, device=valP.device)
        dense = dense.index_put((rows, colP.long()), valP, accumulate=True)
        flat = ((dense + dense.T) * 0.5).reshape(-1)
        keep = flat != 0
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        bound = min(2 * nnz, n * n)
        idx = order[:bound]
        count = torch.sum(keep).to(torch.int64)
        valid = torch.arange(bound, device=flat.device) < count
        return [torch.where(valid, idx // n, 0).to(torch.int32),
                torch.where(valid, idx % n, 0).to(torch.int32),
                torch.where(valid, flat[idx], 0.0), count]
    return f


@register_op("knnMindistance")
def _knn_mindistance(**_):
    def f(point, lowest, highest):
        d = point - torch.minimum(torch.maximum(point, lowest), highest)
        return torch.sqrt(torch.sum(d * d))
    return f


@register_op("cellContains")
def _cell_contains(**_):
    return lambda corner, width, point: torch.all(
        _abs(point - corner) <= width * 0.5)


# ---------------------------------------------------------------------------
# CTC greedy decoder: the argmax path with blanks (and, with mergeRepeated,
# repeats) dropped, front-packed and padded with -1, and each length
# ---------------------------------------------------------------------------
@register_op("ctcGreedyDecoder")
def _ctc_greedy(blankIndex=0, mergeRepeated=True, **_):
    def f(logits):
        path = torch.argmax(logits, dim=-1)                    # (b, t)
        keep = path != blankIndex
        if mergeRepeated:
            prev = torch.cat([torch.full_like(path[:, :1], -1),
                              path[:, :-1]], dim=1)
            keep = keep & (path != prev)
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        packed = torch.gather(path, 1, order)
        counts = torch.sum(keep, dim=1)
        t = path.shape[1]
        packed = torch.where(torch.arange(t, device=path.device)[None, :]
                             < counts[:, None], packed, -1)
        return [packed.to(torch.int32), counts.to(torch.int32)]
    return f


@register_op("create")
def _create(shape=(), dtype="float32", initValue=0.0, **_):
    return lambda: torch.full(tuple(int(s) for s in shape), initValue,
                              dtype=_torch_dtype(dtype))


_simple("noOp", lambda *xs: xs[0] if xs else torch.zeros(()))


# ---------------------------------------------------------------------------
# the reference's alias names (its alternate-name op classes) share
# lowerings
# ---------------------------------------------------------------------------
for _alias, _base in [
    ("randomGamma", "random_gamma"), ("randomPoisson", "random_poisson"),
    ("randomExponential", "random_exponential"),
    ("randomShuffle", "random_shuffle"),
    ("weightedCrossEntropy", "weightedCrossEntropyWithLogits"),
    ("matmul", "mmul"), ("tensordot", "tensorMmul"),
    ("minimum", "min_pairwise"), ("maximum", "max_pairwise"),
    ("lrelu", "leakyRelu"), ("realDiv", "div"), ("mergeSum", "mergeAdd"),
    ("adjustContrastV2", "adjustContrast"),
    ("subtract", "sub"), ("multiply", "mul"), ("divide", "div"),
    ("onesAs", "onesLike"), ("zerosAs", "zerosLike"),
]:
    OP_IMPLS[_alias] = OP_IMPLS[_base]
