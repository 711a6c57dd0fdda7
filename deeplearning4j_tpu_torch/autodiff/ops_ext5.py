"""Extended SameDiff ops, part 5: the port of the ops of
``deeplearning4j_tpu/autodiff/ops_ext5.py`` that the TF importer's rules
emit (TF's LSTM blocks, the tensor-scatter family, ``einsum``,
``searchsorted`` / ``bucketize``, shape utilities, ``imageResize``,
``diagPart`` and the ``multinomial`` alias), and those the ONNX importer's
rules emit (``instanceNorm``, ``groupNorm``, ``pnormPool2d``, ``splitV``).
The rest waits for ROADMAP A12b.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.ops_ext import (_jax_resize,
                                                       _nd_index)
from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, _simple,
                                                        register_op)


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
