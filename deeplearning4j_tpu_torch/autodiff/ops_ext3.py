"""Extended SameDiff ops, part 3: the port of
``deeplearning4j_tpu/autodiff/ops_ext3.py`` — the updater ops (the
reference's libnd4j ``generic/updaters/*.cpp`` expose each optimizer as a
declarable op), each wrapping the port's ``learning.config`` updater so
graph-side and model-side updater arithmetic are one implementation, and
the stragglers: ``xlogy`` / ``xdivy``, 1-D pooling, ``deconv3d``, N-d
space/batch, ``nthElement``, ``clipByGlobalNorm``,
``sufficientStatistics``, ``logMatrixDeterminant`` and ``resizeArea``."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.ops_ext import _jax_resize
from deeplearning4j_tpu_torch.autodiff.ops_ext2 import _pad_same
from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, _axes,
                                                        _simple, register_op)
from deeplearning4j_tpu_torch.nn.conf.convolutional import _transposed_conv


# ---------------------------------------------------------------------------
# updater ops: (param, grad, *state) -> [updated param, *new state], the
# state in the order of ``state_keys`` (learning.config's layout)
# ---------------------------------------------------------------------------
def _updater_op(name, updater_cls, state_keys):
    def factory(lr=None, iteration=0, **attrs):
        known = {f.name for f in dataclasses.fields(updater_cls)}
        up = updater_cls(**{k: v for k, v in attrs.items() if k in known})
        step_lr = lr if lr is not None else up.learningRate

        def f(param, grad, *state_vals):
            state = dict(zip(state_keys, state_vals))
            upd, new_state = up.apply(grad, state, step_lr, int(iteration),
                                      0, param=param)
            return [param - upd] + [new_state[k] for k in state_keys]
        return f
    OP_IMPLS[name] = factory


def _register_updater_ops():
    from deeplearning4j_tpu_torch.learning.config import (AMSGrad, AdaDelta,
                                                          AdaGrad, AdaMax,
                                                          Adam, Nadam,
                                                          Nesterovs, RmsProp,
                                                          Sgd)
    _updater_op("sgdUpdater", Sgd, [])
    _updater_op("adamUpdater", Adam, ["m", "v"])
    _updater_op("adaMaxUpdater", AdaMax, ["m", "v"])
    _updater_op("nadamUpdater", Nadam, ["m", "v"])
    _updater_op("amsGradUpdater", AMSGrad, ["m", "v", "vHat"])
    _updater_op("adaGradUpdater", AdaGrad, ["h"])
    _updater_op("adaDeltaUpdater", AdaDelta, ["msg", "msdx"])
    _updater_op("rmsPropUpdater", RmsProp, ["g"])
    _updater_op("nesterovsUpdater", Nesterovs, ["v"])


_register_updater_ops()


# ---------------------------------------------------------------------------
# elementwise stragglers
# ---------------------------------------------------------------------------
def _where_x_zero(x, y, fn):
    safe = torch.where(x == 0, torch.ones_like(y), y)
    return torch.where(x == 0, torch.zeros_like(x * safe), fn(x, safe))


_simple("xlogy", lambda x, y: _where_x_zero(x, y,
                                            lambda a, b: a * torch.log(b)))
_simple("xdivy", lambda x, y: _where_x_zero(x, y, lambda a, b: a / b))
OP_IMPLS["floorMod"] = OP_IMPLS["mod"]


@register_op("nthElement")
def _nth_element(n=0, reverse=False, **_):
    def f(x):
        k = x.shape[-1] - 1 - int(n) if reverse else int(n)
        return torch.sort(x, dim=-1).values[..., k]
    return f


@register_op("clipByGlobalNorm")
def _clip_global_norm(clipNorm=1.0, **_):
    def f(*tensors):
        gnorm = torch.sqrt(sum(torch.sum(t.double() ** 2) for t in tensors))
        scale = torch.clamp(clipNorm / torch.clamp(gnorm, min=1e-12), max=1.0)
        out = [t * scale.to(t.dtype) for t in tensors]
        return out if len(out) > 1 else out[0]
    return f


@register_op("sufficientStatistics")
def _suff_stats(dims=None, **_):
    def f(x):
        ax = _axes(x, dims)
        cnt = torch.tensor(float(np.prod([x.shape[a] for a in ax])),
                           dtype=x.dtype, device=x.device)
        return [cnt, torch.sum(x, dim=ax), torch.sum(x * x, dim=ax)]
    return f


@register_op("logMatrixDeterminant")
def _log_det(**_):
    return lambda x: list(torch.linalg.slogdet(x))


# ---------------------------------------------------------------------------
# 1-D pooling, deconv3d, N-d space/batch, resizeArea
# ---------------------------------------------------------------------------
def _pool1d(kind):
    def factory(k=2, s=None, isSameMode=False, **_):
        kk, ss = int(k), int(s or k)

        def f(x):   # (b, c, t)
            if kind == "max":
                if isSameMode:
                    x = _pad_same(x, (kk,), (ss,), -math.inf)
                return F.max_pool1d(x, kk, ss)
            if not isSameMode:
                return F.avg_pool1d(x, kk, ss)
            ones = torch.ones_like(x[:1, :1])
            return F.avg_pool1d(_pad_same(x, (kk,), (ss,)), kk, ss) \
                / F.avg_pool1d(_pad_same(ones, (kk,), (ss,)), kk, ss)
        return f
    OP_IMPLS[f"{kind}Pooling1d"] = factory


_pool1d("max")
_pool1d("avg")


@register_op("deconv3d")
def _deconv3d(sD=1, sH=1, sW=1, isSameMode=False, **_):
    st = (int(sD), int(sH), int(sW))

    def f(x, w, *bias):   # x (b, c, d, h, w); w (o, i, kd, kh, kw)
        ks = w.shape[2:]
        if isSameMode:
            pads = []
            for n, kk, ss in zip(x.shape[2:], ks, st):
                tot = (n - 1) * ss + kk - n * ss
                pads.append(((kk - 1) - tot // 2 - tot % 2,
                             (kk - 1) - tot // 2))
        else:
            pads = [(kk - 1, kk - 1) for kk in ks]
        y = _transposed_conv(x, w, st, pads)
        return y + bias[0].reshape(1, -1, 1, 1, 1) if bias else y
    return f


@register_op("spaceToBatchND")
def _space_to_batch_nd(blockShape=(2, 2), paddings=((0, 0), (0, 0)), **_):
    bs = [int(b) for b in blockShape]
    pd = [(int(a), int(b)) for a, b in paddings]

    def f(x):   # batch, *spatial, channels
        pads = [(0, 0)] + pd + [(0, 0)] * (x.dim() - 1 - len(pd))
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        b, nd = x.shape[0], len(bs)
        spatial = x.shape[1:1 + nd]
        rest = list(x.shape[1 + nd:])
        shape = [b]
        for s, blk in zip(spatial, bs):
            shape += [s // blk, blk]
        x = x.reshape(shape + rest)
        perm = [2 * i + 2 for i in range(nd)] + [0] + \
            [2 * i + 1 for i in range(nd)] + list(range(1 + 2 * nd, x.dim()))
        return x.permute(perm).reshape(
            [b * int(np.prod(bs))] + [s // blk for s, blk in zip(spatial, bs)]
            + rest)
    return f


@register_op("batchToSpaceND")
def _batch_to_space_nd(blockShape=(2, 2), crops=((0, 0), (0, 0)), **_):
    bs = [int(b) for b in blockShape]
    cr = [(int(a), int(b)) for a, b in crops]

    def f(x):
        nd = len(bs)
        b = x.shape[0] // int(np.prod(bs))
        spatial = list(x.shape[1:1 + nd])
        rest = list(x.shape[1 + nd:])
        x = x.reshape(bs + [b] + spatial + rest)
        perm = [nd]
        for i in range(nd):
            perm += [nd + 1 + i, i]
        perm += list(range(2 * nd + 1, x.dim()))
        x = x.permute(perm).reshape(
            [b] + [s * blk for s, blk in zip(spatial, bs)] + rest)
        for i, (lo, hi) in enumerate(cr):
            x = x.narrow(1 + i, lo, x.shape[1 + i] - lo - hi)
        return x
    return f


@register_op("resizeArea")
def _resize_area(height=None, width=None, **_):
    def f(x):   # NHWC; exact for an integer downscale (a mean pool)
        b, h, w, c = x.shape
        oh, ow = int(height), int(width)
        if h % oh == 0 and w % ow == 0:
            return x.reshape(b, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))
        return _jax_resize(x, oh, ow, "linear")
    return f
