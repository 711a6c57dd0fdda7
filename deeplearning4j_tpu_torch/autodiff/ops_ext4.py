"""Extended SameDiff ops, part 4: the port of
``deeplearning4j_tpu/autodiff/ops_ext4.py`` — the merge ops (mergeadd,
mergeavg, mergemax, mergemaxindex), the condition transforms
(match_condition, replace_where, compare_and_set / replace), the legacy
index reductions (firstIndex, lastIndex, iamax, iamin), the boolean
reductions, a few generators and reductions, and the reference's alias
names that map onto existing ops."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, _abs,
                                                        _simple, register_op)

# ---- n-ary merges --------------------------------------------------------
_simple("mergeAdd", lambda *xs: sum(xs))
_simple("mergeAvg", lambda *xs: sum(xs) / len(xs))


@register_op("mergeMax")
def _merge_max(**_):
    def f(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out
    return f


@register_op("mergeMaxIndex")
def _merge_max_index(**_):
    return lambda *xs: torch.argmax(torch.stack(xs), dim=0).to(torch.int32)


# ---- condition transforms (reference: the ConditionOp kernels) -----------
_COND = {
    "EQ": lambda x, v: x == v, "NEQ": lambda x, v: x != v,
    "LT": lambda x, v: x < v, "LTE": lambda x, v: x <= v,
    "GT": lambda x, v: x > v, "GTE": lambda x, v: x >= v,
    "ABS_GT": lambda x, v: _abs(x) > v,
    "ABS_LT": lambda x, v: _abs(x) < v,
    "IS_NAN": lambda x, v: torch.isnan(x),
    "IS_INF": lambda x, v: torch.isinf(x),
}


def _cond(condition, value):
    key = str(condition).upper().replace("LESSTHAN", "LT") \
        .replace("GREATERTHAN", "GT").replace("EPSEQUALS", "EQ")
    if key not in _COND:
        raise ValueError(f"Unknown condition {condition!r}; "
                         f"known: {sorted(_COND)}")
    return lambda x: _COND[key](x, value)


@register_op("matchCondition")
def _match_condition(condition="GT", value=0.0, **_):
    c = _cond(condition, value)
    return lambda x: torch.sum(c(x)).to(torch.int64)


@register_op("matchConditionTransform")
def _match_condition_transform(condition="GT", value=0.0, **_):
    c = _cond(condition, value)
    return lambda x: c(x).to(torch.float32)


@register_op("replaceWhere")
def _replace_where(condition="GT", value=0.0, **_):
    c = _cond(condition, value)
    return lambda x, repl: torch.where(c(x), repl, x)


@register_op("compareAndSet")
def _compare_and_set(condition="EQ", value=0.0, setValue=0.0, **_):
    c = _cond(condition, value)
    return lambda x: torch.where(c(x), setValue, x)


@register_op("compareAndReplace")
def _compare_and_replace(condition="GT", value=0.0, **_):
    # where x satisfies the condition, the replacement tensor's value
    c = _cond(condition, value)
    return lambda x, y: torch.where(c(x), y, x)


# ---- the legacy index reductions (reference: indexreduce loops) ----------
def _index_of(first):
    def factory(condition="GT", value=0.0, dims=None, **_):
        c = _cond(condition, value)

        def f(x):
            m = c(x)
            ax = int(dims[0]) if isinstance(dims, (tuple, list)) and dims \
                else -1
            n = x.shape[ax]
            shape = [1] * x.dim()
            shape[ax] = n
            iota = torch.arange(n, device=x.device).reshape(shape)
            if first:
                out = torch.amin(torch.where(m, iota, n + 1), dim=ax)
                return torch.where(out == n + 1, -1, out).to(torch.int64)
            return torch.amax(torch.where(m, iota, -1), dim=ax).to(
                torch.int64)
        return f
    return factory


OP_IMPLS["firstIndex"] = _index_of(True)
OP_IMPLS["lastIndex"] = _index_of(False)


def _arg_abs(fn):
    def factory(dims=None, **_):
        ax = int(dims[0]) if isinstance(dims, (tuple, list)) and dims \
            else None
        return lambda x: fn(_abs(x), dim=ax).to(torch.int64)
    return factory


OP_IMPLS["iamax"] = _arg_abs(torch.argmax)
OP_IMPLS["iamin"] = _arg_abs(torch.argmin)


# ---- boolean reductions --------------------------------------------------
_simple("isNonDecreasing",
        lambda x: torch.all(x.reshape(-1)[1:] >= x.reshape(-1)[:-1]))
_simple("isStrictlyIncreasing",
        lambda x: torch.all(x.reshape(-1)[1:] > x.reshape(-1)[:-1]))
# jnp.number: every integer, float and complex type, not bool
_simple("isNumericTensor", lambda x: torch.tensor(x.dtype != torch.bool,
                                                  device=x.device))


# ---- small generators / reductions ---------------------------------------
@register_op("logspace")
def _logspace(start=0.0, stop=1.0, num=10, base=10.0, **_):
    # in float64, as the reference's x64 jnp.logspace, then float32
    return lambda: torch.logspace(float(start), float(stop), int(num),
                                  base=float(base),
                                  dtype=torch.float64).to(torch.float32)


@register_op("squaredNorm")
def _squared_norm(dims=None, keepDims=False, **_):
    ax = tuple(dims) if dims else None
    return lambda x: torch.sum(x * x, dim=ax, keepdim=bool(keepDims))


@register_op("countZero")
def _count_zero(dims=None, **_):
    ax = tuple(dims) if dims else None
    return lambda x: torch.sum((x == 0).to(torch.int64), dim=ax)


@register_op("upsampling1d")
def _upsampling1d(scale=2, **_):
    return lambda x: torch.repeat_interleave(x, int(scale), dim=2)  # (b,c,t)


# ---- the reference's alias names onto existing ops -----------------------
for _alias, _target in [("setdiff1d", "listDiff"),
                        ("divideNoNan", "divNoNan"),
                        ("squaredSubtract", "squaredDifference"),
                        ("softmaxCrossEntropyWithLogits",
                         "softmaxCrossEntropy"),
                        ("sigmoidCrossEntropyWithLogits",
                         "sigmoidCrossEntropy"),
                        ("iMax", "argmax"), ("iMin", "argmin")]:
    OP_IMPLS[_alias] = OP_IMPLS[_target]
