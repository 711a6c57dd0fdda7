"""ONNX importer breadth, part 1; the port of
``deeplearning4j_tpu/imports/onnx_import_ext.py``.

Reference: samediff-import-onnx's per-op mapping rules (SURVEY.md §2.3).
Extends ``onnx_import._ONNX_OPS`` with the elementwise/reduce/shape/
normalization op set torch.onnx and common exporters emit beyond the
MLP/CNN core: comparisons, ``Where``, ``Expand``, ``ConstantOfShape``
among them.  Each rule emits the reference's SameDiff op with the
reference's attrs.  Imported for side effects at the bottom of
``onnx_import.py``.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.imports.onnx_import import _ONNX_OPS, _op

# ---- unary through sd.math()/sd.nn() -------------------------------------
def _un_math(our):
    def fn(ctx, node):
        return getattr(ctx.sd.math(), our)(ctx.get(node.inputs[0]))
    return fn


for onnx_name, our in [("Reciprocal", "reciprocal"), ("Floor", "floor"),
                       ("Ceil", "ceil"), ("Round", "round"),
                       ("Sign", "sign"), ("Sin", "sin"), ("Cos", "cos"),
                       ("Tan", "tan"), ("Asin", "asin"), ("Acos", "acos"),
                       ("Atan", "atan"), ("Sinh", "sinh"),
                       ("Cosh", "cosh"), ("Asinh", "asinh"),
                       ("Acosh", "acosh"), ("Atanh", "atanh"),
                       ("IsNaN", "isNaN"), ("Not", "not_")]:
    _ONNX_OPS[onnx_name] = _un_math(our)


@_op("IsInf")
def _isinf(ctx, node):
    return ctx.sd._op("isInf", [ctx.get(node.inputs[0])])


@_op("LeakyRelu")
def _leaky(ctx, node):
    return ctx.sd._op("leakyRelu", [ctx.get(node.inputs[0])],
                      {"alpha": float(node.attrs.get("alpha", 0.01))})


@_op("PRelu")
def _prelu(ctx, node):
    return ctx.sd._op("prelu", [ctx.get(node.inputs[0]),
                                ctx.get(node.inputs[1])])


@_op("HardSigmoid")
def _hard_sigmoid(ctx, node):
    a = float(node.attrs.get("alpha", 0.2))
    b = float(node.attrs.get("beta", 0.5))
    x = ctx.get(node.inputs[0])
    ax = x.mul(ctx.sd.constant(np.float32(a)))
    s = ax.add(ctx.sd.constant(np.float32(b)))
    return ctx.sd._op("clipByValue", [s],
                      {"clipValueMin": 0.0, "clipValueMax": 1.0})


@_op("Clip")
def _clip(ctx, node):
    lo, hi = node.attrs.get("min"), node.attrs.get("max")
    if len(node.inputs) > 1 and node.inputs[1]:
        lo = float(ctx.const_val(node.inputs[1]))
    if len(node.inputs) > 2 and node.inputs[2]:
        hi = float(ctx.const_val(node.inputs[2]))
    return ctx.sd._op("clipByValue", [ctx.get(node.inputs[0])],
                      {"clipValueMin": float(lo if lo is not None
                                             else -3.4e38),
                       "clipValueMax": float(hi if hi is not None
                                             else 3.4e38)})


@_op("LogSoftmax")
def _log_softmax(ctx, node):
    return ctx.sd._op("logSoftmax", [ctx.get(node.inputs[0])],
                      {"dimension": int(node.attrs.get("axis", -1))})


@_op("Mod")
def _mod(ctx, node):
    our = "fmod" if int(node.attrs.get("fmod", 0)) else "mod"
    return ctx.sd._op(our, [ctx.get(node.inputs[0]),
                            ctx.get(node.inputs[1])])


# ---- n-ary / comparisons / logic -----------------------------------------
def _nary(our_pair):
    def fn(ctx, node):
        out = ctx.get(node.inputs[0])
        for i in node.inputs[1:]:
            out = ctx.sd._op(our_pair, [out, ctx.get(i)])
        return out
    return fn


_ONNX_OPS["Min"] = _nary("min_pairwise")
_ONNX_OPS["Max"] = _nary("max_pairwise")
_ONNX_OPS["Sum"] = _nary("add")


@_op("Mean")
def _mean_nary(ctx, node):
    out = ctx.get(node.inputs[0])
    for i in node.inputs[1:]:
        out = ctx.sd._op("add", [out, ctx.get(i)])
    return out.mul(ctx.sd.constant(np.float32(1.0 / len(node.inputs))))


for onnx_name, our in [("Equal", "eq"), ("Greater", "gt"),
                       ("GreaterOrEqual", "gte"), ("Less", "lt"),
                       ("LessOrEqual", "lte"), ("And", "and_"),
                       ("Or", "or_"), ("Xor", "xor")]:
    def _cmp(ctx, node, _our=our):
        return ctx.sd._op(_our, [ctx.get(node.inputs[0]),
                                 ctx.get(node.inputs[1])])
    _ONNX_OPS[onnx_name] = _cmp


@_op("Where")
def _where(ctx, node):
    return ctx.sd._op("select", [ctx.get(node.inputs[0]),
                                 ctx.get(node.inputs[1]),
                                 ctx.get(node.inputs[2])])


# ---- reductions ----------------------------------------------------------
def _axes_of(ctx, node):
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        axes = ctx.const_val(node.inputs[1]).astype(int).tolist()
    return tuple(int(a) for a in axes) if axes is not None else None


def _reduce(our):
    def fn(ctx, node):
        dims = _axes_of(ctx, node)
        keep = bool(int(node.attrs.get("keepdims", 1)))
        return ctx.sd._op(our, [ctx.get(node.inputs[0])],
                          {"dims": dims, "keepDims": keep})
    return fn


for onnx_name, our in [("ReduceMean", "mean"), ("ReduceSum", "sum"),
                       ("ReduceMax", "reduce_max"),
                       ("ReduceMin", "reduce_min"),
                       ("ReduceProd", "prod")]:
    _ONNX_OPS[onnx_name] = _reduce(our)


@_op("ReduceL2")
def _reduce_l2(ctx, node):
    dims = _axes_of(ctx, node)
    keep = bool(int(node.attrs.get("keepdims", 1)))
    sq = ctx.sd._op("squaredNorm", [ctx.get(node.inputs[0])],
                    {"dims": dims, "keepDims": keep})
    return ctx.sd.math().sqrt(sq)


@_op("ArgMax")
def _argmax(ctx, node):
    return ctx.sd._op("argmax", [ctx.get(node.inputs[0])],
                      {"dimension": int(node.attrs.get("axis", 0)),
                       "keepDims": bool(int(node.attrs.get("keepdims",
                                                           1)))})


@_op("ArgMin")
def _argmin(ctx, node):
    return ctx.sd._op("argmin", [ctx.get(node.inputs[0])],
                      {"dimension": int(node.attrs.get("axis", 0)),
                       "keepDims": bool(int(node.attrs.get("keepdims",
                                                           1)))})


# ---- shape ops -----------------------------------------------------------
@_op("Squeeze")
def _squeeze(ctx, node):
    axes = _axes_of(ctx, node)
    return ctx.sd._op("squeeze", [ctx.get(node.inputs[0])],
                      {"axis": axes})


@_op("Unsqueeze")
def _unsqueeze(ctx, node):
    axes = _axes_of(ctx, node)
    out = ctx.get(node.inputs[0])
    for a in sorted(axes):
        out = ctx.sd._op("expandDims", [out], {"axis": int(a)})
    return out


@_op("Slice")
def _slice(ctx, node):
    if "starts" in node.attrs:                 # opset < 10: attrs
        starts = list(node.attrs["starts"])
        ends = list(node.attrs["ends"])
        axes = list(node.attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = ctx.const_val(node.inputs[1]).astype(int).tolist()
        ends = ctx.const_val(node.inputs[2]).astype(int).tolist()
        axes = ctx.const_val(node.inputs[3]).astype(int).tolist() \
            if len(node.inputs) > 3 and node.inputs[3] \
            else list(range(len(starts)))
        steps = ctx.const_val(node.inputs[4]).astype(int).tolist() \
            if len(node.inputs) > 4 and node.inputs[4] \
            else [1] * len(starts)
    return ctx.sd._op("stridedSlice", [ctx.get(node.inputs[0])],
                      {"begin": starts, "end": ends, "strides": steps,
                       "axes": axes})


@_op("Tile")
def _tile(ctx, node):
    reps = ctx.const_val(node.inputs[1]).astype(int).tolist()
    return ctx.sd._op("tile", [ctx.get(node.inputs[0])], {"reps": reps})


@_op("Expand")
def _expand(ctx, node):
    shape = ctx.const_val(node.inputs[1]).astype(int).tolist()
    return ctx.sd._op("broadcastTo", [ctx.get(node.inputs[0])],
                      {"shape": tuple(shape)})


@_op("Cast")
def _cast(ctx, node):
    to = {1: "float32", 6: "int32", 7: "int64", 9: "bool",
          11: "float64", 10: "float16"}[int(node.attrs.get("to", 1))]
    return ctx.sd._op("cast", [ctx.get(node.inputs[0])], {"dtype": to})


@_op("Trilu")
def _trilu(ctx, node):
    upper = bool(int(node.attrs.get("upper", 1)))
    return ctx.sd._op("triu" if upper else "tril",
                      [ctx.get(node.inputs[0])])


@_op("GatherElements")
def _gather_elements(ctx, node):
    return ctx.sd._op("takeAlongAxis",
                      [ctx.get(node.inputs[0]), ctx.get(node.inputs[1])],
                      {"axis": int(node.attrs.get("axis", 0))})


@_op("CumSum")
def _cumsum(ctx, node):
    axis = int(np.atleast_1d(ctx.const_val(node.inputs[1]))[0])
    return ctx.sd._op("cumsum", [ctx.get(node.inputs[0])],
                      {"axis": axis})


@_op("ConstantOfShape")
def _const_of_shape(ctx, node):
    shape = ctx.const_val(node.inputs[0]).astype(int).tolist()
    val = node.attrs.get("value")
    fill = float(np.atleast_1d(val)[0]) if val is not None else 0.0
    arr = np.full(shape, fill, np.float32)
    ctx.consts[node.outputs[0]] = arr
    return ctx.sd.constant(arr, name=f"c_{node.outputs[0]}")


@_op("Dropout")
def _dropout(ctx, node):
    # inference graphs: identity (mask output, if requested, is unused)
    return ctx.sd._op("identity", [ctx.get(node.inputs[0])])


@_op("GlobalMaxPool")
def _global_max_pool(ctx, node):
    return ctx.sd._op("reduce_max", [ctx.get(node.inputs[0])],
                      {"dims": (2, 3), "keepDims": True})


@_op("LayerNormalization")
def _layer_norm(ctx, node):
    eps = float(node.attrs.get("epsilon", 1e-5))
    return ctx.sd._op("layerNorm",
                      [ctx.get(node.inputs[0]), ctx.get(node.inputs[1]),
                       ctx.get(node.inputs[2])],
                      {"eps": eps,
                       "axis": int(node.attrs.get("axis", -1))})
