"""TF GraphDef → SameDiff importer; the port of
``deeplearning4j_tpu/imports/tf_import.py``.

Reference: nd4j ``samediff-import-tensorflow`` (Kotlin ``TensorflowImporter``
→ ``ImportGraph`` with an ``OpMappingRegistry`` of per-op declarative rules)
and the legacy facade ``nd4j-api .../imports/graphmapper/tf/
TFGraphMapper.java`` (SURVEY.md §3.3).

Design: same rule-registry shape as the reference — ``TF_OPS`` maps a TF op
name to an emitter that appends the equivalent ops to the target SameDiff.
Frozen-graph Const weights import as trainable VARIABLEs (enabling
fine-tuning, matching the reference), other Consts as constants.  Axis/shape
tensor-inputs must be constant-foldable (the reference's rules have the same
static requirement).  The imported graph lives on the device
``importGraph`` is given (``cuda`` unless the caller asks for another).

The GraphDef is read by the port's own wire decoder
(:mod:`deeplearning4j_tpu_torch.imports.graphdef`), so importing needs no
tensorflow: the port never imports it.  A rule whose SameDiff op the port
lacks would raise at import, naming the op; every rule's op is ported.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable
from deeplearning4j_tpu_torch.imports.graphdef import (decode_graphdef,
                                                       dtype_name,
                                                       tensor_value)

__all__ = ["TFGraphMapper", "TF_OPS", "register_tf_op"]

TF_OPS: Dict[str, Callable] = {}


def register_tf_op(*names):
    def deco(fn):
        for n in names:
            TF_OPS[n] = fn
        return fn
    return deco


class _Unknown:
    """Sentinel for a statically-unknown dim (usually batch).  Instances
    from a Shape op carry provenance (which tensor, which dim) so a
    Reshape of the SAME tensor can resolve the [batch, -1] pattern."""

    def __init__(self, src=None, dim=None):
        self.src = src
        self.dim = dim

    def __repr__(self):
        return "?"


UNKNOWN = _Unknown()


class _Ctx:
    """Import context: resolves TF tensor names to SDVariables and tracks
    constant values for static folding (axes/shapes/perms).  ``sym_vals``
    additionally tracks PARTIALLY-known integer vectors (None = unknown
    dim, usually the batch) from Shape/StridedSlice/Pack chains — the
    shape subgraphs real frozen graphs feed into Reshape (round 5,
    VERDICT r4 ask 7; the reference's Kotlin framework evaluates these by
    full graph interpretation)."""

    def __init__(self, sd: SameDiff):
        self.sd = sd
        self.tensors: Dict[str, SDVariable] = {}   # "node:i" -> var
        self.const_vals: Dict[str, np.ndarray] = {}
        self.sym_vals: Dict[str, list] = {}        # list/scalar with Nones

    def put(self, name: str, var: SDVariable, const: Optional[np.ndarray] = None):
        self.tensors[name] = var
        self.tensors.setdefault(name.split(":")[0], var)
        if const is not None:
            self.const_vals[name] = const
            self.const_vals.setdefault(name.split(":")[0], const)

    def put_sym(self, name: str, val) -> None:
        """Record a symbolic (partially-known) value; fully-known values
        also land in const_vals so every ctx.const consumer folds."""
        self.sym_vals[name] = val
        self.sym_vals.setdefault(name.split(":")[0], val)
        seq = val if isinstance(val, (list, tuple)) else [val]
        if not any(isinstance(v, _Unknown) for v in seq):
            arr = np.asarray([int(v) for v in seq]) \
                if isinstance(val, (list, tuple)) \
                else np.asarray(int(val))
            self.const_vals.setdefault(name, arr)
            self.const_vals.setdefault(name.split(":")[0], arr)

    def get(self, name: str) -> SDVariable:
        if name in self.tensors:
            return self.tensors[name]
        base = name.split(":")[0]
        return self.tensors[base]

    def const(self, name: str) -> np.ndarray:
        """Constant value of an input (for axes/shape/perm operands)."""
        if name in self.const_vals:
            return self.const_vals[name]
        base = name.split(":")[0]
        if base in self.const_vals:
            return self.const_vals[base]
        raise ValueError(
            f"TF import: input '{name}' must be a foldable constant")

    def sym(self, name: str):
        """Symbolic value (int/UNKNOWN scalar or list of them), or None
        when the tensor is not tracked at all."""
        if name in self.sym_vals:
            return self.sym_vals[name]
        base = name.split(":")[0]
        if base in self.sym_vals:
            return self.sym_vals[base]
        if name in self.const_vals or base in self.const_vals:
            arr = self.const_vals.get(name, self.const_vals.get(base))
            arr = np.asarray(arr)
            if arr.ndim == 0:
                return int(arr)
            if arr.ndim == 1 and arr.dtype.kind in "iu":
                return [int(v) for v in arr]
        return None


def _attr(node, key, default=None):
    if key not in node.attr:
        return default
    a = node.attr[key]
    kind = a.WhichOneof("value")
    if kind == "i":
        return int(a.i)
    if kind == "f":
        return float(a.f)
    if kind == "b":
        return bool(a.b)
    if kind == "s":
        return a.s.decode("utf-8", "ignore")
    if kind == "list":
        if a.list.i:
            return [int(v) for v in a.list.i]
        if a.list.f:
            return [float(v) for v in a.list.f]
        return []
    if kind == "type":
        return int(a.type)
    if kind == "shape":
        return [d.size for d in a.shape.dim]
    return default


def _tensor_value(node) -> np.ndarray:
    return tensor_value(node.attr["value"].tensor)


def _data_inputs(node) -> List[str]:
    return [i for i in node.input if not i.startswith("^")]


# --------------------------------------------------------------------------
# emitters
# --------------------------------------------------------------------------
@register_tf_op("Placeholder")
def _ph(ctx, node):
    shape = _attr(node, "shape")
    if shape is not None:
        shape = [None if int(s) < 0 else int(s) for s in shape]
    v = ctx.sd.placeholder(node.name, shape=shape)
    ctx.put(node.name, v)


@register_tf_op("Const")
def _const(ctx, node):
    val = _tensor_value(node)
    if not np.issubdtype(val.dtype, np.number) and val.dtype != np.bool_:
        # string/resource consts (Assert messages etc.) — host-side only;
        # their consumers are dropped bookkeeping nodes
        ctx.const_vals[node.name] = val
        ctx.const_vals.setdefault(node.name.split(":")[0], val)
        return
    arr = torch.from_numpy(val)
    if dtype_name(node.attr["value"].tensor.dtype) == "bfloat16":
        arr = arr.to(torch.bfloat16)     # numpy holds bf16 values as f32
    if np.issubdtype(val.dtype, np.floating) and val.size > 1:
        v = ctx.sd.var(node.name, arr)   # frozen weight -> trainable
    else:
        v = ctx.sd.constant(arr, name=node.name)
    ctx.put(node.name, v, const=val)


@register_tf_op("Identity", "StopGradient", "PreventGradient", "Snapshot",
                "CheckNumerics")
def _identity(ctx, node):
    src = _data_inputs(node)[0]
    v = ctx.sd._op("identity", [ctx.get(src)], name=node.name)
    ctx.put(node.name, v)
    if src in ctx.const_vals or src.split(":")[0] in ctx.const_vals:
        ctx.const_vals[node.name] = ctx.const(src)


def _simple_map(tf_name, our_op, n_in=1):
    @register_tf_op(tf_name)
    def _f(ctx, node, _op=our_op, _n=n_in):
        ins = [ctx.get(i) for i in _data_inputs(node)[:_n]]
        ctx.put(node.name, ctx.sd._op(_op, ins, name=node.name))


for _tf, _ours in [("Add", "add"), ("AddV2", "add"), ("Sub", "sub"),
                   ("Mul", "mul"), ("RealDiv", "div"), ("Div", "div"),
                   ("Maximum", "max_pairwise"), ("Minimum", "min_pairwise"),
                   ("Pow", "pow"), ("SquaredDifference", "squaredDifference"),
                   ("FloorDiv", "floordiv"), ("FloorMod", "mod"),
                   ("Equal", "eq"), ("NotEqual", "neq"), ("Greater", "gt"),
                   ("GreaterEqual", "gte"), ("Less", "lt"),
                   ("LessEqual", "lte"), ("LogicalAnd", "and_"),
                   ("LogicalOr", "or_")]:
    _simple_map(_tf, _ours, n_in=2)

for _tf, _ours in [("Neg", "neg"), ("Exp", "exp"), ("Log", "log"),
                   ("Log1p", "log1p"), ("Sqrt", "sqrt"), ("Rsqrt", "rsqrt"),
                   ("Square", "square"), ("Abs", "abs"), ("Sign", "sign"),
                   ("Floor", "floor"), ("Ceil", "ceil"), ("Round", "round"),
                   ("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"),
                   ("Tanh", "tanh"), ("Sigmoid", "sigmoid"), ("Erf", "erf"),
                   ("Relu", "relu"), ("Relu6", "relu6"), ("Elu", "elu"),
                   ("Selu", "selu"), ("Softplus", "softplus"),
                   ("Softsign", "softsign"), ("LogicalNot", "not_"),
                   ("Reciprocal", "reciprocal"), ("IsNan", "isNaN"),
                   ("Erfc", "erfc"), ("Sinh", "sinh"), ("Cosh", "cosh"),
                   ("Asin", "asin"), ("Acos", "acos"), ("Atan", "atan"),
                   ("IsInf", "isInf"), ("IsFinite", "isFinite")]:
    _simple_map(_tf, _ours, n_in=1)


@register_tf_op("LeakyRelu")
def _leaky_relu(ctx, node):
    v = ctx.sd._op("leakyRelu", [ctx.get(_data_inputs(node)[0])],
                   {"alpha": _attr(node, "alpha", 0.2)}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("MatMul")
def _matmul(ctx, node):
    a, b = _data_inputs(node)[:2]
    v = ctx.sd._op("mmul", [ctx.get(a), ctx.get(b)],
                   {"transposeA": _attr(node, "transpose_a", False),
                    "transposeB": _attr(node, "transpose_b", False)},
                   name=node.name)
    ctx.put(node.name, v)


@register_tf_op("BatchMatMul", "BatchMatMulV2")
def _batch_matmul(ctx, node):
    a, b = _data_inputs(node)[:2]
    v = ctx.sd._op("mmul", [ctx.get(a), ctx.get(b)],
                   {"transposeA": _attr(node, "adj_x", False),
                    "transposeB": _attr(node, "adj_y", False)},
                   name=node.name)
    ctx.put(node.name, v)


@register_tf_op("BiasAdd")
def _biasadd(ctx, node):
    x, b = _data_inputs(node)[:2]
    if _attr(node, "data_format", "NHWC") == "NCHW":
        xv = ctx.get(x)
        bv = ctx.get(b)
        bshaped = ctx.sd._op("reshape", [bv], {"shape": [-1, 1, 1]})
        ctx.put(node.name, ctx.sd._op("add", [xv, bshaped], name=node.name))
    else:
        ctx.put(node.name, ctx.sd._op("add", [ctx.get(x), ctx.get(b)],
                                      name=node.name))


@register_tf_op("AddN")
def _addn(ctx, node):
    ins = _data_inputs(node)
    acc = ctx.get(ins[0])
    for i in ins[1:]:
        acc = ctx.sd._op("add", [acc, ctx.get(i)])
    ctx.put(node.name, acc.rename(ctx.sd._unique(node.name)))


def _reduce_map(tf_name, our_op):
    @register_tf_op(tf_name)
    def _f(ctx, node, _op=our_op):
        x, ax = _data_inputs(node)[:2]
        dims = np.atleast_1d(ctx.const(ax)).astype(int).tolist()
        v = ctx.sd._op(_op, [ctx.get(x)],
                       {"dims": dims,
                        "keepDims": _attr(node, "keep_dims", False)},
                       name=node.name)
        ctx.put(node.name, v)


for _tf, _ours in [("Mean", "mean"), ("Sum", "sum"), ("Max", "reduce_max"),
                   ("Min", "reduce_min"), ("Prod", "prod"), ("All", "all"),
                   ("Any", "any")]:
    _reduce_map(_tf, _ours)


@register_tf_op("ArgMax")
def _tf_argmax(ctx, node):
    x, ax = _data_inputs(node)[:2]
    v = ctx.sd._op("argmax", [ctx.get(x)],
                   {"dimension": int(np.atleast_1d(ctx.const(ax))[0])},
                   name=node.name)
    ctx.put(node.name, v)


@register_tf_op("Softmax")
def _tf_softmax(ctx, node):
    ctx.put(node.name, ctx.sd._op("softmax",
                                  [ctx.get(_data_inputs(node)[0])],
                                  {"dimension": -1}, name=node.name))


@register_tf_op("LogSoftmax")
def _tf_logsoftmax(ctx, node):
    ctx.put(node.name, ctx.sd._op("logSoftmax",
                                  [ctx.get(_data_inputs(node)[0])],
                                  {"dimension": -1}, name=node.name))


@register_tf_op("Reshape")
def _tf_reshape(ctx, node):
    x, shp = _data_inputs(node)[:2]
    try:
        shape = [int(s) for s in np.atleast_1d(ctx.const(shp))]
    except ValueError:
        # dynamic shape subgraph: the symbolic fold pass may have
        # resolved it to a vector with one unknown (batch) dim -> -1
        sym = ctx.sym(shp)
        if sym is None or not isinstance(sym, (list, tuple)):
            raise ValueError(
                f"TF import: Reshape '{node.name}' takes a dynamic shape "
                "the symbolic folder cannot resolve (only Shape/"
                "StridedSlice/Pack/Concat chains over statically-shaped "
                "tensors fold)")
        sym = list(sym)
        unk = [i for i, s in enumerate(sym) if isinstance(s, _Unknown)]
        m1 = [i for i, s in enumerate(sym)
              if not isinstance(s, _Unknown) and int(s) == -1]
        if len(unk) == 1 and len(m1) == 1:
            # [batch, -1]-style: resolvable when the unknown PROVABLY is
            # a dim of the very tensor being reshaped and every other dim
            # of that tensor is static — then the -1 slot is computable
            u = sym[unk[0]]
            xshape = getattr(ctx.get(x), "shape", None)
            if u.src == x.split(":")[0] and xshape is not None and \
                    sum(1 for s in xshape if s is None or int(s) < 0) == 1 \
                    and (xshape[u.dim] is None or int(xshape[u.dim]) < 0):
                known_x = 1
                for s in xshape:
                    if s is not None and int(s) > 0:
                        known_x *= int(s)
                known_t = 1
                for i, s in enumerate(sym):
                    if i not in (unk[0], m1[0]):
                        known_t *= int(s)
                if known_t and known_x % known_t == 0:
                    sym[m1[0]] = known_x // known_t
                    m1 = []
        if len(unk) + len(m1) > 1:
            raise ValueError(
                f"TF import: Reshape '{node.name}' shape {sym} has more "
                "than one unknown dim — not expressible statically")
        shape = [-1 if isinstance(s, _Unknown) else int(s) for s in sym]
    v = ctx.sd._op("reshape", [ctx.get(x)], {"shape": shape}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("Transpose")
def _tf_transpose(ctx, node):
    x, perm = _data_inputs(node)[:2]
    dims = [int(p) for p in np.atleast_1d(ctx.const(perm))]
    ctx.put(node.name, ctx.sd._op("permute", [ctx.get(x)], {"dims": dims},
                                  name=node.name))


@register_tf_op("ExpandDims")
def _tf_expand(ctx, node):
    x, ax = _data_inputs(node)[:2]
    ctx.put(node.name, ctx.sd._op(
        "expandDims", [ctx.get(x)],
        {"axis": int(np.atleast_1d(ctx.const(ax))[0])}, name=node.name))


@register_tf_op("Squeeze")
def _tf_squeeze(ctx, node):
    dims = _attr(node, "squeeze_dims") or None
    ctx.put(node.name, ctx.sd._op(
        "squeeze", [ctx.get(_data_inputs(node)[0])],
        {"axis": tuple(dims) if dims else None}, name=node.name))


@register_tf_op("ConcatV2")
def _tf_concat(ctx, node):
    ins = _data_inputs(node)
    axis = int(np.atleast_1d(ctx.const(ins[-1]))[0])
    v = ctx.sd._op("concat", [ctx.get(i) for i in ins[:-1]],
                   {"dimension": axis}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("Pack")
def _tf_pack(ctx, node):
    v = ctx.sd._op("stack", [ctx.get(i) for i in _data_inputs(node)],
                   {"axis": _attr(node, "axis", 0)}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("GatherV2", "Gather")
def _tf_gather(ctx, node):
    ins = _data_inputs(node)
    axis = 0
    if len(ins) > 2:
        axis = int(np.atleast_1d(ctx.const(ins[2]))[0])
    v = ctx.sd._op("gather", [ctx.get(ins[0]), ctx.get(ins[1])],
                   {"axis": axis}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("OneHot")
def _tf_onehot(ctx, node):
    ins = _data_inputs(node)
    depth = int(np.atleast_1d(ctx.const(ins[1]))[0])
    on = float(np.atleast_1d(ctx.const(ins[2]))[0]) if len(ins) > 2 else 1.0
    off = float(np.atleast_1d(ctx.const(ins[3]))[0]) if len(ins) > 3 else 0.0
    v = ctx.sd._op("oneHot", [ctx.get(ins[0])],
                   {"depth": depth, "on": on, "off": off,
                    "axis": _attr(node, "axis", -1)}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("Cast")
def _tf_cast(ctx, node):
    v = ctx.sd._op("cast", [ctx.get(_data_inputs(node)[0])],
                   {"dtype": dtype_name(node.attr["DstT"].type)},
                   name=node.name)
    ctx.put(node.name, v)


@register_tf_op("StridedSlice")
def _tf_strided_slice(ctx, node):
    ins = _data_inputs(node)
    begin = np.atleast_1d(ctx.const(ins[1])).astype(int)
    end = np.atleast_1d(ctx.const(ins[2])).astype(int)
    strides = np.atleast_1d(ctx.const(ins[3])).astype(int)
    bm = _attr(node, "begin_mask", 0)
    em = _attr(node, "end_mask", 0)
    sm = _attr(node, "shrink_axis_mask", 0)
    if _attr(node, "ellipsis_mask", 0) or _attr(node, "new_axis_mask", 0):
        raise ValueError("TF import: StridedSlice ellipsis_mask/new_axis_mask"
                         f" not supported (node '{node.name}')")
    x = ctx.get(ins[0])
    b, e, s = [], [], []
    shrink = []
    for i in range(len(begin)):
        b.append(None if bm & (1 << i) else int(begin[i]))
        e.append(None if em & (1 << i) else int(end[i]))
        s.append(int(strides[i]))
        if sm & (1 << i):
            shrink.append(i)
            bi = b[-1] if b[-1] is not None else 0
            # begin -1 means "last element": end must be None, not 0
            e[-1] = None if bi == -1 else bi + 1
            s[-1] = 1
    v = ctx.sd._op("stridedSlice", [x],
                   {"begin": b, "end": e, "strides": s}, name=node.name)
    if shrink:
        v = ctx.sd._op("squeeze", [v], {"axis": tuple(shrink)})
    ctx.put(node.name, v)


@register_tf_op("Slice")
def _tf_slice(ctx, node):
    ins = _data_inputs(node)
    begin = np.atleast_1d(ctx.const(ins[1])).astype(int).tolist()
    size = np.atleast_1d(ctx.const(ins[2])).astype(int).tolist()
    v = ctx.sd._op("slice", [ctx.get(ins[0])],
                   {"begin": begin, "size": size}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("Pad", "PadV2")
def _tf_pad(ctx, node):
    ins = _data_inputs(node)
    paddings = np.asarray(ctx.const(ins[1])).astype(int).tolist()
    const = 0.0
    if len(ins) > 2:
        const = float(np.atleast_1d(ctx.const(ins[2]))[0])
    v = ctx.sd._op("pad", [ctx.get(ins[0])],
                   {"paddings": paddings, "constant": const}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("Tile")
def _tf_tile(ctx, node):
    ins = _data_inputs(node)
    reps = np.atleast_1d(ctx.const(ins[1])).astype(int).tolist()
    ctx.put(node.name, ctx.sd._op("tile", [ctx.get(ins[0])], {"reps": reps},
                                  name=node.name))


@register_tf_op("Select", "SelectV2")
def _tf_select(ctx, node):
    ins = [ctx.get(i) for i in _data_inputs(node)[:3]]
    ctx.put(node.name, ctx.sd._op("where", ins, name=node.name))


@register_tf_op("Assert")
def _tf_assert(ctx, node):
    # Runtime assertion machinery (input-validation subgraphs in frozen
    # Keras/HF models): dropped at import, like the reference mapper skips
    # framework bookkeeping nodes.  Its operand subgraph becomes dead code.
    pass


@register_tf_op("Fill")
def _tf_fill(ctx, node):
    ins = _data_inputs(node)
    dims = np.atleast_1d(ctx.const(ins[0])).astype(int).tolist()
    val = np.atleast_1d(ctx.const(ins[1]))[0]
    arr = np.full(dims, val)
    v = ctx.sd.constant(arr, name=node.name)
    ctx.put(node.name, v, const=arr)


@register_tf_op("Range")
def _tf_range(ctx, node):
    ins = _data_inputs(node)
    start = np.atleast_1d(ctx.const(ins[0]))[0]
    limit = np.atleast_1d(ctx.const(ins[1]))[0]
    delta = np.atleast_1d(ctx.const(ins[2]))[0]
    arr = np.arange(start, limit, delta)
    v = ctx.sd.constant(arr, name=node.name)
    ctx.put(node.name, v, const=arr)


@register_tf_op("Conv2D")
def _tf_conv2d(ctx, node):
    x, w = _data_inputs(node)[:2]
    strides = _attr(node, "strides", [1, 1, 1, 1])
    fmt = _attr(node, "data_format", "NHWC")
    dil = _attr(node, "dilations", [1, 1, 1, 1])
    if fmt == "NHWC":
        sH, sW, dH, dW = strides[1], strides[2], dil[1], dil[2]
    else:
        sH, sW, dH, dW = strides[2], strides[3], dil[2], dil[3]
    v = ctx.sd._op("conv2d", [ctx.get(x), ctx.get(w)],
                   {"sH": sH, "sW": sW, "dH": dH, "dW": dW,
                    "isSameMode": _attr(node, "padding") == "SAME",
                    "dataFormat": fmt}, name=node.name)
    ctx.put(node.name, v)


def _tf_pool(ctx, node, op):
    x = _data_inputs(node)[0]
    k = _attr(node, "ksize", [1, 2, 2, 1])
    s = _attr(node, "strides", [1, 2, 2, 1])
    fmt = _attr(node, "data_format", "NHWC")
    if fmt == "NHWC":
        kH, kW, sH, sW = k[1], k[2], s[1], s[2]
    else:
        kH, kW, sH, sW = k[2], k[3], s[2], s[3]
    v = ctx.sd._op(op, [ctx.get(x)],
                   {"kH": kH, "kW": kW, "sH": sH, "sW": sW,
                    "isSameMode": _attr(node, "padding") == "SAME",
                    "dataFormat": fmt}, name=node.name)
    ctx.put(node.name, v)


@register_tf_op("MaxPool")
def _tf_maxpool(ctx, node):
    _tf_pool(ctx, node, "maxPooling2d")


@register_tf_op("AvgPool")
def _tf_avgpool(ctx, node):
    _tf_pool(ctx, node, "avgPooling2d")


@register_tf_op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _tf_fused_bn(ctx, node):
    ins = _data_inputs(node)
    x, gamma, beta, mean, var = [ctx.get(i) for i in ins[:5]]
    fmt = _attr(node, "data_format", "NHWC")
    axis = 3 if fmt == "NHWC" else 1
    v = ctx.sd._op("batchNorm", [x, mean, var, gamma, beta],
                   {"axis": axis, "eps": _attr(node, "epsilon", 1e-3)},
                   name=node.name)
    ctx.put(node.name, v)


# --------------------------------------------------------------------------
# facade
# --------------------------------------------------------------------------
def _poison(f):
    """Arithmetic where any unknown operand yields UNKNOWN."""
    return lambda a, b: UNKNOWN \
        if isinstance(a, _Unknown) or isinstance(b, _Unknown) else f(a, b)


_SYM_BINOPS = {
    "Mul": _poison(lambda a, b: a * b),
    "AddV2": _poison(lambda a, b: a + b),
    "Add": _poison(lambda a, b: a + b),
    "Sub": _poison(lambda a, b: a - b),
    "FloorDiv": _poison(lambda a, b: a // b),
    "Maximum": _poison(max),
    "Minimum": _poison(min),
}


def _try_fold_shape(ctx, node) -> None:
    """Symbolically evaluate shape-producing chains (Shape → StridedSlice
    → Pack/Concat, with Cast/Identity/arithmetic links) so dynamic
    Reshapes over statically-shaped tensors import.  UNKNOWN dims poison
    through arithmetic and surface as -1 in the final Reshape."""
    ins = _data_inputs(node)
    op = node.op
    if op == "Shape":
        var = ctx.get(ins[0])
        shp = getattr(var, "shape", None)
        if shp is not None:
            base = ins[0].split(":")[0]
            ctx.put_sym(node.name,
                        [_Unknown(base, i) if s is None or int(s) < 0
                         else int(s) for i, s in enumerate(shp)])
        return
    if op in ("Cast", "Identity"):
        v = ctx.sym(ins[0])
        if v is not None:
            ctx.put_sym(node.name, v)
        return
    if op == "Pack":
        vals = [ctx.sym(i) for i in ins]
        if all(v is not None and not isinstance(v, (list, tuple))
               for v in vals):            # scalars (known or UNKNOWN)
            ctx.put_sym(node.name, list(vals))
        return
    if op == "ConcatV2":
        parts = [ctx.sym(i) for i in ins[:-1]]
        norm = []
        for p in parts:
            if p is None:
                return
            norm.append(list(p) if isinstance(p, (list, tuple)) else [p])
        ctx.put_sym(node.name, [v for p in norm for v in p])
        return
    if op == "StridedSlice":
        src = ctx.sym(ins[0])
        if not isinstance(src, (list, tuple)):
            return
        try:
            begin = int(np.atleast_1d(ctx.const(ins[1]))[0])
            end = int(np.atleast_1d(ctx.const(ins[2]))[0])
            stride = int(np.atleast_1d(ctx.const(ins[3]))[0])
        except ValueError:
            return
        if _attr(node, "ellipsis_mask", 0) or _attr(node, "new_axis_mask",
                                                    0):
            return
        bm = _attr(node, "begin_mask", 0)
        em = _attr(node, "end_mask", 0)
        if _attr(node, "shrink_axis_mask", 0) & 1:
            if -len(src) <= begin < len(src):
                ctx.put_sym(node.name, src[begin])
            return
        b = None if bm & 1 else begin
        e = None if em & 1 else end
        ctx.put_sym(node.name, list(src)[slice(b, e, stride)])
        return
    if op in _SYM_BINOPS:
        a, b = ctx.sym(ins[0]), ctx.sym(ins[1])
        if a is None or b is None:
            return
        f = _SYM_BINOPS[op]
        if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
            la = list(a) if isinstance(a, (list, tuple)) else None
            lb = list(b) if isinstance(b, (list, tuple)) else None
            if la is None:
                la = [a] * len(lb)
            if lb is None:
                lb = [b] * len(la)
            if len(la) == len(lb):
                ctx.put_sym(node.name, [f(x, y) for x, y in zip(la, lb)])
        else:
            ctx.put_sym(node.name, f(a, b))
        return
    if op == "Prod":
        v = ctx.sym(ins[0])
        if isinstance(v, (list, tuple)):
            out = 1
            for x in v:
                if isinstance(x, _Unknown):
                    return
                out *= int(x)
            ctx.put_sym(node.name, out)
        return


class TFGraphMapper:
    """Reference facade: nd4j-api .../imports/graphmapper/tf/TFGraphMapper."""

    @staticmethod
    def importGraph(graph, device=None) -> SameDiff:
        """``graph``: path to a frozen .pb, bytes, the decoder's own
        ``GraphDef`` or any object with ``SerializeToString()`` (a
        tensorflow ``GraphDef``).  The graph lives on ``device``
        (``cuda`` unless the caller asks for another)."""
        gd = decode_graphdef(graph)
        sd = SameDiff.create(device)
        ctx = _Ctx(sd)
        for node in gd.node:
            if node.op in ("NoOp",):
                continue
            emit = TF_OPS.get(node.op)
            if emit is None:
                raise ValueError(
                    f"TF import: unsupported op '{node.op}' (node "
                    f"'{node.name}'); supported: {sorted(TF_OPS)}")
            emit(ctx, node)
            _try_fold_shape(ctx, node)
        return sd


from deeplearning4j_tpu_torch.imports import tf_import_ext  # noqa: E402,F401  isort:skip
from deeplearning4j_tpu_torch.imports import tf_import_ext2  # noqa: E402,F401  isort:skip
