"""ONNX importer breadth, part 2; the port of
``deeplearning4j_tpu/imports/onnx_import_ext2.py``.

Reference: samediff-import-onnx mapping rules (SURVEY.md §2.3).  Adds
the activation/reduce/normalization/quantize/random families plus
multi-output ops (TopK/Split) on top of part 1, with the helper ops they
emit (``onnx_hardmax``, ``onnx_topk``, ``onnx_resize``, ``onnx_qlinear``,
``onnx_dqlinear``, ``onnx_bernoulli``) in torch.  ``onnx_resize`` computes
what the reference's ``jax.image.resize`` computes (the port's
``_jax_resize``: half-pixel centres, the triangle and Keys cubic kernels,
antialiased when downsampling); ``onnx_bernoulli`` draws from a generator
seeded by the node's seed, as the port's random ops do (the same draws on
every call and device, not the reference's bits).  Imported for side
effects at the bottom of ``onnx_import.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.ops_ext import _jax_resize
from deeplearning4j_tpu_torch.autodiff.samediff import _gen, register_op
from deeplearning4j_tpu_torch.imports.onnx_import import _ONNX_OPS, _op


def _un(our_ns_op):
    def fn(ctx, node):
        return ctx.sd._op(our_ns_op, [ctx.get(node.inputs[0])])
    return fn


# ---- activations ----------------------------------------------------------
for onnx_name, our in [("Mish", "mish"), ("Softsign", "softsign"),
                       ("HardSwish", "hardSwish")]:
    _ONNX_OPS[onnx_name] = _un(our)


@_op("Gelu")
def _gelu(ctx, node):  # opset 20; approximate attr: "none" | "tanh"
    return ctx.sd._op("gelu", [ctx.get(node.inputs[0])],
                      {"approximate": node.attrs.get("approximate",
                                                     "none") == "tanh"})


@_op("ThresholdedRelu")
def _thresholded_relu(ctx, node):
    return ctx.sd._op("thresholdRelu", [ctx.get(node.inputs[0])],
                      {"cutoff": float(node.attrs.get("alpha", 1.0))})


@_op("Celu")
def _celu(ctx, node):
    # celu(x) = max(0,x) + min(0, a*(exp(x/a)-1)) == elu with alpha scale
    a = float(node.attrs.get("alpha", 1.0))
    x = ctx.get(node.inputs[0])
    sd = ctx.sd
    pos = sd._op("relu", [x])
    scaled = x.mul(sd.constant(np.float32(1.0 / a)))
    neg = sd._op("elu", [scaled]).mul(sd.constant(np.float32(a)))
    zero = sd.constant(np.float32(0.0))
    return pos.add(sd._op("min_pairwise", [neg, zero]))


@register_op("onnx_hardmax")
def _onnx_hardmax_impl(axis=-1, **_):
    def fn(x):
        # one-hot of the FIRST max along axis (ONNX tie-break semantics)
        ax = int(axis) % x.dim()
        oh = F.one_hot(torch.argmax(x, dim=ax), x.shape[ax]).to(x.dtype)
        return oh.movedim(-1, ax)
    return fn


@_op("Hardmax")
def _hardmax(ctx, node):
    return ctx.sd._op("onnx_hardmax", [ctx.get(node.inputs[0])],
                      {"axis": int(node.attrs.get("axis", -1))})


# ---- reductions -----------------------------------------------------------
def _reduce(our):
    def fn(ctx, node):
        # opset >=18 passes axes as a second input; earlier as an attr.
        # An absent optional input (name "") or an empty axes tensor means
        # reduce over ALL axes unless noop_with_empty_axes=1 (identity).
        if len(node.inputs) > 1 and node.inputs[1]:
            axes = [int(v) for v in ctx.const_val(node.inputs[1])]
        else:
            axes = node.attrs.get("axes")
        if axes is None or len(axes) == 0:
            if node.attrs.get("noop_with_empty_axes", 0):
                return ctx.get(node.inputs[0])
            axes = None
        attrs = {"keepDims": bool(node.attrs.get("keepdims", 1))}
        if axes is not None:
            attrs["dims"] = list(axes)
        return ctx.sd._op(our, [ctx.get(node.inputs[0])], attrs)
    return fn


for onnx_name, our in [("ReduceL1", "norm1"), ("ReduceLogSumExp",
                                               "logSumExp"),
                       ("ReduceSumSquare", "squaredNorm")]:
    _ONNX_OPS[onnx_name] = _reduce(our)


@_op("ReduceLogSum")
def _reduce_log_sum(ctx, node):
    # compose the shared _reduce rule (handles axes-as-input, opset 18+)
    return ctx.sd._op("log", [_reduce("sum")(ctx, node)])


# ---- shape/indexing -------------------------------------------------------
@_op("Shape")
def _shape(ctx, node):
    return ctx.sd._op("shape_of", [ctx.get(node.inputs[0])])


@_op("Size")
def _size(ctx, node):
    return ctx.sd._op("size", [ctx.get(node.inputs[0])])


@_op("Range")
def _range(ctx, node):
    start = float(ctx.const_val(node.inputs[0]))
    limit = float(ctx.const_val(node.inputs[1]))
    delta = float(ctx.const_val(node.inputs[2]))
    return ctx.sd._op("range", [], {"start": start, "limit": limit,
                                    "delta": delta})


@_op("EyeLike")
def _eye_like(ctx, node):
    x = ctx.get(node.inputs[0])
    return ctx.sd._op("matrixSetDiag", [
        ctx.sd._op("zerosLike", [x]),
        ctx.sd._op("onesLike", [ctx.sd._op("diagPart", [x])])])


@_op("GatherND")
def _gather_nd(ctx, node):
    return ctx.sd._op("gatherNd", [ctx.get(node.inputs[0]),
                                   ctx.get(node.inputs[1])])


@_op("ScatterND")
def _scatter_nd(ctx, node):
    return ctx.sd._op("scatterNdUpdate", [ctx.get(node.inputs[0]),
                                          ctx.get(node.inputs[1]),
                                          ctx.get(node.inputs[2])])


@_op("ScatterElements")
def _scatter_elements(ctx, node):
    # Element-wise semantics (output[indices[i][j]][j] = updates[i][j] for
    # axis=0), NOT whole-row scatter — mapped to putAlongAxis (advisor r4).
    axis = int(node.attrs.get("axis", 0))
    red = node.attrs.get("reduction", "none")
    if red not in ("none", "add", "mul"):
        raise ValueError(f"ScatterElements reduction={red!r} unsupported")
    return ctx.sd._op("putAlongAxis", [ctx.get(node.inputs[0]),
                                       ctx.get(node.inputs[1]),
                                       ctx.get(node.inputs[2])],
                      {"axis": axis, "reduction": red})


_ONNX_OPS["Scatter"] = _scatter_elements          # deprecated alias


@register_op("onnx_topk")
def _onnx_topk_impl(k=1, axis=-1, largest=1, sorted=True, **_):
    def fn(x):
        ax = int(axis) % x.dim()
        moved = torch.movedim(x, ax, -1)
        # a stable descending sort: equal values keep the lower index
        # first, as lax.top_k's; indices int32, as lax.top_k's
        v, i = torch.sort(moved if largest else -moved, dim=-1,
                          descending=True, stable=True)
        v, i = v[..., :int(k)], i[..., :int(k)].to(torch.int32)
        if not largest:
            v = -v
        return [torch.movedim(v, -1, ax), torch.movedim(i, -1, ax)]
    return fn


@_op("TopK")
def _topk(ctx, node):
    k = int(ctx.const_val(node.inputs[1])) if len(node.inputs) > 1 \
        else int(node.attrs.get("k", 1))
    outs = ctx.sd._op("onnx_topk", [ctx.get(node.inputs[0])],
                      {"k": k, "axis": int(node.attrs.get("axis", -1)),
                       "largest": int(node.attrs.get("largest", 1)),
                       "sorted": bool(node.attrs.get("sorted", 1))},
                      n_out=2)
    if len(node.outputs) > 1:
        ctx.vars[node.outputs[1]] = outs[1]
    return outs[0]


@_op("Split")
def _split(ctx, node):
    axis = int(node.attrs.get("axis", 0))
    sizes = None
    if len(node.inputs) > 1:                    # opset 13+: sizes input
        sizes = [int(v) for v in ctx.const_val(node.inputs[1])]
    elif node.attrs.get("split") is not None:   # opset <=12: split attr
        sizes = [int(v) for v in node.attrs["split"]]
    if sizes is not None:
        outs = ctx.sd._op("splitV", [ctx.get(node.inputs[0])],
                          {"sizes": sizes, "axis": axis},
                          n_out=len(sizes))
    else:
        n = len(node.outputs)
        outs = ctx.sd._op("split", [ctx.get(node.inputs[0])],
                          {"numSplit": n, "dimension": axis}, n_out=n)
    outs = outs if isinstance(outs, list) else [outs]
    for name, var in zip(node.outputs[1:], outs[1:]):
        ctx.vars[name] = var
    return outs[0]


@_op("ReverseSequence")
def _reverse_sequence(ctx, node):
    return ctx.sd._op("reverseSequence",
                      [ctx.get(node.inputs[0]), ctx.get(node.inputs[1])],
                      {"seqAxis": int(node.attrs.get("time_axis", 0)),
                       "batchAxis": int(node.attrs.get("batch_axis", 1))})


@_op("Einsum")
def _einsum(ctx, node):
    return ctx.sd._op("einsum", [ctx.get(i) for i in node.inputs],
                      {"equation": node.attrs.get("equation", "")})


@_op("Pad")
def _pad(ctx, node):
    mode = node.attrs.get("mode", "constant")
    if len(node.inputs) > 1:
        pads = [int(v) for v in ctx.const_val(node.inputs[1])]
    else:
        pads = [int(v) for v in node.attrs.get("pads", [])]
    n = len(pads) // 2
    # ONNX: [x1_begin, x2_begin, ..., x1_end, x2_end, ...]
    pairs = [[pads[i], pads[n + i]] for i in range(n)]
    value = 0.0
    if len(node.inputs) > 2 and node.inputs[2]:
        value = float(ctx.const_val(node.inputs[2]))
    if mode == "constant":
        return ctx.sd._op("pad", [ctx.get(node.inputs[0])],
                          {"paddings": pairs, "constant": value})
    if mode == "reflect":
        return ctx.sd._op("mirrorPad", [ctx.get(node.inputs[0])],
                          {"paddings": pairs, "mode": "REFLECT"})
    raise ValueError(f"Pad mode {mode!r} unsupported")


# ---- spatial --------------------------------------------------------------
@_op("DepthToSpace")
def _depth_to_space(ctx, node):
    return ctx.sd._op("depthToSpace", [ctx.get(node.inputs[0])],
                      {"blockSize": int(node.attrs.get("blocksize", 2)),
                       "dataFormat": "NCHW",
                       "mode": node.attrs.get("mode", "DCR")})


@_op("SpaceToDepth")
def _space_to_depth(ctx, node):
    return ctx.sd._op("spaceToDepth", [ctx.get(node.inputs[0])],
                      {"blockSize": int(node.attrs.get("blocksize", 2)),
                       "dataFormat": "NCHW"})


@register_op("onnx_resize")
def _onnx_resize_impl(scaleH=1.0, scaleW=1.0, sizeH=0, sizeW=0,
                      method="nearest", **_):
    def fn(x):
        # x NCHW; output extent from explicit sizes or scales (shape is
        # static inside the op, so scales resolve here)
        oh = int(sizeH) or int(round(x.shape[2] * scaleH))
        ow = int(sizeW) or int(round(x.shape[3] * scaleW))
        y = _jax_resize(x.permute(0, 2, 3, 1), oh, ow, method)
        return y.permute(0, 3, 1, 2)
    return fn


@_op("Resize")
def _resize(ctx, node):
    # inputs: X, roi?, scales?, sizes?; NCHW
    mode = node.attrs.get("mode", "nearest")
    attrs = {"method": mode}
    if len(node.inputs) > 3 and node.inputs[3]:
        sizes = [int(v) for v in ctx.const_val(node.inputs[3])]
        attrs.update(sizeH=sizes[2], sizeW=sizes[3])
    elif len(node.inputs) > 2 and node.inputs[2]:
        scales = [float(v) for v in ctx.const_val(node.inputs[2])]
        attrs.update(scaleH=scales[2], scaleW=scales[3])
    else:
        raise ValueError("Resize without scales or sizes")
    return ctx.sd._op("onnx_resize", [ctx.get(node.inputs[0])], attrs)


@_op("ConvTranspose")
def _conv_transpose(ctx, node):
    W = ctx.const_val(node.inputs[1]).astype(np.float32)   # IOHW for deconv
    strides = node.attrs.get("strides", [1, 1])
    pads = node.attrs.get("pads", [0, 0, 0, 0])
    if pads[0] != pads[2] or pads[1] != pads[3]:
        raise ValueError("asymmetric ConvTranspose pads unsupported")
    attrs = {"kH": W.shape[2], "kW": W.shape[3], "sH": int(strides[0]),
             "sW": int(strides[1]), "pH": int(pads[0]), "pW": int(pads[1]),
             "isSameMode": node.attrs.get("auto_pad",
                                          "NOTSET") != "NOTSET",
             "dataFormat": "NCHW"}
    # ONNX ConvTranspose weight is (Cin, Cout, kH, kW); deconv2d wants
    # OIHW with O=Cout, I=Cin
    ins = [ctx.get(node.inputs[0]),
           ctx.weight(f"w_{node.name}", W.transpose(1, 0, 2, 3))]
    if len(node.inputs) > 2:
        ins.append(ctx.weight(
            f"b_{node.name}",
            ctx.const_val(node.inputs[2]).astype(np.float32)))
    return ctx.sd._op("deconv2d", ins, attrs)


@_op("InstanceNormalization")
def _instance_norm(ctx, node):
    return ctx.sd._op("instanceNorm",
                      [ctx.get(node.inputs[0]), ctx.get(node.inputs[1]),
                       ctx.get(node.inputs[2])],
                      {"epsilon": float(node.attrs.get("epsilon", 1e-5))})


@_op("GroupNormalization")
def _group_norm(ctx, node):
    return ctx.sd._op("groupNorm",
                      [ctx.get(node.inputs[0]), ctx.get(node.inputs[1]),
                       ctx.get(node.inputs[2])],
                      {"numGroups": int(node.attrs["num_groups"]),
                       "epsilon": float(node.attrs.get("epsilon", 1e-5))})


@_op("LpNormalization")
def _lp_normalization(ctx, node):
    p = int(node.attrs.get("p", 2))
    if p != 2:
        raise ValueError("LpNormalization p!=2 unsupported")
    return ctx.sd._op("l2Normalize", [ctx.get(node.inputs[0])],
                      {"dims": [int(node.attrs.get("axis", -1))]})


@_op("MeanVarianceNormalization")
def _mvn(ctx, node):
    return ctx.sd._op("standardize", [ctx.get(node.inputs[0])],
                      {"dims": list(node.attrs.get("axes", [0, 2, 3]))})


# ---- quantization ---------------------------------------------------------
def _qdq_params(ctx, node):
    """(scale, zero_point, qmin, qmax) with per-axis tensors reshaped to
    broadcast along the node's axis attr; saturation range follows the
    zero-point dtype (int8 vs uint8, ONNX saturation semantics)."""
    scale = np.asarray(ctx.const_val(node.inputs[1]), np.float32)
    if len(node.inputs) > 2 and node.inputs[2]:
        zp_arr = np.asarray(ctx.const_val(node.inputs[2]))
        signed = zp_arr.dtype in (np.int8, np.int16, np.int32)
        zp = zp_arr.astype(np.float32)
    else:
        signed, zp = False, np.float32(0.0)
    qmin, qmax = (-128.0, 127.0) if signed else (0.0, 255.0)
    # per-axis scale/zp stay 1-D here; _qdq_broadcast reshapes them
    # against the input's rank inside the op (static at trace time)
    return scale, zp, qmin, qmax


@_op("QuantizeLinear")
def _quantize_linear(ctx, node):
    # y = saturate(round(x / scale) + zero_point) — kept float (the
    # downstream DequantizeLinear undoes the affine; a pure-int8 compute
    # path is out of scope for import parity)
    sd = ctx.sd
    x = ctx.get(node.inputs[0])
    scale, zp, qmin, qmax = _qdq_params(ctx, node)
    axis = int(node.attrs.get("axis", 1))
    q = sd._op("onnx_qlinear", [x],
               {"scale": scale.tolist(), "zp": np.asarray(zp).tolist(),
                "qmin": qmin, "qmax": qmax, "axis": axis})
    return q


@_op("DequantizeLinear")
def _dequantize_linear(ctx, node):
    sd = ctx.sd
    x = ctx.get(node.inputs[0])
    scale, zp, _qmin, _qmax = _qdq_params(ctx, node)
    axis = int(node.attrs.get("axis", 1))
    return sd._op("onnx_dqlinear", [x],
                  {"scale": scale.tolist(),
                   "zp": np.asarray(zp).tolist(), "axis": axis})


def _qdq_broadcast(arr_list, x, axis):
    a = torch.as_tensor(np.asarray(arr_list, np.float32), device=x.device)
    if a.dim() == 0 or a.numel() == 1:
        return a.reshape(())
    shape = [1] * x.dim()
    shape[axis] = -1
    return a.reshape(shape)


@register_op("onnx_qlinear")
def _onnx_qlinear_impl(scale=1.0, zp=0.0, qmin=0.0, qmax=255.0, axis=1,
                       **_):
    def fn(x):
        s = _qdq_broadcast(scale, x, axis)
        z = _qdq_broadcast(zp, x, axis)
        # torch.round rounds half to even, as jnp.round does
        return torch.clamp(torch.round(x / s) + z, qmin, qmax)
    return fn


@register_op("onnx_dqlinear")
def _onnx_dqlinear_impl(scale=1.0, zp=0.0, axis=1, **_):
    def fn(x):
        s = _qdq_broadcast(scale, x, axis)
        z = _qdq_broadcast(zp, x, axis)
        return (x - z) * s
    return fn


# ---- bitwise (opset 18) ---------------------------------------------------
for onnx_name, our in [("BitwiseAnd", "bitwiseAnd"),
                       ("BitwiseOr", "bitwiseOr"),
                       ("BitwiseXor", "bitwiseXor")]:
    def _mk(our=our):
        def fn(ctx, node):
            return ctx.sd._op(our, [ctx.get(node.inputs[0]),
                                    ctx.get(node.inputs[1])])
        return fn
    _ONNX_OPS[onnx_name] = _mk()


@_op("BitwiseNot")
def _bitwise_not(ctx, node):
    return ctx.sd._op("bitwiseNot", [ctx.get(node.inputs[0])])


@_op("BitShift")
def _bit_shift(ctx, node):
    our = "leftShift" if node.attrs.get("direction",
                                        "LEFT") == "LEFT" else "rightShift"
    return ctx.sd._op(our, [ctx.get(node.inputs[0]),
                            ctx.get(node.inputs[1])])


# ---- random ---------------------------------------------------------------
@_op("RandomNormal")
def _random_normal(ctx, node):
    return ctx.sd._op("random_normal", [], {
        "shape": [int(v) for v in node.attrs.get("shape", [])],
        "mean": float(node.attrs.get("mean", 0.0)),
        "stddev": float(node.attrs.get("scale", 1.0)),
        "seed": int(node.attrs.get("seed", 0))})


@_op("RandomUniform")
def _random_uniform(ctx, node):
    return ctx.sd._op("random_uniform", [], {
        "shape": [int(v) for v in node.attrs.get("shape", [])],
        "minVal": float(node.attrs.get("low", 0.0)),
        "maxVal": float(node.attrs.get("high", 1.0)),
        "seed": int(node.attrs.get("seed", 0))})


@register_op("onnx_bernoulli")
def _onnx_bernoulli_impl(seed=0, **_):
    def fn(p):
        # per-element probabilities (ONNX Bernoulli semantics)
        u = torch.rand(tuple(p.shape), generator=_gen(seed)).to(p.device)
        return (u < p).to(p.dtype)
    return fn


@_op("Bernoulli")
def _bernoulli(ctx, node):
    return ctx.sd._op("onnx_bernoulli", [ctx.get(node.inputs[0])],
                      {"seed": int(node.attrs.get("seed", 0))})


# ---- misc -----------------------------------------------------------------
@_op("NonMaxSuppression")
def _nms(ctx, node):
    max_out = int(ctx.const_val(node.inputs[2])) \
        if len(node.inputs) > 2 else 10
    iou = float(ctx.const_val(node.inputs[3])) \
        if len(node.inputs) > 3 else 0.5
    st = float(ctx.const_val(node.inputs[4])) \
        if len(node.inputs) > 4 else -np.inf
    return ctx.sd._op("nonMaxSuppression",
                      [ctx.get(node.inputs[0]), ctx.get(node.inputs[1])],
                      {"maxOutputSize": max_out, "iouThreshold": iou,
                       "scoreThreshold": st})


@_op("Multinomial")
def _multinomial(ctx, node):
    return ctx.sd._op("multinomial", [ctx.get(node.inputs[0])],
                      {"numSamples": int(node.attrs.get("sample_size", 1)),
                       "seed": int(node.attrs.get("seed", 0))})


@_op("Det")
def _det(ctx, node):
    return ctx.sd._op("matrixDeterminant", [ctx.get(node.inputs[0])])


@_op("LpPool")
def _lp_pool(ctx, node):
    k = node.attrs.get("kernel_shape", [2, 2])
    s = node.attrs.get("strides", k)
    return ctx.sd._op("pnormPool2d", [ctx.get(node.inputs[0])],
                      {"kH": int(k[0]), "kW": int(k[1]),
                       "sH": int(s[0]), "sW": int(s[1]),
                       "pnorm": int(node.attrs.get("p", 2))})
