"""TF importer op-mapping breadth — sprint-3 rule table (round 4); the
port of ``deeplearning4j_tpu/imports/tf_import_ext2.py``.

Reference: samediff-import-tensorflow rules (SURVEY.md §2.3).  Maps the
TF op names the sprint-5 registry unlocked (tensor_scatter, einsum,
searchsorted, recurrent blocks, extended image/random/shape families)
plus common shape/metadata ops.  Imported for side effects at the
bottom of ``tf_import.py``.
"""
from __future__ import annotations

import numpy as np

import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import register_op
from deeplearning4j_tpu_torch.imports.tf_import import (TF_OPS, _attr,
                                                        _data_inputs,
                                                        _simple_map,
                                                        register_tf_op)
from deeplearning4j_tpu_torch.nn.conf.layers import _pad2d, _same_pads

# ---- shape / metadata ----------------------------------------------------
for _tf, _ours, _n in [("Shape", "shape_of", 1), ("Size", "size", 1),
                       ("Rank", "rank", 1), ("BroadcastTo", "broadcastTo", 2),
                       ("BroadcastArgs", "broadcastDynamicShape", 2),
                       ("InvertPermutation", "invertPermutation", 1),
                       ("UnravelIndex", "unravelIndex", 2),
                       ("Diag", "matrixDiag", 1),
                       ("DiagPart", "diagPart", 1),
                       ("MatrixSetDiag", "matrixSetDiag", 2),
                       ("MatrixSetDiagV2", "matrixSetDiag", 2),
                       ("MatrixSetDiagV3", "matrixSetDiag", 2),
                       ("MatrixDiagPartV2", "matrixDiagPart", 1),
                       ("MatrixDiagPartV3", "matrixDiagPart", 1),
                       ("ReverseSequence", "reverseSequence", 2)]:
    _simple_map(_tf, _ours, n_in=_n)


@register_tf_op("BroadcastTo")
def _tf_broadcast_to(ctx, node):
    ins = _data_inputs(node)
    shape = tuple(int(v) for v in np.atleast_1d(ctx.const(ins[1])))
    ctx.put(node.name, ctx.sd._op("broadcastTo", [ctx.get(ins[0])],
                                  {"shape": shape}, name=node.name))


def _tf_space_depth(our):
    def fn(ctx, node):
        df = _attr(node, "data_format", b"NHWC")
        df = df.decode() if isinstance(df, bytes) else str(df)
        ctx.put(node.name, ctx.sd._op(
            our, [ctx.get(_data_inputs(node)[0])],
            {"blockSize": int(_attr(node, "block_size", 2)),
             "dataFormat": df}, name=node.name))
    return fn


register_tf_op("SpaceToDepth")(_tf_space_depth("spaceToDepth"))
register_tf_op("DepthToSpace")(_tf_space_depth("depthToSpace"))


@register_tf_op("ShapeN")
def _tf_shape_n(ctx, node):
    ins = _data_inputs(node)
    outs = ctx.sd._op("shapeN", [ctx.get(i) for i in ins],
                      n_out=len(ins), name=node.name)
    outs = outs if isinstance(outs, list) else [outs]
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


# ---- scatter / gather ----------------------------------------------------
for _tf, _ours in [("TensorScatterAdd", "tensorScatterAdd"),
                   ("TensorScatterSub", "tensorScatterSub"),
                   ("TensorScatterMax", "tensorScatterMax"),
                   ("TensorScatterMin", "tensorScatterMin"),
                   ("TensorScatterUpdate", "tensorScatterUpdate")]:
    _simple_map(_tf, _ours, n_in=3)


@register_tf_op("ScatterNd")
def _tf_scatter_nd(ctx, node):
    ins = _data_inputs(node)
    shape = tuple(int(v) for v in np.atleast_1d(ctx.const(ins[2])))
    ctx.put(node.name, ctx.sd._op(
        "scatterNd", [ctx.get(ins[0]), ctx.get(ins[1])],
        {"shape": shape}, name=node.name))


@register_tf_op("Einsum")
def _tf_einsum(ctx, node):
    eq = _attr(node, "equation", "")
    eq = eq.decode() if isinstance(eq, bytes) else str(eq)
    ctx.put(node.name, ctx.sd._op(
        "einsum", [ctx.get(i) for i in _data_inputs(node)],
        {"equation": eq}, name=node.name))


@register_tf_op("SearchSorted")
def _tf_searchsorted(ctx, node):
    side = _attr(node, "side", b"left")
    side = side.decode() if isinstance(side, bytes) else str(side)
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "searchsorted", [ctx.get(ins[0]), ctx.get(ins[1])],
        {"right": side == "right"}, name=node.name))


@register_tf_op("Bucketize")
def _tf_bucketize(ctx, node):
    ctx.put(node.name, ctx.sd._op(
        "bucketize", [ctx.get(_data_inputs(node)[0])],
        {"boundaries": list(_attr(node, "boundaries", []))},
        name=node.name))


# ---- random --------------------------------------------------------------
def _tf_random(tf_name, our, extra=()):
    @register_tf_op(tf_name)
    def _f(ctx, node, _our=our, _extra=tuple(extra)):
        ins = _data_inputs(node)
        shape = tuple(int(v) for v in np.atleast_1d(ctx.const(ins[0])))
        attrs = {"shape": shape, "seed": int(_attr(node, "seed", 0) or 0)}
        attrs.update(dict(_extra))
        ctx.put(node.name, ctx.sd._op(_our, [], attrs, name=node.name))


_tf_random("RandomStandardNormal", "random_normal")
_tf_random("RandomUniform", "random_uniform")
_tf_random("TruncatedNormal", "random_truncated_normal")


@register_tf_op("RandomShuffle")
def _tf_random_shuffle(ctx, node):
    ctx.put(node.name, ctx.sd._op(
        "random_shuffle", [ctx.get(_data_inputs(node)[0])],
        {"seed": int(_attr(node, "seed", 0) or 0)}, name=node.name))


@register_tf_op("Multinomial")
def _tf_multinomial(ctx, node):
    ins = _data_inputs(node)
    n = int(np.atleast_1d(ctx.const(ins[1]))[0])
    ctx.put(node.name, ctx.sd._op(
        "multinomial", [ctx.get(ins[0])],
        {"numSamples": n, "seed": int(_attr(node, "seed", 0) or 0)},
        name=node.name))


# ---- image ---------------------------------------------------------------
@register_tf_op("ResizeBicubic")
def _tf_resize_bicubic(ctx, node):
    ins = _data_inputs(node)
    hw = [int(v) for v in np.atleast_1d(ctx.const(ins[1]))]
    ctx.put(node.name, ctx.sd._op(
        "resizeBicubic", [ctx.get(ins[0])],
        {"height": hw[0], "width": hw[1]}, name=node.name))


@register_tf_op("ResizeArea")
def _tf_resize_area(ctx, node):
    ins = _data_inputs(node)
    hw = [int(v) for v in np.atleast_1d(ctx.const(ins[1]))]
    ctx.put(node.name, ctx.sd._op(
        "imageResize", [ctx.get(ins[0])],
        {"height": hw[0], "width": hw[1], "method": "area"},
        name=node.name))


@register_tf_op("CropAndResize")
def _tf_crop_and_resize(ctx, node):
    ins = _data_inputs(node)
    cs = [int(v) for v in np.atleast_1d(ctx.const(ins[3]))]
    meth = _attr(node, "method", b"bilinear")
    meth = meth.decode() if isinstance(meth, bytes) else str(meth)
    ctx.put(node.name, ctx.sd._op(
        "cropAndResize",
        [ctx.get(ins[0]), ctx.get(ins[1]), ctx.get(ins[2])],
        {"cropHeight": cs[0], "cropWidth": cs[1], "method": meth},
        name=node.name))


for _tf, _ours in [("HSVToRGB", "hsvToRgb"), ("RGBToHSV", "rgbToHsv")]:
    _simple_map(_tf, _ours, n_in=1)


@register_tf_op("AdjustContrastv2")
def _tf_adjust_contrast(ctx, node):
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "adjustContrast", [ctx.get(ins[0])],
        {"factor": float(np.atleast_1d(ctx.const(ins[1]))[0])},
        name=node.name))


@register_tf_op("AdjustHue")
def _tf_adjust_hue(ctx, node):
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "adjustHue", [ctx.get(ins[0])],
        {"delta": float(np.atleast_1d(ctx.const(ins[1]))[0])},
        name=node.name))


@register_tf_op("AdjustSaturation")
def _tf_adjust_saturation(ctx, node):
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "adjustSaturation", [ctx.get(ins[0])],
        {"factor": float(np.atleast_1d(ctx.const(ins[1]))[0])},
        name=node.name))


@register_tf_op("ExtractImagePatches")
def _tf_extract_patches(ctx, node):
    ks = list(_attr(node, "ksizes", [1, 1, 1, 1]))
    ss = list(_attr(node, "strides", [1, 1, 1, 1]))
    rs = list(_attr(node, "rates", [1, 1, 1, 1]))
    if any(int(r) != 1 for r in rs):
        raise ValueError("ExtractImagePatches: rates != 1 unsupported")
    pad = _attr(node, "padding", b"VALID")
    pad = pad.decode() if isinstance(pad, bytes) else str(pad)
    ctx.put(node.name, ctx.sd._op(
        "extractImagePatches", [ctx.get(_data_inputs(node)[0])],
        {"kH": int(ks[1]), "kW": int(ks[2]), "sH": int(ss[1]),
         "sW": int(ss[2]), "isSameMode": pad == "SAME"}, name=node.name))


# ---- losses --------------------------------------------------------------
@register_tf_op("SoftmaxCrossEntropyWithLogits")
def _tf_softmax_ce(ctx, node):
    # the raw TF op returns PER-EXAMPLE losses (reduction happens in
    # the surrounding graph)
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "softmaxCrossEntropyWithLogits",
        [ctx.get(ins[0]), ctx.get(ins[1])],
        {"reduction": "NONE"}, name=node.name))


@register_tf_op("SparseSoftmaxCrossEntropyWithLogits")
def _tf_sparse_softmax_ce(ctx, node):
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "sparseSoftmaxCrossEntropy",
        [ctx.get(ins[0]), ctx.get(ins[1])],
        {"reduction": "NONE"}, name=node.name))


# ---- recurrent blocks ----------------------------------------------------
@register_tf_op("LSTMBlockCell")
def _tf_lstm_block_cell(ctx, node):
    # TF inputs: x, cs_prev, h_prev, w, wci, wcf, wco, b
    ins = [ctx.get(i) for i in _data_inputs(node)[:8]]
    x, cs, h, w, wci, wcf, wco, b = ins
    outs = ctx.sd._op(
        "lstmBlockCell", [x, cs, h, w, wci, wcf, wco, b],
        {"forgetBias": float(_attr(node, "forget_bias", 1.0)),
         "peephole": bool(_attr(node, "use_peephole", False))},
        n_out=7, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("BlockLSTM", "BlockLSTMV2")
def _tf_block_lstm(ctx, node):
    # TF inputs: seq_len_max, x, cs_prev, h_prev, w, wci, wcf, wco, b
    ins = _data_inputs(node)
    args = [ctx.get(i) for i in ins[1:9]]
    outs = ctx.sd._op(
        "lstmBlock", args,
        {"forgetBias": float(_attr(node, "forget_bias", 1.0)),
         "peephole": bool(_attr(node, "use_peephole", False))},
        n_out=7, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


# ---- misc ----------------------------------------------------------------
for _tf, _ours, _n in [("Xdivy", "xdivy", 2), ("Xlogy", "xlogy", 2),
                       ("TruncateDiv", "truncateDiv", 2),
                       ("LogMatrixDeterminant", "logMatrixDeterminant", 1)]:
    _simple_map(_tf, _ours, n_in=_n)


@register_tf_op("ClipByValue")
def _tf_clip(ctx, node):
    ins = _data_inputs(node)
    lo = float(np.atleast_1d(ctx.const(ins[1]))[0])
    hi = float(np.atleast_1d(ctx.const(ins[2]))[0])
    ctx.put(node.name, ctx.sd._op(
        "clipByValue", [ctx.get(ins[0])],
        {"clipValueMin": lo, "clipValueMax": hi}, name=node.name))


@register_tf_op("LinSpace")
def _tf_linspace(ctx, node):
    ins = _data_inputs(node)
    ctx.put(node.name, ctx.sd._op(
        "linspace", [],
        {"start": float(np.atleast_1d(ctx.const(ins[0]))[0]),
         "stop": float(np.atleast_1d(ctx.const(ins[1]))[0]),
         "num": int(np.atleast_1d(ctx.const(ins[2]))[0])},
        name=node.name))


@register_tf_op("SparseToDense")
def _tf_sparse_to_dense(ctx, node):
    ins = _data_inputs(node)
    shape = np.atleast_1d(ctx.const(ins[1])).astype(np.int64)
    default = 0.0
    if len(ins) > 3:
        default = float(np.atleast_1d(ctx.const(ins[3]))[0])
    ctx.put(node.name, ctx.sd._op(
        "sparseToDense",
        [ctx.get(ins[0]), ctx.sd.constant(shape,
                                          name=f"{node.name}_shape"),
         ctx.get(ins[2])],
        {"defaultValue": default}, name=node.name))


def _tf_cumulative(our):
    def fn(ctx, node):
        if bool(_attr(node, "exclusive", False)) or \
                bool(_attr(node, "reverse", False)):
            raise ValueError(f"{our}: exclusive/reverse unsupported")
        ins = _data_inputs(node)
        axis = int(np.atleast_1d(ctx.const(ins[1]))[0])
        ctx.put(node.name, ctx.sd._op(our, [ctx.get(ins[0])],
                                      {"axis": axis}, name=node.name))
    return fn


register_tf_op("Cumsum")(_tf_cumulative("cumsum"))
register_tf_op("Cumprod")(_tf_cumulative("cumprod"))


# ---- round-5 conv family additions ---------------------------------------
TF_OPS["BatchMatMulV3"] = TF_OPS["BatchMatMulV2"]


@register_tf_op("DepthwiseConv2dNative")
def _tf_depthwise_conv2d(ctx, node):
    x, w = _data_inputs(node)[:2]
    strides = _attr(node, "strides", [1, 1, 1, 1])
    fmt = _attr(node, "data_format", "NHWC")
    fmt = fmt.decode() if isinstance(fmt, bytes) else fmt
    dil = _attr(node, "dilations", [1, 1, 1, 1])
    if fmt == "NHWC":
        sH, sW, dH, dW = strides[1], strides[2], dil[1], dil[2]
    else:
        sH, sW, dH, dW = strides[2], strides[3], dil[2], dil[3]
    pad = _attr(node, "padding", b"VALID")
    pad = pad.decode() if isinstance(pad, bytes) else pad
    if pad not in ("SAME", "VALID"):
        raise NotImplementedError(
            f"DepthwiseConv2dNative padding={pad!r} unsupported")
    ctx.put(node.name, ctx.sd._op(
        "tf_depthwiseConv2d", [ctx.get(x), ctx.get(w)],
        {"sH": int(sH), "sW": int(sW), "dH": int(dH), "dW": int(dW),
         "isSameMode": pad == "SAME", "dataFormat": fmt},
        name=node.name))


@register_op("tf_depthwiseConv2d")
def _tf_depthwise2d_impl(sH=1, sW=1, dH=1, dW=1, isSameMode=False,
                         dataFormat="NHWC", **_):
    def f(x, w):
        # TF kernel (kh, kw, c, m) -> grouped OIHW (c*m, 1, kh, kw)
        kh, kw, c, m = w.shape
        wk = w.permute(2, 3, 0, 1).reshape(c * m, 1, kh, kw)
        if dataFormat == "NHWC":
            x = x.permute(0, 3, 1, 2)
        if isSameMode:
            x = _pad2d(x, (_same_pads(x.shape[2], kh, int(sH), int(dH)),
                           _same_pads(x.shape[3], kw, int(sW), int(dW))))
        y = F.conv2d(x, wk, stride=(int(sH), int(sW)),
                     dilation=(int(dH), int(dW)), groups=c)
        if dataFormat == "NHWC":
            y = y.permute(0, 2, 3, 1)
        return y
    return f


@register_tf_op("Conv2DBackpropInput")
def _tf_conv2d_backprop_input(ctx, node):
    """The deconvolution/generator pattern: inputs are
    (input_sizes, filter, out_backprop) — input_sizes must be constant."""
    ins = _data_inputs(node)
    sizes = [int(v) for v in np.atleast_1d(ctx.const(ins[0])).reshape(-1)]
    strides = _attr(node, "strides", [1, 1, 1, 1])
    if any(int(d) != 1 for d in _attr(node, "dilations", [1, 1, 1, 1])):
        raise NotImplementedError(
            "Conv2DBackpropInput dilations != 1 unsupported")
    fmt = _attr(node, "data_format", "NHWC")
    fmt = fmt.decode() if isinstance(fmt, bytes) else fmt
    if fmt == "NHWC":
        sH, sW = strides[1], strides[2]
        oh, ow = sizes[1], sizes[2]
    else:
        sH, sW = strides[2], strides[3]
        oh, ow = sizes[2], sizes[3]
    pad = _attr(node, "padding", b"VALID")
    pad = pad.decode() if isinstance(pad, bytes) else pad
    if pad not in ("SAME", "VALID"):
        raise NotImplementedError(
            f"Conv2DBackpropInput padding={pad!r} unsupported")
    ctx.put(node.name, ctx.sd._op(
        "tf_conv2dBackpropInput", [ctx.get(ins[1]), ctx.get(ins[2])],
        {"sH": int(sH), "sW": int(sW), "isSameMode": pad == "SAME",
         "dataFormat": fmt, "oH": int(oh), "oW": int(ow)},
        name=node.name))


@register_op("tf_conv2dBackpropInput")
def _tf_conv2d_backprop_input_impl(sH=1, sW=1, isSameMode=False,
                                   dataFormat="NHWC", oH=0, oW=0, **_):
    def f(w, dy):
        # TF filter (kh, kw, in, out); dy carries OUT channels; the
        # transposed conv contracts over out and emits IN channels
        kh, kw = w.shape[0], w.shape[1]
        wk = w.permute(2, 3, 0, 1).flip(2, 3)         # (in, out, kh, kw)
        if dataFormat == "NHWC":
            dy = dy.permute(0, 3, 1, 2)
        ih, iw = dy.shape[2], dy.shape[3]

        # out = (in-1)*s + 1 + lo + hi - (k-1) must equal oH/oW; the low
        # pad comes from the forward conv's top pad (TF SAME: the smaller
        # half, clamped at 0 — kernel < stride pads nothing), the high
        # side absorbs the remainder (a negative pad crops)
        def grad_pads(k, s, i, o):
            pt = max((i - 1) * s + k - o, 0) // 2 if isSameMode else 0
            lo = k - 1 - pt
            return (lo, (o + k - 2 - (i - 1) * s) - lo)
        (t, b), (l, r) = (grad_pads(kh, int(sH), ih, int(oH)),
                          grad_pads(kw, int(sW), iw, int(oW)))
        # lhs dilation: s - 1 zeros between the inputs along each axis
        up = dy.new_zeros(dy.shape[0], dy.shape[1], (ih - 1) * int(sH) + 1,
                          (iw - 1) * int(sW) + 1)
        up[:, :, ::int(sH), ::int(sW)] = dy
        y = F.conv2d(F.pad(up, (l, r, t, b)), wk)
        if dataFormat == "NHWC":
            y = y.permute(0, 2, 3, 1)
        return y
    return f
