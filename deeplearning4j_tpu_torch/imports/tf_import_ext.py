"""TF importer op-mapping breadth — sprint-2 rule table; the port of
``deeplearning4j_tpu/imports/tf_import_ext.py``.

Reference: samediff-import-tensorflow's per-op mapping rules (SURVEY.md
§2.3) — this module extends ``tf_import.TF_OPS`` onto the round-3 op
registry (roll/mirrorPad/unique/dynamic*/fft/decompositions/bitwise/…).
Imported for its registration side effects at the bottom of
``tf_import.py``.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.imports.tf_import import (_attr,
                                                        _data_inputs,
                                                        register_tf_op,
                                                        _simple_map)

# ---- elementwise families ------------------------------------------------
for _tf, _ours in [("Asinh", "asinh"), ("Acosh", "acosh"),
                   ("Atanh", "atanh"), ("Digamma", "digamma"),
                   ("Lgamma", "lgamma"), ("Expm1", "expm1"),
                   ("Rint", "rint"), ("Inv", "reciprocal"),
                   ("Invert", "bitwiseNot"), ("OnesLike", "onesLike"),
                   ("ZerosLike", "zerosLike"), ("Erfinv", "erfinv"),
                   ("PopulationCount", "bitCount")]:
    _simple_map(_tf, _ours, n_in=1)

for _tf, _ours in [("Atan2", "atan2"), ("Igamma", "igamma"),
                   ("Igammac", "igammac"), ("Zeta", "zeta"),
                   ("Polygamma", "polygamma"), ("DivNoNan", "divNoNan"),
                   ("TruncateMod", "fmod"), ("Mod", "mod"),
                   ("BitwiseAnd", "bitwiseAnd"), ("BitwiseOr", "bitwiseOr"),
                   ("BitwiseXor", "bitwiseXor"), ("LeftShift", "leftShift"),
                   ("RightShift", "rightShift"), ("Cross", "cross"),
                   ("NextAfter", "nextAfter"),
                   ("LogicalXor", "xor")]:
    _simple_map(_tf, _ours, n_in=2)

for _tf, _ours in [("Betainc", "betainc")]:
    _simple_map(_tf, _ours, n_in=3)

# ---- linalg --------------------------------------------------------------
for _tf, _ours in [("MatrixDeterminant", "matrixDeterminant"),
                   ("MatrixInverse", "matrixInverse"),
                   ("Cholesky", "cholesky"),
                   ("MatrixDiagPart", "matrixDiagPart"),
                   ("L2Loss", "l2Loss")]:
    _simple_map(_tf, _ours, n_in=1)
for _tf, _ours in [("MatrixSolve", "solve"), ("GatherNd", "gatherNd")]:
    _simple_map(_tf, _ours, n_in=2)


@register_tf_op("MatrixTriangularSolve")
def _tf_tri_solve(ctx, node):
    a, b = [ctx.get(i) for i in _data_inputs(node)[:2]]
    ctx.put(node.name, ctx.sd._op(
        "triangularSolve", [a, b],
        {"lower": bool(_attr(node, "lower", True)),
         "adjoint": bool(_attr(node, "adjoint", False))}, name=node.name))


@register_tf_op("MatrixBandPart")
def _tf_band_part(ctx, node):
    ins = _data_inputs(node)
    lo = int(np.atleast_1d(ctx.const(ins[1]))[0])
    hi = int(np.atleast_1d(ctx.const(ins[2]))[0])
    ctx.put(node.name, ctx.sd._op(
        "matrixBandPart", [ctx.get(ins[0])],
        {"numLower": lo, "numUpper": hi}, name=node.name))


@register_tf_op("Svd")
def _tf_svd(ctx, node):
    outs = ctx.sd._op("svd", [ctx.get(_data_inputs(node)[0])],
                      {"fullUV": bool(_attr(node, "full_matrices", False)),
                       "computeUv": bool(_attr(node, "compute_uv", True))},
                      n_out=3, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("Qr")
def _tf_qr(ctx, node):
    outs = ctx.sd._op("qr", [ctx.get(_data_inputs(node)[0])],
                      {"fullMatrices": bool(_attr(node, "full_matrices",
                                                  False))},
                      n_out=2, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


# ---- fft -----------------------------------------------------------------
for _tf, _ours in [("FFT", "fft"), ("IFFT", "ifft"), ("FFT2D", "fft2d"),
                   ("IFFT2D", "ifft2d")]:
    _simple_map(_tf, _ours, n_in=1)


@register_tf_op("RFFT")
def _tf_rfft(ctx, node):
    ctx.put(node.name, ctx.sd._op("rfft",
                                  [ctx.get(_data_inputs(node)[0])],
                                  name=node.name))


@register_tf_op("IRFFT")
def _tf_irfft(ctx, node):
    ins = _data_inputs(node)
    n = None
    if len(ins) > 1:
        n = int(np.atleast_1d(ctx.const(ins[1]))[-1])
    ctx.put(node.name, ctx.sd._op("irfft", [ctx.get(ins[0])],
                                  {"n": n}, name=node.name))


# ---- data movement -------------------------------------------------------
@register_tf_op("Roll")
def _tf_roll(ctx, node):
    ins = _data_inputs(node)
    shift = np.atleast_1d(ctx.const(ins[1])).astype(int).tolist()
    axes = np.atleast_1d(ctx.const(ins[2])).astype(int).tolist()
    ctx.put(node.name, ctx.sd._op(
        "roll", [ctx.get(ins[0])],
        {"shift": tuple(shift) if len(shift) > 1 else shift[0],
         "dims": tuple(axes)}, name=node.name))


@register_tf_op("MirrorPad")
def _tf_mirror_pad(ctx, node):
    ins = _data_inputs(node)
    pads = tuple(tuple(int(v) for v in row)
                 for row in np.asarray(ctx.const(ins[1])))
    ctx.put(node.name, ctx.sd._op(
        "mirrorPad", [ctx.get(ins[0])],
        {"mode": _attr(node, "mode", "REFLECT"), "paddings": pads},
        name=node.name))


@register_tf_op("ReverseV2")
def _tf_reverse(ctx, node):
    ins = _data_inputs(node)
    axes = np.atleast_1d(ctx.const(ins[1])).astype(int).tolist()
    ctx.put(node.name, ctx.sd._op("reverse", [ctx.get(ins[0])],
                                  {"dims": tuple(axes)}, name=node.name))


@register_tf_op("Unique")
def _tf_unique(ctx, node):
    outs = ctx.sd._op("unique", [ctx.get(_data_inputs(node)[0])],
                      n_out=2, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("UniqueWithCounts")
def _tf_unique_counts(ctx, node):
    outs = ctx.sd._op("uniqueWithCounts",
                      [ctx.get(_data_inputs(node)[0])],
                      n_out=3, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("ListDiff")
def _tf_listdiff(ctx, node):
    ins = _data_inputs(node)
    outs = ctx.sd._op("listDiff", [ctx.get(ins[0]), ctx.get(ins[1])],
                      n_out=2, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("DynamicPartition")
def _tf_dyn_partition(ctx, node):
    ins = _data_inputs(node)
    k = int(_attr(node, "num_partitions", 2))
    outs = ctx.sd._op("dynamicPartition",
                      [ctx.get(ins[0]), ctx.get(ins[1])],
                      {"numPartitions": k}, n_out=k, name=node.name)
    outs = outs if isinstance(outs, list) else [outs]
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("DynamicStitch", "ParallelDynamicStitch")
def _tf_dyn_stitch(ctx, node):
    ins = [ctx.get(i) for i in _data_inputs(node)]
    k = len(ins) // 2
    ctx.put(node.name, ctx.sd._op("dynamicStitch", ins,
                                  {"numPartitions": k}, name=node.name))


@register_tf_op("TopKV2")
def _tf_topk(ctx, node):
    ins = _data_inputs(node)
    k = int(np.atleast_1d(ctx.const(ins[1]))[0])
    outs = ctx.sd._op("topK", [ctx.get(ins[0])],
                      {"k": k, "sorted": bool(_attr(node, "sorted", True))},
                      n_out=2, name=node.name)
    for i, o in enumerate(outs):
        ctx.put(f"{node.name}:{i}" if i else node.name, o)


@register_tf_op("InTopKV2", "InTopK")
def _tf_in_topk(ctx, node):
    ins = _data_inputs(node)
    if len(ins) > 2:
        k = int(np.atleast_1d(ctx.const(ins[2]))[0])
    else:
        k = int(_attr(node, "k", 1))
    ctx.put(node.name, ctx.sd._op(
        "inTopK", [ctx.get(ins[0]), ctx.get(ins[1])], {"k": k},
        name=node.name))


@register_tf_op("HistogramFixedWidth")
def _tf_histogram(ctx, node):
    ins = _data_inputs(node)
    nbins = int(np.atleast_1d(ctx.const(ins[2]))[0]) if len(ins) > 2 \
        else int(_attr(node, "nbins", 100))
    ctx.put(node.name, ctx.sd._op(
        "histogramFixedWidth", [ctx.get(ins[0]), ctx.get(ins[1])],
        {"numBins": nbins}, name=node.name))


@register_tf_op("Bincount")
def _tf_bincount(ctx, node):
    ins = _data_inputs(node)
    size = int(np.atleast_1d(ctx.const(ins[1]))[0])
    ctx.put(node.name, ctx.sd._op("bincount", [ctx.get(ins[0])],
                                  {"maxLength": size}, name=node.name))


@register_tf_op("ArgMin")
def _tf_argmin(ctx, node):
    ins = _data_inputs(node)
    axis = int(np.atleast_1d(ctx.const(ins[1]))[0]) if len(ins) > 1 else 0
    ctx.put(node.name, ctx.sd._op("argmin", [ctx.get(ins[0])],
                                  {"dimension": axis}, name=node.name))


# ---- segments ------------------------------------------------------------
for _tf, _ours in [("SegmentSum", "segmentSum"),
                   ("SegmentMean", "segmentMean"),
                   ("SegmentMax", "segmentMax"),
                   ("SegmentMin", "segmentMin"),
                   ("SegmentProd", "segmentProd")]:
    @register_tf_op(_tf)
    def _seg(ctx, node, _op=_ours):
        ins = _data_inputs(node)
        seg = np.atleast_1d(ctx.const(ins[1])).astype(int)
        ctx.put(node.name, ctx.sd._op(
            _op, [ctx.get(ins[0]), ctx.get(ins[1])],
            {"numSegments": int(seg.max()) + 1}, name=node.name))


for _tf, _ours in [("UnsortedSegmentSum", "unsortedSegmentSum"),
                   ("UnsortedSegmentMax", "unsortedSegmentMax"),
                   ("UnsortedSegmentMin", "unsortedSegmentMin"),
                   ("UnsortedSegmentProd", "unsortedSegmentProd")]:
    @register_tf_op(_tf)
    def _useg(ctx, node, _op=_ours):
        ins = _data_inputs(node)
        n = int(np.atleast_1d(ctx.const(ins[2]))[0])
        ctx.put(node.name, ctx.sd._op(
            _op, [ctx.get(ins[0]), ctx.get(ins[1])],
            {"numSegments": n}, name=node.name))


# ---- image ---------------------------------------------------------------
@register_tf_op("ResizeBilinear", "ResizeNearestNeighbor")
def _tf_resize(ctx, node):
    ins = _data_inputs(node)
    size = np.atleast_1d(ctx.const(ins[1])).astype(int)
    our = "resizeBilinear" if node.op == "ResizeBilinear" \
        else "resizeNearestNeighbor"
    ctx.put(node.name, ctx.sd._op(
        our, [ctx.get(ins[0])],
        {"height": int(size[0]), "width": int(size[1]),
         "alignCorners": bool(_attr(node, "align_corners", False))},
        name=node.name))


@register_tf_op("NonMaxSuppressionV3", "NonMaxSuppressionV2",
                "NonMaxSuppression")
def _tf_nms(ctx, node):
    ins = _data_inputs(node)
    k = int(np.atleast_1d(ctx.const(ins[2]))[0])
    iou = float(np.atleast_1d(ctx.const(ins[3]))[0]) if len(ins) > 3 \
        else float(_attr(node, "iou_threshold", 0.5))
    score = float(np.atleast_1d(ctx.const(ins[4]))[0]) if len(ins) > 4 \
        else -np.inf
    ctx.put(node.name, ctx.sd._op(
        "nonMaxSuppression", [ctx.get(ins[0]), ctx.get(ins[1])],
        {"maxOutputSize": k, "iouThreshold": iou,
         "scoreThreshold": score}, name=node.name))


@register_tf_op("LRN")
def _tf_lrn(ctx, node):
    r = int(_attr(node, "depth_radius", 5))
    ctx.put(node.name, ctx.sd._op(
        "localResponseNormalization",
        [ctx.get(_data_inputs(node)[0])],
        {"depth": 2 * r + 1, "bias": float(_attr(node, "bias", 1.0)),
         "alpha": float(_attr(node, "alpha", 1.0)),
         "beta": float(_attr(node, "beta", 0.5)),
         "dataFormat": "NHWC"}, name=node.name))
