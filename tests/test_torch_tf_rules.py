"""Port parity: every TF import rule of the port (``TF_OPS`` in
``deeplearning4j_tpu_torch/imports/tf_import*.py``) on a frozen graph that
holds its TF op, through both importers.

The reference's TF tests (``tests/test_imports.py``,
``tests/test_import_breadth.py``, the ``tests/test_tfgraph_corpus.py``
corpus, run in ``tests/test_torch_tf_import.py``) reach about half of the
rules; each rule they miss gets a one-op graph here.  Each graph is frozen
by the installed tensorflow, run by TF as the oracle, and imported by the
reference's ``TFGraphMapper`` and by the port's (``device="cpu"``).

What each case holds (``mode``):
- ``tf``: the port against TF (atol 1e-4 / rtol 1e-3, the corpus's
  tolerance; the special functions and the LSTM blocks 1e-3) and against
  the reference (atol 2e-5 / rtol 1e-4: both float32, summation order);
- ``ref``: the port against the reference only, where the reference
  implements the op with other semantics than TF's kernel (named at the
  case), which the port keeps;
- ``shape``: the RNG ops, whose bits differ between the packages and TF:
  the shape and dtype;
- ``recon``: ``Svd`` / ``Qr``, unique up to signs: the factors rebuild the
  input;
and ``test_rule_on_a_graph_written_by_hand`` takes the TF ops that no
tensorflow graph can hold (no such op in this TF build): a GraphDef written
by hand, through both importers, against numpy.
"""
import inspect

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.imports import TFGraphMapper as JMapper  # noqa: E402
from deeplearning4j_tpu_torch.imports import TFGraphMapper  # noqa: E402

from _torch_parity import _np  # noqa: E402

pytestmark = pytest.mark.torch_port

TF_TOL = dict(atol=1e-4, rtol=1e-3)
TF_LOOSE = dict(atol=1e-3, rtol=1e-3)
REF_TOL = dict(atol=2e-5, rtol=1e-4)
R = np.random.RandomState
raw = tf.raw_ops


def f32(*shape, seed=0, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def pos(*shape, seed=0):
    return (np.abs(R(seed).randn(*shape)) + 0.5).astype(np.float32)


def unit(*shape, seed=0):
    return R(seed).uniform(0.05, 0.95, shape).astype(np.float32)


def i32(*shape, lo=0, hi=10, seed=0):
    return R(seed).randint(lo, hi, shape).astype(np.int32)


def spd(n, seed=0):
    m = R(seed).randn(n, n)
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


X, Y = f32(3, 4, seed=1), f32(3, 4, seed=2)
P, Q = pos(3, 4, seed=1), pos(3, 4, seed=2)
IMG = unit(2, 6, 6, 3, seed=3)
BOXES = np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                  [0, 10, 1, 11], [0, 10.1, 1, 11.1], [0, 100, 1, 101]],
                 np.float32)
SCORES = np.array([0.9, 0.75, 0.6, 0.95, 0.5, 0.3], np.float32)
CPX = (f32(2, 8, seed=1) + 1j * f32(2, 8, seed=2)).astype(np.complex64)
CPX2 = (f32(4, 4, seed=1) + 1j * f32(4, 4, seed=2)).astype(np.complex64)
LSTM_W = f32(7, 16, seed=5, scale=0.3)
LSTM_B = f32(16, seed=6, scale=0.1)
PEEP = [f32(4, seed=s, scale=0.3) for s in (7, 8, 9)]

RULES = {}


def rule(op, fn, feeds, mode="tf", tol=TF_TOL):
    RULES.setdefault(op, []).append((fn, feeds, mode, tol))


# ---- elementwise ---------------------------------------------------------
for _op, _fn, _x in [
        ("Acosh", lambda a: raw.Acosh(x=a), P + 1),
        ("Asinh", lambda a: raw.Asinh(x=a), X),
        ("Atanh", lambda a: raw.Atanh(x=a), np.clip(X, -0.9, 0.9)),
        ("Digamma", lambda a: raw.Digamma(x=a), P),
        ("Erfinv", lambda a: raw.Erfinv(x=a), np.clip(X, -0.9, 0.9)),
        ("Expm1", lambda a: raw.Expm1(x=a), X),
        ("Lgamma", lambda a: raw.Lgamma(x=a), P),
        ("Rint", lambda a: raw.Rint(x=a), X * 3),
        ("Tan", lambda a: raw.Tan(x=a), X * 0.5),
        ("Inv", lambda a: raw.Inv(x=a), P),
        ("OnesLike", lambda a: raw.OnesLike(x=a), X),
        ("ZerosLike", lambda a: raw.ZerosLike(x=a), X),
        ("L2Loss", lambda a: raw.L2Loss(t=a), X),
        ("CheckNumerics", lambda a: raw.CheckNumerics(tensor=a,
                                                       message="m") * 2, X),
        ("PreventGradient", lambda a: raw.PreventGradient(input=a) * 2, X),
        ("Snapshot", lambda a: raw.Snapshot(input=a) * 2, X),
        ("StopGradient", lambda a: raw.StopGradient(input=a) * 2, X)]:
    rule(_op, _fn, [_x], tol=TF_LOOSE if _op in ("Digamma", "Lgamma")
         else TF_TOL)

_NF = np.array([[1.0, np.inf, -np.inf, np.nan]] * 3, np.float32)
for _op in ("IsFinite", "IsInf", "IsNan"):
    rule(_op, lambda a, _o=_op: getattr(raw, _o)(x=a), [_NF])

for _op, _fn, _xs, _tol in [
        ("Add", lambda a, b: raw.Add(x=a, y=b), [X, Y], TF_TOL),
        ("Div", lambda a, b: raw.Div(x=a, y=b), [X, P], TF_TOL),
        ("Atan2", lambda a, b: raw.Atan2(y=a, x=b), [X, Y], TF_TOL),
        ("DivNoNan", lambda a, b: raw.DivNoNan(x=a, y=b),
         [X, np.where(np.abs(Y) < 0.5, 0, Y).astype(np.float32)], TF_TOL),
        ("FloorMod", lambda a, b: raw.FloorMod(x=a, y=b), [X * 3, P],
         TF_TOL),
        ("Mod", lambda a, b: raw.Mod(x=a, y=b), [P * 3, Q], TF_TOL),
        ("TruncateMod", lambda a, b: raw.TruncateMod(x=a, y=b), [X * 3, P],
         TF_TOL),
        ("TruncateDiv", lambda a, b: raw.TruncateDiv(x=a, y=b),
         [i32(3, 4, lo=-20, hi=20), i32(3, 4, lo=1, hi=5, seed=1)], TF_TOL),
        ("Igamma", lambda a, b: raw.Igamma(a=a, x=b), [P, Q], TF_LOOSE),
        ("Igammac", lambda a, b: raw.Igammac(a=a, x=b), [P, Q], TF_LOOSE),
        ("NextAfter", lambda a, b: raw.NextAfter(x1=a, x2=b), [X, Y],
         TF_TOL),
        ("Polygamma", lambda a, b: raw.Polygamma(a=a, x=b),
         [np.array([[0, 1, 2, 3]] * 3, np.float32), P], TF_LOOSE),
        ("Zeta", lambda a, b: raw.Zeta(x=a, q=b), [P + 1, Q], TF_LOOSE),
        ("Equal", lambda a, b: raw.Equal(x=a, y=b), [X, np.where(
            X > 0, X, Y)], TF_TOL),
        ("NotEqual", lambda a, b: raw.NotEqual(x=a, y=b), [X, np.where(
            X > 0, X, Y)], TF_TOL),
        ("GreaterEqual", lambda a, b: raw.GreaterEqual(x=a, y=b), [X, Y],
         TF_TOL),
        ("Less", lambda a, b: raw.Less(x=a, y=b), [X, Y], TF_TOL),
        ("LessEqual", lambda a, b: raw.LessEqual(x=a, y=b), [X, Y], TF_TOL),
        ("LogicalOr", lambda a, b: raw.LogicalOr(x=a > 0, y=b > 0), [X, Y],
         TF_TOL),
        ("Cross", lambda a, b: raw.Cross(a=a, b=b),
         [f32(4, 3, seed=1), f32(4, 3, seed=2)], TF_TOL),
        ("BitwiseAnd", lambda a, b: raw.BitwiseAnd(x=a, y=b),
         [i32(3, 4, hi=1000), i32(3, 4, hi=1000, seed=1)], TF_TOL),
        ("BitwiseOr", lambda a, b: raw.BitwiseOr(x=a, y=b),
         [i32(3, 4, hi=1000), i32(3, 4, hi=1000, seed=1)], TF_TOL),
        ("BitwiseXor", lambda a, b: raw.BitwiseXor(x=a, y=b),
         [i32(3, 4, hi=1000), i32(3, 4, hi=1000, seed=1)], TF_TOL),
        ("LeftShift", lambda a, b: raw.LeftShift(x=a, y=b),
         [i32(3, 4, hi=1000), i32(3, 4, hi=8, seed=1)], TF_TOL),
        ("RightShift", lambda a, b: raw.RightShift(x=a, y=b),
         [i32(3, 4, lo=-1000, hi=1000), i32(3, 4, hi=8, seed=1)], TF_TOL)]:
    rule(_op, _fn, _xs, tol=_tol)
# TF's Mod truncates (C fmod); the reference maps it to its floor-mod
# "mod" (ROADMAP C11): TF's answer where the signs agree, the reference's
# everywhere
rule("Mod", lambda a, b: raw.Mod(x=a, y=b), [X * 3, P], mode="ref")

rule("Betainc", lambda a, b, c: raw.Betainc(a=a, b=b, x=c),
     [P, Q, unit(3, 4)], tol=TF_LOOSE)
rule("Invert", lambda a: raw.Invert(x=a), [i32(3, 4, lo=-500, hi=500)])
rule("PopulationCount", lambda a: raw.PopulationCount(x=a),
     [i32(3, 4, lo=-1000, hi=1000)])
rule("ClipByValue", lambda a: raw.ClipByValue(
    t=a, clip_value_min=-0.5, clip_value_max=0.7), [X])

# ---- reductions, arg ops, cumulative -------------------------------------
rule("All", lambda a: raw.All(input=a > 0, axis=[1]), [X])
rule("Any", lambda a: raw.Any(input=a > 0, axis=[0], keep_dims=True), [X])
rule("ArgMin", lambda a: raw.ArgMin(input=a, dimension=1), [X])
rule("Cumprod", lambda a: raw.Cumprod(x=a, axis=1), [X])

# ---- linalg --------------------------------------------------------------
S4 = spd(4)
rule("Cholesky", lambda a: raw.Cholesky(input=a), [S4])
rule("MatrixDeterminant", lambda a: raw.MatrixDeterminant(input=a), [S4],
     tol=dict(atol=1e-2, rtol=1e-4))
rule("MatrixInverse", lambda a: raw.MatrixInverse(input=a), [S4])
rule("MatrixSolve", lambda a, b: raw.MatrixSolve(matrix=a, rhs=b),
     [S4, f32(4, 2)])
rule("MatrixTriangularSolve", lambda a, b: raw.MatrixTriangularSolve(
    matrix=a, rhs=b, lower=True, adjoint=True), [np.tril(S4), f32(4, 2)])
rule("MatrixBandPart", lambda a: raw.MatrixBandPart(
    input=a, num_lower=1, num_upper=0), [f32(4, 5)])
rule("MatrixDiagPart", lambda a: raw.MatrixDiagPart(input=a),
     [f32(2, 3, 4)])
rule("MatrixDiagPartV2", lambda a: raw.MatrixDiagPartV2(
    input=a, k=0, padding_value=0.0), [f32(2, 3, 4)])
rule("MatrixDiagPartV3", lambda a: raw.MatrixDiagPartV3(
    input=a, k=0, padding_value=0.0), [f32(2, 3, 4)])
rule("MatrixSetDiag", lambda a, b: raw.MatrixSetDiag(input=a, diagonal=b),
     [f32(2, 3, 4), f32(2, 3, seed=1)])
rule("MatrixSetDiagV2", lambda a, b: raw.MatrixSetDiagV2(
    input=a, diagonal=b, k=0), [f32(2, 3, 4), f32(2, 3, seed=1)])
rule("MatrixSetDiagV3", lambda a, b: raw.MatrixSetDiagV3(
    input=a, diagonal=b, k=0), [f32(2, 3, 4), f32(2, 3, seed=1)])
rule("Diag", lambda a: raw.Diag(diagonal=a), [f32(4)])
rule("DiagPart", lambda a: raw.DiagPart(input=a), [f32(4, 4)])
rule("LogMatrixDeterminant", lambda a: raw.LogMatrixDeterminant(
    input=a)[0], [S4])
# the reference's rule maps only the op's first output, so the graph's
# log|det| (output 1) reads the sign (ROADMAP C11)
rule("LogMatrixDeterminant", lambda a: raw.LogMatrixDeterminant(
    input=a)[1], [S4], mode="ref")
rule("Svd", lambda a: raw.Svd(input=a, compute_uv=True)[1], [f32(4, 3)],
     mode="recon")
rule("Qr", lambda a: raw.Qr(input=a)[0], [f32(4, 3)], mode="recon")

# ---- fft -----------------------------------------------------------------
rule("FFT", lambda a: raw.FFT(input=a), [CPX])
rule("IFFT", lambda a: raw.IFFT(input=a), [CPX])
rule("FFT2D", lambda a: raw.FFT2D(input=a), [CPX2])
rule("IFFT2D", lambda a: raw.IFFT2D(input=a), [CPX2])
rule("RFFT", lambda a: raw.RFFT(input=a, fft_length=[8]), [f32(2, 8)])
rule("IRFFT", lambda a: raw.IRFFT(input=a, fft_length=[8]),
     [np.fft.rfft(f32(2, 8)).astype(np.complex64)])

# ---- segments ------------------------------------------------------------
_SEG = np.array([0, 0, 1, 1, 1, 3], np.int32)
_USEG = np.array([2, 0, 2, 1, 0, 2], np.int32)
for _op in ("SegmentSum", "SegmentMean", "SegmentMax", "SegmentMin",
            "SegmentProd"):
    rule(_op, lambda a, _o=_op: getattr(raw, _o)(
        data=a, segment_ids=_SEG[[0, 1, 2, 3, 4, 4]]), [f32(6, 3)])
# an empty segment: TF writes 0, jax.ops.segment_max/min the reduction's
# identity (±inf), which the port keeps (ROADMAP C11)
for _op in ("SegmentMax", "SegmentMin"):
    rule(_op, lambda a, _o=_op: getattr(raw, _o)(
        data=a, segment_ids=_SEG), [f32(6, 3)], mode="ref")
for _op in ("UnsortedSegmentSum", "UnsortedSegmentMax",
            "UnsortedSegmentMin", "UnsortedSegmentProd"):
    rule(_op, lambda a, _o=_op: getattr(raw, _o)(
        data=a, segment_ids=_USEG, num_segments=3), [f32(6, 3)])

# ---- data movement -------------------------------------------------------
rule("Roll", lambda a: raw.Roll(input=a, shift=[1, -2], axis=[0, 1]),
     [f32(3, 5)])
rule("ReverseV2", lambda a: raw.ReverseV2(tensor=a, axis=[1]), [f32(3, 5)])
rule("MirrorPad", lambda a: raw.MirrorPad(
    input=a, paddings=[[1, 1], [0, 2]], mode="SYMMETRIC"), [f32(3, 5)])
rule("Pad", lambda a: raw.Pad(input=a, paddings=[[1, 0], [2, 1]]),
     [f32(3, 5)])
rule("ListDiff", lambda a, b: raw.ListDiff(x=a, y=b)[0],
     [np.array([1, 2, 3, 4, 5, 6], np.int32),
      np.array([1, 3, 5], np.int32)], mode="ref")
rule("DynamicPartition", lambda a, b: raw.DynamicPartition(
    data=a, partitions=b, num_partitions=3)[1],
     [f32(6), np.array([0, 2, 1, 0, 2, 1], np.int32)], mode="ref")
rule("DynamicStitch", lambda a, b: raw.DynamicStitch(
    indices=[[0, 2, 4], [1, 3, 5]], data=[a, b]), [f32(3), f32(3, seed=1)])
rule("ParallelDynamicStitch", lambda a, b: raw.ParallelDynamicStitch(
    indices=[[0, 2, 4], [1, 3, 5]], data=[a, b]), [f32(3), f32(3, seed=1)])
rule("TopKV2", lambda a: raw.TopKV2(input=a, k=3)[1],
     [np.round(f32(4, 7) * 2) / 2])
rule("InTopK", lambda a: raw.InTopK(predictions=a, targets=[0, 3, 6, 2],
                                    k=2), [f32(4, 7)])
rule("InTopKV2", lambda a: raw.InTopKV2(predictions=a, targets=[0, 3, 6, 2],
                                        k=2), [f32(4, 7)])
rule("HistogramFixedWidth", lambda a: raw.HistogramFixedWidth(
    values=a, value_range=[-2.0, 2.0], nbins=5), [f32(20, seed=3) * 3])
rule("Bincount", lambda a: raw.Bincount(arr=a, size=5, weights=tf.zeros(
    [0], tf.int32)), [np.array([0, 1, 1, 3, 4, 4, 4], np.int32)])
rule("InvertPermutation", lambda a: raw.InvertPermutation(x=a),
     [R(0).permutation(7).astype(np.int32)])
rule("Gather", lambda a: raw.Gather(params=a, indices=[2, 0, 2]), [X])
rule("GatherNd", lambda a: raw.GatherNd(params=a, indices=[[0, 1], [2, 3]]),
     [X])
rule("ScatterNd", lambda a: raw.ScatterNd(
    indices=[[0, 1], [2, 3], [0, 1]], updates=a, shape=[3, 4]), [f32(3)])
for _op in ("TensorScatterSub", "TensorScatterUpdate", "TensorScatterMax",
            "TensorScatterMin"):
    rule(_op, lambda a, b, _o=_op: getattr(raw, _o)(
        tensor=a, indices=[[2], [0]], updates=b), [X, f32(2, 4, seed=3)])
rule("ReverseSequence", lambda a: raw.ReverseSequence(
    input=a, seq_lengths=[2, 5, 0], seq_dim=1, batch_dim=0), [f32(3, 5, 2)])
rule("BroadcastArgs", lambda a, b: raw.BroadcastArgs(s0=a, s1=b),
     [np.array([2, 1, 4], np.int32), np.array([3, 1], np.int32)])
rule("Rank", lambda a: raw.Rank(input=a), [f32(2, 3, 4)])
rule("Size", lambda a: raw.Size(input=a), [f32(2, 3, 4)])
rule("ShapeN", lambda a, b: raw.ShapeN(input=[a, b])[1],
     [f32(3, 4), f32(2, 5, 6)])
rule("UnravelIndex", lambda a: raw.UnravelIndex(indices=a, dims=[3, 4]),
     [np.array([0, 5, 11, 7], np.int32)], mode="ref")
rule("Select", lambda a, b: raw.Select(condition=a > 0, x=a, y=b), [X, Y])
rule("LinSpace", lambda a: a + raw.LinSpace(start=-1.0, stop=2.0, num=4),
     [X])
rule("SparseToDense", lambda a: raw.SparseToDense(
    sparse_indices=[[0, 1], [1, 0], [2, 3]], output_shape=[3, 4],
    sparse_values=a, default_value=-1.0), [f32(3)])
# Unique keeps first-occurrence order (TF's; the reference's jnp.unique
# sorts, ROADMAP C10), padded to the input's size
rule("Unique", lambda a: raw.Unique(x=a)[0],
     [np.array([4, 1, 4, 7, 1, 1, 9, 4], np.int32)], mode="unique")
rule("UniqueWithCounts", lambda a: raw.UniqueWithCounts(x=a)[2],
     [np.array([4, 1, 4, 7, 1, 1, 9, 4], np.int32)], mode="unique")
rule("Bucketize", lambda a: raw.Bucketize(
    input=a, boundaries=[-1.0, 0.0, 0.5, 2.0]), [X * 2])

# ---- random: shape and dtype ---------------------------------------------
rule("RandomShuffle", lambda a: raw.RandomShuffle(value=a, seed=3),
     [f32(9, 3)], mode="shape")
rule("Multinomial", lambda a: raw.Multinomial(
    logits=a, num_samples=5, seed=1, output_dtype=tf.int32), [X],
     mode="shape")
rule("RandomStandardNormal", lambda a: a + raw.RandomStandardNormal(
    shape=[3, 4], dtype=tf.float32, seed=2), [X], mode="shape")
rule("RandomUniform", lambda a: a + raw.RandomUniform(
    shape=[3, 4], dtype=tf.float32, seed=2), [X], mode="shape")
rule("TruncatedNormal", lambda a: a + raw.TruncatedNormal(
    shape=[3, 4], dtype=tf.float32, seed=2), [X], mode="shape")

# ---- image ---------------------------------------------------------------
rule("AdjustContrastv2", lambda a: raw.AdjustContrastv2(
    images=a, contrast_factor=1.7), [IMG])
rule("AdjustHue", lambda a: raw.AdjustHue(images=a, delta=0.3), [IMG])
rule("AdjustSaturation", lambda a: raw.AdjustSaturation(
    images=a, scale=0.6), [IMG], mode="ref")
rule("HSVToRGB", lambda a: raw.HSVToRGB(images=a), [IMG])
rule("RGBToHSV", lambda a: raw.RGBToHSV(images=a), [IMG])
rule("CropAndResize", lambda a: raw.CropAndResize(
    image=a, boxes=[[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 0.5]],
    box_ind=[1, 0], crop_size=[4, 3]), [IMG])
rule("ExtractImagePatches", lambda a: raw.ExtractImagePatches(
    images=a, ksizes=[1, 3, 2, 1], strides=[1, 1, 2, 1],
    rates=[1, 1, 1, 1], padding="VALID"), [IMG])
rule("ExtractImagePatches", lambda a: raw.ExtractImagePatches(
    images=a, ksizes=[1, 3, 3, 1], strides=[1, 2, 2, 1],
    rates=[1, 1, 1, 1], padding="SAME"), [IMG])
rule("ResizeArea", lambda a: raw.ResizeArea(images=a, size=[3, 2]), [IMG])
# the reference resizes with jax.image.resize: half-pixel centres, which TF
# takes with half_pixel_centers=True; upsampling matches TF's kernels
rule("ResizeBilinear", lambda a: raw.ResizeBilinear(
    images=a, size=[12, 9], half_pixel_centers=True), [IMG])
rule("ResizeBilinear", lambda a: raw.ResizeBilinear(
    images=a, size=[11, 8], align_corners=True), [IMG])
rule("ResizeNearestNeighbor", lambda a: raw.ResizeNearestNeighbor(
    images=a, size=[12, 9], half_pixel_centers=True), [IMG])
rule("ResizeNearestNeighbor", lambda a: raw.ResizeNearestNeighbor(
    images=a, size=[11, 8], align_corners=True), [IMG])
# jax's bicubic is Keys' a = -0.5, TF's ResizeBicubic kernel a = -0.75
rule("ResizeBicubic", lambda a: raw.ResizeBicubic(
    images=a, size=[12, 9], half_pixel_centers=True), [IMG], mode="ref")
rule("LRN", lambda a: raw.LRN(input=a, depth_radius=2, bias=1.0,
                              alpha=1e-3, beta=0.75), [pos(2, 4, 4, 8)])
rule("NonMaxSuppression", lambda a, b: raw.NonMaxSuppression(
    boxes=a, scores=b, max_output_size=3, iou_threshold=0.5),
     [BOXES, SCORES], mode="ref")
rule("NonMaxSuppressionV2", lambda a, b: raw.NonMaxSuppressionV2(
    boxes=a, scores=b, max_output_size=3, iou_threshold=0.5),
     [BOXES, SCORES], mode="ref")
rule("NonMaxSuppressionV3", lambda a, b: raw.NonMaxSuppressionV3(
    boxes=a, scores=b, max_output_size=3, iou_threshold=0.5,
    score_threshold=0.55), [BOXES, SCORES], mode="ref")
rule("FusedBatchNorm", lambda a: raw.FusedBatchNorm(
    x=a, scale=[1.0, 2.0, 0.5], offset=[0.1, 0.0, -0.2],
    mean=[0.5, 0.4, 0.6], variance=[0.1, 0.2, 0.3], is_training=False)[0],
     [IMG])
for _op in ("FusedBatchNormV2", "FusedBatchNormV3"):
    rule(_op, lambda a, _o=_op: getattr(raw, _o)(
        x=a, scale=[1.0, 2.0, 0.5], offset=[0.1, 0.0, -0.2],
        mean=[0.5, 0.4, 0.6], variance=[0.1, 0.2, 0.3],
        is_training=False)[0], [IMG])

# ---- products, losses, recurrent blocks ----------------------------------
rule("BatchMatMul", lambda a, b: raw.BatchMatMul(x=a, y=b, adj_y=True),
     [f32(2, 3, 4), f32(2, 5, 4, seed=1)])
rule("BatchMatMulV3", lambda a, b: raw.BatchMatMulV3(
    x=a, y=b, Tout=tf.float32, adj_x=True), [f32(2, 4, 3), f32(2, 4, 5,
                                                                seed=1)])
rule("SoftmaxCrossEntropyWithLogits", lambda a: raw.SoftmaxCrossEntropyWithLogits(
    features=a, labels=np.eye(4, dtype=np.float32)[[0, 2, 3]])[0], [X])
for _peep in (False, True):
    rule("LSTMBlockCell", lambda a, c, h, _p=_peep: raw.LSTMBlockCell(
        x=a, cs_prev=c, h_prev=h, w=LSTM_W, wci=PEEP[0], wcf=PEEP[1],
        wco=PEEP[2], b=LSTM_B, forget_bias=1.0, use_peephole=_p)[6],
        [f32(2, 3), f32(2, 4, seed=1), f32(2, 4, seed=2)], tol=TF_LOOSE)
rule("BlockLSTM", lambda a, c, h: raw.BlockLSTM(
    seq_len_max=np.int64(5), x=a, cs_prev=c, h_prev=h, w=LSTM_W,
    wci=PEEP[0], wcf=PEEP[1], wco=PEEP[2], b=LSTM_B, forget_bias=0.5,
    use_peephole=True)[6],
     [f32(5, 2, 3), f32(2, 4, seed=1), f32(2, 4, seed=2)], tol=TF_LOOSE)
rule("BlockLSTMV2", lambda a, c, h: raw.BlockLSTMV2(
    seq_len_max=np.int64(5), x=a, cs_prev=c, h_prev=h, w=LSTM_W,
    wci=PEEP[0], wcf=PEEP[1], wco=PEEP[2], b=LSTM_B,
    use_peephole=False)[1],
     [f32(5, 2, 3), f32(2, 4, seed=1), f32(2, 4, seed=2)], mode="ref")


def _assert_graph(a):
    check = raw.Assert(condition=tf.reduce_all(tf.math.is_finite(a)),
                       data=[a])
    with tf.control_dependencies([check]):
        return tf.identity(a * 3.0)


rule("Assert", _assert_graph, [X])


# ---- TF ops this tensorflow build has no kernel for: GraphDefs by hand ---
def _node(gd, name, op, inputs=(), **attrs):
    n = gd.node.add(name=name, op=op)
    n.input.extend(inputs)
    for k, v in attrs.items():
        n.attr[k].CopyFrom(v)
    return n


def _handmade(op, n_in, np_fn, extra=None):
    """(GraphDef bytes with placeholders in0.. feeding ``op`` then an
    Identity "out", the numpy answer)."""
    from tensorflow.core.framework import attr_value_pb2, graph_pb2
    gd = graph_pb2.GraphDef()
    f = attr_value_pb2.AttrValue(type=tf.float32.as_datatype_enum)
    for i in range(n_in):
        _node(gd, f"in{i}", "Placeholder", dtype=f)
    _node(gd, "op", op, [f"in{i}" for i in range(n_in)], **(extra or {}))
    _node(gd, "out", "Identity", ["op"])
    return gd.SerializeToString(), np_fn


_XOR_A, _XOR_B = X > 0, Y > 0
HANDMADE = {
    "LogicalXor": (_handmade("LogicalXor", 2, lambda a, b: a ^ b),
                   [_XOR_A, _XOR_B]),
    "SearchSorted": (_handmade("SearchSorted", 2, lambda s, v: np.stack(
        [np.searchsorted(si, vi) for si, vi in zip(s, v)]).astype(
            np.int32)), [np.sort(f32(2, 8), axis=1), f32(2, 5, seed=1)]),
}


# ---------------------------------------------------------------------------
def _freeze(fn, feeds):
    """(frozen function, GraphDef); the placeholders take ``fn``'s
    parameter names."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    specs = [tf.TensorSpec(a.shape, tf.as_dtype(a.dtype)) for a in feeds]
    cf = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(cf)
    return frozen, frozen.graph.as_graph_def()


def _both(gd_bytes, feed, out):
    j = JMapper.importGraph(gd_bytes).outputSingle(feed, out)
    t = TFGraphMapper.importGraph(gd_bytes, device="cpu").outputSingle(
        feed, out)
    return np.asarray(j.numpy()), _np(t)


def _cases():
    for op in sorted(RULES):
        for i, case in enumerate(RULES[op]):
            yield pytest.param(op, case, id=f"{op}-{i}")


@pytest.mark.parametrize("op,case", list(_cases()))
def test_rule_through_both_importers(op, case):
    fn, feeds, mode, tol = case
    names = list(inspect.signature(fn).parameters)[:len(feeds)]
    frozen, gd = _freeze(fn, feeds)
    assert op in {n.op for n in gd.node}, f"the graph holds no {op}"
    golden = frozen(*[tf.constant(a) for a in feeds])
    golden = (golden[0] if isinstance(golden, (list, tuple))
              else golden).numpy()
    phs = [n.name for n in gd.node if n.op == "Placeholder"]
    feed = {p: feeds[names.index(p)] for p in phs}
    out = [n.name for n in gd.node if n.op == "Identity"][-1]
    j, t = _both(gd.SerializeToString(), feed, out)
    assert t.shape == j.shape, (t.shape, j.shape)
    if mode not in ("ref", "unique"):
        assert t.shape == golden.shape, (t.shape, golden.shape)
    if mode == "shape":
        assert t.dtype.kind == golden.dtype.kind
        assert np.isfinite(t.astype(np.float64)).all()
        return
    if mode == "unique":
        k = golden.shape[0]
        np.testing.assert_array_equal(t[:k], golden)
        np.testing.assert_array_equal(t[k:], 0)
        if op == "Unique":                  # the reference's, as a set
            assert set(t[:k]) == set(j[:k])
        return
    if mode == "recon":
        # the factors rebuild the input; a column's sign is free
        node = [n.name for n in gd.node if n.op == op][0]
        sd = TFGraphMapper.importGraph(gd, device="cpu")
        fac = [_np(sd.outputSingle(feed, f"{node}:{i}"))
               for i in range(3 if op == "Svd" else 2)]
        rebuilt = (fac[1] * fac[0]) @ fac[2].T if op == "Svd" \
            else fac[0] @ fac[1]
        np.testing.assert_allclose(rebuilt, feeds[0], atol=1e-4)
        np.testing.assert_allclose(np.abs(t), np.abs(golden), **TF_TOL)
        return
    if t.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j)
        if mode == "tf":
            np.testing.assert_array_equal(t, golden.astype(t.dtype))
        return
    np.testing.assert_allclose(t, j, **REF_TOL)
    if mode == "tf":
        np.testing.assert_allclose(t, golden, **tol)


@pytest.mark.parametrize("op", sorted(HANDMADE))
def test_rule_on_a_graph_written_by_hand(op):
    (gd_bytes, np_fn), feeds = HANDMADE[op]
    feed = {f"in{i}": a for i, a in enumerate(feeds)}
    j, t = _both(gd_bytes, feed, "out")
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, np_fn(*feeds))

