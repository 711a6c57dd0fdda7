"""The validation battery's one-op cases for the ops SameDiff gained with its
control flow (the 240 the reference registers beyond the importers' set):
seeded numpy inputs, the op's attrs, its output count and the comparison
it is held to.  Numpy only, so both packages' tests and the card's smoke
run read the same table.

Each case builds a graph of one op over placeholders ``in0``, ``in1``, ...
(or, for control flow, the graph its ``build`` makes) with the SameDiff
API that both packages share, and feeds ``feeds()``; the inputs of
``consts`` are graph constants instead, where the op reads one as static
metadata.  ``check`` names the
comparison:

- ``auto``: floating outputs within ``tol`` (rtol, atol; float32 at
  rtol 1e-4 and atol 1e-5 by default), integer and boolean outputs equal;
- ``linalg``: within rtol 1e-3 (``lu``: the factors within it, the
  pivots equal);
- ``eig`` / ``eigh``: eigenpairs held by A·v = w·v and the sorted
  eigenvalues, not element by element (order and phase are free);
- ``random``: shape, dtype kind and determinism, and the moments within
  10 % of the other run's (the bits of two generators cannot match);
  ``shuffle`` and ``crop`` hold the draw to its input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["OpCase", "CASES", "build_case", "FLOAT_TOL", "LINALG_RTOL"]

FLOAT_TOL = (1e-4, 1e-5)        # rtol, atol: float32 with TF32 off
LINALG_RTOL = 1e-3
MOMENT_RTOL = 0.1


@dataclasses.dataclass
class OpCase:
    op: str
    inputs: Tuple[np.ndarray, ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    n_out: int = 1
    check: str = "auto"
    tol: Tuple[float, float] = FLOAT_TOL
    build: Optional[Callable] = None      # (sd, placeholders) -> outputs
    suffix: str = ""
    consts: Tuple[int, ...] = ()          # inputs that are graph constants

    @property
    def id(self) -> str:
        return self.op + (f"-{self.suffix}" if self.suffix else "")

    def feeds(self) -> Dict[str, np.ndarray]:
        return {f"in{i}": a for i, a in enumerate(self.inputs)
                if i not in self.consts}


def build_case(sd, case: OpCase) -> List[str]:
    """Build ``case``'s graph on ``sd`` (either package's SameDiff); the
    names of its outputs."""
    phs = [sd.constant(a, name=f"in{i}") if i in case.consts
           else sd.placeholder(f"in{i}") for i, a in enumerate(case.inputs)]
    if case.build is not None:
        outs = case.build(sd, phs)
    else:
        outs = sd._op(case.op, phs, dict(case.attrs), n_out=case.n_out,
                      name="o")
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [o.name() for o in outs]


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------
def _f(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(seed, *shape):
    return np.abs(_f(seed, *shape)) + np.float32(0.5)


def _i(seed, lo, hi, *shape, dtype=np.int32):
    return np.random.RandomState(seed).randint(lo, hi, size=shape).astype(
        dtype)


def _probs(seed, *shape):
    p = _pos(seed, *shape)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _spd(seed, n):
    a = _f(seed, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


X = _f(0, 3, 4)
Y = _f(1, 3, 4)
XP = _pos(2, 3, 4)
YP = _pos(3, 3, 4)
XZ = np.where(np.abs(X) < 0.4, 0.0, X).astype(np.float32)   # with zeros
IMG = np.random.RandomState(4).rand(2, 3, 4, 3).astype(np.float32)
RAND_SHAPE = (64, 64)


def _c(op, *inputs, n_out=1, check="auto", suffix="", tol=FLOAT_TOL,
       consts=(), **attrs):
    return OpCase(op, tuple(inputs), attrs, n_out, check, tol, None, suffix,
                  consts)


# ---------------------------------------------------------------------------
# control flow (reference: samediff.py while_loop / if_cond / for_loop)
# ---------------------------------------------------------------------------
def _while(sd, ph):
    out = sd.whileLoop(
        [sd.constant(0.0), ph[0]], lambda s, v: v[0].lt(4.0),
        lambda s, v: [v[0] + 1.0, s.math().tanh(v[1] * 1.5 + 0.1)])
    return out[1]


def _if(sd, ph):
    return sd.ifCond([ph[0], ph[1]], lambda s, v: v[0].sum().gt(0.0),
                     lambda s, v: [v[0] * v[1]],
                     lambda s, v: [v[0] - v[1]])[0]


def _for(sd, ph):
    return sd.forLoop(3, [ph[0], ph[1]],
                      lambda s, v: [s.math().tanh(v[0] @ v[1]), v[1]])[0]


CASES: List[OpCase] = [
    OpCase("while_loop", (X,), build=_while),
    OpCase("if_cond", (X, Y), build=_if),
    OpCase("if_cond", (-np.abs(X), Y), build=_if, suffix="false"),
    OpCase("for_loop", (X, _f(5, 4, 4, scale=0.5)), build=_for),
    # -- math, elementwise ------------------------------------------------
    _c("assign", X, Y), _c("cbrt", X), _c("cloneList", X),
    _c("copySign", X, Y), _c("crelu", X), _c("cube", X),
    _c("diag", _f(6, 3)), _c("diag", _f(6, 2, 3), suffix="2d"),
    _c("divide", X, YP), _c("divideNoNan", X, XZ), _c("floorMod", X, YP),
    _c("frac", 3 * X), _c("heavyside", XZ), _c("hypot", X, Y),
    _c("imageFlipLeftRight", IMG), _c("imageFlipUpDown", IMG),
    _c("isNonDecreasing", np.sort(X.reshape(-1))),
    _c("isNumericTensor", X), _c("isStrictlyIncreasing", X),
    _c("kron", _f(7, 2, 2), _f(8, 2, 3)), _c("log10", XP), _c("log2", XP),
    _c("logAddExp", X, Y), _c("logdet", _spd(9, 3), check="linalg"),
    _c("maximum", X, Y), _c("minimum", X, Y),
    _c("mergeAdd", X, Y, XP), _c("mergeAvg", X, Y, XP),
    _c("mergeSum", X, Y, XP), _c("multiply", X, Y), _c("noOp", X),
    _c("oneMinus", X), _c("onesAs", X), _c("zerosAs", X),
    _c("outer", _f(10, 3), _f(11, 4)), _c("parallelStack", X, Y, XP),
    _c("rationalTanh", X), _c("rectifiedTanh", X), _c("ravel", X),
    _c("realDiv", X, YP), _c("rgbToGrayscale", IMG), _c("rgbToYiq", IMG),
    _c("yiqToRgb", IMG), _c("safeDivide", X, XZ), _c("sinc", X),
    _c("squaredSubtract", X, Y), _c("stackList", X), _c("step", XZ),
    _c("stopGradient", X), _c("subtract", X, Y), _c("swishDerivative", X),
    _c("tensordot", X, _f(12, 4, 2)), _c("timesOneMinus", X),
    _c("toDegrees", X), _c("toRadians", X), _c("trunc", 3 * X),
    _c("toDouble", X), _c("toFloat16", X, tol=(1e-3, 1e-3)),
    _c("toFloat32", X.astype(np.float64)), _c("toInt32", 10 * X),
    _c("toInt64", 10 * X), _c("toUint32", 10 * XP), _c("toUint64", 10 * XP),
    _c("toggleBits", _i(13, -1000, 1000, 3, 4)),
    _c("lrelu", X, alpha=0.2),
    _c("matmul", X, _f(14, 2, 4), transposeB=True),
    _c("sigmoidCrossEntropyWithLogits", X, (XP > 1.0).astype(np.float32)),
    # -- summary statistics ------------------------------------------------
    _c("amax", X, dims=[1]), _c("amean", X, dims=[1], keepDims=True),
    _c("amin", X, dims=[0]), _c("asum", X),
    _c("entropy", _probs(15, 3, 4), dims=[1]),
    _c("logEntropy", _probs(15, 3, 4), dims=[1]),
    _c("shannonEntropy", _probs(15, 3, 4), dims=[1]),
    _c("kurtosis", _f(16, 3, 8), dims=[1]),
    _c("skewness", _f(16, 3, 8), dims=[1]),
    _c("zeroFraction", XZ, dims=[1]),
    _c("iMax", X, dimension=1), _c("iMin", X, dimension=0),
    # -- reduce3 distances --------------------------------------------------
    _c("cosineSimilarity", X, Y, dims=[1]), _c("dot_reduce", X, Y, dims=[1]),
    _c("euclideanDistance", X, Y, dims=[1]),
    _c("hammingDistance", np.round(X), np.round(Y), dims=[1]),
    _c("jaccardDistance", XP, YP, dims=[1]),
    _c("manhattanDistance", X, Y), _c("clipByNorm", X, clipValue=1.0,
                                      dims=[1]),
    # -- segment and scatter -------------------------------------------------
    _c("segmentSqrtN", _f(17, 6, 3), np.array([0, 0, 1, 2, 2, 2], np.int32),
       numSegments=3),
    _c("unsortedSegmentMean", _f(17, 6, 3),
       np.array([2, 0, 1, 2, 0, 2], np.int32), numSegments=3),
    _c("unsortedSegmentSqrtN", _f(17, 6, 3),
       np.array([2, 0, 1, 2, 0, 2], np.int32), numSegments=3),
    _c("scatterSub", _f(18, 5, 3), np.array([0, 2, 2], np.int32),
       _f(19, 3, 3)),
    _c("scatterMul", _f(18, 5, 3), np.array([0, 2, 2], np.int32),
       _f(19, 3, 3)),
    _c("scatterDiv", _f(18, 5, 3), np.array([0, 2, 2], np.int32),
       _pos(19, 3, 3)),
    _c("scatterMax", _f(18, 5, 3), np.array([0, 2, 2], np.int32),
       _f(19, 3, 3)),
    _c("scatterMin", _f(18, 5, 3), np.array([0, 2, 2], np.int32),
       _f(19, 3, 3)),
    # -- shape surgery ---------------------------------------------------------
    _c("repeat", X, repeats=2, axis=1),
    _c("batchToSpace", _f(20, 4, 2, 2, 1), blocks=(2, 2),
       crops=((0, 0), (1, 0))),
    _c("spaceToBatch", _f(21, 1, 4, 4, 1), blocks=(2, 2),
       pads=((0, 0), (0, 2))),
    _c("sequenceMask", np.array([1, 3, 2], np.int32), maxLen=4),
    _c("confusionMatrix", _i(22, 0, 3, 8), _i(23, 0, 3, 8), numClasses=3),
    _c("sortAlongAxis", X, axis=1, descending=True),
    _c("argsortAlongAxis", X, axis=1),
    _c("meshgrid", _f(24, 3), _f(25, 2), n_out=2),
    _c("adjustBrightness", IMG, delta=0.1),
    _c("adjustContrastV2", IMG, factor=1.5),
    # -- recurrent ----------------------------------------------------------
    _c("gruCell", _f(26, 2, 3), _f(27, 2, 4), _f(28, 7, 8, scale=0.5),
       _f(29, 7, 4, scale=0.5), _f(30, 8), _f(31, 4)),
    _c("lstmCell", _f(26, 2, 3), _f(27, 2, 4), _f(32, 2, 4),
       _f(33, 7, 16, scale=0.5), _f(34, 16), n_out=2),
    _c("gru", _f(35, 5, 2, 3), _f(27, 2, 4), _f(28, 7, 8, scale=0.5),
       _f(29, 7, 4, scale=0.5), _f(30, 8), _f(31, 4)),
    _c("lstmLayer", _f(35, 5, 2, 3), _f(27, 2, 4), _f(32, 2, 4),
       _f(33, 7, 16, scale=0.5), _f(34, 16)),
    _c("simpleRnnLayer", _f(35, 5, 2, 3), _f(27, 2, 4),
       _f(36, 3, 4, scale=0.5), _f(37, 4, 4, scale=0.5), _f(38, 4)),
    # -- ops_ext2: reductions, bitwise, linalg ---------------------------------
    _c("checkNumerics", X),
    _c("rot90", X, k=1, axes=(0, 1)), _c("isMax", X),
    _c("clipByAvgNorm", X, clipValue=0.1),
    _c("tri", row=3, column=4, diag=1),
    _c("cumMax", X, dims=1), _c("cumMin", X, dims=1, exclusive=True,
                                reverse=True),
    _c("percentile", X, percentile=30.0, dims=[1]),
    _c("median", X, dims=[1]), _c("median", _f(39, 3, 5), suffix="odd"),
    _c("moments", X, dims=[0], n_out=2),
    _c("normalizeMoments", np.float32(4.0), _f(40, 3), _pos(41, 3),
       n_out=2),
    _c("matrixPower", _f(42, 3, 3, scale=0.5), n=3, check="linalg"),
    _c("cyclicShiftLeft", _i(43, -2**31, 2**31 - 1, 3, 4),
       _i(44, 0, 70, 3, 4)),
    _c("cyclicShiftRight", _i(43, -2**31, 2**31 - 1, 3, 4),
       _i(44, 0, 70, 3, 4)),
    _c("cyclicShiftLeft", _i(43, -2**62, 2**62, 3, 4, dtype=np.int64),
       _i(44, 0, 130, 3, 4, dtype=np.int64), suffix="int64"),
    _c("bitsHammingDistance", _i(45, -1000, 1000, 3, 4),
       _i(46, -1000, 1000, 3, 4)),
    _c("lu", _f(47, 4, 4), n_out=2, check="lu"),
    _c("eig", _f(48, 3, 3), n_out=2, check="eig"),
    _c("selfAdjointEig", _spd(49, 3), n_out=2, check="eigh"),
    _c("lstsq", _f(50, 6, 3), _f(51, 6, 2), check="linalg"),
    _c("batchMmul", _f(52, 2, 4, 3), _f(53, 2, 4, 2), transposeA=True),
    _c("im2col", _f(54, 2, 3, 5, 5), kH=3, kW=3, sH=2, sW=2, pH=1, pW=1),
    _c("im2col", _f(54, 2, 3, 5, 5), kH=2, kW=2, sH=2, sW=2,
       isSameMode=True, suffix="same"),
    _c("col2im", _f(55, 2, 3, 3, 3, 3, 3), sH=2, sW=2, pH=1, pW=1, imgH=5,
       imgW=5),
    _c("ctcLoss", np.array([[1, 2, 2], [3, 1, 0]], np.int32),
       _f(56, 2, 6, 5), np.array([3, 2], np.int32),
       np.array([6, 5], np.int32)),
    _c("setdiff1d", np.array([1, 2, 3, 4, 5, 6], np.int32),
       np.array([2, 4], np.int32), n_out=2),
    _c("histogram", _f(57, 40), numBins=5),
    # -- losses ---------------------------------------------------------------
    _c("hingeLoss", (XP > 1.0).astype(np.float32), X),
    _c("squaredHingeLoss", (XP > 1.0).astype(np.float32), X,
       reduction="SUM"),
    _c("poissonLoss", XP, YP, full=True),
    _c("weightedCrossEntropyWithLogits", (XP > 1.0).astype(np.float32), X,
       YP),
    _c("weightedCrossEntropy", (XP > 1.0).astype(np.float32), X, YP),
    _c("klDivergence", _probs(58, 3, 4), _probs(59, 3, 4)),
    _c("cosineDistanceLoss", X / np.linalg.norm(X, axis=1, keepdims=True),
       Y / np.linalg.norm(Y, axis=1, keepdims=True)),
    # -- convolutions and pools ------------------------------------------------
    _c("conv1d", _f(60, 2, 3, 8), _f(61, 4, 3, 3), _f(62, 4), s=1,
       isSameMode=True),
    _c("conv1d", _f(60, 2, 3, 8), _f(61, 4, 3, 3), s=2, p=1,
       suffix="pad"),
    _c("conv3d", _f(63, 1, 2, 4, 4, 4), _f(64, 3, 2, 2, 2, 2), _f(65, 3),
       sD=2, sH=1, sW=1, isSameMode=True),
    _c("depthwiseConv2d", _f(66, 2, 3, 5, 5), _f(67, 6, 1, 3, 3), sH=2,
       sW=2, isSameMode=True),
    _c("sconv2d", _f(66, 2, 3, 5, 5), _f(68, 3, 1, 3, 3),
       _f(69, 4, 3, 1, 1), _f(70, 4)),
    _c("avgPooling3d", _f(71, 1, 2, 5, 4, 4), kD=2, kH=2, kW=2,
       isSameMode=True),
    _c("maxPooling3d", _f(71, 1, 2, 5, 4, 4), kD=2, kH=2, kW=2, sD=1),
    _c("upsampling2d", _f(72, 1, 2, 3, 3), scaleH=2, scaleW=3),
    _c("upsampling3d", _f(73, 1, 2, 2, 2, 2)),
    # -- random ---------------------------------------------------------------
    _c("random_exponential", check="random", shape=RAND_SHAPE, seed=3,
       **{"lambda": 2.0}),
    _c("randomExponential", check="random", shape=RAND_SHAPE, seed=4),
    _c("random_gamma", check="random", shape=RAND_SHAPE, seed=5, alpha=2.0,
       beta=1.5),
    _c("randomGamma", check="random", shape=RAND_SHAPE, seed=6, alpha=0.5),
    _c("random_poisson", check="random", shape=RAND_SHAPE, seed=7, lam=3.0),
    _c("randomPoisson", check="random", shape=RAND_SHAPE, seed=8, lam=0.5),
    _c("random_gumbel", check="random", shape=RAND_SHAPE, seed=9),
    _c("randomShuffle", _f(74, 16, 3), check="shuffle", seed=1),
    _c("randomBinomial", check="random", trials=10, prob=0.3,
       shape=RAND_SHAPE, seed=10),
    _c("alphaDropout", _f(75, *RAND_SHAPE), check="random", p=0.2, seed=11),
    _c("randomCrop", _f(76, 8, 8), check="crop", shape=(4, 5), seed=12),
    _c("rgbToYuv", IMG), _c("yuvToRgb", IMG),
    # -- ops_ext3 ---------------------------------------------------------------
    _c("nthElement", X, n=1, reverse=True),
    _c("clipByGlobalNorm", X, Y, clipNorm=0.5, n_out=2),
    _c("sufficientStatistics", X, dims=[0], n_out=3),
    _c("avgPooling1d", _f(77, 2, 3, 7), k=3, s=2, isSameMode=True),
    _c("maxPooling1d", _f(77, 2, 3, 7), k=3, s=2),
    _c("deconv3d", _f(78, 1, 2, 3, 3, 3), _f(79, 3, 2, 2, 2, 2), sD=2, sH=2,
       sW=2, isSameMode=True),
    _c("deconv3d", _f(78, 1, 2, 3, 3, 3), _f(79, 3, 2, 3, 2, 2), _f(80, 3),
       suffix="valid"),
    _c("spaceToBatchND", _f(81, 1, 4, 4, 1), blockShape=(2, 2),
       paddings=((0, 0), (0, 2))),
    _c("batchToSpaceND", _f(82, 4, 2, 3, 1), blockShape=(2, 2),
       crops=((0, 0), (1, 1))),
    _c("resizeArea", _f(83, 1, 4, 6, 2), height=2, width=3),
    _c("resizeArea", _f(83, 1, 4, 6, 2), height=3, width=4,
       suffix="linear"),
    # -- ops_ext4 --------------------------------------------------------------
    _c("mergeMax", X, Y, XP), _c("mergeMaxIndex", X, Y, XP),
    _c("matchCondition", X, condition="GT", value=0.5),
    _c("matchConditionTransform", X, condition="ABS_LT", value=0.5),
    _c("replaceWhere", X, Y, condition="LT", value=0.0),
    _c("compareAndSet", XZ, condition="EQ", value=0.0, setValue=5.0),
    _c("compareAndReplace", X, Y, condition="GTE", value=0.2),
    _c("firstIndex", X, condition="GT", value=0.5, dims=[1]),
    _c("lastIndex", X, condition="GT", value=0.5, dims=[1]),
    _c("iamax", X, dims=[1]), _c("iamin", X),
    _c("logspace", start=0.0, stop=2.0, num=5, base=10.0),
    _c("countZero", XZ, dims=[1]),
    _c("upsampling1d", _f(84, 2, 3, 4), scale=3),
    # -- ops_ext5: recurrent variants -----------------------------------------
    _c("sruCell", _f(85, 2, 3), _f(86, 2, 3), _f(87, 3, 9, scale=0.5),
       _f(88, 6), n_out=2),
    _c("sru", _f(89, 4, 2, 3), _f(87, 3, 9, scale=0.5), _f(88, 6),
       _f(86, 2, 3), n_out=2),
    _c("sruBI", _f(89, 4, 2, 3), _f(90, 3, 18, scale=0.5), _f(91, 12),
       _f(92, 2, 2, 3), (_f(93, 4, 2) > 0).astype(np.float32), n_out=2),
    _c("dynamicRnn", _f(94, 4, 2, 3), _f(95, 3, 5, scale=0.5),
       _f(96, 5, 5, scale=0.5), _f(97, 5), _f(98, 2, 5), n_out=2),
    _c("staticRnn", _f(94, 4, 2, 3), _f(95, 3, 5, scale=0.5),
       _f(96, 5, 5, scale=0.5), _f(97, 5), _f(98, 2, 5), n_out=2),
    _c("dynamicBidirectionalRnn", _f(94, 4, 2, 3), _f(95, 3, 5, scale=0.5),
       _f(96, 5, 5, scale=0.5), _f(97, 5), _f(98, 2, 5),
       _f(99, 3, 5, scale=0.5), _f(100, 5, 5, scale=0.5), _f(101, 5),
       _f(102, 2, 5), n_out=4),
    _c("staticBidirectionalRnn", _f(94, 4, 2, 3), _f(95, 3, 5, scale=0.5),
       _f(96, 5, 5, scale=0.5), _f(97, 5), _f(98, 2, 5),
       _f(99, 3, 5, scale=0.5), _f(100, 5, 5, scale=0.5), _f(101, 5),
       _f(102, 2, 5), n_out=4),
    # -- normalization, conv and pool extras -----------------------------------
    _c("renorm", X, p=2.0, dim=0, maxnorm=1.0),
    _c("fusedBatchNorm", _f(103, 2, 3, 3, 4), _pos(104, 4), _f(105, 4),
       n_out=3),
    _c("dilation2d", _f(106, 1, 5, 5, 2), _f(107, 2, 2, 2),
       strides=(2, 2), rates=(1, 1)),
    _c("dilation2d", _f(106, 1, 6, 6, 2), _f(107, 2, 2, 2),
       strides=(1, 1), rates=(2, 2), isSameMode=False, suffix="valid"),
    _c("maxPoolWithArgmax", _f(108, 1, 5, 5, 2), kH=2, kW=2, sH=2, sW=2,
       isSameMode=True, n_out=2),
    _c("pointwiseConv2d", _f(109, 1, 3, 3, 4), _f(110, 1, 1, 4, 2),
       _f(111, 2)),
    _c("reshapeAs", X, _f(112, 2, 6)), _c("tear", X, n_out=3),
    _c("choose", X, mode="GT", scalar=0.0, n_out=2),
    _c("meanPairwiseSquaredError", X, Y),
    _c("logPoissonLoss", X, 3 * XP, full=True),
    _c("drawBoundingBoxes", np.random.RandomState(113).rand(
        1, 6, 6, 3).astype(np.float32),
       np.array([[[0.1, 0.1, 0.6, 0.8], [0.3, 0.2, 0.9, 0.5]]], np.float32),
       np.array([[1, 0, 0], [0, 1, 0]], np.float32)),
    _c("nonMaxSuppressionOverlaps", np.random.RandomState(114).rand(
        5, 5).astype(np.float32), _f(115, 5), maxOutputSize=3,
       overlapThreshold=0.5),
    _c("fakeQuantWithMinMaxVars", X, np.float32(-1.0), np.float32(1.2)),
    _c("fakeQuantWithMinMaxVarsPerChannel", X, -XP[0], XP[1], numBits=4,
       narrowRange=True),
    # -- math / linalg extras ---------------------------------------------------
    _c("axpy", X, Y, alpha=2.0), _c("norm", X, p=3.0, dims=[1]),
    _c("bitcast", X, dtype="int32"),
    _c("bitcast", X, dtype="uint8", suffix="narrow"),
    _c("bitcast", np.arange(8, dtype=np.int8).reshape(2, 4),
       dtype="int32", suffix="wide"),
    _c("stabilize", (X * 0.02).astype(np.float32), realMin=1e-2),
    _c("hashCode", _i(116, -1000, 1000, 3, 4)),
    _c("hashCode", X, suffix="float"),
    _c("biasAdd", _f(117, 2, 3, 4, 4), _f(118, 3), nchw=True),
    _c("xwPlusB", _f(119, 2, 3), _f(120, 4, 3), _f(121, 4),
       transposeW=True),
    _c("printVariable", X, message="v="),
    _c("Assert", (X > -5).astype(np.float32), message="in range"),
    # -- tensor lists -------------------------------------------------------------
    _c("unstackList", _f(122, 3, 2), n_out=3),
    _c("readList", _f(122, 3, 2), index=1),
    _c("writeList", _f(122, 3, 2), _f(123, 2), index=1),
    _c("gatherList", _f(122, 3, 2), np.array([2, 0], np.int32)),
    _c("scatterList", np.array([1, 3], np.int32), _f(124, 2, 2),
       np.int32(4), consts=(2,)),
    _c("sizeList", _f(122, 3, 2)),
    _c("splitList", _f(122, 3, 2), sizes=(1, 2), n_out=2),
    # -- t-SNE helpers, CTC decoding, factories ----------------------------------
    _c("barnesGains", XP, X, Y),
    _c("barnesEdgeForces", np.array([0, 2, 3, 5], np.int32),
       np.array([1, 2, 0, 0, 1], np.int32), _pos(125, 5), _f(126, 3, 2)),
    _c("barnesSymmetrized", np.array([0, 2, 3, 5], np.int32),
       np.array([1, 2, 0, 0, 1], np.int32), _pos(125, 5), n_out=4),
    _c("knnMindistance", _f(127, 3), -np.ones(3, np.float32) * 0.5,
       np.ones(3, np.float32) * 0.5),
    _c("cellContains", np.zeros(2, np.float32), np.ones(2, np.float32),
       np.array([0.3, -0.2], np.float32)),
    _c("ctcGreedyDecoder", _f(128, 2, 8, 4), n_out=2),
    _c("ctcGreedyDecoder", _f(128, 2, 8, 4), blankIndex=3,
       mergeRepeated=False, n_out=2, suffix="nomerge"),
    _c("create", shape=(2, 3), dtype="float32", initValue=1.5),
]


def _updater_cases():
    p, g = _f(130, 3, 4), _f(131, 3, 4)
    st = {"m": _f(132, 3, 4, scale=0.1), "v": _pos(133, 3, 4) * 0.01,
          "vHat": _pos(134, 3, 4) * 0.02, "h": _pos(135, 3, 4),
          "msg": _pos(136, 3, 4), "msdx": _pos(137, 3, 4) * 0.1,
          "g": _pos(138, 3, 4), "vN": _f(139, 3, 4, scale=0.1)}
    spec = [("sgdUpdater", (), {}),
            ("adamUpdater", ("m", "v"), {"beta1": 0.8}),
            ("adaMaxUpdater", ("m", "v"), {}),
            ("nadamUpdater", ("m", "v"), {}),
            ("amsGradUpdater", ("m", "v", "vHat"), {}),
            ("adaGradUpdater", ("h",), {}),
            ("adaDeltaUpdater", ("msg", "msdx"), {"rho": 0.9}),
            ("rmsPropUpdater", ("g",), {}),
            ("nesterovsUpdater", ("vN",), {"momentum": 0.8})]
    return [_c(op, p, g, *(st[k] for k in keys), n_out=1 + len(keys),
               lr=0.01, iteration=3, **extra)
            for op, keys, extra in spec]


CASES.extend(_updater_cases())


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------
def _close(a, b, rtol, atol):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return f"shape {a.shape} != {b.shape}"
    kinds = {a.dtype.kind, b.dtype.kind}
    if kinds <= set("biu"):
        return None if np.array_equal(a.astype(np.int64),
                                      b.astype(np.int64)) else \
            f"integers differ at {int(np.sum(a != b))} places"
    if a.dtype.kind in "biu" or b.dtype.kind in "biu":
        return f"dtype kinds {a.dtype} / {b.dtype}"
    if not np.allclose(a.astype(np.complex128), b.astype(np.complex128),
                       rtol=rtol, atol=atol, equal_nan=True):
        return f"max abs diff {float(np.nanmax(np.abs(a - b)))}"
    return None


def _eig_ok(a, w, v, rtol):
    """A·v = w·v column by column, within rtol of |A|·|v|."""
    a = a.astype(np.complex128)
    res = a @ v - v * w[None, :]
    scale = np.abs(a).max() * np.abs(v).max() + 1e-12
    return float(np.abs(res).max() / scale) <= rtol


def compare(case: OpCase, got: List[np.ndarray], want: List[np.ndarray]
            ) -> Optional[str]:
    """None where ``got`` (one run's outputs) matches ``want`` (the other
    run's) as ``case.check`` says, else what differs."""
    if len(got) != len(want):
        return f"{len(got)} outputs != {len(want)}"
    rtol, atol = case.tol
    if case.check == "linalg":
        rtol, atol = LINALG_RTOL, LINALG_RTOL * 1e-2
    if case.check in ("auto", "linalg"):
        for i, (g, w) in enumerate(zip(got, want)):
            err = _close(g, w, rtol, atol)
            if err:
                return f"output {i}: {err}"
        return None
    if case.check == "lu":
        return _close(got[0], want[0], LINALG_RTOL, 1e-5) or \
            _close(got[1], want[1], 0, 0)
    a = case.inputs[0] if case.inputs else None
    if case.check in ("eig", "eigh"):
        for w, v in (got, want):
            if not _eig_ok(a, np.asarray(w), np.asarray(v), LINALG_RTOL):
                return "A v != w v"
        order = (lambda w: np.sort_complex(np.asarray(w, np.complex128)))
        return _close(order(got[0]), order(want[0]), LINALG_RTOL, 1e-5)
    g, w = np.asarray(got[0]), np.asarray(want[0])
    if g.shape != w.shape or g.dtype.kind != w.dtype.kind:
        return f"{g.shape} {g.dtype} != {w.shape} {w.dtype}"
    if case.check == "shuffle":
        return None if np.array_equal(np.sort(g, 0), np.sort(a, 0)) else \
            "not a permutation of the input's rows"
    if case.check == "crop":
        h, wd = g.shape
        hits = [(i, j) for i in range(a.shape[0] - h + 1)
                for j in range(a.shape[1] - wd + 1)
                if np.array_equal(a[i:i + h, j:j + wd], g)]
        return None if hits else "not a window of the input"
    # random: the moments
    gm, gs, wm, ws = g.mean(), g.std(), w.mean(), w.std()
    if abs(gm - wm) > MOMENT_RTOL * max(ws, abs(wm)) or \
            abs(gs - ws) > MOMENT_RTOL * ws:
        return f"moments {gm:.4g}/{gs:.4g} vs {wm:.4g}/{ws:.4g}"
    return None
