"""Port parity: every SameDiff op the TF importer's rules emit that the
port gained with the importer (``deeplearning4j_tpu_torch/autodiff/
ops_ext*.py``), each against the reference op of the same name.

Each case builds the one-op graph in both packages' SameDiff (placeholders
fed, shape operands as graph constants, as the importer makes them) and
compares what ``output`` gives, as ``tests/test_torch_samediff.py`` does.
Tolerances: float32 elementwise and small linear algebra at atol 2e-5 /
rtol 1e-4 (summation order and libm differences); the special functions
(``igamma``, ``betainc``, ``zeta``, ``polygamma``, ``lgamma``) at rtol
2e-4, since XLA and torch evaluate their series differently; integer,
boolean and index outputs exactly.

Where the two packages cannot agree bit for bit, the case holds what
defines the op:
- ``svd`` and ``qr`` are unique only up to signs: their factors must
  rebuild the input (atol 1e-4) and the singular values / |diag R| agree;
- the two RNGs never give the same bits (``random_shuffle``,
  ``multinomial``, ``random_truncated_normal``): shapes, support and the
  permutation property are held;
- ``unique`` keeps first-occurrence order, TF's and libnd4j's order, where
  the reference's ``jnp.unique`` sorts (ROADMAP C10): the values are held
  to TF's ``tf.unique`` and, as a set, to the reference's.
"""
import zlib

import numpy as np
import pytest

import deeplearning4j_tpu.imports  # noqa: F401  (registers the tf_* ops)
import deeplearning4j_tpu_torch.imports  # noqa: F401  (the same)
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import SameDiff

from _torch_parity import _np

pytestmark = pytest.mark.torch_port

FWD = dict(atol=2e-5, rtol=1e-4)
SPECIAL = dict(atol=2e-5, rtol=2e-4)
R = np.random.RandomState


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


X34, Y34 = f32(3, 4, seed=1), f32(3, 4, seed=2)
IMG = unit(2, 6, 6, 3, seed=3)
XZ = X34.copy()
XZ[0, :2] = 0.0
YZ = Y34.copy()
YZ[1, 1] = 0.0
LOWER = np.tril(spd(4, seed=4))
BOXES = np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                  [0, 10, 1, 11], [0, 10.1, 1, 11.1], [0, 100, 1, 101]],
                 np.float32)
SCORES = np.array([0.9, 0.75, 0.6, 0.95, 0.5, 0.3], np.float32)


def _lstm_weights(n_in, n_h, seed):
    r = R(seed)
    return [(r.randn(n_in + n_h, 4 * n_h) * 0.3).astype(np.float32),
            (r.randn(n_h) * 0.3).astype(np.float32),
            (r.randn(n_h) * 0.3).astype(np.float32),
            (r.randn(n_h) * 0.3).astype(np.float32),
            (r.randn(4 * n_h) * 0.1).astype(np.float32)]


def C(op, ins, attrs=None, n_out=1, tol=FWD, check="close", consts=()):
    """One case: ``ins`` feed placeholders, except the positions in
    ``consts``, which become graph constants."""
    return pytest.param(dict(op=op, ins=ins, attrs=attrs or {}, n_out=n_out,
                             tol=tol, check=check, consts=consts),
                        id=f"{op}-{zlib.crc32(repr(attrs).encode()):08x}"
                        if attrs else op)


_LW = _lstm_weights(3, 4, 5)
_DWW = f32(3, 3, 3, 2, seed=6, scale=0.3)
_BPW = f32(3, 3, 2, 4, seed=7, scale=0.3)

CASES = [
    # math
    C("expm1", [X34]), C("rint", [X34 * 3]),
    C("lgamma", [pos(3, 4)], tol=SPECIAL),
    C("digamma", [pos(3, 4)], tol=SPECIAL),
    C("igamma", [pos(3, 4, seed=1), pos(3, 4, seed=2)], tol=SPECIAL),
    C("igammac", [pos(3, 4, seed=1), pos(3, 4, seed=2)], tol=SPECIAL),
    C("asinh", [X34]), C("acosh", [pos(3, 4) + 1]),
    C("atanh", [np.clip(X34, -0.9, 0.9)]),
    C("erfinv", [np.clip(X34, -0.9, 0.9)]),
    C("nextAfter", [X34, Y34]), C("fmod", [X34 * 3, pos(3, 4)]),
    C("zeta", [pos(3, 4) + 1, pos(3, 4, seed=1)], tol=SPECIAL),
    C("betainc", [pos(3, 4, seed=1), pos(3, 4, seed=2), unit(3, 4)],
      tol=SPECIAL),
    C("polygamma", [np.array([[0, 1, 2, 3]] * 3, np.float32),
                    pos(3, 4)], tol=SPECIAL),
    C("divNoNan", [X34, YZ]), C("xlogy", [XZ, pos(3, 4)]),
    C("xdivy", [XZ, pos(3, 4)]), C("truncateDiv", [X34 * 5, pos(3, 4)]),
    C("cross", [f32(4, 3, seed=1), f32(4, 3, seed=2)]),
    C("l2Loss", [X34]),
    C("invertPermutation", [R(0).permutation(7).astype(np.int32)]),
    # bitwise
    C("bitwiseAnd", [i32(3, 4, hi=1000), i32(3, 4, hi=1000, seed=1)]),
    C("bitwiseOr", [i32(3, 4, hi=1000), i32(3, 4, hi=1000, seed=1)]),
    C("bitwiseXor", [i32(3, 4, hi=1000), i32(3, 4, hi=1000, seed=1)]),
    C("bitwiseNot", [i32(3, 4, lo=-500, hi=500)]),
    C("leftShift", [i32(3, 4, hi=1000), i32(3, 4, hi=8, seed=1)]),
    C("rightShift", [i32(3, 4, lo=-1000, hi=1000), i32(3, 4, hi=8, seed=1)]),
    C("bitCount", [i32(3, 4, lo=-1000, hi=1000)]),
    # segment
    *[C(op, [f32(6, 3), np.array([0, 0, 1, 1, 1, 3], np.int32)],
        {"numSegments": 4})
      for op in ("segmentSum", "segmentMean", "segmentMax", "segmentMin",
                 "segmentProd")],
    *[C(op, [f32(6, 3), np.array([2, 0, 2, 1, 0, 2], np.int32)],
        {"numSegments": 4})
      for op in ("unsortedSegmentSum", "unsortedSegmentMax",
                 "unsortedSegmentMin", "unsortedSegmentProd")],
    # scatter / gather
    C("scatterNd", [np.array([[0, 1], [2, 3], [0, 1], [1, 0]], np.int32),
                    f32(4)], {"shape": (3, 4)}),
    *[C(op, [X34, np.array([[2], [0]], np.int32), f32(2, 4, seed=3)])
      for op in ("scatterNdAdd", "scatterNdSub", "scatterNdUpdate",
                 "tensorScatterAdd", "tensorScatterSub",
                 "tensorScatterUpdate", "tensorScatterMax",
                 "tensorScatterMin")],
    C("tensorScatterMax", [X34, np.array([[2, 1], [0, 3]], np.int32),
                           f32(2, seed=3)]),
    C("gatherNd", [f32(3, 4, 2), np.array([[0, 1], [2, 3], [1, 1], [0, 0],
                                           [2, 0]], np.int32)]),
    C("sparseToDense", [np.array([[0, 1], [2, 3], [1, 0]], np.int32),
                        np.array([3, 4], np.int32), f32(3)],
      {"defaultValue": -1.0}, consts=(1,)),
    # shape surgery
    C("reverseSequence", [f32(3, 5, 2), np.array([2, 5, 0], np.int32)],
      {"seqAxis": 1, "batchAxis": 0}),
    C("reverseSequence", [f32(5, 3, 2), np.array([2, 5, 1], np.int32)],
      {"seqAxis": 0, "batchAxis": 1}),
    C("spaceToDepth", [f32(2, 4, 6, 3)], {"blockSize": 2,
                                          "dataFormat": "NHWC"}),
    C("spaceToDepth", [f32(2, 3, 4, 6)], {"blockSize": 2,
                                          "dataFormat": "NCHW"}),
    C("depthToSpace", [f32(2, 2, 3, 8)], {"blockSize": 2,
                                          "dataFormat": "NHWC"}),
    C("depthToSpace", [f32(2, 8, 2, 3)], {"blockSize": 2,
                                          "dataFormat": "NCHW"}),
    C("broadcastTo", [f32(3, 1)], {"shape": (2, 3, 4)}),
    C("mirrorPad", [f32(3, 5)], {"mode": "REFLECT",
                                 "paddings": ((1, 1), (2, 2))}),
    C("mirrorPad", [f32(3, 5)], {"mode": "SYMMETRIC",
                                 "paddings": ((0, 2), (3, 1))}),
    C("roll", [f32(3, 5)], {"shift": 2, "dims": (1,)}),
    C("roll", [f32(3, 5)], {"shift": (1, -2), "dims": (0, 1)}),
    C("bincount", [np.array([0, 1, 1, 3, 4, 4, 4, 7, 9], np.int32)],
      {"maxLength": 5}),
    C("topK", [np.round(f32(4, 7) * 2) / 2], {"k": 3}, n_out=2),
    C("inTopK", [np.round(f32(4, 7) * 2) / 2,
                 np.array([0, 3, 6, 2], np.int32)], {"k": 2}),
    C("einsum", [f32(3, 4), f32(4, 5, seed=1)], {"equation": "ij,jk->ik"}),
    C("einsum", [f32(2, 3, 4)], {"equation": "bij->bji"}),
    C("searchsorted", [np.sort(f32(8)), f32(5, seed=1)], {"right": False}),
    C("searchsorted", [np.sort(f32(2, 8), axis=1), f32(2, 5, seed=1)],
      {"right": True}),
    C("bucketize", [f32(3, 4) * 2], {"boundaries": [-1.0, 0.0, 0.5, 2.0]}),
    C("unravelIndex", [np.array([0, 5, 11, 7], np.int32),
                       np.array([3, 4], np.int32)], consts=(1,)),
    C("broadcastDynamicShape", [np.array([2, 1, 4], np.int32),
                                np.array([3, 1], np.int32)]),
    C("shapeN", [f32(3, 4), f32(2, 5, 6)], n_out=2),
    C("histogramFixedWidth", [f32(20) * 3, np.array([-2.0, 2.0],
                                                    np.float32)],
      {"numBins": 5}),
    C("listDiff", [np.array([1, 2, 3, 4, 5, 6], np.int32),
                   np.array([1, 3, 5], np.int32)], n_out=2),
    C("dynamicPartition", [f32(6), np.array([0, 2, 1, 0, 2, 0], np.int32)],
      {"numPartitions": 3}, n_out=3),
    C("dynamicStitch", [np.array([0, 2, 4], np.int32),
                        np.array([1, 3, 5], np.int32), f32(3), f32(3, seed=1)],
      {"numPartitions": 2}),
    # linalg
    C("matrixInverse", [spd(4)]), C("matrixDeterminant", [spd(4)]),
    C("cholesky", [spd(4)]), C("solve", [spd(4), f32(4, 2)]),
    C("matrixDiagPart", [f32(2, 3, 4)]), C("diagPart", [f32(3, 3)]),
    C("logMatrixDeterminant", [spd(4)], n_out=2),
    *[C("triangularSolve", [a, f32(4, 2)], {"lower": lo, "adjoint": adj})
      for a, lo in ((LOWER, True), (LOWER.T.copy(), False))
      for adj in (False, True)],
    C("matrixBandPart", [f32(4, 5)], {"numLower": 1, "numUpper": 1}),
    C("matrixBandPart", [f32(4, 5)], {"numLower": -1, "numUpper": 0}),
    C("matrixBandPart", [f32(2, 4, 5)], {"numLower": 0, "numUpper": -1}),
    C("matrixSetDiag", [f32(2, 3, 4), f32(2, 3, seed=1)]),
    C("svd", [f32(4, 3)], {"fullUV": False}, n_out=3, check="svd"),
    C("svd", [f32(3, 4)], {"fullUV": True}, n_out=3, check="svd"),
    C("svd", [f32(4, 3)], {"computeUv": False}),
    C("qr", [f32(4, 3)], {"fullMatrices": False}, n_out=2, check="qr"),
    C("qr", [f32(4, 3)], {"fullMatrices": True}, n_out=2, check="qr"),
    # fft
    C("fft", [f32(8)]), C("ifft", [f32(2, 8)]), C("rfft", [f32(8)]),
    C("irfft", [np.fft.rfft(f32(8)).astype(np.complex64)], {"n": 8}),
    C("fft2d", [f32(2, 4, 4)]), C("ifft2d", [f32(4, 4)]),
    # image
    *[C(op, [IMG], {"height": h, "width": w, "alignCorners": ac})
      for op in ("resizeBilinear", "resizeNearestNeighbor")
      for h, w in ((12, 9), (4, 3), (5, 7)) for ac in (False, True)],
    *[C("resizeBicubic", [IMG], {"height": h, "width": w})
      for h, w in ((12, 9), (4, 3))],
    *[C("imageResize", [IMG], {"height": h, "width": w, "method": m})
      for m in ("bilinear", "bicubic", "nearest", "lanczos3", "area")
      for h, w in ((9, 12), (3, 2))],
    C("imageResize", [IMG], {"height": 4, "width": 5, "method": "area"}),
    C("cropAndResize", [IMG, np.array([[0.1, 0.2, 0.8, 0.9],
                                       [0.0, 0.0, 1.0, 0.5]], np.float32),
                        np.array([1, 0], np.int32)],
      {"cropHeight": 4, "cropWidth": 3, "method": "bilinear"}),
    C("cropAndResize", [IMG, np.array([[0.1, 0.2, 0.8, 0.9]], np.float32),
                        np.array([1], np.int32)],
      {"cropHeight": 3, "cropWidth": 5, "method": "nearest"}),
    C("adjustContrast", [IMG], {"factor": 1.7}),
    C("adjustSaturation", [IMG], {"factor": 0.6}),
    C("adjustHue", [IMG], {"delta": 0.3}),
    C("rgbToHsv", [IMG]), C("hsvToRgb", [IMG]),
    C("extractImagePatches", [IMG], {"kH": 3, "kW": 2, "sH": 1, "sW": 2,
                                     "isSameMode": False}),
    C("extractImagePatches", [IMG], {"kH": 3, "kW": 3, "sH": 2, "sW": 2,
                                     "isSameMode": True}),
    C("localResponseNormalization", [pos(2, 4, 4, 8)],
      {"depth": 5, "bias": 1.0, "alpha": 1e-3, "beta": 0.75,
       "dataFormat": "NHWC"}),
    C("localResponseNormalization", [pos(2, 8, 3, 3)],
      {"depth": 3, "bias": 2.0, "alpha": 1e-2, "beta": 0.5,
       "dataFormat": "NCHW"}),
    C("nonMaxSuppression", [BOXES, SCORES],
      {"maxOutputSize": 5, "iouThreshold": 0.5}),
    C("nonMaxSuppression", [BOXES, SCORES],
      {"maxOutputSize": 4, "iouThreshold": 0.5, "scoreThreshold": 0.55}),
    C("tf_depthwiseConv2d", [f32(2, 7, 7, 3), _DWW],
      {"sH": 2, "sW": 2, "isSameMode": True, "dataFormat": "NHWC"}),
    C("tf_depthwiseConv2d", [f32(2, 3, 6, 6), _DWW],
      {"sH": 1, "sW": 1, "dH": 2, "dW": 2, "isSameMode": False,
       "dataFormat": "NCHW"}),
    C("tf_conv2dBackpropInput", [_BPW, f32(2, 4, 4, 4)],
      {"sH": 2, "sW": 2, "isSameMode": True, "dataFormat": "NHWC",
       "oH": 8, "oW": 7}),
    C("tf_conv2dBackpropInput", [_BPW, f32(2, 4, 3, 3)],
      {"sH": 2, "sW": 2, "isSameMode": False, "dataFormat": "NCHW",
       "oH": 7, "oW": 8}),
    # losses, recurrent blocks
    C("softmaxCrossEntropyWithLogits",
      [X34, np.eye(4, dtype=np.float32)[[0, 2, 3]]], {"reduction": "NONE"}),
    *[C("lstmBlockCell", [f32(2, 3), f32(2, 4, seed=1), f32(2, 4, seed=2),
                          *_LW], {"forgetBias": 1.0, "peephole": p},
        n_out=7) for p in (False, True)],
    *[C("lstmBlock", [f32(5, 2, 3), f32(2, 4, seed=1), f32(2, 4, seed=2),
                      *_LW], {"forgetBias": 0.5, "peephole": p}, n_out=7)
      for p in (False, True)],
]


def _run(pkg, case):
    sd = JSameDiff.create() if pkg == "jax" else SameDiff.create("cpu")
    ins, feeds = [], {}
    for i, a in enumerate(case["ins"]):
        if i in case["consts"]:
            ins.append(sd.constant(a, name=f"c{i}"))
        else:
            ins.append(sd.placeholder(f"in{i}"))
            feeds[f"in{i}"] = a
    outs = sd._op(case["op"], ins, case["attrs"], n_out=case["n_out"],
                  name="out")
    outs = outs if isinstance(outs, list) else [outs]
    names = [o.name() for o in outs]
    res = sd.output(feeds, *names)
    if pkg == "jax":
        return [np.asarray(res[n].numpy()) for n in names]
    return [_np(res[n]) for n in names]


@pytest.mark.parametrize("case", CASES)
def test_op_matches_reference(case):
    j, t = _run("jax", case), _run("torch", case)
    assert len(j) == len(t)
    a = case["ins"][0]
    if case["check"] == "svd":
        s, u, v = t
        np.testing.assert_allclose(s, j[0], **FWD)
        k = s.shape[-1]
        np.testing.assert_allclose((u[:, :k] * s) @ v[:, :k].T, a,
                                   atol=1e-4)
        return
    if case["check"] == "qr":
        q, r = t
        np.testing.assert_allclose(q @ r, a, atol=1e-4)
        np.testing.assert_allclose(np.triu(r), r, atol=0)
        np.testing.assert_allclose(np.abs(np.diagonal(r)),
                                   np.abs(np.diagonal(j[1])), **FWD)
        return
    for jo, to in zip(j, t):
        assert jo.shape == to.shape, (jo.shape, to.shape)
        if jo.dtype.kind in "iub" or to.dtype.kind in "iub":
            np.testing.assert_array_equal(to, jo)
        else:
            np.testing.assert_allclose(to, jo, **case["tol"])


def test_every_op_the_tf_rules_emit_is_ported():
    """Each SameDiff op a rule of the port's importer emits is registered
    (the rules' op names, read from the reference's rule files)."""
    import re
    from pathlib import Path
    from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS
    src = "".join((Path(__file__).parent.parent / "deeplearning4j_tpu"
                   / "imports" / f).read_text()
                  for f in ("tf_import.py", "tf_import_ext.py",
                            "tf_import_ext2.py"))
    emitted = set(re.findall(r'sd\._op\(\s*"(\w+)"', src))
    emitted |= set(re.findall(r'\("[A-Z]\w*",\s*"(\w+)"(?:,\s*\d)?\)', src))
    emitted |= set(re.findall(r'_tf_(?:random|space_depth|cumulative)'
                              r'\("(?:\w+", )?"?(\w+)"', src))
    emitted = {o for o in emitted if o[0].islower()}   # not TF's names
    assert len(emitted) > 150
    assert sorted(emitted - set(OP_IMPLS)) == []
    tested = {c.values[0]["op"] for c in CASES}
    # the ops the ext modules added: every registered name that the core
    # samediff.py never spells out
    from deeplearning4j_tpu_torch.autodiff import samediff
    core = set(re.findall(r'"(\w+)"', Path(samediff.__file__).read_text()))
    ported = set(OP_IMPLS) - core
    assert "tf_conv2dBackpropInput" in ported and "einsum" in ported
    # the ops the ONNX importer's rules added are held by their own cases
    import test_torch_onnx_ops as onnx_ops
    tested |= {c.values[0]["op"] for c in onnx_ops.CASES} | {
        "onnx_bernoulli"}
    # and those of the control-flow slice by autodiff/op_cases.py's cases
    # (tests/test_torch_samediff_ops.py)
    from deeplearning4j_tpu_torch.autodiff.op_cases import CASES as SD_CASES
    tested |= {c.op for c in SD_CASES}
    untested = ported - tested - {"random_shuffle", "random_multinomial",
                                  "multinomial", "random_truncated_normal",
                                  "unique", "uniqueWithCounts"}
    assert sorted(untested) == []


# ---------------------------------------------------------------------------
# the RNG ops: the reference's bits are jax.random's, so hold the contract
# ---------------------------------------------------------------------------
def test_random_shuffle_is_a_seeded_permutation_of_rows():
    x = f32(9, 3)
    a = _run("torch", dict(op="random_shuffle", ins=[x], attrs={"seed": 4},
                           n_out=1, consts=()))[0]
    b = _run("torch", dict(op="random_shuffle", ins=[x], attrs={"seed": 4},
                           n_out=1, consts=()))[0]
    j = _run("jax", dict(op="random_shuffle", ins=[x], attrs={"seed": 4},
                         n_out=1, consts=()))[0]
    np.testing.assert_array_equal(a, b)
    for out in (a, j):
        assert out.shape == x.shape
        np.testing.assert_array_equal(np.sort(out[:, 0]), np.sort(x[:, 0]))
        rows = {tuple(r) for r in x}
        assert all(tuple(r) in rows for r in out)


@pytest.mark.parametrize("op", ["multinomial", "random_multinomial"])
def test_multinomial_shape_and_support(op):
    logits = np.log(np.array([[0.7, 0.3, 0.0, 1e-9],
                              [0.1, 0.1, 0.4, 0.4]], np.float32) + 1e-30)
    case = dict(op=op, ins=[logits], attrs={"numSamples": 500, "seed": 1},
                n_out=1, consts=())
    t, j = _run("torch", case)[0], _run("jax", case)[0]
    assert t.shape == j.shape == (2, 500)
    assert t.dtype == np.int32
    assert set(np.unique(t[0])) <= {0, 1} and set(np.unique(t[1])) <= {
        0, 1, 2, 3}
    # the draw frequencies follow the probabilities in both packages
    for out in (t, j):
        assert abs((out[0] == 0).mean() - 0.7) < 0.08
        assert abs((out[1] >= 2).mean() - 0.8) < 0.08


def test_truncated_normal_shape_and_support():
    case = dict(op="random_truncated_normal", ins=[],
                attrs={"shape": (4000,), "seed": 3, "mean": 1.0,
                       "stddev": 2.0}, n_out=1, consts=())
    t, j = _run("torch", case)[0], _run("jax", case)[0]
    assert t.shape == j.shape == (4000,)
    for out in (t, j):
        assert out.min() >= 1.0 - 4.0 - 1e-5 and out.max() <= 1.0 + 4.0 + 1e-5
        # a standard normal cut at ±2 has standard deviation 0.8796
        assert abs(out.mean() - 1.0) < 0.1
        assert abs(out.std() - 2 * 0.8796) < 0.1


# ---------------------------------------------------------------------------
# unique: first-occurrence order (TF), the reference's values as a set
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op,n_out", [("unique", 2), ("uniqueWithCounts", 3)])
def test_unique_keeps_first_occurrence_order(op, n_out):
    tf = pytest.importorskip("tensorflow")
    x = np.array([4, 1, 4, 7, 1, 1, 9, 4], np.int32)
    case = dict(op=op, ins=[x], attrs={}, n_out=n_out, consts=())
    t, j = _run("torch", case), _run("jax", case)
    golden = tf.unique_with_counts(x)
    k = golden.y.shape[0]
    np.testing.assert_array_equal(t[0][:k], golden.y.numpy())
    np.testing.assert_array_equal(t[0][k:], 0)            # padded with 0
    np.testing.assert_array_equal(t[1], golden.idx.numpy())
    np.testing.assert_array_equal(t[0][t[1]], x)
    assert set(t[0][:k]) == set(j[0][:k])                 # reference: sorted
    assert t[0].shape == j[0].shape and t[1].shape == j[1].shape
    if n_out == 3:
        np.testing.assert_array_equal(t[2][:k], golden.count.numpy())
        np.testing.assert_array_equal(t[2][k:], 0)
