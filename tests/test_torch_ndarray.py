"""The tensor layer (ROADMAP A2): the port's ``NDArray``, ``Nd4j``,
``DataType``, RNG and ``.npy`` serde held against the JAX package's on the
same seeded numpy inputs.

- ``tests/test_ndarray.py``'s ten classes, their bodies run against the
  port (host-only mode: creation without ``device=`` lands on the CPU);
- one case per ``Nd4j`` method and per ``NDArray`` method: the port's
  result against the reference's, equal for elementwise and shape ops,
  within ``TOL`` for the transcendental ones, products and reductions;
- a write through a view reaches the parent for every index form
  (``get`` with points, intervals, ``all``, ``indices`` and ``newAxis``,
  ``getRow`` / ``getColumn`` / ``slice`` / ``tensorAlongDimension`` /
  ``[]``, chains of them, ``put`` / ``putRow`` / ``putColumn`` /
  ``putScalar`` / ``assign`` / ``addi`` on a view), the parent holding the
  reference's values after the same writes;
- DOUBLE stays float64 through ``mmul`` and the reductions, and the
  default stays FLOAT;
- ``.npy`` / ``.npz`` written by either package read in the other, the
  bytes equal;
- the RNG: a seed repeats, two seeds differ, shapes, dtypes, moments and
  bounds (the bits are not JAX's threefry).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import DataType as JDataType
from deeplearning4j_tpu.ops import Nd4j as JNd4j
from deeplearning4j_tpu.ops import NDArray as JNDArray
from deeplearning4j_tpu.ops import NDArrayIndex as JIndex
from deeplearning4j_tpu.ops import serde as jserde
from deeplearning4j_tpu_torch.ops import (DataType, Nd4j, NDArray,
                                          NDArrayIndex, get_random, serde)
from deeplearning4j_tpu_torch.ops.dtype import default_float, promote
from deeplearning4j_tpu_torch.ops.ndarray import set_host_only_arrays
from tests._torch_parity import _reference_tests, _run_reference_test

pytestmark = pytest.mark.torch_port

#: (atol, rtol) of results that are not bit-equal by construction:
#: transcendental functions and products of float32 inputs (the two
#: libraries' kernels round differently), float32 reductions (another
#: summation order)
TOL = dict(atol=1e-5, rtol=1e-5)

_REF_MOD, _REF_CASES = _reference_tests("test_ndarray.py")


@pytest.mark.parametrize("case", [c for _, c in _REF_CASES],
                         ids=[i for i, _ in _REF_CASES])
def test_reference_ndarray_tests_pass_on_the_port(case, tmp_path,
                                                  monkeypatch):
    _run_reference_test(case, tmp_path, monkeypatch)


def test_reference_suite_has_its_ten_classes():
    classes = {i.split(".")[0] for i, _ in _REF_CASES}
    assert len(classes) == 10 and len(_REF_CASES) == 40


# ---------------------------------------------------------------------------
# per-method parity
# ---------------------------------------------------------------------------

R = np.random.RandomState(0)
A = R.randn(3, 4).astype(np.float32)
B = R.randn(3, 4).astype(np.float32)
SQ = R.randn(4, 4).astype(np.float32)
POS = (R.rand(3, 4) + 0.5).astype(np.float32)
UNIT = (R.rand(3, 4) * 1.8 - 0.9).astype(np.float32)
V3 = R.randn(3).astype(np.float32)
V4 = R.randn(4).astype(np.float32)
IDX = np.array([2, 0, 1], np.int32)
IMG = R.randn(2, 3, 6, 5).astype(np.float32)
NAN = np.array([1.0, np.nan, np.inf, -2.0], np.float32)


def _both(x):
    """(reference array, port array) of a numpy input."""
    return JNDArray(x), NDArray(x)


def _host(v):
    if isinstance(v, (list, tuple)):
        return [_host(x) for x in v]
    if isinstance(v, (JNDArray, NDArray)):
        return np.asarray(v.numpy())
    return v


def _check(got, want, exact):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, exact)
        return
    if isinstance(want, (float, int, bool)):
        assert got == pytest.approx(want, rel=TOL["rtol"], abs=TOL["atol"])
        return
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), **TOL)


# (name, args as numpy, exact) — every Nd4j op on the same inputs
ND4J_OPS = [
    ("zerosLike", (A,), True), ("onesLike", (A,), True),
    ("diag", (V4,), True), ("gemm", (A, B.T), False),
    ("matmul", (A, B.T), False), ("tensorMmul", (A, B, ([1], [1])), False),
    ("dot", (V4, V4), False), ("concat", (0, A, B), True),
    ("concat", (1, A, B), True), ("hstack", (A, B), True),
    ("vstack", (A, B), True), ("stack", (0, A, B), True),
    ("split", (A, 2, 1), True), ("tile", (A, 2, 1), True),
    ("repeat", (A, 2, 1), True), ("pad", (A, ((1, 1), (2, 0))), True),
    ("expandDims", (A, 1), True), ("squeeze", (A[None],), True),
    ("flip", (A, 1), True), ("flip", (A,), True), ("roll", (A, 2, 1), True),
    ("roll", (A, 3), True), ("reverse", (A,), True),
    ("where", (A > 0, A, B), True), ("gather", (A, IDX, 0), True),
    ("gather", (A, IDX, 1), True),
    ("scatterUpdate", (A, np.array([0, 2], np.int32), B[:2]), True),
    ("scatterUpdate", (A, np.array([1, 3], np.int32), B[:, :2], 1), True),
    ("oneHot", (IDX, 4), True), ("sort", (V4,), True),
    ("sort", (A, 0, False), True), ("argsort", (V4,), True),
    ("topK", (V4, 2), True), ("unique", (np.array([3., 1, 3, 2]),), True),
    ("exp", (A,), False), ("log", (POS,), False), ("log1p", (POS,), False),
    ("sqrt", (POS,), False), ("square", (A,), True), ("abs", (A,), True),
    ("sign", (A,), True), ("floor", (A * 3,), True), ("ceil", (A * 3,), True),
    ("round", (A * 3,), True), ("sin", (A,), False), ("cos", (A,), False),
    ("tan", (UNIT,), False), ("asin", (UNIT,), False),
    ("acos", (UNIT,), False), ("atan", (A,), False), ("sinh", (A,), False),
    ("cosh", (A,), False), ("tanh", (A,), False), ("erf", (A,), False),
    ("sigmoid", (A,), False), ("softplus", (A,), False),
    ("softsign", (A,), False), ("relu", (A,), True), ("relu6", (A * 4,), True),
    ("leakyRelu", (A, 0.2), False), ("elu", (A,), False),
    ("gelu", (A,), False), ("swish", (A,), False), ("mish", (A,), False),
    ("hardSigmoid", (A,), False), ("hardTanh", (A * 2,), True),
    ("softmax", (A,), False), ("softmax", (A, 0), False),
    ("logSoftmax", (A,), False), ("pow", (POS, 2.5), False),
    ("clip", (A, -0.5, 0.5), True), ("reciprocal", (POS,), False),
    ("rsqrt", (POS,), False), ("maximum", (A, B), True),
    ("minimum", (A, B), True), ("isNaN", (NAN,), True),
    ("isInf", (NAN,), True), ("replaceNaN", (NAN, 0.0), True),
    ("sum", (A, 0), False), ("mean", (A, 1), False), ("max", (A, 0), True),
    ("min", (A, 1), True), ("argMax", (A, 1), True), ("norm2", (A, 0), False),
    ("cosineSim", (A, B), False), ("euclideanDistance", (A, B), False),
    ("manhattanDistance", (A, B), False),
    ("im2col", (IMG, 3, 2, 2, 1, 1, 0), True),
    ("im2col", (IMG, 2, 2, 1, 1, 1, 1, 2, 1), True),
]


def _wrap_args(args, wrap):
    return [wrap(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("name,args,exact", ND4J_OPS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(ND4J_OPS)])
def test_nd4j_op_matches_reference(name, args, exact):
    want = getattr(JNd4j, name)(*_wrap_args(args, JNDArray))
    got = getattr(Nd4j, name)(*_wrap_args(args, NDArray))
    if isinstance(want, tuple):
        want, got = list(want), list(got)
    _check(got, want, exact)


CREATION = [
    ("zeros", (2, 3), {}), ("ones", (4,), {"dtype": "DOUBLE"}),
    ("valueArrayOf", ((2, 2), 7.0), {}), ("scalar", (3.5,), {}),
    ("scalar", (3,), {}), ("scalar", (True,), {}), ("arange", (5,), {}),
    ("arange", (1, 7, 2), {}), ("linspace", (0, 1, 11), {}),
    ("linspace", (-2, 3, 7), {"dtype": "DOUBLE"}), ("eye", (3,), {}),
    ("empty", (), {}), ("create", ([[1.0, 2.0], [3.0, 4.0]],), {}),
    ("create", ([1, 2, 3, 4],), {"shape": (2, 2), "dtype": "INT32"}),
    ("create", (np.arange(6, dtype=np.float64),), {}),
    ("create", (np.arange(6, dtype=np.float64),), {"dtype": "DOUBLE"}),
    ("create", (np.arange(6, dtype=np.int64),), {}),
]


@pytest.mark.parametrize("name,args,kw", CREATION,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(CREATION)])
def test_creation_matches_reference_on_the_cpu(name, args, kw):
    """The same values and DataType; the port's array on the device asked
    for."""
    jkw = {k: getattr(JDataType, v) if k == "dtype" else v
           for k, v in kw.items()}
    tkw = {k: getattr(DataType, v) if k == "dtype" else v
           for k, v in kw.items()}
    want = getattr(JNd4j, name)(*args, **jkw)
    got = getattr(Nd4j, name)(*args, device="cpu", **tkw)
    assert got.dataType().name == want.dataType().name
    assert got.torch.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-7, atol=0)


# (method, args, exact): NDArray methods that return a value
NDARRAY_METHODS = [
    ("add", (B,), True), ("sub", (B,), True), ("mul", (B,), True),
    ("div", (POS,), True), ("rsub", (B,), True), ("rdiv", (B,), True),
    ("fmod", (POS,), True), ("add", (2.5,), True), ("mul", (-3,), True),
    ("addRowVector", (V4,), True), ("addColumnVector", (V3,), True),
    ("subRowVector", (V4,), True), ("subColumnVector", (V3,), True),
    ("mulRowVector", (V4,), True), ("mulColumnVector", (V3,), True),
    ("divRowVector", (V4 + 3,), True), ("divColumnVector", (V3 + 3,), True),
    ("neg", (), True), ("mmul", (B.T,), False), ("dot", (B,), False),
    ("sum", (), False), ("sum", (0,), False), ("sum", (0, 1), False),
    ("mean", (1,), False), ("max", (), True), ("max", (1,), True),
    ("min", (0,), True), ("prod", (1,), False), ("prod", (0, 1), False),
    ("std", (), False), ("std", (0,), False), ("var", (1,), False),
    ("norm1", (), False), ("norm1", (1,), False), ("norm2", (0,), False),
    ("normmax", (), True), ("normmax", (1,), True), ("argMax", (), True),
    ("argMax", (0,), True), ("argMin", (1,), True), ("cumsum", (1,), False),
    ("cumprod", (0,), False), ("sumNumber", (), False),
    ("meanNumber", (), False), ("maxNumber", (), True),
    ("minNumber", (), True), ("norm1Number", (), False),
    ("norm2Number", (), False), ("gt", (B,), True), ("gte", (0.0,), True),
    ("lt", (B,), True), ("lte", (0.1,), True), ("eq", (A,), True),
    ("neq", (B,), True), ("reshape", (4, 3), True),
    ("reshape", ("c", 2, 6), True), ("ravel", (), True),
    ("flatten", (), True), ("transpose", (), True), ("permute", (1, 0), True),
    ("swapAxes", (0, 1), True), ("broadcast", (2, 3, 4), True),
    ("repeat", (1, 2), True), ("castTo", ("INT32",), True),
    ("castTo", ("DOUBLE",), True), ("asDataType", ("HALF",), True),
    ("dup", (), True), ("detach", (), True), ("getRow", (1,), True),
    ("getColumn", (2,), True), ("getRows", (2, 0), True),
    ("getColumns", (3, 1), True), ("getScalar", (1, 2), True),
    ("getDouble", (1, 2), True), ("getDouble", (5,), True),
    ("getFloat", (), True), ("getInt", (2, 3), True),
    ("slice", (1,), True), ("slice", (2, 1), True),
    ("tensorAlongDimension", (1, 1), True),
    ("tensorsAlongDimension", (1,), True), ("length", (), True),
    ("rank", (), True), ("rows", (), True), ("columns", (), True),
    ("size", (1,), True), ("isVector", (), True), ("isMatrix", (), True),
    ("isScalar", (), True), ("isEmpty", (), True),
    ("equalShapes", (B,), True), ("equalsWithEps", (A + 1e-7,), True),
    ("toDoubleMatrix", (), True), ("toFloatVector", (), True),
    ("scan", (lambda v: v > 0,), True), ("__pow__", (2,), False),
    ("__abs__", (), True), ("__neg__", (), True),
    ("__radd__", (1.0,), True), ("__rtruediv__", (2.0,), True),
]


@pytest.mark.parametrize("name,args,exact", NDARRAY_METHODS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(NDARRAY_METHODS)])
def test_ndarray_method_matches_reference(name, args, exact):
    ja, ta = _both(A)

    def conv(a, wrap, dt):
        if isinstance(a, np.ndarray):
            return wrap(a)
        if isinstance(a, str) and hasattr(dt, a):
            return getattr(dt, a)
        return a

    want = getattr(ja, name)(*[conv(a, JNDArray, JDataType) for a in args])
    got = getattr(ta, name)(*[conv(a, NDArray, DataType) for a in args])
    if isinstance(want, (JNDArray,)):
        assert got.dataType().name == want.dataType().name, name
        assert got._parent is None or want._parent is not None
    _check(got, want, exact)


def test_binary_ops_promote_as_the_reference():
    for a_dt in ("INT32", "FLOAT", "DOUBLE", "HALF"):
        for b_dt in ("INT32", "FLOAT", "DOUBLE", "BFLOAT16"):
            ja = JNd4j.ones(2, dtype=getattr(JDataType, a_dt))
            jb = JNd4j.ones(2, dtype=getattr(JDataType, b_dt))
            ta = Nd4j.ones(2, dtype=getattr(DataType, a_dt), device="cpu")
            tb = Nd4j.ones(2, dtype=getattr(DataType, b_dt), device="cpu")
            assert ta.add(tb).dataType().name == \
                ja.add(jb).dataType().name
            ta.addi(tb)
            assert ta.dataType().name == a_dt      # in place keeps its own
            assert promote(getattr(DataType, a_dt),
                           getattr(DataType, b_dt)).name == \
                ja.add(jb).dataType().name


# ---------------------------------------------------------------------------
# writes through views reach the parent, every index form
# ---------------------------------------------------------------------------

def _write_both(fn):
    """Apply ``fn(Nd4j, NDArrayIndex, base)`` to a fresh 4x5 arange in each
    package; the parents must end equal."""
    base = np.arange(20, dtype=np.float32).reshape(4, 5)
    j, t = JNDArray(base), NDArray(base)
    fn(JNd4j, JIndex, j)
    set_host_only_arrays(True)          # Nd4j.create lands on the CPU
    try:
        fn(Nd4j, NDArrayIndex, t)
    finally:
        set_host_only_arrays(False)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    assert not np.array_equal(t.numpy(), base)       # the write landed
    return t


VIEW_WRITES = {
    "get_point_all_assign": lambda n, I, a: a.get(
        I.point(1), I.all()).assign(5.0),
    "get_interval_addi": lambda n, I, a: a.get(
        I.interval(1, 3), I.interval(0, 4, 2)).addi(100.0),
    "get_indices_assign": lambda n, I, a: a.get(
        I.indices(0, 2), I.all()).assign(-1.0),
    "get_indices_cols_muli": lambda n, I, a: a.get(
        I.all(), I.indices(4, 1)).muli(3.0),
    "get_newaxis_assign": lambda n, I, a: a.get(
        I.point(2), I.newAxis(), I.interval(1, 4)).assign(7.0),
    "getRow_putScalar": lambda n, I, a: a.getRow(2).putScalar(3, 42.0),
    "getColumn_assign": lambda n, I, a: a.getColumn(1).assign(
        n.create(np.array([9.0, 8.0, 7.0, 6.0], np.float32))),
    "slice_dim1_subi": lambda n, I, a: a.slice(3, 1).subi(0.5),
    "tad_assign": lambda n, I, a: a.tensorAlongDimension(2, 1).assign(0.0),
    "getitem_chain_assign": lambda n, I, a: a[0:3, 1:4][1].assign(11.0),
    "indices_then_row": lambda n, I, a: a.get(
        I.indices(3, 1), I.all()).getRow(0).assign(-5.0),
    "indices_then_indices": lambda n, I, a: a.get(
        I.indices(0, 1, 3), I.all()).get(
            I.indices(2), I.interval(0, 2)).assign(77.0),
    "row_then_indices": lambda n, I, a: a.getRow(1).get(
        I.indices(0, 4)).assign(-3.0),
    "view_put": lambda n, I, a: a.get(I.interval(1, 3), I.all()).put(
        (I.point(0), I.indices(1, 2)), n.create(
            np.array([1.5, 2.5], np.float32))),
    "view_putRow": lambda n, I, a: a.get(I.indices(2, 0), I.all()).putRow(
        1, n.create(np.arange(5, dtype=np.float32) * -1)),
    "view_putColumn": lambda n, I, a: a.get(
        I.interval(0, 4, 2), I.all()).putColumn(
            3, n.create(np.array([0.25, 0.75], np.float32))),
    "view_setitem": lambda n, I, a: a.getColumn(4).__setitem__(
        slice(1, 3), 12.0),
    "view_assignIf": lambda n, I, a: a.get(I.indices(1, 2), I.all())
    .assignIf(0.0, lambda v: v > 8.0),
    "view_negi": lambda n, I, a: a.get(I.all(), I.indices(0, 2)).negi(),
    "view_rdivi": lambda n, I, a: a.getRow(3).rdivi(1.0),
    "root_put_indices": lambda n, I, a: a.put(
        (I.indices(0, 3), I.point(2)), n.create(
            np.array([4.0, 5.0], np.float32))),
    "root_setitem_mask": lambda n, I, a: a.__setitem__(
        (slice(None), np.array([True, False, True, False, True])), -9.0),
}


@pytest.mark.parametrize("name", sorted(VIEW_WRITES))
def test_write_through_a_view_reaches_the_parent(name):
    _write_both(VIEW_WRITES[name])


def test_basic_views_alias_the_parent_storage():
    """Basic-index views are torch views: a later write to the parent is
    seen by the view (ND4J's aliasing; the reference's view is a
    snapshot there)."""
    a = Nd4j.zeros(3, 4, device="cpu")
    row = a.getRow(1)
    a.addi(2.0)
    assert row.sumNumber() == 8.0
    assert row.torch.untyped_storage().data_ptr() == \
        a.torch.untyped_storage().data_ptr()


def test_independent_results_do_not_alias():
    """reshape / transpose / dup / castTo to the same type return arrays of
    their own, as the reference's do."""
    for op in (lambda a: a.reshape(12), lambda a: a.transpose(),
               lambda a: a.dup(), lambda a: a.castTo(DataType.FLOAT),
               lambda a: a.permute(1, 0), lambda a: a.ravel(),
               lambda a: a.broadcast(3, 4)):
        a = Nd4j.ones(3, 4, device="cpu")
        r = op(a)
        r.addi(1.0)
        assert a.sumNumber() == 12.0


# ---------------------------------------------------------------------------
# float64 end to end, float32 by default
# ---------------------------------------------------------------------------

def test_double_stays_float64_and_float_is_the_default():
    assert default_float() is DataType.FLOAT
    d = Nd4j.rand(8, 8, seed=3, dtype=DataType.DOUBLE, device="cpu")
    assert d.torch.dtype == torch.float64
    for r in (d.mmul(d), d.sum(0), d.mean(), d.std(1), d.norm2(0),
              d.add(1.0), d.mul(d), Nd4j.exp(d), Nd4j.softmax(d),
              Nd4j.gemm(d, d, transposeB=True)):
        assert r.dataType() is DataType.DOUBLE
    assert isinstance(d.sumNumber(), float)
    # a float64 numpy input stays float64 when wrapped, as in the reference
    w, jw = NDArray(np.arange(3.0)), JNDArray(np.arange(3.0))
    assert w.dataType().name == jw.dataType().name == "DOUBLE"
    assert Nd4j.zeros(2, device="cpu").dataType() is DataType.FLOAT
    assert Nd4j.create([1.5, 2.5], device="cpu").dataType() is DataType.FLOAT
    # the float64 product equals numpy's float64 product to rounding
    x = np.random.RandomState(1).randn(16, 16)
    got = NDArray(x).mmul(NDArray(x)).numpy()
    np.testing.assert_allclose(got, x @ x, rtol=1e-13, atol=1e-13)


def test_set_default_data_types_is_process_wide_and_restorable():
    try:
        Nd4j.setDefaultDataTypes(DataType.DOUBLE)
        assert Nd4j.defaultFloatingPointType() is DataType.DOUBLE
        assert Nd4j.ones(2, device="cpu").torch.dtype == torch.float64
    finally:
        Nd4j.setDefaultDataTypes(DataType.FLOAT)
    assert Nd4j.ones(2, device="cpu").torch.dtype == torch.float32


# ---------------------------------------------------------------------------
# serde both ways
# ---------------------------------------------------------------------------

SERDE_ARRAYS = {
    "float32": R.randn(3, 4).astype(np.float32),
    "float64": R.randn(5).astype(np.float64),
    "int32": R.randint(-9, 9, (2, 3, 2)).astype(np.int32),
    "int64": np.arange(7, dtype=np.int64),
    "uint8": R.randint(0, 255, (4, 4)).astype(np.uint8),
    "bool": R.rand(6) > 0.5,
    "float16": R.randn(3, 3).astype(np.float16),
    "scalar": np.float32(2.5).reshape(()),
}


@pytest.mark.parametrize("kind", sorted(SERDE_ARRAYS))
def test_npy_bytes_equal_and_cross_read(kind, tmp_path):
    x = SERDE_ARRAYS[kind]
    j, t = JNDArray(x), NDArray(x)
    jb, tb = jserde.to_npy_bytes(j), serde.to_npy_bytes(t)
    assert jb == tb
    np.testing.assert_array_equal(serde.from_npy_bytes(jb).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jserde.from_npy_bytes(tb).numpy()), x)
    pj, pt = tmp_path / "j.npy", tmp_path / "t.npy"
    jserde.write_as_numpy(j, pj)
    Nd4j.writeAsNumpy(t, pt)
    assert pj.read_bytes() == pt.read_bytes()
    back = Nd4j.createFromNpyFile(pj)
    assert back.dataType().name == j.dataType().name
    np.testing.assert_array_equal(back.numpy(), x)


def test_npz_cross_read(tmp_path):
    arrs = {k: v for k, v in SERDE_ARRAYS.items() if k != "scalar"}
    jp, tp = tmp_path / "j.npz", tmp_path / "t.npz"
    jserde.write_npz({k: JNDArray(v) for k, v in arrs.items()}, jp)
    serde.write_npz({k: NDArray(v) for k, v in arrs.items()}, tp)
    for k, v in serde.read_npz(jp).items():
        np.testing.assert_array_equal(v.numpy(), arrs[k])
    for k, v in jserde.read_npz(tp).items():
        np.testing.assert_array_equal(np.asarray(v.numpy()), arrs[k])
    with np.load(jp) as zj, np.load(tp) as zt:
        for k in arrs:
            assert zj[k].tobytes() == zt[k].tobytes()
            assert zj[k].dtype == zt[k].dtype


# ---------------------------------------------------------------------------
# the RNG: torch's generators, held to properties (not to threefry's bits)
# ---------------------------------------------------------------------------

def test_seed_repeats_and_seeds_differ():
    rng = get_random()
    rng.setSeed(7)
    a = rng.uniform((64,), device="cpu")
    b = rng.uniform((64,), device="cpu")
    rng.setSeed(7)
    assert torch.equal(rng.uniform((64,), device="cpu"), a)
    assert not torch.equal(a, b)
    rng.setSeed(8)
    assert not torch.equal(rng.uniform((64,), device="cpu"), a)
    assert rng.getSeed() == 8
    assert torch.equal(Nd4j.rand(3, 5, seed=11, device="cpu").torch,
                       Nd4j.rand(3, 5, seed=11, device="cpu").torch)
    assert not torch.equal(Nd4j.randn(9, seed=1, device="cpu").torch,
                           Nd4j.randn(9, seed=2, device="cpu").torch)


def test_draw_shapes_dtypes_moments_and_bounds():
    """Moments within 5 standard errors at n = 200,000."""
    rng = get_random()
    rng.setSeed(3)
    n = 200_000
    u = rng.uniform((n,), 2.0, 5.0, device="cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == (n,)
    assert 2.0 <= float(u.min()) and float(u.max()) < 5.0
    assert abs(float(u.mean()) - 3.5) < 5 * (3 / 12 ** 0.5) / n ** 0.5
    g = rng.normal((n,), 2.0, 0.5, dtype=DataType.DOUBLE, device="cpu")
    assert g.dtype == torch.float64
    assert abs(float(g.mean()) - 2.0) < 5 * 0.5 / n ** 0.5
    assert abs(float(g.std()) - 0.5) < 5 * 0.5 / (2 * n) ** 0.5
    r = rng.randint((n,), -3, 4, device="cpu")
    assert r.dtype == torch.int32
    assert int(r.min()) == -3 and int(r.max()) == 3
    bern = rng.bernoulli((n,), 0.3, device="cpu")
    assert bern.dtype == torch.bool
    assert abs(float(bern.float().mean()) - 0.3) < 5 * (0.21 / n) ** 0.5
    perm = rng.permutation(50, device="cpu")
    assert sorted(perm.tolist()) == list(range(50))
    assert 0.0 <= rng.nextDouble() < 1.0
    assert isinstance(rng.nextGaussian(), float)
    assert 0 <= rng.nextInt(10) < 10
    seeds = rng.split(3)
    assert len(seeds) == 3 and len(set(seeds)) == 3
    b = Nd4j.randomBernoulli(0.5, 4, 4, device="cpu")
    assert b.dataType() is DataType.FLOAT and set(
        np.unique(b.numpy())) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# environment and the device rule
# ---------------------------------------------------------------------------

def test_environment_answers_as_the_reference():
    from deeplearning4j_tpu.config import Environment as JEnv
    env, jenv = Nd4j.getEnvironment(), JNd4j.getEnvironment()
    for m in ("isDebug", "isVerbose", "blasMajorVersion",
              "allowsPrecisionDowncast", "allowHelpers"):
        assert getattr(env, m)() == getattr(jenv, m)(), m
    assert env.maxThreads() >= 1
    prev = torch.get_num_threads()
    try:
        env.setMaxThreads(2)
        assert env.maxThreads() == 2 and torch.get_num_threads() == 2
    finally:
        env.setMaxThreads(prev)
    assert env.isCPU() == (not torch.cuda.is_available())
    assert Nd4j.getBackend() == ("cuda" if torch.cuda.is_available()
                                 else "cpu")
    assert Nd4j.getAffinityManager()[0].type == Nd4j.getBackend()
    x = Nd4j.ones(2, device="cpu")
    assert Nd4j.exec(x) is x and JEnv.getInstance() is jenv


def test_wrapping_keeps_the_device_and_copies_numpy():
    t = torch.arange(4.0)
    a = NDArray(t)
    assert a.torch is t
    x = np.zeros(3, np.float32)
    b = NDArray(x)
    b.addi(1.0)
    assert x.sum() == 0.0            # the caller's numpy array untouched
    assert not b.numpy().flags.writeable
