"""Port parity: the ONNX importer's rules, through both packages' importers.

- Every test of the reference's hand-encoded ONNX suite
  (``tests/test_imports.py``: ``TestOnnxImport``, ``TestOnnxImportBreadth``
  and the two module-level ONNX tests) runs as written, with its
  ``_import`` swapped for one that imports the same bytes through the port
  (``device="cpu"``) and through the reference: the test's own NumPy
  goldens then hold the port, and every ``output`` call also holds the
  port's answer to the reference's (float32 at atol 2e-5 / rtol 1e-4,
  integers and booleans exactly).  Where the reference raises, the port
  must raise the same error.
- Every one of the 142 rules on a one-node model written by that suite's
  encoder, through both importers, the outputs compared the same way.
  The random rules (``RandomNormal``, ``RandomUniform``, ``Bernoulli``,
  ``Multinomial``) draw different bits in each package (``jax.random``
  against a seeded torch generator): their shapes, dtypes and support are
  held instead.
"""
import os
import struct
import tempfile

import numpy as np
import pytest

from deeplearning4j_tpu.imports import OnnxImporter as JImporter
from deeplearning4j_tpu.imports.onnx_import import _ONNX_OPS as J_OPS
from deeplearning4j_tpu_torch.imports import OnnxImporter
from deeplearning4j_tpu_torch.imports.onnx_import import _ONNX_OPS

import test_imports as ref_tests
from _torch_parity import _np

pytestmark = pytest.mark.torch_port

FWD = dict(atol=2e-5, rtol=1e-4)
T = ref_tests.TestOnnxImport


def _both(blob):
    """Import ``blob`` through both packages: (port result or error,
    reference result or error)."""
    with tempfile.NamedTemporaryFile(suffix=".onnx", delete=False) as f:
        f.write(blob)
        path = f.name
    try:
        out = []
        for imp, kw in ((OnnxImporter, {"device": "cpu"}), (JImporter, {})):
            try:
                out.append((imp.importModel(path, **kw), None))
            except Exception as e:          # compared below
                out.append((None, e))
        return out
    finally:
        os.unlink(path)


def _same(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "iub" or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **FWD)


class _Checked:
    """The port's graph, whose ``output`` also holds each answer to the
    reference graph's on the same feeds."""

    def __init__(self, sd, ref):
        self.sd, self.ref = sd, ref

    def output(self, feeds, *names):
        got = self.sd.output(feeds, *names)
        want = self.ref.output(feeds, *names)
        for n in names:
            _same(_np(got[n]), np.asarray(want[n].numpy()), n)
        return got

    def __getattr__(self, name):
        return getattr(self.sd, name)


def _dual_import(blob, tmp_path_factory=None):
    (port, perr), (ref, rerr) = _both(blob)
    if rerr is not None or perr is not None:
        assert type(perr) is type(rerr) and str(perr) == str(rerr), \
            (perr, rerr)
        raise perr
    sd, ins, outs = port
    assert (ins, outs) == (ref[1], ref[2])
    return _Checked(sd, ref[0]), ins, outs


# ---------------------------------------------------------------------------
# the reference's own ONNX tests, through both importers
# ---------------------------------------------------------------------------
def _methods(cls):
    return [n for n in dir(cls) if n.startswith("test_")]


@pytest.mark.parametrize("cls,name", [
    *[(ref_tests.TestOnnxImport, n) for n in _methods(T)],
    *[(ref_tests.TestOnnxImportBreadth, n)
      for n in _methods(ref_tests.TestOnnxImportBreadth)]],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_reference_onnx_test_through_both_importers(cls, name,
                                                    monkeypatch):
    inst = cls()
    monkeypatch.setattr(inst, "_import", _dual_import, raising=False)
    getattr(inst, name)()


@pytest.mark.parametrize("name", [
    "test_onnx_packed_dims_and_gemm_alpha_beta",
    "test_onnx_pool_asymmetric_pads_rejected"])
def test_reference_module_onnx_test_through_both_importers(name,
                                                           monkeypatch):
    monkeypatch.setattr(T, "_import",
                        lambda self, blob, tmp=None: _dual_import(blob))
    getattr(ref_tests, name)()


# ---------------------------------------------------------------------------
# every rule on a one-node model
# ---------------------------------------------------------------------------
class Init:
    """An initializer input (the rest of a case's inputs are graph
    inputs, fed as placeholders)."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)


def _attr_s(name, text):
    return T._s(1, name) + T._ld(4, text.encode())


def _attr_floats(name, vals):
    return T._s(1, name) + T._ld(7, struct.pack(f"<{len(vals)}f", *vals))


def _attr_t(name, arr):
    return T._s(1, name) + T._ld(5, T._tensor(name, np.asarray(arr)))


def _attr(name, v):
    if isinstance(v, str):
        return _attr_s(name, v)
    if isinstance(v, float):
        return T._attr_f(name, v)
    if isinstance(v, int):
        return T._attr_i(name, v)
    if isinstance(v, np.ndarray):
        return _attr_t(name, v)
    if all(isinstance(x, float) for x in v):
        return _attr_floats(name, list(v))
    return T._attr_ints(name, [int(x) for x in v])


def _model(op, ins, attrs, n_out):
    """(ModelProto bytes, feeds, output names) of a one-node model."""
    names, inits, vinfos, feeds = [], [], [], {}
    for k, a in enumerate(ins):
        if a is None:
            names.append("")
        elif isinstance(a, Init):
            names.append(f"w{k}")
            inits.append(T._tensor(f"w{k}", a.arr))
        else:
            names.append(f"i{k}")
            vinfos.append(T._vinfo(f"i{k}", a.shape))
            feeds[f"i{k}"] = a
    outs = [f"o{k}" for k in range(n_out)]
    enc = [_attr(k, v) for k, v in attrs.items()]
    node = T._node(op, names, outs, enc)
    blob = T._model(nodes=[node], inits=inits, inputs=vinfos,
                    outputs=[T._vinfo(o, (1,)) for o in outs])
    return blob, feeds, outs


def R_(op, ins, attrs=None, n_out=1, check="close", id=None):
    return pytest.param(dict(op=op, ins=ins, attrs=attrs or {}, n_out=n_out,
                             check=check), id=id or op)


def f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def pos(*shape, seed=0):
    return np.abs(f32(*shape, seed=seed)) + 0.5


def unit(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-0.9, 0.9, shape).astype(
        np.float32)


def i64(*vals):
    return np.asarray(vals, np.int64)


X, Y, Z = f32(3, 4, seed=1), f32(3, 4, seed=2), f32(3, 4, seed=3)
BX, BY = X > 0, Y > 0
IX, IY = (np.random.RandomState(4).randint(1, 40, (3, 4)).astype(np.int32),
          np.random.RandomState(5).randint(1, 6, (3, 4)).astype(np.int32))
IMG = f32(2, 4, 6, 6, seed=6)
SPECIAL = np.array([[1.0, np.inf, -np.inf, np.nan]], np.float32)
SEQ, H = f32(5, 2, 3, seed=7), 4


def _unary(op, x=X, **attrs):
    return R_(op, [x], attrs)


def _rnn(op, gates, direction, **attrs):
    nd = 2 if direction == "bidirectional" else 1
    return R_(op, [SEQ, Init(f32(nd, gates * H, 3, seed=8, scale=0.4)),
                   Init(f32(nd, gates * H, H, seed=9, scale=0.4)),
                   Init(f32(nd, 2 * gates * H, seed=10, scale=0.3))],
              {"hidden_size": H, "direction": direction, **attrs},
              n_out=3 if op == "LSTM" else 2, id=f"{op}-{direction}")


RULES = [
    # unary math and activations
    *[_unary(op) for op in ("Abs", "Atan", "Asinh", "Ceil", "Cos", "Cosh",
                            "Elu", "Erf", "Exp", "Floor", "HardSwish",
                            "Mish", "Neg", "Relu", "Round",
                            "Selu", "Sigmoid", "Sign", "Sin", "Sinh",
                            "Softplus", "Softsign", "Tan", "Tanh",
                            "Dropout")],
    *[_unary(op, unit(3, 4)) for op in ("Acos", "Asin", "Atanh")],
    *[_unary(op, pos(3, 4)) for op in ("Log", "Sqrt", "Reciprocal")],
    _unary("Acosh", pos(3, 4) + 1),
    # an output that is a graph input renames the placeholder in both
    # packages, so Identity is held on an initializer
    R_("Identity", [Init(X)]),
    _unary("IsInf", SPECIAL), _unary("IsNaN", SPECIAL), _unary("Not", BX),
    _unary("HardSigmoid", alpha=0.3, beta=0.4),
    _unary("LeakyRelu", alpha=0.1), _unary("Celu", alpha=0.7),
    _unary("Gelu"), R_("Gelu", [X], {"approximate": "tanh"}, id="Gelu-tanh"),
    _unary("ThresholdedRelu", alpha=0.2),
    _unary("Shrink", lambd=0.6, bias=0.1),
    _unary("Softmax", axis=0), _unary("LogSoftmax", axis=1),
    _unary("Hardmax", axis=1),
    R_("Clip", [X], {"min": -0.3, "max": 0.6}),
    R_("Clip", [X, Init(np.float32(-0.2)), Init(np.float32(0.5))],
       id="Clip-inputs"),
    # binary, n-ary, comparisons, logic, bitwise
    *[R_(op, [X, Y]) for op in ("Add", "Sub", "Mul", "Div", "Equal",
                                "Greater", "GreaterOrEqual", "Less",
                                "LessOrEqual")],
    R_("Pow", [pos(3, 4), Y]),
    R_("Mod", [IX, IY]), R_("Mod", [X * 5, pos(3, 4)], {"fmod": 1},
                            id="Mod-fmod"),
    *[R_(op, [BX, BY]) for op in ("And", "Or", "Xor")],
    *[R_(op, [IX, IY]) for op in ("BitwiseAnd", "BitwiseOr", "BitwiseXor")],
    R_("BitwiseNot", [IX]),
    R_("BitShift", [IX, IY], {"direction": "LEFT"}),
    R_("BitShift", [IX, IY], {"direction": "RIGHT"}, id="BitShift-right"),
    *[R_(op, [X, Y, Z]) for op in ("Max", "Min", "Sum", "Mean")],
    R_("Where", [BX, X, Y]),
    # reductions
    *[R_(op, [f32(2, 3, 4)], {"axes": [1], "keepdims": 0})
      for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                 "ReduceProd", "ReduceL2")],
    *[R_(op, [pos(2, 3, 4), Init(i64(0, 2))], {"keepdims": 1})
      for op in ("ReduceL1", "ReduceLogSum", "ReduceLogSumExp",
                 "ReduceSumSquare")],
    R_("ArgMax", [X], {"axis": 1, "keepdims": 0}),
    R_("ArgMin", [X], {"axis": 0}),
    # shape and indexing
    R_("Squeeze", [f32(3, 1, 4)], {"axes": [1]}),
    R_("Unsqueeze", [X], {"axes": [0, 3]}),
    R_("Slice", [f32(4, 6), Init(i64(1, 0)), Init(i64(4, 5)),
                 Init(i64(0, 1)), Init(i64(2, 2))]),
    R_("Tile", [X, Init(i64(2, 1))]),
    R_("Expand", [f32(3, 1), Init(i64(2, 3, 4))]),
    R_("Cast", [IX], {"to": 1}), R_("Cast", [X * 4], {"to": 6},
                                    id="Cast-int32"),
    R_("Trilu", [f32(4, 4)]), R_("Trilu", [f32(4, 4)], {"upper": 0},
                                 id="Trilu-lower"),
    R_("GatherElements", [X, np.array([[0, 3], [1, 1], [2, 0]])],
       {"axis": 1}),
    R_("CumSum", [X, Init(i64(1))]),
    R_("ConstantOfShape", [Init(i64(2, 3))],
       {"value": np.array([1.5], np.float32)}),
    R_("Concat", [X, Y], {"axis": 1}),
    R_("Gather", [f32(5, 3), np.array([[0, 4], [2, 2]], np.int64)]),
    R_("Gather", [X, Init(i64(3, 0))], {"axis": 1}, id="Gather-axis1"),
    R_("Reshape", [f32(2, 3, 4), Init(i64(0, -1))]),
    R_("Reshape", [f32(2, 3, 4), Init(i64(4, 6))], id="Reshape-static"),
    R_("Transpose", [f32(2, 3, 4)], {"perm": [2, 0, 1]}),
    R_("Flatten", [f32(2, 3, 4)], {"axis": 2}),
    R_("Shape", [f32(2, 3, 4)]), R_("Size", [f32(2, 3, 4)]),
    R_("Range", [Init(np.float32(1.0)), Init(np.float32(7.0)),
                 Init(np.float32(1.5))]),
    R_("EyeLike", [f32(3, 4)]),
    R_("GatherND", [f32(3, 4, 2), np.array([[0, 1], [2, 3]], np.int64)]),
    R_("ScatterND", [f32(4, 3), np.array([[1], [3]], np.int64),
                     f32(2, 3, seed=2)]),
    R_("ScatterElements", [f32(3, 4), np.array([[0, 2], [1, 3], [3, 0]]),
                           f32(3, 2, seed=2)], {"axis": 1}),
    R_("ScatterElements", [f32(3, 4), np.array([[0, 2], [1, 3], [3, 0]]),
                           f32(3, 2, seed=2)],
       {"axis": 1, "reduction": "add"}, id="ScatterElements-add"),
    R_("Scatter", [f32(3, 4), np.array([[1, 0, 2, 1]]), f32(1, 4, seed=2)]),
    R_("TopK", [f32(3, 5), Init(i64(2))], {"axis": 1}, n_out=2),
    R_("TopK", [f32(3, 5), Init(i64(2))], {"axis": 0, "largest": 0},
       n_out=2, id="TopK-smallest"),
    R_("Split", [f32(4, 6), Init(i64(2, 4))], {"axis": 1}, n_out=2),
    R_("Split", [f32(4, 6)], {"axis": 0}, n_out=2, id="Split-even"),
    R_("Split", [f32(6, 2)], {"split": [1, 5]}, n_out=2, id="Split-attr"),
    R_("ReverseSequence", [f32(5, 3, 2), np.array([5, 2, 3], np.int64)],
       {"time_axis": 0, "batch_axis": 1}),
    R_("Einsum", [f32(2, 3, 4), f32(2, 4, 5, seed=2)],
       {"equation": "bij,bjk->bik"}),
    R_("Pad", [IMG, Init(i64(0, 0, 1, 2, 0, 0, 2, 1)),
               Init(np.float32(0.5))]),
    R_("Pad", [IMG, Init(i64(0, 0, 1, 2, 0, 0, 2, 1))], {"mode": "reflect"},
       id="Pad-reflect"),
    R_("DepthToSpace", [IMG], {"blocksize": 2}),
    R_("DepthToSpace", [IMG], {"blocksize": 2, "mode": "CRD"},
       id="DepthToSpace-CRD"),
    R_("SpaceToDepth", [IMG], {"blocksize": 3}),
    R_("Resize", [IMG, None, Init(np.array([1, 1, 2, 2], np.float32))]),
    R_("Resize", [IMG, None, None, Init(i64(2, 4, 4, 9))],
       {"mode": "linear"}, id="Resize-linear-sizes"),
    R_("OneHot", [np.array([[0, 2], [-1, 5]], np.int64), Init(i64(4)),
                  Init(np.array([-1.0, 3.0], np.float32))]),
    R_("Constant", [], {"value": f32(2, 3)}),
    # layers
    R_("Gemm", [X, Init(f32(4, 5, seed=2)), Init(f32(5, seed=3))],
       {"alpha": 0.5, "beta": 2.0}),
    R_("Gemm", [X, Init(f32(5, 4, seed=2))], {"transB": 1},
       id="Gemm-transB"),
    R_("MatMul", [f32(2, 3, 4), Init(f32(4, 5, seed=2))]),
    R_("Conv", [IMG, Init(f32(3, 4, 3, 3, seed=2, scale=0.3)),
                Init(f32(3, seed=3))],
       {"strides": [2, 1], "pads": [1, 1, 1, 1]}),
    R_("Conv", [IMG, Init(f32(3, 4, 3, 3, seed=2, scale=0.3))],
       {"dilations": [2, 2], "auto_pad": "SAME_UPPER"}, id="Conv-same"),
    R_("ConvTranspose", [IMG, Init(f32(4, 3, 3, 3, seed=2, scale=0.3)),
                         Init(f32(3, seed=3))],
       {"strides": [2, 2], "pads": [1, 1, 1, 1]}),
    R_("MaxPool", [IMG], {"kernel_shape": [3, 3], "strides": [2, 2],
                          "pads": [1, 1, 1, 1]}),
    R_("AveragePool", [IMG], {"kernel_shape": [2, 2]}),
    R_("GlobalAveragePool", [IMG]), R_("GlobalMaxPool", [IMG]),
    R_("BatchNormalization", [IMG, Init(pos(4, seed=1)), Init(f32(4)),
                              Init(f32(4, seed=2, scale=0.1)),
                              Init(pos(4, seed=3))], {"epsilon": 1e-3}),
    R_("InstanceNormalization", [IMG, Init(pos(4, seed=1)),
                                 Init(f32(4, seed=2))]),
    R_("GroupNormalization", [IMG, Init(pos(4, seed=1)),
                              Init(f32(4, seed=2))], {"num_groups": 2}),
    R_("LayerNormalization", [f32(2, 3, 8), Init(pos(8, seed=1)),
                              Init(f32(8, seed=2))], {"epsilon": 1e-5}),
    R_("LpNormalization", [X], {"axis": 0}),
    R_("MeanVarianceNormalization", [IMG]),
    R_("PRelu", [X, Init(f32(4, seed=2, scale=0.3))]),
    R_("LpPool", [IMG], {"kernel_shape": [2, 2], "p": 3}),
    R_("Det", [f32(2, 3, 3)]),
    R_("NonMaxSuppression", [
        np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, 10, 1, 11],
                  [0, 10.1, 1, 11.1], [0, 100, 1, 101]], np.float32),
        np.array([0.9, 0.75, 0.95, 0.5, 0.3], np.float32),
        Init(i64(3)), Init(np.float32(0.5)), Init(np.float32(0.0))]),
    R_("QuantizeLinear", [X, Init(np.float32(0.02)), Init(i64(128))]),
    R_("QuantizeLinear", [X, Init(np.array([0.01, 0.02, 0.03, 0.04],
                                           np.float32))],
       id="QuantizeLinear-axis"),
    R_("DequantizeLinear", [np.round(pos(3, 4) * 50),
                            Init(np.float32(0.02)), Init(i64(10))]),
    _rnn("LSTM", 4, "forward"), _rnn("LSTM", 4, "bidirectional"),
    _rnn("GRU", 3, "forward", linear_before_reset=1),
    _rnn("GRU", 3, "reverse"),
    _rnn("RNN", 1, "forward"), _rnn("RNN", 1, "bidirectional"),
    # random: shapes, dtypes and support
    R_("RandomNormal", [], {"shape": [200, 3], "mean": 1.0, "scale": 2.0,
                            "seed": 3}, check="normal"),
    R_("RandomUniform", [], {"shape": [200, 3], "low": -1.0, "high": 3.0,
                             "seed": 3}, check="uniform"),
    R_("Bernoulli", [np.tile(np.float32([0.0, 1.0, 0.5]), (200, 1))],
       {"seed": 2}, check="bernoulli"),
    R_("Multinomial", [np.log(np.float32([[0.2, 0.8, 1e-9],
                                          [0.5, 0.25, 0.25]]))],
       {"sample_size": 300, "seed": 1}, check="multinomial"),
]


@pytest.mark.parametrize("case", RULES)
def test_rule_matches_reference(case):
    blob, feeds, outs = _model(case["op"], case["ins"], case["attrs"],
                               case["n_out"])
    (port, perr), (ref, rerr) = _both(blob)
    assert perr is None and rerr is None, (perr, rerr)
    assert (port[1], port[2]) == (ref[1], ref[2])
    got = port[0].output(feeds, *outs)
    want = ref[0].output(feeds, *outs)
    for o in outs:
        t, j = _np(got[o]), np.asarray(want[o].numpy())
        if case["check"] == "close":
            _same(t, j, o)
            continue
        assert t.shape == j.shape and t.dtype.kind == j.dtype.kind, \
            (t.shape, j.shape, t.dtype, j.dtype)
        for a in (t, j):
            if case["check"] == "normal":
                assert abs(a.mean() - 1.0) < 0.3 and abs(a.std() - 2) < 0.3
            elif case["check"] == "uniform":
                assert a.min() >= -1.0 and a.max() <= 3.0
            elif case["check"] == "bernoulli":
                np.testing.assert_array_equal(a[:, :2], [[0.0, 1.0]] * 200)
                assert 0.35 < a[:, 2].mean() < 0.65
            else:                                   # multinomial
                assert set(np.unique(a[0])) <= {0, 1}
                assert set(np.unique(a[1])) <= {0, 1, 2}


def test_every_rule_is_held_here():
    """The port has the reference's 142 rules, and each has a case."""
    assert sorted(_ONNX_OPS) == sorted(J_OPS) and len(_ONNX_OPS) == 142
    held = {c.values[0]["op"] for c in RULES}
    assert sorted(set(_ONNX_OPS) - held) == []
