"""Port parity: the 31 SameDiff ops the port gained with the ONNX importer,
each against the reference op of the same name.

- The 17 core ops the importer's rules emit (``autodiff/ops_ext*.py``:
  ``hardSwish``, ``logSumExp``, ``prelu``, ``thresholdRelu``,
  ``standardize``, ``takeAlongAxis``, ``putAlongAxis``, ``split``,
  ``l2Normalize``, ``triu``, ``tril``, ``deconv2d``, ``squaredNorm``,
  ``instanceNorm``, ``groupNorm``, ``pnormPool2d``, ``splitV``);
- the 14 ``onnx_*`` helper ops of ``imports/onnx_import*.py``.

Each case builds the one-op graph in both packages' SameDiff (placeholders
fed, as ``tests/test_torch_tf_ops.py`` does) and compares what ``output``
gives: float32 at atol 2e-5 / rtol 1e-4 (summation order, libm), integer,
boolean and index outputs exactly.  The weight-bearing ops (``prelu``,
``deconv2d``, ``instanceNorm``, ``groupNorm``, the three recurrent ops)
are also held by their gradients: every float input becomes a variable,
the loss is the sum of the output times a fixed random tensor, and
``calculateGradients`` must agree at the same tolerance.

``onnx_bernoulli`` draws from a seeded torch generator, the reference from
``jax.random``: the two never give the same bits, so its contract is held
(degenerate probabilities exact, the draw frequency near p, the same bits
on every call).
"""
import zlib

import numpy as np
import pytest

import deeplearning4j_tpu.imports  # noqa: F401  (registers the onnx_* ops)
import deeplearning4j_tpu_torch.imports  # noqa: F401  (the same)
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import SameDiff

from _torch_parity import _np

pytestmark = pytest.mark.torch_port

FWD = dict(atol=2e-5, rtol=1e-4)
R = np.random.RandomState


def f32(*shape, seed=0, scale=1.0):
    return (R(seed).randn(*shape) * scale).astype(np.float32)


def pos(*shape, seed=0):
    return (np.abs(R(seed).randn(*shape)) + 0.5).astype(np.float32)


def C(op, ins, attrs=None, n_out=1, grad=False):
    return pytest.param(dict(op=op, ins=ins, attrs=attrs or {}, n_out=n_out,
                             grad=grad),
                        id=f"{op}-{zlib.crc32(repr(attrs).encode()):08x}"
                        if attrs else op)


X34 = f32(3, 4, seed=1)
TIES = np.array([[1.0, 3.0, 3.0], [5.0, 4.0, 5.0]], np.float32)
IDX = np.array([[4, 0], [-1, 2], [1, 3]], np.int64)   # numpy wraps -1
UNIQ = np.array([[4, 0], [1, 2], [3, 1]], np.int64)   # no repeat in a row
IMG = f32(2, 3, 6, 6, seed=3)
T, B, I, H = 4, 2, 3, 5


def _rnn(kind, nd, seed, with_b=True, with_h0=True, with_c0=False):
    g = {"lstm": 4, "gru": 3, "rnn": 1}[kind]
    ins = [f32(T, B, I, seed=seed), f32(nd, g * H, I, seed=seed + 1,
                                        scale=0.4),
           f32(nd, g * H, H, seed=seed + 2, scale=0.4)]
    if with_b:
        ins.append(f32(nd, 2 * g * H, seed=seed + 3, scale=0.3))
    if with_h0:
        ins.append(f32(nd, B, H, seed=seed + 4, scale=0.5))
    if with_c0:
        ins.append(f32(nd, B, H, seed=seed + 5, scale=0.5))
    return ins, {"has_b": with_b, "has_h0": with_h0, "has_c0": with_c0}


def _rnn_case(kind, direction, lbr=None, activation=None, **kw):
    nd = 2 if direction == "bidirectional" else 1
    ins, flags = _rnn(kind, nd, seed=len(direction) + (lbr or 0), **kw)
    attrs = {"hidden": H, "direction": direction, **flags}
    if lbr is not None:
        attrs["linear_before_reset"] = lbr
    if activation is not None:
        attrs["activation"] = activation
    return C(f"onnx_{kind}", ins, attrs, n_out=3 if kind == "lstm" else 2,
             grad=True)


CASES = [
    # the core ops
    C("hardSwish", [X34 * 4]),
    C("logSumExp", [f32(2, 3, 4)]),
    C("logSumExp", [f32(2, 3, 4)], {"dims": [0, 2], "keepDims": True}),
    C("prelu", [X34, f32(4, seed=2, scale=0.3)], grad=True),
    C("prelu", [f32(2, 3, 4, seed=3), f32(3, 1, seed=4, scale=0.3)],
      grad=True),
    C("thresholdRelu", [X34]), C("thresholdRelu", [X34], {"cutoff": 0.3}),
    C("standardize", [f32(2, 3, 4)]),
    C("standardize", [f32(2, 3, 4)], {"dims": [1, 2]}),
    C("takeAlongAxis", [f32(3, 5), IDX], {"axis": 1}),
    C("takeAlongAxis", [f32(5, 3), IDX.T.copy()], {"axis": 0}),
    C("takeAlongAxis", [f32(3, 5), IDX[:1]], {"axis": 1}),   # broadcast
    C("putAlongAxis", [f32(3, 5), UNIQ, f32(3, 2, seed=2)], {"axis": 1}),
    C("putAlongAxis", [f32(3, 5), UNIQ, f32(3, 2, seed=2)],
      {"axis": 1, "reduction": "add"}),
    C("putAlongAxis", [f32(3, 5), UNIQ, f32(3, 2, seed=2)],
      {"axis": 1, "reduction": "mul"}),
    C("putAlongAxis", [f32(5, 3), UNIQ.T.copy(), f32(2, 3, seed=2)],
      {"axis": 0}),
    C("putAlongAxis", [f32(3, 5), np.array([[-1], [0], [-5]]),
                       f32(3, 1, seed=2)], {"axis": -1}),
    C("split", [f32(4, 6)], {"numSplit": 3, "dimension": 1}, n_out=3),
    C("split", [f32(4, 6)], {"numSplit": 2, "dimension": 0}, n_out=2),
    C("l2Normalize", [X34]), C("l2Normalize", [X34], {"dims": [0]}),
    C("triu", [f32(4, 5)]), C("triu", [f32(2, 3, 3)]),
    C("tril", [f32(4, 5)]), C("tril", [f32(2, 3, 3)]),
    C("deconv2d", [IMG, f32(4, 3, 3, 3, seed=4, scale=0.3),
                   f32(4, seed=5)], {"sH": 2, "sW": 2, "pH": 1, "pW": 1},
      grad=True),
    C("deconv2d", [IMG, f32(4, 3, 2, 3, seed=4, scale=0.3)],
      {"sH": 1, "sW": 2}, grad=True),
    C("deconv2d", [IMG, f32(4, 3, 3, 3, seed=4, scale=0.3)],
      {"sH": 2, "sW": 2, "isSameMode": True}, grad=True),
    C("deconv2d", [IMG, f32(4, 3, 2, 2, seed=4, scale=0.3),
                   f32(4, seed=5)], {"sH": 1, "sW": 1, "isSameMode": True},
      grad=True),
    C("squaredNorm", [f32(2, 3, 4)]),
    C("squaredNorm", [f32(2, 3, 4)], {"dims": [1], "keepDims": True}),
    C("instanceNorm", [IMG, pos(3, seed=1), f32(3, seed=2)],
      {"epsilon": 1e-5}, grad=True),
    C("groupNorm", [f32(2, 4, 3, 3), pos(4, seed=1), f32(4, seed=2)],
      {"numGroups": 2}, grad=True),
    C("pnormPool2d", [IMG], {"kH": 2, "kW": 2, "sH": 2, "sW": 2,
                             "pnorm": 2}),
    C("pnormPool2d", [IMG], {"kH": 3, "kW": 2, "sH": 1, "sW": 2,
                             "pnorm": 3}),
    C("splitV", [f32(4, 7)], {"sizes": [2, 5], "axis": 1}, n_out=2),
    C("splitV", [f32(6, 3)], {"sizes": [1, 2, 3], "axis": 0}, n_out=3),
    # the onnx_* helper ops
    C("onnx_flatten", [f32(2, 3, 4, 5)]),
    C("onnx_flatten", [f32(2, 3, 4, 5)], {"axis": 2}),
    C("onnx_flatten", [f32(2, 3, 4, 5)], {"axis": 0}),
    C("onnx_reshape0", [f32(2, 3, 4)], {"shape": (0, 12)}),
    C("onnx_reshape0", [f32(2, 3, 4)], {"shape": (0, 0, -1)}),
    C("onnx_global_avg_pool", [IMG]),
    C("onnx_hardmax", [TIES]), C("onnx_hardmax", [TIES], {"axis": 0}),
    C("onnx_topk", [TIES], {"k": 2}, n_out=2),
    C("onnx_topk", [TIES], {"k": 2, "largest": 0}, n_out=2),
    C("onnx_topk", [f32(4, 3)], {"k": 3, "axis": 0}, n_out=2),
    C("onnx_resize", [IMG], {"scaleH": 2.0, "scaleW": 2.0}),
    C("onnx_resize", [IMG], {"sizeH": 9, "sizeW": 4, "method": "nearest"}),
    C("onnx_resize", [IMG], {"scaleH": 2.0, "scaleW": 1.5,
                             "method": "linear"}),
    C("onnx_resize", [IMG], {"sizeH": 3, "sizeW": 4, "method": "linear"}),
    C("onnx_resize", [IMG], {"sizeH": 8, "sizeW": 5, "method": "cubic"}),
    C("onnx_qlinear", [X34 * 3], {"scale": 0.1, "zp": 3.0, "qmin": -128.0,
                                  "qmax": 127.0}),
    C("onnx_qlinear", [X34 * 3], {"scale": [0.1, 0.2, 0.05, 0.5],
                                  "zp": [0.0, 1.0, 2.0, 3.0],
                                  "axis": 1}),
    C("onnx_dqlinear", [np.round(X34 * 20)], {"scale": 0.05, "zp": 2.0}),
    C("onnx_dqlinear", [np.round(X34 * 20)],
      {"scale": [0.1, 0.2, 0.3], "zp": [0.0, 1.0, -1.0], "axis": 0}),
    _rnn_case("lstm", "forward"),
    _rnn_case("lstm", "bidirectional", with_c0=True),
    _rnn_case("lstm", "reverse", with_b=False, with_h0=False),
    _rnn_case("gru", "forward", lbr=0),
    _rnn_case("gru", "bidirectional", lbr=1),
    _rnn_case("gru", "reverse", lbr=1, with_h0=False),
    _rnn_case("rnn", "forward", activation="Tanh"),
    _rnn_case("rnn", "bidirectional", activation="Relu"),
    _rnn_case("rnn", "reverse", activation="Tanh", with_b=False),
    C("onnx_onehot", [np.array([[1, -1, 5], [0, 3, -4]])], {"depth": 4}),
    C("onnx_onehot", [np.array([0, 2, -2])],
      {"depth": 3, "off": -1.0, "on": 2.0, "axis": 0}),
    C("onnx_shrink", [X34 * 2]),
    C("onnx_shrink", [X34 * 2], {"lambd": 1.0, "bias": 0.5}),
]


def _build(pkg, case, variables=False):
    """The one-op graph in one package; float inputs become variables when
    ``variables``.  Returns (sd, feeds, output names)."""
    sd = JSameDiff.create() if pkg == "jax" else SameDiff.create("cpu")
    ins, feeds = [], {}
    for i, a in enumerate(case["ins"]):
        if variables and a.dtype == np.float32:
            ins.append(sd.var(f"in{i}", a))
        else:
            ins.append(sd.placeholder(f"in{i}"))
            feeds[f"in{i}"] = a
    outs = sd._op(case["op"], ins, case["attrs"], n_out=case["n_out"],
                  name="out")
    outs = outs if isinstance(outs, list) else [outs]
    return sd, feeds, [o.name() for o in outs]


def _run(pkg, case):
    sd, feeds, names = _build(pkg, case)
    res = sd.output(feeds, *names)
    conv = (lambda a: np.asarray(a.numpy())) if pkg == "jax" else _np
    return [conv(res[n]) for n in names]


@pytest.mark.parametrize("case", CASES)
def test_op_matches_reference(case):
    j, t = _run("jax", case), _run("torch", case)
    assert len(j) == len(t) == case["n_out"]
    for jo, to in zip(j, t):
        assert jo.shape == to.shape, (jo.shape, to.shape)
        if jo.dtype.kind in "iub" or to.dtype.kind in "iub":
            np.testing.assert_array_equal(to, jo)
        else:
            np.testing.assert_allclose(to, jo, **FWD)


GRAD_CASES = [c for c in CASES if c.values[0]["grad"]]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_weight_bearing_op_gradients_match_reference(case):
    grads = {}
    for pkg in ("jax", "torch"):
        sd, feeds, names = _build(pkg, case, variables=True)
        out = sd.getVariable(names[0])
        w = f32(*case_shape(pkg, case), seed=9)
        loss = out.mul(sd.constant(w)).sum()
        sd.setLossVariables(loss)
        g = sd.calculateGradients(feeds)
        conv = (lambda a: np.asarray(a.numpy())) if pkg == "jax" else _np
        grads[pkg] = {n: conv(v) for n, v in g.items()}
    assert sorted(grads["jax"]) == sorted(grads["torch"])
    assert grads["jax"]
    for n, j in grads["jax"].items():
        np.testing.assert_allclose(grads["torch"][n], j, atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def case_shape(pkg, case):
    """The first output's shape (the loss weights' shape)."""
    return _run(pkg, case)[0].shape


def test_every_op_the_onnx_rules_emit_is_ported():
    """Each SameDiff op a rule of the reference's ONNX importer emits is
    registered in the port, and the 31 ops the port gained with the
    importer each have a case here."""
    import re
    from pathlib import Path
    from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS
    src = "".join((Path(__file__).parent.parent / "deeplearning4j_tpu"
                   / "imports" / f).read_text()
                  for f in ("onnx_import.py", "onnx_import_ext.py",
                            "onnx_import_ext2.py", "onnx_import_ext3.py"))
    emitted = set(re.findall(r'_op\(\s*"(\w+)"', src))
    emitted |= set(re.findall(r'\("[A-Z]\w*",\s*"(\w+)"\)', src))
    emitted -= {n for n in emitted if n[0].isupper()}   # ONNX's names
    assert len(emitted) > 80
    assert sorted(emitted - set(OP_IMPLS)) == []
    new = {"hardSwish", "logSumExp", "tril", "prelu", "thresholdRelu",
           "standardize", "takeAlongAxis", "putAlongAxis", "split",
           "l2Normalize", "triu", "deconv2d",
           "squaredNorm", "instanceNorm", "groupNorm", "pnormPool2d",
           "splitV", "onnx_flatten", "onnx_reshape0",
           "onnx_global_avg_pool", "onnx_hardmax", "onnx_topk",
           "onnx_resize", "onnx_qlinear", "onnx_dqlinear",
           "onnx_bernoulli", "onnx_lstm", "onnx_gru", "onnx_rnn",
           "onnx_onehot", "onnx_shrink"}
    assert len(new) == 31 and new <= set(OP_IMPLS)
    tested = {c.values[0]["op"] for c in CASES} | {"onnx_bernoulli"}
    assert sorted(new - tested) == []


# ---------------------------------------------------------------------------
# onnx_bernoulli: the reference's bits are jax.random's, so hold the contract
# ---------------------------------------------------------------------------
def test_bernoulli_is_a_seeded_draw_at_each_probability():
    p = np.tile(np.array([0.0, 1.0, 0.25, 0.75], np.float32), (2000, 1))
    case = dict(op="onnx_bernoulli", ins=[p], attrs={"seed": 3}, n_out=1)
    t, t2, j = _run("torch", case)[0], _run("torch", case)[0], \
        _run("jax", case)[0]
    np.testing.assert_array_equal(t, t2)
    for out in (t, j):
        assert out.shape == p.shape and out.dtype == np.float32
        assert set(np.unique(out)) <= {0.0, 1.0}
        np.testing.assert_array_equal(out[:, :2], p[:, :2])
        np.testing.assert_allclose(out[:, 2:].mean(0), [0.25, 0.75],
                                   atol=0.04)
