"""Port parity: the SameDiff core (``deeplearning4j_tpu_torch/autodiff``)
against the JAX package's ``autodiff/samediff.py``.

Every case builds the same graph in both packages through the shared
SameDiff API, feeds the same seeded numpy inputs and compares the outputs:
each op family (elementwise, reductions with ``dims`` / ``keepDims``, shape
ops, ``gather`` / ``oneHot``, the nn ops, both attention ops with and
without a mask, ``embeddingLookup`` with ids -1 and >= n, each loss under
each reduction), ``calculateGradients`` against ``jax.grad``, ``fit`` of
``tests/test_samediff.py``'s linear regression under Sgd and Adam with and
without L1/L2, and the zip format both ways with ``updater.npz``.

Both compute in float32 (the JAX package turns on x64, so its one-hot,
linspace and eye come out float64; values are compared) and differ by
summation order: forward atol 2e-5 / rtol 1e-4; gradients and fitted
variables rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import config as jlc
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.listeners import HistoryListener
from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning import config as tlc

from _torch_parity import _np

pytestmark = pytest.mark.torch_port

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD_RTOL = 1e-4
R = np.random.RandomState(0)
X = R.randn(3, 4, 5).astype(np.float32)
Y = R.randn(3, 4, 5).astype(np.float32)
POS = (np.abs(X) + 0.5).astype(np.float32)
UNIT = np.clip(X, -0.9, 0.9).astype(np.float32)


def _both(build, feeds=None):
    """Build with ``build(sd) -> output names`` in both packages and run
    ``output``; returns [(name, JAX array, port array)]."""
    feeds = feeds or {}
    js = JSameDiff.create()
    ts = SameDiff.create("cpu")
    names = build(js)
    assert build(ts) == names
    jo = js.output(feeds, *names)
    to = ts.output(feeds, *names)
    return [(n, np.asarray(jo[n].numpy()), _np(to[n])) for n in names]


def _check(build, feeds=None, **tol):
    for name, j, t in _both(build, feeds):
        assert j.shape == t.shape, (name, j.shape, t.shape)
        np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                                   err_msg=name, **(tol or FWD))


def _op(op, inputs, attrs=None):
    """A builder of one op over named constant inputs."""
    def build(sd):
        ins = [sd.constant(a, name=f"in{i}") for i, a in enumerate(inputs)]
        return [sd._op(op, ins, attrs, name="out").name()]
    return build


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
UNARY = {op: X for op in [
    "neg", "exp", "square", "abs", "sign", "floor", "ceil", "round", "sin",
    "cos", "tan", "atan", "sinh", "cosh", "tanh", "erf", "erfc", "sigmoid",
    "softplus", "softsign", "relu6", "elu", "selu", "swish", "mish",
    "hardSigmoid", "hardTanh", "identity", "logSigmoid", "isNaN", "isInf",
    "isFinite"]}
UNARY.update({op: POS for op in ["log", "log1p", "sqrt", "reciprocal",
                                 "rsqrt"]})
UNARY.update({op: UNIT for op in ["asin", "acos"]})


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary(op):
    _check(_op(op, [UNARY[op] * 3]))


@pytest.mark.parametrize("op,attrs", [
    ("gelu", {}), ("gelu", {"approximate": False}), ("relu", {}),
    ("relu", {"cutoff": 0.5}), ("leakyRelu", {"alpha": 0.2}),
    ("clipByValue", {"clipValueMin": -0.3, "clipValueMax": 0.4}),
    ("softmax", {}), ("softmax", {"dimension": 1}), ("logSoftmax", {}),
    ("cast", {"dtype": "int32"}), ("cast", {"dtype": "float64"}),
    ("cumsum", {"axis": 1}), ("cumprod", {"axis": 2}),
    ("argmax", {"dimension": 1}), ("argmin", {"dimension": 2,
                                              "keepDims": True})],
    ids=lambda v: str(v))
def test_unary_with_attrs(op, attrs):
    _check(_op(op, [X * 3], attrs))


BINARY = ["add", "sub", "mul", "div", "rsub", "rdiv", "squaredDifference",
          "max_pairwise", "min_pairwise", "atan2", "floordiv", "mod", "eq",
          "neq", "gt", "gte", "lt", "lte"]


@pytest.mark.parametrize("op", BINARY + ["pow"])
def test_binary(op):
    a = POS if op == "pow" else np.round(X * 3)
    _check(_op(op, [a, np.round(Y * 2) + 0.5]))


@pytest.mark.parametrize("op", ["and_", "or_", "xor"])
def test_logical(op):
    _check(_op(op, [X > 0, Y > 0]))
    _check(_op("not_", [X > 0]))


def test_operator_overloads():
    def build(sd):
        a = sd.constant(X, name="a")
        b = sd.constant(POS, name="b")
        return [(a + 2.0).rename("p").name(), (3.0 - a).rename("q").name(),
                (a * b / 2.0).rename("r").name(),
                (1.0 / b).rename("s").name(), (b ** 2.0).rename("t").name(),
                (-a).rename("u").name(), a.gt(0.1).rename("v").name()]
    _check(build)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
REDUCTIONS = ["sum", "mean", "reduce_max", "reduce_min", "prod", "std",
              "variance", "norm1", "norm2", "normMax", "countNonZero", "any",
              "all"]


@pytest.mark.parametrize("dims", [None, (1,), (0, 2), (-1,)],
                         ids=lambda d: str(d))
@pytest.mark.parametrize("op", REDUCTIONS)
def test_reduction(op, dims):
    """With and without ``keepDims``, as two outputs of one graph."""
    x = np.round(X * 2) if op in ("countNonZero", "any", "all") else X

    def build(sd):
        xin = sd.constant(x, name="x")
        return [sd._op(op, [xin], {"dims": dims, "keepDims": keep},
                       name=f"keep{keep}").name() for keep in (False, True)]
    _check(build)


# ---------------------------------------------------------------------------
# shape ops, gather / oneHot
# ---------------------------------------------------------------------------
M = R.randn(4, 3).astype(np.float32)
SHAPE_CASES = {
    "reshape": ("reshape", [X], {"shape": (4, 15)}),
    "reshape-1": ("reshape", [X], {"shape": (-1, 5)}),
    "permute": ("permute", [X], {"dims": (2, 0, 1)}),
    "transpose": ("transpose", [X], {}),
    "expandDims": ("expandDims", [X], {"axis": 1}),
    "squeeze": ("squeeze", [X[:, :1]], {"axis": 1}),
    "squeeze-all": ("squeeze", [X[:1, :, :1]], {}),
    "concat": ("concat", [X, Y], {"dimension": 1}),
    "stack": ("stack", [X, Y], {"axis": 2}),
    "tile": ("tile", [M], {"reps": (2, 3)}),
    "slice": ("slice", [X], {"begin": (1, 0, 2), "size": (2, -1, 2)}),
    "stridedSlice": ("stridedSlice", [X], {"begin": (0, 1), "end": (3, 4),
                                           "strides": (2, 2)}),
    "stridedSlice-neg": ("stridedSlice", [X], {"begin": (2, 3),
                                               "end": (None, 0),
                                               "strides": (-1, -2)}),
    "stridedSlice-axes": ("stridedSlice", [X], {"begin": (1,), "end": (99,),
                                                "axes": (2,)}),
    "reverse": ("reverse", [X], {"dims": (0, 2)}),
    "pad-constant": ("pad", [M], {"paddings": ((1, 2), (0, 1)),
                                  "constant": 0.5}),
    "pad-reflect": ("pad", [M], {"paddings": ((2, 1), (1, 2)),
                                 "mode": "REFLECT"}),
    "pad-symmetric": ("pad", [M], {"paddings": ((1, 2), (2, 0)),
                                   "mode": "SYMMETRIC"}),
    "gather0": ("gather", [M, np.array([2, 0, -1, 3], np.int32)], {}),
    "gather1": ("gather", [X, np.array([[4, 0], [1, -2]], np.int32)],
                {"axis": 2}),
    "gather-out-of-range": ("gather", [M, np.array([4, -5, 1], np.int32)],
                            {}),
    "oneHot": ("oneHot", [np.array([0, 2, 1, -1, 3], np.int32)],
               {"depth": 3}),
    "oneHot-axis0": ("oneHot", [np.array([[0, 2], [1, 1]], np.int32)],
                     {"depth": 4, "axis": 0, "on": 2.0, "off": -1.0}),
    "scatterUpdate": ("scatterUpdate", [M, np.array([3, 0], np.int32),
                                        np.ones((2, 3), np.float32)], {}),
    "scatterAdd": ("scatterAdd", [M, np.array([1, 1, 2], np.int32),
                                  np.ones((3, 3), np.float32)], {}),
    "shape_of": ("shape_of", [X], {}),
    "size": ("size", [X], {}),
    "rank": ("rank", [X], {}),
    "zerosLike": ("zerosLike", [X], {}),
    "onesLike": ("onesLike", [X], {}),
    "fill": ("fill", [], {"shape": (2, 3), "value": 1.5}),
    "range": ("range", [], {"start": 1.0, "limit": 4.0, "delta": 0.5}),
    "linspace": ("linspace", [], {"start": -1.0, "stop": 2.0, "num": 7}),
    "eye": ("eye", [], {"rows": 3, "cols": 4}),
    "where": ("where", [X > 0, X, Y], {}),
    "select": ("select", [(X > 0).astype(np.float32), X, Y], {}),
    "matrixDiag": ("matrixDiag", [M[0]], {}),
    "trace": ("trace", [R.randn(3, 3, 2).astype(np.float32)], {}),
    "mmul": ("mmul", [M, M.T], {}),
    "mmul-tA": ("mmul", [M, M], {"transposeA": True}),
    "mmul-tB": ("mmul", [X, Y], {"transposeB": True}),
    "tensorMmul": ("tensorMmul", [X, R.randn(5, 2).astype(np.float32)], {}),
    "dot": ("dot", [X, Y], {}),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_op(case):
    op, ins, attrs = SHAPE_CASES[case]
    _check(_op(op, ins, attrs))


def test_unstack_and_namespace_helpers():
    def build(sd):
        x = sd.constant(X, name="x")
        parts = sd.unstack(x, 1, 4, name="u")
        g = sd.gather(x, [2, 0], axis=0, name="g")
        c = sd.concat(0, x, x, name="c")
        s = x.get(slice(1, 3), 2).rename("s")
        oh = sd.oneHot(sd.constant(np.array([1, 0, 2], np.int32)), 3,
                       name="oh")
        return [p.name() for p in parts] + [g.name(), c.name(), s.name(),
                                            oh.name()]
    _check(build)


# ---------------------------------------------------------------------------
# nn ops
# ---------------------------------------------------------------------------
IMG = R.randn(2, 3, 7, 6).astype(np.float32)
KERN = (R.randn(3, 3, 3, 4) * 0.3).astype(np.float32)
NN_CASES = {
    "linear": ("linear", [X, R.randn(5, 3).astype(np.float32), M[0]], {}),
    "reluLayer": ("reluLayer", [X, R.randn(5, 3).astype(np.float32), M[0]],
                  {}),
    "layerNorm": ("layerNorm", [X * 3 + 1, POS[0, 0], Y[0, 0]], {}),
    "layerNorm-noBias": ("layerNorm", [X * 3 + 1, POS[0, 0]],
                         {"noBias": True}),
    "layerNorm-axis1": ("layerNorm", [X, POS[0, :, :1]], {"axis": 1}),
    "batchNorm": ("batchNorm", [IMG, M[:3, 0], POS[0, 0, :3], POS[1, 0, :3],
                                Y[0, 0, :3]], {}),
    "conv2d-same": ("conv2d", [IMG, KERN], {"kH": 3, "kW": 3, "sH": 2,
                                            "sW": 2, "isSameMode": True}),
    "conv2d-pad-dilated-bias": ("conv2d", [IMG, KERN,
                                           R.randn(4).astype(np.float32)],
                                {"kH": 3, "kW": 3, "pH": 2, "pW": 1,
                                 "dH": 2, "dW": 1}),
    "conv2d-nhwc": ("conv2d", [IMG.transpose(0, 2, 3, 1), KERN],
                    {"kH": 3, "kW": 3, "isSameMode": True,
                     "dataFormat": "NHWC"}),
    "maxPooling2d": ("maxPooling2d", [IMG], {}),
    "maxPooling2d-same": ("maxPooling2d", [IMG], {"kH": 3, "kW": 3,
                                                  "isSameMode": True}),
    "avgPooling2d-same": ("avgPooling2d", [IMG], {"kH": 3, "kW": 2, "sH": 2,
                                                  "sW": 1,
                                                  "isSameMode": True}),
    "avgPooling2d-pad": ("avgPooling2d", [IMG], {"kH": 3, "kW": 3, "pH": 1,
                                                 "pW": 1, "sH": 1, "sW": 1}),
    "avgPooling2d-nhwc": ("avgPooling2d", [IMG.transpose(0, 2, 3, 1)],
                          {"dataFormat": "NHWC", "isSameMode": True}),
    # -1 wraps to the last row; 4 and -5 give NaN rows (jnp.take's rules)
    "embeddingLookup": ("embeddingLookup",
                        [M, np.array([[0, 3, -1], [4, 2, -5]], np.int32)],
                        {}),
}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nn_op(case):
    op, ins, attrs = NN_CASES[case]
    _check(_op(op, ins, attrs))


B, T, D = 2, 5, 8
Q = R.randn(B, 2, T, 4).astype(np.float32)
KV = R.randn(B, 2, T, 4).astype(np.float32)
MASK = np.ones((B, 1, 1, T), np.float32)
MASK[0, ..., 3:] = 0
MASK[1] = 0                             # a fully masked row: uniform weights
SEQ = R.randn(B, T, D).astype(np.float32)
WS = [(R.randn(D, D) * 0.3).astype(np.float32) for _ in range(4)]
FMASK = np.ones((B, T), np.float32)
FMASK[0, 3:] = 0
FMASK[1] = 0


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention(masked):
    def build(sd):
        ins = [sd.constant(a) for a in (Q, KV, KV * 0.5)]
        m = sd.constant(MASK) if masked else None
        out = sd.nn().dotProductAttention(*ins, mask=m, name="a")
        wout = sd._op("dotProductAttention", ins + ([m] if masked else []),
                      {"withWeights": True, "scaled": False}, n_out=2,
                      name="w")
        return [out.name()] + [w.name() for w in wout]
    _check(build)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(masked):
    def build(sd):
        x = sd.constant(SEQ, name="x")
        ws = [sd.var(f"W{i}", w) for i, w in enumerate(WS)]
        m = sd.constant(FMASK) if masked else None
        return [sd.nn().multiHeadDotProductAttention(
            x, x, x, *ws, mask=m, nHeads=2, name="mha").name()]
    _check(build)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
LOGITS = R.randn(6, 5).astype(np.float32)
ONEHOT = np.eye(5, dtype=np.float32)[R.randint(0, 5, 6)]
SPARSE = R.randint(0, 5, 6).astype(np.int32)
WEIGHTS = np.array([1, 0, 2, 0.5, 0, 1], np.float32)
PROBS = 1 / (1 + np.exp(-LOGITS))
#: loss -> (inputs, whether it takes weights)
LOSSES = {
    "softmaxCrossEntropy": ([LOGITS, ONEHOT], True),
    "sparseSoftmaxCrossEntropy": ([LOGITS, SPARSE], True),
    "sigmoidCrossEntropy": ([LOGITS, (ONEHOT > 0).astype(np.float32)], True),
    "meanSquaredError": ([LOGITS, ONEHOT], True),
    "absoluteDifference": ([LOGITS, ONEHOT], True),
    "huberLoss": ([LOGITS, ONEHOT], True),
    "logLoss": ([PROBS, ONEHOT], False),
    "cosineDistance": ([LOGITS / np.linalg.norm(LOGITS, axis=1,
                                                keepdims=True), ONEHOT],
                       False),
}
REDUCES = ["NONE", "SUM", "MEAN_BY_WEIGHT", "MEAN_BY_NONZERO_WEIGHT_COUNT"]


@pytest.mark.parametrize("loss,reduction,weighted", [
    (loss, reduction, weighted) for loss in sorted(LOSSES)
    for reduction in REDUCES for weighted in (False, True)
    if LOSSES[loss][1] or not weighted])
def test_loss(loss, reduction, weighted):
    ins, _ = LOSSES[loss]
    attrs = {"reduction": reduction}
    if loss == "softmaxCrossEntropy":
        attrs["labelSmoothing"] = 0.1
    _check(_op(loss, ins + ([WEIGHTS] if weighted else []), attrs))


def test_sparse_cross_entropy_out_of_range_label_is_nan():
    labels = np.array([0, 5, -1, 2, -6, 1], np.int32)
    _check(_op("sparseSoftmaxCrossEntropy", [LOGITS, labels],
               {"reduction": "NONE"}))


# ---------------------------------------------------------------------------
# dropout and the random ops: the port draws from torch generators, so
# they are held to their semantics, not to the reference's bits
# ---------------------------------------------------------------------------
def test_dropout_keep_rate_scale_and_seeding():
    x = torch.full((200_000,), 3.0)
    fn = OP_IMPLS["dropout"](p=0.8, seed=7)
    y0, y0b, y1 = fn(x, 0), fn(x, 0), fn(x, 1)
    kept = y0 != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    torch.testing.assert_close(y0[kept], torch.full_like(y0[kept], 3.75))
    assert torch.equal(y0, y0b) and not torch.equal(y0, y1)


def test_dropout_is_identity_at_inference_and_drops_in_training():
    sd = SameDiff.create("cpu")
    x = sd.placeholder("x")
    w = sd.var("w", np.ones((1000,), np.float32))
    d = sd.nn().dropout(x * w, keepProb=0.5, seed=1, name="d")
    d.sum().rename("loss").markAsLoss()
    xv = np.ones(1000, np.float32)
    np.testing.assert_array_equal(_np(d.eval({"x": xv})), xv)
    g = _np(sd.calculateGradients({"x": xv}, "w")["w"])
    assert set(np.unique(g)) == {0.0, 2.0}
    assert 0.4 < (g != 0).mean() < 0.6


def test_random_ops_are_seeded_and_shaped():
    sd = SameDiff.create("cpu")
    n = sd.random().normal(1.0, 2.0, (20000,), seed=3, name="n")
    u = sd.random().uniform(-1.0, 3.0, (20000,), seed=3, name="u")
    b = sd.random().bernoulli(0.25, (20000,), seed=3, name="b")
    o1 = sd.output({}, n, u, b)
    o2 = sd.output({}, n, u, b)
    for k in o1:
        assert torch.equal(o1[k], o2[k])
    assert abs(float(o1["n"].mean()) - 1.0) < 0.05
    assert abs(float(o1["n"].std()) - 2.0) < 0.05
    assert float(o1["u"].min()) >= -1.0 and float(o1["u"].max()) < 3.0
    assert abs(float(o1["b"].mean()) - 0.25) < 0.02


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _grad_graph(sd):
    """An MLP with a tied embedding table, layerNorm, gelu, attention and a
    weighted softmax cross-entropy."""
    r = np.random.RandomState(4)
    ids = sd.placeholder("ids", dtype=np.int32)
    lab = sd.placeholder("lab")
    w = sd.placeholder("w")
    emb = sd.var("emb", (r.randn(7, 8) * 0.5).astype(np.float32))
    ws = [sd.var(f"W{i}", (r.randn(8, 8) * 0.3).astype(np.float32))
          for i in range(4)]
    g = sd.var("g", np.ones(8, np.float32) * 1.1)
    bb = sd.var("bb", np.full(8, 0.1, np.float32))
    sd.var("unused", np.ones(3, np.float32))
    x = sd.nn().embeddingLookup(emb, ids)                  # (2, 5, 8)
    x = sd.nn().layerNorm(x + sd.nn().multiHeadDotProductAttention(
        x, x, x, *ws, nHeads=2), g, bb)
    h = sd.nn().gelu(x)
    logits = h.mmul(emb, transposeB=True)                  # (2, 5, 7)
    sd.loss().softmaxCrossEntropy(lab, logits, weights=w, name="loss")


def _grad_feeds():
    r = np.random.RandomState(5)
    return {"ids": r.randint(0, 7, (2, 5)).astype(np.int32),
            "lab": np.eye(7, dtype=np.float32)[r.randint(0, 7, (2, 5))],
            "w": (r.rand(2, 5) > 0.3).astype(np.float32)}


def test_calculate_gradients_match_jax_grad():
    js, ts = JSameDiff.create(), SameDiff.create("cpu")
    _grad_graph(js)
    _grad_graph(ts)
    feeds = _grad_feeds()
    jg = js.calculateGradients(feeds)
    tg = ts.calculateGradients(feeds)
    assert sorted(jg) == sorted(tg)
    for n in jg:
        j = np.asarray(jg[n].numpy())
        np.testing.assert_allclose(_np(tg[n]), j, rtol=GRAD_RTOL,
                                   atol=1e-6 * np.abs(j).max() + 1e-12,
                                   err_msg=n)
    np.testing.assert_array_equal(_np(tg["unused"]), 0.0)
    np.testing.assert_array_equal(_np(ts.getVariable("emb").gradient()),
                                  _np(tg["emb"]))
    one = ts.grad(feeds, "W0")
    assert list(one) == ["W0"]


# ---------------------------------------------------------------------------
# fit: tests/test_samediff.py's linear regression
# ---------------------------------------------------------------------------
def _regression(sd):
    x = sd.placeholder("x", shape=(None, 2))
    label = sd.placeholder("label", shape=(None, 1))
    w = sd.var("w", np.zeros((2, 1), np.float32))
    b = sd.var("b", np.full((1,), 0.2, np.float32))
    pred = (x.mmul(w) + b).rename("pred")
    sd.loss().meanSquaredError(label, pred, name="loss")


def _regression_data():
    r = np.random.RandomState(42)
    X = r.randn(256, 2).astype(np.float32)
    return X, (X @ np.array([[2.0], [-3.0]], np.float32) + 0.5)


def _fit_both(updater, epochs, **cfg):
    X, Y = _regression_data()
    fitted = []
    for sd, tc, lc, ds in (
            (JSameDiff.create(), JTrainingConfig, jlc, JDataSet(X, Y)),
            (SameDiff.create("cpu"), TrainingConfig, tlc, DataSet(X, Y))):
        _regression(sd)
        b = (tc.Builder().updater(updater(lc)).dataSetFeatureMapping("x")
             .dataSetLabelMapping("label"))
        for k, v in cfg.items():
            b = getattr(b, k)(v)
        sd.setTrainingConfig(b.build())
        fitted.append((sd, sd.fit(ds, epochs=epochs)))
    return fitted


@pytest.mark.parametrize("cfg", [{}, {"l2": 0.05}, {"l1": 0.02, "l2": 0.01}],
                         ids=["plain", "l2", "l1+l2"])
@pytest.mark.parametrize("updater", [lambda m: m.Sgd(0.05),
                                     lambda m: m.Adam(0.1)],
                         ids=["Sgd", "Adam"])
def test_fit_linear_regression_matches(updater, cfg):
    (js, jh), (ts, th) = _fit_both(updater, 12, **cfg)
    np.testing.assert_allclose(th.lossCurve(), jh.lossCurve(),
                               rtol=GRAD_RTOL)
    assert ts.iterationCount == js.iterationCount == 12
    for n in ("w", "b"):
        np.testing.assert_allclose(_np(ts.getVariable(n).getArr()),
                                   js.getVariable(n).getArr().numpy(),
                                   rtol=GRAD_RTOL, atol=1e-7)


def test_fit_with_listeners_and_a_variable_added_after_a_fit():
    X, Y = _regression_data()
    sd = SameDiff.create("cpu")
    _regression(sd)
    sd.setTrainingConfig(TrainingConfig(updater=tlc.Adam(0.1),
                                        dataSetFeatureMapping=["x"],
                                        dataSetLabelMapping=["label"]))
    hl = HistoryListener()
    sd.setListeners(hl)
    h = sd.fit([DataSet(X[:128], Y[:128]), DataSet(X[128:], Y[128:])],
               epochs=2)
    assert hl.losses == pytest.approx(h.lossCurve()) and len(hl.losses) == 4
    extra = sd.var("extra", np.ones((1,), np.float32))
    (sd.getVariable("pred") * 0.0 + extra * extra).sum().rename(
        "reg").markAsLoss()
    sd.fit(DataSet(X, Y), epochs=1)
    assert "extra" in sd._opt_state and sd.iterationCount == 5
    assert float(sd.getVariable("extra").getArr()) < 1.0


# ---------------------------------------------------------------------------
# serde: the zip both ways, with the updater state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_zip_loads_in_the_other_package(tmp_path, direction):
    (js, _), (ts, _) = _fit_both(lambda m: m.Adam(0.1), 3)
    X, Y = _regression_data()
    path = str(tmp_path / "g.sdz")
    if direction == "jax->port":
        js.save(path, saveUpdaterState=True)
        loaded = SameDiff.load(path, loadUpdaterState=True, device="cpu")
        src_opt = {n: {k: np.asarray(a) for k, a in st.items()}
                   for n, st in js._opt_state.items()}
        got_opt = {n: {k: _np(a) for k, a in st.items()}
                   for n, st in loaded._opt_state.items()}
        src = js
    else:
        ts.save(path, saveUpdaterState=True)
        loaded = JSameDiff.load(path, loadUpdaterState=True)
        src_opt = {n: {k: _np(a) for k, a in st.items()}
                   for n, st in ts._opt_state.items()}
        got_opt = {n: {k: np.asarray(a) for k, a in st.items()}
                   for n, st in loaded._opt_state.items()}
        src = ts
    assert sorted(src_opt) == sorted(got_opt)
    for n in src_opt:
        for k in src_opt[n]:
            np.testing.assert_array_equal(got_opt[n][k], src_opt[n][k])
    # the loaded variables are the source's bit for bit ...
    assert sorted(loaded._arrays) == sorted(src._arrays)
    for n in src._arrays:
        np.testing.assert_array_equal(_np(loaded._arrays[n]),
                                      _np(src._arrays[n]))
    # ... but the outputs come from two libraries' float32 products
    # (XLA's and torch's), which may round differently: atol 1e-6
    out = lambda sd: np.asarray(
        sd.output({"x": X[:4]}, "pred")["pred"].numpy()
        if not isinstance(sd, SameDiff)
        else _np(sd.output({"x": X[:4]}, "pred")["pred"]))
    np.testing.assert_allclose(out(loaded), out(src), atol=1e-6, rtol=0)
    assert loaded.getLossVariables() == ["loss"]
    assert loaded.getVariable("x").shape == (None, 2)


def test_bert_style_graph_round_trips_in_the_port(tmp_path):
    sd = SameDiff.create("cpu")
    _grad_graph(sd)
    path = str(tmp_path / "g.sdz")
    sd.save(path)
    back = SameDiff.load(path, device="cpu")
    feeds = _grad_feeds()
    assert back.getVariable("ids").dtype == torch.int32
    for k, v in sd.output(feeds).items():
        assert torch.equal(back.output(feeds)[k], v)


def test_load_names_ops_the_port_lacks(tmp_path):
    """A reference zip with an op this test once refused (``clipByNorm``)
    loads and runs as the reference's; one naming an op neither package
    registers still raises, naming it."""
    import json
    import zipfile
    js = JSameDiff.create()
    x = js.var("x", np.arange(3, dtype=np.float32))
    js._op("clipByNorm", [x], {"clipValue": 1.0}, name="c")
    path = str(tmp_path / "g.sdz")
    js.save(path)
    back = SameDiff.load(path, device="cpu")
    np.testing.assert_allclose(_np(back.output({}, "c")["c"]),
                               np.asarray(js.output({}, "c")["c"].numpy()),
                               rtol=1e-6)
    with zipfile.ZipFile(path) as z:
        graph = json.loads(z.read("graph.json"))
        arrays = z.read("arrays.npz")
    graph["ops"][0]["op"] = "noSuchOp"
    bad = str(tmp_path / "bad.sdz")
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("graph.json", json.dumps(graph))
        z.writestr("arrays.npz", arrays)
    with pytest.raises(NotImplementedError, match="noSuchOp"):
        SameDiff.load(bad, device="cpu")


def _calls():
    """Each call this test once refused, as a working call: (build, check)
    on a graph with placeholder ``x`` (2 x 3) fed A."""
    def image(sd, x):
        return sd.image().flipLeftRight(sd._op("reshape", [x], {
            "shape": (1, 2, 3, 1)}), name="o")

    def rnn(sd, x):
        h = sd.constant(np.zeros((2, 2), np.float32))
        return sd.rnn().lstmCell(x, h, h, sd.constant(np.ones(
            (5, 8), np.float32) * 0.1), sd.constant(np.zeros(8, np.float32)),
            name="o")[0]

    def linalg(sd, x):
        return sd.linalg().det(x @ x.transpose() + 1.0, name="o")

    def while_loop(sd, x):
        return sd.whileLoop([sd.constant(0.0), x], lambda s, v: v[0].lt(3.0),
                            lambda s, v: [v[0] + 1.0, v[1] * 2.0])[1]

    def if_cond(sd, x):
        return sd.ifCond([x], lambda s, v: v[0].sum().gt(100.0),
                         lambda s, v: [v[0] + 1.0],
                         lambda s, v: [v[0] - 1.0])[0]

    def for_loop(sd, x):
        return sd.forLoop(2, [x], lambda s, v: [s.math().tanh(v[0])])[0]
    return {"image": image, "rnn": rnn, "linalg": linalg,
            "whileLoop": while_loop, "ifCond": if_cond, "forLoop": for_loop}


@pytest.mark.parametrize("call", [
    "image", "rnn", "linalg", "whileLoop", "ifCond", "forLoop", "execDebug",
    "stepCostAnalysis", "invokeGraphOn"])
def test_unported_api_names_its_roadmap_item(call):
    """The nine calls this test once held to raising (naming ROADMAP
    A12b) work and match the reference's
    (``tests/test_torch_control_flow.py`` holds them further)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 6.0
    builds = _calls()
    if call in builds:
        for_both = []
        for sd in (JSameDiff.create(), SameDiff.create("cpu")):
            out = builds[call](sd, sd.placeholder("x"))
            got = sd.output({"x": a}, out.name())[out.name()]
            for_both.append(_np(got) if isinstance(got, torch.Tensor)
                            else np.asarray(got.numpy()))
        np.testing.assert_allclose(for_both[1], for_both[0], rtol=1e-5,
                                   atol=1e-6)
        return
    sd = SameDiff.create("cpu")
    x = sd.placeholder("x")
    y = sd.placeholder("y")
    w = sd.var("w", np.ones((3, 2), np.float32))
    sd.loss().meanSquaredError(y, x @ w, name="loss")
    if call == "execDebug":
        assert torch.allclose(sd.execDebug({"x": a, "y": a[:, :2]}, "loss")[
            "loss"], sd.output({"x": a, "y": a[:, :2]}, "loss")["loss"])
    elif call == "stepCostAnalysis":
        sd.setTrainingConfig(TrainingConfig(
            updater=tlc.Sgd(0.1), dataSetFeatureMapping=["x"],
            dataSetLabelMapping=["y"]))
        cost = sd.stepCostAnalysis(DataSet(a, a[:, :2]))
        assert cost["flops"] == 2 * 2 * 3 * 2 * 2 and cost["bytes"] > 0
    else:
        other = SameDiff.create("cpu")
        sd.invokeGraphOn(other)
        other.setLossVariables("loss")
        assert torch.equal(other.output({"x": a, "y": a[:, :2]})["loss"],
                           sd.output({"x": a, "y": a[:, :2]})["loss"])


def test_evaluate_names_its_roadmap_item():
    """``evaluate``, which this test once refused naming ROADMAP A9, is
    ported (held to the reference in ``tests/test_torch_eval.py``): it
    asks for the TrainingConfig's feature mapping first, as the
    reference does, and names no ROADMAP item."""
    with pytest.raises(ValueError, match="setTrainingConfig first"):
        SameDiff.create("cpu").evaluate(None, "x")


# ---------------------------------------------------------------------------
# listeners
# ---------------------------------------------------------------------------
def test_listener_errors_are_swallowed_and_counted_stop_signals_raised():
    from deeplearning4j_tpu_torch.optimize import listeners as ol

    class Broken(HistoryListener):
        def iterationDone(self, sd, at, data, loss=None):
            raise RuntimeError("monitor bug")

    class Stop(HistoryListener):
        def epochEnd(self, sd, at, loss_curve=None):
            raise ol.TrainingStopSignal()

    X, Y = _regression_data()
    sd = SameDiff.create("cpu")
    _regression(sd)
    sd.setTrainingConfig(TrainingConfig(updater=tlc.Sgd(0.05),
                                        dataSetFeatureMapping=["x"],
                                        dataSetLabelMapping=["label"]))
    before = ol.dl4j_tpu_train_listener_errors_total
    hl = HistoryListener()
    sd.setListeners(Broken(), hl)
    sd.fit(DataSet(X, Y), epochs=2)
    assert ol.dl4j_tpu_train_listener_errors_total == before + 2
    assert len(hl.losses) == 2
    sd.addListeners(Stop())
    with pytest.raises(ol.TrainingStopSignal):
        sd.fit(DataSet(X, Y), epochs=2)
    assert sd.iterationCount == 3


def test_exec_debugging_listener_prints_ops(capsys):
    from deeplearning4j_tpu_torch.autodiff.listeners import (
        At, ExecDebuggingListener)
    sd = SameDiff.create("cpu")
    x = sd.var("x", np.ones(3, np.float32))
    y = (x * 2.0).rename("y")
    node = sd._producer[y.name()][0]
    lst = ExecDebuggingListener(printArrays=True, maxIterations=1)
    lst.preOpExecution(sd, At(), node)
    lst.opExecution(sd, At(), node, [y.eval()])
    lst.execDebugPassDone(sd, At())
    lst.preOpExecution(sd, At(), node)        # silenced after one pass
    out = capsys.readouterr().out
    assert "[exec] mul" in out and "y: shape=(3,)" in out
    assert out.count("[exec]") == 1
