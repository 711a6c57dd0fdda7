"""Port parity: SameDiff's control flow and the rest of its API ported with
it — ``whileLoop`` / ``ifCond`` / ``forLoop`` (nested regions, forLoop's
gradients against ``jax.grad``, zips carrying regions in both
directions), ``execDebug``, ``stepCostAnalysis``, ``invokeGraphOn``, the
``image`` / ``rnn`` / ``linalg`` / ``bitwise`` namespaces, gradient checking
— and the card's Path 2 at test size: ``chip_smoke.py``'s character model
as a SameDiff graph (two ``lstmLayer``, a dense softmax), trained by
``fit``, recomputed by ``forLoop`` over ``lstmCell``, sampled greedily by
``whileLoop`` with an ``ifCond`` in its body.

Tolerances: forward atol 1e-6 (the same float32 ops in another order),
gradients and fitted variables rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import config as jlc
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.gradcheck import check_gradients
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning import config as tlc

from _torch_parity import _np
from chip_smoke import (CHAR_TEXT, _sd_char_data, _sd_char_forloop,
                        _sd_char_graph, _sd_char_sampler, _sd_char_vars)

pytestmark = pytest.mark.torch_port

SMALL = dict(hidden=8, batch=3, length=6, lr=5e-3, seed=1, iters=2, rows=2,
             primer=3)
H = SMALL["hidden"]
X, Y, VOCAB, PRIMER = _sd_char_data(CHAR_TEXT[:2000], SMALL, 3)
NC = len(VOCAB)
V = _sd_char_vars(NC, H, 5)
FEEDS = {"x": X, "y": Y}
R = np.random.RandomState(0)
A = R.randn(3, 4).astype(np.float32)
B = (R.randn(4, 4) * 0.5).astype(np.float32)


def _pair(build):
    js, ts = JSameDiff.create(), SameDiff.create("cpu")
    names = build(js)
    assert build(ts) == names
    return js, ts, names


def _outs(js, ts, names, feeds):
    jo, to = js.output(feeds, *names), ts.output(feeds, *names)
    return {n: (np.asarray(jo[n].numpy()), _np(to[n])) for n in names}


def _cfg(pkg_tc, pkg_lc, lr):
    return pkg_tc(updater=pkg_lc.Adam(lr), dataSetFeatureMapping=["x"],
                  dataSetLabelMapping=["y"])


# ---------------------------------------------------------------------------
# the character model (Path 2 at test size)
# ---------------------------------------------------------------------------
def test_char_graph_fit_matches_the_reference():
    """Two iterations of ``SameDiff.fit`` from the same variables: the loss
    curve and every variable after it."""
    js, ts, names = _pair(lambda sd: _sd_char_graph(sd, V, NC, H))
    for n, (j, t) in _outs(js, ts, names, FEEDS).items():
        np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-5, err_msg=n)
    js.setTrainingConfig(_cfg(JTrainingConfig, jlc, SMALL["lr"]))
    ts.setTrainingConfig(_cfg(TrainingConfig, tlc, SMALL["lr"]))
    jh = js.fit(JDataSet(X, Y), epochs=SMALL["iters"])
    th = ts.fit(DataSet(X, Y), epochs=SMALL["iters"])
    np.testing.assert_allclose(th.lossCurve(), jh.lossCurve(), rtol=1e-5)
    for k in V:
        np.testing.assert_allclose(_np(ts._arrays[k]),
                                   np.asarray(js._arrays[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_for_loop_states_equal_lstm_layer_and_train_like_the_reference():
    """``forLoop`` over ``lstmCell`` gives ``lstmLayer``'s states; its
    gradients (autograd through the Python loop) equal ``jax.grad``
    through the reference's ``lax.scan``, and one fit step through it
    moves the variables as the reference's."""
    t = SMALL["length"]
    ts = SameDiff.create("cpu")
    _sd_char_graph(ts, V, NC, H)
    js, fs, names = _pair(lambda sd: _sd_char_forloop(sd, V, NC, H, t))
    ref_states = _np(ts.output(FEEDS, "hs2")["hs2"])
    np.testing.assert_allclose(_np(fs.output(FEEDS, "hs2")["hs2"]),
                               ref_states, atol=1e-6)
    jg, tg = js.calculateGradients(FEEDS), fs.calculateGradients(FEEDS)
    for k in V:
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k].numpy()),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    js.setTrainingConfig(_cfg(JTrainingConfig, jlc, SMALL["lr"]))
    fs.setTrainingConfig(_cfg(TrainingConfig, tlc, SMALL["lr"]))
    jh, th = js.fit(JDataSet(X, Y)), fs.fit(DataSet(X, Y))
    np.testing.assert_allclose(th.lossCurve(), jh.lossCurve(), rtol=1e-5)
    for k in V:
        np.testing.assert_allclose(_np(fs._arrays[k]),
                                   np.asarray(js._arrays[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_sampler_matches_the_reference_and_round_trips(tmp_path):
    """The greedy sampler (``whileLoop`` with an ``ifCond`` in its body):
    the same characters as the reference's, top-two gaps within float32;
    its zip (regions nested two deep) restores bit for bit in the port and
    runs in the reference, and the reference's zip runs in the port."""
    n = 10
    js, ts, names = _pair(lambda sd: _sd_char_sampler(sd, V, NC, H, n,
                                                      PRIMER))
    res = _outs(js, ts, names, {})
    np.testing.assert_array_equal(res["chars"][1], res["chars"][0])
    np.testing.assert_allclose(res["gaps"][1], res["gaps"][0], atol=1e-6)
    p_port, p_ref = str(tmp_path / "port.sdz"), str(tmp_path / "ref.sdz")
    ts.save(p_port)
    js.save(p_ref)
    back = SameDiff.load(p_port, device="cpu")
    for k in names:
        assert torch.equal(back.output({}, k)[k], ts.output({}, k)[k])
    in_ref = JSameDiff.load(p_port)
    np.testing.assert_array_equal(
        np.asarray(in_ref.output({}, "chars")["chars"].numpy()),
        res["chars"][0])
    from_ref = SameDiff.load(p_ref, device="cpu")
    np.testing.assert_array_equal(_np(from_ref.output({}, "chars")["chars"]),
                                  res["chars"][0])


# ---------------------------------------------------------------------------
# the control-flow ops on their own
# ---------------------------------------------------------------------------
def _for_if(sd):
    """A forLoop whose body branches by ifCond."""
    x, w = sd.placeholder("x"), sd.placeholder("w")

    def step(s, v):
        br = s.ifCond([v[0], v[1]], lambda t, u: u[0].mean().gt(0.0),
                      lambda t, u: [t.math().tanh(u[0] @ u[1])],
                      lambda t, u: [t.math().sin(u[0] @ u[1]) * 0.5])[0]
        return [br, v[1]]
    return sd.forLoop(4, [x, w], step, name="f")[0]


def _nested(sd):
    """``_for_if``'s loop, then a whileLoop of two outputs whose body runs
    a forLoop: regions nested in regions."""
    f = _for_if(sd)
    k0 = sd.constant(np.float32(0.0), name="k0")

    def body(s, v):
        inner = s.forLoop(2, [v[1]], lambda t, u: [u[0] * 0.9 + 0.1])[0]
        return [v[0] + 1.0, inner]
    out = sd.whileLoop([k0, f], lambda s, v: v[0].lt(3.0), body, name="wl")
    sd._op("identity", [out[0]], name="count")
    sd._op("identity", [out[1]], name="value")
    return ["count", "value"]


def test_nested_regions_match_the_reference(tmp_path):
    js, ts, names = _pair(_nested)
    for n, (j, t) in _outs(js, ts, names, {"x": A, "w": B}).items():
        np.testing.assert_allclose(t, j, atol=1e-6, err_msg=n)
    path = str(tmp_path / "nested.sdz")
    js.save(path)
    back = SameDiff.load(path, device="cpu")
    got = back.output({"x": A, "w": B}, "value")["value"]
    np.testing.assert_allclose(
        _np(got), np.asarray(js.output({"x": A, "w": B}, "value")["value"]
                             .numpy()), atol=1e-6)


def test_if_cond_takes_each_branch_and_differentiates():
    def build(sd):
        x, w = sd.placeholder("x"), sd.var("w", B)
        y = sd.ifCond([x, w], lambda s, v: v[0].sum().gt(0.0),
                      lambda s, v: [s.math().tanh(v[0] @ v[1])],
                      lambda s, v: [(v[0] @ v[1]) * (v[0] @ v[1])],
                      name="br")[0]
        y.sum().markAsLoss()
        return [y.name()]
    js, ts, names = _pair(build)
    for x in (A, -np.abs(A)):
        for n, (j, t) in _outs(js, ts, names, {"x": x}).items():
            np.testing.assert_allclose(t, j, atol=1e-6)
        jg = js.calculateGradients({"x": x})["w"]
        tg = ts.calculateGradients({"x": x})["w"]
        np.testing.assert_allclose(_np(tg), np.asarray(jg.numpy()),
                                   rtol=1e-5, atol=1e-6)


def test_c28_while_loop_is_forward_only():
    """C28: a gradient through ``whileLoop`` raises, as the reference's
    ``lax.while_loop`` refuses reverse mode; its forward runs."""
    def build(sd):
        w = sd.var("w", B)
        k0 = sd.constant(np.float32(0.0), name="k0")
        out = sd.whileLoop([k0, w], lambda s, v: v[0].lt(2.0),
                           lambda s, v: [v[0] + 1.0, v[1] * 1.5])
        out[1].sum().markAsLoss()
        return [out[1].name()]
    js, ts, names = _pair(build)
    for n, (j, t) in _outs(js, ts, names, {}).items():
        np.testing.assert_allclose(t, j, atol=1e-6)
    with pytest.raises(RuntimeError, match="forward-only"):
        ts.calculateGradients({})
    with pytest.raises(Exception):
        js.calculateGradients({})


def test_region_needs_one_condition_and_matching_arity():
    sd = SameDiff.create("cpu")
    x = sd.placeholder("x")
    with pytest.raises(ValueError, match="exactly one scalar"):
        sd.whileLoop([x], lambda s, v: [v[0].sum(), v[0].sum()],
                     lambda s, v: [v[0]])
    with pytest.raises(ValueError, match="body returns"):
        sd.forLoop(2, [x], lambda s, v: [v[0], v[0]])
    with pytest.raises(ValueError, match="branches return"):
        sd.ifCond([x], lambda s, v: v[0].sum().gt(0.0),
                  lambda s, v: [v[0]], lambda s, v: [v[0], v[0]])


def test_gradcheck_float64_through_for_loop_and_if_cond():
    """The port's ``check_gradients`` (central differences in float64
    against autograd) passes through a forLoop whose body branches."""
    sd = SameDiff.create("cpu")
    out = _for_if(sd).name()
    fn = sd._build_fn((out,), compute_dtype=torch.float64)
    res = check_gradients(
        lambda p: fn({"x": p["x"], "w": p["w"]}, {}, 0)[out].sum(),
        {"x": A.astype(np.float64), "w": B.astype(np.float64)})
    assert res.passed and res.totalParams == A.size + B.size, res.failures


# ---------------------------------------------------------------------------
# execDebug, stepCostAnalysis, invokeGraphOn, namespaces
# ---------------------------------------------------------------------------
class _Recorder:
    def __init__(self):
        self.pre, self.post, self.passes = [], [], 0

    def preOpExecution(self, sd, at, op):
        self.pre.append(op.op)

    def opExecution(self, sd, at, op, outputs):
        self.post.append((op.op, [tuple(o.shape) for o in outputs]))

    def execDebugPassDone(self, sd, at):
        self.passes += 1


def test_exec_debug_fires_once_per_op_in_the_reference_order():
    js, ts, names = _pair(lambda sd: _sd_char_graph(sd, V, NC, H))
    jr, tr = _Recorder(), _Recorder()
    js.setListeners(jr)
    ts.setListeners(tr)
    jo, to = js.execDebug(FEEDS, "loss"), ts.execDebug(FEEDS, "loss")
    assert tr.pre == jr.pre and len(tr.pre) == len(set(
        n.name for n in ts._needed_nodes(("loss",))))
    assert [s for _, s in tr.post] == [s for _, s in jr.post]
    assert tr.passes == jr.passes == 1
    np.testing.assert_allclose(_np(to["loss"]),
                               np.asarray(jo["loss"].numpy()), rtol=1e-6)


def _mlp(sd):
    r = np.random.RandomState(1)
    x, lab = sd.placeholder("x"), sd.placeholder("y")
    w1 = sd.var("w1", (r.randn(12, 32) * 0.1).astype(np.float32))
    w2 = sd.var("w2", (r.randn(32, NC) * 0.1).astype(np.float32))
    b1 = sd.var("b1", np.zeros(32, np.float32))
    out = sd.math().tanh(x @ w1 + b1) @ w2
    sd.loss().softmaxCrossEntropy(lab, out, name="loss")
    return ["loss"]


def _costs(build, ds_x, ds_y):
    js, ts, _ = _pair(build)
    js.setTrainingConfig(_cfg(JTrainingConfig, jlc, SMALL["lr"]))
    ts.setTrainingConfig(_cfg(TrainingConfig, tlc, SMALL["lr"]))
    before = {k: _np(v).copy() for k, v in ts._arrays.items()}
    jc = js.stepCostAnalysis(JDataSet(ds_x, ds_y))
    tc = ts.stepCostAnalysis(DataSet(ds_x, ds_y))
    assert ts.iterationCount == 0
    for k, v in ts._arrays.items():       # the step ran on copies
        np.testing.assert_array_equal(_np(v), before[k])
    return jc, tc


def test_c29_step_cost_analysis_counts_products_at_every_iteration():
    """C29: ``stepCostAnalysis`` counts the step's matrix-product FLOPs
    (FlopCounterMode) and its bytes op by op, unfused, as it runs the step
    once on copies; XLA's analysis of the compiled step adds elementwise
    FLOPs, fuses bytes and counts a loop's body once.  On a loop-free MLP
    the port's FLOPs lie within [0.5, 1.0] of XLA's; on the char model the
    port counts all t steps of the lstmLayers (doubling t doubles its
    count) where XLA's count moves little."""
    r = np.random.RandomState(2)
    x = r.randn(16, 12).astype(np.float32)
    y = np.eye(NC, dtype=np.float32)[r.randint(0, NC, 16)]
    jc, tc = _costs(_mlp, x, y)
    assert 0.5 * jc["flops"] <= tc["flops"] <= jc["flops"]
    assert tc["bytes"] > 0 and jc["bytes"] > 0
    counts = []
    for t in (SMALL["length"], 2 * SMALL["length"]):
        c = dict(SMALL, length=t)
        xs, ys, _, _ = _sd_char_data(CHAR_TEXT[:2000], c, 3)
        counts.append(_costs(lambda sd: _sd_char_graph(sd, V, NC, H), xs,
                             ys))
    (j1, t1), (j2, t2) = counts
    assert t2["flops"] / t1["flops"] == pytest.approx(2.0, rel=0.02)
    assert j2["flops"] / j1["flops"] < 1.5
    assert t1["flops"] > j1["flops"]


def test_invoke_graph_on_copies_structure_and_arrays():
    ts = SameDiff.create("cpu")
    _sd_char_graph(ts, V, NC, H)
    other = SameDiff.create("cpu")
    ts.invokeGraphOn(other)
    other.setLossVariables("loss")
    assert torch.equal(other.output(FEEDS, "loss")["loss"],
                       ts.output(FEEDS, "loss")["loss"])
    js = JSameDiff.create()
    _sd_char_graph(js, V, NC, H)
    jother = JSameDiff.create()
    js.invokeGraphOn(jother)
    assert [n.op for n in other._ops] == [n.op for n in jother._ops]


def test_namespaces_match_the_reference():
    img = np.random.RandomState(1).rand(1, 4, 5, 3).astype(np.float32)
    m = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    ints = np.array([[5, -7, 2 ** 30, -1]], np.int32)

    def build(sd):
        i, a, k = (sd.placeholder(n) for n in ("img", "m", "k"))
        outs = [sd.image().flipLeftRight(i, name="flip"),
                sd.image().adjustBrightness(i, 0.2, name="bright"),
                sd.image().rgbToGrayscale(i, name="gray"),
                sd.linalg().logdet(a @ a.transpose() + 4.0, name="ld"),
                sd.linalg().lu(a, name="lu")[0],
                sd.bitwise().leftShiftCyclic(k, sd.constant(3), name="rl"),
                sd.bitwise().rightShiftCyclic(k, sd.constant(5), name="rr"),
                sd.bitwise().bitsHammingDistance(k, sd.constant(
                    np.int32(12345)), name="hd"),
                sd.math().cube(a, name="cube"),
                sd.nn().rationalTanh(a, name="rt"),
                sd.math().median(a, name="med")]
        return [o.name() for o in outs]
    js, ts, names = _pair(build)
    for n, (j, t) in _outs(js, ts, names,
                           {"img": img, "m": m, "k": ints}).items():
        if j.dtype.kind in "iu":
            np.testing.assert_array_equal(t, j, err_msg=n)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5,
                                       err_msg=n)


def test_rnn_namespace_lstm_cell_and_gru():
    x = np.random.RandomState(3).randn(5, 2, 3).astype(np.float32)
    w = np.random.RandomState(4).randn(7, 8).astype(np.float32) * 0.5
    wc = np.random.RandomState(5).randn(7, 4).astype(np.float32) * 0.5

    def build(sd):
        xs = sd.placeholder("x")
        h0 = sd.constant(np.zeros((2, 4), np.float32), name="h0")
        g = sd.rnn().gru(xs, h0, sd.var("Wru", w), sd.var("Wc", wc),
                         sd.var("bru", np.zeros(8, np.float32)),
                         sd.var("bc", np.zeros(4, np.float32)), name="g")
        g.sum().markAsLoss()
        return ["g"]
    js, ts, names = _pair(build)
    for n, (j, t) in _outs(js, ts, names, {"x": x}).items():
        np.testing.assert_allclose(t, j, atol=1e-6)
    jg, tg = js.calculateGradients({"x": x}), ts.calculateGradients({"x": x})
    for k in ("Wru", "Wc", "bru", "bc"):
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k].numpy()),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
