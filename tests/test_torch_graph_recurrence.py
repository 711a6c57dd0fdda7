"""Port parity: ``ComputationGraph`` recurrence — truncated BPTT over the
DAG (per-input masks included), ``rnnTimeStep`` and the stored-state API —
against the JAX package, on the cases of ``tests/test_graph_recurrence.py``.

Parameters are drawn by the JAX graph and copied into the port; inputs come
from a seeded numpy generator.  Both compute in float32 and differ by
summation order: losses of order 10 and outputs of order 1 hold to 1e-5 of
their scale, and parameters after 16 Adam steps at lr 5e-2 to 1e-4
(Adam's first steps move a parameter by ~lr whatever the size of its
gradient, so a near-zero gradient's rounding is amplified; measured
≤ 9e-7 with LSTM cells, ≤ 2.9e-5 with GRU's).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import JAX, PORT

pytestmark = pytest.mark.torch_port

TOL = dict(loss=1e-5, out=1e-5, params=1e-4)


def _char_data(seed=7, b=8, nIn=5, nOut=5, t=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nIn, t)).astype(np.float32)
    idx = rng.integers(0, nOut, (b, t))
    y = np.zeros((b, nOut, t), np.float32)
    for i in range(b):
        y[i, idx[i], np.arange(t)] = 1.0
    return x, y


def _char_graph(pkg, nIn=5, nHidden=8, nOut=5, t=20, backprop="Standard",
                tbptt=5, seed=42, hidden=None):
    """``tests/test_graph_recurrence.py``'s char-RNN graph with a merge
    vertex: the LSTM features are merged with the raw input before the
    output projection.  ``hidden`` swaps the LSTM for another RNN layer."""
    rec = pkg.rec
    layer = hidden(pkg) if hidden else rec.LSTM.builder().nOut(nHidden) \
        .build()
    gb = (pkg.conf.NeuralNetConfiguration.builder().seed(seed)
          .updater(pkg.learn.Adam(5e-2)).graphBuilder()
          .addInputs("in")
          .addLayer("lstm", layer, "in")
          .addVertex("merge", pkg.gc.MergeVertex(), "lstm", "in")
          .addLayer("out", rec.RnnOutputLayer.builder("mcxent").nOut(nOut)
                    .activation("softmax").build(), "merge")
          .setOutputs("out")
          .setInputTypes(pkg.conf.InputType.recurrent(nIn, t))
          .backpropType(backprop).tBPTTLength(tbptt))
    return gb.build()


def _graphs(conf_fn, **kw):
    """(JAX graph, port graph on the CPU) from the JAX graph's params."""
    jnet = JAX.models.ComputationGraph(conf_fn(JAX, **kw)).init()
    net = PORT.models.ComputationGraph(conf_fn(PORT, **kw), device="cpu") \
        .init(params=jax.tree.map(np.array, jnet.params_))
    return jnet, net


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy() if isinstance(port, torch.Tensor)
                               else np.asarray(port), np.asarray(ref),
                               atol=atol, rtol=0)


def _params_close(jnet, net):
    _close(net.params(), jnet.params().jax, TOL["params"])


# ---------------------------------------------------------------------------
# truncated BPTT
# ---------------------------------------------------------------------------

_HIDDEN = {"LSTM": None,
           "GravesLSTM": lambda p: p.rec.GravesLSTM(nOut=8),
           "GRU": lambda p: p.rec.GRU(nOut=8, resetAfter=True)}


@pytest.mark.parametrize("hidden", sorted(_HIDDEN))
@pytest.mark.parametrize("masked", [False, True])
def test_graph_tbptt_matches_reference(hidden, masked):
    """Four TBPTT batches of 20 steps in chunks of 5 through the merge
    vertex, with ragged feature and label masks when ``masked``: losses,
    the full-sequence score and the parameters."""
    jnet, net = _graphs(_char_graph, backprop="TruncatedBPTT", tbptt=5,
                        hidden=_HIDDEN[hidden])
    assert net.conf.toJson() == jnet.conf.toJson()
    x, y = _char_data(b=6)
    fm = None
    if masked:
        fm = np.ones((6, 20), np.float32)
        fm[:, 14:] = 0.0
        fm[1, 7:] = 0.0
    for _ in range(4):
        jnet.fit(JAX.ds.DataSet(x, y, fm, fm))
        net.fit(PORT.ds.DataSet(x, y, fm, fm))
        assert abs(net.score() - jnet.score()) <= TOL["loss"] * max(
            1.0, abs(jnet.score()))
    assert net.iterationCount == jnet.iterationCount == 4
    _params_close(jnet, net)
    full_j = jnet.score(JAX.ds.DataSet(x, y, fm, fm))
    assert abs(net.score(PORT.ds.DataSet(x, y, fm, fm)) - full_j) <= \
        TOL["loss"] * abs(full_j)


def _mln_and_graph(pkg):
    """``test_tbptt_matches_mln_path``'s pair: one LSTM stack as an MLN
    and as a graph."""
    rec = pkg.rec
    mln = (pkg.conf.NeuralNetConfiguration.builder().seed(9)
           .updater(pkg.learn.Adam(3e-2)).list()
           .layer(rec.LSTM.builder().nOut(6).build())
           .layer(rec.RnnOutputLayer.builder("mcxent").nOut(3)
                  .activation("softmax").build())
           .setInputType(pkg.conf.InputType.recurrent(4, 12))
           .backpropType("TruncatedBPTT").tBPTTLength(4).build())
    cg = (pkg.conf.NeuralNetConfiguration.builder().seed(9)
          .updater(pkg.learn.Adam(3e-2)).graphBuilder()
          .addInputs("in")
          .addLayer("lstm", rec.LSTM.builder().nOut(6).build(), "in")
          .addLayer("out", rec.RnnOutputLayer.builder("mcxent").nOut(3)
                    .activation("softmax").build(), "lstm")
          .setOutputs("out")
          .setInputTypes(pkg.conf.InputType.recurrent(4, 12))
          .backpropType("TruncatedBPTT").tBPTTLength(4).build())
    return mln, cg


def test_graph_tbptt_matches_the_mln_path():
    """One LSTM stack through the graph's and the MLN's TBPTT from the same
    parameters gives the same parameters and outputs (the reference's
    ``test_tbptt_matches_mln_path``), and both match the reference's MLN."""
    mconf, _ = _mln_and_graph(JAX)
    jmln = JAX.models.MultiLayerNetwork(mconf).init()
    p0 = jax.tree.map(np.array, jmln.params_)
    pm, pc = _mln_and_graph(PORT)
    mln = PORT.models.MultiLayerNetwork(pm, device="cpu").init(params=p0)
    cg = PORT.models.ComputationGraph(pc, device="cpu").init(
        params={"lstm": p0["0"], "out": p0["1"]})
    x, y = _char_data(b=4, nIn=4, nOut=3, t=12)
    for _ in range(3):
        jmln.fit(JAX.ds.DataSet(x, y))
        mln.fit(PORT.ds.DataSet(x, y))
        cg.fit(PORT.ds.DataSet(x, y))
    for k in ("W", "RW", "b"):
        torch.testing.assert_close(cg.params_["lstm"][k], mln.params_["0"][k],
                                   atol=1e-6, rtol=0)
    _params_close(jmln, mln)
    xp = np.random.default_rng(3).standard_normal((2, 4, 12)).astype(
        np.float32)
    torch.testing.assert_close(cg.output(xp).torch, mln.output(xp).torch,
                               atol=1e-6, rtol=0)


def _two_input_graph(pkg, rnn_out=True):
    """Two sequence inputs, each through its own LSTM; with ``rnn_out`` the
    merged sequences feed an RnnOutputLayer (for TBPTT), else each LSTM
    goes through LastTimeStep into a dense output (the reference's
    ``test_per_input_masks_route_independently``)."""
    rec = pkg.rec
    gb = (pkg.conf.NeuralNetConfiguration.builder().seed(3)
          .updater(pkg.learn.Adam(1e-2)).graphBuilder().addInputs("a", "b"))
    if rnn_out:
        gb.addLayer("la", rec.LSTM.builder().nOut(4).build(), "a")
        gb.addLayer("lb", rec.GravesLSTM.builder().nOut(4).build(), "b")
        gb.addVertex("m", pkg.gc.MergeVertex(), "la", "lb")
        gb.addLayer("out", rec.RnnOutputLayer.builder("mse").nOut(2)
                    .activation("identity").build(), "m")
    else:
        gb.addLayer("la", rec.LastTimeStep(rec.LSTM.builder().nOut(4)
                                           .build()), "a")
        gb.addLayer("lb", rec.LastTimeStep(rec.LSTM.builder().nOut(4)
                                           .build()), "b")
        gb.addVertex("m", pkg.gc.MergeVertex(), "la", "lb")
        gb.addLayer("out", pkg.layers.OutputLayer.builder("mse").nOut(2)
                    .activation("identity").build(), "m")
    gb.setOutputs("out").setInputTypes(pkg.conf.InputType.recurrent(3, 6),
                                       pkg.conf.InputType.recurrent(3, 6))
    if rnn_out:
        gb.backpropType("TruncatedBPTT").tBPTTLength(4)
    return gb.build()


def _two_inputs():
    rng = np.random.default_rng(11)
    xa, xb = (rng.standard_normal((2, 3, 6)).astype(np.float32)
              for _ in range(2))
    ma = np.ones((2, 6), np.float32)
    ma[:, 4:] = 0.0                     # input a: valid length 4
    mb = np.ones((2, 6), np.float32)    # input b: fully valid
    return xa, xb, ma, mb


def test_per_input_masks_route_independently():
    """Each input's feature mask reaches only the vertices downstream of
    that input: output against the reference, and a's masked tail does not
    move it while b's tail does."""
    jnet, net = _graphs(_two_input_graph, rnn_out=False)
    xa, xb, ma, mb = _two_inputs()
    out = net.output(xa, xb, featuresMask=(ma, mb)).torch
    _close(out, jnet.output(xa, xb, featuresMask=(ma, mb)).jax, TOL["out"])
    xa2, xb2 = xa.copy(), xb.copy()
    xa2[:, :, 4:] = 9.9
    xb2[:, :, 5:] = 9.9
    torch.testing.assert_close(
        net.output(xa2, xb, featuresMask=(ma, mb)).torch, out, atol=1e-6,
        rtol=0)
    assert not torch.allclose(
        net.output(xa, xb2, featuresMask=(ma, mb)).torch, out)


def test_two_input_tbptt_with_per_input_masks_matches_reference():
    """``_fitTbptt`` over two sequence inputs, each with its own feature
    mask, and a label mask: the chunks slice every input, label and mask;
    parameters against the reference after two batches."""
    jnet, net = _graphs(_two_input_graph)
    xa, xb, ma, mb = _two_inputs()
    y = np.random.default_rng(12).standard_normal((2, 2, 6)).astype(
        np.float32)
    for _ in range(2):
        jnet._fitTbptt((xa, xb), (y,), (ma,), (ma, mb))
        net._fitTbptt(tuple(torch.from_numpy(a) for a in (xa, xb)),
                      (torch.from_numpy(y),), (torch.from_numpy(ma),),
                      tuple(torch.from_numpy(m) for m in (ma, mb)))
    assert abs(net.score() - jnet.score()) <= TOL["loss"]
    _params_close(jnet, net)


# ---------------------------------------------------------------------------
# rnnTimeStep and the stored state
# ---------------------------------------------------------------------------

def test_graph_rnn_time_step_matches_full_forward_and_reference():
    jnet, net = _graphs(_char_graph, t=10)
    x = np.random.default_rng(4).standard_normal((3, 5, 10)).astype(
        np.float32)
    full = net.output(x).torch
    _close(full, jnet.output(x).jax, TOL["out"])
    steps = []
    for i in range(10):
        s = net.rnnTimeStep(x[:, :, i]).torch
        _close(s, jnet.rnnTimeStep(x[:, :, i]).jax, TOL["out"])
        steps.append(s)
    torch.testing.assert_close(torch.stack(steps, 2), full, atol=1e-6,
                               rtol=0)


def test_graph_chunked_generation_and_state_api():
    jnet, net = _graphs(_char_graph, t=8)
    x = np.random.default_rng(5).standard_normal((2, 5, 8)).astype(
        np.float32)
    full = net.output(x).torch
    o1 = net.rnnTimeStep(x[:, :, :5]).torch
    st = net.rnnGetPreviousState("lstm")
    assert isinstance(st, tuple) and tuple(st[0].shape) == (2, 8)
    jnet.rnnTimeStep(x[:, :, :5])
    for a, b in zip(st, jnet.rnnGetPreviousState("lstm")):
        _close(a, b, TOL["out"])
    o2 = net.rnnTimeStep(x[:, :, 5:]).torch
    torch.testing.assert_close(torch.cat([o1, o2], 2), full, atol=1e-6,
                               rtol=0)
    net.rnnClearPreviousState()
    assert net.rnnGetPreviousState("lstm") is None
    net.rnnSetPreviousState("lstm", st)
    torch.testing.assert_close(net.rnnTimeStep(x[:, :, 5:]).torch, o2,
                               atol=1e-6, rtol=0)
    a = net.rnnTimeStep(x[:, :, 0]).torch
    net.rnnClearPreviousState()
    b = net.rnnTimeStep(x[:, :, 0]).torch
    assert not torch.allclose(a, b)         # the state was carried
    torch.testing.assert_close(b, full[:, :, 0], atol=1e-6, rtol=0)


def test_graph_rnn_time_step_refuses_bidirectional():
    rec = PORT.rec
    gb = (PORT.conf.NeuralNetConfiguration.builder().seed(1)
          .updater(PORT.learn.Adam(1e-2)).graphBuilder().addInputs("in")
          .addLayer("bi", rec.Bidirectional("CONCAT", rec.LSTM.builder()
                                            .nOut(4).build()), "in")
          .addLayer("out", rec.RnnOutputLayer.builder("mse").nOut(2)
                    .activation("identity").build(), "bi")
          .setOutputs("out")
          .setInputTypes(PORT.conf.InputType.recurrent(3, 5)))
    net = PORT.models.ComputationGraph(gb.build(), device="cpu").init()
    with pytest.raises(ValueError, match="bidirectional"):
        net.rnnTimeStep(np.zeros((1, 3), np.float32))


def test_graph_json_round_trip_keeps_tbptt():
    js = _char_graph(JAX, backprop="TruncatedBPTT", tbptt=7).toJson()
    conf = PORT.gc.ComputationGraphConfiguration.fromJson(js)
    assert conf.toJson() == js
    assert conf.backpropType == "TruncatedBPTT" and conf.tbpttFwdLength == 7
