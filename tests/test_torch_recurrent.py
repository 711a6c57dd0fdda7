"""Port parity: the recurrent slice — the recurrent layers
(``nn/conf/recurrent.py``), ``MaskingLayer``, ``CharacterIterator``, and
``MultiLayerNetwork``'s carry dispatch, truncated BPTT and ``rnnTimeStep``
— against the JAX package.

Layer checks draw every parameter (GravesLSTM's zero-initialised peepholes
and GRU's ``b2`` included), the input, an initial carry and the weights of
a random linear loss from a seeded numpy RandomState, and hold the port's
forward, final carry and autograd gradients (of the params, the input and
the carry) to the reference's forward and ``jax.grad`` at nIn 5, hidden 8,
t 6, batch 4, masked and unmasked.  Both compute in float32 and differ by
summation order only: 1e-5 on values of order 1 (measured ≤ 1e-6).

The example's net (``examples/lstm_charmodelling.py``: 2 x GravesLSTM 96,
Adam 5e-3, TBPTT 25, batch 16, length 50) runs from the JAX net's copied
parameters on the same CharacterIterator batches.  Its per-batch loss sums
mcxent over 25 steps (values 60-110), and Adam moves a parameter by up to
lr per step whatever its gradient's size, so float32 rounding differences
grow along the curve: losses hold to 2e-5 relative and parameters to 1e-4
after 24 iterations (measured 2.2e-6 and 3.4e-5); the next-character
probabilities of the trained nets to 1e-5 (measured 2.3e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.characters import \
    CharacterIterator as JCharacterIterator
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu_torch.datasets import CharacterIterator
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import recurrent as trec

from _torch_parity import CHAR_TEXT, JAX, PORT, _char_conf, _conf, _np

pytestmark = pytest.mark.torch_port

NIN, HID, T, B = 5, 8, 6, 4
ATOL = 1e-5
CHAR = dict(batch=16, length=50, hidden=96, tbptt=25, iters=24,
            loss_rtol=2e-5, params_atol=1e-4, probs_atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# each recurrent layer: forward, final carry and gradients
# ---------------------------------------------------------------------------

def _bi(mode, **kw):
    return lambda m: m.Bidirectional(mode, m.LSTM(nIn=NIN, nOut=HID), **kw)


_SCANNED = {
    "SimpleRnn": lambda m: m.SimpleRnn(nIn=NIN, nOut=HID),
    "LSTM": lambda m: m.LSTM(nIn=NIN, nOut=HID),
    "LSTM-hardsigmoid-relu": lambda m: m.LSTM(
        nIn=NIN, nOut=HID, gateActivationFunction="hardsigmoid",
        activation="relu"),
    "GravesLSTM": lambda m: m.GravesLSTM(nIn=NIN, nOut=HID),
    "GRU": lambda m: m.GRU(nIn=NIN, nOut=HID),
    "GRU-resetAfter": lambda m: m.GRU(nIn=NIN, nOut=HID, resetAfter=True),
    **{f"Bidirectional-{mode}": _bi(mode)
       for mode in ("ADD", "MUL", "AVERAGE", "CONCAT")},
}
# layers reached through forward(), not scanSeq (no carry out)
_FORWARD = {
    "Bidirectional-CONCAT-last": _bi("CONCAT", returnSequences=False),
    "Bidirectional-ADD-last": _bi("ADD", returnSequences=False),
    "LastTimeStep": lambda m: m.LastTimeStep(m.GravesLSTM(nIn=NIN,
                                                          nOut=HID)),
}


def _layer_case(name, masked, seed=0):
    """(JAX layer, port layer, params, x, mask, carry) as numpy."""
    make = {**_SCANNED, **_FORWARD}[name]
    jl, tl = make(jrec), make(trec)
    rng = np.random.RandomState(seed)
    shapes = jax.tree.map(np.shape, jl.initParams(jax.random.PRNGKey(0),
                                                  None))
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32) * 0.4,
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    x = rng.randn(B, NIN, T).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[1, 4:] = 0
        mask[2, 1:] = 0
        mask[3, 2] = 0                     # an interior hole
    carry = None
    if name in _SCANNED:
        carry = jax.tree.map(lambda a: rng.randn(*a.shape).astype(
            np.float32), jl.initialCarry(B, jnp.float32))
    return jl, tl, params, x, mask, carry


def _run_jax(jl, name, params, x, mask, carry):
    if name in _SCANNED:
        return jl.scanSeq(params, x, False, None, carry, mask)
    return jl.forward(params, x, False, None, {}, mask=mask)[0], ()


def _run_port(tl, name, params, x, mask, carry):
    m = None if mask is None else _t(mask)
    if name in _SCANNED:
        return tl.scanSeq(params, x, False, None, carry, m)
    return tl.forward(params, x, False, None, {}, mask=m)[0], ()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted({**_SCANNED, **_FORWARD}))
def test_layer_forward_and_grad_match_reference(name, masked):
    jl, tl, params, x, mask, carry = _layer_case(name, masked)
    y_ref, c_ref = _run_jax(jl, name, params, x, mask, carry)
    rng = np.random.RandomState(1)
    wy = rng.randn(*y_ref.shape).astype(np.float32)
    wc = [rng.randn(*np.shape(c)).astype(np.float32)
          for c in _leaves(c_ref)]

    def jloss(p, xx, c):
        y, cf = _run_jax(jl, name, p, xx, mask, c)
        return jnp.sum(y * wy) + sum(jnp.sum(a * w)
                                     for a, w in zip(_leaves(cf), wc))

    g_ref = jax.grad(jloss, argnums=(0, 1, 2))(params, x, carry)

    tp = _tree(lambda a: _t(a).requires_grad_(), params)
    tx = _t(x).requires_grad_()
    tc = None if carry is None else _tree(
        lambda a: _t(a).requires_grad_(), carry)
    y, cf = _run_port(tl, name, tp, tx, mask, tc)
    _close(y.detach(), y_ref)
    assert len(_leaves(cf)) == len(wc)
    for a, r in zip(_leaves(cf), _leaves(c_ref)):
        _close(a.detach(), r)
    loss = torch.sum(y * _t(wy)) + sum(torch.sum(a * _t(w))
                                       for a, w in zip(_leaves(cf), wc))
    wrt = _leaves(tp) + [tx] + ([] if tc is None else _leaves(tc))
    grads = torch.autograd.grad(loss, wrt)
    want = _leaves(g_ref[0]) + [g_ref[1]] + \
        ([] if carry is None else _leaves(g_ref[2]))
    assert len(grads) == len(want)
    for g, r in zip(grads, want):
        _close(g, r)


def test_masked_steps_output_zeros_and_hold_the_carry():
    """A sequence masked after step 1 ends with the carry of step 1, and
    its outputs after it are zeros."""
    jl, tl, params, x, mask, carry = _layer_case("GravesLSTM", True)
    tp, tc = _tree(_t, params), _tree(_t, carry)
    y, (h, c) = tl.scanSeq(tp, _t(x), False, None, tc, _t(mask))
    y2, (h2, c2) = tl.scanSeq(tp, _t(x[:, :, :1]), False, None, tc, None)
    assert torch.equal(y[2, :, 1:], torch.zeros_like(y[2, :, 1:]))
    torch.testing.assert_close(h[2], h2[2])
    torch.testing.assert_close(c[2], c2[2])


def test_carry_dtype_follows_the_projected_input():
    """A float32 zero carry against float64 params: the scan runs in the
    projected input's dtype, as the reference's."""
    layer = trec.LSTM(nIn=NIN, nOut=HID)
    p = layer.initParams(torch.Generator().manual_seed(0), None,
                         torch.float64, "cpu")
    y, (h, c) = layer.scanSeq(p, torch.randn(B, NIN, T,
                                             dtype=torch.float64),
                              False, None,
                              layer.initialCarry(B, torch.float32, "cpu"))
    assert y.dtype == h.dtype == c.dtype == torch.float64


def test_init_params_keep_the_reference_layout():
    """W (nIn, 4h), RW (h, 4h), b (4h) with forget-gate bias 1, zero
    peepholes; GRU (nIn, 3h) with b2 when resetAfter; Bidirectional
    halves."""
    gen = torch.Generator().manual_seed(0)
    for make in list(_SCANNED.values()) + list(_FORWARD.values()):
        jl, tl = make(jrec), make(trec)
        want = jax.tree.map(np.shape, jl.initParams(jax.random.PRNGKey(0),
                                                    None))
        got = _tree(lambda a: tuple(a.shape),
                    tl.initParams(gen, None, device="cpu"))
        assert got == want
    p = trec.GravesLSTM(nIn=NIN, nOut=HID).initParams(gen, None,
                                                      device="cpu")
    assert torch.equal(p["b"][HID:2 * HID], torch.ones(HID))
    assert torch.equal(p["b"][:HID], torch.zeros(HID))
    assert all(torch.equal(p[k], torch.zeros(HID)) for k in ("pI", "pF",
                                                             "pO"))


# ---------------------------------------------------------------------------
# the other wrappers and MaskingLayer
# ---------------------------------------------------------------------------

def test_time_distributed_and_rnn_loss_layer_match_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(B, NIN, T).astype(np.float32)
    kw = dict(nIn=NIN, nOut=3, activation="tanh")
    jl = jrec.TimeDistributed(jlayers.DenseLayer(**kw))
    tl = trec.TimeDistributed(tlayers.DenseLayer(**kw))
    p = {"W": rng.randn(NIN, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    _close(tl.forward(_tree(_t, p), _t(x), False, None, {})[0],
           jl.forward(p, x, False, None, {})[0])
    it = JAX.conf.InputType.recurrent(NIN, T)
    assert tl.getOutputType(PORT.conf.InputType.recurrent(NIN, T)) \
        .toJson() == jl.getOutputType(it).toJson()
    mask = np.ones((B, T), np.float32)
    mask[0, 3:] = 0
    for act in ("softmax", "sigmoid", None):
        jr = jrec.RnnLossLayer(lossFunction="mse", activation=act)
        tr = trec.RnnLossLayer(lossFunction="mse", activation=act)
        _close(tr.forward({}, _t(x), False, None, {}, mask=_t(mask))[0],
               jr.forward({}, x, False, None, {}, mask=mask)[0])


def test_time_distributed_cnn_and_flatten_match_reference():
    """A convolution over each frame of an NCDHW sequence, then
    TimeDistributedFlatten to (b, h*w*c, d) in keras feature order."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4, 6, 6).astype(np.float32)     # (b, c, d, h, w)
    kw = dict(nIn=3, nOut=5, kernelSize=(3, 3), convolutionMode="Same",
              activation="relu")
    jl = jrec.TimeDistributed(jlayers.ConvolutionLayer(**kw))
    tl = trec.TimeDistributed(tlayers.ConvolutionLayer(**kw))
    p = {"W": rng.randn(5, 3, 3, 3).astype(np.float32) * 0.3,
         "b": rng.randn(5).astype(np.float32)}
    ref = jl.forward(p, x, False, None, {})[0]
    out = tl.forward(_tree(_t, p), _t(x), False, None, {})[0]
    assert tuple(out.shape) == ref.shape == (2, 5, 4, 6, 6)
    _close(out, ref)
    _close(trec.TimeDistributedFlatten().forward({}, out, False, None,
                                                 {})[0],
           jrec.TimeDistributedFlatten().forward({}, ref, False, None,
                                                 {})[0])
    it3 = JAX.conf.InputType.convolutional3D(4, 6, 6, 3)
    assert tl.getOutputType(PORT.conf.InputType.convolutional3D(
        4, 6, 6, 3)).toJson() == jl.getOutputType(it3).toJson()


def _masking_conf(pkg):
    rec = pkg.rec
    return (pkg.conf.NeuralNetConfiguration.builder().seed(4)
            .updater(pkg.learn.Adam(1e-2)).list()
            .layer(pkg.misc.MaskingLayer(maskValue=0.0))
            .layer(rec.LSTM.builder().nOut(HID).build())
            .layer(rec.LastTimeStep(rec.GRU(nOut=HID)))
            .layer(pkg.layers.OutputLayer.builder("mcxent").nOut(3).build())
            .setInputType(pkg.conf.InputType.recurrent(NIN, T)).build())


def test_masking_layer_derives_the_mask_from_the_data():
    """Steps whose features are all ``maskValue`` are masked downstream:
    the LSTM holds its carry over them and LastTimeStep takes the last
    unmasked step.  Outputs, a fit step and the padded-equals-truncated
    property, against the reference."""
    jnet = JAX.models.MultiLayerNetwork(_masking_conf(JAX)).init()
    net = PORT.models.MultiLayerNetwork(_masking_conf(PORT), device="cpu") \
        .init(params=jax.tree.map(np.array, jnet.params_))
    assert net.conf.toJson() == jnet.conf.toJson()
    rng = np.random.RandomState(5)
    x = rng.randn(B, NIN, T).astype(np.float32)
    x[0, :, 4:] = 0.0
    x[1, :, 2] = 0.0                       # an interior hole
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)]
    out = net.output(x)
    _close(out, jnet.output(x).jax)
    _close(net.output(x[:1, :, :4]), out[:1])
    jnet.fit(JAX.ds.DataSet(x, y))
    net.fit(PORT.ds.DataSet(x, y))
    assert abs(net.score() - jnet.score()) <= ATOL
    _close(net.params(), jnet.params().jax)


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------

def _json_conf(pkg):
    rec = pkg.rec
    return (pkg.conf.NeuralNetConfiguration.builder().seed(6)
            .updater(pkg.learn.RmsProp(1e-2)).l2(1e-4).list()
            .layer(rec.SimpleRnn.builder().nOut(HID).build())
            .layer(rec.GravesLSTM.builder().nOut(HID)
                   .weightInitRecurrent("ORTHOGONAL").build())
            .layer(rec.GRU.builder().nOut(HID).resetAfter(True).build())
            .layer(rec.Bidirectional("ADD", rec.LSTM(nOut=HID,
                                                     forgetGateBiasInit=0.5)))
            .layer(pkg.misc.MaskingLayer(maskValue=-1.0))
            .layer(rec.TimeDistributed(pkg.layers.DenseLayer(nOut=HID)))
            .layer(rec.RnnLossLayer(lossFunction="mse"))
            .setInputType(pkg.conf.InputType.recurrent(NIN, T))
            .backpropType("TruncatedBPTT").tBPTTLength(3).build())


def test_recurrent_config_json_is_byte_equal_both_ways():
    js = _json_conf(JAX).toJson()
    assert _json_conf(PORT).toJson() == js
    conf = PORT.conf.MultiLayerConfiguration.fromJson(js)
    assert conf.toJson() == js
    assert JAX.conf.MultiLayerConfiguration.fromJson(
        _json_conf(PORT).toJson()).toJson() == js


@pytest.mark.parametrize("name", sorted(_FORWARD) + [
    "Bidirectional-MUL", "GRU-resetAfter"])
def test_wrapper_json_round_trips_through_both_packages(name):
    make = {**_SCANNED, **_FORWARD}[name]
    js = make(jrec).toJson()
    assert make(trec).toJson() == js
    assert tlayers.layer_from_json(js).toJson() == js
    assert jlayers.layer_from_json(make(trec).toJson()).toJson() == js


def test_wrappers_delegate_hyper_params_to_the_wrapped_layer():
    inner = trec.LSTM(nOut=HID, l2=0.1, updater=PORT.learn.Sgd(0.5))
    for w in (trec.Bidirectional(inner), trec.LastTimeStep(inner),
              trec.TimeDistributed(inner)):
        assert w.l2 == 0.1 and w.updater == PORT.learn.Sgd(0.5)
        assert w.weightParamKeys() == ("W", "RW")


def _copy_in_conf(pkg):
    rec = pkg.rec
    return (pkg.conf.NeuralNetConfiguration.builder().seed(7).list()
            .layer(rec.Bidirectional("CONCAT", rec.GRU(nOut=HID,
                                                        resetAfter=True)))
            .layer(rec.GravesLSTM.builder().nOut(HID).build())
            .layer(rec.RnnOutputLayer.builder("mse").nOut(3)
                   .activation("identity").build())
            .setInputType(pkg.conf.InputType.recurrent(NIN, T)).build())


def test_copied_recurrent_params_keep_the_reference_layout():
    """``init(params=)`` takes the JAX net's nested Bidirectional halves,
    GRU's ``b2`` and GravesLSTM's peepholes unchanged: the flat vector,
    the param table's order and the output match the reference's.  The
    peepholes are set non-zero first, so they are used."""
    jnet = JAX.models.MultiLayerNetwork(_copy_in_conf(JAX)).init()
    p0 = jax.tree.map(np.array, jnet.params_)
    rng = np.random.RandomState(9)
    for k in ("pI", "pF", "pO"):
        p0["1"][k] = rng.randn(HID).astype(np.float32)
    jnet = JAX.models.MultiLayerNetwork(_copy_in_conf(JAX)).init(
        params=jax.tree.map(np.array, p0))
    net = PORT.models.MultiLayerNetwork(_copy_in_conf(PORT), device="cpu") \
        .init(params=p0)
    assert list(net.paramTable()) == list(jnet.paramTable())
    assert "0_fwd/b2" in net.paramTable() and "1_pO" in net.paramTable()
    np.testing.assert_array_equal(net.params().numpy(),
                                  np.asarray(jnet.params().jax))
    x = rng.randn(B, NIN, T).astype(np.float32)
    _close(net.output(x), jnet.output(x).jax)


# ---------------------------------------------------------------------------
# CharacterIterator
# ---------------------------------------------------------------------------

def test_character_iterator_gives_the_reference_batches():
    ji = JCharacterIterator(CHAR_TEXT, 16, 50, seed=12345)
    ti = CharacterIterator(CHAR_TEXT, 16, 50, seed=12345)
    assert ti.numCharacters() == ji.numCharacters() == ti.inputColumns()
    assert ti.idxToChar == ji.idxToChar
    for _ in range(2):
        n = 0
        while ji.hasNext():
            assert ti.hasNext()
            jd, td = ji.next(), ti.next()
            assert np.array_equal(td.features.numpy(),
                                  np.asarray(jd.features.jax))
            assert np.array_equal(td.labels.numpy(),
                                  np.asarray(jd.labels.jax))
            n += 1
        # (len - 1) // 50 = 100 examples, in batches of 16
        assert not ti.hasNext() and n == 7
        ji.reset()
        ti.reset()
    assert ti.convertIndexToCharacter(ti.convertCharacterToIndex("q")) == "q"
    other = CharacterIterator(CHAR_TEXT, 16, 50, seed=7).next()
    assert not torch.equal(other.features, ti.next().features)


# ---------------------------------------------------------------------------
# the example's net: TBPTT loss curve, parameters, rnnTimeStep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def char_runs():
    """Both packages' example nets from the JAX net's parameters, trained
    by TBPTT on the same CharacterIterator batches for CHAR["iters"]
    iterations (epochs of 7 batches).  Returns (jnet, net, iterator,
    loss curve as rows of (JAX, port), iteration counts)."""
    ji = JCharacterIterator(CHAR_TEXT, CHAR["batch"], CHAR["length"],
                            seed=12345)
    ti = CharacterIterator(CHAR_TEXT, CHAR["batch"], CHAR["length"],
                           seed=12345)
    n = ti.inputColumns()
    kw = dict(hidden=CHAR["hidden"], tbptt=CHAR["tbptt"])
    jnet = JAX.models.MultiLayerNetwork(_char_conf(JAX, n, **kw)).init()
    net = PORT.models.MultiLayerNetwork(_char_conf(PORT, n, **kw),
                                        device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    curve, counts = [], []
    while len(curve) < CHAR["iters"]:
        ji.reset()
        ti.reset()
        while ji.hasNext() and len(curve) < CHAR["iters"]:
            jnet.fit(ji.next())
            net.fit(ti.next())
            curve.append((jnet.score(), net.score()))
            counts.append((jnet.getIterationCount(),
                           net.getIterationCount()))
    return jnet, net, ti, np.array(curve), counts


def test_char_rnn_config_json_matches_reference():
    n = CharacterIterator(CHAR_TEXT, 16, 50).inputColumns()
    assert _char_conf(PORT, n).toJson() == _char_conf(JAX, n).toJson()


def test_char_rnn_tbptt_loss_curve_and_params_match_reference(char_runs):
    jnet, net, _, curve, counts = char_runs
    assert len(curve) == CHAR["iters"] >= 20
    np.testing.assert_allclose(curve[:, 1], curve[:, 0],
                               rtol=CHAR["loss_rtol"], atol=0)
    assert curve[-1, 1] < 0.75 * curve[0, 1]          # it learns
    # one iteration per batch (2 chunks each), as the reference counts
    assert counts == [(i, i) for i in range(1, CHAR["iters"] + 1)]
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jnet.params().jax),
                               atol=CHAR["params_atol"], rtol=0)


def test_char_rnn_time_step_probabilities_match_reference(char_runs):
    """The example's sampling loop fed a fixed string one character at a
    time: the next-character distributions match, and stepping equals the
    full-sequence output."""
    jnet, net, it, _, _ = char_runs
    text = "the question whether tis nobler"
    idx = [it.convertCharacterToIndex(c) for c in text]
    n = it.inputColumns()
    x = np.zeros((1, n, len(idx)), np.float32)
    x[0, idx, np.arange(len(idx))] = 1.0
    jnet.rnnClearPreviousState()
    net.rnnClearPreviousState()
    steps = []
    for k in range(len(idx)):
        p = net.rnnTimeStep(x[:, :, k])
        _close(p, jnet.rnnTimeStep(x[:, :, k]).jax, CHAR["probs_atol"])
        assert tuple(p.shape) == (1, n)
        steps.append(p)
    torch.testing.assert_close(torch.stack(steps, dim=2), net.output(x),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(steps[-1].sum(), torch.tensor(1.0))


# ---------------------------------------------------------------------------
# the reference's traps, one test each
# ---------------------------------------------------------------------------

def _tiny_char(pkg, dataType="FLOAT"):
    """The example's net at hidden 6 over 5 characters, TBPTT 4."""
    return _char_conf(pkg, NIN, hidden=6, tbptt=4, dataType=dataType)


def _onehot_batch(t_len, seed=8, b=3):
    rng = np.random.RandomState(seed)
    eye = np.eye(NIN, dtype=np.float32)
    x = eye[rng.randint(0, NIN, (b, t_len))].transpose(0, 2, 1)
    y = eye[rng.randint(0, NIN, (b, t_len))].transpose(0, 2, 1)
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def test_iteration_counts_batches_not_chunks(monkeypatch):
    """Every TBPTT chunk of one batch steps Adam with the same iteration
    (the reference increments once per batch, after all its chunks)."""
    net = PORT.models.MultiLayerNetwork(_tiny_char(PORT), device="cpu") \
        .init()
    seen = []
    apply = PORT.learn.Adam.apply

    def spy(self, grad, state, lr, iteration, *a, **kw):
        seen.append(iteration)
        return apply(self, grad, state, lr, iteration, *a, **kw)

    monkeypatch.setattr(PORT.learn.Adam, "apply", spy)
    x, y = _onehot_batch(10)
    net.fit(x, y)
    net.fit(x, y)
    leaves = len(list(net._leaf_items()))
    # 10 steps in chunks of 4: 3 chunks a batch, each over every leaf
    assert seen == [0] * 3 * leaves + [1] * 3 * leaves
    assert net.getIterationCount() == 2


def test_carries_cross_chunk_borders_detached():
    """The carries handed to the next chunk carry no graph: the backward
    of a chunk stops at its start, as the reference truncates it."""
    net = PORT.models.MultiLayerNetwork(_tiny_char(PORT), device="cpu") \
        .init()
    x, y = _onehot_batch(4)
    carries = net._runTrainStep(_t(x), _t(y), None, None,
                                net._zeroCarries(3))
    assert sorted(carries) == ["0", "1"]
    for c in _leaves(carries):
        assert c.grad_fn is None and not c.requires_grad
        assert tuple(c.shape) == (3, 6) and bool(c.abs().sum() > 0)


def test_tbptt_matches_reference_from_nonzero_chunk_carries():
    """Two batches of 10 steps in chunks of 4 (the last chunk shorter):
    losses and parameters against the reference, whose chunks pass
    concrete (truncated) carries."""
    jnet = JAX.models.MultiLayerNetwork(_tiny_char(JAX)).init()
    net = PORT.models.MultiLayerNetwork(_tiny_char(PORT), device="cpu") \
        .init(params=jax.tree.map(np.array, jnet.params_))
    for seed in (8, 9):
        x, y = _onehot_batch(10, seed)
        jnet.fit(JAX.ds.DataSet(x, y))
        net.fit(PORT.ds.DataSet(x, y))
        assert abs(net.score() - jnet.score()) <= ATOL
    _close(net.params(), jnet.params().jax)


@pytest.mark.parametrize("t_len,rank,chunks", [
    (10, 3, 3),     # t > tbpttFwdLength: ceil(10 / 4) chunks
    (4, 3, 1),      # t == tbpttFwdLength: standard backpropagation
    (3, 3, 1),
    (10, 2, 1),     # rank-2 labels: standard backpropagation
])
def test_tbptt_runs_only_for_rank3_data_longer_than_the_forward_length(
        monkeypatch, t_len, rank, chunks):
    conf = _tiny_char(PORT)
    if rank == 2:
        conf = (PORT.conf.NeuralNetConfiguration.builder().seed(1).list()
                .layer(PORT.rec.LastTimeStep(PORT.rec.GravesLSTM(
                    nIn=NIN, nOut=6)))
                .layer(PORT.layers.OutputLayer.builder("mcxent").nIn(6)
                       .nOut(NIN).build())
                .backpropType("TruncatedBPTT").tBPTTForwardLength(4)
                .tBPTTBackwardLength(2).build())
    net = PORT.models.MultiLayerNetwork(conf, device="cpu").init()
    calls = []
    run = net._runTrainStep

    def spy(x, *a, **kw):
        calls.append(int(x.shape[2]))
        return run(x, *a, **kw)

    monkeypatch.setattr(net, "_runTrainStep", spy)
    x, y = _onehot_batch(t_len)
    net.fit(x, y if rank == 3 else y[:, :, -1])
    assert len(calls) == chunks and sum(calls) == t_len
    assert net.getIterationCount() == 1


def test_zero_carries_are_explicit_zeros_or_none():
    net = PORT.models.MultiLayerNetwork(_tiny_char(PORT), device="cpu") \
        .init()
    z = net._zeroCarries(3)
    assert sorted(z) == ["0", "1"]
    assert all(torch.equal(c, torch.zeros(3, 6)) for c in _leaves(z))
    dense = PORT.models.MultiLayerNetwork(_conf(PORT), device="cpu")
    assert dense._zeroCarries(3) is None


def test_bf16_tbptt_carries_pass_through_the_compute_cast():
    """Under BFLOAT16 compute the chunk carries are bf16 activations; the
    loss stays float32 and follows the reference's bf16 run within bf16
    noise: the two round at other points, so the last chunk's loss of ~3
    holds to 5e-3, a third of one bf16 ulp at 3 (measured 6.3e-4)."""
    jnet = JAX.models.MultiLayerNetwork(_tiny_char(JAX, dataType="BFLOAT16"))
    jnet.init()
    net = PORT.models.MultiLayerNetwork(
        _tiny_char(PORT, dataType="BFLOAT16"), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    x, y = _onehot_batch(10)
    carries = net._runTrainStep(_t(x[:, :, :4]), _t(y[:, :, :4]), None,
                                None, net._zeroCarries(3))
    assert {c.dtype for c in _leaves(carries)} == {torch.bfloat16}
    net2 = PORT.models.MultiLayerNetwork(
        _tiny_char(PORT, dataType="BFLOAT16"), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    jnet.fit(JAX.ds.DataSet(x, y))
    net2.fit(PORT.ds.DataSet(x, y))
    assert abs(net2.score() - jnet.score()) <= 5e-3
    assert {v.dtype for v in net2.params_["0"].values()} == {torch.float32}


def test_rnn_time_step_state_api_and_predict():
    """Stepping equals the full output; 3-D chunks continue the state;
    get/set/clear; predict takes the argmax over the class axis."""
    net = PORT.models.MultiLayerNetwork(_tiny_char(PORT), device="cpu") \
        .init()
    x, _ = _onehot_batch(7)
    full = net.output(x)
    steps = torch.stack([net.rnnTimeStep(x[:, :, k]) for k in range(7)], 2)
    torch.testing.assert_close(steps, full, atol=1e-6, rtol=0)
    net.rnnClearPreviousState()
    assert net.rnnGetPreviousState(0) is None
    a = net.rnnTimeStep(x[:, :, :4])
    st = net.rnnGetPreviousState(1)
    b = net.rnnTimeStep(x[:, :, 4:])
    torch.testing.assert_close(torch.cat([a, b], 2), full, atol=1e-6,
                               rtol=0)
    net.rnnClearPreviousState()
    net.rnnTimeStep(x[:, :, :4])
    net.rnnSetPreviousState(1, tuple(torch.zeros_like(c) for c in st))
    assert torch.equal(net.rnnGetPreviousState(1)[0], torch.zeros(3, 6))
    pred = net.predict(x)
    assert pred.shape == (3, 7)
    assert np.array_equal(pred, full.argmax(dim=1).numpy())


def test_rnn_time_step_refuses_a_bidirectional_net():
    conf = (PORT.conf.NeuralNetConfiguration.builder().list()
            .layer(PORT.rec.Bidirectional(PORT.rec.LSTM(nIn=NIN, nOut=4)))
            .layer(PORT.rec.RnnOutputLayer.builder("mse").nOut(2)
                   .activation("identity").build())
            .setInputType(PORT.conf.InputType.recurrent(NIN, T)).build())
    net = PORT.models.MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="bidirectional"):
        net.rnnTimeStep(np.zeros((1, NIN), np.float32))


def test_recurrent_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.models.MultiLayerNetwork(_tiny_char(PORT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trec.GravesLSTM(nIn=2, nOut=2).initParams(torch.Generator(), None)
