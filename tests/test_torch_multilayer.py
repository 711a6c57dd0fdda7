"""Port parity: the training slice — the config DSL, ``MultiLayerNetwork``
(``init(params=)``, ``output``, ``score``, ``fit``, the flat param views),
the updaters, activations, losses, weight init, input types,
preprocessors and the DataSet iterators — against the JAX package.

The slice's model is ``bench.py``'s ``bench_long_context`` net (two
``SelfAttentionLayer`` and an ``RnnOutputLayer("mse", identity)``, Adam,
seed 5) at small widths: nIn 16, 2 heads of 8, nOut 4, t 32, batch 3.
Parameters are drawn by the JAX net and copied into the port
(``init(params=)``): the two RNGs never agree.  Features, labels and
gradients come from a seeded numpy RandomState.

Tolerances, each from what the check shows:

- FLOAT: both nets compute in float32 (the reference's outputs, params and
  scores are float32 — checked below), so values of order 1 agree to
  float32 summation order: outputs (up to ~2) to 2e-6 and scores of ~4 to
  1e-5 (measured 1.2e-6 and 2e-6).  Adam divides by sqrt(v) + eps, so a near-zero gradient
  component's rounding difference grows by up to lr / (eps / sqrt(1 -
  beta2)) ~ 3e3 in the update: params hold to 1e-5 (measured 1.1e-6 after
  4 steps);
- BFLOAT16: both compute in bf16 over f32 masters, but round inside the
  matmuls and the softmax at other points, so scores agree to 5e-3 (about
  1e-3 relative; measured 1.1e-3).  A gradient component within bf16 noise
  of zero can change sign, and Adam's first steps move a parameter by
  ~lr whatever the gradient's size: one element may differ by up to
  2·lr per step (measured 2.0e-3 after 5 steps), while 99 % of the
  parameters agree to 1e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.models as tmodels
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.nn.conf.attention as tatt
from deeplearning4j_tpu.models import multilayer as jmm
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import lossfunctions as jloss
from deeplearning4j_tpu.nn.conf import attention as jatt
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu_torch.models import multilayer as tmm
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import lossfunctions as tloss
from deeplearning4j_tpu_torch.nn import weights as tw
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre

from _torch_parity import (B, HEAD, HEADS, JAX, LR, NIN, NOUT, PORT, T,
                           _conf, _fit_both, _nets)

pytestmark = pytest.mark.torch_port

F32 = dict(out=2e-6, params=1e-5, score=1e-5)
BF16 = dict(score=5e-3, params_bulk=1e-4, bulk_share=0.99)


# ---------------------------------------------------------------------------
# the parity helper: one config, both packages, copied params
# (tests/_torch_parity.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params0():
    """The JAX net's initial params (numpy), drawn once: the draw is the
    same for every dataType (params are drawn in float32)."""
    jnet = JAX.models.MultiLayerNetwork(_conf(JAX)).init()
    return jax.tree.map(np.array, jnet.params_)


def _port_net(params0, dataType="FLOAT"):
    return PORT.models.MultiLayerNetwork(_conf(PORT, dataType),
                                         device="cpu").init(params=params0)


def _batches(n=2, seed=1, t=T):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, NIN, t).astype(np.float32),
             rng.randn(B, NOUT, t).astype(np.float32)) for _ in range(n)]


def _flat(jnet, net):
    return np.asarray(jnet.params().jax), net.params().numpy()


# ---------------------------------------------------------------------------
# configuration DSL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataType", ["FLOAT", "BFLOAT16"])
def test_config_json_matches_reference(dataType):
    assert _conf(PORT, dataType).toJson() == _conf(JAX, dataType).toJson()


def test_reference_json_builds_the_port_config():
    js = _conf(JAX, "BFLOAT16").toJson()
    conf = PORT.conf.MultiLayerConfiguration.fromJson(js)
    assert conf.toJson() == js
    assert [type(l).__name__ for l in conf.layers] == [
        "SelfAttentionLayer", "SelfAttentionLayer", "RnnOutputLayer"]
    assert isinstance(conf.globalConf["updater"], tlearn.Adam)


def _dense_conf(pkg):
    """Dense layers into an RNN output layer: FF -> RNN preprocessor, and
    every per-layer option the updater step reads."""
    L = pkg.layers
    return (pkg.conf.NeuralNetConfiguration.builder().seed(7)
            .updater(pkg.learn.Sgd(0.1)).l2(1e-3).weightDecay(1e-2)
            .activation("tanh").list()
            .layer(L.DenseLayer.builder().nOut(6).l1(1e-3)
                   .gradientNormalization("ClipL2PerLayer")
                   .gradientNormalizationThreshold(0.5).build())
            .layer(pkg.rec.RnnOutputLayer.builder("mse").nOut(3)
                   .biasUpdater(pkg.learn.NoOp()).build())
            .setInputType(pkg.conf.InputType.feedForward(5)).build())


def test_dense_config_json_matches_reference():
    js = _dense_conf(JAX).toJson()
    assert _dense_conf(PORT).toJson() == js
    assert json.loads(js)["preProcessors"]["1"]["@class"] == \
        "FeedForwardToRnnPreProcessor"
    assert PORT.conf.MultiLayerConfiguration.fromJson(js).toJson() == js


def test_unported_pieces_raise_naming_their_roadmap_item():
    """What is still unported raises naming its ROADMAP item (GPipe stages:
    A10); A3's updaters and schedules, A4's embedding and autoencoder
    layers, A6's vertices and A12b's SameDiff layers, which this test once
    refused, now build from the reference's JSON."""
    with pytest.raises(NotImplementedError, match="A10"):
        PORT.conf.NeuralNetConfiguration.builder().list().pipelineStages(2)
    assert type(tlayers.layer_from_json(
        {"@class": "PixelShuffleLayer", "blockSize": 2})).__name__ == \
        "PixelShuffleLayer"
    assert type(tlayers.layer_from_json(
        {"@class": "AutoEncoder", "nIn": 3, "nOut": 2})).__name__ == \
        "AutoEncoder"
    assert type(tlayers.layer_from_json(
        {"@class": "EmbeddingLayer", "nIn": 3, "nOut": 2})).__name__ == \
        "EmbeddingLayer"
    rms = jlearn.RmsProp(0.1)
    assert tlearn.IUpdater.fromJson(rms.toJson()).toJson() == rms.toJson()
    adam = jlearn.Adam(learningRateSchedule=jlearn.ExponentialSchedule(
        "ITERATION", 0.1, 0.9))
    assert tlearn.IUpdater.fromJson(adam.toJson()).toJson() == adam.toJson()
    from deeplearning4j_tpu_torch.models.graph_conf import vertex_from_json
    assert type(vertex_from_json({"@class": "StackVertex"})).__name__ == \
        "StackVertex"


# ---------------------------------------------------------------------------
# MultiLayerNetwork: init(params=), output, score, flat params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataType", ["FLOAT", "BFLOAT16"])
def test_output_and_score_match_reference(params0, dataType):
    """The tolerances assume float32 outputs and masters on both sides:
    the JAX package turns on x64, so check that nothing leaks float64."""
    jnet, net = _nets(params0, dataType)
    f, l = _batches(1)[0]
    out = net.output(f)
    assert tuple(out.shape) == (B, NOUT, T) and out.torch.dtype == torch.float32
    assert np.asarray(jnet.output(f).jax).dtype == np.float32
    assert {np.asarray(v).dtype for lp in jnet.params_.values()
            for v in lp.values()} == {np.dtype(np.float32)}
    tol = F32["out"] if dataType == "FLOAT" else 2e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(f).jax),
                               atol=tol, rtol=0)
    stol = F32["score"] if dataType == "FLOAT" else BF16["score"]
    assert abs(net.score(PORT.ds.DataSet(f, l)) -
               jnet.score(JAX.ds.DataSet(f, l))) <= stol


def test_params_match_reference_in_flat_order(params0):
    jnet, net = _nets(params0)
    jp, tp = _flat(jnet, net)
    np.testing.assert_array_equal(tp, jp)
    assert net.numParams() == jnet.numParams() == tp.size
    assert list(net.paramTable()) == list(jnet.paramTable())
    assert list(net.paramTable())[:4] == ["0_Wk", "0_Wo", "0_Wq", "0_Wv"]
    assert list(net.paramTable())[-2:] == ["2_W", "2_b"]


def test_set_params_round_trips(params0):
    net = _port_net(params0)
    flat = net.params().torch
    net.setParams(torch.arange(flat.numel(), dtype=torch.float32))
    table = net.paramTable()
    assert table["0_Wk"].torch.flatten()[:3].tolist() == [0.0, 1.0, 2.0]
    assert float(table["2_b"][-1]) == flat.numel() - 1
    assert table["0_Wo"].shape == (HEADS * HEAD, NIN)
    net.setParams(flat)
    assert torch.equal(net.params().torch, flat)
    with pytest.raises(ValueError, match="length"):
        net.setParams(torch.zeros(flat.numel() + 1))


def test_seeded_init_draws_the_reference_distributions():
    """The port draws its own numbers (another RNG) from the same
    distributions: XAVIER weights of std sqrt(2/(fanIn+fanOut)), zero
    bias; the same seed gives the same params."""
    conf = _conf(PORT)
    a = tmodels.MultiLayerNetwork(conf, device="cpu").init()
    b = tmodels.MultiLayerNetwork(_conf(PORT), device="cpu").init()
    assert torch.equal(a.params().torch, b.params().torch)
    assert a.params_["0"]["Wq"].shape == (NIN, HEADS * HEAD)
    assert torch.equal(a.params_["2"]["b"], torch.zeros(NOUT))
    assert a.numParams() == tmodels.MultiLayerNetwork(
        _conf(PORT), device="cpu").init().numParams()


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def test_fit_matches_reference_float(params0):
    """Loss curve and params after 1 and after 5 steps."""
    jnet, net = _nets(params0)
    batches = _batches()
    for done, steps in ((0, 1), (1, 5)):
        curve = _fit_both(jnet, net, batches[done:] + batches[:done],
                          steps - done)
        np.testing.assert_allclose(curve[:, 1], curve[:, 0],
                                   atol=F32["score"], rtol=0)
        np.testing.assert_allclose(*_flat(jnet, net)[::-1],
                                   atol=F32["params"], rtol=0,
                                   err_msg=f"after {steps} steps")
        assert net.getIterationCount() == jnet.getIterationCount() == steps


def test_fit_matches_reference_bf16(params0):
    """Loss curve and params after 1 and after 5 steps."""
    jnet, net = _nets(params0, "BFLOAT16")
    batches = _batches()
    for done, steps in ((0, 1), (1, 5)):
        curve = _fit_both(jnet, net, batches[done:] + batches[:done],
                          steps - done)
        np.testing.assert_allclose(curve[:, 1], curve[:, 0],
                                   atol=BF16["score"], rtol=0)
        jp, tp = _flat(jnet, net)
        diff = np.abs(tp - jp)
        assert diff.max() <= 2 * LR * steps, f"after {steps} steps"
        assert np.mean(diff <= BF16["params_bulk"]) >= BF16["bulk_share"]
    # masters stay float32 under bf16 compute
    assert {v.dtype for lp in net.params_.values() for v in lp.values()} \
        == {torch.float32}


def test_fit_through_the_flash_route_matches_reference(params0,
                                                       monkeypatch):
    """The port's attention forced onto ``impl="flash"`` (on the CPU: the
    kernels' plain versions through ``FlashAttention``) trains as the
    reference's dense attention does."""
    dpa = tatt.dot_product_attention
    monkeypatch.setattr(tatt, "dot_product_attention",
                        lambda *a, **kw: dpa(*a, **{**kw, "impl": "flash"}))
    jnet, net = _nets(params0)
    curve = _fit_both(jnet, net, _batches(), 3)
    np.testing.assert_allclose(curve[:, 1], curve[:, 0], atol=F32["score"],
                               rtol=0)
    np.testing.assert_allclose(*_flat(jnet, net)[::-1], atol=F32["params"],
                               rtol=0)


def test_fit_iterator_two_epochs_equals_batches_in_turn(params0):
    batches = _batches(2, seed=3)
    jnet, net = _nets(params0)
    net2 = _port_net(params0)
    net.fit(PORT.ds.ListDataSetIterator(
        [PORT.ds.DataSet(f, l) for f, l in batches]), epochs=2)
    for _ in range(2):
        for f, l in batches:
            net2.fit(f, l)
    assert torch.equal(net.params().torch, net2.params().torch)
    assert net.score() == net2.score()
    assert (net.getIterationCount(), net.getEpochCount()) == (4, 2)
    assert (net2.getIterationCount(), net2.getEpochCount()) == (4, 0)
    jnet.fit(JAX.ds.ListDataSetIterator(
        [JAX.ds.DataSet(f, l) for f, l in batches]), epochs=2)
    np.testing.assert_allclose(*_flat(jnet, net)[::-1], atol=F32["params"],
                               rtol=0)
    assert abs(net.score() - jnet.score()) <= F32["score"]


def test_fit_with_regularization_matches_reference():
    """l1, l2, weight decay, per-layer gradient clipping, a bias updater
    and a FF -> RNN preprocessor through two steps."""
    jnet = JAX.models.MultiLayerNetwork(_dense_conf(JAX)).init()
    net = PORT.models.MultiLayerNetwork(_dense_conf(PORT), device="cpu") \
        .init(params=jax.tree.map(np.asarray, jnet.params_))
    rng = np.random.RandomState(4)
    for _ in range(2):
        # the reference's FF -> RNN preprocessor takes the batch as the
        # mini-batch, so (b, n) features make (b, nOut, 1) outputs
        f = rng.randn(6, 5).astype(np.float32)
        l = rng.randn(6, 3, 1).astype(np.float32)
        jnet.fit(JAX.ds.DataSet(f, l))
        net.fit(PORT.ds.DataSet(f, l))
        assert abs(net.score() - jnet.score()) <= F32["score"]
    np.testing.assert_allclose(*_flat(jnet, net)[::-1], atol=F32["params"],
                               rtol=0)


def test_masks_flow_to_the_layers_and_the_loss(params0):
    jnet, net = _nets(params0)
    f, l = _batches(1)[0]
    fm = np.ones((B, T), np.float32)
    fm[1, 20:] = 0
    lm = fm.copy()
    for _ in range(2):
        jnet.fit(JAX.ds.DataSet(f, l, fm, lm))
        net.fit(PORT.ds.DataSet(f, l, fm, lm))
        assert abs(net.score() - jnet.score()) <= F32["score"]
    np.testing.assert_allclose(net.output(f, featuresMask=fm).numpy(),
                               np.asarray(jnet.output(f, featuresMask=fm)
                                          .jax), atol=F32["out"], rtol=0)


def test_unported_training_modes_raise(params0):
    """The training modes this test once refused now run.  The line-search
    solvers (ROADMAP A9) make one line-searched iteration per ``fit``
    (held to the reference in ``tests/test_torch_solvers.py``).  Truncated
    BPTT runs on a net without RNN layers as the reference runs it: chunk
    by chunk, one iteration per batch."""
    f, l = _batches(1)[0]
    conf = _conf(PORT)
    conf.globalConf["optimizationAlgo"] = "LBFGS"
    lbfgs = tmodels.MultiLayerNetwork(conf, device="cpu")
    lbfgs.fit(f, l)
    assert lbfgs.getIterationCount() == 1 and np.isfinite(lbfgs.score())
    jnet, net = _nets(params0)
    for n in (jnet, net):
        n.conf.backpropType, n.conf.tbpttFwdLength = "TruncatedBPTT", 8
    curve = _fit_both(jnet, net, [(f, l)], 2)
    np.testing.assert_allclose(curve[:, 1], curve[:, 0], atol=F32["score"],
                               rtol=0)
    np.testing.assert_allclose(*_flat(jnet, net)[::-1], atol=F32["params"],
                               rtol=0)
    assert net.getIterationCount() == jnet.getIterationCount() == 2


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.MultiLayerNetwork(_conf(PORT))
    layer = tatt.SelfAttentionLayer(nIn=4, nHeads=1, headSize=4, nOut=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layer.initParams(torch.Generator(), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlayers.DenseLayer(nIn=2, nOut=2).initParams(torch.Generator(), None)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_self_attention_forward_matches_reference(causal, masked):
    rng = np.random.RandomState(5)
    kw = dict(nIn=NIN, nHeads=HEADS, headSize=HEAD, nOut=6, causal=causal)
    jl, tl = jatt.SelfAttentionLayer(**kw), tatt.SelfAttentionLayer(**kw)
    params = {k: rng.randn(*s).astype(np.float32) * 0.3
              for k, s in (("Wq", (NIN, 16)), ("Wk", (NIN, 16)),
                           ("Wv", (NIN, 16)), ("Wo", (16, 6)))}
    x = rng.randn(2, NIN, 24).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 24), np.float32)
        mask[0, 17:] = 0
    ref, _ = jl.forward(params, x, False, None, {}, mask=mask)
    out, _ = tl.forward({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), False, None, {},
                        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32["out"],
                               rtol=0)


def test_input_dropout_keeps_the_retain_probability():
    layer = tlayers.DenseLayer(nIn=2, nOut=2, dropOut=0.8)
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = layer._dropin(x, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert torch.equal(layer._dropin(x, False, gen), x)


# ---------------------------------------------------------------------------
# updaters, gradient normalization, the update step
# ---------------------------------------------------------------------------

_UPDATERS = {"sgd": lambda m: m.Sgd(0.05), "noop": lambda m: m.NoOp(),
             "adam": lambda m: m.Adam(1e-2, beta1=0.8, beta2=0.99),
             "nesterovs": lambda m: m.Nesterovs(0.1, momentum=0.85)}


@pytest.mark.parametrize("name", sorted(_UPDATERS))
@pytest.mark.parametrize("steps", [1, 7])
def test_updater_matches_reference(name, steps):
    rng = np.random.RandomState(6)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(steps)]
    ju, tu = _UPDATERS[name](jlearn), _UPDATERS[name](tlearn)
    p0 = rng.randn(5, 3).astype(np.float32)
    js, ts = ju.init(jnp.asarray(p0)), tu.init(torch.from_numpy(p0))
    for i, g in enumerate(grads):
        jup, js = ju.apply(jnp.asarray(g), js, ju.currentLr(i, 0), i)
        tup, ts = tu.apply(torch.from_numpy(g), ts, tu.currentLr(i, 0), i)
        np.testing.assert_allclose(tup.numpy(), np.asarray(jup), atol=1e-7,
                                   rtol=1e-6)
    assert sorted(ts) == sorted(js)
    assert tu.stateSize(15) == ju.stateSize(15)


@pytest.mark.parametrize("name", sorted(_UPDATERS))
def test_updater_json_matches_reference(name):
    ju, tu = _UPDATERS[name](jlearn), _UPDATERS[name](tlearn)
    assert tu.toJson() == ju.toJson()
    assert tlearn.IUpdater.fromJson(ju.toJson()) == tu


@pytest.mark.parametrize("mode", [
    None, "None", "RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
    "ClipElementWiseAbsoluteValue", "ClipL2PerLayer", "ClipL2PerParamType"])
def test_gradient_normalization_matches_reference(mode):
    rng = np.random.RandomState(7)
    g = {"W": rng.randn(4, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    layer = tlayers.DenseLayer(gradientNormalization=mode,
                               gradientNormalizationThreshold=0.7)
    ref = jmm._grad_normalize(layer, {k: jnp.asarray(v)
                                      for k, v in g.items()})
    out = tmm._grad_normalize(layer, {k: torch.from_numpy(v)
                                      for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, rtol=1e-6)


def test_apply_updates_matches_reference():
    """Per-leaf updaters, the bias updater and weight decay on weights
    only, over one layer's params."""
    rng = np.random.RandomState(8)
    p = {"W": rng.randn(4, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    out = {}
    for pkg, mm, arr in ((JAX, jmm, jnp.asarray), (PORT, tmm,
                                                   torch.from_numpy)):
        layer = pkg.layers.DenseLayer(updater=pkg.learn.Adam(1e-2),
                                      biasUpdater=pkg.learn.Sgd(0.1),
                                      weightDecay=0.05)
        params = {"0": {k: arr(v) for k, v in p.items()}}
        grads = {"0": {k: arr(v) for k, v in g.items()}}
        opt = {"0": {"W": layer.updater.init(params["0"]["W"]), "b": {}}}
        out[pkg is PORT] = mm._apply_updates([("0", layer)], {}, params,
                                             grads, opt, 0, 0)[0]["0"]
    for k in p:
        np.testing.assert_allclose(np.asarray(out[True][k]),
                                   np.asarray(out[False][k]), atol=1e-7,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# activations, losses, weight init
# ---------------------------------------------------------------------------

_ACTS = sorted(jact._REGISTRY) + ["thresholdedrelu:0.5", "leakyrelu:0.2",
                                  "elu:0.7", "softmax:1", "clippedrelu:2"]


@pytest.mark.parametrize("name", _ACTS)
def test_activation_matches_reference(name):
    x = np.random.RandomState(9).randn(3, 5, 4).astype(np.float32) * 3
    ref = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    out = tact.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_activation_tables_agree():
    assert sorted(tact._REGISTRY) == sorted(jact._REGISTRY)
    assert sorted(tact._PARAMETERIZED) == sorted(jact._PARAMETERIZED)
    with pytest.raises(ValueError, match="Unknown activation"):
        tact.get_activation("nope")


def _loss_inputs(name, shape, seed=10):
    rng = np.random.RandomState(seed)
    if name == "sparse_mcxent":
        out = rng.rand(*shape).astype(np.float32)
        out /= out.sum(-1, keepdims=True)
        return rng.randint(0, shape[-1], shape[:-1]).astype(np.float32), out
    labels = rng.rand(*shape).astype(np.float32)
    out = rng.rand(*shape).astype(np.float32) * 0.9 + 0.05
    if name in ("hinge", "squared_hinge"):
        labels = np.sign(labels - 0.5).astype(np.float32)
    return labels, out


@pytest.mark.parametrize("name", sorted(jloss._REGISTRY))
@pytest.mark.parametrize("rnn", [False, True])
def test_loss_matches_reference(name, rnn):
    shape = (4, 3, 6) if rnn else (4, 5)
    labels, out = _loss_inputs(name, shape)
    mask = None
    # the reference takes a per-step mask only where it reduces through
    # _reduce (cosine reduces over the last axis first, sparse has no n)
    if rnn and name not in ("sparse_mcxent", "cosine_proximity"):
        mask = np.ones((4, 6), np.float32)
        mask[0, 4:] = 0
    ref = np.asarray(jloss.get_loss(name)(jnp.asarray(labels),
                                          jnp.asarray(out), mask))
    got = tloss.get_loss(name)(
        torch.from_numpy(labels), torch.from_numpy(out),
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (4,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_loss_tables_agree():
    assert sorted(tloss._REGISTRY) == sorted(jloss._REGISTRY)


def test_mse_divides_by_the_time_length():
    """The reference's ``_mse`` divides by labels.shape[-1]: on (b, n, t)
    that is t, not n (ROADMAP queue C).  The port keeps it."""
    labels = torch.zeros(1, 2, 10)
    out = torch.ones(1, 2, 10)
    assert float(tloss.get_loss("mse")(labels, out)[0]) == pytest.approx(
        2.0)     # 20 elements of 1, divided by t = 10
    assert float(jloss.get_loss("mse")(jnp.zeros((1, 2, 10)),
                                       jnp.ones((1, 2, 10)))[0]) == \
        pytest.approx(2.0)


_STD = {"NORMAL": lambda fi, fo: 1 / np.sqrt(fi),
        "XAVIER": lambda fi, fo: np.sqrt(2 / (fi + fo)),
        "XAVIER_FAN_IN": lambda fi, fo: np.sqrt(1 / fi),
        "RELU": lambda fi, fo: np.sqrt(2 / fi),
        "LECUN_NORMAL": lambda fi, fo: np.sqrt(1 / fi),
        "VAR_SCALING_NORMAL_FAN_AVG": lambda fi, fo: np.sqrt(2 / (fi + fo)),
        # uniform U(-a, a) has std a / sqrt(3)
        "UNIFORM": lambda fi, fo: 1 / np.sqrt(fi) / np.sqrt(3),
        "XAVIER_UNIFORM": lambda fi, fo: np.sqrt(6 / (fi + fo) / 3),
        "RELU_UNIFORM": lambda fi, fo: np.sqrt(6 / fi / 3),
        "LECUN_UNIFORM": lambda fi, fo: np.sqrt(3 / fi / 3),
        "SIGMOID_UNIFORM": lambda fi, fo: 4 * np.sqrt(6 / (fi + fo) / 3),
        "VAR_SCALING_UNIFORM_FAN_OUT": lambda fi, fo: np.sqrt(3 / fo / 3)}


@pytest.mark.parametrize("scheme", sorted(_STD))
def test_weight_init_draws_the_reference_distribution(scheme):
    """The std of 40k draws is within 3 % of the scheme's (the sampling
    error is ~0.4 %); the JAX package's draw of the same scheme too."""
    fi, fo = 200, 300
    w = tw.init_weight(torch.Generator().manual_seed(0), (200, 200), fi, fo,
                       scheme, device="cpu")
    want = _STD[scheme](fi, fo)
    assert w.dtype == torch.float32 and w.shape == (200, 200)
    assert abs(w.std().item() / want - 1) < 0.03
    assert abs(w.mean().item()) < 0.03 * want
    from deeplearning4j_tpu.nn.weights import init_weight as jinit
    jw = np.asarray(jinit(jax.random.PRNGKey(0), (200, 200), fi, fo,
                          scheme))
    assert abs(jw.std() / want - 1) < 0.03


@pytest.mark.parametrize("scheme", ["ZERO", "ONES", "IDENTITY"])
def test_weight_init_constants(scheme):
    w = tw.init_weight(torch.Generator(), (4, 4), 4, 4, scheme,
                       device="cpu")
    from deeplearning4j_tpu.nn.weights import init_weight as jinit
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jinit(jax.random.PRNGKey(0), (4, 4), 4, 4,
                                    scheme)))


# ---------------------------------------------------------------------------
# input types, preprocessors, datasets
# ---------------------------------------------------------------------------

_PRE = {
    "FeedForwardToCnnPreProcessor": ((2, 3 * 4 * 5), dict(
        inputHeight=4, inputWidth=5, numChannels=3)),
    "CnnToFeedForwardPreProcessor": ((2, 3, 4, 5), dict(
        inputHeight=4, inputWidth=5, numChannels=3)),
    "FeedForwardToRnnPreProcessor": ((2 * 6, 5), {}),
    "RnnToFeedForwardPreProcessor": ((2, 5, 6), {}),
    "CnnToRnnPreProcessor": ((2 * 6, 3, 4, 5), dict(
        inputHeight=4, inputWidth=5, numChannels=3)),
    "RnnToCnnPreProcessor": ((2, 60, 6), dict(
        inputHeight=4, inputWidth=5, numChannels=3)),
    "Cnn3DToFeedForwardPreProcessor": ((2, 3, 2, 4, 5), dict(
        inputDepth=2, inputHeight=4, inputWidth=5, numChannels=3)),
}


@pytest.mark.parametrize("name", sorted(_PRE))
def test_preprocessor_matches_reference(name):
    shape, kw = _PRE[name]
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    jp, tp = getattr(jpre, name)(**kw), getattr(tpre, name)(**kw)
    np.testing.assert_array_equal(tp.preProcess(torch.from_numpy(x),
                                                2).numpy(),
                                  np.asarray(jp.preProcess(jnp.asarray(x),
                                                           2)))
    it = jconf.InputType.recurrent(60, 6)
    assert tp.toJson() == jp.toJson()
    try:
        want = jp.getOutputType(it)
    except Exception as e:    # the reference's own limits stay the same
        with pytest.raises(type(e)):
            tp.getOutputType(tconf.InputType.recurrent(60, 6))
    else:
        assert tp.getOutputType(tconf.InputType.recurrent(60, 6)) \
            .toJson() == want.toJson()


@pytest.mark.parametrize("it", [
    ("feedForward", (7,)), ("convolutional", (4, 5, 3)),
    ("convolutionalFlat", (4, 5, 3)), ("recurrent", (8, 11)),
    ("convolutional3D", (2, 4, 5, 3))])
def test_input_type_matches_reference(it):
    name, args = it
    j, t = getattr(jconf.InputType, name)(*args), \
        getattr(tconf.InputType, name)(*args)
    assert t.toJson() == j.toJson()
    assert t.getShape(2) == j.getShape(2)
    assert t.arrayElementsPerExample() == j.arrayElementsPerExample()


def test_dataset_and_list_iterator():
    rng = np.random.RandomState(12)
    f, l = rng.randn(10, 3).astype(np.float32), rng.randn(10, 2)
    ds = tds.DataSet(f, l, featuresMask=np.ones((10, 3)))
    parts = ds.batchBy(4)
    assert [p.numExamples() for p in parts] == [4, 4, 2]
    assert parts[2].featuresMask.shape == (2, 3)
    assert parts[0].labelsMask is None
    assert torch.equal(torch.cat([p.labels.torch for p in parts]),
                       ds.labels.torch)
    it = tds.ListDataSetIterator([ds], batch=4)
    assert it.batch() == 4 and it.totalOutcomes() == 2 and \
        it.inputColumns() == 3
    assert [d.numExamples() for d in it] == [4, 4, 2]
    assert not it.hasNext()

    class Scale:
        def preProcess(self, d):
            d.features = d.features * 2

    it.setPreProcessor(Scale())
    it.reset()
    first = it.next()
    assert torch.equal(first.features.torch, ds.features.torch[:4] * 2)
    assert torch.equal(parts[0].features.torch,
                       ds.features.torch[:4])                 # cached copy


# ---------------------------------------------------------------------------
# LeNet from the zoo, and layer state (BatchNormalization) in the stack
# ---------------------------------------------------------------------------

def test_lenet_trains_as_the_reference_for_20_steps():
    """The zoo's LeNet (BASELINE config 1: conv 5x5/20, max-pool, conv
    5x5/50, max-pool, dense 500, softmax 10; Adam 1e-3) from the JAX net's
    params, on 4 fixed batches of 8 flat 28x28 images in turn: the loss
    curve over 20 steps and the final params.  float32 on both sides;
    losses hold to 1e-5.  Adam moves a parameter by up to ~lr whatever
    its gradient's size, so where a gradient is a near-zero sum that the
    two libraries round differently, the parameter can part by a fraction
    of lr.  Measured on the CPU: the gradients of the 20 steps agree to
    1.3e-5 of each tensor's largest; the worst parameter (layer 4 W,
    index 373674: gradient 1.63e-7 against 1.26e-7 at step 1, then
    equal to 1e-5 relative) ends 4.09e-5 apart, the 99.9th percentile
    1.9e-7.  So the params hold as a FLOAT step does in chip_smoke.py:
    99.9 % within 2e-5, and every one within the largest update one of
    the 20 reference steps makes (measured 1.07e-3)."""
    from deeplearning4j_tpu.zoo import LeNet as JLeNet
    from deeplearning4j_tpu_torch.zoo import LeNet as TLeNet
    jnet = JLeNet().init()
    net = TLeNet().init(device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    assert net.conf.toJson() == jnet.conf.toJson()
    np.testing.assert_array_equal(*_flat(jnet, net)[::-1])
    rng = np.random.RandomState(13)
    batches = [(rng.rand(8, 784).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
               for _ in range(4)]
    curve, largest_update = [], 0.0
    for s in range(20):
        before = _flat(jnet, net)[0]
        curve.append(_fit_both(jnet, net, [batches[s % 4]], 1)[0])
        largest_update = max(largest_update,
                             float(np.abs(_flat(jnet, net)[0] - before).max()))
    curve = np.array(curve)
    np.testing.assert_allclose(curve[:, 1], curve[:, 0], atol=1e-5, rtol=0)
    assert curve[-1, 1] < curve[0, 1]           # it learns
    diff = np.abs(np.subtract(*_flat(jnet, net)))
    assert np.mean(diff <= 2e-5) >= 0.999, np.quantile(diff, 0.999)
    assert diff.max() <= largest_update, (diff.max(), largest_update)
    f = batches[0][0]
    np.testing.assert_allclose(net.output(f).numpy(),
                               np.asarray(jnet.output(f).jax), atol=1e-5)


def _bn_conf(pkg):
    L = pkg.layers
    return (pkg.conf.NeuralNetConfiguration.builder().seed(21)
            .updater(pkg.learn.Nesterovs(0.05, momentum=0.9)).list()
            .layer(L.ConvolutionLayer.builder().nOut(4).kernelSize(3, 3)
                   .convolutionMode("Same").activation("identity").build())
            .layer(L.BatchNormalization.builder().decay(0.7)
                   .activation("relu").build())
            .layer(L.DenseLayer.builder().nOut(6).activation("identity")
                   .build())
            .layer(L.BatchNormalization.builder().build())
            .layer(L.OutputLayer.builder("mcxent").nOut(3).build())
            .setInputType(pkg.conf.InputType.convolutional(5, 5, 2)).build())


def test_batch_norm_running_stats_follow_the_reference_in_a_stack():
    """BatchNormalization in a MultiLayerNetwork (CNN and FF): the running
    statistics are the net's layer state, updated each step and used by
    ``output`` and ``score`` — after 3 steps they, the params, the losses
    and the inference outputs match the reference (float32 summation
    order: 1e-5)."""
    jnet = JAX.models.MultiLayerNetwork(_bn_conf(JAX)).init()
    net = PORT.models.MultiLayerNetwork(_bn_conf(PORT), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    assert sorted(net.state_) == sorted(jnet.state_) == ["1", "3"]
    rng = np.random.RandomState(14)
    batches = [(rng.randn(6, 2, 5, 5).astype(np.float32) + 1.0,
                np.eye(3, dtype=np.float32)[rng.randint(0, 3, 6)])
               for _ in range(3)]
    curve = _fit_both(jnet, net, batches, 3)
    np.testing.assert_allclose(curve[:, 1], curve[:, 0], atol=1e-5, rtol=0)
    for li in ("1", "3"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(net.state_[li][k].numpy(),
                                       np.asarray(jnet.state_[li][k]),
                                       atol=1e-5, rtol=0)
        assert not torch.equal(net.state_[li]["var"],
                               torch.ones_like(net.state_[li]["var"]))
    np.testing.assert_allclose(*_flat(jnet, net)[::-1], atol=1e-5, rtol=0)
    f, l = batches[0]
    np.testing.assert_allclose(net.output(f).numpy(),
                               np.asarray(jnet.output(f).jax), atol=1e-5)
    assert abs(net.score(PORT.ds.DataSet(f, l)) -
               jnet.score(JAX.ds.DataSet(f, l))) <= 1e-5
