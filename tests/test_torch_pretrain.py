"""ROADMAP A4's rest against the reference: ``AutoEncoder``,
``VariationalAutoencoder`` and ``MultiLayerNetwork.pretrain``.

torch cannot draw the reference's ``jax.random`` bits, so the noisy
quantities are held through the layers' inner forms that take the noise
explicitly (``pretrainLossGivenMask``, ``pretrainLossGivenNoise``,
``reconstructionLogProbabilityGivenNoise``), fed the reference's own
draws; ``pretrain`` is held step for step with the reference's draws
substituted for the port's.  Then the behaviour of the reference's
``tests/test_vae.py`` on the port, and ROADMAP C20."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JAX, PORT, _json_round_trip, _layer_parity
from deeplearning4j_tpu.nn.conf.autoencoder import AutoEncoder as JAE
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.variational import \
    VariationalAutoencoder as JVAE
from deeplearning4j_tpu_torch.nn.conf.autoencoder import AutoEncoder
from deeplearning4j_tpu_torch.nn.conf.variational import \
    VariationalAutoencoder

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-5, rtol=1e-5)
NIN = 6


def _blobs(n=32, seed=0):
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 2, n)
    return (rng.randn(n, NIN) * 0.3 + c[:, None] * 2.0).astype(np.float32)


def _params(jl, seed=0):
    """The reference's drawn parameters, its zero biases made random."""
    jl.inferNIn(JInputType.feedForward(NIN))
    p = jl.initParams(jax.random.PRNGKey(seed), JInputType.feedForward(NIN))
    rng = np.random.RandomState(seed + 1)
    return {k: np.asarray(v) if k.startswith("W") else
            (rng.randn(*np.shape(v)) * 0.1).astype(np.float32)
            for k, v in p.items()}


def _loss_and_grads_match(jfn, tfn, params, atol=1e-5, rtol=1e-5):
    """A scalar loss of the parameters and its gradient, both packages
    (the reference's under one ``jax.jit``)."""
    jl, jg = jax.jit(jax.value_and_grad(jfn))({k: jnp.asarray(v)
                                               for k, v in params.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tl = tfn(tp)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=atol, rtol=rtol)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# AutoEncoder
# ---------------------------------------------------------------------------

AE_CASES = [dict(nOut=4, corruptionLevel=0.3, lossFunction="mse",
                 activation="sigmoid"),
            dict(nOut=3, corruptionLevel=0.5, lossFunction="xent"),
            dict(nOut=4, corruptionLevel=0.0, lossFunction="mse",
                 activation="tanh")]


@pytest.mark.parametrize("kw", AE_CASES, ids=["mse", "xent", "clean"])
def test_autoencoder_loss_with_the_references_corruption(kw):
    jl, tl = JAE(nIn=NIN, **kw), AutoEncoder(nIn=NIN, **kw)
    params = _params(jl)
    x = np.clip(_blobs() * 0.2 + 0.3, 0.0, 1.0)
    key = jax.random.PRNGKey(4)
    keep = None
    if 0.0 < kw["corruptionLevel"] < 1.0:
        keep = np.array(jax.random.bernoulli(
            key, 1.0 - kw["corruptionLevel"], x.shape))
    _loss_and_grads_match(
        lambda p: jl.pretrainLoss(p, jnp.asarray(x), key),
        lambda p: tl.pretrainLossGivenMask(p, torch.tensor(x), keep),
        params)
    np.testing.assert_allclose(
        tl.reconstructionError({k: torch.tensor(v) for k, v in
                                params.items()}, x).numpy(),
        np.asarray(jl.reconstructionError(params, jnp.asarray(x))), **TOL)


def test_autoencoder_forward_is_the_encoder_as_the_references():
    jl, tl = JAE(nIn=NIN, nOut=4), AutoEncoder(nIn=NIN, nOut=4)
    _layer_parity(jl, tl, _params(jl), _blobs(8), **TOL)


def test_autoencoder_draws_its_corruption_from_the_generator():
    tl = AutoEncoder(nIn=NIN, nOut=4, corruptionLevel=0.3)
    x = torch.ones((2000, NIN))
    keep = tl.corruptionMask(x, torch.Generator().manual_seed(0))
    assert abs(keep.float().mean().item() - 0.7) < 0.02
    again = tl.corruptionMask(x, torch.Generator().manual_seed(0))
    assert torch.equal(keep, again)
    p = {k: torch.tensor(v) for k, v in _params(JAE(nIn=NIN, nOut=4))
         .items()}
    assert tl.pretrainLoss(p, x, torch.Generator().manual_seed(0)).item() \
        == pytest.approx(tl.pretrainLossGivenMask(p, x, keep).item())
    assert AutoEncoder(nIn=NIN, nOut=4, corruptionLevel=0.0) \
        .corruptionMask(x, torch.Generator()) is None


# ---------------------------------------------------------------------------
# VariationalAutoencoder
# ---------------------------------------------------------------------------

VAE_CASES = [dict(nOut=2, encoderLayerSizes=(16,), decoderLayerSizes=(16,),
                  activation="tanh", reconstructionDistribution="gaussian"),
             dict(nOut=3, encoderLayerSizes=(8, 8), decoderLayerSizes=(8,),
                  activation="leakyrelu",
                  reconstructionDistribution="bernoulli", numSamples=3)]


def _eps(key, s_count, shape):
    """The reference's ε draws: ``normal(fold_in(key, s))`` per sample."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), shape, jnp.float32))
        for s in range(s_count)])


def _vae_data(kw):
    if kw["reconstructionDistribution"] == "bernoulli":
        return (np.random.RandomState(3).rand(16, NIN) < 0.3).astype(
            np.float32)
    return _blobs(16)


@pytest.mark.parametrize("kw", VAE_CASES, ids=["gaussian", "bernoulli"])
def test_vae_negative_elbo_with_the_references_noise(kw):
    jl, tl = JVAE(nIn=NIN, **kw), VariationalAutoencoder(nIn=NIN, **kw)
    params = _params(jl)
    x = _vae_data(kw)
    key = jax.random.PRNGKey(7)
    eps = _eps(key, max(1, jl.numSamples), (x.shape[0], jl.nOut))
    _loss_and_grads_match(
        lambda p: jl.pretrainLoss(p, jnp.asarray(x), key),
        lambda p: tl.pretrainLossGivenNoise(p, torch.tensor(x), eps),
        params, atol=1e-4)


@pytest.mark.parametrize("kw", VAE_CASES, ids=["gaussian", "bernoulli"])
def test_vae_scoring_and_generation_match_the_reference(kw):
    jl, tl = JVAE(nIn=NIN, **kw), VariationalAutoencoder(nIn=NIN, **kw)
    params = _params(jl)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    x = _vae_data(kw)
    ref = np.asarray(jl.reconstructionLogProbability(params, x,
                                                     numSamples=5))
    eps = _eps(jax.random.PRNGKey(0), 5, (x.shape[0], jl.nOut))
    got = tl.reconstructionLogProbabilityGivenNoise(tp, x, eps).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    z = np.random.RandomState(2).randn(4, jl.nOut).astype(np.float32)
    np.testing.assert_allclose(
        tl.generateAtMeanGivenZ(tp, z).numpy(),
        np.asarray(jl.generateAtMeanGivenZ(params, z)), **TOL)
    _layer_parity(jl, tl, params, x, **TOL)          # forward: the mean
    drawn = tl.reconstructionLogProbability(tp, x, numSamples=5)
    assert drawn.shape == (x.shape[0],) and bool(drawn.isfinite().all())


@pytest.mark.parametrize("layer", [
    JAE(nIn=NIN, nOut=4, corruptionLevel=0.2, lossFunction="xent"),
    JVAE(nIn=NIN, nOut=2, encoderLayerSizes=(5, 4),
         decoderLayerSizes=(3,), reconstructionDistribution="bernoulli")],
    ids=["AutoEncoder", "VariationalAutoencoder"])
def test_layer_json_loads_in_the_port(layer):
    port, ref, back = _json_round_trip(layer)
    assert type(port).__name__ == type(layer).__name__
    assert back == ref


def test_c20_the_references_vae_json_loads_only_in_the_port():
    """ROADMAP C20: the reference leaves ``VariationalAutoencoder`` out of
    its layer registry, so its own JSON does not load there (a zip of a
    VAE net cannot be restored); the port registers it."""
    from deeplearning4j_tpu.nn.conf.layers import \
        layer_from_json as jlayer_from_json
    js = JVAE(nIn=NIN, nOut=2).toJson()
    with pytest.raises(KeyError, match="VariationalAutoencoder"):
        jlayer_from_json(dict(js))
    assert type(_json_round_trip(JVAE(nIn=NIN, nOut=2))[0]) is \
        VariationalAutoencoder


# ---------------------------------------------------------------------------
# MultiLayerNetwork.pretrain
# ---------------------------------------------------------------------------

def _two_pretrain_layers(pkg):
    """An AutoEncoder then a VAE, both pretrained, and a head."""
    conf = pkg.conf
    return (conf.NeuralNetConfiguration.builder().seed(7)
            .updater(pkg.learn.Adam(1e-2)).list()
            .layer(conf.AutoEncoder(nOut=5, corruptionLevel=0.3,
                                    lossFunction="xent",
                                    activation="sigmoid"))
            .layer(conf.VariationalAutoencoder(
                nOut=2, encoderLayerSizes=(8,), decoderLayerSizes=(8,),
                activation="tanh", reconstructionDistribution="gaussian",
                numSamples=2))
            .layer(pkg.layers.OutputLayer.builder("mse").nOut(2)
                   .activation("identity").build())
            .setInputType(conf.InputType.feedForward(NIN)).build())


def _with_references_noise(net, jnet):
    """Make the port's layers draw what the reference's pretrain draws at
    each step: ``fold_in(_fitKey, it)`` per step, restarting per layer."""
    state = {"layer": None, "it": 0}
    fit_key = jnet._fitKey

    def step_key(layer):
        if state["layer"] is not layer:
            state["layer"], state["it"] = layer, 0
        key = jax.random.fold_in(fit_key, state["it"])
        state["it"] += 1
        return key

    ae, vae = net.conf.layers[0], net.conf.layers[1]
    ae.corruptionMask = lambda x, gen: torch.tensor(np.array(
        jax.random.bernoulli(step_key(ae), 1.0 - ae.corruptionLevel,
                             tuple(x.shape))))
    vae._noise = lambda like, n, gen: torch.tensor(_eps(
        step_key(vae), n, tuple(like.shape)))


def test_pretrain_matches_the_reference_step_for_step():
    """Two pretrain layers, two batches, three epochs: each layer trains
    on its own loss with the layers below frozen, a fresh Adam state per
    layer, no regularization; the parameters and the score follow the
    reference's."""
    jnet = JAX.models.MultiLayerNetwork(_two_pretrain_layers(JAX)).init()
    params0 = jax.tree.map(np.asarray, jnet.params_)
    net = PORT.models.MultiLayerNetwork(_two_pretrain_layers(PORT),
                                        device="cpu").init(params=params0)
    _with_references_noise(net, jnet)
    X = np.clip(_blobs(32) * 0.2 + 0.3, 0.0, 1.0)
    batches = [X[:16], X[16:]]
    y = np.zeros((16, 2), np.float32)
    jnet.pretrain(JAX.ds.ListDataSetIterator(
        [JAX.ds.DataSet(b, y) for b in batches]), epochs=3)
    net.pretrain(PORT.ds.ListDataSetIterator(
        [PORT.ds.DataSet(b, y) for b in batches]), epochs=3)
    for k in ("0", "1", "2"):
        for n, v in net.params_[k].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(
                jnet.params_[k][n]), atol=2e-5, rtol=1e-4,
                err_msg=f"{k}/{n}")
    assert not np.allclose(net.params_["1"]["We0"].numpy(),
                           params0["1"]["We0"])
    np.testing.assert_array_equal(net.params_["2"]["W"].numpy(),
                                  params0["2"]["W"])   # not a pretrain layer
    assert net.score() == pytest.approx(jnet.score(), rel=1e-4)


def _vae_net(dist="gaussian", latent=2):
    conf = PORT.conf
    return PORT.models.MultiLayerNetwork(
        conf.NeuralNetConfiguration.builder().seed(7)
        .updater(PORT.learn.Adam(1e-2)).list()
        .layer(conf.VariationalAutoencoder(
            nOut=latent, encoderLayerSizes=(16,), decoderLayerSizes=(16,),
            activation="tanh", reconstructionDistribution=dist))
        .layer(PORT.layers.OutputLayer.builder("mse").nOut(2)
               .activation("identity").build())
        .setInputType(conf.InputType.feedForward(NIN)).build(),
        device="cpu").init()


def test_vae_pretrain_improves_elbo_and_scores_anomalies():
    """``tests/test_vae.py``'s first test on the port."""
    net = _vae_net()
    layer = net.conf.layers[0]
    X = torch.tensor(_blobs(128))
    it = PORT.ds.ListDataSetIterator(
        [PORT.ds.DataSet(X.numpy(), np.zeros((128, 2), np.float32))],
        batch=128)
    eps = torch.randn((1, 128, 2), generator=torch.Generator().manual_seed(1))
    before = layer.pretrainLossGivenNoise(net.params_["0"], X, eps).item()
    net.pretrain(it, epochs=60)
    p1 = net.params_["0"]
    after = layer.pretrainLossGivenNoise(p1, X, eps).item()
    assert after < before - 1.0, (before, after)
    inliers = layer.reconstructionLogProbability(p1, X[:32])
    outliers = layer.reconstructionLogProbability(
        p1, np.full((32, NIN), 8.0, np.float32))
    assert inliers.mean() > outliers.mean() + 5.0
    assert tuple(net.output(X[:4]).shape) == (4, 2)
    gen = layer.generateAtMeanGivenZ(p1, np.zeros((3, 2), np.float32))
    assert tuple(gen.shape) == (3, NIN) and bool(gen.isfinite().all())


def test_vae_pretrain_applies_its_own_preprocessor():
    conf = PORT.conf
    c = (conf.NeuralNetConfiguration.builder().seed(7)
         .updater(PORT.learn.Adam(1e-2)).list()
         .layer(PORT.layers.ConvolutionLayer.builder().nIn(1).nOut(1)
                .kernelSize(1, 1).activation("identity").build())
         .layer(conf.VariationalAutoencoder(
             nOut=2, encoderLayerSizes=(8,), decoderLayerSizes=(8,),
             activation="tanh"))
         .layer(PORT.layers.OutputLayer.builder("mse").nOut(2)
                .activation("identity").build())
         .setInputType(conf.InputType.convolutional(2, 3, 1)).build())
    net = PORT.models.MultiLayerNetwork(c, device="cpu").init()
    assert type(net.conf.preProcessors[1]).__name__ == \
        "CnnToFeedForwardPreProcessor"
    X = np.random.RandomState(0).randn(16, 1, 2, 3).astype(np.float32)
    net.pretrain(PORT.ds.ListDataSetIterator(
        [PORT.ds.DataSet(X, np.zeros((16, 2), np.float32))], batch=16),
        epochs=2)
    assert np.isfinite(net.score())


def test_pretrain_on_an_empty_iterator_keeps_the_score():
    net = _vae_net()
    net.pretrain(PORT.ds.ListDataSetIterator([], batch=8), epochs=1)
    assert net._scoreArr is None


def test_autoencoder_pretrain_reduces_reconstruction_error(tmp_path):
    """``tests/test_vae.py``'s plain autoencoder from the reference's
    initial parameters: 80 epochs halve the reconstruction error (the
    reference's bar, which its own run clears by 0.3 %), within 2 % of
    the reference's final error (the corruption draws differ)."""
    def conf(pkg):
        c = pkg.conf
        return (c.NeuralNetConfiguration.builder().seed(3)
                .updater(pkg.learn.Adam(1e-2)).list()
                .layer(c.AutoEncoder(nOut=4, corruptionLevel=0.3,
                                     activation="sigmoid"))
                .layer(pkg.layers.OutputLayer.builder("mse").nOut(2)
                       .activation("identity").build())
                .setInputType(c.InputType.feedForward(NIN)).build())
    jnet = JAX.models.MultiLayerNetwork(conf(JAX)).init()
    net = PORT.models.MultiLayerNetwork(conf(PORT), device="cpu").init(
        params=jax.tree.map(np.asarray, jnet.params_))
    layer = net.conf.layers[0]
    assert set(net.params_["0"]) == {"W", "b", "vb"}     # tied weights
    X = np.clip(_blobs(128) * 0.2 + 0.3, 0.0, 1.0)
    e0 = layer.reconstructionError(net.params_["0"], X).mean().item()
    y = np.zeros((128, 2), np.float32)
    net.pretrain(PORT.ds.ListDataSetIterator([PORT.ds.DataSet(X, y)],
                                             batch=128), epochs=80)
    jnet.pretrain(JAX.ds.ListDataSetIterator([JAX.ds.DataSet(X, y)],
                                             batch=128), epochs=80)
    e1 = layer.reconstructionError(net.params_["0"], X).mean().item()
    je1 = float(np.mean(np.asarray(jnet.conf.layers[0].reconstructionError(
        jnet.params_["0"], X))))
    assert e1 < e0 * 0.5, (e0, e1)
    assert e1 == pytest.approx(je1, rel=0.02)
    r_out = layer.reconstructionError(
        net.params_["0"], np.full((32, NIN), 0.99, np.float32))
    assert r_out.mean() > layer.reconstructionError(
        net.params_["0"], X[:32]).mean()
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    p = str(tmp_path / "ae.zip")
    ModelSerializer.writeModel(net, p, saveUpdater=False)
    back = ModelSerializer.restoreMultiLayerNetwork(p, device="cpu")
    assert torch.equal(back.output(X[:8]).torch, net.output(X[:8]).torch)


def test_vae_bernoulli_distribution_pretrains():
    net = _vae_net(dist="bernoulli")
    layer = net.conf.layers[0]
    X = (np.random.RandomState(3).rand(64, NIN) < 0.3).astype(np.float32)
    net.pretrain(PORT.ds.ListDataSetIterator(
        [PORT.ds.DataSet(X, np.zeros((64, 2), np.float32))], batch=64),
        epochs=30)
    p = net.params_["0"]
    probs = layer.generateAtMeanGivenZ(p, np.zeros((2, 2), np.float32))
    assert bool(((probs >= 0) & (probs <= 1)).all())
    assert bool(layer.reconstructionLogProbability(p, X[:8])
                .isfinite().all())
