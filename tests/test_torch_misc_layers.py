"""Port parity: ``nn/conf/misc.py`` (every layer but ``MaskingLayer``,
which ``test_torch_recurrent.py`` holds) against the JAX package.

Each layer runs its forward in both packages on the same seeded numpy
parameters, state and input, then the gradients of sum(output · R) with
respect to its parameters and input; float32 on both sides, so 1e-5
(absolute and relative).  The noise and dropout layers draw from the
port's generator, so they are held at inference (the identity, as in the
reference) and by their moments.  Every layer's reference JSON loads in
the port and is given back byte for byte.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.models as jmodels
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.models as tmodels
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import misc as jmisc
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import misc as tmisc
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

from _torch_parity import _json_round_trip, _layer_parity, _loss_parity

pytestmark = pytest.mark.torch_port


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _pair(name, **kw):
    return getattr(jmisc, name)(**kw), getattr(tmisc, name)(**kw)


@pytest.mark.parametrize("masked", [False, True])
def test_mask_layer(masked):
    rng = np.random.RandomState(1)
    jl, tl = _pair("MaskLayer")
    mask = (rng.rand(3, 5) > 0.4).astype(np.float32) if masked else None
    out, _ = _layer_parity(jl, tl, {}, _rand(rng, 3, 4, 5), mask=mask)
    if masked:
        assert (out.numpy()[mask[:, None, :].repeat(4, 1) == 0] == 0).all()


def test_rescale_layer():
    rng = np.random.RandomState(2)
    jl, tl = _pair("RescaleLayer", scale=1 / 255, offset=-0.5)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 3, 4, 4, scale=100))


@pytest.mark.parametrize("stats", ["given", "default"])
@pytest.mark.parametrize("shape", [(2, 3), (2, 3, 4, 5), (2, 3, 6)])
def test_static_normalization_layer(stats, shape):
    rng = np.random.RandomState(3)
    kw = dict(nIn=3)
    if stats == "given":
        kw.update(mean=(0.5, -1.0, 2.0), variance=(4.0, 0.25, 1.0))
    jl, tl = _pair("StaticNormalizationLayer", **kw)
    jst = jl.initState(None)
    tst = tl.initState(None, device="cpu")
    for k in ("mean", "var"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    _layer_parity(jl, tl, {}, _rand(rng, *shape),
                  state={k: np.asarray(v) for k, v in jst.items()})


def test_repeat_vector():
    rng = np.random.RandomState(4)
    jl, tl = _pair("RepeatVector", repetitionFactor=4)
    out, _ = _layer_parity(jl, tl, {}, _rand(rng, 3, 5))
    assert tuple(out.shape) == (3, 5, 4)


def test_element_wise_multiplication_layer():
    rng = np.random.RandomState(5)
    jl, tl = _pair("ElementWiseMultiplicationLayer", nIn=6,
                   activation="tanh")
    p = {"W": _rand(rng, 6), "b": _rand(rng, 6)}
    _layer_parity(jl, tl, p, _rand(rng, 4, 6))
    tp = tl.initParams(None, None, device="cpu")
    assert (tp["W"] == 1).all() and (tp["b"] == 0).all()


@pytest.mark.parametrize("cropping", [(1, 2), 1, (0, 0)])
def test_cropping1d(cropping):
    rng = np.random.RandomState(6)
    jl, tl = _pair("Cropping1D", cropping=cropping)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 3, 7))


@pytest.mark.parametrize("padding", [(1, 2), 2])
def test_zero_padding1d(padding):
    rng = np.random.RandomState(7)
    jl, tl = _pair("ZeroPadding1DLayer", padding=padding)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 3, 5))


@pytest.mark.parametrize("shape", [(4, 6), (3, 6, 5), (2, 6, 3, 4)])
def test_layer_normalization(shape):
    """The biased variance over the feature axis (axis 1)."""
    rng = np.random.RandomState(8)
    jl, tl = _pair("LayerNormalization", nIn=6, eps=1e-3)
    p = {"gamma": _rand(rng, 6), "beta": _rand(rng, 6)}
    _layer_parity(jl, tl, p, _rand(rng, *shape, scale=2.0))


NOISE = [("GaussianNoiseLayer", dict(stddev=0.3)),
         ("GaussianDropoutLayer", dict(rate=0.4)),
         ("AlphaDropoutLayer", dict(rate=0.2))]


@pytest.mark.parametrize("name,kw", NOISE, ids=[n for n, _ in NOISE])
def test_noise_layers_identity_at_inference_and_moments(name, kw):
    """Identity at inference (and in training without a generator), as
    the reference; in training, the moments their formulas promise over
    4e5 draws from a seeded generator: x + N(0, sd²), x · N(1,
    rate/(1-rate)), and alpha dropout's kept mean and variance."""
    rng = np.random.RandomState(9)
    jl, tl = _pair(name, **kw)
    _layer_parity(jl, tl, {}, _rand(rng, 3, 4))
    x = torch.from_numpy(_rand(rng, 3, 4))
    assert torch.equal(tl.forward({}, x, True, None, {})[0], x)
    gen = torch.Generator().manual_seed(0)
    n = 400_000
    if name == "AlphaDropoutLayer":
        xs = torch.randn(n, generator=torch.Generator().manual_seed(1))
        y, _ = tl.forward({}, xs, True, gen, {})
        assert abs(float(y.mean())) < 0.01
        assert abs(float(y.var()) - 1.0) < 0.01
        return
    y, _ = tl.forward({}, torch.ones(n), True, gen, {})
    if name == "GaussianNoiseLayer":
        assert abs(float(y.mean()) - 1.0) < 0.003
        assert abs(float(y.std()) - kw["stddev"]) < 0.003
    else:
        sd = (kw["rate"] / (1 - kw["rate"])) ** 0.5
        assert abs(float(y.mean()) - 1.0) < 0.01
        assert abs(float(y.std()) - sd) < 0.01


RESHAPES = [((2, 12), (3, 4)), ((2, 3, 4), (12,)), ((2, 3, 4, 5), (20, 3)),
            ((2, 3, 4), (2, -1)), ((2, 6), (1, 2, 3))]


@pytest.mark.parametrize("shape,target", RESHAPES)
def test_reshape_layer(shape, target):
    """Keras channels-last semantics on the port's layouts."""
    rng = np.random.RandomState(10)
    jl, tl = _pair("ReshapeLayer", targetShape=target)
    _layer_parity(jl, tl, {}, _rand(rng, *shape))


PERMUTES = [((2, 3, 4), (2, 1)), ((2, 3, 4, 5), (3, 1, 2)),
            ((2, 3, 4, 5), (2, 1, 3))]


@pytest.mark.parametrize("shape,dims", PERMUTES)
def test_permute_layer(shape, dims):
    rng = np.random.RandomState(11)
    jl, tl = _pair("PermuteLayer", dims=dims)
    _layer_parity(jl, tl, {}, _rand(rng, *shape))


def test_reshape_and_permute_output_types():
    for jl, tl, it in [
            (*_pair("ReshapeLayer", targetShape=(4, -1)),
             InputType.convolutional(4, 3, 2)),
            (*_pair("PermuteLayer", dims=(3, 1, 2)),
             InputType.convolutional(4, 3, 2))]:
        got = tl.getOutputType(it)
        ref = jl.getOutputType(jconf.InputType.fromJson(it.toJson()))
        assert got.toJson() == ref.toJson()


@pytest.mark.parametrize("train", [False, True])
def test_ocnn_output_layer(train):
    """score = w · sigmoid(V x), output score - r; a training forward moves
    r to 0.9 r + 0.1 · the nu-quantile of the scores (linear interpolation
    in both ``jnp.quantile`` and ``torch.quantile``)."""
    rng = np.random.RandomState(12)
    jl, tl = _pair("OCNNOutputLayer", nIn=5, hiddenSize=4, nu=0.3)
    p = {"V": _rand(rng, 5, 4), "w": _rand(rng, 4)}
    x = _rand(rng, 8, 5)
    st = {"r": np.float32(0.2)}
    _layer_parity(jl, tl, p, x, state=st, train=train)
    jp = {k: jax.numpy.asarray(v) for k, v in p.items()}
    _, jst = jl.forward(jp, jax.numpy.asarray(x), train, None,
                        {"r": jax.numpy.asarray(0.2, np.float32)})
    _, tst = tl.forward({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), train, None,
                        {"r": torch.tensor(0.2)})
    np.testing.assert_allclose(float(tst["r"]), float(jst["r"]), rtol=1e-6)
    out = _rand(rng, 8, 1)
    _loss_parity(jl, tl, np.zeros((8, 1), np.float32), out)


MISC_JSON = [
    ("MaskLayer", {}), ("RescaleLayer", dict(scale=2.0, offset=1.0)),
    ("StaticNormalizationLayer", dict(nIn=2, mean=(1.0, 2.0),
                                      variance=(3.0, 4.0))),
    ("RepeatVector", dict(repetitionFactor=3)),
    ("ElementWiseMultiplicationLayer", dict(nIn=4)),
    ("Cropping1D", dict(cropping=(1, 2))),
    ("ZeroPadding1DLayer", dict(padding=(2, 0))),
    ("LayerNormalization", dict(nIn=3, eps=1e-5)),
    ("GaussianNoiseLayer", dict(stddev=0.2)),
    ("GaussianDropoutLayer", dict(rate=0.3)),
    ("AlphaDropoutLayer", dict(rate=0.05)),
    ("ReshapeLayer", dict(targetShape=(2, -1))),
    ("PermuteLayer", dict(dims=(2, 1))),
    ("OCNNOutputLayer", dict(nIn=5, hiddenSize=3, nu=0.1)),
    ("MaskingLayer", dict(maskValue=-1.0))]


@pytest.mark.parametrize("name,kw", MISC_JSON, ids=[n for n, _ in MISC_JSON])
def test_reference_json_loads_and_round_trips(name, kw):
    layer, ref, back = _json_round_trip(getattr(jmisc, name)(**kw))
    assert type(layer).__name__ == name and back == ref


def test_every_misc_class_is_registered():
    from deeplearning4j_tpu.nn.conf.layers import _LAYER_REGISTRY as REF
    names = sorted(n for n, c in REF.items() if c.__module__ == jmisc.__name__)
    assert len(names) == 15 and sorted(n for n, _ in MISC_JSON) == names
    assert [n for n in names if n not in tlayers._LAYER_REGISTRY] == []


def _ocnn_conf(c, L, M, learn):
    return (c.NeuralNetConfiguration.builder().seed(3)
            .updater(learn.Adam(1e-2)).l2(1e-3).list()
            .layer(L.DenseLayer.builder().nOut(6).activation("tanh").build())
            .layer(M.LayerNormalization.builder().build())
            .layer(M.OCNNOutputLayer.builder().hiddenSize(4).nu(0.2).build())
            .setInputType(c.InputType.feedForward(5)).build())


def test_ocnn_network_fits_like_the_reference():
    """Three Adam steps of dense + layer norm + OCNN in both packages from
    the same parameters: the losses, the parameters and the state r to
    1e-5."""
    jnet = jmodels.MultiLayerNetwork(_ocnn_conf(jconf, jlayers, jmisc,
                                                jlearn))
    jnet.init()
    net = tmodels.MultiLayerNetwork(
        _ocnn_conf(tconf, tlayers, tmisc, tlearn), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    rng = np.random.RandomState(13)
    for _ in range(3):
        x = _rand(rng, 16, 5)
        y = np.zeros((16, 1), np.float32)
        jnet.fit(jds.DataSet(x, y))
        net.fit(tds.DataSet(x, y))
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jnet.params().jax), atol=1e-5)
    np.testing.assert_allclose(float(net.state_["2"]["r"]),
                               float(jnet.state_["2"]["r"]), rtol=1e-5)
