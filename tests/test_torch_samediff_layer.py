"""Port parity: the SameDiff layers (``nn/conf/samediff_layer.py``:
``SDLayerParams``, ``SameDiffLayer``, ``SameDiffLambdaLayer``) and the zoo's
``SRGAN`` with its ``PixelShuffleLayer`` against the JAX package's.

A user's dense layer on the SameDiff op surface in ``MultiLayerNetwork``,
FLOAT and BFLOAT16, one ``fit`` step from copied parameters; the lambda
layer; the JSON and the ``ModelSerializer`` zips in both directions;
SRGAN at the reference test's size (``inputShape=(3, 12, 12)``, two
residual blocks): generator and discriminator forward and one step each
from carried parameters, the configuration's JSON, the zips; and the
reference's own ``tests/test_samediff_layer.py`` run against the port.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.models as jmodels
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.zoo as jz
import deeplearning4j_tpu_torch.models as tmodels
import deeplearning4j_tpu_torch.nn.conf as tconf
import deeplearning4j_tpu_torch.zoo as tz
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.utils import ModelSerializer as JMS
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
from deeplearning4j_tpu_torch.utils import ModelSerializer as TMS

from _torch_parity import _cpu_default, _reference_tests

pytestmark = pytest.mark.torch_port

STEP_RTOL = 1e-4


def _host(a):
    """A port tensor or NDArray, or a reference NDArray, as float32
    numpy."""
    if hasattr(a, "torch") and not isinstance(a, torch.Tensor):
        a = a.torch
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a.numpy(), dtype=np.float32)


def _dense_cls(base, input_type):
    """A user's dense + tanh layer on ``base`` (either package's
    SameDiffLayer), named ``UserDense`` in both so one JSON builds
    both."""
    def defineParameters(self, params):
        params.addWeightParam("W", self.nIn, self.nOut)
        params.addBiasParam("b", self.nOut)

    def defineLayer(self, sd, layerInput, paramTable):
        return sd.math().tanh(sd.nn().linear(layerInput, paramTable["W"],
                                             paramTable["b"]) * 1.5)

    def getOutputType(self, inputType):
        return input_type.feedForward(self.nOut)
    cls = type("UserDense", (base,), {
        "__annotations__": {"nOut": int}, "nOut": 8,
        "defineParameters": defineParameters, "defineLayer": defineLayer,
        "getOutputType": getOutputType, "__module__": __name__})
    return dataclasses.dataclass(cls)


def _lambda_cls(base):
    def defineLayer(self, sd, layerInput):
        return sd.math().sin(layerInput) * 2.0 + layerInput
    return dataclasses.dataclass(type("SinPlus", (base,), {
        "defineLayer": defineLayer, "__module__": __name__}))


JDense = _dense_cls(jconf.SameDiffLayer, jconf.InputType)
TDense = _dense_cls(tconf.SameDiffLayer, tconf.InputType)
JSin = _lambda_cls(jconf.SameDiffLambdaLayer)
TSin = _lambda_cls(tconf.SameDiffLambdaLayer)


def _nets(jlayer, tlayer, data_type="FLOAT"):
    def conf(pkg, layer, out, adam):
        return (pkg.NeuralNetConfiguration.builder().seed(5)
                .updater(adam(1e-2)).dataType(data_type).list()
                .layer(layer)
                .layer(out.builder("mcxent").nOut(3).activation("softmax")
                       .build())
                .setInputType(pkg.InputType.feedForward(10)).build())
    net = tmodels.MultiLayerNetwork(conf(tconf, tlayer, OutputLayer, Adam),
                                    device="cpu").init()
    jnet = jmodels.MultiLayerNetwork(conf(jconf, jlayer, JOutputLayer,
                                          JAdam))
    jnet.init(params=jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                                  net.params_))
    return net, jnet


def _toy(n=16):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 10).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ rng.randn(10, 3), 1)]
    return x, y


def _params_close(net, jnet, rtol, atol):
    for k, lp in net.params_.items():
        for n, v in lp.items():
            np.testing.assert_allclose(
                _host(v), np.asarray(jnet.params_[k][n], dtype=np.float32),
                rtol=rtol, atol=atol, err_msg=f"{k}/{n}")


@pytest.mark.parametrize("data_type,tol", [("FLOAT", (1e-5, 1e-6, 1e-6)),
                                           ("BFLOAT16", (1e-2, 1e-2, 1e-5))])
def test_samediff_layer_fit_step_matches_the_reference(data_type, tol):
    """``defineParameters``' names carry by ``init(params=)``; the output
    and one Adam step from the same parameters match the reference's
    (BFLOAT16: bf16 compute over float32 masters, the input and
    parameters cast once by the net, the layer's graph constant once at
    staging). The step is held by its update, p_after - p_before, at
    ``tol[2]``: Adam's first step moves each parameter by about
    lr = 1e-2, so a step left out fails by a hundred times the limit."""
    net, jnet = _nets(JDense(nOut=8), TDense(nOut=8), data_type)
    assert set(net.params_["0"]) == {"W", "b"}
    before = {k: {n: _host(v) for n, v in lp.items()}
              for k, lp in net.params_.items()}
    x, y = _toy()
    np.testing.assert_allclose(_host(net.output(x)),
                               _host(jnet.output(x)), rtol=tol[0],
                               atol=tol[1])
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    assert net.score() == pytest.approx(jnet.score(), rel=tol[0] * 10)
    for k, lp in net.params_.items():
        for n, v in lp.items():
            ref = np.asarray(jnet.params_[k][n], dtype=np.float32)
            assert np.abs(ref - before[k][n]).min() > 5e-3, f"{k}/{n}"
            np.testing.assert_allclose(_host(v) - before[k][n],
                                       ref - before[k][n], rtol=0,
                                       atol=tol[2], err_msg=f"{k}/{n}")
    if data_type == "FLOAT":
        _params_close(net, jnet, STEP_RTOL, 1e-6)


def test_bfloat16_layer_stages_once_per_device_and_dtype():
    """The staged graph is cached per (train, device, dtype): a BFLOAT16
    net's forward runs the bf16 staging, whose constant is bf16 (a
    float32 constant would promote the output)."""
    net, _ = _nets(JDense(nOut=4), TDense(nOut=4), "BFLOAT16")
    layer = net.conf.layers[0]
    x, y = _toy(4)
    net.output(x)
    net.fit(DataSet(x, y))
    keys = set(layer.__dict__["_staged_fns"])
    assert keys == {(False, torch.device("cpu"), torch.bfloat16),
                    (True, torch.device("cpu"), torch.bfloat16)}
    fn, name = layer.__dict__["_staged_fns"][(False, torch.device("cpu"),
                                              torch.bfloat16)]
    out = fn({"layerInput": torch.ones(2, 10, dtype=torch.bfloat16),
              "W": torch.ones(10, 4, dtype=torch.bfloat16),
              "b": torch.zeros(4, dtype=torch.bfloat16)}, {}, 0)[name]
    assert out.dtype == torch.bfloat16


def test_lambda_layer_matches_the_reference_and_trains():
    net, jnet = _nets(JSin(), TSin())
    x, y = _toy()
    np.testing.assert_allclose(_host(net.output(x)), _host(jnet.output(x)),
                               rtol=1e-5, atol=1e-6)
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    _params_close(net, jnet, STEP_RTOL, 1e-6)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_samediff_layer_zip_restores_in_the_other_package(direction,
                                                          tmp_path):
    net, jnet = _nets(JDense(nOut=6), TDense(nOut=6))
    x, y = _toy()
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    path = str(tmp_path / "sd.zip")
    if direction == "jax->port":
        JMS.writeModel(jnet, path, saveUpdater=True)
        back = TMS.restoreMultiLayerNetwork(path, device="cpu")
        ref = _host(jnet.output(x))
    else:
        TMS.writeModel(net, path, saveUpdater=True)
        back = JMS.restoreMultiLayerNetwork(path)
        ref = _host(net.output(x))
    assert type(back.conf.layers[0]).__name__ == "UserDense"
    out = back.output(x)
    np.testing.assert_allclose(_host(out), ref, rtol=1e-5, atol=1e-6)


def test_samediff_layer_json_round_trip():
    ref = JDense(nOut=5).toJson()
    layer = tconf.layers.layer_from_json(json.loads(json.dumps(ref)))
    assert isinstance(layer, TDense) and layer.nOut == 5
    assert layer.toJson() == ref
    with pytest.raises(KeyError, match="not registered"):
        tconf.layers.layer_from_json({"@class": "NoSuchUserLayer"})


# ---------------------------------------------------------------------------
# SRGAN at the reference test's size
# ---------------------------------------------------------------------------
SR = dict(inputShape=(3, 12, 12), numResidualBlocks=2)


@pytest.fixture(scope="module")
def srgan_pair():
    """(port generator, the reference's carrying its parameters), shared
    by the module's generator tests (one compile of the reference's)."""
    net = tz.SRGAN(**SR).init(device="cpu")
    jnet = jmodels.ComputationGraph(jz.SRGAN(**SR).graphBuilder().build())
    jnet.init(params=jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                                  net.params_))
    return net, jnet


def _sr_batch():
    rng = np.random.RandomState(2)
    return (rng.rand(2, 3, 12, 12).astype(np.float32) * 2 - 1,
            rng.rand(2, 3, 48, 48).astype(np.float32) * 2 - 1)


def test_pixel_shuffle_is_depth_to_space_dcr():
    """PixelShuffleLayer is TF's depthToSpace (DCR: channel index
    (i·r + j)·c' + k), which ``F.pixel_shuffle`` (CRD) is not."""
    layer = tz.PixelShuffleLayer(blockSize=2)
    x = torch.arange(2 * 8 * 3 * 3, dtype=torch.float32).reshape(2, 8, 3, 3)
    y, _ = layer.forward({}, x, False, None, {})
    assert y.shape == (2, 2, 6, 6)
    assert torch.equal(y[:, :, 0, 1], x[:, 2:4, 0, 0])   # (i, j) = (0, 1)
    assert not torch.equal(y, torch.nn.functional.pixel_shuffle(x, 2))
    jl = jz.PixelShuffleLayer(blockSize=2)
    jy, _ = jl.forward({}, jax.numpy.asarray(x.numpy()), False, None, {})
    np.testing.assert_array_equal(np.asarray(jy), y.numpy())


def test_srgan_json_round_trip_and_zips_both_ways(srgan_pair, tmp_path):
    net, jnet = srgan_pair
    ref = jnet.conf.toJson()
    assert net.conf.toJson() == ref
    assert "PixelShuffleLayer" in ref
    loaded = type(net.conf).fromJson(ref)
    assert loaded.toJson() == ref
    lr, hr = _sr_batch()
    p_ref, p_port = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    JMS.writeModel(jnet, p_ref, saveUpdater=True)
    TMS.writeModel(net, p_port, saveUpdater=True)
    from_ref = TMS.restoreComputationGraph(p_ref, device="cpu")
    np.testing.assert_allclose(_host(from_ref.output(lr)),
                               _host(jnet.output(lr)), rtol=1e-5, atol=2e-6)
    from_port = JMS.restoreComputationGraph(p_port)
    np.testing.assert_allclose(_host(from_port.output(lr)),
                               _host(net.output(lr)), rtol=1e-5, atol=2e-6)
    again = TMS.restoreComputationGraph(p_port, device="cpu")
    np.testing.assert_array_equal(_host(again.output(lr)),
                                  _host(net.output(lr)))


def test_srgan_generator_matches_the_reference_and_steps(srgan_pair):
    net, jnet = srgan_pair
    lr, hr = _sr_batch()
    out = net.output(lr)
    assert tuple(out.shape) == (2, 3, 48, 48)
    np.testing.assert_allclose(_host(out), _host(jnet.output(lr)),
                               rtol=1e-5, atol=2e-6)
    net.fit(DataSet(lr, hr))
    jnet.fit(JDataSet(lr, hr))
    assert net.score() == pytest.approx(jnet.score(), rel=1e-5)
    # Adam's first step moves each parameter by about lr (1e-4) whatever
    # its gradient's size, so a gradient within float32 rounding of zero
    # moves the other way: every parameter within 2 lr, nearly all within
    # 2e-6
    d = np.concatenate([np.abs(_host(v) - np.asarray(jnet.params_[k][n]))
                        .ravel() for k, lp in net.params_.items()
                        for n, v in lp.items()])
    assert d.max() <= 2e-4 + 1e-6 and (d <= 2e-6).mean() >= 0.99


def test_srgan_discriminator_matches_the_reference_and_steps(monkeypatch):
    d = tz.SRGAN(**SR).initDiscriminator(device="cpu")
    with monkeypatch.context() as m:    # the configuration, nothing drawn
        m.setattr(jmodels.MultiLayerNetwork, "init",
                  lambda self, *a, **k: self)
        jd = jz.SRGAN(**SR).initDiscriminator()
    assert d.conf.toJson() == jd.conf.toJson()
    jd.init(params=jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                                d.params_))
    rng = np.random.RandomState(3)
    x = rng.rand(4, 3, 48, 48).astype(np.float32)
    y = np.array([[1.], [0.], [1.], [0.]], np.float32)
    np.testing.assert_allclose(_host(d.output(x)), _host(jd.output(x)),
                               rtol=1e-5, atol=1e-6)
    d.fit(DataSet(x, y))
    jd.fit(JDataSet(x, y))
    assert d.score() == pytest.approx(jd.score(), rel=1e-5)


# ---------------------------------------------------------------------------
# the reference's own SameDiffLayer tests, against the port
# ---------------------------------------------------------------------------
_, _REF = _reference_tests("test_samediff_layer.py")


@pytest.fixture
def on_cpu(monkeypatch):
    _cpu_default(monkeypatch)


@pytest.mark.parametrize("case", [c for _, c in _REF],
                         ids=[i for i, _ in _REF])
def test_reference_samediff_layer_suite(case, tmp_path, on_cpu):
    import inspect
    fn = getattr(case[0](), case[1]) if isinstance(case, tuple) else case
    fn(**{p: tmp_path for p in inspect.signature(fn).parameters})
