"""Port parity: ``ModelSerializer`` (``deeplearning4j_tpu_torch/utils``)
against the JAX package's — a zip written by either package restores in
the other.

For LeNet (``MultiLayerNetwork``, Adam) and the narrow ResNet
(``ComputationGraph``, Nesterovs, BatchNormalization state), trained a
few steps in one package and restored in the other: the parameters, the
layer state, the updater state and the counters are bit-identical, and
the restored net written again gives the same ``coefficients.bin`` and
``updaterState.bin`` bytes.  The outputs are computed by two libraries
(atol 1e-5).  One more ``fit`` step from the restored net matches the
source package's step: the loss to 1e-5, and the parameters as a FLOAT
step is held in ``chip_smoke.py`` — 99.9 % within 1e-6 and every one
within 2 lr + 1e-6 (Adam moves a parameter whose gradient is a near-zero
sum by a fraction of lr whatever the sum's rounding).
"""
import io
import zipfile

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.learning as tlearn
from deeplearning4j_tpu.utils import ModelSerializer as JMS
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch.utils import ModelSerializer as TMS
from deeplearning4j_tpu_torch.zoo import LeNet as TLeNet

from _torch_parity import (JAX, PORT, NARROW_BATCH, NARROW_CLASSES,
                           _carried, _narrow, _narrow_yolo2, _np,
                           _yolo_labels)

pytestmark = pytest.mark.torch_port

OUT_ATOL = 1e-5
LOSS_ATOL = 1e-5


def _tree(tree, prefix=""):
    """{path: numpy array} over a nested dict of either package."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def _assert_bit_equal(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _entries(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _lenet_pair():
    jnet = JLeNet().init()
    net = TLeNet().init(device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    rng = np.random.RandomState(21)
    batches = [(rng.rand(8, 784).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
               for _ in range(3)]
    return jnet, net, batches, 1e-3


def _resnet_pair():
    jg = JAX.models.ComputationGraph(_narrow(JAX, "FLOAT")).init()
    g = PORT.models.ComputationGraph(_narrow(PORT, "FLOAT"),
                                     device="cpu").init(
        params=jax.tree.map(np.array, jg.params_))
    rng = np.random.RandomState(22)
    batches = [(rng.randn(NARROW_BATCH, 3, 16, 16).astype(np.float32),
                np.eye(NARROW_CLASSES, dtype=np.float32)[
                    rng.randint(0, NARROW_CLASSES, NARROW_BATCH)])
               for _ in range(3)]
    return jg, g, batches, 0.1


def _host(a):
    """A port tensor or a JAX package NDArray as numpy."""
    return np.asarray(a.jax) if hasattr(a, "jax") else _np(a)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("model", ["lenet", "narrow_resnet"])
def test_zip_restores_in_the_other_package(model, direction, tmp_path):
    jnet, net, batches, lr = (_lenet_pair if model == "lenet"
                              else _resnet_pair)()
    graph = model == "narrow_resnet"
    if direction == "jax->port":
        src, ds_mod, ms_src = jnet, jds, JMS
        restore = (TMS.restoreComputationGraph if graph
                   else TMS.restoreMultiLayerNetwork)
        kw, other_ds = dict(device="cpu"), tds
    else:
        src, ds_mod, ms_src = net, tds, TMS
        restore = (JMS.restoreComputationGraph if graph
                   else JMS.restoreMultiLayerNetwork)
        kw, other_ds = {}, jds
    for f, l in batches[:2]:
        src.fit(ds_mod.DataSet(f, l))
    norm = ds_mod.NormalizerStandardize()
    norm.fit(ds_mod.DataSet(*batches[0]))
    path = str(tmp_path / "model.zip")
    ms_src.writeModel(src, path, saveUpdater=True, normalizer=norm)

    back = restore(path, **kw)
    assert type(back).__name__ == type(src).__name__
    assert (back.iterationCount, back.epochCount) == (2, 0)
    assert back.conf.toJson() == src.conf.toJson()
    _assert_bit_equal(back.params_, src.params_)
    _assert_bit_equal(back.state_, src.state_)
    _assert_bit_equal(back.optState_, src.optState_)
    if graph:
        assert _tree(back.state_) and any(
            not np.all(v == 0) for k, v in _tree(back.state_).items()
            if k.endswith("mean"))
    nback = (TMS if direction == "jax->port" else JMS).restoreNormalizer(path)
    np.testing.assert_array_equal(nback.mean, norm.mean)
    np.testing.assert_array_equal(nback.std, norm.std)

    # written again from the restored net: the same flat bytes
    again = str(tmp_path / "again.zip")
    (TMS if direction == "jax->port" else JMS).writeModel(back, again)
    a, b = _entries(path), _entries(again)
    assert sorted(set(a) - {"normalizer.npz"}) == sorted(b)
    for name in ("configuration.json", "coefficients.bin",
                 "updaterState.bin"):
        assert a[name] == b[name], name

    f, l = batches[2]
    np.testing.assert_allclose(_host(back.output(f)), _host(src.output(f)),
                               atol=OUT_ATOL, rtol=0)
    src.fit(ds_mod.DataSet(f, l))
    back.fit(other_ds.DataSet(f, l))
    assert abs(back.score() - src.score()) <= LOSS_ATOL
    diff = np.abs(_host(back.params()) - _host(src.params()))
    assert np.mean(diff <= 1e-6) >= 0.999, np.quantile(diff, 0.999)
    assert diff.max() <= 2 * lr + 1e-6, diff.max()


def _tiny_conf(pkg, updater):
    L = pkg.layers
    return (pkg.conf.NeuralNetConfiguration.builder().seed(4)
            .updater(updater).list()
            .layer(L.DenseLayer.builder().nIn(3).nOut(5).activation("tanh")
                   .build())
            .layer(L.OutputLayer.builder("mse").nIn(5).nOut(2)
                   .activation("identity").build())
            .build())


_UPDATERS = {
    "Adam": lambda m: m.Adam(1e-2),
    "Nesterovs": lambda m: m.Nesterovs(0.05, momentum=0.9),
    "Adam+schedule": lambda m: m.Adam(
        learningRateSchedule=m.ExponentialSchedule(
            m.ScheduleType.ITERATION, 0.05, 0.9)),
}


@pytest.mark.parametrize("name", sorted(_UPDATERS))
def test_updater_state_keys_are_the_reference_keys(name, tmp_path):
    """The port's ``optState_`` flattens to the reference's
    ``arrays.npz`` keys: a JAX-written zip restored in the port and
    written again holds the same keys and the same arrays."""
    jnet = JAX.models.MultiLayerNetwork(
        _tiny_conf(JAX, _UPDATERS[name](jlearn))).init()
    rng = np.random.RandomState(3)
    for _ in range(3):
        jnet.fit(jds.DataSet(rng.randn(6, 3).astype(np.float32),
                             rng.randn(6, 2).astype(np.float32)))
    src, again = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    JMS.writeModel(jnet, src)
    net = TMS.restoreMultiLayerNetwork(src, device="cpu")
    assert net.conf.toJson() == jnet.conf.toJson()
    TMS.writeModel(net, again)
    with np.load(io.BytesIO(_entries(src)["arrays.npz"])) as a, \
            np.load(io.BytesIO(_entries(again)["arrays.npz"])) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("updater/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # and the next step follows the reference's (the schedule reads the
    # restored iteration count)
    f = rng.randn(6, 3).astype(np.float32)
    l = rng.randn(6, 2).astype(np.float32)
    jnet.fit(jds.DataSet(f, l))
    net.fit(tds.DataSet(f, l))
    np.testing.assert_allclose(_host(net.params()), _host(jnet.params()),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_normalizer_in_the_zip_both_ways(kind, direction, tmp_path):
    rng = np.random.RandomState(9)
    f = (rng.rand(10, 3) * 255).astype(np.float32)
    l = rng.randn(10, 2).astype(np.float32)
    w_mod, r_ms = (jds, TMS) if direction == "jax->port" else (tds, JMS)
    w_ms = JMS if direction == "jax->port" else TMS
    args = (-1.0, 1.0) if kind == "NormalizerMinMaxScaler" \
        else (0.0, 2.0, 200.0)
    norm = getattr(w_mod, kind)(*args)
    norm.fit(w_mod.DataSet(f, l))
    pkg = JAX if direction == "jax->port" else PORT
    net = pkg.models.MultiLayerNetwork(
        _tiny_conf(pkg, pkg.learn.Sgd(0.1)),
        **({} if pkg is JAX else {"device": "cpu"})).init()
    path = str(tmp_path / "n.zip")
    w_ms.writeModel(net, path, normalizer=norm)
    back = r_ms.restoreNormalizer(path)
    assert type(back).__name__ == kind
    assert (back.minRange, back.maxRange) == (norm.minRange, norm.maxRange)
    if kind == "NormalizerMinMaxScaler":
        np.testing.assert_array_equal(back.dataMin, norm.dataMin)
        np.testing.assert_array_equal(back.dataMax, norm.dataMax)
    else:
        assert back.maxPixelVal == norm.maxPixelVal


def test_zip_without_updater_restores_fresh_state(tmp_path):
    net = TLeNet().init(device="cpu")
    path = str(tmp_path / "m.zip")
    TMS.writeModel(net, path, saveUpdater=False)
    assert "updaterState.bin" not in _entries(path)
    back = TMS.restoreMultiLayerNetwork(path, device="cpu")
    _assert_bit_equal(back.params_, net.params_)
    assert all(not np.any(v) for v in _tree(back.optState_).values())
    jback = JMS.restoreMultiLayerNetwork(path)
    _assert_bit_equal(jback.params_, net.params_)


def _zoo_pair(model):
    """(reference net, port net, batches): the narrow YOLO2 (built as
    ``YOLO2`` builds it, at a 16th of its widths over 32x32) or the zoo's
    ``UNet`` at 32x32, the same parameters in both."""
    if model == "narrow_yolo2":
        jnet = JAX.models.ComputationGraph(_narrow_yolo2(JAX))
        jnet.init()
        net = PORT.models.ComputationGraph(_narrow_yolo2(PORT),
                                           device="cpu").init(
            params=jax.tree.map(np.array, jnet.params_))
        rng = np.random.RandomState(31)
        batches = [(rng.randn(2, 3, 32, 32).astype(np.float32),
                    _yolo_labels(rng, 2, 3, 2)) for _ in range(2)]
        return jnet, net, batches
    net, jnet = _carried("UNet", dict(inputShape=(3, 32, 32)))
    rng = np.random.RandomState(32)
    batches = [(rng.randn(2, 3, 32, 32).astype(np.float32),
                (rng.rand(2, 1, 32, 32) > 0.5).astype(np.float32))
               for _ in range(2)]
    return jnet, net, batches


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("model", ["narrow_yolo2", "unet"])
def test_zoo_zip_restores_in_the_other_package(model, direction, tmp_path):
    """A zip of the narrow YOLO2 or of UNet, written by either package after
    a step, restores in the other: parameters, BN state and updater state
    bit for bit, outputs equal (atol 1e-5).  The restored net scores as
    the source does, except where ROADMAP C16 stops it: the reference reads
    a YOLO zip's ``boundingBoxes`` back as a string and cannot score."""
    jnet, net, batches = _zoo_pair(model)
    f, l = batches[0]
    if direction == "jax->port":
        src, ms_src, ds_src, ds_back = jnet, JMS, jds, tds
        restore, kw = TMS.restoreComputationGraph, dict(device="cpu")
    else:
        src, ms_src, ds_src, ds_back = net, TMS, tds, jds
        restore, kw = JMS.restoreComputationGraph, {}
    src.fit(ds_src.DataSet(f, l))
    path = str(tmp_path / f"{model}.zip")
    ms_src.writeModel(src, path, saveUpdater=True)
    back = restore(path, **kw)
    assert back.conf.toJson() == src.conf.toJson()
    _assert_bit_equal(back.params_, src.params_)
    _assert_bit_equal(back.state_, src.state_)
    _assert_bit_equal(back.optState_, src.optState_)
    f2, l2 = batches[1]
    np.testing.assert_allclose(_host(back.output(f2)), _host(src.output(f2)),
                               atol=OUT_ATOL, rtol=0)
    if model == "narrow_yolo2" and direction == "port->jax":
        with pytest.raises(ValueError,
                           match="could not convert string to float"):
            back.score(ds_back.DataSet(f2, l2))          # ROADMAP C16
        return
    np.testing.assert_allclose(back.score(ds_back.DataSet(f2, l2)),
                               src.score(ds_src.DataSet(f2, l2)), rtol=1e-5)
