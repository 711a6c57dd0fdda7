"""Port parity: the zoo's pretrained loader (``zoo/pretrained.py``,
``ZooModel.initPretrained``) against the JAX package, and ROADMAP C16.

- A zip written by the reference's ``ModelSerializer`` into the local
  weight repository (``$DL4J_TPU_DATA_DIR/pretrained/<Model>_<TYPE>.zip``)
  restores through the port's ``initPretrained(device="cpu")`` bit for
  bit, for a ComputationGraph (SqueezeNet) and a MultiLayerNetwork
  (SimpleCNN), both at 32x32; a zip the port wrote restores with its
  updater state and counters (the full-width YOLO2 takes this route on the
  card, in ``chip_smoke.py``);
- with no checkpoint the message names the model, the type and the
  directory, as the reference's; ``path=`` wins over the repository;
- ``transplant`` pairs layers as the reference's (positional and
  scanning), copying parameters and BatchNormalization state;
- an ``.h5`` checkpoint goes through the Keras importer (ROADMAP A12d,
  ported): an empty file is refused by its HDF5 reader, and a VGG16 saved
  by keras transplants into the zoo's VGG16 as in the reference's
  ``tests/test_pretrained.py``;
- C16: a YOLO zip restored by the reference holds ``boundingBoxes`` as a
  string, so the reference's restored net cannot score
  (``ValueError``); the port's restored net parses it and scores as the
  saved net did (1e-5 relative; float32 on both sides).
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.zoo as jz
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.zoo as tz
from deeplearning4j_tpu.utils import ModelSerializer as JMS
from deeplearning4j_tpu.zoo.pretrained import transplant as jtransplant
from deeplearning4j_tpu_torch.utils import ModelSerializer as TMS

from _torch_parity import JAX, _carried, _np, _yolo_labels

pytestmark = pytest.mark.torch_port

GRAPH = ("SqueezeNet", dict(inputShape=(3, 32, 32), numClasses=3))
MLN = ("SimpleCNN", dict(inputShape=(3, 32, 32), numClasses=3))


@pytest.fixture
def repo_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    d = tmp_path / "pretrained"
    d.mkdir()
    return d


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("name,kw", [GRAPH, MLN], ids=["graph", "mln"])
def test_reference_zip_restores_through_init_pretrained(name, kw, repo_dir):
    _, jnet = _carried(name, kw)
    JMS.writeModel(jnet, str(repo_dir / f"{name}_IMAGENET.zip"))
    net = getattr(tz, name)(**kw).initPretrained(device="cpu")
    assert type(net).__name__ == type(jnet).__name__
    assert net.device == torch.device("cpu")
    _assert_bit_equal(net.params_, jnet.params_)
    _assert_bit_equal(net.state_, jnet.state_)
    x = np.random.RandomState(3).randn(2, *kw["inputShape"]).astype(
        np.float32)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x).jax), atol=2e-5,
                               rtol=1e-5)


def test_port_zip_restores_through_init_pretrained(repo_dir):
    name, kw = GRAPH
    net, _ = _carried(name, kw)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    net.fit(tds.DataSet(x, np.eye(3, dtype=np.float32)[[0, 2]]))
    TMS.writeModel(net, str(repo_dir / f"{name}_CUSTOM.zip"))
    got = tz.SqueezeNet(**kw).initPretrained("custom", device="cpu")
    _assert_bit_equal(got.params_, net.params_)
    _assert_bit_equal(got.state_, net.state_)
    _assert_bit_equal(got.optState_, net.optState_)
    assert got.iterationCount == net.iterationCount == 1


def test_missing_checkpoint_names_the_model_type_and_directory(repo_dir):
    for pkg in (jz, tz):
        with pytest.raises(RuntimeError) as e:
            pkg.YOLO2().initPretrained("COCO")
        msg = str(e.value)
        assert "YOLO2: no pretrained checkpoint for type 'COCO'" in msg
        assert "YOLO2_COCO.zip" in msg and str(repo_dir) in msg
    assert tz.resolvePretrained("YOLO2", "coco") is None
    assert tz.weightsDir() == str(repo_dir)


def test_path_wins_and_zip_comes_before_h5(repo_dir, tmp_path):
    net, _ = _carried(*MLN)
    elsewhere = tmp_path / "elsewhere.zip"
    TMS.writeModel(net, str(elsewhere))
    (repo_dir / "SimpleCNN_IMAGENET.h5").write_bytes(b"")
    got = tz.SimpleCNN(**MLN[1]).initPretrained(path=str(elsewhere),
                                                device="cpu")
    _assert_bit_equal(got.params_, net.params_)
    TMS.writeModel(net, str(repo_dir / "SimpleCNN_IMAGENET.zip"))
    assert tz.resolvePretrained("SimpleCNN", "imagenet").endswith(".zip")


def test_h5_checkpoint_needs_the_keras_importer(repo_dir):
    (repo_dir / "YOLO2_IMAGENET.h5").write_bytes(b"")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        tz.YOLO2().initPretrained(device="cpu")
    with pytest.raises(ValueError, match="Unsupported pretrained"):
        tz.YOLO2().initPretrained(path=str(repo_dir / "x.bin"),
                                  device="cpu")


@pytest.mark.parametrize("src_spec,dst_spec", [
    (("SimpleCNN", 4), ("SimpleCNN", 4)),       # positional, every layer
    (("SimpleCNN", 4), ("SimpleCNN", 6)),       # positional, not the head
    (("TinyYOLO", 3), ("SimpleCNN", 3))],       # counts differ: the scan
    ids=["positional", "head_mismatch", "scan"])
def test_transplant_pairs_layers_as_the_reference(src_spec, dst_spec):
    """Both packages load the same layers from the same source and copy
    the same values (parameters and BN running statistics); ``strict``
    refuses in both where a layer finds no match."""
    (sname, sc), (dname, dc) = src_spec, dst_spec
    src, jsrc = _carried(sname, dict(inputShape=(3, 32, 32), numClasses=sc))
    dst, jdst = _carried(dname, dict(inputShape=(3, 32, 32), numClasses=dc))
    for st in src.state_.values():
        st["mean"] += 0.5
    jsrc.state_ = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                               src.state_)
    loaded = tz.transplant(src, dst)
    assert loaded == jtransplant(jsrc, jdst) and loaded
    for k in loaded:
        _assert_bit_equal(dst.params_[k], jdst.params_[k])
        if k in dst.state_:
            _assert_bit_equal(dst.state_[k], jdst.state_[k])
    complete = len(loaded) == len(dst.params_)
    for fn, s_, d_ in ((tz.transplant, src, dst),
                       (jtransplant, jsrc, jdst)):
        if complete:
            assert fn(s_, d_, strict=True) == loaded
        else:
            with pytest.raises(ValueError):
                fn(s_, d_, strict=True)


def _yolo_mln(pkg):
    """A conv and a Yolo2OutputLayer with three priors over 2 classes."""
    from importlib import import_module
    conv = import_module(pkg.layers.__name__.rsplit(".", 1)[0]
                         + ".convolutional")
    return (pkg.conf.NeuralNetConfiguration.builder().seed(2)
            .updater(pkg.learn.Adam(1e-3)).list()
            .layer(pkg.layers.ConvolutionLayer.builder().nOut(3 * 7)
                   .kernelSize(3, 3).convolutionMode("Same").build())
            .layer(conv.Yolo2OutputLayer.builder().boundingBoxes(
                np.asarray(((1.08, 1.19), (3.42, 4.41), (6.63, 11.38))))
                .build())
            .setInputType(pkg.conf.InputType.convolutional(4, 4, 2))
            .build())


def test_c16_reference_cannot_score_a_restored_yolo_the_port_can(tmp_path):
    """ROADMAP C16, kept in the reference and departed from on purpose in
    the port: the reference writes ``boundingBoxes`` as numpy's str and
    reads the string back as it is, so its restored YOLO's score raises;
    the port's parses the string and scores as the saved net did."""
    jnet = JAX.models.MultiLayerNetwork(_yolo_mln(JAX))
    jnet.init()
    rng = np.random.RandomState(5)
    x = rng.randn(3, 2, 4, 4).astype(np.float32)
    y = _yolo_labels(rng, 3, 2, 4)
    before = jnet.score(jds.DataSet(x, y))
    path = str(tmp_path / "yolo.zip")
    JMS.writeModel(jnet, path)
    restored = JMS.restoreMultiLayerNetwork(path)
    assert isinstance(restored.conf.layers[-1].boundingBoxes, str)
    with pytest.raises(ValueError, match="could not convert string to float"):
        restored.score(jds.DataSet(x, y))
    port = TMS.restoreMultiLayerNetwork(path, device="cpu")
    assert isinstance(port.conf.layers[-1].boundingBoxes, str)
    np.testing.assert_allclose(port.score(tds.DataSet(x, y)), before,
                               rtol=1e-5)
    assert port.conf.toJson() == restored.conf.toJson()


def _keras_vgg16_32(numClasses=10):
    """The reference test's Keras model: VGG16's topology at 32x32."""
    keras = pytest.importorskip("keras")
    L = keras.layers
    m = keras.Sequential([L.Input(shape=(32, 32, 3))])
    for n, reps in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(reps):
            m.add(L.Conv2D(n, 3, padding="same", activation="relu"))
        m.add(L.MaxPooling2D(2, 2))
    m.add(L.Flatten())
    m.add(L.Dense(4096, activation="relu"))
    m.add(L.Dense(4096, activation="relu"))
    m.add(L.Dense(numClasses, activation="softmax"))
    return m


def test_vgg16_h5_transplant_classifies_as_the_reference(repo_dir):
    """``tests/test_pretrained.py``'s h5 route: ``VGG16().initPretrained()``
    finds ``VGG16_IMAGENET.h5`` in the repository, the Keras importer reads
    it and ``transplant`` moves its weights into the zoo's VGG16; the zoo
    net classifies as keras and as the reference's does."""
    keras_model = _keras_vgg16_32()
    keras_model.save(str(repo_dir / "VGG16_IMAGENET.h5"))
    net = tz.VGG16(inputShape=(3, 32, 32), numClasses=10).initPretrained(
        device="cpu")
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(keras_model(x))
    xin = np.transpose(x, (0, 3, 1, 2))
    ours = net.output(xin).numpy()
    np.testing.assert_allclose(ours, want, atol=1e-3, rtol=1e-3)
    assert (ours.argmax(1) == want.argmax(1)).all()
    ref = jz.VGG16(inputShape=(3, 32, 32), numClasses=10).initPretrained()
    np.testing.assert_allclose(ours, np.asarray(ref.output(xin).numpy()),
                               atol=1e-5, rtol=1e-4)
