"""Port parity: the model zoo (``zoo/models.py``, ``models2.py``,
``models3.py``, ``models4.py``) against the JAX package.

- Every architecture this slice ports, at its default shape: the
  reference's configuration JSON loads in the port and is given back byte
  for byte, the port builds the same JSON itself, and every layer draws
  parameters of the reference's shapes (the reference's by
  ``jax.eval_shape`` of its own ``initParams``, so no full-width model is
  drawn by JAX), hence the same ``numParams()``;
- the full-width YOLO2's parameter count, 50,962,889, in both packages
  (init only);
- outputs of narrow YOLO2, TinyYOLO, UNet, SqueezeNet and
  FaceNetNN4Small2 from the same parameters (drawn by the port, carried
  into the reference by ``init(params=)``): float32 on both sides, 2e-5
  absolute and 1e-5 relative (the convolutions' summation order);
- one FLOAT fit step of the narrow YOLO2 at batch 8 (Adam 1e-3) held to
  the reference's.  The loss before the step (inference) holds to 1e-5
  relative and the step's (BatchNorm on batch statistics) to 5e-5
  (measured 6e-6).  The float32 gradient of the backbone flows back
  through 23 BatchNorm layers whose backward subtracts batch means over
  32 values a channel at the 2x2 grid; against the same gradient in
  float64 the port's float32 gradient is under 2 % off (relative L2 per
  weight tensor) and the reference's farther
  (``tests/test_torch_zoo_numerics.py``), so the two disagree in sign
  wherever a gradient lies within that noise.  Adam's first step moves a
  parameter by lr·g/(|g| + eps), lr·sign(g) for any |g| ≫ eps, so such a
  parameter moves 2·lr apart.  Hence: every parameter within 2·lr + 1e-6
  of the reference's, and 98 % of them within 1e-5 (measured 99.3 %); the
  BN running statistics (forward quantities) to 2e-5 absolute and 1e-5
  relative.
- FaceNetNN4Small2, which has no loss layer, steps with loss 0 and its
  parameters unchanged in both packages (BN running statistics as the
  YOLO2 step's);
- ``TwoTowerRecommender``, ``DLRM``, ``SRGAN`` and ``PixelShuffleLayer``
  raise naming their ROADMAP items.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.zoo as jz
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.zoo as tz
from deeplearning4j_tpu.nn.conf.layers import Layer as JLayer
from deeplearning4j_tpu_torch.models.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import Layer

from _torch_parity import _carried, _zoo_conf, _yolo_labels

pytestmark = pytest.mark.torch_port

PORTED = ["SimpleCNN", "AlexNet", "VGG16", "VGG19", "SqueezeNet",
          "Darknet19", "TinyYOLO", "UNet", "Xception", "InceptionResNetV1",
          "NASNet", "FaceNetNN4Small2", "TextGenerationLSTM", "C3D", "YOLO2"]
OUT_TOL = dict(atol=2e-5, rtol=1e-5)


def _layers(conf):
    """(key, layer, input type) of each layer, in the order ``init``
    draws them."""
    if hasattr(conf, "topoOrder"):
        return [(n, conf.nodes[n][0], conf.vertexInputTypes.get(n))
                for n in conf.topoOrder
                if isinstance(conf.nodes[n][0], (Layer, JLayer))]
    return [(str(i), l, conf.layerInputTypes[i])
            for i, l in enumerate(conf.layers)]


@pytest.mark.parametrize("name", PORTED)
def test_reference_config_loads_and_params_match(name, monkeypatch):
    jconf = _zoo_conf(getattr(jz, name)(), monkeypatch)
    ref = jconf.toJson()
    tconf = _zoo_conf(getattr(tz, name)(), monkeypatch)
    assert tconf.toJson() == ref
    loaded = (ComputationGraphConfiguration if hasattr(jconf, "topoOrder")
              else MultiLayerConfiguration).fromJson(ref)
    assert loaded.toJson() == ref

    key = jax.random.PRNGKey(0)
    ref_shapes, got_shapes = {}, {}
    for k, layer, it in _layers(jconf):
        p = jax.eval_shape(lambda r: layer.initParams(r, it, jnp.float32),
                           key)
        if p:
            ref_shapes[k] = {n: tuple(v.shape) for n, v in p.items()}
    gen = torch.Generator().manual_seed(0)
    for k, layer, it in _layers(loaded):
        p = layer.initParams(gen, it, torch.float32, "cpu")
        if p:
            got_shapes[k] = {n: tuple(v.shape) for n, v in p.items()}
        del p
    assert got_shapes == ref_shapes
    count = sum(int(np.prod(s)) for lp in got_shapes.values()
                for s in lp.values())
    assert count > 0


def test_full_width_yolo2_parameter_count():
    """YOLO2() as the reference builds it: 80 classes, (3, 416, 416), five
    COCO priors — the reference's numClasses=4 count plus 1025 x 380 for
    the 80-class head."""
    net = tz.YOLO2().init(device="cpu")
    jnet = jz.YOLO2().init()
    assert net.numParams() == jnet.numParams() == 50_962_889
    assert 50_573_389 + 1025 * 380 == 50_962_889
    assert {k: {n: tuple(v.shape) for n, v in lp.items()}
            for k, lp in net.params_.items()} == \
        {k: {n: tuple(v.shape) for n, v in lp.items()}
         for k, lp in jnet.params_.items()}


NARROW = [("YOLO2", dict(inputShape=(3, 64, 64), numClasses=4)),
          ("TinyYOLO", dict(inputShape=(3, 64, 64), numClasses=3)),
          ("UNet", dict(inputShape=(3, 32, 32))),
          ("SqueezeNet", dict(inputShape=(3, 64, 64), numClasses=5)),
          ("FaceNetNN4Small2", dict(inputShape=(3, 32, 32)))]


@pytest.mark.parametrize("name,kw", NARROW, ids=[n for n, _ in NARROW])
def test_narrow_zoo_outputs_match_the_reference(name, kw):
    net, jnet = _carried(name, kw)
    x = np.random.RandomState(1).randn(2, *kw["inputShape"]).astype(
        np.float32)
    out = net.output(x).numpy()
    ref = np.asarray(jnet.output(x).jax)
    np.testing.assert_allclose(out, ref, **OUT_TOL)
    if name == "FaceNetNN4Small2":
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0,
                                   atol=1e-4)


def test_narrow_yolo2_fit_step_matches_the_reference():
    lr = 1e-3                      # YOLO2's zoo updater, Adam(1e-3)
    net, jnet = _carried("YOLO2", dict(inputShape=(3, 64, 64),
                                       numClasses=4))
    rng = np.random.RandomState(2)
    x = rng.randn(8, 3, 64, 64).astype(np.float32)
    y = _yolo_labels(rng, 8, 4, 2)
    np.testing.assert_allclose(net.score(tds.DataSet(x, y)),
                               jnet.score(jds.DataSet(x, y)), rtol=1e-5)
    net.fit(tds.DataSet(x, y))
    jnet.fit(jds.DataSet(x, y))
    np.testing.assert_allclose(net.score(), jnet.score(), rtol=5e-5)
    d = np.abs(net.params().numpy() - np.asarray(jnet.params().jax))
    assert d.max() <= 2 * lr + 1e-6
    assert (d <= 1e-5).mean() >= 0.98
    for k, st in net.state_.items():
        for q in ("mean", "var"):
            np.testing.assert_allclose(st[q].numpy(),
                                       np.asarray(jnet.state_[k][q]),
                                       atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name,item", [("TwoTowerRecommender", "A11"),
                                       ("DLRM", "A11"), ("SRGAN", "A12b"),
                                       ("PixelShuffleLayer", "A12b")])
def test_unported_zoo_names_raise_naming_their_item(name, item):
    """A12b's names still raise naming it; A11's recommender models,
    ported, build as the reference's (``tests/test_torch_recsys.py``)."""
    cls = getattr(tz, name)
    if item == "A11":
        net = cls(numEmbeddings=64).init(device="cpu")
        assert net.params_["0"]["W"].shape[0] == 64
        assert cls.builder().numEmbeddings(32).build().numEmbeddings == 32
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cls()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cls.builder()


def test_facenet_without_a_loss_layer_steps_like_the_reference():
    """FaceNetNN4Small2 ends in an L2NormalizeVertex, no loss layer: a fit
    step has loss 0 and zero gradients, so Adam leaves every parameter and
    only BatchNormalization's running statistics move, in both packages."""
    kw = dict(inputShape=(3, 64, 64))   # 2x2 at inception 5b, so its BN
    net, jnet = _carried("FaceNetNN4Small2", kw)   # sees 16 values
    p0 = net.params().torch.clone()
    x = np.random.RandomState(6).randn(4, 3, 64, 64).astype(np.float32)
    y = np.zeros((4, 128), np.float32)
    net.fit(tds.DataSet(x, y))
    jnet.fit(jds.DataSet(x, y))
    assert net.score() == jnet.score() == 0.0
    assert torch.equal(net.params().torch, p0)
    np.testing.assert_array_equal(np.asarray(jnet.params().jax), p0.numpy())
    for k, st in net.state_.items():
        np.testing.assert_allclose(st["mean"].numpy(),
                                   np.asarray(jnet.state_[k]["mean"]),
                                   atol=2e-5, rtol=1e-5)
