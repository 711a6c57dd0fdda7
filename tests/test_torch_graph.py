"""Port parity: the ResNet-50 slice — the CNN layers, ``Nesterovs``, the
graph configuration (vertices, topological order, JSON),
``ComputationGraph`` and the zoo's ``ResNet50`` — against the JAX package.

Parameters are drawn by the JAX graph and copied into the port
(``init(params=)``): the two RNGs never agree.  Inputs and labels come from
a seeded numpy RandomState.

Tolerances, each from what the check shows:

- FLOAT: both compute in float32 and differ by summation order (the convs'
  above all), so activations hold to 1e-5 of their scale, losses of ~1 to
  2e-5 and, after Nesterovs steps at lr 0.1 (a step moves a parameter by
  0.19 x its gradient), parameters, BN running statistics and the momentum
  buffers to 2e-5 (measured ≤ 5e-6 over 5 steps);
- BFLOAT16: both round to bf16 at every layer; the forward agrees bit for
  bit up to the softmax, the backward rounds its gradients at other points,
  and lr 0.1 with momentum 0.9 amplifies that over the steps on BN batches
  of 16 values.  The test holds the port's bf16 run to the reference's
  bf16 run no farther than the reference's own bf16 run is from its
  float32 run: that distance is what bf16 training noise is on this graph
  (measured: the port's distance is 0.7-0.8 of it after one step and at
  most 0.8 of its largest value over the 5-step loss curve).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.models as jmodels
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.models as tmodels
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.models import graph_conf as jgc
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.models import graph_conf as tgc
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.zoo import ResNet50 as TResNet50

from _torch_parity import (JAX, NARROW_BATCH, NARROW_CLASSES, PORT,
                           _flat_state, _narrow)

pytestmark = pytest.mark.torch_port

F32 = dict(act=1e-5, loss=2e-5, params=2e-5)
BF16_LOSS = 4 * 2.0 ** -7     # four bf16 ulps of a probability, via -log


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# CNN layers: SAME padding, pooling, batch norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [9, 10, 15, 16])
@pytest.mark.parametrize("k,s", [(7, 2), (3, 1), (3, 2), (1, 2), (2, 2)])
def test_same_convolution_matches_reference(size, k, s):
    """``ConvolutionMode.Same`` pads as lax's SAME: the extra pixel of an
    odd total at the end (the stem's 7x7 stride 2 at 224 pads (2, 3))."""
    rng = np.random.RandomState(size * 10 + k)
    x = rng.randn(2, 3, size, size).astype(np.float32)
    p = {"W": rng.randn(5, 3, k, k).astype(np.float32) * 0.3,
         "b": rng.randn(5).astype(np.float32)}
    kw = dict(nIn=3, nOut=5, kernelSize=(k, k), stride=(s, s),
              convolutionMode="Same", activation="relu")
    ref, _ = jlayers.ConvolutionLayer(**kw).forward(p, x, False, None, {})
    out, _ = tlayers.ConvolutionLayer(**kw).forward(
        {n: _t(v) for n, v in p.items()}, _t(x), False, None, {})
    assert tuple(out.shape) == ref.shape == (2, 5, -(-size // s),
                                              -(-size // s))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32["act"],
                               rtol=0)


@pytest.mark.parametrize("mode,padding,dilation", [
    ("Truncate", (0, 0), (1, 1)), ("Truncate", (2, 1), (1, 1)),
    ("Strict", (1, 1), (2, 2)), ("Same", (0, 0), (2, 1))])
def test_truncate_and_dilated_convolution_match_reference(mode, padding,
                                                          dilation):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 11, 12).astype(np.float32)
    p = {"W": rng.randn(3, 4, 3, 3).astype(np.float32) * 0.3}
    kw = dict(nIn=4, nOut=3, kernelSize=3, stride=(2, 1), padding=padding,
              dilation=dilation, convolutionMode=mode, hasBias=False)
    jl, tl = jlayers.ConvolutionLayer(**kw), tlayers.ConvolutionLayer(**kw)
    ref, _ = jl.forward(p, x, False, None, {})
    out, _ = tl.forward({"W": _t(p["W"])}, _t(x), False, None, {})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32["act"],
                               rtol=0)
    it = jconf.InputType.convolutional(11, 12, 4)
    assert tl.getOutputType(tconf.InputType.convolutional(11, 12, 4)) \
        .toJson() == jl.getOutputType(it).toJson()
    assert tuple(out.shape[2:]) == ref.shape[2:]


@pytest.mark.parametrize("size", [7, 8, 111, 112])
@pytest.mark.parametrize("pool", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("mode", ["Same", "Truncate"])
def test_pooling_matches_reference(size, pool, mode):
    """MAX pads with -inf (the stem's 3x3 stride-2 pool at 112 pads (0, 1));
    AVG divides border windows by their count of valid cells."""
    rng = np.random.RandomState(size)
    x = rng.randn(2, 3, size, size).astype(np.float32)
    kw = dict(poolingType=pool, kernelSize=(3, 3), stride=(2, 2),
              convolutionMode=mode, padding=(1, 1), pnorm=3)
    jl, tl = jlayers.SubsamplingLayer(**kw), tlayers.SubsamplingLayer(**kw)
    ref, _ = jl.forward({}, x, False, None, {})
    out, _ = tl.forward({}, _t(x), False, None, {})
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-6)
    it = tconf.InputType.convolutional(size, size, 3)
    assert tl.getOutputType(it).toJson() == jl.getOutputType(
        jconf.InputType.convolutional(size, size, 3)).toJson()


def test_avg_pool_with_pad_in_divisor_matches_reference():
    x = np.random.RandomState(2).randn(1, 2, 9, 9).astype(np.float32)
    kw = dict(poolingType="AVG", kernelSize=(3, 3), stride=(2, 2),
              convolutionMode="Same", avgPoolIncludePadInDivisor=True)
    ref, _ = jlayers.SubsamplingLayer(**kw).forward({}, x, False, None, {})
    out, _ = tlayers.SubsamplingLayer(**kw).forward({}, _t(x), False, None,
                                                    {})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("cnn", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_reference(cnn, train, dtype):
    """The DL4J running average, the biased f32 variance, and under bf16
    the batch moments rounded to bf16 while the state stays float32."""
    rng = np.random.RandomState(3)
    shape = (4, 3, 5, 6) if cnn else (6, 3)
    x = (rng.randn(*shape) * 2 + 1.5).astype(np.float32)
    p = {"gamma": rng.rand(3).astype(np.float32) + 0.5,
         "beta": rng.randn(3).astype(np.float32)}
    st = {"mean": rng.randn(3).astype(np.float32),
          "var": rng.rand(3).astype(np.float32) + 0.5}
    kw = dict(nIn=3, nOut=3, decay=0.8, activation="relu")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref, rst = jlayers.BatchNormalization(**kw).forward(
        {k: jnp.asarray(v, jdt) for k, v in p.items()},
        jnp.asarray(x, jdt), train, None,
        {k: jnp.asarray(v) for k, v in st.items()})
    out, ost = tlayers.BatchNormalization(**kw).forward(
        {k: _t(v).to(tdt) for k, v in p.items()}, _t(x).to(tdt), train,
        None, {k: _t(v) for k, v in st.items()})
    assert out.dtype == tdt and ost["mean"].dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * 4   # one bf16 ulp
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ost[k].numpy(), np.asarray(rst[k]),
                                   atol=1e-6, rtol=1e-6)


def test_batch_norm_state_and_params():
    it = tconf.InputType.convolutional(4, 4, 6)
    bn = tlayers.BatchNormalization()
    bn.inferNIn(it)
    assert (bn.nIn, bn.nOut) == (6, 6)
    st = bn.initState(it, device="cpu")
    assert torch.equal(st["mean"], torch.zeros(6)) and \
        torch.equal(st["var"], torch.ones(6))
    assert bn.weightParamKeys() == ()
    assert tlayers.BatchNormalization(nIn=2, lockGammaBeta=True).initParams(
        torch.Generator(), it, device="cpu") == {}


@pytest.mark.parametrize("pool", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("rnn,masked", [(False, False), (True, False),
                                        (True, True)])
@pytest.mark.parametrize("collapse", [True, False])
def test_global_pooling_matches_reference(pool, rnn, masked, collapse):
    rng = np.random.RandomState(4)
    x = rng.randn(*((3, 4, 7) if rnn else (3, 4, 5, 6))).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 7), np.float32)
        mask[1, 4:] = 0
    kw = dict(poolingType=pool, pnorm=3, collapseDimensions=collapse)
    ref, _ = jlayers.GlobalPoolingLayer(**kw).forward({}, x, False, None, {},
                                                      mask=mask)
    out, _ = tlayers.GlobalPoolingLayer(**kw).forward(
        {}, _t(x), False, None, {}, mask=None if mask is None else _t(mask))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)


def test_output_and_activation_layers_match_reference():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6).astype(np.float32)
    p = {"W": rng.randn(6, 3).astype(np.float32), "b": rng.randn(3)
         .astype(np.float32)}
    labels = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    for pkg, conv in ((JAX, jnp.asarray), (PORT, _t)):
        ol = pkg.layers.OutputLayer.builder("negativeloglikelihood") \
            .nIn(6).nOut(3).build()
        out, _ = ol.forward({k: conv(v) for k, v in p.items()}, conv(x),
                            False, None, {})
        score = ol.computeScore(conv(labels), out)
        act, _ = pkg.layers.ActivationLayer(activation="tanh").forward(
            {}, conv(x), False, None, {})
        if pkg is JAX:
            ref = (np.asarray(out), np.asarray(score), np.asarray(act))
        else:
            got = (out.numpy(), score.numpy(), act.numpy())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6)


_LAYERS = {
    "conv": lambda L: L.ConvolutionLayer.builder().nIn(3).nOut(8)
    .kernelSize(3, 3).stride(2, 2).convolutionMode("Same").hasBias(False)
    .dilation(1, 1).build(),
    "pool": lambda L: L.SubsamplingLayer.builder().poolingType("AVG")
    .kernelSize(3, 3).stride(1, 1).padding(1, 1).build(),
    "bn": lambda L: L.BatchNormalization.builder().decay(0.95)
    .activation("relu").build(),
    "act": lambda L: L.ActivationLayer.builder().activation("relu").build(),
    "gpool": lambda L: L.GlobalPoolingLayer.builder().poolingType("AVG")
    .build(),
    "out": lambda L: L.OutputLayer.builder("mcxent").nOut(4).build(),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_layer_json_matches_reference(name):
    jl, tl = _LAYERS[name](jlayers), _LAYERS[name](tlayers)
    assert json.dumps(tl.toJson()) == json.dumps(jl.toJson())
    back = tlayers.layer_from_json(json.loads(json.dumps(jl.toJson())))
    assert back == tl
    assert tlayers.Convolution2D is tlayers.ConvolutionLayer


# ---------------------------------------------------------------------------
# graph configuration: vertices, topological order, JSON
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["Add", "Subtract", "Product", "Average",
                                "Max", "Min"])
def test_element_wise_vertex_matches_reference(op):
    rng = np.random.RandomState(6)
    xs = [rng.randn(2, 3, 4).astype(np.float32) for _ in range(2 if op ==
                                                             "Subtract"
                                                             else 3)]
    ref = jgc.ElementWiseVertex(op).forward(*xs)
    out = tgc.ElementWiseVertex(op).forward(*[_t(x) for x in xs])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    assert tgc.ElementWiseVertex(op).toJson() == \
        jgc.ElementWiseVertex(op).toJson()


@pytest.mark.parametrize("kind", ["FF", "CNN", "RNN"])
def test_merge_vertex_matches_reference(kind):
    shapes = {"FF": [(2, 3), (2, 5)], "CNN": [(2, 3, 4, 4), (2, 2, 4, 4)],
              "RNN": [(2, 3, 6), (2, 4, 6)]}[kind]
    rng = np.random.RandomState(7)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    np.testing.assert_array_equal(
        tgc.MergeVertex().forward(*[_t(x) for x in xs]).numpy(),
        np.asarray(jgc.MergeVertex().forward(*xs)))
    its = {"FF": lambda m: [m.feedForward(3), m.feedForward(5)],
           "CNN": lambda m: [m.convolutional(4, 4, 3),
                             m.convolutional(4, 4, 2)],
           "RNN": lambda m: [m.recurrent(3, 6), m.recurrent(4, 6)]}[kind]
    assert tgc.MergeVertex().getOutputType(*its(tconf.InputType)).toJson() \
        == jgc.MergeVertex().getOutputType(*its(jconf.InputType)).toJson()


def _merge_graph(pkg):
    """Two inputs, a merge, two dense branches and two output layers: the
    sorted-ready topological order, automatic preprocessors and losses
    summed over outputs."""
    L = pkg.layers
    return (pkg.conf.NeuralNetConfiguration.builder().seed(11)
            .updater(pkg.learn.Sgd(0.1)).l2(1e-3).graphBuilder()
            .addInputs("in_b", "in_a")
            .setInputTypes(pkg.conf.InputType.feedForward(3),
                           pkg.conf.InputType.feedForward(2))
            .addVertex("merge", pkg.gc.MergeVertex(), "in_b", "in_a")
            .addLayer("z_dense", L.DenseLayer.builder().nOut(4)
                      .activation("tanh").build(), "merge")
            .addLayer("a_dense", L.DenseLayer.builder().nOut(4)
                      .activation("relu").build(), "merge")
            .addVertex("sum", pkg.gc.ElementWiseVertex("Add"), "z_dense",
                       "a_dense")
            .addLayer("out1", L.OutputLayer.builder("mse").nOut(2)
                      .activation("identity").build(), "sum")
            .addLayer("out0", L.OutputLayer.builder("mcxent").nOut(3)
                      .build(), "z_dense")
            .setOutputs("out0", "out1").build())


def test_graph_config_topological_order_and_json_match_reference():
    jc, tc = _merge_graph(JAX), _merge_graph(PORT)
    # ready vertices start sorted, then follow in the order they became
    # ready (each vertex's dependents in insertion order)
    assert tc.topoOrder == jc.topoOrder == [
        "merge", "z_dense", "a_dense", "out0", "sum", "out1"]
    assert tc.toJson() == jc.toJson()
    assert {k: v.toJson() for k, v in tc.vertexOutputTypes.items()} == \
        {k: v.toJson() for k, v in jc.vertexOutputTypes.items()}
    assert tgc.ComputationGraphConfiguration.fromJson(jc.toJson()).toJson() \
        == jc.toJson()


def test_graph_config_rejects_cycles_and_unknown_inputs():
    L = tlayers
    gb = tconf.NeuralNetConfiguration.builder().graphBuilder() \
        .addInputs("in").addLayer("a", L.DenseLayer(nIn=2, nOut=2), "b") \
        .addLayer("b", L.DenseLayer(nIn=2, nOut=2), "a")
    with pytest.raises(ValueError, match="cycle"):
        gb.build()
    gb = tconf.NeuralNetConfiguration.builder().graphBuilder() \
        .addInputs("in").addLayer("a", L.DenseLayer(nIn=2, nOut=2), "nope")
    with pytest.raises(ValueError, match="unknown input"):
        gb.build()


@pytest.mark.parametrize("dataType", ["FLOAT", "BFLOAT16"])
def test_resnet50_json_matches_reference_and_round_trips(dataType):
    js = JResNet50(dataType=dataType).graphBuilder().build().toJson()
    conf = TResNet50(dataType=dataType).graphBuilder().build()
    assert conf.toJson() == js
    back = tgc.ComputationGraphConfiguration.fromJson(js)
    assert back.toJson() == js and back.topoOrder == conf.topoOrder
    assert isinstance(back.globalConf["updater"], tlearn.Nesterovs)
    assert back.vertexOutputTypes["fc"].size == 1000
    stem = conf.nodes["stem_conv"][0]
    assert (stem.kernelSize, stem.stride, stem.hasBias) == ((7, 7), (2, 2),
                                                           False)
    assert conf.vertexOutputTypes["stem_pool"].toJson() == \
        tconf.InputType.convolutional(56, 56, 64).toJson()


# ---------------------------------------------------------------------------
# ResNet-50 at 32x32: parameters and the forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_small():
    """ResNet-50 at inputShape (3, 32, 32), 4 classes: the JAX graph and
    the port's graph on the CPU from copies of its params."""
    kw = dict(numClasses=4, inputShape=(3, 32, 32))
    jnet = JResNet50(**kw).init()
    params = jax.tree.map(np.array, jnet.params_)
    net = tmodels.ComputationGraph(TResNet50(**kw).graphBuilder().build(),
                                   device="cpu").init(params=params)
    return jnet, net


def test_resnet50_small_params_match_reference(resnet_small):
    jnet, net = resnet_small
    convs = [n for n, (node, _) in net.conf.nodes.items()
             if isinstance(node, tlayers.ConvolutionLayer)]
    assert len(convs) == 53
    assert net.numParams() == jnet.numParams() == 23_516_228
    np.testing.assert_array_equal(net.params().numpy(),
                                  np.asarray(jnet.params().jax))
    assert sorted(net.paramTable()) == sorted(jnet.paramTable())
    assert net.getNumLayers() == jnet.getNumLayers()
    assert net.summary() .splitlines()[-1] == "Total params: 23516228"
    assert set(net.state_) == set(jnet.state_)
    assert all(torch.equal(s["var"], torch.ones_like(s["var"]))
               for s in net.state_.values())


def test_resnet50_small_forward_matches_reference(resnet_small):
    """Batch 2.  The inference forward through all 16 bottlenecks, every
    vertex's activation against the reference's (BN on the initial running
    statistics leaves the scale growing through the residual adds, so each
    activation is compared relative to its largest value)."""
    jnet, net = resnet_small
    x = np.random.RandomState(8).randn(2, 3, 32, 32).astype(np.float32)
    fwd = jax.jit(lambda p, s, xx: jnet._forward(p, s, (xx,), False,
                                                 None)[0])
    ref = fwd(jnet.params_, jnet.state_, jnp.asarray(x))
    with torch.no_grad():
        acts = net._forward(net.params_, net.state_, (_t(x),), False,
                            None)[0]
    for name in net.conf.topoOrder:
        r, a = np.asarray(ref[name]), acts[name].numpy()
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=F32["act"] * np.abs(r).max(),
                                   rtol=0, err_msg=name)
    out = net.output(x)
    assert out.shape == (2, 4) and out.torch.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x).jax),
                               atol=F32["act"])


# ---------------------------------------------------------------------------
# a narrow ResNet: one fit step and a loss curve, FLOAT and BFLOAT16
# ---------------------------------------------------------------------------

def _narrow_batches(n=2):
    rng = np.random.RandomState(9)
    return [(rng.randn(NARROW_BATCH, 3, 16, 16).astype(np.float32),
             np.eye(NARROW_CLASSES, dtype=np.float32)[
                 rng.randint(0, NARROW_CLASSES, NARROW_BATCH)])
            for _ in range(n)]


@pytest.fixture(scope="module")
def narrow_runs():
    """5 fit steps of the narrow graph in each package and dataType from
    the same copied params.  Per dataType and step: {"jax": (score, flat
    params, BN stats, momentum), "port": the same}."""
    p0 = jax.tree.map(np.array, jmodels.ComputationGraph(
        _narrow(JAX, "FLOAT")).init().params_)
    batches = _narrow_batches()
    runs = {}
    for dt in ("FLOAT", "BFLOAT16"):
        jnet = jmodels.ComputationGraph(_narrow(JAX, dt)).init(
            params=jax.tree.map(np.array, p0))
        net = tmodels.ComputationGraph(_narrow(PORT, dt), device="cpu") \
            .init(params=p0)
        steps = []
        for s in range(5):
            f, l = batches[s % 2]
            jnet.fit(jds.DataSet(f, l))
            net.fit(tds.DataSet(f, l))
            steps.append({
                "jax": (jnet.score(), np.asarray(jnet.params().jax),
                        *_flat_state(jnet)),
                "port": (net.score(), net.params().numpy(),
                         *_flat_state(net))})
        runs[dt] = (jnet, net, steps)
    return runs


def _dist(a, b):
    """Max |a - b| over each of (score, params, BN stats, momentum)."""
    return [float(np.abs(np.asarray(x) - np.asarray(y)).max())
            for x, y in zip(a, b)]


def test_narrow_graph_json_and_forward_match_reference(narrow_runs):
    for dt in ("FLOAT", "BFLOAT16"):
        assert _narrow(PORT, dt).toJson() == _narrow(JAX, dt).toJson()
    jnet, net, _ = narrow_runs["FLOAT"]
    f, _l = _narrow_batches(1)[0]
    np.testing.assert_allclose(net.output(f).numpy(),
                               np.asarray(jnet.output(f).jax),
                               atol=F32["act"])


def test_narrow_graph_fit_float_matches_reference(narrow_runs):
    """Loss, parameters, BN running stats and Nesterovs buffers after one
    step and along the 5-step curve."""
    _, net, steps = narrow_runs["FLOAT"]
    for i, step in enumerate(steps):
        d_loss, d_params, d_state, d_v = _dist(step["port"], step["jax"])
        assert d_loss <= F32["loss"], i
        assert max(d_params, d_state, d_v) <= F32["params"], i
    assert (net.iterationCount, net.getEpochCount()) == (5, 0)
    assert {v.dtype for s in net.state_.values() for v in s.values()} == \
        {torch.float32}


def test_narrow_graph_fit_bf16_matches_reference(narrow_runs):
    """The port's bf16 run against the reference's.  The first loss comes
    from the same bf16 forward, whose softmax the two round at other points
    (the probabilities differ by a few bf16 ulps, each moving -log p by up
    to 2**-7): BF16_LOSS.  Parameters, BN running stats and momentum after
    one step, and every loss of the 5-step curve, hold to bf16 noise: no
    farther from the reference's bf16 run than that run is from the
    reference's own float32 run (after one step, and the largest such
    distance over the curve)."""
    f32, bf = narrow_runs["FLOAT"][2], narrow_runs["BFLOAT16"][2]
    port, ref, ref32 = bf[0]["port"], bf[0]["jax"], f32[0]["jax"]
    assert abs(port[0] - ref[0]) <= BF16_LOSS
    for d, noise in zip(_dist(port, ref)[1:], _dist(ref, ref32)[1:]):
        assert d <= noise
    noise = max(abs(b["jax"][0] - f["jax"][0]) for b, f in zip(bf, f32))
    assert all(abs(b["port"][0] - b["jax"][0]) <= noise for b in bf)
    _, net, _ = narrow_runs["BFLOAT16"]
    assert {v.dtype for lp in net.params_.values() for v in lp.values()} \
        == {torch.float32}
    assert {v.dtype for s in net.state_.values() for v in s.values()} == \
        {torch.float32}


# ---------------------------------------------------------------------------
# ComputationGraph API
# ---------------------------------------------------------------------------

def test_multi_output_graph_fit_and_output_match_reference():
    jnet = jmodels.ComputationGraph(_merge_graph(JAX)).init()
    net = tmodels.ComputationGraph(_merge_graph(PORT), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    rng = np.random.RandomState(10)
    a, b = rng.randn(5, 2).astype(np.float32), rng.randn(5, 3).astype(
        np.float32)
    outs = net.output(b, a)
    assert isinstance(outs, list) and [o.shape for o in outs] == [(5, 3),
                                                                  (5, 2)]
    for o, r in zip(outs, jnet.output(b, a)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r.jax), atol=1e-6)
    torch.testing.assert_close(net.outputSingle(b, a).torch, outs[0].torch)
    # a two-input, two-output graph fits on a MultiDataSet (ROADMAP A6)
    y0 = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 5)]
    y1 = rng.randn(5, 2).astype(np.float32)
    jnet.fit(JAX.ds.MultiDataSet([b, a], [y0, y1]))
    net.fit(PORT.ds.MultiDataSet([b, a], [y0, y1]))
    assert abs(net.score() - jnet.score()) <= 1e-5
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jnet.params().jax), atol=1e-6)


def test_fit_iterator_two_epochs_equals_batches_in_turn():
    batches = _narrow_batches()
    net = tmodels.ComputationGraph(_narrow(PORT, "FLOAT"), device="cpu") \
        .init()
    net2 = tmodels.ComputationGraph(_narrow(PORT, "FLOAT"), device="cpu") \
        .init()
    assert torch.equal(net.params().torch, net2.params().torch)  # seeded
    net.fit(tds.ListDataSetIterator([tds.DataSet(f, l)
                                     for f, l in batches]), epochs=2)
    for _ in range(2):
        for f, l in batches:
            net2.fit(f, l)
    assert torch.equal(net.params().torch, net2.params().torch)
    assert net.score() == net2.score()
    assert (net.iterationCount, net.getEpochCount()) == (4, 2)
    f, l = batches[0]
    assert abs(net.score(tds.DataSet(f, l)) - net2.score(tds.DataSet(f, l))) \
        == 0.0


def test_score_of_a_dataset_matches_reference(narrow_runs):
    jnet, net, _ = narrow_runs["FLOAT"]
    f, l = _narrow_batches(1)[0]
    assert abs(net.score(tds.DataSet(f, l)) -
               jnet.score(jds.DataSet(f, l))) <= F32["loss"]


def test_set_params_round_trips():
    net = tmodels.ComputationGraph(_narrow(PORT, "FLOAT"), device="cpu") \
        .init()
    flat = net.params().torch
    net.setParams(torch.arange(flat.numel(), dtype=torch.float32))
    first = net.conf.topoOrder[0]
    assert first == "stem_conv"
    assert net.paramTable()["stem_conv_W"].torch.flatten()[:2].tolist() == \
        [0., 1.]
    net.setParams(flat)
    assert torch.equal(net.params().torch, flat)
    with pytest.raises(ValueError, match="length"):
        net.setParams(torch.zeros(flat.numel() + 1))


def test_unported_pieces_raise_naming_their_roadmap_item():
    """What is still unported raises naming its ROADMAP item; what this
    test once refused (A3's schedules, A5's TBPTT, A6's vertices, A8's
    rnnTimeStep, A9's evaluate, listeners, line-search solvers and the
    pretrained loader, which now asks for a checkpoint) now runs: a graph without
    RNN vertices steps as ``output``, ``evaluate`` counts its examples,
    listeners attach, LBFGS makes one iteration per ``fit``, and a TBPTT
    graph fed rank-4 images trains by standard backpropagation."""
    # A6's vertices, which this test once refused, now build
    assert tgc.vertex_from_json({"@class": "SubsetVertex", "fromIndex": 1,
                                 "toIndex": 2}).toIndex == 2
    # A4's VAE and A11's embedding bag, which this test once refused, load
    assert type(tlayers.layer_from_json(
        {"@class": "ShardedEmbeddingBag", "numEmbeddings": 8,
         "embeddingDim": 2})).__name__ == "ShardedEmbeddingBag"
    assert type(tlayers.layer_from_json(
        {"@class": "VariationalAutoencoder", "nIn": 4, "nOut": 2})) \
        .__name__ == "VariationalAutoencoder"
    net = tmodels.ComputationGraph(_narrow(PORT, "FLOAT"), device="cpu") \
        .init()
    f, l = _narrow_batches(1)[0]
    torch.testing.assert_close(net.rnnTimeStep(f[:1]).torch,
                               net.output(f[:1]).torch)
    assert net.evaluate(tds.ListDataSetIterator(
        [tds.DataSet(f, l)])).getNumRowCounter() == f.shape[0]
    net.setListeners(object())
    assert len(net.getListeners()) == 1
    net.setListeners()
    with pytest.raises(RuntimeError, match="no pretrained checkpoint"):
        TResNet50().initPretrained(path=None, pretrainedType="NONE_SUCH")
    fixed = tlearn.Nesterovs(momentumSchedule=tlearn.FixedSchedule(0.5))
    for a, b in zip(fixed.apply(torch.ones(2), {"v": torch.ones(2)}, 0.1, 0),
                    tlearn.Nesterovs(momentum=0.5).apply(
                        torch.ones(2), {"v": torch.ones(2)}, 0.1, 0)):
        torch.testing.assert_close(a, b)
    conf = _narrow(PORT, "FLOAT")
    conf.globalConf["optimizationAlgo"] = "LBFGS"
    lbfgs = tmodels.ComputationGraph(conf, device="cpu")
    lbfgs.fit(f, l)
    assert lbfgs.iterationCount == 1 and np.isfinite(lbfgs.score())
    conf = _narrow(PORT, "FLOAT")
    conf.backpropType = "TruncatedBPTT"
    conf.tbpttFwdLength = 2
    net = tmodels.ComputationGraph(conf, device="cpu").init()
    net2 = tmodels.ComputationGraph(_narrow(PORT, "FLOAT"), device="cpu") \
        .init()
    net._fitBatch(tds.DataSet(f, l))
    net2._fitBatch(tds.DataSet(f, l))
    assert net.iterationCount == 1
    assert torch.equal(net.params().torch, net2.params().torch)
