"""Port parity: every graph vertex of ``models/graph_conf.py`` and the
graph's ``MultiDataSet`` route (``ComputationGraph.fit`` / ``score``)
against the JAX package.

Each vertex runs its forward in both packages on the same seeded inputs,
then the gradients of sum(output · R) with respect to every input
(``jax.grad`` against autograd); float32, 1e-6.  Every vertex's JSON
round-trips through ``vertex_from_json`` in the port and gives the
reference's back.  A two-input, two-output graph of the new vertices fits
three steps on ``MultiDataSet``s in both packages from the same
parameters: losses to 1e-5 relative, parameters to 1e-5.
"""
import json

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
from deeplearning4j_tpu.models import graph_conf as jgc
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu_torch.models import graph_conf as tgc
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-6, rtol=1e-6)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


VERTICES = [  # (name, kwargs, input shapes)
    ("SubsetVertex", dict(fromIndex=1, toIndex=3), [(3, 5)]),
    ("SubsetVertex", dict(fromIndex=0, toIndex=1), [(2, 4, 3, 3)]),
    ("ScaleVertex", dict(scaleFactor=-2.5), [(3, 4)]),
    ("ShiftVertex", dict(shiftFactor=0.75), [(2, 3, 4)]),
    ("StackVertex", {}, [(2, 4), (3, 4), (1, 4)]),
    ("UnstackVertex", dict(fromIndex=1, stackSize=3), [(6, 4)]),
    ("L2NormalizeVertex", {}, [(3, 6)]),
    ("L2NormalizeVertex", dict(eps=1e-3), [(2, 3, 2, 2)]),
    ("MergeVertex", {}, [(2, 3), (2, 4)]),
    ("ElementWiseVertex", dict(op="Max"), [(2, 3), (2, 3), (2, 3)]),
]


@pytest.mark.parametrize("name,kw,shapes", VERTICES,
                         ids=[f"{n}-{i}" for i, (n, _k, _s)
                              in enumerate(VERTICES)])
def test_vertex_forward_and_gradient(name, kw, shapes):
    rng = np.random.RandomState(len(shapes) * 7 + len(kw))
    xs = [_rand(rng, *s) for s in shapes]
    jv, tv = getattr(jgc, name)(**kw), getattr(tgc, name)(**kw)
    ref = np.asarray(jv.forward(*[jax.numpy.asarray(x) for x in xs]))
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    out = tv.forward(*txs)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    r = _rand(rng, *ref.shape)
    gs = jax.grad(lambda *a: jax.numpy.sum(jv.forward(*a) * r),
                  argnums=tuple(range(len(xs))))(
        *[jax.numpy.asarray(x) for x in xs])
    (out * torch.from_numpy(r)).sum().backward()
    for t, g in zip(txs, gs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_preprocessor_vertex():
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 3, 4, 5)
    jv = jgc.PreprocessorVertex(jpre.CnnToFeedForwardPreProcessor(4, 5, 3))
    tv = tgc.PreprocessorVertex(tpre.CnnToFeedForwardPreProcessor(4, 5, 3))
    np.testing.assert_array_equal(
        tv.forward(torch.from_numpy(x)).numpy(),
        np.asarray(jv.forward(jax.numpy.asarray(x))))
    it = tconf.InputType.convolutional(4, 5, 3)
    assert tv.getOutputType(it).toJson() == jv.getOutputType(
        jconf.InputType.fromJson(it.toJson())).toJson()


VERTEX_JSON = [
    jgc.SubsetVertex(2, 5), jgc.ScaleVertex(3.0), jgc.ShiftVertex(-1.0),
    jgc.StackVertex(), jgc.UnstackVertex(2, 4), jgc.L2NormalizeVertex(1e-4),
    jgc.PreprocessorVertex(jpre.RnnToFeedForwardPreProcessor()),
    jgc.PreprocessorVertex(jpre.FeedForwardToCnnPreProcessor(2, 3, 4)),
    jgc.MergeVertex(), jgc.ElementWiseVertex("Product")]


@pytest.mark.parametrize("vertex", VERTEX_JSON,
                         ids=[type(v).__name__ for v in VERTEX_JSON])
def test_vertex_json_round_trip(vertex):
    ref = json.dumps(vertex.toJson())
    port = tgc.vertex_from_json(json.loads(ref))
    assert type(port).__name__ == type(vertex).__name__
    assert json.dumps(port.toJson()) == ref


def test_every_reference_vertex_is_ported():
    names = [n for n in jgc.__all__ if n.endswith("Vertex")
             and n != "GraphVertex"]
    assert len(names) == 9
    assert [n for n in names if not hasattr(tgc, n)] == []


# ---------------------------------------------------------------------------
# a two-input, two-output graph on MultiDataSets
# ---------------------------------------------------------------------------

B = 6


def _multi_conf(c, L, G, P, learn):
    gb = (c.NeuralNetConfiguration.builder().seed(7)
          .updater(learn.Adam(1e-2)).weightInit("XAVIER").graphBuilder())
    gb.addInputs("a", "b").setInputTypes(c.InputType.feedForward(5),
                                         c.InputType.feedForward(4))
    gb.addVertex("a_sub", G.SubsetVertex(1, 4), "a")             # 4 wide
    gb.addVertex("a_scaled", G.ScaleVertex(0.5), "a_sub")
    gb.addVertex("b_shift", G.ShiftVertex(0.25), "b")
    gb.addVertex("stacked", G.StackVertex(), "a_scaled", "b_shift")
    gb.addLayer("shared", L.DenseLayer.builder().nIn(4).nOut(6)
                .activation("tanh").build(), "stacked")
    gb.addVertex("from_a", G.UnstackVertex(0, 2), "shared")
    gb.addVertex("from_b", G.UnstackVertex(1, 2), "shared")
    gb.addVertex("norm", G.L2NormalizeVertex(), "from_b")
    gb.addVertex("merged", G.MergeVertex(), "from_a", "norm")
    gb.addVertex("as_cnn", G.PreprocessorVertex(
        P.FeedForwardToCnnPreProcessor(2, 3, 2)), "merged")
    gb.addVertex("flat", G.PreprocessorVertex(
        P.CnnToFeedForwardPreProcessor(2, 3, 2)), "as_cnn")
    gb.addLayer("cls", L.OutputLayer.builder("mcxent").nOut(3)
                .activation("softmax").build(), "flat")
    gb.addLayer("reg", L.OutputLayer.builder("mse").nOut(2)
                .activation("identity").build(), "norm")
    return gb.setOutputs("cls", "reg").build()


def _batches(pkg, n, masks=False):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        a, b = _rand(rng, B, 5), _rand(rng, B, 4)
        cls = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)]
        reg = _rand(rng, B, 2)
        lm = [(rng.rand(B, 1) > 0.3).astype(np.float32),
              np.ones((B, 1), np.float32)] if masks else None
        out.append(pkg.MultiDataSet([a, b], [cls, reg], labelsMasks=lm))
    return out


def _nets():
    jnet = jmodels.ComputationGraph(_multi_conf(jconf, jlayers, jgc, jpre,
                                                jlearn))
    jnet.init()
    net = tmodels.ComputationGraph(
        _multi_conf(tconf, tlayers, tgc, tpre, tlearn), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    return jnet, net


def test_graph_json_of_the_new_vertices_is_the_references():
    jc = _multi_conf(jconf, jlayers, jgc, jpre, jlearn)
    tc = _multi_conf(tconf, tlayers, tgc, tpre, tlearn)
    assert tc.toJson() == jc.toJson()
    assert tgc.ComputationGraphConfiguration.fromJson(
        jc.toJson()).toJson() == jc.toJson()
    assert tc.topoOrder == jc.topoOrder


@pytest.mark.parametrize("masks", [False, True])
def test_multidataset_fit_and_score_match_the_reference(masks):
    jnet, net = _nets()
    jb, tb = _batches(jds, 3, masks), _batches(tds, 3, masks)
    np.testing.assert_allclose(net.score(tb[0]), jnet.score(jb[0]),
                               rtol=1e-5)
    for j, t in zip(jb, tb):
        jnet.fit(j)
        net.fit(t)
        np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jnet.params().jax), atol=1e-5)
    np.testing.assert_allclose(net.score(tb[1]), jnet.score(jb[1]),
                               rtol=1e-5)
    outs = net.output(*tb[0].features)
    refs = jnet.output(*[f.numpy() for f in jb[0].features])
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=1e-5)
    assert net.iterationCount == 3 and net.lastBatchSize == B


def test_multidataset_through_an_iterator():
    """A ``ListDataSetIterator`` of ``MultiDataSet``s drives ``fit`` as in
    the reference."""
    jnet, net = _nets()
    jnet.fit(jds.ListDataSetIterator(_batches(jds, 2)), epochs=2)
    net.fit(tds.ListDataSetIterator(_batches(tds, 2)), epochs=2)
    assert net.iterationCount == jnet.iterationCount == 4
    np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
