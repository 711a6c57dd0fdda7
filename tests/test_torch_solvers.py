"""Port parity: the line-search solvers (``deeplearning4j_tpu_torch/
optimize/solvers.py``) behind ``optimizationAlgo``, against the JAX
package's.

Three ``fit`` calls of each algorithm from copied parameters, on a small
MLP as a ``MultiLayerNetwork`` and as a ``ComputationGraph``, full batch:
the scores follow the reference's to 1e-5 relative and the parameters to
1e-5 (float32 on both sides: the dot products of the line search and the
two-loop recursion sum in different orders; no branch of the line search
flips on these inputs, so the test runs in FLOAT).  Then the solvers'
own contract: a non-finite loss raises ``InvalidStepException``, an
unknown algorithm raises, and L-BFGS drives a regression loss down.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.optimize import InvalidStepException
from deeplearning4j_tpu_torch.optimize.solvers import (LBFGS,
                                                       BackTrackLineSearch,
                                                       make_solver)

from _torch_parity import JAX, PORT, _np

pytestmark = pytest.mark.torch_port

ALGOS = ["LBFGS", "CONJUGATE_GRADIENT", "LINE_GRADIENT_DESCENT"]
SCORE_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _mlp(pkg, algo, graph=False):
    L = pkg.layers
    b = (pkg.conf.NeuralNetConfiguration.builder().seed(11)
         .optimizationAlgo(algo).maxNumLineSearchIterations(8)
         .updater(pkg.learn.Sgd(0.1)))
    dense = L.DenseLayer.builder().nIn(3).nOut(8).activation("tanh").build()
    out = L.OutputLayer.builder("mse").nIn(8).nOut(2) \
        .activation("identity").build()
    if not graph:
        return b.list().layer(dense).layer(out).build()
    gb = b.graphBuilder().addInputs("in")
    gb.addLayer("dense", dense, "in").addLayer("out", out, "dense")
    return gb.setOutputs("out").build()


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], x[:, 2] * x[:, 0]], 1) \
        .astype(np.float32)
    return x, y


def _pair(algo, graph):
    Model = "ComputationGraph" if graph else "MultiLayerNetwork"
    jnet = getattr(JAX.models, Model)(_mlp(JAX, algo, graph)).init()
    net = getattr(PORT.models, Model)(_mlp(PORT, algo, graph),
                                      device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    return jnet, net


def _flat(net):
    p = net.params()
    return np.asarray(p.jax) if hasattr(p, "jax") else _np(p)


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("algo", ALGOS)
def test_three_solver_steps_follow_the_reference(algo, graph):
    jnet, net = _pair(algo, graph)
    x, y = _data()
    js, ts = [], []
    for _ in range(3):
        jnet.fit(JAX.ds.DataSet(x, y))
        net.fit(PORT.ds.DataSet(x, y))
        js.append(jnet.score())
        ts.append(net.score())
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    assert ts[-1] < ts[0] and all(np.isfinite(ts))
    assert net.iterationCount == jnet.iterationCount == 3
    np.testing.assert_allclose(_flat(net), _flat(jnet), atol=PARAM_ATOL,
                               rtol=0)


def test_nonfinite_loss_raises_invalid_step():
    jnet, net = _pair("LBFGS", False)
    x, y = _data()
    x[0, 0] = np.nan
    with pytest.raises(InvalidStepException, match="non-finite"):
        net.fit(PORT.ds.DataSet(x, y))


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="Unknown optimizationAlgo"):
        make_solver("NEWTON")


def test_lbfgs_drives_a_regression_loss_down():
    """The reference's own check (``optimize/solvers.py`` on a quadratic):
    a least-squares problem over the flat vector."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(20, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(20).astype(np.float32))
    solver = LBFGS(10).bind(lambda v, a, b: ((a @ v - b) ** 2).mean())
    v, f0 = torch.zeros(5), float(((a @ torch.zeros(5) - b) ** 2).mean())
    for _ in range(30):
        v, f = solver.step(v, a, b)
    want = torch.linalg.lstsq(a, b[:, None]).solution[:, 0]
    assert f < f0 and float((v - want).abs().max()) < 1e-3


def test_line_search_refuses_an_ascent_direction():
    ls = BackTrackLineSearch()
    x, g = torch.zeros(3), torch.ones(3)
    alpha, x2, f = ls.search(lambda v: v.sum(), x, 0.0, g, g)
    assert alpha == 0.0 and f == 0.0 and torch.equal(x2, x)
