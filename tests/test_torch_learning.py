"""Port parity: ``learning/`` — every updater, the ``ISchedule`` family
and the regularization classes — against the JAX package.

Updaters are held step by step, for one step and for seven, from the same
seeded gradients; schedules at a list of (iteration, epoch) points, in both
schedule types, and as the learning rate (and Nesterovs' momentum) of a
5-step fit; L1, L2 and weight decay through fit steps.  Both packages
compute in float32 (beta^t too), except where the JAX package's schedule
arithmetic promotes to float64 under x64 (Sigmoid, Linear, Cycle): values
agree to 1e-6 relative, updates to 1e-7 absolute plus 1e-6 relative, and
the small dense net's losses and parameters after 5 steps to 1e-6 (values
of order 1; measured ≤ 4.8e-7 and 1.2e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu_torch.learning as tlearn

from _torch_parity import JAX, PORT, _fit_both

pytestmark = pytest.mark.torch_port

FIT_TOL = 1e-6

_UPDATERS = {
    "adamw": lambda m: m.AdamW(1e-2, beta1=0.8, weightDecay=0.1),
    "adamax": lambda m: m.AdaMax(2e-2, beta2=0.99),
    "amsgrad": lambda m: m.AMSGrad(1e-2, epsilon=1e-6),
    "nadam": lambda m: m.Nadam(1e-2, beta1=0.85),
    "rmsprop": lambda m: m.RmsProp(1e-2, rmsDecay=0.9),
    "adagrad": lambda m: m.AdaGrad(5e-2),
    "adadelta": lambda m: m.AdaDelta(rho=0.9),
}


@pytest.mark.parametrize("name", sorted(_UPDATERS))
@pytest.mark.parametrize("steps", [1, 7])
def test_updater_matches_reference(name, steps):
    rng = np.random.RandomState(6)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(steps)]
    ju, tu = _UPDATERS[name](jlearn), _UPDATERS[name](tlearn)
    p = rng.randn(5, 3).astype(np.float32)
    js, ts = ju.init(jnp.asarray(p)), tu.init(torch.from_numpy(p))
    for i, g in enumerate(grads):
        jup, js = ju.apply(jnp.asarray(g), js, ju.currentLr(i, 0), i,
                           param=jnp.asarray(p))
        tup, ts = tu.apply(torch.from_numpy(g), ts, tu.currentLr(i, 0), i,
                           param=torch.from_numpy(p))
        np.testing.assert_allclose(tup.numpy(), np.asarray(jup), atol=1e-7,
                                   rtol=1e-6)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       atol=1e-7, rtol=1e-6)
        p = p - tup.numpy()
    assert sorted(ts) == sorted(js)
    assert tu.stateSize(15) == ju.stateSize(15)


@pytest.mark.parametrize("name", sorted(_UPDATERS))
def test_updater_json_matches_reference(name):
    ju, tu = _UPDATERS[name](jlearn), _UPDATERS[name](tlearn)
    assert tu.toJson() == ju.toJson()
    assert tlearn.IUpdater.fromJson(ju.toJson()) == tu
    assert jlearn.IUpdater.fromJson(tu.toJson()) == ju


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _schedules(m, st="ITERATION"):
    S = m.ScheduleType
    st = getattr(S, st)
    return {
        "fixed": m.FixedSchedule(0.05),
        "exponential": m.ExponentialSchedule(st, 0.1, 0.93),
        "inverse": m.InverseSchedule(st, 0.1, 0.2, 1.5),
        "poly": m.PolySchedule(st, 0.1, 2.0, 60),
        "sigmoid": m.SigmoidSchedule(st, 0.1, 0.3, 8),
        "step": m.StepSchedule(st, 0.1, 0.5, 3),
        "linear": m.LinearSchedule(st, 0.1, 0.01, 40),
        "cycle": m.CycleSchedule(st, 0.01, 0.1, 11, annealingLength=3),
        "map": m.MapSchedule(st, {0: 0.1, 3: 0.05, 9: 0.01}),
    }


_POINTS = [(0, 0), (1, 0), (2, 1), (3, 1), (7, 2), (10, 4), (11, 5),
           (25, 9), (59, 20), (60, 21), (250, 40), (4000, 800)]


@pytest.mark.parametrize("st", ["ITERATION", "EPOCH"])
@pytest.mark.parametrize("name", sorted(_schedules(jlearn)))
def test_schedule_values_match_reference(name, st):
    js, ts = _schedules(jlearn, st)[name], _schedules(tlearn, st)[name]
    for it, ep in _POINTS:
        want = float(js.valueAt(it, ep))
        got = float(ts.valueAt(it, ep))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (it, ep)


@pytest.mark.parametrize("name", sorted(_schedules(jlearn)))
def test_schedule_json_round_trips_both_ways(name):
    js, ts = _schedules(jlearn)[name], _schedules(tlearn)[name]
    assert ts.toJson() == js.toJson()
    assert tlearn.ISchedule.fromJson(js.toJson()) == ts
    assert jlearn.ISchedule.fromJson(ts.toJson()) == js
    up = tlearn.Adam(learningRateSchedule=ts)
    want = jlearn.Adam(learningRateSchedule=js).toJson()
    assert up.toJson() == want
    assert tlearn.IUpdater.fromJson(want).toJson() == want


def _dense(pkg, updater, **glob):
    """A small dense net: 6 -> tanh 7 -> identity 3 (mse), with global
    options ``glob`` (l1, l2, weightDecay)."""
    L = pkg.layers
    b = pkg.conf.NeuralNetConfiguration.builder().seed(17).updater(updater)
    for k, v in glob.items():
        b = getattr(b, k)(v)
    return (b.list()
            .layer(L.DenseLayer.builder().nOut(7).activation("tanh").build())
            .layer(L.OutputLayer.builder("mse").nOut(3)
                   .activation("identity").build())
            .setInputType(pkg.conf.InputType.feedForward(6)).build())


def _dense_batches():
    rng = np.random.RandomState(18)
    return [(rng.randn(5, 6).astype(np.float32),
             rng.randn(5, 3).astype(np.float32)) for _ in range(2)]


def _fit_dense(make_updater, steps=5, **glob):
    jconf = _dense(JAX, make_updater(jlearn), **glob)
    tconf = _dense(PORT, make_updater(tlearn), **glob)
    jnet = JAX.models.MultiLayerNetwork(jconf).init()
    net = PORT.models.MultiLayerNetwork(tconf, device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    assert tconf.toJson() == jconf.toJson()
    curve = _fit_both(jnet, net, _dense_batches(), steps)
    np.testing.assert_allclose(curve[:, 1], curve[:, 0], atol=FIT_TOL,
                               rtol=FIT_TOL)
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jnet.params().jax), atol=FIT_TOL,
                               rtol=0)
    return jnet, net


@pytest.mark.parametrize("name", sorted(_schedules(jlearn)))
def test_schedule_as_learning_rate_in_a_fit(name):
    _fit_dense(lambda m: m.Sgd(learningRateSchedule=_schedules(m)[name]))


def test_momentum_schedule_in_a_fit():
    _fit_dense(lambda m: m.Nesterovs(
        learningRateSchedule=m.StepSchedule("ITERATION", 0.1, 0.5, 2),
        momentumSchedule=m.MapSchedule("ITERATION", {0: 0.5, 2: 0.9})))


@pytest.mark.parametrize("name", sorted(_UPDATERS))
def test_updater_in_a_fit(name):
    _fit_dense(_UPDATERS[name])


# ---------------------------------------------------------------------------
# regularization
# ---------------------------------------------------------------------------

_REGS = {"l1": lambda m: m.L1Regularization(0.03),
         "l2": lambda m: m.L2Regularization(0.2),
         "wd": lambda m: m.WeightDecay(0.1),
         "wd-noLR": lambda m: m.WeightDecay(0.1, applyLR=False)}


@pytest.mark.parametrize("name", sorted(_REGS))
def test_regularization_matches_reference(name):
    rng = np.random.RandomState(19)
    p, g = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    jr, tr = _REGS[name](jlearn), _REGS[name](tlearn)
    assert tr.applyStep() == jr.applyStep()
    np.testing.assert_allclose(
        tr.apply(torch.from_numpy(p), torch.from_numpy(g), 0.05).numpy(),
        np.asarray(jr.apply(jnp.asarray(p), jnp.asarray(g), 0.05)),
        atol=1e-7, rtol=1e-6)
    assert float(tr.score(torch.from_numpy(p))) == pytest.approx(
        float(jr.score(jnp.asarray(p))), rel=1e-6)
    assert tr.toJson() == jr.toJson()
    assert tlearn.Regularization.fromJson(jr.toJson()) == tr


@pytest.mark.parametrize("reg", [dict(l1=0.02), dict(l2=0.05),
                                 dict(weightDecay=0.1),
                                 dict(l1=0.01, l2=0.02, weightDecay=0.05)])
def test_regularization_in_fit_steps(reg):
    """L1 and L2 enter the loss (the score includes them), weight decay
    the update, scaled by the learning rate, on weights only."""
    jnet, net = _fit_dense(lambda m: m.Adam(1e-2), steps=3, **reg)
    assert net.conf.layers[0].l1 == reg.get("l1")
