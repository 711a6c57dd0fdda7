"""Port parity of the training fault supervisor: ``FaultTolerantTrainer``
with its checkpointer and the training faults, on the small MLP and graph
of ``tests/test_fault_tolerance.py``.  The port's nets carry the JAX nets'
parameters (``init(params=)``); the same seeded numpy batches and the same
fault schedule go through both packages' supervisors, and the final
parameters are held to the reference's within ``PARAM_ATOL`` (float32
Adam on both sides, a few steps: the packages' CPU kernels round apart by
~1e-7 a step).  A resumed run in the port equals its uninterrupted run
bit for bit."""
import functools
import json
import logging
import math

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.fault as jfault
import deeplearning4j_tpu_torch.fault as tfault
from _torch_parity import JAX, PORT
from deeplearning4j_tpu.utils.sharded_checkpoint import \
    ShardedCheckpointer as JCkpt
from deeplearning4j_tpu_torch.utils.sharded_checkpoint import \
    ShardedCheckpointer as TCkpt

pytestmark = pytest.mark.torch_port

PARAM_ATOL = 1e-5
LOSS_ATOL = 1e-5
FAULTS = {"reference": jfault, "port": tfault}


def _conf(P, seed=42, lr=0.01):
    L = P.layers
    return (P.conf.NeuralNetConfiguration.builder().seed(seed)
            .updater(P.learn.Adam(lr)).list()
            .layer(L.DenseLayer.builder().nIn(4).nOut(8)
                   .activation("relu").build())
            .layer(L.OutputLayer.builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(P.conf.InputType.feedForward(4)).build())


def _graph_conf(P):
    L = P.layers
    return (P.conf.NeuralNetConfiguration.builder().seed(7)
            .updater(P.learn.Adam(0.01)).graphBuilder()
            .addInputs("in")
            .setInputTypes(P.conf.InputType.feedForward(4))
            .addLayer("d", L.DenseLayer.builder().nOut(8)
                      .activation("relu").build(), "in")
            .addLayer("out", L.OutputLayer.builder("mcxent").nOut(3)
                      .activation("softmax").build(), "d")
            .setOutputs("out").build())


def _np_params(jnet):
    return jax.tree.map(np.array, jnet.params_)


@functools.lru_cache(maxsize=None)
def _p0(graph):
    """The reference's seeded initial parameters (drawn once: every net
    below starts from them through ``init(params=)``)."""
    if graph:
        return _np_params(JAX.models.ComputationGraph(_graph_conf(JAX))
                          .init())
    return _np_params(JAX.models.MultiLayerNetwork(_conf(JAX)).init())


def _net(key, graph=False):
    """A fresh net of one package carrying ``_p0``, the port's on the
    CPU."""
    P = JAX if key == "reference" else PORT
    conf = (_graph_conf if graph else _conf)(P)
    cls = P.models.ComputationGraph if graph else P.models.MultiLayerNetwork
    net = cls(conf) if key == "reference" else cls(conf, device="cpu")
    return net.init(params=_p0(graph))


def _pair(graph=False):
    """(reference net, port net carrying the same parameters)."""
    return _net("reference", graph), _net("port", graph)


def _toy(n=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    cls = np.clip((x.sum(1) > 0).astype(int) + (x[:, 0] > 1).astype(int),
                  0, 2)
    return x, np.eye(3, dtype=np.float32)[cls]


def _iterator(P, batch=32):
    x, y = _toy()
    return P.ds.ListDataSetIterator([P.ds.DataSet(x, y)], batch=batch)


def _trainer(key, net, ckdir, **kw):
    kw.setdefault("checkpointEveryN", 2)
    kw.setdefault("keepLast", 10)
    kw.setdefault("durableExport", False)
    return FAULTS[key].FaultTolerantTrainer(net, str(ckdir), **kw)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_params_close(net, jnet, atol=PARAM_ATOL):
    port = dict(_leaves(jax.tree.map(lambda t: t.numpy(), net.params_)))
    ref = dict(_leaves(jnet.params_))
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=atol, rtol=0,
                                   err_msg=k)


def _trees_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_trees_equal(a[k], b[k])
                                              for k in a)
    return torch.equal(a, b)


class _LrLog:
    """Records ``(iteration, lrScale)`` at every ``iterationDone``."""

    def __init__(self):
        self.seq = []

    def iterationDone(self, model, iteration, epoch):
        self.seq.append((int(iteration), float(model.getLrScale())))

    def __getattr__(self, name):        # the listener SPI's other hooks
        return lambda *a, **k: None


def _run(key, net, ckdir, faults=(), preempted=False, epochs=2, **kw):
    P = JAX if key == "reference" else PORT
    t = _trainer(key, net, ckdir, **kw)
    with FAULTS[key].inject(*faults):
        if preempted:
            with pytest.raises(FAULTS[key].SimulatedPreemption):
                t.fit(_iterator(P), epochs=epochs)
            # what a killed process leaves is what reached the disk; the
            # writes it had issued are joined here, so the next trainer
            # on the directory does not wait on them
            t.close()
        else:
            t.fit(_iterator(P), epochs=epochs)
    return t


def test_preempt_and_resume_matches_the_reference_and_is_bit_exact(
        tmp_path):
    jnet, net = _pair()
    base = _net("port")
    tb = _run("port", base, tmp_path / "base")
    stats = {}
    for key, first in (("reference", jnet), ("port", net)):
        _run(key, first, tmp_path / key, (FAULTS[key].PreemptAtStep(5),),
             preempted=True)
        assert first.iterationCount == 5
    # fresh nets on the same directories resume from step 4
    jres, res = _pair()
    for key, n in (("reference", jres), ("port", res)):
        t = _run(key, n, tmp_path / key)
        stats[key] = (t.stats["resumedFromStep"], n.iterationCount,
                      n.epochCount, t.lastLoss)
    assert stats["port"][:3] == stats["reference"][:3] == (4, 8, 2)
    assert stats["port"][3] == pytest.approx(stats["reference"][3],
                                             abs=LOSS_ATOL)
    _assert_params_close(res, jres)
    # in the port alone: the resumed run IS the uninterrupted run
    assert _trees_equal(res.params_, base.params_)
    assert _trees_equal(res.optState_, base.optState_)
    assert tb.lastLoss == stats["port"][3]


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_oom_split_then_nan_rollback_and_the_lr_scale_sequence(tmp_path,
                                                               graph):
    """One schedule through both supervisors: an injected OOM at step 1
    (split into two 16-example halves), NaN features at step 3 (rolled
    back to the step-2 checkpoint with the LR halved)."""
    jnet, net = _pair(graph)
    out = {}
    for key, n in (("reference", jnet), ("port", net)):
        log = _LrLog()
        n.setListeners(log)
        F = FAULTS[key]
        t = _run(key, n, tmp_path / key, (F.OOMAtStep(1), F.NaNAtStep(3)),
                 epochs=1)
        out[key] = (t.stats["oomSplits"], t.stats["rollbacks"],
                    n.iterationCount, n.epochCount, log.seq, t.lastLoss)
    assert out["port"][:5] == out["reference"][:5]
    assert out["port"][:3] == (1, 1, 3)
    assert out["port"][4][-1] == (3, 0.5)
    assert math.isfinite(out["port"][5])
    assert out["port"][5] == pytest.approx(out["reference"][5],
                                           abs=LOSS_ATOL)
    _assert_params_close(net, jnet)


def test_persistent_nan_raises_diverged(tmp_path):
    """As the reference's own test holds it: after maxRollbacks the
    supervisor gives up (maxRollbacks + the final one counted)."""
    t = _trainer("port", _net("port"), tmp_path, maxRollbacks=2)
    with tfault.inject(tfault.NaNAtStep(times=None)):
        with pytest.raises(tfault.TrainingDivergedError):
            t.fit(_iterator(PORT), epochs=1)
    assert t.stats["rollbacks"] == 3


def test_corrupt_newest_checkpoint_falls_back_as_the_reference(tmp_path):
    jnet, net = _pair()
    out = {}
    for key, n in (("reference", jnet), ("port", net)):
        _run(key, n, tmp_path / key, epochs=1)
        ck = (JCkpt if key == "reference" else TCkpt)(
            str(tmp_path / key), keepLast=10)
        newest = max(ck.allSteps())
        assert ck.verifyStep(newest)
        FAULTS[key].corrupt_checkpoint(str(tmp_path / key), newest)
        assert not ck.verifyStep(newest)
        fresh = _net(key)
        t = _run(key, fresh, tmp_path / key, epochs=1)
        out[key] = (newest, ck.latestValidStep(), t.stats["resumedFromStep"],
                    fresh.iterationCount, fresh)
    assert out["port"][:4] == out["reference"][:4]
    assert out["port"][2] < out["port"][0]
    _assert_params_close(out["port"][4], out["reference"][4])


def test_corrupt_checkpoint_fault_in_the_port_resumes_bit_exact(tmp_path):
    """CorruptCheckpointAtStep on the newest step, then a preemption: the
    resume skips it and still lands on the uninterrupted run's bits."""
    mk = lambda: _net("port")
    base = mk()
    _run("port", base, tmp_path / "base")
    first = mk()
    _run("port", first, tmp_path / "run",
         (tfault.CorruptCheckpointAtStep(6), tfault.PreemptAtStep(7)),
         preempted=True)
    res = mk()
    t = _run("port", res, tmp_path / "run")
    assert t.stats["resumedFromStep"] == 4
    assert _trees_equal(res.params_, base.params_)


def test_supervising_a_wrapper_waits_for_a10(tmp_path):
    class Wrapper:          # anything exposing .model, as ParallelWrapper
        model = _net("port")

    with pytest.raises(NotImplementedError, match="A10"):
        tfault.FaultTolerantTrainer(Wrapper(), str(tmp_path))


def test_unsplittable_oom_propagates(tmp_path):
    x, y = _toy(n=8)
    it = PORT.ds.ListDataSetIterator([PORT.ds.DataSet(x, y)], batch=1)
    t = _trainer("port", _net("port"), tmp_path)
    with tfault.inject(tfault.OOMAtStep(2, times=10)):
        with pytest.raises(tfault.InjectedOOM):
            t.fit(it, epochs=1)


def test_a_failed_step_leaves_the_net_as_it_was(tmp_path):
    """A real out-of-memory error partway through a step (the generator
    already drawn from, the params already replaced) is undone before
    the halves run: the split step equals the reference-free split of the
    same batch from the pre-step state."""
    net, ref = _net("port"), _net("port")
    x, y = _toy(n=32)
    ds = PORT.ds.DataSet(x, y)
    orig = net._runTrainStep
    calls = []

    def failing(*a, **k):
        calls.append(a[0].shape[0])
        if a[0].shape[0] == 32:
            orig(*a, **k)            # the step's work happens, then
            torch.rand(4, generator=net._fitGen)
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return orig(*a, **k)

    net._runTrainStep = failing
    t = _trainer("port", net, tmp_path / "oom")
    t._stepOnce(ds)
    assert calls == [32, 16, 16] and net.iterationCount == 1
    for half in (ds._rows(slice(0, 16)), ds._rows(slice(16, 32))):
        ref.fit(half)
        ref.iterationCount = 0
    assert _trees_equal(net.params_, ref.params_)
    assert torch.equal(net._fitGen.get_state(), ref._fitGen.get_state())


def test_is_oom_error_is_true_only_for_oom_types():
    assert tfault.is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert tfault.is_oom_error(tfault.InjectedOOM())
    assert not tfault.is_oom_error(RuntimeError("CUDA error: out of memory"))
    assert not tfault.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED"))
    # the reference matches by message, so its injected OOM reads alike
    assert jfault.is_oom_error(jfault.InjectedOOM()) and \
        str(tfault.InjectedOOM("x")) == str(jfault.InjectedOOM("x"))


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_one_lr_scaled_step_matches_the_reference(graph):
    jnet, net = _pair(graph)
    x, y = _toy(n=32)
    for n, P in ((jnet, JAX), (net, PORT)):
        n.setLrScale(0.5)
        assert n.getLrScale() == 0.5
        n.fit(P.ds.DataSet(x, y))
    _assert_params_close(net, jnet, atol=1e-6)
    # the scale halves the step against an unscaled one from the same
    # start (Adam's step is linear in the learning rate)
    full = _net("port", graph)
    full.fit(PORT.ds.DataSet(x, y))
    p0 = dict(_leaves(_p0(graph)))
    half = dict(_leaves(jax.tree.map(lambda t: t.numpy(), net.params_)))
    one = dict(_leaves(jax.tree.map(lambda t: t.numpy(), full.params_)))
    for k in p0:
        np.testing.assert_allclose(p0[k] - half[k], 0.5 * (p0[k] - one[k]),
                                   atol=1e-7, err_msg=k)


def test_manifest_keys_match_the_references(tmp_path):
    jnet, net = _pair()
    meta = {"stepInEpoch": 7, "lrScale": 0.25}
    docs = {}
    for key, n, cls in (("reference", jnet, JCkpt), ("port", net, TCkpt)):
        ck = cls(str(tmp_path / key), keepLast=3)
        step = ck.saveWithManifest(n, metadata=meta)
        assert ck.verifyStep(step) and ck.readMetadata(step) == meta
        with open(tmp_path / key / "manifests" / f"step-{step}.json") as f:
            docs[key] = json.load(f)
        ck.close()
    p, r = docs["port"], docs["reference"]
    assert sorted(p) == sorted(r) == ["files", "metadata", "step", "tree"]
    assert p["step"] == r["step"] and p["metadata"] == r["metadata"]
    assert p["tree"]["params"] == r["tree"]["params"]
    assert sorted(p["tree"]["optState"]) == sorted(r["tree"]["optState"])
    for rec in p["files"].values():
        assert sorted(rec) == ["bytes", "sha256"]


def test_checkpoint_restores_every_piece_of_the_tree(tmp_path):
    """Params, updater and layer state, counters, the training generator
    and the rnn carries come back bit for bit; a restore onto another
    mesh waits for A10."""
    net = _net("port")
    x, y = _toy(n=32)
    net.fit(PORT.ds.DataSet(x, y))
    torch.rand(3, generator=net._fitGen)
    net._rnnCarries = {"0": (torch.arange(4.0), torch.ones(2, 2))}
    ck = TCkpt(str(tmp_path), keepLast=2)
    step = ck.saveWithManifest(net, metadata={"lrScale": 1.0})
    other = PORT.models.MultiLayerNetwork(_conf(PORT), device="cpu").init()
    assert not _trees_equal(other.params_, net.params_)
    ck.restore(other, step=step)
    assert _trees_equal(other.params_, net.params_)
    assert _trees_equal(other.optState_, net.optState_)
    assert other.iterationCount == net.iterationCount == 1
    assert torch.equal(other._fitGen.get_state(), net._fitGen.get_state())
    assert torch.equal(other._rnnCarries["0"][0], torch.arange(4.0))
    assert isinstance(other._rnnCarries["0"], tuple)
    with pytest.raises(NotImplementedError, match="A10"):
        ck.restore(other, step=step, shardings={"params": None, "x": 1})
    # keepLast prunes the oldest steps and their manifests
    for _ in range(3):
        net.fit(PORT.ds.DataSet(x, y))
        ck.saveWithManifest(net)
    assert ck.allSteps() == [3, 4]
    assert sorted((tmp_path / "manifests").iterdir())[0].name == \
        "step-3.json"


@pytest.mark.parametrize("which", ["failing_exhausts", "transient", "slow"])
def test_fetch_faults_through_the_fetchers(which, caplog):
    import deeplearning4j_tpu.datasets.fetchers as jf
    import deeplearning4j_tpu_torch.datasets.fetchers as tf
    out = {}
    for key, mod in (("reference", jf), ("port", tf)):
        F = FAULTS[key]
        if which == "failing_exhausts":
            fault = F.FailingFetch("cifar10", times=5)
            make = lambda: mod.Cifar10DataSetIterator(8, numExamples=16)
        elif which == "transient":
            fault = F.FailingFetch("emnist", times=2)
            make = lambda: mod.EmnistDataSetIterator("DIGITS", 8,
                                                     numExamples=16)
        else:
            fault = F.SlowFetch("emnist", delay=0.01)
            make = lambda: mod.EmnistDataSetIterator("DIGITS", 8,
                                                     numExamples=16)
        with caplog.at_level(logging.WARNING):
            with F.inject(fault):
                it = make()
        ds = it.next()
        out[key] = (getattr(fault, "attempts", None),
                    getattr(it, "isSynthetic", None),
                    np.asarray(ds.features.numpy()))
    assert out["port"][:2] == out["reference"][:2]
    if which != "slow":
        assert out["port"][0] == 3
    np.testing.assert_array_equal(out["port"][2], out["reference"][2])
