"""The port's profiler and training UI (ROADMAP A12e) against the reference.

- the reference's own ``tests/test_observability.py`` bodies run against
  the port (``_torch_parity._reference_tests``), on the CPU;
- ``StatsListener``'s param, update and activation stats against the
  reference's on the same parameters, and its one host copy a record;
- the NaN/Inf panic on the same step index as the reference's, both
  models' ``fit``, no host read with panic off, and the rollback under
  ``FaultTolerantTrainer``;
- the tracer's file merging ``OpProfiler``'s phases; ``start_trace`` /
  ``stop_trace`` on ``torch.profiler``;
- ROADMAP C36: ``autodiff.ops_ext.OPS_EXT_NAMES`` equal to the
  reference's.
"""
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import (_cpu_default, _reference_tests,
                                 _run_reference_test)

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests' small CPU ops run on one intra-op thread: beside the
    suite's other workers, a thread pool per op mostly waits."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

# the reference's tests, all of them: the one that serves through
# ParallelInference, JsonModelServer(parallelInference=True), came with the
# parallel layer's data axis (ROADMAP A10a), so none is left out
_A10 = ()
_MOD, _CASES = _reference_tests("test_observability.py", exclude=_A10)


@pytest.fixture
def fresh_profiler():
    """The OpProfiler singleton as a test found it, restored after."""
    from deeplearning4j_tpu_torch.profiler import OpProfiler
    prev = OpProfiler._instance
    OpProfiler._instance = None
    yield OpProfiler
    OpProfiler._instance = prev


@pytest.mark.parametrize("case", [c for _, c in _CASES],
                         ids=[i for i, _ in _CASES])
def test_reference_observability_suite(case, tmp_path, monkeypatch,
                                       fresh_profiler):
    _cpu_default(monkeypatch)
    _run_reference_test(case, tmp_path, monkeypatch)


def test_a10_case_is_the_only_one_left_out():
    names = {n for n, _ in _CASES}
    assert not _A10
    assert "test_json_server_through_parallel_inference" in names
    assert len(names) == 13


# ---------------------------------------------------------------------------
# StatsListener against the reference's stats
# ---------------------------------------------------------------------------

def _mlp_pair():
    """The reference test's ``_net`` in both packages, the port's carrying
    the reference's parameters."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    jnet = _MOD_REF._net()
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer.builder().nIn(4).nOut(8).activation("relu")
                   .build())
            .layer(OutputLayer.builder("mcxent").nIn(8).nOut(2)
                   .activation("softmax").build())
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=jax.tree.map(np.asarray, jnet.params_))
    return jnet, net


def _ref_module():
    import importlib
    return importlib.import_module("tests.test_observability")


_MOD_REF = _ref_module()


def _close_stats(got, ref, rtol=1e-5, atol=1e-6):
    assert set(got) == set(ref)
    for name in ref:
        for field in ("norm", "mean", "stdev", "min", "max"):
            np.testing.assert_allclose(got[name][field], ref[name][field],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{field}")
        assert got[name]["hist"] == ref[name]["hist"], name


def test_stats_listener_stats_equal_the_references(monkeypatch):
    """Two fits with the listener in both packages from the same params:
    the param, update and activation stats of every record agree."""
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JMem
    from deeplearning4j_tpu.ui import StatsListener as JStats
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage,
                                             StatsListener)
    jnet, net = _mlp_pair()
    jmem, mem = JMem(), InMemoryStatsStorage()
    jnet.setListeners(JStats(jmem, sessionId="s", collectActivations=True))
    net.setListeners(StatsListener(mem, sessionId="s",
                                   collectActivations=True))
    d = _MOD_REF._data()
    f, lab = np.asarray(d.features.jax), np.asarray(d.labels.jax)
    for _ in range(2):
        jnet.fit(JDataSet(f, lab))
        net.fit(DataSet(f, lab))
    jups, ups = jmem.getUpdates("s"), mem.getUpdates("s")
    assert len(ups) == len(jups) == 2
    for u, ju in zip(ups, jups):
        for section in ("paramStats", "updateStats", "activationStats"):
            _close_stats(u[section], ju[section])
        assert u["paramNorms"].keys() == ju["paramNorms"].keys()
        assert u["score"] == pytest.approx(ju["score"], rel=1e-5)
        assert u["memory"]["platform"] == "cpu"
    assert ups[0]["updateStats"] == {} and ups[1]["updateStats"]


def test_stats_rows_reach_the_host_once_a_record(monkeypatch):
    """One ``.cpu()`` copy for all three trees of a record."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage,
                                             StatsListener)
    _, net = _mlp_pair()
    mem = InMemoryStatsStorage()
    lst = StatsListener(mem, sessionId="c", collectActivations=True)
    d = _MOD_REF._data()
    f, lab = np.asarray(d.features.jax), np.asarray(d.labels.jax)
    net.fit(DataSet(f, lab))
    copies = []
    orig = torch.Tensor.cpu

    def counting(self, *a, **k):
        copies.append(tuple(self.shape))
        return orig(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    lst.iterationDone(net, 1, 0)
    lst.iterationDone(net, 2, 0)
    # params (4 leaves) + activations (3) then + updates (4), 25 columns
    assert copies == [(7, 25), (11, 25)]
    assert len(mem.getUpdates("c")) == 2


def test_stats_of_odd_leaves_against_numpy():
    """Constant, single-element and wide leaves against numpy: the
    reference's float32 bins (a zero span counts everything in bin 0) and
    population stdev."""
    from deeplearning4j_tpu_torch.ui.stats import _tree_stats
    rng = np.random.RandomState(3)
    leaves = {"a": np.full((3, 4), 0.5, np.float32),
              "b": np.array([2.0], np.float32),
              "c": rng.randn(1000, 7).astype(np.float32) * 3}
    got = _tree_stats({"0": {k: torch.tensor(v) for k, v in leaves.items()}})
    for k, v in leaves.items():
        flat = v.ravel()
        lo, hi = flat.min(), flat.max()
        span = hi - lo if hi > lo else np.float32(1.0)
        bins = np.clip(((flat - lo) / span * np.float32(20)).astype(
            np.int32), 0, 19)
        want = {"norm": np.linalg.norm(flat.astype(np.float64)),
                "mean": flat.astype(np.float64).mean(),
                "stdev": flat.astype(np.float64).std(), "min": lo,
                "max": hi}
        for field, w in want.items():
            np.testing.assert_allclose(got[f"0.{k}"][field], w, rtol=1e-12,
                                       atol=1e-12, err_msg=field)
        assert got[f"0.{k}"]["hist"] == np.bincount(bins,
                                                     minlength=20).tolist()


# ---------------------------------------------------------------------------
# the NaN/Inf panic in fit
# ---------------------------------------------------------------------------

def _panic_confs():
    """The reference test's blow-up MLP (``Sgd(1e12)``, mse) in both
    packages."""
    import deeplearning4j_tpu.learning as jl
    import deeplearning4j_tpu.nn.conf as jc
    import deeplearning4j_tpu.nn.conf.layers as jlay
    import deeplearning4j_tpu_torch.learning as tl
    import deeplearning4j_tpu_torch.nn.conf as tc
    import deeplearning4j_tpu_torch.nn.conf.layers as tlay

    def conf(c, lay, learn):
        return (c.NeuralNetConfiguration.builder().seed(1)
                .updater(learn.Sgd(1e12)).list()
                .layer(lay.DenseLayer.builder().nIn(4).nOut(8)
                       .activation("relu").build())
                .layer(lay.OutputLayer.builder("mse").nIn(8).nOut(2)
                       .activation("identity").build())
                .build())
    return conf(jc, jlay, jl), conf(tc, tlay, tl)


def _panic_step(fit, prof_cls, cfg_cls, steps=20):
    """The index of the fit call that panics (None if none does)."""
    prof = prof_cls.getInstance()
    prof.setConfig(cfg_cls(checkForNAN=True, checkForINF=True))
    try:
        for i in range(steps):
            try:
                fit()
            except FloatingPointError as e:
                assert "NAN_PANIC" in str(e) or "INF_PANIC" in str(e)
                return i
        return None
    finally:
        prof.setConfig(cfg_cls())


def test_panic_step_index_equals_the_references(fresh_profiler):
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.profiler import OpProfiler as JProf
    from deeplearning4j_tpu.profiler import ProfilerConfig as JCfg
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.profiler import OpProfiler, ProfilerConfig
    jconf, tconf = _panic_confs()
    jnet = JMLN(jconf).init()
    net = MultiLayerNetwork(tconf, device="cpu").init(
        params=jax.tree.map(np.asarray, jnet.params_))
    d = _MOD_REF._data()
    f, lab = np.asarray(d.features.jax), np.asarray(d.labels.jax)
    jstep = _panic_step(lambda: jnet.fit(JDataSet(f, lab)), JProf, JCfg)
    step = _panic_step(lambda: net.fit(DataSet(f, lab)), OpProfiler,
                       ProfilerConfig)
    assert jstep is not None and step == jstep
    # the panicking step's iteration never completed in either package
    assert net.iterationCount == jnet.iterationCount == step


def test_graph_fit_panics(fresh_profiler):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning import Sgd
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.profiler import OpProfiler, ProfilerConfig
    gb = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(1e12))
          .graphBuilder())
    gb.addInputs("in")
    gb.addLayer("fc", DenseLayer.builder().nIn(4).nOut(8)
                .activation("relu").build(), "in")
    gb.addLayer("out", OutputLayer.builder("mse").nIn(8).nOut(2)
                .activation("identity").build(), "fc")
    gb.setOutputs("out")
    g = ComputationGraph(gb.build(), device="cpu").init()
    d = _MOD_REF._data()
    f, lab = np.asarray(d.features.jax), np.asarray(d.labels.jax)
    step = _panic_step(lambda: g.fit(DataSet(f, lab)), OpProfiler,
                       ProfilerConfig)
    assert step is not None and g.iterationCount == step


def test_no_host_read_of_the_loss_with_panic_off(monkeypatch,
                                                 fresh_profiler):
    """With panic off the step leaves its loss on the device: no
    ``Tensor.item`` / ``__float__`` in ``fit``; with panic on, one."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.profiler import OpProfiler, ProfilerConfig
    _, net = _mlp_pair()
    d = _MOD_REF._data()
    ds = DataSet(np.asarray(d.features.jax), np.asarray(d.labels.jax))
    reads = []
    orig_float = torch.Tensor.__float__

    def counting(self):
        reads.append(1)
        return orig_float(self)
    monkeypatch.setattr(torch.Tensor, "__float__", counting)
    net.fit(ds)
    assert reads == [] and net._scoreArr is not None
    OpProfiler.getInstance().setConfig(ProfilerConfig(checkForNAN=True))
    net.fit(ds)
    assert reads == [1] and net._scoreArr is None


def test_fault_tolerant_trainer_rolls_back_the_panic(tmp_path,
                                                     fresh_profiler):
    """Under the supervisor the panic is a rollback, not an exception."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import FaultTolerantTrainer
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.profiler import OpProfiler, ProfilerConfig
    _, tconf = _panic_confs()
    net = MultiLayerNetwork(tconf, device="cpu").init()
    d = _MOD.__dict__["_data"]()
    it = ListDataSetIterator([d], batch=32)
    OpProfiler.getInstance().setConfig(
        ProfilerConfig(checkForNAN=True, checkForINF=True))
    try:
        tr = FaultTolerantTrainer(net, str(tmp_path), checkpointEveryN=50,
                                  lrBackoff=1e-13, durableExport=False)
        tr.fit(it, epochs=1)
    finally:
        OpProfiler.getInstance().setConfig(ProfilerConfig())
    from deeplearning4j_tpu_torch.telemetry import flight_recorder
    reasons = [r.get("reason", "") for r in flight_recorder().snapshot()
               if r.get("event") == "rollback"]
    assert tr.stats["rollbacks"] >= 1
    assert reasons and reasons[-1].startswith("NAN/INF panic: INF_PANIC")
    assert np.isfinite(net.score())


# ---------------------------------------------------------------------------
# the merged trace and the device trace
# ---------------------------------------------------------------------------

def test_tracer_file_merges_profiler_phases(tmp_path, fresh_profiler):
    """The reference's merge rule: profiler events shifted into the
    tracer's epoch, both ``tail``-bounded, and none when
    ``merge_profiler=False``."""
    from deeplearning4j_tpu.profiler import OpProfiler as JProf
    from deeplearning4j_tpu.telemetry.tracing import Tracer as JTracer
    from deeplearning4j_tpu_torch.telemetry.tracing import Tracer

    def run(tracer_cls, prof_cls, path):
        tr = tracer_cls()
        prof_cls._instance = None
        prof = prof_cls.getInstance()
        for i in range(3):
            with tr.span(f"step{i}"):
                with prof.phase("etl"):
                    pass
        tr.write_chrome_trace(str(path))
        full = json.loads(path.read_text())["traceEvents"]
        tr.write_chrome_trace(str(path), tail=2)
        tail = json.loads(path.read_text())["traceEvents"]
        tr.write_chrome_trace(str(path), merge_profiler=False)
        alone = json.loads(path.read_text())["traceEvents"]
        prof_cls._instance = None
        return full, tail, alone

    got = run(Tracer, fresh_profiler, tmp_path / "t.json")
    ref = run(JTracer, JProf, tmp_path / "r.json")
    for g, r in zip(got, ref):
        assert [e["name"] for e in g] == [e["name"] for e in r]
    full = got[0]
    steps = [e for e in full if e["name"].startswith("step")]
    etl = [e for e in full if e["name"] == "etl"]
    assert len(steps) == 3 and len(etl) == 3
    for s, p in zip(steps, etl):        # each phase inside its step span
        assert s["ts"] <= p["ts"] <= p["ts"] + p["dur"] <= \
            s["ts"] + s["dur"] + 1.0


def test_start_stop_trace_writes_a_device_trace(tmp_path, fresh_profiler):
    from deeplearning4j_tpu_torch.profiler import start_trace, stop_trace
    from deeplearning4j_tpu_torch.telemetry import (device_trace_active,
                                                    tracer)
    start_trace(str(tmp_path))
    try:
        assert device_trace_active()
        with pytest.raises(RuntimeError, match="already running"):
            start_trace(str(tmp_path))
        with tracer().span("traced_region"):
            torch.ones(8).sum()
    finally:
        stop_trace()
    assert not device_trace_active()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert "traced_region" in names


def test_ui_metrics_route_serves_the_registry():
    from deeplearning4j_tpu_torch.telemetry import get_registry
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, UIServer
    st = InMemoryStatsStorage(maxRecordsPerSession=1)
    st.putUpdate("m", {"iteration": 1, "score": 1.0})
    st.putUpdate("m", {"iteration": 2, "score": float("nan")})
    server = UIServer(port=0)
    server.attach(st)
    try:
        base = f"http://127.0.0.1:{server.port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "dl4j_tpu_ui_stats_records_dropped_total" in text
        data = json.loads(urllib.request.urlopen(
            base + "/train/m/data", timeout=10).read())
        assert data == [{"iteration": 2, "score": None}]
        assert urllib.request.urlopen(base + "/healthz",
                                      timeout=10).status == 200
    finally:
        server.stop()
    assert get_registry() is not None


# ---------------------------------------------------------------------------
# ROADMAP C36
# ---------------------------------------------------------------------------

def test_c36_ops_ext_names_equal_the_references():
    import deeplearning4j_tpu.autodiff.ops_ext as ref
    import deeplearning4j_tpu_torch.autodiff.ops_ext as port
    assert port.OPS_EXT_NAMES == ref.OPS_EXT_NAMES
    assert port._CORE_OPS == ref._CORE_OPS
    assert len(port.OPS_EXT_NAMES) > 100
