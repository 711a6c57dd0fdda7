"""The producer pool and the staging ring in the port
(``datavec/pipeline.py``), ROADMAP C21 and C22, and the mask finding:

- the reference's ``tests/test_etl_pipeline.py`` run against the port,
  each case in a fresh metrics registry as the reference's autouse fixture
  gives it: record sharding, exactly-once delivery, reset mid-epoch,
  worker exception and hard death surfaced, a queued error re-raised at
  ``reset()``, the epoch signal, the ETL telemetry series,
  ``maybe_prefetch``'s selection, the iterators' exhausted-reader and
  label contracts (its sleep-based two-process throughput smoke is
  ``slow`` in the reference and left out here);
- the pool's batches equal the inline iterator's shards on the CPU; a
  worker runs in host-only mode on one torch thread; a source holding a
  tensor off the CPU is refused at construction; the restart replay skips
  exactly the delivered batches;
- C21: the models' outputs and parameters are the port's ``NDArray``,
  ``DataSet`` holds ``NDArray``s, and a batch's tensor reaches the model
  without a host round trip;
- C22: ``MultiLayerNetwork.fit`` on a streaming iterator engages the pool
  and closes it; ``ComputationGraph.fit`` does not, as in the reference;
- the mask finding: ``SequenceRecordReaderDataSetIterator`` always
  attaches a features mask, and attention with a mask takes the dense
  path in both packages, so a DataVec-fed attention net never reaches the
  flash kernels (B1-B3).
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datavec as J
import deeplearning4j_tpu_torch.datavec as T
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datavec import pipeline
from deeplearning4j_tpu_torch.ops import NDArray
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry
from tests._torch_parity import (PORT, _reference_tests,
                                 _run_reference_test)

pytestmark = pytest.mark.torch_port

# left out: test_two_process_throughput_smoke, ``slow`` in the reference
# (a sleep-based speed-up bound that flakes under a loaded test run)
_MOD, _CASES = _reference_tests(
    "test_etl_pipeline.py", exclude=("test_two_process_throughput_smoke",))


@pytest.fixture
def fresh_registry():
    prev = telemetry.set_registry(MetricsRegistry())
    yield telemetry.get_registry()
    telemetry.set_registry(prev)


@pytest.mark.parametrize("case", [c for _, c in _CASES],
                         ids=[i for i, _ in _CASES])
def test_reference_etl_pipeline_tests_pass_on_the_port(case, tmp_path,
                                                       monkeypatch,
                                                       fresh_registry):
    _run_reference_test(case, tmp_path, monkeypatch)


def test_reference_cases_are_all_collected():
    assert len(_CASES) == 26


# ---------------------------------------------------------------------------
# the pool on the CPU
# ---------------------------------------------------------------------------

def _csv_iterator(P, n=40, batch=4):
    csv = "\n".join(f"{i},{(i * 7) % 11},{i % 3}" for i in range(n))
    rr = P.CSVRecordReader()
    rr.initialize(P.StringSplit(csv))
    return P.RecordReaderDataSetIterator(rr, batchSize=batch, labelIndex=2,
                                         numPossibleLabels=3)


def test_pool_batches_equal_the_inline_shards(fresh_registry):
    """Each pool batch is, bit for bit, a batch of one worker's shard
    drained inline; every record arrives exactly once; the batches are CPU
    arrays (no device asked for)."""
    it = _csv_iterator(T)
    pit = T.PrefetchingDataSetIterator(it, numWorkers=3, queueDepth=3)
    try:
        got = []
        while pit.hasNext():
            ds = pit.next()
            assert isinstance(ds.features, NDArray)
            assert ds.features.torch.device.type == "cpu"
            got.append((ds.features.numpy().copy(),
                        ds.labels.numpy().copy()))
    finally:
        pit.close()
    inline = []
    for w in range(3):
        sh = it.shard(w, 3)
        while sh.hasNext():
            d = sh.next()
            inline.append((d.features.numpy(), d.labels.numpy()))
    assert len(got) == len(inline)
    key = lambda fl: fl[0].tobytes() + fl[1].tobytes()
    assert sorted(map(key, got)) == sorted(map(key, inline))
    ids = sorted(int(r) for f, _ in got for r in f[:, 0])
    assert ids == list(range(40))
    reg = fresh_registry
    assert reg.get("dl4j_tpu_etl_h2d_bytes_total").value() == sum(
        f.nbytes + l.nbytes for f, l in got)


def _worker_state_factory(spec):
    import gc
    from deeplearning4j_tpu_torch.ops.ndarray import host_only_arrays
    from deeplearning4j_tpu_torch.ops import Nd4j
    made = Nd4j.zeros(2)                 # creation without device=
    yield DataSet(np.array([[float(host_only_arrays()),
                             float(torch.get_num_threads()),
                             float(made.torch.device.type == "cpu"),
                             float(gc.get_freeze_count() > 0)]],
                           np.float32), np.zeros((1, 1), np.float32))


def test_workers_run_host_only_on_one_thread(fresh_registry):
    """A worker makes CPU arrays on one torch thread, and the heap it
    inherited is frozen (its collector never frees a parent's tensor);
    the parent's heap is unfrozen again."""
    import gc
    pit = T.PrefetchingDataSetIterator(_worker_state_factory, numWorkers=2)
    try:
        rows = [pit.next().features.numpy()[0].tolist()
                for _ in range(2)]
    finally:
        pit.close()
    assert rows == [[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]]
    assert gc.get_freeze_count() == 0


class _Held(ListDataSetIterator):
    def streaming(self):
        return True


def test_a_source_holding_a_device_tensor_is_refused():
    src = _Held([DataSet(np.zeros((2, 2), np.float32),
                        np.zeros((2, 1), np.float32))])
    src.stats = torch.empty(3, device="meta")     # not a CPU tensor
    with pytest.raises(ValueError, match="workers must not touch the card"):
        T.PrefetchingDataSetIterator(src, numWorkers=1)
    assert T.maybe_prefetch(src) is src           # falls back inline
    src.stats = torch.zeros(3)
    T.PrefetchingDataSetIterator(src, numWorkers=1).close()


def test_restart_replays_past_the_delivered_batches(fresh_registry):
    pit = T.PrefetchingDataSetIterator(_csv_iterator(T, n=24, batch=3),
                                       numWorkers=1, queueDepth=2)
    try:
        first = [pit.next().features.numpy()[:, 0].tolist()
                 for _ in range(3)]
        pit.requestRestart()
        rest = []
        while pit.hasNext():
            rest.append(pit.next().features.numpy()[:, 0].tolist())
    finally:
        pit.close()
    ids = [int(i) for b in first + rest for i in b]
    assert ids == list(range(24))
    assert fresh_registry.get(
        "dl4j_tpu_etl_pool_restarts_total").value() == 1


def test_stage_batch_on_the_host_hands_out_cpu_arrays():
    ds = DataSet(np.arange(6, dtype=np.float32).reshape(2, 3),
                 np.eye(2, dtype=np.float32))
    out = pipeline.stage_batch(ds, "cpu").materialize()
    np.testing.assert_array_equal(out.features.numpy(), ds.features.numpy())
    assert out.features.torch.data_ptr() != ds.features.torch.data_ptr()
    it = T.AsyncDataSetIterator(ListDataSetIterator([ds, ds]), device="cpu")
    assert [d.labels.numpy().tolist() for d in it] == [np.eye(2).tolist()] * 2


def test_ragged_reader_names_a11_and_hash_feature_is_the_references():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        T.pipeline.RaggedFeatureReader([], 1, 8, 2)
    v = np.random.RandomState(0).randint(0, 2 ** 40, 1000)
    np.testing.assert_array_equal(pipeline.hash_feature(v, 4099),
                                  J.pipeline.hash_feature(v, 4099))


# ---------------------------------------------------------------------------
# C21: NDArray out of the models and in the DataSet
# ---------------------------------------------------------------------------

def _mlp(P, device=None):
    c = P.conf
    conf = (c.NeuralNetConfiguration.builder().seed(3)
            .updater(P.learn.Sgd(0.1)).list()
            .layer(P.layers.DenseLayer.builder().nIn(2).nOut(5)
                   .activation("tanh").build())
            .layer(P.layers.OutputLayer.builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(c.InputType.feedForward(2)).build())
    kw = {} if device is None else {"device": device}
    return P.models.MultiLayerNetwork(conf, **kw).init()


def test_c21_model_methods_return_ndarray():
    net = _mlp(PORT, "cpu")
    x = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    out = net.output(x)
    assert isinstance(out, NDArray) and out.torch.device.type == "cpu"
    assert out.argMax(1).shape == (4,)            # net.output(x).argMax(1)
    assert isinstance(net.output(NDArray(x)), NDArray)
    assert all(isinstance(a, NDArray) for a in net.feedForward(x))
    assert isinstance(net.params(), NDArray)
    assert all(isinstance(v, NDArray) for v in net.paramTable().values())
    w = net.getParam("0_W")
    assert isinstance(w, NDArray)
    net.setParam("0_W", w.mul(2.0))
    np.testing.assert_allclose(net.getParam("0_W").numpy(),
                               w.numpy() * 2.0)
    net.setParams(net.params())
    g = PORT.models.ComputationGraph(_graph_conf(), device="cpu").init()
    assert isinstance(g.output(x), NDArray)
    assert isinstance(g.outputSingle(x), NDArray)
    assert isinstance(g.params(), NDArray)


def _graph_conf():
    c, L = PORT.conf, PORT.layers
    return (c.NeuralNetConfiguration.builder().seed(3).graphBuilder()
            .addInputs("in")
            .addLayer("d", L.DenseLayer.builder().nIn(2).nOut(4)
                      .activation("relu").build(), "in")
            .addLayer("out", L.OutputLayer.builder("mse").nOut(1)
                      .activation("identity").build(), "d")
            .setOutputs("out")
            .setInputTypes(c.InputType.feedForward(2)).build())


def test_c21_dataset_holds_ndarrays_and_wrapping_never_moves_data():
    f = np.ones((3, 2), np.float32)
    t = torch.zeros(3, 1)
    ds = DataSet(f, t, featuresMask=NDArray(np.ones((3, 1), np.float32)))
    for a in (ds.features, ds.labels, ds.featuresMask):
        assert isinstance(a, NDArray)
    assert ds.labels.torch is t                   # a tensor keeps its place
    assert ds.labelsMask is None
    ds.features = torch.full((3, 2), 2.0)         # assignment wraps too
    assert isinstance(ds.features, NDArray)


def test_c21_a_batch_reaches_the_model_without_a_host_round_trip(
        monkeypatch):
    net = _mlp(PORT, "cpu")
    rng = np.random.RandomState(1)
    ds = DataSet(rng.randn(8, 2).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])

    def no_host(*a, **k):
        raise AssertionError("the batch went through the host")

    monkeypatch.setattr(NDArray, "__array__", no_host)
    monkeypatch.setattr(NDArray, "numpy", no_host)
    net.fit(ds)
    net.output(ds.features)
    assert np.isfinite(net.score())


# ---------------------------------------------------------------------------
# C22: MultiLayerNetwork.fit engages the pool; ComputationGraph.fit does not
# ---------------------------------------------------------------------------

def _spy_pool(monkeypatch):
    made, closed = [], []
    real = pipeline.PrefetchingDataSetIterator

    class Spy(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(k.get("device"))

        def close(self):
            closed.append(True)
            super().close()

    monkeypatch.setattr(pipeline, "PrefetchingDataSetIterator", Spy)
    return made, closed


def _stream(P, n=24):
    rng = np.random.RandomState(2)
    rows = [[float(rng.randn()), float(rng.randn()), int(rng.randint(3))]
            for _ in range(n)]
    csv = "\n".join(",".join(str(v) for v in r) for r in rows)
    rr = P.CSVRecordReader()
    rr.initialize(P.StringSplit(csv))
    return P.RecordReaderDataSetIterator(rr, 6, labelIndex=2,
                                         numPossibleLabels=3)


def test_c22_multilayer_fit_engages_the_pool_and_closes_it(monkeypatch,
                                                           fresh_registry):
    monkeypatch.delenv("DL4J_TPU_ETL_WORKERS", raising=False)
    made, closed = _spy_pool(monkeypatch)
    net = _mlp(PORT, "cpu")
    it = _stream(T)
    assert it.streaming()
    net.fit(it, epochs=2)
    assert made == [net.device] and closed == [True]
    assert net.getIterationCount() == 8 and net.getEpochCount() == 2
    assert fresh_registry.get(
        "dl4j_tpu_etl_pool_batches_total").value() == 8
    assert fresh_registry.get("dl4j_tpu_etl_pool_workers").value() == 0
    # an in-memory iterator passes through, as in the reference
    net.fit(ListDataSetIterator([it.reset() or it.next()]))
    assert len(made) == 1


def test_c22_pool_fit_trains_as_the_inline_fit(monkeypatch):
    """The pool's two workers hand out the records' shards; with one worker
    the order is the inline order and the parameters equal the inline
    fit's bit for bit."""
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "1")
    a, b = _mlp(PORT, "cpu"), _mlp(PORT, "cpu")
    a.fit(_stream(T), epochs=2)
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "0")
    b.fit(_stream(T), epochs=2)
    assert torch.equal(a.params().torch, b.params().torch)


def test_c22_graph_fit_does_not_engage_the_pool(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_ETL_WORKERS", raising=False)
    made, _ = _spy_pool(monkeypatch)
    g = PORT.models.ComputationGraph(_graph_conf(), device="cpu").init()
    rng = np.random.RandomState(5)
    rows = [[float(rng.randn()), float(rng.randn()), float(rng.randn())]
            for _ in range(12)]
    rr = T.CollectionRecordReader(rows)

    class Streaming(T.RecordReaderDataSetIterator):
        def streaming(self):
            return True

    g.fit(Streaming(rr, 4, labelIndex=2, regression=True))
    assert made == [] and g.iterationCount == 3


# ---------------------------------------------------------------------------
# the mask finding: DataVec sequences never reach the flash kernels
# ---------------------------------------------------------------------------

def _seq_dir(tmp_path, n=4, t=6):
    rng = np.random.RandomState(7)
    for i in range(n):
        (tmp_path / f"s{i}.csv").write_text("\n".join(
            ",".join(f"{v:.4f}" for v in rng.randn(4)) for _ in range(t)))
    return tmp_path


def test_sequence_iterator_always_attaches_a_features_mask(tmp_path):
    d = _seq_dir(tmp_path)
    for P in (J, T):
        rr = P.CSVSequenceRecordReader()
        rr.initialize(P.FileSplit(d))
        ds = P.SequenceRecordReaderDataSetIterator(
            rr, 2, numPossibleLabels=-1, labelIndex=3,
            regression=True).next()
        assert ds.featuresMask is not None and ds.labels.shape == (2, 1, 6)
        assert np.asarray(ds.featuresMask.numpy()).min() == 1.0  # all valid


def test_attention_with_a_mask_takes_the_dense_path_in_both_packages(
        monkeypatch):
    """The reference's auto dispatch picks flash only without a mask
    (``parallel/ring.py``: ``long_seq and on_tpu and mask is None``), the
    port's ``_auto_impl`` the same; so the long-context net fed by
    ``SequenceRecordReaderDataSetIterator`` runs dense attention in both
    (a reference fault the port keeps, ROADMAP C)."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import ring as jring
    from deeplearning4j_tpu_torch.parallel import ring as tring
    shape = (1, 2, 1024, 16)
    dts = (torch.bfloat16,) * 3
    assert tring._auto_impl(shape, shape, shape, dts, True, True) == "dense"
    assert tring._auto_impl(shape, shape, shape, dts, False, True) == "flash"

    class FakeTpu:
        platform = "tpu"

    calls = []
    monkeypatch.setattr(jring.jax, "devices", lambda *a: [FakeTpu()])
    monkeypatch.setattr(jring, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0])
    q = jnp.ones(shape, jnp.float32)
    mask = jnp.ones((1, 1024), jnp.float32)
    jring.dot_product_attention(q, q, q, mask=mask)
    assert calls == []                     # masked: dense, no kernel
    jring.dot_product_attention(q, q, q)
    assert calls == ["flash"]              # unmasked: the kernel
    assert jax is not None


def test_a_datavec_fed_attention_fit_passes_the_mask(tmp_path, monkeypatch):
    """The port's attention layer receives the iterator's mask during
    ``fit``, so its dispatch sees ``has_mask`` (dense on any device)."""
    from deeplearning4j_tpu_torch.nn.conf import attention as tatt
    seen = []
    real = tatt.dot_product_attention
    monkeypatch.setattr(tatt, "dot_product_attention",
                        lambda *a, **k: seen.append(
                            k.get("mask") is not None) or real(*a, **k))
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "0")
    c = PORT.conf
    conf = (c.NeuralNetConfiguration.builder().seed(2)
            .updater(PORT.learn.Adam(1e-3)).list()
            .layer(PORT.att.SelfAttentionLayer.builder().nIn(3).nOut(8)
                   .nHeads(2).headSize(4).build())
            .layer(PORT.rec.RnnOutputLayer.builder("mse").nOut(1)
                   .activation("identity").build())
            .setInputType(c.InputType.recurrent(3, 6)).build())
    net = PORT.models.MultiLayerNetwork(conf, device="cpu").init()
    rr = T.CSVSequenceRecordReader()
    rr.initialize(T.FileSplit(_seq_dir(tmp_path)))
    net.fit(T.SequenceRecordReaderDataSetIterator(
        rr, 2, numPossibleLabels=-1, labelIndex=3, regression=True))
    assert seen and all(seen)
    assert np.isfinite(net.score())
