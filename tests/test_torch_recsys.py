"""The recommender tier in the port (ROADMAP A11's rest):
``nn/conf/embedding.py``, ``models/recsys.py``, ``zoo``'s
``TwoTowerRecommender`` and ``DLRM``, ``datavec/pipeline.py``'s
``RaggedFeatureReader``, the ``dl4j_tpu_recsys_*`` telemetry and
``recsys_hash_collision_rule``, against the reference on the same seeded
numpy inputs:

- ``bag_lookup`` / ``bag_lookup_dedup`` (sum and mean, a lossless and a
  too-small unique buffer) and their gradients (1e-6);
  ``embedding_lookup_table_parallel`` raises naming A10;
- ``ShardedEmbeddingBag`` (with its weights mask), ``FeatureInteraction-
  Layer`` and ``DotProductScorer``: outputs and gradients through
  ``_layer_parity`` (1e-5), JSON both ways;
- a narrow DLRM and a narrow two-tower net, the port's parameters carried
  into the reference, three ``fit`` steps each (loss and parameters
  within 1e-5; Adam moves every row of the dense table as the reference
  does); configurations' JSON equal; zips restore in the other package;
- ``RaggedFeatureReader`` batches (features, weights, labels, ``offsets``)
  bit-identical, the ingestion and collision counters equal; exactly once
  across a pool restart and through the pickle fallback;
- ``topk_retrieve`` through the port's ``ContinuousBatcher`` against the
  reference's batcher and the flat ranking; k = 1 requests pass a
  page-deficit admission rule and run no decode step;
- ROADMAP C25: the reference's decode step masks the corpus's last item;
  ROADMAP C26: half-precision ids are refused.

The reference's mesh tests (table-parallel lookup, sharded trajectories,
elastic re-mesh) wait for ROADMAP A10 and are not run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.nn.conf.embedding as jemb
import deeplearning4j_tpu.telemetry as jtel
import deeplearning4j_tpu.zoo as jz
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.nn.conf.embedding as temb
import deeplearning4j_tpu_torch.telemetry as ttel
import deeplearning4j_tpu_torch.zoo as tz
from deeplearning4j_tpu.datavec.pipeline import \
    RaggedFeatureReader as JRagged
from deeplearning4j_tpu.models import recsys as jrec
from deeplearning4j_tpu.remote import (BucketLadder as JLadder,
                                       ContinuousBatcher as JBatcher)
from deeplearning4j_tpu.utils import ModelSerializer as JMS
from deeplearning4j_tpu_torch.datavec.pipeline import (
    PrefetchingDataSetIterator, RaggedFeatureReader)
from deeplearning4j_tpu_torch.models import recsys as trec
from deeplearning4j_tpu_torch.remote import (AdmissionControl, BucketLadder,
                                             ContinuousBatcher,
                                             ServiceOverloaded)
from deeplearning4j_tpu_torch.utils import ModelSerializer as TMS
from tests._torch_parity import _carried, _json_round_trip, _layer_parity

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-5, rtol=1e-5)
DLRM_KW = dict(numEmbeddings=600, embeddingDim=8, numFields=3, bagSize=4,
               denseUnits=(16, 8))
TWO_TOWER_KW = dict(numEmbeddings=300, embeddingDim=8, bagSize=4)


@pytest.fixture
def registries():
    """Fresh metrics registries in both packages (the counters start at
    0); the previous ones put back."""
    tprev = ttel.set_registry(ttel.MetricsRegistry())
    jprev = jtel.set_registry(jtel.MetricsRegistry())
    yield ttel.get_registry(), jtel.get_registry()
    ttel.set_registry(tprev)
    jtel.set_registry(jprev)


def _value(reg, name, **labels):
    m = reg.get(name)
    return m.value(**labels) if m is not None else 0.0


# ---------------------------------------------------------------- lookup ----

def _lookup_inputs(seed=0, vocab=40, dim=6, rows=12, bag=5):
    rng = np.random.RandomState(seed)
    W = rng.randn(vocab, dim).astype(np.float32)
    ids = rng.randint(0, vocab, (rows, bag)).astype(np.int32)
    ids[:, -1] = ids[:, 0]                           # duplicates in a bag
    w = rng.randint(0, 3, (rows, bag)).astype(np.float32)
    return W, ids, w


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dedupSize", [0, 100, 9])
def test_bag_lookups_and_gradients_equal_the_references(combiner,
                                                        dedupSize):
    """``dedupSize`` 9 is below the batch's distinct count: both packages
    drop the same largest ids and read the buffer's last row for them."""
    W, ids, w = _lookup_inputs()
    r = np.random.RandomState(1).randn(ids.shape[0], W.shape[1]).astype(
        np.float32)
    for fn in ("bag_lookup", "bag_lookup_dedup"):
        kw = {} if fn == "bag_lookup" else {"dedupSize": dedupSize}

        def jloss(Wj):
            return jnp.sum(getattr(jemb, fn)(Wj, jnp.asarray(ids),
                                             jnp.asarray(w), combiner,
                                             **kw) * r)

        jout = np.asarray(getattr(jemb, fn)(jnp.asarray(W), jnp.asarray(ids),
                                            jnp.asarray(w), combiner, **kw))
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(W)))
        tW = torch.tensor(W, requires_grad=True)
        out = getattr(temb, fn)(tW, torch.tensor(ids), torch.tensor(w),
                                combiner, **kw)
        (out * torch.from_numpy(r)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(tW.grad.numpy(), jg, atol=1e-6, rtol=1e-6)
    full = temb.bag_lookup(torch.tensor(W), torch.tensor(ids),
                           torch.tensor(w), combiner)
    dedup = temb.bag_lookup_dedup(torch.tensor(W), torch.tensor(ids),
                                  torch.tensor(w), combiner, dedupSize)
    assert torch.equal(full, dedup) == (dedupSize != 9)


def test_table_parallel_lookup_waits_for_a10_and_bytes_match():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        temb.embedding_lookup_table_parallel(None, None, None)
    for args in ((4, 128, 16), (8, 1000, 64, 2, 8)):
        assert temb.alltoall_bytes_per_lookup(*args) == \
            jemb.alltoall_bytes_per_lookup(*args)
    v = np.random.RandomState(0).randint(0, 2 ** 40, 1000)
    np.testing.assert_array_equal(temb.hash_feature(v, 977),
                                  jemb.hash_feature(v, 977))


# ---------------------------------------------------------------- layers ----

@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_sharded_embedding_bag_forward_and_gradient(combiner):
    jl = jemb.ShardedEmbeddingBag(numEmbeddings=40, embeddingDim=6,
                                  numFields=3, combiner=combiner,
                                  dedupSize=0)
    tl = temb.ShardedEmbeddingBag(numEmbeddings=40, embeddingDim=6,
                                  numFields=3, combiner=combiner)
    W, ids, w = _lookup_inputs(rows=8, bag=12)
    _layer_parity(jl, tl, {"W": W}, ids.astype(np.float32), mask=w)
    _layer_parity(jl, tl, {"W": W}, ids.astype(np.float32))
    layer, ref, back = _json_round_trip(jl)
    assert type(layer) is temb.ShardedEmbeddingBag and back == ref
    assert tl.rowShardedParamKeys() == jl.rowShardedParamKeys() == ("W",)


def test_recsys_layers_forward_and_gradient():
    rng = np.random.RandomState(2)
    x = rng.randn(5, 4 * 6).astype(np.float32)
    out, _ = _layer_parity(jrec.FeatureInteractionLayer(numFields=4,
                                                        embeddingDim=6),
                           trec.FeatureInteractionLayer(numFields=4,
                                                        embeddingDim=6),
                           {}, x)
    assert out.shape == (5, 24 + 6)
    e = x.reshape(5, 4, 6)
    np.testing.assert_allclose(out[:, 24 + 2].numpy(),
                               (e[:, 0] * e[:, 3]).sum(1), rtol=1e-5)
    _layer_parity(jrec.DotProductScorer(embeddingDim=12),
                  trec.DotProductScorer(embeddingDim=12), {}, x)
    for jl in (jrec.FeatureInteractionLayer(numFields=4, embeddingDim=6),
               jrec.DotProductScorer(embeddingDim=12)):
        layer, ref, back = _json_round_trip(jl)
        assert type(layer).__name__ == type(jl).__name__ and back == ref


def test_c26_half_precision_ids_are_refused():
    """ROADMAP C26: ids ride as float features, exact to 2**24 in float32
    but only to 256 in bf16; the reference's BFLOAT16 net casts them and
    looks up the wrong rows; the port refuses."""
    tl = temb.ShardedEmbeddingBag(numEmbeddings=1000, embeddingDim=4,
                                  numFields=1)
    W = torch.zeros(1000, 4)
    x = torch.tensor([[257.0, 513.0]], dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        tl.forward({"W": W}, x, False, None, {})


# ------------------------------------------------------------ the nets ----

def _batches(kw, steps, seed, two_tower):
    rng = np.random.RandomState(seed)
    width = (2 if two_tower else kw["numFields"]) * kw["bagSize"]
    out = []
    for _ in range(steps):
        f = rng.randint(0, kw["numEmbeddings"], (16, width)).astype(
            np.float32)
        w = rng.randint(0, 3, (16, width)).astype(np.float32)
        y = rng.randint(0, 2, (16, 1)).astype(np.float32) if two_tower \
            else np.eye(2, dtype=np.float32)[rng.randint(0, 2, 16)]
        out.append((f, y, w))
    return out


@pytest.fixture(scope="module")
def net_pairs():
    return {"DLRM": _carried("DLRM", DLRM_KW),
            "TwoTowerRecommender": _carried("TwoTowerRecommender",
                                            TWO_TOWER_KW)}


@pytest.mark.parametrize("name", ["DLRM", "TwoTowerRecommender"])
def test_narrow_nets_fit_three_steps_as_the_reference(net_pairs, name):
    net, jnet = net_pairs[name]
    assert net.conf.toJson() == jnet.conf.toJson()
    kw = DLRM_KW if name == "DLRM" else TWO_TOWER_KW
    batches = _batches(kw, 3, 7, name != "DLRM")
    for i, (f, y, w) in enumerate(batches):
        net.fit(tds.DataSet(f, y, featuresMask=w))
        jnet.fit(jds.DataSet(f, y, featuresMask=w))
        assert abs(net.score() - float(jnet.score())) <= 1e-5
        if i == 0:
            W1 = net.params_["0"]["W"].numpy().copy()
    for k, lp in net.params_.items():
        for p, v in lp.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jnet.params_[k][p]),
                                       err_msg=f"{k}/{p}", **TOL)
    # dense Adam, as the reference's: a row the first batch touched (with
    # weight) and the later two did not still moves on their steps,
    # through its moments
    def rows(f, w):
        return set(f[w > 0].astype(int).tolist())
    only_first = rows(*batches[0][::2]) - rows(*batches[1][::2]) \
        - rows(*batches[2][::2])
    assert only_first
    W3 = net.params_["0"]["W"].numpy()
    moved = [r for r in only_first if not np.array_equal(W1[r], W3[r])]
    assert moved == sorted(only_first) or set(moved) == only_first


@pytest.mark.parametrize("name", ["DLRM", "TwoTowerRecommender"])
@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_zips_restore_in_the_other_package(net_pairs, name, direction,
                                           tmp_path):
    net, jnet = net_pairs[name]
    path = str(tmp_path / "m.zip")
    kw = DLRM_KW if name == "DLRM" else TWO_TOWER_KW
    f, y, w = _batches(kw, 1, 11, name != "DLRM")[0]
    if direction == "port->jax":
        TMS.writeModel(net, path)
        back = JMS.restoreMultiLayerNetwork(path)
        src_out = net.output(f).numpy()
        back_out = np.asarray(back.output(f))
    else:
        JMS.writeModel(jnet, path)
        back = TMS.restoreMultiLayerNetwork(path, device="cpu")
        src_out = np.asarray(jnet.output(f))
        back_out = back.output(f).numpy()
    assert back.conf.toJson() == net.conf.toJson()
    np.testing.assert_allclose(back_out, src_out, **TOL)


def test_zoo_defaults_build_like_the_references(monkeypatch):
    from tests._torch_parity import _zoo_conf
    for name in ("DLRM", "TwoTowerRecommender"):
        tconf = _zoo_conf(getattr(tz, name)(), monkeypatch)
        jconf = _zoo_conf(getattr(jz, name)(), monkeypatch)
        assert tconf.toJson() == jconf.toJson()
        assert getattr(tz, name).builder().numEmbeddings(64).build() \
            .numEmbeddings == 64


# --------------------------------------------------------------- ragged ----

def _ragged_records(n=24, fields=2, seed=5, hi=10 ** 6):
    rng = np.random.RandomState(seed)

    def bag():
        return rng.randint(0, hi, (rng.randint(1, 9),)).tolist()

    return [(tuple(bag() for _ in range(fields)) if fields > 1 else bag(),
             int(rng.randint(0, 2))) for _ in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("features", "featuresMask", "labels", "offsets"):
            a, b = getattr(g, k).numpy(), np.asarray(getattr(w, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def _drain(it):
    out = []
    while it.hasNext():
        out.append(it.next())
    return out


@pytest.mark.parametrize("kw", [
    dict(numFields=2, numEmbeddings=512),
    dict(numFields=1, numEmbeddings=3, collisionSampleEvery=1),
    dict(numFields=3, numEmbeddings=10 ** 6, bagBuckets=(8, 16),
         collisionSampleSize=3),
    dict(numFields=2, numEmbeddings=97, hashInputs=False),
    dict(numFields=2, numEmbeddings=64, collisionSampleEvery=0)],
    ids=["two-fields", "colliding", "buckets", "raw-ids", "no-sampling"])
def test_ragged_batches_and_counters_equal_the_references(registries, kw):
    treg, jreg = registries
    fields = kw["numFields"]
    recs = _ragged_records(n=30, fields=fields,
                           hi=60 if kw.get("hashInputs") is False
                           else 10 ** 6)
    got = _drain(RaggedFeatureReader(recs, 7, numClasses=2, **kw))
    want = _drain(JRagged(recs, 7, numClasses=2, **kw))
    _assert_batches_equal(got, want)
    for name, labels in (("dl4j_tpu_recsys_lookup_rows_total",
                          {"phase": "raw"}),
                         ("dl4j_tpu_recsys_lookup_rows_total",
                          {"phase": "stored"}),
                         ("dl4j_tpu_recsys_hash_collisions_total", {}),
                         ("dl4j_tpu_recsys_dedup_ratio", {})):
        assert _value(treg, name, **labels) == _value(jreg, name, **labels)
    if kw["numEmbeddings"] == 3:
        assert _value(treg, "dl4j_tpu_recsys_hash_collisions_total") >= 1


def test_ragged_reader_refusals_match():
    recs = [((1, 2), 0)]
    for R in (RaggedFeatureReader, JRagged):
        with pytest.raises(ValueError, match="expected 3"):
            R(recs, 1, 8, 2, numFields=3).next()
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            R([(list(range(9)), 0)], 1, 10 ** 6, 2, bagBuckets=(4, 8)).next()
        r = R(recs, 1, 8, 2)
        r.next()
        with pytest.raises(StopIteration):
            r.next()


def test_ragged_exactly_once_under_pool_restart():
    """A restart of the port's pool mid-drain replays past the delivered
    prefix: every batch once, in order, equal to the reference's."""
    recs = _ragged_records(n=24)
    want = _drain(JRagged(recs, 4, 512, 2, numFields=2))
    pit = PrefetchingDataSetIterator(
        RaggedFeatureReader(recs, 4, 512, 2, numFields=2), numWorkers=1)
    try:
        got = [pit.next(), pit.next()]
        pit.requestRestart()
        while pit.hasNext():
            got.append(pit.next())
    finally:
        pit.close()
    _assert_batches_equal(got, want)


def test_ragged_offsets_survive_the_pickle_fallback():
    recs = _ragged_records(n=8)
    want = _drain(JRagged(recs, 4, 512, 2, numFields=2))
    pit = PrefetchingDataSetIterator(
        RaggedFeatureReader(recs, 4, 512, 2, numFields=2), numWorkers=1,
        shmBytes=8)
    try:
        got = _drain(pit)
    finally:
        pit.close()
    _assert_batches_equal(got, want)


def test_collision_estimator_feeds_the_health_rule(registries):
    """The reference's ``test_servfault.py`` collision case on the port:
    64 ids into 3 rows collide; the rule fires; sampling off adds
    nothing.  A pool worker runs host-only and counts nothing (as the
    reference's workers do)."""
    treg, _ = registries
    recs = [([i], i % 2) for i in range(64)]
    r = RaggedFeatureReader(recs, 16, 3, 2, collisionSampleEvery=1)
    _drain(r)
    seen = _value(treg, "dl4j_tpu_recsys_hash_collisions_total")
    assert seen >= 1
    mon = ttel.HealthMonitor(rules=[ttel.recsys_hash_collision_rule()],
                             interval=3600)
    assert "recsys_hash_collision" in mon.evaluate_once(now=0.0)
    _drain(RaggedFeatureReader(recs, 16, 3, 2, collisionSampleEvery=0))
    assert _value(treg, "dl4j_tpu_recsys_hash_collisions_total") == seen
    pit = PrefetchingDataSetIterator(
        RaggedFeatureReader(recs, 16, 3, 2, collisionSampleEvery=1),
        numWorkers=1)
    try:
        _drain(pit)
    finally:
        pit.close()
    assert _value(treg, "dl4j_tpu_recsys_hash_collisions_total") == seen


# -------------------------------------------------------------- serving ----

def _tables(vocab=64, dim=8, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randn(vocab, dim).astype(np.float32), \
        rng.randn(vocab, dim).astype(np.float32)


def _flat_topk(users, items, prompt, k):
    u = users[np.asarray(prompt)].mean(0)
    return np.argsort(-(u @ items.T), kind="stable")[:k].astype(np.int32)


@pytest.fixture(scope="module")
def batchers():
    users, items = _tables()
    lm = trec.RetrievalLM(users, items, maxLen=32, device="cpu")
    jlm = jrec.RetrievalLM(users, items, maxLen=32)
    ladder = dict(batchSizes=(2,), seqLens=(8, 16))
    cb = ContinuousBatcher(lm, name="recsys-topk", pageSize=8, maxSlots=2,
                           ladder=BucketLadder(**ladder)).start()
    jcb = JBatcher(jlm, name="recsys-topk-ref", pageSize=8, maxSlots=2,
                   ladder=JLadder(**ladder)).start()
    yield (users, items), cb, jcb
    cb.shutdown()
    jcb.shutdown()


def test_topk_through_the_batcher_equals_the_references(batchers,
                                                        registries):
    """Concurrent-free ragged requests, k from 1 to 8: the port's top-k
    equals the reference batcher's and the flat ranking (no request here
    ranks the corpus's last item after rank 1: C25)."""
    (users, items), cb, jcb = batchers
    treg, _ = registries
    rng = np.random.RandomState(11)
    for n, k in ((5, 5), (9, 3), (3, 6), (16, 8), (1, 1), (12, 2)):
        p = rng.randint(0, 63, (n,)).astype(np.int32)
        out = trec.topk_retrieve(cb, p[None, :], k, timeout=120)
        jout = jrec.topk_retrieve(jcb, p[None, :], k, timeout=120)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(out[0],
                                      _flat_topk(users, items, p, k))
    h = treg.get("dl4j_tpu_recsys_topk_latency_seconds")
    assert h is not None and h.count() == 6


def test_single_step_retrieval_bypasses_the_kv_shed():
    """k = 1 emits at admission and retires before any decode step: it
    holds no KV page, so the page-deficit rule does not shed it, while a
    k = 4 request against the same pool does."""
    users, items = _tables()
    lm = trec.RetrievalLM(users, items, maxLen=32, device="cpu")
    cb = ContinuousBatcher(
        lm, name="recsys-shed", pageSize=8, maxSlots=2,
        admission=AdmissionControl(minFreePages=10 ** 9,
                                   retryAfter=0.1)).start()
    try:
        ids = np.arange(1, 7, dtype=np.int32)
        with pytest.raises(ServiceOverloaded):
            cb.submit({"tokens": ids.tolist(), "maxNewTokens": 4},
                      timeout=120)
        steps = cb._steps
        out = cb.submit({"tokens": ids.tolist(), "maxNewTokens": 1},
                        timeout=120)
        np.testing.assert_array_equal(out[0],
                                      _flat_topk(users, items, ids, 1))
        assert cb._steps == steps
    finally:
        cb.shutdown()


def test_from_two_tower_serves_the_trained_table(net_pairs):
    net, jnet = net_pairs["TwoTowerRecommender"]
    lm = trec.RetrievalLM.from_two_tower(net, maxLen=40)
    jlm = jrec.RetrievalLM.from_two_tower(jnet, maxLen=40)
    assert lm.config == trec.RetrievalConfig(**{
        f: getattr(jlm.config, f) for f in ("vocabSize", "embeddingDim",
                                            "maxLen", "nLayers", "nHeads")})
    assert lm.config.headSize == jlm.config.headSize
    tokens = np.array([[0, 0, 5, 9, 17], [1, 2, 3, 4, 5]], np.int32)
    logits, ks, vs = lm.prefillRaw(tokens, lengths=[3, 5])
    jl, jk, jv = jlm.prefillRaw(tokens, lengths=[3, 5])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(ks.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jv))
    assert lm.compileCacheSize() is None
    with pytest.raises(ValueError, match="positional capacity"):
        lm.prefillRaw(np.zeros((1, 41), np.int32))
    with pytest.raises(ValueError, match="tower tables disagree"):
        trec.RetrievalLM(np.zeros((4, 2)), np.zeros((5, 2)), device="cpu")


def test_c25_the_last_item_ranks_after_the_first_only_in_the_port():
    """ROADMAP C25: the reference's decode step scatters its mask with the
    history's -1 sentinels, which JAX wraps to the last item, so the last
    item of the corpus is never emitted after rank 1; the port masks only
    emitted items and equals the flat ranking."""
    users, items = _tables()
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    items[-1] = items[7] * 0.999                 # second to item 7
    users[:] = items[7]                          # every user wants item 7
    prompt = np.array([[3, 4]], np.int32)
    want = _flat_topk(users, items, prompt[0], 3)
    assert list(want[:2]) == [7, 63]
    lm = trec.RetrievalLM(users, items, maxLen=32, device="cpu")
    jlm = jrec.RetrievalLM(users, items, maxLen=32)
    cb = ContinuousBatcher(lm, name="c25", pageSize=8, maxSlots=1).start()
    jcb = JBatcher(jlm, name="c25-ref", pageSize=8, maxSlots=1).start()
    try:
        out = cb.submit({"tokens": prompt, "maxNewTokens": 3}, timeout=120)
        jout = jcb.submit({"tokens": prompt, "maxNewTokens": 3},
                          timeout=120)
    finally:
        cb.shutdown()
        jcb.shutdown()
    np.testing.assert_array_equal(out[0], want)
    assert 63 not in list(np.asarray(jout)[0])
    assert int(np.asarray(jout)[0, 0]) == 7
