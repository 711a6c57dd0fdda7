"""Port parity of the iteration-level scheduler (``remote/scheduler.py``):
``ContinuousBatcher`` against the JAX package's batcher and against
``TransformerLM.generate`` — ragged concurrent requests, admission
mid-decode, preemption and replay, speculative decode, KV-headroom sheds,
enqueue-time 400s, step failures — and ``ReplicaSet`` failover under an
injected replica crash, with ``armAutoscale``'s scale edges.

Tokens follow the near-tie rule of ``tests/_torch_serving.py``.  Every
batcher, replica set and thread is shut down or joined in a ``finally``;
no wall-clock timeout is shorter than a second.
"""
import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.remote as jrem
from deeplearning4j_tpu.telemetry.instrument import \
    serving_metrics as ref_serving_metrics
import deeplearning4j_tpu_torch.remote as trem
import deeplearning4j_tpu_torch.telemetry as ttel
from _torch_serving import DRAFT_CFG, assert_tokens, lm_pair, prompts
from deeplearning4j_tpu_torch.fault import injection as inj
from deeplearning4j_tpu_torch.remote import (AdmissionControl, BucketLadder,
                                             ContinuousBatcher, ReplicaSet,
                                             ServiceOverloaded)
from deeplearning4j_tpu_torch.telemetry import HealthMonitor, get_registry

pytestmark = pytest.mark.torch_port

TIMEOUT = 120


@pytest.fixture(scope="module")
def lms():
    return lm_pair()


@pytest.fixture(scope="module")
def drafts():
    return lm_pair(**{k: v for k, v in DRAFT_CFG.items() if k in
                      ("nLayers", "seed")})


def _metric(name, **labels):
    m = get_registry().get(name)
    return m.value(**labels) if m is not None else 0.0


def _wait(cond, seconds=20.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _concurrent(fn, items):
    """fn(item) on one thread per item; results (or exceptions) in
    order; every thread joined with a timeout."""
    out = [None] * len(items)

    def run(i):
        try:
            out[i] = fn(items[i])
        except Exception as e:       # noqa: BLE001 — returned to check
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            th.join(TIMEOUT + 30)
    assert not any(th.is_alive() for th in threads)
    return out


@pytest.mark.parametrize("spec", [None, "draft", "self"],
                         ids=["greedy", "speculative", "self_draft"])
def test_batcher_matches_reference_batcher_and_generate(lms, drafts, spec):
    """Seven ragged concurrent requests through both packages' batchers
    (three slots, so admission churns mid-decode): the port's tokens are
    the reference batcher's and ``generate``'s of each prompt alone; the
    speculative batcher (draftK 3) gives the target-only greedy tokens and
    counts its proposals.  A separately seeded 1-layer draft rarely
    agrees; the target as its own draft agrees, so both packages take
    the accept branch (several tokens a step, ``_pos`` moved by a + 1).
    Every page returns to the free list."""
    jlm, tlm = lms
    draftOf = {None: (None, None), "draft": drafts, "self": lms}[spec]
    ps = prompts(7, 3, 30, seed=0)
    quotas = [int(q) for q in np.random.RandomState(1).randint(2, 14, 7)]
    payloads = [{"tokens": p.tolist(), "maxNewTokens": q}
                for p, q in zip(ps, quotas)]
    outs = {}
    for i, (k, m) in enumerate((("reference", jrem), ("port", trem))):
        cb = m.ContinuousBatcher(
            lms[i], name=f"cb-{k}-{spec}", draft=draftOf[i],
            draftK=3, pageSize=8, maxSlots=3,
            ladder=m.BucketLadder(batchSizes=(3,), seqLens=(16, 32))).start()
        try:
            outs[k] = _concurrent(lambda pl: cb.submit(pl, TIMEOUT),
                                  payloads)
            if k == "port":
                assert _wait(lambda: not cb.busy())
                assert cb.pool.freePages() == cb.pool.numPages - 1
                assert 0 < cb.occupancy() <= 1
        finally:
            cb.shutdown()
    for o, q in zip(outs["port"], quotas):
        assert isinstance(o, np.ndarray) and o.shape == (1, q)
    assert_tokens(jlm, ps, outs["port"], outs["reference"])
    alone = [tlm.generate(p[None], q) for p, q in zip(ps, quotas)]
    assert_tokens(jlm, ps, outs["port"], alone)
    name = f"cb-port-{spec}"
    assert ttel.serving_metrics().sequences_admitted().value(model=name) \
        == ttel.serving_metrics().sequences_retired().value(model=name) == 7
    assert ttel.serving_metrics().decode_tokens().value(model=name) == \
        sum(quotas)
    proposed = ttel.serving_metrics().draft_proposed().value(model=name)
    assert (proposed > 0) == (spec is not None)
    if spec == "self":
        accepted = ttel.serving_metrics().draft_accepted().value(model=name)
        refAccepted = ref_serving_metrics().draft_accepted().value(
            model=f"cb-reference-{spec}")
        assert accepted > 0 and refAccepted > 0


def test_stream_and_admit_mid_decode(lms):
    """A streams while B is admitted into the other slot mid-decode: A's
    streamed tokens equal its ``generate``, one per step, and B's too."""
    jlm, tlm = lms
    pa, pb = prompts(2, 4, 12, seed=3)
    cb = ContinuousBatcher(tlm, name="cb-admit", pageSize=8, maxSlots=2,
                           ladder=BucketLadder(batchSizes=(2,),
                                               seqLens=(16,))).start()
    try:
        gen = cb.submitStream({"tokens": pa.tolist(), "maxNewTokens": 24})
        got = [next(gen), next(gen)]                # A is mid-decode
        outB = cb.submit({"tokens": pb.tolist(), "maxNewTokens": 5},
                         timeout=TIMEOUT)
        got.extend(gen)
    finally:
        cb.shutdown()
    assert_tokens(jlm, [pa, pb], [got, outB[0]],
                  [tlm.generate(pa[None], 24)[0],
                   tlm.generate(pb[None], 5)[0]])


def test_preemption_replays_teacher_forced(lms):
    """A pool too small for two full sequences (9 pages of 8, 6 a
    sequence): the younger slot is preempted, requeued at the front and
    replayed, its stream swallowing the replayed prefix (``streamSkip``):
    both clients see ``generate``'s tokens exactly once."""
    jlm, tlm = lms
    pa, pb = prompts(2, 12, 12, seed=1)
    cb = ContinuousBatcher(tlm, name="cb-preempt", pageSize=8, numPages=9,
                           maxSlots=2, ladder=BucketLadder(
                               batchSizes=(2,), seqLens=(16,))).start()
    try:
        def run(p):
            gen = cb.submitStream({"tokens": p.tolist(),
                                   "maxNewTokens": 30})
            return [t for t in gen]
        got = _concurrent(run, [pa, pb])
        assert _wait(lambda: not cb.busy())
        assert cb.pool.freePages() == cb.pool.numPages - 1
    finally:
        cb.shutdown()
    assert ttel.serving_metrics().preemptions().value(
        model="cb-preempt") >= 1
    assert_tokens(jlm, [pa, pb], got,
                  [tlm.generate(p[None], 30)[0] for p in (pa, pb)])


def test_enqueue_rejections_and_kv_headroom_shed(lms):
    """Impossible requests are offender-only 400s at enqueue, with the
    reference's messages; a request whose pages cannot fit the free list
    sheds 429 (``serving_kv_exhausted``) with a Retry-After while another
    sequence holds the pool."""
    jlm, tlm = lms
    bad = [{"tokens": list(range(1, 30)) * 2, "maxNewTokens": 4},
           {"tokens": [1, 2, 3], "maxNewTokens": 60},
           {"tokens": np.zeros((0, 4), np.int32).tolist()},
           {"tokens": [1, 2], "maxNewTokens": 0},
           {"tokens": [1, 64]}, {"toks": [1]}]
    msgs = {}
    for i, (k, m) in enumerate((("reference", jrem), ("port", trem))):
        cb = m.ContinuousBatcher(lms[i], name=f"cb-400-{k}", pageSize=8,
                                 maxSlots=2, ladder=m.BucketLadder(
                                     batchSizes=(2,), seqLens=(16,)))
        msgs[k] = []
        for pl in bad:
            with pytest.raises(ValueError) as e:
                cb._makeSeqs(pl)
            msgs[k].append(str(e.value))
    assert msgs["port"] == msgs["reference"]

    pa = prompts(1, 12, 12, seed=1)[0]
    cb = ContinuousBatcher(tlm, name="cb-shed", pageSize=8, numPages=9,
                           maxSlots=2, admission=AdmissionControl(
                               retryAfter=0.5),
                           ladder=BucketLadder(batchSizes=(2,),
                                               seqLens=(16,))).start()
    inj.set_replica_slowdown("cb-shed", 0.1)       # A: 28 more steps, 2.8 s
    try:
        gen = cb.submitStream({"tokens": pa.tolist(), "maxNewTokens": 40})
        first = [next(gen) for _ in range(12)]     # A holds 4+ pages
        assert cb.pool.freePages() < 6
        with pytest.raises(ServiceOverloaded, match="kv page headroom") \
                as e:
            cb.submit({"tokens": pa.tolist(), "maxNewTokens": 40},
                      timeout=TIMEOUT)
        assert e.value.retryAfter >= 0.5
        inj.set_replica_slowdown("cb-shed", 0)
        rest = list(gen)
    finally:
        inj.clear_serving_faults()
        cb.shutdown()
    assert ttel.serving_metrics().shed().value(
        model="cb-shed", rule="serving_kv_exhausted") == 1
    assert_tokens(jlm, [pa], [first + rest], [tlm.generate(pa[None], 40)[0]])


def test_step_failure_errors_in_flight_then_recovers(lms):
    """No fallback: a failing shared step errors the sequences it carried
    (a standalone batcher has no failover), the stepping thread survives,
    rebuilds and re-warms its pools, and serves the next request
    exactly; a timed-out submit leaves no phantom backlog."""
    jlm, tlm = lms
    p = prompts(1, 8, 8, seed=0)[0]
    cb = ContinuousBatcher(tlm, name="cb-fail", pageSize=8, maxSlots=2,
                           ladder=BucketLadder(batchSizes=(2,),
                                               seqLens=(16,))).start()
    try:
        real, state = cb._stepFns["step"], {"n": 0}

        def bad(*a, **k):
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(*a, **k)

        cb._stepFns["step"] = bad
        old_pool = cb.pool.k
        with pytest.raises(RuntimeError, match="injected"):
            cb.submit({"tokens": p.tolist(), "maxNewTokens": 5},
                      timeout=TIMEOUT)
        out = cb.submit({"tokens": p.tolist(), "maxNewTokens": 5},
                        timeout=TIMEOUT)
        assert cb.pool.k is not old_pool            # rebuilt
        inj.set_replica_slowdown("cb-fail", 0.2)    # 40 steps: 8 s
        with pytest.raises(TimeoutError):
            cb.submit({"tokens": p.tolist(), "maxNewTokens": 40},
                      timeout=1.0)
        inj.set_replica_slowdown("cb-fail", 0)
        assert _wait(lambda: cb.queuedRows() == 0 and not cb.busy())
    finally:
        inj.clear_serving_faults()
        cb.shutdown()
    assert_tokens(jlm, [p], [out[0]], [tlm.generate(p[None], 5)[0]])
    assert ttel.serving_metrics().requests().value(
        model="cb-fail", outcome="error") >= 1


def test_many_clients_keep_the_books_balanced(lms):
    """More client threads than cores against a 3-slot batcher, with the
    interpreter switching threads every microsecond: every request is
    answered with its ``generate`` tokens, admitted equals retired, and
    every page returns to the free list (a lost update in the queue or
    page bookkeeping would break one of them)."""
    import sys
    jlm, tlm = lms
    ps = prompts(40, 2, 14, seed=9)
    quotas = [int(q) for q in np.random.RandomState(2).randint(1, 6, 40)]
    cb = ContinuousBatcher(tlm, name="cb-stress", pageSize=8, maxSlots=3,
                           ladder=BucketLadder(batchSizes=(3,),
                                               seqLens=(16,))).start()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = _concurrent(lambda i: cb.submit(
            {"tokens": ps[i].tolist(), "maxNewTokens": quotas[i]},
            TIMEOUT), list(range(40)))
        assert _wait(lambda: not cb.busy() and cb.queuedRows() == 0)
        assert cb.pool.freePages() == cb.pool.numPages - 1
    finally:
        sys.setswitchinterval(prev)
        cb.shutdown()
    sm = ttel.serving_metrics()
    assert sm.sequences_admitted().value(model="cb-stress") == \
        sm.sequences_retired().value(model="cb-stress") == 40
    assert_tokens(jlm, ps, [o[0] for o in outs],
                  [tlm.generate(p[None], q)[0] for p, q in zip(ps, quotas)])


def test_placement_and_waits(lms):
    """``device=`` follows the default (``cuda``: raises without a card),
    the TP replica path raises naming ROADMAP A10, and the probe runs a
    real op on the replica's device."""
    jlm, tlm = lms
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatcher(tlm, device="cuda", maxSlots=1)
    with pytest.raises(NotImplementedError, match="A10"):
        ContinuousBatcher(tlm, plan=object())
    cb = ContinuousBatcher(tlm, name="cb-probe", device="cpu", maxSlots=1,
                           pageSize=8)
    assert cb.pool.k.device.type == "cpu" and cb.probe()
    assert cb.compileCacheSize() is None
    with pytest.raises(NotImplementedError, match="A10"):
        cb.applyPlan(object())
    inj.arm_replica_crash("cb-probe")
    try:
        assert not cb.probe()                   # an armed, idle crash
        assert inj.replica_dead("cb-probe")     # consumed: now dead
    finally:
        inj.clear_serving_faults()


def _factory(tlm, name):
    def make(idx):
        return ContinuousBatcher(
            tlm, name=f"{name}/{idx}", pageSize=8, maxSlots=2,
            ladder=BucketLadder(batchSizes=(2,), seqLens=(16, 32)))
    return make


def test_replica_crash_fails_over_streams_exactly_once(lms):
    """A replica set of two batchers sharing one LM: a replica holding
    streams is armed to crash while they are in flight.  Every stream
    finishes with ``generate``'s tokens, no token twice (its replayed
    prefix swallowed by ``streamSkip``); the probe retires the crashed
    replica; the failover and replica metrics show it."""
    jlm, tlm = lms
    ps = prompts(4, 5, 20, seed=7)
    rs = ReplicaSet(_factory(tlm, "fo"), name="fo", replicas=2,
                    maxReplicas=2, probeInterval=0.05, probeTimeout=2.0,
                    probeFailThreshold=1, seed=0).start()
    try:
        for nm in ("fo/0", "fo/1"):     # slow decode: the crash lands
            inj.set_replica_slowdown(nm, 0.03)      # mid-stream
        gens = [rs.submitStream({"tokens": p.tolist(), "maxNewTokens": 12})
                for p in ps]
        heads = [[next(g)] for g in gens]
        with rs._lock:
            busy = [ex.name for ex in rs._replicas if ex.busy()]
        assert busy, "the streams should hold slots"
        inj.arm_replica_crash(busy[0])
        got = _concurrent(lambda i: heads[i] + [t for t in gens[i]
                                                if isinstance(t, int)],
                          list(range(4)))
        assert _wait(lambda: rs.replicaCount() == 1)
        with rs._lock:
            assert [ex.name for ex in rs._replicas] == \
                [n for n in ("fo/0", "fo/1") if n != busy[0]]
    finally:
        inj.clear_serving_faults()
        rs.shutdown()
    assert_tokens(jlm, ps, got,
                  [tlm.generate(p[None], 12)[0] for p in ps])
    assert _metric("dl4j_tpu_serving_failovers_total", model="fo") >= 1
    assert _metric("dl4j_tpu_serving_replica_health", model="fo",
                   replica=busy[0]) == 0
    assert _metric("dl4j_tpu_serving_replicas", model="fo") == 1


def test_autoscale_edges_scale_up_and_down(lms):
    """``armAutoscale``: the queue-depth rule's firing edge adds a
    replica, its resolved edge drains one away; both counted."""
    jlm, tlm = lms
    p = prompts(1, 10, 10, seed=0)[0]
    rs = ReplicaSet(_factory(tlm, "as"), name="as", replicas=1,
                    maxReplicas=3, probeInterval=0).start()
    threads = []
    try:
        mon = HealthMonitor(rules=[])
        rs.armAutoscale(mon, highQueueRows=3)
        inj.set_replica_slowdown("as/0", 0.05)     # a wave of 2: 1 s
        payload = {"tokens": p.tolist(), "maxNewTokens": 20}
        threads = [threading.Thread(target=rs.submit,
                                    args=(payload, TIMEOUT))
                   for _ in range(8)]
        for th in threads:
            th.start()
        assert _wait(lambda: rs.queuedRows() >= 3)
        mon.evaluate_once(now=100.0)
        assert rs.replicaCount() == 2
        inj.set_replica_slowdown("as/0", 0)
        for th in threads:
            th.join(TIMEOUT)
        assert not any(th.is_alive() for th in threads)
        assert rs.queuedRows() == 0
        mon.evaluate_once(now=200.0)
        assert _wait(lambda: rs.replicaCount() == 1)
        out = rs.submit({"tokens": p.tolist(), "maxNewTokens": 6},
                        timeout=TIMEOUT)
    finally:
        inj.clear_serving_faults()
        for th in threads:
            th.join(TIMEOUT)
        rs.shutdown()
    assert_tokens(jlm, [p], [out[0]], [tlm.generate(p[None], 6)[0]])
    acted = get_registry().get("dl4j_tpu_health_actions_total")
    cells = dict((tuple(k), v) for k, v in acted.data()["cells"])
    assert cells.get(("serving_queue_depth_high", "ok"), 0) >= 2
