"""Serving-tier instrumentation — the port of the serving part of
``deeplearning4j_tpu/telemetry/instrument.py``: :class:`ServingMetrics`
(the ``dl4j_tpu_serving_*`` namespace, names, help text, labels and
buckets letter for letter the reference's, so dashboards and alert rules
work against either package) and the histogram exemplars
(:func:`observe_exemplar`, :func:`exemplar_for`,
:func:`latency_exemplars`).  The elastic and coordination
instruments wait for ROADMAP A10b; the ETL namespace
(:class:`EtlMetrics`, :func:`etl_metrics`, :func:`note_etl_wait`,
:func:`etl_fetch`) is here, names and help text the reference's, for
DataVec's pipelines, and so are the AOT-cache namespace
(:class:`AotCacheMetrics`, :func:`aot_metrics`) that ``compile.aotcache``
reports through and the training instruments the models and the fault
supervisor report through: the logical-step reporting
(:func:`train_step_span`, :func:`record_logical_step`), the supervised
and micro-batch scopes, :func:`record_crash` and the ``dl4j_tpu_step_*``
step-phase histograms (:func:`observe_step_phase`); the mesh namespace
(:class:`MeshMetrics`) the parallel layer's ``MeshTrainer`` reports
through, and the per-replica step gauge with its
:class:`ReplicaTimingListener`.

Eager PyTorch compiles no executables: the only compiled artifacts are the
kernel and native libraries, which the AOT cache stores when it is
configured.  With the cache off (the default) the serving tier's
``compileCacheSize`` probes return None, so
``dl4j_tpu_serving_compile_cache_{hits,misses}_total``,
``dl4j_tpu_serving_warmup_compiles_total`` and the train step's compile
accounting stay unset (the reference tolerates that); with it on they
count fresh compiler runs.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.telemetry.flight import flight_recorder
from deeplearning4j_tpu_torch.telemetry.registry import (DEFAULT_BUCKETS,
                                                         get_registry)
from deeplearning4j_tpu_torch.telemetry.runlog import (current_run,
                                                       record_event,
                                                       run_span_attrs)
from deeplearning4j_tpu_torch.telemetry.tracing import tracer

__all__ = ["EtlMetrics", "etl_metrics", "note_etl_wait", "RecsysMetrics",
           "recsys_metrics", "RECSYS_TOPK_BUCKETS",
           "ServingMetrics", "serving_metrics", "SERVING_LATENCY_BUCKETS",
           "SERVING_WARMUP_BUCKETS", "observe_exemplar", "exemplar_for",
           "latency_exemplars", "clear_exemplars", "train_step_span",
           "record_crash", "etl_fetch", "supervised_scope",
           "MeshMetrics", "mesh_metrics", "replica_step_gauge",
           "ReplicaTimingListener",
           "microbatch_scope", "in_microbatch", "record_logical_step",
           "STEP_PHASES", "StepPhaseMetrics", "step_phase_metrics",
           "observe_step_phase", "AotCacheMetrics", "aot_metrics",
           "AOT_LOAD_BUCKETS", "AOT_BAKE_BUCKETS"]

#: serving latency spans sub-ms (warm MLP on-host) to tens of seconds
#: (long-context decode) — finer low end than DEFAULT_BUCKETS so a p99
#: read off the bucket bounds stays meaningful at serving speeds
SERVING_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

#: a ladder warm-up spans "every bucket loads from the AOT cache" (ms)
#: to "a deep generative ladder compiles from scratch" (minutes) —
#: DEFAULT_BUCKETS can't resolve both ends
SERVING_WARMUP_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0)


class ServingMetrics:
    """The ``dl4j_tpu_serving_*`` namespace, registered from ONE site.

    The continuous-batching tier (``remote/serving.py``) reports here;
    admission control reads the same registry back through
    ``ThresholdRule``s, so the shed decision and the dashboards see one
    coherent series.  Accessors re-resolve through :func:`get_registry`
    on every call (tests swap the registry).  Every per-model series
    carries a ``model`` label — one serving process hosts many models.
    """

    def request_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_request_seconds",
            "End-to-end request latency inside the serving tier "
            "(enqueue to response ready), per model",
            labelnames=("model",), buckets=SERVING_LATENCY_BUCKETS)

    def requests(self):
        return get_registry().counter(
            "dl4j_tpu_serving_requests_total",
            "Requests completed by the bucketed executor, by model and "
            "outcome (ok/error/shed)",
            labelnames=("model", "outcome"))

    def queue_depth(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_queue_depth",
            "Feature rows currently queued ahead of the scheduler, per "
            "model (the admission controller's primary signal)",
            labelnames=("model",))

    def shed(self):
        return get_registry().counter(
            "dl4j_tpu_serving_shed_total",
            "Requests rejected by admission control (HTTP 429), by model "
            "and the rule that fired",
            labelnames=("model", "rule"))

    def compile_hits(self):
        return get_registry().counter(
            "dl4j_tpu_serving_compile_cache_hits_total",
            "Dispatches that hit a warm executable (no fresh XLA trace)",
            labelnames=("model",))

    def compile_misses(self):
        return get_registry().counter(
            "dl4j_tpu_serving_compile_cache_misses_total",
            "Dispatches that triggered a fresh XLA trace after warmup "
            "(steady state should hold this at zero)",
            labelnames=("model",))

    def warmup_compiles(self):
        return get_registry().counter(
            "dl4j_tpu_serving_warmup_compiles_total",
            "Executables compiled eagerly by BucketedExecutor.start() "
            "over the bucket ladder",
            labelnames=("model",))

    def p99_seconds(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_p99_seconds",
            "p99 request latency read off the request histogram after "
            "each dispatch (admission control's latency signal)",
            labelnames=("model",))

    def batch_occupancy(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_batch_occupancy",
            "Real rows / padded rows of the last dispatched bucket "
            "(1.0 = no padding waste)",
            labelnames=("model",))

    def pad_rows(self):
        return get_registry().counter(
            "dl4j_tpu_serving_pad_rows_total",
            "Padding rows dispatched to round batches up to a bucket",
            labelnames=("model",))

    def decode_tokens(self):
        return get_registry().counter(
            "dl4j_tpu_serving_decode_tokens_total",
            "Tokens generated through the KV-cache decode path",
            labelnames=("model",))

    def warmup_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_warmup_seconds",
            "Wall time of one BucketedExecutor ladder warm-up (compile "
            "on a cold AOT cache, executable loads on a warm one) — the "
            "server-start-to-ready cost, per model",
            labelnames=("model",), buckets=SERVING_WARMUP_BUCKETS)

    # -- continuous batching (remote/scheduler.py) -----------------------
    def slot_occupancy(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_slot_occupancy",
            "Active decode slots / total slots of the continuous "
            "batcher's shared step (1.0 = every slot busy; the "
            "iteration-level scheduler's primary efficiency signal)",
            labelnames=("model",))

    def kv_pages_in_use(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_kv_pages_in_use",
            "KV-cache pages currently allocated to admitted sequences, "
            "per model and pool (target / draft)",
            labelnames=("model", "pool"))

    def kv_pages_free(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_kv_pages_free",
            "KV-cache pages on the free list, per model and pool — the "
            "admission controller's page-headroom signal",
            labelnames=("model", "pool"))

    def preemptions(self):
        return get_registry().counter(
            "dl4j_tpu_serving_preemptions_total",
            "Decode slots evicted mid-generation to free KV pages "
            "(restart-with-skip; the sequence requeues at the front)",
            labelnames=("model",))

    def sequences_admitted(self):
        return get_registry().counter(
            "dl4j_tpu_serving_sequences_admitted_total",
            "Sequences admitted into a decode slot between steps",
            labelnames=("model",))

    def sequences_retired(self):
        return get_registry().counter(
            "dl4j_tpu_serving_sequences_retired_total",
            "Sequences retired from a decode slot (finished, errored "
            "or cancelled) with all their pages freed",
            labelnames=("model",))

    def decode_steps(self):
        return get_registry().counter(
            "dl4j_tpu_serving_decode_steps_total",
            "Shared decode steps dispatched by the continuous batcher "
            "(one fixed-shape executable call per step)",
            labelnames=("model",))

    def draft_proposed(self):
        return get_registry().counter(
            "dl4j_tpu_serving_draft_tokens_proposed_total",
            "Tokens proposed by the speculative-decode draft model, "
            "per slot-round",
            labelnames=("model",))

    def draft_accepted(self):
        return get_registry().counter(
            "dl4j_tpu_serving_draft_tokens_accepted_total",
            "Draft proposals accepted by the target model's verify "
            "forward (accept rate = accepted / proposed)",
            labelnames=("model",))

    def replicas(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_replicas",
            "Live executor replicas behind the named registry route "
            "(scaled by the serving_queue_depth remediation)",
            labelnames=("model",))

    def failovers(self):
        return get_registry().counter(
            "dl4j_tpu_serving_failovers_total",
            "Sequences failed over from an unhealthy/crashed replica to "
            "a survivor, replayed from the prompt with streamSkip hiding "
            "the re-emission (exactly-once delivery across the move)",
            labelnames=("model",))

    def deadline_sheds(self):
        return get_registry().counter(
            "dl4j_tpu_serving_deadline_sheds_total",
            "Requests shed because their end-to-end deadline expired — "
            "stage=admission never entered a decode slot (HTTP 504); "
            "stage=queued/decode were cancelled between steps with their "
            "KV pages freed",
            labelnames=("model", "stage"))

    def drain_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_drain_seconds",
            "Graceful-drain duration when a replica leaves the route "
            "(scaleDown/swap): admission stopped, in-flight sequences "
            "run to completion bounded by drainTimeout, stragglers "
            "failed over to survivors",
            buckets=SERVING_WARMUP_BUCKETS, labelnames=("model",))

    def replica_health(self):
        return get_registry().gauge(
            "dl4j_tpu_serving_replica_health",
            "Per-replica probe verdict: 1 healthy (probe within timeout "
            "under the consecutive-failure threshold), 0 removed from "
            "routing — surfaced in /healthz",
            labelnames=("model", "replica"))

    # -- per-stage latency decomposition (request-scoped observability) --
    def ttft_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_ttft_seconds",
            "Time to first token: request enqueue to the first token "
            "emitted to the client, per model (queue wait + prefill + "
            "first sampling step; failover restarts extend it)",
            labelnames=("model",), buckets=SERVING_LATENCY_BUCKETS)

    def inter_token_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_inter_token_seconds",
            "Gap between consecutive NEW tokens of one sequence "
            "(replayed tokens hidden by streamSkip do not observe; a "
            "failover's replay gap lands here by design), per model",
            labelnames=("model",), buckets=SERVING_LATENCY_BUCKETS)

    def queue_wait_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_queue_wait_seconds",
            "Enqueue to decode-slot admission, per model — the queueing "
            "share of TTFT (attributes p99 regressions to queueing vs "
            "compute)",
            labelnames=("model",), buckets=SERVING_LATENCY_BUCKETS)

    def prefill_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_serving_prefill_seconds",
            "Prompt prefill wall time (bucketed forward + KV pool write "
            "+ first-token argmax) inside slot admission, per model",
            labelnames=("model",), buckets=SERVING_LATENCY_BUCKETS)


_SERVING_METRICS = ServingMetrics()


def serving_metrics() -> ServingMetrics:
    """Accessor for the shared serving metric namespace (see
    :class:`ServingMetrics`)."""
    return _SERVING_METRICS


# -- histogram exemplars --------------------------------------------------
# Prometheus-style exemplars: each (histogram, label set) remembers the
# trace id of the observation that landed in its highest bucket so far,
# so a p99 spike on a latency dashboard links DIRECTLY to one request's
# timeline (`/v1/requests/<traceId>`).  The store is tiny (one record
# per cell) and updated under one lock — hot-loop safe.
_EXEMPLARS: dict = {}
_EXEMPLAR_LOCK = threading.Lock()


def observe_exemplar(name, value, trace_id=None, attrs=None, **labels):
    """Observe ``value`` into the ALREADY-REGISTERED histogram ``name``
    and attach ``trace_id`` as the exemplar when this observation is as
    slow as (or slower than) the cell's current exemplar.  A literal,
    registered metric name is required.  ``attrs`` rides along on the
    exemplar record WITHOUT becoming histogram labels."""
    hist = get_registry().get(name)
    if hist is None or not hasattr(hist, "buckets"):
        return
    hist.observe(value, **labels)
    if not trace_id:
        return
    bucket = bisect.bisect_left(hist.buckets, value)
    key = (name, tuple(sorted(labels.items())))
    with _EXEMPLAR_LOCK:
        cur = _EXEMPLARS.get(key)
        if cur is None or bucket >= cur["bucket"]:
            rec = {"trace_id": trace_id, "value": value, "bucket": bucket}
            if attrs:
                rec["attrs"] = dict(attrs)
            _EXEMPLARS[key] = rec


def exemplar_for(name, **labels):
    """The slowest-bucket exemplar recorded for one histogram cell:
    ``{"trace_id", "value", "bucket"}`` or None."""
    key = (name, tuple(sorted(labels.items())))
    with _EXEMPLAR_LOCK:
        got = _EXEMPLARS.get(key)
        return dict(got) if got else None


def latency_exemplars():
    """Every recorded exemplar, keyed ``{metric: {label tuple: record}}``
    — what the README's worked example walks from a p99 spike to a
    trace id."""
    with _EXEMPLAR_LOCK:
        out: dict = {}
        for (name, lkey), rec in _EXEMPLARS.items():
            out.setdefault(name, {})[lkey] = dict(rec)
        return out


def clear_exemplars():
    with _EXEMPLAR_LOCK:
        _EXEMPLARS.clear()


class EtlMetrics:
    """The ``dl4j_tpu_etl_*`` metric namespace, registered from ONE site.

    Both input pipelines report here — the thread-prefetch
    ``AsyncDataSetIterator`` and the process-pool
    ``datavec.pipeline.PrefetchingDataSetIterator`` — so the watchdog's
    ``etl_starvation`` rule and the federated dashboards see one coherent
    series no matter which pipeline feeds the loop (and the telemetry
    lint's one-registering-module rule stays satisfiable).  Accessors
    re-resolve through :func:`get_registry` on every call: tests swap the
    registry, and a cached metric would silently write into the old one.
    """

    def queue_depth(self):
        return get_registry().gauge(
            "dl4j_tpu_etl_queue_depth",
            "Prefetch-queue depth observed by the consumer")

    def consumers_waiting(self):
        return get_registry().gauge(
            "dl4j_tpu_etl_consumers_waiting",
            "Consumers currently blocked on an empty prefetch queue")

    def empty_polls(self):
        return get_registry().counter(
            "dl4j_tpu_etl_queue_empty_polls_total",
            "Consumer polls that found the prefetch queue empty")

    def producer_active(self):
        return get_registry().gauge(
            "dl4j_tpu_etl_producer_active",
            "Prefetch producers (threads or pool processes) currently "
            "running")

    def prefetch_wait(self):
        return get_registry().gauge(
            "dl4j_tpu_etl_prefetch_wait_seconds",
            "Consumer block time on the last prefetch-queue get")

    def h2d_bytes(self):
        return get_registry().counter(
            "dl4j_tpu_etl_h2d_bytes_total",
            "Bytes moved host->device by the ETL staging ring")

    def h2d_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_etl_h2d_seconds",
            "Per-batch host->device transfer wall time (issue + "
            "completion wait) in the ETL staging ring",
            buckets=DEFAULT_BUCKETS)

    def pool_workers(self):
        return get_registry().gauge(
            "dl4j_tpu_etl_pool_workers",
            "Producer processes alive in the sharded ETL pool")

    def pool_batches(self):
        return get_registry().counter(
            "dl4j_tpu_etl_pool_batches_total",
            "Batches delivered by the sharded ETL producer pool")

    def pool_inline_batches(self):
        return get_registry().counter(
            "dl4j_tpu_etl_pool_inline_batches_total",
            "Pool batches that bypassed shared memory (oversized or "
            "partial: pickled through the queue instead)")

    def pool_restarts(self):
        return get_registry().counter(
            "dl4j_tpu_etl_pool_restarts_total",
            "Producer-pool restarts (etl_starvation remediation or an "
            "explicit requestRestart) — the stream position is "
            "preserved by the consumer's skip fast-forward")


_ETL_METRICS = EtlMetrics()


def etl_metrics() -> EtlMetrics:
    """Accessor for the shared ETL metric namespace (see
    :class:`EtlMetrics`)."""
    return _ETL_METRICS


#: a top-k retrieval request is one prefill (+ k-1 fixed-shape decode
#: steps): sub-ms warm on the CPU proxy to tens of ms under queueing —
#: resolution concentrated under 100 ms where the serving SLO lives
RECSYS_TOPK_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5)


class RecsysMetrics:
    """The ``dl4j_tpu_recsys_*`` namespace, registered from ONE site.

    The recommender tier reports here: ingestion volume and dedup
    effectiveness from ``RaggedFeatureReader`` (host-side per-row
    unique of hashed ids), the interconnect bytes a table-parallel
    lookup moves (computed statically from the exchange shapes — no
    device sync), and end-to-end top-k retrieval latency through
    ``ContinuousBatcher``.  Accessors re-resolve through
    :func:`get_registry` on every call (tests swap the registry).
    """

    def lookup_rows(self):
        return get_registry().counter(
            "dl4j_tpu_recsys_lookup_rows_total",
            "Embedding ids ingested for lookup, by pipeline phase "
            "(raw = before host-side dedup, stored = after)",
            labelnames=("phase",))

    def alltoall_bytes(self):
        return get_registry().counter(
            "dl4j_tpu_recsys_alltoall_bytes_total",
            "Interconnect bytes moved by table-parallel sparse "
            "lookups (id requests + resolved rows + row all-gather), "
            "computed from static exchange shapes")

    def dedup_ratio(self):
        return get_registry().gauge(
            "dl4j_tpu_recsys_dedup_ratio",
            "stored/raw id ratio of the last ingested ragged batch "
            "(1.0 = no duplicates; lower is better)")

    def topk_latency(self):
        return get_registry().histogram(
            "dl4j_tpu_recsys_topk_latency_seconds",
            "End-to-end top-k retrieval latency through the "
            "continuous batcher (submit to ranked ids)",
            buckets=RECSYS_TOPK_BUCKETS)

    def hash_collisions(self):
        return get_registry().counter(
            "dl4j_tpu_recsys_hash_collisions_total",
            "Distinct raw feature values observed mapping to the same "
            "hashed embedding row (sampled estimator in "
            "RaggedFeatureReader; silent collisions degrade ranking "
            "quality without ever erroring)")


_RECSYS_METRICS = RecsysMetrics()


def recsys_metrics() -> RecsysMetrics:
    """Accessor for the shared recommender-tier metric namespace (see
    :class:`RecsysMetrics`)."""
    return _RECSYS_METRICS


def note_etl_wait(seconds: float, owner) -> None:
    """Record blocking ETL wait incurred outside ``next()``
    (AsyncDataSetIterator blocks in ``hasNext()`` to populate its peek),
    charged to ``owner`` — the iterator that blocked — and folded into the
    next :func:`etl_fetch` ON THAT ITERATOR.  Keying by iterator (not a
    bare thread-local) keeps a drain that never calls ``etl_fetch`` (a
    normalizer ``fit`` pass) from leaking its waits into an unrelated
    fetch; the iterator zeroes its pending on reset."""
    owner._telemetry_pending_wait = getattr(
        owner, "_telemetry_pending_wait", 0.0) + float(seconds)


def etl_fetch(iterator):
    """One batch fetch timed as the ETL phase: an ``etl`` trace event, the
    last-fetch stall gauge, and cumulative stall seconds.  Used by every
    training loop that drains an iterator, so a slow input pipeline is
    visible as ``dl4j_tpu_etl_stall_seconds`` regardless of which loop
    drives it — including async iterators whose blocking happens in
    ``hasNext`` (handed over via :func:`note_etl_wait`)."""
    reg = get_registry()
    pending = getattr(iterator, "_telemetry_pending_wait", 0.0)
    if pending:
        iterator._telemetry_pending_wait = 0.0
    t0 = time.perf_counter()
    ds = iterator.next()
    dt = (time.perf_counter() - t0) + pending
    # start is backdated over the hasNext wait so the trace slice spans
    # the whole time the loop stood still for data
    tracer().record_complete("etl", t0 - pending, dt)
    observe_step_phase("data_wait", dt)
    reg.gauge("dl4j_tpu_etl_stall_seconds",
              "Host wall time the train loop spent waiting on the last "
              "batch fetch (async prefetch waits included)").set(dt)
    reg.counter("dl4j_tpu_etl_stall_seconds_total",
                "Cumulative seconds the train loop waited on batch "
                "fetches").inc(dt)
    return ds


# -- training steps -----------------------------------------------------

# set while a fault supervisor owns the step: a step-level
# InvalidStepException is then a RECOVERABLE divergence (the supervisor
# rolls back), not a crash — no dump, no crash counter.  The supervisor
# itself dumps exactly once if recovery finally fails.
_scope = threading.local()


@contextlib.contextmanager
def supervised_scope():
    prev = getattr(_scope, "supervised", False)
    _scope.supervised = True
    try:
        yield
    finally:
        _scope.supervised = prev


@contextlib.contextmanager
def microbatch_scope():
    """Active during OOM micro-batch retries: half-batch steps are not
    logical steps, so they must not enter the step counter, the step-time
    histogram or the listeners' ``iterationDone``."""
    prev = getattr(_scope, "microbatch", False)
    _scope.microbatch = True
    try:
        yield
    finally:
        _scope.microbatch = prev


def in_microbatch() -> bool:
    """True inside an OOM micro-batch retry (see :func:`microbatch_scope`);
    the model train loops use this to defer per-step listener/metric
    reporting to the supervisor's logical-step boundary."""
    return getattr(_scope, "microbatch", False)


def _report_step(model, seconds: float, batch_size: int,
                 **flight_extra) -> None:
    """The one reporting tail every logical step goes through — normal
    steps and OOM micro-batch splits must land in the SAME series."""
    reg = get_registry()
    reg.counter("dl4j_tpu_train_steps_total",
                "Logical train steps dispatched").inc()
    reg.histogram("dl4j_tpu_train_step_seconds",
                  "Host wall time per logical train step",
                  buckets=DEFAULT_BUCKETS).observe(seconds)
    if seconds > 0:
        reg.gauge(
            "dl4j_tpu_train_examples_per_second",
            "Dispatch-rate examples/sec (see PerformanceListener for the "
            "blocked, device-accurate rate)").set(batch_size / seconds)
    observe_step_phase("compute", seconds, step=model.iterationCount)
    # an OOM-split logical step says so on its timeline event
    # (ROADMAP C34); every other step's event is the reference's
    record_event("train.step", step=int(model.iterationCount),
                 epoch=int(model.epochCount),
                 seconds=round(seconds, 6),
                 oom_split=flight_extra.get("oom_split"))
    flight_recorder().record(
        iteration=model.iterationCount, epoch=model.epochCount,
        step_seconds=round(seconds, 6), batch_size=int(batch_size),
        **flight_extra)


def _jit_cache_size(model):
    """(fresh compiler runs, their seconds) of the model's AOT-dispatched
    train step, or None with the AOT cache off: eager PyTorch keeps no jit
    cache, so the step's compile accounting then stays unset."""
    from deeplearning4j_tpu_torch.compile.aotcache import (aot_cache,
                                                           bound_dispatch)
    fn = bound_dispatch(model, "_trainStep")
    if fn is None:
        return (0, 0.0) if aot_cache() is not None else None
    return fn._cache_size(), fn._freshSeconds


@contextlib.contextmanager
def train_step_span(model, batch_size: int):
    """Wrap one logical train step (the step / TBPTT chunk loop / line
    search iteration): step counter + step-time histogram + examples/sec
    gauge + a ``step`` span + a FlightRecorder record.  With the AOT cache
    configured the step also reports its compile accounting, as the
    reference's does: the kernel and native libraries the step had to
    compile fresh (a cache load is not a compile) land in
    ``dl4j_tpu_train_jit_cache_misses_total`` and their compiler seconds
    in ``dl4j_tpu_train_compile_seconds_total``; with it off (the
    default) both stay unset.  An ``InvalidStepException`` inside an
    unsupervised step dumps the flight ring (see :func:`record_crash`) and
    re-raises."""
    if getattr(_scope, "microbatch", False):
        # OOM-retry half-batches are not logical steps: the supervisor
        # keeps iterationCount at ONE step for the whole split, so the
        # step counter/histogram/throughput must not see the halves —
        # only a trace span marking the retry work
        with tracer().span("microbatch_step", batch=int(batch_size)):
            yield
        return
    before = _jit_cache_size(model)
    t0 = time.perf_counter()
    try:
        with tracer().span("step", iteration=model.iterationCount,
                           epoch=model.epochCount, batch=int(batch_size),
                           **run_span_attrs()):
            yield
    except Exception as e:
        from deeplearning4j_tpu_torch.optimize.solvers import \
            InvalidStepException
        if isinstance(e, (InvalidStepException, FloatingPointError)):
            if getattr(_scope, "supervised", False):
                # the supervisor will roll back and retry — log the event
                # in the ring but don't report a crash for a recoverable
                # divergence (it dumps once itself if recovery fails)
                flight_recorder().record(
                    event="invalid_step", reason=f"{type(e).__name__}: {e}",
                    iteration=model.iterationCount)
            else:
                record_crash(f"{type(e).__name__}: {e}", model=model)
        raise
    dt = time.perf_counter() - t0
    after = _jit_cache_size(model)
    if before is not None and after is not None and after[0] > before[0]:
        reg = get_registry()
        reg.counter(
            "dl4j_tpu_train_jit_cache_misses_total",
            "Fused-step executable cache misses (recompiles)").inc(
                after[0] - before[0])
        reg.counter(
            "dl4j_tpu_train_compile_seconds_total",
            "Wall seconds of the kernel and native library compiler runs "
            "a step started").inc(after[1] - before[1])
        tracer().record_complete("compile", t0, dt,
                                 args={"iteration": model.iterationCount})
    if after is not None:
        _report_step(model, dt, batch_size, jit_cache_size=after[0])
    else:
        _report_step(model, dt, batch_size)


def record_logical_step(model, seconds: float, batch_size: int) -> None:
    """Count one LOGICAL step completed via micro-batch OOM retry: the
    halves themselves are skipped (``microbatch_scope``), so the
    supervisor reports the whole split here — without this the step
    counter would drift below ``iterationCount`` and the step-time
    histogram would be missing exactly the slowest steps."""
    _report_step(model, seconds, batch_size, oom_split=True)


def record_crash(reason: str, model=None) -> str:
    """Append a crash record, mark the trace, and dump the flight ring to
    JSON (the ``CrashReportingUtil`` analogue).  Returns the dump path."""
    fr = flight_recorder()
    rec = {"event": "crash", "reason": reason}
    if model is not None:
        rec["iteration"] = getattr(model, "iterationCount", None)
        rec["epoch"] = getattr(model, "epochCount", None)
    fr.record(**rec)
    tracer().instant("crash", reason=reason)
    get_registry().counter("dl4j_tpu_train_crash_dumps_total",
                           "FlightRecorder crash dumps written").inc()
    return fr.dump(reason=reason)


# -- step-phase decomposition -------------------------------------------

#: The five seams one logical train step decomposes into — instrumented
#: at etl_fetch (data_wait), the staging ring's materialize (h2d), the
#: step (compute), the supervisor's sealed save (checkpoint) and the pod
#: barrier (barrier, which comes with the parallel layer).
STEP_PHASES = ("data_wait", "h2d", "compute", "checkpoint", "barrier")


class StepPhaseMetrics:
    """The ``dl4j_tpu_step_*`` step-time decomposition namespace,
    registered from ONE site (names, help text and buckets the
    reference's).  Every histogram takes exemplars (via
    :func:`observe_step_phase`) pointing at the (trace id, generation,
    step) of the slowest observation.  Accessors re-resolve through
    :func:`get_registry` on every call (tests swap the registry)."""

    def data_wait_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_step_data_wait_seconds",
            "Step time waiting on the input pipeline (batch fetch, "
            "prefetch stalls)", buckets=DEFAULT_BUCKETS)

    def h2d_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_step_h2d_seconds",
            "Step time staging batches host-to-device (issue + "
            "materialize wait)", buckets=DEFAULT_BUCKETS)

    def compute_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_step_compute_seconds",
            "Step time in the fused-step dispatch (host wall around the "
            "jitted call)", buckets=DEFAULT_BUCKETS)

    def checkpoint_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_step_checkpoint_seconds",
            "Step time blocked on a sealed checkpoint save",
            buckets=DEFAULT_BUCKETS)

    def barrier_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_step_barrier_seconds",
            "Step time blocked on the pod coordination barrier",
            buckets=DEFAULT_BUCKETS)


_STEP_PHASE_METRICS = StepPhaseMetrics()


def step_phase_metrics() -> StepPhaseMetrics:
    """Accessor for the shared step-phase namespace (see
    :class:`StepPhaseMetrics`)."""
    return _STEP_PHASE_METRICS


def observe_step_phase(phase: str, seconds: float,
                       step: Optional[int] = None) -> None:
    """Observe one step-phase duration with a run-scoped exemplar: the
    active :class:`~deeplearning4j_tpu_torch.telemetry.runlog.RunContext`
    supplies the trace id and generation, so the slowest-bucket exemplar
    on each phase histogram resolves to (trace id, generation, step)."""
    if phase not in STEP_PHASES:
        raise ValueError(f"unknown step phase {phase!r}; "
                         f"expected one of {STEP_PHASES}")
    rc = current_run()
    tid = rc.runId if rc is not None else None
    attrs = None
    if rc is not None:
        attrs = {"generation": int(rc.generation)}
        if step is not None:
            attrs["step"] = int(step)
    getattr(_STEP_PHASE_METRICS, f"{phase}_seconds")()
    observe_exemplar(f"dl4j_tpu_step_{phase}_seconds", seconds, tid,
                     attrs=attrs)


# -- the AOT cache -------------------------------------------------------

#: a library load is a disk read + checksum + dlopen: sub-ms to tens of
#: ms for a few-MB kernel library — DEFAULT_BUCKETS has no resolution
#: below 5 ms where most loads land
AOT_LOAD_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0)

#: a bake is a full compiler run: about a second for the native library
#: with g++ to tens of seconds for a Hopper kernel with nvcc
AOT_BAKE_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0)


class AotCacheMetrics:
    """The ``dl4j_tpu_aot_cache_*`` namespace, registered from ONE site
    (names, labels and buckets the reference's).

    ``compile.aotcache`` reports here: library-cache hits/misses by kind
    (the dispatch's kind — train_step / output / prefill / decode — or
    ``kernel`` / ``native`` for a lookup outside one), load and bake
    latency, LRU evictions and quarantined (corrupt) entries.  The
    warm-boot bar reads as: hits > 0 while
    ``dl4j_tpu_train_compile_seconds_total`` and the serving compile-miss
    counters stay ~0.  Accessors re-resolve through :func:`get_registry`
    on every call (tests swap the registry).
    """

    def hits(self):
        return get_registry().counter(
            "dl4j_tpu_aot_cache_hits_total",
            "Compiled libraries loaded from the persistent AOT cache "
            "instead of compiled, by kind",
            labelnames=("kind",))

    def misses(self):
        return get_registry().counter(
            "dl4j_tpu_aot_cache_misses_total",
            "AOT cache lookups that found no loadable entry (a fresh "
            "compiler run follows), by kind",
            labelnames=("kind",))

    def load_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_aot_cache_load_seconds",
            "Wall time to read, verify and load one cached library",
            buckets=AOT_LOAD_BUCKETS)

    def bake_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_aot_cache_bake_seconds",
            "Wall time of the fresh compiler run behind one cache miss "
            "(the cost the next boot skips)",
            buckets=AOT_BAKE_BUCKETS)

    def evictions(self):
        return get_registry().counter(
            "dl4j_tpu_aot_cache_evictions_total",
            "Cache entries removed by LRU eviction to hold the "
            "configured size bound")

    def quarantined(self):
        return get_registry().counter(
            "dl4j_tpu_aot_cache_quarantined_total",
            "Corrupt or unloadable cache entries moved to quarantine "
            "(checksum or load failure; the caller compiled fresh)")


_AOT_METRICS = AotCacheMetrics()


def aot_metrics() -> AotCacheMetrics:
    """Accessor for the shared AOT-cache metric namespace (see
    :class:`AotCacheMetrics`)."""
    return _AOT_METRICS


class MeshMetrics:
    """The ``dl4j_tpu_mesh_*`` namespace, registered from ONE site.

    ``parallel.meshtrainer.MeshTrainer`` — the stepping path every
    parallel facade (ParallelWrapper, SharedTrainingMaster, ZeRO)
    executes through — reports here: step time, per-axis collective
    traffic estimated statically from the ShardingPlan, and compile
    misses (with the AOT cache on; nothing is compiled per signature
    otherwise).
    Accessors re-resolve through :func:`get_registry` on every call
    (tests swap the registry).
    """

    def steps(self):
        return get_registry().counter(
            "dl4j_tpu_mesh_steps_total",
            "Train steps dispatched through the MeshTrainer unified "
            "sharded step (all parallel facades step here)")

    def step_seconds(self):
        return get_registry().histogram(
            "dl4j_tpu_mesh_step_seconds",
            "Host wall time per MeshTrainer step (lockstep across the "
            "mesh: one executable, GSPMD collectives inside)",
            buckets=DEFAULT_BUCKETS)

    def jit_cache_misses(self):
        return get_registry().counter(
            "dl4j_tpu_mesh_jit_cache_misses_total",
            "Sharded-step executable cache misses (steady state must "
            "hold this flat after the first step)")

    def collective_bytes(self):
        return get_registry().counter(
            "dl4j_tpu_mesh_collective_bytes_total",
            "Estimated bytes moved per mesh axis and collective "
            "(all_reduce / reduce_scatter / all_gather), priced "
            "statically from the ShardingPlan",
            labelnames=("axis", "collective"))

    def axis_size(self):
        return get_registry().gauge(
            "dl4j_tpu_mesh_axis_size",
            "Device count per named mesh axis of the active "
            "ShardingPlan", labelnames=("axis",))


_MESH_METRICS = MeshMetrics()


def mesh_metrics() -> MeshMetrics:
    """Accessor for the shared mesh metric namespace (see
    :class:`MeshMetrics`)."""
    return _MESH_METRICS


def replica_step_gauge():
    """The per-replica lockstep step-time gauge — registered HERE (one
    module) and shared by :class:`ReplicaTimingListener`, the straggler
    watchdog rule, and the fault-injection straggler stand-in."""
    return get_registry().gauge(
        "dl4j_tpu_parallel_replica_step_seconds",
        "Lockstep per-replica step wall time",
        labelnames=("replica",))


class ReplicaTimingListener:
    """Per-replica step-time gauges + timing-spread gauge for data-parallel
    fits (attached internally by ``ParallelWrapper``).

    The ranks step in lockstep (the gradient all-reduce joins them), so
    each replica's step time IS the lockstep wall time; the straggler /
    contention signal ``bench.py`` flags (``timing_spread``) is the
    max/min ratio over a rolling window of those lockstep times — a
    contended window reads as spread, not as a uniform regression."""

    def __init__(self, devices: Sequence, window: int = 20):
        # the mesh's ranks (ROADMAP C44: deviceIds are ranks)
        self._device_ids = [str(getattr(d, "id", d)) for d in devices]
        self._window = max(2, int(window))
        self._times = []
        self._last = None
        self._etl_mark = None

    def _etl_total(self) -> float:
        c = get_registry().get("dl4j_tpu_etl_stall_seconds_total")
        return c.value() if c is not None else 0.0

    # TrainingListener duck-typed surface (only the hooks it needs)
    def onEpochStart(self, model):
        # epoch boundaries (iterator reset, async-producer drain/join) are
        # not step time — restart the inter-iteration clock so the gap
        # can't masquerade as a straggler in the spread gauge
        self._last = None

    def onEpochEnd(self, model):
        self._last = None

    def onForwardPass(self, model, activations=None):
        pass

    def onBackwardPass(self, model):
        pass

    def onGradientCalculation(self, model):
        pass

    def iterationDone(self, model, iteration, epoch):
        now = time.perf_counter()
        etl_now = self._etl_total()
        if self._last is None:
            self._last, self._etl_mark = now, etl_now
            return
        # the inter-iteration interval contains one batch fetch — subtract
        # the ETL counter's delta so a slow fetch (cold cache, starved
        # prefetcher) doesn't read as device contention in the spread;
        # this keeps one semantics with the fitDataSet path, which times
        # the step call alone
        dt = max(now - self._last - (etl_now - (self._etl_mark or 0.0)),
                 0.0)
        self._last, self._etl_mark = now, etl_now
        if dt > 0:
            self.record(dt)

    def record(self, dt: float) -> None:
        """Feed one lockstep step time directly (the per-batch
        ``fitDataSet`` path times the step call itself so supervisor
        overhead between batches doesn't pollute the gauge)."""
        if getattr(_scope, "microbatch", False):
            return      # OOM half-batches are not representative steps
        reg = get_registry()
        g = replica_step_gauge()
        for rid in self._device_ids:
            g.set(dt, replica=rid)
        self._times.append(dt)
        if len(self._times) > self._window:
            self._times.pop(0)
        if len(self._times) >= 2:
            lo = min(self._times)
            if lo > 0:
                reg.gauge(
                    "dl4j_tpu_parallel_step_time_spread",
                    "max/min step time over a rolling window (bench.py's "
                    "contention flag fires above 2.0)").set(
                        max(self._times) / lo)
