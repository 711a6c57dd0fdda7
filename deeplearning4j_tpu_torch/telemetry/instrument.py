"""Serving-tier instrumentation — the port of the serving part of
``deeplearning4j_tpu/telemetry/instrument.py``: :class:`ServingMetrics`
(the ``dl4j_tpu_serving_*`` namespace, names, help text, labels and
buckets letter for letter the reference's, so dashboards and alert rules
work against either package) and the histogram exemplars
(:func:`observe_exemplar`, :func:`exemplar_for`,
:func:`latency_exemplars`).  The training, ETL, mesh, elastic,
coordination and AOT-cache instruments wait for ROADMAP A12; the ETL
namespace (:class:`EtlMetrics`, :func:`etl_metrics`, :func:`note_etl_wait`)
is here, names and help text the reference's, for DataVec's pipelines.

In the port ``dl4j_tpu_serving_compile_cache_{hits,misses}_total`` and
``dl4j_tpu_serving_warmup_compiles_total`` are never incremented: eager
PyTorch compiles no executables, so the serving tier's
``compileCacheSize`` probes return None (the reference tolerates that).
"""
from __future__ import annotations

import bisect
import threading

from deeplearning4j_tpu_torch.telemetry.registry import (DEFAULT_BUCKETS,
                                                         get_registry)

__all__ = ["EtlMetrics", "etl_metrics", "note_etl_wait",
           "ServingMetrics", "serving_metrics", "SERVING_LATENCY_BUCKETS",
           "SERVING_WARMUP_BUCKETS", "observe_exemplar", "exemplar_for",
           "latency_exemplars", "clear_exemplars"]

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


def note_etl_wait(seconds: float, owner) -> None:
    """Record blocking ETL wait incurred outside ``next()``
    (AsyncDataSetIterator blocks in ``hasNext()`` to populate its peek),
    charged to ``owner`` — the iterator that blocked — and folded into the
    next ``etl_fetch`` ON THAT ITERATOR (``etl_fetch`` comes with ROADMAP
    A12's training instruments).  Keying by iterator (not a
    bare thread-local) keeps a drain that never calls ``etl_fetch`` (a
    normalizer ``fit`` pass) from leaking its waits into an unrelated
    fetch; the iterator zeroes its pending on reset."""
    owner._telemetry_pending_wait = getattr(
        owner, "_telemetry_pending_wait", 0.0) + float(seconds)
