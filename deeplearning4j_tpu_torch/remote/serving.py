"""The serving tier: bucketed executors, KV-cache decode, multi-model
hosting, admission control — the port of
``deeplearning4j_tpu/remote/serving.py``.

- :class:`BucketLadder` — the fixed ladder of batch / sequence buckets
  every request is padded up to;
- :class:`BucketedExecutor` — per-model request queue + scheduler: each
  tick coalesces the queue into the LARGEST ready bucket, pads, dispatches,
  and splits results back per request.  Weights stay resident on the
  model's device, shared by every worker thread — requests carry only
  activations (numpy on the host);
- :class:`ForwardServing` / :class:`GenerativeServing` — the two model
  adapters: padded batched forward (mask-correct for sequence models) and
  KV-cache decode through :class:`~deeplearning4j_tpu_torch.nlp.
  transformer.TransformerLM` (``generate`` with ``lengths``, so the masked
  dense path: the HTTP tier never reaches the flash kernel, ROADMAP C2);
- :class:`AdmissionControl` — load shedding (HTTP 429 + ``Retry-After``)
  driven by ``ThresholdRule``s over the ``dl4j_tpu_serving_*`` metrics;
- :class:`ModelRegistry` + :class:`InferenceServer` — multi-model hosting
  behind ``POST /v1/serving/<name>`` (bare ``/v1/serving`` routes to the
  default model), with the shared observability GET surface.

Eager PyTorch compiles no executables; the port's compiled artifacts are
its kernel and native libraries, which the AOT cache (``compile.aotcache``)
keeps when it is configured.  With the cache on, ``warm()`` first wraps
the model's entry points in the cache (``wrap_serving_model``), which
preloads their ladders, the adapters' ``compileCacheSize`` returns the
fresh compiler runs of those dispatches, and the compile accounting
(``dl4j_tpu_serving_compile_cache_{hits,misses}_total``,
``dl4j_tpu_serving_warmup_compiles_total``) counts them, as the
reference's does.  The cache is off unless configured; then
``compileCacheSize`` returns None and that accounting stays unset
(ROADMAP C42).  Either way ``warm()`` runs every bucket once (cuBLAS
heuristics, the caching allocator) and times it into
``dl4j_tpu_serving_warmup_seconds``.  As in the
reference, ``InferenceServer.start`` starts the OTLP exporter when
``DL4J_TPU_OTLP_ENDPOINT`` points at a collector.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.remote.server import is_shape_error
from deeplearning4j_tpu_torch.telemetry import (RequestContext, ThresholdRule,
                                          current_context, get_registry,
                                          parse_traceparent, request_context,
                                          serving_metrics, timeline_store)

__all__ = ["BucketLadder", "ServiceOverloaded", "DeadlineExceeded",
           "NoHealthyReplicas", "AdmissionControl", "ForwardServing",
           "GenerativeServing", "BucketedExecutor", "ModelRegistry",
           "InferenceServer", "histogram_quantile"]


class ServiceOverloaded(RuntimeError):
    """Admission control rejected the request (HTTP 429).  ``retryAfter``
    is the server's backoff hint in seconds."""

    def __init__(self, detail: str, retryAfter: float = 1.0):
        super().__init__(detail)
        self.retryAfter = float(retryAfter)


class DeadlineExceeded(RuntimeError):
    """The request's end-to-end deadline expired (HTTP 504) — shed at
    admission before it ever held a decode slot, or cancelled between
    decode steps with its KV pages freed."""


class NoHealthyReplicas(RuntimeError):
    """Every replica behind the route has been removed by health probing
    or scale-down (HTTP 503 + ``Retry-After``, NOT a bare 500: the
    condition is transient — autoscaling or a swap will repopulate the
    route — so clients should back off and retry, not alert)."""

    def __init__(self, detail: str, retryAfter: float = 1.0):
        super().__init__(detail)
        self.retryAfter = float(retryAfter)


def _host(out) -> np.ndarray:
    """A model output as a host array: the response payload."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class BucketLadder:
    """The fixed shape ladder: requests round UP to the nearest bucket.

    ``batchSizes`` bounds how many rows one dispatch carries; ``seqLens``
    buckets the time axis of rank-3 (b, n, t) inputs and prompt lengths.
    A request above the top batch bucket is chunked into warm shapes; a
    sequence above the top seq bucket is a 400 (it was never warmed; the
    reference never compiled an executable for it).
    """

    def __init__(self, batchSizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 seqLens: Sequence[int] = (16, 32, 64, 128)):
        if not batchSizes:
            raise ValueError("need at least one batch bucket")
        self.batchSizes = tuple(sorted(int(b) for b in batchSizes))
        self.seqLens = tuple(sorted(int(t) for t in seqLens))

    @property
    def maxBatch(self) -> int:
        return self.batchSizes[-1]

    @property
    def maxSeq(self) -> int:
        return self.seqLens[-1] if self.seqLens else 0

    def batchBucket(self, n: int) -> int:
        for b in self.batchSizes:
            if n <= b:
                return b
        return self.maxBatch

    def seqBucket(self, t: int) -> int:
        for s in self.seqLens:
            if t <= s:
                return s
        raise ValueError(
            f"sequence length {t} exceeds the top bucket {self.maxSeq} "
            "(no warm executable exists for it)")


def histogram_quantile(hist, q: float, **labels) -> Optional[float]:
    """Quantile estimate off a registry histogram's cumulative bucket
    counts (upper-bound attribution, the Prometheus
    ``histogram_quantile`` convention).  None with no observations."""
    try:
        counts = hist.bucketCounts(**labels)
    except Exception:
        return None
    total = max(counts.values()) if counts else 0
    if total <= 0:
        return None
    rank = q * total
    prev_bound = 0.0
    for bound, cum in counts.items():
        if cum >= rank:
            return bound if not math.isinf(bound) else prev_bound
        prev_bound = bound
    return prev_bound


class AdmissionControl:
    """Shed load before it queues: evaluated on every submit.

    Both default conditions are plain ``ThresholdRule``s over the
    ``dl4j_tpu_serving_*`` series (queue-depth gauge, p99 gauge the
    executor maintains from the request histogram) — the identical rule
    machinery ``telemetry.health`` runs, so an operator can mirror the
    same thresholds into the watchdog's alert log.  Extra rules append.
    """

    def __init__(self, maxQueueRows: int = 256,
                 p99Threshold: Optional[float] = None,
                 retryAfter: float = 1.0,
                 rules: Optional[Sequence[ThresholdRule]] = None,
                 minFreePages: int = 0,
                 maxKvRetryAfter: float = 30.0):
        self.maxQueueRows = int(maxQueueRows)
        self.p99Threshold = p99Threshold
        self.retryAfter = float(retryAfter)
        self.minFreePages = int(minFreePages)
        self.maxKvRetryAfter = float(maxKvRetryAfter)
        self._extra = list(rules or [])
        self._rules: List[ThresholdRule] = []
        self._latencyRules: List[ThresholdRule] = []

    def bind(self, model: str) -> None:
        """Materialize the per-model rules (called by the executor once
        its model name is known)."""
        self._rules = [ThresholdRule(
            "serving_queue_full", "dl4j_tpu_serving_queue_depth", ">=",
            self.maxQueueRows, model=model)]
        self._rules.extend(self._extra)
        self._latencyRules = []
        if self.p99Threshold is not None:
            self._latencyRules.append(ThresholdRule(
                "serving_p99_high", "dl4j_tpu_serving_p99_seconds", ">",
                self.p99Threshold, model=model))

    def check(self, queuedRows: int = 0) -> Optional[Tuple[str, str]]:
        """(rule_name, detail) of the first firing rule, else None.

        Latency rules only apply while a backlog exists (``queuedRows``
        > 0): the p99 gauge is refreshed by dispatches, so with ALL
        traffic shed it would freeze above threshold and 429 an idle
        server forever.  An empty queue means the next request cannot be
        queue-delayed — admit it, and its dispatch refreshes the gauge.
        """
        reg = get_registry()
        now = time.time()
        rules = list(self._rules)
        if queuedRows > 0:
            rules += getattr(self, "_latencyRules", [])
        for rule in rules:
            detail = rule.evaluate(reg, now)
            if detail is not None:
                return rule.name, detail
        return None

    def checkKv(self, freePages: int, neededPages: int,
                retireRate: float,
                holdsPages: bool = True) -> Optional[Tuple[str, str, float]]:
        """KV-page headroom shed for paged executors: reject a request
        whose pages don't fit the pool's free list (beyond the
        ``minFreePages`` reserve) BEFORE it queues — an admitted
        sequence that can't grow its cache preempts its neighbours, so
        page exhaustion must degrade at the door, not wedge the batch.

        ``holdsPages=False`` bypasses the shed entirely: single-step
        retrieval sequences (top-k recommender lookups, quota == 1)
        emit their whole answer at admission and retire before any
        decode step, so they never occupy KV pages and cannot wedge the
        batch — a page deficit must not 429 them.  Queue-depth rules
        (``check``) still apply.

        Returns ``(rule, detail, retryAfter)`` or None.  The
        ``Retry-After`` is the page DEFICIT divided by the pool's
        observed mean retire rate (pages/sec): the client backs off for
        roughly as long as the pool needs to free the shortfall,
        instead of a fixed guess — clamped to
        [``retryAfter``, ``maxKvRetryAfter``].
        """
        if not holdsPages:
            return None
        headroom = int(freePages) - self.minFreePages
        needed = int(neededPages)
        if needed <= headroom:
            return None
        deficit = needed - max(headroom, 0)
        if retireRate and retireRate > 0:
            wait = deficit / float(retireRate)
        else:
            wait = self.maxKvRetryAfter     # nothing retiring yet: back
            # off hard rather than hammering an empty free list
        wait = min(max(wait, self.retryAfter), self.maxKvRetryAfter)
        return ("serving_kv_exhausted",
                f"kv page headroom exhausted: request needs {needed} "
                f"pages, {max(headroom, 0)} free past the "
                f"{self.minFreePages}-page reserve (mean retire rate "
                f"{float(retireRate):.2f} pages/s)", wait)


class _Request:
    __slots__ = ("payload", "rows", "event", "result", "error", "t0", "ctx")

    def __init__(self, payload, rows: int):
        self.payload = payload
        self.rows = int(rows)
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        # the ingress request context (trace id) rides on the request so
        # the executor's lifecycle notes land in the SAME timeline the
        # continuous-batching tier writes
        self.ctx: Optional[RequestContext] = current_context()


# ---------------------------------------------------------------------------
# model adapters
# ---------------------------------------------------------------------------

class ForwardServing:
    """Bucketed batched forward for MLN/ComputationGraph-style models.

    Requests are feature arrays; the group key is the non-batch shape
    (with the time axis bucketed), so the scheduler only ever
    concatenates compatible rows — a request with a mismatched trailing
    shape is ITS OWN 400 at validation time, never a poisoned batch.

    Sequence padding is mask-correct: rank-3 inputs are zero-padded up to
    the seq bucket and served with a features mask (1 = real timestep),
    so mask-honoring models produce outputs identical to the unpadded
    forward at every real position.  Rank-3 dispatches ALWAYS carry a
    mask (all-ones when unpadded), as the reference's do (for it,
    mask-presence is part of the trace).
    """

    def __init__(self, model, ladder: Optional[BucketLadder] = None,
                 inputShape: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.model = model
        self.ladder = ladder or BucketLadder()
        # trailing (non-batch) dims; rank-3 models give (nIn, None) and
        # get their time axis bucketed
        self.inputShape = tuple(inputShape) if inputShape is not None \
            else None
        self.dtype = dtype

    # -- request admission / grouping -----------------------------------
    def makeRequest(self, payload) -> _Request:
        xv = np.asarray(payload, dtype=self.dtype)
        if xv.ndim < 2:
            raise ValueError(
                f"features must include a batch axis; got shape {xv.shape}")
        if xv.shape[0] < 1:
            # a zero-row request must be ITS OWN 400: coalesced into a
            # batch it yields an empty dispatch that poisons every
            # neighbour's request with the concat error
            raise ValueError("features batch must contain at least one "
                             "row")
        if self.inputShape is not None:
            want = self.inputShape
            got = xv.shape[1:]
            ok = len(got) == len(want) and all(
                w is None or int(w) == int(g) for w, g in zip(want, got))
            if not ok:
                raise ValueError(
                    f"feature shape {tuple(got)} does not match the "
                    f"serving input shape {tuple(want)}")
        if xv.ndim == 3:
            self.ladder.seqBucket(xv.shape[2])      # reject un-warmable t
        return _Request(xv, xv.shape[0])

    def groupKey(self, req: _Request):
        xv = req.payload
        if xv.ndim == 3:
            return ("fwd3", xv.shape[1], self.ladder.seqBucket(xv.shape[2]))
        return ("fwd",) + tuple(xv.shape[1:])

    def maxRowsPerDispatch(self, key) -> int:
        return self.ladder.maxBatch

    # -- dispatch --------------------------------------------------------
    def _pad_rows(self, x: np.ndarray, bucket: int) -> np.ndarray:
        if x.shape[0] == bucket:
            return x
        pad = np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad], axis=0)

    def _run(self, x: np.ndarray, mask: Optional[np.ndarray]):
        if mask is not None:
            out = self.model.output(x, featuresMask=mask)
        else:
            out = self.model.output(x)
        return _host(out)

    def dispatch(self, key, reqs: List[_Request]) -> List[np.ndarray]:
        rank3 = key[0] == "fwd3"
        T = key[2] if rank3 else None
        xs, masks, true_t = [], [], []
        for r in reqs:
            xv = r.payload
            if rank3:
                t = xv.shape[2]
                true_t.append(t)
                if t < T:
                    padT = np.zeros(xv.shape[:2] + (T - t,), xv.dtype)
                    xv = np.concatenate([xv, padT], axis=2)
                m = np.zeros((xv.shape[0], T), np.float32)
                m[:, :t] = 1.0
                masks.append(m)
            xs.append(xv)
        x = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        mask = (np.concatenate(masks, axis=0) if len(masks) > 1
                else masks[0]) if rank3 else None
        results: List[Optional[np.ndarray]] = [None] * len(reqs)
        sm = serving_metrics()
        pos = 0
        chunk_start = 0
        maxB = self.ladder.maxBatch
        outs = []
        # oversized coalesced batches chunk at the TOP bucket — more than
        # one warm dispatch, never a fresh shape
        while chunk_start < x.shape[0]:
            rows = min(maxB, x.shape[0] - chunk_start)
            B = self.ladder.batchBucket(rows)
            cx = self._pad_rows(x[chunk_start:chunk_start + rows], B)
            cm = None
            if rank3:
                cm = np.ones((B, T), np.float32)
                cm[:rows] = mask[chunk_start:chunk_start + rows]
            sm.pad_rows().inc(B - rows, model=_model_name.get() or "?")
            sm.batch_occupancy().set(
                rows / B, model=_model_name.get() or "?")
            outs.append(self._run(cx, cm)[:rows])
            chunk_start += rows
        out = np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        for i, r in enumerate(reqs):
            piece = out[pos:pos + r.rows]
            if rank3 and piece.ndim == 3 and true_t[i] < T:
                piece = piece[:, :, :true_t[i]]
            results[i] = piece
            pos += r.rows
        return results

    # -- warm start ------------------------------------------------------
    def warmKeys(self):
        if self.inputShape is None:
            return []
        if len(self.inputShape) == 2 and self.inputShape[1] is None:
            return [("fwd3", self.inputShape[0], s)
                    for s in self.ladder.seqLens]
        return [("fwd",) + tuple(self.inputShape)]

    def warm(self, key) -> None:
        rank3 = key[0] == "fwd3"
        for B in self.ladder.batchSizes:
            if rank3:
                x = np.zeros((B, key[1], key[2]), self.dtype)
                m = np.ones((B, key[2]), np.float32)
                self._run(x, m)
            else:
                self._run(np.zeros((B,) + key[1:], self.dtype), None)

    def compileCacheSize(self) -> Optional[int]:
        """Fresh compiler runs of the model's AOT dispatches; None with the
        AOT cache off (eager PyTorch keeps no executable cache to
        probe)."""
        from deeplearning4j_tpu_torch.compile.aotcache import \
            _dispatch_cache_size
        return _dispatch_cache_size(self.model)


class GenerativeServing:
    """Bucketed KV-cache generation for :class:`TransformerLM`.

    Requests are ``{"tokens": [...], "maxNewTokens": n}``; the group key
    is the PROMPT bucket, prompts are LEFT-padded to it (uniform cache
    write position — see ``KVCache.start``), and one prefill + max(n)
    decode steps serve the whole group.  ``generate`` gets ``lengths``
    for every group, so prefill is the masked dense path (ROADMAP C2).
    """

    def __init__(self, lm, ladder: Optional[BucketLadder] = None):
        self.lm = lm
        cap = lm.config.maxLen
        self.ladder = ladder or BucketLadder(
            batchSizes=(1, 2, 4, 8),
            seqLens=tuple(s for s in (16, 32, 64, 128, 256, 512, 1024)
                          if s <= cap // 2) or (cap // 2,))

    def makeRequest(self, payload) -> _Request:
        if not isinstance(payload, dict) or "tokens" not in payload:
            raise ValueError('generative request needs {"tokens": [...]}')
        toks = np.asarray(payload["tokens"], np.int32)
        if toks.ndim == 1:
            toks = toks[None, :]
        if toks.ndim != 2 or toks.shape[0] < 1 or toks.shape[1] < 1:
            # enqueue-time rejection (offender-only 400): a zero-row or
            # empty prompt coalesced into a group would fail mid-dispatch
            # and poison every neighbour's request
            raise ValueError(f"tokens must be (t,) or (b, t) with b >= 1 "
                             f"and t >= 1; got shape {toks.shape}")
        vocab = self.lm.config.vocabSize
        if toks.min() < 0 or toks.max() >= vocab:
            raise ValueError(f"token ids must be in [0, {vocab})")
        n = int(payload.get("maxNewTokens", 16))
        if n < 1:
            raise ValueError("maxNewTokens must be >= 1")
        Tp = self.ladder.seqBucket(toks.shape[1])
        if Tp + n > self.lm.config.maxLen:
            raise ValueError(
                f"prompt bucket {Tp} + maxNewTokens {n} exceeds cache "
                f"capacity {self.lm.config.maxLen}")
        return _Request({"tokens": toks, "n": n}, toks.shape[0])

    def groupKey(self, req: _Request):
        return ("gen", self.ladder.seqBucket(req.payload["tokens"].shape[1]))

    def maxRowsPerDispatch(self, key) -> int:
        return self.ladder.maxBatch

    def _left_pad(self, toks: np.ndarray, Tp: int) -> np.ndarray:
        if toks.shape[1] == Tp:
            return toks
        pad = np.zeros((toks.shape[0], Tp - toks.shape[1]), np.int32)
        return np.concatenate([pad, toks], axis=1)

    def dispatch(self, key, reqs: List[_Request]) -> List[np.ndarray]:
        Tp = key[1]
        toks = np.concatenate(
            [self._left_pad(r.payload["tokens"], Tp) for r in reqs], axis=0)
        lengths = np.concatenate(
            [np.full(r.rows, r.payload["tokens"].shape[1], np.int32)
             for r in reqs])
        steps = max(r.payload["n"] for r in reqs)
        rows = toks.shape[0]
        sm = serving_metrics()
        name = _model_name.get() or "?"
        results: List[Optional[np.ndarray]] = [None] * len(reqs)
        chunk_start = 0
        outs = []
        maxB = self.ladder.maxBatch
        while chunk_start < rows:
            n = min(maxB, rows - chunk_start)
            B = self.ladder.batchBucket(n)
            ct = toks[chunk_start:chunk_start + n]
            cl = lengths[chunk_start:chunk_start + n]
            if n < B:
                # pad rows: single-token prompts, generated then dropped
                ct = np.concatenate(
                    [ct, np.zeros((B - n, Tp), np.int32)], axis=0)
                cl = np.concatenate([cl, np.ones(B - n, np.int32)])
            sm.pad_rows().inc(B - n, model=name)
            sm.batch_occupancy().set(n / B, model=name)
            outs.append(self.lm.generate(ct, steps, lengths=cl)[:n])
            sm.decode_tokens().inc(B * steps, model=name)
            chunk_start += n
        gen = np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        pos = 0
        for i, r in enumerate(reqs):
            results[i] = gen[pos:pos + r.rows, :r.payload["n"]]
            pos += r.rows
        return results

    def warmKeys(self):
        return [("gen", s) for s in self.ladder.seqLens]

    def warm(self, key) -> None:
        Tp = key[1]
        if Tp + 2 > self.lm.config.maxLen:
            return
        for B in self.ladder.batchSizes:
            # 2 new tokens: token 0 comes from prefill's logits, so only
            # a 2+-token generate runs the decode step too
            toks = np.zeros((B, Tp), np.int32)
            self.lm.generate(toks, 2,
                             lengths=np.full(B, max(1, Tp // 2), np.int32))

    def compileCacheSize(self) -> Optional[int]:
        """Fresh compiler runs of the LM's AOT dispatches; None with the
        AOT cache off (eager PyTorch keeps no executable cache to
        probe)."""
        from deeplearning4j_tpu_torch.compile.aotcache import \
            _dispatch_cache_size
        return _dispatch_cache_size(self.lm)


# ---------------------------------------------------------------------------
# access log
# ---------------------------------------------------------------------------

_ACCESS_LOG_ENV = "DL4J_TPU_ACCESS_LOG"
_ACCESS_LOG_LOCK = threading.Lock()


def _timeline_summary(trace_id: Optional[str]) -> dict:
    """Roll one request's timeline events up into the access-log fields:
    time-to-first-token, emitted token count, shed/failover flags."""
    out = {"ttft_s": None, "tokens": 0, "shed": False, "failover": False}
    got = timeline_store().get(trace_id) if trace_id else None
    if got is None:
        return out
    for ev in got.get("events", []):
        kind = ev.get("event")
        if kind == "serving.first_token" and out["ttft_s"] is None:
            out["ttft_s"] = ev.get("ttft_s")
        elif kind == "serving.retire":
            out["tokens"] += int(ev.get("tokens", 0) or 0)
        elif kind == "serving.shed":
            out["shed"] = True
        elif kind == "serving.failover":
            out["failover"] = True
    return out


def _write_access_line(ctx: Optional[RequestContext], route: str,
                       status: Optional[int], model: Optional[str],
                       total_s: float) -> None:
    """Append one NDJSON access-log line when ``DL4J_TPU_ACCESS_LOG`` is
    set.  Open-append-close per line: a rotation (rename + recreate)
    between lines lands the next line in the fresh file, never a held-
    open stale inode.  Logging failures never fail the request."""
    path = os.environ.get(_ACCESS_LOG_ENV, "").strip()
    if not path:
        return
    tid = ctx.traceId if ctx is not None else None
    record = {"ts": time.time(), "trace_id": tid, "model": model,
              "route": route, "status": status,
              "total_s": round(total_s, 6)}
    record.update(_timeline_summary(tid))
    line = json.dumps(record) + "\n"
    try:
        with _ACCESS_LOG_LOCK:
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
    except OSError:
        pass


# the adapter dispatch runs on executor worker threads; the model name
# they report metrics under travels in a context-local
class _ModelName(threading.local):
    def __init__(self):
        self.name = None

    def get(self):
        return self.name


_model_name = _ModelName()


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class BucketedExecutor:
    """Per-model batching scheduler over a warmed bucket ladder.

    ``submit()`` validates + enqueues and blocks for the result; worker
    threads repeatedly pick the group with the most queued rows (the
    largest ready bucket), coalesce up to the top batch bucket, and
    dispatch through the adapter.  Model weights stay on the model's
    device, owned by the adapter's model — every worker thread dispatches
    against the SAME tensors, so hosting cost is one weight copy per model
    regardless of worker count.
    """

    def __init__(self, serving, name: str = "default",
                 admission: Optional[AdmissionControl] = None,
                 workers: int = 1):
        self.serving = serving
        self.name = str(name)
        self.admission = admission or AdmissionControl()
        self._workers = max(1, int(workers))
        self._groups: Dict[object, deque] = {}
        self._queuedRows = 0
        self._cv = threading.Condition()
        self._threads: List[threading.Thread] = []
        self._running = False
        self._warmed = False
        self._cacheSeen: Optional[int] = None
        self._acctLock = threading.Lock()

    # -- lifecycle -------------------------------------------------------
    def warm(self) -> float:
        """Run every ladder bucket once BEFORE traffic arrives (cuBLAS
        heuristics, the caching allocator's first blocks).  With the AOT
        cache configured, first wrap the model's entry points in it, which
        preloads their ladders — warm boots then LOAD the kernel libraries
        instead of compiling them — and count the fresh compiler runs the
        ladder took into ``dl4j_tpu_serving_warmup_compiles_total``.
        Returns the warm-up wall seconds, which also land in
        ``dl4j_tpu_serving_warmup_seconds`` — the server-start-to-ready
        cost an operator watches."""
        if self._warmed:
            return 0.0
        sm = serving_metrics()
        t0 = time.perf_counter()
        from deeplearning4j_tpu_torch.compile.aotcache import \
            wrap_serving_model
        wrap_serving_model(getattr(self.serving, "model", None) or
                           getattr(self.serving, "lm", None))
        before = self.serving.compileCacheSize()
        _model_name.name = self.name
        try:
            for key in self.serving.warmKeys():
                self.serving.warm(key)
        finally:
            _model_name.name = None
        after = self.serving.compileCacheSize()
        if before is not None and after is not None:
            sm.warmup_compiles().inc(max(0, after - before),
                                     model=self.name)
        self._warmed = True
        dt = time.perf_counter() - t0
        sm.warmup_seconds().observe(dt, model=self.name)
        return dt

    def start(self) -> "BucketedExecutor":
        if self._running:
            return self
        sm = serving_metrics()
        self.admission.bind(self.name)
        sm.queue_depth().set(0, model=self.name)
        if self.serving.compileCacheSize() is not None:
            # materialize the hit/miss cells at zero: a scrape (or
            # hit-rate probe) must see an explicit 0, not an absent series
            sm.compile_hits().inc(0, model=self.name)
            sm.compile_misses().inc(0, model=self.name)
        self.warm()
        self._cacheSeen = self.serving.compileCacheSize()
        self._running = True
        self._threads = []
        for i in range(self._workers):
            th = threading.Thread(target=self._loop, daemon=True,
                                  name=f"serving-{self.name}-{i}")
            th.start()
            self._threads.append(th)
        return self

    def shutdown(self) -> None:
        with self._cv:
            if not self._running:
                return
            self._running = False
            # reject everything still queued under the SAME lock that
            # gates enqueue — a submit that raced past the running check
            # either lands before this drain (rejected here) or re-checks
            # running and raises at the caller
            err = RuntimeError(f"serving executor {self.name!r} shut down")
            for dq in self._groups.values():
                for req in dq:
                    req.error = err
                    req.event.set()
            self._groups.clear()
            self._queuedRows = 0
            self._cv.notify_all()
        for th in self._threads:
            th.join(timeout=5.0)
        self._threads = []
        # registry locks are never taken under _cv (scheduler -> registry
        # lock order); the zero is written
        # AFTER the worker joins so no in-flight worker write can land
        # later and leave a phantom backlog on a stopped executor
        serving_metrics().queue_depth().set(0, model=self.name)

    # -- request path ----------------------------------------------------
    def queuedRows(self) -> int:
        with self._cv:
            return self._queuedRows

    def submit(self, payload, timeout: Optional[float] = None):
        """Validate, admit, enqueue, and block until the result is ready.
        Raises ``ValueError`` for malformed payloads (HTTP 400),
        :class:`ServiceOverloaded` when admission sheds (HTTP 429)."""
        sm = serving_metrics()
        req = self.serving.makeRequest(payload)      # offender-only 400
        tid = req.ctx.traceId if req.ctx is not None else None
        queued = self.queuedRows()
        # re-sync the depth gauge from the live count BEFORE admission
        # reads it: gauge writes happen outside _cv (lock discipline —
        # scheduler locks never hold registry locks), so a drain/enqueue
        # pair can land out of order; without this refresh a stale high
        # value could shed traffic forever (shed requests never enqueue,
        # so nothing else would rewrite the gauge on an idle queue)
        sm.queue_depth().set(queued, model=self.name)
        fired = self.admission.check(queued)
        if fired is not None:
            rule, detail = fired
            sm.shed().inc(model=self.name, rule=rule)
            sm.requests().inc(model=self.name, outcome="shed")
            timeline_store().note(tid, "serving.shed", model=self.name,
                                  stage="admission", rule=rule)
            raise ServiceOverloaded(detail, self.admission.retryAfter)
        key = self.serving.groupKey(req)
        with self._cv:
            if not self._running:
                raise RuntimeError(
                    f"serving executor {self.name!r} is not running")
            self._groups.setdefault(key, deque()).append(req)
            self._queuedRows += req.rows
            depth = self._queuedRows
            self._cv.notify()
        # gauge write AFTER releasing _cv (scheduler -> registry lock
        # order; see shutdown)
        sm.queue_depth().set(depth, model=self.name)
        timeline_store().note(tid, "serving.enqueue", model=self.name,
                              rows=req.rows)
        if not req.event.wait(timeout):
            # pull the abandoned request back OUT of the queue — left
            # behind it would still be dispatched at full device cost
            # (a whole prefill+decode for generative models) with nobody
            # waiting, and its rows would keep feeding the admission
            # queue-depth rule
            depth = None
            with self._cv:
                dq = self._groups.get(key)
                if dq is not None and req in dq:
                    dq.remove(req)
                    if not dq:
                        del self._groups[key]
                    self._queuedRows -= req.rows
                    depth = self._queuedRows
            if depth is not None:
                sm.queue_depth().set(depth, model=self.name)
            if not req.event.is_set():   # not completed while cancelling
                timeline_store().note(tid, "serving.retire",
                                      model=self.name, rows=req.rows,
                                      error="TimeoutError")
                raise TimeoutError(
                    f"serving request timed out after {timeout}s")
        if req.error is not None:
            timeline_store().note(tid, "serving.retire", model=self.name,
                                  rows=req.rows,
                                  error=type(req.error).__name__)
            raise req.error
        timeline_store().note(tid, "serving.retire", model=self.name,
                              rows=req.rows, error=None)
        return req.result

    # -- scheduler -------------------------------------------------------
    def _take_batch(self):
        """Under the lock: pop the largest ready group's requests up to
        the top batch bucket.  Returns (key, [requests]) or None."""
        if not self._groups:
            return None
        key = max(self._groups, key=lambda k: sum(
            r.rows for r in self._groups[k]))
        dq = self._groups[key]
        limit = self.serving.maxRowsPerDispatch(key)
        batch, rows = [], 0
        while dq and (not batch or rows + dq[0].rows <= limit):
            r = dq.popleft()
            batch.append(r)
            rows += r.rows
        if not dq:
            del self._groups[key]
        self._queuedRows -= rows
        return key, batch

    def _loop(self) -> None:
        sm = serving_metrics()
        while True:
            with self._cv:
                while self._running and self._queuedRows == 0:
                    self._cv.wait(0.1)
                if not self._running:
                    return
                taken = self._take_batch()
                depth = self._queuedRows
            # the registry's metric locks are taken only AFTER _cv is
            # released — one global scheduler -> registry order on every
            # path
            sm.queue_depth().set(depth, model=self.name)
            if taken is None:
                continue
            key, batch = taken
            _model_name.name = self.name
            try:
                results = self.serving.dispatch(key, batch)
            except Exception as e:
                for r in batch:
                    r.error = e
                    r.event.set()
                sm.requests().inc(len(batch), model=self.name,
                                  outcome="error")
                _model_name.name = None
                continue
            _model_name.name = None
            after = self.serving.compileCacheSize()
            if after is not None:
                # misses count fresh compiler runs (the dispatches' count
                # past the high-water mark), hits count clean dispatches
                with self._acctLock:
                    seen = self._cacheSeen if self._cacheSeen is not None \
                        else after
                    if after > seen:
                        sm.compile_misses().inc(after - seen,
                                                model=self.name)
                        self._cacheSeen = after
                    else:
                        sm.compile_hits().inc(model=self.name)
            now = time.perf_counter()
            hist = sm.request_seconds()
            for r, res in zip(batch, results):
                r.result = res
                hist.observe(now - r.t0, model=self.name)
                r.event.set()
            sm.requests().inc(len(batch), model=self.name, outcome="ok")
            p99 = histogram_quantile(hist, 0.99, model=self.name)
            if p99 is not None:
                sm.p99_seconds().set(p99, model=self.name)

    # -- introspection ---------------------------------------------------
    def compileHitRate(self) -> Optional[float]:
        """hits / (hits + misses) since start; None before any traffic or
        with the AOT cache off (then eager PyTorch compiles nothing and no
        accounting is kept)."""
        if self.serving.compileCacheSize() is None:
            return None
        sm = serving_metrics()
        try:
            h = sm.compile_hits().value(model=self.name)
            m = sm.compile_misses().value(model=self.name)
        except Exception:
            return None
        return h / (h + m) if (h + m) > 0 else None


# ---------------------------------------------------------------------------
# multi-model hosting
# ---------------------------------------------------------------------------

class ModelRegistry:
    """name -> :class:`BucketedExecutor`; the first registered model is
    the default route for bare ``/v1/serving``."""

    def __init__(self):
        self._executors: Dict[str, BucketedExecutor] = {}
        self._default: Optional[str] = None
        self._lock = threading.Lock()

    def register(self, name: str, serving,
                 admission: Optional[AdmissionControl] = None,
                 workers: int = 1):
        """``serving`` is a model adapter (:class:`ForwardServing` /
        :class:`GenerativeServing`, wrapped in a fresh
        :class:`BucketedExecutor`) or an already-built executor-like —
        anything with ``start``/``submit``/``shutdown`` (a
        ``BucketedExecutor``, a continuous-batching
        ``scheduler.ContinuousBatcher``, a ``scheduler.ReplicaSet``)
        hosts as-is behind the route."""
        if isinstance(serving, BucketedExecutor):
            ex = serving
            ex.name = name
        elif hasattr(serving, "submit") and hasattr(serving, "start") \
                and not hasattr(serving, "makeRequest"):
            ex = serving
            ex.name = name
        else:
            ex = BucketedExecutor(serving, name=name, admission=admission,
                                  workers=workers)
        with self._lock:
            if name in self._executors:
                raise ValueError(f"model {name!r} already registered")
            self._executors[name] = ex
            if self._default is None:
                self._default = name
        return ex

    def get(self, name: Optional[str]) -> Optional[BucketedExecutor]:
        with self._lock:
            if name is None or name == "":
                name = self._default
            return self._executors.get(name) if name else None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._executors)

    def start(self) -> "ModelRegistry":
        for ex in list(self._executors.values()):
            ex.start()
        return self

    def shutdown(self) -> None:
        for ex in list(self._executors.values()):
            ex.shutdown()


class InferenceServer:
    """HTTP front of the serving tier.

    ``POST /v1/serving/<name>`` (bare ``/v1/serving`` = default model)
    with ``{"features": [...]}`` for forward models or
    ``{"tokens": [...], "maxNewTokens": n}`` for generative ones.
    Status split: 400 = the caller's payload, 404 = unknown model,
    429 + ``Retry-After`` = admission shed, 500 = ours.  GET serves the
    shared observability surface (``/metrics``, ``/healthz``, ...) plus
    ``/v1/serving`` (model listing).
    """

    def __init__(self, registry: ModelRegistry, port: int = 0):
        self.registry = registry
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "InferenceServer":
        # observability side-cars: the in-process retention ring backing
        # /metrics/query always runs with a server; the OTLP exporter
        # only when DL4J_TPU_OTLP_ENDPOINT points at a collector
        from deeplearning4j_tpu_torch.telemetry import (ensure_otlp_exporter,
                                                        ensure_retention)
        ensure_retention()
        ensure_otlp_exporter()
        self.registry.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 so token streaming can use chunked transfer
            # encoding (every non-streaming reply carries an exact
            # Content-Length via reply_safely, as 1.1 keep-alive needs)
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: bytes, ctype: str,
                       headers: Optional[Dict[str, str]] = None) -> None:
                from deeplearning4j_tpu_torch.remote.server import reply_safely
                ctx = getattr(self, "_ctx", None)
                if ctx is not None:
                    headers = dict(headers or {})
                    headers.setdefault("X-Trace-Id", ctx.traceId)
                reply_safely(self, code, body, ctype, headers)

            def _reply_json(self, code: int, obj,
                            headers: Optional[Dict[str, str]] = None):
                # every error body carries the trace id so a client's
                # log line alone is enough to pull /v1/requests/<id>
                ctx = getattr(self, "_ctx", None)
                if ctx is not None and code >= 400 and isinstance(obj,
                                                                  dict):
                    obj.setdefault("trace_id", ctx.traceId)
                self._reply(code, json.dumps(obj).encode("utf-8"),
                            "application/json", headers)

            def do_GET(self):
                from deeplearning4j_tpu_torch.telemetry.http import \
                    observability_route
                route = observability_route(self.path)
                if route is not None:
                    self._reply(*route)
                    return
                if self.path.rstrip("/") == "/v1/serving":
                    self._reply_json(200,
                                     {"models": server.registry.names()})
                    return
                self._reply_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                # ONE trace context per request, minted here or parsed
                # from the caller's W3C traceparent; every continuation
                # (executor enqueue, batcher admission, failover replay)
                # reads it off the contextvar, so the whole life of the
                # request shares one trace id
                t0 = time.perf_counter()
                ctx = parse_traceparent(
                    self.headers.get("traceparent")) \
                    or RequestContext.new()
                self._ctx = ctx
                route = self.path
                status, model = None, None
                try:
                    with request_context(ctx):
                        status, model = self._serve_post(ctx)
                finally:
                    _write_access_line(ctx, route, status, model,
                                       time.perf_counter() - t0)

            def _serve_post(self, ctx):
                """Dispatch one POST; returns ``(status, model)`` for the
                access log (the reply has already been written)."""
                name = None
                path = self.path.rstrip("/")
                if path == "/v1/serving":
                    name = None
                elif path.startswith("/v1/serving/"):
                    name = path[len("/v1/serving/"):]
                else:
                    self._reply_json(404,
                                     {"error": f"no route {self.path}"})
                    return 404, None
                ex = server.registry.get(name)
                if ex is None:
                    self._reply_json(404, {
                        "error": f"unknown model {name!r}; hosted: "
                                 f"{server.registry.names()}"})
                    return 404, name
                model = getattr(ex, "name", name)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:
                    self._reply_json(400,
                                     {"error": f"{type(e).__name__}: {e}"})
                    return 400, model
                try:
                    if "features" in payload:
                        out = ex.submit(payload["features"])
                        body, code = {"output": np.asarray(out).tolist()}, \
                            200
                    elif "tokens" in payload:
                        if payload.get("stream"):
                            if not hasattr(ex, "submitStream"):
                                # an explicit 400 beats silently
                                # answering a different response shape
                                self._reply_json(400, {
                                    "error": f"model {ex.name!r} does "
                                    "not support streaming"})
                                return 400, model
                            # validation/shed errors surface HERE (the
                            # call enqueues eagerly) as normal 400/429
                            # replies; once the generator exists, tokens
                            # stream out as each decode step completes
                            gen = ex.submitStream(payload)
                            from deeplearning4j_tpu_torch.remote.server import (
                                KEEPALIVE, stream_ndjson)
                            stream_ndjson(
                                self,
                                (t if t is KEEPALIVE else {"token": t}
                                 for t in gen),
                                final={"done": True},
                                headers={"X-Trace-Id": ctx.traceId})
                            return 200, model
                        out = ex.submit(payload)
                        body = {"tokens": np.asarray(out).tolist()}
                        code = 200
                    else:
                        body = {"error": "payload needs 'features' or "
                                         "'tokens'"}
                        code = 400
                except ServiceOverloaded as e:
                    self._reply_json(
                        429, {"error": f"overloaded: {e}",
                              "retry_after": e.retryAfter},
                        headers={"Retry-After":
                                 str(max(1, int(math.ceil(e.retryAfter))))})
                    return 429, model
                except NoHealthyReplicas as e:
                    # transient fleet state, not a server bug: 503 tells
                    # the client to back off, 500 would page someone
                    self._reply_json(
                        503, {"error": f"no healthy replicas: {e}",
                              "retry_after": e.retryAfter},
                        headers={"Retry-After":
                                 str(max(1, int(math.ceil(e.retryAfter))))})
                    return 503, model
                except DeadlineExceeded as e:
                    body, code = {"error": f"deadline exceeded: {e}"}, 504
                except (ValueError, TypeError) as e:
                    body, code = {"error": f"{type(e).__name__}: {e}"}, 400
                except Exception as e:
                    # torch's wrong-shape RuntimeError is the caller's too
                    body = {"error": f"{type(e).__name__}: {e}"}
                    code = 400 if is_shape_error(e) else 500
                self._reply_json(code, body)
                return code, model

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            # stop() must not return while the acceptor thread still
            # runs — handlers mid-request would race the executor
            # shutdown below
            self._thread.join(timeout=5.0)
            self._thread = None
        self.registry.shutdown()
