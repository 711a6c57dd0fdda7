"""Iteration-level continuous batching: paged KV-cache pool, admit/retire
scheduler, speculative decode, and replica fan-out — the port of
``deeplearning4j_tpu/remote/scheduler.py``.

- :class:`KVCachePool` — fixed-size pages over ONE preallocated device
  buffer per model, with per-slot page tables.  Admitting or retiring a
  sequence is a host-side free-list edit; the step's shapes (slots x
  page-table width x pool) never change (``nn/conf/attention.py
  paged_attention`` is the device-side math).
- :class:`ContinuousBatcher` — the iteration-level scheduler: a fixed slot
  array steps through ONE shared paged decode step; finished sequences
  retire and queued ones admit BETWEEN steps (strict-FIFO admission), each
  new token streams back to the waiting client as its step completes, and
  a pool squeeze preempts the youngest slot (restart-with-skip) instead of
  wedging.  With a small draft :class:`~deeplearning4j_tpu_torch.nlp.
  transformer.TransformerLM` attached, every step is a speculative round:
  the draft proposes ``draftK`` tokens, the target verifies all of them in
  ONE batched forward, and the accept-prefix rule keeps the output the
  target's own greedy tokens.
- :class:`ReplicaSet` — fan-out behind one registry route: requests route
  to the least-loaded live replica, a prober retires unhealthy replicas and
  fails their sequences over (``forced`` / ``streamSkip`` make the move
  invisible to a client), and ``armAutoscale`` scales the set one replica
  up/down on the ``serving_queue_depth`` alert's edges.

Threads: all device work of a batcher runs on its one stepping thread
(and in ``warm()``, before it starts); HTTP handler threads only move
numpy.  The copy of each step's tokens to the host is the step's one
synchronisation point.  The pools are tensors the stepping thread writes
in place (the reference donates them to each jitted step and swaps in
the returned arrays).

Where the port departs: eager PyTorch compiles no executables, and the
batcher's step functions are not AOT dispatches, so there is no warm-up
compile count; ``compileCacheSize`` returns None with the AOT cache off
(the default) and, with it configured, the fresh compiler runs of the
LMs' dispatches (``compile.aotcache``); ``warm()`` still runs every step
function and prompt bucket once.  ``device=`` moves the models to that
``torch.device`` (the one-device case of the reference's
``meshtrainer.place_replica``).  The tensor-parallel replica path
(``plan=`` / :meth:`ContinuousBatcher.applyPlan`) waits for the model
axis, ROADMAP A10b, and raises naming it.
"""
from __future__ import annotations

import queue as _stdqueue
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.fault import injection as _inj
from deeplearning4j_tpu_torch.remote.serving import (AdmissionControl,
                                                     BucketLadder,
                                                     DeadlineExceeded,
                                                     NoHealthyReplicas,
                                                     ServiceOverloaded)
from deeplearning4j_tpu_torch.telemetry import (
    RequestContext, ThresholdRule, current_context, flight_recorder,
    observe_exemplar, serving_metrics, timeline_store, tracer)

__all__ = ["KVCachePool", "ContinuousBatcher", "ReplicaSet"]


def place_replica(model, device) -> None:
    """Move a model's parameters to ``device`` (a ``torch.device``) and
    point its entry points there — the one-device case of the
    reference's ``meshtrainer.place_replica``."""
    device = resolve_device(device)
    model.to(device)
    model.device = device


class KVCachePool:
    """Paged KV memory for one model: ``(nLayers, numPages, nHeads,
    pageSize, headSize)`` device buffers plus a host-side free list and
    per-slot page tables.

    Page 0 is the SCRATCH page: inactive slots' table entries point at
    it, so the fixed-shape step can write their (ignored) K/V somewhere
    harmless.  ``ensure``/``release`` are plain list edits — allocation
    never reallocates device memory.
    """

    def __init__(self, nLayers: int, nHeads: int, headSize: int,
                 pageSize: int = 8, numPages: int = 64, maxSlots: int = 4,
                 maxPagesPerSeq: int = 8, dtype=torch.float32,
                 device=None):
        self.pageSize = int(pageSize)
        self.numPages = int(numPages)
        self.maxSlots = int(maxSlots)
        self.maxPagesPerSeq = int(maxPagesPerSeq)
        if self.numPages < self.maxPagesPerSeq + 1:
            # invariant the preemption path relies on: a LONE sequence
            # always fits once everything else is evicted
            raise ValueError(
                f"numPages={self.numPages} must exceed maxPagesPerSeq="
                f"{self.maxPagesPerSeq} (page 0 is reserved scratch)")
        shape = (int(nLayers), self.numPages, int(nHeads), self.pageSize,
                 int(headSize))
        dev = resolve_device(device)
        self.k = torch.zeros(shape, dtype=dtype, device=dev)
        self.v = torch.zeros(shape, dtype=dtype, device=dev)
        self.pageTable = np.zeros((self.maxSlots, self.maxPagesPerSeq),
                                  np.int32)
        self._free = deque(range(1, self.numPages))
        self._held: List[List[int]] = [[] for _ in range(self.maxSlots)]

    def freePages(self) -> int:
        return len(self._free)

    def usedPages(self) -> int:
        return (self.numPages - 1) - len(self._free)

    def pagesFor(self, tokens: int) -> int:
        return -(-int(tokens) // self.pageSize)

    def capacityTokens(self) -> int:
        return self.maxPagesPerSeq * self.pageSize

    def heldIds(self, slot: int) -> List[int]:
        return list(self._held[slot])

    def ensure(self, slot: int, upTo: int) -> bool:
        """Grow ``slot``'s allocation to cover positions ``[0, upTo)``.
        False when the free list (or the per-sequence table width)
        can't — the scheduler then preempts or defers."""
        want = self.pagesFor(upTo)
        if want > self.maxPagesPerSeq:
            return False
        held = self._held[slot]
        need = want - len(held)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            pid = self._free.popleft()
            self.pageTable[slot, len(held)] = pid
            held.append(pid)
        return True

    def release(self, slot: int) -> int:
        """Free every page ``slot`` holds; returns how many."""
        held = self._held[slot]
        n = len(held)
        self._free.extend(held)
        held.clear()
        self.pageTable[slot, :] = 0
        return n


class _Pending:
    """One client request: its rows fan out to sequences; results
    reassemble when the last row retires.  Completion bookkeeping uses a
    PER-REQUEST lock, not a per-batcher one: after a failover the rows
    of one request can retire on DIFFERENT replicas concurrently."""
    __slots__ = ("rows", "quota", "doneRows", "error", "event", "t0",
                 "deadline", "lock", "ctx", "firstTokenAt")

    def __init__(self, rows: int, quota: int,
                 deadline: Optional[float] = None,
                 ctx: Optional[RequestContext] = None):
        self.rows = int(rows)
        self.quota = int(quota)
        self.doneRows = 0
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.t0 = time.perf_counter()
        self.deadline = deadline        # absolute time.monotonic(), or None
        self.lock = threading.Lock()
        # request-scoped observability: ONE context for the request's
        # whole life, shared by every row and surviving failover hops
        self.ctx = ctx
        self.firstTokenAt: Optional[float] = None   # TTFT observed once


class _Seq:
    """One sequence of a request: queued, then bound to a decode slot."""
    __slots__ = ("tokens", "realLen", "bucket", "quota", "pages", "parent",
                 "row", "emitted", "streamQ", "streamed", "streamSkip",
                 "cancelled", "restarts", "deadline", "forced", "ctx",
                 "enqT", "lastTokT")

    def __init__(self, tokens: np.ndarray, bucket: int, quota: int,
                 pages: int, parent: _Pending, row: int,
                 deadline: Optional[float] = None):
        self.tokens = tokens            # (1, realLen) int32
        self.realLen = int(tokens.shape[1])
        self.bucket = int(bucket)
        self.quota = int(quota)
        self.pages = int(pages)
        self.parent = parent
        self.row = int(row)
        self.emitted: List[int] = []
        self.streamQ: Optional[_stdqueue.Queue] = None
        self.streamed = 0               # tokens pushed to the stream, ever
        self.streamSkip = 0             # re-emissions to swallow after a preempt
        self.cancelled = False
        self.restarts = 0
        self.deadline = deadline        # absolute time.monotonic(), or None
        # the already-computed token prefix, teacher-forced during a
        # replay so the prefix a client sees never depends on bit-wise
        # reproducibility across the replica that adopts the sequence
        self.forced: List[int] = []
        self.ctx = parent.ctx           # the request's one trace context
        self.enqT: Optional[float] = None    # perf_counter at last enqueue
        self.lastTokT: Optional[float] = None  # last FRESH token's time


def _finish_seq(seq: _Seq, error: Optional[BaseException],
                model: str) -> None:
    """Deliver a sequence's final verdict to its request.  Module-level
    (not a batcher method) because after a failover the finishing
    replica is not the admitting one — and the replica set itself
    finishes orphans when no survivor can adopt them."""
    parent = seq.parent
    if seq.streamQ is not None:
        seq.streamQ.put(error)          # None = clean end sentinel
    with parent.lock:
        parent.doneRows += 1
        if error is not None and parent.error is None:
            parent.error = error
        last = parent.doneRows >= parent.rows
    tid = parent.ctx.traceId if parent.ctx is not None else None
    timeline_store().note(tid, "serving.retire", replica=model,
                          row=seq.row, tokens=len(seq.emitted),
                          error=type(error).__name__ if error else None)
    if last:
        sm = serving_metrics()
        sm.request_seconds().observe(time.perf_counter() - parent.t0,
                                     model=model)
        sm.requests().inc(model=model,
                          outcome="error" if parent.error else "ok")
        if parent.error is not None and tid is not None:
            # a failed request's whole timeline lands in the crash ring
            # so the post-mortem has the trace without racing eviction
            flight_recorder().record(
                kind="serving_request_failure", trace_id=tid, model=model,
                error=f"{type(parent.error).__name__}: {parent.error}",
                timeline=timeline_store().events(tid))
        parent.event.set()


class ContinuousBatcher:
    """The iteration-level scheduler: one shared fixed-slot decode batch,
    admit/retire between steps, token streaming, optional speculative
    decode, paged KV memory.

    Registry-compatible executor surface (``start``/``submit``/
    ``submitStream``/``queuedRows``/``shutdown``), so it hosts behind
    ``POST /v1/serving/<name>`` exactly like a
    :class:`~deeplearning4j_tpu_torch.remote.serving.BucketedExecutor` —
    ``{"tokens": [...], "maxNewTokens": n}`` payloads, plus
    ``{"stream": true}`` for per-token NDJSON streaming.
    """

    def __init__(self, lm, name: str = "default", draft=None,
                 draftK: int = 4, pageSize: int = 8,
                 numPages: Optional[int] = None, maxSlots: int = 4,
                 ladder: Optional[BucketLadder] = None,
                 admission: Optional[AdmissionControl] = None,
                 eosToken: Optional[int] = None, plan=None, device=None,
                 retireLogSize: int = 64):
        if plan is not None:
            raise NotImplementedError(
                "the tensor-parallel replica path (plan=) needs a model "
                "axis, which waits for ROADMAP A10b")
        self.lm = lm
        self.draft = draft
        self.draftK = int(draftK) if draft is not None else 0
        if draft is not None:
            if self.draftK < 1:
                raise ValueError("draftK must be >= 1 with a draft model")
            if draft.config.vocabSize != lm.config.vocabSize:
                raise ValueError("draft and target must share a vocabulary")
        self.name = str(name)
        cfg = lm.config
        self.pageSize = int(pageSize)
        self._maxPagesPerSeq = -(-(cfg.maxLen + self.draftK)
                                 // self.pageSize)
        self._numPages = int(numPages) if numPages is not None else \
            1 + int(maxSlots) * self._maxPagesPerSeq
        self.maxSlots = int(maxSlots)
        self.eosToken = int(eosToken) if eosToken is not None else None
        self.admission = admission or AdmissionControl()
        # the SMALLER cache bounds every admissible position when a
        # draft rides along (both models ingest the same prompt)
        effCap = cfg.maxLen if draft is None \
            else min(cfg.maxLen, draft.config.maxLen)
        if ladder is None:
            ladder = BucketLadder(
                batchSizes=(self.maxSlots,),
                seqLens=tuple(
                    s for s in (16, 32, 64, 128, 256, 512, 1024)
                    if s <= max(effCap // 2, self.pageSize)
                    and s % self.pageSize == 0) or (self.pageSize,))
        for s in ladder.seqLens:
            if s % self.pageSize:
                raise ValueError(
                    f"prompt bucket {s} is not a multiple of the page "
                    f"size {self.pageSize} (prefill copies whole pages)")
            if s >= effCap:
                raise ValueError(
                    f"prompt bucket {s} leaves no room to generate "
                    f"within the capacity {effCap}"
                    + (" (bounded by the draft model)"
                       if draft is not None and
                       draft.config.maxLen < cfg.maxLen else ""))
        self.ladder = ladder
        # slot state — owned by the loop thread
        self._slotSeq: List[Optional[_Seq]] = [None] * self.maxSlots
        self._pos = np.zeros(self.maxSlots, np.int32)
        self._start = np.zeros(self.maxSlots, np.int32)
        self._tok = np.zeros(self.maxSlots, np.int32)
        self._admitOrder: deque = deque()   # slots, oldest admission first
        # request queue — guarded by _cv
        self._queue: deque = deque()
        self._queuedRows = 0
        self._queuedPages = 0
        self._cv = threading.Condition()
        self._running = False
        self._warmed = False
        self._thread: Optional[threading.Thread] = None
        # bounded ring of (ts, pages freed): _retireRate() only ever
        # needs the recent window, and an unbounded log on a long-lived
        # replica would grow its Retry-After bookkeeping forever
        self._retireLog: deque = deque(maxlen=max(2, int(retireLogSize)))
        # set by ReplicaSet: called with (batcher, seqs, error) when a
        # shared step fails with sequences in flight — the failover
        # path.  None (standalone batcher) errors the sequences instead.
        self.onSequenceFailure = None
        self._stepFns: Dict[str, object] = {}
        self._busySteps = 0.0
        self._steps = 0
        if device is not None:
            place_replica(lm, device)
            if draft is not None:
                place_replica(draft, device)
        self._device = lm.device
        if draft is not None and draft.device != self._device:
            raise ValueError(f"the draft runs on {draft.device}, the "
                             f"target on {self._device}")
        self._buildPools()

    # -- placement ------------------------------------------------------
    def _buildPools(self) -> None:
        cfg = self.lm.config
        self.pool = KVCachePool(
            cfg.nLayers, cfg.nHeads, cfg.headSize, self.pageSize,
            self._numPages, self.maxSlots, self._maxPagesPerSeq,
            device=self._device)
        if self.draft is not None:
            dc = self.draft.config
            self.draftPool = KVCachePool(
                dc.nLayers, dc.nHeads, dc.headSize, self.pageSize,
                self._numPages, self.maxSlots, self._maxPagesPerSeq,
                device=self._device)
        else:
            self.draftPool = None

    def applyPlan(self, plan) -> None:
        """The tensor-parallel replica path: waits for ROADMAP A10b."""
        raise NotImplementedError(
            "applyPlan needs a model axis, which waits for "
            "ROADMAP A10b")

    # -- step functions -------------------------------------------------
    def _invalidateFns(self) -> None:
        """Pools changed: drop the step functions and re-warm before the
        next step (the reference must also drop its traced closures)."""
        self._stepFns.clear()
        self._warmed = False

    def _ensureFns(self) -> None:
        if "step" in self._stepFns:
            return
        self._stepFns["step"] = self.lm.buildPagedDecodeFn()
        self._stepFns["write"] = self.lm.buildPagedPrefillWriteFn()
        if self.draft is not None:
            self._stepFns["propose"] = \
                self.draft.buildPagedProposeFn(self.draftK)
            self._stepFns["dwrite"] = self.draft.buildPagedPrefillWriteFn()

    def compileCacheSize(self) -> Optional[int]:
        """Fresh compiler runs of the target's and the draft's AOT
        dispatches; None with the AOT cache off (eager PyTorch keeps no
        executable cache; the reference counts its jit-cache entries
        here)."""
        from deeplearning4j_tpu_torch.compile.aotcache import \
            _dispatch_cache_size
        return _dispatch_cache_size(self.lm, self.draft)

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def warm(self) -> float:
        """Run every steady-state step once BEFORE traffic: one prefill +
        pool write per prompt bucket (scratch pages take the dummy
        writes), the tq=1 decode step, and with a draft the tq=draftK+1
        verify plus the proposal loop.  Their time lands in
        ``dl4j_tpu_serving_warmup_seconds``."""
        if self._warmed:
            return 0.0
        t0 = time.perf_counter()
        self._ensureFns()
        S = self.maxSlots
        zeros = np.zeros(S, np.int32)
        step = self._stepFns["step"]
        step(self.pool.k, self.pool.v, np.zeros((S, 1), np.int32),
             self.pool.pageTable, zeros, zeros)
        if self.draft is not None:
            step(self.pool.k, self.pool.v,
                 np.zeros((S, self.draftK + 1), np.int32),
                 self.pool.pageTable, zeros, zeros)
            self._stepFns["propose"](
                self.draftPool.k, self.draftPool.v, zeros,
                self.draftPool.pageTable, zeros, zeros)
        for Tp in self.ladder.seqLens:
            dummy = np.zeros((1, Tp), np.int32)
            ids = np.zeros(Tp // self.pageSize, np.int32)   # scratch
            _l, ks, vs = self.lm.prefillRaw(dummy, lengths=[1])
            self._stepFns["write"](self.pool.k, self.pool.v, ks[:, 0],
                                   vs[:, 0], ids)
            if self.draft is not None:
                _l, dks, dvs = self.draft.prefillRaw(dummy, lengths=[1])
                self._stepFns["dwrite"](self.draftPool.k, self.draftPool.v,
                                        dks[:, 0], dvs[:, 0], ids)
        self._sync()    # the warm-up's device time lands in warmup_seconds
        self._warmed = True
        dt = time.perf_counter() - t0
        serving_metrics().warmup_seconds().observe(dt, model=self.name)
        return dt

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        if self._running:
            return self
        sm = serving_metrics()
        self.admission.bind(self.name)
        sm.queue_depth().set(0, model=self.name)
        # register the latency-decomposition histograms up front so the
        # hot path's observe_exemplar() finds them already constructed
        sm.ttft_seconds()
        sm.inter_token_seconds()
        sm.queue_wait_seconds()
        sm.prefill_seconds()
        self.warm()
        self._updatePageGauges()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"cbatch-{self.name}")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        err = RuntimeError(f"continuous batcher {self.name!r} shut down")
        with self._cv:
            if not self._running:
                return
            self._running = False
            drained = list(self._queue)
            self._queue.clear()
            self._queuedRows = 0
            self._queuedPages = 0
            self._cv.notify_all()
        # registry/metric locks are only ever taken AFTER _cv is released
        # (one scheduler -> registry lock order on every path)
        for seq in drained:
            self._finishSeq(seq, err)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # the loop has exited: slot state is safe to touch from here
        for slot, seq in enumerate(self._slotSeq):
            if seq is not None:
                self._retireSlot(slot, error=err)
        serving_metrics().queue_depth().set(0, model=self.name)

    def busy(self) -> bool:
        return any(s is not None for s in self._slotSeq)

    def queuedRows(self) -> int:
        with self._cv:
            return self._queuedRows

    def occupancy(self) -> Optional[float]:
        """Mean active-slots fraction over every decode step so far."""
        return self._busySteps / self._steps if self._steps else None

    # -- request path ---------------------------------------------------
    def _makeSeqs(self, payload) -> Tuple[List[_Seq], _Pending]:
        """Validate and split one request into per-row sequences.  Every
        condition that could wedge or poison the shared decode batch is
        rejected HERE (HTTP 400), never mid-flight: prompts above the
        top bucket, quotas past the positional capacity, and quotas
        whose pages can never fit the per-sequence KV budget."""
        if not isinstance(payload, dict) or "tokens" not in payload:
            raise ValueError('generative request needs {"tokens": [...]}')
        toks = np.asarray(payload["tokens"], np.int32)
        if toks.ndim == 1:
            toks = toks[None, :]
        if toks.ndim != 2 or toks.shape[0] < 1 or toks.shape[1] < 1:
            raise ValueError(
                f"tokens must be (t,) or (b, t) with b >= 1 and t >= 1; "
                f"got shape {toks.shape}")
        vocab = self.lm.config.vocabSize
        if toks.min() < 0 or toks.max() >= vocab:
            raise ValueError(f"token ids must be in [0, {vocab})")
        n = int(payload.get("maxNewTokens", 16))
        if n < 1:
            raise ValueError("maxNewTokens must be >= 1")
        Tp = self.ladder.seqBucket(toks.shape[1])    # 400 above top bucket
        cap = self.lm.config.maxLen
        if self.draft is not None:
            # the draft ingests the same positions — the SMALLER cache
            # bounds what is admissible (reject here, not on the loop
            # thread inside draft.prefillRaw)
            cap = min(cap, self.draft.config.maxLen)
        if Tp + n > cap:
            raise ValueError(
                f"prompt bucket {Tp} + maxNewTokens {n} exceeds the "
                f"positional capacity {cap}"
                + (" (bounded by the draft model)" if self.draft is not None
                   and self.draft.config.maxLen < self.lm.config.maxLen
                   else ""))
        pages = self.pool.pagesFor(Tp + n + self.draftK)
        if pages > self.pool.maxPagesPerSeq:
            raise ValueError(
                f"prompt bucket {Tp} + maxNewTokens {n} can never fit "
                f"the KV page budget ({pages} pages > "
                f"{self.pool.maxPagesPerSeq} per sequence)")
        deadline = None
        dl = payload.get("deadlineSeconds")
        if dl is not None:
            dl = float(dl)
            if not dl >= 0.0:           # also rejects NaN
                raise ValueError("deadlineSeconds must be >= 0")
            deadline = time.monotonic() + dl
        # adopt the ingress-thread's ambient trace context (the HTTP
        # handler parsed/minted it and enqueues synchronously on this
        # same thread); a direct caller without one gets a fresh trace
        ctx = current_context()
        if ctx is None:
            ctx = RequestContext.new(deadline=deadline)
        parent = _Pending(toks.shape[0], n, deadline=deadline, ctx=ctx)
        seqs = [_Seq(toks[i:i + 1], Tp, n, pages, parent, i,
                     deadline=deadline)
                for i in range(toks.shape[0])]
        return seqs, parent

    def _admitGate(self, rows: int, pages: int,
                   singleStep: bool = False,
                   deadline: Optional[float] = None,
                   ctx: Optional[RequestContext] = None) -> None:
        sm = serving_metrics()
        tid = ctx.traceId if ctx is not None else None
        if deadline is not None and time.monotonic() >= deadline:
            # end-to-end deadline already spent (queueing upstream, a
            # slow hop): shed NOW rather than burn a decode slot on a
            # response nobody is waiting for (tail-at-scale discipline)
            sm.deadline_sheds().inc(model=self.name, stage="admission")
            sm.requests().inc(model=self.name, outcome="deadline")
            timeline_store().note(tid, "serving.shed", replica=self.name,
                                  stage="admission")
            raise DeadlineExceeded(
                "end-to-end deadline expired before admission")
        queued = self.queuedRows()
        sm.queue_depth().set(queued, model=self.name)
        fired = self.admission.check(queued)
        retryAfter = self.admission.retryAfter
        if fired is None:
            # page-headroom shed is about WEDGE risk, not backlog: a
            # queued sequence holds no pages, so only a request that
            # cannot fit the CURRENT free list sheds (backlog depth is
            # the queue-depth rule's job).  Single-step retrieval
            # sequences (quota == 1) emit at admission and retire before
            # any decode step — they never hold pages, so the deficit
            # shed does not apply to them.
            kv = self.admission.checkKv(self.pool.freePages(), pages,
                                        self._retireRate(),
                                        holdsPages=not singleStep)
            if kv is not None:
                fired, retryAfter = kv[:2], kv[2]
        if fired is not None:
            rule, detail = fired
            sm.shed().inc(model=self.name, rule=rule)
            sm.requests().inc(model=self.name, outcome="shed")
            timeline_store().note(tid, "serving.shed", replica=self.name,
                                  stage="admission", rule=rule)
            raise ServiceOverloaded(detail, retryAfter)

    def _enqueue(self, seqs: Sequence[_Seq], front: bool = False) -> None:
        now = time.perf_counter()
        with self._cv:
            if not self._running:
                raise RuntimeError(
                    f"continuous batcher {self.name!r} is not running")
            if front:
                # failed-over sequences adopt the survivor's FIFO head:
                # they already waited their turn on the dead replica
                for s in reversed(list(seqs)):
                    self._queue.appendleft(s)
            else:
                for s in seqs:
                    self._queue.append(s)
            for s in seqs:
                s.enqT = now        # queue wait restarts on every hop
            self._queuedRows += len(seqs)
            self._queuedPages += sum(s.pages for s in seqs)
            depth = self._queuedRows
            self._cv.notify()
        serving_metrics().queue_depth().set(depth, model=self.name)
        ts = timeline_store()
        for s in seqs:
            ts.note(s.ctx.traceId if s.ctx is not None else None,
                    "serving.enqueue", replica=self.name, row=s.row,
                    front=front, restarts=s.restarts)

    def submit(self, payload, timeout: Optional[float] = None):
        """Validate, admit, enqueue, block until every row finished.
        Returns (b, maxNewTokens) int32 (rows that hit ``eosToken``
        early are padded with it).  Raises ``ValueError`` (HTTP 400) for
        malformed payloads, :class:`ServiceOverloaded` (429) when
        admission sheds."""
        seqs, parent = self._makeSeqs(payload)
        self._admitGate(len(seqs), sum(s.pages for s in seqs),
                        singleStep=(parent.quota == 1),
                        deadline=parent.deadline, ctx=parent.ctx)
        self._enqueue(seqs)
        if not parent.event.wait(timeout):
            # reap still-QUEUED rows now — left behind they would keep
            # inflating _queuedRows (phantom backlog shedding live
            # traffic) until each crawled to the FIFO head; rows already
            # in a slot retire at the loop's next boundary
            depth = None
            with self._cv:
                for s in seqs:
                    s.cancelled = True
                    if s in self._queue:
                        self._queue.remove(s)
                        self._queuedRows -= 1
                        self._queuedPages -= s.pages
                depth = self._queuedRows
                self._cv.notify()
            serving_metrics().queue_depth().set(depth, model=self.name)
            raise TimeoutError(
                f"continuous-batching request timed out after {timeout}s")
        if parent.error is not None:
            raise parent.error
        pad = self.eosToken if self.eosToken is not None else 0
        out = np.full((parent.rows, parent.quota), pad, np.int32)
        for s in seqs:
            row = np.asarray(s.emitted[:parent.quota], np.int32)
            out[s.row, :len(row)] = row
        return out

    def submitStream(self, payload):
        """Single-sequence streaming submit: validates + enqueues NOW
        (so 400/429 surface before any token), returns a generator
        yielding each token as its decode step completes.  Closing the
        generator early cancels the sequence at the next step
        boundary."""
        seqs, parent = self._makeSeqs(payload)
        if len(seqs) != 1:
            raise ValueError("streaming serves a single sequence per "
                             "request")
        seq = seqs[0]
        seq.streamQ = _stdqueue.Queue()
        self._admitGate(1, seq.pages, singleStep=(seq.quota == 1),
                        deadline=parent.deadline, ctx=parent.ctx)
        heartbeat = payload.get("keepAliveSeconds")
        if heartbeat is not None:
            heartbeat = float(heartbeat)
            if not heartbeat > 0.0:
                raise ValueError("keepAliveSeconds must be > 0")
        self._enqueue(seqs)

        def gen():
            from deeplearning4j_tpu_torch.remote.server import KEEPALIVE
            try:
                while True:
                    try:
                        item = seq.streamQ.get(timeout=heartbeat)
                    except _stdqueue.Empty:
                        # decode gap (big batch, failover replay, a slow
                        # replica): yield the sentinel so the transport
                        # writes a comment line — a client that hung up
                        # fails THAT write and cancels the sequence just
                        # like a failed token write would
                        yield KEEPALIVE
                        continue
                    if item is None:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield int(item)
            finally:
                if not seq.parent.event.is_set():
                    seq.cancelled = True
        return gen()

    def _retireRate(self) -> float:
        """Mean page-retire rate (pages/sec) over the recent retire log
        — the denominator of the KV-headroom Retry-After."""
        log = list(self._retireLog)
        if len(log) < 2:
            return 0.0
        dt = log[-1][0] - log[0][0]
        if dt <= 0:
            return 0.0
        return sum(p for _, p in log[1:]) / dt

    # -- scheduler loop -------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._running and self._queuedRows == 0 and \
                        not any(s is not None for s in self._slotSeq):
                    self._cv.wait(0.1)
                if not self._running:
                    return
            try:
                if _inj.replica_dead(self.name):
                    # a crashed replica's loop idles instead of serving:
                    # the health probe (not this thread) is what removes
                    # it from routing
                    time.sleep(0.02)
                    continue
                if _inj.check_replica_crash(self.name):
                    raise _inj.InjectedReplicaCrash(self.name)
                if not self._warmed:
                    # a prior failure rebuilt the pools: re-warm before
                    # serving (fresh fns against the fresh buffers)
                    self.warm()
                self._admit()
                if any(s is not None for s in self._slotSeq):
                    self._stepOnce()
            except Exception as e:
                # the scheduler thread must survive ANY dispatch failure
                # (device OOM, a launch error): fail the affected work, not
                # every future request (cf. BucketedExecutor._loop)
                self._failBatch(e)

    def _failBatch(self, error: BaseException) -> None:
        """Last-resort recovery for a failed shared step: hand every
        in-flight sequence to the replica set's failover handler when
        one is wired (reset for a from-prompt replay on a survivor),
        else error it; then rebuild pools and step fns — a step that
        raised may have written part of its K/V into the pools, so the old
        buffers cannot be trusted."""
        handler = self.onSequenceFailure
        handed: List[_Seq] = []
        for slot, seq in enumerate(self._slotSeq):
            if seq is None:
                continue
            if handler is not None and not seq.cancelled:
                self.pool.release(slot)
                if self.draftPool is not None:
                    self.draftPool.release(slot)
                self._slotSeq[slot] = None
                self._pos[slot] = self._start[slot] = self._tok[slot] = 0
                if slot in self._admitOrder:
                    self._admitOrder.remove(slot)
                self._resetForReplay(seq)
                handed.append(seq)
            else:
                self._retireSlot(slot, error=error)
        self._buildPools()
        self._invalidateFns()
        self._updatePageGauges()
        if handed:
            ts = timeline_store()
            for seq in handed:
                ts.note(seq.ctx.traceId if seq.ctx is not None else None,
                        "serving.evacuate", replica=self.name,
                        reason=f"{type(error).__name__}: {error}")
            handler(self, handed, error)

    def _admit(self) -> None:
        """Fill free slots from the queue head — strict FIFO, so a large
        request defers later arrivals instead of being starved by them;
        admission stops when the head's prefill pages don't fit yet."""
        while True:
            free = next((i for i, s in enumerate(self._slotSeq)
                         if s is None), None)
            seq = None
            with self._cv:
                if not self._queue:
                    return
                head = self._queue[0]
                expired = head.deadline is not None and \
                    time.monotonic() >= head.deadline
                if not head.cancelled and not expired:
                    if free is None:
                        return
                    want = self.pool.pagesFor(head.bucket)
                    if self.pool.freePages() < want or (
                            self.draftPool is not None and
                            self.draftPool.freePages() < want):
                        return
                self._queue.popleft()
                self._queuedRows -= 1
                self._queuedPages -= head.pages
                depth = self._queuedRows
                seq = head
            serving_metrics().queue_depth().set(depth, model=self.name)
            if seq.cancelled:
                self._finishSeq(seq, None)
                continue
            if expired:
                # its deadline ran out while it waited in line: it never
                # gets a slot, never holds a page
                serving_metrics().deadline_sheds().inc(model=self.name,
                                                       stage="queued")
                timeline_store().note(
                    seq.ctx.traceId if seq.ctx is not None else None,
                    "serving.shed", replica=self.name, stage="queued")
                self._finishSeq(seq, DeadlineExceeded(
                    "end-to-end deadline expired while queued"))
                continue
            try:
                self._admitSeq(free, seq)
            except Exception as e:
                # an admission that blows up (bad prefill, device error)
                # fails ITS sequence only — free whatever the slot
                # already holds and keep admitting
                self.pool.release(free)
                if self.draftPool is not None:
                    self.draftPool.release(free)
                if self._slotSeq[free] is seq:
                    self._retireSlot(free, error=e)
                else:
                    self._finishSeq(seq, e)

    def _admitSeq(self, slot: int, seq: _Seq) -> None:
        sm = serving_metrics()
        tid = seq.ctx.traceId if seq.ctx is not None else None
        admitT = time.perf_counter()
        queueWait = admitT - seq.enqT if seq.enqT is not None else None
        if queueWait is not None:
            observe_exemplar("dl4j_tpu_serving_queue_wait_seconds",
                             queueWait, trace_id=tid, model=self.name)
        Tp = seq.bucket
        self.pool.ensure(slot, Tp)
        if self.draftPool is not None:
            self.draftPool.ensure(slot, Tp)
        padded = seq.tokens if seq.realLen == Tp else np.concatenate(
            [np.zeros((1, Tp - seq.realLen), np.int32), seq.tokens],
            axis=1)
        nP = Tp // self.pageSize
        # a restart (preemption OR failover onto this replica) goes
        # through the model's restart hook — same computation + bucket as
        # a first admission, but the hook is the seam a survivor with
        # different numerics can override
        prefillT0 = time.perf_counter()
        prefill = getattr(self.lm, "restartFromPrompt",
                          self.lm.prefillRaw) \
            if seq.restarts > 0 else self.lm.prefillRaw
        logits, ks, vs = prefill(padded, lengths=[seq.realLen])
        self._stepFns["write"](self.pool.k, self.pool.v, ks[:, 0],
                               vs[:, 0], self.pool.heldIds(slot)[:nP])
        if self.draft is not None:
            _l, dks, dvs = self.draft.prefillRaw(padded,
                                                 lengths=[seq.realLen])
            self._stepFns["dwrite"](
                self.draftPool.k, self.draftPool.v, dks[:, 0], dvs[:, 0],
                self.draftPool.heldIds(slot)[:nP])
        # the prefill's greedy token seeds the host-side slot state (one
        # copy to the host, as the reference's)
        first = int(torch.argmax(logits[0]))
        if seq.forced and len(seq.emitted) < len(seq.forced):
            # teacher-forced replay: the first token was already
            # computed (and maybe delivered) before the move — force it
            # so the delivered prefix survives any cross-replica
            # numeric drift, and so the KV the step writes next is
            # conditioned on the prefix the client actually saw
            first = int(seq.forced[0])
        prefillDt = time.perf_counter() - prefillT0
        observe_exemplar("dl4j_tpu_serving_prefill_seconds", prefillDt,
                         trace_id=tid, model=self.name)
        tracer().record_complete(
            "serving.prefill", prefillT0, prefillDt,
            args={"replica": self.name, "slot": slot, "bucket": Tp,
                  "trace_id": tid})
        self._slotSeq[slot] = seq
        self._pos[slot] = Tp
        self._start[slot] = Tp - seq.realLen
        self._tok[slot] = first
        self._admitOrder.append(slot)
        sm.sequences_admitted().inc(model=self.name)
        timeline_store().note(
            tid, "serving.admit", replica=self.name, slot=slot, row=seq.row,
            restarts=seq.restarts,
            queue_wait_s=round(queueWait, 6) if queueWait is not None
            else None,
            prefill_s=round(prefillDt, 6))
        self._updatePageGauges()
        if self._emit(seq, first):
            self._retireSlot(slot)

    def _emit(self, seq: _Seq, tok: int) -> bool:
        """Deliver one token; True when the sequence is finished.  After
        a preemption the regenerated prefix is swallowed
        (``streamSkip``) so a streaming client never sees a token
        twice."""
        seq.emitted.append(tok)
        serving_metrics().decode_tokens().inc(model=self.name)
        # latency decomposition observes FRESH tokens only: a replayed
        # prefix (len(emitted) <= len(forced)) was already delivered, so
        # re-observing it would double-count.  lastTokT deliberately
        # survives the replay — the first fresh post-failover token's
        # inter-token gap then CONTAINS the failover, which is exactly
        # what the client experienced.
        if len(seq.emitted) > len(seq.forced):
            now = time.perf_counter()
            tid = seq.ctx.traceId if seq.ctx is not None else None
            parent = seq.parent
            if parent.firstTokenAt is None:
                with parent.lock:
                    isFirst = parent.firstTokenAt is None
                    if isFirst:
                        parent.firstTokenAt = now
                if isFirst:
                    observe_exemplar("dl4j_tpu_serving_ttft_seconds",
                                     now - parent.t0, trace_id=tid,
                                     model=self.name)
                    timeline_store().note(
                        tid, "serving.first_token", replica=self.name,
                        row=seq.row, ttft_s=round(now - parent.t0, 6))
            if seq.lastTokT is not None:
                observe_exemplar("dl4j_tpu_serving_inter_token_seconds",
                                 now - seq.lastTokT, trace_id=tid,
                                 model=self.name)
            seq.lastTokT = now
        if seq.streamQ is not None:
            if seq.streamSkip > 0:
                seq.streamSkip -= 1
            else:
                seq.streamQ.put(tok)
                seq.streamed += 1
        if len(seq.emitted) >= seq.quota:
            return True
        return self.eosToken is not None and tok == self.eosToken

    def _stepOnce(self) -> None:
        sm = serving_metrics()
        delay = _inj.replica_slowdown(self.name)
        if delay:
            time.sleep(delay)           # injected brownout (SlowReplica)
        now = time.monotonic()
        for s, seq in enumerate(self._slotSeq):
            # deadline sweep BETWEEN steps: an expired sequence's pages
            # go back to the free list before the next dispatch
            if seq is not None and seq.deadline is not None and \
                    now >= seq.deadline:
                sm.deadline_sheds().inc(model=self.name, stage="decode")
                self._retireSlot(s, error=DeadlineExceeded(
                    "end-to-end deadline expired mid-decode"))
        stepT0 = time.perf_counter()
        tq = self.draftK + 1 if self.draft is not None else 1
        # page growth in ADMISSION-AGE order: a slot may only preempt
        # YOUNGER slots, and when none are left it DEFERS one step
        # instead — the oldest sequence therefore always progresses and
        # finishes, so a pool squeeze degrades to serial service rather
        # than two big sequences preempting each other forever
        deferred = set()
        for s in list(self._admitOrder):
            if self._slotSeq[s] is None:
                continue
            need = int(self._pos[s]) + tq
            while not (self.pool.ensure(s, need) and
                       (self.draftPool is None or
                        self.draftPool.ensure(s, need))):
                order = list(self._admitOrder)
                younger = order[order.index(s) + 1:]
                victim = next((v for v in reversed(younger)
                               if self._slotSeq[v] is not None), None)
                if victim is None:
                    deferred.add(s)
                    break
                self._preempt(victim)
        active = [i for i, s in enumerate(self._slotSeq)
                  if s is not None and i not in deferred]
        if not active:
            return
        if deferred:
            # mask deferred rows onto the scratch page with zeroed
            # state: the fixed-shape step still computes them, but their
            # writes land in scratch and their REAL page tables / slot
            # state stay untouched for the next round
            ptH = self.pool.pageTable.copy()
            posH = self._pos.copy()
            startH = self._start.copy()
            tokH = self._tok.copy()
            for s in deferred:
                ptH[s, :] = 0
                posH[s] = startH[s] = tokH[s] = 0
        else:
            ptH, posH, startH, tokH = (self.pool.pageTable, self._pos,
                                       self._start, self._tok)
        step = self._stepFns["step"]
        if self.draft is not None:
            dptH = self.draftPool.pageTable
            if deferred:
                dptH = dptH.copy()
                for s in deferred:
                    dptH[s, :] = 0
            props, _, _ = self._stepFns["propose"](
                self.draftPool.k, self.draftPool.v, tokH, dptH, posH,
                startH)
            # proposals route through the host to form the verify batch
            # (the accept rule is host-side), as in the reference
            propsH = props.cpu().numpy()
            verifyIn = np.concatenate([tokH[:, None], propsH], axis=1)
            greedy, _, _ = step(self.pool.k, self.pool.v, verifyIn, ptH,
                                posH, startH)
        else:
            propsH = None
            greedy, _, _ = step(self.pool.k, self.pool.v, tokH[:, None],
                                ptH, posH, startH)
        # the step's tokens ARE the response payload: its one copy back
        g = greedy.cpu().numpy()
        for s in active:
            seq = self._slotSeq[s]
            if seq is None:
                continue
            if seq.cancelled:
                self._retireSlot(s)
                continue
            remForced = len(seq.forced) - len(seq.emitted)
            if propsH is not None and remForced <= 0:
                a = 0
                while a < self.draftK and propsH[s, a] == g[s, a]:
                    a += 1
                newToks = g[s, :a + 1]
                sm.draft_proposed().inc(self.draftK, model=self.name)
                sm.draft_accepted().inc(a, model=self.name)
            else:
                newToks = g[s, :1]
            if remForced > 0:
                # teacher-forced replay: override the computed token
                # with the one the sequence already produced before the
                # move.  Capped to ONE token per step even in
                # speculative mode — the unaccepted proposals' KV
                # writes get overwritten by the existing partial-accept
                # semantics, exactly as on a short accept.
                newToks = np.asarray(
                    [int(seq.forced[len(seq.emitted)])], np.int32)
            done = False
            for t in newToks:
                done = self._emit(seq, int(t))
                if done:
                    break
            self._pos[s] += len(newToks)
            self._tok[s] = int(newToks[-1])
            timeline_store().note(
                seq.ctx.traceId if seq.ctx is not None else None,
                "serving.decode.step", replica=self.name, slot=s,
                tokens=len(seq.emitted))
            if done:
                self._retireSlot(s)
        self._steps += 1
        self._busySteps += len(active) / self.maxSlots
        tracer().record_complete(
            "serving.decode.step", stepT0, time.perf_counter() - stepT0,
            args={"replica": self.name, "active": len(active)})
        sm.decode_steps().inc(model=self.name)
        sm.slot_occupancy().set(len(active) / self.maxSlots,
                                model=self.name)

    def _preempt(self, slot: int) -> None:
        """Evict the youngest slot to free pages: release everything it
        holds and requeue it at the FRONT.  Greedy decode is
        deterministic, so the restart regenerates the identical prefix;
        ``streamSkip`` swallows the re-emissions."""
        seq = self._slotSeq[slot]
        freed = self.pool.release(slot)
        if self.draftPool is not None:
            freed += self.draftPool.release(slot)
        self._slotSeq[slot] = None
        self._pos[slot] = self._start[slot] = self._tok[slot] = 0
        self._admitOrder.remove(slot)
        self._resetForReplay(seq)
        with self._cv:
            self._queue.appendleft(seq)
            self._queuedRows += 1
            self._queuedPages += seq.pages
        sm = serving_metrics()
        sm.preemptions().inc(model=self.name)
        timeline_store().note(
            seq.ctx.traceId if seq.ctx is not None else None,
            "serving.preempt", replica=self.name, slot=slot,
            tokens_kept=len(seq.forced))
        self._updatePageGauges()

    @staticmethod
    def _resetForReplay(seq: _Seq) -> None:
        """Rewind a sequence to restart-from-prompt state (preemption or
        failover): record the computed prefix for teacher-forcing, arm
        ``streamSkip`` so the re-emission is swallowed, clear the
        emitted list.  Exactly-once delivery follows: every token a
        client saw is in ``forced`` and will be re-emitted (skipped) in
        the same order; every token it hasn't seen streams once."""
        if len(seq.emitted) > len(seq.forced):
            seq.forced = list(seq.emitted)
        seq.restarts += 1
        seq.streamSkip = seq.streamed
        seq.emitted = []

    def probe(self) -> bool:
        """Replica liveness check for the health prober: the injected
        fault registries (a chaos schedule's crash/brownout), the loop
        thread's liveness, and one tiny REAL device op (a one-element add
        on the replica's device, then a synchronise: its round trip is
        the health signal, bounded by the prober's ``probeTimeout`` on its
        own thread).  Decode-path health is covered separately: a crashed
        step raises into ``_failBatch`` and the failover handler, it
        doesn't wait for a probe."""
        if _inj.replica_dead(self.name):
            return False
        if _inj.check_replica_crash(self.name):
            # an armed crash with no traffic to trip it: an IDLE crashed
            # replica must still go unhealthy (the loop's check only
            # runs when there is work)
            return False
        delay = _inj.replica_slowdown(self.name)
        if delay:
            time.sleep(delay)           # a browned-out replica probes slow
        if self._thread is not None and not self._thread.is_alive():
            return False
        out = torch.ones((1,), dtype=torch.int32, device=self._device) + 1
        self._sync()
        return int(out[0]) == 2

    def evacuate(self) -> List[_Seq]:
        """Pull every queued AND in-flight sequence off this replica for
        failover, stopping the loop.  Returns the sequences reset for a
        from-prompt replay (cancelled ones are finished here instead).
        In-flight slots are stolen only after the loop thread actually
        JOINED — a wedged thread mid-``_stepOnce`` still owns its slot
        state, so a reaper thread waits it out and errors the leftovers
        (exactly-once beats availability: a maybe-double-delivered
        sequence is worse than a failed one)."""
        with self._cv:
            self._running = False
            queued = list(self._queue)
            self._queue.clear()
            self._queuedRows = 0
            self._queuedPages = 0
            self._cv.notify_all()
        inflight: List[_Seq] = []
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            joined = not self._thread.is_alive()
        if joined:
            self._thread = None
            for slot in list(self._admitOrder):
                seq = self._slotSeq[slot]
                if seq is None:
                    continue
                self.pool.release(slot)
                if self.draftPool is not None:
                    self.draftPool.release(slot)
                self._slotSeq[slot] = None
                self._pos[slot] = self._start[slot] = 0
                self._tok[slot] = 0
                inflight.append(seq)
            self._admitOrder.clear()
            self._updatePageGauges()
        else:
            # wedged mid-step: its slots cannot be failed over safely
            # (the step may still emit).  A reaper outlives the wedge
            # and errors whatever is left.
            wedged = self._thread

            def reap():
                wedged.join()
                for slot, seq in enumerate(self._slotSeq):
                    if seq is not None:
                        self._retireSlot(slot, error=RuntimeError(
                            f"replica {self.name!r} evacuated while "
                            f"wedged mid-step"))
            threading.Thread(target=reap, daemon=True,
                             name=f"cbatch-wedge-reap-{self.name}"
                             ).start()
        out: List[_Seq] = []
        ts = timeline_store()
        for seq in inflight + queued:
            if seq.cancelled:
                self._finishSeq(seq, None)
                continue
            self._resetForReplay(seq)
            ts.note(seq.ctx.traceId if seq.ctx is not None else None,
                    "serving.evacuate", replica=self.name,
                    reason="replica evacuated")
            out.append(seq)
        serving_metrics().queue_depth().set(0, model=self.name)
        return out

    def _retireSlot(self, slot: int, error: Optional[BaseException] = None
                    ) -> None:
        seq = self._slotSeq[slot]
        freed = self.pool.release(slot)
        if self.draftPool is not None:
            freed += self.draftPool.release(slot)
        self._slotSeq[slot] = None
        self._pos[slot] = self._start[slot] = self._tok[slot] = 0
        if slot in self._admitOrder:
            self._admitOrder.remove(slot)
        self._retireLog.append((time.monotonic(), freed))
        sm = serving_metrics()
        sm.sequences_retired().inc(model=self.name)
        self._updatePageGauges()
        self._finishSeq(seq, error)

    def _finishSeq(self, seq: _Seq, error: Optional[BaseException]) -> None:
        _finish_seq(seq, error, self.name)

    def _updatePageGauges(self) -> None:
        sm = serving_metrics()
        sm.kv_pages_in_use().set(self.pool.usedPages(), model=self.name,
                                 pool="target")
        sm.kv_pages_free().set(self.pool.freePages(), model=self.name,
                               pool="target")
        if self.draftPool is not None:
            sm.kv_pages_in_use().set(self.draftPool.usedPages(),
                                     model=self.name, pool="draft")
            sm.kv_pages_free().set(self.draftPool.freePages(),
                                   model=self.name, pool="draft")


class _ReplicaQueueDepthRule(ThresholdRule):
    """``serving_queue_depth`` rule evaluating the replica set's LIVE
    queued rows (summed across replicas) and publishing them to the
    set-level gauge.  The gauge alone is written when a submit
    COMPLETES — during a cold burst every submit is still blocked (and
    streaming submits never write it), so a gauge-only rule would read
    0 at exactly the moment the autoscaler is needed."""

    def __init__(self, rs: "ReplicaSet", threshold: float):
        super().__init__("serving_queue_depth_high",
                         "dl4j_tpu_serving_queue_depth", ">=", threshold,
                         model=rs.name)
        self._rs = rs

    def evaluate(self, registry, now):
        depth = float(self._rs.queuedRows())
        serving_metrics().queue_depth().set(depth, model=self._rs.name)
        if depth >= self.threshold:
            return (f"dl4j_tpu_serving_queue_depth{{model="
                    f"{self._rs.name!r}}} = {depth:g} >= "
                    f"{self.threshold:g} (live replica-set backlog)")
        return None


class ReplicaSet:
    """Fan one registry route out over N executor replicas.

    ``factory(idx)`` builds replica ``idx`` (a
    :class:`ContinuousBatcher` or ``BucketedExecutor`` whose weights the
    factory has already placed — ``device=`` / :func:`place_replica` for
    one-device copies; the reference's TP-sharded replicas wait for
    ROADMAP A10b).  Requests route to the least-loaded live replica.
    ``scaleUp``/``scaleDown`` move the set by one replica;
    :meth:`armAutoscale` wires them to the ``serving_queue_depth``
    alert's firing/resolved edges through
    ``HealthMonitor.registerAction`` (counted in
    ``dl4j_tpu_health_actions_total``)."""

    def __init__(self, factory, name: str = "default", replicas: int = 1,
                 minReplicas: int = 1, maxReplicas: int = 8,
                 drainTimeout: float = 30.0, probeInterval: float = 0.5,
                 probeTimeout: float = 2.0, probeFailThreshold: int = 2,
                 submitRetries: int = 2, retryBackoff: float = 0.05,
                 retryMaxBackoff: float = 1.0, retryJitter: float = 0.5,
                 retryAfter: float = 1.0, seed: Optional[int] = None):
        self._factory = factory
        self.name = str(name)
        self.minReplicas = max(1, int(minReplicas))
        self.maxReplicas = max(self.minReplicas, int(maxReplicas))
        self._initial = max(self.minReplicas, int(replicas))
        self.drainTimeout = float(drainTimeout)
        # health probing (0 disables): a replica failing
        # probeFailThreshold CONSECUTIVE probes — each bounded by
        # probeTimeout on its own thread, so a wedged probe can't wedge
        # the prober — leaves routing; one healthy pass resets the run
        self.probeInterval = float(probeInterval)
        self.probeTimeout = float(probeTimeout)
        self.probeFailThreshold = max(1, int(probeFailThreshold))
        # submit retry-against-another-replica policy: exponential
        # backoff with seeded jitter, bounded by the request's
        # remaining deadline budget
        self.submitRetries = max(0, int(submitRetries))
        self.retryBackoff = float(retryBackoff)
        self.retryMaxBackoff = float(retryMaxBackoff)
        self.retryJitter = float(retryJitter)
        self.retryAfter = float(retryAfter)
        self._rng = random.Random(seed)
        self._replicas: List = []
        self._nextIdx = 0
        self._pendingAdds = 0
        self._lock = threading.Lock()
        self._running = False
        self._reapers: List[threading.Thread] = []
        self._probes: List[threading.Thread] = []

    def start(self) -> "ReplicaSet":
        with self._lock:
            if self._running:
                return self
            self._running = True
        while self.replicaCount() < self._initial:
            if self._addReplica() is None:
                break
        return self

    def _addReplica(self, force: bool = False):
        """Build + start one replica.  The slow factory/warm work runs
        OUTSIDE the lock; admission into the routing set re-checks
        ``_running``/``maxReplicas`` under it, so a racing shutdown (or
        a second concurrent scaleUp) can never leak a live replica or
        overshoot the cap — a replica that loses the re-check is shut
        down, not stranded.  ``force`` lifts the cap check for
        :meth:`swap`, which adds the green replica BEFORE removing the
        blue one (momentarily maxReplicas + 1)."""
        with self._lock:
            if not self._running or (
                    not force and
                    len(self._replicas) + self._pendingAdds >=
                    self.maxReplicas):
                return None
            self._pendingAdds += 1
            idx = self._nextIdx
            self._nextIdx += 1
        ex = None
        started = False
        try:
            ex = self._factory(idx)
            if getattr(ex, "name", None) in (None, "default"):
                ex.name = f"{self.name}/{idx}"
            # ex.start() warms every step BEFORE the replica can be
            # routed to — a swapped-in replica never serves cold
            ex.start()
            started = True
        finally:
            with self._lock:
                self._pendingAdds -= 1
                admitted = started and self._running and (
                    force or len(self._replicas) < self.maxReplicas)
                if admitted:
                    self._replicas.append(ex)
                    n = len(self._replicas)
        if not admitted:
            if ex is not None:
                ex.shutdown()
            return None
        if hasattr(ex, "onSequenceFailure"):
            # the in-flight failover seam: a failed shared step hands
            # its live sequences here instead of erroring them
            ex.onSequenceFailure = self._onBatchFailure
        sm = serving_metrics()
        sm.replicas().set(n, model=self.name)
        sm.replica_health().set(1, model=self.name,
                                replica=getattr(ex, "name", str(idx)))
        self._startProbe(ex)
        return ex

    # -- health probing -------------------------------------------------
    def _startProbe(self, ex) -> None:
        if self.probeInterval <= 0 or not hasattr(ex, "probe"):
            return
        th = threading.Thread(
            target=self._probeLoop, args=(ex,), daemon=True,
            name=f"replica-probe-{getattr(ex, 'name', '?')}")
        th.start()
        with self._lock:
            self._probes.append(th)

    def _probeOnce(self, ex) -> bool:
        """One probe attempt, bounded by ``probeTimeout`` on its OWN
        short-lived thread — a wedged device dispatch hangs that thread,
        not the prober (the DeviceHealthProbe discipline)."""
        result: List[bool] = []

        def attempt():
            try:
                result.append(bool(ex.probe()))
            except Exception:
                result.append(False)
        t = threading.Thread(target=attempt, daemon=True,
                             name=f"probe-once-{getattr(ex, 'name', '?')}")
        t.start()
        t.join(self.probeTimeout)
        return bool(result) and result[0]

    def _probeLoop(self, ex) -> None:
        fails = 0
        sm = serving_metrics()
        rname = getattr(ex, "name", "?")
        while True:
            with self._lock:
                if not self._running or ex not in self._replicas:
                    return
            if self._probeOnce(ex):
                fails = 0
                sm.replica_health().set(1, model=self.name,
                                        replica=rname)
            else:
                fails += 1
                if fails >= self.probeFailThreshold:
                    sm.replica_health().set(0, model=self.name,
                                            replica=rname)
                    self._retireReplica(
                        ex, reason=f"{fails} consecutive probe failures")
                    return
            time.sleep(self.probeInterval)

    def _retireReplica(self, ex, reason: str = "") -> None:
        """Remove an UNHEALTHY replica from routing and fail its work
        over to survivors.  Health retirement ignores ``minReplicas`` —
        keeping a dead replica in the route to satisfy a floor just
        converts every Nth request into an error."""
        with self._lock:
            if ex not in self._replicas:
                return
            self._replicas.remove(ex)
            n = len(self._replicas)
        sm = serving_metrics()
        sm.replicas().set(n, model=self.name)
        sm.replica_health().set(0, model=self.name,
                                replica=getattr(ex, "name", "?"))
        if hasattr(ex, "evacuate"):
            seqs = ex.evacuate()
            if seqs:
                self._failover(seqs, note=reason)
        # the dead replica's shutdown can block (a wedged loop thread):
        # reap it off-path so retirement itself never wedges
        th = threading.Thread(target=ex.shutdown, daemon=True,
                              name=f"replica-reaper-{self.name}")
        th.start()
        with self._lock:
            self._reapers.append(th)

    def _failover(self, seqs: Sequence[_Seq], note: str = "",
                  exclude=None) -> None:
        """Re-home evacuated sequences on survivors: each lands at a
        survivor's FIFO head (it already waited its turn) and replays
        from the prompt, ``streamSkip``/``forced`` making the move
        invisible to the client.  A sequence whose deadline already
        expired — or with no survivor to take it — finishes with the
        error instead."""
        sm = serving_metrics()
        ts = timeline_store()
        for seq in seqs:
            tid = seq.ctx.traceId if seq.ctx is not None else None
            if seq.deadline is not None and \
                    time.monotonic() >= seq.deadline:
                sm.deadline_sheds().inc(model=self.name, stage="failover")
                ts.note(tid, "serving.shed", replica=self.name,
                        stage="failover")
                _finish_seq(seq, DeadlineExceeded(
                    "end-to-end deadline expired during failover"),
                    self.name)
                continue
            with self._lock:
                live = list(self._replicas)
            cands = [e for e in live
                     if hasattr(e, "_enqueue") and e is not exclude] or \
                    [e for e in live if hasattr(e, "_enqueue")]
            target = min(cands, key=lambda e: e.queuedRows()) \
                if cands else None
            if target is None:
                _finish_seq(seq, NoHealthyReplicas(
                    f"no survivor to adopt sequence after failover"
                    f"{' (' + note + ')' if note else ''}",
                    retryAfter=self.retryAfter), self.name)
                continue
            try:
                target._enqueue([seq], front=True)
                sm.failovers().inc(model=self.name)
                ts.note(tid, "serving.failover",
                        to=getattr(target, "name", "?"),
                        note=note or None)
            except Exception as e:
                _finish_seq(seq, e, self.name)

    def _onBatchFailure(self, source, seqs, error) -> None:
        self._failover(seqs,
                       note=f"{type(error).__name__}: {error}",
                       exclude=source)

    def replicaCount(self) -> int:
        with self._lock:
            return len(self._replicas)

    def scaleUp(self) -> Optional[str]:
        """One replica up (the queue-depth alert's firing-edge
        remediation); None when already at ``maxReplicas`` or shut
        down."""
        if self._addReplica() is None:
            return None
        return f"scaled {self.name} up to {self.replicaCount()} replicas"

    def scaleDown(self) -> Optional[str]:
        """One replica down (the resolved-edge remediation): the replica
        leaves the routing set immediately and a reaper thread drains
        its backlog before shutdown; None at ``minReplicas``."""
        with self._lock:
            if not self._running or len(self._replicas) <= self.minReplicas:
                return None
            ex = self._replicas.pop()       # stops routing to it NOW
            n = len(self._replicas)
        sm = serving_metrics()
        sm.replicas().set(n, model=self.name)
        sm.replica_health().set(0, model=self.name,
                                replica=getattr(ex, "name", "?"))
        th = threading.Thread(target=self._drainStop, args=(ex,),
                              daemon=True,
                              name=f"replica-reaper-{self.name}")
        th.start()
        with self._lock:
            self._reapers.append(th)
        return f"scaled {self.name} down to {n} replicas"

    def _drainStop(self, ex) -> None:
        """Graceful drain: the replica is already out of routing, so its
        backlog only shrinks — let every in-flight sequence finish,
        bounded by ``drainTimeout``; stragglers past the bound are
        evacuated and failed over to survivors (not dropped)."""
        t0 = time.monotonic()
        deadline = t0 + self.drainTimeout
        busy = getattr(ex, "busy", None)
        while time.monotonic() < deadline and (
                ex.queuedRows() > 0 or (busy is not None and busy())):
            time.sleep(0.05)
        if hasattr(ex, "evacuate") and (
                ex.queuedRows() > 0 or (busy is not None and busy())):
            stragglers = ex.evacuate()
            if stragglers:
                self._failover(stragglers, note="drain timeout",
                               exclude=ex)
        ex.shutdown()
        serving_metrics().drain_seconds().observe(
            time.monotonic() - t0, model=self.name)

    def swap(self, factory=None) -> Optional[str]:
        """Blue/green rollover (ROADMAP item 4's serving primitive):
        for each current replica, build + WARM a replacement from
        ``factory`` (default: the current one), route to it, then drain
        and retire the old replica through the ``scaleDown`` reaper
        path.  In-flight streams on the old replica finish (or fail
        over past ``drainTimeout``); new requests land on the
        replacement, which entered the route fully warmed."""
        if factory is not None:
            self._factory = factory
        with self._lock:
            olds = list(self._replicas)
        swapped = 0
        for old in olds:
            new = self._addReplica(force=True)
            if new is None:
                break
            with self._lock:
                if old not in self._replicas:   # crashed/retired already
                    continue
                self._replicas.remove(old)
                n = len(self._replicas)
            sm = serving_metrics()
            sm.replicas().set(n, model=self.name)
            sm.replica_health().set(0, model=self.name,
                                    replica=getattr(old, "name", "?"))
            th = threading.Thread(target=self._drainStop, args=(old,),
                                  daemon=True,
                                  name=f"replica-reaper-{self.name}")
            th.start()
            with self._lock:
                self._reapers.append(th)
            swapped += 1
        if swapped == 0:
            return None
        return f"swapped {swapped} replica(s) behind {self.name}"

    def _pick(self):
        with self._lock:
            if not self._replicas:
                raise NoHealthyReplicas(
                    f"replica set {self.name!r} has no live replicas",
                    retryAfter=self.retryAfter)
            return min(self._replicas, key=lambda e: e.queuedRows())

    def _retryDelay(self, attempt: int,
                    deadline: Optional[float]) -> float:
        """Bounded exponential backoff with seeded jitter, clipped to
        the request's remaining deadline budget (raises when none is
        left — retrying past the deadline only wastes a survivor's
        slot)."""
        delay = min(self.retryBackoff * (2 ** attempt),
                    self.retryMaxBackoff)
        delay *= 1.0 + self.retryJitter * self._rng.random()
        if deadline is not None and \
                time.monotonic() + delay >= deadline:
            sm = serving_metrics()
            sm.deadline_sheds().inc(model=self.name, stage="retry")
            raise DeadlineExceeded(
                "end-to-end deadline leaves no budget for a retry")
        return delay

    @staticmethod
    def _requestDeadline(payload) -> Optional[float]:
        dl = payload.get("deadlineSeconds") \
            if isinstance(payload, dict) else None
        if dl is None:
            return None
        dl = float(dl)
        if not dl >= 0.0:
            raise ValueError("deadlineSeconds must be >= 0")
        return time.monotonic() + dl

    def submit(self, payload, timeout: Optional[float] = None):
        """Route to the least-loaded replica; a replica-side FAILURE
        (not a client error, not an admission shed, not a deadline)
        retries against another replica with backoff + jitter, honoring
        the remaining deadline budget."""
        deadline = self._requestDeadline(payload)
        attempt = 0
        while True:
            ex = self._pick()
            try:
                out = ex.submit(payload, timeout)
            except (ServiceOverloaded, NoHealthyReplicas,
                    DeadlineExceeded, TimeoutError, ValueError,
                    TypeError):
                raise               # deterministic / client-owned: no retry
            except Exception:
                if attempt >= self.submitRetries:
                    raise
                time.sleep(self._retryDelay(attempt, deadline))
                attempt += 1
                continue
            serving_metrics().queue_depth().set(self.queuedRows(),
                                                model=self.name)
            return out

    def submitStream(self, payload):
        """Streaming route with the same retry policy around CREATION
        (validate + enqueue happen eagerly, before any token, so a
        failed submit here never half-delivered anything)."""
        deadline = self._requestDeadline(payload)
        attempt = 0
        while True:
            ex = self._pick()
            if not hasattr(ex, "submitStream"):
                raise ValueError(
                    f"replica set {self.name!r} does not stream")
            try:
                return ex.submitStream(payload)
            except (ServiceOverloaded, NoHealthyReplicas,
                    DeadlineExceeded, TimeoutError, ValueError,
                    TypeError):
                raise
            except Exception:
                if attempt >= self.submitRetries:
                    raise
                time.sleep(self._retryDelay(attempt, deadline))
                attempt += 1

    def queuedRows(self) -> int:
        with self._lock:
            return sum(e.queuedRows() for e in self._replicas)

    def shutdown(self) -> None:
        with self._lock:
            self._running = False
            reps, self._replicas = self._replicas, []
        for ex in reps:
            ex.shutdown()
        for pth in self._probes:
            pth.join(timeout=max(5.0, self.probeTimeout +
                                 self.probeInterval + 1.0))
        for rth in self._reapers:
            rth.join(timeout=35.0)
        self._probes = []
        self._reapers = []

    def armAutoscale(self, monitor, highQueueRows: int = 64,
                     rule: Optional[ThresholdRule] = None) -> ThresholdRule:
        """Wire the self-healing loop (ROADMAP item 5's serving
        remainder): a ``serving_queue_depth`` rule on ``monitor`` whose
        FIRING edge scales one replica up and whose RESOLVED edge
        scales one back down.  The default rule reads the set's LIVE
        backlog (see :class:`_ReplicaQueueDepthRule`); pass ``rule`` to
        watch something else."""
        rule = rule or _ReplicaQueueDepthRule(self, highQueueRows)
        monitor.rules.append(rule)

        def scale_up(_rule, _detail):
            return self.scaleUp()

        def scale_down(_rule, _detail):
            return self.scaleDown()

        monitor.registerAction(rule.name, scale_up)
        monitor.registerAction(rule.name, scale_down, on="resolved")
        return rule
