"""Request-scoped observability context: W3C trace propagation + the
per-request lifecycle timeline — the port of
``deeplearning4j_tpu/telemetry/context.py`` (pure Python, copied).

The serving tier spans replicas, failover, retries, and speculative
decode, but the rest of the telemetry spine is process-scoped (the
``Tracer`` records per-thread Chrome tracks, ``/metrics`` is point in
time).  This module adds the one signal that follows an *individual
request* through admission → queue → prefill → decode → failover:

- :class:`RequestContext` — trace id / span id / flags / deadline /
  baggage, minted at ``InferenceServer`` ingress or parsed from an
  incoming W3C ``traceparent`` header, and threaded through
  ``ModelRegistry`` → ``ReplicaSet`` → ``ContinuousBatcher``
  ``_Pending``/``_Seq`` so ONE trace id covers the request's whole
  life even across a mid-decode replica crash.
- :func:`current_context` / :func:`request_context` — a
  ``contextvars``-based ambient slot so the HTTP handler thread can
  set the context once and every layer below picks it up without
  plumbing an extra argument through stable APIs.
- :class:`TimelineStore` — bounded in-process map of trace id → ordered
  lifecycle events (enqueued, admitted, prefill, decode steps,
  preempted, evacuated, failover, retired, shed), served on
  ``GET /v1/requests/<traceId>`` and dumped into the ``FlightRecorder``
  ring when a request fails.

Everything here is O(1) per event and lock-scoped to a dict append so
it is safe to call from the decode hot loop.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

__all__ = [
    "RequestContext", "TimelineStore", "current_context",
    "parse_traceparent", "request_context", "set_timeline_store",
    "timeline_store",
]

_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace>[0-9a-f]{32})-"
    r"(?P<span>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$")


class RequestContext:
    """One request's identity: W3C trace id + span id, the absolute
    monotonic deadline (``time.monotonic()`` domain, or ``None``) and a
    small string-valued baggage dict.  Immutable by convention — the
    same object is shared across retries and failover hops precisely so
    the trace id cannot fork mid-request."""

    __slots__ = ("traceId", "spanId", "flags", "deadline", "baggage")

    def __init__(self, traceId: str, spanId: str, flags: int = 1,
                 deadline: Optional[float] = None,
                 baggage: Optional[Dict[str, str]] = None):
        self.traceId = traceId
        self.spanId = spanId
        self.flags = flags
        self.deadline = deadline
        self.baggage = dict(baggage or {})

    @classmethod
    def new(cls, deadline: Optional[float] = None,
            **baggage: str) -> "RequestContext":
        return cls(traceId=os.urandom(16).hex(), spanId=os.urandom(8).hex(),
                   flags=1, deadline=deadline, baggage=baggage)

    def child(self) -> "RequestContext":
        """Same trace, fresh span id — for an outbound hop."""
        return RequestContext(traceId=self.traceId,
                              spanId=os.urandom(8).hex(), flags=self.flags,
                              deadline=self.deadline, baggage=self.baggage)

    def to_traceparent(self) -> str:
        return f"00-{self.traceId}-{self.spanId}-{self.flags:02x}"

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def __repr__(self) -> str:
        return f"RequestContext({self.to_traceparent()})"


def parse_traceparent(header: Optional[str],
                      deadline: Optional[float] = None
                      ) -> Optional[RequestContext]:
    """Parse a W3C ``traceparent`` header.  Returns ``None`` on any
    malformation (callers then mint a fresh context) — a bad header from
    one client must never 500 the request."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None or m.group("trace") == "0" * 32 \
            or m.group("span") == "0" * 16:
        return None
    return RequestContext(traceId=m.group("trace"), spanId=m.group("span"),
                          flags=int(m.group("flags"), 16),
                          deadline=deadline)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_tpu_request_context", default=None)


def current_context() -> Optional[RequestContext]:
    return _CURRENT.get()


@contextlib.contextmanager
def request_context(ctx: Optional[RequestContext]):
    """Ambient-context scope: everything called inside sees ``ctx`` via
    :func:`current_context`.  The HTTP handler wraps dispatch in this so
    ``ContinuousBatcher._makeSeqs`` (same thread, synchronous enqueue)
    captures the context without an API change."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


class TimelineStore:
    """Bounded trace id → lifecycle-event list.

    LRU over traces (``maxTraces``) and capped per trace
    (``maxEvents``, overflow counted in the ``dropped`` field rather
    than silently lost) so a long soak holds O(maxTraces · maxEvents)
    memory no matter how many requests flow through.  ``note`` is a
    dict append under one lock — cheap enough for the decode loop."""

    def __init__(self, maxTraces: int = 512, maxEvents: int = 256):
        self.maxTraces = maxTraces
        self.maxEvents = maxEvents
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()

    def note(self, traceId: Optional[str], event: str, **attrs) -> None:
        if not traceId:
            return
        rec = {"ts": time.time(), "event": event}
        rec.update(attrs)
        with self._lock:
            entry = self._traces.get(traceId)
            if entry is None:
                entry = {"events": [], "dropped": 0}
                self._traces[traceId] = entry
                while len(self._traces) > self.maxTraces:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(traceId)
            if len(entry["events"]) >= self.maxEvents:
                entry["dropped"] += 1
            else:
                entry["events"].append(rec)

    def get(self, traceId: str) -> Optional[dict]:
        with self._lock:
            entry = self._traces.get(traceId)
            if entry is None:
                return None
            return {"trace_id": traceId,
                    "events": list(entry["events"]),
                    "dropped": entry["dropped"]}

    def events(self, traceId: str) -> List[dict]:
        got = self.get(traceId)
        return got["events"] if got else []

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces.keys())

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_TIMELINE = TimelineStore()
_TIMELINE_LOCK = threading.Lock()


def timeline_store() -> TimelineStore:
    return _TIMELINE


def set_timeline_store(store: TimelineStore) -> TimelineStore:
    global _TIMELINE
    with _TIMELINE_LOCK:
        prev, _TIMELINE = _TIMELINE, store
    return prev
