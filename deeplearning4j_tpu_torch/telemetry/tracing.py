"""Span tracing — the port of ``deeplearning4j_tpu/telemetry/tracing.py``.

:class:`Tracer` is the one producer the stack reports through: nested
``span(name, **attrs)`` contexts and :meth:`Tracer.record_complete` record
chrome://tracing "X" events on a per-thread track (the continuous batcher
records ``serving.prefill`` and ``serving.decode.step`` here), and
:meth:`Tracer.write_chrome_trace` writes them to one file (load it at
``chrome://tracing`` or Perfetto), merged with the
:class:`~deeplearning4j_tpu_torch.profiler.OpProfiler` singleton's phase
events, as the reference merges them.

When a device trace is marked active (:func:`set_device_trace_active`, set
around a ``torch.profiler`` capture), each span also enters
``torch.profiler.record_function`` so the host span shows up in the
profiler's timeline beside the CUDA kernels (the reference enters
``jax.profiler.TraceAnnotation``).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Deque, List, Optional

__all__ = ["Tracer", "tracer", "set_tracer", "device_trace_active",
           "set_device_trace_active"]

# flipped by profiler.start_trace/stop_trace (this module owns the flag so
# the two modules don't import-cycle: profiler -> telemetry only)
_device_trace_active = False


def device_trace_active() -> bool:
    return _device_trace_active


def set_device_trace_active(active: bool) -> None:
    global _device_trace_active
    _device_trace_active = bool(active)


class _ThreadTrack(threading.local):
    def __init__(self):
        self.depth = 0


class Tracer:
    """Nested span recorder (bounded ring — long runs can't grow it
    without limit)."""

    def __init__(self, maxEvents: int = 100_000):
        self._events: Deque[dict] = deque(maxlen=int(maxEvents))
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._track = _ThreadTrack()
        self._next_tid = 0
        # spans currently INSIDE their with-block, keyed by a unique id —
        # a crash/SIGTERM dump needs "what was the process in the middle
        # of", which the completed-event ring by definition can't hold
        self._live: dict = {}
        self._next_span_id = 0

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a nested region.  Yields a dict the body may add attrs to;
        everything lands in the Chrome event's ``args``."""
        self._track.depth += 1
        depth = self._track.depth
        start = time.perf_counter()
        live_attrs = dict(attrs)
        with self._lock:
            self._next_span_id += 1
            span_id = self._next_span_id
            self._live[span_id] = {"name": name, "start": start,
                                   "depth": depth, "attrs": live_attrs}
        ann = None
        if _device_trace_active:
            try:
                import torch
                ann = torch.profiler.record_function(name)
                ann.__enter__()
            except Exception:
                ann = None
        try:
            yield live_attrs
        finally:
            if ann is not None:
                try:
                    ann.__exit__(None, None, None)
                except Exception:
                    pass
            self._track.depth -= 1
            with self._lock:
                self._live.pop(span_id, None)
            self.record_complete(name, start, time.perf_counter() - start,
                                 args=dict(live_attrs, depth=depth))

    def record_complete(self, name: str, start: float, duration: float,
                        args: Optional[dict] = None,
                        tid: Optional[int] = None) -> None:
        """Append one complete ("X") event; ``start`` is a perf_counter
        timestamp from THIS process (shares the tracer's epoch)."""
        ev = {"name": name, "ph": "X", "pid": 1,
              "tid": tid if tid is not None else self._tid(),
              "ts": (start - self._t0) * 1e6, "dur": duration * 1e6}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def _tid(self) -> int:
        """Small stable per-thread track id, stored thread-LOCALLY (raw
        idents are pthread addresses — huge, and CPython recycles them
        after thread death, so an ident-keyed map could hand a new thread
        a dead thread's track; thread-local storage dies with its
        thread)."""
        tid = getattr(self._track, "tid", None)
        if tid is None:
            with self._lock:
                self._next_tid += 1
                tid = self._next_tid
            self._track.tid = tid
        return tid

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker event ("i" phase) — crash/rollback points."""
        ev = {"name": name, "ph": "i", "pid": 1, "s": "p",
              "tid": self._tid(),
              "ts": (time.perf_counter() - self._t0) * 1e6}
        if attrs:
            ev["args"] = attrs
        with self._lock:
            self._events.append(ev)

    # -- inspection / output ---------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def open_spans(self) -> List[dict]:
        """Spans whose with-block has not exited yet (outermost first):
        name, attrs, depth, and seconds open so far.  A SIGTERM'd worker's
        final snapshot includes this — "preempted 48s into `compile`" is
        the post-mortem one-liner the completed-event ring can't give."""
        now = time.perf_counter()
        with self._lock:
            live = sorted(self._live.items())
        return [{"name": s["name"], "depth": s["depth"],
                 "open_seconds": round(now - s["start"], 6),
                 "attrs": {k: v for k, v in s["attrs"].items()}}
                for _sid, s in live]

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._live.clear()
        self._t0 = time.perf_counter()

    def write_chrome_trace(self, path: str, merge_profiler: bool = True,
                           tail: Optional[int] = None) -> None:
        """ONE merged trace file: this tracer's spans plus the OpProfiler
        singleton's phase events.  Both record ``ts`` relative to their
        own perf_counter epoch, so profiler events are SHIFTED into this
        tracer's epoch before merging — phases line up against the step
        spans they overlapped, even after an ``OpProfiler.reset()`` moved
        its zero.  ``tail`` keeps only the newest N tracer events (cheap
        periodic flushes from the training hot loop)."""
        events = self.events()
        if tail is not None:
            events = events[-int(tail):]
        if merge_profiler:
            from deeplearning4j_tpu_torch.profiler import OpProfiler
            prof = OpProfiler._instance
            if prof is not None:
                shift = (prof._t0 - self._t0) * 1e6
                pev = list(prof._events)
                if tail is not None:
                    # the profiler list is unbounded; an unbounded merge
                    # would defeat the point of a tail-bounded flush
                    pev = pev[-int(tail):]
                events = events + [
                    dict(e, ts=e["ts"] + shift) if "ts" in e else dict(e)
                    for e in pev]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)


_default = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every subsystem records through."""
    return _default


def set_tracer(t: Tracer) -> Tracer:
    """Swap the global tracer (tests); returns the previous one."""
    global _default
    prev, _default = _default, t
    return prev
