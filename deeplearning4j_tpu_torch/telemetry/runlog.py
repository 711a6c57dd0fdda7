"""Training-run observability: run-scoped trace ids + a cross-host
fleet timeline — the port of ``deeplearning4j_tpu/telemetry/runlog.py``
(pure Python, copied).

The serving tier correlates one REQUEST across layers with a
``RequestContext``; this module does the same for one TRAINING RUN.

- :class:`RunContext` — one trace id minted per training run (reusing
  the ``context.py`` trace-id machinery), threaded ambiently through the
  supervisor/elastic/coordination/checkpoint stack so step spans,
  checkpoint save/seal/restore spans, barrier waits and remesh
  operations all share ONE trace id tagged with (generation, step).
- :class:`FleetTimeline` — every lifecycle event (``train.step``,
  ``ckpt.*``, ``coord.*``, ``elastic.*``, ``etl.restart``, ``health.*``)
  appended as one NDJSON line per host into the federation run dir,
  stamped with a hybrid logical clock so the per-host files merge into
  ONE causally ordered pod timeline (:func:`merge_timelines`, served at
  ``GET /v1/runs/<runId>/timeline``).

Causality across hosts comes from the HLC: the leader ticks its clock
when it publishes a plan and embeds the stamp in the plan file; every
adopter *observes* that stamp before recording its ``coord.adopt`` —
so a propose merges strictly before the adopts it caused, regardless of
wall-clock skew between hosts.

Recording is a no-op (one global read) when no timeline is configured —
the hot train loop pays nothing until observability is switched on.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.telemetry.context import RequestContext

__all__ = [
    "TIMELINE_EVENT_KINDS", "RunContext", "current_run", "current_run_id",
    "run_scope", "run_span_attrs", "HybridLogicalClock", "FleetTimeline",
    "fleet_timeline", "set_fleet_timeline", "record_event",
    "merge_timelines",
]

#: Bounded vocabulary of timeline event kinds, the reference's set letter
#: for letter (the parity tests hold the two sets equal).
TIMELINE_EVENT_KINDS = frozenset({
    "run.start", "run.end",
    "train.step",
    "ckpt.save", "ckpt.seal", "ckpt.restore", "ckpt.rollback",
    "coord.propose", "coord.barrier", "coord.adopt",
    "coord.leader_failover", "coord.evict", "coord.readmit",
    "elastic.shrink", "elastic.grow", "elastic.remesh",
    "etl.restart",
    "health.firing", "health.resolved",
})

_TIMELINE_PREFIX = "timeline_"
_TIMELINE_SUFFIX = ".ndjson"
_HOST_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


# -- run context ----------------------------------------------------------

class RunContext:
    """One training run's identity: a 32-hex trace id (minted through
    :class:`RequestContext`) plus the run's CURRENT mesh generation.

    Every span the run emits (step, checkpoint, barrier, remesh) carries
    ``trace_id=runId`` via :func:`run_span_attrs`, so the OTLP exporter
    groups the whole run — across save/restore/remesh — under one trace.
    ``generation`` is mutable: the elastic supervisor bumps it whenever
    the coordinator adopts a new plan, and everything downstream (spans,
    timeline events, HealthMonitor records) reads the live value.
    """

    __slots__ = ("ctx", "generation")

    def __init__(self, ctx: RequestContext, generation: int = 0):
        self.ctx = ctx
        self.generation = int(generation)

    @classmethod
    def new(cls, **baggage) -> "RunContext":
        return cls(RequestContext.new(**baggage))

    @property
    def runId(self) -> str:
        return self.ctx.traceId

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"RunContext(runId={self.runId!r}, generation={self.generation})"


_CURRENT_RUN: contextvars.ContextVar[Optional[RunContext]] = \
    contextvars.ContextVar("dl4j_tpu_run_context", default=None)

# Process-global fallback: background threads (HealthMonitor's evaluator,
# async checkpoint sealers, the prefetch pool) are spawned outside the
# fit thread's contextvar snapshot, but their records still belong to the
# active run.  Last fit wins — one training run per process is the
# supported shape (the chaos soak's phantom PEERS are bare coordinators
# and never install a run).
_ACTIVE_RUN: Optional[RunContext] = None
_ACTIVE_LOCK = threading.Lock()


def current_run() -> Optional[RunContext]:
    """The ambient :class:`RunContext`: the contextvar if set (same-task
    callers), else the process-global active run (background threads)."""
    got = _CURRENT_RUN.get()
    if got is not None:
        return got
    return _ACTIVE_RUN


def current_run_id() -> Optional[str]:
    rc = current_run()
    return rc.runId if rc is not None else None


@contextlib.contextmanager
def run_scope(rc: RunContext):
    """Install ``rc`` as the ambient run for the duration: contextvar for
    the calling task AND the process-global slot for background threads."""
    global _ACTIVE_RUN
    token = _CURRENT_RUN.set(rc)
    with _ACTIVE_LOCK:
        prev = _ACTIVE_RUN
        _ACTIVE_RUN = rc
    try:
        yield rc
    finally:
        _CURRENT_RUN.reset(token)
        with _ACTIVE_LOCK:
            _ACTIVE_RUN = prev


def run_span_attrs(step: Optional[int] = None, **extra) -> Dict[str, Any]:
    """Span attributes tying a span to the active run: ``trace_id`` (what
    the OTLP exporter keys the trace on) + the live ``generation``, plus
    ``step`` when the caller knows it.  Empty dict when no run is active,
    so call sites can always ``**run_span_attrs()``."""
    rc = current_run()
    if rc is None:
        return dict(extra)
    attrs: Dict[str, Any] = {"trace_id": rc.runId,
                             "generation": int(rc.generation)}
    if step is not None:
        attrs["step"] = int(step)
    attrs.update(extra)
    return attrs


# -- hybrid logical clock -------------------------------------------------

class HybridLogicalClock:
    """A hybrid logical clock (physical millis + logical counter).

    ``tick()`` stamps a local event; ``observe(remote)`` merges a stamp
    read from another host (a published plan) so that every subsequent
    local stamp sorts AFTER the remote event — the causal edge that makes
    the merged pod timeline ordered even with wall-clock skew."""

    __slots__ = ("_pt", "_lt", "_lock")

    def __init__(self):
        self._pt = 0
        self._lt = 0
        self._lock = threading.Lock()

    @staticmethod
    def _now_ms() -> int:
        return int(time.time() * 1000)

    def tick(self) -> Tuple[int, int]:
        now = self._now_ms()
        with self._lock:
            if now > self._pt:
                self._pt, self._lt = now, 0
            else:
                self._lt += 1
            return self._pt, self._lt

    def observe(self, remote) -> Tuple[int, int]:
        """Merge a remote ``[pt, lt]`` stamp (tolerates None/garbage —
        a plan written by older code simply contributes no edge)."""
        try:
            rpt, rlt = int(remote[0]), int(remote[1])
        except (TypeError, ValueError, IndexError):
            with self._lock:
                return self._pt, self._lt
        now = self._now_ms()
        with self._lock:
            pt = max(self._pt, rpt, now)
            if pt == self._pt and pt == rpt:
                lt = max(self._lt, rlt) + 1
            elif pt == self._pt:
                lt = self._lt + 1
            elif pt == rpt:
                lt = rlt + 1
            else:
                lt = 0
            self._pt, self._lt = pt, lt
            return self._pt, self._lt

    def last(self) -> Tuple[int, int]:
        with self._lock:
            return self._pt, self._lt


# -- per-host timeline writer --------------------------------------------

class FleetTimeline:
    """Appends lifecycle events as NDJSON lines — one file per host in
    the shared (federation) run dir — each stamped with this host's HLC.

    Lines are written open-append-close (same idiom as the HealthMonitor
    event log): crash-safe, torn-tail tolerant on merge, and cheap enough
    that the per-step event stays under the 2% overhead gate.  A small
    in-memory ring of recent events backs the FlightRecorder window dump
    around rollbacks/divergence."""

    def __init__(self, runDir: str, hostId: Optional[str] = None,
                 runId: Optional[str] = None, recentMax: int = 64):
        from deeplearning4j_tpu_torch.telemetry.federation import host_id
        self.runDir = str(runDir)
        self.hostId = str(hostId or host_id())
        self.runId = runId
        self.clock = HybridLogicalClock()
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=int(recentMax))
        safe = _HOST_SAFE.sub("-", self.hostId)
        self.path = os.path.join(
            self.runDir, f"{_TIMELINE_PREFIX}{safe}{_TIMELINE_SUFFIX}")

    def record(self, kind: str, generation: Optional[int] = None,
               step: Optional[int] = None, **attrs) -> Dict[str, Any]:
        """Append one event.  Never raises — a full disk must not take
        down the train loop (same contract as the health event log)."""
        pt, lt = self.clock.tick()
        rc = current_run()
        run = self.runId or (rc.runId if rc is not None else None)
        if generation is None and rc is not None:
            generation = rc.generation
        event: Dict[str, Any] = {"ts": round(time.time(), 6),
                                 "hlc": [pt, lt],
                                 "host": self.hostId,
                                 "run": run, "kind": str(kind)}
        if generation is not None:
            event["generation"] = int(generation)
        if step is not None:
            event["step"] = int(step)
        for k, v in attrs.items():
            if v is not None:
                event[k] = v
        line = json.dumps(event, sort_keys=True, default=str)
        with self._lock:
            self._recent.append(event)
            try:
                os.makedirs(self.runDir, exist_ok=True)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
            except OSError:
                pass
        return event

    def observe(self, remote) -> None:
        """Merge a remote HLC stamp (from an adopted plan) into this
        host's clock — the cross-host causal edge."""
        self.clock.observe(remote)

    def stamp(self) -> List[int]:
        """Tick and return ``[pt, lt]`` for embedding in a published plan
        (the stamp every adopter observes)."""
        pt, lt = self.clock.tick()
        return [pt, lt]

    def recent(self, n: int = 16) -> List[Dict[str, Any]]:
        """The last ``n`` events recorded by THIS host — the window the
        supervisor dumps into the FlightRecorder around a rollback."""
        with self._lock:
            items = list(self._recent)
        return items[-int(n):]


# -- process-global recorder ---------------------------------------------

_TIMELINE: Optional[FleetTimeline] = None
_TIMELINE_LOCK = threading.Lock()


def fleet_timeline() -> Optional[FleetTimeline]:
    return _TIMELINE


def set_fleet_timeline(tl: Optional[FleetTimeline]) -> Optional[FleetTimeline]:
    """Install the process-global timeline; returns the previous one so
    scoped installers (the supervisor's fit) can restore it."""
    global _TIMELINE
    with _TIMELINE_LOCK:
        prev = _TIMELINE
        _TIMELINE = tl
        return prev


def record_event(kind: str, generation: Optional[int] = None,
                 step: Optional[int] = None, **attrs) -> None:
    """Record one lifecycle event on the process-global timeline; a pure
    no-op (one global read) when none is configured.  ``kind`` must be a
    dot.separated lowercase literal from :data:`TIMELINE_EVENT_KINDS`."""
    tl = _TIMELINE
    if tl is None:
        return
    tl.record(kind, generation=generation, step=step, **attrs)


# -- merge ---------------------------------------------------------------

def _merge_key(event: Dict[str, Any]) -> Tuple[int, int, str]:
    hlc = event.get("hlc") or [0, 0]
    try:
        return int(hlc[0]), int(hlc[1]), str(event.get("host", ""))
    except (TypeError, ValueError, IndexError):
        return 0, 0, str(event.get("host", ""))


def merge_timelines(runDir: str, run_id: Optional[str] = None,
                    kinds: Optional[Iterable[str]] = None,
                    generation: Optional[int] = None,
                    step_min: Optional[int] = None,
                    step_max: Optional[int] = None) -> List[Dict[str, Any]]:
    """Merge every host's ``timeline_*.ndjson`` in ``runDir`` into ONE
    causally ordered pod timeline (HLC order, host id as tie-break).

    Filters: ``run_id`` keeps events of that run PLUS run-agnostic
    coordination-plane events (peers that never joined a run context
    record ``run: null`` — they still belong to the pod's story);
    ``kinds``/``generation``/``step_min``/``step_max`` narrow further.
    Torn trailing lines (a host dying mid-append) are skipped, matching
    the federation aggregator's torn-snapshot tolerance."""
    events: List[Dict[str, Any]] = []
    kindset = set(kinds) if kinds else None
    try:
        names = sorted(os.listdir(runDir))
    except OSError:
        return []
    for fn in names:
        if not (fn.startswith(_TIMELINE_PREFIX)
                and fn.endswith(_TIMELINE_SUFFIX)):
            continue
        try:
            with open(os.path.join(runDir, fn), encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn tail
            if not isinstance(ev, dict):
                continue
            if run_id is not None and ev.get("run") not in (None, run_id):
                continue
            if kindset is not None and ev.get("kind") not in kindset:
                continue
            if generation is not None and ev.get("generation") != generation:
                continue
            step = ev.get("step")
            if step_min is not None and (step is None or step < step_min):
                continue
            if step_max is not None and (step is None or step > step_max):
                continue
            events.append(ev)
    events.sort(key=_merge_key)
    return events
