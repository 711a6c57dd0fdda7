"""Durable snapshot export for scrape-less batch jobs — the port of
``deeplearning4j_tpu/telemetry/export.py`` (pure Python, copied).

A Prometheus pull model loses everything a batch job counted between the
last scrape and its death — and preempted jobs die on SIGTERM with
seconds of notice.  :func:`install_export_handlers` arms two flush
paths (opt-in; the fault supervisor and training masters arm them for
their runs):

- **atexit** — every normal interpreter exit writes a final registry
  snapshot, so a job that never got scraped still leaves its counters.
- **SIGTERM** — a preemption additionally dumps the FlightRecorder ring
  (the crash record a killed job otherwise never writes) before chaining
  to the previous handler / exiting 143.

The final snapshot lands next to the FlightRecorder output
(``$DL4J_TPU_FLIGHT_DIR``) unless federation is configured, in which
case it IS the worker's federation snapshot file — the aggregator then
serves the dead worker's final numbers with no special casing.  The
payload also includes the tracer's **open spans**: "SIGTERM'd 48s into
``compile``" is the post-mortem one-liner completed-event logs can't
give.
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import tempfile
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.telemetry.flight import flight_recorder
from deeplearning4j_tpu_torch.telemetry.registry import get_registry
from deeplearning4j_tpu_torch.telemetry.tracing import tracer

__all__ = ["write_final_snapshot", "install_export_handlers",
           "uninstall_export_handlers"]

_lock = threading.Lock()
_atexit_armed = False
_sigterm_armed = False
_prev_sigterm = None
_flushed = False
_pending_reason = None
_pending_open_spans = None


def _atomic_json(path: str, payload: dict) -> None:
    """tmp + os.replace: a SIGKILL landing mid-dump (grace period
    expired) must leave either the whole file or nothing — a torn final
    snapshot is worse than none for post-mortem tooling."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".final_", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_final_snapshot(reason: str = "manual",
                         directory: Optional[str] = None) -> str:
    """Write the durable end-of-life snapshot; returns the path ('' on
    failure — a failing flush must not mask the shutdown it reports).

    With federation configured (and no explicit ``directory``) this
    updates the worker's own ``metrics_<host>.json`` through
    :class:`~deeplearning4j_tpu_torch.telemetry.federation.SnapshotWriter`, so
    the federated view keeps serving the final numbers; otherwise it
    writes ``dl4j_tpu_final_<pid>_<ms>.json`` next to the FlightRecorder
    dumps.  Open spans ride along in both cases via a sibling
    ``dl4j_tpu_spans_<pid>_<ms>.json``."""
    from deeplearning4j_tpu_torch.telemetry import federation
    out = ""
    fed_dir = directory or federation.get_federation_dir()
    try:
        if fed_dir is not None:
            # reuse the periodic writer's host id (custom hostId=
            # included) so the final flush overwrites the SAME file the
            # aggregator already tracks for this process
            out = federation.SnapshotWriter(
                fed_dir,
                hostId=federation.local_snapshot_host_id()).write_now(
                    reason=f"final_{reason}")
            span_dir = fed_dir
        else:
            span_dir = flight_recorder().dumpDir
            stamp = f"{os.getpid()}_{int(time.time() * 1e3)}"
            path = os.path.join(span_dir, f"dl4j_tpu_final_{stamp}.json")
            _atomic_json(path, {
                "host": federation.host_id(), "pid": os.getpid(),
                "written_at": time.time(), "reason": f"final_{reason}",
                "metrics": get_registry().snapshot()})
            out = path
        # a SIGTERM death flushes at atexit, AFTER SystemExit unwound the
        # stack (closing every span) — the handler stashed the spans that
        # were open at signal time so the post-mortem keeps them
        open_spans = _pending_open_spans
        if open_spans is None:
            open_spans = tracer().open_spans()
        if open_spans:
            span_path = os.path.join(
                span_dir,
                f"dl4j_tpu_spans_{os.getpid()}_{int(time.time() * 1e3)}"
                ".json")
            _atomic_json(span_path, {
                "reason": reason, "pid": os.getpid(),
                "written_at": time.time(), "open_spans": open_spans})
    except Exception:
        pass
    return out


def _flush(reason: str, dumpFlight: bool, once: bool = True) -> None:
    """``once=True`` is the process's one end-of-life flush (atexit); the
    suppressor flag is only set AFTER the write succeeds, so an
    interrupted attempt never eats the later retry.  ``once=False``
    (survived-SIGTERM paths) writes without consuming the one-shot — the
    process lives on and its real exit must still flush the final
    numbers."""
    global _flushed
    if once:
        with _lock:
            if _flushed:
                return
    write_final_snapshot(reason=reason)
    if dumpFlight and len(flight_recorder()):
        flight_recorder().dump(reason=f"flush_{reason}")
    if once:
        with _lock:
            _flushed = True


def _on_sigterm(signum, frame):
    # the handler executes at a bytecode boundary of the MAIN thread —
    # possibly INSIDE a registry/cell lock's critical section (the train
    # hot path takes those every step), so flushing from this frame could
    # self-deadlock on a non-reentrant lock the interrupted frame still
    # holds.  On the default disposition we therefore don't flush here at
    # all: SystemExit unwinds the interrupted frame (releasing its locks)
    # and the atexit hook does the flush on a clean stack, tagged with
    # the pending sigterm reason.
    global _pending_reason
    prev = _prev_sigterm
    if prev is signal.SIG_IGN or callable(prev):
        # the process may SURVIVE this signal (launcher ignored it or a
        # prior handler owns the outcome), so atexit may be hours away:
        # flush now on a helper thread — free to wait out whatever lock
        # the interrupted frame holds — with a bounded join.  once=False:
        # this must not consume the real end-of-life flush.
        t = threading.Thread(target=_flush, args=("sigterm", True, False),
                             name="telemetry-sigterm-flush", daemon=True)
        t.start()
        t.join(timeout=10.0)
        if callable(prev):
            prev(signum, frame)
        return
    _pending_reason = "sigterm"

    # stash the spans open RIGHT NOW — the unwind below closes them
    # before the atexit flush runs.  A helper thread (bounded join)
    # reads them because the tracer lock may be held by the very frame
    # this handler interrupted.
    def _capture():
        global _pending_open_spans
        try:
            _pending_open_spans = tracer().open_spans()
        except Exception:
            pass

    t = threading.Thread(target=_capture,
                         name="telemetry-span-capture", daemon=True)
    t.start()
    t.join(timeout=2.0)
    # default disposition: die with the conventional 128+15 status so
    # supervisors (and a scheduler's preemption logic) see a clean SIGTERM
    # death, but through SystemExit so atexit/finally still run
    raise SystemExit(143)


def _on_atexit():
    # atexit covers clean exits, unhandled-exception exits AND the
    # SIGTERM SystemExit path (tagged via _pending_reason); the flight
    # ring flush here is what turns "the pod scheduler reaped us" into a
    # crash record (SIGKILL is unflushable; SIGTERM/atexit is the window)
    _flush(_pending_reason or "atexit", dumpFlight=True)


def install_export_handlers() -> bool:
    """Arm the atexit + SIGTERM flush (idempotent).  Returns True once
    the SIGTERM hook is armed; False when only atexit could be (Python
    allows signal handlers in the main thread only — a later call FROM
    the main thread upgrades to the full hook, so supervisors built on
    worker threads still get SIGTERM coverage when the main-thread fit
    arms again)."""
    global _atexit_armed, _sigterm_armed, _prev_sigterm
    with _lock:
        if not _atexit_armed:
            atexit.register(_on_atexit)
            _atexit_armed = True
        if not _sigterm_armed:
            try:
                _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
                _sigterm_armed = True
            except (ValueError, OSError):       # not the main thread
                pass
        return _sigterm_armed


def uninstall_export_handlers() -> None:
    """Disarm (tests).  Restores the previous SIGTERM handler."""
    global _atexit_armed, _sigterm_armed, _prev_sigterm, _flushed, \
        _pending_reason, _pending_open_spans
    with _lock:
        if not (_atexit_armed or _sigterm_armed):
            return
        _atexit_armed = False
        _flushed = False
        _pending_reason = None
        _pending_open_spans = None
        sigterm_was_armed, _sigterm_armed = _sigterm_armed, False
    try:
        atexit.unregister(_on_atexit)
    except Exception:
        pass
    if sigterm_was_armed:
        try:
            signal.signal(signal.SIGTERM,
                          _prev_sigterm if _prev_sigterm is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        _prev_sigterm = None
