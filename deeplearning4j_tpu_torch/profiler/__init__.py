"""Profiling, panic modes and Chrome trace emission — the port of
``deeplearning4j_tpu/profiler/__init__.py``.

Reference: nd4j-api ``org/nd4j/linalg/profiler/{OpProfiler,ProfilerConfig,
PerformanceTracker}.java`` (per-op timings, NAN_PANIC/INF_PANIC scanning op
outputs) and the SameDiff ``ProfilingListener`` writing chrome://tracing
JSON.

As in the reference, the unit of profiling is a phase of the step (the
train step, ETL, a transfer) timed on the host by :class:`OpProfiler`, and
NAN/INF panic checks the step's loss.  The eager port could scan every
op's output, but that would read each one back to the host; the loss is
the reference's surface, and reading it is the one sync panic mode opts
into.  For kernel-level depth, :func:`start_trace` / :func:`stop_trace`
wrap a ``torch.profiler`` capture (the reference wraps ``jax.profiler``)
and write its Chrome trace, CUDA kernels included, into ``log_dir``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = ["ProfilerConfig", "OpProfiler", "check_panic", "panic_enabled",
           "start_trace", "stop_trace", "ProfilingListener"]


class ProfilerConfig:
    """Reference: ProfilerConfig.java — build with the modes you want."""

    def __init__(self, checkForNAN: bool = False, checkForINF: bool = False,
                 stackTrace: bool = False, nativeStatistics: bool = False):
        self.checkForNAN = checkForNAN
        self.checkForINF = checkForINF
        self.stackTrace = stackTrace
        self.nativeStatistics = nativeStatistics


class OpProfiler:
    """Singleton phase timer + panic checks (reference: OpProfiler.java)."""

    _instance: Optional["OpProfiler"] = None

    def __init__(self):
        self.config = ProfilerConfig()
        self._times: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._events: List[dict] = []
        self._t0 = time.perf_counter()

    @classmethod
    def getInstance(cls) -> "OpProfiler":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def setConfig(self, config: ProfilerConfig) -> None:
        self.config = config

    # -- timing -----------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - start
            self._times[name] += dur
            self._counts[name] += 1
            self._events.append({
                "name": name, "ph": "X", "pid": 1, "tid": 1,
                "ts": (start - self._t0) * 1e6, "dur": dur * 1e6})

    def timeSpent(self, name: str) -> float:
        return self._times[name]

    def invocations(self, name: str) -> int:
        return self._counts[name]

    def reset(self) -> None:
        self._times.clear()
        self._counts.clear()
        self._events.clear()
        self._t0 = time.perf_counter()

    def printOutDashboard(self) -> str:
        lines = [f"{'phase':<30} {'count':>8} {'total_s':>10} {'avg_ms':>10}"]
        for name in sorted(self._times, key=lambda n: -self._times[n]):
            t, c = self._times[name], self._counts[name]
            lines.append(f"{name:<30} {c:>8} {t:>10.3f} {1e3 * t / c:>10.2f}")
        out = "\n".join(lines)
        print(out)
        return out

    # -- chrome trace ------------------------------------------------------
    def writeChromeTrace(self, path: str) -> None:
        """chrome://tracing-format JSON (reference: ProfilingListener)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": self._events}, f)

    # -- panic -------------------------------------------------------------
    def hookOut(self, value: float, where: str = "loss") -> None:
        """Reference: DefaultOpExecutioner.profilingConfigurableHookOut —
        throw on the first NaN/Inf when panic mode is on."""
        v = float(value)
        if self.config.checkForNAN and math.isnan(v):
            raise FloatingPointError(f"NAN_PANIC: NaN detected in {where}")
        if self.config.checkForINF and math.isinf(v):
            raise FloatingPointError(f"INF_PANIC: Inf detected in {where}")


def check_panic(value: float, where: str = "loss") -> None:
    """Cheap global hook used by the train loops."""
    prof = OpProfiler._instance
    if prof is not None and (prof.config.checkForNAN or
                             prof.config.checkForINF):
        prof.hookOut(value, where)


def panic_enabled() -> bool:
    """True when NAN/INF panic mode is on — the train loops read the
    step's loss back to the host only then; otherwise it stays on the
    device and a step never waits on the host."""
    prof = OpProfiler._instance
    return prof is not None and (prof.config.checkForNAN or
                                 prof.config.checkForINF)


# -- device-level traces ------------------------------------------------------

_capture = None     # (torch.profiler.profile, log_dir) while a trace runs


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture of the host and, where a card is
    present, its CUDA kernels.  While it runs, every
    ``telemetry.tracer().span(...)`` also enters
    ``torch.profiler.record_function`` so host spans line up with the
    kernel timeline in the capture."""
    global _capture
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.telemetry import set_device_trace_active
    if _capture is not None:
        raise RuntimeError("a device trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _capture = (prof, log_dir)
    set_device_trace_active(True)


def stop_trace() -> None:
    """Stop the capture and write its Chrome trace into the ``log_dir``
    given to :func:`start_trace` (``<pid>.<ms>.pt.trace.json``)."""
    global _capture
    from deeplearning4j_tpu_torch.telemetry import set_device_trace_active
    set_device_trace_active(False)
    if _capture is None:
        return
    prof, log_dir = _capture
    _capture = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"))


class ProfilingListener:
    """TrainingListener emitting one Chrome-trace slice per iteration
    (reference: autodiff/listeners/profiler/ProfilingListener.java).

    Registry-backed: iteration slices are recorded through the process
    telemetry :func:`~deeplearning4j_tpu_torch.telemetry.tracer`, so the
    flushed file is the MERGED trace — the train loop's nested step spans
    and the OpProfiler's phase events, one file.

    The trace file flushes every ``flushEveryNIterations`` (and on epoch
    end) — a per-iteration rewrite of the cumulative JSON would be O(n²)
    host IO in the training hot loop.
    """

    def __init__(self, outputPath: str, flushEveryNIterations: int = 100):
        self.outputPath = outputPath
        self.flushEvery = max(1, flushEveryNIterations)
        self._iter_start = None

    #: newest tracer events kept by the cheap PERIODIC flush (epoch end
    #: writes the full ring) — bounds the hot-loop serialization cost
    PERIODIC_FLUSH_TAIL = 10_000

    def onEpochStart(self, model):
        pass

    def onEpochEnd(self, model):
        self._flush()

    def onForwardPass(self, model, activations=None):
        pass

    def onBackwardPass(self, model):
        pass

    def onGradientCalculation(self, model):
        pass

    def _flush(self, tail=None):
        from deeplearning4j_tpu_torch.telemetry import tracer
        tracer().write_chrome_trace(self.outputPath, tail=tail)

    def iterationDone(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.telemetry import tracer
        now = time.perf_counter()
        if self._iter_start is not None:
            tracer().record_complete(
                f"iteration_{iteration}", self._iter_start,
                now - self._iter_start, args={"score": model.score()})
        self._iter_start = now
        if iteration % self.flushEvery == 0:
            # tail-bounded: the periodic flush keeps the file fresh if the
            # run dies, without re-serializing the whole shared ring
            self._flush(tail=self.PERIODIC_FLUSH_TAIL)
