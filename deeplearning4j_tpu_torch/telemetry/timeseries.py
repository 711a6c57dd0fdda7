"""Bounded in-process time-series retention: ``rate()`` without Prometheus
— the port of ``deeplearning4j_tpu/telemetry/timeseries.py`` (pure Python,
copied).

``/metrics`` is a point-in-time scrape surface; asking "what is the
token rate over the last minute" needs TWO samples, which normally means
an external Prometheus.  Batch pods and bench soaks don't have one, so
:class:`MetricsRetention` keeps a small ring of registry snapshots
sampled on a fixed cadence:

- O(window / interval) samples, each a compact ``{metric: {labelkey:
  float}}`` dict — counters/gauges sample their value, histograms their
  cumulative observation count (suffix ``:sum`` holds the running sum so
  mean latency over a window is also answerable).
- ``rate()`` / ``increase()`` with counter-reset smoothing (a restarted
  worker resets to 0; a negative delta counts as the new value, never a
  negative rate), ``latest()``, and raw ``series()``.
- :meth:`http_query` backs ``GET /metrics/query?metric=...&fn=rate`` on
  every server that routes through ``telemetry.http``.

The sampler is a daemon thread; :meth:`sample_now` takes an explicit
timestamp so tests drive deterministic clocks.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                   get_registry)

__all__ = ["MetricsRetention", "ensure_retention", "retention",
           "set_retention"]

_ENV_WINDOW = "DL4J_TPU_RETENTION_WINDOW"
_ENV_INTERVAL = "DL4J_TPU_RETENTION_INTERVAL"

_QUERY_FNS = ("rate", "increase", "latest")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw or default)
    except ValueError:
        return default


class MetricsRetention:
    """Fixed-cadence sampler over a :class:`MetricsRegistry` with a
    bounded window — O(window) memory regardless of run length."""

    def __init__(self, interval: float = 5.0, window: float = 300.0,
                 registry: Optional[MetricsRegistry] = None):
        if interval <= 0 or window <= 0:
            raise ValueError("interval and window must be positive")
        self.interval = interval
        self.window = window
        self._registry = registry
        self._lock = threading.Lock()
        #: (ts, {metric: (labelnames, {labelkey: value})})
        self._samples: Deque[Tuple[float, dict]] = deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    # -- sampling --------------------------------------------------------
    def sample_now(self, ts: Optional[float] = None) -> None:
        """Take one sample (the thread calls this on cadence; tests call
        it directly with an explicit ``ts`` for deterministic clocks)."""
        now = time.time() if ts is None else ts
        reg = self._reg()
        reg.counter("dl4j_tpu_retention_samples_total",
                    "retention-ring samples taken").inc()
        snap = reg.snapshot()
        compact: Dict[str, Tuple[Tuple[str, ...], Dict[Tuple[str, ...],
                                                       float]]] = {}
        for name, data in snap.items():
            labelnames = tuple(data.get("labelnames", ()))
            cells: Dict[Tuple[str, ...], float] = {}
            sums: Dict[Tuple[str, ...], float] = {}
            for key, cell in data.get("cells", []):
                k = tuple(key)
                if isinstance(cell, dict):        # histogram
                    cells[k] = cell.get("count", 0)
                    sums[k] = cell.get("sum", 0.0)
                else:
                    cells[k] = cell
            compact[name] = (labelnames, cells)
            if sums:
                compact[name + ":sum"] = (labelnames, sums)
        with self._lock:
            self._samples.append((now, compact))
            floor = now - self.window
            while len(self._samples) > 1 and self._samples[0][0] < floor:
                self._samples.popleft()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_now()
            except Exception:
                pass        # a torn sample must never kill the sampler

    def start(self) -> "MetricsRetention":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="metrics-retention", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- queries ---------------------------------------------------------
    def _window_samples(self, window: Optional[float]
                        ) -> List[Tuple[float, dict]]:
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return []
        w = self.window if window is None else window
        floor = samples[-1][0] - w
        return [s for s in samples if s[0] >= floor]

    def _cells(self, samples: List[Tuple[float, dict]], metric: str,
               labels: Dict[str, str]
               ) -> Dict[Tuple[str, ...], List[Tuple[float, float]]]:
        """Per-label-key series for one metric, filtered by a partial
        label match."""
        out: Dict[Tuple[str, ...], List[Tuple[float, float]]] = {}
        for ts, compact in samples:
            entry = compact.get(metric)
            if entry is None:
                continue
            labelnames, cells = entry
            for key, value in cells.items():
                got = dict(zip(labelnames, key))
                if any(got.get(n) != v for n, v in labels.items()):
                    continue
                out.setdefault(key, []).append((ts, value))
        return out

    @staticmethod
    def _increase(series: List[Tuple[float, float]]) -> float:
        """Sum of positive deltas; a counter reset (negative delta) counts
        the post-reset value — monotonic smoothing, never negative."""
        total = 0.0
        for (_, prev), (_, cur) in zip(series, series[1:]):
            total += cur - prev if cur >= prev else cur
        return total

    def series(self, metric: str, window: Optional[float] = None,
               **labels) -> Dict[Tuple[str, ...],
                                 List[Tuple[float, float]]]:
        return self._cells(self._window_samples(window), metric, labels)

    def increase(self, metric: str, window: Optional[float] = None,
                 **labels) -> float:
        cells = self.series(metric, window, **labels)
        return sum(self._increase(s) for s in cells.values())

    def rate(self, metric: str, window: Optional[float] = None,
             **labels) -> float:
        cells = self.series(metric, window, **labels)
        total = 0.0
        for s in cells.values():
            if len(s) < 2:
                continue
            elapsed = s[-1][0] - s[0][0]
            if elapsed > 0:
                total += self._increase(s) / elapsed
        return total

    def latest(self, metric: str, **labels) -> Optional[float]:
        cells = self.series(metric, None, **labels)
        vals = [s[-1][1] for s in cells.values() if s]
        return sum(vals) if vals else None

    def sample_count(self) -> int:
        with self._lock:
            return len(self._samples)

    # -- HTTP ------------------------------------------------------------
    def http_query(self, params: Dict[str, str]) -> Tuple[int, dict]:
        """Back ``GET /metrics/query``.  ``params`` are the single-valued
        query args: ``metric`` (required), ``fn`` (rate | increase |
        latest, default rate), ``window`` (seconds), plus any metric
        labels as extra keys.  Returns (status, JSON-able doc)."""
        metric = params.get("metric", "")
        fn = params.get("fn", "rate")
        if not metric:
            return 400, {"error": "missing required query arg 'metric'"}
        if fn not in _QUERY_FNS:
            return 400, {"error": f"unknown fn {fn!r}; "
                         f"expected one of {list(_QUERY_FNS)}"}
        window = None
        raw_window = params.get("window")
        if raw_window is not None:
            try:
                window = float(raw_window or "")
            except ValueError:
                return 400, {"error": f"bad window {raw_window!r}"}
        labels = {k: v for k, v in params.items()
                  if k not in ("metric", "fn", "window")}
        cells = self.series(metric, window, **labels)
        labelnames: Tuple[str, ...] = ()
        with self._lock:
            for _, compact in reversed(self._samples):
                if metric in compact:
                    labelnames = compact[metric][0]
                    break
        out = []
        for key, s in sorted(cells.items()):
            if fn == "latest":
                value = s[-1][1] if s else None
            elif fn == "increase":
                value = self._increase(s)
            else:
                elapsed = s[-1][0] - s[0][0] if len(s) > 1 else 0.0
                value = self._increase(s) / elapsed if elapsed > 0 else 0.0
            out.append({"labels": dict(zip(labelnames, key)),
                        "value": value, "points": len(s)})
        return 200, {"metric": metric, "fn": fn,
                     "window_seconds": window if window is not None
                     else self.window,
                     "interval_seconds": self.interval,
                     "samples": self.sample_count(), "series": out}


_RETENTION: Optional[MetricsRetention] = None
_RETENTION_LOCK = threading.Lock()


def retention() -> Optional[MetricsRetention]:
    return _RETENTION


def set_retention(r: Optional[MetricsRetention]
                  ) -> Optional[MetricsRetention]:
    global _RETENTION
    with _RETENTION_LOCK:
        prev, _RETENTION = _RETENTION, r
    return prev


def ensure_retention(start: bool = True) -> MetricsRetention:
    """The process-global retention ring, created on first use from the
    ``DL4J_TPU_RETENTION_{WINDOW,INTERVAL}`` env knobs (seconds)."""
    global _RETENTION
    with _RETENTION_LOCK:
        if _RETENTION is None:
            _RETENTION = MetricsRetention(
                interval=_env_float(_ENV_INTERVAL, 5.0),
                window=_env_float(_ENV_WINDOW, 300.0))
        r = _RETENTION
    if start:
        r.start()
    return r
