"""OTLP/HTTP JSON exporter: metrics + spans pushed to a collector — the
port of ``deeplearning4j_tpu/telemetry/otlp.py`` (pure Python on
``urllib``, copied).

A background thread
periodically serializes the metrics registry and the :class:`Tracer`
ring into the OTLP/HTTP JSON shape (``/v1/metrics``, ``/v1/traces`` on
the collector) and POSTs them with a short timeout.

Hot-path contract — the exporter can NEVER stall a decode step:

- it runs entirely on its own daemon thread; the serving tier does not
  call into it;
- the span queue is bounded (``maxQueue`` per flush); overflow is
  dropped oldest-first and counted in
  ``dl4j_tpu_otlp_dropped_total{signal=...}``;
- a dead/unreachable collector costs one short-timeout socket error per
  flush, counted in ``dl4j_tpu_otlp_exports_total{outcome="error"}``,
  and the dropped payload's items land on the drop counter — no retry
  queue to grow, no backpressure.

Enable on :class:`~deeplearning4j_tpu_torch.remote.serving.InferenceServer`
via the ``DL4J_TPU_OTLP_ENDPOINT`` env knob (e.g.
``http://collector:4318``) or construct/start one directly.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                         get_registry)
from deeplearning4j_tpu_torch.telemetry.tracing import Tracer, tracer

__all__ = ["OtlpExporter", "ensure_otlp_exporter", "otlp_exporter",
           "set_otlp_exporter"]

_ENV_ENDPOINT = "DL4J_TPU_OTLP_ENDPOINT"
_ENV_INTERVAL = "DL4J_TPU_OTLP_INTERVAL"

_TRACE_ID_LEN = 32
_SPAN_ID_LEN = 16


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


class OtlpExporter:
    """Push-mode OTLP/HTTP JSON exporter with a bounded span queue."""

    def __init__(self, endpoint: str, interval: float = 10.0,
                 maxQueue: int = 2048, timeout: float = 2.0,
                 registry: Optional[MetricsRegistry] = None,
                 trace: Optional[Tracer] = None,
                 serviceName: str = "dl4j_tpu"):
        self.endpoint = endpoint.rstrip("/")
        self.interval = interval
        self.maxQueue = maxQueue
        self.timeout = timeout
        self.serviceName = serviceName
        self._registry = registry
        self._tracer = trace
        self._lastSpanTs = -math.inf     # tracer-epoch µs high-water mark
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def _tr(self) -> Tracer:
        return self._tracer if self._tracer is not None else tracer()

    def _drops(self):
        return self._reg().counter(
            "dl4j_tpu_otlp_dropped_total",
            "OTLP items dropped (queue overflow or collector failure)",
            labelnames=("signal",))

    def _exports(self):
        return self._reg().counter(
            "dl4j_tpu_otlp_exports_total",
            "OTLP flush attempts by signal and outcome",
            labelnames=("signal", "outcome"))

    # -- payload construction -------------------------------------------
    def _resource(self) -> dict:
        return {"attributes": [_attr("service.name", self.serviceName),
                               _attr("process.pid", os.getpid())]}

    def _metrics_payload(self) -> dict:
        metrics: List[dict] = []
        nowNano = str(int(time.time() * 1e9))
        for name, data in self._reg().snapshot().items():
            labelnames = data.get("labelnames", [])
            typ = data.get("type")
            points, hpoints = [], []
            for key, cell in data.get("cells", []):
                attrs = [_attr(n, v) for n, v in zip(labelnames, key)]
                if typ == "histogram":
                    counts = cell.get("counts", [])
                    hpoints.append({
                        "attributes": attrs, "timeUnixNano": nowNano,
                        "count": str(cell.get("count", 0)),
                        "sum": cell.get("sum", 0.0),
                        "bucketCounts": [str(c) for c in counts],
                        "explicitBounds": list(data.get("buckets", []))})
                else:
                    points.append({"attributes": attrs,
                                   "timeUnixNano": nowNano,
                                   "asDouble": cell})
            entry: dict = {"name": name, "description": data.get("help", "")}
            if typ == "counter":
                entry["sum"] = {"dataPoints": points, "isMonotonic": True,
                                "aggregationTemporality": 2}
            elif typ == "histogram":
                entry["histogram"] = {"dataPoints": hpoints,
                                      "aggregationTemporality": 2}
            else:
                entry["gauge"] = {"dataPoints": points}
            metrics.append(entry)
        return {"resourceMetrics": [{
            "resource": self._resource(),
            "scopeMetrics": [{"scope": {"name": "dl4j_tpu.telemetry"},
                              "metrics": metrics}]}]}

    def _spans_payload(self) -> Optional[dict]:
        """Complete ("X") tracer events newer than the high-water mark,
        bounded at ``maxQueue`` newest; the overflow is counted dropped."""
        tr = self._tr()
        # map tracer perf_counter epoch -> wall clock once per flush
        anchor = time.time() - (time.perf_counter() - tr._t0)
        fresh = [e for e in tr.events()
                 if e.get("ph") == "X" and e.get("ts", 0) > self._lastSpanTs]
        if not fresh:
            return None
        if len(fresh) > self.maxQueue:
            self._drops().inc(len(fresh) - self.maxQueue, signal="spans")
            fresh = fresh[-self.maxQueue:]
        self._lastSpanTs = max(e["ts"] for e in fresh)
        spans = []
        for e in fresh:
            args = e.get("args") or {}
            traceId = str(args.get("trace_id", ""))
            if len(traceId) != _TRACE_ID_LEN:
                traceId = os.urandom(16).hex()
            startNano = int((anchor + e["ts"] / 1e6) * 1e9)
            spans.append({
                "traceId": traceId,
                "spanId": os.urandom(8).hex(),
                "name": e.get("name", "span"),
                "kind": 1,
                "startTimeUnixNano": str(startNano),
                "endTimeUnixNano": str(startNano
                                       + int(e.get("dur", 0) * 1e3)),
                "attributes": [_attr(k, v) for k, v in args.items()
                               if k != "trace_id"]
                + [_attr("thread.track", e.get("tid", 0))]})
        return {"resourceSpans": [{
            "resource": self._resource(),
            "scopeSpans": [{"scope": {"name": "dl4j_tpu.tracing"},
                            "spans": spans}]}]}

    # -- transport -------------------------------------------------------
    def _post(self, path: str, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            self.endpoint + path, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()

    def _item_count(self, payload: dict, signal: str) -> int:
        if signal == "spans":
            return sum(len(ss["spans"])
                       for rs in payload.get("resourceSpans", [])
                       for ss in rs.get("scopeSpans", []))
        return sum(len(sm["metrics"])
                   for rm in payload.get("resourceMetrics", [])
                   for sm in rm.get("scopeMetrics", []))

    def export_now(self) -> Dict[str, str]:
        """One synchronous flush (the thread calls this on cadence; tests
        call it directly).  Never raises."""
        outcomes: Dict[str, str] = {}
        for signal, path, payload in (
                ("metrics", "/v1/metrics", self._metrics_payload()),
                ("spans", "/v1/traces", self._spans_payload())):
            if payload is None:
                outcomes[signal] = "empty"
                continue
            try:
                self._post(path, payload)
                outcomes[signal] = "ok"
            except Exception:
                self._drops().inc(self._item_count(payload, signal),
                                  signal=signal)
                outcomes[signal] = "error"
            self._exports().inc(signal=signal, outcome=outcomes[signal])
        return outcomes

    # -- lifecycle -------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.export_now()

    def start(self) -> "OtlpExporter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="otlp-exporter", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None


_EXPORTER: Optional[OtlpExporter] = None
_EXPORTER_LOCK = threading.Lock()


def otlp_exporter() -> Optional[OtlpExporter]:
    return _EXPORTER


def set_otlp_exporter(e: Optional[OtlpExporter]) -> Optional[OtlpExporter]:
    global _EXPORTER
    with _EXPORTER_LOCK:
        prev, _EXPORTER = _EXPORTER, e
    return prev


def ensure_otlp_exporter(start: bool = True) -> Optional[OtlpExporter]:
    """Create (and start) the global exporter from ``DL4J_TPU_OTLP_*``
    env knobs; returns None when no endpoint is configured."""
    global _EXPORTER
    endpoint = os.environ.get(_ENV_ENDPOINT, "").strip()
    with _EXPORTER_LOCK:
        if _EXPORTER is None:
            if not endpoint:
                return None
            raw = os.environ.get(_ENV_INTERVAL, "")
            try:
                interval = float(raw or 10.0)
            except ValueError:
                interval = 10.0
            _EXPORTER = OtlpExporter(endpoint, interval=interval)
        e = _EXPORTER
    if start:
        e.start()
    return e
