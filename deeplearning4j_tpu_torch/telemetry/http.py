"""Shared GET routing for the observability endpoints — the port of
``deeplearning4j_tpu/telemetry/http.py``.

``InferenceServer`` and ``JsonModelServer`` expose the same observability
surfaces — ``/metrics``, ``/metrics/federated``, ``/metrics/query``,
``/healthz``, ``/v1/requests/<traceId>``, ``/v1/runs/<runId>/timeline`` —
through this one function, so status codes, content types and the
federation hint text cannot drift between handlers.
"""
from __future__ import annotations

import json
import urllib.parse
from typing import Optional, Tuple

__all__ = ["observability_route", "PROMETHEUS_CTYPE"]

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


_FEDERATION_HINT = ("federation unconfigured: set DL4J_TPU_TELEMETRY_DIR or "
                    "call telemetry.set_federation_dir(runDir)")


def _json(status: int, doc) -> Tuple[int, bytes, str]:
    return status, json.dumps(doc).encode("utf-8"), "application/json"


def observability_route(path: str) -> Optional[Tuple[int, bytes, str]]:
    """Resolve an observability GET.  Returns ``(status, body, ctype)``,
    or None when ``path`` is not an observability endpoint (the server's
    own routing continues):

    - ``/metrics`` — this process's registry, Prometheus text;
    - ``/healthz`` — liveness JSON (uptime, last-step age, firing alert
      count, replica health);
    - ``/metrics/query?metric=...&fn=rate|increase|latest`` — windowed
      queries over the in-process retention ring
      (:mod:`~deeplearning4j_tpu_torch.telemetry.timeseries`);
    - ``/v1/requests/<traceId>`` — one request's lifecycle timeline from
      the :class:`~deeplearning4j_tpu_torch.telemetry.context.
      TimelineStore`;
    - ``/metrics/federated`` — every worker snapshot in the configured
      run dir merged (counters summed, gauges/histograms host-labeled);
      404 with a configuration hint when federation is unconfigured;
    - ``/v1/runs/<runId>/timeline`` — one training run's causally
      ordered cross-host fleet timeline, merged from the per-host NDJSON
      files in the federation run dir
      (:meth:`~deeplearning4j_tpu_torch.telemetry.federation.
      TelemetryAggregator.timeline`); filterable with
      ``?kind=ckpt.rollback&generation=3&step_min=100&step_max=200``
      (``kind`` repeatable).
    """
    from deeplearning4j_tpu_torch.telemetry.health import health_summary
    from deeplearning4j_tpu_torch.telemetry.registry import get_registry
    if path.startswith("/metrics/query"):
        from deeplearning4j_tpu_torch.telemetry.timeseries import retention
        ring = retention()
        if ring is None:
            return _json(503, {
                "error": "retention ring not running: start an "
                "InferenceServer or call telemetry.timeseries."
                "ensure_retention()"})
        qs = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
        return _json(*ring.http_query({k: v[-1] for k, v in qs.items()}))
    if path.startswith("/v1/requests/"):
        from deeplearning4j_tpu_torch.telemetry.context import \
            timeline_store
        trace_id = path[len("/v1/requests/"):].split("?", 1)[0]
        got = timeline_store().get(trace_id) if trace_id else None
        if got is None:
            return _json(404, {
                "error": "unknown trace id (evicted or never seen)",
                "trace_id": trace_id})
        return _json(200, got)
    if path.startswith("/v1/runs/"):
        from deeplearning4j_tpu_torch.telemetry.federation import (
            TelemetryAggregator, get_federation_dir)
        parsed = urllib.parse.urlparse(path)
        parts = parsed.path.split("/")
        # /v1/runs/<runId>/timeline -> ["", "v1", "runs", runId, "timeline"]
        if len(parts) != 5 or parts[4] != "timeline" or not parts[3]:
            return None
        run_id = parts[3]
        run_dir = get_federation_dir()
        if run_dir is None:
            return _json(404, {"error": _FEDERATION_HINT})
        qs = urllib.parse.parse_qs(parsed.query)

        def _int(name):
            vals = qs.get(name)
            try:
                return int(vals[-1]) if vals else None
            except ValueError:
                return None

        events = TelemetryAggregator(run_dir).timeline(
            run_id, kinds=qs.get("kind") or None,
            generation=_int("generation"),
            step_min=_int("step_min"), step_max=_int("step_max"))
        if not events and not any(
                e.get("run") == run_id for e in
                TelemetryAggregator(run_dir).timeline()):
            return _json(404, {
                "error": "unknown run id (no timeline events recorded "
                "for it in the federation run dir)", "run_id": run_id})
        hosts = sorted({e.get("host") for e in events if e.get("host")})
        return _json(200, {"run_id": run_id, "hosts": hosts,
                           "count": len(events), "events": events})
    if path == "/metrics":
        return (200, get_registry().exposition().encode("utf-8"),
                PROMETHEUS_CTYPE)
    if path == "/metrics/federated":
        from deeplearning4j_tpu_torch.telemetry.federation import \
            federated_exposition
        text = federated_exposition()
        if text is None:
            return _json(404, {"error": _FEDERATION_HINT})
        return 200, text.encode("utf-8"), PROMETHEUS_CTYPE
    if path == "/healthz":
        return _json(200, health_summary())
    return None
