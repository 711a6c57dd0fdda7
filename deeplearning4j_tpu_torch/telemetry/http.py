"""Shared GET routing for the observability endpoints — the port of
``deeplearning4j_tpu/telemetry/http.py``.

``InferenceServer`` and ``JsonModelServer`` expose the same observability
surfaces through this one function, so status codes and content types
cannot drift between handlers.  ``/metrics/federated`` and
``/v1/runs/<runId>/timeline`` need ``telemetry.federation`` and
``telemetry.runlog``, which wait for ROADMAP A12: they answer 501 with a
JSON error naming it.
"""
from __future__ import annotations

import json
import urllib.parse
from typing import Optional, Tuple

__all__ = ["observability_route", "PROMETHEUS_CTYPE"]

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


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
    - ``/metrics/federated``, ``/v1/runs/<runId>/timeline`` — 501, waiting
      for ROADMAP A12.
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
    if path == "/metrics/federated":
        return _json(501, {"error": "federation waits for ROADMAP A12 in "
                                    "the PyTorch port"})
    parts = urllib.parse.urlparse(path).path.split("/")
    if len(parts) == 5 and parts[1:3] == ["v1", "runs"] and parts[3] \
            and parts[4] == "timeline":
        return _json(501, {"error": "run timelines wait for ROADMAP A12 "
                                    "in the PyTorch port"})
    if path == "/metrics":
        return (200, get_registry().exposition().encode("utf-8"),
                PROMETHEUS_CTYPE)
    if path == "/healthz":
        return _json(200, health_summary())
    return None
