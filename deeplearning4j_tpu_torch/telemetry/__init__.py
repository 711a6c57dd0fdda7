"""Telemetry the serving tier reports through — the port of the
``deeplearning4j_tpu/telemetry`` modules that ``remote/`` needs, pure
Python (no device code), so each is a copy or a cut of the reference's:

- :mod:`.registry` — counters/gauges/histograms with labels, thread-safe,
  process-global; Prometheus text exposition served from ``/metrics``;
- :mod:`.tracing` — span tracer (Chrome trace events);
- :mod:`.flight` — ring of crash records;
- :mod:`.context` — W3C trace context and the per-request timeline store
  behind ``/v1/requests/<traceId>``;
- :mod:`.health` — ``ThresholdRule``, ``HealthMonitor`` (alert → action
  remediations), ``/healthz``;
- :mod:`.timeseries` — the retention ring behind ``/metrics/query``;
- :mod:`.instrument` — ``ServingMetrics``, latency exemplars and the ETL
  namespace (``EtlMetrics``, ``note_etl_wait``) DataVec reports through;
- :mod:`.http` — the shared observability GET routing.

Federation, export, OTLP, the run log and the training instruments wait
for ROADMAP A12.  Metric names are the reference's letter for letter:
``dl4j_tpu_<subsystem>_<name>``, counters ending ``_total``.
"""
from deeplearning4j_tpu_torch.telemetry.context import (  # noqa: F401
    RequestContext, TimelineStore, current_context, parse_traceparent,
    request_context, set_timeline_store, timeline_store)
from deeplearning4j_tpu_torch.telemetry.flight import (  # noqa: F401
    FlightRecorder, flight_recorder, set_flight_recorder)
from deeplearning4j_tpu_torch.telemetry.health import (  # noqa: F401
    AlertRule, HealthMonitor, ThresholdRule, health_summary)
from deeplearning4j_tpu_torch.telemetry.instrument import (  # noqa: F401
    EtlMetrics, etl_metrics, note_etl_wait, ServingMetrics, clear_exemplars, exemplar_for, latency_exemplars,
    observe_exemplar, serving_metrics)
from deeplearning4j_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    get_registry, set_registry)
from deeplearning4j_tpu_torch.telemetry.timeseries import (  # noqa: F401
    MetricsRetention, ensure_retention, retention, set_retention)
from deeplearning4j_tpu_torch.telemetry.tracing import (  # noqa: F401
    Tracer, device_trace_active, set_device_trace_active, set_tracer,
    tracer)
