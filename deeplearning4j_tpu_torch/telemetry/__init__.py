"""Telemetry the serving tier and the training loops report through —
the port of ``deeplearning4j_tpu/telemetry``, pure Python (no device
code), so each module is a copy or a cut of the reference's:

- :mod:`.registry` — counters/gauges/histograms with labels, thread-safe,
  process-global; Prometheus text exposition served from ``/metrics``;
- :mod:`.tracing` — span tracer (Chrome trace events);
- :mod:`.flight` — ring of step and crash records, dumped on a crash;
- :mod:`.context` — W3C trace context and the per-request timeline store
  behind ``/v1/requests/<traceId>``;
- :mod:`.runlog` — one trace id per training run (``RunContext``) and the
  per-host fleet timeline, merged by a hybrid logical clock, behind
  ``/v1/runs/<runId>/timeline``;
- :mod:`.federation` — per-process snapshot writers and the aggregator
  behind ``/metrics/federated`` (counters sum across hosts,
  gauges/histograms gain a ``host`` label);
- :mod:`.health` — the alert rules (``ThresholdRule`` and the four
  training rules of ``default_rules``), ``HealthMonitor`` (alert → action
  remediations, webhook delivery, federated evaluation), ``/healthz``,
  ``recsys_hash_collision_rule``;
- :mod:`.export` — the final snapshot and flight-ring flush on atexit /
  SIGTERM for scrape-less batch jobs;
- :mod:`.otlp` — the OTLP/HTTP JSON exporter of metrics and spans;
- :mod:`.timeseries` — the retention ring behind ``/metrics/query``;
- :mod:`.instrument` — ``ServingMetrics``, latency exemplars, the ETL
  namespace DataVec reports through, the recommender tier's
  (``RecsysMetrics``) and the training instruments (logical steps, the
  supervised and micro-batch scopes, the step-phase histograms);
- :mod:`.http` — the shared observability GET routing.

The mesh, elastic, coordination and AOT-cache instruments wait for
ROADMAP A10 and A12.  Metric names are the reference's letter for letter:
``dl4j_tpu_<subsystem>_<name>``, counters ending ``_total``.
"""
from deeplearning4j_tpu_torch.telemetry.context import (  # noqa: F401
    RequestContext, TimelineStore, current_context, parse_traceparent,
    request_context, set_timeline_store, timeline_store)
from deeplearning4j_tpu_torch.telemetry.export import (  # noqa: F401
    install_export_handlers, uninstall_export_handlers,
    write_final_snapshot)
from deeplearning4j_tpu_torch.telemetry.federation import (  # noqa: F401
    SnapshotWriter, TelemetryAggregator, federated_exposition,
    get_federation_dir, host_id, set_federation_dir)
from deeplearning4j_tpu_torch.telemetry.flight import (  # noqa: F401
    FlightRecorder, flight_recorder, set_flight_recorder)
from deeplearning4j_tpu_torch.telemetry.health import (  # noqa: F401
    AlertRule, DivergencePrecursorRule, EtlStarvationRule, HealthMonitor,
    ReplicaStragglerRule, ThresholdRule, TrainingStallRule, default_rules,
    health_summary, recsys_hash_collision_rule)
from deeplearning4j_tpu_torch.telemetry.instrument import (  # noqa: F401
    STEP_PHASES, EtlMetrics, RecsysMetrics, ServingMetrics,
    StepPhaseMetrics, clear_exemplars, etl_fetch, etl_metrics,
    exemplar_for, in_microbatch, latency_exemplars, microbatch_scope,
    note_etl_wait, observe_exemplar, observe_step_phase, record_crash,
    record_logical_step, recsys_metrics, serving_metrics,
    step_phase_metrics, supervised_scope, train_step_span)
from deeplearning4j_tpu_torch.telemetry.otlp import (  # noqa: F401
    OtlpExporter, ensure_otlp_exporter, otlp_exporter, set_otlp_exporter)
from deeplearning4j_tpu_torch.telemetry.runlog import (  # noqa: F401
    TIMELINE_EVENT_KINDS, FleetTimeline, HybridLogicalClock, RunContext,
    current_run, current_run_id, fleet_timeline, merge_timelines,
    record_event, run_scope, run_span_attrs, set_fleet_timeline)
from deeplearning4j_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    get_registry, set_registry)
from deeplearning4j_tpu_torch.telemetry.timeseries import (  # noqa: F401
    MetricsRetention, ensure_retention, retention, set_retention)
from deeplearning4j_tpu_torch.telemetry.tracing import (  # noqa: F401
    Tracer, device_trace_active, set_device_trace_active, set_tracer,
    tracer)
