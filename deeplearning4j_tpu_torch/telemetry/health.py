"""Watchdog alerting over registry values: declarative rules + monitor —
the port of ``deeplearning4j_tpu/telemetry/health.py``, the part the
serving tier needs.

- :class:`AlertRule` / :class:`ThresholdRule` — conditions evaluated
  against the process-global registry (admission control's shed rules are
  ``ThresholdRule``s; ``ReplicaSet.armAutoscale`` registers one);
- :class:`HealthMonitor` — evaluates rules on an interval, logs
  firing/resolved transitions as JSON lines, mirrors them into
  ``dl4j_tpu_health_alerts_firing`` / ``dl4j_tpu_health_alert_state`` and
  dispatches the actions registered on each edge (:meth:`HealthMonitor.
  registerAction`, how ``ReplicaSet.armAutoscale`` scales);
- :func:`health_summary` — the ``/healthz`` liveness JSON;
- :func:`recsys_hash_collision_rule` — the recommender tier's hashed-id
  collision alert.

Wait for ROADMAP A12: the training rules (``TrainingStallRule``,
``ReplicaStragglerRule``, ``EtlStarvationRule``,
``DivergencePrecursorRule``, ``default_rules``), webhook delivery and
federated evaluation (both raise naming A12), and the run tags the
reference stamps on each event line (``telemetry.runlog``).  The OTLP
block of ``/healthz`` is absent, as the reference's is when no exporter
runs.  All rules take an explicit ``now`` so tests drive time
deterministically.
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                         get_registry)

__all__ = ["AlertRule", "ThresholdRule", "HealthMonitor", "health_summary",
           "recsys_hash_collision_rule"]

_process_start = time.time()


def host_id() -> str:
    """This process's identity on event-log lines: ``DL4J_TPU_HOST_ID``, or
    ``<hostname>-<pid>`` (the reference's ``federation.host_id``)."""
    return os.environ.get("DL4J_TPU_HOST_ID") or \
        f"{socket.gethostname()}-{os.getpid()}"


class AlertRule:
    """One watchdog condition.  ``evaluate`` returns a human-readable
    detail string while the condition holds, None while it doesn't; the
    monitor turns edges of that into firing/resolved events.  Rules keep
    their own state (last counter value, first-seen-zero time) — they are
    single-monitor objects, not shareable constants."""

    name = "alert"

    def evaluate(self, registry: MetricsRegistry,
                 now: float) -> Optional[str]:
        raise NotImplementedError


class ThresholdRule(AlertRule):
    """Generic: fire while ``metric <op> threshold`` (op in <, >, <=, >=).
    The escape hatch for run-specific conditions the built-ins don't
    cover — e.g. loss ceilings exported as gauges."""

    _OPS = {"<": lambda a, b: a < b, ">": lambda a, b: a > b,
            "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b}

    def __init__(self, name: str, metric: str, op: str, threshold: float,
                 **labels):
        if op not in self._OPS:
            raise ValueError(f"op must be one of {sorted(self._OPS)}")
        self.name = name
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.labels = labels

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        try:
            v = m.value(**self.labels)
        except (ValueError, AttributeError):
            return None
        if self._OPS[self.op](v, self.threshold):
            return (f"{self.metric}{self.labels or ''} = {v:g} "
                    f"{self.op} {self.threshold:g}")
        return None


def _total_value(metric) -> float:
    """Sum over every label set (label-less metrics: the single cell)."""
    try:
        return sum(float(v) for _k, v in metric.data().get("cells", []))
    except (TypeError, ValueError):
        return 0.0


def recsys_hash_collision_rule(threshold: float = 1.0) -> ThresholdRule:
    """Fire when the :class:`~deeplearning4j_tpu_torch.datavec.pipeline.
    RaggedFeatureReader` sampled estimator has observed ``threshold``
    or more distinct raw ids sharing a hashed embedding row.  Hash
    collisions never error — two users silently share an embedding and
    ranking quality degrades — so the counter (and this rule) is the
    only way the condition pages anyone before an offline metric
    drifts."""
    return ThresholdRule("recsys_hash_collision",
                         "dl4j_tpu_recsys_hash_collisions_total", ">=",
                         threshold)


class HealthMonitor:
    """Daemon watchdog: evaluates rules on an interval, logs transitions.

    The event log is JSON Lines — each line
    ``{"ts", "host", "rule", "state", "detail"}`` with ``state`` one of
    ``firing``/``resolved``/``event``/``action`` (``event`` lines come from
    :meth:`note`).  Everything is also visible to scrapes:
    ``dl4j_tpu_health_alerts_firing`` counts currently-firing rules,
    ``dl4j_tpu_health_alert_state{rule=}`` holds each rule's 0/1, and
    ``dl4j_tpu_health_alert_transitions_total`` counts edges.
    ``evaluate_once(now=...)`` drives the same logic deterministically for
    tests (no thread, no sleeps).

    ``rules=None`` watches nothing: the reference's default training rules
    wait for ROADMAP A12, and so do ``federated=True`` and ``webhookUrl``,
    which raise naming it."""

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 interval: float = 5.0,
                 eventLogPath: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 federated: bool = False,
                 webhookUrl: Optional[str] = None):
        if federated:
            raise NotImplementedError(
                "federated health evaluation waits for ROADMAP A12 "
                "(telemetry.federation)")
        if webhookUrl is not None:
            raise NotImplementedError(
                "alert webhook delivery waits for ROADMAP A12")
        self.rules = list(rules) if rules is not None else []
        self.interval = float(interval)
        self._eventLogPath = eventLogPath
        self._registry = registry
        self.firing: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log_lock = threading.Lock()
        # alert -> action remediations, dispatched on the named rule's
        # firing or resolved edge (see registerAction)
        self._actions: Dict[str, List] = {}
        self._actions_lock = threading.Lock()

    @property
    def eventLogPath(self) -> str:
        # resolved lazily: the launcher may set DL4J_TPU_TELEMETRY_DIR
        # after this monitor is constructed
        if self._eventLogPath is not None:
            return self._eventLogPath
        base = os.environ.get("DL4J_TPU_TELEMETRY_DIR") or \
            tempfile.gettempdir()
        return os.path.join(base, f"health_events_{os.getpid()}.jsonl")

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else \
            get_registry()

    # -- event log -------------------------------------------------------
    def _append(self, record: dict) -> None:
        """Append one JSON line; never raises (an unwritable log must not
        kill the watchdog)."""
        try:
            line = json.dumps(record, default=str)
            with self._log_lock:
                os.makedirs(os.path.dirname(self.eventLogPath) or ".",
                            exist_ok=True)
                with open(self.eventLogPath, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
        except Exception:
            pass

    def note(self, event: str, **details) -> None:
        """Structured non-rule event — same log, ``state: "event"``."""
        self._append({"ts": time.time(), "host": host_id(), "rule": event,
                      "state": "event", "detail": details})

    # -- evaluation ------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> Dict[str, str]:
        """One evaluation pass over every rule; returns the currently
        firing {rule: detail} map.  ``now`` is monotonic-clock seconds
        (tests pass explicit values to step time forward)."""
        if now is None:
            now = time.monotonic()
        reg = self._reg()
        state_g = reg.gauge(
            "dl4j_tpu_health_alert_state",
            "1 while the named watchdog rule is firing, else 0",
            labelnames=("rule",))
        for rule in self.rules:
            try:
                detail = rule.evaluate(reg, now)
            except Exception as e:
                # a broken rule is an alert about the watchdog, not a
                # watchdog crash
                detail = None
                self._append({"ts": time.time(), "host": host_id(),
                              "rule": rule.name, "state": "rule_error",
                              "detail": f"{type(e).__name__}: {e}"})
            was = rule.name in self.firing
            if detail is not None and not was:
                self.firing[rule.name] = detail
                self._transition(rule.name, "firing", detail)
            elif detail is None and was:
                prev = self.firing.pop(rule.name)
                self._transition(rule.name, "resolved", prev)
            elif detail is not None:
                self.firing[rule.name] = detail    # refresh detail
            state_g.set(1.0 if rule.name in self.firing else 0.0,
                        rule=rule.name)
        reg.gauge("dl4j_tpu_health_alerts_firing",
                  "Watchdog alert rules currently firing").set(
                      len(self.firing))
        return dict(self.firing)

    def _transition(self, rule: str, state: str, detail: str) -> None:
        self._append({"ts": time.time(), "host": host_id(), "rule": rule,
                      "state": state, "detail": detail})
        self._reg().counter(
            "dl4j_tpu_health_alert_transitions_total",
            "Watchdog firing/resolved edges",
            labelnames=("rule", "state")).inc(rule=rule, state=state)
        if state in ("firing", "resolved"):
            self._dispatchActions(rule, detail, state)

    # -- alert -> action remediations ------------------------------------
    def registerAction(self, rule: str, action,
                       on: str = "firing") -> None:
        """Register a remediation for ``rule``: ``action(rule, detail)``
        runs on the chosen transition edge — ``on="firing"`` (the
        default) or ``on="resolved"`` — once per transition, not per
        refresh, on the evaluating thread.  Resolved-edge actions are
        how a remediation UNWINDS when the condition clears (e.g. the
        serving queue-depth rule scales replica fan-out up on firing and
        back down on resolved).  The action returns a short outcome
        string (logged as an ``action`` event) or None for "not
        applicable".  Actions must be quick and thread-safe —
        heavyweight work should set a flag the owning loop consumes (see
        ``PrefetchingDataSetIterator.requestRestart``)."""
        if on not in ("firing", "resolved"):
            raise ValueError(f"on must be 'firing' or 'resolved', "
                             f"got {on!r}")
        with self._actions_lock:
            self._actions.setdefault(str(rule), []).append((action, on))

    def unregisterAction(self, rule: str, action=None) -> None:
        """Remove ``action`` for ``rule`` on every edge (all of the
        rule's actions when ``action`` is None)."""
        with self._actions_lock:
            if action is None:
                self._actions.pop(str(rule), None)
                return
            lst = self._actions.get(str(rule), [])
            self._actions[str(rule)] = [(a, on) for a, on in lst
                                        if a is not action]

    def _dispatchActions(self, rule: str, detail: str,
                         state: str = "firing") -> None:
        with self._actions_lock:
            actions = [a for a, on in self._actions.get(rule, ())
                       if on == state]
        if not actions:
            return
        counter = self._reg().counter(
            "dl4j_tpu_health_actions_total",
            "Remediation actions dispatched on alert firing/resolved "
            "edges, by rule and outcome (ok / noop / failed)",
            labelnames=("rule", "outcome"))
        for action in actions:
            name = getattr(action, "__name__", type(action).__name__)
            try:
                result = action(rule, detail)
                outcome = "noop" if result is None else "ok"
                note = result or "not applicable"
            except Exception as e:
                # a broken remediation is an alert about the remediation,
                # never a watchdog crash (same contract as rule errors)
                outcome = "failed"
                note = f"{type(e).__name__}: {e}"
            counter.inc(rule=rule, outcome=outcome)
            self._append({"ts": time.time(), "host": host_id(),
                          "rule": rule, "state": "action",
                          "detail": {"action": name, "outcome": outcome,
                                     "note": note}})

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "HealthMonitor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval):
                    self.evaluate_once()

            self._thread = threading.Thread(
                target=loop, name="telemetry-health-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread and RESOLVE anything still firing: a stopped
        watchdog can't claim alerts are active, and a run that just ended
        (the usual caller) makes 'training stalled' vacuously stale.  The
        firing history stays in the event log and transition counters."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.firing:
            reg = self._reg()
            state_g = reg.gauge(
                "dl4j_tpu_health_alert_state",
                "1 while the named watchdog rule is firing, else 0",
                labelnames=("rule",))
            for rule in list(self.firing):
                self.firing.pop(rule)
                self._transition(rule, "resolved", "watchdog stopped")
                state_g.set(0.0, rule=rule)
        reg = self._reg()
        g = reg.get("dl4j_tpu_health_alerts_firing")
        if g is not None:
            g.set(0.0)

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


# -- /healthz ------------------------------------------------------------

_progress_lock = threading.Lock()
# keyed to the registry OBJECT: a swapped/cleared registry (new run in
# the same serving process, tests) must restart the age clock even when
# the new run coincidentally reaches the same step total
_progress = {"registry": None, "value": None, "t": None}


def health_summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """Liveness JSON for ``/healthz``: uptime, seconds since the step
    counter last moved (null before the first step), and the firing alert
    count.  Self-contained — works with or without a HealthMonitor (the
    last-step age is tracked across calls right here, so the first scrape
    after a stall already shows a growing age)."""
    reg = registry if registry is not None else get_registry()
    now = time.monotonic()
    steps = reg.get("dl4j_tpu_train_steps_total")
    total = _total_value(steps) if steps is not None else None
    last_step_age = None
    with _progress_lock:
        if _progress["registry"] is not reg:
            _progress.update(registry=reg, value=None, t=None)
        if total is not None and total > 0:
            if _progress["value"] != total:
                _progress["value"], _progress["t"] = total, now
            last_step_age = now - _progress["t"]
    firing = reg.get("dl4j_tpu_health_alerts_firing")
    n_firing = int(firing.value()) if firing is not None else 0
    out = {"status": "alerting" if n_firing else "ok",
           "uptime_seconds": round(time.time() - _process_start, 3),
           "steps_total": total,
           "last_step_age_seconds": None if last_step_age is None
           else round(last_step_age, 3),
           "firing_alerts": n_firing,
           "pid": os.getpid()}
    # serving replica health, when a ReplicaSet's prober publishes it:
    # {model: {replica: 0|1}} — the scrape an operator (or a
    # blue/green rollout script) reads before trusting a route
    health = reg.get("dl4j_tpu_serving_replica_health")
    if health is not None:
        d = health.data()
        names = d["labelnames"]
        byModel: dict = {}
        for labelvalues, value in d["cells"]:
            cell = dict(zip(names, labelvalues))
            byModel.setdefault(cell.get("model", ""), {})[
                cell.get("replica", "")] = int(value)
        if byModel:
            out["replica_health"] = byModel
    # observability side-car: is /metrics/query live
    from deeplearning4j_tpu_torch.telemetry.timeseries import retention
    ring = retention()
    out["retention"] = None if ring is None else {
        "window_seconds": ring.window, "interval_seconds": ring.interval,
        "samples": ring.sample_count()}
    return out
