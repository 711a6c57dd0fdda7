"""Watchdog alerting over registry values: declarative rules + monitor —
the port of ``deeplearning4j_tpu/telemetry/health.py`` (pure Python,
copied, so both packages fire the same rules on the same registry states
and write the same event lines).

Metrics nobody watches are a dashboard, not observability.  Awan et al.
(arXiv:1810.11112) characterize distributed DNN training as dominated at
scale by stragglers and communication stalls — conditions that are
*silent* in per-process logs and only visible as relationships between
registry values over time.  :class:`HealthMonitor` is the thread that
watches those relationships:

- **declarative rules** (:class:`AlertRule` subclasses) evaluated every
  ``interval`` seconds against the process-global registry;
- **firing/resolved transitions** appended as JSON lines to a structured
  event log (one object per line — ``jq``-able, tail-able) and mirrored
  into two metrics: ``dl4j_tpu_health_alerts_firing`` (count, the
  pager-feed gauge) and ``dl4j_tpu_health_alert_state{rule=...}`` (0/1
  per rule, which the federation layer tags per host);
- a :func:`health_summary` liveness snapshot served at ``/healthz``.

Built-in rules (see :func:`default_rules`): training stall (step counter
frozen), replica straggler (per-replica step gauge vs. the median), ETL
starvation (prefetch queue pinned empty while the producer lives), and
divergence precursor (NaN-rollback counter rising).  All rules take an
explicit ``now`` so tests drive time deterministically — no sleeps.
"""
from __future__ import annotations

import json
import os
import queue as _queue
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                         get_registry)

__all__ = ["AlertRule", "ThresholdRule", "TrainingStallRule",
           "ReplicaStragglerRule", "EtlStarvationRule",
           "DivergencePrecursorRule", "HealthMonitor", "default_rules",
           "health_summary", "recsys_hash_collision_rule"]

_process_start = time.time()


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


class TrainingStallRule(AlertRule):
    """No step-counter progress for ``timeout`` seconds.

    Arms only once the counter is nonzero — a job still compiling its
    first step (or a coordinator that never trains) must not page as
    stalled; resolves the moment the counter moves again."""

    name = "training_stall"

    def __init__(self, timeout: float = 120.0,
                 counter: str = "dl4j_tpu_train_steps_total"):
        self.timeout = float(timeout)
        self.counter = counter
        self._last_value: Optional[float] = None
        self._last_change: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.counter)
        if m is None:
            return None
        v = _total_value(m)
        if self._last_value is None or v != self._last_value:
            self._last_value, self._last_change = v, now
            return None
        if v <= 0:
            return None
        stalled = now - self._last_change
        if stalled >= self.timeout:
            return (f"no {self.counter} progress for {stalled:.1f}s "
                    f"(threshold {self.timeout:g}s, stuck at {v:g})")
        return None


class ReplicaStragglerRule(AlertRule):
    """Any replica's step-time gauge above ``ratio`` × the median replica.

    Under lockstep GSPMD every replica of ONE process publishes the same
    time, so within a single local registry this cannot fire — the
    divergence it hunts lives across hosts.  Run it on a coordinator's
    ``HealthMonitor(federated=True)``, where the evaluated registry is
    the merged federated view and each host's gauge is a separate
    ``host``-labeled cell."""

    name = "replica_straggler"

    def __init__(self, ratio: float = 2.0,
                 gauge: str = "dl4j_tpu_parallel_replica_step_seconds"):
        self.ratio = float(ratio)
        self.gauge = gauge

    def evaluate(self, registry, now):
        m = registry.get(self.gauge)
        if m is None:
            return None
        cells = m.data().get("cells", [])
        vals = sorted(float(v) for _k, v in cells)
        if len(vals) < 2:
            return None
        # LOWER median: with an even cell count the midpoint average
        # would include the straggler's own value, making
        # "worst > k*median" unsatisfiable for 2 hosts (w > w+b); the
        # lower median compares the worst against the healthy half
        median = vals[(len(vals) - 1) // 2]
        if median <= 0:
            return None
        worst_key, worst = max(cells, key=lambda kv: float(kv[1]))
        if float(worst) > self.ratio * median:
            return (f"replica {'/'.join(worst_key)} step time "
                    f"{float(worst):.4g}s > {self.ratio:g}x median "
                    f"{median:.4g}s")
        return None


class EtlStarvationRule(AlertRule):
    """A consumer BLOCKED on an empty prefetch queue for ``forSeconds``
    while the producer thread is still alive
    (``dl4j_tpu_etl_producer_active``) — the input pipeline can't keep up
    with the device loop.  Keys on ``dl4j_tpu_etl_consumers_waiting``
    (live for the duration of the block) rather than the queue-depth
    gauge, which goes STALE between consumer polls: a loop stuck in a
    minutes-long XLA compile would otherwise read as "pinned at 0" and
    false-page.  A drained epoch end (producer exited) must NOT fire."""

    name = "etl_starvation"

    def __init__(self, forSeconds: float = 30.0,
                 gauge: str = "dl4j_tpu_etl_consumers_waiting"):
        self.forSeconds = float(forSeconds)
        self.gauge = gauge
        self._waiting_since: Optional[float] = None

    def evaluate(self, registry, now):
        waiting = registry.get(self.gauge)
        if waiting is None or _total_value(waiting) <= 0:
            self._waiting_since = None
            return None
        active = registry.get("dl4j_tpu_etl_producer_active")
        if active is not None and _total_value(active) <= 0:
            self._waiting_since = None     # clean drain, not starvation
            return None
        if self._waiting_since is None:
            self._waiting_since = now
            return None
        blocked = now - self._waiting_since
        if blocked >= self.forSeconds:
            return (f"consumer blocked {blocked:.1f}s on an empty "
                    f"prefetch queue with a live producer (threshold "
                    f"{self.forSeconds:g}s)")
        return None


class DivergencePrecursorRule(AlertRule):
    """NaN-rollback counter rising: fires on any increase, stays firing
    until ``quietSeconds`` pass with no further rollback (the supervisor
    is coping, but someone should look before maxRollbacks runs out)."""

    name = "divergence_precursor"

    def __init__(self, quietSeconds: float = 300.0,
                 counter: str = "dl4j_tpu_fault_nan_rollbacks_total"):
        self.quietSeconds = float(quietSeconds)
        self.counter = counter
        self._last_value: Optional[float] = None
        self._last_rise: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.counter)
        if m is None:
            return None
        v = _total_value(m)
        if self._last_value is None:
            self._last_value = v
            return None
        if v > self._last_value:
            self._last_value, self._last_rise = v, now
        elif v < self._last_value:
            # counter reset (a federated worker restarted and re-zeroed
            # its share of the sum): re-baseline so the NEXT rollback
            # still reads as a rise instead of hiding under the old max
            self._last_value = v
        if self._last_rise is not None and \
                now - self._last_rise < self.quietSeconds:
            return (f"{self.counter} rose to {v:g} "
                    f"{now - self._last_rise:.1f}s ago")
        return None


def _total_value(metric) -> float:
    """Sum over every label set (label-less metrics: the single cell)."""
    try:
        return sum(float(v) for _k, v in metric.data().get("cells", []))
    except (TypeError, ValueError):
        return 0.0


def default_rules(stallTimeout: float = 120.0, stragglerRatio: float = 2.0,
                  starvationSeconds: float = 30.0,
                  divergenceQuietSeconds: float = 300.0
                  ) -> List[AlertRule]:
    """The four conditions every supervised run should watch: stall,
    straggler, ETL starvation, divergence precursor."""
    return [TrainingStallRule(timeout=stallTimeout),
            ReplicaStragglerRule(ratio=stragglerRatio),
            EtlStarvationRule(forSeconds=starvationSeconds),
            DivergencePrecursorRule(quietSeconds=divergenceQuietSeconds)]


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
    ``firing``/``resolved``/``event`` (``event`` lines come from
    :meth:`note`, the supervisor's rollback/restore hook).  Everything is
    also visible to scrapes: ``dl4j_tpu_health_alerts_firing`` counts
    currently-firing rules, ``dl4j_tpu_health_alert_state{rule=}`` holds
    each rule's 0/1, and ``dl4j_tpu_health_alert_transitions_total``
    counts edges.  ``evaluate_once(now=...)`` drives the same logic
    deterministically for tests (no thread, no sleeps).

    ``federated=True`` makes a COORDINATOR's monitor evaluate its rules
    against the merged federated registry (every worker snapshot in the
    configured run dir + this process's live registry) instead of the
    local one — the only place cross-host conditions like a replica
    straggler are visible (each host's gauge is a separate
    ``host``-labeled cell there).  Alert-state metrics still land in the
    LOCAL registry, so they export/federate normally."""

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 interval: float = 5.0,
                 eventLogPath: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 federated: bool = False,
                 webhookUrl: Optional[str] = None,
                 webhookTimeout: float = 2.0, webhookRetries: int = 3,
                 webhookBackoff: float = 0.1, webhookQueueSize: int = 256):
        self.rules = list(rules) if rules is not None else default_rules()
        self.interval = float(interval)
        self._eventLogPath = eventLogPath
        self._registry = registry
        self.federated = bool(federated)
        self.firing: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log_lock = threading.Lock()
        # alert -> action remediations: callables dispatched on the
        # FIRING edge of the named rule (see registerAction) — the
        # self-healing half of the ops loop
        self._actions: Dict[str, List] = {}
        self._actions_lock = threading.Lock()
        # webhook alert delivery: firing/resolved transitions POST to
        # webhookUrl from a dedicated sender thread — the watchdog only
        # ever enqueues (put_nowait), so a dead endpoint can delay
        # deliveries, never rule evaluation
        self.webhookUrl = webhookUrl
        self.webhookTimeout = float(webhookTimeout)
        self.webhookRetries = max(1, int(webhookRetries))
        self.webhookBackoff = float(webhookBackoff)
        self._whQ: Optional[_queue.Queue] = None
        self._whQueueSize = int(webhookQueueSize)
        self._whStop = threading.Event()
        self._whThread: Optional[threading.Thread] = None

    @property
    def eventLogPath(self) -> str:
        # resolved lazily like FlightRecorder.dumpDir: the launcher may
        # configure the run dir (set_federation_dir or the env var) after
        # this monitor is constructed — the alerts belong next to the
        # metric snapshots the operator is already tailing
        if self._eventLogPath is not None:
            return self._eventLogPath
        from deeplearning4j_tpu_torch.telemetry.federation import \
            get_federation_dir
        base = get_federation_dir() or tempfile.gettempdir()
        return os.path.join(base, f"health_events_{os.getpid()}.jsonl")

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else \
            get_registry()

    # -- event log -------------------------------------------------------
    def _append(self, record: dict) -> None:
        """Append one JSON line; never raises (an unwritable log must not
        kill the watchdog, let alone the training it watches)."""
        try:
            line = json.dumps(record, default=str)
            with self._log_lock:
                os.makedirs(os.path.dirname(self.eventLogPath) or ".",
                            exist_ok=True)
                with open(self.eventLogPath, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
        except Exception:
            pass

    @staticmethod
    def _run_tags() -> dict:
        """The active run's (run id, mesh generation) — stamped on every
        event-log line and webhook payload so an alert can be JOINED to
        the remesh/generation that caused it.  Empty when no training
        run is active (a bare serving process)."""
        from deeplearning4j_tpu_torch.telemetry.runlog import current_run
        rc = current_run()
        if rc is None:
            return {}
        return {"run": rc.runId, "generation": int(rc.generation)}

    def note(self, event: str, **details) -> None:
        """Structured non-rule event (the supervisor's rollback/restore/
        divergence hooks land here) — same log, ``state: "event"``."""
        from deeplearning4j_tpu_torch.telemetry.federation import host_id
        self._append({"ts": time.time(), "host": host_id(), "rule": event,
                      "state": "event", "detail": details,
                      **self._run_tags()})

    # -- evaluation ------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> Dict[str, str]:
        """One evaluation pass over every rule; returns the currently
        firing {rule: detail} map.  ``now`` is monotonic-clock seconds
        (tests pass explicit values to step time forward)."""
        if now is None:
            now = time.monotonic()
        reg = self._reg()
        eval_reg = reg
        if self.federated:
            from deeplearning4j_tpu_torch.telemetry.federation import (
                TelemetryAggregator, get_federation_dir)
            run_dir = get_federation_dir()
            if run_dir is not None:
                try:
                    eval_reg = TelemetryAggregator(
                        run_dir, localRegistry=reg).merged()
                except Exception:
                    eval_reg = reg      # a torn run dir must not blind
                    # the LOCAL rules too — degrade to local evaluation
        from deeplearning4j_tpu_torch.telemetry.federation import host_id
        state_g = reg.gauge(
            "dl4j_tpu_health_alert_state",
            "1 while the named watchdog rule is firing, else 0",
            labelnames=("rule",))
        for rule in self.rules:
            try:
                detail = rule.evaluate(eval_reg, now)
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
        from deeplearning4j_tpu_torch.telemetry.federation import host_id
        record = {"ts": time.time(), "host": host_id(), "rule": rule,
                  "state": state, "detail": detail, **self._run_tags()}
        self._append(record)
        if state == "firing":
            from deeplearning4j_tpu_torch.telemetry.runlog import record_event
            record_event("health.firing", rule=rule, detail=detail)
        elif state == "resolved":
            from deeplearning4j_tpu_torch.telemetry.runlog import record_event
            record_event("health.resolved", rule=rule, detail=detail)
        self._reg().counter(
            "dl4j_tpu_health_alert_transitions_total",
            "Watchdog firing/resolved edges",
            labelnames=("rule", "state")).inc(rule=rule, state=state)
        self._enqueueWebhook(record)
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
        from deeplearning4j_tpu_torch.telemetry.federation import host_id
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

    # -- webhook delivery ------------------------------------------------
    def _enqueueWebhook(self, record: dict) -> None:
        """Hand a transition to the sender thread.  NEVER blocks: a full
        queue (endpoint down for a long time) drops the oldest-undelivered
        semantics in favor of protecting the watchdog — drops are counted
        in ``dl4j_tpu_health_webhook_dropped_total``."""
        if self.webhookUrl is None:
            return
        self._ensureSender()
        try:
            self._whQ.put_nowait(record)
        except _queue.Full:
            self._reg().counter(
                "dl4j_tpu_health_webhook_dropped_total",
                "Alert webhook payloads dropped because the delivery "
                "queue was full (endpoint down or too slow)").inc()

    def _ensureSender(self) -> None:
        if self._whThread is not None and self._whThread.is_alive():
            return
        if self._whQ is None:
            self._whQ = _queue.Queue(maxsize=self._whQueueSize)
        self._whStop.clear()
        self._whThread = threading.Thread(
            target=self._webhookLoop, name="telemetry-health-webhook",
            daemon=True)
        self._whThread.start()

    def _webhookLoop(self) -> None:
        while True:
            try:
                record = self._whQ.get(timeout=0.2)
            except _queue.Empty:
                if self._whStop.is_set():
                    return
                continue
            self._deliverWebhook(record)

    def _deliverWebhook(self, record: dict) -> None:
        """One POST with bounded retry + exponential backoff.  Runs on
        the sender thread only; a permanently failing delivery is
        counted and logged to the event file, never raised."""
        import urllib.request
        data = json.dumps(record, default=str).encode("utf-8")
        last = None
        for attempt in range(self.webhookRetries):
            try:
                req = urllib.request.Request(
                    self.webhookUrl, data=data,
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(
                        req, timeout=self.webhookTimeout) as resp:
                    status = getattr(resp, "status", 200)
                    if 200 <= status < 300:
                        self._reg().counter(
                            "dl4j_tpu_health_webhook_deliveries_total",
                            "Alert webhook POSTs by outcome",
                            labelnames=("status",)).inc(status="ok")
                        return
                    last = f"HTTP {status}"
            except Exception as e:
                last = f"{type(e).__name__}: {e}"
            if attempt < self.webhookRetries - 1:
                time.sleep(self.webhookBackoff * (2 ** attempt))
        self._reg().counter(
            "dl4j_tpu_health_webhook_deliveries_total",
            "Alert webhook POSTs by outcome",
            labelnames=("status",)).inc(status="failed")
        from deeplearning4j_tpu_torch.telemetry.federation import host_id
        self._append({"ts": time.time(), "host": host_id(),
                      "rule": record.get("rule"), "state": "webhook_error",
                      "detail": f"delivery failed after "
                                f"{self.webhookRetries} attempts: {last}"})

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
        # drain-then-stop the webhook sender AFTER resolving, so the
        # resolved transitions above still deliver (bounded: each pending
        # payload retries at most webhookRetries times)
        if self._whThread is not None:
            self._whStop.set()
            self._whThread.join(timeout=30.0)
            self._whThread = None

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
    # observability side-cars: is /metrics/query live, and is the OTLP
    # exporter keeping up (drop count is the signal a collector outage
    # leaves behind — the hot path never blocks on it)
    from deeplearning4j_tpu_torch.telemetry.otlp import otlp_exporter
    from deeplearning4j_tpu_torch.telemetry.timeseries import retention
    ring = retention()
    out["retention"] = None if ring is None else {
        "window_seconds": ring.window, "interval_seconds": ring.interval,
        "samples": ring.sample_count()}
    exp = otlp_exporter()
    if exp is not None:
        drops = reg.get("dl4j_tpu_otlp_dropped_total")
        out["otlp"] = {"endpoint": exp.endpoint,
                       "interval_seconds": exp.interval,
                       "dropped_total": _total_value(drops)
                       if drops is not None else 0.0}
    return out
