"""Fault-tolerant training supervisor — the port of
``deeplearning4j_tpu/fault/supervisor.py``.

:class:`FaultTolerantTrainer` wraps a ``MultiLayerNetwork`` or
``ComputationGraph`` and makes ``fit`` survive the failures we can
enumerate:

- **atomic checkpointing** — every ``checkpointEveryN`` steps through
  :class:`~deeplearning4j_tpu_torch.utils.sharded_checkpoint.
  ShardedCheckpointer` with a sha256 manifest sealed only after the write
  is durable; restore skips a corrupt newest step and falls back to the
  last sealed one.
- **divergence sentinel** — the per-step loss is read and checked for
  NaN/Inf (and an optional ceiling); on divergence the model rolls back to
  the last good checkpoint with learning-rate backoff (``setLrScale``) and
  retries.
- **crash/preemption auto-resume** — re-running the same entrypoint picks
  up from the latest valid step: params/opt-state/counters AND the
  training generator + rnn carries come back from the checkpoint tree,
  the within-epoch position and LR backoff from the manifest metadata.
- **OOM step retry** — a step that dies with the device's out-of-memory
  error (:func:`is_oom_error`) is retried as micro-batches (recursive
  halving up to ``maxMicroBatchSplits``), with step counters kept
  consistent.

A failed step changes nothing: before each attempt the supervisor keeps
the net's pre-step params, updater state, layer state, carries, counters
and generator state (references, no copies — the step assigns new
tensors), and an OOM puts them all back before the halves run.  The
retry runs after the ``except`` block has let go of the exception, so the
failed attempt's activations, which its traceback's frames hold, are
freed first.  The halves are views of the batch on its own device, masks
included.

Every path is exercised deterministically through
:mod:`deeplearning4j_tpu_torch.fault.injection`.

Usage::

    trainer = FaultTolerantTrainer(net, "/ckpts/run1", checkpointEveryN=50)
    trainer.fit(iterator, epochs=10)    # re-run after a kill: auto-resumes

Supervising a ``ParallelWrapper`` (and the mesh-trainer hooks around the
checkpoint), and the elastic re-meshing one layer up, wait for the
parallel layer (ROADMAP A10).
"""
from __future__ import annotations

import contextlib
import gc
import logging
import math
import time
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.fault import injection as _inj
from deeplearning4j_tpu_torch.optimize.listeners import notifyListeners
from deeplearning4j_tpu_torch.telemetry import (DEFAULT_BUCKETS, etl_fetch,
                                                flight_recorder, get_registry,
                                                microbatch_scope,
                                                record_crash,
                                                record_logical_step,
                                                supervised_scope, tracer)
from deeplearning4j_tpu_torch.telemetry.instrument import observe_step_phase
from deeplearning4j_tpu_torch.telemetry.runlog import (FleetTimeline,
                                                       RunContext,
                                                       current_run,
                                                       fleet_timeline,
                                                       record_event,
                                                       run_scope,
                                                       run_span_attrs,
                                                       set_fleet_timeline)
from deeplearning4j_tpu_torch.utils.sharded_checkpoint import \
    ShardedCheckpointer

__all__ = ["FaultTolerantTrainer", "TrainingDivergedError", "is_oom_error"]

log = logging.getLogger(__name__)


class TrainingDivergedError(RuntimeError):
    """Raised when rollback + LR backoff could not restore a finite loss
    within ``maxRollbacks`` attempts."""


def is_oom_error(e: BaseException) -> bool:
    """Device out-of-memory, by type: torch's ``OutOfMemoryError`` (what
    the CUDA caching allocator raises) or the harness's
    :class:`~deeplearning4j_tpu_torch.fault.injection.InjectedOOM`.  Any
    other ``RuntimeError`` is not an OOM, whatever its message says."""
    return isinstance(e, (torch.OutOfMemoryError, _inj.InjectedOOM))


def _split_dataset(ds):
    """Halve a DataSet/MultiDataSet along the batch axis (micro-batch OOM
    retry): views of each array on its own device, masks included.
    Returns a list of two smaller batches."""

    def half(arr, lo, hi):
        if arr is None:
            return None
        return getattr(arr, "torch", arr)[lo:hi]

    if hasattr(ds, "features") and not isinstance(ds.features, (tuple, list)):
        n = ds.features.shape[0]
        mid = n // 2
        cls = type(ds)
        return [cls(half(ds.features, lo, hi), half(ds.labels, lo, hi),
                    half(ds.featuresMask, lo, hi),
                    half(ds.labelsMask, lo, hi))
                for lo, hi in ((0, mid), (mid, n))]
    # MultiDataSet: lists of features/labels (+ per-array masks)
    n = ds.features[0].shape[0]
    mid = n // 2
    cls = type(ds)

    def halves(arrs, lo, hi):
        if not arrs:
            return None
        return [half(a, lo, hi) for a in arrs]

    return [cls(halves(ds.features, lo, hi), halves(ds.labels, lo, hi),
                halves(getattr(ds, "featuresMasks", None) or (), lo, hi),
                halves(getattr(ds, "labelsMasks", None) or (), lo, hi))
            for lo, hi in ((0, mid), (mid, n))]


class _PreStep:
    """The net's state before a step attempt, by reference: the step
    assigns new params/updater/layer-state tensors rather than writing
    into the old ones, so holding the old references is enough to put the
    net back exactly (the generator's state is a 16-byte host copy)."""

    def __init__(self, net):
        self.net = net
        self.params = net.params_
        self.optState = net.optState_
        self.state = dict(net.state_)
        self.rnnCarries = getattr(net, "_rnnCarries", None)
        self.iteration = net.iterationCount
        self.scoreArr = getattr(net, "_scoreArr", None)
        self.score = getattr(net, "_score", None)
        gen = getattr(net, "_fitGen", None)
        self.gen = None if gen is None else gen.get_state()

    def restore(self) -> None:
        net = self.net
        net.params_ = self.params
        net.optState_ = self.optState
        net.state_ = dict(self.state)
        if hasattr(net, "_rnnCarries"):
            net._rnnCarries = self.rnnCarries
        net.iterationCount = self.iteration
        net._scoreArr = self.scoreArr
        if self.score is not None:
            net._score = self.score
        if self.gen is not None:
            net._fitGen.set_state(self.gen)


class FaultTolerantTrainer:
    """Supervised training loop with checkpoint/rollback/resume semantics
    over a ``MultiLayerNetwork`` or ``ComputationGraph``."""

    def __init__(self, model, checkpointDir: str, *,
                 checkpointEveryN: int = 25, keepLast: int = 3,
                 lrBackoff: float = 0.5, maxRollbacks: int = 3,
                 divergenceThreshold: Optional[float] = None,
                 maxMicroBatchSplits: int = 2, resume: bool = True,
                 injector: Optional["_inj.FaultInjector"] = None,
                 healthMonitor=None,
                 durableExport: bool = True,
                 asyncSeal: bool = False,
                 cadenceRestoreSeconds: Optional[float] = 600.0):
        if hasattr(model, "model"):
            raise NotImplementedError(
                "supervising a ParallelWrapper waits for the parallel "
                "layer (ROADMAP A10); pass the net itself")
        self.net = model
        self.ckpt = ShardedCheckpointer(checkpointDir, keepLast=keepLast)
        self.checkpointEveryN = max(1, int(checkpointEveryN))
        self.lrBackoff = float(lrBackoff)
        self.maxRollbacks = int(maxRollbacks)
        self.divergenceThreshold = divergenceThreshold
        self.maxMicroBatchSplits = int(maxMicroBatchSplits)
        self.resume = bool(resume)
        self._injector = injector
        # watchdog integration: a telemetry.HealthMonitor whose event log
        # receives the supervisor's rollback/restore/divergence hooks and
        # whose rules run for the duration of fit() (started there if the
        # caller hasn't already)
        self.healthMonitor = healthMonitor
        # arm the atexit/SIGTERM final-snapshot + flight-ring flush: a
        # supervised batch job that dies unscraped still leaves its
        # counters and crash record on disk
        self.durableExport = bool(durableExport)
        # async manifest sealing: the checkpoint cadence no longer joins
        # the step write (see ShardedCheckpointer.saveWithManifest(block=))
        self.asyncSeal = bool(asyncSeal)
        # rollback-window hysteresis: once the divergence_precursor
        # remediation tightens the checkpoint cadence, the ORIGINAL
        # cadence comes back only after the run has stayed quiet (no
        # new rollbacks, precursor not firing) for this long; None
        # keeps the tightened cadence for the rest of the run
        self.cadenceRestoreSeconds = None if cadenceRestoreSeconds \
            is None else float(cadenceRestoreSeconds)
        self._cadenceOriginal: Optional[int] = None
        self._cadenceQuietSince: Optional[float] = None
        self._cadenceRollbacksSeen = 0
        # the (possibly prefetch-wrapped) iterator of the CURRENT fit
        self._activeIterator = None
        self.lastLoss: Optional[float] = None
        self.stats: Dict[str, Any] = {"rollbacks": 0, "oomSplits": 0,
                                      "resumedFromStep": None,
                                      "checkpoints": 0}

    def _note(self, event: str, **details) -> None:
        """Alert hook: structured event into the watchdog's JSON log (a
        no-op without a monitor — the counters still tell the story)."""
        if self.healthMonitor is not None:
            self.healthMonitor.note(event, **details)

    # -- injection ------------------------------------------------------
    @property
    def injector(self) -> Optional["_inj.FaultInjector"]:
        return self._injector or _inj.get_injector()

    # -- checkpointing --------------------------------------------------
    def _lrScale(self) -> float:
        return float(getattr(self.net, "_lrScale", 1.0))

    def _checkpoint(self, stepInEpoch: int) -> None:
        t0 = time.perf_counter()
        with tracer().span("checkpoint", step=self.net.iterationCount,
                           **run_span_attrs()):
            step = self.ckpt.saveWithManifest(
                self.net, metadata={"stepInEpoch": int(stepInEpoch),
                                    "epoch": int(self.net.epochCount),
                                    "lrScale": self._lrScale()},
                block=not self.asyncSeal)
        dt = time.perf_counter() - t0
        observe_step_phase("checkpoint", dt, step=int(step))
        record_event("ckpt.save", step=int(step), seconds=round(dt, 6),
                     sealed=not self.asyncSeal)
        self.stats["checkpoints"] += 1
        self._maybeRestoreCadence()
        get_registry().counter(
            "dl4j_tpu_fault_checkpoints_total",
            "Sealed checkpoints written by the supervisor").inc()
        inj = self.injector
        if inj is not None:
            inj.after_checkpoint(step, self.ckpt.stepPath(step))

    def _restoreLastGood(self) -> int:
        step = self.ckpt.latestValidStep()
        if step is None:
            raise TrainingDivergedError(
                "divergence before any checkpoint existed — nothing to "
                "roll back to")
        self._timedRestore(step)
        return step

    def _timedRestore(self, step: int) -> None:
        reg = get_registry()
        t0 = time.perf_counter()
        with tracer().span("checkpoint_restore", step=step,
                           **run_span_attrs()):
            self.ckpt.restore(self.net, step=step)
        dt = time.perf_counter() - t0
        reg.histogram("dl4j_tpu_fault_restore_seconds",
                      "Checkpoint restore latency",
                      buckets=DEFAULT_BUCKETS).observe(dt)
        reg.counter("dl4j_tpu_fault_checkpoint_restores_total",
                    "Checkpoint restores (rollback + resume)").inc()
        record_event("ckpt.restore", step=int(step), seconds=round(dt, 6))

    # -- the supervised loop --------------------------------------------
    @contextlib.contextmanager
    def _timelineScope(self):
        """Install the process-global fleet timeline for the run's
        duration: reuse one already installed, else write into the
        federation run dir when configured.  Unconfigured, recording
        stays a no-op and the hot loop pays nothing."""
        tl = fleet_timeline()
        if tl is None:
            from deeplearning4j_tpu_torch.telemetry.federation import \
                get_federation_dir
            runDir = get_federation_dir()
            if runDir:
                tl = FleetTimeline(runDir)
        if tl is None:
            yield
            return
        prev = set_fleet_timeline(tl)
        record_event("run.start", step=int(self.net.iterationCount))
        reason = None
        try:
            yield
        except BaseException as e:
            # a run cut short (a preemption, a divergence it gave up on)
            # says why on its run.end (ROADMAP C34)
            reason = type(e).__name__
            raise
        finally:
            record_event("run.end", step=int(self.net.iterationCount),
                         reason=reason)
            set_fleet_timeline(prev)

    def fit(self, iterator, epochs: int = 1) -> None:
        # one RunContext per training run: every span/timeline event/
        # exemplar below carries its trace id, so the whole run — across
        # restore and rollback — is ONE trace on the OTLP side and ONE
        # timeline under /v1/runs/<id>
        rc = current_run() or RunContext.new()
        with run_scope(rc), self._timelineScope():
            self._fitRun(iterator, epochs)

    def _fitRun(self, iterator, epochs: int = 1) -> None:
        if self.durableExport:
            from deeplearning4j_tpu_torch.telemetry import \
                install_export_handlers
            install_export_handlers()
        # streaming sources engage the producer pool, ALWAYS pinned to
        # one worker under supervision: checkpoints record a mid-epoch
        # position (stepInEpoch) that resume fast-forwards through, so
        # the stream order must be deterministic on BOTH the writing run
        # and the resuming run.  A bare net sees the full stream on every
        # process (no host sharding).
        from deeplearning4j_tpu_torch.datavec.pipeline import maybe_prefetch
        src = iterator
        iterator = maybe_prefetch(iterator, numWorkers=1, hostShard=False,
                                  device=self.net.device)
        owns_monitor = (self.healthMonitor is not None and
                        not self.healthMonitor.is_running())
        if self.healthMonitor is not None:
            # alert -> action: the watchdog doesn't just page for the
            # failures this supervisor can fix itself
            self._registerRemediations(self.healthMonitor)
        if owns_monitor:
            self.healthMonitor.start()
        self._activeIterator = iterator
        try:
            self._fit(iterator, epochs)
        finally:
            self._activeIterator = None
            if iterator is not src:
                iterator.close()
            if self.healthMonitor is not None:
                self._unregisterRemediations(self.healthMonitor)
            if owns_monitor:
                # stop() resolves anything still firing: the run is over,
                # so "training stalled" would be vacuously stale; the
                # firing history survives in the event log and counters
                self.healthMonitor.stop()

    # -- alert -> action remediations -----------------------------------
    def _remediations(self) -> Dict[str, Any]:
        """rule name -> remediation callable, registered on the fit's
        HealthMonitor for the duration of the run."""
        return {"etl_starvation": self._remediateEtlStarvation,
                "divergence_precursor": self._remediateDivergence}

    def _registerRemediations(self, monitor) -> None:
        for rule, action in self._remediations().items():
            monitor.registerAction(rule, action)

    def _unregisterRemediations(self, monitor) -> None:
        for rule, action in self._remediations().items():
            monitor.unregisterAction(rule, action)

    def _remediateEtlStarvation(self, rule: str,
                                detail: str) -> Optional[str]:
        """A starved consumer with a live producer usually means the
        pool is wedged (worker deadlock, stuck decode): request a
        producer-pool restart.  The CONSUMER thread performs it at its
        next poll — including while blocked on the starved queue — and
        the replay fast-forward keeps delivery exactly-once."""
        it = self._activeIterator
        req = getattr(it, "requestRestart", None)
        if req is None:
            return None
        if getattr(it, "numWorkers", 1) != 1:
            # the replay skip is exact only for a single-worker pool
            # (deterministic stream order; supervised fits always pin
            # one worker)
            return None
        req()
        self._note("etl_pool_restart_requested", reason=detail)
        return "producer-pool restart requested"

    def _remediateDivergence(self, rule: str, detail: str) -> Optional[str]:
        """Divergence precursors (rollbacks happening) tighten the
        rollback window: halve the checkpoint cadence so the NEXT
        rollback replays fewer steps.  The original cadence is restored
        by :meth:`_maybeRestoreCadence` once the precursor has stayed
        quiet for ``cadenceRestoreSeconds``."""
        old = self.checkpointEveryN
        if old <= 1:
            return None
        if self._cadenceOriginal is None:
            self._cadenceOriginal = old
        self.checkpointEveryN = max(1, old // 2)
        self._cadenceQuietSince = None      # the quiet clock re-arms
        self._note("rollback_window_tightened", was=old,
                   now=self.checkpointEveryN, reason=detail)
        return (f"checkpoint cadence tightened "
                f"{old} -> {self.checkpointEveryN}")

    def _maybeRestoreCadence(self, now: Optional[float] = None) -> None:
        """Un-tighten the rollback window (checked at every checkpoint
        boundary): once ``divergence_precursor`` tightened the cadence,
        restore the ORIGINAL ``checkpointEveryN`` only after
        ``cadenceRestoreSeconds`` of quiet — no new rollbacks AND the
        precursor rule itself resolved."""
        if self._cadenceOriginal is None or \
                self.cadenceRestoreSeconds is None or \
                self.checkpointEveryN >= self._cadenceOriginal:
            return
        now = time.monotonic() if now is None else now
        rollbacks = int(self.stats["rollbacks"])
        if rollbacks != self._cadenceRollbacksSeen or \
                (self.healthMonitor is not None and
                 "divergence_precursor" in self.healthMonitor.firing):
            self._cadenceRollbacksSeen = rollbacks
            self._cadenceQuietSince = now
            return
        if self._cadenceQuietSince is None:
            self._cadenceQuietSince = now
            return
        if now - self._cadenceQuietSince < self.cadenceRestoreSeconds:
            return
        was = self.checkpointEveryN
        self.checkpointEveryN = self._cadenceOriginal
        self._cadenceQuietSince = None
        self._note("rollback_window_restored", was=was,
                   now=self.checkpointEveryN,
                   quietSeconds=self.cadenceRestoreSeconds)
        log.info("divergence precursor quiet for %gs: checkpoint "
                 "cadence restored %d -> %d", self.cadenceRestoreSeconds,
                 was, self.checkpointEveryN)

    def _fit(self, iterator, epochs: int) -> None:
        net = self.net
        if net.params_ is None:
            net.init()
        skip = 0
        step = None
        if self.resume:
            step = self.ckpt.latestValidStep()
            if step is not None:
                self._timedRestore(step)
                meta = self.ckpt.readMetadata(step)
                skip = int(meta.get("stepInEpoch", 0))
                net.setLrScale(float(meta.get("lrScale", 1.0)))
                self.stats["resumedFromStep"] = step
                self._note("checkpoint_resume", step=step,
                           epoch=net.epochCount, stepInEpoch=skip)
                log.info("resumed from checkpoint step %d "
                         "(epoch %d, stepInEpoch %d)", step,
                         net.epochCount, skip)
        else:
            stale = self.ckpt.allSteps()
            if stale:
                # a fresh start must not keep another run's steps around:
                # the first rollback would restore THAT run's params
                log.warning("resume=False: clearing %d stale checkpoint "
                            "step(s) in %s", len(stale),
                            self.ckpt.directory)
                self.ckpt.clear()
        if step is None:
            # guarantee a rollback target before the first optimizer step
            self._checkpoint(stepInEpoch=0)
        while net.epochCount < int(epochs):
            notifyListeners(net.getListeners(), "onEpochStart", net)
            iterator.reset()
            stepInEpoch = 0
            while iterator.hasNext():
                ds = etl_fetch(iterator)
                if skip > 0:
                    # fast-forward a mid-epoch resume to the stored
                    # position (counters/generator came from the
                    # checkpoint, the data stream must line up with them)
                    skip -= 1
                    stepInEpoch += 1
                    continue
                self._superviseStep(ds)
                stepInEpoch += 1
                if net.iterationCount % self.checkpointEveryN == 0:
                    self._checkpoint(stepInEpoch)
            skip = 0
            net.epochCount += 1
            notifyListeners(net.getListeners(), "onEpochEnd", net)
        self._checkpoint(stepInEpoch=0)
        self.ckpt.waitUntilFinished()

    # -- one supervised step --------------------------------------------
    def _superviseStep(self, ds) -> None:
        net = self.net
        rollbacks = 0
        while True:
            diverged = None
            try:
                with supervised_scope():
                    self._stepOnce(ds)
                loss = float(net.score())
                if math.isnan(loss) or math.isinf(loss):
                    diverged = f"non-finite loss {loss}"
                elif self.divergenceThreshold is not None \
                        and loss > self.divergenceThreshold:
                    diverged = (f"loss {loss} above divergence threshold "
                                f"{self.divergenceThreshold}")
            except FloatingPointError as e:
                diverged = f"NAN/INF panic: {e}"
            except Exception as e:
                from deeplearning4j_tpu_torch.optimize.solvers import \
                    InvalidStepException
                if not isinstance(e, InvalidStepException):
                    raise
                diverged = f"solver: {e}"
            if diverged is None:
                self.lastLoss = loss
                return
            rollbacks += 1
            self.stats["rollbacks"] += 1
            get_registry().counter(
                "dl4j_tpu_fault_nan_rollbacks_total",
                "Divergence (NaN/Inf/threshold/solver) rollbacks to the "
                "last good checkpoint").inc()
            flight_recorder().record(
                event="rollback", reason=diverged,
                iteration=net.iterationCount, epoch=net.epochCount)
            record_event("ckpt.rollback", step=int(net.iterationCount),
                         reason=diverged, attempt=rollbacks)
            tl = fleet_timeline()
            if tl is not None:
                # dump the fleet-timeline window around the rollback into
                # the flight ring: the divergence dump then carries the
                # context that surrounded it
                flight_recorder().record(event="timeline_window",
                                         around="ckpt.rollback",
                                         events=tl.recent(16))
            if rollbacks > self.maxRollbacks:
                reason = (f"still diverging after {self.maxRollbacks} "
                          f"rollbacks ({diverged})")
                self._note("training_diverged", reason=reason,
                           iteration=net.iterationCount)
                record_crash(reason, model=net)
                raise TrainingDivergedError(reason)
            self._note("rollback", reason=diverged,
                       iteration=net.iterationCount, epoch=net.epochCount,
                       attempt=rollbacks)
            with tracer().span("recovery", reason=diverged,
                               rollback=rollbacks, **run_span_attrs()):
                epoch_now = net.epochCount
                step = self._restoreLastGood()
                self._note("checkpoint_restore", step=step,
                           reason=diverged)
                # rollback rewinds the STEP counter/params/opt-state, not
                # the epoch loop position: the iterator hasn't moved, so a
                # restore from a previous epoch's checkpoint must not make
                # the epoch loop re-run a whole extra epoch
                net.epochCount = epoch_now
                net.setLrScale(self._lrScale() * self.lrBackoff)
            log.warning(
                "divergence (%s): rolled back to checkpoint step %d, "
                "lrScale now %.4g (rollback %d/%d)", diverged, step,
                self._lrScale(), rollbacks, self.maxRollbacks)

    def _stepOnce(self, ds, depth: int = 0) -> None:
        """One train step with OOM micro-batch retry.  Injection happens
        inside the try so an injected OOM takes the same split path a real
        one would.  The retry runs after the ``except`` block: by then the
        exception, its traceback and the failed attempt's frames (with
        their activations) are gone."""
        net = self.net
        it0 = net.iterationCount
        pre = _PreStep(net)
        oom = None
        try:
            inj = self.injector
            if inj is not None:
                ds = inj.before_step(it0, net, ds)
            net.fit(ds)
        except Exception as e:
            if not is_oom_error(e) or depth >= self.maxMicroBatchSplits \
                    or ds.numExamples() < 2:
                raise
            oom = type(e).__name__
        if oom is None:
            return
        pre.restore()
        del pre
        if oom != "InjectedOOM":
            # the failed attempt's tensors are unreachable now; hand the
            # blocks they held back to the allocator before the halves
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        self.stats["oomSplits"] += 1
        get_registry().counter(
            "dl4j_tpu_fault_oom_retries_total",
            "Device-OOM steps retried as micro-batches").inc()
        flight_recorder().record(
            event="oom_retry", iteration=it0,
            micro_batch=ds.numExamples() // 2)
        log.warning(
            "device OOM at step %d (%s); retrying as %d-example "
            "micro-batches", it0, oom, ds.numExamples() // 2)
        t0 = time.perf_counter()
        with microbatch_scope():
            for half in _split_dataset(ds):
                # every micro-batch updates at the SAME schedule
                # position: without the reset, half 2 would consume
                # iteration it0+1 and the next real batch would repeat
                # it (double-stepping any iteration-keyed LR schedule)
                net.iterationCount = it0
                self._stepOnce(half, depth + 1)
        # the outside world saw ONE logical step
        net.iterationCount = it0 + 1
        if depth == 0:
            # the halves deferred their reporting (microbatch_scope):
            # count the logical step's metrics and fire iterationDone
            # exactly once at the step boundary
            record_logical_step(net, time.perf_counter() - t0,
                                ds.numExamples())
            notifyListeners(net.getListeners(), "iterationDone", net,
                            net.iterationCount, net.epochCount)

    def close(self) -> None:
        self.ckpt.close()
