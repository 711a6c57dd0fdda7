"""Training listeners — the port of ``deeplearning4j_tpu/optimize/
listeners.py`` (the reference's ``org/deeplearning4j/optimize/api/
TrainingListener.java`` and the stock listeners under
``optimize/listeners/**``): the SPI, ``notifyListeners``, and the score,
performance, score-collecting, time, evaluative and checkpoint listeners.
``StatsListener`` lives in :mod:`deeplearning4j_tpu_torch.ui.stats`, and
``ProfilingListener`` in :mod:`deeplearning4j_tpu_torch.profiler`.

A swallowed listener error counts in the telemetry registry's
``dl4j_tpu_train_listener_errors_total``, as in the reference, and in the
module's :data:`dl4j_tpu_train_listener_errors_total`; the performance
listener's rates land in its gauges and stay on the listener.
"""
from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

__all__ = ["TrainingStopSignal", "notifyListeners", "TrainingListener",
           "ScoreIterationListener", "PerformanceListener",
           "CollectScoresIterationListener", "TimeIterationListener",
           "EvaluativeListener", "CheckpointListener"]

log = logging.getLogger("deeplearning4j_tpu_torch")

#: listener callback exceptions swallowed by the train loop (the
#: reference's counter of the same name)
dl4j_tpu_train_listener_errors_total = 0


class TrainingStopSignal(Exception):
    """Deliberate listener-driven control flow (early stopping's
    iteration-termination check): ``notifyListeners`` re-raises it instead
    of swallowing it like an ordinary listener bug."""


def notifyListeners(listeners, method: str, model, *args, **kwargs) -> None:
    """Invoke one listener hook across all listeners, non-fatally.

    A listener is a monitor: a bug in one logs a warning and counts in
    :data:`dl4j_tpu_train_listener_errors_total`, and never kills the run
    it watches.  :class:`TrainingStopSignal`, a listener with
    ``failOnError`` and BaseExceptions propagate."""
    global dl4j_tpu_train_listener_errors_total
    for l in listeners:
        try:
            getattr(l, method)(model, *args, **kwargs)
        except TrainingStopSignal:
            raise
        except Exception as e:
            if getattr(l, "failOnError", False):
                # side-effecting listeners (checkpoint writers) are not
                # monitors: a run that silently stops producing artifacts
                # is worse than a dead one
                raise
            dl4j_tpu_train_listener_errors_total += 1
            from deeplearning4j_tpu_torch.telemetry.registry import \
                get_registry
            get_registry().counter(
                "dl4j_tpu_train_listener_errors_total",
                "Listener callback exceptions swallowed by the train "
                "loop").inc()
            log.warning("listener %s.%s failed (swallowed): %s: %s",
                        type(l).__name__, method, type(e).__name__, e)


class TrainingListener:
    """SPI: iterationDone / onEpochStart / onEpochEnd / onForwardPass /
    onBackwardPass / onGradientCalculation.

    ``failOnError`` (class attr): monitors default to False — the train
    loop swallows their exceptions (warning + counter).  Listeners whose
    side effects the run depends on (checkpoint writers) set True so a
    failure still kills the run."""

    failOnError = False

    def iterationDone(self, model, iteration: int, epoch: int) -> None:
        pass

    def onEpochStart(self, model) -> None:
        pass

    def onEpochEnd(self, model) -> None:
        pass

    def onForwardPass(self, model, activations=None) -> None:
        pass

    def onBackwardPass(self, model) -> None:
        pass

    def onGradientCalculation(self, model) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Print the score every N iterations (``ScoreIterationListener.java``)."""

    def __init__(self, printIterations: int = 10):
        self.printIterations = max(int(printIterations), 1)

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.printIterations == 0:
            print(f"Score at iteration {iteration} is {model.score()}")


class PerformanceListener(TrainingListener):
    """Throughput (``PerformanceListener.java``).

    The train loops return before the device finishes a step, so a bare
    timestamp here would measure the host's launch rate.  On a reporting
    iteration the listener first waits for the model's device
    (``torch.cuda.synchronize``) and only then stamps the time: the rates
    are the card's, and the wait is paid once per ``frequency``
    iterations.  The last rates stay on the listener
    (``iterationsPerSecond``, ``samplesPerSecond``) and land in
    ``dl4j_tpu_train_iterations_per_second`` /
    ``dl4j_tpu_train_throughput_examples_per_second`` on the default
    registry."""

    def __init__(self, frequency: int = 10, reportScore: bool = False):
        self.frequency = max(int(frequency), 1)
        self.reportScore = reportScore
        self._last: Optional[float] = None
        self._lastIter = 0
        self.iterationsPerSecond: Optional[float] = None
        self.samplesPerSecond: Optional[float] = None

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency:
            return
        device = getattr(model, "device", None)
        if device is not None and device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if self._last is not None and iteration > self._lastIter:
            dt = now - self._last
            its = (iteration - self._lastIter) / dt if dt > 0 else 0.0
            bs = getattr(model, "lastBatchSize", 0)
            self.iterationsPerSecond, self.samplesPerSecond = its, its * bs
            from deeplearning4j_tpu_torch.telemetry.registry import \
                get_registry
            reg = get_registry()
            reg.gauge("dl4j_tpu_train_iterations_per_second",
                      "Blocked (device-accurate) iterations/sec").set(its)
            reg.gauge("dl4j_tpu_train_throughput_examples_per_second",
                      "Blocked (device-accurate) samples/sec").set(its * bs)
            msg = (f"iteration {iteration}; iterations/sec: {its:.2f}; "
                   f"samples/sec: {its * bs:.2f}")
            if self.reportScore:
                msg += f"; score: {model.score()}"
            print(msg)
        self._last = now
        self._lastIter = iteration


class CollectScoresIterationListener(TrainingListener):
    """Keep ``(iteration, score)`` every ``frequency`` iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(int(frequency), 1)
        self.scores: List[Tuple[int, float]] = []

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score()))

    def getScores(self):
        return self.scores


class TimeIterationListener(TrainingListener):
    """Print the remaining time estimated from the mean iteration time
    (``TimeIterationListener.java``)."""

    def __init__(self, iterationCount: int, frequency: int = 50):
        self.iterationCount = iterationCount
        self.frequency = max(frequency, 1)
        self._start = time.time()

    def iterationDone(self, model, iteration, epoch):
        if iteration and iteration % self.frequency == 0:
            elapsed = time.time() - self._start
            per = elapsed / max(iteration, 1)
            remain = (self.iterationCount - iteration) * per
            print(f"Remaining time estimate: {remain:.0f}s "
                  f"(iteration {iteration}/{self.iterationCount})")


class EvaluativeListener(TrainingListener):
    """Evaluate on a held-out iterator every ``frequency`` epochs or
    iterations (``EvaluativeListener.java``)."""

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch"):
        self.iterator = iterator
        self.frequency = max(int(frequency), 1)
        self.unit = unit
        self.lastEvaluation = None

    def _evaluate(self, model):
        self.lastEvaluation = model.evaluate(self.iterator)
        print(self.lastEvaluation.stats())

    def iterationDone(self, model, iteration, epoch):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._evaluate(model)

    def onEpochEnd(self, model):
        if self.unit == "epoch" and \
                model.getEpochCount() % self.frequency == 0:
            self._evaluate(model)


class CheckpointListener(TrainingListener):
    """Write the model (with its updater state) through
    ``ModelSerializer`` every N iterations or epochs, keeping the last
    ``keepLast`` (``CheckpointListener.java``)."""

    failOnError = True     # a run with no checkpoints must not look green

    def __init__(self, saveDir: str, saveEveryNIterations: int = 0,
                 saveEveryNEpochs: int = 0, keepLast: int = 3):
        self.saveDir = saveDir
        os.makedirs(saveDir, exist_ok=True)
        self.everyIter = saveEveryNIterations
        self.everyEpoch = saveEveryNEpochs
        self.keepLast = keepLast
        self._saved: List[str] = []

    def _save(self, model, tag: str):
        from deeplearning4j_tpu_torch.utils.model_serializer import \
            ModelSerializer
        path = os.path.join(self.saveDir, f"checkpoint_{tag}.zip")
        ModelSerializer.writeModel(model, path, saveUpdater=True)
        self._saved.append(path)
        while self.keepLast > 0 and len(self._saved) > self.keepLast:
            old = self._saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iterationDone(self, model, iteration, epoch):
        if self.everyIter and iteration and iteration % self.everyIter == 0:
            self._save(model, f"iter_{iteration}")

    def onEpochEnd(self, model):
        ep = model.getEpochCount()
        if self.everyEpoch and ep and ep % self.everyEpoch == 0:
            self._save(model, f"epoch_{ep}")
