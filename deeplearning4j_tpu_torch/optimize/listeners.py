"""Training listener SPI — the port of the first part of
``deeplearning4j_tpu/optimize/listeners.py`` (the reference's
``org/deeplearning4j/optimize/api/TrainingListener.java``):
``TrainingStopSignal``, ``notifyListeners`` and ``TrainingListener``.  The
stock listeners (score, performance, checkpoint, stats) wait for ROADMAP
A9.

The reference counts a swallowed listener error in its telemetry registry;
telemetry waits for ROADMAP A12, so until then the count is kept in
:data:`dl4j_tpu_train_listener_errors_total` here, beside the same
warning.
"""
from __future__ import annotations

import logging

__all__ = ["TrainingStopSignal", "notifyListeners", "TrainingListener"]

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
