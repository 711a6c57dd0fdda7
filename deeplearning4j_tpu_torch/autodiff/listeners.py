"""SameDiff listener SPI and stock listeners — the port of
``deeplearning4j_tpu/autodiff/listeners.py`` (the reference's
``org/nd4j/autodiff/listeners/BaseListener.java``, ``At``, ``Loss`` and
``impl/ExecDebuggingListener``).

``iterationStart`` / ``iterationDone`` / ``epochStart`` / ``epochEnd``
fire from ``SameDiff.fit``.  The per-op hooks fire from
``SameDiff.execDebug``, which waits for ROADMAP A12b.
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["Loss", "BaseListener", "At", "ExecDebuggingListener",
           "HistoryListener"]


class Loss:
    """Named loss values for a step (reference: listeners/Loss.java)."""

    def __init__(self, names: List[str], values: List[float]):
        self.names = names
        self.values = values

    def totalLoss(self) -> float:
        return float(sum(self.values))


class BaseListener:
    """SPI — override what you need."""

    def epochStart(self, sd, at) -> None:
        pass

    def epochEnd(self, sd, at, loss_curve=None) -> None:
        pass

    def iterationStart(self, sd, at, data, etl_ms: int = 0) -> None:
        pass

    def iterationDone(self, sd, at, data, loss: Optional[Loss] = None) -> None:
        pass

    def preOpExecution(self, sd, at, op) -> None:
        pass

    def opExecution(self, sd, at, op, outputs) -> None:
        pass


class At:
    """Where training currently is (reference: listeners/At.java)."""

    def __init__(self, epoch: int = 0, iteration: int = 0):
        self.epoch_ = epoch
        self.iteration_ = iteration

    def epoch(self) -> int:
        return self.epoch_

    def iteration(self) -> int:
        return self.iteration_


class ExecDebuggingListener(BaseListener):
    """Print every executed op with its inputs and outputs (reference:
    impl/ExecDebuggingListener), for an op-by-op ``execDebug`` pass."""

    def __init__(self, printArrays: bool = False, maxIterations: int = -1):
        self.printArrays = printArrays
        self.maxIterations = maxIterations
        self._iters = 0          # execDebug passes completed

    def _silenced(self) -> bool:
        return 0 <= self.maxIterations <= self._iters

    def preOpExecution(self, sd, at, op):
        if self._silenced():
            return
        print(f"[exec] {op.op:<24} inputs={op.inputs} -> {op.outputs}")

    def execDebugPassDone(self, sd, at):
        self._iters += 1

    def opExecution(self, sd, at, op, outputs):
        if self._silenced():
            return
        for name, val in zip(op.outputs, outputs):
            arr = val.detach().cpu() if isinstance(val, torch.Tensor) \
                else torch.as_tensor(val)
            line = (f"        {name}: shape={tuple(arr.shape)} "
                    f"dtype={arr.dtype}")
            if self.printArrays:
                line += f" values={arr!r}"
            print(line)


class HistoryListener(BaseListener):
    """Collect per-iteration losses (a programmatic listener)."""

    def __init__(self):
        self.losses: List[float] = []

    def iterationDone(self, sd, at, data, loss=None):
        if loss is not None:
            self.losses.append(loss.totalLoss())
