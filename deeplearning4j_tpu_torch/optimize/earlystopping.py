"""Early stopping — trainer, termination conditions, savers; the port of
``deeplearning4j_tpu/optimize/earlystopping.py`` (deeplearning4j-core's
``org/deeplearning4j/earlystopping/**``: ``EarlyStoppingConfiguration``
with its epoch and iteration termination conditions, score calculator,
model saver and ``evaluateEveryNEpochs``; ``trainer/EarlyStoppingTrainer``;
``saver/{InMemoryModelSaver,LocalFileModelSaver}``;
``scorecalc/DataSetLossCalculator``; ``EarlyStoppingResult`` with
``TerminationReason``).

The in-memory saver keeps copies of the parameter, state and updater
tensors on the model's device; the file saver writes a
``ModelSerializer`` zip and restores it onto the device of the model it
saved.
"""
from __future__ import annotations

import copy
import os
import time
from typing import List, Optional

__all__ = [
    "EpochTerminationCondition", "MaxEpochsTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition", "IterationTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition", "ScoreCalculator",
    "DataSetLossCalculator", "ClassificationScoreCalculator",
    "EarlyStoppingModelSaver", "InMemoryModelSaver", "LocalFileModelSaver",
    "EarlyStoppingConfiguration", "TerminationReason",
    "EarlyStoppingResult", "EarlyStoppingTrainer",
    "EarlyStoppingGraphTrainer"]


# ----------------------------------------------------------- conditions ----

class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epochNum: int, score: float,
                  minimize: bool) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, maxEpochs: int):
        self.maxEpochs = maxEpochs

    def terminate(self, epochNum, score, minimize):
        return epochNum + 1 >= self.maxEpochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.maxEpochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when no improvement for N evaluations (maxEpochsWithNoImprovement),
    optionally requiring at least minImprovement delta."""

    def __init__(self, maxEpochsWithNoImprovement: int,
                 minImprovement: float = 0.0):
        self.patience = maxEpochsWithNoImprovement
        self.minImprovement = minImprovement
        self._best: Optional[float] = None
        self._bad = 0

    def initialize(self):
        self._best = None
        self._bad = 0

    def terminate(self, epochNum, score, minimize):
        if self._best is None:
            self._best = score
            return False
        improved = (self._best - score) if minimize else (score - self._best)
        if improved > self.minImprovement:
            self._best = score
            self._bad = 0
        else:
            self._bad += 1
        return self._bad >= self.patience

    def __str__(self):
        return ("ScoreImprovementEpochTerminationCondition("
                f"{self.patience}, {self.minImprovement})")


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target."""

    def __init__(self, bestExpectedScore: float):
        self.bestExpectedScore = bestExpectedScore

    def terminate(self, epochNum, score, minimize):
        return score <= self.bestExpectedScore if minimize \
            else score >= self.bestExpectedScore

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.bestExpectedScore})"


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, lastMiniBatchScore: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, maxTime: float, unit: str = "seconds"):
        mult = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0}[unit]
        self.maxSeconds = maxTime * mult
        self._start = None

    def initialize(self):
        self._start = time.time()

    def terminate(self, lastMiniBatchScore):
        return (time.time() - self._start) > self.maxSeconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.maxSeconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort when the minibatch score explodes past a ceiling (divergence)."""

    def __init__(self, maxScore: float):
        self.maxScore = maxScore

    def terminate(self, lastMiniBatchScore):
        import math
        return lastMiniBatchScore > self.maxScore or \
            math.isnan(lastMiniBatchScore)

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.maxScore})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate on NaN/Inf minibatch score (reference:
    ``termination/InvalidScoreIterationTerminationCondition.java``).
    Always part of the trainer's default checks — a diverged run burning
    the rest of its epoch budget on NaN steps helps nobody."""

    def terminate(self, lastMiniBatchScore):
        import math
        return math.isnan(lastMiniBatchScore) or \
            math.isinf(lastMiniBatchScore)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"


# ------------------------------------------------------ score calculators ----

class ScoreCalculator:
    minimizeScore: bool = True

    def calculateScore(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Reference: scorecalc/DataSetLossCalculator — average loss over a
    held-out iterator."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculateScore(self, net) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            total += net.score(ds) * ds.numExamples()
            n += ds.numExamples()
        return total / max(n, 1) if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Accuracy/F1 on a held-out set (HIGHER is better)."""

    minimizeScore = False

    def __init__(self, iterator, metric: str = "accuracy"):
        self.iterator = iterator
        self.metric = metric

    def calculateScore(self, net) -> float:
        self.iterator.reset()
        ev = net.evaluate(self.iterator)
        return getattr(ev, self.metric)()


# ---------------------------------------------------------------- savers ----

class EarlyStoppingModelSaver:
    def saveBestModel(self, net, score: float) -> None:
        raise NotImplementedError

    def saveLatestModel(self, net, score: float) -> None:
        pass

    def getBestModel(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    def __init__(self):
        self._best = None

    def saveBestModel(self, net, score):
        from deeplearning4j_tpu_torch.models.multilayer import _clone_tree
        self._best = (net, _clone_tree(net.params_),
                      _clone_tree(net.state_), _clone_tree(net.optState_))

    def getBestModel(self):
        if self._best is None:
            return None
        from deeplearning4j_tpu_torch.models.multilayer import _clone_tree
        net, params, state, opt = self._best
        restored = copy.copy(net)
        # hand out copies, so training the restored model leaves the saved
        # snapshot as it was
        restored.params_ = _clone_tree(params)
        restored.state_ = _clone_tree(state)
        restored.optState_ = _clone_tree(opt)
        return restored


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Reference: saver/LocalFileModelSaver — bestModel.zip (and
    latestModel.zip) in a directory; ``getBestModel`` restores onto the
    device of the model that was saved."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._isGraph = False
        self._device = None

    def _path(self, name):
        return os.path.join(self.directory, name)

    def saveBestModel(self, net, score):
        from deeplearning4j_tpu_torch.utils.model_serializer import \
            ModelSerializer
        self._isGraph = type(net).__name__ == "ComputationGraph"
        self._device = net.device
        ModelSerializer.writeModel(net, self._path("bestModel.zip"),
                                   saveUpdater=True)

    def saveLatestModel(self, net, score):
        from deeplearning4j_tpu_torch.utils.model_serializer import \
            ModelSerializer
        ModelSerializer.writeModel(net, self._path("latestModel.zip"),
                                   saveUpdater=True)

    def getBestModel(self):
        from deeplearning4j_tpu_torch.utils.model_serializer import \
            ModelSerializer
        restore = ModelSerializer.restoreComputationGraph if self._isGraph \
            else ModelSerializer.restoreMultiLayerNetwork
        return restore(self._path("bestModel.zip"), device=self._device)


# ---------------------------------------------------------------- config ----

class EarlyStoppingConfiguration:
    def __init__(self, epochTerminationConditions=None,
                 iterationTerminationConditions=None,
                 scoreCalculator: Optional[ScoreCalculator] = None,
                 modelSaver: Optional[EarlyStoppingModelSaver] = None,
                 evaluateEveryNEpochs: int = 1,
                 saveLastModel: bool = False):
        self.epochConds: List[EpochTerminationCondition] = \
            list(epochTerminationConditions or [])
        self.iterConds: List[IterationTerminationCondition] = \
            list(iterationTerminationConditions or [])
        self.scoreCalculator = scoreCalculator
        self.modelSaver = modelSaver or InMemoryModelSaver()
        self.evaluateEveryNEpochs = max(1, evaluateEveryNEpochs)
        self.saveLastModel = saveLastModel

    class Builder:
        def __init__(self):
            self._kw = {"epochTerminationConditions": [],
                        "iterationTerminationConditions": []}

        def epochTerminationConditions(self, *conds):
            self._kw["epochTerminationConditions"].extend(conds)
            return self

        def iterationTerminationConditions(self, *conds):
            self._kw["iterationTerminationConditions"].extend(conds)
            return self

        def scoreCalculator(self, sc):
            self._kw["scoreCalculator"] = sc
            return self

        def modelSaver(self, saver):
            self._kw["modelSaver"] = saver
            return self

        def evaluateEveryNEpochs(self, n):
            self._kw["evaluateEveryNEpochs"] = n
            return self

        def saveLastModel(self, b=True):
            self._kw["saveLastModel"] = b
            return self

        def build(self):
            return EarlyStoppingConfiguration(**self._kw)

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


class TerminationReason:
    EpochTerminationCondition = "EpochTerminationCondition"
    IterationTerminationCondition = "IterationTerminationCondition"
    Error = "Error"


class EarlyStoppingResult:
    def __init__(self, terminationReason, terminationDetails, scoreVsEpoch,
                 bestModelEpoch, bestModelScore, totalEpochs, bestModel):
        self.terminationReason = terminationReason
        self.terminationDetails = terminationDetails
        self.scoreVsEpoch = scoreVsEpoch
        self.bestModelEpoch = bestModelEpoch
        self.bestModelScore = bestModelScore
        self.totalEpochs = totalEpochs
        self._bestModel = bestModel

    def getBestModel(self):
        return self._bestModel

    def getTerminationReason(self):
        return self.terminationReason

    def __str__(self):
        return (f"EarlyStoppingResult(reason={self.terminationReason}, "
                f"details={self.terminationDetails}, "
                f"bestEpoch={self.bestModelEpoch}, "
                f"bestScore={self.bestModelScore}, "
                f"totalEpochs={self.totalEpochs})")


# --------------------------------------------------------------- trainer ----

class EarlyStoppingTrainer:
    """Reference: trainer/EarlyStoppingTrainer (+ BaseEarlyStoppingTrainer).

    Epoch loop: train one epoch → (every N epochs) score on the held-out
    calculator → track/save best → check epoch conditions.  Iteration
    conditions (time budget, divergence) are checked after every
    minibatch via a listener hook.  Given a configuration, it builds a
    ``MultiLayerNetwork`` on ``device`` (``cuda`` unless the caller asks
    for another).
    """

    def __init__(self, earlyStoppingConfiguration, conf_or_net, iterator,
                 device=None):
        self.esConfig = earlyStoppingConfiguration
        self.net = conf_or_net
        if not hasattr(conf_or_net, "fit"):  # a configuration was passed
            from deeplearning4j_tpu_torch.models import MultiLayerNetwork
            self.net = MultiLayerNetwork(conf_or_net, device=device)
            self.net.init()
        self.iterator = iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.esConfig
        iterConds = list(cfg.iterConds)
        if not any(isinstance(c, InvalidScoreIterationTerminationCondition)
                   for c in iterConds):
            # default check (reference parity): a NaN/Inf minibatch score
            # always terminates, whether or not the user listed conditions
            iterConds.append(InvalidScoreIterationTerminationCondition())
        for c in cfg.epochConds + iterConds:
            c.initialize()
        calc = cfg.scoreCalculator
        minimize = calc.minimizeScore if calc else True
        scoreVsEpoch = {}
        best_score = None
        best_epoch = -1
        epoch = 0
        reason, details = TerminationReason.EpochTerminationCondition, ""

        from deeplearning4j_tpu_torch.optimize.listeners import (
            TrainingListener, TrainingStopSignal)

        class _IterCheck(TrainingListener):
            stop = None

            def iterationDone(self, model, iteration, ep):
                s = model.score()
                for c in iterConds:
                    if c.terminate(s):
                        _IterCheck.stop = str(c)
                        raise _StopTraining()

        class _StopTraining(TrainingStopSignal):
            # TrainingStopSignal: the train loop's non-fatal listener
            # wrapper re-raises control-flow signals instead of logging
            # them away like monitor bugs
            pass

        listener = _IterCheck()
        self.net.addListeners(listener)
        try:
            while True:
                try:
                    self.iterator.reset()
                    self.net.fit(self.iterator, epochs=1)
                except _StopTraining:
                    reason = TerminationReason.IterationTerminationCondition
                    details = _IterCheck.stop
                    break

                # the (possibly expensive) held-out pass runs only on eval
                # epochs (epoch 0 always evals); stateful epoch conditions
                # (score-improvement patience) are ONLY fed on eval epochs —
                # feeding a stale score would burn patience N times faster
                # (reference: BaseEarlyStoppingTrainer checks on eval epochs)
                is_eval = calc is None or epoch % cfg.evaluateEveryNEpochs == 0
                score = None
                if is_eval:
                    score = calc.calculateScore(self.net) if calc \
                        else self.net.score()
                    scoreVsEpoch[epoch] = score
                    better = best_score is None or \
                        (score < best_score if minimize else score > best_score)
                    if better:
                        best_score, best_epoch = score, epoch
                        cfg.modelSaver.saveBestModel(self.net, score)
                if cfg.saveLastModel:
                    cfg.modelSaver.saveLatestModel(self.net, score)

                stop = None
                for c in cfg.epochConds:
                    if isinstance(c, MaxEpochsTerminationCondition):
                        hit = c.terminate(epoch, score, minimize)
                    else:
                        hit = is_eval and c.terminate(epoch, score, minimize)
                    if hit:
                        stop = str(c)
                        break
                epoch += 1
                if stop is not None:
                    reason = TerminationReason.EpochTerminationCondition
                    details = stop
                    break
        finally:
            try:
                self.net.removeListener(listener)
            except Exception:
                pass

        return EarlyStoppingResult(
            terminationReason=reason, terminationDetails=details,
            scoreVsEpoch=scoreVsEpoch, bestModelEpoch=best_epoch,
            bestModelScore=best_score, totalEpochs=epoch,
            bestModel=cfg.modelSaver.getBestModel())


EarlyStoppingGraphTrainer = EarlyStoppingTrainer
