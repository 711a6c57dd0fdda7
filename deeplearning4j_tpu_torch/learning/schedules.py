"""Learning-rate (and momentum) schedules — the port of
``deeplearning4j_tpu/learning/schedules.py`` (the reference's
``org/nd4j/linalg/schedule/*.java``: ``ISchedule`` and the Fixed,
Exponential, Inverse, Poly, Sigmoid, Step, Linear, Cycle and Map
schedules).

``valueAt(iteration, epoch)`` takes the host's counters (Python ints), so
a schedule is plain Python arithmetic.  Where the JAX package computes a
value in float32 (every ``beta^t``-style power, through :func:`_f32pow`)
the port does too and returns a 0-d float32 tensor on the CPU, usable as a
scalar with tensors on any device; elsewhere (float64 in the JAX package,
which turns on x64) it returns a Python float.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

__all__ = ["ISchedule", "FixedSchedule", "ExponentialSchedule",
           "InverseSchedule", "PolySchedule", "SigmoidSchedule",
           "StepSchedule", "MapSchedule", "LinearSchedule", "CycleSchedule",
           "ScheduleType"]


def _f32pow(base, exponent):
    """base^exponent in float32, as the reference computes Adam's
    ``beta^t`` (a 0-d float32 tensor on the CPU, usable as a scalar with
    tensors on any device)."""
    return torch.pow(torch.tensor(base, dtype=torch.float32),
                     torch.tensor(exponent, dtype=torch.float32))


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


class ScheduleType:
    ITERATION = "ITERATION"
    EPOCH = "EPOCH"


@dataclasses.dataclass
class ISchedule:
    def valueAt(self, iteration, epoch):
        raise NotImplementedError

    def _t(self, iteration, epoch):
        st = getattr(self, "scheduleType", ScheduleType.ITERATION)
        return epoch if st == ScheduleType.EPOCH else iteration

    def toJson(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def fromJson(d: dict) -> "ISchedule":
        d = dict(d)
        name = d.pop("@class")
        if name == "MapSchedule":
            return MapSchedule(scheduleType=d["scheduleType"],
                               values={int(k): v
                                       for k, v in d["values"].items()})
        return _REGISTRY[name](**d)


@dataclasses.dataclass
class FixedSchedule(ISchedule):
    value: float

    def valueAt(self, iteration, epoch):
        return self.value


@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    scheduleType: str
    initialValue: float
    gamma: float

    def valueAt(self, iteration, epoch):
        return self.initialValue * _f32pow(self.gamma,
                                           self._t(iteration, epoch))


@dataclasses.dataclass
class InverseSchedule(ISchedule):
    scheduleType: str
    initialValue: float
    gamma: float
    power: float

    def valueAt(self, iteration, epoch):
        return self.initialValue / _f32pow(
            1.0 + self.gamma * self._t(iteration, epoch), self.power)


@dataclasses.dataclass
class PolySchedule(ISchedule):
    scheduleType: str
    initialValue: float
    power: float
    maxIter: int

    def valueAt(self, iteration, epoch):
        frac = _clip01(self._t(iteration, epoch) / self.maxIter)
        return self.initialValue * _f32pow(1.0 - frac, self.power)


@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    scheduleType: str
    initialValue: float
    gamma: float
    stepSize: int

    def valueAt(self, iteration, epoch):
        z = self.gamma * (self._t(iteration, epoch) - self.stepSize)
        try:
            e = math.exp(z)
        except OverflowError:     # jnp.exp gives inf, so the value is 0
            e = math.inf
        return self.initialValue / (1.0 + e)


@dataclasses.dataclass
class StepSchedule(ISchedule):
    scheduleType: str
    initialValue: float
    decayRate: float
    step: float

    def valueAt(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initialValue * _f32pow(self.decayRate,
                                           math.floor(t / self.step))


@dataclasses.dataclass
class LinearSchedule(ISchedule):
    scheduleType: str
    initialValue: float
    finalValue: float
    maxIter: int

    def valueAt(self, iteration, epoch):
        frac = _clip01(self._t(iteration, epoch) / self.maxIter)
        return self.initialValue + frac * (self.finalValue
                                           - self.initialValue)


@dataclasses.dataclass
class CycleSchedule(ISchedule):
    """1-cycle policy (reference: ``CycleSchedule.java``)."""
    scheduleType: str
    initialLearningRate: float
    maxLearningRate: float
    cycleLength: int
    annealingLength: int = 0
    annealingDecay: float = 0.1

    def valueAt(self, iteration, epoch):
        t = self._t(iteration, epoch)
        cycle = self.cycleLength - self.annealingLength
        up = cycle // 2
        down = cycle - up  # odd cycle lengths: down phase gets the extra step
        pos = t % self.cycleLength
        span = self.maxLearningRate - self.initialLearningRate
        if pos < up:
            return self.initialLearningRate + span * pos / max(up, 1)
        if pos < cycle:
            return self.maxLearningRate - span * (pos - up) / max(down, 1)
        return self.initialLearningRate * self.annealingDecay


@dataclasses.dataclass
class MapSchedule(ISchedule):
    """Piecewise-constant values keyed by iteration/epoch
    (``MapSchedule.java``); before the first key, the first key's value."""
    scheduleType: str
    values: Dict[int, float]

    def valueAt(self, iteration, epoch):
        t = self._t(iteration, epoch)
        keys = sorted(int(k) for k in self.values)
        out = self.values[keys[0]]
        for k in keys:
            if t >= k:
                out = self.values[k]
        return out

    def toJson(self) -> dict:
        return {"@class": "MapSchedule", "scheduleType": self.scheduleType,
                "values": {str(k): v for k, v in self.values.items()}}


_REGISTRY = {c.__name__: c for c in [
    FixedSchedule, ExponentialSchedule, InverseSchedule, PolySchedule,
    SigmoidSchedule, StepSchedule, LinearSchedule, CycleSchedule]}
