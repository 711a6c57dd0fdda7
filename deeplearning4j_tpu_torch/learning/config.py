"""Updater (optimizer) configs and their pure appliers — the port of
``deeplearning4j_tpu/learning/config.py`` (``IUpdater``, ``Sgd``, ``NoOp``,
``Adam``, ``Nesterovs``).

Each config exposes

- ``init(param) -> state dict`` (tensors shaped like the param);
- ``apply(grad, state, lr, iteration) -> (update, new_state)``;

both pure: ``update`` is SUBTRACTED from the param by the caller (the
reference's ``params.subi(gradientView)`` step).  AdamW, AdaMax, AMSGrad,
Nadam, RmsProp, AdaGrad, AdaDelta and learning-rate and momentum schedules
wait for ROADMAP A3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.learning.schedules import _f32pow

__all__ = ["IUpdater", "Sgd", "Adam", "NoOp", "Nesterovs"]


def _no_schedules():
    return NotImplementedError(
        "learning-rate and momentum schedules are not ported yet "
        "(ROADMAP A3)")


@dataclasses.dataclass
class IUpdater:
    """Base updater config."""
    learningRate: float = 1e-3
    learningRateSchedule: Optional[Any] = None

    # -- API ------------------------------------------------------------
    def currentLr(self, iteration, epoch):
        if self.learningRateSchedule is not None:
            raise _no_schedules()
        return self.learningRate

    def init(self, param) -> Dict[str, Any]:
        return {}

    def apply(self, grad, state, lr, iteration, epoch=0, param=None
              ) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    def stateSize(self, numParams: int) -> int:
        return 0

    # -- serde ----------------------------------------------------------
    def toJson(self) -> dict:
        if self.learningRateSchedule is not None:
            raise _no_schedules()
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def fromJson(d: dict) -> "IUpdater":
        d = dict(d)
        name = d.pop("@class")
        if name not in _REGISTRY:
            raise NotImplementedError(
                f"updater {name} is not ported yet (ROADMAP A3)")
        if d.get("learningRateSchedule") or d.get("momentumSchedule"):
            raise _no_schedules()
        return _REGISTRY[name](**d)


@dataclasses.dataclass
class Sgd(IUpdater):
    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        return lr * grad, state


@dataclasses.dataclass
class NoOp(IUpdater):
    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        return torch.zeros_like(grad), state


@dataclasses.dataclass
class Adam(IUpdater):
    learningRate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def stateSize(self, n):
        return 2 * n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        t = iteration + 1
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        # beta^t and the bias correction in float32, as the reference
        a = lr * torch.sqrt(1 - _f32pow(self.beta2, t)) \
            / (1 - _f32pow(self.beta1, t))
        return a * m / (torch.sqrt(v) + self.epsilon), {"m": m, "v": v}


@dataclasses.dataclass
class Nesterovs(IUpdater):
    learningRate: float = 0.1
    momentum: float = 0.9
    momentumSchedule: Optional[Any] = None

    def init(self, param):
        return {"v": torch.zeros_like(param)}

    def stateSize(self, n):
        return n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        if self.momentumSchedule is not None:
            raise _no_schedules()
        mu = self.momentum
        # the reference's NesterovsUpdater: v = mu*v_prev - lr*g, and the
        # param moves by -mu*v_prev + (1+mu)*v; the caller subtracts the
        # returned update, so it is negated
        vPrev = state["v"]
        v = mu * vPrev - lr * grad
        update = mu * vPrev - (1 + mu) * v
        return update, {"v": v}

    def toJson(self) -> dict:
        if self.momentumSchedule is not None:
            raise _no_schedules()
        return IUpdater.toJson(self)


_REGISTRY = {c.__name__: c for c in [Sgd, NoOp, Adam, Nesterovs]}
