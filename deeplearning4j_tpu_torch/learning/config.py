"""Updater (optimizer) configs and their pure appliers — the port of
``deeplearning4j_tpu/learning/config.py`` (the reference's ``IUpdater``
impls: Sgd, Adam, AdamW, AdaMax, AMSGrad, Nadam, Nesterovs, RmsProp,
AdaGrad, AdaDelta, NoOp).

Each config exposes

- ``init(param) -> state dict`` (tensors shaped like the param);
- ``apply(grad, state, lr, iteration) -> (update, new_state)``;

both pure: ``update`` is SUBTRACTED from the param by the caller (the
reference's ``params.subi(gradientView)`` step).  A learning rate or
momentum may follow an ``ISchedule`` of ``learning/schedules.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.learning.schedules import ISchedule, _f32pow

__all__ = ["IUpdater", "Sgd", "Adam", "AdamW", "AdaMax", "AMSGrad", "Nadam",
           "Nesterovs", "RmsProp", "AdaGrad", "AdaDelta", "NoOp"]


@dataclasses.dataclass
class IUpdater:
    """Base updater config."""
    learningRate: float = 1e-3
    learningRateSchedule: Optional[ISchedule] = None

    # -- API ------------------------------------------------------------
    def currentLr(self, iteration, epoch):
        if self.learningRateSchedule is not None:
            return self.learningRateSchedule.valueAt(iteration, epoch)
        return self.learningRate

    def init(self, param) -> Dict[str, Any]:
        return {}

    def apply(self, grad, state, lr, iteration, epoch=0, param=None
              ) -> Tuple[Any, Dict[str, Any]]:
        """``param`` is the current parameter value — only updaters with
        decoupled decay (AdamW) use it; train steps always pass it."""
        raise NotImplementedError

    def stateSize(self, numParams: int) -> int:
        return 0

    # -- serde ----------------------------------------------------------
    def toJson(self) -> dict:
        # the reference's key order: a schedule moves to the end
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if not isinstance(v, dict) or k != "learningRateSchedule"}
        if self.learningRateSchedule is not None:
            d["learningRateSchedule"] = self.learningRateSchedule.toJson()
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def fromJson(d: dict) -> "IUpdater":
        d = dict(d)
        cls = _REGISTRY[d.pop("@class")]
        for k in ("learningRateSchedule", "momentumSchedule"):
            if d.get(k):
                d[k] = ISchedule.fromJson(d[k])
        return cls(**d)


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
class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter): the decay
    term ``wd * lr * param`` is added to the update after the Adam step
    (train steps pass ``param``; without it decay is skipped)."""
    weightDecay: float = 0.0

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        update, new_state = Adam.apply(self, grad, state, lr, iteration,
                                       epoch)
        if self.weightDecay and param is not None:
            update = update + self.weightDecay * lr * param
        return update, new_state


@dataclasses.dataclass
class AdaMax(Adam):
    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        t = iteration + 1
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        u = torch.maximum(self.beta2 * state["v"], torch.abs(grad))
        a = lr / (1 - _f32pow(self.beta1, t))
        return a * m / (u + self.epsilon), {"m": m, "v": u}


@dataclasses.dataclass
class AMSGrad(Adam):
    def init(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "vHat": torch.zeros_like(param)}

    def stateSize(self, n):
        return 3 * n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        t = iteration + 1
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        vHat = torch.maximum(state["vHat"], v)
        a = lr * torch.sqrt(1 - _f32pow(self.beta2, t)) \
            / (1 - _f32pow(self.beta1, t))
        return a * m / (torch.sqrt(vHat) + self.epsilon), \
            {"m": m, "v": v, "vHat": vHat}


@dataclasses.dataclass
class Nadam(Adam):
    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        t = iteration + 1
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        c1 = 1 - _f32pow(self.beta1, t)
        mHat = m / c1
        vHat = v / (1 - _f32pow(self.beta2, t))
        mBar = self.beta1 * mHat + (1 - self.beta1) * grad / c1
        return lr * mBar / (torch.sqrt(vHat) + self.epsilon), \
            {"m": m, "v": v}


@dataclasses.dataclass
class Nesterovs(IUpdater):
    learningRate: float = 0.1
    momentum: float = 0.9
    momentumSchedule: Optional[ISchedule] = None

    def init(self, param):
        return {"v": torch.zeros_like(param)}

    def stateSize(self, n):
        return n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        mu = (self.momentumSchedule.valueAt(iteration, epoch)
              if self.momentumSchedule is not None else self.momentum)
        # the reference's NesterovsUpdater: v = mu*v_prev - lr*g, and the
        # param moves by -mu*v_prev + (1+mu)*v; the caller subtracts the
        # returned update, so it is negated
        vPrev = state["v"]
        v = mu * vPrev - lr * grad
        update = mu * vPrev - (1 + mu) * v
        return update, {"v": v}

    def toJson(self) -> dict:
        d = IUpdater.toJson(self)
        if self.momentumSchedule is not None:
            d["momentumSchedule"] = self.momentumSchedule.toJson()
        return d




@dataclasses.dataclass
class RmsProp(IUpdater):
    learningRate: float = 1e-1
    rmsDecay: float = 0.95
    epsilon: float = 1e-8

    def init(self, param):
        return {"g": torch.zeros_like(param)}

    def stateSize(self, n):
        return n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        g = self.rmsDecay * state["g"] + (1 - self.rmsDecay) * grad * grad
        return lr * grad / (torch.sqrt(g) + self.epsilon), {"g": g}


@dataclasses.dataclass
class AdaGrad(IUpdater):
    learningRate: float = 1e-1
    epsilon: float = 1e-6

    def init(self, param):
        return {"h": torch.zeros_like(param)}

    def stateSize(self, n):
        return n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        h = state["h"] + grad * grad
        return lr * grad / (torch.sqrt(h) + self.epsilon), {"h": h}


@dataclasses.dataclass
class AdaDelta(IUpdater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, param):
        return {"msg": torch.zeros_like(param),
                "msdx": torch.zeros_like(param)}

    def stateSize(self, n):
        return 2 * n

    def apply(self, grad, state, lr, iteration, epoch=0, param=None):
        msg = self.rho * state["msg"] + (1 - self.rho) * grad * grad
        dx = grad * torch.sqrt(state["msdx"] + self.epsilon) \
            / torch.sqrt(msg + self.epsilon)
        msdx = self.rho * state["msdx"] + (1 - self.rho) * dx * dx
        return dx, {"msg": msg, "msdx": msdx}


_REGISTRY = {c.__name__: c for c in [
    Sgd, NoOp, Adam, AdamW, AdaMax, AMSGrad, Nadam, Nesterovs, RmsProp,
    AdaGrad, AdaDelta]}
