"""Regularization — the port of ``deeplearning4j_tpu/learning/
regularization.py`` (the reference's ``org/nd4j/linalg/learning/
regularization/{L1,L2,WeightDecay}.java``).  L1 and L2 modify the
gradient before the updater (``ApplyStep.BEFORE_UPDATER``); the models add
their ``score`` to the loss, which gives the same gradient.  WeightDecay
modifies the update after the updater, scaled by the current learning rate
(``ApplyStep.POST_UPDATER``).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Regularization", "L1Regularization", "L2Regularization",
           "WeightDecay"]


@dataclasses.dataclass
class Regularization:
    def applyStep(self) -> str:
        return "BEFORE_UPDATER"

    def apply(self, param, grad_or_update, lr):
        raise NotImplementedError

    def score(self, param) -> float:
        return 0.0

    def toJson(self):
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def fromJson(d):
        d = dict(d)
        return _REGISTRY[d.pop("@class")](**d)


@dataclasses.dataclass
class L2Regularization(Regularization):
    l2: float = 0.0

    def apply(self, param, grad, lr):
        return grad + self.l2 * param

    def score(self, param):
        return 0.5 * self.l2 * torch.sum(param * param)


@dataclasses.dataclass
class L1Regularization(Regularization):
    l1: float = 0.0

    def apply(self, param, grad, lr):
        return grad + self.l1 * torch.sign(param)

    def score(self, param):
        return self.l1 * torch.sum(torch.abs(param))


@dataclasses.dataclass
class WeightDecay(Regularization):
    coeff: float = 0.0
    applyLR: bool = True

    def applyStep(self) -> str:
        return "POST_UPDATER"

    def apply(self, param, update, lr):
        scale = lr if self.applyLR else 1.0
        return update + self.coeff * scale * param


_REGISTRY = {c.__name__: c for c in
             [L1Regularization, L2Regularization, WeightDecay]}
