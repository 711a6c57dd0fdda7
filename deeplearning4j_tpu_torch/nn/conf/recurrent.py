"""Recurrent-format layers — the port of ``deeplearning4j_tpu/nn/conf/
recurrent.py``.  So far only ``RnnOutputLayer``; LSTM, GravesLSTM, GRU,
SimpleRnn, Bidirectional, LastTimeStep and RnnLossLayer wait for ROADMAP A8.
"""
from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, register_layer
from deeplearning4j_tpu_torch.nn.lossfunctions import get_loss

__all__ = ["RnnOutputLayer"]


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense + activation + loss over (b, n, t).
    Reference: ``conf/layers/RnnOutputLayer.java`` — the dense projection
    at every step, loss masked per (example, step)."""
    lossFunction: str = "mcxent"

    acceptsMask = True

    @classmethod
    def _builderArgs(cls, b, *args):
        if args:
            b._kw["lossFunction"] = args[0]

    def preferredFormat(self):
        return "RNN"

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, inputType.timeSeriesLength)

    def hasLoss(self) -> bool:
        return True

    def computeScore(self, labels, output, mask=None):
        """labels/output (b, nOut, t), mask (b, t) -> per-example scores."""
        return get_loss(self.lossFunction)(labels, output, mask)

    def forward(self, params, x, train, gen, state, mask=None):
        x = self._dropin(x, train, gen)
        y = torch.einsum("bnt,nh->bht", x, params["W"])
        if self.hasBias:
            y = y + params["b"][:, None]
        if (self.activation or "softmax") == "softmax":
            # softmax over the feature axis (axis 1 of (b, n, t))
            y = torch.softmax(y, dim=1)
        else:
            y = get_activation(self.activation)(y)
        if mask is not None:
            y = y * mask[:, None, :]
        return y, state
