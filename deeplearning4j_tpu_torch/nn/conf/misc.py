"""Misc layers — the port of ``deeplearning4j_tpu/nn/conf/misc.py``.  So
far ``MaskingLayer``, which the recurrent path needs; the rest of the
module waits for ROADMAP A9.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer

__all__ = ["MaskingLayer"]


@register_layer
@dataclasses.dataclass
class MaskingLayer(BaseLayer):
    """Computes a timestep mask from the data: a step whose features all
    equal ``maskValue`` is masked for every downstream mask-aware layer
    (recurrent scans keep their carry, LastTimeStep picks the last valid
    step).  Values pass through unchanged — keras ``Masking`` semantics;
    the mask rides the forward's mask channel."""
    maskValue: float = 0.0

    #: the models' forward replaces the active mask with computeMask's
    producesMask = True

    def getOutputType(self, inputType):
        return inputType

    def computeMask(self, x, mask):
        # x: (b, f, t) — a step is valid if any feature differs from the
        # sentinel; an incoming mask ANDs in (keras: masks AND up)
        m = (x != self.maskValue).any(dim=1).float()
        if mask is not None:
            m = m * mask.to(m.dtype)
        return m

    def forward(self, params, x, train, gen, state):
        return x, state
