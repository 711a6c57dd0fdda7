"""Learning-rate schedules — the port of
``deeplearning4j_tpu/learning/schedules.py``.  So far only :func:`_f32pow`,
which Adam's bias correction needs; the ``ISchedule`` family waits for
ROADMAP A3."""
from __future__ import annotations

import torch


def _f32pow(base, exponent):
    """base^exponent in float32, as the reference computes Adam's
    ``beta^t`` (a 0-d float32 tensor on the CPU, usable as a scalar with
    tensors on any device)."""
    return torch.pow(torch.tensor(base, dtype=torch.float32),
                     torch.tensor(exponent, dtype=torch.float32))
