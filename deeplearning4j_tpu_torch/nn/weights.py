"""Weight initialization — the port of ``deeplearning4j_tpu/nn/weights.py``
(the reference's ``WeightInit`` / ``WeightInitUtil``).  DL4J's XAVIER is
Glorot-*normal* with variance 2/(fanIn+fanOut), RELU is He-normal 2/fanIn.

Draws come from an explicit ``torch.Generator`` on the CPU, then move to
the device: the same generator state gives the same weights on any device.
The distributions are the reference's; the numbers are not (the two RNGs
differ), so parity tests copy parameters instead of drawing them twice.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["WeightInit", "init_weight"]


class WeightInit:
    ZERO = "ZERO"
    ONES = "ONES"
    IDENTITY = "IDENTITY"
    NORMAL = "NORMAL"                  # N(0, 1/sqrt(fanIn))
    UNIFORM = "UNIFORM"                # U(-a, a), a = 1/sqrt(fanIn)
    XAVIER = "XAVIER"                  # N(0, sqrt(2/(fanIn+fanOut)))
    XAVIER_UNIFORM = "XAVIER_UNIFORM"  # U(+-sqrt(6/(fanIn+fanOut)))
    XAVIER_FAN_IN = "XAVIER_FAN_IN"    # N(0, sqrt(1/fanIn))
    RELU = "RELU"                      # He normal: N(0, sqrt(2/fanIn))
    RELU_UNIFORM = "RELU_UNIFORM"      # U(+-sqrt(6/fanIn))
    LECUN_NORMAL = "LECUN_NORMAL"      # N(0, sqrt(1/fanIn))
    LECUN_UNIFORM = "LECUN_UNIFORM"    # U(+-sqrt(3/fanIn))
    SIGMOID_UNIFORM = "SIGMOID_UNIFORM"  # U(+-4*sqrt(6/(fanIn+fanOut)))
    VAR_SCALING_NORMAL_FAN_IN = "VAR_SCALING_NORMAL_FAN_IN"
    VAR_SCALING_NORMAL_FAN_OUT = "VAR_SCALING_NORMAL_FAN_OUT"
    VAR_SCALING_NORMAL_FAN_AVG = "VAR_SCALING_NORMAL_FAN_AVG"
    VAR_SCALING_UNIFORM_FAN_IN = "VAR_SCALING_UNIFORM_FAN_IN"
    VAR_SCALING_UNIFORM_FAN_OUT = "VAR_SCALING_UNIFORM_FAN_OUT"
    VAR_SCALING_UNIFORM_FAN_AVG = "VAR_SCALING_UNIFORM_FAN_AVG"


def init_weight(gen: torch.Generator, shape, fan_in: int, fan_out: int,
                scheme: str, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Initialize one weight tensor (``WeightInitUtil.initWeights``),
    drawing from ``gen`` (a CPU generator)."""
    s = str(scheme).upper()
    shape = tuple(int(d) for d in shape)
    fi, fo = max(int(fan_in), 1), max(int(fan_out), 1)

    def normal(std):
        return torch.randn(shape, generator=gen, dtype=dtype) * std

    def uniform(a):
        return (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1) * a

    def draw():
        if s == WeightInit.ZERO:
            return torch.zeros(shape, dtype=dtype)
        if s == WeightInit.ONES:
            return torch.ones(shape, dtype=dtype)
        if s == WeightInit.IDENTITY:
            if len(shape) != 2 or shape[0] != shape[1]:
                raise ValueError("IDENTITY init requires square 2d shape")
            return torch.eye(shape[0], dtype=dtype)
        if s == WeightInit.NORMAL:
            return normal(1.0 / np.sqrt(fi))
        if s == WeightInit.UNIFORM:
            return uniform(1.0 / np.sqrt(fi))
        if s == WeightInit.XAVIER:
            return normal(np.sqrt(2.0 / (fi + fo)))
        if s == WeightInit.XAVIER_UNIFORM:
            return uniform(np.sqrt(6.0 / (fi + fo)))
        if s in (WeightInit.XAVIER_FAN_IN, WeightInit.LECUN_NORMAL):
            return normal(np.sqrt(1.0 / fi))
        if s == WeightInit.RELU:
            return normal(np.sqrt(2.0 / fi))
        if s == WeightInit.RELU_UNIFORM:
            return uniform(np.sqrt(6.0 / fi))
        if s == WeightInit.LECUN_UNIFORM:
            return uniform(np.sqrt(3.0 / fi))
        if s == WeightInit.SIGMOID_UNIFORM:
            return uniform(4.0 * np.sqrt(6.0 / (fi + fo)))
        if s.startswith("VAR_SCALING"):
            # parse: VAR_SCALING_{NORMAL|UNIFORM}_FAN_{IN|OUT|AVG}
            parts = s.split("_")
            fan = "_".join(parts[3:])
            denom = {"FAN_IN": fi, "FAN_OUT": fo,
                     "FAN_AVG": (fi + fo) / 2.0}[fan]
            if parts[2] == "NORMAL":
                return normal(np.sqrt(1.0 / denom))
            return uniform(np.sqrt(3.0 / denom))
        raise ValueError(f"Unknown weight init scheme: {scheme!r}")

    return draw().to(device)
