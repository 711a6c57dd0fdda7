"""Activation functions — the port of ``deeplearning4j_tpu/nn/activations.py``
(the reference's ``IActivation`` impls and ``Activation`` enum).

Forward only: backprop comes from autograd through the whole step.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

__all__ = ["Activation", "get_activation"]


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


_REGISTRY: Dict[str, Callable] = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": _relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    # DL4J RationalTanh: 1.7159 * tanh(2x/3) approximation family
    "rationaltanh": lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "silu": F.silu,
    # keras/MobileNetV3 piecewise-linear family: relu6(x+3)/6-based
    # ("hardsigmoid" above keeps the reference's 0.2x+0.5 definition)
    "hardsigmoid6": lambda x: _relu6(x + 3.0) / 6.0,
    "hardswish": lambda x: x * _relu6(x + 3.0) / 6.0,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "cube": lambda x: x ** 3,
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, 0.0),
}


class Activation:
    """Enum-style accessors (``Activation.RELU`` etc.)."""
    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    HARDTANH = "hardtanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    MISH = "mish"
    CUBE = "cube"
    THRESHOLDEDRELU = "thresholdedrelu"


#: activations that accept one parameter via the string form "name:value"
#: (keeps parameterized activations JSON-serializable in the config DSL)
_PARAMETERIZED: Dict[str, Callable] = {
    "thresholdedrelu": lambda th: (lambda x: torch.where(x > th, x, 0.0)),
    "leakyrelu": lambda a: (lambda x: F.leaky_relu(x, a)),
    "elu": lambda a: (lambda x: torch.where(x > 0, x, a * torch.expm1(x))),
    # "softmax:1" = softmax over the channel/feature axis of (b, f, t) /
    # NCHW / NCDHW tensors (axis -1 would be time/width)
    "softmax": lambda ax: (lambda x: torch.softmax(x, dim=int(ax))),
    "clippedrelu": lambda m: (lambda x: torch.clamp(torch.relu(x), 0.0, m)),
}


def get_activation(name) -> Callable:
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    if ":" in key:
        base, _, arg = key.partition(":")
        if base in _PARAMETERIZED:
            return _PARAMETERIZED[base](float(arg))
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(f"Unknown activation: {name!r}. "
                         f"Available: {sorted(_REGISTRY)}")
