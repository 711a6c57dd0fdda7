"""Loss functions — the port of ``deeplearning4j_tpu/nn/lossfunctions.py``
(the reference's ``ILossFunction`` impls and ``LossFunctions.LossFunction``
enum).  Each loss maps ``(labels, output-after-activation, mask) ->
per-example scores``; the scalar score is the mean over examples.
Gradients come from autograd of the scalar.

The reference's semantics are kept where they surprise: ``_mse`` (and
``_mae``, ``_mape``, ``_msle``) divide by ``labels.shape[-1]``, which on
an RNN's (b, n, t) labels is the time length t, not the feature count n
(ROADMAP queue C).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

__all__ = ["LossFunctions", "LossFunction", "get_loss"]

_EPS = 1e-7


def _reduce(per_elem, mask):
    """Per-example score: sum over feature dims; mask weights
    examples/steps (a (b, t) mask on (b, n, t) scores applies per step)."""
    if mask is not None and per_elem.dim() == 3 and mask.dim() == 2:
        per_elem = per_elem * mask[:, None, :]
        mask = None
    dims = tuple(range(1, per_elem.dim()))
    per_ex = per_elem.sum(dim=dims) if dims else per_elem
    if mask is not None:
        per_ex = per_ex * mask.reshape(per_ex.shape)
    return per_ex


def _sum_rest(x):
    return x.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x


def _mcxent(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0 - _EPS)
    return _reduce(-labels * torch.log(p), mask)


def _sparse_mcxent(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0 - _EPS)
    idx = labels.long()
    per_ex = -_sum_rest(torch.gather(torch.log(p), -1, idx[..., None])[..., 0])
    if mask is not None:
        per_ex = per_ex * mask.reshape(per_ex.shape)
    return per_ex


def _mse(labels, output, mask=None):
    d = output - labels
    return _reduce(d * d / labels.shape[-1], mask)


def _l2(labels, output, mask=None):
    d = output - labels
    return _reduce(d * d, mask)


def _l1(labels, output, mask=None):
    return _reduce(torch.abs(output - labels), mask)


def _mae(labels, output, mask=None):
    return _reduce(torch.abs(output - labels) / labels.shape[-1], mask)


def _xent(labels, output, mask=None):
    """Binary cross-entropy (sigmoid outputs)."""
    p = torch.clamp(output, _EPS, 1.0 - _EPS)
    return _reduce(-(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)),
                   mask)


def _hinge(labels, output, mask=None):
    y = torch.where(labels > 0, 1.0, -1.0)
    return _reduce(torch.clamp(1.0 - y * output, min=0.0), mask)


def _squared_hinge(labels, output, mask=None):
    y = torch.where(labels > 0, 1.0, -1.0)
    return _reduce(torch.clamp(1.0 - y * output, min=0.0) ** 2, mask)


def _cosine(labels, output, mask=None):
    ln = labels / (torch.linalg.norm(labels, dim=-1, keepdim=True) + _EPS)
    on = output / (torch.linalg.norm(output, dim=-1, keepdim=True) + _EPS)
    per_ex = _sum_rest(1.0 - torch.sum(ln * on, dim=-1))
    if mask is not None:
        per_ex = per_ex * mask.reshape(per_ex.shape)
    return per_ex


def _poisson(labels, output, mask=None):
    p = torch.clamp(output, min=_EPS)
    return _reduce(p - labels * torch.log(p), mask)


def _kld(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0)
    q = torch.clamp(labels, _EPS, 1.0)
    return _reduce(q * (torch.log(q) - torch.log(p)), mask)


def _mape(labels, output, mask=None):
    return _reduce(100.0 * torch.abs((labels - output) /
                                     torch.clamp(torch.abs(labels), min=_EPS))
                   / labels.shape[-1], mask)


def _msle(labels, output, mask=None):
    d = torch.log1p(torch.clamp(output, min=-1 + _EPS)) - \
        torch.log1p(torch.clamp(labels, min=-1 + _EPS))
    return _reduce(d * d / labels.shape[-1], mask)


_REGISTRY: Dict[str, Callable] = {
    "mcxent": _mcxent,
    "negativeloglikelihood": _mcxent,
    "sparse_mcxent": _sparse_mcxent,
    "mse": _mse,
    "squared_loss": _mse,
    "l1": _l1,
    "l2": _l2,
    "mean_absolute_error": _mae,
    "xent": _xent,
    "hinge": _hinge,
    "squared_hinge": _squared_hinge,
    "cosine_proximity": _cosine,
    "poisson": _poisson,
    "kl_divergence": _kld,
    "reconstruction_crossentropy": _xent,
    "mean_absolute_percentage_error": _mape,
    "mean_squared_logarithmic_error": _msle,
}


class LossFunction:
    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    SPARSE_MCXENT = "sparse_mcxent"
    MSE = "mse"
    SQUARED_LOSS = "squared_loss"
    L1 = "l1"
    L2 = "l2"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    XENT = "xent"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    COSINE_PROXIMITY = "cosine_proximity"
    POISSON = "poisson"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"


class LossFunctions:
    LossFunction = LossFunction


def get_loss(name) -> Callable:
    """Return ``loss(labels, output, mask=None) -> per-example scores``."""
    if callable(name):
        return name
    key = str(name).lower()
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(f"Unknown loss function: {name!r}. "
                         f"Available: {sorted(_REGISTRY)}")
