"""Numeric-against-analytic gradient checking — the port of
``deeplearning4j_tpu/autodiff/gradcheck.py`` (the reference's
``org/deeplearning4j/gradientcheck/GradientCheckUtil.java``): central
differences in float64 against autograd, per-coordinate relative errors.

The analytic side is ``torch.autograd.grad`` of the loss at the float64
parameters; the numeric side perturbs each scalar coordinate by ±eps.
Parameters stay on their device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np
import torch
from torch.utils._pytree import (keystr, tree_flatten_with_path,
                                 tree_unflatten)

__all__ = ["GradCheckResult", "check_gradients", "GradientCheckUtil"]

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8


@dataclasses.dataclass
class GradCheckResult:
    passed: bool
    totalParams: int
    totalFailures: int
    maxRelError: float
    # (path, index, analytic, numeric, relative error)
    failures: List[Tuple[str, int, float, float, float]]

    def __bool__(self):
        return self.passed


def _to64(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float64)
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def check_gradients(loss_fn: Callable[[Any], Any], params: Any,
                    eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    max_per_param: int = 0,
                    subset_stride: int = 1,
                    seed: int = 12345) -> GradCheckResult:
    """Central-difference check of autograd's gradient of ``loss_fn`` at
    ``params`` (a pytree of tensors or arrays).  ``max_per_param`` > 0
    samples that many coordinates of each tensor (the reference's
    ``maxPerParam`` for big nets)."""
    flat, spec = tree_flatten_with_path(params)
    paths = [keystr(p) for p, _ in flat]
    leaves = [_to64(v) for _, v in flat]

    def loss_at(vals):
        return loss_fn(tree_unflatten(vals, spec)).to(torch.float64).sum()

    req = [v.clone().requires_grad_(True) for v in leaves]
    analytic = torch.autograd.grad(loss_at(req), req, allow_unused=True)
    rng = np.random.RandomState(seed)
    failures, max_rel, total = [], 0.0, 0
    with torch.no_grad():
        for li, (leaf, g) in enumerate(zip(leaves, analytic)):
            ga = (torch.zeros_like(leaf) if g is None else g).reshape(-1) \
                .cpu().numpy()
            idxs = np.arange(0, leaf.numel(), subset_stride)
            if max_per_param and len(idxs) > max_per_param:
                idxs = rng.choice(idxs, size=max_per_param, replace=False)
            for i in idxs:
                total += 1
                vals = list(leaves)
                pert = leaf.clone().reshape(-1)
                pert[i] += eps
                vals[li] = pert.reshape(leaf.shape)
                up = float(loss_at(vals))
                pert[i] -= 2 * eps
                down = float(loss_at(vals))
                numeric = (up - down) / (2 * eps)
                a = float(ga[i])
                denom = abs(a) + abs(numeric)
                rel = 0.0 if denom == 0 else abs(a - numeric) / denom
                if rel > max_rel_error and abs(a - numeric) > min_abs_error:
                    failures.append((paths[li], int(i), a, numeric, rel))
                max_rel = max(max_rel, rel)
    return GradCheckResult(passed=not failures, totalParams=total,
                           totalFailures=len(failures), maxRelError=max_rel,
                           failures=failures[:50])


class GradientCheckUtil:
    """DL4J-named facade."""
    checkGradients = staticmethod(check_gradients)
