"""Line-search solvers: L-BFGS, conjugate gradient, line gradient descent
— the port of ``deeplearning4j_tpu/optimize/solvers.py`` (deeplearning4j-
nn's ``org/deeplearning4j/optimize/solvers/{LBFGS,ConjugateGradient,
LineGradientDescent,BackTrackLineSearch}.java``), the full-batch solvers
``NeuralNetConfiguration.builder().optimizationAlgo(...)`` selects.

The loss and its gradient are over the flat parameter vector (the
model's leaves in sorted key order, as the reference's
``ravel_pytree``), by ``torch.autograd``; the solver itself (two-loop
recursion, Polak-Ribière beta, Armijo backtracking) is vector algebra on
the vector's device, with one host read of the loss per probe, as in the
reference.  Each ``fit`` call makes one line-searched iteration on its
batch; the L-BFGS curvature history stays on the solver across calls.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["BackTrackLineSearch", "LBFGS", "ConjugateGradient",
           "LineGradientDescent", "make_solver", "InvalidStepException"]


class InvalidStepException(ArithmeticError):
    """Reference: ``org.deeplearning4j.exception.InvalidStepException`` —
    the loss went NaN/Inf, so no line search can make progress."""


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


class BackTrackLineSearch:
    """Armijo backtracking (reference: BackTrackLineSearch.java)."""

    def __init__(self, maxIterations: int = 5, c1: float = 1e-4,
                 backtrack: float = 0.5, initialStep: float = 1.0):
        self.maxIterations = max(1, int(maxIterations))
        self.c1 = c1
        self.backtrack = backtrack
        self.initialStep = initialStep

    def search(self, loss_fn: Callable, x: torch.Tensor, f0: float,
               g: torch.Tensor, d: torch.Tensor):
        """Returns ``(alpha, new_x, new_f)``; alpha 0 if no decrease was
        found."""
        slope = _dot(g, d)
        if slope >= 0:          # not a descent direction
            return 0.0, x, f0
        alpha = self.initialStep
        for _ in range(self.maxIterations):
            x_new = x + alpha * d
            f_new = float(loss_fn(x_new))
            if np.isfinite(f_new) and f_new <= f0 + self.c1 * alpha * slope:
                return alpha, x_new, f_new
            alpha *= self.backtrack
        return 0.0, x, f0


class _FlatSolver:
    """Shared machinery: the loss and its gradient over the flat vector."""

    def __init__(self, maxLineSearchIterations: int = 5):
        self.lineSearch = BackTrackLineSearch(maxLineSearchIterations)
        self._loss = None
        self._valgrad = None

    def bind(self, loss_fn: Callable):
        """``loss_fn``: (flat vector, *batch) -> scalar loss tensor, a pure
        function of its arguments; the batch is passed at each step."""
        self._loss_raw = loss_fn
        return self

    def _value_and_grad(self, v: torch.Tensor, *batch):
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self._loss_raw(v, *batch)
            (g,) = torch.autograd.grad(f, [v])
        return f.detach(), g

    def step(self, x: torch.Tensor, *batch) -> tuple:
        """One line-searched iteration; returns ``(new_x, new_loss)``."""

        def loss(v):
            with torch.no_grad():
                return self._loss_raw(v, *batch)

        self._loss = loss
        self._valgrad = lambda v: self._value_and_grad(v, *batch)
        return self._step(x.detach())

    def _checked_valgrad(self, x):
        """Loss and gradient at the step's entry point; a non-finite loss
        raises ``InvalidStepException`` (the reference's semantics)."""
        f0, g = self._valgrad(x)
        f0 = float(f0)
        if not np.isfinite(f0):
            raise InvalidStepException(
                f"non-finite loss ({f0}) entering solver step")
        return f0, g

    def _step(self, x: torch.Tensor) -> tuple:
        raise NotImplementedError


class LineGradientDescent(_FlatSolver):
    """Steepest descent + line search (reference:
    LineGradientDescent.java)."""

    def _step(self, x):
        f0, g = self._checked_valgrad(x)
        _, x_new, f_new = self.lineSearch.search(self._loss, x, f0, g, -g)
        return x_new, float(f_new)


class ConjugateGradient(_FlatSolver):
    """Polak-Ribière nonlinear CG with automatic restart (reference:
    ConjugateGradient.java)."""

    def __init__(self, maxLineSearchIterations: int = 5):
        super().__init__(maxLineSearchIterations)
        self._g_prev: Optional[torch.Tensor] = None
        self._d_prev: Optional[torch.Tensor] = None

    def _step(self, x):
        f0, g = self._checked_valgrad(x)
        if self._g_prev is None:
            d = -g
        else:
            beta = _dot(g, g - self._g_prev) \
                / max(_dot(self._g_prev, self._g_prev), 1e-30)
            beta = max(0.0, beta)           # PR+ restart
            d = -g + beta * self._d_prev
            if _dot(g, d) >= 0:             # lost descent: restart
                d = -g
        alpha, x_new, f_new = self.lineSearch.search(self._loss, x, f0, g, d)
        if alpha == 0.0 and self._g_prev is not None:
            # stuck on a conjugate direction: restart with steepest descent
            alpha, x_new, f_new = self.lineSearch.search(
                self._loss, x, f0, g, -g)
            d = -g
        self._g_prev, self._d_prev = g, d
        return x_new, float(f_new)


class LBFGS(_FlatSolver):
    """Limited-memory BFGS two-loop recursion (reference: LBFGS.java),
    history ``m``."""

    def __init__(self, maxLineSearchIterations: int = 5, m: int = 10):
        super().__init__(maxLineSearchIterations)
        self.m = int(m)
        self._hist: deque = deque(maxlen=self.m)    # (s, y, rho)
        self._x_prev: Optional[torch.Tensor] = None
        self._g_prev: Optional[torch.Tensor] = None

    def _direction(self, g):
        q = g
        alphas = []
        for s, y, rho in reversed(self._hist):
            a = rho * _dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._hist:
            s, y, _ = self._hist[-1]
            gamma = _dot(s, y) / max(_dot(y, y), 1e-30)
            q = gamma * q
        for (s, y, rho), a in zip(self._hist, reversed(alphas)):
            b = rho * _dot(y, q)
            q = q + (a - b) * s
        return -q

    def _step(self, x):
        f0, g = self._checked_valgrad(x)
        if self._g_prev is not None:
            s = x - self._x_prev
            y = g - self._g_prev
            sy = _dot(s, y)
            if sy > 1e-10:          # curvature condition
                self._hist.append((s, y, 1.0 / sy))
        d = self._direction(g)
        alpha, x_new, f_new = self.lineSearch.search(self._loss, x, f0, g, d)
        if alpha == 0.0:
            # bad curvature model: drop history, steepest-descent step
            self._hist.clear()
            alpha, x_new, f_new = self.lineSearch.search(
                self._loss, x, f0, g, -g)
        self._x_prev, self._g_prev = x, g
        return x_new, float(f_new)


_SOLVERS = {
    "LBFGS": LBFGS,
    "CONJUGATE_GRADIENT": ConjugateGradient,
    "LINE_GRADIENT_DESCENT": LineGradientDescent,
}


def make_solver(optimizationAlgo: str, maxLineSearchIterations: int = 5):
    name = str(optimizationAlgo).upper()
    if name not in _SOLVERS:
        raise ValueError(
            f"Unknown optimizationAlgo {optimizationAlgo!r}; known: "
            f"{sorted(_SOLVERS)} or STOCHASTIC_GRADIENT_DESCENT")
    return _SOLVERS[name](maxLineSearchIterations)
