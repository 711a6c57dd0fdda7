"""t-SNE — the port of ``deeplearning4j_tpu/clustering/tsne.py``.

Reference: deeplearning4j-core ``org/deeplearning4j/plot/BarnesHutTsne.java``.

As in the reference, the gradient is the exact dense (N, N) one (theta =
0 semantics; the ``theta`` knob is accepted for API parity), here two
matmul-shaped passes on the device per iteration; the gains/momentum
update follows the reference rule exactly (the ``barnesGains`` op is its
registry form).

P (the perplexity binary search) is built host-side in float64 numpy,
the reference's own code: once, before iterating.  ``initialY`` starts
the embedding from given values instead of the seeded draw.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

__all__ = ["BarnesHutTsne"]


def _conditional_p(D: np.ndarray, perplexity: float,
                   tol: float = 1e-5, max_tries: int = 50) -> np.ndarray:
    """Row-wise beta binary search to the target perplexity (reference:
    BarnesHutTsne.computeGaussianPerplexity)."""
    n = D.shape[0]
    P = np.zeros((n, n), np.float64)
    logU = np.log(perplexity)
    for i in range(n):
        beta, lo, hi = 1.0, -np.inf, np.inf
        Di = np.delete(D[i], i)
        for _ in range(max_tries):
            Pi = np.exp(-Di * beta)
            sumP = max(Pi.sum(), 1e-12)
            H = np.log(sumP) + beta * float((Di * Pi).sum()) / sumP
            diff = H - logU
            if abs(diff) < tol:
                break
            if diff > 0:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        Pi = np.exp(-Di * beta)
        Pi /= max(Pi.sum(), 1e-12)
        P[i, np.arange(n) != i] = Pi
    return P


def _joint_p(X: np.ndarray, perplexity: float) -> np.ndarray:
    """The symmetrized joint P of the reference, float64."""
    n = X.shape[0]
    # ||x||^2 + ||y||^2 - 2XY^T form: the broadcasted (n, n, d)
    # difference tensor would be O(n^2 d) host memory
    sq = (X * X).sum(1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    P = _conditional_p(D, perplexity)
    P = (P + P.T) / (2.0 * n)                   # symmetrize (joint)
    return np.maximum(P, 1e-12)


def _tsne_step(Y, inc, gains, P_eff, not_eye, mom: float, lr: float):
    """One exact-gradient iteration: the new (Y, inc, gains) and the Q it
    measured (before the update)."""
    sq = (Y * Y).sum(1)
    D2 = sq[:, None] + sq[None, :] - 2.0 * (Y @ Y.T)
    num = torch.where(not_eye, 1.0 / (1.0 + D2), torch.zeros_like(D2))
    Q = torch.clamp_min(num / num.sum(), 1e-12)
    W = (P_eff - Q) * num                       # (n, n)
    # (diag(rowsum W) - W) @ Y, without the (n, n) diagonal matrix
    grad = 4.0 * (W.sum(1)[:, None] * Y - W @ Y)
    # reference gains rule (the barnesGains op)
    same = torch.sign(grad) == torch.sign(inc)
    gains = torch.clamp_min(torch.where(same, gains * 0.8, gains + 0.2),
                            0.01)
    inc = mom * inc - lr * gains * grad
    Y = Y + inc
    return Y - Y.mean(0), inc, gains, Q


class BarnesHutTsne:
    """Reference-shaped builder-free config; ``fit(X)`` returns and
    stores the (N, numDimension) embedding."""

    def __init__(self, numDimension: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learningRate: float = 200.0,
                 maxIter: int = 500, momentum: float = 0.5,
                 finalMomentum: float = 0.8, switchMomentumIteration: int = 250,
                 stopLyingIteration: int = 100, exaggeration: float = 12.0,
                 seed: int = 42, device=None, initialY=None):
        self.numDimension = numDimension
        self.perplexity = perplexity
        self.theta = theta          # accepted for parity; dense-exact here
        self.learningRate = learningRate
        self.maxIter = maxIter
        self.momentum = momentum
        self.finalMomentum = finalMomentum
        self.switchMomentumIteration = switchMomentumIteration
        self.stopLyingIteration = stopLyingIteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.initialY = initialY
        self.Y: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def fit(self, X) -> np.ndarray:
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        if self.perplexity * 3 > n - 1:
            raise ValueError(f"perplexity {self.perplexity} too large for "
                             f"{n} samples (needs 3*perplexity < n)")
        dev = self.device
        Pj = torch.as_tensor(_joint_p(X, self.perplexity)).to(
            dev, torch.float32)
        if self.initialY is not None:
            Y = torch.from_numpy(np.array(self.initialY, np.float32)).to(dev)
            if tuple(Y.shape) != (n, self.numDimension):
                raise ValueError(f"initialY of shape {tuple(Y.shape)}, "
                                 f"expected {(n, self.numDimension)}")
        else:
            # a host generator: the same start on every device
            gen = torch.Generator().manual_seed(int(self.seed))
            Y = (1e-4 * torch.randn((n, self.numDimension),
                                    generator=gen)).to(dev)
        inc = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        not_eye = ~torch.eye(n, dtype=torch.bool, device=dev)
        P_lying = Pj * self.exaggeration
        Q = None
        for it in range(self.maxIter):
            P_eff = P_lying if it < self.stopLyingIteration else Pj
            mom = self.momentum if it < self.switchMomentumIteration \
                else self.finalMomentum
            Y, inc, gains, Q = _tsne_step(Y, inc, gains, P_eff, not_eye,
                                          mom, self.learningRate)
        # KL of the last iteration's Q against the TRUE P (not the
        # exaggerated P_eff the gradient uses during early lying
        # iterations), as the reference reports it
        self.klDivergence = float((Pj * torch.log(Pj / Q)).sum()) \
            if Q is not None else float("nan")
        self.Y = Y.cpu().numpy()
        return self.Y

    def getData(self) -> np.ndarray:
        if self.Y is None:
            raise ValueError("fit first")
        return self.Y

    def saveAsFile(self, labels, path: str) -> None:
        """Reference: BarnesHutTsne.saveAsFile — tab-separated
        ``y0 y1 ... label`` rows."""
        Y = self.getData()
        with open(path, "w", encoding="utf-8") as f:
            for row, lab in zip(Y, labels):
                f.write("\t".join(f"{v:.6f}" for v in row)
                        + f"\t{lab}\n")
