"""K-means clustering — the port of ``deeplearning4j_tpu/clustering/kmeans.py``.

Reference: nearestneighbor-core
``org/deeplearning4j/clustering/kmeans/KMeansClustering.java`` +
``cluster/ClusterSet``.

One Lloyd iteration (assign + recentre) runs on the device over the full
(N, D) matrix: the assignment is a matmul-shaped pairwise-distance
reduce, the update a scatter-add of the points into their centers'
sums.  Seeding (k-means++ under ``useKMeansPlusPlus``, else k distinct
points) is the reference's host numpy, from the same ``RandomState``.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

__all__ = ["KMeansClustering", "ClusterSet"]


class ClusterSet:
    """Reference-shaped result: centers + assignments."""

    def __init__(self, centers: np.ndarray, assignments: np.ndarray,
                 inertia: float):
        self.centers = centers
        self.assignments = assignments
        self.inertia = inertia

    def getClusterCount(self) -> int:
        return int(self.centers.shape[0])

    def getCenters(self) -> np.ndarray:
        return self.centers

    def classifyPoint(self, point) -> int:
        d = ((self.centers - np.asarray(point)[None, :]) ** 2).sum(-1)
        return int(np.argmin(d))


def _lloyd(X, xx, centers, k: int):
    """One Lloyd iteration on the device: (new centers, assignments,
    inertia, the largest squared center shift).  An empty cluster keeps
    its center."""
    d2 = xx[:, None] + (centers * centers).sum(1)[None, :] \
        - 2.0 * (X @ centers.T)
    mins, assign = d2.min(dim=1)
    counts = torch.bincount(assign, minlength=k).to(X.dtype)
    sums = torch.zeros_like(centers).index_add_(0, assign, X)
    new = torch.where(counts[:, None] > 0,
                      sums / counts.clamp_min(1.0)[:, None], centers)
    shift = ((new - centers) ** 2).sum(1).max()
    return new, assign, mins.sum(), shift


class KMeansClustering:
    """``KMeansClustering.setup(k, maxIter, 'euclidean')`` then
    ``applyTo(points)`` (reference API shape)."""

    def __init__(self, k: int, maxIterations: int = 100,
                 distanceFunction: str = "euclidean",
                 useKMeansPlusPlus: bool = True, seed: int = 0,
                 tol: float = 1e-6, device=None):
        if distanceFunction not in ("euclidean",):
            raise ValueError("only euclidean k-means is supported "
                             "(the reference's default)")
        self.k = int(k)
        self.maxIterations = int(maxIterations)
        self.useKMeansPlusPlus = useKMeansPlusPlus
        self.seed = seed
        self.tol = tol
        self.device = resolve_device(device)

    @staticmethod
    def setup(k: int, maxIterations: int = 100,
              distanceFunction: str = "euclidean",
              useKMeansPlusPlus: bool = True,
              seed: int = 0, device=None) -> "KMeansClustering":
        return KMeansClustering(k, maxIterations, distanceFunction,
                                useKMeansPlusPlus, seed, device=device)

    # ------------------------------------------------------------------
    def _init_centers(self, X: np.ndarray) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        n = X.shape[0]
        if not self.useKMeansPlusPlus:
            return X[rng.choice(n, self.k, replace=False)].copy()
        centers = [X[rng.randint(n)]]
        for _ in range(1, self.k):
            d2 = np.min(((X[:, None, :] - np.stack(centers)[None]) ** 2)
                        .sum(-1), axis=1)
            total = d2.sum()
            if total <= 0:           # duplicates: any point is as good
                centers.append(X[rng.randint(n)])
                continue
            centers.append(X[rng.choice(n, p=d2 / total)])
        return np.stack(centers)

    def applyTo(self, points) -> ClusterSet:
        X = np.asarray(points, np.float32)
        if X.shape[0] < self.k:
            raise ValueError(f"{X.shape[0]} points < k={self.k}")
        centers = torch.as_tensor(self._init_centers(X)).to(self.device)
        Xd = torch.as_tensor(X).to(self.device)
        xx = (Xd * Xd).sum(1)
        for _ in range(self.maxIterations):
            centers, _assign, _inertia, shift = _lloyd(Xd, xx, centers,
                                                       self.k)
            if float(shift) < self.tol:
                break
        # final consistent view: assignments/inertia AGAINST the returned
        # centers (the loop's values lag one update behind)
        _new, assign, inertia, _ = _lloyd(Xd, xx, centers, self.k)
        return ClusterSet(centers.cpu().numpy(), assign.cpu().numpy(),
                          float(inertia))
