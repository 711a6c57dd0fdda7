"""VP-tree and KD-tree exact nearest-neighbor search — the port of
``deeplearning4j_tpu/clustering/trees.py``, a copy of its host numpy.

Reference: deeplearning4j-nearestneighbors-parent
``org/deeplearning4j/clustering/vptree/VPTree.java`` (vantage-point tree
with euclidean/cosine/manhattan metrics) and ``kdtree/KDTree.java``.

Host-side structures (tree search is pointer-chasing, not a device
shape); the bulk distance computations inside each node batch through
NumPy.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


def _metric(name: str):
    name = name.lower()
    if name in ("euclidean", "l2"):
        return lambda X, y: np.linalg.norm(X - y, axis=-1)
    if name in ("manhattan", "l1"):
        return lambda X, y: np.abs(X - y).sum(axis=-1)
    if name == "cosine":
        def cos(X, y):
            num = X @ y
            den = np.linalg.norm(X, axis=-1) * np.linalg.norm(y)
            return 1.0 - num / np.maximum(den, 1e-12)
        return cos
    raise ValueError(f"unknown similarity function {name!r}")


class VPTree:
    """Vantage-point tree (reference: VPTree.java).

    ``search(target, k)`` returns (items, distances) sorted ascending.
    """

    def __init__(self, items, similarityFunction: str = "euclidean",
                 leafSize: int = 32, seed: int = 123):
        self.items = np.asarray(items, dtype=np.float64)
        self.dist = _metric(similarityFunction)
        self.leafSize = max(4, leafSize)
        self._rng = np.random.RandomState(seed)
        idx = np.arange(len(self.items))
        self._root = self._build(idx)

    def _build(self, idx: np.ndarray):
        if len(idx) == 0:
            return None
        if len(idx) <= self.leafSize:
            return ("leaf", idx)
        vp = idx[self._rng.randint(len(idx))]
        rest = idx[idx != vp]
        d = self.dist(self.items[rest], self.items[vp])
        mu = float(np.median(d))
        inner = rest[d <= mu]
        outer = rest[d > mu]
        if len(inner) == 0 or len(outer) == 0:   # degenerate split
            return ("leaf", idx)
        return ("node", vp, mu, self._build(inner), self._build(outer))

    def search(self, target, k: int) -> Tuple[List[int], List[float]]:
        target = np.asarray(target, dtype=np.float64)
        heap: List[Tuple[float, int]] = []   # max-heap via negated distance
        tau = [np.inf]

        def push(cands: np.ndarray):
            d = self.dist(self.items[cands], target)
            for di, ii in zip(d, cands):
                if len(heap) < k:
                    heapq.heappush(heap, (-di, int(ii)))
                elif di < -heap[0][0]:
                    heapq.heapreplace(heap, (-di, int(ii)))
            if len(heap) == k:
                tau[0] = -heap[0][0]

        def visit(node):
            if node is None:
                return
            if node[0] == "leaf":
                push(node[1])
                return
            _, vp, mu, inner, outer = node
            dvp = float(self.dist(self.items[vp][None], target)[0])
            push(np.array([vp]))
            if dvp <= mu:
                visit(inner)
                if dvp + tau[0] > mu:
                    visit(outer)
            else:
                visit(outer)
                if dvp - tau[0] <= mu:
                    visit(inner)

        visit(self._root)
        out = sorted((-d, i) for d, i in heap)
        return [i for _, i in out], [d for d, _ in out]


class KDTree:
    """KD-tree with median splits (reference: kdtree/KDTree.java)."""

    def __init__(self, dims_or_items, leafSize: int = 16):
        self.leafSize = max(2, leafSize)
        if isinstance(dims_or_items, int):
            self.dims = dims_or_items
            self._points: List[np.ndarray] = []
            self._root = None
        else:
            pts = np.asarray(dims_or_items, dtype=np.float64)
            self.dims = pts.shape[1]
            self._points = list(pts)
            self._root = None
            self._rebuild()

    def insert(self, point) -> None:
        self._points.append(np.asarray(point, dtype=np.float64))
        self._rebuild()   # small-scale exactness over incremental balance

    def size(self) -> int:
        return len(self._points)

    def _rebuild(self):
        if not self._points:
            self._root = None
            return
        P = np.stack(self._points)
        self._P = P
        self._root = self._build(np.arange(len(P)), 0)

    def _build(self, idx: np.ndarray, depth: int):
        if len(idx) <= self.leafSize:
            return ("leaf", idx)
        axis = depth % self.dims
        vals = self._P[idx, axis]
        order = np.argsort(vals, kind="stable")
        mid = len(idx) // 2
        m_idx = idx[order[mid]]
        left = idx[order[:mid]]
        right = idx[order[mid + 1:]]
        return ("node", m_idx, axis, float(self._P[m_idx, axis]),
                self._build(left, depth + 1), self._build(right, depth + 1))

    def nn(self, point) -> Tuple[np.ndarray, float]:
        idx, dist = self.knn(point, 1)
        return self._P[idx[0]], dist[0]

    def knn(self, point, k: int) -> Tuple[List[int], List[float]]:
        if self._root is None:
            self._rebuild()
        q = np.asarray(point, dtype=np.float64)
        heap: List[Tuple[float, int]] = []

        def push(cands):
            d = np.linalg.norm(self._P[cands] - q, axis=-1)
            for di, ii in zip(d, np.atleast_1d(cands)):
                if len(heap) < k:
                    heapq.heappush(heap, (-di, int(ii)))
                elif di < -heap[0][0]:
                    heapq.heapreplace(heap, (-di, int(ii)))

        def visit(node):
            if node is None:
                return
            if node[0] == "leaf":
                if len(node[1]):
                    push(node[1])
                return
            _, m_idx, axis, split, left, right = node
            push(np.array([m_idx]))
            first, second = (left, right) if q[axis] <= split else (right,
                                                                    left)
            visit(first)
            tau = -heap[0][0] if len(heap) == k else np.inf
            if abs(q[axis] - split) <= tau:
                visit(second)

        visit(self._root)
        out = sorted((-d, i) for d, i in heap)
        return [i for _, i in out], [d for d, _ in out]
