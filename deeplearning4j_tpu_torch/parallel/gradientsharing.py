"""Gradient sharing: threshold compression, mesh topology, update routing —
the port of ``deeplearning4j_tpu/parallel/gradientsharing.py`` (host code:
numpy over the port's own native library, the codec's torch ops from
``native.ffi``).

Reference: the P3 distributed stack of SURVEY.md §2.6/§3.4 —
``EncodedGradientsAccumulator`` + ``ThresholdAlgorithm``
(deeplearning4j-nn optimize/solvers/accumulation/encoding),
``MeshOrganizer``/``ModelParameterServer`` (nd4j-parameter-server v2), and
the ``DummyTransport`` in-process test transport.

The default data-parallel path is one gradient all-reduce a step (see
:mod:`.meshtrainer`), with no host compression.  This module keeps the
reference's gradient-sharing capability as a working HOST-side path:
sparse threshold messages with residual accumulation (kernels in C++ —
``native.threshold_encode``), the 2-bit bitmap codec (``encodeBitmap``, on
the ``dl4j::bitmap_encode`` / ``dl4j::bitmap_decode`` ops of
``native/ffi.py``), an adaptive threshold controller, and a relay-tree
mesh with node-failure remapping.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import native


class ThresholdAlgorithm:
    """Chooses the encode threshold tau each step.

    Reference: encoding/ThresholdAlgorithm.java SPI.
    """

    def threshold(self, step: int, grad: np.ndarray) -> float:
        raise NotImplementedError

    def update(self, encoded: int, total: int) -> None:
        """Feedback after a step: how many elements the message carried."""


class FixedThresholdAlgorithm(ThresholdAlgorithm):
    """Reference: FixedThresholdAlgorithm — constant tau."""

    def __init__(self, threshold: float = 1e-3):
        self.initialThreshold = float(threshold)

    def threshold(self, step, grad):
        return self.initialThreshold

    def update(self, encoded, total):
        pass


class AdaptiveThresholdAlgorithm(ThresholdAlgorithm):
    """Steers tau toward a target message sparsity.

    Reference: AdaptiveThresholdAlgorithm.java — keeps the encoded fraction
    near ``targetSparsity`` by scaling tau when a step's message is too dense
    or too sparse (dead-zone of 2x around the target).
    """

    def __init__(self, initialThreshold: float = 1e-3,
                 targetSparsity: float = 1e-3, minThreshold: float = 1e-8,
                 maxThreshold: float = 1.0, decayRate: float = 1.5):
        self.initialThreshold = float(initialThreshold)
        self._tau = float(initialThreshold)
        self.targetSparsity = float(targetSparsity)
        self.minThreshold = float(minThreshold)
        self.maxThreshold = float(maxThreshold)
        self.decayRate = float(decayRate)

    def threshold(self, step, grad):
        return self._tau

    def update(self, encoded, total):
        if total <= 0:
            return
        ratio = encoded / total
        if ratio > 2.0 * self.targetSparsity:
            self._tau = min(self._tau * self.decayRate, self.maxThreshold)
        elif ratio < 0.5 * self.targetSparsity:
            self._tau = max(self._tau / self.decayRate, self.minThreshold)


class ResidualClippingPostProcessor:
    """Clip runaway residuals every N steps.

    Reference: ResidualClippingPostProcessor.java — residual magnitudes are
    capped at ``thresholdMultiple * tau`` so stale mass can't explode.
    """

    def __init__(self, thresholdMultiple: float = 5.0, frequency: int = 5):
        self.thresholdMultiple = float(thresholdMultiple)
        self.frequency = int(frequency)

    def process(self, step: int, tau: float, residual: np.ndarray) -> None:
        if self.frequency > 0 and step % self.frequency == 0:
            cap = self.thresholdMultiple * tau
            np.clip(residual, -cap, cap, out=residual)


class EncodedGradientsAccumulator:
    """Worker-side encode/apply with residual accumulation.

    Reference: EncodedGradientsAccumulator.java.  ``encode`` folds the new
    gradient into this worker's residual, emits the sparse message (C++
    kernel, residual semantics), and returns it; ``apply`` decodes a peer's
    message onto a flat parameter/gradient vector.
    """

    def __init__(self, num_workers: int, param_count: int,
                 thresholdAlgorithm: Optional[ThresholdAlgorithm] = None,
                 residualPostProcessor: Optional[
                     ResidualClippingPostProcessor] = None):
        self.num_workers = num_workers
        self.thresholdAlgorithm = thresholdAlgorithm or \
            AdaptiveThresholdAlgorithm()
        self.residualPostProcessor = residualPostProcessor
        self._residuals = [np.zeros(param_count, dtype=np.float32)
                           for _ in range(num_workers)]
        self._steps = [0] * num_workers

    def encode(self, worker: int, grad: np.ndarray) -> dict:
        residual = self._residuals[worker]
        residual += np.asarray(grad, dtype=np.float32).ravel()
        step = self._steps[worker] = self._steps[worker] + 1
        tau = self.thresholdAlgorithm.threshold(step, residual)
        msg = native.threshold_encode(residual, tau)  # residual updated inplace
        self.thresholdAlgorithm.update(len(msg), residual.size)
        if self.residualPostProcessor is not None:
            self.residualPostProcessor.process(step, tau, residual)
        return {"indices": msg, "threshold": tau, "worker": worker}

    def encodeBitmap(self, worker: int, grad) -> dict:
        """Residual update + 2-bit bitmap packing in one call of the
        ``dl4j::bitmap_encode`` op (``native/ffi.py``: the native kernel on
        the CPU, torch ops on CUDA) — the reference's FFI path.  Same
        residual semantics as ``encode``; the message carries the dense
        bitmap words instead of indices."""
        from deeplearning4j_tpu_torch.native import ffi
        step = self._steps[worker] = self._steps[worker] + 1
        residual = self._residuals[worker]
        summed = residual + np.asarray(grad, np.float32).ravel()
        tau = float(self.thresholdAlgorithm.threshold(step, summed))
        new_r, words, count = ffi.bitmap_encode(torch.from_numpy(summed),
                                                tau)
        self._residuals[worker] = new_r.numpy()
        self.thresholdAlgorithm.update(int(count), residual.size)
        if self.residualPostProcessor is not None:
            self.residualPostProcessor.process(step, tau,
                                               self._residuals[worker])
        return {"bitmap": words.numpy(), "threshold": tau,
                "worker": worker, "count": int(count)}

    @staticmethod
    def apply(message: dict, target: np.ndarray) -> np.ndarray:
        if "bitmap" in message:
            from deeplearning4j_tpu_torch.native import ffi
            delta = ffi.bitmap_decode(message["bitmap"],
                                      message["threshold"],
                                      target.size).numpy()
            target += delta.reshape(target.shape)
            return target
        return native.threshold_decode(message["indices"],
                                       message["threshold"], target)

    def residual(self, worker: int) -> np.ndarray:
        return self._residuals[worker]


# ---------------------------------------------------------------- mesh ----

class MeshOrganizer:
    """Relay-tree topology over participating nodes.

    Reference: nd4j-parameter-server v2 ``util/MeshOrganizer.java`` — a
    root + relay tree bounding per-node fan-out; updates propagate root-down
    and leaf-up; a dead node's children are remapped to its parent.
    """

    def __init__(self, max_downstreams: int = 3):
        self.max_downstreams = max_downstreams
        self.parent: Dict[str, Optional[str]] = {}
        self.children: Dict[str, List[str]] = {}
        self.root: Optional[str] = None

    def add_node(self, node_id: str) -> None:
        if node_id in self.parent:
            return
        self.children[node_id] = []
        if self.root is None:
            self.root = node_id
            self.parent[node_id] = None
            return
        # BFS for the first node with spare fan-out: keeps the tree shallow.
        queue = [self.root]
        while queue:
            cand = queue.pop(0)
            if len(self.children[cand]) < self.max_downstreams:
                self.children[cand].append(node_id)
                self.parent[node_id] = cand
                return
            queue.extend(self.children[cand])

    def mark_node_offline(self, node_id: str) -> None:
        """Remap a dead node's children onto the surviving tree."""
        if node_id not in self.parent:
            return
        orphans = self.children.pop(node_id, [])
        p = self.parent.pop(node_id)
        if p is not None:
            self.children[p].remove(node_id)
        elif orphans:           # root died: promote first orphan
            new_root = orphans.pop(0)
            self.root = new_root
            self.parent[new_root] = None
            for o in orphans:
                self.parent.pop(o, None)
                self._readd(o)
            return
        elif self.root == node_id:
            self.root = None
            return
        for o in orphans:
            self.parent.pop(o, None)
            self._readd(o)

    def _readd(self, node_id: str) -> None:
        sub = self.children.get(node_id, [])
        self.children.pop(node_id, None)
        self.add_node(node_id)
        self.children[node_id] = sub

    def nodes(self) -> List[str]:
        return list(self.parent)

    def downstream(self, node_id: str) -> List[str]:
        return list(self.children.get(node_id, []))

    def upstream(self, node_id: str) -> Optional[str]:
        return self.parent.get(node_id)


class InProcessTransport:
    """In-memory message routing between nodes — zero network.

    Reference: ``transport/impl/DummyTransport.java``, the fake transport the
    reference uses to test mesh logic, chunking, and node failure without a
    cluster (SURVEY.md §4).  Same role here, and also the real transport for
    single-process multi-worker host training.
    """

    def __init__(self):
        self._handlers: Dict[str, Callable[[str, dict], None]] = {}
        self._offline: set = set()
        self._lock = threading.Lock()
        self.sent: int = 0

    def register(self, node_id: str,
                 handler: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._handlers[node_id] = handler
            self._offline.discard(node_id)

    def disconnect(self, node_id: str) -> None:
        with self._lock:
            self._offline.add(node_id)

    def send(self, from_id: str, to_id: str, message: dict) -> bool:
        with self._lock:
            if to_id in self._offline or to_id not in self._handlers:
                return False
            handler = self._handlers[to_id]
            self.sent += 1
        handler(from_id, message)
        return True


class ModelParameterServer:
    """Update propagation over the mesh.

    Reference: v2 ``ModelParameterServer.java``.  Each node registers an
    ``apply(message)`` consumer; ``publish`` floods a worker's encoded update
    through the relay tree (up to the parent, down to children), skipping the
    originator — every live node sees each update exactly once.
    """

    def __init__(self, transport: Optional[InProcessTransport] = None,
                 mesh: Optional[MeshOrganizer] = None):
        self.transport = transport or InProcessTransport()
        self.mesh = mesh or MeshOrganizer()
        self._consumers: Dict[str, Callable[[dict], None]] = {}

    def launch(self, node_id: str, consumer: Callable[[dict], None]) -> None:
        self.mesh.add_node(node_id)
        self._consumers[node_id] = consumer
        self.transport.register(
            node_id,
            lambda frm, msg, nid=node_id: self._receive(nid, frm, msg))

    def shutdown(self, node_id: str) -> None:
        self.transport.disconnect(node_id)
        self.mesh.mark_node_offline(node_id)
        self._consumers.pop(node_id, None)

    def publish(self, from_id: str, message: dict) -> None:
        """Flood ``message`` from ``from_id``; the originator's consumer is
        NOT invoked (it already applied the update locally)."""
        self._forward(from_id, exclude=None, message=message)

    def _neighbors(self, node_id: str) -> List[str]:
        up = self.mesh.upstream(node_id)
        return ([up] if up else []) + self.mesh.downstream(node_id)

    def _forward(self, at: str, exclude: Optional[str],
                 message: dict) -> None:
        for nxt in self._neighbors(at):
            if nxt != exclude:
                self.transport.send(at, nxt, message)

    def _receive(self, node_id: str, from_id: str, message: dict) -> None:
        consumer = self._consumers.get(node_id)
        if consumer is not None:
            consumer(message)
        # Parent-exclusion flood: exactly-once delivery on a tree.
        self._forward(node_id, exclude=from_id, message=message)
