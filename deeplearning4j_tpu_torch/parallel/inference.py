"""ParallelInference — batched serving over the mesh; the port of
``deeplearning4j_tpu/parallel/inference.py``.

Reference: deeplearning4j-scaleout-parallelwrapper
``org/deeplearning4j/parallelism/ParallelInference.java`` — request queueing,
dynamic batching (``ObservablesProvider``), round-robin device workers
(SURVEY.md §2.6 P4, §3.5).

One forward of the model a batch; a tiny batching queue provides the
dynamic BATCHED-mode semantics.  With a mesh whose data axis divides the
batch, each rank runs its rows and the outputs are all-gathered over the
data group, so every rank answers with the whole batch.  Every rank then
serves the same requests in the same order (SEQUENTIAL mode): a BATCHED
queue coalesces what each process happens to hold, so it refuses a mesh
of more than one data rank.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.ops.ndarray import NDArray
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, all_gather_cat


class InferenceMode:
    SEQUENTIAL = "SEQUENTIAL"
    BATCHED = "BATCHED"


#: wakes the worker so it can observe shutdown (a bare flag flip leaves it
#: parked in Queue.get for up to its poll timeout)
_SHUTDOWN = object()


class ParallelInference:
    def __init__(self, model, mesh: Optional[DeviceMesh] = None,
                 inferenceMode: str = InferenceMode.BATCHED,
                 batchLimit: int = 32, queueLimit: int = 64,
                 workers: int = -1):
        if mesh is not None and mesh.dataSize > 1 and \
                inferenceMode == InferenceMode.BATCHED:
            raise ValueError(
                "ParallelInference over a mesh of several data ranks serves "
                "in SEQUENTIAL mode: every rank must run the same batches "
                "in the same order, which one BATCHED queue per process "
                "cannot promise")
        self.model = model
        self.mesh = mesh
        self.inferenceMode = inferenceMode
        self.batchLimit = int(batchLimit)
        self._q: "queue.Queue" = queue.Queue(maxsize=queueLimit)
        self._lock = threading.Lock()
        # gates BOTH the running check + enqueue and shutdown's drain, so
        # a request can never slip into the queue after the drain ran
        self._qlock = threading.Lock()
        # NOT self._lock: that one is held across whole device dispatches,
        # and enqueue-time validation must never wait on a running batch
        self._shapeLock = threading.Lock()
        self._expectTrailing: Optional[tuple] = None
        self._worker: Optional[threading.Thread] = None
        self._running = inferenceMode == InferenceMode.BATCHED
        if self._running:
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def inferenceMode(self, m):
            self._kw["inferenceMode"] = m
            return self

        def batchLimit(self, n):
            self._kw["batchLimit"] = n
            return self

        def queueLimit(self, n):
            self._kw["queueLimit"] = n
            return self

        def workers(self, n):
            self._kw["workers"] = n
            return self

        def build(self):
            return ParallelInference(self._model, **self._kw)

    # -- serving ---------------------------------------------------------
    def _validate(self, xv: np.ndarray) -> None:
        """Reject a mismatched feature shape at ENQUEUE time — only the
        offender errors, instead of its whole coalesced batch failing in
        ``np.concatenate`` (batch poisoning).  The expected shape is
        latched from the first SUCCESSFULLY served batch (see ``_loop``)
        — latching from the first request *seen* would let one malformed
        request poison every valid request for the instance's lifetime."""
        if xv.ndim < 1:
            raise ValueError("features must include a batch axis")
        trailing = tuple(xv.shape[1:])
        with self._shapeLock:
            expect = self._expectTrailing
        if expect is not None and trailing != expect:
            raise ValueError(
                f"feature shape {xv.shape} (trailing {trailing}) does "
                f"not match this server's batch shape {expect}; mixed "
                "shapes cannot share a coalesced batch")

    def output(self, x) -> NDArray:
        xv = np.asarray(x.numpy() if isinstance(x, NDArray) else x)
        if self.inferenceMode == InferenceMode.SEQUENTIAL:
            return self._run(xv)
        self._validate(xv)
        ev = threading.Event()
        holder = {}
        item = (xv, ev, holder)
        while True:
            with self._qlock:
                if not self._running:
                    raise RuntimeError(
                        "ParallelInference has been shut down")
                try:
                    self._q.put_nowait(item)
                    break
                except queue.Full:
                    pass
            # full queue: back off OUTSIDE the lock (the worker needs no
            # lock to drain, and shutdown must be able to take it)
            time.sleep(0.001)
        ev.wait()
        if "err" in holder:
            raise holder["err"]
        return holder["out"]

    def _run(self, xv: np.ndarray) -> NDArray:
        with self._lock:
            if self.mesh is not None and self.mesh.dataSize > 1 and \
                    xv.shape[0] % self.mesh.dataSize == 0:
                out = self.model.output(self.mesh.shardBatch(xv))
                return NDArray(all_gather_cat(out.torch,
                                              self.mesh.group("data")))
            return self.model.output(xv)

    def _loop(self):
        stop = False
        while not stop:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._running:
                    return
                continue
            if first is _SHUTDOWN:
                return
            batch = [first]
            while len(batch) < self.batchLimit:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is _SHUTDOWN:
                    stop = True     # serve what we already hold, then exit
                    break
                batch.append(item)
            xs = [b[0] for b in batch]
            sizes = [x.shape[0] for x in xs]
            try:
                out = self._run(np.concatenate(xs, axis=0)).numpy()
                if self._expectTrailing is None:
                    # the model accepted this shape: pin it as THE
                    # serving shape — future mismatches are rejected at
                    # enqueue, individually
                    with self._shapeLock:
                        if self._expectTrailing is None:
                            self._expectTrailing = tuple(xs[0].shape[1:])
                pos = 0
                for (x, ev, holder), n in zip(batch, sizes):
                    holder["out"] = NDArray(out[pos:pos + n])
                    pos += n
                    ev.set()
            except Exception as e:  # propagate to all waiters
                for _, ev, holder in batch:
                    holder["err"] = e
                    ev.set()

    def shutdown(self):
        """Idempotent.  Order matters: flip ``_running`` under the enqueue
        lock (no new requests can slip in), wake + join the worker via a
        sentinel, then reject whatever is still queued — a request that
        passed the running check before the flip is guaranteed to be in
        the queue by then, so nobody blocks forever."""
        with self._qlock:
            if not self._running:
                return
            self._running = False
        worker = self._worker
        if worker is not None:
            try:
                self._q.put_nowait(_SHUTDOWN)
            except queue.Full:
                pass                # worker is draining; the flag stops it
            worker.join(timeout=5.0)
            self._worker = None
        with self._qlock:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is _SHUTDOWN:
                    continue
                _, ev, holder = item
                holder["err"] = RuntimeError("ParallelInference shut down")
                ev.set()
