"""Sharded multi-process input pipeline with a pinned, double-buffered H2D
ring — the port of ``deeplearning4j_tpu/datavec/pipeline.py``.

The streaming gap it closes: a training loop that decodes and augments on
one Python thread, then copies each batch from pageable memory while the
card waits, starves the card as soon as data does not already live on it.
Two stages take that work out of the loop:

1. **Producer pool** — ``numWorkers`` OS processes (``multiprocessing``,
   fork by default so the decode code needs no re-import), each handed a
   deterministic :class:`ShardSpec`.  The record source shards per
   process group rank first (``torch.distributed``'s rank, the
   ``SharedTrainingMaster`` host-index convention), then per worker within
   the host, so no record is decoded twice.  Workers assemble fixed-shape
   batches directly into **shared-memory slots** (one memcpy, no pickle of
   the pixel payload) and post slot metadata on a queue; slot recycling is
   the pool's backpressure.  A worker is a fork of a process whose CUDA
   context it must never touch: the parent's heap is frozen across the
   fork (``gc.freeze``), so the child's cyclic collector never frees an
   inherited CUDA tensor (whose destructor would call into that context);
   the worker turns on host-only arrays first (every array it makes stays
   on the CPU) and sets torch to one intra-op thread (an OpenMP team
   inherited across a fork can hang); and the pickled source is refused
   if it holds a CUDA tensor.
2. **Pinned H2D ring** (the CUDA design that replaces the reference's
   ``jax.device_put``) — ``stagingDepth + 1`` page-locked host buffers,
   allocated once and grown only when a batch is larger.  The consumer
   copies a batch out of its shared-memory slot into the next pinned
   buffer (the slot goes back to the pool when that memcpy ends), then
   issues ``copy_(..., non_blocking=True)`` onto the card on a dedicated
   copy stream and records an event after it.  ``materialize()`` makes the
   consumer's current stream wait on that event (no host wait) and calls
   ``record_stream`` on each batch tensor, so the caching allocator cannot
   hand the memory out again before the step that reads it has run.  A
   pinned buffer is written again only after its own copy event has
   completed.  The copy of batch N+1 runs while the step on batch N does:
   the staged ring is ``stagingDepth`` deep (2 = double buffered).

Crash discipline mirrors ``AsyncDataSetIterator``'s sentinel contract: a
worker that dies — exception (pickled through the queue) or hard kill
(detected by liveness polling, since a SIGKILLed producer can post no
sentinel) — surfaces as :class:`ProducerWorkerError` in the consumer, so
a truncated epoch can never look like a clean end.

Telemetry reuses the ``dl4j_tpu_etl_*`` namespace
(:func:`deeplearning4j_tpu_torch.telemetry.etl_metrics`): queue depth,
consumers-waiting and producer-active gauges, and the
``dl4j_tpu_etl_h2d_bytes_total`` / ``dl4j_tpu_etl_h2d_seconds`` series of
the transfer stage (issue time on the host plus the copy's device time).

``MultiLayerNetwork.fit`` engages the pool through :func:`maybe_prefetch`
whenever the iterator reports ``streaming() == True`` (as the reference's
does; ``ComputationGraph.fit`` does not, in either package); tune with
``DL4J_TPU_ETL_WORKERS`` (0 disables) or construct
:class:`PrefetchingDataSetIterator` directly.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import logging
import multiprocessing as _mp
import os
import pickle
import queue as _queue
import threading
import time
import weakref
from multiprocessing import shared_memory as _shm
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

log = logging.getLogger(__name__)

__all__ = ["ShardSpec", "PrefetchingDataSetIterator", "ProducerWorkerError",
           "RaggedFeatureReader", "hash_feature", "maybe_prefetch",
           "default_host_spec", "stage_batch"]

_FIELDS = ("features", "labels", "featuresMask", "labelsMask")

# every array a batch carries across the process/device boundary: the
# DL4J quadruple plus the ragged-batch offsets sidecar
_XFER_FIELDS = _FIELDS + ("offsets",)

# byte alignment of each field inside a pinned buffer
_ALIGN = 256


# ----------------------------------------------------------- sharding ----

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Deterministic shard assignment for one producer worker.

    The global shard index flattens host-major — host h, worker w of W
    owns shard ``h*W + w`` of ``H*W`` — so a multi-process run reads every
    record exactly once with no coordination beyond the spec itself.
    """

    hostIndex: int = 0
    hostCount: int = 1
    workerIndex: int = 0
    workerCount: int = 1
    # epoch generation of this worker pool start: the pickled source
    # blob is frozen, so per-epoch variation (augmentation RNG) keys off
    # this — see ``setEpoch``
    epoch: int = 0

    @property
    def shardIndex(self) -> int:
        return self.hostIndex * self.workerCount + self.workerIndex

    @property
    def shardCount(self) -> int:
        return self.hostCount * self.workerCount

    def owns(self, recordIndex: int) -> bool:
        return recordIndex % self.shardCount == self.shardIndex


def default_host_spec() -> tuple:
    """(hostIndex, hostCount): the ``torch.distributed`` rank and world
    size when a process group is initialised, else (0, 1)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


def _resolve_shard(source, spec: ShardSpec):
    """Shard ``source`` for one worker: a callable is a batch factory
    (``source(spec)`` returns the worker's iterable of DataSets); an
    iterator with ``shard(index, count)`` shards at record granularity;
    anything else falls back to batch-granularity ownership (every worker
    drains the whole source and keeps batches ``i % count == index``)."""
    if callable(source) and not isinstance(source, DataSetIterator):
        return source(spec)
    shard = getattr(source, "shard", None)
    if shard is not None:
        try:
            return shard(spec.shardIndex, spec.shardCount)
        except NotImplementedError:
            pass
    return _ModuloBatches(source, spec)


class _ModuloBatches:
    def __init__(self, source, spec: ShardSpec):
        self.source, self.spec = source, spec

    def __iter__(self):
        for i, ds in enumerate(_iter_batches(self.source)):
            if self.spec.owns(i):
                yield ds


def _iter_batches(src):
    if hasattr(src, "hasNext") and hasattr(src, "next"):
        # the DataSetIterator SPI drained by hand (duck-typed: user
        # sources need not subclass), not the python protocol
        if hasattr(src, "reset"):
            src.reset()
        while src.hasNext():
            yield src.next()
    else:
        yield from src


# ------------------------------------------------------- worker process ----

def _to_np(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x))


def _untrack(seg, untrack: bool) -> None:
    """Drop the attach-side resource_tracker registration — but ONLY in a
    spawn-started worker, whose own fresh tracker would otherwise unlink
    the parent's live segments when the worker exits.  A fork-started
    worker shares the parent's tracker."""
    if not untrack:
        return
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass


@contextlib.contextmanager
def _unfreezing(frozen: bool):
    """Put the parent's heap back in the collector's hands on the way out
    (``gc.freeze`` before the forks)."""
    try:
        yield
    finally:
        if frozen:
            gc.unfreeze()


def _worker_main(sourceBlob: bytes, spec: ShardSpec, shmNames, shmBytes: int,
                 freeQ, metaQ, stopEvt, untrack: bool = False) -> None:
    """Producer-pool worker body, in a child process: host decode only,
    never CUDA, never the parent's telemetry.  Exits through the sentinel
    discipline: exactly one terminal message, ``("err", ...)`` then
    ``("end", ...)`` on a crash, a bare ``("end", ...)`` on a clean
    drain."""
    segs = {}
    try:
        # FIRST: every array this process makes stays on the CPU, and
        # torch runs one intra-op thread (an OpenMP team inherited across
        # the fork can hang the first parallel region)
        from deeplearning4j_tpu_torch.ops.ndarray import set_host_only_arrays
        set_host_only_arrays(True)
        torch.set_num_threads(1)
        source = pickle.loads(sourceBlob)
        # the blob is the SAME bytes every epoch: without an epoch
        # signal, augmentation would replay identically each generation
        setEpoch = getattr(source, "setEpoch", None)
        if setEpoch is not None:
            setEpoch(spec.epoch)
        it = _resolve_shard(source, spec)
        for ds in _iter_batches(it):
            if stopEvt.is_set():
                break
            fields = [_to_np(getattr(ds, f, None)) for f in _XFER_FIELDS]
            nbytes = sum(a.nbytes for a in fields if a is not None)
            if nbytes > shmBytes:
                # oversized batch: pickle through the queue (slower, but
                # the contract survives any shape)
                metaQ.put(("inline", spec.workerIndex, fields))
                continue
            slot = None
            while slot is None and not stopEvt.is_set():
                try:
                    slot = freeQ.get(timeout=0.1)
                except _queue.Empty:
                    pass
            if slot is None:        # stopping while blocked on a slot
                break
            seg = segs.get(slot)
            if seg is None:
                seg = segs[slot] = _shm.SharedMemory(name=shmNames[slot])
                _untrack(seg, untrack)
            off, metas = 0, []
            for a in fields:
                if a is None:
                    metas.append(None)
                    continue
                np.ndarray(a.shape, dtype=a.dtype, buffer=seg.buf,
                           offset=off)[...] = a
                metas.append((a.shape, str(a.dtype), off))
                off += a.nbytes
            metaQ.put(("batch", spec.workerIndex, slot, metas))
    except BaseException as e:
        import traceback
        metaQ.put(("err", spec.workerIndex, type(e).__name__, str(e),
                   traceback.format_exc()))
    finally:
        metaQ.put(("end", spec.workerIndex))
        for seg in segs.values():
            try:
                seg.close()
            except Exception:
                pass


class _NoCudaPickler(pickle.Pickler):
    """Pickles a pool's source and refuses a CUDA tensor in it: a worker
    that unpickled one would initialise CUDA in a forked child."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise ValueError(
                "the producer pool's source holds a tensor on "
                f"{obj.device}: workers must not touch the card (keep "
                "the source's arrays, e.g. a normalizer's statistics, on "
                "the CPU)")
        return NotImplemented


def _pickle_source(source) -> bytes:
    buf = io.BytesIO()
    _NoCudaPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(source)
    return buf.getvalue()


# ------------------------------------------------------------ H2D ring ----

def _cuda(device) -> Optional[torch.device]:
    """``device`` as an indexed CUDA device, or None for a host target."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _to_torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class _PinnedSlot:
    __slots__ = ("buf", "event", "pending")

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None   # uint8, page-locked
        self.event = None       # the copy-done event of its last batch
        self.pending = None     # its batch, until the h2d time is read


class _PinnedRing:
    """``depth`` page-locked host buffers and the copy stream of one CUDA
    device.  A buffer is handed out again only after the copy that last
    read it has completed (its event), so the host never overwrites bytes
    the copy engine has yet to read."""

    def __init__(self, depth: int, device: torch.device):
        self.device = device
        self.slots = [_PinnedSlot() for _ in range(max(1, int(depth)))]
        self.stream = torch.cuda.Stream(device=device)
        self._next = 0

    def acquire(self, nbytes: int) -> _PinnedSlot:
        slot = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        if slot.event is not None:
            slot.event.synchronize()
            if slot.pending is not None:
                slot.pending._observe()
        if slot.buf is None or slot.buf.numel() < nbytes:
            # grown only for a larger batch; the copy that last read the
            # old buffer has completed above
            slot.buf = None     # free the old pinned block first
            slot.buf = torch.empty(max(int(nbytes), 1), dtype=torch.uint8,
                                   pin_memory=True)
        return slot

    def drain(self) -> None:
        """Wait for every copy in flight and report its time."""
        for slot in self.slots:
            if slot.event is not None:
                slot.event.synchronize()
                if slot.pending is not None:
                    slot.pending._observe()
                slot.pending = None


_RINGS = {}
_RINGS_LOCK = threading.Lock()


def _default_ring(device: torch.device) -> _PinnedRing:
    """The shared ring of ``stage_batch`` callers (one per device)."""
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = _PinnedRing(3, device)
        return ring


class _StagedBatch:
    """One in-flight H2D transfer.

    ``sources`` are the batch's host arrays (numpy views, of a shared-
    memory slot or of a worker's pickled arrays); ``release`` runs once
    they have been copied into the pinned buffer (the pool recycles the
    slot there).  With a CUDA ``device`` the batch then crosses on the
    ring's copy stream; with a host target it is copied into private CPU
    tensors and ``materialize`` hands those out (the bytes and the copy
    time are reported the same way, as the reference reports its
    ``device_put`` onto the CPU)."""

    __slots__ = ("dev", "nbytes", "issueSeconds", "issuedAt", "device",
                 "start", "done", "observed")

    def __init__(self, sources, device, ring: Optional[_PinnedRing] = None,
                 release=None):
        from deeplearning4j_tpu_torch.telemetry import etl_metrics
        self.nbytes = sum(a.nbytes for a in sources if a is not None)
        self.device = _cuda(device)
        self.start = self.done = None
        self.observed = False
        t0 = time.perf_counter()
        self.issuedAt = t0
        try:
            if self.device is None:
                self.dev = [None if a is None else torch.from_numpy(
                    np.array(a, copy=True)) for a in sources]
            else:
                self.dev = self._issue(sources, ring or _default_ring(
                    self.device))
        finally:
            if release is not None:
                release()
        self.issueSeconds = time.perf_counter() - t0
        etl_metrics().h2d_bytes().inc(self.nbytes)
        if self.device is None:         # a host target: the copy is done
            self._observe()

    def _issue(self, sources, ring: _PinnedRing):
        offs, total = [], 0
        for a in sources:
            offs.append(total)
            if a is not None:
                total = _aligned(total + a.nbytes)
        slot = ring.acquire(total)
        host = slot.buf.numpy()
        pinned = []
        for a, off in zip(sources, offs):
            if a is None:
                pinned.append(None)
                continue
            view = host[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
            np.copyto(view, a)          # the one host memcpy
            pinned.append(slot.buf[off:off + a.nbytes])
        self.start = torch.cuda.Event(enable_timing=True)
        self.done = torch.cuda.Event(enable_timing=True)
        out = []
        with torch.cuda.stream(ring.stream):
            self.start.record(ring.stream)
            for a, p in zip(sources, pinned):
                if a is None:
                    out.append(None)
                    continue
                t = torch.empty(a.shape, dtype=_to_torch_dtype(a.dtype),
                                device=self.device)
                if a.nbytes:
                    t.view(-1).view(torch.uint8).copy_(p, non_blocking=True)
                out.append(t)
            self.done.record(ring.stream)
        slot.event = self.done
        slot.pending = self
        return out

    def _observe(self) -> None:
        """Report the transfer's time once its copy is known complete:
        host issue time plus the copy's device time."""
        if self.observed:
            return
        self.observed = True
        from deeplearning4j_tpu_torch.telemetry import etl_metrics, tracer
        dt = self.issueSeconds if self.done is None else \
            self.issueSeconds + self.start.elapsed_time(self.done) / 1e3
        etl_metrics().h2d_seconds().observe(dt)
        tracer().record_complete("h2d_stage", self.issuedAt, dt,
                                 args={"bytes": int(self.nbytes)})
        from deeplearning4j_tpu_torch.telemetry.instrument import \
            observe_step_phase
        observe_step_phase("h2d", dt)

    def materialize(self) -> DataSet:
        if self.device is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.done)
            for t in self.dev:
                if t is not None:
                    t.record_stream(cur)
            if self.done.query():
                self._observe()
        ds, self.dev = DataSet(*self.dev), None
        return ds


def stage_batch(ds, device) -> _StagedBatch:
    """Stage a DataSet's arrays onto ``device`` asynchronously through the
    device's shared pinned ring; ``.materialize()`` later returns the
    on-device DataSet (the consumer's stream waits on the copy).  Used by
    ``AsyncDataSetIterator``.  A field already on the card is handed
    through."""
    fields, cuda_fields = [], {}
    for i, name in enumerate(_XFER_FIELDS):
        a = getattr(ds, name, None)
        t = a.torch if hasattr(a, "torch") else a
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            cuda_fields[i] = t
            fields.append(None)
        else:
            fields.append(_to_np(a))
    staged = _StagedBatch(fields, device)
    for i, t in cuda_fields.items():
        staged.dev[i] = t
    return staged


# ------------------------------------------------------------- consumer ----

class ProducerWorkerError(RuntimeError):
    """A producer-pool worker died — either with an exception (original
    type/message/traceback attached) or without a sentinel (killed)."""

    def __init__(self, workerIndex: int, message: str,
                 childTraceback: str = ""):
        super().__init__(f"ETL producer worker {workerIndex}: {message}")
        self.workerIndex = workerIndex
        self.childTraceback = childTraceback


class PrefetchingDataSetIterator(DataSetIterator):
    """Drop-in DataSetIterator over a sharded producer pool + H2D ring.

    ``source`` is either a picklable :class:`DataSetIterator` (sharded per
    worker through its ``shard()`` when available) or a callable
    ``factory(spec: ShardSpec) -> iterable[DataSet]``.  The pool starts
    lazily on first ``hasNext()`` and restarts on ``reset()`` (one worker
    generation per epoch).  ``close()`` stops the workers and releases the
    shared-memory slots; the fit path that engages the pool calls it, and
    a finalizer covers leaked instances.

    Tuning knobs: ``numWorkers`` (decode parallelism), ``queueDepth``
    (shared-memory slots = in-flight assembled batches = producer
    backpressure), ``stagingDepth`` (batches staged ahead on the card, 2 =
    double buffered; the pinned ring holds one buffer more), ``shmBytes``
    (per-slot capacity; an oversized batch is pickled through the queue
    instead).  ``device``: a ``torch.device`` (or its name) the batches
    are staged onto; None or the CPU hands out CPU arrays.  Sharded
    placement waits for ROADMAP A10.
    """

    def __init__(self, source, numWorkers: int = 2, queueDepth: int = 4,
                 stagingDepth: int = 2, shmBytes: int = 32 << 20,
                 hostIndex: Optional[int] = None,
                 hostCount: Optional[int] = None,
                 device=None, startMethod: Optional[str] = None):
        if numWorkers < 1:
            raise ValueError("numWorkers must be >= 1")
        # pickle NOW: an unpicklable source (or one holding a CUDA tensor)
        # must fail at construction, where maybe_prefetch can fall back
        self._sourceBlob = _pickle_source(source)
        self._wrapped = source if isinstance(source, DataSetIterator) \
            else None
        self.numWorkers = int(numWorkers)
        self.queueDepth = max(2, int(queueDepth))
        self.stagingDepth = max(1, int(stagingDepth))
        self.shmBytes = int(shmBytes)
        h, n = default_host_spec()
        self.hostIndex = h if hostIndex is None else int(hostIndex)
        self.hostCount = n if hostCount is None else int(hostCount)
        self.device = device
        self._pinned: Optional[_PinnedRing] = None
        method = startMethod or os.environ.get("DL4J_TPU_ETL_START_METHOD")
        if method is None:
            method = "fork" if "fork" in _mp.get_all_start_methods() \
                else "spawn"
        self._ctx = _mp.get_context(method)
        self._segs = []
        self._procs = []
        self._metaQ = self._freeQ = self._stopEvt = None
        self._ring = collections.deque()
        self._started = False
        self._exhausted = False
        self._endsSeen: set = set()
        self._liveProducers = 0
        self._closed = False
        self._epoch = -1
        self._pendingError: Optional[ProducerWorkerError] = None
        # health-remediation restart: set from any thread; the CONSUMER
        # thread (which owns the pool) restarts the workers at its next
        # poll, fast-forwarding past the batches already delivered this
        # epoch (exact for numWorkers=1)
        self._restartReq = threading.Event()
        self._delivered = 0
        self._skip = 0
        # state the leak finalizer can reach without holding self
        self._live = {"segs": self._segs, "procs": [], "stop": None}
        self._finalizer = weakref.finalize(
            self, PrefetchingDataSetIterator._cleanup_leaked, self._live)

    # -- lifecycle ------------------------------------------------------

    @staticmethod
    def _cleanup_leaked(state) -> None:
        stop = state.get("stop")
        if stop is not None:
            try:
                stop.set()
            except Exception:
                pass
        for p in state.get("procs", ()):
            try:
                if p.is_alive():
                    p.terminate()
            except Exception:
                pass
        PrefetchingDataSetIterator._cleanup_segments(state["segs"])

    @staticmethod
    def _cleanup_segments(segs) -> None:
        for seg in segs:
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass
        segs.clear()

    def _ensure_segments(self) -> None:
        while len(self._segs) < self.queueDepth:
            self._segs.append(_shm.SharedMemory(create=True,
                                                size=self.shmBytes))

    def _start(self) -> None:
        from deeplearning4j_tpu_torch.telemetry import etl_metrics, tracer
        if self._closed:
            raise RuntimeError("iterator is closed")
        self._ensure_segments()
        self._metaQ = self._ctx.Queue()
        self._freeQ = self._ctx.Queue()
        for i in range(len(self._segs)):
            self._freeQ.put(i)
        self._stopEvt = self._ctx.Event()
        self._endsSeen = set()
        self._exhausted = False
        self._epoch += 1
        names = [seg.name for seg in self._segs]
        untrack = self._ctx.get_start_method() != "fork"
        self._procs = []
        # a forked worker inherits the parent's heap, CUDA tensors
        # included; the cyclic collector running in the child would free
        # one, and its destructor calls into a CUDA context the child
        # cannot use (the process aborts).  Frozen objects are never
        # collected, so the parent's heap is frozen across the forks
        forking = self._ctx.get_start_method() == "fork"
        if forking:
            gc.freeze()
        with tracer().span("etl_pool_start", workers=self.numWorkers,
                           epoch=self._epoch), \
                _unfreezing(forking):
            import warnings
            with warnings.catch_warnings():
                # py3.12+'s os.fork()-with-threads warning: the workers
                # decode on the CPU only and never enter CUDA or the
                # parent's thread pools
                warnings.simplefilter("ignore", RuntimeWarning)
                warnings.simplefilter("ignore", DeprecationWarning)
                for w in range(self.numWorkers):
                    spec = ShardSpec(self.hostIndex, self.hostCount, w,
                                     self.numWorkers, epoch=self._epoch)
                    p = self._ctx.Process(
                        target=_worker_main,
                        args=(self._sourceBlob, spec, names, self.shmBytes,
                              self._freeQ, self._metaQ, self._stopEvt,
                              untrack),
                        daemon=True)
                    p.start()
                    self._procs.append(p)
        self._live["procs"] = list(self._procs)
        self._live["stop"] = self._stopEvt
        self._liveProducers = self.numWorkers
        em = etl_metrics()
        em.producer_active().inc(self.numWorkers)
        em.pool_workers().set(self.numWorkers)
        self._started = True

    def _producer_done(self) -> None:
        if self._liveProducers > 0:
            self._liveProducers -= 1
            from deeplearning4j_tpu_torch.telemetry import etl_metrics
            etl_metrics().producer_active().dec()

    def _shutdown(self) -> Optional[ProducerWorkerError]:
        """Stop the pool (keeps the shm slots for the next epoch).
        Returns the first worker error found while draining — ``reset()``
        re-raises it, as ``AsyncDataSetIterator.reset`` does."""
        if not self._started:
            return None
        from deeplearning4j_tpu_torch.telemetry import etl_metrics
        err = None
        self._stopEvt.set()
        # drain pending metadata so worker feeder threads can flush and
        # exit; slots referenced by drained messages are simply unused
        try:
            while True:
                msg = self._metaQ.get_nowait()
                if err is None and msg and msg[0] == "err":
                    _, w, tname, text, tb = msg
                    err = ProducerWorkerError(w, f"{tname}: {text}", tb)
        except (_queue.Empty, OSError):
            pass
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for q in (self._metaQ, self._freeQ):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass
        while self._liveProducers > 0:
            self._producer_done()
        etl_metrics().pool_workers().set(0)
        self._procs = []
        self._live["procs"] = []
        self._started = False
        return err

    def requestRestart(self) -> None:
        """Thread-safe producer-pool restart request (the
        ``etl_starvation`` remediation): the consumer thread, which owns
        the pool, tears it down at its next poll and fast-forwards the
        fresh worker generation past the batches already delivered this
        epoch.  The skip is exact only for ``numWorkers=1``."""
        self._restartReq.set()

    def _restart_pool(self) -> None:
        """Consumer-thread only: restart the same ShardSpec epoch, skipping
        the already-delivered prefix on replay.  Staged-but-undelivered
        batches are dropped — the new generation reproduces them."""
        from deeplearning4j_tpu_torch.telemetry import etl_metrics
        log.warning("restarting ETL producer pool (epoch %d): replay "
                    "will skip the %d batch(es) already delivered",
                    max(self._epoch, 0), self._delivered)
        err = self._shutdown()
        if err is not None and self._pendingError is None:
            self._pendingError = err
        self._ring.clear()
        self._skip = self._delivered
        self._epoch -= 1    # same ShardSpec epoch: identical stream order
        self._start()
        etl_metrics().pool_restarts().inc()
        from deeplearning4j_tpu_torch.telemetry.runlog import record_event
        record_event("etl.restart", delivered=self._delivered,
                     epoch=max(self._epoch, 0))

    def close(self) -> None:
        """Full teardown: pool + shared-memory slots.  Idempotent; does
        not re-raise pending worker errors."""
        self._shutdown()
        self._pendingError = None
        self._ring.clear()
        if self._pinned is not None:
            self._pinned.drain()
            self._pinned = None         # frees the page-locked buffers
        self._restartReq.clear()
        self._delivered = self._skip = 0
        self._cleanup_segments(self._segs)
        self._closed = True

    # -- consumption ----------------------------------------------------

    def _dead_without_sentinel(self):
        for w, p in enumerate(self._procs):
            if w not in self._endsSeen and not p.is_alive():
                return w, p
        return None

    def _fail(self, exc: ProducerWorkerError) -> None:
        try:
            self._shutdown()
        finally:
            self._ring.clear()
            self._exhausted = True
        raise exc

    def _get_msg(self, block: bool):
        from deeplearning4j_tpu_torch.telemetry import (etl_metrics,
                                                        note_etl_wait)
        em = etl_metrics()
        try:
            depth = self._metaQ.qsize()
        except (NotImplementedError, OSError):  # pragma: no cover
            depth = -1
        if depth >= 0:
            em.queue_depth().set(depth)
        em.pool_workers().set(sum(p.is_alive() for p in self._procs))
        if not block:
            try:
                return self._metaQ.get_nowait()
            except _queue.Empty:
                return None
        waiting = None
        if depth == 0:
            # the live waiting gauge is what EtlStarvationRule watches
            em.empty_polls().inc()
            waiting = em.consumers_waiting()
            waiting.inc()
        t0 = time.perf_counter()
        try:
            while True:
                try:
                    msg = self._metaQ.get(timeout=0.2)
                    break
                except _queue.Empty:
                    if self._restartReq.is_set():
                        self._restartReq.clear()
                        self._restart_pool()
                        continue
                    dead = self._dead_without_sentinel()
                    if dead is None:
                        continue
                    # grace get: a cleanly-exited worker's ("end", w) can
                    # still be in the pipe when is_alive() first reads
                    # False
                    try:
                        msg = self._metaQ.get(timeout=1.0)
                        break
                    except _queue.Empty:
                        w, p = dead
                        self._fail(ProducerWorkerError(
                            w, "died without sentinel "
                               f"(exitcode {p.exitcode})"))
        finally:
            if waiting is not None:
                waiting.dec()
        wait = time.perf_counter() - t0
        em.prefetch_wait().set(wait)
        note_etl_wait(wait, self)
        return msg

    def _stage(self, sources, release=None) -> _StagedBatch:
        dev = _cuda(self.device)
        if dev is not None and (self._pinned is None
                                or self._pinned.device != dev):
            self._pinned = _PinnedRing(self.stagingDepth + 1, dev)
        return _StagedBatch(sources, dev, self._pinned, release)

    def _fill(self, block: bool) -> None:
        """Pull pool messages, staging up to ``stagingDepth`` batches.
        ``block`` only applies while the ring is empty — topping up never
        stalls the caller."""
        from deeplearning4j_tpu_torch.telemetry import etl_metrics, tracer
        em = etl_metrics()
        while not self._exhausted and len(self._ring) < self.stagingDepth:
            if self._restartReq.is_set():
                self._restartReq.clear()
                if self._started:
                    self._restart_pool()
            msg = self._get_msg(block and not self._ring)
            if msg is None:
                return
            kind = msg[0]
            if kind == "batch":
                _, w, slot, metas = msg
                if self._skip > 0:
                    # replay fast-forward after a pool restart: recycle
                    # the slot without assembling the batch
                    self._skip -= 1
                    self._freeQ.put(slot)
                    continue
                t0 = time.perf_counter()
                views = []
                for meta in metas:
                    if meta is None:
                        views.append(None)
                        continue
                    shape, dtype, off = meta
                    views.append(np.ndarray(shape, dtype=dtype,
                                            buffer=self._segs[slot].buf,
                                            offset=off))
                # the slot goes back to the pool as soon as its bytes are
                # copied out (into a pinned buffer, or private CPU memory)
                staged = self._stage(
                    views, release=lambda s=slot: self._freeQ.put(s))
                tracer().record_complete("etl_assemble", t0,
                                         time.perf_counter() - t0)
                em.pool_batches().inc()
                self._ring.append(staged)
            elif kind == "inline":
                _, w, fields = msg
                if self._skip > 0:
                    self._skip -= 1
                    continue
                em.pool_batches().inc()
                em.pool_inline_batches().inc()
                self._ring.append(self._stage(fields))
            elif kind == "end":
                self._endsSeen.add(msg[1])
                self._producer_done()
                if len(self._endsSeen) >= self.numWorkers:
                    self._exhausted = True
                    self._shutdown()
            else:   # ("err", worker, typename, message, traceback)
                _, w, tname, text, tb = msg
                self._producer_done()
                self._fail(ProducerWorkerError(w, f"{tname}: {text}", tb))

    def _raise_pending(self) -> None:
        if self._pendingError is not None:
            exc = self._pendingError
            self._pendingError = None
            raise exc

    def hasNext(self) -> bool:
        self._raise_pending()
        if not self._started and not self._exhausted:
            self._start()
        self._fill(block=True)
        return bool(self._ring)

    def next(self, num: int = 0) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        staged = self._ring.popleft()
        self._delivered += 1
        ds = staged.materialize()
        # double buffering: issue the NEXT transfer before the caller
        # starts the step on this batch (non-blocking top-up).  A crash
        # surfacing during the top-up must not discard the good batch
        # already materialized — defer it to the next fetch.
        try:
            self._fill(block=False)
        except ProducerWorkerError as e:
            self._pendingError = e
        return self._applyPre(ds)

    def setDevice(self, device) -> None:
        """Retarget the H2D staging ring from the NEXT staged batch."""
        self.device = device

    def reassign(self, hostIndex: Optional[int] = None,
                 hostCount: Optional[int] = None) -> None:
        """Re-assign this consumer's ShardSpec host slot (the process
        group changed).  Stops the pool; the next ``hasNext()`` restarts
        it with the new spec from the stream's start."""
        err = self._shutdown()
        if hostIndex is not None:
            self.hostIndex = int(hostIndex)
        if hostCount is not None:
            self.hostCount = int(hostCount)
        self._ring.clear()
        self._delivered = self._skip = 0
        self._exhausted = False
        if err is not None:
            self._pendingError = err

    def reset(self) -> None:
        err = self._shutdown()
        if err is None:
            err = self._pendingError
        self._pendingError = None
        self._ring.clear()
        self._restartReq.clear()
        self._delivered = self._skip = 0
        self._exhausted = False     # lazy restart on the next hasNext()
        if err is not None:
            # a crash drained away (or deferred from a next() top-up)
            # must not vanish in a reset: the prior epoch was truncated
            raise err

    # -- SPI delegation -------------------------------------------------

    def batch(self) -> int:
        return self._wrapped.batch() if self._wrapped is not None else -1

    def totalOutcomes(self) -> int:
        return self._wrapped.totalOutcomes() \
            if self._wrapped is not None else -1

    def inputColumns(self) -> int:
        return self._wrapped.inputColumns() \
            if self._wrapped is not None else -1

    def streaming(self) -> bool:
        return False        # already prefetched: never wrap twice


# ------------------------------------------------ ragged ingestion ----

# Knuth multiplicative hash constants (golden-ratio / 2^64 + the
# splitmix64 finalizer) — cheap, stateless, and identical across
# processes, so ETL workers and the serving tier hash raw feature
# values to the same embedding-table rows.
_HASH_MULT = 0x9E3779B97F4A7C15
_HASH_MIX = 0xBF58476D1CE4E5B9


def hash_feature(values, numEmbeddings: int) -> np.ndarray:
    """Hash raw categorical feature values into ``[0, numEmbeddings)``:
    int64 hashed ids of the same shape (pure numpy, the reference's
    constants, so both packages hash a value to the same row)."""
    v = np.asarray(values, dtype=np.uint64)
    with np.errstate(over="ignore"):    # wraparound IS the hash
        h = (v + np.uint64(1)) * np.uint64(_HASH_MULT)
        h ^= h >> np.uint64(29)
        h *= np.uint64(_HASH_MIX)
        h ^= h >> np.uint64(32)
    return (h % np.uint64(numEmbeddings)).astype(np.int64)


class RaggedFeatureReader(DataSetIterator):
    """Streaming ragged/hashed-feature ingestion for the recommender
    tier (feeds ``ShardedEmbeddingBag``).

    Records are ``(values, label)`` pairs where ``values`` is one
    ragged list of raw categorical ids (``numFields == 1``) or a tuple
    of ``numFields`` such lists.  Each batch:

    - hashes raw ids into ``[0, numEmbeddings)`` (:func:`hash_feature`),
    - dedups ids PER ROW host-side (phase 1 of the two-phase sparse
      lookup: ``np.unique`` with counts — the duplicate multiplicity
      moves into the ``featuresMask`` weights, so sum-pooling is
      unchanged and only unique ids cross the interconnect),
    - pads every bag to the smallest bucket in ``bagBuckets`` that fits
      the batch's longest bag (id 0 / weight 0).  Raggedness therefore
      maps to a FINITE set of batch shapes — the fused train step
      compiles one executable per bucket and never re-traces on
      per-batch raggedness.

    The emitted DataSet carries features ``(b, numFields*bucket)``
    (float-encoded ids), featuresMask weights of the same shape,
    one-hot labels, and an ``offsets`` sidecar — the CSR row offsets of
    the PRE-dedup ragged values (``numFields*b + 1`` int64) used for
    exactly-once accounting across pool restarts.  Deterministic:
    record order fully determines every batch, which is what the pool's
    replay fast-forward needs.
    """

    def __init__(self, records, batchSize: int, numEmbeddings: int,
                 numClasses: int, bagBuckets=(4, 8, 16, 32, 64, 128),
                 numFields: int = 1, hashInputs: bool = True,
                 collisionSampleEvery: int = 8,
                 collisionSampleSize: int = 4096):
        self.records = list(records)
        self.batchSize = int(batchSize)
        self.numEmbeddings = int(numEmbeddings)
        self.numClasses = int(numClasses)
        self.bagBuckets = tuple(sorted(int(b) for b in bagBuckets))
        self.numFields = int(numFields)
        self.hashInputs = bool(hashInputs)
        # sampled collision estimator: hashed rows whose id falls on
        # the sample stride remember the FIRST raw value seen; a later
        # DIFFERENT raw value on the same row is a witnessed collision
        # (counted once per distinct pair).  Both dicts are bounded —
        # the estimator must never grow with stream length.
        # 0 disables sampling entirely.
        self.collisionSampleEvery = int(collisionSampleEvery)
        self.collisionSampleSize = int(collisionSampleSize)
        self._collisionSeen: Dict[int, int] = {}
        self._collisionHits: set = set()
        self._i = 0

    # -- SPI ------------------------------------------------------------
    def hasNext(self) -> bool:
        return self._i < len(self.records)

    def next(self, num: int = 0) -> DataSet:
        n = num or self.batchSize
        rows = self.records[self._i:self._i + n]
        if not rows:
            raise StopIteration("reader exhausted: call reset() first")
        self._i += len(rows)
        bags, labels = [], []
        for values, label in rows:
            fields = values if self.numFields > 1 else (values,)
            if len(fields) != self.numFields:
                raise ValueError(
                    f"record has {len(fields)} fields, expected "
                    f"{self.numFields}")
            bags.extend(fields)
            labels.append(label)
        # the batch in one array: hashing is elementwise, the collision
        # sampler walks the ids in the reference's order (bag by bag), and
        # the unique runs per bag through one sort keyed (bag, id), so
        # every bag comes out as the reference's per-bag np.unique gives
        # it — without a numpy call per bag
        dtype = np.uint64 if self.hashInputs else np.int64
        parts = [np.asarray(v, dtype=dtype).reshape(-1) for v in bags]
        lens = np.fromiter((len(p) for p in parts), np.int64, len(parts))
        flat = np.concatenate(parts)
        collisions = 0
        if self.hashInputs:
            ids = hash_feature(flat, self.numEmbeddings)
            if self.collisionSampleEvery > 0:
                raw = np.concatenate([np.asarray(v, dtype=np.int64)
                                      .reshape(-1) for v in bags])
                collisions = self._sampleCollisions(ids, raw)
        else:
            ids = flat
        seg = np.repeat(np.arange(len(bags)), lens)
        order = np.lexsort((ids, seg))
        sid, sseg = ids[order], seg[order]
        new = np.ones(len(sid), bool)
        new[1:] = (sid[1:] != sid[:-1]) | (sseg[1:] != sseg[:-1])
        starts = np.flatnonzero(new)
        uniq, useg = sid[starts], sseg[starts]
        counts = np.diff(np.append(starts, len(sid)))
        per_bag = np.bincount(useg, minlength=len(bags))
        first = np.cumsum(per_bag) - per_bag
        pos = np.arange(len(uniq)) - first[useg]
        bucket = self._bucket_for(int(per_bag.max()))
        b = len(rows)
        f = np.zeros((b, self.numFields * bucket), dtype=np.float32)
        w = np.zeros((b, self.numFields * bucket), dtype=np.float32)
        row, field = np.divmod(useg, self.numFields)
        col = field * bucket + pos
        f[row, col] = uniq
        w[row, col] = counts.astype(np.float32)
        l = np.zeros((b, self.numClasses), dtype=np.float32)
        l[np.arange(b), np.asarray(labels, dtype=np.int64)] = 1.0
        offsets = np.zeros(len(bags) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        self._note_batch(int(offsets[-1]), len(uniq), collisions)
        return self._applyPre(
            DataSet(f, l, featuresMask=w, offsets=offsets))

    def _sampleCollisions(self, hashed: np.ndarray,
                          raw: np.ndarray) -> int:
        """Count NEWLY witnessed hash collisions among the sampled
        stride of this bag.  A collision is two distinct raw ids on one
        hashed row — silent by construction (the lookup math is
        perfectly happy serving both users one embedding), so witnessing
        is the only detection there is.  Sampling ``1/sampleEvery`` of
        rows keeps the memory and per-batch cost bounded; scale the
        counter by ``sampleEvery`` for a population estimate."""
        sel = hashed % self.collisionSampleEvery == 0
        if not sel.any():
            return 0
        count = 0
        seen = self._collisionSeen
        for h, r in zip(hashed[sel].tolist(), raw[sel].tolist()):
            first = seen.get(h)
            if first is None:
                if len(seen) < self.collisionSampleSize:
                    seen[h] = r
            elif first != r:
                key = (h, r)
                if key not in self._collisionHits and \
                        len(self._collisionHits) < \
                        self.collisionSampleSize:
                    self._collisionHits.add(key)
                    count += 1
        return count

    def _bucket_for(self, longest: int) -> int:
        for bkt in self.bagBuckets:
            if longest <= bkt:
                return bkt
        raise ValueError(
            f"bag of {longest} unique ids exceeds the largest bucket "
            f"{self.bagBuckets[-1]} — raise bagBuckets (silent "
            "truncation would violate exactly-once ingestion)")

    def _note_batch(self, raw: int, stored: int,
                    collisions: int = 0) -> None:
        # ingestion telemetry — but ONLY in the parent process: a pool
        # worker runs in host-only mode and its registry is discarded
        # with it, so what a worker ingests is not counted (as in the
        # reference)
        from deeplearning4j_tpu_torch.ops.ndarray import host_only_arrays
        if host_only_arrays():
            return
        from deeplearning4j_tpu_torch.telemetry import recsys_metrics
        rm = recsys_metrics()
        rm.lookup_rows().inc(raw, phase="raw")
        rm.lookup_rows().inc(stored, phase="stored")
        rm.dedup_ratio().set(stored / max(raw, 1))
        if collisions:
            rm.hash_collisions().inc(collisions)

    def reset(self) -> None:
        self._i = 0

    def batch(self) -> int:
        return self.batchSize

    def totalOutcomes(self) -> int:
        return self.numClasses

    def inputColumns(self) -> int:
        return self.numFields

    def streaming(self) -> bool:
        return True         # per-record hash+dedup is real host work

    def setEpoch(self, epoch: int) -> None:
        pass                # deterministic: no per-epoch randomness

    def shard(self, index: int, count: int) -> "RaggedFeatureReader":
        """Deterministic 1-of-``count`` record shard (producer-pool
        worker contract)."""
        out = RaggedFeatureReader(
            self.records[index::count], self.batchSize,
            self.numEmbeddings, self.numClasses,
            bagBuckets=self.bagBuckets, numFields=self.numFields,
            hashInputs=self.hashInputs,
            collisionSampleEvery=self.collisionSampleEvery,
            collisionSampleSize=self.collisionSampleSize)
        if self.getPreProcessor() is not None:
            out.setPreProcessor(self.getPreProcessor())
        return out


# ------------------------------------------------------- auto-selection ----

def maybe_prefetch(iterator, numWorkers: Optional[int] = None,
                   hostShard: bool = True, **kw):
    """Wrap ``iterator`` in the producer pool when it is a streaming
    source (``iterator.streaming()``) and the pool is enabled
    (``DL4J_TPU_ETL_WORKERS`` > 0, default 2).  Falls back to the iterator
    unchanged when the source is not streaming, not picklable, or the pool
    can't start — the inline path always works.

    ``DL4J_TPU_ETL_WORKERS=0`` wins even over an explicit ``numWorkers``.
    ``hostShard=False`` pins the spec to (0, 1) hosts: a bare
    ``MultiLayerNetwork.fit`` has no all-reduce, so each process must see
    the whole stream.  The caller that gets a NEW object back owns its
    ``close()``.
    """
    if not isinstance(iterator, DataSetIterator):
        return iterator
    try:
        if not iterator.streaming():
            return iterator
    except Exception:
        return iterator
    try:
        env = int(os.environ.get("DL4J_TPU_ETL_WORKERS", "2"))
    except ValueError:
        env = 2
    if env <= 0:
        return iterator
    if numWorkers is None:
        numWorkers = env
    if numWorkers <= 0:
        return iterator
    if not hostShard:
        kw.setdefault("hostIndex", 0)
        kw.setdefault("hostCount", 1)
    try:
        return PrefetchingDataSetIterator(iterator, numWorkers=numWorkers,
                                          **kw)
    except Exception as e:
        # visible degradation: the operator asked for the pool and is
        # getting the slow inline path instead
        log.warning(
            "ETL producer pool unavailable for %s (%s: %s); falling back "
            "to the inline single-process path",
            type(iterator).__name__, type(e).__name__, e)
        return iterator
