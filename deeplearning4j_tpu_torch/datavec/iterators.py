"""RecordReader → DataSet iterator glue + async device prefetch.

Reference: deeplearning4j-datavec-iterators
``RecordReaderDataSetIterator`` / ``SequenceRecordReaderDataSetIterator``
and deeplearning4j-utility-iterators ``AsyncDataSetIterator`` (the prefetch
thread every ``fit`` wraps around its iterator — SURVEY.md §3.1).

The port of ``deeplearning4j_tpu/datavec/iterators.py``: prefetch overlaps
HOST record assembly with the device step; batches are assembled in numpy
and wrapped as CPU arrays (the model, or a staging ring, moves them), and
sequence batches pad to the longest sequence with masks — the same
(features, labels, featuresMask, labelsMask) quadruple the reference emits.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.datavec.records import (RecordReader,
                                                      SequenceRecordReader)
from deeplearning4j_tpu_torch.datavec.writable import NDArrayWritable


class RecordReaderDataSetIterator(DataSetIterator):
    """Batch records into (features, labels) DataSets.

    ``labelIndex`` marks the label column; with ``numPossibleLabels`` the
    label one-hot-encodes (classification); ``regression=True`` keeps raw
    values.  NDArrayWritable feature columns (e.g. from ImageRecordReader)
    are used as-is.
    """

    def __init__(self, recordReader: RecordReader, batchSize: int,
                 labelIndex: Optional[int] = None,
                 numPossibleLabels: int = -1, regression: bool = False,
                 labelIndexTo: Optional[int] = None):
        self.reader = recordReader
        self.batchSize = batchSize
        self.labelIndex = labelIndex
        self.numPossibleLabels = numPossibleLabels
        self.regression = regression
        self.labelIndexTo = labelIndexTo

    def hasNext(self) -> bool:
        return self.reader.hasNext()

    def _split_record(self, rec):
        if self.labelIndex is None:
            feats = [w for w in rec]
            return feats, None
        hi = self.labelIndexTo if self.labelIndexTo is not None \
            else self.labelIndex
        feats = rec[:self.labelIndex] + rec[hi + 1:]
        label = rec[self.labelIndex:hi + 1]
        return feats, label

    def _feat_array(self, feats) -> np.ndarray:
        if len(feats) == 1 and isinstance(feats[0], NDArrayWritable):
            return feats[0].value.astype(np.float32)
        return np.array([w.toDouble() for w in feats], dtype=np.float32)

    def next(self, num: int = 0) -> DataSet:
        n = num or self.batchSize
        fs, ls = [], []
        while self.reader.hasNext() and len(fs) < n:
            feats, label = self._split_record(self.reader.next())
            fs.append(self._feat_array(feats))
            if label is not None:
                if self.regression:
                    ls.append([w.toDouble() for w in label])
                else:
                    k = int(label[0].toDouble())
                    if not 0 <= k < self.numPossibleLabels:
                        raise ValueError(
                            f"label index {k} out of range for "
                            f"numPossibleLabels={self.numPossibleLabels} "
                            f"(record {len(fs) - 1} of this batch)")
                    onehot = np.zeros(self.numPossibleLabels,
                                      dtype=np.float32)
                    onehot[k] = 1.0
                    ls.append(onehot)
        if not fs:
            # next() past the end: np.stack([]) would raise a bare
            # ValueError deep in numpy — make the exhausted-reader
            # contract explicit
            raise StopIteration("reader exhausted: call reset() first")
        f = np.stack(fs)
        l = np.asarray(ls, dtype=np.float32) if ls else None
        return self._applyPre(DataSet(f, l))

    def reset(self) -> None:
        self.reader.reset()

    def batch(self) -> int:
        return self.batchSize

    def totalOutcomes(self) -> int:
        return self.numPossibleLabels

    def streaming(self) -> bool:
        return self.reader.streaming()

    def setEpoch(self, epoch: int) -> None:
        """Producer-pool epoch signal (see ``datavec.pipeline``): lets a
        reader with per-epoch randomness (augmentation) vary across the
        pool's frozen-pickle generations."""
        se = getattr(self.reader, "setEpoch", None)
        if se is not None:
            se(epoch)

    def shard(self, index: int, count: int
              ) -> "RecordReaderDataSetIterator":
        """Deterministic 1-of-``count`` shard: a copy of this iterator
        over the records ``i % count == index`` (the producer-pool
        worker contract — see ``datavec.pipeline``)."""
        out = RecordReaderDataSetIterator(
            self.reader.shard(index, count), self.batchSize,
            labelIndex=self.labelIndex,
            numPossibleLabels=self.numPossibleLabels,
            regression=self.regression, labelIndexTo=self.labelIndexTo)
        if self.getPreProcessor() is not None:
            out.setPreProcessor(self.getPreProcessor())
        return out


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequences → (b, c, t) batches padded to the longest, with masks.

    Reference: SequenceRecordReaderDataSetIterator single-reader mode
    (features+label per time step) — layout matches the RNN layers' NCW.
    """

    def __init__(self, reader: SequenceRecordReader, batchSize: int,
                 numPossibleLabels: int, labelIndex: int,
                 regression: bool = False):
        self.reader = reader
        self.batchSize = batchSize
        self.numPossibleLabels = numPossibleLabels
        self.labelIndex = labelIndex
        self.regression = regression

    def hasNext(self) -> bool:
        return self.reader.hasNext()

    def next(self, num: int = 0) -> DataSet:
        n = num or self.batchSize
        seqs = []
        while self.reader.hasNext() and len(seqs) < n:
            seqs.append(self.reader.nextSequence())
        if not seqs:
            # same exhausted-reader contract as the non-sequence
            # iterator: max() over zero sequences is a bare ValueError
            raise StopIteration("reader exhausted: call reset() first")
        tmax = max(len(s) for s in seqs)
        # infer nin from EVERY time step, not just the first step of the
        # first sequence — ragged rows must fail loudly here, not as a
        # shape error in the assignment loop below
        widths = {len(step) for seq in seqs for step in seq}
        if len(widths) != 1:
            raise ValueError(
                "inconsistent sequence step widths in batch: "
                f"{sorted(widths)} columns (every time step must carry "
                "the same feature+label column count)")
        nin = widths.pop() - 1
        nout = 1 if self.regression else self.numPossibleLabels
        b = len(seqs)
        f = np.zeros((b, nin, tmax), dtype=np.float32)
        l = np.zeros((b, nout, tmax), dtype=np.float32)
        fm = np.zeros((b, tmax), dtype=np.float32)
        for bi, seq in enumerate(seqs):
            for t, step in enumerate(seq):
                vals = [w.toDouble() for w in step]
                lab = vals.pop(self.labelIndex)
                f[bi, :, t] = vals
                if self.regression:
                    l[bi, 0, t] = lab
                else:
                    l[bi, int(lab), t] = 1.0
                fm[bi, t] = 1.0
        return self._applyPre(DataSet(f, l, fm, fm.copy()))

    def reset(self) -> None:
        self.reader.reset()

    def batch(self) -> int:
        return self.batchSize

    def totalOutcomes(self) -> int:
        return self.numPossibleLabels

    def streaming(self) -> bool:
        return self.reader.streaming()

    def shard(self, index: int, count: int
              ) -> "SequenceRecordReaderDataSetIterator":
        out = SequenceRecordReaderDataSetIterator(
            self.reader.shard(index, count), self.batchSize,
            numPossibleLabels=self.numPossibleLabels,
            labelIndex=self.labelIndex, regression=self.regression)
        if self.getPreProcessor() is not None:
            out.setPreProcessor(self.getPreProcessor())
        return out


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper.

    Reference: AsyncDataSetIterator.java — a bounded queue between a
    producer thread draining the wrapped iterator and the training loop, so
    host ETL overlaps the device step.
    """

    _END = object()

    def __init__(self, wrapped: DataSetIterator, queueSize: int = 4,
                 device=None):
        self.wrapped = wrapped
        self.queueSize = queueSize
        self._device = device
        self._q: queue.Queue = queue.Queue(maxsize=queueSize)
        self._thread: Optional[threading.Thread] = None
        self._peek = None
        self._start()

    def setDevice(self, device) -> None:
        """Route the prefetch H2D through ``device`` (a ``torch.device``;
        sharded placement waits for ROADMAP A10).  The consumer reads it
        live; set it before or between fits."""
        self._device = device

    def _start(self) -> None:
        self._q = queue.Queue(maxsize=self.queueSize)
        self._peek = None
        # waits incurred by a pre-reset drain (normalizer fit) are not the
        # next epoch's stalls
        self._telemetry_pending_wait = 0.0

        def produce():
            # liveness signal for the watchdog's starvation rule: depth 0
            # with an ACTIVE producer is starvation; depth 0 after the
            # producer exited is just a drained epoch.  Registration is
            # guarded INSIDE the sentinel-guaranteeing structure — a
            # telemetry failure (e.g. a conflicting registration of this
            # name) must degrade to "no gauge", never to a consumer
            # blocked forever on a queue that never sees _END
            active = None
            try:
                try:
                    from deeplearning4j_tpu_torch.telemetry import etl_metrics
                    active = etl_metrics().producer_active()
                    active.inc()
                except Exception:
                    active = None
                while self.wrapped.hasNext():
                    self._q.put(self.wrapped.next())
            except BaseException as e:  # surface in the consumer, not stderr
                self._q.put(e)
            finally:
                if active is not None:
                    try:
                        active.dec()
                    except Exception:
                        pass
                self._q.put(self._END)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def hasNext(self) -> bool:
        if self._peek is None:
            import time as _time

            from deeplearning4j_tpu_torch.telemetry import etl_metrics
            em = etl_metrics()
            # depth BEFORE the blocking get: 0 here means the device loop
            # is outrunning host ETL (the producer is the bottleneck)
            depth = self._q.qsize()
            em.queue_depth().set(depth)
            waiting = None
            if depth == 0:
                # starvation signals: the consumer arrived at an EMPTY
                # queue and is about to block.  The counter makes each
                # starved arrival countable; the waiting gauge is LIVE
                # for the duration of the block — the watchdog's
                # EtlStarvationRule keys on it because the depth gauge
                # goes stale between polls (a consumer busy compiling
                # for minutes must not read as starved)
                em.empty_polls().inc()
                waiting = em.consumers_waiting()
                waiting.inc()
            t0 = _time.perf_counter()
            try:
                self._peek = self._q.get()
            finally:
                if waiting is not None:
                    waiting.dec()
            wait = _time.perf_counter() - t0
            # the blocking wait lives HERE (hasNext populates the peek),
            # not in next() — hand it to the next etl_fetch so the etl
            # span/gauge/counter see it, or an input-bound async pipeline
            # would read as stall-free.  Waits for the _END sentinel or a
            # producer exception are NOT batch stalls: reporting them
            # would show a phantom stall once per epoch (producer drain)
            # or leak into the next unrelated fetch's accounting.
            if self._peek is not self._END and \
                    not isinstance(self._peek, BaseException):
                from deeplearning4j_tpu_torch.telemetry import note_etl_wait
                em.prefetch_wait().set(wait)
                note_etl_wait(wait, self)
                if self._device is not None:
                    # issue the asynchronous copy as soon as the peek
                    # exists: the transfer overlaps the caller's current
                    # step, and staging HERE (not in the producer) keeps
                    # at most ONE batch in flight on device — the
                    # bounded-ring discipline of the pool path, not
                    # queueSize batches of device memory
                    from deeplearning4j_tpu_torch.datavec.pipeline import \
                        stage_batch
                    self._peek = stage_batch(self._peek, self._device)
        if isinstance(self._peek, BaseException):
            exc = self._peek
            self._peek = None
            raise exc  # a truncated epoch must not look like a clean end
        return self._peek is not self._END

    def next(self, num: int = 0) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        ds = self._peek
        self._peek = None
        if hasattr(ds, "materialize"):      # staged H2D (see setDevice)
            ds = ds.materialize()
        return ds

    def reset(self) -> None:
        # drain current producer, reset source, restart.  A producer
        # exception encountered while draining (held in _peek or still
        # queued behind it) is re-raised AFTER the drain: a truncated
        # epoch must not be reset away silently.  State is left clean
        # (_peek == _END, thread joined) so a subsequent reset() can
        # still restart the pipeline after the caller handles the error.
        exc = self._peek if isinstance(self._peek, BaseException) else None
        while self._peek is not self._END:
            self._peek = self._q.get()
            if exc is None and isinstance(self._peek, BaseException):
                exc = self._peek
        self._thread.join()
        if exc is not None:
            raise exc
        self.wrapped.reset()
        self._start()

    def batch(self) -> int:
        return self.wrapped.batch()

    def totalOutcomes(self) -> int:
        return self.wrapped.totalOutcomes()

    def inputColumns(self) -> int:
        return self.wrapped.inputColumns()
