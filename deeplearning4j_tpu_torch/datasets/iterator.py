"""DataSetIterator SPI and the stock in-memory iterators — the port of
``deeplearning4j_tpu/datasets/iterator.py`` (the reference's
``DataSetIterator.java``, ``ListDataSetIterator.java``, and the
iterators over arrays and over an existing collection).  The Python
iterator protocol is supported too (``for ds in it``, resetting first).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

__all__ = ["DataSetIterator", "ListDataSetIterator",
           "INDArrayDataSetIterator", "ExistingDataSetIterator"]


class DataSetIterator:
    """SPI: hasNext/next/reset/batch/totalOutcomes/inputColumns."""

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self, num: int = 0) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        return -1

    def totalOutcomes(self) -> int:
        return -1

    def inputColumns(self) -> int:
        return -1

    def resetSupported(self) -> bool:
        return True

    def asyncSupported(self) -> bool:
        return True

    def getPreProcessor(self):
        return getattr(self, "_preProcessor", None)

    def setPreProcessor(self, p) -> None:
        self._preProcessor = p

    def _applyPre(self, ds: DataSet) -> DataSet:
        p = self.getPreProcessor()
        if p is not None:
            # a shallow copy first: preprocessors rebind ds.features, and
            # ListDataSetIterator hands out its cached DataSets
            ds = DataSet(ds.features, ds.labels, ds.featuresMask,
                         ds.labelsMask)
            p.preProcess(ds)
        return ds

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        return self.next()


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of DataSets (one DataSet with ``batch > 0`` is split
    into batches of that size)."""

    def __init__(self, datasets: List[DataSet], batch: int = -1):
        if batch > 0 and len(datasets) == 1:
            datasets = datasets[0].batchBy(batch)
        self._ds = list(datasets)
        self._i = 0
        self._batch = batch if batch > 0 else (
            self._ds[0].numExamples() if self._ds else -1)

    def hasNext(self) -> bool:
        return self._i < len(self._ds)

    def next(self, num: int = 0) -> DataSet:
        ds = self._ds[self._i]
        self._i += 1
        return self._applyPre(ds)

    def reset(self) -> None:
        self._i = 0

    def batch(self) -> int:
        return self._batch

    def totalOutcomes(self) -> int:
        return int(self._ds[0].labels.shape[-1]) \
            if self._ds and self._ds[0].labels is not None else -1

    def inputColumns(self) -> int:
        return int(self._ds[0].features.shape[-1]) if self._ds else -1


class INDArrayDataSetIterator(DataSetIterator):
    """Mini-batches over in-memory (features, labels) arrays, optionally
    shuffled each epoch by a seeded ``numpy.random.RandomState`` (the
    reference's draws, so one seed gives the same batches in both
    packages)."""

    def __init__(self, features, labels, batchSize: int,
                 shuffle: bool = False, seed: Optional[int] = None):
        self._f = np.asarray(features)
        self._l = np.asarray(labels)
        self._bs = int(batchSize)
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(self._f.shape[0])
        self._i = 0
        if shuffle:
            self._rng.shuffle(self._order)

    def hasNext(self) -> bool:
        return self._i < self._f.shape[0]

    def next(self, num: int = 0) -> DataSet:
        j = min(self._i + self._bs, self._f.shape[0])
        idx = self._order[self._i:j]
        self._i = j
        return self._applyPre(DataSet(self._f[idx], self._l[idx]))

    def reset(self) -> None:
        self._i = 0
        if self._shuffle:
            self._rng.shuffle(self._order)

    def batch(self) -> int:
        return self._bs

    def totalOutcomes(self) -> int:
        return self._l.shape[-1]

    def inputColumns(self) -> int:
        return self._f.shape[-1]


class ExistingDataSetIterator(DataSetIterator):
    """Iterate an existing collection of DataSets."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._src = list(iterable)
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._src)

    def next(self, num: int = 0) -> DataSet:
        ds = self._src[self._i]
        self._i += 1
        return self._applyPre(ds)

    def reset(self) -> None:
        self._i = 0
