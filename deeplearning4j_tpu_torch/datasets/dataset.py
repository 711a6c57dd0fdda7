"""DataSet container — the port of ``deeplearning4j_tpu/datasets/
dataset.py`` (the reference's ``org/nd4j/linalg/dataset/DataSet.java``
and ``MultiDataSet.java``): the (features, labels, featuresMask,
labelsMask) quadruple, and its multi-input form of lists.

Arrays are held as ``torch.Tensor`` (numpy arrays and nested lists are
converted, on the CPU); a model moves a batch to its own device when it
fits on it.  The ``NDArray`` facade waits for ROADMAP A2.

``shuffle`` and ``sample`` draw from ``np.random.RandomState(seed)`` as
the reference does, so one seed gives the same order in both packages;
``save`` / ``load`` use the reference's ``.npz`` keys, so a file written by
either package loads in the other.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DataSet", "SplitTestAndTrain", "MultiDataSet"]


def _tensor(x) -> Optional[torch.Tensor]:
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _cat(parts):
    return None if any(p is None for p in parts) else torch.cat(parts)


class DataSet:
    def __init__(self, features=None, labels=None, featuresMask=None,
                 labelsMask=None, offsets=None):
        self.features = _tensor(features)
        self.labels = _tensor(labels)
        self.featuresMask = _tensor(featuresMask)
        self.labelsMask = _tensor(labelsMask)
        # the reference's ragged-batch sidecar (CSR row offsets of the
        # pre-padding ragged features); carried, never read here
        self.offsets = _tensor(offsets)

    # DL4J accessors
    def getFeatures(self) -> torch.Tensor:
        return self.features

    def getLabels(self) -> torch.Tensor:
        return self.labels

    def getFeaturesMaskArray(self):
        return self.featuresMask

    def getLabelsMaskArray(self):
        return self.labelsMask

    def getOffsets(self):
        return self.offsets

    def numExamples(self) -> int:
        return int(self.features.shape[0]) if self.features is not None \
            else 0

    def _parts(self):
        return (self.features, self.labels, self.featuresMask,
                self.labelsMask)

    def _rows(self, idx) -> "DataSet":
        return DataSet(*(None if a is None else a[idx]
                         for a in self._parts()))

    def batchBy(self, batchSize: int) -> List["DataSet"]:
        n = self.numExamples()
        return [self._rows(slice(i, i + batchSize))
                for i in range(0, n, batchSize)]

    def splitTestAndTrain(self, fractionOrCount) -> "SplitTestAndTrain":
        """The first ``fractionOrCount`` examples (a fraction of them when
        it is a float) to train on, the rest to test; the masks are not
        carried, as in the reference."""
        n = self.numExamples()
        k = int(fractionOrCount * n) if isinstance(fractionOrCount, float) \
            else int(fractionOrCount)
        f, l = self.features, self.labels
        return SplitTestAndTrain(DataSet(f[:k], l[:k]),
                                 DataSet(f[k:], l[k:]))

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Reorder the examples in place by
        ``RandomState(seed).permutation``."""
        perm = torch.from_numpy(
            np.random.RandomState(seed).permutation(self.numExamples()))
        self.features, self.labels, self.featuresMask, self.labelsMask = (
            None if a is None else a[perm] for a in self._parts())

    def sample(self, n: int, seed: Optional[int] = None) -> "DataSet":
        """``n`` examples drawn without replacement by
        ``RandomState(seed).choice``."""
        idx = np.random.RandomState(seed).choice(self.numExamples(), size=n,
                                                 replace=False)
        return self._rows(torch.from_numpy(idx))

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """The examples of every ``DataSet`` in turn; a mask only when
        every part has one."""
        return DataSet(*(_cat([d._parts()[i] for d in datasets])
                         for i in range(4)))

    def asList(self) -> List["DataSet"]:
        return self.batchBy(1)

    def save(self, path) -> None:
        """``np.savez`` with the reference's keys (``features``,
        ``labels``, ``featuresMask``, ``labelsMask``, each when present)."""
        arrs = {k: a.cpu().numpy() for k, a in zip(
            ("features", "labels", "featuresMask", "labelsMask"),
            self._parts()) if a is not None}
        np.savez(path, **arrs)

    @staticmethod
    def load(path) -> "DataSet":
        with np.load(path, allow_pickle=False) as z:
            return DataSet(*(z[k] if k in z.files else None for k in (
                "features", "labels", "featuresMask", "labelsMask")))


class SplitTestAndTrain:
    def __init__(self, train: DataSet, test: DataSet):
        self._train, self._test = train, test

    def getTrain(self) -> DataSet:
        return self._train

    def getTest(self) -> DataSet:
        return self._test


class MultiDataSet:
    """Lists of features, labels and their masks (a mask list may hold
    None for an input without one) — the multi-input form a SameDiff graph
    binds to its placeholders."""

    def __init__(self, features, labels, featuresMasks=None,
                 labelsMasks=None):
        as_list = lambda v: [_tensor(x) for x in v] \
            if isinstance(v, (list, tuple)) else [_tensor(v)]
        self.features = as_list(features)
        self.labels = as_list(labels)
        self.featuresMasks = [_tensor(x) for x in featuresMasks] \
            if featuresMasks else None
        self.labelsMasks = [_tensor(x) for x in labelsMasks] \
            if labelsMasks else None

    def getFeatures(self, i: Optional[int] = None):
        return self.features if i is None else self.features[i]

    def getLabels(self, i: Optional[int] = None):
        return self.labels if i is None else self.labels[i]

    def numExamples(self) -> int:
        return int(self.features[0].shape[0])
