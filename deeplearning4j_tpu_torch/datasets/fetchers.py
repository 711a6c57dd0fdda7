"""Dataset fetcher iterators: CIFAR-10, EMNIST, Iris — the port of
``deeplearning4j_tpu/datasets/fetchers.py`` (deeplearning4j-datasets'
``Cifar10DataSetIterator`` and ``EmnistDataSetIterator``,
deeplearning4j-core's ``IrisDataSetIterator``).

Nothing is downloaded: real data loads from ``$DL4J_TPU_DATA_DIR``
(CIFAR-10 binary batches, EMNIST idx files) when present, through a
bounded retry; otherwise a deterministic synthetic set with the same
shapes and class structure stands in (``isSynthetic``).  The synthetic
sets make the reference's ``numpy.random.RandomState`` draws, so one seed
gives the same batches in both packages.
"""
from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.datasets.mnist import _read_idx

__all__ = ["Cifar10DataSetIterator", "EmnistDataSetIterator",
           "IrisDataSetIterator"]

log = logging.getLogger(__name__)


def _data_dir() -> Optional[Path]:
    d = os.environ.get("DL4J_TPU_DATA_DIR")
    return Path(d) if d else None


def _fetch_with_retries(what: str, loader: Callable[[], Optional[Tuple]],
                        attempts: int = 3, baseDelay: float = 0.02,
                        maxDelay: float = 0.1) -> Optional[Tuple]:
    """Bounded retry around a real-data loader: ``attempts`` tries with a
    short exponential backoff; when they all fail the fetcher falls back
    to the synthetic set with a logged warning instead of raising
    mid-iteration.  The :mod:`deeplearning4j_tpu_torch.fault.injection`
    harness hooks in here (``check_fetch_fault``) so the retry/fallback
    path is deterministic under test."""
    from deeplearning4j_tpu_torch.fault.injection import check_fetch_fault
    for attempt in range(attempts):
        try:
            check_fetch_fault(what)
            return loader()
        except Exception as e:
            log.warning("%s: real-data load failed (attempt %d/%d): %s: %s",
                        what, attempt + 1, attempts, type(e).__name__, e)
            if attempt + 1 < attempts:
                time.sleep(min(baseDelay * (2 ** attempt), maxDelay))
    log.warning("%s: real-data load failed after %d attempts; "
                "falling back to the synthetic set", what, attempts)
    return None


class _ArrayIterator(DataSetIterator):
    def __init__(self, feats: np.ndarray, labels: np.ndarray, batch: int,
                 numClasses: int):
        self._f = feats
        self._onehot = np.eye(numClasses, dtype=np.float32)[labels]
        self._bs = batch
        self._i = 0
        self.numClasses = numClasses

    def hasNext(self) -> bool:
        return self._i < len(self._f)

    def next(self, num: int = 0) -> DataSet:
        j = min(self._i + (num or self._bs), len(self._f))
        ds = DataSet(self._f[self._i:j], self._onehot[self._i:j])
        self._i = j
        return self._applyPre(ds)

    def reset(self) -> None:
        self._i = 0

    def batch(self) -> int:
        return self._bs

    def totalOutcomes(self) -> int:
        return self.numClasses


def _synthetic_images(n: int, c: int, h: int, w: int, classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional blob images: each class lights a distinct region
    and channel — linearly separable but non-trivial under conv stacks."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    x = rng.randn(n, c, h, w).astype(np.float32) * 0.15
    gy, gx = np.mgrid[0:h, 0:w]
    for i, cls in enumerate(labels):
        cy = (cls * 7919 % h)
        cx = (cls * 104729 % w)
        blob = np.exp(-(((gy - cy) % h) ** 2 + ((gx - cx) % w) ** 2)
                      / (2.0 * (max(h, w) / 6.0) ** 2))
        x[i, cls % c] += blob.astype(np.float32)
    return x, labels


class Cifar10DataSetIterator(_ArrayIterator):
    """(b, 3, 32, 32) images in [0, 255], one-hot over 10 classes."""

    def __init__(self, batchSize: int, train: bool = True, seed: int = 123,
                 numExamples: int = 10000):
        data = _fetch_with_retries(
            "cifar10", lambda: self._load_real(train, numExamples))
        self.isSynthetic = data is None
        if data is None:
            x, y = _synthetic_images(numExamples, 3, 32, 32, 10, seed)
            x = (x - x.min()) / (x.max() - x.min()) * 255.0
        else:
            x, y = data
        super().__init__(x.astype(np.float32), y, batchSize, 10)

    @staticmethod
    def _load_real(train: bool, n: int):
        d = _data_dir()
        if d is None:
            return None
        base = d / "cifar-10-batches-bin"
        files = [base / f"data_batch_{i}.bin" for i in range(1, 6)] \
            if train else [base / "test_batch.bin"]
        if not all(f.exists() for f in files):
            return None
        xs, ys, have = [], [], 0
        for f in files:
            raw = np.frombuffer(f.read_bytes(), dtype=np.uint8)
            rec = raw.reshape(-1, 3073)
            ys.append(rec[:, 0])
            xs.append(rec[:, 1:].reshape(-1, 3, 32, 32))
            have += len(rec)
            if have >= n:       # don't materialize all 50k for a tiny ask
                break
        x = np.concatenate(xs)[:n].astype(np.float32)
        y = np.concatenate(ys)[:n].astype(np.int64)
        return x, y


class EmnistDataSetIterator(_ArrayIterator):
    """MNIST-shaped (flat 784 features), with the split's classes."""

    SETS = {"LETTERS": 26, "DIGITS": 10, "BALANCED": 47, "MNIST": 10}

    def __init__(self, dataSet: str, batchSize: int, train: bool = True,
                 seed: int = 123, numExamples: int = 10000):
        self.dataSetName = dataSet.upper()
        classes = self.SETS[self.dataSetName]
        data = _fetch_with_retries(
            "emnist", lambda: self._load_real(self.dataSetName, train,
                                              numExamples))
        self.isSynthetic = data is None
        if data is None:
            x, y = _synthetic_images(numExamples, 1, 28, 28, classes, seed)
            x = x.reshape(numExamples, 28 * 28)
        else:
            x, y = data
        super().__init__(x.astype(np.float32), y, batchSize, classes)

    @staticmethod
    def _load_real(name: str, train: bool, n: int):
        d = _data_dir()
        if d is None:
            return None
        tag = "train" if train else "test"
        imgs = d / f"emnist-{name.lower()}-{tag}-images-idx3-ubyte"
        labs = d / f"emnist-{name.lower()}-{tag}-labels-idx1-ubyte"
        if not (imgs.exists() and labs.exists()):
            return None
        x = _read_idx(imgs)[:n].reshape(-1, 28 * 28).astype(np.float32) \
            / 255.0
        y = _read_idx(labs)[:n].astype(np.int64)
        if name == "LETTERS":
            y = y - 1   # the LETTERS split is 1-based by its spec
        return x, y


class IrisDataSetIterator(_ArrayIterator):
    """The classic 150 x 4 measurements, generated from the published
    per-class feature means and standard deviations (seeded): the same
    shape, classes and separability as the original table."""

    _MEANS = np.array([[5.01, 3.43, 1.46, 0.25],
                       [5.94, 2.77, 4.26, 1.33],
                       [6.59, 2.97, 5.55, 2.03]])
    _STDS = np.array([[0.35, 0.38, 0.17, 0.11],
                      [0.52, 0.31, 0.47, 0.20],
                      [0.64, 0.32, 0.55, 0.27]])

    def __init__(self, batch: int = 150, numExamples: int = 150,
                 seed: int = 6):
        rng = np.random.RandomState(seed)
        per = max(1, numExamples // 3)
        xs, ys = [], []
        for c in range(3):
            xs.append(rng.randn(per, 4) * self._STDS[c] + self._MEANS[c])
            ys.append(np.full(per, c))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys).astype(np.int64)
        order = rng.permutation(len(x))
        super().__init__(x[order], y[order], batch, 3)
