"""Data normalizers (fit over a DataSet or an iterator, then transform)
— the port of ``deeplearning4j_tpu/datasets/normalizers.py`` (nd4j's
``NormalizerStandardize``, ``NormalizerMinMaxScaler`` and
``ImagePreProcessingScaler``).

They work on the DataSet's tensors on whatever device those lie; the
fitted statistics are kept as numpy arrays (float64 for the standardizer,
the features' dtype for the min-max scaler, as in the reference), so
``save``/``load`` and a model zip's ``normalizer.npz`` are the
reference's bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

__all__ = ["DataNormalization", "NormalizerStandardize",
           "NormalizerMinMaxScaler", "ImagePreProcessingScaler"]


def _rows(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(f.shape[0], -1)


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a).to(like.device)


class DataNormalization:
    def fit(self, data) -> None:
        raise NotImplementedError

    def transform(self, ds: DataSet) -> None:
        raise NotImplementedError

    def preProcess(self, ds: DataSet) -> None:
        self.transform(ds)

    def revert(self, ds: DataSet) -> None:
        raise NotImplementedError

    def _iterate(self, data):
        from deeplearning4j_tpu_torch.datasets.iterator import \
            DataSetIterator
        if isinstance(data, DataSet):
            yield data
        elif isinstance(data, DataSetIterator):
            data.reset()
            while data.hasNext():
                yield data.next()
            data.reset()
        else:
            yield from data


class NormalizerStandardize(DataNormalization):
    """Zero mean, unit variance per feature column (float64 statistics)."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data) -> None:
        count, s, s2 = 0, None, None
        for ds in self._iterate(data):
            f = _rows(ds.features.detach().to(torch.float64))
            s = f.sum(0) if s is None else s + f.sum(0)
            s2 = (f * f).sum(0) if s2 is None else s2 + (f * f).sum(0)
            count += f.shape[0]
        mean = s / count
        var = s2 / count - mean * mean
        self.mean = mean.cpu().numpy()
        self.std = torch.sqrt(torch.clamp(var, min=1e-12)).cpu().numpy()

    def transform(self, ds: DataSet) -> None:
        f = ds.features
        f2 = (_rows(f).to(torch.float64) - _on(self.mean, f)) \
            / _on(self.std, f)
        ds.features = f2.reshape(f.shape).to(f.dtype)

    def revert(self, ds: DataSet) -> None:
        f = ds.features
        f2 = _rows(f).to(torch.float64) * _on(self.std, f) \
            + _on(self.mean, f)
        ds.features = f2.reshape(f.shape).to(f.dtype)

    def save(self, path):
        np.savez(path, mean=self.mean, std=self.std, kind="standardize")

    @staticmethod
    def load(path) -> "NormalizerStandardize":
        n = NormalizerStandardize()
        with np.load(path, allow_pickle=False) as z:
            n.mean, n.std = z["mean"], z["std"]
        return n


class NormalizerMinMaxScaler(DataNormalization):
    """Each feature column from [min, max] seen in ``fit`` to
    [minRange, maxRange]."""

    def __init__(self, minRange: float = 0.0, maxRange: float = 1.0):
        self.minRange, self.maxRange = minRange, maxRange
        self.dataMin: Optional[np.ndarray] = None
        self.dataMax: Optional[np.ndarray] = None

    def fit(self, data) -> None:
        lo, hi = None, None
        for ds in self._iterate(data):
            f = _rows(ds.features.detach())
            mn, mx = f.min(0).values, f.max(0).values
            lo = mn if lo is None else torch.minimum(lo, mn)
            hi = mx if hi is None else torch.maximum(hi, mx)
        self.dataMin, self.dataMax = lo.cpu().numpy(), hi.cpu().numpy()

    def transform(self, ds: DataSet) -> None:
        f = ds.features
        lo = _on(self.dataMin, f)
        rng = torch.clamp(_on(self.dataMax, f) - lo, min=1e-12)
        f2 = (_rows(f) - lo) / rng
        f2 = f2 * (self.maxRange - self.minRange) + self.minRange
        ds.features = f2.reshape(f.shape).to(f.dtype)

    def revert(self, ds: DataSet) -> None:
        f = ds.features
        lo = _on(self.dataMin, f)
        rng = _on(self.dataMax, f) - lo
        f2 = (_rows(f) - self.minRange) / (self.maxRange - self.minRange)
        f2 = f2 * rng + lo
        ds.features = f2.reshape(f.shape).to(f.dtype)


class ImagePreProcessingScaler(DataNormalization):
    """Pixel values [0, maxPixelVal] -> [minRange, maxRange] (stateless)."""

    def __init__(self, minRange: float = 0.0, maxRange: float = 1.0,
                 maxPixelVal: float = 255.0):
        self.minRange, self.maxRange = minRange, maxRange
        self.maxPixelVal = maxPixelVal

    def fit(self, data) -> None:
        pass

    def transform(self, ds: DataSet) -> None:
        f = ds.features.to(torch.float32)
        ds.features = f / self.maxPixelVal * (self.maxRange - self.minRange) \
            + self.minRange

    def revert(self, ds: DataSet) -> None:
        f = ds.features
        ds.features = (f - self.minRange) / (self.maxRange - self.minRange) \
            * self.maxPixelVal
