"""MNIST iterator — the port of ``deeplearning4j_tpu/datasets/mnist.py``
(deeplearning4j-datasets' ``MnistDataSetIterator``: fetch, cache,
iterate).  Nothing is downloaded.  The images are looked up in order:

1. idx/ubyte (optionally gzipped) or ``.npz`` files under
   ``$DL4J_TPU_DATA_DIR`` or ``~/.deeplearning4j_tpu/mnist``;
2. else a deterministic synthetic digit set (5x7 glyphs, scaled and
   placed at random, plus noise), flagged by ``isSynthetic``.  Its
   ``numpy.random.RandomState`` draws are the reference's, so one seed
   gives the same bytes in both packages.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

__all__ = ["MnistDataSetIterator"]

_GLYPHS = {  # 5x7 bitmap font for synthetic digits
    0: ["0110", "1001", "1001", "1001", "1001", "1001", "0110"],
    1: ["0010", "0110", "0010", "0010", "0010", "0010", "0111"],
    2: ["0110", "1001", "0001", "0010", "0100", "1000", "1111"],
    3: ["1110", "0001", "0001", "0110", "0001", "0001", "1110"],
    4: ["1001", "1001", "1001", "1111", "0001", "0001", "0001"],
    5: ["1111", "1000", "1000", "1110", "0001", "0001", "1110"],
    6: ["0110", "1000", "1000", "1110", "1001", "1001", "0110"],
    7: ["1111", "0001", "0010", "0010", "0100", "0100", "0100"],
    8: ["0110", "1001", "1001", "0110", "1001", "1001", "0110"],
    9: ["0110", "1001", "1001", "0111", "0001", "0001", "0110"],
}


def _data_dirs():
    env = os.environ.get("DL4J_TPU_DATA_DIR")
    dirs = [Path(env)] if env else []
    dirs.append(Path.home() / ".deeplearning4j_tpu" / "mnist")
    return dirs


def _read_idx(path: Path) -> np.ndarray:
    op = gzip.open if path.suffix == ".gz" else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _load_real(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    stem = "train" if train else "t10k"
    for d in _data_dirs():
        if not d.is_dir():
            continue
        npz = d / f"mnist_{stem}.npz"
        if npz.exists():
            with np.load(npz, allow_pickle=False) as z:
                return z["images"], z["labels"]
        for suffix in ("", ".gz"):
            imgs = d / f"{stem}-images-idx3-ubyte{suffix}"
            lbls = d / f"{stem}-labels-idx1-ubyte{suffix}"
            if imgs.exists() and lbls.exists():
                return _read_idx(imgs), _read_idx(lbls)
    return None


def _synthesize(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural MNIST stand-in: glyphs at random offsets/scales + noise
    (uint8 images, uint8 labels; the reference's draws in its order)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    imgs = np.zeros((n, 28, 28), dtype=np.float32)
    for i, d in enumerate(labels):
        glyph = np.array([[int(c) for c in row] for row in _GLYPHS[int(d)]],
                         dtype=np.float32)
        scale = rng.randint(2, 4)
        g = np.kron(glyph, np.ones((scale, scale), dtype=np.float32))
        gh, gw = g.shape
        oy = rng.randint(0, 28 - gh)
        ox = rng.randint(0, 28 - gw)
        imgs[i, oy:oy + gh, ox:ox + gw] = g * rng.uniform(0.7, 1.0)
        imgs[i] += rng.uniform(0, 0.08, size=(28, 28)).astype(np.float32)
    return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), \
        labels.astype(np.uint8)


class MnistDataSetIterator(DataSetIterator):
    """``new MnistDataSetIterator(batch, train, seed)``: flat 784-pixel
    float32 features in [0, 1] (``binarize``: > 0.3), one-hot labels,
    shuffled by ``seed`` each epoch unless ``shuffle`` is False."""

    def __init__(self, batch: int, train: bool = True, seed: int = 123,
                 numExamples: int = 0, binarize: bool = False,
                 shuffle: bool = True):
        real = _load_real(train)
        self.isSynthetic = real is None
        if real is not None:
            images, labels = real
        else:
            n = numExamples or (4096 if train else 1024)
            images, labels = _synthesize(n, seed + (0 if train else 1))
        if numExamples:
            images, labels = images[:numExamples], labels[:numExamples]
        feats = images.reshape(images.shape[0], 784).astype(np.float32) \
            / 255.0
        if binarize:
            feats = (feats > 0.3).astype(np.float32)
        onehot = np.eye(10, dtype=np.float32)[labels.astype(np.int64)]
        self._f, self._l = feats, onehot
        self._bs = int(batch)
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(feats.shape[0])
        if shuffle:
            self._rng.shuffle(self._order)
        self._i = 0

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
        return 10

    def inputColumns(self) -> int:
        return 784
