"""``.npy`` / ``.npz`` serde for NDArray — the port of
``deeplearning4j_tpu/ops/serde.py`` (``Nd4j.writeAsNumpy``,
``Nd4j.createFromNpyFile``, ``BinarySerde``).

Both packages write with ``np.save`` / ``np.savez`` from the array's host
copy, so a file written by either reads in the other and the bytes are
equal for the same array, dtype and shape.  A CUDA array is copied to the
host once per write (``NDArray.numpy``); a read gives a CPU array.
"""
from __future__ import annotations

import io
import os
from typing import Dict, Union

import numpy as np

from deeplearning4j_tpu_torch.ops.ndarray import NDArray

__all__ = ["write_as_numpy", "from_npy_file", "to_npy_bytes",
           "from_npy_bytes", "write_npz", "read_npz"]

PathLike = Union[str, os.PathLike]


def write_as_numpy(arr: NDArray, path: PathLike) -> None:
    np.save(os.fspath(path), arr.numpy(), allow_pickle=False)


def from_npy_file(path: PathLike) -> NDArray:
    return NDArray(np.load(os.fspath(path), allow_pickle=False))


def to_npy_bytes(arr: NDArray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr.numpy(), allow_pickle=False)
    return buf.getvalue()


def from_npy_bytes(data: bytes) -> NDArray:
    return NDArray(np.load(io.BytesIO(data), allow_pickle=False))


def write_npz(arrays: Dict[str, NDArray], path: PathLike) -> None:
    np.savez(os.fspath(path), **{k: v.numpy() for k, v in arrays.items()})


def read_npz(path: PathLike) -> Dict[str, NDArray]:
    with np.load(os.fspath(path), allow_pickle=False) as z:
        return {k: NDArray(z[k]) for k in z.files}
