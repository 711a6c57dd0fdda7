"""Data types and promotion rules — the port of
``deeplearning4j_tpu/ops/dtype.py`` (the reference's ``DataType.java``
lattice: BOOL < unsigned < signed ints < HALF < BFLOAT16 < FLOAT < DOUBLE).
Promotion between two types picks the higher one, ND4J's rule rather than
NumPy's value-based promotion.

The port's counterpart of the reference's ``.jnp`` is :attr:`DataType.torch`.
New arrays default to FLOAT, and DOUBLE stays float64 end to end: torch
runs float64 natively, so the reference's process-wide x64 switch
(``deeplearning4j_tpu/__init__.py:33-36``) has no counterpart here.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = ["DataType", "promote", "from_np", "default_float",
           "set_default_float"]


class DataType(enum.Enum):
    BOOL = "bool"
    UINT8 = "uint8"
    INT8 = "int8"
    UINT16 = "uint16"
    INT16 = "int16"
    UINT32 = "uint32"
    INT32 = "int32"
    UINT64 = "uint64"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    # ------------------------------------------------------------------
    @property
    def torch(self) -> torch.dtype:
        return _TO_TORCH[self]

    @property
    def np(self):
        if self is DataType.BFLOAT16:
            try:            # numpy has no bfloat16 of its own
                import ml_dtypes
            except ImportError:
                raise TypeError("numpy has no bfloat16 without ml_dtypes")
            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.value)

    def isFPType(self) -> bool:
        return self in (DataType.HALF, DataType.BFLOAT16, DataType.FLOAT,
                        DataType.DOUBLE)

    def isIntType(self) -> bool:
        return self in (DataType.INT8, DataType.INT16, DataType.INT32,
                        DataType.INT64, DataType.UINT8, DataType.UINT16,
                        DataType.UINT32, DataType.UINT64)

    def isSigned(self) -> bool:
        return self.isFPType() or self in (
            DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64)

    def width(self) -> int:
        """Bytes per element."""
        return {DataType.BOOL: 1, DataType.UINT8: 1, DataType.INT8: 1,
                DataType.UINT16: 2, DataType.INT16: 2, DataType.UINT32: 4,
                DataType.INT32: 4, DataType.UINT64: 8, DataType.INT64: 8,
                DataType.HALF: 2, DataType.BFLOAT16: 2, DataType.FLOAT: 4,
                DataType.DOUBLE: 8}[self]

    # DL4J-style aliases
    @staticmethod
    def fromNumpy(dt) -> "DataType":
        return from_np(dt)


_TO_TORCH = {
    DataType.BOOL: torch.bool,
    DataType.UINT8: torch.uint8,
    DataType.INT8: torch.int8,
    DataType.UINT16: torch.uint16,
    DataType.INT16: torch.int16,
    DataType.UINT32: torch.uint32,
    DataType.INT32: torch.int32,
    DataType.UINT64: torch.uint64,
    DataType.INT64: torch.int64,
    DataType.HALF: torch.float16,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}

_FROM_STR = {dt.value: dt for dt in DataType}
# ND4J promotion precedence (higher wins).
_RANK = {dt: i for i, dt in enumerate([
    DataType.BOOL, DataType.UINT8, DataType.INT8, DataType.UINT16,
    DataType.INT16, DataType.UINT32, DataType.INT32, DataType.UINT64,
    DataType.INT64, DataType.HALF, DataType.BFLOAT16, DataType.FLOAT,
    DataType.DOUBLE])}


def from_np(dt) -> DataType:
    """Map a numpy or torch dtype (or a string, or a DataType) to a
    DataType."""
    if isinstance(dt, DataType):
        return dt
    if isinstance(dt, torch.dtype):
        try:
            return _FROM_TORCH[dt]
        except KeyError:
            raise ValueError(f"Unsupported dtype: {dt!r}")
    if "bfloat16" in str(dt):
        return DataType.BFLOAT16
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    try:
        return _FROM_STR[name]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dt!r}")


def promote(a: DataType, b: DataType) -> DataType:
    """ND4J-style promotion: the higher-precedence type wins; HALF with
    BFLOAT16 gives FLOAT (no exact common type)."""
    if a is b:
        return a
    if {a, b} == {DataType.HALF, DataType.BFLOAT16}:
        return DataType.FLOAT
    return a if _RANK[a] >= _RANK[b] else b


#: Default floating-point type for array creation (``Nd4j.setDefaultDataTypes``).
_DEFAULT_FLOAT = [DataType.FLOAT]


def default_float() -> DataType:
    return _DEFAULT_FLOAT[0]


def set_default_float(dt) -> None:
    _DEFAULT_FLOAT[0] = dt if isinstance(dt, DataType) else from_np(dt)
