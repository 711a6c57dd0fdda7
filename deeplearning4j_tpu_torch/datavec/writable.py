"""Writable value types — the per-cell record currency.

Reference: datavec-api ``org/datavec/api/writable/*.java`` (Writable,
IntWritable, DoubleWritable, FloatWritable, LongWritable, BooleanWritable,
Text, NDArrayWritable).  The reference needs these for Hadoop-style serde;
here they are light typed wrappers so RecordReaders and TransformProcess can
keep the same API while NumPy does the bulk math.

The port of ``deeplearning4j_tpu/datavec/writable.py``: the same classes.
``NDArrayWritable`` keeps its payload as a host numpy array (records are
decoded in producer processes that must stay off the card) and hands it
out as the port's ``NDArray`` through ``get()``.
"""
from __future__ import annotations

import numpy as np


class Writable:
    def toDouble(self) -> float:
        raise NotImplementedError

    def toInt(self) -> int:
        return int(self.toDouble())

    def toFloat(self) -> float:
        return float(self.toDouble())

    def toLong(self) -> int:
        return int(self.toDouble())

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    def __eq__(self, other):
        return type(self) is type(other) and self.value == other.value

    def __hash__(self):
        return hash((type(self).__name__, self.value))


class IntWritable(Writable):
    def __init__(self, value: int):
        self.value = int(value)

    def toDouble(self):
        return float(self.value)


class LongWritable(IntWritable):
    pass


class DoubleWritable(Writable):
    def __init__(self, value: float):
        self.value = float(value)

    def toDouble(self):
        return self.value


class FloatWritable(DoubleWritable):
    pass


class BooleanWritable(Writable):
    def __init__(self, value: bool):
        self.value = bool(value)

    def toDouble(self):
        return 1.0 if self.value else 0.0


class Text(Writable):
    def __init__(self, value: str):
        self.value = str(value)

    def toDouble(self):
        return float(self.value)

    def toString(self) -> str:
        return self.value


class NullWritable(Writable):
    """Missing value (reference: NullWritable — outer-join fill)."""
    def __init__(self):
        self.value = None

    def toDouble(self):
        raise ValueError("NullWritable has no numeric value")

    def __repr__(self):
        return "NullWritable()"


class NDArrayWritable(Writable):
    def __init__(self, value):
        self.value = np.asarray(value)

    def get(self):
        """The payload as an ``NDArray`` (a CPU array)."""
        from deeplearning4j_tpu_torch.ops.ndarray import NDArray
        return NDArray(self.value)

    def toDouble(self):
        if self.value.size != 1:
            raise ValueError("NDArrayWritable with size != 1 has no scalar")
        return float(self.value.reshape(()))

    # ndarray payloads need content-based identity: the base-class
    # value-compare would raise on arrays (ambiguous truth value / unhashable)
    def __eq__(self, other):
        return (type(other) is NDArrayWritable
                and self.value.shape == other.value.shape
                and self.value.dtype == other.value.dtype
                and np.array_equal(self.value, other.value))

    def __hash__(self):
        return hash((self.value.shape, str(self.value.dtype),
                     self.value.tobytes()))


def writable(v) -> Writable:
    """Coerce a python value to the narrowest Writable."""
    if isinstance(v, Writable):
        return v
    if v is None:
        return NullWritable()   # outer-join fill round-trips as null
    if isinstance(v, (bool, np.bool_)):
        return BooleanWritable(bool(v))
    if isinstance(v, (int, np.integer)):
        return IntWritable(int(v))
    if isinstance(v, (float, np.floating)):
        return DoubleWritable(float(v))
    if isinstance(v, np.ndarray):
        return NDArrayWritable(v)
    return Text(str(v))
