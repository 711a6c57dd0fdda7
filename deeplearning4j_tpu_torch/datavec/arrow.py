"""Arrow format adapter — the port of ``deeplearning4j_tpu/datavec/arrow.py``.

Reference: ``datavec-arrow`` ``ArrowConverter.java`` /
``ArrowRecordReader`` — records <-> Arrow columnar batches, plus
feather/IPC file round trips.  The reference is built on pyarrow, which
the H100 machine lacks; the port writes and reads the files with its own
codec (``datavec/arrowipc.py``: the IPC stream and Feather v2 formats,
LZ4-frame bodies read), so a file either package writes, or pyarrow
writes, reads in the other.

One departure (ROADMAP C24): with no pyarrow, ``toTable`` returns the
port's :class:`~deeplearning4j_tpu_torch.datavec.arrowipc.ArrowTable` —
named columns, ``num_rows``, ``schema`` (fields with ``name`` and
``type``), ``column(name)`` — where the reference returns a
``pyarrow.Table``.  ``fromTable`` and ``schemaFromTable`` read either,
by the types' pyarrow names (``int32``, ``float``, ``double``, ...).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datavec.arrowipc import (
    BOOL, FLOAT32, FLOAT64, INT32, INT64, STRING, ArrowColumn, ArrowField,
    ArrowTable, is_ipc_file, read_ipc_file, read_ipc_stream, write_ipc_file,
    write_ipc_stream)
from deeplearning4j_tpu_torch.datavec.records import RecordReader
from deeplearning4j_tpu_torch.datavec.schema import (ColumnMetaData,
                                                     ColumnType, Schema)
from deeplearning4j_tpu_torch.datavec.writable import (DoubleWritable,
                                                       FloatWritable,
                                                       IntWritable,
                                                       LongWritable, Text,
                                                       Writable)

__all__ = ["ArrowConverter", "ArrowRecordReader"]

_TO_ARROW = {
    ColumnType.Integer: INT32,
    ColumnType.Long: INT64,
    ColumnType.Double: FLOAT64,
    ColumnType.Float: FLOAT32,
    ColumnType.String: STRING,
    ColumnType.Categorical: STRING,
    ColumnType.Boolean: BOOL,
    ColumnType.Time: INT64,
}

_INT_NAMES = {f"{u}int{b}" for u in ("", "u") for b in (8, 16, 32, 64)}


# pyarrow.types' predicates, by the type's name (ours or pyarrow's)
def _is_integer(t) -> bool:
    return str(t) in _INT_NAMES


def _is_int64(t) -> bool:
    return str(t) == "int64"


def _is_float32(t) -> bool:
    return str(t) == "float"


def _is_floating(t) -> bool:
    return str(t) in ("halffloat", "float", "double")


def _is_boolean(t) -> bool:
    return str(t) == "bool"


def _writable_for(arrow_type, value) -> Writable:
    if value is None:
        return Text("")
    if _is_integer(arrow_type):
        return LongWritable(int(value)) if _is_int64(arrow_type) \
            else IntWritable(int(value))
    if _is_float32(arrow_type):
        return FloatWritable(float(value))
    if _is_floating(arrow_type):
        return DoubleWritable(float(value))
    if _is_boolean(arrow_type):
        return IntWritable(int(bool(value)))
    return Text(str(value))


def _column(at, vals: list) -> ArrowColumn:
    """``pa.array(vals, type=at)``'s values: float32 rounds, an integer
    out of the type's range raises as pyarrow's conversion does."""
    if at == FLOAT32:
        vals = [float(np.float32(v)) for v in vals]
    elif _is_integer(at):
        lo, hi = (-(1 << (at.bitWidth - 1)), (1 << (at.bitWidth - 1)) - 1)
        for v in vals:
            if not lo <= v <= hi:
                raise OverflowError(
                    f"value {v} does not fit the Arrow type {at}")
    return ArrowColumn(at, vals)


class ArrowConverter:
    """records <-> Arrow tables, feather/IPC files (reference:
    ArrowConverter.toArrowColumns / readFromFile / writeRecordBatchTo)."""

    @staticmethod
    def toTable(records: List[List[Writable]], schema: Schema) -> ArrowTable:
        cols = {}
        for i, c in enumerate(schema.columns):
            at = _TO_ARROW.get(c.columnType, STRING)
            vals = []
            for r in records:
                w = r[i]
                if at == STRING:
                    vals.append(str(w.value))
                elif _is_integer(at):
                    vals.append(w.toLong())
                elif _is_boolean(at):
                    vals.append(bool(w.toInt()))
                else:
                    vals.append(w.toDouble())
            cols[c.name] = _column(at, vals)
        return ArrowTable([ArrowField(n, col.type) for n, col in cols.items()],
                          list(cols.values()))

    @staticmethod
    def fromTable(table) -> List[List[Writable]]:
        out: List[List[Writable]] = []
        arrays = [(col.type, col.to_pylist()) for col in table.columns]
        for ri in range(table.num_rows):
            out.append([_writable_for(t, vals[ri]) for t, vals in arrays])
        return out

    @staticmethod
    def schemaFromTable(table) -> Schema:
        cols = []
        for f in table.schema:
            if _is_int64(f.type):
                ct = ColumnType.Long
            elif _is_integer(f.type):
                ct = ColumnType.Integer
            elif _is_float32(f.type):
                ct = ColumnType.Float
            elif _is_floating(f.type):
                ct = ColumnType.Double
            elif _is_boolean(f.type):
                ct = ColumnType.Boolean
            else:
                ct = ColumnType.String
            cols.append(ColumnMetaData(f.name, ct))
        return Schema(cols)

    # -- files ----------------------------------------------------------
    @staticmethod
    def writeFeather(records, schema: Schema, path: str) -> None:
        write_ipc_file(ArrowConverter.toTable(records, schema), path)

    @staticmethod
    def readFeather(path: str):
        table = read_ipc_file(path)
        return (ArrowConverter.fromTable(table),
                ArrowConverter.schemaFromTable(table))

    @staticmethod
    def writeIpcStream(records, schema: Schema, path: str) -> None:
        write_ipc_stream(ArrowConverter.toTable(records, schema), path)

    @staticmethod
    def readIpcStream(path: str):
        table = read_ipc_stream(path)
        return (ArrowConverter.fromTable(table),
                ArrowConverter.schemaFromTable(table))


class ArrowRecordReader(RecordReader):
    """Iterate records out of a feather/IPC file (reference:
    ArrowRecordReader)."""

    def __init__(self):
        self._records: List[List[Writable]] = []
        self._i = 0
        self.schema: Optional[Schema] = None

    def initialize(self, path: str) -> "ArrowRecordReader":
        # the reference tries feather and falls back to the stream on
        # pyarrow's ArrowInvalid; the file format is told by its magic
        with open(path, "rb") as f:
            head = f.read(8)
        if is_ipc_file(head):
            self._records, self.schema = ArrowConverter.readFeather(path)
        else:
            self._records, self.schema = ArrowConverter.readIpcStream(path)
        self._i = 0
        return self

    def hasNext(self) -> bool:
        return self._i < len(self._records)

    def next(self) -> List[Writable]:
        r = self._records[self._i]
        self._i += 1
        return r

    def reset(self) -> None:
        self._i = 0
