"""Columnar adapters — JDBC-style SQL reader + columnar batch conversion;
the port of ``deeplearning4j_tpu/datavec/columnar.py`` (stdlib and numpy,
kept as a copy on the port's records, schema and writables).

Reference: ``datavec-jdbc`` (``JDBCRecordReader`` — reads records from a
SQL query over a JDBC DataSource) and ``datavec-arrow``
(``ArrowConverter`` — row records <-> columnar batches + file round-trip)
— SURVEY.md §2.4.  The JDBC DataSource becomes stdlib ``sqlite3``; the
Arrow columnar file becomes a numpy ``.npz`` column store (one array per
column, schema in a JSON sidecar key) — same role (zero-copy columnar
exchange with the ETL pipeline), no fake Arrow wire format claimed.
"""
from __future__ import annotations

import json
import sqlite3
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datavec.records import InputSplit, RecordReader
from deeplearning4j_tpu_torch.datavec.schema import ColumnType, Schema
from deeplearning4j_tpu_torch.datavec.writable import (DoubleWritable,
                                                 FloatWritable, IntWritable,
                                                 LongWritable, Text,
                                                 Writable, writable)

__all__ = ["JDBCRecordReader", "ColumnarConverter"]


class JDBCRecordReader(RecordReader):
    """Reference: datavec-jdbc ``JDBCRecordReader(query, dataSource)``.

    ``initialize`` accepts either an InputSplit whose single location is a
    sqlite database path, or nothing when a connection was passed in."""

    def __init__(self, query: str, conn: Optional[sqlite3.Connection] = None):
        self.query = query
        self._conn = conn
        self._rows: List[tuple] = []
        self._i = 0

    def initialize(self, split: Optional[InputSplit] = None) -> None:
        conn = self._conn
        owns = False
        if conn is None:
            if split is None:
                raise ValueError("JDBCRecordReader needs a connection or a "
                                 "split pointing at a sqlite file")
            conn = sqlite3.connect(split.locations()[0])
            owns = True
        try:
            self._rows = list(conn.execute(self.query))
        finally:
            if owns:
                conn.close()
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._rows)

    def next(self) -> List[Writable]:
        row = self._rows[self._i]
        self._i += 1
        return [writable(v) for v in row]

    def reset(self) -> None:
        self._i = 0


_COL_DTYPE = {ColumnType.Integer: np.int32, ColumnType.Long: np.int64,
              ColumnType.Float: np.float32, ColumnType.Double: np.float64}


class ColumnarConverter:
    """Reference: datavec-arrow ``ArrowConverter`` — rows <-> columnar."""

    @staticmethod
    def toColumnar(records: Sequence[Sequence], schema: Schema) -> dict:
        """Row records -> {columnName: np.ndarray} (strings: object arr)."""
        cols = {}
        names = schema.getColumnNames()
        for j, name in enumerate(names):
            ct = schema.getType(name)
            if ct == ColumnType.String:
                cols[name] = np.asarray(
                    [r[j].toString() if hasattr(r[j], "toString")
                     else str(r[j]) for r in records], object)
            else:
                cols[name] = np.asarray(
                    [r[j].toDouble() if isinstance(r[j], Writable)
                     else r[j] for r in records],
                    _COL_DTYPE.get(ct, np.float64))
        return cols

    @staticmethod
    def fromColumnar(cols: dict, schema: Schema) -> List[List[Writable]]:
        names = schema.getColumnNames()
        n = len(next(iter(cols.values()))) if cols else 0
        out = []
        for i in range(n):
            row = []
            for name in names:
                v = cols[name][i]
                ct = schema.getType(name)
                if ct == ColumnType.Integer:
                    row.append(IntWritable(int(v)))
                elif ct == ColumnType.Long:
                    row.append(LongWritable(int(v)))
                elif ct == ColumnType.Float:
                    row.append(FloatWritable(float(v)))
                elif ct == ColumnType.Double:
                    row.append(DoubleWritable(float(v)))
                else:
                    row.append(Text(str(v)))
            out.append(row)
        return out

    @staticmethod
    def save(path: str, cols: dict, schema: Schema) -> None:
        """Columnar file round-trip (ArrowConverter.writeRecordBatchTo)."""
        np.savez(path, __schema__=np.asarray(schema.toJson()),
                 **{k: v for k, v in cols.items()})

    @staticmethod
    def load(path: str):
        with np.load(path, allow_pickle=True) as z:
            schema = Schema.fromJson(str(z["__schema__"]))
            cols = {k: z[k] for k in z.files if k != "__schema__"}
        return cols, schema
