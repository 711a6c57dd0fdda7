"""Reducer — groupBy + per-column aggregations.

Reference: datavec-api ``org/datavec/api/transform/reduce/Reducer.java``
(Builder with a DEFAULT ReduceOp for every non-key column plus per-column
overrides — sum/mean/min/max/count/countUnique/range/stdev/takeFirst/
takeLast) wired into ``TransformProcess.Builder.reduce(...)``.

Output naming follows the reference: an aggregated column ``x`` under op
``Sum`` becomes ``sum(x)``; TakeFirst/TakeLast keep the original name.
Key columns pass through unchanged and come first in the output schema.

The port of ``deeplearning4j_tpu/datavec/reduce.py``, a copy.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

from deeplearning4j_tpu_torch.datavec.schema import (ColumnMetaData, ColumnType,
                                                     Schema)
from deeplearning4j_tpu_torch.datavec.writable import (DoubleWritable, IntWritable,
                                                       LongWritable, Text, Writable)

__all__ = ["ReduceOp", "Reducer"]


class ReduceOp:
    TakeFirst = "TakeFirst"
    TakeLast = "TakeLast"
    Sum = "Sum"
    Mean = "Mean"
    Min = "Min"
    Max = "Max"
    Range = "Range"
    Count = "Count"
    CountUnique = "CountUnique"
    Stdev = "Stdev"


_NUMERIC = {ColumnType.Integer, ColumnType.Long, ColumnType.Double,
            ColumnType.Float}


def _out_name(op: str, name: str) -> str:
    if op in (ReduceOp.TakeFirst, ReduceOp.TakeLast):
        return name
    return f"{op[0].lower() + op[1:]}({name})"


def _out_meta(op: str, meta: ColumnMetaData) -> ColumnMetaData:
    name = _out_name(op, meta.name)
    if op in (ReduceOp.TakeFirst, ReduceOp.TakeLast, ReduceOp.Min,
              ReduceOp.Max, ReduceOp.Range):
        return ColumnMetaData(name, meta.columnType)
    if op in (ReduceOp.Count, ReduceOp.CountUnique):
        return ColumnMetaData(name, ColumnType.Long)
    if op == ReduceOp.Sum:
        t = ColumnType.Long if meta.columnType in (
            ColumnType.Integer, ColumnType.Long) else ColumnType.Double
        return ColumnMetaData(name, t)
    return ColumnMetaData(name, ColumnType.Double)     # Mean / Stdev


def _aggregate(op: str, ctype: str, ws: List[Writable]) -> Writable:
    if op == ReduceOp.TakeFirst:
        return ws[0]
    if op == ReduceOp.TakeLast:
        return ws[-1]
    if op == ReduceOp.Count:
        return LongWritable(len(ws))
    if op == ReduceOp.CountUnique:
        return LongWritable(len({w.value for w in ws}))
    if ctype not in _NUMERIC:
        raise ValueError(f"ReduceOp.{op} on non-numeric column type "
                         f"{ctype}")
    vals = [w.toDouble() for w in ws]
    integer = ctype in (ColumnType.Integer, ColumnType.Long)
    if op == ReduceOp.Sum:
        s = sum(vals)
        return LongWritable(int(s)) if integer else DoubleWritable(s)
    if op == ReduceOp.Mean:
        return DoubleWritable(sum(vals) / len(vals))
    if op == ReduceOp.Min:
        m = min(vals)
        return IntWritable(int(m)) if integer else DoubleWritable(m)
    if op == ReduceOp.Max:
        m = max(vals)
        return IntWritable(int(m)) if integer else DoubleWritable(m)
    if op == ReduceOp.Range:
        r = max(vals) - min(vals)
        return IntWritable(int(r)) if integer else DoubleWritable(r)
    if op == ReduceOp.Stdev:
        n = len(vals)
        mu = sum(vals) / n
        var = sum((v - mu) ** 2 for v in vals) / (n - 1) if n > 1 else 0.0
        return DoubleWritable(math.sqrt(var))
    raise ValueError(f"unknown ReduceOp {op!r}")


class Reducer:
    def __init__(self, keys: Sequence[str], defaultOp: str,
                 colOps: Dict[str, str]):
        self.keys = list(keys)
        self.defaultOp = defaultOp
        self.colOps = dict(colOps)

    def _op_for(self, name: str) -> str:
        return self.colOps.get(name, self.defaultOp)

    def outSchema(self, schema: Schema) -> Schema:
        cols = [ColumnMetaData(k, schema.getType(k)) for k in self.keys]
        for c in schema.columns:
            if c.name in self.keys:
                continue
            cols.append(_out_meta(self._op_for(c.name), c))
        return Schema(cols)

    def reduce(self, schema: Schema, records: List[List[Writable]]
               ) -> List[List[Writable]]:
        kidx = [schema.getIndexOfColumn(k) for k in self.keys]
        groups: Dict[tuple, List[List[Writable]]] = {}
        for r in records:
            groups.setdefault(tuple(r[i].value for i in kidx), []) \
                .append(r)
        out = []
        for key, rows in groups.items():          # insertion order
            rec: List[Writable] = [rows[0][i] for i in kidx]
            for ci, c in enumerate(schema.columns):
                if c.name in self.keys:
                    continue
                rec.append(_aggregate(self._op_for(c.name), c.columnType,
                                      [r[ci] for r in rows]))
            out.append(rec)
        return out

    class Builder:
        def __init__(self, defaultOp: str = ReduceOp.TakeFirst):
            self._default = defaultOp
            self._keys: List[str] = []
            self._ops: Dict[str, str] = {}

        def keyColumns(self, *names: str) -> "Reducer.Builder":
            self._keys.extend(names)
            return self

        def _set(self, op, names):
            for n in names:
                self._ops[n] = op
            return self

        def sumColumns(self, *names):
            return self._set(ReduceOp.Sum, names)

        def meanColumns(self, *names):
            return self._set(ReduceOp.Mean, names)

        def minColumns(self, *names):
            return self._set(ReduceOp.Min, names)

        def maxColumns(self, *names):
            return self._set(ReduceOp.Max, names)

        def rangeColumns(self, *names):
            return self._set(ReduceOp.Range, names)

        def countColumns(self, *names):
            return self._set(ReduceOp.Count, names)

        def countUniqueColumns(self, *names):
            return self._set(ReduceOp.CountUnique, names)

        def stdevColumns(self, *names):
            return self._set(ReduceOp.Stdev, names)

        def takeFirstColumns(self, *names):
            return self._set(ReduceOp.TakeFirst, names)

        def takeLastColumns(self, *names):
            return self._set(ReduceOp.TakeLast, names)

        def build(self) -> "Reducer":
            if not self._keys:
                raise ValueError("Reducer requires at least one key column")
            return Reducer(self._keys, self._default, self._ops)
