"""TransformProcess — declarative column transform pipeline + executor.

Reference: datavec-api ``org/datavec/api/transform/TransformProcess.java``
(Builder: removeColumns, filter, categoricalToInteger/OneHot,
doubleMathOp/integerMathOp, renameColumn, conditionalReplace, stringMap, …),
``transform/condition/**`` (ConditionOp, ColumnCondition, ConditionFilter)
and datavec-local ``LocalTransformExecutor``.

Each step maps (schema, records) → (schema, records); the built process
carries the evolved output schema (``getFinalSchema``), exactly the
reference's contract.  Executors: :class:`LocalTransformExecutor` (rows of
Writables) and :class:`SparkTransformExecutor`, which partitions over the
native thread pool on one host and, across processes, over
``torch.distributed`` — the device never sees raw records.

The port of ``deeplearning4j_tpu/datavec/transform.py``: the same steps
and JSON (a process written by either package loads in the other, byte
for byte); the distributed executors run on ``torch.distributed`` where
the reference's run on ``jax.distributed``.
"""
from __future__ import annotations

import json
import math
import operator
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.schema import (ColumnMetaData, ColumnType,
                                                     Schema)
from deeplearning4j_tpu_torch.datavec.writable import (DoubleWritable, IntWritable,
                                                       Text, Writable, writable)

Record = List[Writable]


# ----------------------------------------------------------- conditions ----

class ConditionOp:
    """Reference: transform/condition/ConditionOp.java."""
    Equal = "Equal"
    NotEqual = "NotEqual"
    LessThan = "LessThan"
    LessOrEqual = "LessOrEqual"
    GreaterThan = "GreaterThan"
    GreaterOrEqual = "GreaterOrEqual"
    InSet = "InSet"
    NotInSet = "NotInSet"

    _OPS = {
        "Equal": operator.eq, "NotEqual": operator.ne,
        "LessThan": operator.lt, "LessOrEqual": operator.le,
        "GreaterThan": operator.gt, "GreaterOrEqual": operator.ge,
    }


class ColumnCondition:
    """Reference: condition/column/*ColumnCondition.java — typed compare on
    one column."""

    def __init__(self, column: str, op: str, value):
        self.column = column
        self.op = op
        self.value = value

    def test(self, schema: Schema, record: Record) -> bool:
        w = record[schema.getIndexOfColumn(self.column)]
        ctype = schema.getType(self.column)
        if ctype in (ColumnType.String, ColumnType.Categorical):
            v = w.toString() if isinstance(w, Text) else str(w.value)
        else:
            v = w.toDouble()
        if self.op == ConditionOp.InSet:
            return v in self.value
        if self.op == ConditionOp.NotInSet:
            return v not in self.value
        return ConditionOp._OPS[self.op](v, self.value)


# Convenience constructors mirroring the reference class names.
def IntegerColumnCondition(column, op, value):
    return ColumnCondition(column, op, value)


DoubleColumnCondition = IntegerColumnCondition
CategoricalColumnCondition = IntegerColumnCondition
StringColumnCondition = IntegerColumnCondition


class ConditionFilter:
    """Reference: transform/filter/ConditionFilter.java — REMOVES records
    matching the condition."""

    def __init__(self, condition: ColumnCondition):
        self.condition = condition

    def removeExample(self, schema: Schema, record: Record) -> bool:
        return self.condition.test(schema, record)


# ---------------------------------------------------------------- steps ----

class _Step:
    """One pipeline stage: schema evolution + record mapping."""

    #: row-wise steps commute with partitioning (parallel/distributed
    #: executors); global steps (reduce, convertToSequence) do not
    row_wise = True

    def out_schema(self, schema: Schema) -> Schema:
        return schema

    def apply(self, schema: Schema, records: List[Record]) -> List[Record]:
        return records

    def describe(self) -> dict:
        return {"op": type(self).__name__}

    def mutatedColumns(self) -> set:
        """Columns whose VALUES this step may change (conservative:
        steps with unknown effects report {"*"})."""
        for attr in ("name", "column"):
            if hasattr(self, attr):
                return {getattr(self, attr)}
        return set()


class _RemoveColumns(_Step):
    def __init__(self, names, keep=False):
        self.names = set(names)
        self.keep = keep

    def _keep_idx(self, schema):
        return [i for i, c in enumerate(schema.columns)
                if (c.name in self.names) == self.keep]

    def out_schema(self, schema):
        return Schema([schema.columns[i] for i in self._keep_idx(schema)])

    def apply(self, schema, records):
        idx = self._keep_idx(schema)
        return [[r[i] for i in idx] for r in records]


class _Filter(_Step):
    def __init__(self, f: ConditionFilter):
        self.f = f

    def apply(self, schema, records):
        return [r for r in records
                if not self.f.removeExample(schema, r)]


class _CategoricalToInteger(_Step):
    def __init__(self, names):
        self.names = names

    def out_schema(self, schema):
        cols = []
        for c in schema.columns:
            if c.name in self.names:
                cols.append(ColumnMetaData(c.name, ColumnType.Integer))
            else:
                cols.append(c)
        return Schema(cols)

    def apply(self, schema, records):
        out = []
        maps = {n: {s: i for i, s in
                    enumerate(schema.getMetaData(n).stateNames or [])}
                for n in self.names}
        idxs = {schema.getIndexOfColumn(n): n for n in self.names}
        for r in records:
            row = list(r)
            for i, n in idxs.items():
                key = row[i].toString() if isinstance(row[i], Text) \
                    else str(row[i].value)
                row[i] = IntWritable(maps[n][key])
            out.append(row)
        return out


class _CategoricalToOneHot(_Step):
    def __init__(self, name):
        self.name = name

    def out_schema(self, schema):
        cols = []
        for c in schema.columns:
            if c.name == self.name:
                for s in (c.stateNames or []):
                    cols.append(ColumnMetaData(f"{c.name}[{s}]",
                                               ColumnType.Integer))
            else:
                cols.append(c)
        return Schema(cols)

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        states = schema.getMetaData(self.name).stateNames or []
        out = []
        for r in records:
            key = r[i].toString() if isinstance(r[i], Text) else str(r[i].value)
            onehot = [IntWritable(1 if s == key else 0) for s in states]
            out.append(list(r[:i]) + onehot + list(r[i + 1:]))
        return out


class _IntegerToCategorical(_Step):
    def __init__(self, name, states):
        self.name = name
        self.states = list(states)

    def out_schema(self, schema):
        cols = [ColumnMetaData(c.name, ColumnType.Categorical, self.states)
                if c.name == self.name else c for c in schema.columns]
        return Schema(cols)

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        out = []
        for r in records:
            row = list(r)
            row[i] = Text(self.states[row[i].toInt()])
            out.append(row)
        return out


class _StringToCategorical(_IntegerToCategorical):
    def apply(self, schema, records):
        return records  # values already strings; only the type changes


_MATH = {
    "Add": operator.add, "Subtract": operator.sub, "Multiply": operator.mul,
    "Divide": operator.truediv, "Modulus": operator.mod,
    "ReverseSubtract": lambda a, b: b - a,
    "ReverseDivide": lambda a, b: b / a,
    "ScalarMin": min, "ScalarMax": max,
}

_MATH_FN = {
    "ABS": abs, "CEIL": math.ceil, "FLOOR": math.floor, "EXP": math.exp,
    "LOG": math.log, "LOG10": math.log10, "SQRT": math.sqrt,
    "SIN": math.sin, "COS": math.cos, "TAN": math.tan, "SIGN": lambda v:
        (v > 0) - (v < 0), "NEGATE": operator.neg,
}


class _MathOp(_Step):
    """doubleMathOp / integerMathOp (reference: MathOp enum transforms)."""

    def __init__(self, name, op, scalar, integer=False):
        self.name, self.op, self.scalar, self.integer = name, op, scalar, \
            integer

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        fn = _MATH[self.op]
        mk = IntWritable if self.integer else DoubleWritable
        out = []
        for r in records:
            row = list(r)
            v = row[i].toInt() if self.integer else row[i].toDouble()
            row[i] = mk(fn(v, self.scalar))
            out.append(row)
        return out


class _MathFunction(_Step):
    """doubleMathFunction (reference: MathFunction enum)."""

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        f = _MATH_FN[self.fn]
        out = []
        for r in records:
            row = list(r)
            row[i] = DoubleWritable(f(row[i].toDouble()))
            out.append(row)
        return out


class _Rename(_Step):
    def __init__(self, old, new):
        self.old, self.new = old, new

    def out_schema(self, schema):
        cols = [ColumnMetaData(self.new, c.columnType, c.stateNames)
                if c.name == self.old else c for c in schema.columns]
        return Schema(cols)


class _Reorder(_Step):
    def __init__(self, names):
        self.names = list(names)

    def _order(self, schema):
        rest = [c.name for c in schema.columns if c.name not in self.names]
        return [schema.getIndexOfColumn(n) for n in self.names + rest]

    def out_schema(self, schema):
        return Schema([schema.columns[i] for i in self._order(schema)])

    def apply(self, schema, records):
        order = self._order(schema)
        return [[r[i] for i in order] for r in records]


class _Duplicate(_Step):
    def __init__(self, name, newName):
        self.name, self.newName = name, newName

    def out_schema(self, schema):
        c = schema.getMetaData(self.name)
        return Schema(list(schema.columns) +
                      [ColumnMetaData(self.newName, c.columnType,
                                      c.stateNames)])

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        return [list(r) + [r[i]] for r in records]


class _ConditionalReplace(_Step):
    """Reference: ConditionalReplaceValueTransform."""

    def __init__(self, name, newValue, condition):
        self.name, self.newValue, self.condition = name, newValue, condition

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        out = []
        for r in records:
            row = list(r)
            if self.condition.test(schema, r):
                row[i] = writable(self.newValue)
            out.append(row)
        return out


class _StringMap(_Step):
    """Reference: StringMapTransform — dictionary replace."""

    def __init__(self, name, mapping):
        self.name, self.mapping = name, dict(mapping)

    def apply(self, schema, records):
        i = schema.getIndexOfColumn(self.name)
        out = []
        for r in records:
            row = list(r)
            s = row[i].toString()
            row[i] = Text(self.mapping.get(s, s))
            out.append(row)
        return out


class _Lambda(_Step):
    """Escape hatch: arbitrary (schema, records)->records callable."""

    def mutatedColumns(self) -> set:
        return {"*"}

    def __init__(self, fn: Callable[[Schema, List[Record]], List[Record]],
                 schema_fn: Optional[Callable[[Schema], Schema]] = None):
        self.fn = fn
        self.schema_fn = schema_fn

    def out_schema(self, schema):
        return self.schema_fn(schema) if self.schema_fn else schema

    def apply(self, schema, records):
        return self.fn(schema, records)


def _group_by_key(schema, keys, records):
    """Bucket records by their key-column value tuple (insertion order).
    THE grouping implementation — Reducer, convertToSequence, and the
    distributed key partitioner must agree on key semantics."""
    kidx = [schema.getIndexOfColumn(k) for k in keys]
    groups = {}
    for r in records:
        groups.setdefault(tuple(r[i].value for i in kidx), []).append(r)
    return groups


class NumericalColumnComparator:
    """Sequence step ordering (reference:
    ``transform/sequence/comparator/NumericalColumnComparator.java``)."""

    def __init__(self, column: str, ascending: bool = True):
        self.column = column
        self.ascending = ascending

    def sortKey(self, schema: Schema):
        idx = schema.getIndexOfColumn(self.column)
        return lambda rec: rec[idx].toDouble()


class StringComparator(NumericalColumnComparator):
    """Lexicographic sequence ordering on a string column."""

    def sortKey(self, schema: Schema):
        idx = schema.getIndexOfColumn(self.column)
        return lambda rec: rec[idx].toString() \
            if hasattr(rec[idx], "toString") else str(rec[idx].value)


class _Reduce(_Step):
    """GroupBy + aggregate (reference: TransformProcess.Builder.reduce)."""
    row_wise = False

    def __init__(self, reducer):
        self.reducer = reducer

    def out_schema(self, schema):
        return self.reducer.outSchema(schema)

    def apply(self, schema, records):
        return self.reducer.reduce(schema, records)

    def keyColumns(self):
        return list(self.reducer.keys)

    def describe(self):
        return {"op": "_Reduce", "keys": self.reducer.keys,
                "default": self.reducer.defaultOp,
                "colOps": self.reducer.colOps}


class _ConvertToSequence(_Step):
    """Group rows by key into time-ordered sequences (reference:
    ``TransformProcess.Builder.convertToSequence(keyColumns,
    comparator)`` + ``ConvertToSequence.java``)."""
    row_wise = False

    def __init__(self, keys, comparator):
        self.keys = list(keys)
        self.comparator = comparator

    def out_schema(self, schema):
        from deeplearning4j_tpu_torch.datavec.schema import SequenceSchema
        return SequenceSchema(schema.columns)

    def apply(self, schema, records):
        groups = _group_by_key(schema, self.keys, records)
        key_fn = self.comparator.sortKey(schema) if self.comparator else None
        out = []
        for _key, rows in groups.items():          # insertion order
            if key_fn is not None:
                rows = sorted(rows, key=key_fn,
                              reverse=not self.comparator.ascending)
            out.append(rows)
        return out

    def keyColumns(self):
        return list(self.keys)

    def describe(self):
        return {"op": "_ConvertToSequence", "keys": self.keys}


# -------------------------------------------------------------- process ----

class TransformProcess:
    def __init__(self, initialSchema: Schema, steps: Sequence[_Step]):
        self.initialSchema = initialSchema
        self.steps = list(steps)

    def getFinalSchema(self) -> Schema:
        s = self.initialSchema
        for st in self.steps:
            s = st.out_schema(s)
        return s

    def execute(self, records: List[Record]) -> List[Record]:
        s = self.initialSchema
        sequence_mode = False
        for st in self.steps:
            if sequence_mode and st.row_wise:
                # after convertToSequence, row-wise steps apply WITHIN
                # each sequence (the reference's sequence-transform
                # semantics); filters drop steps inside a sequence
                records = [st.apply(s, seq) for seq in records]
            else:
                records = st.apply(s, records)
            s = st.out_schema(s)
            if isinstance(st, _ConvertToSequence):
                sequence_mode = True
        return records

    def hasFilters(self) -> bool:
        """True when any step can DROP rows (row counts then aren't
        partition-additive — the distributed count check skips)."""
        return any(type(st).__name__ in ("_Filter", "_RemoveInvalid")
                   for st in self.steps) or not self.isRowWise()

    def isRowWise(self) -> bool:
        """False when the process contains a global (group-by) step."""
        return all(st.row_wise for st in self.steps)

    def firstGlobalKeyColumns(self) -> Optional[List[str]]:
        """Key columns of the first global step, IF they exist in the
        initial schema AND no earlier step can change their values (the
        distributed executor partitions input rows by them, so a mutated
        key would split groups across ranks)."""
        mutated: set = set()
        for st in self.steps:
            if not st.row_wise:
                keys = st.keyColumns()
                if all(self.initialSchema.hasColumn(k) for k in keys) \
                        and not (mutated & set(keys)) and \
                        mutated != {"*"}:
                    return keys
                return None
            mutated |= st.mutatedColumns()
            if "*" in mutated:
                mutated = {"*"}
        return None

    def toJson(self) -> str:
        return json.dumps({
            "initialSchema": json.loads(self.initialSchema.toJson()),
            "steps": [st.describe() for st in self.steps]}, indent=2)

    class Builder:
        def __init__(self, initialSchema: Schema):
            self._schema0 = initialSchema
            self._schema = initialSchema  # evolves as steps are added
            self._steps: List[_Step] = []

        def _add(self, step: _Step) -> "TransformProcess.Builder":
            from deeplearning4j_tpu_torch.datavec.schema import SequenceSchema
            if not step.row_wise and isinstance(self._schema,
                                                SequenceSchema):
                raise ValueError(
                    f"{type(step).__name__.lstrip('_')} after "
                    "convertToSequence is unsupported (sequences cannot "
                    "be re-grouped)")
            self._steps.append(step)
            self._schema = step.out_schema(self._schema)
            return self

        def removeColumns(self, *names):
            return self._add(_RemoveColumns(names))

        def removeAllColumnsExceptFor(self, *names):
            return self._add(_RemoveColumns(names, keep=True))

        def filter(self, f) -> "TransformProcess.Builder":
            if isinstance(f, ColumnCondition):
                f = ConditionFilter(f)
            return self._add(_Filter(f))

        def categoricalToInteger(self, *names):
            return self._add(_CategoricalToInteger(names))

        def categoricalToOneHot(self, name):
            return self._add(_CategoricalToOneHot(name))

        def integerToCategorical(self, name, states):
            return self._add(_IntegerToCategorical(name, states))

        def stringToCategorical(self, name, states):
            return self._add(_StringToCategorical(name, states))

        def doubleMathOp(self, name, op, scalar):
            return self._add(_MathOp(name, op, scalar))

        def integerMathOp(self, name, op, scalar):
            return self._add(_MathOp(name, op, scalar, integer=True))

        def doubleMathFunction(self, name, fn):
            return self._add(_MathFunction(name, fn))

        def renameColumn(self, old, new):
            return self._add(_Rename(old, new))

        def reorderColumns(self, *names):
            return self._add(_Reorder(names))

        def duplicateColumn(self, name, newName):
            return self._add(_Duplicate(name, newName))

        def conditionalReplaceValueTransform(self, name, newValue, condition):
            return self._add(_ConditionalReplace(name, newValue, condition))

        def stringMapTransform(self, name, mapping):
            return self._add(_StringMap(name, mapping))

        def transform(self, fn, schema_fn=None):
            return self._add(_Lambda(fn, schema_fn))

        def reduce(self, reducer) -> "TransformProcess.Builder":
            """GroupBy + aggregate (reference:
            ``TransformProcess.Builder.reduce(IAssociativeReducer)``)."""
            return self._add(_Reduce(reducer))

        def convertToSequence(self, keyColumns, comparator=None
                              ) -> "TransformProcess.Builder":
            """Group rows into per-key sequences ordered by
            ``comparator`` (reference: ``convertToSequence``)."""
            if isinstance(keyColumns, str):
                keyColumns = [keyColumns]
            return self._add(_ConvertToSequence(keyColumns, comparator))

        def build(self) -> "TransformProcess":
            return TransformProcess(self._schema0, self._steps)

    @staticmethod
    def builder(initialSchema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(initialSchema)


def _key_norm(v) -> str:
    """Normalize a key value so equal keys of different numeric types
    (3, 3.0, True) hash identically — matching dict-equality grouping."""
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    return str(v)


def _key_hash(record, kidx) -> int:
    """Deterministic (cross-process) hash of a record's key values."""
    import zlib
    s = "\x1f".join(_key_norm(record[i].value
                              if hasattr(record[i], "value")
                              else record[i]) for i in kidx)
    return zlib.crc32(s.encode())


class LocalTransformExecutor:
    """Reference: datavec-local ``LocalTransformExecutor.execute``."""

    @staticmethod
    def execute(records: List[Record], tp: TransformProcess) -> List[Record]:
        return tp.execute([[writable(v) for v in r] for r in records])

    @staticmethod
    def executeJoin(join, left: List[Record],
                    right: List[Record]) -> List[Record]:
        """Reference: datavec-local/spark ``executeJoin(Join, left,
        right)``."""
        return join.executeJoin(
            [[writable(v) for v in r] for r in left],
            [[writable(v) for v in r] for r in right])

    @staticmethod
    def executeParallel(records: List[Record], tp: TransformProcess,
                        minChunk: int = 256) -> List[Record]:
        """Partitioned TransformProcess execution over the native
        work-stealing pool (reference: datavec-spark
        ``SparkTransformExecutor`` mapPartitions — here the partitions run
        on ``native/src/threads.cpp``'s parallel_for instead of a
        cluster).  Row-wise steps commute with chunking; a process with a
        GLOBAL step (reduce/convertToSequence) would split groups across
        chunks, so it runs unchunked (the distributed executor instead
        partitions BY KEY — see executeDistributed)."""
        if not tp.isRowWise():
            return LocalTransformExecutor.execute(records, tp)
        from deeplearning4j_tpu_torch import native
        recs = [[writable(v) for v in r] for r in records]
        results: dict = {}

        def work(lo, hi):
            results[int(lo)] = tp.execute(recs[lo:hi])

        native.parallel_for(work, 0, len(recs), minChunk)
        out: List[Record] = []
        for lo in sorted(results):
            out.extend(results[lo])
        return out


def _world():
    """(rank, world size) of the initialised ``torch.distributed`` group,
    else (0, 1): one process, as the reference's ``process_count() == 1``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SparkTransformExecutor:
    """Reference: datavec-spark ``SparkTransformExecutor.execute(rdd, tp)``
    — distributed TransformProcess execution.  One host partitions over
    the native thread pool; a ``torch.distributed`` group partitions across
    its processes (``executeDistributed``).  ETL stays host-side.  API
    parity keeps migration one-line."""

    @staticmethod
    def execute(records: List[Record], tp: TransformProcess,
                numPartitions: int = 0) -> List[Record]:
        chunk = max(1, len(records) // numPartitions) if numPartitions \
            else 256
        return LocalTransformExecutor.executeParallel(records, tp,
                                                      minChunk=chunk)

    @staticmethod
    def executeJoin(join, left: List[Record],
                    right: List[Record]) -> List[Record]:
        """Reference: ``SparkTransformExecutor.executeJoin``."""
        return LocalTransformExecutor.executeJoin(join, left, right)

    @staticmethod
    def executeJoinDistributed(join, left: List[Record],
                               right: List[Record]) -> List[Record]:
        """Distributed join over a ``torch.distributed`` group: BOTH
        sides hash-partition by the join key, each rank joins its
        partition (Spark's shuffle-join semantics — the union of every
        rank's return equals the single-host join)."""
        rank, nproc = _world()
        if nproc <= 1:
            return LocalTransformExecutor.executeJoin(join, left, right)
        li = [join.leftSchema.getIndexOfColumn(k) for k in join.keysLeft]
        ri = [join.rightSchema.getIndexOfColumn(k) for k in join.keysRight]
        lw = [[writable(v) for v in r] for r in left]
        rw = [[writable(v) for v in r] for r in right]
        return join.executeJoin(
            [r for r in lw if _key_hash(r, li) % nproc == rank],
            [r for r in rw if _key_hash(r, ri) % nproc == rank])

    @staticmethod
    def executeDistributed(records: List[Record],
                           tp: TransformProcess) -> List[Record]:
        """Distributed TransformProcess over a ``torch.distributed``
        group (the multi-host capability, not just the API):
        each PROCESS transforms its round-robin partition of the input
        (Spark ``mapPartitions`` semantics — results stay distributed;
        concatenating every rank's return equals the single-host
        ``execute``), and a cross-process ``psum`` verifies the global
        row count so a silently-dead rank cannot fake completion.
        Single-process callers degrade to the local parallel executor
        over the full input."""
        rank, nproc = _world()
        if nproc <= 1:
            return SparkTransformExecutor.execute(records, tp)
        if tp.isRowWise():
            shard = records[rank::nproc]
        else:
            # global (group-by) steps: partition BY KEY HASH so every
            # group lands whole on one rank (Spark's shuffle semantics)
            keys = tp.firstGlobalKeyColumns()
            if keys is None:
                raise ValueError(
                    "executeDistributed: the first reduce/"
                    "convertToSequence key columns must exist in the "
                    "initial schema so rows can be key-partitioned")
            kidx = [tp.initialSchema.getIndexOfColumn(k) for k in keys]
            shard = [r for r in records
                     if _key_hash(r, kidx) % nproc == rank]
        out = LocalTransformExecutor.executeParallel(shard, tp)

        # global row-count check across ranks (an all-reduce over the
        # group's backend: gloo on the CPU)
        import torch
        import torch.distributed as dist

        count = torch.tensor([len(out)], dtype=torch.int64)
        dist.all_reduce(count)
        expected = sum(len(records[r::nproc]) for r in range(nproc))
        got = int(count.item())
        if got != expected and not tp.hasFilters():
            raise RuntimeError(
                f"distributed transform row-count mismatch: {got} != "
                f"{expected}")
        return out
