"""Schema — typed column metadata for transform pipelines.

Reference: datavec-api ``org/datavec/api/transform/schema/Schema.java``
(Builder with addColumnInteger/Double/Float/Long/Categorical/String/Time,
column name/type/index lookups).  JSON round-trip matches the reference's
Jackson-serialized intent, not its exact wire format.

The port of ``deeplearning4j_tpu/datavec/schema.py``, a copy: a schema
written by either package loads in the other, its JSON byte for byte.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence


class ColumnType:
    Integer = "Integer"
    Long = "Long"
    Double = "Double"
    Float = "Float"
    Categorical = "Categorical"
    String = "String"
    Boolean = "Boolean"
    Time = "Time"


class ColumnMetaData:
    def __init__(self, name: str, columnType: str,
                 stateNames: Optional[Sequence[str]] = None):
        self.name = name
        self.columnType = columnType
        self.stateNames = list(stateNames) if stateNames else None

    def to_dict(self):
        d = {"name": self.name, "type": self.columnType}
        if self.stateNames:
            d["stateNames"] = self.stateNames
        return d


class Schema:
    def __init__(self, columns: Sequence[ColumnMetaData]):
        self.columns = list(columns)
        self._index: Dict[str, int] = {c.name: i
                                       for i, c in enumerate(self.columns)}
        if len(self._index) != len(self.columns):
            raise ValueError("duplicate column names")

    # --- lookups (reference: Schema.java accessors) ---
    def numColumns(self) -> int:
        return len(self.columns)

    def getColumnNames(self) -> List[str]:
        return [c.name for c in self.columns]

    def getIndexOfColumn(self, name: str) -> int:
        return self._index[name]

    def getType(self, name_or_idx) -> str:
        if isinstance(name_or_idx, str):
            name_or_idx = self._index[name_or_idx]
        return self.columns[name_or_idx].columnType

    def getMetaData(self, name: str) -> ColumnMetaData:
        return self.columns[self._index[name]]

    def hasColumn(self, name: str) -> bool:
        return name in self._index

    # --- serde ---
    def toJson(self) -> str:
        return json.dumps({"columns": [c.to_dict() for c in self.columns]},
                          indent=2)

    @staticmethod
    def fromJson(s: str) -> "Schema":
        d = json.loads(s)
        return Schema([ColumnMetaData(c["name"], c["type"],
                                      c.get("stateNames"))
                       for c in d["columns"]])

    def __repr__(self):
        cols = ", ".join(f"{c.name}:{c.columnType}" for c in self.columns)
        return f"Schema({cols})"

    class Builder:
        def __init__(self):
            self._cols: List[ColumnMetaData] = []

        def addColumnInteger(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Integer))
            return self

        def addColumnLong(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Long))
            return self

        def addColumnDouble(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Double))
            return self

        def addColumnFloat(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Float))
            return self

        def addColumnString(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.String))
            return self

        def addColumnCategorical(self, name: str,
                                 *stateNames: str) -> "Schema.Builder":
            states = stateNames[0] if len(stateNames) == 1 and \
                isinstance(stateNames[0], (list, tuple)) else list(stateNames)
            self._cols.append(
                ColumnMetaData(name, ColumnType.Categorical, states))
            return self

        def addColumnBoolean(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Boolean))
            return self

        def addColumnTime(self, name: str, tz=None) -> "Schema.Builder":
            self._cols.append(ColumnMetaData(name, ColumnType.Time))
            return self

        def addColumnsDouble(self, pattern: str, lo: int,
                             hi: int) -> "Schema.Builder":
            """``addColumnsDouble("x_%d", 0, 3)`` → x_0..x_3."""
            for i in range(lo, hi + 1):
                self._cols.append(ColumnMetaData(pattern % i,
                                                 ColumnType.Double))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()


class SequenceSchema(Schema):
    """Same columns, sequence semantics: records are List[List[Record]]
    (reference: ``schema/SequenceSchema.java``; produced by
    ``TransformProcess.Builder.convertToSequence``)."""
