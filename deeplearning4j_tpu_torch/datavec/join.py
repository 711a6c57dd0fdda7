"""Join — two-reader joins on key columns.

Reference: datavec-api ``org/datavec/api/transform/join/Join.java``
(JoinType Inner/LeftOuter/RightOuter/FullOuter, Builder with
setJoinColumns/setSchemas) executed by datavec-spark
``SparkTransformExecutor.executeJoin``.  Missing sides of outer joins
fill with :class:`NullWritable`, as in the reference.

Output schema: all left columns, then the right columns minus the right
join keys (the reference's layout).

The port of ``deeplearning4j_tpu/datavec/join.py``, a copy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from deeplearning4j_tpu_torch.datavec.schema import ColumnMetaData, Schema
from deeplearning4j_tpu_torch.datavec.writable import NullWritable, Writable

__all__ = ["Join", "JoinType"]


class JoinType:
    Inner = "Inner"
    LeftOuter = "LeftOuter"
    RightOuter = "RightOuter"
    FullOuter = "FullOuter"


class Join:
    def __init__(self, joinType: str, leftSchema: Schema,
                 rightSchema: Schema, keysLeft: Sequence[str],
                 keysRight: Sequence[str]):
        self.joinType = joinType
        self.leftSchema = leftSchema
        self.rightSchema = rightSchema
        self.keysLeft = list(keysLeft)
        self.keysRight = list(keysRight)
        if len(self.keysLeft) != len(self.keysRight):
            raise ValueError("left/right join column counts differ")

    def getOutputSchema(self) -> Schema:
        cols = [ColumnMetaData(c.name, c.columnType, c.stateNames)
                for c in self.leftSchema.columns]
        seen = {c.name for c in self.leftSchema.columns}
        for c in self.rightSchema.columns:
            if c.name in self.keysRight:
                continue
            name = c.name if c.name not in seen else f"right_{c.name}"
            cols.append(ColumnMetaData(name, c.columnType, c.stateNames))
        return Schema(cols)

    # ------------------------------------------------------------------
    def executeJoin(self, left: List[List[Writable]],
                    right: List[List[Writable]]) -> List[List[Writable]]:
        li = [self.leftSchema.getIndexOfColumn(k) for k in self.keysLeft]
        ri = [self.rightSchema.getIndexOfColumn(k) for k in self.keysRight]
        r_rest = [i for i in range(len(self.rightSchema.columns))
                  if i not in ri]
        table: Dict[Tuple, List[List[Writable]]] = {}
        for r in right:
            table.setdefault(tuple(w.value for w in
                                   (r[i] for i in ri)), []).append(r)
        out: List[List[Writable]] = []
        matched_right: set = set()
        for l in left:
            key = tuple(l[i].value for i in li)
            matches = table.get(key)
            if matches:
                matched_right.add(key)
                for r in matches:
                    out.append(list(l) + [r[i] for i in r_rest])
            elif self.joinType in (JoinType.LeftOuter, JoinType.FullOuter):
                out.append(list(l) +
                           [NullWritable() for _ in r_rest])
        if self.joinType in (JoinType.RightOuter, JoinType.FullOuter):
            n_left = len(self.leftSchema.columns)
            for key, rows in table.items():
                if key in matched_right:
                    continue
                for r in rows:
                    rec: List[Writable] = [NullWritable()] * n_left
                    # the key values ARE known on the right side: surface
                    # them in the left key slots (reference behavior)
                    for lpos, rpos in zip(li, ri):
                        rec[lpos] = r[rpos]
                    out.append(rec + [r[i] for i in r_rest])
        return out

    class Builder:
        def __init__(self, joinType: str = JoinType.Inner):
            self._type = joinType
            self._keysL: List[str] = []
            self._keysR: List[str] = []
            self._left: Schema = None
            self._right: Schema = None

        def setJoinColumns(self, *names: str) -> "Join.Builder":
            self._keysL = list(names)
            self._keysR = list(names)
            return self

        def setJoinColumnsLeft(self, *names: str) -> "Join.Builder":
            self._keysL = list(names)
            return self

        def setJoinColumnsRight(self, *names: str) -> "Join.Builder":
            self._keysR = list(names)
            return self

        def setSchemas(self, left: Schema, right: Schema) -> "Join.Builder":
            self._left, self._right = left, right
            return self

        def build(self) -> "Join":
            if self._left is None or self._right is None:
                raise ValueError("Join requires setSchemas(left, right)")
            if not self._keysL:
                raise ValueError("Join requires join columns")
            return Join(self._type, self._left, self._right,
                        self._keysL, self._keysR)
