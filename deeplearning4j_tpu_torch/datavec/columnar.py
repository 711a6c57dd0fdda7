"""A stand-in for ``deeplearning4j_tpu/datavec/columnar.py``, the columnar file
converter and the JDBC (sqlite) reader: it waits for ROADMAP "A12 datavec
formats". Its public names keep the reference's import paths and raise
naming that item when built or called."""
from deeplearning4j_tpu_torch import unported

_ITEM = "A12 datavec formats"

__all__ = ["ColumnarConverter",
           "JDBCRecordReader"]

ColumnarConverter = unported("ColumnarConverter", _ITEM)
JDBCRecordReader = unported("JDBCRecordReader", _ITEM)
