"""A stand-in for ``deeplearning4j_tpu/datavec/excel.py``, the xlsx reader and
writer: it waits for ROADMAP "A12 datavec formats". Its public names keep
the reference's import paths and raise naming that item when built or
called."""
from deeplearning4j_tpu_torch import unported

_ITEM = "A12 datavec formats"

__all__ = ["ExcelRecordReader",
           "writeXlsx"]

ExcelRecordReader = unported("ExcelRecordReader", _ITEM)
writeXlsx = unported("writeXlsx", _ITEM)
