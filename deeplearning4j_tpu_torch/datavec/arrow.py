"""A stand-in for ``deeplearning4j_tpu/datavec/arrow.py``, the Arrow
feather/IPC adapter (it needs pyarrow, which the H100 machine lacks): it
waits for ROADMAP "A12 datavec formats". Its public names keep the
reference's import paths and raise naming that item when built or called."""
from deeplearning4j_tpu_torch import unported

_ITEM = "A12 datavec formats"

__all__ = ["ArrowConverter",
           "ArrowRecordReader"]

ArrowConverter = unported("ArrowConverter", _ITEM)
ArrowRecordReader = unported("ArrowRecordReader", _ITEM)
