"""SameDiff, the define-by-graph autodiff API (the port of
``deeplearning4j_tpu/autodiff``).  So far the core graph, its registered
ops, training and serde; gradient checking, validation, the ``ops_ext``
families and control flow wait for ROADMAP A12b."""
from deeplearning4j_tpu_torch.autodiff.samediff import (  # noqa: F401
    SameDiff, SDVariable, TrainingConfig, VariableType, register_op)
