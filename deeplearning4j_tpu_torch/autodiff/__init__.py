"""SameDiff, the define-by-graph autodiff API (the port of
``deeplearning4j_tpu/autodiff``): the graph, its 522 registered ops with
control flow, training, serde and listeners, gradient checking
(``gradcheck``) and the op validation harness (``validation``)."""
from deeplearning4j_tpu_torch.autodiff.gradcheck import (  # noqa: F401
    GradCheckResult, check_gradients)
from deeplearning4j_tpu_torch.autodiff.samediff import (  # noqa: F401
    SameDiff, SDVariable, TrainingConfig, VariableType, register_op)
