"""Evaluation suite (the port of ``deeplearning4j_tpu/eval``; nd4j's
``org/nd4j/evaluation``)."""
from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    Evaluation, EvaluationBinary, EvaluationCalibration,
    RegressionEvaluation, ROC, ROCBinary, ROCMultiClass)
