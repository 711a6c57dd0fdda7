"""Utilities (the port of ``deeplearning4j_tpu/utils``): so far
``ModelSerializer``.  ``sharded_checkpoint`` waits for the parallel layer
(ROADMAP A10)."""
from deeplearning4j_tpu_torch.utils.model_serializer import (  # noqa: F401
    ModelSerializer)
