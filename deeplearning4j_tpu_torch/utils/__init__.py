"""Utilities (the port of ``deeplearning4j_tpu/utils``): ``ModelSerializer``
and ``sharded_checkpoint.ShardedCheckpointer`` (its one-process half; the
restore onto another mesh waits for the parallel layer, ROADMAP A10)."""
from deeplearning4j_tpu_torch.utils.model_serializer import (  # noqa: F401
    ModelSerializer)
