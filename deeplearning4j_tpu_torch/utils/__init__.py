"""Utilities (the port of ``deeplearning4j_tpu/utils``): ``ModelSerializer``,
``sharded_checkpoint.ShardedCheckpointer`` (its one-process half; the
restore onto another mesh waits for ROADMAP A10b) and
``resources`` (``DL4JResources``, ``Resources`` and a ``Downloader`` that
reads a local mirror, never the network).  ``utils/trees.py`` has no port:
it copies pytrees that XLA donation would delete, and torch donates no
buffer (ROADMAP C43)."""
from deeplearning4j_tpu_torch.utils.model_serializer import (  # noqa: F401
    ModelSerializer)
from deeplearning4j_tpu_torch.utils.resources import (  # noqa: F401
    DL4JResources, Downloader, Resources)
