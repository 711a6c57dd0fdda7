"""Graph vertex embeddings — the port of ``deeplearning4j_tpu/graphs``
(reference: deeplearning4j-graph org/deeplearning4j/graph — Graph,
RandomWalkIterator, DeepWalk)."""
from deeplearning4j_tpu_torch.graphs.deepwalk import (  # noqa: F401
    DeepWalk, Graph, RandomWalkIterator)
