"""Model classes (the port of ``deeplearning4j_tpu/models``).  So far
``MultiLayerNetwork`` and ``ComputationGraph``; transfer learning waits for
ROADMAP A9."""
from deeplearning4j_tpu_torch.models.graph import (  # noqa: F401
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multilayer import (  # noqa: F401
    MultiLayerNetwork)
