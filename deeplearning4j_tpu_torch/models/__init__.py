"""Model classes (the port of ``deeplearning4j_tpu/models``).  So far
``MultiLayerNetwork``; ComputationGraph and transfer learning wait for
ROADMAP A6 and A9."""
from deeplearning4j_tpu_torch.models.multilayer import (  # noqa: F401
    MultiLayerNetwork)
