"""Model classes (the port of ``deeplearning4j_tpu/models``):
``MultiLayerNetwork``, ``ComputationGraph`` with its configuration and
vertices, and transfer learning."""
from deeplearning4j_tpu_torch.models.graph import (  # noqa: F401
    ComputationGraph)
from deeplearning4j_tpu_torch.models.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration, ElementWiseVertex, GraphBuilder,
    L2NormalizeVertex, MergeVertex, PreprocessorVertex, ScaleVertex,
    ShiftVertex, StackVertex, SubsetVertex, UnstackVertex)
from deeplearning4j_tpu_torch.models.multilayer import (  # noqa: F401
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.models.transferlearning import (  # noqa: F401
    FineTuneConfiguration, FrozenLayer, TransferLearning)
