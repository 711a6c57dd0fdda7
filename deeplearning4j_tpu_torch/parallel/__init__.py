"""The port's parallel layer, on ``torch.distributed``: one process is one
mesh position (a rank), and the collectives are explicit (ROADMAP C44).

The data and sequence axes are here: the mesh, ``ParallelWrapper`` and
``MeshTrainer`` (data parallelism, ZeRO-1, ring attention over the seq
axis), the training masters, gradient sharing and ``ParallelInference``.
The names of the model and stage axes (``PipelinedTrainer``,
``PipelineStack``, ``pipeline_apply`` and the MoE names) import, and raise
naming ROADMAP A10b when called.
"""
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    A10B, DeviceMesh, P, activate_mesh, activate_plan, active_mesh,
    active_plan, shard_params)
from deeplearning4j_tpu_torch.parallel.mesh import waits_for_a10b as _waits
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper, TrainingMode)
from deeplearning4j_tpu_torch.parallel.sharedtraining import (  # noqa: F401
    AdaptiveThresholdAlgorithm, FixedThresholdAlgorithm,
    ParameterAveragingTrainingMaster, SharedTrainingMaster,
    SparkDl4jMultiLayer, ThresholdAlgorithm, VoidConfiguration)
from deeplearning4j_tpu_torch.parallel.gradientsharing import (  # noqa: F401
    EncodedGradientsAccumulator, InProcessTransport, MeshOrganizer,
    ModelParameterServer, ResidualClippingPostProcessor)
from deeplearning4j_tpu_torch.parallel.meshtrainer import (  # noqa: F401
    MeshTrainer, ShardingPlan)
from deeplearning4j_tpu_torch.parallel.zero import (  # noqa: F401
    ZeroStage1, shard_optimizer_state)
from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    InferenceMode, ParallelInference)
from deeplearning4j_tpu_torch.parallel.ring import (  # noqa: F401
    blockwise_attention, context_parallel_attention, dot_product_attention,
    flash_attention, ring_attention)


PipelinedTrainer = _waits("PipelinedTrainer",
                          "pipeline-parallel training over a stage axis")
PipelineStack = _waits("PipelineStack", "a GPipe stage stack")
pipeline_apply = _waits("pipeline_apply", "the GPipe schedule")
MoEFeedForwardLayer = _waits("MoEFeedForwardLayer", "mixture of experts")
MoELayer = _waits("MoELayer", "mixture of experts")
init_moe = _waits("init_moe", "mixture of experts")
moe_apply = _waits("moe_apply", "mixture of experts")
moe_apply_expert_parallel = _waits("moe_apply_expert_parallel",
                                   "expert parallelism over a model axis")
