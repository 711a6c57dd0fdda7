"""Training listeners, early stopping and the line-search solvers (the
port of ``deeplearning4j_tpu/optimize``; the reference's
``org/deeplearning4j/optimize`` and ``earlystopping``)."""
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener, CollectScoresIterationListener, EvaluativeListener,
    PerformanceListener, ScoreIterationListener, TimeIterationListener,
    TrainingListener)
from deeplearning4j_tpu_torch.optimize.earlystopping import (  # noqa: F401
    BestScoreEpochTerminationCondition, ClassificationScoreCalculator,
    DataSetLossCalculator, EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer, EarlyStoppingResult, EarlyStoppingTrainer,
    InMemoryModelSaver, InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition, MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition, TerminationReason)
from deeplearning4j_tpu_torch.optimize.solvers import (  # noqa: F401
    InvalidStepException)
