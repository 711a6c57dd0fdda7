"""Updaters, schedules and regularization (the port of
``deeplearning4j_tpu/learning``; the reference's org/nd4j/linalg/learning)."""
from deeplearning4j_tpu_torch.learning.config import (  # noqa: F401
    AMSGrad, AdaDelta, AdaGrad, AdaMax, Adam, AdamW, IUpdater, Nadam,
    Nesterovs, NoOp, RmsProp, Sgd)
from deeplearning4j_tpu_torch.learning.regularization import (  # noqa: F401
    L1Regularization, L2Regularization, Regularization, WeightDecay)
from deeplearning4j_tpu_torch.learning.schedules import (  # noqa: F401
    CycleSchedule, ExponentialSchedule, FixedSchedule, ISchedule,
    InverseSchedule, LinearSchedule, MapSchedule, PolySchedule, ScheduleType,
    SigmoidSchedule, StepSchedule)
