"""Updaters (the port of ``deeplearning4j_tpu/learning``).  So far ``Sgd``,
``NoOp``, ``Adam`` and ``Nesterovs``; the other updaters, the schedules and
the regularization classes wait for ROADMAP A3."""
from deeplearning4j_tpu_torch.learning.config import (  # noqa: F401
    Adam, IUpdater, Nesterovs, NoOp, Sgd)
