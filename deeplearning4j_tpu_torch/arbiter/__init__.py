"""Arbiter — hyperparameter optimization; the port of
``deeplearning4j_tpu/arbiter`` (reference: arbiter/ — ParameterSpace,
OptimizationConfiguration, grid, random and Bayesian search, the UI)."""
from deeplearning4j_tpu_torch.arbiter.optimize import (  # noqa: F401
    BayesianSearchGenerator, CandidateGenerator, ContinuousParameterSpace,
    DiscreteParameterSpace, GridSearchCandidateGenerator,
    IntegerParameterSpace, LocalOptimizationRunner, MaxCandidatesCondition,
    MaxTimeCondition, OptimizationConfiguration, OptimizationResult,
    RandomSearchGenerator)
from deeplearning4j_tpu_torch.arbiter.ui import (  # noqa: F401
    ArbiterUIServer, StatsStorageCandidateListener)
