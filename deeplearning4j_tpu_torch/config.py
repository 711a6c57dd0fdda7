"""Runtime environment and flag registry — the port of
``deeplearning4j_tpu/config.py`` (the reference's ``ND4JSystemProperties``,
``ND4JEnvironmentVars`` and ``Nd4j.getEnvironment()``).

``maxThreads`` steers the port's native thread pool
(:mod:`deeplearning4j_tpu_torch.native`) and torch's intra-op pool
(``torch.set_num_threads``), where the reference steered XLA.  Workspace
modes are accepted and ignored, as in the reference (the caching
allocator owns device buffers).  Reach it through ``Nd4j.getEnvironment()``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["ND4JEnvironmentVars", "ND4JSystemProperties", "Environment"]


class ND4JEnvironmentVars:
    """The environment-variable names (reference: ND4JEnvironmentVars)."""
    ND4J_DATA_DIR = "DL4J_TPU_DATA_DIR"
    OMP_NUM_THREADS = "OMP_NUM_THREADS"
    ND4J_DEBUG = "DL4J_TPU_DEBUG"
    ND4J_VERBOSE = "DL4J_TPU_VERBOSE"
    DISABLE_NATIVE = "DL4J_TPU_DISABLE_NATIVE"


class ND4JSystemProperties:
    """Reference: ND4JSystemProperties (JVM -D flags; here env too)."""
    DATA_DIR = ND4JEnvironmentVars.ND4J_DATA_DIR
    LOG_INITIALIZATION = "DL4J_TPU_LOG_INIT"


class Environment:
    """Reference: Nd4j.getEnvironment() — the runtime flag mirror."""

    _instance: Optional["Environment"] = None

    def __init__(self):
        def env_flag(name: str) -> bool:
            # "0"/"false"/"" turn a flag off
            return os.environ.get(name, "").strip().lower() \
                not in ("", "0", "false", "no", "off")

        self._debug = env_flag(ND4JEnvironmentVars.ND4J_DEBUG)
        self._verbose = env_flag(ND4JEnvironmentVars.ND4J_VERBOSE)
        self._allowHelpers = True

    @classmethod
    def getInstance(cls) -> "Environment":
        if cls._instance is None:
            cls._instance = Environment()
        return cls._instance

    # -- debug/verbose ---------------------------------------------------
    def isDebug(self) -> bool:
        return self._debug

    def isVerbose(self) -> bool:
        return self._verbose

    def setDebug(self, b: bool) -> None:
        self._debug = bool(b)

    def setVerbose(self, b: bool) -> None:
        self._verbose = bool(b)

    # -- threading: the native pool and torch's intra-op pool -------------
    def maxThreads(self) -> int:
        from deeplearning4j_tpu_torch import native
        return native.num_threads()

    def setMaxThreads(self, n: int) -> None:
        from deeplearning4j_tpu_torch import native
        native.set_num_threads(int(n))
        torch.set_num_threads(int(n))

    # -- device info -----------------------------------------------------
    def isCPU(self) -> bool:
        return not torch.cuda.is_available()

    def blasMajorVersion(self) -> int:
        return 0    # the BLAS is cuBLAS's (or torch's CPU build's) concern

    # -- precision -------------------------------------------------------
    def allowsPrecisionDowncast(self) -> bool:
        return True   # bf16 mixed precision via .dataType("BFLOAT16")

    def allowHelpers(self, b: Optional[bool] = None):
        """Reference: the cuDNN/oneDNN helper toggle; the knob is kept and
        gates nothing."""
        if b is not None:
            self._allowHelpers = bool(b)
        return self._allowHelpers
