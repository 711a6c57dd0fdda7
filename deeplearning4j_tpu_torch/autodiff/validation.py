"""Op validation harness — the port of
``deeplearning4j_tpu/autodiff/validation.py`` (the reference's
``org/nd4j/autodiff/validation/{OpValidation,TestCase}.java``): a test case
declares a graph's expected outputs and, optionally, a numeric gradient
check; ``OpValidation`` runs it and keeps the coverage of the registered
ops, whose ``coverageReport`` names the ops no case exercised::

    tc = TestCase(sd).expectedOutput(var, expected).gradientCheck(True)
    err = OpValidation.validate(tc)     # None = pass, str = failure
    missing = OpValidation.coverageReport()
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (OP_IMPLS, SameDiff,
                                                        _np)

__all__ = ["TestCase", "OpValidation"]

#: ops with no numeric output of their own to check: the ONNX importer's,
#: covered end to end by its fixtures
_EXEMPT: Set[str] = {"onnx_flatten", "onnx_global_avg_pool"}


class TestCase:
    """Reference: validation/TestCase.java — one validation's builder."""

    __test__ = False    # not a pytest class despite the name

    def __init__(self, sd: SameDiff, testName: str = ""):
        self.sd = sd
        self.testName = testName
        self._expected: Dict[str, np.ndarray] = {}
        self._placeholders: Dict[str, np.ndarray] = {}
        self._gradCheck = False
        self._tolerance = 1e-5

    def placeholderValue(self, name, value) -> "TestCase":
        key = name.name() if hasattr(name, "name") else str(name)
        self._placeholders[key] = np.asarray(value)
        return self

    def expectedOutput(self, var, expected) -> "TestCase":
        name = var.name() if hasattr(var, "name") else str(var)
        self._expected[name] = np.asarray(expected)
        return self

    def gradientCheck(self, check: bool = True) -> "TestCase":
        self._gradCheck = check
        return self

    def gradCheckEpsilon(self, eps: float) -> "TestCase":
        return self

    def expectedPrecision(self, tol: float) -> "TestCase":
        self._tolerance = tol
        return self


class OpValidation:
    """Which registered ops a validation has exercised."""

    _tested: Set[str] = set()

    @classmethod
    def validate(cls, tc: TestCase) -> Optional[str]:
        """Run the case: None on success, else what failed.  Every op of
        the graph counts as covered."""
        sd = tc.sd
        for node in sd._ops:
            cls._tested.add(node.op)
        try:
            out = sd.output(tc._placeholders, *tc._expected.keys())
        except Exception as e:
            return f"execution failed: {type(e).__name__}: {e}"
        for name, exp in tc._expected.items():
            got = _np(out[name])
            if got.shape != exp.shape:
                return f"{name}: shape {got.shape} != expected {exp.shape}"
            if not np.allclose(got, exp, rtol=tc._tolerance,
                               atol=tc._tolerance):
                md = float(np.abs(got - exp).max())
                return f"{name}: max abs diff {md} > {tc._tolerance}"
        if tc._gradCheck and sd.getLossVariables():
            return cls._gradient_check(sd, tc)
        return None

    @classmethod
    def _gradient_check(cls, sd: SameDiff, tc: TestCase) -> Optional[str]:
        """Central differences against autograd over the graph's loss
        variables in float64, perturbing the floating-point placeholders
        (reference: TestCase.gradientCheck -> GradientCheckUtil)."""
        from deeplearning4j_tpu_torch.autodiff.gradcheck import \
            check_gradients
        # float64 throughout: the graph's float32 constants and variables
        # too (torch does not promote a matrix product's operands)
        fn = sd._build_fn(tuple(sd.getLossVariables()),
                          compute_dtype=torch.float64)
        var_vals = {k: v.double() if v.dtype == torch.float32 else v
                    for k, v in sd._var_values().items()}
        floats = {k: torch.as_tensor(v, dtype=torch.float64,
                                     device=sd.device)
                  for k, v in tc._placeholders.items()
                  if np.issubdtype(np.asarray(v).dtype, np.floating)}
        others = {k: torch.as_tensor(np.asarray(v), device=sd.device)
                  for k, v in tc._placeholders.items() if k not in floats}

        def loss_fn(p):
            res = fn({**others, **p}, var_vals, 0)
            return sum(torch.sum(v) for v in res.values())

        r = check_gradients(loss_fn, floats)
        if not r.passed:
            return (f"gradient check failed: {r.totalFailures}/"
                    f"{r.totalParams} coords, maxRelErr={r.maxRelError:.3g},"
                    f" first={r.failures[:3]}")
        return None

    @classmethod
    def recordTested(cls, *op_names: str) -> None:
        cls._tested.update(op_names)

    @classmethod
    def coverageReport(cls) -> List[str]:
        """Registered ops no validation has exercised (the reference fails
        CI on these — ``OpValidation.allOpsTested``)."""
        return sorted(set(OP_IMPLS) - cls._tested - _EXEMPT)

    @classmethod
    def coverageFraction(cls) -> float:
        total = len(set(OP_IMPLS) - _EXEMPT)
        return 1.0 - len(cls.coverageReport()) / max(total, 1)
