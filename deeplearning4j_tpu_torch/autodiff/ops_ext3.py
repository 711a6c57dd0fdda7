"""Extended SameDiff ops, part 3: the port of the ops of
``deeplearning4j_tpu/autodiff/ops_ext3.py`` that the TF importer's rules
emit (``xlogy``, ``xdivy``, ``logMatrixDeterminant``).  The rest waits for
ROADMAP A12b."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.autodiff.samediff import _simple, register_op


def _where_x_zero(x, y, fn):
    safe = torch.where(x == 0, torch.ones_like(y), y)
    return torch.where(x == 0, torch.zeros_like(x * safe), fn(x, safe))


_simple("xlogy", lambda x, y: _where_x_zero(x, y,
                                            lambda a, b: a * torch.log(b)))
_simple("xdivy", lambda x, y: _where_x_zero(x, y, lambda a, b: a / b))


@register_op("logMatrixDeterminant")
def _log_det(**_):
    def f(x):
        sign, logdet = torch.linalg.slogdet(x)
        return [sign, logdet]
    return f
