"""Extended SameDiff ops, part 4: the port of the ops of
``deeplearning4j_tpu/autodiff/ops_ext4.py`` that the TF and ONNX
importers' rules emit — ``softmaxCrossEntropyWithLogits``, the reference's
alias of ``softmaxCrossEntropy``, and ``squaredNorm`` (ONNX ReduceL2 and
ReduceSumSquare).  The rest waits for ROADMAP A12b."""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS, register_op

OP_IMPLS["softmaxCrossEntropyWithLogits"] = OP_IMPLS["softmaxCrossEntropy"]


@register_op("squaredNorm")
def _squared_norm(dims=None, keepDims=False, **_):
    ax = tuple(dims) if dims else None
    return lambda x: torch.sum(x * x, dim=ax, keepdim=bool(keepDims))
