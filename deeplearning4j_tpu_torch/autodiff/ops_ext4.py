"""Extended SameDiff ops, part 4: the port of the ops of
``deeplearning4j_tpu/autodiff/ops_ext4.py`` that the TF importer's rules
emit — ``softmaxCrossEntropyWithLogits``, the reference's alias of
``softmaxCrossEntropy``.  The rest waits for ROADMAP A12b."""
from __future__ import annotations

from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS

OP_IMPLS["softmaxCrossEntropyWithLogits"] = OP_IMPLS["softmaxCrossEntropy"]
