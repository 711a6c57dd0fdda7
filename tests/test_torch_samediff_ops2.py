"""Port parity: the second half of ``autodiff/op_cases.py``'s one-op cases
against the JAX package's same ops, held as ``test_torch_samediff_ops.py``
holds the first half (split so that the suite's workers share them)."""
import pytest

from deeplearning4j_tpu_torch.autodiff.op_cases import CASES
from test_torch_samediff_ops import HALF, _hold

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("case", CASES[HALF:],
                         ids=[c.id for c in CASES[HALF:]])
def test_op_against_the_reference(case, capsys):
    _hold(case)
