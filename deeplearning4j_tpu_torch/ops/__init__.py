"""The tensor layer (the port of ``deeplearning4j_tpu/ops``, ND4J's role):
``NDArray`` over ``torch.Tensor`` with ND4J's aliasing views, ``DataType``
and its promotion rules, the ``Nd4j`` factory, the seeded RNG and
``.npy`` serde; and ``fused``, the counterpart of ``ops/pallas_fused.py``
(the B4 kernel)."""

from deeplearning4j_tpu_torch.ops.dtype import DataType, promote, from_np  # noqa: F401
from deeplearning4j_tpu_torch.ops.ndarray import NDArray, NDArrayIndex  # noqa: F401
from deeplearning4j_tpu_torch.ops.factory import Nd4j  # noqa: F401
from deeplearning4j_tpu_torch.ops.random import RandomGenerator, get_random  # noqa: F401
from deeplearning4j_tpu_torch.ops import serde  # noqa: F401
