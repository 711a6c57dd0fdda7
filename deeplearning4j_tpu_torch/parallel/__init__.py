"""Parallel layer of the port.  So far only the attention half of
``parallel/ring.py``; the mesh, the wrappers and ring attention over a
process group come with the parallel slice (ROADMAP A10)."""
from deeplearning4j_tpu_torch.parallel.ring import (  # noqa: F401
    blockwise_attention, dot_product_attention, flash_attention)
