"""Tensor-level operations (the port of ``deeplearning4j_tpu/ops``).  So far
``fused``, the counterpart of ``ops/pallas_fused.py``; the ``NDArray``
facade, dtypes, the factory, serde and the RNG wait for ROADMAP A2."""
