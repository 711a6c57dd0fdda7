"""Ahead-of-time compilation: the persistent cache of the port's compiled
libraries — the port of ``deeplearning4j_tpu/compile``.

Eager PyTorch compiles no executables; what the port compiles are its
hand-written kernel libraries (``csrc/*.cu`` with ``nvcc``) and its
native host library (``g++``).  :mod:`.aotcache` keeps those as
persistent, content-addressed entries, preloaded at boot by the train,
serving and resume paths, behind the reference's API; :mod:`.aotc`
pre-bakes them.
"""
from deeplearning4j_tpu_torch.compile.aotcache import (  # noqa: F401
    AotCache, AotDispatch, aot_cache, set_aot_cache, device_fingerprint,
    model_digest, plan_digest, preload_model, version_fingerprint,
    wrap_jit, wrap_serving_model)
