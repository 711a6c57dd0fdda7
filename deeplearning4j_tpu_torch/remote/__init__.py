"""Remote inference serving — the port of ``deeplearning4j_tpu/remote``:
``JsonModelServer`` / ``SameDiffJsonModelServer`` and the
``JsonRemoteInference`` client (``server.py``), the serving tier
(``serving.py``: bucketed executors, KV-cache decode, multi-model hosting,
admission control, ``InferenceServer``) and the iteration-level scheduler
(``scheduler.py``: paged KV pool, admit/retire between decode steps, token
streaming, speculative decode, replica fan-out)."""
from deeplearning4j_tpu_torch.remote.scheduler import (  # noqa: F401
    ContinuousBatcher, KVCachePool, ReplicaSet)
from deeplearning4j_tpu_torch.remote.server import (  # noqa: F401
    JsonModelServer, JsonRemoteInference, SameDiffJsonModelServer)
from deeplearning4j_tpu_torch.remote.serving import (  # noqa: F401
    AdmissionControl, BucketedExecutor, BucketLadder, DeadlineExceeded,
    ForwardServing, GenerativeServing, InferenceServer, ModelRegistry,
    NoHealthyReplicas, ServiceOverloaded)
