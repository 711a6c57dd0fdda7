"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package stays the reference; this package grows beside it, slice by
slice, and mirrors its module paths so each counterpart is easy to find
(``deeplearning4j_tpu/parallel/ring.py`` ->
``deeplearning4j_tpu_torch/parallel/ring.py``).  It imports ``torch`` and
never ``jax``, and imports nothing from ``deeplearning4j_tpu``.

Every Pallas kernel the JAX package wrote for the TPU that a ported path
runs becomes a kernel written by hand for Hopper (``csrc/*.cu``, built by
:mod:`deeplearning4j_tpu_torch.kernels`).  Each kernel keeps a plain
PyTorch version beside it, which runs only for tensors on the CPU (the
tests) — a CUDA tensor reaches the kernel or raises.

Ported so far (the serving slice, the long-context training slice, the
ResNet-50 slice, the recurrent slice, BERT on SameDiff, the training
user's loop around ``fit`` with LeNet-MNIST, BERT-base through TF import,
the serving tier, BERT-base through ONNX import, the zoo, Keras import,
DataVec with the tensor layer, the recommender tier, then SameDiff
finished, then training fault tolerance):

- ``parallel.ring``      — dense / blockwise / flash attention (forward and
                           backward kernels, ``FlashAttention``) and the
                           ``dot_product_attention`` dispatch;
- ``nn.conf.attention``  — ``SelfAttentionLayer``, ``KVCache``,
                           ``cached_attention`` and ``paged_attention``;
- ``nlp.transformer``    — ``TransformerLM`` prefill, KV decode, greedy and
                           speculative generation, the paged step builders;
- ``remote``             — the serving tier: ``InferenceServer``,
                           ``ModelRegistry``, ``BucketedExecutor`` with
                           ``ForwardServing`` / ``GenerativeServing``,
                           ``AdmissionControl``, ``ContinuousBatcher``
                           (paged KV pool, speculative decode),
                           ``ReplicaSet``, ``JsonModelServer``,
                           ``SameDiffJsonModelServer``,
                           ``JsonRemoteInference``;
- ``telemetry``          — the registry and ``/metrics``, tracer, flight
                           recorder, trace context and request timelines,
                           the alert rules (``default_rules``) and
                           ``HealthMonitor`` with webhooks, the retention
                           ring, ``ServingMetrics``, the training
                           instruments, the run log, federation, export
                           and the OTLP exporter;
- ``fault``              — ``FaultTolerantTrainer`` (checkpoints, NaN
                           rollback, resume, OOM micro-batches), the
                           injection harness and the serving tier's
                           replica faults;
- ``nlp.tokenization``   — WordPiece and the vocab helpers;
- ``nlp.bert_iterator``  — ``BertIterator`` (MLM and sequence-
                           classification batches);
- ``autodiff``           — SameDiff: the graph, all 522 of the
                           reference's ops with control flow and its
                           serialized regions, ``output``, gradients,
                           ``fit``, the zip serde, listeners,
                           ``evaluate``, ``execDebug``,
                           ``stepCostAnalysis``, gradient checking and
                           the validation harness;
- ``imports``            — ``TFGraphMapper`` (frozen GraphDef -> SameDiff,
                           read by the port's own wire decoder),
                           ``GraphRunner`` and ``OnnxImporter`` (ONNX
                           ModelProto -> SameDiff, read by the port's own
                           reader);
- ``nn``, ``nn.conf``    — activations, weight init, losses, ``InputType``,
                           preprocessors, the config DSL and its JSON,
                           ``DenseLayer``, ``LossLayer``, the CNN layers
                           (convolution, pooling, batch norm, activation,
                           global pooling, output), every recurrent layer
                           of ``nn.conf.recurrent`` and ``MaskingLayer``;
- ``learning``           — every updater, the ``ISchedule`` family and
                           L1/L2/``WeightDecay``;
- ``datasets``           — ``DataSet``, ``MultiDataSet``, the list,
                           array and existing-collection iterators,
                           ``CharacterIterator``, the MNIST, CIFAR-10,
                           EMNIST and Iris iterators (offline synthetic
                           sets) and the normalizers;
- ``models``             — ``MultiLayerNetwork`` and ``ComputationGraph``
                           (``init``, ``fit`` with truncated BPTT and the
                           line-search solvers, listeners, ``output``,
                           ``score``, ``evaluate``, ``rnnTimeStep`` and its
                           stored state, the flat param views, layer
                           state), the graph DSL (``graph_conf``) and
                           transfer learning;
- ``eval``               — every evaluation class;
- ``optimize``           — the stock listeners, early stopping and the
                           line-search solvers;
- ``utils``              — ``ModelSerializer`` (zips either package
                           reads) and ``ShardedCheckpointer`` (the
                           supervisor's sealed checkpoints);
- ``zoo``                — every model of the reference's zoo (``SRGAN``
                           with ``PixelShuffleLayer`` among them) and BERT
                           on SameDiff (``Bert``, ``BertBase``);
- ``ops.fused``          — ``matmul_bn_stats`` / ``conv1x1_bn_stats`` (the
                           B4 kernel; no model dispatches it).
- ``ops``                — the tensor layer: ``NDArray`` over a tensor,
                           ``NDArrayIndex``, ``DataType``, ``Nd4j``, the
                           seeded RNG, ``.npy`` serde; ``config`` and
                           ``native`` (the C++ host runtime's loader);
- ``datavec``            — readers, ``Schema`` / ``TransformProcess``,
                           joins, reductions, the image pipeline on the
                           port's own PNG codec, the iterators and the
                           producer pool with its pinned H2D ring.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when a CUDA device is asked for (explicitly or by
    default) and none is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
