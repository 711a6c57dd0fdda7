"""SharedTrainingMaster — cluster data-parallel training; the port of
``deeplearning4j_tpu/parallel/sharedtraining.py``.

Reference: dl4j-spark-parameterserver ``SharedTrainingMaster.java`` +
``SharedTrainingWrapper`` + the Aeron UDP mesh.  As in the JAX package the
threshold-encode → push → decode-apply pipeline collapses into one
synchronous gradient all-reduce a step (here over ``torch.distributed``:
NCCL between cards, gloo on the CPU), and ``VoidConfiguration`` and the
threshold knobs are recorded but unused.

Multi-process: every process calls
``SharedTrainingMaster.connect(coordinator, rank, n)`` (the launcher role
the Spark driver played), then builds the same net and master and calls
``fitMultiLayerNetwork``; each process is one rank of the mesh.
``faultConfig=`` (``FaultTolerantTrainer`` over the wrapper) waits for
ROADMAP A10b.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.gradientsharing import (  # noqa: F401
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator,
    FixedThresholdAlgorithm, ResidualClippingPostProcessor,
    ThresholdAlgorithm)
from deeplearning4j_tpu_torch.parallel.mesh import A10B, DeviceMesh
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

__all__ = ["VoidConfiguration", "SharedTrainingMaster",
           "ParameterAveragingTrainingMaster", "SparkDl4jMultiLayer",
           "ThresholdAlgorithm", "FixedThresholdAlgorithm",
           "AdaptiveThresholdAlgorithm"]


@dataclasses.dataclass
class VoidConfiguration:
    """Reference: nd4j-parameter-server ``conf/VoidConfiguration.java``.
    Transport knobs, kept for config parity (the process group has its
    own rendezvous, ``_TrainingMaster.connect``)."""
    networkMask: Optional[str] = None
    controllerAddress: Optional[str] = None
    unicastPort: int = 40123
    streamId: int = 119
    meshBuildMode: str = "MESH"


class _TrainingMaster:
    """Shared base: fluent builder + mesh-backed fit (both reference
    masters collapse to the same synchronous all-reduce here)."""

    _KNOWN: frozenset = frozenset()

    class _FluentBuilder:
        _cls = None

        def __init__(self, **seed_kw):
            self._kw = dict(seed_kw)

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(v):
                self._kw[name] = v
                return self

            return setter

        def build(self):
            kw = {k: v for k, v in self._kw.items()
                  if k in type(self)._cls._KNOWN}
            return type(self)._cls(**kw)

    # -- multi-process launcher -------------------------------------------
    @staticmethod
    def connect(coordinator_address: str, process_id: int,
                num_processes: int, backend: Optional[str] = None,
                device="cuda", timeout: float = 300.0) -> None:
        """Join the process group as rank ``process_id`` of
        ``num_processes`` (replaces the Spark driver + Aeron handshake).
        ``coordinator_address`` is ``host:port`` (``tcp://``) or a
        ``file://`` path.  The backend is ``nccl`` for a CUDA ``device``
        and ``gloo`` for the CPU unless ``backend`` says otherwise; nothing
        switches it on its own (NCCL refuses two ranks on one card)."""
        kind = torch.device(device).type
        if backend is None:
            backend = "nccl" if kind == "cuda" else "gloo"
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        if kind == "cuda":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, rank=int(process_id),
            world_size=int(num_processes),
            timeout=datetime.timedelta(seconds=float(timeout)))

    # -- training --------------------------------------------------------
    def fitMultiLayerNetwork(self, net, iterator, epochs: int = 1,
                             faultConfig: Optional[dict] = None,
                             telemetryDir: Optional[str] = None,
                             healthConfig: Optional[dict] = None):
        """Train ``net`` (a MultiLayerNetwork or ComputationGraph) over the
        master's mesh through a ``ParallelWrapper``.

        ``telemetryDir`` (or ``DL4J_TPU_TELEMETRY_DIR``) federates the
        run: periodic registry snapshots there, the merged view at
        ``/metrics/federated``, the atexit/SIGTERM flush armed.
        ``healthConfig`` starts a watchdog ``HealthMonitor`` for the fit
        (``{}`` for the default rules, or their knobs:
        ``stallTimeout``, ``starvationSeconds``,
        ``divergenceQuietSeconds``, ``stragglerRatio`` and the monitor's
        own).  ``faultConfig`` waits for ROADMAP A10b."""
        if faultConfig is not None:
            raise NotImplementedError(
                "fitMultiLayerNetwork(faultConfig=...): FaultTolerantTrainer "
                f"over a ParallelWrapper (the mesh half of fault/) waits "
                f"for {A10B}")
        from deeplearning4j_tpu_torch.telemetry import (HealthMonitor,
                                                        SnapshotWriter,
                                                        get_registry,
                                                        install_export_handlers,
                                                        set_federation_dir,
                                                        tracer)
        from deeplearning4j_tpu_torch.telemetry import \
            federation as _federation
        mesh = self.mesh or DeviceMesh()
        wrapper = ParallelWrapper(net, mesh=mesh)
        get_registry().gauge(
            "dl4j_tpu_parallel_workers",
            "Data-parallel worker count of the active training master"
        ).set(mesh.dataSize)
        run_dir = telemetryDir or _federation.get_federation_dir()
        writer = monitor = None
        try:
            if run_dir is not None:
                set_federation_dir(run_dir)
                writer = SnapshotWriter(run_dir).start()
                install_export_handlers()
            if healthConfig is not None:
                hc = dict(healthConfig)
                from deeplearning4j_tpu_torch.telemetry.health import (
                    DivergencePrecursorRule, EtlStarvationRule,
                    TrainingStallRule)
                rules = [TrainingStallRule(
                             timeout=hc.pop("stallTimeout", 120.0)),
                         EtlStarvationRule(
                             forSeconds=hc.pop("starvationSeconds", 30.0)),
                         DivergencePrecursorRule(
                             quietSeconds=hc.pop(
                                 "divergenceQuietSeconds", 300.0))]
                rules += wrapper.healthRules(
                    stragglerRatio=hc.pop("stragglerRatio", 2.0))
                monitor = HealthMonitor(rules=rules, **hc)
                monitor.start()
            with tracer().span("cluster_fit", workers=int(mesh.dataSize),
                               supervised=False):
                wrapper.fit(iterator, epochs=epochs)
        finally:
            if monitor is not None and monitor.is_running():
                monitor.stop()
            if writer is not None:
                writer.stop()       # final write: the federated view
                # keeps this worker's end-of-fit numbers after it exits
        return net

    executeTraining = fitMultiLayerNetwork


class SharedTrainingMaster(_TrainingMaster):
    _KNOWN = frozenset({"voidConfiguration", "batchSizePerWorker",
                        "workersPerNode", "thresholdAlgorithm", "mesh"})

    def __init__(self, voidConfiguration: Optional[VoidConfiguration] = None,
                 batchSizePerWorker: int = 32,
                 workersPerNode: int = -1,
                 thresholdAlgorithm: Optional[ThresholdAlgorithm] = None,
                 mesh: Optional[DeviceMesh] = None, **_ignored):
        self.voidConfiguration = voidConfiguration or VoidConfiguration()
        self.batchSizePerWorker = batchSizePerWorker
        self.workersPerNode = workersPerNode
        self.thresholdAlgorithm = thresholdAlgorithm  # recorded, unused
        self.mesh = mesh

    class Builder(_TrainingMaster._FluentBuilder):
        def __init__(self, voidConfiguration=None,
                     rddDataSetNumExamples: int = 1):
            super().__init__(voidConfiguration=voidConfiguration)


SharedTrainingMaster.Builder._cls = SharedTrainingMaster


class ParameterAveragingTrainingMaster(_TrainingMaster):
    """Reference: dl4j-spark ``ParameterAveragingTrainingMaster.java`` —
    here, as in the JAX package, a synchronous gradient all-reduce every
    step (parameter averaging at frequency 1); ``averagingFrequency`` is
    recorded, not used."""

    _KNOWN = frozenset({"batchSizePerWorker", "averagingFrequency",
                        "workerPrefetchNumBatches", "mesh"})

    def __init__(self, batchSizePerWorker: int = 32,
                 averagingFrequency: int = 1, workerPrefetchNumBatches: int = 2,
                 mesh: Optional[DeviceMesh] = None, **_ignored):
        self.batchSizePerWorker = batchSizePerWorker
        self.averagingFrequency = averagingFrequency
        self.workerPrefetchNumBatches = workerPrefetchNumBatches
        self.mesh = mesh

    class Builder(_TrainingMaster._FluentBuilder):
        def __init__(self, rddDataSetNumExamples: int = 1):
            super().__init__()


ParameterAveragingTrainingMaster.Builder._cls = \
    ParameterAveragingTrainingMaster


class SparkDl4jMultiLayer:
    """Reference: dl4j-spark ``SparkDl4jMultiLayer`` — driver-side facade.
    'The cluster' is the process group; the RDD is any DataSetIterator."""

    def __init__(self, sparkContext=None, net=None, trainingMaster=None):
        self.net = net
        self.trainingMaster = trainingMaster or SharedTrainingMaster()

    def fit(self, iterator, epochs: int = 1):
        return self.trainingMaster.fitMultiLayerNetwork(self.net, iterator,
                                                        epochs=epochs)

    def getNetwork(self):
        return self.net

    def evaluate(self, iterator):
        return self.net.evaluate(iterator)
