"""ParallelWrapper — data-parallel training over the mesh's ranks; the port
of ``deeplearning4j_tpu/parallel/wrapper.py``.

Reference: deeplearning4j-scaleout-parallelwrapper
``org/deeplearning4j/parallelism/ParallelWrapper.java``.  As in the JAX
package the wrapper is a facade over
:class:`~deeplearning4j_tpu_torch.parallel.meshtrainer.MeshTrainer`: one
``ShardingPlan`` over the mesh, each rank steps its rows of every batch,
and one gradient all-reduce a step makes it the synchronous global step
(the reference's averaging at ``averagingFrequency=1``).  Every rank runs
the same program: build the wrapper and call ``fit`` on each.  The
``trainingMode`` / ``averagingFrequency`` / threshold knobs are accepted
and ignored, as in the reference.  ``remesh`` waits for ROADMAP A10b.
"""
from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_tpu_torch.parallel.mesh import A10B, DeviceMesh
from deeplearning4j_tpu_torch.telemetry import (ReplicaTimingListener,
                                                get_registry, tracer)

__all__ = ["ParallelWrapper", "TrainingMode"]


class TrainingMode:
    AVERAGING = "AVERAGING"
    SHARED_GRADIENTS = "SHARED_GRADIENTS"
    CUSTOM = "CUSTOM"


class ParallelWrapper:
    """``ParallelWrapper.Builder(net).workers(N)...build()`` parity."""

    def __init__(self, model, mesh: Optional[DeviceMesh] = None,
                 tensorParallel: bool = False, **_ignored):
        self.model = model
        self.mesh = mesh or DeviceMesh()
        self.tensorParallel = tensorParallel
        self._trainer = None
        self._replicaTimer = None

    # -- builder ---------------------------------------------------------
    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n: int):
            self._kw["workers"] = n
            return self

        def trainingMode(self, mode: str):
            self._kw["trainingMode"] = mode  # accepted, no-op
            return self

        def averagingFrequency(self, n: int):
            self._kw["averagingFrequency"] = n  # no-op
            return self

        def prefetchBuffer(self, n: int):
            self._kw["prefetchBuffer"] = n  # no-op
            return self

        def thresholdAlgorithm(self, algo):
            self._kw["thresholdAlgorithm"] = algo  # no-op
            return self

        def residualPostProcessor(self, p):
            self._kw["residualPostProcessor"] = p  # no-op
            return self

        def workspaceMode(self, m):
            return self

        def build(self) -> "ParallelWrapper":
            """``workers(n)`` builds ``DeviceMesh(data=n)`` over the world
            (n must be its size); without it, the world's data axis."""
            workers = self._kw.get("workers")
            mesh = DeviceMesh(data=workers) if workers else None
            return ParallelWrapper(self._model, mesh=mesh)

    # -- the one stepping path -------------------------------------------
    def trainer(self):
        """The MeshTrainer this facade steps through (built lazily; rebuilt
        when the model object or its ZeRO tag changed)."""
        from deeplearning4j_tpu_torch.parallel.meshtrainer import MeshTrainer
        tr = self._trainer
        zero_now = getattr(self.model, "_zero1Axis", None) is not None
        if tr is None or tr.net is not self.model or \
                tr.plan.zero1 != zero_now:
            tr = MeshTrainer(self.model, mesh=self.mesh,
                             tensorParallel=self.tensorParallel)
            self._trainer = tr
        return tr

    def remesh(self, mesh: DeviceMesh, reshard: bool = True) -> None:
        raise NotImplementedError(
            f"ParallelWrapper.remesh: elastic re-meshing waits for {A10B}")

    # -- API -------------------------------------------------------------
    def fit(self, iterator, epochs: int = 1) -> None:
        """Train with every batch's rows split over the mesh's data axis
        (a seq axis routes the attention layers to ring attention).  A
        streaming source engages the model's own producer pool, every rank
        reading the whole stream and keeping its rows."""
        tr = self.trainer()
        net = self.model
        timer = self._timing()
        net.addListeners(timer)
        try:
            with tracer().span("dp_fit", replicas=int(self.mesh.dataSize),
                               epochs=int(epochs)):
                tr.fit(iterator, epochs=epochs)
        finally:
            net.removeListener(timer)

    def _timing(self) -> ReplicaTimingListener:
        """Per-replica lockstep step-time gauges + the rolling max/min
        spread (``dl4j_tpu_parallel_step_time_spread``)."""
        if self._replicaTimer is None:
            ranks = self.mesh.deviceIds()
            self._replicaTimer = ReplicaTimingListener(ranks)
            get_registry().gauge(
                "dl4j_tpu_parallel_replicas",
                "Devices participating in the data-parallel mesh").set(
                    len(ranks))
        return self._replicaTimer

    def healthRules(self, stragglerRatio: float = 2.0):
        """Watchdog rules scoped to this wrapper's mesh: the per-replica
        straggler check over the step-time gauges its
        ``ReplicaTimingListener`` publishes::

            HealthMonitor(rules=default_rules() + wrapper.healthRules())
        """
        from deeplearning4j_tpu_torch.telemetry.health import \
            ReplicaStragglerRule
        self._timing()      # ensure the replica gauges exist to watch
        return [ReplicaStragglerRule(ratio=stragglerRatio)]

    def fitDataSet(self, ds) -> None:
        """One train step on a single (global) batch — the per-batch entry
        point a supervisor drives."""
        tr = self.trainer()
        t0 = time.perf_counter()
        with tracer().span("dp_step", replicas=int(self.mesh.dataSize)):
            tr.step(ds)
        self._timing().record(time.perf_counter() - t0)

    # -- supervision hooks ------------------------------------------------
    def syncToNet(self) -> None:
        """Flush trainer-held state back into the net's trees before a
        checkpoint (nothing to flush on this slice's meshes)."""
        if self._trainer is not None:
            self._trainer.syncToNet()

    def placeAfterRestore(self) -> None:
        """Re-assert plan placement after a checkpoint restore."""
        self.trainer().placeAfterRestore()

    def shutdown(self) -> None:
        pass
