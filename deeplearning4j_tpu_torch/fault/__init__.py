"""Fault tolerance: the training supervisor and the deterministic fault
injection harness — the port of ``deeplearning4j_tpu/fault``.

See :mod:`deeplearning4j_tpu_torch.fault.supervisor` for the recovery
semantics and :mod:`deeplearning4j_tpu_torch.fault.injection` for the
harness that exercises every path (NaN at step k, simulated preemption,
checkpoint corruption, device OOM, a stalled loop, slow/failing data
fetches) and for the serving tier's hooks.  The elastic, coordination and
chaos layers and their mesh faults wait for the mesh half of the
parallel layer (ROADMAP A10b).
"""
from deeplearning4j_tpu_torch.fault.injection import (  # noqa: F401
    ClientHangupAtToken, CorruptCheckpointAtStep, DeadlineStorm,
    FailingFetch, Fault, FaultInjector, InjectedOOM, InjectedReplicaCrash,
    NaNAtStep, OOMAtStep, PreemptAtStep, ReplicaCrashAtStep,
    SimulatedPreemption, SlowFetch, SlowReplica, StallAtStep,
    arm_replica_crash, check_replica_crash, clear_injector,
    clear_serving_faults, corrupt_checkpoint, get_injector, inject,
    replica_dead, replica_slowdown, revive_replica, set_injector,
    set_replica_slowdown)
from deeplearning4j_tpu_torch.fault.supervisor import (  # noqa: F401
    FaultTolerantTrainer, TrainingDivergedError, is_oom_error)
