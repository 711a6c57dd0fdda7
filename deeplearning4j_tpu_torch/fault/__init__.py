"""Fault injection — the port's serving hooks (see :mod:`.injection`); the
supervisor, elastic and coordination layers wait for ROADMAP A12."""
from deeplearning4j_tpu_torch.fault.injection import (  # noqa: F401
    InjectedReplicaCrash, arm_replica_crash, check_replica_crash,
    clear_serving_faults, replica_dead, replica_slowdown, revive_replica,
    set_replica_slowdown)
