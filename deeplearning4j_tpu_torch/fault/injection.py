"""Deterministic fault injection for the serving tier — the port of the
serving hooks of ``deeplearning4j_tpu/fault/injection.py`` (``:218-289``):
a replica crash armed by name and consumed by the continuous batcher at its
next decode step, the dead-replica set its health probe reads, and an
injected per-replica slowdown.  The training supervisor's faults and the
``inject`` harness wait for ROADMAP A12.
"""
from __future__ import annotations

__all__ = ["InjectedReplicaCrash", "arm_replica_crash",
           "check_replica_crash", "replica_dead", "revive_replica",
           "set_replica_slowdown", "replica_slowdown",
           "clear_serving_faults"]


class InjectedReplicaCrash(RuntimeError):
    """Shaped like an unavailable-device error so the serving tier's
    failure path treats an injected replica crash exactly like a real dead
    accelerator behind a batcher."""

    def __init__(self, replica: str, note: str = "injected"):
        self.replica = str(replica)
        super().__init__(
            f"UNAVAILABLE: serving replica {replica!r} lost ({note}); "
            f"its device is permanently unreachable")


# -- simulated serving-replica failures --------------------------------------
# Serving-tier analogues of the lost-device registry.  A CRASH is armed
# per replica name and consumed by the continuous batcher at its next
# decode step (the dispatch raises InjectedReplicaCrash and the replica
# joins the dead set, where the health probe sees it); a SLOWDOWN delays
# every decode step and probe by a fixed amount (the wedged-but-alive
# replica whose probe must time out).  clear_serving_faults() resets all.

_REPLICA_CRASHES: set = set()
_DEAD_REPLICAS: set = set()
_REPLICA_SLOWDOWNS: dict = {}


def arm_replica_crash(replica) -> None:
    """Arm ``replica`` (a batcher name) to crash at its next decode
    step and stay dead until :func:`revive_replica`."""
    _REPLICA_CRASHES.add(str(replica))


def check_replica_crash(replica) -> bool:
    """One-shot check-and-clear, consulted by the batcher's step loop;
    a consumed crash moves the replica to the dead set (its probe fails
    from now on)."""
    name = str(replica)
    if name not in _REPLICA_CRASHES:
        return False
    _REPLICA_CRASHES.discard(name)
    _DEAD_REPLICAS.add(name)
    return True


def replica_dead(replica) -> bool:
    return str(replica) in _DEAD_REPLICAS


def revive_replica(replica) -> None:
    _DEAD_REPLICAS.discard(str(replica))
    _REPLICA_CRASHES.discard(str(replica))


def set_replica_slowdown(replica, seconds: float) -> None:
    """Delay every decode step and health probe of ``replica`` by
    ``seconds`` (0 clears).  Above the probe timeout, the probe's
    consecutive-failure threshold evicts the replica."""
    if float(seconds) <= 0.0:
        _REPLICA_SLOWDOWNS.pop(str(replica), None)
    else:
        _REPLICA_SLOWDOWNS[str(replica)] = float(seconds)


def replica_slowdown(replica) -> float:
    return float(_REPLICA_SLOWDOWNS.get(str(replica), 0.0))


def clear_serving_faults() -> None:
    _REPLICA_CRASHES.clear()
    _DEAD_REPLICAS.clear()
    _REPLICA_SLOWDOWNS.clear()
