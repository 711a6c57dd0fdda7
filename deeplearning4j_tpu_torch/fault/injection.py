"""Deterministic fault injection — the port of
``deeplearning4j_tpu/fault/injection.py``: the training supervisor's
faults and the harness that fires them, and the serving tier's hooks.

Every recovery path of :mod:`deeplearning4j_tpu_torch.fault.supervisor`
is exercised through this harness: faults fire at exact step numbers (or
attempt counts), never at random, so a failing recovery test replays
bit-for-bit.

Injection sites:

- ``before_step`` — consulted by :class:`FaultTolerantTrainer` right before
  each train step.  A fault may poison the batch (:class:`NaNAtStep`,
  on the batch's own device), raise a process-fatal
  :class:`SimulatedPreemption` (:class:`PreemptAtStep`), a device-OOM-shaped
  :class:`InjectedOOM` (:class:`OOMAtStep`) or freeze the loop
  (:class:`StallAtStep`).
- ``after_checkpoint`` — fired with the just-sealed step directory;
  :class:`CorruptCheckpointAtStep` flips bytes in it so the checksum
  fallback path is exercised.
- ``fetch`` — consulted by the dataset fetchers' bounded-retry loader
  (:class:`FailingFetch`, :class:`SlowFetch`).

Activate with the :func:`inject` context manager (or ``set_injector``)::

    with inject(NaNAtStep(5), PreemptAtStep(12)):
        trainer.fit(iterator, epochs=2)

The serving hooks: a replica crash armed by name and consumed by the
continuous batcher at its next decode step, the dead-replica set its
health probe reads, and an injected per-replica slowdown.  The
device-loss, partition, heartbeat, leader-crash and barrier-kill faults
serve the elastic and coordination layers, which wait for ROADMAP A10b.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional


__all__ = ["SimulatedPreemption", "InjectedOOM", "Fault", "NaNAtStep",
           "PreemptAtStep", "OOMAtStep", "StallAtStep",
           "CorruptCheckpointAtStep", "FailingFetch", "SlowFetch",
           "FaultInjector", "set_injector", "get_injector",
           "clear_injector", "inject", "check_fetch_fault",
           "corrupt_checkpoint", "InjectedReplicaCrash",
           "ReplicaCrashAtStep", "SlowReplica", "ClientHangupAtToken",
           "DeadlineStorm", "arm_replica_crash", "check_replica_crash",
           "replica_dead", "revive_replica", "set_replica_slowdown",
           "replica_slowdown", "clear_serving_faults"]


class SimulatedPreemption(BaseException):
    """Process-fatal by design: derives from BaseException so no recovery
    layer (``except Exception``) can accidentally swallow it — exactly like
    a real SIGKILL'd preemption, the only thing that survives is what the
    checkpointer already put on disk."""


class InjectedOOM(RuntimeError):
    """Shaped like the device's out-of-memory error (the reference's
    ``RESOURCE_EXHAUSTED`` text, which also reads "out of memory") so the
    supervisor's matcher treats it exactly like the real thing."""

    def __init__(self, note: str = "injected"):
        super().__init__(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            f"device buffer ({note})")


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


class Fault:
    """Base fault: subclasses override the site hooks they participate in."""

    def before_step(self, step: int, net, ds):
        """May return a replacement DataSet (None = leave unchanged) or
        raise.  ``step`` is the net's iteration count BEFORE the step."""
        return None

    def after_checkpoint(self, step: int, step_path: str) -> None:
        pass

    def on_fetch(self, what: str) -> None:
        pass


class NaNAtStep(Fault):
    """Poison the features of the batch entering step ``step`` with NaN —
    the loss (and, untreated, the params) go NaN that step.  The poisoned
    copy stays on the batch's device.

    One-shot by default (``times=1``): the retry after rollback sees the
    clean batch again and recovers.  ``step=None`` fires at every step and
    ``times=None`` never exhausts — together they model a PERSISTENT
    divergence no backoff can fix (the supervisor must eventually raise
    ``TrainingDivergedError`` instead of looping forever)."""

    def __init__(self, step: Optional[int] = None, times: Optional[int] = 1):
        self.step = None if step is None else int(step)
        self.times = times

    def before_step(self, step, net, ds):
        if self.step is not None and step != self.step:
            return None
        if self.times is not None:
            if self.times <= 0:
                return None
            self.times -= 1
        f = ds.features.torch.clone()
        f.view(-1)[0] = float("nan")
        return type(ds)(f, ds.labels, ds.featuresMask, ds.labelsMask)


class PreemptAtStep(Fault):
    """Simulate preemption right before step ``step``: raises
    :class:`SimulatedPreemption`, which nothing below the test harness
    catches."""

    def __init__(self, step: int):
        self.step = int(step)

    def before_step(self, step, net, ds):
        if step == self.step:
            raise SimulatedPreemption(f"preempted before step {step}")


class OOMAtStep(Fault):
    """Raise a device-OOM-shaped error for the first ``times`` attempts at
    step ``step`` — the supervisor responds by splitting the micro-batch."""

    def __init__(self, step: int, times: int = 1):
        self.step = int(step)
        self.times = int(times)

    def before_step(self, step, net, ds):
        if step == self.step and self.times > 0:
            self.times -= 1
            raise InjectedOOM(f"step {step}")


class StallAtStep(Fault):
    """Freeze the training loop for ``seconds`` right before step ``step``
    — a deterministic stand-in for a hung collective / wedged host.  The
    run itself is untouched (the step proceeds after the sleep); what the
    stall exercises is the WATCHDOG: a
    :class:`~deeplearning4j_tpu_torch.telemetry.health.TrainingStallRule`
    with a timeout under ``seconds`` must fire while the loop is frozen
    and resolve once steps resume."""

    def __init__(self, step: int, seconds: float = 0.5, times: int = 1):
        self.step = int(step)
        self.seconds = float(seconds)
        self.times = int(times)

    def before_step(self, step, net, ds):
        if step == self.step and self.times > 0:
            self.times -= 1
            time.sleep(self.seconds)


class CorruptCheckpointAtStep(Fault):
    """Corrupt the checkpoint written for step ``step`` right after the
    manifest is sealed — restore must detect the checksum mismatch and fall
    back to the previous valid step."""

    def __init__(self, step: int):
        self.step = int(step)

    def after_checkpoint(self, step, step_path):
        if step == self.step:
            _corrupt_tree(step_path)


class FailingFetch(Fault):
    """Fail the first ``times`` real-data fetch attempts for dataset
    ``what`` (None = any) — exercises the fetchers' bounded retry and
    synthetic fallback."""

    def __init__(self, what: Optional[str] = None, times: int = 2,
                 exc: type = ConnectionError):
        self.what = what
        self.times = int(times)
        self.exc = exc
        self.attempts = 0

    def on_fetch(self, what):
        if self.what is not None and what != self.what:
            return
        self.attempts += 1
        if self.times > 0:
            self.times -= 1
            raise self.exc(f"injected fetch failure for {what}")


class SlowFetch(Fault):
    """Delay each fetch attempt by ``delay`` seconds (keep it well under
    100ms in tests) — a slow-network stand-in that must NOT fail the run."""

    def __init__(self, what: Optional[str] = None, delay: float = 0.05):
        self.what = what
        self.delay = float(delay)

    def on_fetch(self, what):
        if self.what is None or what == self.what:
            time.sleep(self.delay)


class ReplicaCrashAtStep(Fault):
    """Arm ``replica`` (a continuous batcher name) to crash at its next
    decode step once the consulted step count reaches ``step`` — a replica
    losing its accelerator mid-generation.  The batcher's step raises
    :class:`InjectedReplicaCrash`, its in-flight sequences hand over to
    the failover path, and the replica stays dead (probe-visible) until
    revived.  One-shot."""

    def __init__(self, replica: str, step: int = 0):
        self.replica = str(replica)
        self.step = int(step)
        self.fired = False

    def before_step(self, step, net, ds):
        if not self.fired and step >= self.step:
            self.fired = True
            arm_replica_crash(self.replica)


class SlowReplica(Fault):
    """Slow ``replica``'s every decode step and health probe by
    ``seconds`` from step ``step`` on (optionally healing at
    ``untilStep``) — the wedged-but-alive replica: requests on it crawl,
    the probe times out, and the consecutive-failure threshold must
    evict it with its sequences failed over, not errored."""

    def __init__(self, replica: str, seconds: float = 0.5,
                 step: int = 0, untilStep: Optional[int] = None):
        self.replica = str(replica)
        self.seconds = float(seconds)
        self.step = int(step)
        self.untilStep = None if untilStep is None else int(untilStep)
        self.fired = False
        self.healed = False

    def before_step(self, step, net, ds):
        if not self.fired and step >= self.step:
            self.fired = True
            set_replica_slowdown(self.replica, self.seconds)
        if (self.fired and not self.healed and self.untilStep is not None
                and step >= self.untilStep):
            self.healed = True
            set_replica_slowdown(self.replica, 0.0)


class ClientHangupAtToken(Fault):
    """At step ``step``, launch a doomed streaming client that reads
    ``token`` tokens and hangs up — the caller binds ``action`` to the
    launch (the hangup itself is client-side behavior, not a server
    registry).  The server must treat the mid-stream disconnect as a
    cancellation.  One-shot."""

    def __init__(self, step: int, token: int = 3, action=None):
        self.step = int(step)
        self.token = int(token)
        self.action = action
        self.fired = False

    def before_step(self, step, net, ds):
        if not self.fired and step >= self.step:
            self.fired = True
            if self.action is not None:
                self.action(self.token)


class DeadlineStorm(Fault):
    """At step ``step``, fire a burst of ``requests`` already-expired
    requests (deadline ~0) — every one must shed 504 at admission
    without ever holding a decode slot.  The caller binds ``action`` to
    the burst.  One-shot."""

    def __init__(self, step: int, requests: int = 4, action=None):
        self.step = int(step)
        self.requests = int(requests)
        self.action = action
        self.fired = False

    def before_step(self, step, net, ds):
        if not self.fired and step >= self.step:
            self.fired = True
            if self.action is not None:
                self.action(self.requests)


class FaultInjector:
    """An ordered collection of faults consulted at each injection site."""

    def __init__(self, *faults: Fault):
        self.faults: List[Fault] = list(faults)

    def add(self, fault: Fault) -> "FaultInjector":
        self.faults.append(fault)
        return self

    def before_step(self, step: int, net, ds):
        for f in self.faults:
            out = f.before_step(step, net, ds)
            if out is not None:
                ds = out
        return ds

    def after_checkpoint(self, step: int, step_path: str) -> None:
        for f in self.faults:
            f.after_checkpoint(step, step_path)

    def on_fetch(self, what: str) -> None:
        for f in self.faults:
            f.on_fetch(what)


_ACTIVE: Optional[FaultInjector] = None


def set_injector(injector: Optional[FaultInjector]) -> None:
    global _ACTIVE
    _ACTIVE = injector


def get_injector() -> Optional[FaultInjector]:
    return _ACTIVE


def clear_injector() -> None:
    set_injector(None)


@contextlib.contextmanager
def inject(*faults: Fault):
    """Activate an injector for the duration of a with-block.  On exit the
    serving fault registries are cleared too — one test's dead replicas
    must not bleed into the next test's probe."""
    prev = get_injector()
    set_injector(FaultInjector(*faults))
    try:
        yield get_injector()
    finally:
        set_injector(prev)
        clear_serving_faults()


def check_fetch_fault(what: str) -> None:
    """Injection point for the dataset fetchers (no-op without an active
    injector)."""
    inj = get_injector()
    if inj is not None:
        inj.on_fetch(what)


def _corrupt_tree(path: str) -> None:
    """Flip bytes in the middle of the largest file under ``path`` (size
    preserved — corruption a length check would NOT catch, only a
    checksum will)."""
    largest, size = None, -1
    for root, _dirs, files in os.walk(path):
        for fn in files:
            fp = os.path.join(root, fn)
            s = os.path.getsize(fp)
            if s > size:
                largest, size = fp, s
    if largest is None or size == 0:
        raise FileNotFoundError(f"nothing to corrupt under {path}")
    with open(largest, "r+b") as fh:
        fh.seek(size // 2)
        chunk = fh.read(min(64, size - size // 2))
        fh.seek(size // 2)
        fh.write(bytes(b ^ 0xFF for b in chunk))


def corrupt_checkpoint(directory: str, step: int) -> None:
    """Corrupt the on-disk checkpoint for ``step`` under a
    :class:`~deeplearning4j_tpu_torch.utils.sharded_checkpoint.
    ShardedCheckpointer` directory (test hook for the checksum-fallback
    path)."""
    _corrupt_tree(os.path.join(os.path.abspath(directory), str(step)))
