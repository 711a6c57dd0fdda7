"""Cross-process metric federation: snapshot writers + the aggregator —
the port of ``deeplearning4j_tpu/telemetry/federation.py`` (pure Python,
copied, so both packages merge the same snapshot files into the same
exposition).

The metrics spine is per-process by design: each worker serves its own
``/metrics`` from its process-global registry.  A pod-scale ``parallel/``
run is N processes, and the numbers an operator actually needs — total
step counters, the straggler spread ACROSS hosts — only exist after a
merge.  This module is that merge, file-based so it needs no extra
network surface (the shared run directory the checkpointer already
requires is enough):

- :class:`SnapshotWriter` — a daemon thread in every worker that
  periodically serializes its registry (``MetricsRegistry.snapshot()``)
  to ``metrics_<host>.json`` in the run directory.  Writes are atomic
  (tmp + ``os.replace``) so the aggregator never reads a torn file.
- :class:`TelemetryAggregator` — reads every snapshot in the directory
  and merges: **counters sum** across hosts (a cluster-total
  ``rate()`` works unchanged), **gauges and histograms gain a ``host``
  label** (per-host values stay distinguishable — summing a gauge is a
  lie).  The federated view serves at ``/metrics/federated`` on both
  ``JsonModelServer`` and ``InferenceServer``.

The run directory is configured per process with :func:`set_federation_dir`
(or the ``DL4J_TPU_TELEMETRY_DIR`` environment variable, resolved at
request time so launchers can set it before OR after import).
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                         get_registry)

__all__ = ["SnapshotWriter", "TelemetryAggregator", "host_id",
           "set_federation_dir", "get_federation_dir",
           "federated_exposition", "reset_counter_smoothing"]

_SNAPSHOT_PREFIX = "metrics_"
#: tri-state: _UNSET -> fall back to the env var; None -> explicitly
#: DISABLED (an explicit clear must win over an inherited env var, or
#: tests/embedded uses could never opt out of an operator's live run dir)
_UNSET = object()
_federation_dir = _UNSET
_dir_lock = threading.Lock()
#: host ids this process has written PROCESS-GLOBAL-registry snapshots
#: under (SnapshotWriter with registry=None).  The aggregator must treat
#: those files as stale copies of the live local registry — even when
#: the writer used a custom hostId= the default host_id() can't predict
_local_snapshot_ids: List[str] = []


def host_id() -> str:
    """Stable identity of this process in the federated view.  Override
    with ``DL4J_TPU_HOST_ID`` (launchers usually set it to the rank);
    default ``<hostname>-<pid>`` keeps N workers on one box distinct."""
    return os.environ.get("DL4J_TPU_HOST_ID") or \
        f"{socket.gethostname()}-{os.getpid()}"


def local_snapshot_host_id() -> str:
    """The host id this process's snapshots live under: the most recent
    process-global SnapshotWriter's id if one exists (so a final flush
    overwrites the SAME file the periodic writer maintained, custom
    ``hostId=`` included), else the default :func:`host_id`."""
    with _dir_lock:
        if _local_snapshot_ids:
            return _local_snapshot_ids[-1]
    return host_id()


def set_federation_dir(path) -> object:
    """Set the shared run directory this process aggregates from and
    serves at ``/metrics/federated``.  ``None`` DISABLES federation even
    when ``DL4J_TPU_TELEMETRY_DIR`` is set in the environment.  Returns
    the previous value (pass it back to restore, including the initial
    env-fallback state)."""
    global _federation_dir
    with _dir_lock:
        prev, _federation_dir = _federation_dir, path
    return prev


def get_federation_dir() -> Optional[str]:
    """Configured run directory; unconfigured processes fall back to
    ``DL4J_TPU_TELEMETRY_DIR`` (env resolved at call time, not import
    time), and an explicit ``set_federation_dir(None)`` yields None."""
    with _dir_lock:
        v = _federation_dir
    if v is _UNSET:
        return os.environ.get("DL4J_TPU_TELEMETRY_DIR") or None
    return v


class SnapshotWriter:
    """Periodic atomic JSON dump of a registry into the shared run dir.

    One per worker process.  ``write_now()`` is also the durable-export
    path (atexit/SIGTERM flush, :mod:`.export`) — the final write and the
    periodic ones land in the same file, so the aggregator needs no
    special casing for dead workers: their last snapshot simply stops
    moving."""

    def __init__(self, runDir: str, hostId: Optional[str] = None,
                 interval: float = 5.0,
                 registry: Optional[MetricsRegistry] = None):
        self.runDir = str(runDir)
        self.hostId = hostId or host_id()
        self.interval = float(interval)
        self._registry = registry
        if registry is None:
            # this writer snapshots the process-global registry: record
            # the id so the aggregator in THIS process dedupes the file
            # against its live registry (see _local_snapshot_ids)
            with _dir_lock:
                if self.hostId not in _local_snapshot_ids:
                    _local_snapshot_ids.append(self.hostId)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.lastPath: Optional[str] = None

    @property
    def path(self) -> str:
        # the host id doubles as the filename key: one file per worker,
        # overwritten in place (the aggregator globs the prefix)
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in self.hostId)
        return os.path.join(self.runDir, f"{_SNAPSHOT_PREFIX}{safe}.json")

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else \
            get_registry()

    def write_now(self, reason: str = "periodic") -> str:
        """One atomic snapshot write; returns the path.  Never raises —
        telemetry export must not take down the training it observes
        (failures return '')."""
        try:
            os.makedirs(self.runDir, exist_ok=True)
            payload = {"host": self.hostId, "pid": os.getpid(),
                       "written_at": time.time(), "reason": reason,
                       "metrics": self._reg().snapshot()}
            fd, tmp = tempfile.mkstemp(dir=self.runDir,
                                       prefix=".snap_", suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(payload, f, default=str)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.lastPath = self.path
            return self.path
        except Exception:
            return ""

    def start(self) -> "SnapshotWriter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval):
                    self.write_now()

            self._thread = threading.Thread(
                target=loop, name=f"telemetry-snapshot-{self.hostId}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, finalWrite: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if finalWrite:
            self.write_now(reason="stop")


# -- counter-reset smoothing ----------------------------------------------
# A restarted worker re-zeroes its counters; summed naively, the
# federated total DROPS and every rate() over it goes negative for one
# window (and loses the pre-restart total forever).  The aggregator
# instead treats a per-(run,host,metric,cell) decrease as a reset and
# accumulates a monotonic offset: reported = offset + current.  State is
# module-global because aggregators are constructed per scrape.
_smooth_lock = threading.Lock()
_smooth_state: Dict[tuple, list] = {}    # key -> [last_seen, offset]


def _monotonic_counter(runDir: str, host: str, name: str, cellKey: tuple,
                       v: float) -> float:
    key = (runDir, host, name, cellKey)
    with _smooth_lock:
        st = _smooth_state.setdefault(key, [v, 0.0])
        if v < st[0]:
            # the worker restarted and re-zeroed: fold the pre-restart
            # total into the offset so the federated series stays
            # monotonic (rate() sees a flat spot, not a cliff)
            st[1] += st[0]
        st[0] = v
        return v + st[1]


def reset_counter_smoothing(runDir: Optional[str] = None) -> None:
    """Forget accumulated reset offsets — for ``runDir`` only, or all
    (tests; a genuinely new run should use a new directory instead)."""
    with _smooth_lock:
        if runDir is None:
            _smooth_state.clear()
        else:
            for k in [k for k in _smooth_state if k[0] == runDir]:
                del _smooth_state[k]


def _prune_smoothing(runDir: str, liveHosts) -> None:
    """Drop smoothing state for hosts no longer present in ``runDir``'s
    merge (run directory cleaned up, or pid-suffixed host ids churned
    by restarts) — a long-lived scraping process must not grow state
    for every host it EVER saw.  A host whose snapshot is merely torn
    for one scrape re-baselines on return: its next value counts as a
    fresh start, which only under-reports, never double-counts."""
    live = set(liveHosts)
    with _smooth_lock:
        for k in [k for k in _smooth_state
                  if k[0] == runDir and k[1] not in live]:
            del _smooth_state[k]


def _merge_scalar(merged: MetricsRegistry, name: str, data: dict,
                  host: str, runDir: str = "") -> None:
    labelnames = tuple(data.get("labelnames") or ())
    help_ = data.get("help", "")
    if data["type"] == "counter":
        c = merged.counter(name, help_, labelnames)
        for key, v in data.get("cells", []):
            v = _monotonic_counter(runDir, host, name, tuple(key),
                                   float(v))
            c.inc(v, **dict(zip(labelnames, key)))
    else:
        g = merged.gauge(name, help_, labelnames + ("host",))
        for key, v in data.get("cells", []):
            labels = dict(zip(labelnames, key))
            labels["host"] = host
            g.set(float(v), **labels)


def _merge_histogram(merged: MetricsRegistry, name: str, data: dict,
                     host: str) -> None:
    labelnames = tuple(data.get("labelnames") or ())
    buckets = tuple(float(b) for b in data.get("buckets") or ())
    h = merged.histogram(name, data.get("help", ""),
                         labelnames + ("host",), buckets=buckets)
    for key, cd in data.get("cells", []):
        labels = dict(zip(labelnames, key))
        labels["host"] = host
        cell = h._cell(labels)
        counts = [int(c) for c in cd.get("counts", [])]
        with cell.lock:
            # raw (non-cumulative) per-bucket counts transplant directly;
            # host-labeled cells never collide so += is exact
            for i, c in enumerate(counts[:len(cell.counts)]):
                cell.counts[i] += c
            cell.sum += float(cd.get("sum", 0.0))
            cell.count += int(cd.get("count", 0))


class TelemetryAggregator:
    """Merge every worker snapshot in a run directory into one registry.

    Counters sum (no extra label — the federated total is what alert
    rules rate() over); gauges/histograms are tagged ``host`` so
    per-replica signals (step-time gauges, queue depths) survive the
    merge instead of averaging into mush.  Metrics whose declared shape
    conflicts across hosts (a counter on one, a gauge on another) are
    skipped and counted in :attr:`skipped` — one worker running old code
    must not take down the whole federated scrape."""

    def __init__(self, runDir: str,
                 localRegistry: Optional[MetricsRegistry] = None,
                 localHost: Optional[str] = None,
                 gcMaxAge: Optional[float] = None):
        self.runDir = str(runDir)
        self._local = localRegistry
        self._localHost = localHost or host_id()
        #: snapshot files whose mtime is older than this are unlinked on
        #: load (None = follow the retention ring's window; GC disabled
        #: when neither is configured).  Live writers refresh their
        #: file's mtime every interval, so only DEAD workers age out.
        self.gcMaxAge = gcMaxAge
        self.skipped: List[str] = []
        self.skippedFiles: List[str] = []
        self.gcFiles: List[str] = []
        self.hosts: List[str] = []

    def timeline(self, run_id: Optional[str] = None,
                 kinds=None, generation: Optional[int] = None,
                 step_min: Optional[int] = None,
                 step_max: Optional[int] = None):
        """Merge every host's ``timeline_*.ndjson`` in the run dir into
        ONE causally ordered pod timeline (hybrid-logical-clock order —
        see :mod:`~deeplearning4j_tpu_torch.telemetry.runlog`).  Serves
        ``GET /v1/runs/<runId>/timeline``; same torn-file tolerance as
        the metric-snapshot merge."""
        from deeplearning4j_tpu_torch.telemetry.runlog import merge_timelines
        return merge_timelines(self.runDir, run_id=run_id, kinds=kinds,
                               generation=generation, step_min=step_min,
                               step_max=step_max)

    def _gc_max_age(self) -> Optional[float]:
        if self.gcMaxAge is not None:
            return float(self.gcMaxAge)
        from deeplearning4j_tpu_torch.telemetry.timeseries import retention
        ring = retention()
        return float(ring.window) if ring is not None else None

    def gc_stale(self) -> List[str]:
        """Unlink snapshot files older than the retention window so a
        long-lived run directory doesn't serve month-dead hosts forever
        (and the federated view matches what ``/metrics/query`` can
        still answer).  Removals are counted in
        ``dl4j_tpu_federation_snapshots_gc_total``; returns the removed
        filenames."""
        maxAge = self._gc_max_age()
        self.gcFiles = []
        if maxAge is None:
            return []
        cutoff = time.time() - maxAge
        try:
            names = sorted(os.listdir(self.runDir))
        except OSError:
            return []
        for fn in names:
            if not (fn.startswith(_SNAPSHOT_PREFIX) and
                    fn.endswith(".json")):
                continue
            p = os.path.join(self.runDir, fn)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.unlink(p)
                    self.gcFiles.append(fn)
            except OSError:
                continue          # raced a writer/another GC: fine
        if self.gcFiles:
            reg = self._local if self._local is not None else \
                get_registry()
            reg.counter(
                "dl4j_tpu_federation_snapshots_gc_total",
                "Stale per-worker snapshot files unlinked by the "
                "aggregator (mtime older than the retention "
                "window)").inc(len(self.gcFiles))
        return self.gcFiles

    def load(self) -> List[dict]:
        """All parseable snapshots, oldest write first (stable merge
        order).  Torn/partial/corrupt files are skipped AND counted
        (``dl4j_tpu_federation_snapshots_skipped_total`` in the local
        registry + :attr:`skippedFiles`) — a worker mid-death or a
        non-atomic writer must not 500 the coordinator's scrape, but the
        operator must still see that the federated view is missing a
        host."""
        snaps = []
        self.skippedFiles = []
        self.gc_stale()
        try:
            names = sorted(os.listdir(self.runDir))
        except OSError:
            return []
        for fn in names:
            if not (fn.startswith(_SNAPSHOT_PREFIX) and
                    fn.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.runDir, fn),
                          encoding="utf-8") as f:
                    snap = json.load(f)
                if isinstance(snap, dict) and \
                        isinstance(snap.get("metrics"), dict):
                    snaps.append(snap)
                else:
                    self.skippedFiles.append(fn)
            except (OSError, ValueError):
                self.skippedFiles.append(fn)
        if self.skippedFiles:
            # count where the federated merge will actually look: the
            # aggregator's own registry when it has one (the endpoint
            # wiring passes get_registry(), a custom registry must see
            # its own skips in merged()), the process registry otherwise
            reg = self._local if self._local is not None else \
                get_registry()
            reg.counter(
                "dl4j_tpu_federation_snapshots_skipped_total",
                "Per-worker snapshot files skipped by the aggregator "
                "because they were torn/partial or unparseable "
                "(counted per scrape while the file stays bad)").inc(
                    len(self.skippedFiles))
        snaps.sort(key=lambda s: s.get("written_at", 0.0))
        return snaps

    def merged(self) -> MetricsRegistry:
        merged = MetricsRegistry()
        self.skipped = []
        self.hosts = []
        snaps = self.load()
        if self._local is not None:
            # the coordinator's own registry joins the federation without
            # having to write a file to its own directory — and if this
            # process ALSO runs a SnapshotWriter (the usual master
            # wiring), its on-disk file is just a stale copy of the live
            # registry: keeping both would double-count every counter.
            # _local_snapshot_ids covers writers with a custom hostId=.
            with _dir_lock:
                own = set(_local_snapshot_ids)
            own.add(self._localHost)
            snaps = [s for s in snaps if str(s.get("host")) not in own]
            snaps.append({"host": self._localHost,
                          "metrics": self._local.snapshot()})
        for snap in snaps:
            host = str(snap.get("host", "unknown"))
            if host not in self.hosts:
                self.hosts.append(host)
            for name, data in sorted(snap["metrics"].items()):
                try:
                    if data["type"] == "histogram":
                        _merge_histogram(merged, name, data, host)
                    elif data["type"] in ("counter", "gauge"):
                        _merge_scalar(merged, name, data, host,
                                      runDir=self.runDir)
                except (ValueError, KeyError, TypeError):
                    self.skipped.append(f"{name}@{host}")
        g = merged.gauge("dl4j_tpu_federation_hosts",
                         "Worker snapshots merged into this federated "
                         "view (coordinator's own registry included)")
        g.set(len(self.hosts))
        _prune_smoothing(self.runDir, self.hosts)
        return merged

    def exposition(self) -> str:
        """Prometheus text for the federated view (recomputed per scrape;
        merging a handful of JSON files is microseconds next to a scrape
        interval)."""
        return self.merged().exposition()


def federated_exposition() -> Optional[str]:
    """The federated Prometheus text for the configured run directory, or
    None when federation is unconfigured (the servers answer 404 with a
    hint instead of inventing an empty federation)."""
    run_dir = get_federation_dir()
    if run_dir is None:
        return None
    return TelemetryAggregator(run_dir, localRegistry=get_registry()
                               ).exposition()
