"""Training stats collection + storage — the port of
``deeplearning4j_tpu/ui/stats.py``.

Reference: deeplearning4j-ui-model ``org/deeplearning4j/ui/model/stats/
StatsListener.java`` (per-iteration score, param/update histograms+norms,
memory/GC) → ``StatsStorage`` SPI (``InMemoryStatsStorage``,
``FileStatsStorage`` MapDB) consumed by the UI server.

The tensor stats are computed on the tensors' device: each leaf's
summaries are queued reductions with no host read, each tree's
histograms one ``bincount``, and the rows of all three trees (params,
updates, activations) reach the host in ONE copy per recorded
iteration.  FileStatsStorage is append-only JSONL, as
the reference's.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

__all__ = ["StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "StatsListener", "RemoteUIStatsStorageRouter"]


class StatsStorage:
    """SPI: putUpdate / getAllSessions / getUpdates."""

    def putUpdate(self, sessionId: str, update: dict) -> None:
        raise NotImplementedError

    def listSessionIDs(self) -> List[str]:
        raise NotImplementedError

    def getUpdates(self, sessionId: str) -> List[dict]:
        raise NotImplementedError


class InMemoryStatsStorage(StatsStorage):
    """Bounded in-memory storage: keeps the newest ``maxRecordsPerSession``
    updates per session (default 10k) so a long or runaway run cannot grow
    the monitoring process without limit — dropped records are counted in
    ``dl4j_tpu_ui_stats_records_dropped_total``."""

    def __init__(self, maxRecordsPerSession: int = 10_000):
        if maxRecordsPerSession < 1:
            raise ValueError("maxRecordsPerSession must be >= 1")
        self.maxRecordsPerSession = int(maxRecordsPerSession)
        self._data: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.maxRecordsPerSession))
        # UIServer's ThreadingHTTPServer reads while trainers write: the
        # full-check + append must be atomic or evictions go uncounted,
        # and deques (unlike lists) raise if iterated during an append,
        # so the read-side snapshots take the same lock
        self._lock = threading.Lock()

    def putUpdate(self, sessionId, update):
        with self._lock:
            q = self._data[sessionId]
            dropped = len(q) == self.maxRecordsPerSession
            q.append(update)
        if dropped:
            from deeplearning4j_tpu_torch.telemetry import get_registry
            get_registry().counter(
                "dl4j_tpu_ui_stats_records_dropped_total",
                "Oldest stats updates evicted by the per-session "
                "retention bound").inc()

    def listSessionIDs(self):
        with self._lock:
            return list(self._data)

    def getUpdates(self, sessionId):
        with self._lock:
            return list(self._data[sessionId])


class FileStatsStorage(StatsStorage):
    """Append-only JSONL per session (reference: FileStatsStorage/MapDB)."""

    def __init__(self, path: str):
        self.path = path
        self._cache: Dict[str, List[dict]] = defaultdict(list)
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    rec = json.loads(line)
                    self._cache[rec["session"]].append(rec)
        except FileNotFoundError:
            pass

    def putUpdate(self, sessionId, update):
        rec = dict(update, session=sessionId)
        self._cache[sessionId].append(rec)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")

    def listSessionIDs(self):
        return list(self._cache)

    def getUpdates(self, sessionId):
        return list(self._cache[sessionId])


#: histogram bin count (reference StatsListener default resolution)
_NBINS = 20
#: the summaries of a stats row, in column order; the histogram follows
_FIELDS = ("norm", "mean", "stdev", "min", "max")


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{layer: {param: tensor}}`` (nested dicts allowed) as
    ``{"layer.param": tensor}``, nested keys joined by ``_`` as the
    reference's pytree paths are."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}_{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, name))
        elif isinstance(val, torch.Tensor) and val.numel():
            out[name] = val
    return out


def _named(tree) -> Dict[str, torch.Tensor]:
    """The reference's stats names: ``f"{layer}.{path}"``."""
    out = {}
    for li, lp in tree.items():
        if isinstance(lp, dict):
            for name, leaf in _flatten(lp).items():
                out[f"{li}.{name}"] = leaf
        elif isinstance(lp, torch.Tensor) and lp.numel():
            out[str(li)] = lp
    return out


def _stats_rows(leaves: List[torch.Tensor]) -> torch.Tensor:
    """One float64 row a leaf, on the leaves' device: norm, mean, stdev
    (population), min, max, then the counts of a ``_NBINS``-bin histogram
    over [min, max].  Each leaf's summaries are whole-tensor reductions
    (float64 accumulation), queued back to back with no host read; the
    histograms of the whole tree are one ``bincount`` of ``leaf * _NBINS
    + bin``.  (Segmented atomics over the concatenated tree serialise on
    a few addresses when a tree has few large leaves.)"""
    rows, bins = [], []
    for i, t in enumerate(leaves):
        x = t.detach().reshape(-1).float()
        lo, hi = torch.aminmax(x)
        x64 = x.double()
        mean = x64.mean()
        d = x64 - mean
        rows.append(torch.stack([torch.linalg.vector_norm(x64), mean,
                                 torch.sqrt((d * d).mean()), lo.double(),
                                 hi.double()]))
        # the bins as the reference computes them, in float32
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        bins.append(((x - lo) / span * _NBINS).to(torch.int64)
                    .clamp_(0, _NBINS - 1) + i * _NBINS)
    hist = torch.bincount(torch.cat(bins), minlength=len(leaves) * _NBINS)
    return torch.cat([torch.stack(rows),
                      hist.view(len(leaves), _NBINS).double()], 1)


def _rows_to_stats(names, rows) -> Dict[str, dict]:
    """Host rows (lists) back into the reference's per-leaf dicts."""
    out = {}
    for name, row in zip(names, rows):
        st = {k: float(v) for k, v in zip(_FIELDS, row)}
        st["hist"] = [int(c) for c in row[len(_FIELDS):]]
        out[name] = st
    return out


def _tree_stats(tree) -> Dict[str, dict]:
    """The stats of every leaf of ``{layer: {param: tensor}}``, computed
    on the leaves' device and copied to the host once."""
    named = _named(tree)
    if not named:
        return {}
    return _rows_to_stats(list(named),
                          _stats_rows(list(named.values())).cpu().tolist())


class StatsListener(TrainingListener):
    """Per-iteration stats → storage (reference: StatsListener.java).

    Collected (parity with the reference's update contents): score, param
    stats (norm/mean/stdev/min/max + 20-bin histogram), UPDATE stats (the
    param delta since the previous recorded iteration, same summaries),
    per-layer ACTIVATION stats on the current batch
    (``collectActivations``, via ``model.feedForward`` on the stashed last
    input), iterations/sec, and a memory/hardware section (device bytes
    in use and the card's total, host RSS, device count/platform).  The
    tensor stats are computed on the model's device and fetched with ONE
    host copy per recorded iteration."""

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 sessionId: Optional[str] = None,
                 collectActivations: bool = False):
        # collectActivations re-runs a full forward per recorded
        # iteration — opt-in, like the reference gates histogram
        # collection behind StatsUpdateConfiguration
        self.storage = storage
        self.frequency = max(1, frequency)
        self.sessionId = sessionId or f"session_{int(time.time())}"
        self.collectActivations = collectActivations
        self._last_time = None
        self._prev_params = None

    def _tensor_trees(self, model) -> List[Tuple[str, Dict[str, torch.Tensor]]]:
        """(section, named leaves) of the params and, from the second
        recorded iteration, the applied update (prev - new: the update
        itself, not the raw delta); the listener keeps its own copy of
        the params for the next one."""
        params = getattr(model, "params_", None) or {}
        named = _named(params)
        if not named:
            return []
        trees = [("paramStats", named)]
        prev = self._prev_params
        if prev is not None and prev.keys() == named.keys() and all(
                prev[k].shape == v.shape for k, v in named.items()):
            trees.append(("updateStats",
                          {k: prev[k] - v.detach()
                           for k, v in named.items()}))
        # own buffers: the model assigns new tensors each step, and a
        # later in-place change must not reach the stored copy
        self._prev_params = {k: v.detach().clone() for k, v in named.items()}
        return trees

    def _activation_tree(self, model) -> Dict[str, torch.Tensor]:
        x = getattr(model, "_lastInput", None)
        if x is None or not hasattr(model, "feedForward"):
            return {}
        acts = model.feedForward(x)
        return _named({str(i): {"act": getattr(a, "torch", a)}
                       for i, a in enumerate(acts)})

    def _collect(self, model) -> Dict[str, Dict[str, dict]]:
        """Every section's stats: the rows of all trees are computed on
        the device, concatenated, and copied to the host once."""
        trees = self._tensor_trees(model)
        if self.collectActivations:
            try:
                acts = self._activation_tree(model)
            except Exception:
                acts = {}       # monitoring must never kill the run
            trees.append(("activationStats", acts))
        out = {name: {} for name, _ in trees}
        trees = [(s, t) for s, t in trees if t]
        if not trees:
            return out
        rows = torch.cat([_stats_rows(list(t.values())) for _, t in trees])
        host = rows.cpu().tolist()
        at = 0
        for section, t in trees:
            out[section] = _rows_to_stats(list(t), host[at:at + len(t)])
            at += len(t)
        return out

    @staticmethod
    def _memory_section(device=None) -> dict:
        dev = torch.device("cpu" if device is None else device)
        out: dict = {"deviceCount": torch.cuda.device_count()
                     if dev.type == "cuda" else 1,
                     "platform": "gpu" if dev.type == "cuda" else "cpu"}
        if dev.type == "cuda":
            ms = torch.cuda.memory_stats(dev)
            out["deviceBytesInUse"] = int(
                ms.get("allocated_bytes.all.current", 0))
            out["deviceBytesLimit"] = int(
                torch.cuda.get_device_properties(dev).total_memory)
        try:
            import resource
            out["hostRssBytes"] = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            pass
        return out

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency:
            return
        now = time.time()
        stats = self._collect(model)
        pstats = stats.get("paramStats", {})
        update = {
            "iteration": iteration,
            "epoch": epoch,
            "timestamp": now,
            "score": float(model.score()),
            "batchSize": getattr(model, "lastBatchSize", 0),
            "paramStats": pstats,
            "updateStats": stats.get("updateStats", {}),
            # back-compat: plain norms view consumed by older dashboards
            "paramNorms": {n: s["norm"] for n, s in pstats.items()},
            "memory": self._memory_section(getattr(model, "device", None)),
        }
        if self.collectActivations:
            update["activationStats"] = stats.get("activationStats", {})
        if self._last_time is not None:
            dt = now - self._last_time
            if dt > 0:
                # dt spans `frequency` iterations between recorded updates
                update["iterationsPerSecond"] = self.frequency / dt
        self._last_time = now
        self.storage.putUpdate(self.sessionId, update)


class RemoteUIStatsStorageRouter(StatsStorage):
    """Push updates to a remote UIServer over HTTP.

    Reference: deeplearning4j-ui ``RemoteUIStatsStorageRouter`` — attach a
    StatsListener to this router on the TRAINING process and view the charts
    on a UIServer running elsewhere (``UIServer`` accepts the POSTs at
    ``/train/post``).
    """

    def __init__(self, address: str):
        self.address = address.rstrip("/")
        self.failureCount = 0

    def putUpdate(self, sessionId, update):
        # a MONITORING failure must never kill the training run it watches
        # (reference router queues + retries; we log and count)
        import logging
        import urllib.request
        data = json.dumps({"session": sessionId, "update": update}
                          ).encode("utf-8")
        req = urllib.request.Request(
            f"{self.address}/train/post", data=data,
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except Exception as e:
            self.failureCount += 1
            logging.getLogger("deeplearning4j_tpu_torch").warning(
                "remote stats push failed (%s): %s", self.address, e)

    def listSessionIDs(self):
        return []          # write-only router (reference behavior)

    def getUpdates(self, sessionId):
        return []
