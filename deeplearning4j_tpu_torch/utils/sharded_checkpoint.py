"""Step-numbered training checkpoints with checksum manifests — the port
of the one-process half of ``deeplearning4j_tpu/utils/sharded_checkpoint.
py`` (``ShardedCheckpointer``).

The reference writes its tree through Orbax, a JAX library; the port
writes its own: one raw file per tensor leaf plus ``index.json`` (the
tree's structure, each leaf's file, dtype and shape, and the non-tensor
leaves), into ``<dir>/<step>.tmp/`` and renamed to ``<dir>/<step>/`` once
every file is fsynced.  An Orbax checkpoint of the reference therefore
does not restore here (ROADMAP C33).  The checksum manifest that seals a
step keeps the reference's schema key for key (``step``, ``files``,
``tree``, ``metadata``), under ``<dir>/manifests/step-<n>.json``.

Save is asynchronous, as in the reference: :meth:`ShardedCheckpointer.
save` issues a copy of every leaf into one page-locked host buffer on the
current CUDA stream, records an event, and returns; a writer thread
waits on that event before it reads the buffer.  The next train step is
queued on the same stream after the copies, so it can never overwrite a
tensor whose copy is still in flight; the writer also holds the source
tensors until the event has fired.  CPU tensors (the tests) are copied
synchronously.

The tree holds the params, the updater state, the layer state
(BatchNorm's running statistics), the counters, the RNN carries
(``_rnnCarries``) and the state of the net's training generator
(``_fitGen``, the port's counterpart of the reference's ``_fitKey``), so
a resumed dropout net draws the same bits.  Restoring onto another mesh
(the reference's ``shardings``) and the write fence (:meth:`setFence`,
installed by the coordination layer) wait for ROADMAP A10b.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["ShardedCheckpointer"]

log = logging.getLogger(__name__)

_ALIGN = 64     # byte alignment of each leaf in the staging buffer


def _io_retry(fn: Callable, what: str, attempts: int = 3,
              backoff: float = 0.05, cleanup: Optional[Callable] = None):
    """Bounded retry with exponential backoff for transient IO errors —
    one flaky write (NFS hiccup, an object store's 5xx surfacing as
    OSError) must not mark a whole checkpoint step corrupt.  ``cleanup``
    runs between attempts (e.g. delete a half-written step so the re-save
    is clean)."""
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            if attempt == attempts - 1:
                raise
            log.warning("transient IO error during %s (%s: %s); retry "
                        "%d/%d", what, type(e).__name__, e, attempt + 1,
                        attempts - 1)
            if cleanup is not None:
                try:
                    cleanup()
                except Exception:
                    pass
            time.sleep(backoff * (2 ** attempt))


def _fsync_dir(path: str) -> None:
    """fsync the directory so the atomic rename itself is durable (a
    crash after ``os.replace`` but before the dir entry hits disk would
    otherwise lose the manifest the data files already paid for)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass        # not all filesystems support dir fsync
    finally:
        os.close(fd)


def _keystr(path) -> str:
    """A leaf's path in ``jax.tree_util.keystr``'s form (``['0']['W']``),
    so the manifest's tree description reads as the reference's."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path=()):
    """``(structure, leaves)``: the JSON-able structure of a tree of
    dicts, tuples and lists, each tensor replaced by ``{"leaf": i}``;
    ``leaves`` the ``(path, tensor)`` pairs in order."""
    leaves: List = []

    def walk(node, p):
        if isinstance(node, torch.Tensor):
            leaves.append((p, node))
            return {"leaf": len(leaves) - 1}
        if isinstance(node, dict):
            return {"dict": {str(k): walk(v, p + (k,))
                             for k, v in node.items()}}
        if isinstance(node, (tuple, list)):
            return {"tuple" if isinstance(node, tuple) else "list":
                    [walk(v, p + (i,)) for i, v in enumerate(node)]}
        if node is None or isinstance(node, (bool, int, float, str)):
            return {"value": node}
        raise TypeError(f"cannot checkpoint a {type(node).__name__} at "
                        f"{_keystr(p)}")

    return walk(tree, path), leaves


def _unflatten(structure, leaves):
    if "leaf" in structure:
        return leaves[structure["leaf"]]
    if "dict" in structure:
        return {k: _unflatten(v, leaves)
                for k, v in structure["dict"].items()}
    if "tuple" in structure:
        return tuple(_unflatten(v, leaves) for v in structure["tuple"])
    if "list" in structure:
        return [_unflatten(v, leaves) for v in structure["list"]]
    return structure["value"]


_DTYPES = {str(d): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
    torch.bool)}


class _PendingWrite:
    """One issued save: the thread that writes the step directory, and the
    error it met (raised by the next join)."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None


class ShardedCheckpointer:
    """Save/restore a model's (params, optState, state, counters) tree.

    Usage::

        ckpt = ShardedCheckpointer("/ckpts/run1", keepLast=3)
        ckpt.save(net)                      # step = net.iterationCount
        ckpt.restore(net)                   # latest step, in place
        ckpt.restore(net, step=1200)

    Works for MultiLayerNetwork, ComputationGraph, and any object exposing
    ``params_`` / ``optState_`` / ``state_`` / ``iterationCount`` /
    ``epochCount``.
    """

    def __init__(self, directory: str, keepLast: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keepLast = max(1, int(keepLast))
        self._writes: List[_PendingWrite] = []
        # async manifest sealing (saveWithManifest(block=False)): at most
        # one sealer thread in flight, joined by waitUntilFinished/close
        self._sealers: List[threading.Thread] = []
        self._sealLock = threading.Lock()
        # the page-locked staging buffer, reused once the write that
        # last read it has been joined
        self._staging: Optional[torch.Tensor] = None
        self._fence = None

    def setFence(self, fence) -> None:
        """Install a write fence (duck-typed: ``validate(op)`` raising
        when this process must not write, plus a ``generation``
        attribute): every ``saveWithManifest`` is validated before the
        write AND again before the manifest publish, and sealed manifests
        carry the writer's generation in their metadata.  The fence
        itself (the coordination layer's ``GenerationFence``) waits for
        ROADMAP A10b."""
        self._fence = fence

    # ------------------------------------------------------------------
    # the tree
    # ------------------------------------------------------------------
    def _tree(self, net) -> Dict[str, Any]:
        tree = {
            "params": net.params_,
            "optState": net.optState_,
            "state": net.state_,
            "counters": {"iteration": int(net.iterationCount),
                         "epoch": int(net.epochCount)},
        }
        # faithful stochastic resume: the training generator advances
        # every step (dropout masks etc.) and rnn carries persist across
        # calls — without them a restored run replays/forks the noise
        gen = getattr(net, "_fitGen", None)
        if gen is not None:
            tree["fitGen"] = gen.get_state()
        if getattr(net, "_rnnCarries", None):
            tree["rnnCarries"] = net._rnnCarries
        return tree

    def _stage(self, leaves):
        """Copy every leaf into the staging buffer; returns ``(views,
        event)``: one host view per leaf and the CUDA event that fires
        when the last copy has landed (None when every leaf is on the
        CPU, copied synchronously)."""
        offs, total = [], 0
        for _p, t in leaves:
            offs.append(total)
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        cuda = [t for _p, t in leaves if t.is_cuda]
        if self._staging is None or self._staging.numel() < total or \
                bool(cuda) != self._staging.is_pinned():
            self._staging = torch.empty(max(total, 1), dtype=torch.uint8,
                                        pin_memory=bool(cuda))
        views = []
        for (_p, t), off in zip(leaves, offs):
            n = t.numel() * t.element_size()
            dst = self._staging[off:off + n].view(t.dtype).view(t.shape)
            dst.copy_(t.detach(), non_blocking=t.is_cuda)
            views.append(dst)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0].device))
        return views, event

    def save(self, net, step: Optional[int] = None) -> int:
        """Async: returns once every leaf's copy into host memory is
        issued; the disk write overlaps training.  ``waitUntilFinished``/
        ``close`` join outstanding writes."""
        step = int(net.iterationCount if step is None else step)
        # the staging buffer is shared: the previous write must be done
        # reading it
        self._joinWrites()
        structure, leaves = _flatten(self._tree(net))
        views, event = self._stage(leaves)
        sources = [t for _p, t in leaves]
        meta = [{"file": f"{i}.bin", "dtype": str(t.dtype),
                 "shape": list(t.shape), "path": _keystr(p)}
                for i, (p, t) in enumerate(leaves)]
        index = {"format": "dl4j-torch-checkpoint/1", "step": step,
                 "structure": structure, "leaves": meta}
        pending = _PendingWrite()

        def write():
            try:
                if event is not None:
                    event.synchronize()
                del sources[:]  # the copies have landed
                _io_retry(lambda: self._writeStep(step, views, index),
                          f"checkpoint step {step} write",
                          cleanup=lambda: shutil.rmtree(
                              self.stepPath(step) + ".tmp",
                              ignore_errors=True))
                self._prune()
            except BaseException as e:     # surfaced by _joinWrites
                pending.error = e

        pending.thread = threading.Thread(target=write, daemon=True,
                                          name=f"ckpt-write-{step}")
        self._writes.append(pending)
        pending.thread.start()
        return step

    def _writeStep(self, step: int, views, index) -> None:
        final = self.stepPath(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for v, m in zip(views, index["leaves"]):
            with open(os.path.join(tmp, m["file"]), "wb") as fh:
                fh.write(v.reshape(-1).view(torch.uint8).numpy().data)
                fh.flush()
                os.fsync(fh.fileno())
        with open(os.path.join(tmp, "index.json"), "w") as fh:
            json.dump(index, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_dir(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        _fsync_dir(self.directory)

    def _prune(self) -> None:
        """Keep the newest ``keepLast`` steps (Orbax's ``max_to_keep``)."""
        for step in self.allSteps()[:-self.keepLast]:
            shutil.rmtree(self.stepPath(step), ignore_errors=True)

    def _joinWrites(self) -> None:
        writes, self._writes = self._writes, []
        err = None
        for w in writes:
            w.thread.join()
            if w.error is not None and err is None:
                err = w.error
        if err is not None:
            raise err

    def _joinSealers(self) -> None:
        # only the training thread mutates the list, so iterating the
        # attribute directly is race-free here
        for t in self._sealers:
            t.join()
        with self._sealLock:
            self._sealers = [t for t in self._sealers if t.is_alive()]

    def waitUntilFinished(self) -> None:
        """Join outstanding async work: the step writes AND any in-flight
        manifest sealer thread."""
        self._joinSealers()
        self._joinWrites()

    def latestStep(self) -> Optional[int]:
        self._joinWrites()
        steps = self.allSteps()
        return steps[-1] if steps else None

    def allSteps(self) -> List[int]:
        """Every completely written step, oldest first."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def _delete(self, step: int) -> None:
        shutil.rmtree(self.stepPath(step), ignore_errors=True)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def _readStep(self, step: int, device) -> Dict[str, Any]:
        spath = self.stepPath(step)
        with open(os.path.join(spath, "index.json")) as fh:
            index = json.load(fh)
        leaves = []
        for m in index["leaves"]:
            raw = np.fromfile(os.path.join(spath, m["file"]), dtype=np.uint8)
            t = torch.from_numpy(raw).view(_DTYPES[m["dtype"]]) \
                .reshape(m["shape"])
            leaves.append(t)
        tree = _unflatten(index["structure"], leaves)
        gen = tree.pop("fitGen", None)      # a host byte tensor
        tree = _to_device(tree, device)
        if gen is not None:
            tree["fitGen"] = gen
        return tree

    def restore(self, net, step: Optional[int] = None, shardings=None):
        """Restore IN PLACE (params/opt/state/counters, the training
        generator and the rnn carries) onto the net's device; returns net.
        ``shardings`` (a restore onto another mesh's placement) waits for
        ROADMAP A10b."""
        if shardings:
            raise NotImplementedError(
                "restoring a checkpoint onto another mesh waits for the "
                "mesh half of the parallel layer (ROADMAP A10b)")
        step = self.latestStep() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        self._joinWrites()
        device = getattr(net, "device", None) or torch.device("cpu")
        restored = self._readStep(step, device)
        net.params_ = restored["params"]
        net.optState_ = restored["optState"]
        net.state_ = restored["state"]
        net.iterationCount = int(restored["counters"]["iteration"])
        net.epochCount = int(restored["counters"]["epoch"])
        if "fitGen" in restored and getattr(net, "_fitGen", None) \
                is not None:
            net._fitGen.set_state(restored["fitGen"])
        if "rnnCarries" in restored:
            net._rnnCarries = restored["rnnCarries"]
        return net

    def close(self):
        self._joinSealers()
        self._joinWrites()

    # ------------------------------------------------------------------
    # checksum manifests (fault tolerance: FaultTolerantTrainer)
    # ------------------------------------------------------------------
    # A manifest seals a step: sha256 + size of every file under the step
    # directory, plus supervisor metadata (stepInEpoch, lrScale, ...).  It
    # is written ATOMICALLY (tmp + os.replace) only AFTER the async write
    # has been joined, so a crash mid-save leaves a step with no manifest
    # — which restore treats exactly like a corrupt step: skipped, fall
    # back to the previous sealed one.

    def stepPath(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _manifestPath(self, step: int) -> str:
        return os.path.join(self.directory, "manifests",
                            f"step-{int(step)}.json")

    @staticmethod
    def _sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _walkFiles(self, step: int):
        spath = self.stepPath(step)
        for root, _dirs, files in os.walk(spath):
            for fn in sorted(files):
                fp = os.path.join(root, fn)
                yield os.path.relpath(fp, spath), fp

    @staticmethod
    def _treeSpec(net) -> Dict[str, Dict[str, Any]]:
        """Shape-agnostic description of the checkpointed state: per-leaf
        logical shape + dtype for params/optState, keyed as
        ``jax.tree_util.keystr`` keys the reference's.  Records NO device
        or placement."""
        spec: Dict[str, Dict[str, Any]] = {}
        for name in ("params", "optState"):
            sub = getattr(net, name + "_", None)
            if sub is None:
                continue
            _s, leaves = _flatten(sub)
            spec[name] = {_keystr(p): {"shape": [int(d) for d in v.shape],
                                       "dtype": str(v.dtype).replace(
                                           "torch.", "")}
                          for p, v in leaves}
        return spec

    def saveWithManifest(self, net, step: Optional[int] = None,
                         metadata: Optional[Dict[str, Any]] = None,
                         block: bool = True) -> int:
        """Sealed save: save -> join the async write -> checksum every
        file -> atomically publish the manifest.

        ``block=True`` (default) seals synchronously before returning.
        ``block=False`` returns as soon as the write is ISSUED and seals
        on a background thread; ``waitUntilFinished``/
        ``latestValidStep``/``close`` join the sealer, so restore never
        races a half-sealed step (an unsealed step is simply skipped, same
        as a crash mid-save).

        Re-saving an existing step (training rolled back past it and
        re-reached it) refreshes it: the stale step + manifest are deleted
        first.
        """
        # one sealer in flight: a new save must not race the previous
        # step's write/checksum pass
        self._joinSealers()
        if self._fence is not None:
            self._fence.validate("checkpoint save")
        step = int(net.iterationCount if step is None else step)
        self._joinWrites()
        if step in set(self.allSteps()):
            self._delete(step)
            try:
                os.remove(self._manifestPath(step))
            except FileNotFoundError:
                pass
        self.save(net, step)
        meta = dict(metadata or {})
        if self._fence is not None:
            meta.setdefault("generation", int(self._fence.generation))
        tree = self._treeSpec(net)
        if block:
            self._seal(step, meta, tree)
            return step
        t = threading.Thread(target=self._sealSafely,
                             args=(step, meta, tree),
                             name=f"ckpt-seal-{step}", daemon=True)
        with self._sealLock:
            self._sealers.append(t)
        t.start()
        return step

    def _sealSafely(self, step: int, metadata: Dict[str, Any],
                    tree: Dict[str, Any]) -> None:
        """Async sealer body: a sealing failure must not take down the
        training thread — the step just stays unsealed (restore skips it
        exactly like a crash mid-save)."""
        try:
            self._seal(step, metadata, tree)
        except Exception as e:
            log.error("async sealing of checkpoint step %d failed "
                      "(%s: %s); step stays unsealed and restore will "
                      "skip it", step, type(e).__name__, e)

    def _seal(self, step: int, metadata: Dict[str, Any],
              tree: Dict[str, Any]) -> None:
        if self._fence is not None:
            self._fence.validate("manifest publish")
        self._joinWrites()

        def _checksums():
            return {rel: {"sha256": self._sha256(fp),
                          "bytes": os.path.getsize(fp)}
                    for rel, fp in self._walkFiles(step)}

        files = _io_retry(_checksums, f"checksumming step {step}")
        manifest = {"step": step, "files": files, "tree": tree,
                    "metadata": metadata}
        mpath = self._manifestPath(step)
        os.makedirs(os.path.dirname(mpath), exist_ok=True)
        tmp = mpath + ".tmp"

        def _publish():
            with open(tmp, "w") as fh:
                json.dump(manifest, fh, indent=1, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, mpath)
            _fsync_dir(os.path.dirname(mpath))

        _io_retry(_publish, f"manifest publish for step {step}")
        from deeplearning4j_tpu_torch.telemetry.runlog import record_event
        record_event("ckpt.seal", step=int(step),
                     generation=metadata.get("generation"))
        self._pruneManifests()

    def _pruneManifests(self) -> None:
        """Drop manifests whose step was already pruned (keepLast)."""
        mdir = os.path.join(self.directory, "manifests")
        if not os.path.isdir(mdir):
            return
        live = {str(s) for s in self.allSteps()}
        for fn in os.listdir(mdir):
            if fn.startswith("step-") and fn.endswith(".json") \
                    and fn[5:-5] not in live:
                try:
                    os.remove(os.path.join(mdir, fn))
                except FileNotFoundError:
                    pass

    def verifyStep(self, step: int) -> bool:
        """True iff the step's manifest exists and every file matches its
        recorded sha256/size (unsealed or tampered steps fail)."""
        try:
            with open(self._manifestPath(step)) as fh:
                manifest = json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return False
        on_disk = dict(self._walkFiles(step))
        recorded = manifest.get("files", {})
        if set(on_disk) != set(recorded):
            return False
        for rel, info in recorded.items():
            fp = on_disk[rel]
            if os.path.getsize(fp) != info["bytes"] \
                    or self._sha256(fp) != info["sha256"]:
                return False
        return True

    def readMetadata(self, step: int) -> Dict[str, Any]:
        with open(self._manifestPath(step)) as fh:
            return json.load(fh).get("metadata", {})

    def readTree(self, step: int) -> Dict[str, Any]:
        """The manifest's shape-agnostic tree description (per-leaf
        logical shape/dtype for params/optState)."""
        with open(self._manifestPath(step)) as fh:
            return json.load(fh).get("tree", {})

    def latestValidStep(self) -> Optional[int]:
        """Newest step whose checksum manifest verifies; corrupt/unsealed
        newer steps are skipped with a warning."""
        self.waitUntilFinished()
        for step in sorted(self.allSteps(), reverse=True):
            if self.verifyStep(step):
                return int(step)
            from deeplearning4j_tpu_torch.telemetry.registry import \
                get_registry
            get_registry().counter(
                "dl4j_tpu_fault_corrupt_manifests_skipped_total",
                "Checkpoint steps skipped on restore because the "
                "checksum manifest failed to verify").inc()
            log.warning(
                "checkpoint step %d failed checksum verification; "
                "falling back to an earlier step", step)
        return None

    def restoreLatestValid(self, net):
        """Restore the newest VERIFIED step in place; returns the step
        number, or None when no valid checkpoint exists (fresh run)."""
        step = self.latestValidStep()
        if step is None:
            return None
        self.restore(net, step=step)
        return step

    def clear(self) -> None:
        """Delete every step and manifest — a ``resume=False`` fresh start
        must not leave stale steps around as rollback targets."""
        self.waitUntilFinished()
        for step in self.allSteps():
            self._delete(step)
        self._pruneManifests()


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree
