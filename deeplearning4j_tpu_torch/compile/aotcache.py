"""The persistent, content-addressed cache of the port's compiled
libraries — the port of ``deeplearning4j_tpu/compile/aotcache.py``.

Eager PyTorch compiles no executables.  What the port compiles, and every
fresh process used to compile again, are its two kinds of shared library:

- ``kind="kernel"``: one ``csrc/<name>.cu`` built by ``nvcc`` for
  ``sm_90a`` (:mod:`deeplearning4j_tpu_torch.kernels`);
- ``kind="native"``: the ``g++`` build of the native host library
  (:mod:`deeplearning4j_tpu_torch.native`).

So an entry of this cache is one compiled library, not a per-signature
executable (ROADMAP C42):

- :class:`AotCache` — the on-disk store.  An entry's key is a sha256 over
  the canonical JSON of (kind, source name, the build module's content hash of
  the sources, headers and flags, the compiler's ``--version`` line, the
  torch / CUDA / port versions); the entry file is the reference's format
  (64 hex chars of sha256(body) + body, the body holding the full key and
  the library bytes), written atomically (tmp + ``os.replace``).  On a
  read the checksum is verified BEFORE anything is loaded; only then is
  the library written out, atomically, to a file ``ctypes`` loads.  A
  torn or flipped entry is never loaded: it is QUARANTINED and the caller
  builds fresh; the total size is bounded with LRU eviction.
- :class:`AotDispatch` — the callable installed in place of a boot-path
  function (the train step, the serving forward, prefill and decode).
  The first call of each input signature records, on its group's LADDER,
  the entries of every library the call used; ``preload()`` loads a
  group's whole ladder at boot, so a restart pays loads instead of
  compiler runs.  Its ``_cache_size()`` counts FRESH compiler runs made
  during its calls — a disk load is not a compile — which is what the
  telemetry layers read as recompiles.

A group is the digest of (kind, the wrapped function's identity,
:func:`model_digest`, :func:`device_fingerprint` — a plan's digest
instead once the AOT cache's mesh half lands, ROADMAP A10b — and
:func:`version_fingerprint`), as in the reference.

The cache is OFF unless configured: set ``DL4J_TPU_AOT_CACHE_DIR`` (or
call :func:`set_aot_cache`) to enable; ``DL4J_TPU_AOT_CACHE=0`` is the
kill switch; ``DL4J_TPU_AOT_CACHE_MAX_BYTES`` bounds the LRU size.  With
it off the build modules build and load through their ``_build/`` directories
exactly as before; with it on, libraries come from the cache directory
only.  A build module resolves each library once per process, at its
first use, so configure the cache before the first kernel launch or
native call: a library loaded before that stays, and a ladder lists only
libraries that came from the cache.  ``python -m
deeplearning4j_tpu_torch.compile.aotc`` pre-bakes the libraries and a
model's ladders.

Telemetry: the ``dl4j_tpu_aot_cache_*`` namespace
(``telemetry.instrument.AotCacheMetrics``) — hits/misses by kind, load
and bake latency, evictions, quarantined entries.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["AotCache", "AotDispatch", "aot_cache", "set_aot_cache",
           "model_digest", "plan_digest", "device_fingerprint",
           "version_fingerprint", "wrap_jit", "wrap_serving_model",
           "preload_model"]

log = logging.getLogger(__name__)

_ENTRY_SUFFIX = ".aotx"
_LIB_SUFFIX = ".so"
_DEFAULT_MAX_BYTES = 4 << 30
_QUARANTINE_KEEP = 20


# ---------------------------------------------------------------------------
# digests (the reference's, copied)
# ---------------------------------------------------------------------------

def _digest(obj: Any) -> str:
    """sha256 over the canonical JSON of ``obj`` (tuples/sets coerced so
    the same logical key always hashes identically across processes)."""
    return hashlib.sha256(json.dumps(
        _canon(obj), sort_keys=True, separators=(",", ":"))
        .encode("utf-8")).hexdigest()


def _canon(obj: Any):
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(),
                                                     key=lambda kv:
                                                     str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_canon(v) for v in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _obj_desc(v: Any, depth: int = 3):
    """Deterministic, address-free description of a config object: class
    name + primitive attributes, recursively (bounded).  ``repr`` alone
    is NOT usable — default object reprs embed memory addresses, which
    would make the digest differ across processes for identical
    topologies."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_obj_desc(x, depth - 1) for x in v] if depth > 0 else len(v)
    if isinstance(v, dict):
        return {str(k): _obj_desc(x, depth - 1) for k, x in v.items()} \
            if depth > 0 else sorted(str(k) for k in v)
    name = type(v).__name__
    if depth <= 0:
        return name
    attrs = getattr(v, "__dict__", None)
    if not attrs:
        return name
    return {"__class__": name,
            **{k: _obj_desc(x, depth - 1) for k, x in sorted(attrs.items())
               if not k.startswith("_")}}


def _param_desc(tree, prefix: str = ""):
    """``[path, shape, dtype]`` of every leaf, dict keys in sorted order
    (as JAX flattens them): a tree restored from a checkpoint, whose keys
    come back in another order, describes the same topology."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _param_desc(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _param_desc(v, f"{prefix}{i}/")
    else:
        yield [prefix, list(getattr(tree, "shape", ())),
               str(getattr(tree, "dtype", ""))]


def model_digest(model) -> str:
    """Topology digest of a model: its configuration (the conf JSON of a
    ``MultiLayerNetwork`` / ``ComputationGraph``, a ``TransformerLM``'s
    config) + per-leaf parameter paths, shapes and dtypes.  Values are
    deliberately EXCLUDED, so two processes that build the same
    architecture share a ladder whatever weights they carry."""
    desc: Dict[str, Any] = {"class": type(model).__name__}
    conf = getattr(model, "conf", None)
    if conf is not None:
        to_json = getattr(conf, "toJson", None)
        desc["conf"] = to_json() if callable(to_json) else _obj_desc(conf)
        desc["computeDtype"] = str(getattr(model, "_computeDtype", ""))
    cfg = getattr(model, "config", None)
    if cfg is not None:
        desc["config"] = _obj_desc(cfg)
    params = getattr(model, "params_", None)
    if params is None and callable(getattr(model, "named_parameters",
                                           None)):
        params = dict(model.named_parameters())
    if params is not None:
        desc["params"] = list(_param_desc(params))
    return _digest(desc)


def plan_digest(plan) -> str:
    """Digest of a ShardingPlan — keying the cache by a plan is the AOT
    cache's mesh half (ROADMAP A10b), so this raises naming it."""
    raise NotImplementedError(
        "plan_digest: keying the AOT cache by a ShardingPlan (its mesh "
        "half) waits for ROADMAP A10b")


def device_fingerprint(devices: Optional[Sequence] = None) -> List:
    """Ordered ``[index, name, "major.minor"]`` of the CUDA devices (or of
    ``devices``); ``[["cpu"]]`` on a host with none — a library built for
    one compute capability is keyed apart from another."""
    import torch
    if devices is None:
        if not torch.cuda.is_available():
            return [["cpu"]]
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out: List = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            out.append([d.type])
            continue
        i = d.index if d.index is not None else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(i)
        out.append([int(i), torch.cuda.get_device_name(i),
                    f"{major}.{minor}"])
    return out


def version_fingerprint() -> Dict[str, str]:
    """What changes a compiled library without changing its sources: the
    torch and CUDA runtime versions and THIS package's version."""
    import torch

    import deeplearning4j_tpu_torch
    return {"torch": str(torch.__version__),
            "cuda": str(torch.version.cuda),
            "dl4j_tpu_torch": str(getattr(deeplearning4j_tpu_torch,
                                          "__version__", "?"))}


def library_key(kind: str, name: str, content: str,
                compiler: str) -> Dict[str, Any]:
    """The full key of one library entry: kind and source name, the
    build module's content hash (sources, headers, flags), the compiler's
    ``--version`` line and :func:`version_fingerprint`."""
    return {"kind": kind, "name": name, "content": content,
            "compiler": compiler, "versions": version_fingerprint()}


_COMPILER_LINES: Dict[str, str] = {}


def compiler_line(exe: str) -> str:
    """The compiler's ``--version`` output, whitespace-folded into one
    line (run once per process and compiler).  Raises when the compiler
    cannot be run: no key, no lookup, as no build."""
    line = _COMPILER_LINES.get(exe)
    if line is None:
        try:
            proc = subprocess.run([exe, "--version"], capture_output=True,
                                  text=True, timeout=60)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"cannot run {exe} --version: {e}") from e
        if proc.returncode:
            raise RuntimeError(f"{exe} --version exited {proc.returncode}")
        line = _COMPILER_LINES[exe] = " ".join(proc.stdout.split())
    return line


# ---------------------------------------------------------------------------
# the process-wide records the build modules keep
# ---------------------------------------------------------------------------

class CompilerRuns:
    """The compiler runs one build module started in this process: how many,
    their wall seconds and the sources' names."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.seconds = 0.0
        self.names: List[str] = []
        self.runs: List[Tuple[Tuple[str, ...], float]] = []

    def add(self, names: Sequence[str], seconds: float) -> None:
        """Record one build: the sources compiled together and the wall
        seconds the build took (parallel runs count once)."""
        with self._lock:
            self.count += len(names)
            self.seconds += float(seconds)
            self.names.extend(names)
            self.runs.append((tuple(names), float(seconds)))


#: entry digest -> uses of the installed library (a kernel launch, a
#: native call) in this process: what a ladder record lists
_USES: Dict[str, int] = {}
#: entry digest -> the cache directory its library was installed from
_INSTALLED: Dict[str, str] = {}


_current = threading.local()


def current_kind(default: str) -> str:
    """The kind of the :class:`AotDispatch` whose call is running on this
    thread (a lookup inside it is labelled with it, as in the reference),
    else ``default``."""
    return getattr(_current, "kind", None) or default


def note_use(digest: Optional[str]) -> None:
    if digest is not None:
        _USES[digest] = _USES.get(digest, 0) + 1


def note_installed(entry: "CachedLibrary") -> None:
    _INSTALLED[entry.digest] = entry.directory


def _fresh_runs() -> Tuple[int, float]:
    """Compiler runs (count, seconds) both build modules started so far."""
    from deeplearning4j_tpu_torch import kernels, native
    a, b = kernels.compiler_runs, native.compiler_runs
    return a.count + b.count, a.seconds + b.seconds


def _key_current(key: Dict[str, Any]) -> bool:
    """Whether an entry's key still describes what its build module would build
    now (same sources, headers, flags and versions).  The compiler line is
    not re-probed: a preload must work where no compiler is reachable."""
    try:
        if key.get("versions") != version_fingerprint():
            return False
        if key.get("kind") == "kernel":
            from deeplearning4j_tpu_torch import kernels
            return key.get("content") == kernels.content_hash(key["name"])
        if key.get("kind") == "native":
            from deeplearning4j_tpu_torch import native
            return key.get("content") == native.content_hash()
    except (OSError, KeyError):
        pass
    return False


def _install(entry: "CachedLibrary") -> bool:
    """Hand a loaded entry to its build module, which serves it from now on."""
    kind = entry.key.get("kind")
    if kind == "kernel":
        from deeplearning4j_tpu_torch import kernels
        return kernels._install(entry)
    if kind == "native":
        from deeplearning4j_tpu_torch import native
        return native._install(entry)
    return False


# ---------------------------------------------------------------------------
# the on-disk cache
# ---------------------------------------------------------------------------

class CachedLibrary(NamedTuple):
    """One loaded entry: its digest, full key, loadable file, handle and
    the cache directory it came from."""
    digest: str
    key: Dict[str, Any]
    path: str
    lib: Any
    directory: str


def _pack(key: Dict[str, Any], library: bytes) -> bytes:
    head = json.dumps(_canon(key), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return len(head).to_bytes(8, "little") + head + library


def _unpack(body: bytes) -> Tuple[Dict[str, Any], bytes]:
    n = int.from_bytes(body[:8], "little")
    if n <= 0 or 8 + n > len(body):
        raise ValueError("malformed entry body")
    return json.loads(body[8:8 + n].decode("utf-8")), body[8 + n:]


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


class AotCache:
    """Content-addressed on-disk store of compiled libraries.

    Layout (all writes atomic: tmp + ``os.replace``)::

        <dir>/<entry-digest>.aotx          sha256 header + body
        <dir>/lib/<entry-digest>.so        the loadable copy of a verified entry
        <dir>/ladder-<group>/<sig>.json    one record per input signature
        <dir>/quarantine/...               corrupt entries, moved aside

    An entry file is ``64 hex chars of sha256(body) + body`` where body is
    the 8-byte length of the key's canonical JSON, that JSON, and the
    library's bytes.  The checksum makes a torn or bit-rotted write
    deterministically detectable: it is quarantined and the caller builds
    fresh.
    """

    def __init__(self, directory: str,
                 maxBytes: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if maxBytes is None:
            env = os.environ.get("DL4J_TPU_AOT_CACHE_MAX_BYTES")
            maxBytes = int(env) if env else _DEFAULT_MAX_BYTES
        self.maxBytes = int(maxBytes)

    # -- paths ----------------------------------------------------------
    def entryPath(self, digest: str) -> str:
        return os.path.join(self.directory, digest + _ENTRY_SUFFIX)

    def _libPath(self, digest: str) -> str:
        return os.path.join(self.directory, "lib", digest + _LIB_SUFFIX)

    def _ladderDir(self, group: str) -> str:
        return os.path.join(self.directory, f"ladder-{group}")

    def _quarantineDir(self) -> str:
        return os.path.join(self.directory, "quarantine")

    # -- metrics --------------------------------------------------------
    @staticmethod
    def _metrics():
        from deeplearning4j_tpu_torch.telemetry import aot_metrics
        return aot_metrics()

    # -- read path ------------------------------------------------------
    def get(self, digest: str, kind: str = "unknown"
            ) -> Optional[CachedLibrary]:
        """Load the library of ``digest``; None on a miss.  The checksum is
        verified before anything is loaded; a corrupt entry, or one the
        loader rejects, is quarantined.  An intact entry whose key no
        longer matches its build module's sources or versions (a ladder can
        outlive an edit) is a miss and stays on disk."""
        m = self._metrics()
        path = self.entryPath(digest)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            m.misses().inc(kind=kind)
            return None
        try:
            head, body = blob[:64], blob[64:]
            if hashlib.sha256(body).hexdigest().encode("ascii") != head:
                raise ValueError("checksum mismatch")
            key, library = _unpack(body)
        except Exception as e:
            log.warning("quarantining corrupt AOT cache entry %s (%s: %s)",
                        os.path.basename(path), type(e).__name__, e)
            self._quarantine(path)
            m.misses().inc(kind=kind)
            return None
        if not _key_current(key):
            m.misses().inc(kind=kind)
            return None
        try:
            lib_path, lib = self.loadBytes(digest, library)
        except OSError as e:
            log.warning("quarantining unloadable AOT cache entry %s "
                        "(%s: %s)", os.path.basename(path),
                        type(e).__name__, e)
            self._quarantine(path)
            m.misses().inc(kind=kind)
            return None
        try:
            os.utime(path)          # touch: the LRU clock is file mtime
        except OSError:
            pass
        m.hits().inc(kind=kind)
        m.load_seconds().observe(time.perf_counter() - t0)
        return CachedLibrary(digest, key, lib_path, lib, self.directory)

    def loadBytes(self, digest: str, library: bytes):
        """Write verified library bytes to their loadable file (atomic)
        and ``dlopen`` it: ``(path, ctypes.CDLL)``."""
        dst = self._libPath(digest)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        _atomic_write(dst, library)
        return dst, ctypes.CDLL(dst)

    def _quarantine(self, path: str) -> None:
        qdir = self._quarantineDir()
        digest = os.path.basename(path)[:-len(_ENTRY_SUFFIX)]
        try:
            os.makedirs(qdir, exist_ok=True)
            dst = os.path.join(
                qdir, f"{os.path.basename(path)}.{os.getpid()}."
                      f"{time.time_ns()}")
            os.replace(path, dst)
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass
        try:
            os.remove(self._libPath(digest))
        except OSError:
            pass
        self._metrics().quarantined().inc()
        # bound the graveyard in COUNT and BYTES: forensics are worth a
        # few files, never multiples of the cache's own size bound
        try:
            aged = []
            for fn in os.listdir(qdir):
                fp = os.path.join(qdir, fn)
                aged.append((os.path.getmtime(fp), os.path.getsize(fp),
                             fp))
            aged.sort(reverse=True)         # newest first
            budget = self.maxBytes // 8
            kept = 0
            for i, (_m, size, fp) in enumerate(aged):
                kept += size
                if i >= _QUARANTINE_KEEP or kept > budget:
                    os.remove(fp)
        except OSError:
            pass

    # -- write path -----------------------------------------------------
    def put(self, digest: str, library: bytes, key: Dict[str, Any],
            bakeSeconds: Optional[float] = None) -> bool:
        """Atomically publish one library, then enforce the LRU bound.
        Returns False — entry skipped, run unaffected — when the cache
        media rejects the write (full or read-only disk): the caller
        already holds the built library."""
        body = _pack(key, library)
        blob = hashlib.sha256(body).hexdigest().encode("ascii") + body
        try:
            _atomic_write(self.entryPath(digest), blob)
        except OSError as e:
            log.warning("AOT cache: entry write failed (%s: %s); "
                        "continuing uncached", type(e).__name__, e)
            return False
        if bakeSeconds is not None:
            self._metrics().bake_seconds().observe(bakeSeconds)
        self._evict()
        return True

    def recordLadder(self, group: str, signature: str,
                     digests: Sequence[str]) -> None:
        """Record one input signature of a group with the entries its
        first call used, so a later boot can preload them.  One atomic
        file PER SIGNATURE (``ladder-<group>/<sig-digest>.json``):
        concurrent processes sharing one cache dir each publish their own
        file, so there is no read-modify-write to lose records to."""
        ldir = self._ladderDir(group)
        path = os.path.join(ldir, f"{_digest(signature)}.json")
        rec = {"signature": signature, "digests": sorted(set(digests))}
        try:
            with open(path) as fh:
                if json.load(fh) == rec:
                    return
        except (OSError, ValueError):
            pass
        os.makedirs(ldir, exist_ok=True)
        _atomic_write(path, json.dumps(rec).encode("utf-8"))

    def ladder(self, group: str) -> List[Dict[str, Any]]:
        ldir = self._ladderDir(group)
        out: List[Dict[str, Any]] = []
        try:
            names = sorted(os.listdir(ldir))
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(ldir, fn)) as fh:
                    out.append(json.load(fh))
            except (OSError, ValueError):
                continue
        return out

    # -- bounds ---------------------------------------------------------
    def entries(self) -> List[Tuple[str, int, float]]:
        """(digest, bytes, mtime) for every entry on disk."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(_ENTRY_SUFFIX):
                continue
            fp = os.path.join(self.directory, fn)
            try:
                st = os.stat(fp)
            except OSError:
                continue
            out.append((fn[:-len(_ENTRY_SUFFIX)], st.st_size, st.st_mtime))
        return out

    def entryKey(self, digest: str) -> Optional[Dict[str, Any]]:
        """The full key stored in an entry (checksum verified), or None."""
        try:
            with open(self.entryPath(digest), "rb") as fh:
                blob = fh.read()
            if hashlib.sha256(blob[64:]).hexdigest().encode("ascii") \
                    != blob[:64]:
                return None
            return _unpack(blob[64:])[0]
        except (OSError, ValueError):
            return None

    def totalBytes(self) -> int:
        return sum(size for _d, size, _m in self.entries())

    def _ladderDirs(self) -> List[str]:
        try:
            return [os.path.join(self.directory, fn)
                    for fn in os.listdir(self.directory)
                    if fn.startswith("ladder-")]
        except OSError:
            return []

    def _dropLadderRecords(self, digest: str) -> None:
        """Remove every ladder record that lists a deleted entry, so later
        boots don't preload a digest that no longer exists: the next call
        of that signature records afresh."""
        for ldir in self._ladderDirs():
            try:
                names = os.listdir(ldir)
            except OSError:
                continue
            for fn in names:
                if not fn.endswith(".json"):
                    continue
                fp = os.path.join(ldir, fn)
                try:
                    with open(fp) as fh:
                        listed = digest in json.load(fh).get("digests", ())
                    if listed:
                        os.remove(fp)
                except (OSError, ValueError, AttributeError):
                    continue

    def _sweepTmp(self) -> None:
        """Delete orphaned ``*.tmp`` files a killed writer left behind, in
        the cache root, ``lib/`` and the ladder dirs.  Age-gated so a LIVE
        concurrent writer's in-flight tmp survives."""
        cutoff = time.time() - 3600.0
        for d in [self.directory, os.path.join(self.directory, "lib"),
                  *self._ladderDirs()]:
            try:
                files = os.listdir(d)
            except OSError:
                continue
            for fn in files:
                if not fn.endswith(".tmp"):
                    continue
                fp = os.path.join(d, fn)
                try:
                    if os.path.getmtime(fp) < cutoff:
                        os.remove(fp)
                except OSError:
                    pass

    def _evict(self) -> None:
        """LRU: drop least-recently-used entries (their loadable copies
        and the ladder records that list them) until under the size bound;
        also sweeps aged orphan tmp files."""
        self._sweepTmp()
        entries = self.entries()
        total = sum(size for _d, size, _m in entries)
        if total <= self.maxBytes:
            return
        m = self._metrics()
        for digest, size, _mtime in sorted(entries, key=lambda e: e[2]):
            if total <= self.maxBytes:
                break
            try:
                os.remove(self.entryPath(digest))
            except OSError:
                continue
            try:
                os.remove(self._libPath(digest))
            except OSError:
                pass
            self._dropLadderRecords(digest)
            total -= size
            m.evictions().inc()


# ---------------------------------------------------------------------------
# process-global configuration
# ---------------------------------------------------------------------------

_CACHE: Optional[AotCache] = None
_CACHE_EXPLICIT = False


def set_aot_cache(cache) -> None:
    """Install the process-global cache: an :class:`AotCache`, a
    directory path, or None to disable.  An explicit install (including
    None) takes precedence over ``DL4J_TPU_AOT_CACHE_DIR``.  Libraries
    already loaded in this process stay as they are."""
    global _CACHE, _CACHE_EXPLICIT
    _CACHE = AotCache(cache) if isinstance(cache, str) else cache
    _CACHE_EXPLICIT = True


def aot_cache() -> Optional[AotCache]:
    """The process-global cache, or None when AOT caching is off.
    Resolution order: the kill switch ``DL4J_TPU_AOT_CACHE=0`` wins,
    then :func:`set_aot_cache`, then ``DL4J_TPU_AOT_CACHE_DIR``."""
    global _CACHE
    if os.environ.get("DL4J_TPU_AOT_CACHE") == "0":
        return None
    if _CACHE_EXPLICIT:
        return _CACHE
    env = os.environ.get("DL4J_TPU_AOT_CACHE_DIR")
    if env and (_CACHE is None or
                _CACHE.directory != os.path.abspath(env)):
        _CACHE = AotCache(env)
    return _CACHE if env else None


# ---------------------------------------------------------------------------
# the dispatch wrapper
# ---------------------------------------------------------------------------

def _sig_str(args: tuple, kwargs: dict, static: Sequence[int] = ()) -> str:
    """Stable string form of a call's input signature: the torch pytree
    spec, then each leaf's (shape, dtype, device) — numpy arrays too —
    and for Python scalars their type only (eager code takes them at run
    time, so a decode position is not a new signature).  Positions in
    ``static`` carry their repr, as the reference's static args do."""
    import numpy as np
    from torch.utils._pytree import tree_flatten
    import torch
    if static:
        args = tuple(("static", repr(a)) if i in static else a
                     for i, a in enumerate(args))
    leaves, spec = tree_flatten((args, kwargs))
    parts = [str(spec)]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append(f"{tuple(leaf.shape)}:{leaf.dtype}:{leaf.device}")
        elif isinstance(leaf, np.ndarray):
            parts.append(f"{leaf.shape}:{leaf.dtype}:host")
        elif isinstance(leaf, (bool, int, float)):
            parts.append(f"py:{type(leaf).__name__}")
        elif leaf is None or isinstance(leaf, str):
            parts.append(f"py:{leaf!r}")
        else:
            parts.append(f"py:{type(leaf).__name__}")
    return ";".join(parts)


class AotDispatch:
    """Drop-in callable for a boot-path function.

    Per input signature: the first call in a process records, on the
    group's ladder, the entries of every library the call used (kernel
    launches and native calls); ``preload()`` loads a group's whole ladder
    before the first call.  ``_cache_size()`` counts fresh compiler runs
    made during its calls ONLY — the telemetry layers
    (``train_step_span``, ``BucketedExecutor``) read it as "recompiles",
    and a disk load is not a recompile; this is exactly what makes
    ``dl4j_tpu_train_compile_seconds_total`` 0 on a warm boot.
    ``static_argnums`` name positions whose VALUE is part of the
    signature.
    """

    def __init__(self, fn, cache: AotCache, keyBase: Dict[str, Any],
                 kind: str, static_argnums: Sequence[int] = ()):
        self._fn = fn
        self._cache = cache
        self._keyBase = keyBase
        self.kind = kind
        self._static = tuple(sorted(static_argnums))
        self.group = _digest(keyBase)
        self._seen: set = set()         # signatures recorded this process
        self._libraries: set = set()    # entries preloaded or recorded
        self._fresh = 0
        self._freshSeconds = 0.0
        self._lock = threading.Lock()

    # the jit-cache-accounting probe every telemetry layer reads
    def _cache_size(self) -> int:
        return self._fresh

    def loadedCount(self) -> int:
        """Entries of this group's ladder loaded in this process (by
        :meth:`preload` or used by a call)."""
        return len(self._libraries)

    def preload(self) -> int:
        """Load every library on this group's ladder (boot-path hook:
        supervisor resume, serving warm, the first train step).  Returns
        the number loaded now; libraries already loaded in this process
        count once, where they were loaded."""
        n = 0
        for rec in self._cache.ladder(self.group):
            for digest in rec.get("digests") or ():
                if digest in self._libraries:
                    continue
                if _INSTALLED.get(digest) != self._cache.directory:
                    entry = self._cache.get(digest, kind=self.kind)
                    if entry is None or not _install(entry):
                        continue
                    n += 1
                self._libraries.add(digest)
        return n

    def __call__(self, *args, **kwargs):
        sig = _sig_str(args, kwargs, self._static)
        c0, s0 = _fresh_runs()
        first = sig not in self._seen
        used0 = dict(_USES) if first else None
        outer = getattr(_current, "kind", None)
        _current.kind = self.kind
        try:
            out = self._fn(*args, **kwargs)
        finally:
            _current.kind = outer
            c1, s1 = _fresh_runs()
            if c1 > c0:
                with self._lock:
                    self._fresh += c1 - c0
                    self._freshSeconds += s1 - s0
        if first:
            used = [d for d, n in _USES.items() if n > used0.get(d, 0)]
            try:
                self._cache.recordLadder(self.group, sig, used)
            except OSError as e:
                log.warning("AOT cache: ladder record failed (%s: %s)",
                            type(e).__name__, e)
            with self._lock:
                self._seen.add(sig)
                self._libraries.update(used)
        return out


# ---------------------------------------------------------------------------
# boot-path wiring helpers
# ---------------------------------------------------------------------------

def wrap_jit(fn, *, kind: str, model=None, plan=None,
             static_argnums: Sequence[int] = (), preload: bool = True):
    """Wrap a boot-path callable in an :class:`AotDispatch` when the
    process-global cache is configured; otherwise return it UNCHANGED
    (zero behaviour change with the cache off).  ``model`` / ``plan``
    contribute their digests to the group — a plan raises naming ROADMAP
    A10b, which falls back to the unwrapped callable like any key that
    cannot be made."""
    cache = aot_cache()
    if cache is None:
        return fn
    keyBase: Dict[str, Any] = {"kind": kind,
                               "versions": version_fingerprint()}
    try:
        # the wrapped function's import identity is always part of the
        # key: two DIFFERENT functions wrapped with the same kind/model
        # must not share a ladder
        wrapped = getattr(fn, "__func__", fn)
        wrapped = getattr(wrapped, "__wrapped__", wrapped)
        keyBase["fn"] = (f"{getattr(wrapped, '__module__', '?')}."
                         f"{getattr(wrapped, '__qualname__', '?')}")
        if model is not None:
            keyBase["model"] = model_digest(model)
        if plan is not None:
            keyBase["plan"] = plan_digest(plan)
        else:
            keyBase["devices"] = device_fingerprint()
    except Exception as e:
        # an undigestable model/plan must degrade to the plain callable,
        # never take the step down
        log.warning("AOT cache: could not key %s (%s: %s); falling back "
                    "to the plain callable", kind, type(e).__name__, e)
        return fn
    disp = AotDispatch(fn, cache, keyBase, kind,
                       static_argnums=static_argnums)
    if preload:
        n = disp.preload()
        if n:
            log.info("AOT cache: preloaded %d %s librar(y/ies) for group "
                     "%s", n, kind, disp.group[:12])
    return disp


def bound_dispatch(obj, name: str) -> Optional[AotDispatch]:
    """The :class:`AotDispatch` installed as ``obj.<name>`` over one of
    ``obj``'s own methods, or None.  A shallow copy of a model carries its
    original's dispatches in its ``__dict__``: those call the original,
    so they do not count as the copy's."""
    fn = obj.__dict__.get(name)
    if isinstance(fn, AotDispatch) and \
            getattr(fn._fn, "__self__", obj) is obj:
        return fn
    return None


def _wrap_attr(obj, name: str, kind: str, model) -> None:
    if bound_dispatch(obj, name) is None:
        obj.__dict__.pop(name, None)
        obj.__dict__[name] = wrap_jit(getattr(obj, name), kind=kind,
                                      model=model)


def wrap_serving_model(model) -> bool:
    """AOT-wrap a serving model's inference entry points in place (the
    ``BucketedExecutor.warm()`` hook): ``_output`` for forward models,
    ``prefill`` / ``decodeStep`` for KV-cache LMs.  No-op (False) with
    the cache off or for models without those surfaces."""
    if aot_cache() is None or model is None:
        return False
    wrapped = False
    if callable(getattr(model, "_output", None)):
        _wrap_attr(model, "_output", "output", model)
        wrapped = True
    if callable(getattr(model, "prefill", None)) and \
            callable(getattr(model, "decodeStep", None)):
        _wrap_attr(model, "prefill", "prefill", model)
        _wrap_attr(model, "decodeStep", "decode", model)
        wrapped = True
    return wrapped


def train_step(model):
    """The model's train step: its ``_runTrainStep``, or with the cache
    configured the :class:`AotDispatch` over it (made on first use, which
    preloads the group's ladder, and kept in ``model.__dict__``)."""
    fn = bound_dispatch(model, "_trainStep")
    if fn is None:
        model.__dict__.pop("_trainStep", None)
        fn = wrap_jit(model._runTrainStep, kind="train_step", model=model)
        if isinstance(fn, AotDispatch):
            model.__dict__["_trainStep"] = fn
    return fn


def preload_model(model) -> int:
    """Preload the train-step ladder for ``model`` (the supervisor's
    resume hook): installs the step's dispatch NOW — outside the first
    step's timed span — so restart-to-first-step pays library LOADS here,
    not compiler runs inside the step.  Returns the libraries of the
    group now loaded; 0 with the cache off.  A mesh facade waits for
    ROADMAP A10b."""
    if aot_cache() is None or model is None:
        return 0
    net = getattr(model, "model", model)
    if not callable(getattr(net, "_runTrainStep", None)):
        return 0
    fn = train_step(net)
    if isinstance(fn, AotDispatch):
        fn.preload()                # idempotent top-up
        return fn.loadedCount()
    return 0


def _dispatch_cache_size(*objs) -> Optional[int]:
    """The serving adapters' ``compileCacheSize``: fresh compiler runs of
    every :class:`AotDispatch` installed on ``objs``, or None with the
    cache off (eager PyTorch keeps no executable cache to probe)."""
    if aot_cache() is None:
        return None
    total = 0
    for obj in objs:
        if obj is None:
            continue
        for name in list(vars(obj)):
            fn = bound_dispatch(obj, name)
            if fn is not None:
                total += fn._cache_size()
    return total
