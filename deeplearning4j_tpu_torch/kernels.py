"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source or header is rebuilt; the directory is listed in
``.gitignore``) and loaded with ``ctypes``.  A source that includes
PyTorch's headers takes minutes to compile; a plain C interface takes
seconds, which is why the kernels are bound this way.

With the AOT cache configured (``compile.aotcache``:
``DL4J_TPU_AOT_CACHE_DIR`` or ``set_aot_cache``) the libraries come from
the cache directory instead: a lookup keys the entry by the same content
hash, the compiler's ``--version`` line and the torch / CUDA / port
versions, loads a verified entry, or builds fresh and bakes the result
back (``_build/`` is not read, so a cold cache is really cold).  Each
library is resolved once per process, at its first use (or when the
cache's preload installs it), and never swapped: the wrappers keep the
entry points they got, and a process that configures the cache after a
library's first use keeps launching what it loaded.  Every compiler run
this module starts is recorded in :data:`compiler_runs`, and every checked
launch notes its library's entry (none for a ``_build/`` library) for the
cache's ladders.

A missing ``nvcc`` or a failed build raises.  Nothing here falls back to
the plain PyTorch versions: those run only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional

from deeplearning4j_tpu_torch.compile import aotcache
from deeplearning4j_tpu_torch.compile.aotcache import CompilerRuns

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "function",
           "check", "content_hash", "entry_key", "compiler_runs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: the nvcc runs this process started (count, seconds, names)
compiler_runs = CompilerRuns()


class _Lib(NamedTuple):
    """A loaded library: the handle and its cache entry's digest (None for
    a library from ``_build/``)."""
    lib: ctypes.CDLL
    digest: Optional[str]


_libs: Dict[str, _Lib] = {}
_lock = threading.RLock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _hash(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def content_hash(name: str) -> str:
    """sha256 of ``csrc/<name>.cu``, every header in ``csrc/`` and the
    flags: what the library built from them depends on."""
    return _hash(CSRC / f"{name}.cu")


def _target(src: Path) -> Path:
    """The library built from ``src``, named by a hash of the source, every
    header in ``csrc/`` and the flags, so an edit to any of them rebuilds."""
    return BUILD_DIR / f"{src.stem}-{_hash(src)[:12]}.so"


def entry_key(name: str):
    """``(digest, key)`` of ``csrc/<name>.cu``'s AOT cache entry: the
    content hash, ``nvcc --version`` and the torch / CUDA / port versions.
    Raises when ``nvcc`` cannot be found or run."""
    key = aotcache.library_key("kernel", name, content_hash(name),
                               aotcache.compiler_line(_nvcc()))
    return aotcache._digest(key), key


def _compile(todo) -> Dict[str, str]:
    """One ``nvcc`` per ``(source, output)`` pair, all started together,
    each into a temporary file renamed into place.  Records the runs in
    :data:`compiler_runs`; returns ``{name: compiler output}``; raises if
    any compile fails."""
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for src, out, tmp, proc in procs:
            logs[src.stem] = proc.communicate()[0]
            if proc.returncode:
                failed.append(f"{src.name} (exit {proc.returncode}):\n"
                              f"{logs[src.stem]}")
            else:
                os.replace(tmp, out)
                out.with_suffix(".log").write_text(logs[src.stem])
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        compiler_runs.add([src.stem for src, *_ in procs],
                          time.perf_counter() - t0)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet: one ``nvcc`` per source, all started together.  Returns
    ``{name: compiler output}`` for the sources compiled now (with
    ``-Xptxas=-v`` it lists each kernel's registers, shared memory and
    spills); the output is also kept beside each library, as ``.log``.
    With the AOT cache configured, "built" means "has a cache entry", and
    each fresh library is baked into the cache.  Raises if any compile
    fails."""
    srcs = sorted(CSRC.glob("*.cu")) if names is None \
        else [CSRC / f"{n}.cu" for n in names]
    cache = aotcache.aot_cache()
    if cache is not None:
        todo = [(s, *entry_key(s.stem)) for s in srcs]
        return _bake(cache, [(s, d, k) for s, d, k in todo
                             if not os.path.exists(cache.entryPath(d))])[0]
    todo = [(s, _target(s)) for s in srcs if not _target(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(exist_ok=True)
    return _compile(todo)


def _bake(cache, todo):
    """Build ``(source, digest, key)`` triples into a temporary directory
    inside ``cache`` and publish each library as an entry.  Returns
    ``({name: compiler output}, {name: library bytes})``."""
    if not todo:
        return {}, {}
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=cache.directory))
    try:
        t0 = time.perf_counter()
        logs = _compile([(s, tmp / f"{s.stem}.so") for s, _d, _k in todo])
        dt = time.perf_counter() - t0
        libs = {s.stem: (tmp / f"{s.stem}.so").read_bytes()
                for s, _d, _k in todo}
        for s, digest, key in todo:
            cache.put(digest, libs[s.stem], key, bakeSeconds=dt)
        return logs, libs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu`` (under ``_lock``),
    resolved at its first use: from ``_build/`` with the cache off, else
    from the cache directory — a hit, or a fresh build baked back."""
    got = _libs.get(source)
    if got is not None:
        return got.lib
    cache = aotcache.aot_cache()
    if cache is None:
        build([source])
        lib = ctypes.CDLL(str(_target(CSRC / f"{source}.cu")))
        _libs[source] = _Lib(lib, None)
        return lib
    digest, key = entry_key(source)
    entry = cache.get(digest, kind=aotcache.current_kind("kernel"))
    if entry is None:
        _logs, libs = _bake(cache, [(CSRC / f"{source}.cu", digest, key)])
        path, lib = cache.loadBytes(digest, libs[source])
        entry = aotcache.CachedLibrary(digest, key, path, lib,
                                       cache.directory)
    _install(entry)
    return entry.lib


def _install(entry) -> bool:
    """Serve ``csrc/<name>.cu`` from a loaded cache entry (the AOT
    cache's preload hands entries here).  A library already resolved
    stays: True only when it is this entry's."""
    with _lock:
        got = _libs.get(entry.key["name"])
        if got is not None:
            return got.digest == entry.digest
        _libs[entry.key["name"]] = _Lib(entry.lib, entry.digest)
    aotcache.note_installed(entry)
    return True


def function(source: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, building and
    loading the library on first use.  Every pointer and the stream must
    be declared ``ctypes.c_void_p`` in ``argtypes`` (an undeclared
    argument is passed as a 32-bit int, which cuts a pointer).  Launch
    entry points return a ``cudaError_t`` as an int."""
    with _lock:
        lib = _library(source)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(source: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it).  Each source
    exports ``<source>_error_string`` for the message.  Every launch is
    checked, so this is also where a launch notes its library's cache
    entry (the AOT ladders list what a call used)."""
    got = _libs.get(source)
    if got is not None:
        aotcache.note_use(got.digest)
    if err:
        msg = function(source, f"{source}_error_string", [ctypes.c_int],
                       restype=ctypes.c_char_p)(err)
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({msg.decode()})")
