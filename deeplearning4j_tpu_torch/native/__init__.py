"""The C++ host runtime — the port's own copy of the ctypes loader in
``deeplearning4j_tpu/native/__init__.py``.

It binds the same library the reference builds, from the repository's
``native/src``: the thread pool (:func:`parallel_for`,
:func:`num_threads`, :func:`set_num_threads`), the numeric CSV parser
(:func:`csv_parse`, the DataVec bulk path), the counter-addressed RNG
(:func:`philox_uniform`, :func:`philox_gaussian`), the gradient codecs
(:func:`threshold_encode` / :func:`threshold_decode`,
:func:`bitmap_encode` / :func:`bitmap_decode`, which the parallel
layer's gradient sharing calls; nothing in DataVec does) and the host arena
(:class:`Workspace`).

On first use the library is compiled from ``native/src/{csv,threads,
random,compression,workspace}.cpp`` with one ``g++`` into
``deeplearning4j_tpu_torch/_build/native/libdl4j_native-<hash>.so`` (the
hash covers those sources, the header and the flags, so an edit rebuilds;
the directory is listed in ``.gitignore``).  ``xla_ffi.cpp`` is never
built: it includes XLA's headers, which no machine the port runs on has.

With the AOT cache configured (``compile.aotcache``) the library comes
from the cache directory instead, keyed by the same content hash, ``g++
--version`` and the torch / CUDA / port versions: a verified entry is
loaded, or the library is built into the cache and baked there
(``_build/native`` is not read).  The library is resolved once per
process, at its first use (or when the cache's preload installs it): a
process that configures the cache after that keeps the library it has.
Every compiler run this module starts is recorded in
:data:`compiler_runs`.

Where the library cannot be built or loaded (no compiler, or
``DL4J_TPU_DISABLE_NATIVE`` set) every function keeps the reference's
pure-NumPy fallback, which is the reference's own behaviour; callers that
must have the native path check :func:`available`.
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
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.compile import aotcache
from deeplearning4j_tpu_torch.compile.aotcache import CompilerRuns

__all__ = ["available", "backend", "library_path", "num_threads",
           "set_num_threads", "parallel_for", "threshold_encode",
           "threshold_decode", "bitmap_encode", "bitmap_decode",
           "philox_uniform", "philox_gaussian", "Workspace", "csv_parse",
           "SOURCES", "content_hash", "entry_key", "compiler_runs"]

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
#: the sources the port builds (never ``xla_ffi.cpp``)
SOURCES = ("csv.cpp", "threads.cpp", "random.cpp", "compression.cpp",
           "workspace.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
#: this process's one resolution of the library, made at its first use:
#: (library or None, its file, its AOT cache entry's digest or None)
_state: Optional[tuple] = None
_NONE = (None, None, None)
#: the g++ runs this process started (count, seconds, names)
compiler_runs = CompilerRuns()


def _sources():
    return [_NATIVE_DIR / "src" / s for s in SOURCES]


def content_hash() -> str:
    """sha256 of the five sources, the header and the flags: what the
    library built from them depends on."""
    h = hashlib.sha256()
    for f in [*_sources(), _NATIVE_DIR / "include" / "dl4j_native.h"]:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()


def _target() -> Path:
    return BUILD_DIR / f"libdl4j_native-{content_hash()[:12]}.so"


def _cxx() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def entry_key():
    """``(digest, key)`` of the library's AOT cache entry: the content
    hash, ``g++ --version`` and the torch / CUDA / port versions.  Raises
    when the compiler cannot be found or run."""
    cxx = _cxx()
    if not cxx:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH)")
    key = aotcache.library_key("native", "libdl4j_native", content_hash(),
                               aotcache.compiler_line(cxx))
    return aotcache._digest(key), key


def _compile(out: Path) -> Optional[Path]:
    """One ``g++`` over the five sources into a temporary file, renamed
    into place, so processes building at once never load a partial file."""
    cxx = _cxx()
    if not cxx or not all(s.exists() for s in _sources()):
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-I", str(_NATIVE_DIR / "include"),
             *[str(s) for s in _sources()], "-o", str(tmp)],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        compiler_runs.add(["libdl4j_native"], time.perf_counter() - t0)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode or not tmp.exists():
        return None
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
    f32 = ctypes.c_float
    pf32 = ctypes.POINTER(ctypes.c_float)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    void_p = ctypes.c_void_p

    lib.dl4j_abi_version.restype = i64
    lib.dl4j_num_threads.restype = i32
    lib.dl4j_set_num_threads.argtypes = [i32]
    lib.dl4j_parallel_for.argtypes = [void_p, void_p, i64, i64, i64]

    lib.dl4j_threshold_count.restype = i64
    lib.dl4j_threshold_count.argtypes = [pf32, i64, f32]
    lib.dl4j_threshold_encode.restype = i64
    lib.dl4j_threshold_encode.argtypes = [pf32, i64, f32, pi32, i64]
    lib.dl4j_threshold_decode.argtypes = [pi32, i64, f32, pf32, i64]
    lib.dl4j_bitmap_encode.restype = i64
    lib.dl4j_bitmap_encode.argtypes = [pf32, i64, f32, pu32]
    lib.dl4j_bitmap_decode.argtypes = [pu32, i64, f32, pf32]

    lib.dl4j_philox_uniform.argtypes = [u64, u64, pf32, i64]
    lib.dl4j_philox_gaussian.argtypes = [u64, u64, pf32, i64]
    lib.dl4j_philox_uint32.argtypes = [u64, u64, pu32, i64]

    lib.dl4j_workspace_create.restype = void_p
    lib.dl4j_workspace_create.argtypes = [i64]
    lib.dl4j_workspace_alloc.restype = void_p
    lib.dl4j_workspace_alloc.argtypes = [void_p, i64]
    lib.dl4j_workspace_reset.argtypes = [void_p]
    lib.dl4j_workspace_destroy.argtypes = [void_p]
    for fn in ("capacity", "used", "spilled"):
        getattr(lib, f"dl4j_workspace_{fn}").restype = i64
        getattr(lib, f"dl4j_workspace_{fn}").argtypes = [void_p]

    lib.dl4j_csv_count_rows.restype = i64
    lib.dl4j_csv_count_rows.argtypes = [ctypes.c_char_p, i64]
    lib.dl4j_csv_parse_f32.restype = i64
    lib.dl4j_csv_parse_f32.argtypes = [ctypes.c_char_p, i64, ctypes.c_char,
                                       i32, pf32, i64, pi32]


def _accepts(lib: ctypes.CDLL) -> bool:
    """Declare the library's entry points; True when it is this module's
    (every symbol there, ABI version 1)."""
    try:
        _declare(lib)
        return lib.dl4j_abi_version() == 1
    except AttributeError:
        return False


def _open(path: Path) -> Optional[ctypes.CDLL]:
    """``dlopen`` a built library; None when it cannot be loaded or is
    not this module's."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    return lib if _accepts(lib) else None


def _bake(cache, digest: str, key) -> Optional["aotcache.CachedLibrary"]:
    """Build the library into a temporary directory inside ``cache``,
    publish it as the entry ``digest`` and load the published file."""
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=cache.directory))
    try:
        t0 = time.perf_counter()
        out = _compile(tmp / "libdl4j_native.so")
        if out is None:
            return None
        library = out.read_bytes()
        cache.put(digest, library, key, bakeSeconds=time.perf_counter() - t0)
        path, lib = cache.loadBytes(digest, library)
    except OSError:
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return aotcache.CachedLibrary(digest, key, path, lib, cache.directory)


def _resolve() -> tuple:
    """Find the library: from ``_build/`` with the AOT cache off, else a
    verified cache entry or a fresh build baked back; ``_NONE`` (the
    fallbacks) when it cannot be had."""
    if os.environ.get("DL4J_TPU_DISABLE_NATIVE"):
        return _NONE
    cache = aotcache.aot_cache()
    if cache is None:
        path = _target()
        if not path.exists() and _compile(path) is None:
            return _NONE
        lib = _open(path)
        return _NONE if lib is None else (lib, str(path), None)
    try:
        digest, key = entry_key()
    except RuntimeError:
        return _NONE
    entry = cache.get(digest, kind=aotcache.current_kind("native"))
    if entry is None:
        entry = _bake(cache, digest, key)
    if entry is None or not _accepts(entry.lib):
        return _NONE
    aotcache.note_installed(entry)
    return entry.lib, entry.path, digest


def _install(entry) -> bool:
    """Serve the library from a loaded cache entry (the AOT cache's
    preload hands entries here).  Once the library is resolved it stays:
    True only when it is this entry's."""
    global _state
    with _lock:
        if _state is not None:
            return _state[2] == entry.digest
        if os.environ.get("DL4J_TPU_DISABLE_NATIVE") or \
                not _accepts(entry.lib):
            return False
        _state = (entry.lib, entry.path, entry.digest)
    aotcache.note_installed(entry)
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The library (resolved at the first call), or None on the
    fallbacks; a library from the AOT cache notes its use for the
    ladders."""
    global _state
    with _lock:
        if _state is None:
            _state = _resolve()
        lib, _path, digest = _state
    aotcache.note_use(digest)
    return lib


def available() -> bool:
    """True when the C++ runtime is loaded (vs the NumPy fallbacks)."""
    return _load() is not None


def backend() -> str:
    return "native" if available() else "numpy"


def library_path() -> Optional[str]:
    """The loaded library's file, or None on the fallbacks."""
    return _state[1] if available() else None


# ---------------------------------------------------------------- threads

def num_threads() -> int:
    lib = _load()
    return int(lib.dl4j_num_threads()) if lib else 1


def set_num_threads(n: int) -> None:
    lib = _load()
    if lib:
        lib.dl4j_set_num_threads(int(n))


_KERNEL_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_void_p)


def parallel_for(fn, start: int, stop: int, min_chunk: int = 1) -> None:
    """Run ``fn(lo, hi)`` over chunks of [start, stop) on the native pool."""
    lib = _load()
    if lib is None:
        fn(start, stop)
        return
    cb = _KERNEL_FN(lambda lo, hi, _arg: fn(lo, hi))
    lib.dl4j_parallel_for(ctypes.cast(cb, ctypes.c_void_p), None,
                          start, stop, min_chunk)


# ---------------------------------------------------------- compression

def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _require_f32_inplace(grad: np.ndarray, fn: str) -> np.ndarray:
    """In-place residual semantics only work on the caller's own buffer: a
    silent contiguous copy would keep the residual in the copy."""
    if not (isinstance(grad, np.ndarray) and grad.dtype == np.float32
            and grad.flags.c_contiguous):
        raise TypeError(f"{fn} mutates its input in place and requires a "
                        "C-contiguous float32 ndarray; got "
                        f"{type(grad).__name__}"
                        f"{'/' + str(grad.dtype) if isinstance(grad, np.ndarray) else ''}")
    return grad


def threshold_encode(grad: np.ndarray, threshold: float) -> np.ndarray:
    """Sparse-encode ``grad`` in place (residual semantics): int32 signed
    indices ``index+1`` carrying the update's sign."""
    grad = _require_f32_inplace(grad, "threshold_encode")
    lib = _load()
    if lib is None:
        mask = np.abs(grad) >= threshold
        idx = np.nonzero(mask)[0].astype(np.int32)
        signs = np.sign(grad[idx]).astype(np.int32)
        grad[idx] -= signs * np.float32(threshold)
        return (idx.astype(np.int32) + 1) * signs
    cap = lib.dl4j_threshold_count(_f32ptr(grad), grad.size,
                                   ctypes.c_float(threshold))
    out = np.empty(int(cap), dtype=np.int32)
    n = lib.dl4j_threshold_encode(
        _f32ptr(grad), grad.size, ctypes.c_float(threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
    return out[:int(n)]


def threshold_decode(idx: np.ndarray, threshold: float,
                     target: np.ndarray) -> np.ndarray:
    """Apply a sparse message onto ``target`` (float32 vector) in place."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    assert target.dtype == np.float32 and target.flags.c_contiguous
    lib = _load()
    if lib is None:
        pos = np.abs(idx) - 1
        np.add.at(target, pos, np.sign(idx).astype(np.float32)
                  * np.float32(threshold))
        return target
    lib.dl4j_threshold_decode(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), idx.size,
        ctypes.c_float(threshold), _f32ptr(target), target.size)
    return target


def bitmap_encode(grad: np.ndarray, threshold: float
                  ) -> Tuple[np.ndarray, int]:
    """Dense 2-bit encode of ``grad`` in place; (bitmap words, count)."""
    grad = _require_f32_inplace(grad, "bitmap_encode")
    words = np.zeros((grad.size + 15) // 16, dtype=np.uint32)
    lib = _load()
    if lib is None:
        codes = np.where(grad >= threshold, 1,
                         np.where(grad <= -threshold, 2, 0)).astype(np.uint32)
        signs = np.where(codes == 1, 1.0, np.where(codes == 2, -1.0, 0.0))
        grad -= signs.astype(np.float32) * np.float32(threshold)
        idx = np.arange(grad.size)
        np.bitwise_or.at(words, idx >> 4, codes << ((idx & 15) << 1))
        return words, int(np.count_nonzero(codes))
    n = lib.dl4j_bitmap_encode(
        _f32ptr(grad), grad.size, ctypes.c_float(threshold),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return words, int(n)


def bitmap_decode(words: np.ndarray, n: int, threshold: float,
                  target: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    assert target.dtype == np.float32 and target.flags.c_contiguous
    lib = _load()
    if lib is None:
        idx = np.arange(n)
        codes = (words[idx >> 4] >> ((idx & 15) << 1)) & 3
        target += np.where(codes == 1, threshold,
                           np.where(codes == 2, -threshold, 0.0)
                           ).astype(np.float32)
        return target
    lib.dl4j_bitmap_decode(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
        ctypes.c_float(threshold), _f32ptr(target))
    return target


# ------------------------------------------------------------------- rng

def philox_uniform(seed: int, offset: int, n: int) -> np.ndarray:
    """U[0,1) float32 stream addressed by (seed, offset)."""
    out = np.empty(n, dtype=np.float32)
    lib = _load()
    if lib is None:
        # numpy's Philox under the same counter discipline (other values
        # than the native kernel's; determinism is per backend, as in the
        # reference)
        bits = np.random.Philox(key=seed, counter=offset)
        out[:] = np.random.Generator(bits).random(n, dtype=np.float32)
        return out
    lib.dl4j_philox_uniform(seed, offset, _f32ptr(out), n)
    return out


def philox_gaussian(seed: int, offset: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.float32)
    lib = _load()
    if lib is None:
        bits = np.random.Philox(key=seed, counter=offset)
        out[:] = np.random.Generator(bits).standard_normal(n,
                                                           dtype=np.float32)
        return out
    lib.dl4j_philox_gaussian(seed, offset, _f32ptr(out), n)
    return out


# ------------------------------------------------------------- workspace

class Workspace:
    """Host arena allocator with LEARNING-policy growth (reference:
    ``MemoryWorkspace``); ``alloc_f32`` returns a float32 view over arena
    memory valid until the next ``reset``."""

    def __init__(self, initial_bytes: int = 1 << 20):
        self._lib = _load()
        self._arrays = []
        if self._lib is not None:
            self._ptr = self._lib.dl4j_workspace_create(int(initial_bytes))
        else:
            self._ptr = None
            self._capacity = int(initial_bytes)
            self._used = 0
            self._spilled = 0

    def alloc_f32(self, n: int) -> np.ndarray:
        nbytes = int(n) * 4
        if self._lib is not None:
            p = self._lib.dl4j_workspace_alloc(self._ptr, nbytes)
            if not p:
                raise MemoryError(
                    f"workspace alloc of {nbytes} bytes failed")
            buf = (ctypes.c_float * int(n)).from_address(p)
            return np.frombuffer(buf, dtype=np.float32)
        a = np.empty(int(n), dtype=np.float32)
        self._arrays.append(a)
        if self._used + nbytes <= self._capacity:
            self._used += nbytes
        else:
            self._spilled += nbytes
        return a

    def reset(self) -> None:
        if self._lib is not None:
            self._lib.dl4j_workspace_reset(self._ptr)
        else:
            self._arrays.clear()
            if self._spilled:
                self._capacity += self._spilled
            self._used = 0
            self._spilled = 0

    @property
    def capacity(self) -> int:
        if self._lib is not None:
            return int(self._lib.dl4j_workspace_capacity(self._ptr))
        return self._capacity

    @property
    def spilled(self) -> int:
        if self._lib is not None:
            return int(self._lib.dl4j_workspace_spilled(self._ptr))
        return self._spilled

    def close(self) -> None:
        if self._lib is not None and self._ptr:
            self._lib.dl4j_workspace_destroy(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ------------------------------------------------------------------ csv

def csv_parse(text, delim: str = ",", skip_rows: int = 0) -> np.ndarray:
    """Parse numeric delimiter-separated text into a float32 matrix."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    lib = _load()
    if lib is None:
        rows = [ln for ln in text.decode("utf-8").splitlines() if ln.strip()]
        rows = rows[skip_rows:]
        if not rows:
            return np.zeros((0, 0), dtype=np.float32)
        data = [[float(v) for v in ln.split(delim)] for ln in rows]
        return np.asarray(data, dtype=np.float32)
    nrows = lib.dl4j_csv_count_rows(text, len(text)) - skip_rows
    if nrows <= 0:
        return np.zeros((0, 0), dtype=np.float32)
    # columns from the first data line, with the C side's idea of an empty
    # line (it trims ' ' and '\r' only)
    nonempty = [ln for ln in text.split(b"\n") if ln.strip(b" \r")]
    first = nonempty[skip_rows] if len(nonempty) > skip_rows else b""
    ncols = first.count(delim.encode()) + 1
    out = np.empty(int(nrows) * ncols, dtype=np.float32)
    cols = ctypes.c_int32(0)
    got = lib.dl4j_csv_parse_f32(
        text, len(text), ctypes.c_char(delim.encode()), skip_rows,
        _f32ptr(out), out.size, ctypes.byref(cols))
    if got < 0:
        raise ValueError("malformed or ragged numeric CSV")
    return out[:int(got) * cols.value].reshape(int(got), cols.value)
