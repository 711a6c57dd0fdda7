"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source or header is rebuilt; the directory is listed in
``.gitignore``) and loaded with ``ctypes``.  A source that includes
PyTorch's headers takes minutes to compile; a plain C interface takes
seconds, which is why the kernels are bound this way.

A missing ``nvcc`` or a failed build raises.  Nothing here falls back to
the plain PyTorch versions: those run only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "function",
           "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    """The library built from ``src``, named by a hash of the source, every
    header in ``csrc/`` and the flags, so an edit to any of them rebuilds."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet: one ``nvcc`` per source, all started together.  Returns
    ``{name: compiler output}`` for the sources compiled now (with
    ``-Xptxas=-v`` it lists each kernel's registers, shared memory and
    spills); the output is also kept beside each library, as ``.log``.
    Raises if any compile fails."""
    srcs = sorted(CSRC.glob("*.cu")) if names is None \
        else [CSRC / f"{n}.cu" for n in names]
    todo = [(s, _target(s)) for s in srcs if not _target(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = []
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
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(source: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, building and
    loading the library on first use.  Every pointer and the stream must
    be declared ``ctypes.c_void_p`` in ``argtypes`` (an undeclared
    argument is passed as a 32-bit int, which cuts a pointer).  Launch
    entry points return a ``cudaError_t`` as an int."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = _libs[source] = ctypes.CDLL(
                str(_target(CSRC / f"{source}.cu")))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(source: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it).  Each source
    exports ``<source>_error_string`` for the message."""
    if err:
        msg = function(source, f"{source}_error_string", [ctypes.c_int],
                       restype=ctypes.c_char_p)(err)
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({msg.decode()})")
