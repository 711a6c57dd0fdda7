"""The native runtime's kernels as PyTorch custom ops — the port of
``deeplearning4j_tpu/native/xla_ffi.py``.

The reference surfaces four kernels of ``native/src`` inside XLA programs
through the typed FFI, with CPU handlers.  Here they are
``torch.library.custom_op``s, so they take part in any torch program like
a built-in op:

- ``dl4j::threshold_count(grad, threshold)`` — count of
  ``|grad| >= threshold`` (int64 scalar);
- ``dl4j::bitmap_encode(residual, threshold)`` — the 2-bit threshold
  encode with residual semantics: ``(new residual f32[n], bitmap
  u32[ceil(n/16)], count int64)`` (00 skip, 01 +tau, 10 -tau);
- ``dl4j::bitmap_decode(bitmap, threshold, n)`` — the dense delta:
  ``f32[n]`` with +/-threshold at coded positions;
- ``dl4j::philox_uniform(seed, offset, n)`` — U[0,1) float32 draws from
  the native Philox stream, the same (seed, offset) addressing as
  ``native.philox_uniform``; a CPU tensor, as the reference's CPU handler
  gives.

On CPU tensors each op calls the port's native library (the reference's
handlers call the same C functions); where that library cannot be built
the ops raise, as the reference's ``philox_uniform`` does.
``bitmap_encode`` / ``bitmap_decode`` also run on CUDA tensors, as torch
ops: the reference's own off-CPU lowering, bit for bit (no TPU kernel
stands behind them).  The parallel layer's gradient sharing calls
them (``parallel.gradientsharing.EncodedGradientsAccumulator.encodeBitmap``).
"""
from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import native

__all__ = ["register", "threshold_count", "bitmap_encode", "bitmap_decode",
           "philox_uniform"]


def _lib():
    lib = native._load()
    if lib is None:
        raise RuntimeError("the native library is unavailable (no C++ "
                           "compiler, or DL4J_TPU_DISABLE_NATIVE set): the "
                           "dl4j custom ops cannot run")
    return lib


def _ptr(t: torch.Tensor, ctype):
    return ctypes.cast(ctypes.c_void_p(t.data_ptr()),
                       ctypes.POINTER(ctype))


def _words(n: int) -> int:
    return (int(n) + 15) // 16


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).reshape(-1).contiguous()


# ------------------------------------------------------------ the ops

@torch.library.custom_op("dl4j::threshold_count", mutates_args=(),
                         device_types="cpu")
def _threshold_count(grad: torch.Tensor, threshold: float) -> torch.Tensor:
    g = _f32(grad)
    n = _lib().dl4j_threshold_count(_ptr(g, ctypes.c_float), g.numel(),
                                    ctypes.c_float(threshold))
    return torch.tensor(int(n), dtype=torch.int64)


@_threshold_count.register_fake
def _(grad, threshold):
    return grad.new_empty((), dtype=torch.int64)


@torch.library.custom_op("dl4j::bitmap_encode", mutates_args=(),
                         device_types="cpu")
def _bitmap_encode(residual: torch.Tensor, threshold: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # the encode works in place: it runs on a copy, as the reference's
    # handler copies the residual into its output buffer
    r = _f32(residual).clone()
    words = torch.zeros(_words(r.numel()), dtype=torch.int32)
    n = _lib().dl4j_bitmap_encode(_ptr(r, ctypes.c_float), r.numel(),
                                  ctypes.c_float(threshold),
                                  _ptr(words, ctypes.c_uint32))
    return r, words.view(torch.uint32), torch.tensor(int(n),
                                                     dtype=torch.int64)


@_bitmap_encode.register_kernel("cuda")
def _bitmap_encode_cuda(residual, threshold):
    """The reference's pure-XLA lowering (``xla_ffi.py:126-139``) in torch
    ops, operation for operation."""
    r = _f32(residual)
    n = r.numel()
    tau = torch.tensor(threshold, dtype=torch.float32, device=r.device)
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    pos = r >= tau
    neg = r <= -tau
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.int64)
    new_r = r - torch.where(pos, tau, zero) + torch.where(neg, tau, zero)
    pad = _words(n) * 16 - n
    cp = torch.nn.functional.pad(codes, (0, pad)).reshape(_words(n), 16)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=r.device)
    w = (cp << shifts).sum(dim=1)           # disjoint bits: a sum is an OR
    # the words as uint32: reinterpret the low 32 bits through int32
    w32 = torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    count = (pos | neg).sum().to(torch.int64)
    return new_r, w32.view(torch.uint32), count


@_bitmap_encode.register_fake
def _(residual, threshold):
    n = residual.numel()
    return (residual.new_empty((n,), dtype=torch.float32),
            residual.new_empty((_words(n),), dtype=torch.uint32),
            residual.new_empty((), dtype=torch.int64))


@torch.library.custom_op("dl4j::bitmap_decode", mutates_args=(),
                         device_types="cpu")
def _bitmap_decode(bitmap: torch.Tensor, threshold: float, n: int
                   ) -> torch.Tensor:
    words = bitmap.detach().reshape(-1).contiguous()
    if words.numel() * 16 < n:
        raise ValueError("bitmap buffer too small")
    out = torch.zeros(int(n), dtype=torch.float32)
    _lib().dl4j_bitmap_decode(_ptr(words, ctypes.c_uint32), int(n),
                              ctypes.c_float(threshold),
                              _ptr(out, ctypes.c_float))
    return out


@_bitmap_decode.register_kernel("cuda")
def _bitmap_decode_cuda(bitmap, threshold, n):
    """The reference's pure-XLA lowering (``xla_ffi.py:153-158``) in
    torch ops."""
    words = bitmap.detach().reshape(-1)
    if words.numel() * 16 < n:
        raise ValueError("bitmap buffer too small")
    w = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=w.device)
    codes = ((w[:, None] >> shifts) & 3).reshape(-1)[:int(n)]
    tau = torch.tensor(threshold, dtype=torch.float32, device=w.device)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    return torch.where(codes == 1, tau, torch.where(codes == 2, -tau, zero))


@_bitmap_decode.register_fake
def _(bitmap, threshold, n):
    return bitmap.new_empty((int(n),), dtype=torch.float32)


@torch.library.custom_op("dl4j::philox_uniform", mutates_args=())
def _philox_uniform(seed: int, offset: int, n: int) -> torch.Tensor:
    out = torch.empty(int(n), dtype=torch.float32)
    _lib().dl4j_philox_uniform(seed, offset, _ptr(out, ctypes.c_float),
                               int(n))
    return out


@_philox_uniform.register_fake
def _(seed, offset, n):
    return torch.empty(int(n), dtype=torch.float32, device="meta")


# ------------------------------------------------- the reference's API

def register() -> bool:
    """Whether the ops' native library is available (the ops themselves
    are registered when this module is imported)."""
    return native.available()


def _tensor(x, dtype=None) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x,
                                                                 dtype=dtype)


def threshold_count(grad, threshold: float) -> torch.Tensor:
    """Count of ``|grad| >= threshold`` as a torch op (int64 scalar)."""
    return torch.ops.dl4j.threshold_count(_tensor(grad, torch.float32),
                                          float(threshold))


def bitmap_encode(residual, threshold: float):
    """Threshold + bitmap encode: residual f32[n] -> (new residual f32[n],
    bitmap u32[ceil(n/16)], count int64) — the native kernel on the CPU,
    the reference's lowering on CUDA."""
    return torch.ops.dl4j.bitmap_encode(_tensor(residual, torch.float32),
                                        float(threshold))


def bitmap_decode(bitmap, threshold: float, n: int) -> torch.Tensor:
    """Bitmap words -> f32[n] with +/-threshold at coded positions."""
    if not isinstance(bitmap, torch.Tensor):
        import numpy as np
        bitmap = torch.from_numpy(
            np.ascontiguousarray(bitmap, dtype=np.uint32).view(np.int32)
        ).view(torch.uint32)
    return torch.ops.dl4j.bitmap_decode(bitmap, float(threshold), int(n))


def philox_uniform(seed: int, offset: int, n: int) -> torch.Tensor:
    """U[0,1) draws from the native Philox stream (a CPU tensor), the same
    (seed, offset) addressing as ``native.philox_uniform``."""
    return torch.ops.dl4j.philox_uniform(int(seed), int(offset), int(n))
