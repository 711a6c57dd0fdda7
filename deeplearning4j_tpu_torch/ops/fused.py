"""Matrix product with the BatchNorm batch statistics in its epilogue — the
port of ``deeplearning4j_tpu/ops/pallas_fused.py``.

``matmul_bn_stats(x, w)`` returns ``(y, s, ss)``: ``y = x @ w`` in x's dtype
and, per output column (per channel when a 1x1 convolution is written as a
GEMM over NHWC rows), ``s = Σ y`` and ``ss = Σ y²`` of the unrounded f32
product, so that BatchNorm's mean ``s/M`` and biased variance ``ss/M −
mean²`` never read y again.  A CUDA tensor launches the hand-written Hopper
kernel ``csrc/matmul_bn_stats.cu`` (adding one to
``matmul_bn_stats.launches``) on the layout of :func:`_mm_layout`, or
raises; a CPU tensor runs :func:`matmul_bn_stats_plain`.  Nothing in the
port dispatches it: as in the reference, whose measured verdict on the TPU
was negative, no layer calls it.

The reference's TPU-only arguments are not carried over: ``block_m`` and
``block_n`` (the kernel picks its own tiles, and TMA reads zeros past the
ragged ones, so M and N need not be multiples of anything) and
``interpret`` (the CPU path is the plain version).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from deeplearning4j_tpu_torch import kernels

__all__ = ["matmul_bn_stats", "matmul_bn_stats_plain",
           "matmul_bn_stats_reference", "conv1x1_bn_stats"]


def matmul_bn_stats_plain(x, w):
    """What the kernel computes, in plain PyTorch: the product accumulated
    in f32 (bf16 products are exact in f32), y rounded once to x's dtype,
    and the sums of the unrounded f32 product."""
    y32 = torch.matmul(x.float(), w.float())
    return y32.to(x.dtype), y32.sum(dim=0), (y32 * y32).sum(dim=0)


def matmul_bn_stats_reference(x, w):
    """The reference's unfused function (``pallas_fused.py:53``): the
    product in x's dtype, then a second pass over y for the statistics.
    For bf16 it differs from the kernel: its sums are of y rounded to
    bf16."""
    y = torch.matmul(x, w)
    yf = y.float()
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return kernels.function("matmul_bn_stats", "matmul_bn_stats",
                            [p, p, p, p, p, p, i, i, i, i, p])


@functools.lru_cache(maxsize=64)
def _scratch_floats(m, k, n, is_bf16):
    """f32 elements of the kernel's scratch for x (m, k), w (k, n) on the
    layout of :func:`_mm_layout`: the partial sums, then (float32) wᵀ's
    split."""
    i = ctypes.c_int
    part = kernels.function("matmul_bn_stats",
                            "matmul_bn_stats_scratch_floats", [i, i],
                            restype=ctypes.c_longlong)
    split = kernels.function("matmul_bn_stats",
                             "matmul_bn_stats_split_floats", [i, i, i],
                             restype=ctypes.c_longlong)
    return part(m, n) + split(k, n, is_bf16)



def _mm_layout(x, w):
    """The layout the kernel's TMA tensor maps take: x (M, K) and w (K, N)
    of one dtype -> ``(xp (M, Kp), wp (Kp, Np))``, contiguous, 16-byte
    aligned, with rows of Kp·elem and Np·elem bytes, multiples of 16.  An
    operand that already is so is passed as it is; any other is copied into
    a fresh tensor whose rows and columns past the originals' are zero.
    Zero columns of x meet zero rows of w and add nothing to y; zero columns
    of w give columns of y, s and ss that :func:`_mm_unpad` slices off.  A
    layout step, like ``.contiguous()``: the values are unchanged."""
    per = 16 // x.element_size()
    m, k = x.shape
    n = w.shape[1]
    kp, np_ = -(-k // per) * per, -(-n // per) * per

    def fit(a, rows, cols):
        if a.shape == (rows, cols) and a.is_contiguous() \
                and a.data_ptr() % 16 == 0:
            return a
        out = a.new_zeros((rows, cols))
        out[:a.shape[0], :a.shape[1]] = a
        return out
    return fit(x, m, kp), fit(w, kp, np_)


def _mm_unpad(y, s, ss, n):
    """The kernel's outputs on the layout of :func:`_mm_layout`, (M, Np) and
    (Np,) -> (M, N) and (N,): the columns past n are sliced off."""
    if y.shape[1] == n:
        return y, s, ss
    return y[:, :n].contiguous(), s[:n].contiguous(), ss[:n].contiguous()


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("matmul_bn_stats takes x (M, K) and w (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("matmul_bn_stats takes float32 or bfloat16 x and w "
                        f"of one dtype; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    if min(x.shape[0], x.shape[1], w.shape[1]) == 0 \
            or max(x.shape[0], x.shape[1], w.shape[1]) > 2 ** 31 - 1:
        raise ValueError(f"matmul_bn_stats takes 0 < M, K, N < 2**31; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")


def matmul_bn_stats(x, w):
    """``y = x @ w`` (M, N) in x's dtype, plus per-column ``(Σy, Σy²)`` of
    the f32 product, each (N,) float32.  x (M, K) and w (K, N) are float32
    or bfloat16, of one dtype, on one device."""
    _check(x, w)
    if x.device.type == "cpu":
        return matmul_bn_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_bn_stats runs on cuda or cpu, not "
                         f"{x.device.type}")
    n = w.shape[1]
    x, w = _mm_layout(x, w)
    m, k = x.shape
    np_ = w.shape[1]
    bf16 = int(x.dtype == torch.bfloat16)
    y = torch.empty((m, np_), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, np_), dtype=torch.float32, device=x.device)
    scratch = torch.empty((_scratch_floats(m, k, np_, bf16),),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # PyTorch's raw accessor (CUDA builds; its compiled kernels use it)
        # takes a few hundred ns, a torch.cuda.Stream a few microseconds.
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        err = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                        stats[0].data_ptr(), stats[1].data_ptr(),
                        scratch.data_ptr(), m, k, np_, bf16, stream)
    kernels.check("matmul_bn_stats", err, "matmul_bn_stats launch")
    matmul_bn_stats.launches += 1
    return _mm_unpad(y, stats[0], stats[1], n)


matmul_bn_stats.launches = 0


def conv1x1_bn_stats(x_nhwc, w):
    """1x1 stride-1 convolution plus the BN statistics through the fused
    GEMM: x (N, H, W, Cin), w (Cin, Cout) -> (y (N, H, W, Cout), s (Cout,),
    ss (Cout,))."""
    n, h, w_, cin = x_nhwc.shape
    cout = w.shape[1]
    y, s, ss = matmul_bn_stats(x_nhwc.reshape(n * h * w_, cin), w)
    return y.reshape(n, h, w_, cout), s, ss
