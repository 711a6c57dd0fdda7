"""Attention implementations and their dispatch — the port of the attention
half of ``deeplearning4j_tpu/parallel/ring.py``.

Three implementations of softmax(QKᵀ/√d)·V, one semantics:

- :func:`dot_product_attention` ``impl="dense"`` — the materialised softmax,
  the reference semantics;
- :func:`blockwise_attention` — online softmax over K/V blocks in plain
  PyTorch: O(T) memory, exact;
- :func:`flash_attention` — the hand-written Hopper kernel
  ``csrc/flash_attn_fwd.cu`` (the port of the TPU kernel ``_flash_kernel``)
  for CUDA tensors, and its plain version :func:`flash_attention_reference`
  for CPU tensors.  It is differentiable through :class:`FlashAttention`,
  whose backward runs the dq and dk/dv kernels ``csrc/flash_attn_bwd_dq.cu``
  and ``csrc/flash_attn_bwd_dkv.cu`` (the ports of ``_flash_bwd_dq_kernel``
  and ``_flash_bwd_dkv_kernel``), or their plain versions on the CPU.

Ring attention (:func:`ring_attention`, :func:`context_parallel_attention`)
splits the time axis over the mesh's ``seq`` ranks: unmasked, each K/V
block a rank holds runs B1 forward and B2/B3 backward against the global
softmax; masked, the reference's plain block update.  K/V travel one hop
a block (``parallel.mesh.ring_exchange``).

Layout is (batch, heads, time, head_dim) throughout.  Masks are (batch,
t_k) with 1 = valid key.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from deeplearning4j_tpu_torch import kernels

__all__ = ["blockwise_attention", "flash_attention", "flash_forward",
           "ring_attention", "context_parallel_attention",
           "flash_attention_reference", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "FlashAttention", "dot_product_attention"]

_NEG = -1e30  # additive-mask floor; avoids -inf NaN paths in exp/grad


def _scale(q) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def _block_update(q, k, v, o, l, m, bias):
    """One online-softmax accumulation step over a K/V block.

    q: (..., tq, d); k/v: (..., tk, d); o: (..., tq, d) f32;
    l/m: (..., tq, 1) f32; bias: broadcastable to (..., tq, tk) additive.
    Scores accumulate in f32 from the storage dtype; p is rounded to v's
    dtype before the second product, as the flash kernels do.
    """
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * _scale(q)
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    o = o * corr + torch.einsum("...qk,...kd->...qd",
                                p.to(v.dtype).float(), v.float())
    return o, l, m_new


def _finish(o, l):
    return o / l.clamp_min(1e-30)


def _mask_bias(mask, dtype=torch.float32):
    """(b, tk) 1=valid → additive (b, 1, 1, tk)."""
    if mask is None:
        return None
    m = mask.bool()[:, None, None, :]
    return torch.where(m, 0.0, _NEG).to(dtype)


def _init_state(q):
    b, h, tq, d = q.shape
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq, 1), _NEG, dtype=torch.float32, device=q.device)
    return o, l, m


def blockwise_attention(q, k, v, mask=None, causal: bool = False,
                        block_k: int = 512):
    """Memory-efficient attention: a loop over K/V blocks with an online
    softmax — never materialises the (tq, tk) score matrix beyond one
    block.  Exact (not approximate) w.r.t. dense softmax attention.

    q/k/v: (b, h, t, d); mask: (b, tk) 1=valid; returns (b, h, tq, d) in
    q.dtype.  A ragged last block is zero-padded and masked out.
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    block_k = min(block_k, tk)
    nblocks = -(-tk // block_k)
    pad = nblocks * block_k - tk
    kmask = torch.ones((b, tk), dtype=torch.bool, device=q.device) \
        if mask is None else mask.bool()
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        kmask = torch.nn.functional.pad(kmask, (0, pad))

    kbias = _mask_bias(kmask)
    q_pos = torch.arange(tq, device=q.device)[:, None]
    o, l, m = _init_state(q)
    for ki in range(nblocks):
        sl = slice(ki * block_k, (ki + 1) * block_k)
        bias = kbias[..., sl]
        if causal:
            k_pos = ki * block_k + torch.arange(block_k,
                                                device=q.device)[None, :]
            bias = bias + torch.where(k_pos <= q_pos, 0.0, _NEG)
        o, l, m = _block_update(q, k[:, :, sl], v[:, :, sl], o, l, m, bias)
    return _finish(o, l).to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention: the Hopper kernel and its plain version
# ---------------------------------------------------------------------------

_FLASH_BLOCK = 64   # the plain versions' key (and query) block
_FLASH_DTYPES = (torch.float32, torch.bfloat16)
_FLASH_MIN_T = 1024  # auto dispatch: flash from this many queries on


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain PyTorch version of the flash kernel: online softmax over
    64-key blocks with f32 accumulators.  q/k/v: (b, h, t, d) ->
    ``(out (b, h, tq, d) in q's dtype, lse (b·h, tq) f32)``.

    Causal is top-left aligned (key ``j`` visible to query ``i`` iff
    ``j <= i``); blocks wholly in the future of every query are skipped,
    which changes nothing (they would add p = 0)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    q_pos = torch.arange(tq, device=q.device)[:, None]
    o, l, m = _init_state(q)
    for k0 in range(0, tk, _FLASH_BLOCK):
        if causal and k0 > tq - 1:
            break
        kb = k[:, :, k0:k0 + _FLASH_BLOCK]
        bias = None
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            bias = torch.where(k_pos <= q_pos, 0.0, _NEG)
        o, l, m = _block_update(q, kb, v[:, :, k0:k0 + _FLASH_BLOCK],
                                o, l, m, bias)
    l_fin = l.clamp_min(1e-30)
    out = (o / l_fin).to(q.dtype)
    lse = (m + torch.log(l_fin)).reshape(b * h, tq)
    return out, lse


@functools.cache
def _flash_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return kernels.function(
        "flash_attn_fwd", "flash_attn_fwd",
        [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p])


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")


def _flash_refusal(q_shape, k_shape, v_shape, dtypes):
    """Why the flash kernels (B1-B3) refuse operands of these shapes and
    dtypes: ``(exception type, message)``, or None where every one of them
    takes q (b, h, tq, d) and k, v (b, h, tk, d) of one dtype.  A pure
    function of shapes and dtypes, shared by :func:`_check_flash_inputs`
    and :func:`_auto_impl` so that the auto dispatch never picks a shape the
    kernels refuse."""
    q_shape, k_shape = tuple(q_shape), tuple(k_shape)
    if len(q_shape) != 4 or len(k_shape) != 4 \
            or k_shape != tuple(v_shape) or q_shape[:2] != k_shape[:2] \
            or q_shape[3] != k_shape[3]:
        return ValueError, (
            "flash_attention takes q (b, h, tq, d) and k, v (b, h, tk, d); "
            f"got {q_shape}, {k_shape}, {tuple(v_shape)}")
    if len(set(dtypes)) != 1 or dtypes[0] not in _FLASH_DTYPES:
        return TypeError, ("flash_attention takes float32 or bfloat16 q, k, "
                           f"v of one dtype; got {', '.join(map(str, dtypes))}")
    b, h, tq, d = q_shape
    if not 0 < d <= 128 or tq == 0 or k_shape[2] == 0 or b * h == 0 \
            or b * h > 65535:
        return ValueError, (f"flash_attention kernel takes 0 < d <= 128, "
                            f"non-empty t and 0 < b·h <= 65535; got "
                            f"q {q_shape}, k {k_shape}")
    return None


def _check_flash_inputs(q, k, v):
    refusal = _flash_refusal(q.shape, k.shape, v.shape,
                             (q.dtype, k.dtype, v.dtype))
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _flash_layout(*xs):
    """The layout the flash kernels' TMA tensor maps take: operands (b, h,
    t, d) of one dtype (q, k, v, and dO for the backward) -> ``(*xs,
    dp)``, contiguous (b, h, t, dp) operands whose rows are dp·elem bytes,
    a multiple of 16, and whose data is 16-byte aligned.  An operand that
    already is so is passed as it is; any other is copied into a fresh
    tensor whose columns d..dp are zero.  Zero columns of Q and K add
    nothing to S, nor those of dO and V to dP; those of V, K and Q give
    columns of O, dq, dk and dv that the caller slices off.  A layout step,
    like ``.contiguous()``: the values and the scale (of the unpadded d)
    are unchanged."""
    d = xs[0].shape[3]
    per = 16 // xs[0].element_size()
    dp = -(-d // per) * per

    def fit(x):
        if dp == d and x.is_contiguous() and x.data_ptr() % 16 == 0:
            return x
        out = x.new_zeros((*x.shape[:3], dp))
        out[..., :d] = x
        return out
    return (*(fit(x) for x in xs), dp)


def _unpad(x, shape):
    """A kernel's output, (b, h, t, dp) or (b·h, t, dp) -> (b, h, t, d) of
    ``shape``: the columns past d that :func:`_flash_layout` added are
    sliced off."""
    x = x.reshape(*shape[:3], x.shape[-1])
    return x if x.shape[-1] == shape[3] else x[..., :shape[3]].contiguous()


def flash_forward(q, k, v, causal: bool = False):
    """Flash attention forward: q/k/v (b, h, t, d) -> ``(out (b, h, tq, d)
    in q's dtype, lse (b·h, tq) f32)``.

    A CUDA tensor launches ``csrc/flash_attn_fwd.cu`` (adding one to
    ``flash_attention.launches``) on the layout of :func:`_flash_layout`,
    with the scale of the unpadded d, or raises: build and launch failures
    are never caught.  A CPU tensor runs :func:`flash_attention_reference`.
    Not differentiable itself: :func:`flash_attention` wraps it in
    :class:`FlashAttention`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _check_cuda(q)
    _check_flash_inputs(q, k, v)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    qf, kf, vf, dp = _flash_layout(q, k, v)
    out = torch.empty_like(qf)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_kernel()(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, dp, int(causal),
            int(q.dtype == torch.bfloat16), _scale(q), stream)
    kernels.check("flash_attn_fwd", err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return _unpad(out, q.shape), lse


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention: q/k/v (b, h, t, d) -> (b, h, tq, d) in q's dtype.

    CUDA tensors go through the Hopper kernels (any tq, tk; d <= 128;
    float32 or bfloat16), CPU tensors through their plain versions — see
    :func:`flash_forward`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`.
    Differentiable: the backward is :class:`FlashAttention`'s.
    ``flash_attention.launches`` counts forward-kernel launches (CPU calls
    do not count)."""
    return FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# flash backward: the dq and dk/dv kernels and their plain versions
# ---------------------------------------------------------------------------

def _p_ds(q, k, v, do, lse, delta, q0, k0, causal):
    """p and ds of one (q block, k block) pair, as the TPU backward kernels
    recompute them: q/do (b, h, bq, d), k/v (b, h, bk, d) in the storage
    dtype; lse/delta (b, h, bq, 1) f32; q0/k0 the blocks' first positions.
    Products accumulate in f32; returns f32 ``(p, ds)`` of (b, h, bq, bk)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * _scale(q)
    if causal:
        q_pos = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = k0 + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, _NEG)
    p = torch.exp(s - lse)
    dp = torch.einsum("...qd,...kd->...qk", do.float(), v.float())
    return p, p * (dp - delta) * _scale(q)


def _rows(x, q):
    """(b·h, tq) f32 -> (b, h, tq, 1), the layout :func:`_p_ds` takes."""
    b, h, tq, _ = q.shape
    return x.reshape(b, h, tq, 1)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = False):
    """Plain PyTorch version of the dq kernel: a loop over 64-key blocks,
    ``dq += ds·K`` with ds rounded to K's dtype, f32 accumulator.
    q/do (b, h, tq, d), k/v (b, h, tk, d) of one dtype; lse/delta (b·h,
    tq) f32 -> dq (b, h, tq, d) in q's dtype.  Causal key blocks wholly in
    the future of every query are skipped (they would add ds = 0)."""
    tq, tk = q.shape[2], k.shape[2]
    lse4, delta4 = _rows(lse, q), _rows(delta, q)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, tk, _FLASH_BLOCK):
        if causal and k0 > tq - 1:
            break
        kb = k[:, :, k0:k0 + _FLASH_BLOCK]
        _, ds = _p_ds(q, kb, v[:, :, k0:k0 + _FLASH_BLOCK], do, lse4,
                      delta4, 0, k0, causal)
        acc += torch.einsum("...qk,...kd->...qd", ds.to(k.dtype).float(),
                            kb.float())
    return acc.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False):
    """Plain PyTorch version of the dk/dv kernel: a loop over 64-row query
    blocks, ``dv += pᵀ·dO`` with p rounded to dO's dtype and ``dk +=
    dsᵀ·Q`` with ds rounded to Q's dtype, f32 accumulators.  Shapes as
    :func:`flash_bwd_dq_reference` -> ``(dk, dv)`` (b, h, tk, d) in k's and
    v's dtype."""
    tq = q.shape[2]
    lse4, delta4 = _rows(lse, q), _rows(delta, q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, tq, _FLASH_BLOCK):
        sl = slice(q0, q0 + _FLASH_BLOCK)
        qb, dob = q[:, :, sl], do[:, :, sl]
        p, ds = _p_ds(qb, k, v, dob, lse4[:, :, sl], delta4[:, :, sl], q0,
                      0, causal)
        dv += torch.einsum("...qk,...qd->...kd", p.to(do.dtype).float(),
                           dob.float())
        dk += torch.einsum("...qk,...qd->...kd", ds.to(q.dtype).float(),
                           qb.float())
    return dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _bwd_kernel(name: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    outs = [p] if name == "flash_attn_bwd_dq" else [p, p]
    return kernels.function(
        name, name, [p] * 6 + outs + [i] * 6 + [ctypes.c_float, p])


def _bwd_operands(q, k, v, do, lse, delta):
    """Check what the backward kernels take and lay it out for them: q, k,
    v and dO as :func:`_flash_layout` pads them, flattened to contiguous
    (b·h, t, dp); lse and delta contiguous (b·h, tq) f32."""
    _check_cuda(q)
    _check_flash_inputs(q, k, v)
    b, h, tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: got {tuple(do.shape)} "
                         f"{do.dtype} on {do.device}, q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b * h, tq) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError(f"{name} must be ({b * h}, {tq}) float32 on "
                             f"{q.device}; got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    *padded, dp = _flash_layout(q, k, v, do)
    flat = [x.reshape(b * h, x.shape[2], dp) for x in padded]
    return (*flat, lse.contiguous(), delta.contiguous())


def _launch_bwd(name, q, operands, outs, causal):
    """Launch a backward kernel on operands laid out by
    :func:`_bwd_operands`, with the scale of q's unpadded d."""
    b, h, tq, _ = q.shape
    _, tk, dp = operands[1].shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel(name)(
            *(x.data_ptr() for x in operands), *(o.data_ptr() for o in outs),
            b * h, tq, tk, dp, int(causal), int(q.dtype == torch.bfloat16),
            _scale(q), stream)
    kernels.check(name, err, f"{name} launch")


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """Flash backward, dq pass: q/do (b, h, tq, d), k/v (b, h, tk, d) of
    one dtype, lse (the forward's) and delta = rowsum(dO⊙O) (b·h, tq) f32
    -> dq (b, h, tq, d) in q's dtype.

    A CUDA tensor launches ``csrc/flash_attn_bwd_dq.cu`` (adding one to
    ``flash_bwd_dq.launches``) on the layout of :func:`_flash_layout`,
    with the scale of the unpadded d, or raises; a CPU tensor runs
    :func:`flash_bwd_dq_reference`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    ops = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(ops[0])
    _launch_bwd("flash_attn_bwd_dq", q, ops, [dq], causal)
    flash_bwd_dq.launches += 1
    return _unpad(dq, q.shape)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """Flash backward, dk/dv pass: arguments as :func:`flash_bwd_dq` ->
    ``(dk, dv)`` (b, h, tk, d) in k's and v's dtype.

    A CUDA tensor launches ``csrc/flash_attn_bwd_dkv.cu`` (adding one to
    ``flash_bwd_dkv.launches``) on the layout of :func:`_flash_layout`,
    with the scale of the unpadded d, or raises; a CPU tensor runs
    :func:`flash_bwd_dkv_reference`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    ops = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    _launch_bwd("flash_attn_bwd_dkv", q, ops, [dk, dv], causal)
    flash_bwd_dkv.launches += 1
    return _unpad(dk, k.shape), _unpad(dv, v.shape)


flash_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward — the counterpart of the
    reference's ``_flash`` ``custom_vjp`` (``ring.py:312-336``).

    The forward (:func:`flash_forward`) saves q, k, v, O and the per-row
    logsumexp; the backward computes delta = rowsum(dO⊙O) in f32 as a plain
    op (as the reference does outside Pallas), then dq
    (:func:`flash_bwd_dq`) and dk/dv (:func:`flash_bwd_dkv`) from p
    recomputed block by block: no (tq, tk) residual is stored."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, tq, _ = q.shape
        delta = (g.float() * out.float()).sum(-1).reshape(b * h, tq)
        do = g.to(q.dtype)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# ring attention (sequence/context parallel)
# ---------------------------------------------------------------------------

def _ring_plan(mesh_or_group, axis_name="seq"):
    """``(group, size, index)`` of the ring: a DeviceMesh's ``axis_name``
    sub-group, or a process group (None: a ring of one)."""
    import torch.distributed as dist
    if hasattr(mesh_or_group, "axisSize"):
        return (mesh_or_group.group(axis_name),
                mesh_or_group.axisSize(axis_name),
                mesh_or_group.coords[axis_name])
    if mesh_or_group is None:
        return None, 1, 0
    return (mesh_or_group, dist.get_world_size(mesh_or_group),
            dist.get_rank(mesh_or_group))


def _hop(group, *ts):
    from deeplearning4j_tpu_torch.parallel.mesh import ring_exchange
    return ring_exchange(list(ts), group)


def _block_bias(mm, causal, q0, k0, tq, tk, device):
    """The additive bias of one masked ring block: the key mask of the
    held block, plus the causal mask at the blocks' global positions."""
    bias = None if mm is None else _mask_bias(mm)
    if causal:
        q_pos = q0 + torch.arange(tq, device=device)[:, None]
        k_pos = k0 + torch.arange(tk, device=device)[None, :]
        cb = torch.where(k_pos <= q_pos, 0.0, _NEG)
        bias = cb if bias is None else bias + cb
    return bias


def _ring_forward(q, k, v, mask, causal, group, n, me):
    """The ring's forward over local chunks q/k/v (b, h, t, d) (mask: the
    local keys' (b, t) or None).  Unmasked, each held K/V block runs the
    flash forward (B1 on CUDA, its plain version on the CPU): the diagonal
    block with B1's top-left causal mask, a block wholly in the future
    skipped, any other block unmasked; each block's (O, lse) merges into
    the running output by log-sum-exp.  Masked, every block takes the
    reference's plain online-softmax update.  Returns ``(out, saved)``:
    out in q's dtype, and what the backward needs (the global lse, or
    the running max and sum of the masked path)."""
    b, h, t, d = q.shape
    kk, vv, mm = k, v, mask
    if mask is None:
        o = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, t, 1), float("-inf"), dtype=torch.float32,
                         device=q.device)
    else:
        o, l, m = _init_state(q)
    for i in range(n):
        src = (me - i) % n
        if mask is None:
            if not (causal and src > me):
                ob, lb = flash_forward(q, kk, vv, causal and src == me)
                lb = lb.reshape(b, h, t, 1)
                new = torch.logaddexp(lse, lb)
                o = o * torch.exp(lse - new) + ob.float() * torch.exp(lb - new)
                lse = new
        else:
            bias = _block_bias(mm, causal, me * t, src * t, t, t, q.device)
            o, l, m = _block_update(q, kk, vv, o, l, m, bias)
        if i != n - 1:
            kk, vv, *rest = _hop(group, kk, vv,
                                 *(() if mm is None else (mm,)))
            mm = rest[0] if rest else None
    if mask is None:
        return o.to(q.dtype), (lse.reshape(b * h, t),)
    return _finish(o, l).to(q.dtype), (m, l)


def _ring_backward(q, k, v, mask, out, saved, g, causal, group, n, me):
    """The ring's backward: each block's dq, dk, dv from p recomputed
    against the GLOBAL softmax (the forward's lse, or its running max and
    sum) and delta = rowsum(dO·O), so each is exact; dq accumulates here,
    dk and dv travel with their K/V block around the ring and take one
    more hop home.  Unmasked blocks run B2 and B3 (their plain versions on
    the CPU), masked ones plain products."""
    b, h, t, d = q.shape
    delta = (g.float() * out.float()).sum(-1)
    do = g.to(q.dtype)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((b, h, t, d), **f32)
    dk = torch.zeros(k.shape, **f32)
    dv = torch.zeros(v.shape, **f32)
    kk, vv, mm = k, v, mask
    for i in range(n):
        src = (me - i) % n
        if mask is None:
            if not (causal and src > me):
                c = causal and src == me
                lse, dl = saved[0], delta.reshape(b * h, t)
                dq += flash_bwd_dq(q, kk, vv, do, lse, dl, c).float()
                dkb, dvb = flash_bwd_dkv(q, kk, vv, do, lse, dl, c)
                dk += dkb.float()
                dv += dvb.float()
        else:
            m, l = saved
            bias = _block_bias(mm, causal, me * t, src * t, t, t, q.device)
            s = torch.einsum("...qd,...kd->...qk", q.float(),
                             kk.float()) * _scale(q)
            if bias is not None:
                s = s + bias
            p = torch.exp(s - m) / l.clamp_min(1e-30)
            dp = torch.einsum("...qd,...kd->...qk", do.float(), vv.float())
            ds = p * (dp - delta[..., None]) * _scale(q)
            dq += torch.einsum("...qk,...kd->...qd", ds, kk.float())
            dk += torch.einsum("...qk,...qd->...kd", ds, q.float())
            dv += torch.einsum("...qk,...qd->...kd", p, do.float())
        if i != n - 1:
            kk, vv, dk, dv, *rest = _hop(group, kk, vv, dk, dv,
                                         *(() if mm is None else (mm,)))
            mm = rest[0] if rest else None
    if n > 1:
        dk, dv = _hop(group, dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_ring(q, k, v, causal):
    if q.shape[2] != k.shape[2] and causal:
        raise ValueError("causal ring attention takes q and k of one local "
                         f"length; got {q.shape[2]} and {k.shape[2]}")


class _Ring(torch.autograd.Function):
    """Ring attention over local chunks, forward and backward
    (:func:`_ring_forward`, :func:`_ring_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, group, n, me):
        _check_ring(q, k, v, causal)
        out, saved = _ring_forward(q, k, v, mask, causal, group, n, me)
        ctx.save_for_backward(q, k, v, out, *saved)
        ctx.args = (mask, causal, group, n, me)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, *saved = ctx.saved_tensors
        mask, causal, group, n, me = ctx.args
        return (*_ring_backward(q, k, v, mask, out, saved, g, causal, group,
                                n, me), None, None, None, None, None)


def ring_attention(q, k, v, axis_name="seq", axis_size: int = None,
                   mask=None, causal: bool = False, group=None):
    """Exact attention with Q/K/V sharded on time over a ring of ranks.

    q/k/v: this rank's (b, h, t_local, d) chunks; mask: (b, t_local) for
    the LOCAL key block.  ``group`` is the ring's process group (the
    mesh's seq sub-group); ``axis_name`` and ``axis_size`` are the
    reference's names and are read from the group here.  Each of the
    ring's steps updates the local output with the held K/V block, then
    hands K/V one hop on (:func:`~deeplearning4j_tpu_torch.parallel.mesh.
    ring_exchange`); differentiable (:class:`_Ring`)."""
    g, n, me = _ring_plan(group)
    if axis_size is not None and axis_size != n:
        raise ValueError(f"axis_size {axis_size} != the group's {n} ranks")
    return _Ring.apply(q, k, v, mask, causal, g, n, me)


class _ContextParallel(torch.autograd.Function):
    """:func:`context_parallel_attention` as one function: this rank's
    time chunk of the whole-sequence q/k/v, the ring, and the outputs
    all-gathered over the seq group; backward the same in reverse (the
    output gradient's chunk in, the chunks' dq/dk/dv all-gathered out), so
    every seq rank holds whole-sequence activations and gradients."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, group, n, me):
        from deeplearning4j_tpu_torch.parallel.mesh import all_gather_cat
        T = q.shape[2]
        if T % n or k.shape[2] % n:
            raise ValueError(f"context-parallel attention over {n} seq "
                             f"ranks needs t divisible by {n}; got q {T}, "
                             f"k {k.shape[2]}")
        t, tk = T // n, k.shape[2] // n
        ql, kl, vl = (x[:, :, me * w:(me + 1) * w].contiguous()
                      for x, w in ((q, t), (k, tk), (v, tk)))
        ml = None if mask is None else mask[:, me * tk:(me + 1) * tk]
        _check_ring(ql, kl, vl, causal)
        out, saved = _ring_forward(ql, kl, vl, ml, causal, group, n, me)
        ctx.save_for_backward(ql, kl, vl, out, *saved)
        ctx.args = (ml, causal, group, n, me)
        return all_gather_cat(out, group, dim=2)

    @staticmethod
    def backward(ctx, g):
        from deeplearning4j_tpu_torch.parallel.mesh import all_gather_cat
        ql, kl, vl, out, *saved = ctx.saved_tensors
        mask, causal, group, n, me = ctx.args
        t = ql.shape[2]
        gl = g[:, :, me * t:(me + 1) * t].contiguous()
        grads = _ring_backward(ql, kl, vl, mask, out, saved, gl, causal,
                               group, n, me)
        return (*(all_gather_cat(x, group, dim=2) for x in grads),
                None, None, None, None, None)


def context_parallel_attention(mesh, q, k, v, mask=None, causal: bool = False,
                               axis_name: str = "seq"):
    """Ring attention over the ``seq`` axis of a ``parallel.DeviceMesh``.

    q/k/v are this rank's rows of the batch over the WHOLE sequence (b, h,
    t, d), t divisible by the seq size: in a ``MeshTrainer`` step the rows
    are already this data rank's (the reference takes the global batch and
    shards it over ``data`` itself).  Each seq rank takes its chunk of the
    time axis, runs the ring, and the seq group all-gathers the outputs:
    (b, h, t, d) in q's dtype on every seq rank.  mask: (b, t_k) 1=valid
    over the whole sequence.  Differentiable (:class:`_ContextParallel`).
    """
    group, n, me = _ring_plan(mesh, axis_name)
    return _ContextParallel.apply(q, k, v, mask, causal, group, n, me)


def _auto_impl(q_shape, k_shape, v_shape, dtypes, has_mask, is_cuda):
    """The ``impl="auto"`` rule, a pure function of shapes, dtypes, mask
    and device kind: "flash" iff the tensors are on CUDA, there are at
    least 1024 queries, no key mask, and every flash kernel takes the
    operands (:func:`_flash_refusal`); "dense" otherwise, as the reference
    computes any shape its kernel refuses without a kernel."""
    if is_cuda and not has_mask \
            and _flash_refusal(q_shape, k_shape, v_shape, dtypes) is None \
            and q_shape[2] >= _FLASH_MIN_T:
        return "flash"
    return "dense"


def dot_product_attention(qh, kh, vh, mask=None, causal: bool = False,
                          impl: str = "auto"):
    """Dispatch point used by the attention layers.

    impl: "dense" (materialised softmax — reference semantics),
    "blockwise", "flash", "ring" (sequence-parallel over the active
    mesh's seq axis: :func:`context_parallel_attention`), or "auto" (ring
    when a ``MeshTrainer`` step runs over a mesh with a seq axis that
    divides t; else :func:`_auto_impl`: flash for CUDA tensors of at least
    1024 queries, no key mask and a shape and dtype the flash kernels
    take; dense otherwise).  The flash kernel takes no key mask, so ``impl="flash"``
    with a mask runs blockwise, which honours it exactly; on CUDA, an
    explicit ``impl="flash"`` on a shape the kernels refuse raises.
    """
    if impl == "auto":
        from deeplearning4j_tpu_torch.parallel.mesh import active_mesh
        am = active_mesh()
        if am is not None and am.seqSize > 1 \
                and qh.shape[2] % am.seqSize == 0 \
                and kh.shape[2] % am.seqSize == 0:
            impl = "ring"
        else:
            impl = _auto_impl(qh.shape, kh.shape, vh.shape,
                              (qh.dtype, kh.dtype, vh.dtype),
                              mask is not None, qh.is_cuda)
    if impl == "ring":
        from deeplearning4j_tpu_torch.parallel.mesh import active_mesh
        am = active_mesh()
        if am is None:
            raise ValueError("impl='ring' needs an active mesh "
                             "(ParallelWrapper.fit with a seq axis)")
        return context_parallel_attention(am, qh, kh, vh, mask=mask,
                                          causal=causal)
    if impl == "flash":
        if mask is not None:
            return blockwise_attention(qh, kh, vh, mask=mask, causal=causal)
        return flash_attention(qh, kh, vh, causal=causal)
    if impl == "blockwise":
        return blockwise_attention(qh, kh, vh, mask=mask, causal=causal)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * _scale(qh)
    # the floor in s's dtype, as the reference's jnp.asarray(_NEG, s.dtype):
    # -inf in float16, which cannot hold -1e30
    neg = s.new_tensor(_NEG)
    if mask is not None:
        s = torch.where(mask.bool()[:, None, None, :], s, neg)
    if causal:
        tq, tk = s.shape[-2:]
        cm = torch.arange(tk, device=s.device)[None, :] <= \
            torch.arange(tq, device=s.device)[:, None]
        s = torch.where(cm, s, neg)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vh)
