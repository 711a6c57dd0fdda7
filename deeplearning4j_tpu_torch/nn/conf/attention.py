"""Attention layers and KV-cached attention — the port of
``deeplearning4j_tpu/nn/conf/attention.py``: ``_mha`` and
``SelfAttentionLayer`` (the reference's ``conf/layers/SelfAttentionLayer.
java``), ``KVCache``, ``cached_attention`` and ``paged_attention`` (the
continuous batcher's paged-pool attention, plain torch ops as the
reference's is plain ``jnp``).

The score/softmax/context chain dispatches through
``parallel.ring.dot_product_attention``: the Hopper flash kernels (forward
and backward) for unmasked sequences of 1024 or more on CUDA, dense
attention otherwise.  Data format follows the DL4J RNN convention
(b, nIn, t); masks are (b, t) with 1 = valid.

``SelfAttentionLayer.initCache``/``decodeStep`` and the other three
attention layers (``LearnedSelfAttentionLayer``, ``RecurrentAttentionLayer``,
``KerasMultiHeadAttention``) wait for ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight
from deeplearning4j_tpu_torch.parallel.ring import dot_product_attention

__all__ = ["SelfAttentionLayer", "KVCache", "cached_attention",
           "paged_attention"]


def _mha(x_btn, Wq, Wk, Wv, Wo, nHeads, mask=None, q_btn=None, impl="auto",
         causal=False):
    """Multi-head attention core.  x_btn: (b, t, n); mask: (b, t_k)."""
    q_btn = x_btn if q_btn is None else q_btn
    b, tq, _ = q_btn.shape

    def heads(inp, w):
        y = torch.matmul(inp, w)                     # (b, t, h*dh)
        return y.reshape(b, inp.shape[1], nHeads, -1).transpose(1, 2)

    qh, kh, vh = heads(q_btn, Wq), heads(x_btn, Wk), heads(x_btn, Wv)
    ctx = dot_product_attention(qh, kh, vh, mask=mask, causal=causal,
                                impl=impl)
    ctx = ctx.transpose(1, 2).reshape(b, tq, -1)
    return torch.matmul(ctx, Wo)                     # (b, tq, nOut)


@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(BaseLayer):
    """Per-timestep self-attention over the sequence: input (b, nIn, t) ->
    output (b, nOut, t).  ``projectInput`` must be true when nHeads > 1
    (the reference's validation); ``causal=True`` masks attention to
    past-and-self."""
    nIn: int = 0
    nOut: int = 0
    nHeads: int = 1
    headSize: int = 0
    projectInput: bool = True
    causal: bool = False

    acceptsMask = True

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size
        if not self.headSize:
            self.headSize = (self.nOut or self.nIn) // self.nHeads
        if not self.nOut:
            self.nOut = self.nIn if not self.projectInput \
                else self.nHeads * self.headSize

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, inputType.timeSeriesLength)

    def weightParamKeys(self):
        return ("Wq", "Wk", "Wv", "Wo")

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        """Wq, Wk, Wv (nIn, nHeads·headSize) and Wo (nHeads·headSize, nOut),
        drawn in that order from ``gen``, on ``device`` (``cuda`` unless
        the caller asks for another)."""
        dev = resolve_device(device)
        if not self.projectInput:
            if self.nHeads > 1:  # matches the reference's validation
                raise ValueError("projectInput=False requires nHeads == 1")
            return {}
        d = self.nHeads * self.headSize
        wi = self.weightInit or "XAVIER"
        shapes = {"Wq": (self.nIn, d), "Wk": (self.nIn, d),
                  "Wv": (self.nIn, d), "Wo": (d, self.nOut)}
        return {name: init_weight(gen, shape, shape[0], shape[1], wi, dtype,
                                  dev) for name, shape in shapes.items()}

    def forward(self, params, x, train, gen, state, mask=None):
        x = self._dropin(x, train, gen)
        xt = x.transpose(1, 2)                       # (b, t, nIn)
        if self.projectInput:
            y = _mha(xt, params["Wq"], params["Wk"], params["Wv"],
                     params["Wo"], self.nHeads, mask, causal=self.causal)
        else:
            eye = torch.eye(self.nIn, dtype=xt.dtype, device=xt.device)
            y = _mha(xt, eye, eye, eye, eye, 1, mask, causal=self.causal)
        return y.transpose(1, 2), state


# ---------------------------------------------------------------------------
# incremental (KV-cached) decode — the serving tier's O(1)-per-token path
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer key/value cache for incremental causal decode.

    ``k``/``v`` are allocated at full ``capacity`` up front and
    :func:`cached_attention` writes new positions into them IN PLACE: a
    returned cache shares its buffers with the one passed in, and only
    ``pos`` advances.  Rolling back (speculative decode) is therefore a
    new ``KVCache`` over the same buffers with a smaller ``pos``: K/V past
    ``pos`` are stale, and each is overwritten before any query can
    attend to it, because a write always precedes the attention of the
    same step.

    ``start`` carries per-example left-padding offsets: keys before
    ``start[b]`` are masked out of every attention, so a left-padded
    batch keeps one write position ``pos`` for all its examples.
    """
    k: torch.Tensor       # (b, nHeads, capacity, headSize)
    v: torch.Tensor       # (b, nHeads, capacity, headSize)
    pos: int              # next write index (tokens cached so far)
    start: torch.Tensor   # (b,) int64 — first VALID key index per example

    @staticmethod
    def create(batch: int, nHeads: int, capacity: int, headSize: int,
               dtype=torch.float32, start=None, device=None) -> "KVCache":
        dev = resolve_device(device)
        shape = (batch, nHeads, capacity, headSize)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            pos=0,
            start=(torch.zeros((batch,), dtype=torch.long, device=dev)
                   if start is None else
                   torch.as_tensor(start, dtype=torch.long, device=dev)))

    @property
    def capacity(self) -> int:
        return int(self.k.shape[2])


def cached_attention(qh, kh_new, vh_new, cache: KVCache):
    """Causal attention of ``tq`` NEW positions against a KV cache.

    ``qh``/``kh_new``/``vh_new``: (b, h, tq, d) for the new positions only.
    Writes the new K/V in place at ``[pos, pos+tq)`` and attends with
    validity masking (key index within ``[start[b], pos+i]`` for query
    ``i``).  Keys at or past ``pos+tq`` are masked for every query, so
    only the first ``pos+tq`` are read: the result equals attending over
    the whole capacity.  Returns ``(ctx (b, h, tq, d), cache advanced by
    tq)``.
    """
    b, h, tq, d = qh.shape
    pos, end = int(cache.pos), int(cache.pos) + tq
    if end > cache.capacity:
        raise ValueError(f"writing {tq} positions at {pos} overflows the "
                         f"cache capacity {cache.capacity}")
    cache.k[:, :, pos:end] = kh_new.to(cache.k.dtype)
    cache.v[:, :, pos:end] = vh_new.to(cache.v.dtype)
    k = cache.k[:, :, :end].to(qh.dtype)
    v = cache.v[:, :, :end].to(qh.dtype)
    kpos = torch.arange(end, device=qh.device)
    qpos = pos + torch.arange(tq, device=qh.device)
    valid = (kpos[None, :] <= qpos[:, None])[None] & \
        (kpos[None, None, :] >= cache.start[:, None, None])  # (b, tq, end)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, k) * (1.0 / math.sqrt(d))
    s = torch.where(valid[:, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bhkd->bhqd", w, v)
    return ctx, KVCache(cache.k, cache.v, end, cache.start)


def paged_attention(qh, kh_new, vh_new, poolK, poolV, pageTable, pos,
                    start):
    """Causal attention of ``tq`` new positions against a PAGED KV pool —
    the attention the continuous-batching scheduler (``remote/
    scheduler.py``) decodes through: K/V live in a shared pool of
    fixed-size pages and each decode SLOT addresses its own pages through a
    page table, so admitting or retiring a sequence is a host-side
    page-table edit, never a reallocation.

    - ``qh``/``kh_new``/``vh_new``: (slots, heads, tq, headSize) for the
      new positions only;
    - ``poolK``/``poolV``: (numPages, heads, pageSize, headSize) — ONE
      layer's shared page pool (page 0 is the scratch page inactive slots
      write into);
    - ``pageTable``: (slots, maxPagesPerSeq) int physical page ids in
      logical order (unallocated tail entries point at the scratch page
      and are masked out by ``pos``);
    - ``pos``/``start``: (slots,) int — next write index and first valid
      key index per slot (``KVCache.pos``/``KVCache.start``, per slot).

    Writes the new K/V into their pages IN PLACE (``tq`` may span a page
    boundary — each token's page and offset are computed on their own),
    gathers every slot's pages back in logical order and attends with the
    validity mask of :func:`cached_attention` (key index within
    ``[start[s], pos[s]+i]`` for query ``i``).  Every written position must
    lie inside the slot's table (the scheduler guarantees it).  Returns
    ``(ctx, poolK, poolV)``, the pools being the tensors passed in (the
    reference returns new arrays from a donated buffer).  Inactive slots
    all write the scratch page at the same offsets: which of those writes
    lands is unspecified, and harmless, because page 0 is never a valid
    key.
    """
    S, h, tq, d = qh.shape
    pageSize = poolK.shape[2]
    pageTable = pageTable.long()
    wpos = pos.long()[:, None] + torch.arange(tq, device=qh.device)[None, :]
    phys = torch.gather(pageTable, 1, wpos // pageSize)          # (S, tq)
    off = wpos % pageSize
    # two index tensors around a slice: the indexed dims go first (numpy's
    # rule, as in the reference's .at[phys, :, off, :]), (S, tq, h, d)
    kv_shape = (S, tq, poolK.shape[1], poolK.shape[3])
    k_new = kh_new.transpose(1, 2).to(poolK.dtype)
    v_new = vh_new.transpose(1, 2).to(poolV.dtype)
    if tuple(k_new.shape) != kv_shape or tuple(v_new.shape) != kv_shape:
        raise ValueError(f"new K/V of shape {tuple(k_new.shape)} do not "
                         f"fit the pool's (slots, tq, heads, headSize) "
                         f"{kv_shape}")
    poolK[phys, :, off, :] = k_new
    poolV[phys, :, off, :] = v_new
    cap = pageTable.shape[1] * pageSize
    k = poolK[pageTable].transpose(1, 2).reshape(S, h, cap, d)
    v = poolV[pageTable].transpose(1, 2).reshape(S, h, cap, d)
    kpos = torch.arange(cap, device=qh.device)
    valid = (kpos[None, None, :] <= wpos[:, :, None]) & \
        (kpos[None, None, :] >= start.long()[:, None, None])  # (S, tq, cap)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, k.to(qh.dtype)) * \
        (1.0 / math.sqrt(d))
    s = torch.where(valid[:, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bhkd->bhqd", w, v.to(qh.dtype))
    return ctx, poolK, poolV
