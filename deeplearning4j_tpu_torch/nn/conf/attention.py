"""Attention layers and KV-cached attention — the port of
``deeplearning4j_tpu/nn/conf/attention.py``: ``_mha``,
``SelfAttentionLayer`` with its KV-cached ``initCache``/``decodeStep``,
``LearnedSelfAttentionLayer`` and ``RecurrentAttentionLayer`` (the
reference's ``conf/layers/{SelfAttentionLayer,LearnedSelfAttentionLayer,
RecurrentAttentionLayer}.java``), ``KerasMultiHeadAttention`` (the layer
the Keras importer builds for ``MultiHeadAttention``), ``KVCache``,
``cached_attention`` and ``paged_attention`` (the continuous batcher's
paged-pool attention, plain torch ops as the reference's is plain
``jnp``).

The score/softmax/context chain of every layer dispatches through
``parallel.ring.dot_product_attention``: the Hopper flash kernels (forward
and backward) for unmasked sequences of 1024 or more on CUDA, dense
attention otherwise.  Data format follows the DL4J RNN convention
(b, nIn, t); masks are (b, t) with 1 = valid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight
from deeplearning4j_tpu_torch.parallel.ring import dot_product_attention

__all__ = ["SelfAttentionLayer", "LearnedSelfAttentionLayer",
           "RecurrentAttentionLayer", "KerasMultiHeadAttention",
           "KVCache", "cached_attention", "paged_attention"]


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

    # -- incremental decode (KV cache) ----------------------------------
    def initCache(self, batch: int, capacity: int, dtype=torch.float32,
                  start=None, device=None) -> "KVCache":
        """Fresh fixed-capacity cache for :meth:`decodeStep`, on
        ``device`` (``cuda`` unless the caller asks for another)."""
        if not self.causal:
            raise ValueError(
                "KV-cache decode requires causal=True (an incremental "
                "step can only ever attend to the past)")
        h = self.nHeads if self.projectInput else 1
        d = self.headSize if self.projectInput else self.nIn
        return KVCache.create(batch, h, capacity, d, dtype, start=start,
                              device=device)

    def decodeStep(self, params, x, cache: "KVCache"):
        """Feed ``t_new`` timesteps (x: (b, nIn, t_new)), attending to
        everything cached so far plus the new steps — the causal
        ``forward`` restricted to the new positions.  Writes the cache in
        place (:func:`cached_attention`); returns ``(y (b, nOut, t_new),
        the cache advanced by t_new)``."""
        xt = x.transpose(1, 2)                       # (b, t_new, nIn)
        b, tq, _ = xt.shape

        def heads(inp, w, n):
            return torch.matmul(inp, w).reshape(b, tq, n, -1).transpose(1, 2)

        if self.projectInput:
            qh = heads(xt, params["Wq"], self.nHeads)
            kh = heads(xt, params["Wk"], self.nHeads)
            vh = heads(xt, params["Wv"], self.nHeads)
            Wo = params["Wo"]
        else:
            qh = kh = vh = xt[:, None]               # (b, 1, t_new, nIn)
            Wo = torch.eye(self.nIn, dtype=xt.dtype, device=xt.device)
        ctx, cache = cached_attention(qh, kh, vh, cache)
        y = torch.matmul(ctx.transpose(1, 2).reshape(b, tq, -1), Wo)
        return y.transpose(1, 2), cache


def _draw(gen, shapes, wi, dtype, dev):
    """Weights of the given ``{name: shape}`` drawn from ``gen`` in that
    order, each with fan-in ``shape[0]`` and fan-out ``shape[-1]``."""
    return {n: init_weight(gen, s, s[0], s[-1], wi, dtype, dev)
            for n, s in shapes.items()}


@register_layer
@dataclasses.dataclass
class LearnedSelfAttentionLayer(BaseLayer):
    """Attention with ``nQueries`` LEARNED query vectors: pools a
    variable-length sequence (b, nIn, t) to a fixed (b, nOut, nQueries)
    output.  Reference: ``conf/layers/LearnedSelfAttentionLayer.java``."""
    nIn: int = 0
    nOut: int = 0
    nHeads: int = 1
    headSize: int = 0
    nQueries: int = 1
    projectInput: bool = True

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
        return InputType.recurrent(self.nOut, self.nQueries)

    def weightParamKeys(self):
        return ("Wq", "Wk", "Wv", "Wo", "Q")

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        """Q (nIn, nQueries), and with ``projectInput`` Wq, Wk, Wv
        (nIn, nHeads·headSize) and Wo (nHeads·headSize, nOut), on
        ``device`` (``cuda`` unless the caller asks for another)."""
        dev = resolve_device(device)
        if not self.projectInput and self.nHeads > 1:
            raise ValueError("projectInput=False requires nHeads == 1")
        wi = self.weightInit or "XAVIER"
        shapes = {"Q": (self.nIn, self.nQueries)}
        if self.projectInput:
            d = self.nHeads * self.headSize
            shapes.update({"Wq": (self.nIn, d), "Wk": (self.nIn, d),
                           "Wv": (self.nIn, d), "Wo": (d, self.nOut)})
        return _draw(gen, shapes, wi, dtype, dev)

    def forward(self, params, x, train, gen, state, mask=None):
        x = self._dropin(x, train, gen)
        xt = x.transpose(1, 2)                       # (b, t, nIn)
        b = xt.shape[0]
        q = params["Q"].T[None].expand(b, self.nQueries, self.nIn)
        if self.projectInput:
            y = _mha(xt, params["Wq"], params["Wk"], params["Wv"],
                     params["Wo"], self.nHeads, mask, q_btn=q)
        else:
            eye = torch.eye(self.nIn, dtype=xt.dtype, device=xt.device)
            y = _mha(xt, eye, eye, eye, eye, 1, mask, q_btn=q)
        return y.transpose(1, 2), state              # (b, nOut, nQueries)


@register_layer
@dataclasses.dataclass
class RecurrentAttentionLayer(BaseLayer):
    """Recurrent cell whose per-timestep input is augmented with an
    attention readout over the whole input sequence: output (b, nOut, t).
    Reference: ``conf/layers/RecurrentAttentionLayer.java`` (SimpleRnn-style
    recurrence + attention per step).  The attention context for ALL
    timesteps is computed once, before the recurrence, as in the
    reference; the recurrence (the reference's ``lax.scan``) is a loop
    over t."""
    nIn: int = 0
    nOut: int = 0
    nHeads: int = 1
    headSize: int = 0
    projectInput: bool = True

    acceptsMask = True

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size
        if not self.headSize:
            self.headSize = (self.nOut or self.nIn) // self.nHeads

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, inputType.timeSeriesLength)

    def weightParamKeys(self):
        return ("W", "RW", "Wq", "Wk", "Wv", "Wo")

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        """W (nIn + d, nOut), RW (nOut, nOut), b (nOut,) zeros and, with
        ``projectInput``, Wq, Wk, Wv (nIn, d) and Wo (d, d), d the context
        width (nHeads·headSize projected, nIn not), on ``device``."""
        dev = resolve_device(device)
        d = self.nHeads * self.headSize if self.projectInput else self.nIn
        if not self.projectInput and self.nHeads > 1:
            raise ValueError("projectInput=False requires nHeads == 1")
        wi = self.weightInit or "XAVIER"
        shapes = {"W": (self.nIn + d, self.nOut),
                  "RW": (self.nOut, self.nOut)}
        if self.projectInput:
            shapes.update({"Wq": (self.nIn, d), "Wk": (self.nIn, d),
                           "Wv": (self.nIn, d), "Wo": (d, d)})
        p = _draw(gen, shapes, wi, dtype, dev)
        p["b"] = torch.zeros((self.nOut,), dtype=dtype, device=dev)
        return p

    def forward(self, params, x, train, gen, state, mask=None):
        x = self._dropin(x, train, gen)
        xt = x.transpose(1, 2)                       # (b, t, nIn)
        if self.projectInput:
            ctx = _mha(xt, params["Wq"], params["Wk"], params["Wv"],
                       params["Wo"], self.nHeads, mask)  # (b, t, d)
        else:
            eye = torch.eye(self.nIn, dtype=xt.dtype, device=xt.device)
            ctx = _mha(xt, eye, eye, eye, eye, 1, mask)
        inp = torch.cat([xt, ctx], dim=-1)           # (b, t, nIn+d)
        act = get_activation(self.activation or "tanh")
        pre = torch.einsum("btn,no->bto", inp, params["W"]) + params["b"]
        h = torch.zeros((xt.shape[0], self.nOut), dtype=xt.dtype,
                        device=xt.device)
        ys = []
        for t in range(pre.shape[1]):
            h = act(pre[:, t] + torch.matmul(h, params["RW"]))
            ys.append(h)
        y = torch.stack(ys, dim=2)                   # (b, nOut, t)
        if mask is not None:
            y = y * mask[:, None, :].to(y.dtype)
        return y, state


@register_layer
@dataclasses.dataclass
class KerasMultiHeadAttention(BaseLayer):
    """Keras-``MultiHeadAttention``-shaped self-attention: per-head q/k/v
    projections with biases and a combining output projection, parameters
    laid out as keras stores them — query/key kernels ``(nIn, h, keyDim)``,
    value ``(nIn, h, valueDim)``, output ``(h, valueDim, nOut)`` — so
    imported weights copy in directly (``imports/keras_import.py``).
    Input/output follow the DL4J RNN convention (b, n, t); the score chain
    dispatches through ``parallel.ring.dot_product_attention`` (the flash
    kernels on CUDA for long unmasked sequences).  The (b, h, t, d) q, k, v
    it hands over are transposed views: the flash wrapper lays them out
    for its kernels."""
    nIn: int = 0
    nHeads: int = 1
    keyDim: int = 0
    valueDim: int = 0          # 0 -> keyDim
    nOut: int = 0              # 0 -> nIn
    hasBias: bool = True

    acceptsMask = True

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size
        if not self.valueDim:
            self.valueDim = self.keyDim
        if not self.nOut:
            self.nOut = self.nIn

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut or self.nIn,
                                   inputType.timeSeriesLength)

    def weightParamKeys(self):
        return ("Wq", "Wk", "Wv", "Wo")

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        """Wq, Wk (nIn, h, keyDim), Wv (nIn, h, valueDim), Wo (h, valueDim,
        nOut) drawn in that order and, with ``hasBias``, zero biases bq,
        bk (h, keyDim), bv (h, valueDim) and bo (nOut,), on ``device``."""
        dev = resolve_device(device)
        h, dk, dv = self.nHeads, self.keyDim, self.valueDim or self.keyDim
        wi = self.weightInit or "XAVIER"
        fans = {"Wq": ((self.nIn, h, dk), self.nIn, h * dk),
                "Wk": ((self.nIn, h, dk), self.nIn, h * dk),
                "Wv": ((self.nIn, h, dv), self.nIn, h * dv),
                "Wo": ((h, dv, self.nOut), h * dv, self.nOut)}
        p = {n: init_weight(gen, s, fi, fo, wi, dtype, dev)
             for n, (s, fi, fo) in fans.items()}
        if self.hasBias:
            for n, s in (("bq", (h, dk)), ("bk", (h, dk)), ("bv", (h, dv)),
                         ("bo", (self.nOut,))):
                p[n] = torch.zeros(s, dtype=dtype, device=dev)
        return p

    def forward(self, params, x, train, gen, state, mask=None):
        x = self._dropin(x, train, gen)
        xt = x.transpose(1, 2)                             # (b, t, nIn)
        q = torch.einsum("btf,fhk->bthk", xt, params["Wq"])
        k = torch.einsum("btf,fhk->bthk", xt, params["Wk"])
        v = torch.einsum("btf,fhv->bthv", xt, params["Wv"])
        if self.hasBias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        # (b, t, h, d) -> (b, h, t, d) for the shared dispatch point
        ctx = dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), mask=mask)
        y = torch.einsum("bhtv,hvo->bto", ctx, params["Wo"])
        if self.hasBias:
            y = y + params["bo"]
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
