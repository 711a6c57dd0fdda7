"""Recommender-tier models — the port of
``deeplearning4j_tpu/models/recsys.py``: DLRM-style feature interaction,
two-tower retrieval scoring, and the paged top-k serving adapter.

Training side: two layers that sit on top of
:class:`~deeplearning4j_tpu_torch.nn.conf.embedding.ShardedEmbeddingBag`
— ``FeatureInteractionLayer`` (DLRM's pairwise-dot interaction over
field embeddings) and ``DotProductScorer`` (the two-tower affinity head
with binary cross-entropy) — registered layers that train through
``MultiLayerNetwork``.

Serving side: :class:`RetrievalLM` puts top-k retrieval onto
``ContinuousBatcher``'s paged-LM contract, as the reference's does.  A
retrieval request is a short generative sequence:

- "vocabulary" = the item corpus (ids share the hashed feature space);
- "prompt"     = the user's hashed feature ids;
- prefill      = user-tower pooling → query embedding ``u``; the prompt
  logits are ``u · itemsᵀ``, so the scheduler's admission-time argmax
  emits rank 1;
- one decode step = one rank: the step reads ``u`` back from the K pool,
  re-scores the corpus, masks every item already emitted (read back from
  the V pool pages, where each emitted item id is written as the
  "token") and emits the next-best item;
- ``maxNewTokens = k`` streams the top-k ranks.

A k=1 request emits at admission and retires before it enters the decode
batch — the single-step shape that bypasses KV-page shedding in
``AdmissionControl``.

One departure (ROADMAP C25): the reference's decode step scatters its
mask with the history's ``-1`` sentinels in place (``mode="drop"`` drops
indices past the end, but JAX wraps ``-1`` to the last item first), so
the last item of the corpus is masked at every rank after the first and
can only ever be emitted at rank 1.  The port masks only items that were
emitted: its top-k is the flat ranking's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.lossfunctions import get_loss

__all__ = ["FeatureInteractionLayer", "DotProductScorer",
           "RetrievalConfig", "RetrievalLM", "topk_retrieve"]

# score mask for already-emitted items: finite (NaN-free through any
# downstream softmax) but below any real dot-product score
_NEG_INF = -1e30


@register_layer
@dataclasses.dataclass
class FeatureInteractionLayer(BaseLayer):
    """DLRM-style pairwise feature interaction.

    Input (FF): (b, numFields * embeddingDim) concatenated field
    embeddings (a ``ShardedEmbeddingBag`` with ``numFields`` fields).
    Output: the input followed by the upper-triangle pairwise dot
    products in ``triu_indices(k=1)`` (row-major) order — (b,
    numFields*embeddingDim + numFields*(numFields-1)/2).  No parameters.
    """
    numFields: int = 0
    embeddingDim: int = 0

    def preferredFormat(self):
        return "FF"

    def inferNIn(self, inputType):
        if not self.embeddingDim:
            if not self.numFields or inputType.size % self.numFields:
                raise ValueError(
                    f"input size {inputType.size} not divisible by "
                    f"numFields {self.numFields}")
            self.embeddingDim = inputType.size // self.numFields

    def getOutputType(self, inputType):
        f = self.numFields
        return InputType.feedForward(
            f * self.embeddingDim + f * (f - 1) // 2)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return {}

    def forward(self, params, x, train, gen, state):
        b = x.shape[0]
        e = x.reshape(b, self.numFields, self.embeddingDim)
        dots = torch.bmm(e, e.transpose(1, 2))
        iu, ju = torch.triu_indices(self.numFields, self.numFields, 1,
                                    device=x.device)
        return torch.cat([x, dots[:, iu, ju]], dim=1), state


@register_layer
@dataclasses.dataclass
class DotProductScorer(BaseLayer):
    """Two-tower affinity head: input (b, 2*embeddingDim) = user embedding
    | item embedding, output sigmoid(u·v) with binary cross-entropy.  No
    parameters — the towers' capacity lives in the embedding table."""
    embeddingDim: int = 0
    lossFunction: str = "xent"

    def preferredFormat(self):
        return "FF"

    def inferNIn(self, inputType):
        if not self.embeddingDim:
            if inputType.size % 2:
                raise ValueError(
                    f"input size {inputType.size} must split into two "
                    "towers")
            self.embeddingDim = inputType.size // 2

    def getOutputType(self, inputType):
        return InputType.feedForward(1)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return {}

    def hasLoss(self) -> bool:
        return True

    def computeScore(self, labels, output, mask=None):
        return get_loss(self.lossFunction)(labels, output, mask)

    def forward(self, params, x, train, gen, state):
        u, v = torch.chunk(x, 2, dim=1)
        s = (u * v).sum(dim=1, keepdim=True)
        return torch.sigmoid(s), state


# ---------------------------------------------------------------------------
# paged top-k serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """The slice of the LM config surface ``ContinuousBatcher`` reads.

    One pseudo-layer, one pseudo-head of width ``embeddingDim``: the K
    pages hold the user query embedding (at every prompt position, so any
    pooled position recovers it) and the V pages hold emitted item ids
    (channel 0; -1 = none) in float32, exact to 2**24 items — the decode
    step needs nothing but pool state, so preemption and re-admission
    replay retrieval as they replay generative KV.
    """
    vocabSize: int          # item corpus == hashed feature id space
    embeddingDim: int
    maxLen: int             # prompt bucket + k must fit here
    nLayers: int = 1
    nHeads: int = 1

    @property
    def headSize(self) -> int:
        return self.embeddingDim


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    if hasattr(a, "torch"):                 # the port's NDArray
        return a.torch.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class RetrievalLM:
    """Top-k retrieval over an item corpus as a paged-decode "LM".

    ``userTable``/``itemTable`` are (vocabSize, embeddingDim) — for a
    shared-table two-tower model both are the trained
    ``ShardedEmbeddingBag`` weight (see :meth:`from_two_tower`).  Scores
    are the plain dot products ``u · itemsᵀ`` where ``u`` is the mean of
    the user's hashed-feature embeddings; ranks are exact (``u``
    round-trips the float32 pool unchanged, so every step re-derives the
    same corpus scores).  Runs on ``cuda`` unless ``device`` says
    otherwise.
    """

    def __init__(self, userTable, itemTable, maxLen: int = 64,
                 device=None):
        self.device = resolve_device(device)
        user = _f32(userTable, self.device)
        items = _f32(itemTable, self.device)
        if user.shape != items.shape:
            raise ValueError(
                f"tower tables disagree: {tuple(user.shape)} vs "
                f"{tuple(items.shape)}")
        self.config = RetrievalConfig(
            vocabSize=int(user.shape[0]),
            embeddingDim=int(user.shape[1]), maxLen=int(maxLen))
        self.params = {"user": user, "items": items}

    @classmethod
    def from_two_tower(cls, net, layerKey: str = "0", maxLen: int = 64,
                       device=None) -> "RetrievalLM":
        """Serving snapshot of a trained two-tower net whose layer
        ``layerKey`` is the shared ``ShardedEmbeddingBag`` table, on the
        net's device unless ``device`` says otherwise."""
        W = net.params_[layerKey]["W"]
        dev = device if device is not None else getattr(net, "device", None)
        return cls(W, W, maxLen=maxLen, device=dev)

    def to(self, device) -> "RetrievalLM":
        """Move the tables (``place_replica``'s one-device contract)."""
        device = resolve_device(device)
        self.params = {k: v.to(device) for k, v in self.params.items()}
        self.device = device
        return self

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, device=self.device).long()

    # -- prefill --------------------------------------------------------
    @torch.no_grad()
    def prefillRaw(self, tokens, lengths=None):
        """(b, t) LEFT-padded user-feature ids -> (corpus scores
        (b, vocab), kStack, vStack (1, b, 1, t, d))."""
        tokens = self._ids(tokens)
        if tokens.dim() == 1:
            tokens = tokens[None, :]
        b, t = tokens.shape
        if t > self.config.maxLen:
            raise ValueError(f"prompt length {t} exceeds positional "
                             f"capacity {self.config.maxLen}")
        if lengths is None:
            start = torch.zeros(b, dtype=torch.long, device=self.device)
        else:
            start = t - self._ids(lengths)
        d = self.config.embeddingDim
        kpos = torch.arange(t, device=self.device)[None, :]
        mask = (kpos >= start[:, None]).to(torch.float32)
        e = self.params["user"][tokens] * mask[..., None]
        u = e.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)[:, None]
        logits = u @ self.params["items"].T
        # K: the query embedding at EVERY prompt position (the decode
        # step reads it back from page 0, position 0); V: channel-0 item
        # ids, -1 = no item emitted here
        kStack = u[:, None, :].expand(b, t, d)[None, :, None].contiguous()
        vStack = torch.full((1, b, 1, t, d), -1.0, dtype=torch.float32,
                            device=self.device)
        return logits, kStack, vStack

    def restartFromPrompt(self, tokens, lengths=None):
        """Restart hook for preemption and failover: the first
        admission's computation."""
        return self.prefillRaw(tokens, lengths=lengths)

    # -- decode ---------------------------------------------------------
    def buildPagedDecodeFn(self):
        """The retrieval step over a ``KVCachePool``'s buffers:
        ``(poolK, poolV, toks (S, 1), pageTable, pos, start) -> (next item
        (S, 1) int32, poolK, poolV)``.  ``toks`` carries each slot's
        last-emitted item; the step writes it into the V pool at ``pos``
        (in place), masks every item the pool says was emitted, and emits
        the next-ranked item."""
        @torch.no_grad()
        def step(poolK, poolV, toks, pageTable, pos, start):
            toks, pageTable = self._ids(toks), self._ids(pageTable)
            pos = self._ids(pos)
            S = toks.shape[0]
            ps = poolV.shape[3]
            V = self.config.vocabSize
            rows = torch.arange(S, device=self.device)
            # query embedding: position 0 of each slot's first page
            u = poolK[0, pageTable[:, 0], 0, 0, :]              # (S, d)
            scores = u @ self.params["items"].T                 # (S, V)
            # emitted-item history from the V pool (channel 0 over every
            # held page position; the prompt region holds -1 and
            # unwritten positions are gated by pos)
            hist = poolV[0, pageTable, 0, :, 0].reshape(S, -1)
            posidx = torch.arange(hist.shape[1], device=self.device)
            emitted = torch.where(posidx[None, :] < pos[:, None],
                                  hist.long(), -1)
            keep = (emitted >= 0) & (emitted < V)
            r = rows[:, None].expand_as(emitted)[keep]
            penalty = torch.zeros_like(scores)
            penalty[r, emitted[keep]] = _NEG_INF
            last = toks[:, -1]
            penalty[rows, last] = _NEG_INF
            nxt = torch.argmax(scores + penalty, dim=-1).to(torch.int32)
            # page in the last-emitted item at pos (inactive slots write
            # to the scratch page through their zeroed page tables)
            page = pageTable[rows, pos // ps]
            poolV[0, page, 0, pos % ps, 0] = last.to(poolV.dtype)
            return nxt[:, None], poolK, poolV
        return step

    def buildPagedPrefillWriteFn(self):
        """The pool write after a prefill, the transformer's contract:
        one sequence's stacked K/V ((1, 1, Tp, d)) into the pages named by
        ``pageIds``, in place."""
        @torch.no_grad()
        def write(poolK, poolV, kStack, vStack, pageIds):
            L, h, Tp, d = kStack.shape
            ps = poolK.shape[3]
            nP = Tp // ps
            ids = self._ids(pageIds)
            poolK[:, ids] = kStack.reshape(L, h, nP, ps, d).transpose(
                1, 2).to(poolK.dtype)
            poolV[:, ids] = vStack.reshape(L, h, nP, ps, d).transpose(
                1, 2).to(poolV.dtype)
            return poolK, poolV
        return write

    def compileCacheSize(self) -> Optional[int]:
        """Fresh compiler runs of this model's AOT dispatches; None with
        the AOT cache off (eager PyTorch keeps no executable cache; the
        reference counts its jit-cache entries here)."""
        from deeplearning4j_tpu_torch.compile.aotcache import \
            _dispatch_cache_size
        return _dispatch_cache_size(self)


def topk_retrieve(batcher, userIds, k: int, timeout=None) -> np.ndarray:
    """Top-k item retrieval through a ``ContinuousBatcher`` wrapping a
    :class:`RetrievalLM`: (b, t) hashed user-feature ids -> (b, k) item
    ids ranked best-first.  Observes end-to-end latency into
    ``dl4j_tpu_recsys_topk_latency_seconds``."""
    from deeplearning4j_tpu_torch.telemetry import recsys_metrics
    t0 = time.perf_counter()
    out = batcher.submit({"tokens": userIds, "maxNewTokens": int(k)},
                         timeout=timeout)
    recsys_metrics().topk_latency().observe(time.perf_counter() - t0)
    return out
