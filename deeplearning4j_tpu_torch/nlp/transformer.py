"""Decoder-only transformer LM with incremental (KV-cached) decode — the
port of ``deeplearning4j_tpu/nlp/transformer.py``.

- :meth:`TransformerLM.prefill` runs the prompt through the stack once
  (causal attention dispatching through ``parallel.ring.
  dot_product_attention``, i.e. the Hopper flash kernel for unpadded
  prompts of 1024 tokens or more on CUDA) and fills the caches;
- :meth:`TransformerLM.decodeStep` feeds ONE token per example against
  the caches, which it updates in place (see ``KVCache``);
- left-padding support (``lengths``) keeps ragged prompts batchable: every
  example ends at the same position, so the cache write position stays
  one integer (see ``KVCache.start``).  A padded prompt carries a key
  mask, which the flash kernel does not take, so it runs dense attention.

Weights follow the pre-LN GPT block (LN → attention → residual, LN → FFN
→ residual) with tied input/output embeddings, in the JAX model's layout
(``x @ W``), and run in float32.  The seeded initialiser draws the same
numbers as the JAX model's from one seed; :meth:`TransformerLM.loadParams`
copies the JAX model's parameters in.

The paged builders (``buildPagedDecodeFn``, ``buildPagedProposeFn``,
``buildPagedPrefillWriteFn``) are the continuous batcher's step functions
(``remote/scheduler.py``) over a ``KVCachePool``'s buffers, which they
write IN PLACE (the reference donates the buffers and returns new ones;
these return the same tensors, so the call sites keep their shape).
``compileCacheSize`` returns None with the AOT cache off (the default):
eager PyTorch keeps no jit cache to probe; with it configured, the fresh
compiler runs of the ``prefill`` / ``decodeStep`` dispatches that
``compile.aotcache.wrap_serving_model`` installs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.conf.attention import (KVCache,
                                                        cached_attention,
                                                        paged_attention)
from deeplearning4j_tpu_torch.parallel.ring import dot_product_attention

__all__ = ["TransformerLMConfig", "TransformerLM"]

_BLOCK_PARAMS = ("ln1_g", "ln1_b", "Wq", "Wk", "Wv", "Wo", "ln2_g", "ln2_b",
                 "Wi", "bi", "Wp", "bp")


@dataclasses.dataclass
class TransformerLMConfig:
    vocabSize: int = 256
    nLayers: int = 2
    nHeads: int = 4
    headSize: int = 16
    ffnMult: int = 4
    maxLen: int = 128          # cache capacity == max prompt + generation
    initializerRange: float = 0.02
    seed: int = 0

    @property
    def hiddenSize(self) -> int:
        return self.nHeads * self.headSize


class _Block(nn.Module):
    """One pre-LN block; parameters named as in the JAX model's layer
    dicts."""

    def __init__(self, c: TransformerLMConfig, device):
        super().__init__()
        H, Fd = c.hiddenSize, c.ffnMult * c.hiddenSize
        shapes = {"ln1_g": (H,), "ln1_b": (H,), "Wq": (H, H), "Wk": (H, H),
                  "Wv": (H, H), "Wo": (H, H), "ln2_g": (H,), "ln2_b": (H,),
                  "Wi": (H, Fd), "bi": (Fd,), "Wp": (Fd, H), "bp": (H,)}
        for name in _BLOCK_PARAMS:
            setattr(self, name, nn.Parameter(
                torch.empty(shapes[name], device=device)))
        self.nHeads, self.headSize = c.nHeads, c.headSize

    def _heads(self, y):
        b, t, _ = y.shape
        return y.view(b, t, self.nHeads, self.headSize).transpose(1, 2)

    def _qkv(self, x):
        h = F.layer_norm(x, x.shape[-1:], self.ln1_g, self.ln1_b, 1e-5)
        return (self._heads(h @ self.Wq), self._heads(h @ self.Wk),
                self._heads(h @ self.Wv))

    def _out(self, x, ctx):
        b, _, t, _ = ctx.shape
        x = x + ctx.transpose(1, 2).reshape(b, t, -1) @ self.Wo
        h = F.layer_norm(x, x.shape[-1:], self.ln2_g, self.ln2_b, 1e-5)
        ff = F.gelu(h @ self.Wi + self.bi, approximate="tanh")
        return x + ff @ self.Wp + self.bp

    def full(self, x, mask):
        """Full-sequence causal block (prefill): attention dispatches
        through ``dot_product_attention`` — flash on CUDA for long
        unmasked prompts, mask-honouring dense otherwise."""
        qh, kh, vh = self._qkv(x)
        ctx = dot_product_attention(qh, kh, vh, mask=mask, causal=True)
        return self._out(x, ctx), (kh, vh)

    def cached(self, x, cache: KVCache):
        qh, kh, vh = self._qkv(x)
        ctx, cache = cached_attention(qh, kh, vh, cache)
        return self._out(x, ctx), cache

    def paged(self, x, poolK, poolV, pageTable, pos, start):
        """The cached block with :func:`paged_attention` in place of the
        private dense cache; writes the new K/V into the pool layer."""
        qh, kh, vh = self._qkv(x)
        ctx, _, _ = paged_attention(qh, kh, vh, poolK, poolV, pageTable,
                                    pos, start)
        return self._out(x, ctx)


class TransformerLM(nn.Module):
    """GPT-style causal LM; ``generate`` == prefill + N decode steps.

    Runs on ``device`` (default ``cuda``; raises when no card is present
    and the CPU was not asked for).  The inference entry points run under
    ``torch.no_grad()``.
    """

    def __init__(self, config: Optional[TransformerLMConfig] = None,
                 device=None, **kw):
        super().__init__()
        self.config = c = config or TransformerLMConfig(**kw)
        self.device = resolve_device(device)
        H = c.hiddenSize
        self.emb = nn.Parameter(torch.empty((c.vocabSize, H),
                                            device=self.device))
        self.pos = nn.Parameter(torch.empty((c.maxLen, H),
                                            device=self.device))
        self.lnf_g = nn.Parameter(torch.empty((H,), device=self.device))
        self.lnf_b = nn.Parameter(torch.empty((H,), device=self.device))
        self.layers = nn.ModuleList(_Block(c, self.device)
                                    for _ in range(c.nLayers))
        self.loadParams(self._init_params())

    # ------------------------------------------------------------------
    def _init_params(self) -> Dict:
        """The JAX model's seeded draw (same RandomState, same order), in
        float32 throughout — the JAX model's LayerNorm and FFN-bias
        leaves come out float64 under its x64 mode, which this port does
        not copy."""
        c = self.config
        rng = np.random.RandomState(c.seed)
        H, Fd = c.hiddenSize, c.ffnMult * c.hiddenSize

        def init(*shape):
            return (rng.randn(*shape) * c.initializerRange).astype(np.float32)

        ones = lambda n: np.ones((n,), np.float32)     # noqa: E731
        zeros = lambda n: np.zeros((n,), np.float32)   # noqa: E731
        p = {"emb": init(c.vocabSize, H), "pos": init(c.maxLen, H),
             "lnf_g": ones(H), "lnf_b": zeros(H), "layers": []}
        for _ in range(c.nLayers):
            p["layers"].append({
                "ln1_g": ones(H), "ln1_b": zeros(H),
                "Wq": init(H, H), "Wk": init(H, H), "Wv": init(H, H),
                "Wo": init(H, H),
                "ln2_g": ones(H), "ln2_b": zeros(H),
                "Wi": init(H, Fd), "bi": zeros(Fd),
                "Wp": init(Fd, H), "bp": zeros(H)})
        return p

    @torch.no_grad()
    def loadParams(self, params) -> "TransformerLM":
        """Copy a parameter tree in the JAX model's layout — ``{"emb",
        "pos", "lnf_g", "lnf_b", "layers": [{"ln1_g", ..., "bp"}]}`` with
        numpy (or array-like) leaves, e.g. ``jax.tree.map(np.asarray,
        lm.params)`` — into this model, cast to float32 on its device."""
        def put(param, value, name):
            value = np.asarray(value)
            if value.shape != tuple(param.shape):
                raise ValueError(f"{name}: expected shape "
                                 f"{tuple(param.shape)}, got {value.shape}")
            param.copy_(torch.from_numpy(value.astype(np.float32)))

        if len(params["layers"]) != len(self.layers):
            raise ValueError(f"expected {len(self.layers)} layers, got "
                             f"{len(params['layers'])}")
        for name in ("emb", "pos", "lnf_g", "lnf_b"):
            put(getattr(self, name), params[name], name)
        for i, (blk, lp) in enumerate(zip(self.layers, params["layers"])):
            for name in _BLOCK_PARAMS:
                put(getattr(blk, name), lp[name], f"layers[{i}].{name}")
        return self

    # ------------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids as a long tensor on the model's device.  Ids from
        outside (numpy, lists) are range-checked on the host: an
        out-of-range gather on the card is a device fault."""
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        arr = np.asarray(tokens, np.int64)
        if arr.size and (arr.min() < 0 or arr.max() >= self.config.vocabSize):
            raise ValueError(f"token ids must lie in [0, "
                             f"{self.config.vocabSize})")
        return torch.from_numpy(arr).to(self.device)

    def _embed(self, tokens, pos_ids):
        return self.emb[tokens] + self.pos[pos_ids]     # (b, t, H)

    def _logits(self, x):
        h = F.layer_norm(x, x.shape[-1:], self.lnf_g, self.lnf_b, 1e-5)
        return h @ self.emb.T                           # tied head

    def _start(self, b, t, lengths):
        if lengths is None:
            return torch.zeros((b,), dtype=torch.long, device=self.device)
        return t - torch.as_tensor(lengths, dtype=torch.long,
                                   device=self.device)

    def _check_prompt(self, t):
        if t > self.config.maxLen:
            raise ValueError(f"prompt length {t} exceeds cache capacity "
                             f"{self.config.maxLen}")

    def _check_room(self, caches, n):
        if caches[0].pos + n > self.config.maxLen:
            raise ValueError(f"{n} more positions at {caches[0].pos} exceed "
                             f"cache capacity {self.config.maxLen}")

    # ------------------------------------------------------------------
    # full forward (the recompute baseline the KV path must match)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens) -> torch.Tensor:
        """Full causal forward: (b, t) int -> (b, t, vocab) logits."""
        tokens = self._tokens(tokens)
        t = tokens.shape[1]
        self._check_prompt(t)
        x = self._embed(tokens, torch.arange(t, device=self.device)[None, :])
        for blk in self.layers:
            x, _ = blk.full(x, None)
        return self._logits(x)

    # ------------------------------------------------------------------
    # incremental decode
    # ------------------------------------------------------------------
    def initCaches(self, batch: int) -> List[KVCache]:
        c = self.config
        return [KVCache.create(batch, c.nHeads, c.maxLen, c.headSize,
                               device=self.device)
                for _ in range(c.nLayers)]

    def _prefill_layers(self, tokens, lengths):
        """(b, t) prompt -> (final hidden states, [(kh, vh)] per layer).
        ``start[b]`` = index of the first REAL token (left padding);
        position ids count from the real start, so padded and unpadded
        prompts see identical positional embeddings.  Unpadded prompts
        keep ``mask=None`` so the causal dispatch stays flash-eligible."""
        b, t = tokens.shape
        self._check_prompt(t)
        start = self._start(b, t, lengths)
        kpos = torch.arange(t, device=self.device)[None, :]
        pos_ids = (kpos - start[:, None]).clamp_min(0)
        mask = (kpos >= start[:, None]).float() \
            if lengths is not None else None                    # (b, t)
        x = self._embed(tokens, pos_ids)
        kvs = []
        for blk in self.layers:
            x, kv = blk.full(x, mask)
            kvs.append(kv)
        return x, kvs, start

    @torch.no_grad()
    def prefill(self, tokens, lengths=None):
        """Run the prompt once, filling every layer's cache.

        ``tokens`` (b, t) int, LEFT-padded when ragged; ``lengths`` (b,)
        gives each example's real token count (defaults to full t).
        Returns ``(last_logits (b, vocab), caches)`` — the logits predict
        the first generated token.
        """
        tokens = self._tokens(tokens)
        b, t = tokens.shape
        x, kvs, start = self._prefill_layers(tokens, lengths)
        c = self.config
        caches = []
        for kh, vh in kvs:
            cache = KVCache.create(b, c.nHeads, c.maxLen, c.headSize,
                                   kh.dtype, start=start, device=self.device)
            cache.k[:, :, :t] = kh
            cache.v[:, :, :t] = vh
            caches.append(cache._replace(pos=t))
        return self._logits(x[:, -1:])[:, 0], caches

    def _cached_forward(self, toks, caches):
        """``k`` new tokens per example against the caches: toks (b, k) ->
        ((b, k, vocab) logits, caches advanced k).  The shared body of
        decode, verification and draft proposal."""
        k = toks.shape[1]
        self._check_room(caches, k)
        pos_ids = (caches[0].pos - caches[0].start)[:, None] + \
            torch.arange(k, device=self.device)[None, :]      # (b, k)
        x = self._embed(toks, pos_ids)
        new = []
        for blk, cache in zip(self.layers, caches):
            x, cache = blk.cached(x, cache)
            new.append(cache)
        return self._logits(x), new

    def _decode_math(self, tok, caches):
        """One incremental step: tok (b,) -> ((b, vocab) logits, caches)."""
        logits, caches = self._cached_forward(tok[:, None], caches)
        return logits[:, 0], caches

    @torch.no_grad()
    def decodeStep(self, tok, caches):
        """One generated token per example: (b,) int + caches ->
        ((b, vocab) logits, advanced caches).  O(cached length) per call —
        the prefix never re-enters the layer stack.  The caches' buffers
        are updated in place."""
        return self._decode_math(self._tokens(tok), caches)

    # ------------------------------------------------------------------
    # speculative decode: draft proposes, target verifies in ONE forward
    # ------------------------------------------------------------------
    @torch.no_grad()
    def verifySteps(self, toks, caches):
        """Target-side verification: toks (b, k) int (the last emitted
        token followed by the draft's proposals) -> ((b, k) greedy
        tokens, caches advanced k).  Greedy token j is the target's
        prediction after prefix ``toks[:, :j+1]`` — identical math to j
        sequential :meth:`decodeStep` calls, one pass.  On a partial
        accept the caller rolls back by rebuilding the caches with a
        smaller ``pos`` (stale K/V past ``pos`` are overwritten before
        they can ever be attended)."""
        logits, caches = self._cached_forward(self._tokens(toks), caches)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    @torch.no_grad()
    def proposeK(self, tok, caches, k: int):
        """Draft entry point: (b,) last tokens -> ((b, k) proposals,
        caches advanced k+1).  It runs k+1 steps so the cache also holds
        K/V for the k-th proposal — a full accept then needs no cache
        repair."""
        tok = self._tokens(tok)
        props = []
        for _ in range(int(k) + 1):
            logits, caches = self._decode_math(tok, caches)
            tok = torch.argmax(logits, dim=-1)
            props.append(tok)
        return torch.stack(props, dim=1)[:, :int(k)].to(torch.int32), caches

    def speculative_generate(self, draft: "TransformerLM", prompts,
                             maxNewTokens: int, draftK: int = 4,
                             lengths=None, returnStats: bool = False):
        """Greedy decode accelerated by a small draft model — output is
        IDENTICAL to :meth:`generate` (accept-prefix rule: every emitted
        token is the target's own greedy argmax; the draft only decides
        how many of them one verification pass yields).

        Per round: the draft proposes ``draftK`` tokens, the target
        verifies all of them in ONE batched forward, and the longest
        matching prefix plus the target's first correction are emitted.

        Serves ONE sequence per call (per-example accept lengths diverge
        under batching).  Requires ``t + maxNewTokens + draftK <=
        maxLen``: a rejected round still wrote its speculative K/V before
        the roll-back, so the cache needs the extra headroom.
        """
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim == 1:
            prompts = prompts[None, :]
        if prompts.shape[0] != 1:
            raise ValueError(
                "speculative_generate serves one sequence at a time "
                "(per-example accept lengths diverge; use the "
                "continuous-batching scheduler for batched speculation)")
        draftK = int(draftK)
        if draftK < 1:
            raise ValueError("draftK must be >= 1")
        if draft.config.vocabSize != self.config.vocabSize:
            raise ValueError("draft and target must share a vocabulary")
        t = prompts.shape[1]
        if t + maxNewTokens + draftK > self.config.maxLen:
            raise ValueError(
                f"prompt {t} + maxNewTokens {maxNewTokens} + draftK "
                f"{draftK} exceeds cache capacity {self.config.maxLen} "
                "(speculative rounds write draftK tokens of K/V ahead)")
        if t + maxNewTokens + draftK > draft.config.maxLen:
            raise ValueError(
                f"draft cache capacity {draft.config.maxLen} cannot hold "
                f"prompt {t} + maxNewTokens {maxNewTokens} + draftK "
                f"{draftK}")
        logits, caches = self.prefill(prompts, lengths)
        _, dcaches = draft.prefill(prompts, lengths)
        tok = int(torch.argmax(logits[0]))
        emitted = [tok]
        proposed = accepted = rounds = 0
        while len(emitted) < maxNewTokens:
            # pre-propose/pre-verify write indices: the roll-back below
            # rebuilds both cache sets relative to THESE
            pos0 = caches[0].pos
            dpos0 = dcaches[0].pos
            props, dcaches = draft.proposeK(
                np.asarray([tok], np.int32), dcaches, draftK)
            props = props[0].cpu().numpy()                   # (draftK,)
            verifyIn = np.concatenate(
                [np.asarray([tok], np.int32), props])[None, :]
            greedy, caches = self.verifySteps(verifyIn, caches)
            greedy = greedy[0].cpu().numpy()                 # (draftK+1,)
            a = 0
            while a < draftK and props[a] == greedy[a]:
                a += 1
            emitted.extend(int(g) for g in greedy[:a + 1])
            tok = int(greedy[a])
            proposed += draftK
            accepted += a
            rounds += 1
            # roll back: only the accepted prefix (plus the verified
            # input token) is real — stale K/V past pos are overwritten
            # before any later query can attend to them
            caches = [KVCache(c.k, c.v, pos0 + a + 1, c.start)
                      for c in caches]
            dcaches = [KVCache(c.k, c.v, dpos0 + a + 1, c.start)
                       for c in dcaches]
        out = np.asarray(emitted[:maxNewTokens], np.int32)[None, :]
        if returnStats:
            return out, {"proposed": proposed, "accepted": accepted,
                         "rounds": rounds,
                         "acceptRate": accepted / proposed if proposed
                         else 0.0}
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefillRaw(self, tokens, lengths=None):
        """(b, t) LEFT-padded prompt -> (last logits (b, vocab), kStack,
        vStack (nLayers, b, h, t, d)).  Always mask-padded (one path per
        prompt bucket regardless of raggedness), so it never reaches the
        flash kernel."""
        tokens = self._tokens(tokens)
        b, t = tokens.shape
        if lengths is None:
            lengths = np.full((b,), t, np.int64)
        x, kvs, _ = self._prefill_layers(tokens, lengths)
        return (self._logits(x[:, -1:])[:, 0],
                torch.stack([kv[0] for kv in kvs]),
                torch.stack([kv[1] for kv in kvs]))

    def restartFromPrompt(self, tokens, lengths=None):
        """Restart hook for preemption and serving failover: rebuild a
        sequence's KV state from its ORIGINAL prompt with exactly the
        computation the first admission used, so the step-by-step replay
        that follows regenerates the identical token prefix."""
        return self.prefillRaw(tokens, lengths=lengths)

    # ------------------------------------------------------------------
    # paged decode — the continuous-batching scheduler's step functions
    # ------------------------------------------------------------------
    def _slot_ids(self, a) -> torch.Tensor:
        """Page tables, positions, tokens: host arrays or tensors, as long
        on the model's device."""
        return torch.as_tensor(a, device=self.device).long()

    def _paged_step_math(self, poolK, poolV, toks, pageTable, pos, start):
        """toks (S, tq) against the stacked pools (L, pages, h, ps, d),
        written in place: returns ((S, tq) greedy tokens int32, poolK,
        poolV).  Position-embedding ids are clipped so a speculative write
        past ``maxLen`` (tokens the accept rule will discard) cannot index
        out of the table."""
        tq = toks.shape[1]
        pos_ids = ((pos - start)[:, None] + torch.arange(
            tq, device=self.device)[None, :]).clamp(0, self.config.maxLen - 1)
        x = self._embed(toks, pos_ids)
        for li, blk in enumerate(self.layers):
            x = blk.paged(x, poolK[li], poolV[li], pageTable, pos, start)
        greedy = torch.argmax(self._logits(x), dim=-1).to(torch.int32)
        return greedy, poolK, poolV

    def buildPagedDecodeFn(self):
        """The paged decode/verify step over a ``KVCachePool``'s buffers:
        ``(poolK, poolV, toks (S, tq), pageTable, pos, start) -> (greedy
        (S, tq) int32, poolK, poolV)``.  tq=1 is the plain decode step,
        tq=draftK+1 the speculative verify.  The pools are written in
        place and returned; the reference's first argument (the jitted
        function's params) is the module's own parameters here."""
        @torch.no_grad()
        def step(poolK, poolV, toks, pageTable, pos, start):
            return self._paged_step_math(
                poolK, poolV, self._slot_ids(toks), self._slot_ids(pageTable),
                self._slot_ids(pos), self._slot_ids(start))
        return step

    def buildPagedProposeFn(self, draftK: int):
        """The paged draft proposal: ``(poolK, poolV, tok (S,), pageTable,
        pos, start) -> (proposals (S, draftK) int32, poolK, poolV)``, by
        draftK+1 greedy steps (a Python loop where the reference scans), so
        the k-th proposal's K/V is already paged in on a full accept."""
        draftK = int(draftK)

        @torch.no_grad()
        def propose(poolK, poolV, tok, pageTable, pos, start):
            tok, pageTable = self._slot_ids(tok), self._slot_ids(pageTable)
            pos, start = self._slot_ids(pos), self._slot_ids(start)
            props = []
            for _ in range(draftK + 1):
                greedy, poolK, poolV = self._paged_step_math(
                    poolK, poolV, tok[:, None], pageTable, pos, start)
                tok = greedy[:, 0].long()
                props.append(greedy[:, 0])
                pos = pos + 1
            return torch.stack(props, dim=1)[:, :draftK], poolK, poolV
        return propose

    def buildPagedPrefillWriteFn(self):
        """The pool write after a prefill: copy one sequence's stacked K/V
        ((L, h, Tp, d), Tp a page multiple) into the pages named by
        ``pageIds`` ((Tp / pageSize,) int), in place; returns (poolK,
        poolV)."""
        @torch.no_grad()
        def write(poolK, poolV, kStack, vStack, pageIds):
            L, h, Tp, d = kStack.shape
            ps = poolK.shape[3]
            nP = Tp // ps
            ids = self._slot_ids(pageIds)
            poolK[:, ids] = kStack.reshape(L, h, nP, ps, d).transpose(
                1, 2).to(poolK.dtype)
            poolV[:, ids] = vStack.reshape(L, h, nP, ps, d).transpose(
                1, 2).to(poolV.dtype)
            return poolK, poolV
        return write

    def compileCacheSize(self) -> Optional[int]:
        """Fresh compiler runs of this LM's AOT dispatches; None with the
        AOT cache off (eager PyTorch keeps no executable cache to count;
        the reference's probe of its jit caches)."""
        from deeplearning4j_tpu_torch.compile.aotcache import \
            _dispatch_cache_size
        return _dispatch_cache_size(self)

    # ------------------------------------------------------------------
    def generate(self, prompts, maxNewTokens: int, lengths=None
                 ) -> np.ndarray:
        """Greedy decode: (b, t) prompts -> (b, maxNewTokens) int32.

        Capacity check: t + maxNewTokens must fit ``maxLen`` (the caches
        are fixed-size)."""
        prompts = self._tokens(prompts)
        if prompts.dim() == 1:
            prompts = prompts[None, :]
        t = prompts.shape[1]
        if t + maxNewTokens > self.config.maxLen:
            raise ValueError(
                f"prompt {t} + maxNewTokens {maxNewTokens} exceeds cache "
                f"capacity {self.config.maxLen}")
        logits, caches = self.prefill(prompts, lengths)
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        for _ in range(maxNewTokens - 1):   # token 0 came from prefill —
            logits, caches = self.decodeStep(tok, caches)   # N-1 steps
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
