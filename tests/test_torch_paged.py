"""Port parity of the paged KV path the continuous batcher decodes
through: ``paged_attention``, ``TransformerLM``'s paged builders
(``buildPagedDecodeFn``, ``buildPagedProposeFn``,
``buildPagedPrefillWriteFn``) and ``KVCachePool``'s host bookkeeping,
each against the JAX package's on the same seeded numpy inputs.

Tolerances: attention contexts and pool contents within atol 1e-5 (the
port runs float32; the reference's LM computes in float64 and stores its
pools in float32, ROADMAP C1).  Page 0 is the scratch page every inactive
slot writes at once — which write lands there is unspecified in both
packages — so it is never compared.  Greedy tokens follow the near-tie
rule of ``tests/_torch_serving.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import NEAR_TIE, assert_tokens, lm_pair
from deeplearning4j_tpu.nn.conf.attention import \
    paged_attention as jax_paged_attention
from deeplearning4j_tpu.remote.scheduler import KVCachePool as JaxPool
from deeplearning4j_tpu_torch.nn.conf.attention import (KVCache,
                                                        cached_attention,
                                                        paged_attention)
from deeplearning4j_tpu_torch.remote.scheduler import KVCachePool

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
PS = 4          # page size of the builder tests


def _pool_close(port, ref):
    """Every page but the scratch page 0 within ATOL (the page axis is
    the fourth from last: (..., pages, heads, pageSize, headSize))."""
    port, ref = port.numpy(), np.asarray(ref)
    ax = port.ndim - 4
    np.testing.assert_allclose(np.delete(port, 0, axis=ax),
                               np.delete(ref, 0, axis=ax), atol=ATOL,
                               rtol=0)


# (tq, pos, start, scratch tail): tq 1 at a page's last offset; tq 5
# crossing a page boundary with start > 0; scratch entries in the table
CASES = {"tq1": (1, [3, 7, 10], [0, 0, 0], False),
         "tq5_cross_page_start": (5, [2, 6, 9], [1, 2, 3], False),
         "tq5_scratch_tail": (5, [2, 3, 6], [0, 1, 2], True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_attention_matches_reference(case):
    tq, pos, start, scratch = CASES[case]
    rng = np.random.RandomState(len(case))
    S, h, d, P = 3, 2, 8, 4
    pages = 1 + S * P
    pk = rng.randn(pages, h, PS, d).astype(np.float32)
    pv = rng.randn(pages, h, PS, d).astype(np.float32)
    table = rng.permutation(np.arange(1, pages)).reshape(S, P).astype(
        np.int32)
    if scratch:     # unallocated tails point at the scratch page
        for s, p in enumerate(pos):
            table[s, -(-(p + tq) // PS):] = 0
    q, k, v = (rng.randn(S, h, tq, d).astype(np.float32) for _ in range(3))
    pos, start = np.asarray(pos, np.int32), np.asarray(start, np.int32)
    jctx, jk, jv = jax_paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, pk, pv, table, pos, start)))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    ctx, rk, rv = paged_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), tk, tv,
        torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(start))
    assert rk is tk and rv is tv            # written in place
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=ATOL,
                               rtol=0)
    _pool_close(tk, jk)
    _pool_close(tv, jv)
    # every new position landed in its own page and offset
    for s in range(S):
        for i in range(tq):
            w = int(pos[s]) + i
            np.testing.assert_array_equal(
                tk[table[s, w // PS], :, w % PS].numpy(), k[s, :, i])


def test_paged_attention_matches_cached_attention():
    """The page-table lookup is the dense KVCache's attention (the
    reference's own check, on the port)."""
    rng = np.random.RandomState(0)
    S, h, d, P = 2, 2, 4, 3
    q, k, v = (torch.from_numpy(rng.randn(S, h, 1, d).astype(np.float32))
               for _ in range(3))
    hist_k = rng.randn(S, h, P * PS, d).astype(np.float32)
    hist_v = rng.randn(S, h, P * PS, d).astype(np.float32)
    pos, start = 7, 2
    cache = KVCache(torch.from_numpy(hist_k.copy()),
                    torch.from_numpy(hist_v.copy()), pos,
                    torch.full((S,), start))
    ref, _ = cached_attention(q, k, v, cache)
    poolK = torch.zeros((1 + S * P, h, PS, d))
    poolV = torch.zeros_like(poolK)
    table = torch.zeros((S, P), dtype=torch.int32)
    for s in range(S):
        table[s] = torch.arange(1 + s * P, 1 + (s + 1) * P)
        for i, pid in enumerate(table[s].tolist()):
            poolK[pid] = torch.from_numpy(hist_k[s][:, i * PS:(i + 1) * PS])
            poolV[pid] = torch.from_numpy(hist_v[s][:, i * PS:(i + 1) * PS])
    got, pk, _ = paged_attention(q, k, v, poolK, poolV, table,
                                 torch.full((S,), pos),
                                 torch.full((S,), start))
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(pk[table[0, pos // PS], :, pos % PS],
                               k[0, :, 0])


def test_paged_attention_rejects_misshapen_writes():
    pool = torch.zeros((3, 2, PS, 8))
    q = torch.zeros((1, 2, 1, 8))
    with pytest.raises(ValueError, match="do not fit"):
        paged_attention(q, torch.zeros((1, 2, 1, 4)), q, pool, pool.clone(),
                        torch.ones((1, 2), dtype=torch.int32),
                        torch.zeros(1), torch.zeros(1))


# ---------------------------------------------------------------------------
# the paged builders
# ---------------------------------------------------------------------------

def _ref_step_logits(jlm, poolK, poolV, toks, table, pos, start):
    """The reference's paged step up to its logits (``_paged_step_math``
    returns only the argmax), on copies of its pools."""
    p = jlm.params
    tq = toks.shape[1]
    pos_ids = jnp.clip((pos - start)[:, None] + jnp.arange(tq), 0,
                       jlm.config.maxLen - 1)
    x = p["emb"][toks] + p["pos"][pos_ids]
    for li, lp in enumerate(p["layers"]):
        x, _, _ = jlm._paged_block(lp, x, poolK[li], poolV[li], table, pos,
                                   start)
    return np.asarray(jlm._logits(p, x))


def _greedy_close(got, ref_logits, min_share=0.5):
    """Greedy tokens equal wherever the reference's top two logits are
    at least NEAR_TIE apart (most positions must be)."""
    got = np.asarray(got)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] >= NEAR_TIE
    assert clear.mean() >= min_share
    np.testing.assert_array_equal(got[clear],
                                  np.argmax(ref_logits, axis=-1)[clear])


@pytest.fixture(scope="module")
def filled():
    """Both LMs and their pools after prefill writes of three ragged
    prompts (bucket 16, page size 4) through each package's
    ``buildPagedPrefillWriteFn``: slot s holds pages
    [1 + 6s, 7 + 6s)."""
    jlm, tlm = lm_pair()
    c = tlm.config
    S, P, Tp = 3, 6, 16
    shape = (c.nLayers, 1 + S * P, c.nHeads, PS, c.headSize)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    table = np.arange(1, 1 + S * P, dtype=np.int32).reshape(S, P)
    jwrite, twrite = jlm.buildPagedPrefillWriteFn(), \
        tlm.buildPagedPrefillWriteFn()
    rng = np.random.RandomState(11)
    lens, first, tfirst, prompts = [5, 16, 9], [], [], []
    for s, n in enumerate(lens):
        toks = np.zeros((1, Tp), np.int32)
        toks[0, Tp - n:] = rng.randint(0, c.vocabSize, n)
        prompts.append(toks[0, Tp - n:])
        jl, jks, jvs = jlm.prefillRaw(toks, lengths=[n])
        tl, tks, tvs = tlm.prefillRaw(toks, lengths=[n])
        ids = table[s, :Tp // PS]
        jk, jv = jwrite(jk, jv, jks[:, 0], jvs[:, 0], jnp.asarray(ids))
        rk, rv = twrite(tk, tv, tks[:, 0], tvs[:, 0], ids)
        assert rk is tk and rv is tv
        first.append(int(np.argmax(np.asarray(jl)[0])))
        tfirst.append(int(torch.argmax(tl[0])))
    pos = np.full((S,), Tp, np.int32)
    start = np.asarray([Tp - n for n in lens], np.int32)
    return dict(jlm=jlm, tlm=tlm, jk=jk, jv=jv, tk=tk, tv=tv, table=table,
                pos=pos, start=start, tok=np.asarray(first, np.int32),
                ttok=np.asarray(tfirst, np.int32), prompts=prompts)


def test_prefill_write_matches_reference(filled):
    f = filled
    _pool_close(f["tk"], f["jk"])
    _pool_close(f["tv"], f["jv"])
    assert float(f["tk"][:, 1:].abs().sum()) > 0


@pytest.mark.parametrize("tq", [1, 3])
def test_decode_fn_matches_reference(filled, tq):
    """tq 1: the decode step; tq 3: a verify step, crossing from the
    prompt's last page into the next (positions 16-18)."""
    f = filled
    toks = np.concatenate(
        [f["tok"][:, None],
         np.random.RandomState(tq).randint(0, 64, (3, tq - 1))],
        axis=1).astype(np.int32)
    jk, jv = jnp.array(f["jk"]), jnp.array(f["jv"])
    tk, tv = f["tk"].clone(), f["tv"].clone()
    args = (f["table"], f["pos"], f["start"])
    ref_logits = _ref_step_logits(f["jlm"], jnp.array(jk), jnp.array(jv),
                                  jnp.asarray(toks),
                                  *(jnp.asarray(a) for a in args))
    jg, jk, jv = f["jlm"].buildPagedDecodeFn()(
        f["jlm"].params, jk, jv, jnp.asarray(toks),
        *(jnp.asarray(a) for a in args))
    g, rk, _ = f["tlm"].buildPagedDecodeFn()(tk, tv, toks, *args)
    assert rk is tk and g.dtype == torch.int32 and g.shape == (3, tq)
    _greedy_close(g.numpy(), ref_logits)
    _greedy_close(np.asarray(jg), ref_logits)
    _pool_close(tk, jk)
    _pool_close(tv, jv)


def test_propose_fn_matches_reference(filled):
    """draftK 3: four greedy steps, three proposals, four positions of K/V
    paged in (the last proposal's included)."""
    f = filled
    jk, jv = jnp.array(f["jk"]), jnp.array(f["jv"])
    tk, tv = f["tk"].clone(), f["tv"].clone()
    args = (f["table"], f["pos"], f["start"])
    jp, jk, jv = f["jlm"].buildPagedProposeFn(3)(
        f["jlm"].params, jk, jv, jnp.asarray(f["tok"]),
        *(jnp.asarray(a) for a in args))
    props, _, _ = f["tlm"].buildPagedProposeFn(3)(tk, tv, f["tok"], *args)
    assert props.dtype == torch.int32 and props.shape == (3, 3)
    # the proposals are the greedy tokens the reference's logits give
    # along its own proposals (teacher-forced through one verify pass)
    toks = np.concatenate([f["tok"][:, None], np.asarray(jp)], axis=1)
    ref_logits = _ref_step_logits(
        f["jlm"], jnp.array(f["jk"]), jnp.array(f["jv"]), jnp.asarray(toks),
        *(jnp.asarray(a) for a in args))[:, :3]
    clear = np.all(np.diff(np.sort(ref_logits, -1)[..., -2:], axis=-1)[..., 0]
                   >= NEAR_TIE, axis=1)
    assert clear.sum() >= 2
    np.testing.assert_array_equal(props.numpy()[clear], np.asarray(jp)[clear])
    for s in np.nonzero(clear)[0]:      # the K/V of the rows that agree
        for w in range(16, 20):
            pid = f["table"][s, w // PS]
            np.testing.assert_allclose(tk[:, pid, :, w % PS].numpy(),
                                       np.asarray(jk)[:, pid, :, w % PS],
                                       atol=ATOL, rtol=0)


def test_paged_greedy_equals_generate(filled):
    """Decoding a slot through the paged step gives ``generate``'s tokens
    for its prompt (the paged pool is the dense cache's attention)."""
    f = filled
    tlm = f["tlm"]
    tk, tv = f["tk"].clone(), f["tv"].clone()
    step = tlm.buildPagedDecodeFn()
    pos, tok, out = f["pos"].copy(), f["ttok"].copy(), [f["ttok"].copy()]
    for _ in range(7):
        g, _, _ = step(tk, tv, tok[:, None], f["table"], pos, f["start"])
        tok = g[:, 0].numpy()
        pos += 1
        out.append(tok.copy())
    out = np.stack(out, axis=1)
    ref = [tlm.generate(p[None], 8)[0] for p in f["prompts"]]
    assert_tokens(f["jlm"], f["prompts"], out, ref)


# ---------------------------------------------------------------------------
# KVCachePool host bookkeeping
# ---------------------------------------------------------------------------

def test_kv_cache_pool_bookkeeping_step_for_step():
    """The same seeded sequence of ``ensure`` / ``release`` through both
    pools: the same verdicts, page tables, held ids and free counts after
    every operation (the free list's order decides which pages a slot
    gets)."""
    kw = dict(pageSize=4, numPages=13, maxSlots=3, maxPagesPerSeq=5)
    jp = JaxPool(1, 2, 8, **kw)
    tp = KVCachePool(1, 2, 8, device="cpu", **kw)
    assert tuple(tp.k.shape) == tuple(jp.k.shape) == (1, 13, 2, 4, 8)
    rng = np.random.RandomState(0)
    for _ in range(200):
        slot = int(rng.randint(3))
        if rng.rand() < 0.3:
            assert tp.release(slot) == jp.release(slot)
        else:
            upTo = int(rng.randint(0, 24))
            assert tp.ensure(slot, upTo) == jp.ensure(slot, upTo)
        np.testing.assert_array_equal(tp.pageTable, jp.pageTable)
        assert tp.freePages() == jp.freePages()
        assert tp.usedPages() == jp.usedPages()
        assert [tp.heldIds(s) for s in range(3)] == \
            [jp.heldIds(s) for s in range(3)]
    assert tp.capacityTokens() == jp.capacityTokens() == 20
    assert tp.pagesFor(9) == jp.pagesFor(9) == 3
    with pytest.raises(ValueError, match="must exceed"):
        KVCachePool(1, 2, 8, pageSize=4, numPages=5, maxPagesPerSeq=5,
                    device="cpu")
