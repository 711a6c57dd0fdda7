"""Port parity: ``deeplearning4j_tpu_torch`` attention against the JAX
package — ``parallel.ring`` (dense, blockwise, the flash kernel's plain
version, the dispatch) and ``nn.conf.attention`` (``KVCache``,
``cached_attention``).

The same float32 inputs, drawn from a seeded numpy RandomState, go through
both packages.  Both compute in float32 here, so outputs agree to float32
rounding of different summation orders: atol 1e-5 on values of order 1 (the
tolerance ``tests/test_ring.py`` holds the JAX kernels to against dense).
The Pallas kernel runs as the JAX package's own tests run it on the CPU, in
interpret mode.  The Hopper kernel itself runs only on the card
(``chip_smoke.py``); on the CPU the wrappers take its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import attention as jatt
from deeplearning4j_tpu.parallel import ring as jring
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.nn.conf import attention as tatt
from deeplearning4j_tpu_torch.parallel import ring as tring

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
_FLASH = tring.flash_attention   # holds the launch counter


def _qkv(b=2, h=2, tq=32, tk=None, d=8, seed=0):
    rng = np.random.RandomState(seed)
    tk = tq if tk is None else tk
    return (rng.randn(b, h, tq, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# flash: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_matches_pallas_interpret(causal):
    q, k, v = _qkv(b=2, h=2, tq=32, d=8, seed=1)
    ref_out = jring.flash_attention(q, k, v, causal=causal, block_q=8,
                                    block_k=8, interpret=True)
    _, ref_lse = jring._flash_forward(q, k, v, causal, 8, 8, True)
    out, lse = tring.flash_attention_reference(*_t(q, k, v), causal)
    assert out.dtype == torch.float32 and lse.shape == (4, 32)
    _close(out, ref_out)
    _close(lse, np.asarray(ref_lse)[..., 0])


@pytest.mark.parametrize("tq,tk,causal", [(70, 70, False), (70, 70, True),
                                          (16, 40, False), (100, 30, True)])
def test_flash_reference_ragged_matches_dense(tq, tk, causal):
    """Shapes that are not a multiple of the kernel's 64-key tile, and
    tq != tk (causal is top-left aligned: key j visible to query i iff
    j <= i)."""
    q, k, v = _qkv(b=1, h=2, tq=tq, tk=tk, d=8, seed=2)
    ref = jring.dot_product_attention(q, k, v, causal=causal, impl="dense")
    out, lse = tring.flash_attention_reference(*_t(q, k, v), causal)
    _close(out, ref)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8.0)
    if causal:
        s = np.where(np.arange(tk)[None, :] <= np.arange(tq)[:, None], s,
                     -np.inf)
    mx = s.max(-1, keepdims=True)
    ref_lse = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    _close(lse, ref_lse.reshape(2, tq), atol=1e-4)


def test_flash_on_cpu_runs_plain_version_without_counting():
    q, k, v = _t(*_qkv(seed=3))
    before = tring.flash_attention.launches
    out = tring.flash_attention(q, k, v, causal=True)
    out2, lse = tring.flash_forward(q, k, v, causal=True)
    ref, ref_lse = tring.flash_attention_reference(q, k, v, True)
    assert torch.equal(out, ref) and torch.equal(out2, ref)
    assert torch.equal(lse, ref_lse)
    assert tring.flash_attention.launches == before


def test_flash_reference_bf16_rounds_p_like_the_kernel():
    """bf16 inputs: scores accumulate in f32, p is rounded to bf16 before
    P·V (B1's ``p.astype(v.dtype)``) and O comes back in bf16."""
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(seed=4)))
    out, lse = tring.flash_attention_reference(q, k, v, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = jring.flash_attention(*(jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16)
                                  for x in (q, k, v)),
                                causal=True, block_q=8, block_k=8,
                                interpret=True)
    # one bf16 ulp at |O| <= 4 is 2^-6; both round the same f32 sums
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), atol=1.6e-2)


@pytest.mark.parametrize("bad,exc", [
    (dict(d=256), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(kshape=(2, 2, 8, 4)), ValueError),
])
def test_flash_kernel_input_checks(bad, exc):
    d = bad.get("d", 8)
    q = torch.zeros((2, 2, 8, d), dtype=bad.get("dtype", torch.float32))
    k = torch.zeros(bad.get("kshape", (2, 2, 8, d)), dtype=q.dtype)
    with pytest.raises(exc):
        tring._check_flash_inputs(q, k, k)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 12, 16, 64, 128])
def test_flash_layout_padding_keeps_the_plain_result(d, dtype, causal,
                                                     monkeypatch):
    """The wrapper's layout step: zero-padded operands, the unpadded scale,
    O sliced back, equal the plain version on the original operands (so the
    kernel, handed that layout, computes the same function)."""
    q, k, v = (x.to(dtype) for x in _t(*_qkv(b=1, h=2, tq=70, tk=90, d=d,
                                               seed=20 + d)))
    ref, ref_lse = tring.flash_attention_reference(q, k, v, causal)
    qf, kf, vf, dp = tring._flash_layout(q, k, v)
    assert dp * q.element_size() % 16 == 0 and dp - d < 16 // q.element_size()
    assert qf.shape == (1, 2, 70, dp)
    assert kf.shape == vf.shape == (1, 2, 90, dp)
    for x in (qf, kf, vf):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
        assert not x[..., d:].any()
    monkeypatch.setattr(tring, "_scale", lambda _: 1.0 / np.sqrt(d))
    out, lse = tring.flash_attention_reference(qf, kf, vf, causal)
    assert not out[..., d:].float().any()
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else \
        dict(atol=2 ** -7, rtol=2 ** -7)    # one bf16 ulp of |O| <= 1
    torch.testing.assert_close(out[..., :d].float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=1e-6)


def test_flash_layout_copies_misaligned_views_and_nothing_else():
    """A contiguous view whose storage offset breaks 16-byte alignment is
    copied into a fresh aligned tensor; an aligned operand is passed as it
    is."""
    q, k, v = _t(*_qkv(b=1, h=2, tq=8, d=8, seed=30))
    buf = torch.zeros(q.numel() + 1)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    qf, kf, vf, dp = tring._flash_layout(shifted, k, v)
    assert dp == 8 and qf.data_ptr() % 16 == 0
    assert qf.data_ptr() != shifted.data_ptr()
    assert torch.equal(qf, q)
    assert kf is k and vf is v


def test_kernel_target_changes_with_a_header(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) renames every kernel's
    library, so no stale build is loaded."""
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    before = kernels._target(src)
    assert kernels._target(src) == before
    (tmp_path / "h.cuh").write_text("// v2\n")
    after = kernels._target(src)
    assert after != before and after.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert kernels._target(src) not in (before, after)


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(["flash_attn_fwd"])


# ---------------------------------------------------------------------------
# blockwise and dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,masked,causal", [(32, False, False),
                                             (30, False, False),
                                             (30, True, False),
                                             (30, True, True),
                                             (32, False, True)])
def test_blockwise_matches_jax(t, masked, causal):
    q, k, v = _qkv(tq=t, seed=5)
    mask = (np.random.RandomState(6).rand(2, t) > 0.3).astype(np.float32) \
        if masked else None
    ref = jring.blockwise_attention(q, k, v, mask=mask, causal=causal,
                                    block_k=8)
    out = tring.blockwise_attention(
        *_t(q, k, v), mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, block_k=8)
    _close(out, ref)


@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_dense_matches_jax(masked, causal):
    q, k, v = _qkv(tq=24, seed=7)
    mask = (np.random.RandomState(8).rand(2, 24) > 0.3).astype(np.float32) \
        if masked else None
    ref = jring.dot_product_attention(q, k, v, mask=mask, causal=causal,
                                      impl="dense")
    out = tring.dot_product_attention(
        *_t(q, k, v), mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, impl="dense")
    _close(out, ref)


@pytest.mark.parametrize("masked,causal", [(True, False), (False, True),
                                           (True, True)])
def test_dense_float16_matches_jax(masked, causal):
    """float16, where the auto rule sends what the flash kernels refuse: the
    mask floor is taken in s's dtype (-inf: float16 cannot hold -1e30), as
    the reference's ``jnp.asarray(_NEG, s.dtype)``."""
    q, k, v = (x.astype(np.float16) for x in _qkv(tq=24, seed=41))
    mask = (np.random.RandomState(42).rand(2, 24) > 0.3).astype(np.float32) \
        if masked else None
    if masked:
        mask[:, 0] = 1      # every row keeps a key
    ref = jring.dot_product_attention(q, k, v, mask=mask, causal=causal,
                                      impl="dense")
    out = tring.dot_product_attention(
        *_t(q, k, v), mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, impl="dense")
    assert out.dtype == torch.float16 and out.isfinite().all()
    # float16 keeps 11 bits: a few ulps of |O| <= 2 between two orders
    _close(out.float(), np.asarray(ref, np.float32), atol=4e-3)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.fixture
def flash_spy(monkeypatch):
    calls = []

    def spy(q, k, v, causal=False):
        calls.append(tuple(q.shape))
        return _FLASH(q, k, v, causal)
    monkeypatch.setattr(tring, "flash_attention", spy)
    return calls


def test_auto_never_picks_flash_for_cpu_tensors(flash_spy):
    q, k, v = _t(*_qkv(b=1, h=1, tq=1024, d=4, seed=9))
    before = _FLASH.launches
    out = tring.dot_product_attention(q, k, v, causal=True)
    ref = tring.dot_product_attention(q, k, v, causal=True, impl="dense")
    assert torch.equal(out, ref)
    assert flash_spy == [] and _FLASH.launches == before


def test_masked_batch_never_reaches_flash(flash_spy):
    q, k, v = _t(*_qkv(tq=16, seed=10))
    mask = torch.from_numpy(
        (np.random.RandomState(11).rand(2, 16) > 0.3).astype(np.float32))
    out = tring.dot_product_attention(q, k, v, mask=mask, causal=True,
                                      impl="flash")
    ref = tring.blockwise_attention(q, k, v, mask=mask, causal=True)
    assert torch.equal(out, ref) and flash_spy == []
    tring.dot_product_attention(q, k, v, causal=True, impl="flash")
    assert flash_spy == [(2, 2, 16, 8)]


# The auto rule (ROADMAP C6) on meta tensors: shapes and dtypes without
# memory, so b·h past 65535 costs nothing.  (b, h) factor each b·h.
_BH = {65535: (257, 255), 65536: (256, 256)}


@pytest.mark.parametrize("cuda", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tq", [1023, 1024])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", sorted(_BH))
@pytest.mark.parametrize("d", [128, 129, 256])
def test_auto_picks_flash_exactly_where_the_kernels_take_it(d, bh, dtype, tq,
                                                            masked, cuda):
    b, h = _BH[bh]
    q = torch.empty((b, h, tq, d), dtype=dtype, device="meta")
    kv = torch.empty((b, h, tq + 7, d), dtype=dtype, device="meta")
    try:
        tring._check_flash_inputs(q, kv, kv)
        accepted = True
    except (TypeError, ValueError):
        accepted = False
    # what the kernels' C entry points take (csrc/flash_attn_*.cu)
    assert accepted == (d <= 128 and bh <= 65535
                        and dtype in (torch.float32, torch.bfloat16))
    picked = tring._auto_impl(q.shape, kv.shape, kv.shape, (dtype,) * 3,
                              masked, cuda)
    want = accepted and cuda and not masked and tq >= 1024
    assert picked == ("flash" if want else "dense")


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
])
def test_auto_never_picks_flash_for_mixed_dtypes(dtypes):
    q, k, v = (torch.empty((1, 2, 1024, 64), dtype=t, device="meta")
               for t in dtypes)
    with pytest.raises(TypeError, match="one dtype"):
        tring._check_flash_inputs(q, k, v)
    assert tring._auto_impl(q.shape, k.shape, v.shape, dtypes, False,
                            True) == "dense"
    assert tring._auto_impl(q.shape, k.shape, v.shape, (dtypes[0],) * 3,
                            False, True) == "flash"


def test_wide_single_head_layer_matches_jax_and_avoids_flash():
    """``SelfAttentionLayer(nHeads=1, nOut=256)`` at t 1024: a head of 256,
    which the flash kernels refuse.  On the card the auto rule sends it to
    dense; here both packages run dense from the same copied params."""
    rng = np.random.RandomState(40)
    nin, t = 8, 1024
    kw = dict(nIn=nin, nHeads=1, nOut=256)
    jl, tl = jatt.SelfAttentionLayer(**kw), tatt.SelfAttentionLayer(**kw)
    for layer in (jl, tl):
        layer.inferNIn(None)
    assert jl.headSize == tl.headSize == 256
    params = {k: rng.randn(*s).astype(np.float32) * 0.06
              for k, s in (("Wq", (nin, 256)), ("Wk", (nin, 256)),
                           ("Wv", (nin, 256)), ("Wo", (256, 256)))}
    x = rng.randn(1, nin, t).astype(np.float32)
    ref, _ = jl.forward(params, x, False, None, {})
    out, _ = tl.forward({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), False, None, {})
    assert out.shape == (1, 256, t)
    _close(out, ref)
    qh = (1, 1, t, 256)
    assert tring._auto_impl(qh, qh, qh, (torch.float32,) * 3, False,
                            True) == "dense"


def test_ring_and_unknown_impl_raise():
    q, k, v = _t(*_qkv(tq=8, seed=12))
    # the ring runs over the active mesh's seq axis (ROADMAP A10a): with
    # none active it raises, as the reference's does
    with pytest.raises(ValueError, match="needs an active mesh"):
        tring.dot_product_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tring.dot_product_attention(q, k, v, impl="sparse")


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _caches(b=2, h=2, cap=16, d=8, pos=5, start=(0, 2), seed=13):
    rng = np.random.RandomState(seed)
    k0 = rng.randn(b, h, cap, d).astype(np.float32)
    v0 = rng.randn(b, h, cap, d).astype(np.float32)
    start = np.asarray(start, np.int32)
    jc = jatt.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                      jnp.asarray(pos, jnp.int32), jnp.asarray(start))
    tc = tatt.KVCache(torch.from_numpy(k0.copy()),
                      torch.from_numpy(v0.copy()), pos,
                      torch.from_numpy(start).long())
    return jc, tc


@pytest.mark.parametrize("tq", [1, 3])
def test_cached_attention_matches_jax(tq):
    jc, tc = _caches()
    q, kn, vn = _qkv(b=2, h=2, tq=tq, d=8, seed=14)
    jctx, jnew = jatt.cached_attention(q, kn, vn, jc)
    tctx, tnew = tatt.cached_attention(*_t(q, kn, vn), tc)
    _close(tctx, jctx)
    _close(tnew.k, jnew.k, atol=0)
    _close(tnew.v, jnew.v, atol=0)
    assert tnew.pos == int(jnew.pos) == 5 + tq
    # the port writes in place: the new cache shares the old buffers
    assert tnew.k.data_ptr() == tc.k.data_ptr()


def test_cached_attention_rollback_over_shared_buffers():
    """Speculative roll-back: write 3 positions, rebuild the cache one
    position in, and write again — the stale K/V are overwritten before
    they are attended, as in the JAX package's immutable version."""
    jc, tc = _caches(seed=15)
    q, kn, vn = _qkv(b=2, h=2, tq=3, d=8, seed=16)
    _, jc = jatt.cached_attention(q, kn, vn, jc)
    _, tc = tatt.cached_attention(*_t(q, kn, vn), tc)
    jc = jatt.KVCache(jc.k, jc.v, jnp.asarray(6, jnp.int32), jc.start)
    tc = tatt.KVCache(tc.k, tc.v, 6, tc.start)
    q2, kn2, vn2 = _qkv(b=2, h=2, tq=2, d=8, seed=17)
    jctx, _ = jatt.cached_attention(q2, kn2, vn2, jc)
    tctx, _ = tatt.cached_attention(*_t(q2, kn2, vn2), tc)
    _close(tctx, jctx)


def test_cached_attention_rejects_overflow():
    _, tc = _caches(cap=16, pos=15)
    q, kn, vn = _t(*_qkv(b=2, h=2, tq=2, d=8, seed=18))
    with pytest.raises(ValueError, match="overflows the cache capacity"):
        tatt.cached_attention(q, kn, vn, tc)


def test_kvcache_create_matches_jax_layout():
    jc = jatt.KVCache.create(2, 3, 10, 4, start=[1, 0])
    tc = tatt.KVCache.create(2, 3, 10, 4, start=[1, 0], device="cpu")
    assert tuple(tc.k.shape) == jc.k.shape and tc.capacity == jc.capacity
    assert tc.pos == int(jc.pos) == 0
    assert tc.start.tolist() == np.asarray(jc.start).tolist()
    assert not tc.k.any() and not tc.v.any()
