"""Port parity: the flash-attention backward — ``parallel.ring``'s plain dq
and dk/dv versions (what the CPU runs in place of the Hopper kernels B2
and B3) and the ``FlashAttention`` autograd Function — against the JAX
package's Pallas backward (``_flash_backward``) and ``jax.grad``.

Inputs come from a seeded numpy RandomState and go through both packages.
The Pallas kernels run as the JAX package's own tests run them on the CPU,
in interpret mode, with asymmetric blocks (16 x 32, ``tests/test_ring.py``).
The Hopper kernels themselves run only on the card (``chip_smoke.py``).
Tolerances:

- float32: both sides sum the same f32 products in different orders;
  values of order 1 agree to atol 1e-5 (the forward's tolerance in
  ``tests/test_ring.py``);
- bfloat16 inputs: both sides round p and ds at the same points, but p is
  exp of an f32 score summed in another order, so a value within an ulp
  of a bf16 rounding boundary can round the other way; the outputs (f32
  sums rounded to bf16) then differ by about one bf16 ulp of their
  magnitude: atol and rtol 2^-7 (one bf16 ulp at 1; measured 0 here);
- gradients through the Function against ``jax.grad``: atol 1e-5, tighter
  than the 5e-3 ``tests/test_ring.py`` holds the JAX backward to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import ring as jring
from deeplearning4j_tpu_torch.parallel import ring as tring

pytestmark = pytest.mark.torch_port

F32_ATOL = 1e-5
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)
BQ, BK = 16, 32            # the Pallas blocks, as tests/test_ring.py


def _inputs(b=2, h=2, tq=64, tk=None, d=16, seed=0):
    rng = np.random.RandomState(seed)
    tk = tq if tk is None else tk
    return (rng.randn(b, h, tq, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tq, d).astype(np.float32))


def _pallas_backward(q, k, v, g, causal):
    """The JAX package's flash backward, fed as ``_flash_vjp_bwd`` feeds it:
    lse from ``_flash_forward`` and delta = rowsum(dO⊙O) (``ring.py:
    328-330``), both lane-replicated.  Returns lse, delta as (b·h, tq) and
    dq, dk, dv."""
    b, h, tq, _ = q.shape
    out, lse = jring._flash_forward(q, k, v, causal, BQ, BK, True)
    delta = jnp.broadcast_to(
        jnp.sum(g.astype(jnp.float32) * out.astype(jnp.float32),
                axis=-1).reshape(b * h, tq)[:, :, None], (b * h, tq, 128))
    grads = jring._flash_backward(q, k, v, g, lse, delta, causal, BQ, BK,
                                  True)
    return (np.asarray(lse[..., 0]), np.asarray(delta[..., 0]),
            *(np.asarray(x.astype(jnp.float32)) for x in grads))


def _port_backward(q, k, v, g, lse, delta, causal, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    rows = [torch.from_numpy(np.array(x)) for x in (lse, delta)]
    dq = tring.flash_bwd_dq(*t, *rows, causal)
    dk, dv = tring.flash_bwd_dkv(*t, *rows, causal)
    for x, ref in zip((dq, dk, dv), t[:3]):
        assert x.dtype == dtype and x.shape == ref.shape
    return [x.float().numpy() for x in (dq, dk, dv)]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret(causal):
    q, k, v, g = _inputs(seed=11)
    lse, delta, *ref = _pallas_backward(q, k, v, g, causal)
    for name, port, want in zip(("dq", "dk", "dv"),
                                _port_backward(q, k, v, g, lse, delta,
                                               causal), ref):
        np.testing.assert_allclose(port, want, atol=F32_ATOL, rtol=0,
                                   err_msg=f"{name} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_bf16_matches_pallas_interpret(causal):
    q, k, v, g = _inputs(seed=12)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
    lse, delta, *ref = _pallas_backward(*jb, causal)
    # the same bf16 values on both sides (round-to-nearest-even both ways)
    q, k, v, g = (np.asarray(x.astype(jnp.float32)) for x in jb)
    for name, port, want in zip(("dq", "dk", "dv"),
                                _port_backward(q, k, v, g, lse, delta,
                                               causal, torch.bfloat16), ref):
        np.testing.assert_allclose(port, want, **BF16_TOL,
                                   err_msg=f"{name} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grad_matches_jax_grad(causal):
    """Autograd through the port's ``flash_attention`` (on the CPU: the
    plain forward, then the plain dq and dk/dv through ``FlashAttention``)
    against ``jax.grad`` through the Pallas custom VJP."""
    q, k, v, _ = _inputs(seed=13)
    w = np.cos(np.arange(16, dtype=np.float32))

    def f_jax(q, k, v):
        return jnp.sum(jring.flash_attention(
            q, k, v, causal=causal, block_q=BQ, block_k=BK,
            interpret=True) * w)

    ref = jax.grad(f_jax, argnums=(0, 1, 2))(q, k, v)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tring.flash_attention(*qkv, causal=causal)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), qkv)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_ATOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("tq,tk,causal", [(70, 70, False), (70, 70, True),
                                          (16, 40, False), (100, 30, True),
                                          (130, 130, True)])
def test_flash_attention_grad_ragged_matches_dense(tq, tk, causal):
    """Lengths that are not a multiple of the kernels' 64-wide tiles (and
    tq != tk, causal top-left aligned): the reference's Pallas path needs
    t divisible by its blocks, so these hold to ``jax.grad`` of dense
    attention."""
    q, k, v, g = _inputs(b=1, h=2, tq=tq, tk=tk, d=8, seed=14)

    def f_dense(q, k, v):
        return jnp.sum(jring.dot_product_attention(
            q, k, v, causal=causal, impl="dense") * g)

    ref = jax.grad(f_dense, argnums=(0, 1, 2))(q, k, v)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tring.flash_attention(*qkv, causal=causal),
                              qkv, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_ATOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("mask", [False, True])
def test_dispatch_flash_impl_gradient_matches_dense(mask):
    """``dot_product_attention(impl="flash")`` is differentiable: unmasked
    through ``FlashAttention``, masked through blockwise attention (the
    flash kernels take no key mask)."""
    q, k, v, g = _inputs(b=2, h=2, tq=40, d=8, seed=15)
    m = np.ones((2, 40), np.float32)
    m[1, 30:] = 0
    km = torch.from_numpy(m) if mask else None
    ref = jax.grad(lambda q, k, v: jnp.sum(jring.dot_product_attention(
        q, k, v, mask=m if mask else None, impl="dense") * g),
        argnums=(0, 1, 2))(q, k, v)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tring.dot_product_attention(
        *qkv, mask=km, impl="flash"), qkv, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_cpu_tensors_never_count_launches():
    before = (tring.flash_attention.launches, tring.flash_bwd_dq.launches,
              tring.flash_bwd_dkv.launches)
    q, k, v, g = _inputs(b=1, h=1, tq=70, d=8, seed=16)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tring.flash_attention(*qkv, causal=True), qkv,
                        torch.from_numpy(g))
    lse = torch.zeros(1, 70)
    tring.flash_bwd_dq(*qkv[:3], torch.from_numpy(g), lse, lse)
    tring.flash_bwd_dkv(*qkv[:3], torch.from_numpy(g), lse, lse)
    assert (tring.flash_attention.launches, tring.flash_bwd_dq.launches,
            tring.flash_bwd_dkv.launches) == before


def test_no_grad_runs_the_forward_alone():
    q, k, v, _ = _inputs(b=1, h=1, tq=20, d=8, seed=17)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = tring.flash_attention(*qkv)
    assert out.grad_fn is None and not out.requires_grad
    ref, _ = tring.flash_attention_reference(*qkv)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("wrapper", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_wrappers_never_fall_back_off_the_cpu(wrapper):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses what is not CUDA."""
    q = torch.zeros((1, 1, 8, 4), device="meta")
    rows = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        getattr(tring, wrapper)(q, q, q, q, rows, rows)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 12, 16, 64, 128])
def test_backward_layout_padding_keeps_the_plain_result(d, dtype, causal,
                                                        monkeypatch):
    """The backward wrappers' layout step: zero-padded q, k, v and dO, the
    unpadded scale and dq, dk, dv sliced back equal the plain versions on
    the original operands (so the kernels, handed that layout, compute the
    same function), and the padded columns of dq, dk and dv are zero."""
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(b=1, h=2, tq=70, tk=90, d=d, seed=40 + d))
    out, lse = tring.flash_attention_reference(q, k, v, causal)
    delta = (g.float() * out.float()).sum(-1).reshape(2, 70)
    args = (lse, delta, causal)
    ref = (tring.flash_bwd_dq_reference(q, k, v, g, *args),
           *tring.flash_bwd_dkv_reference(q, k, v, g, *args))
    qf, kf, vf, gf, dp = tring._flash_layout(q, k, v, g)
    assert dp * q.element_size() % 16 == 0 and dp - d < 16 // q.element_size()
    assert qf.shape == gf.shape == (1, 2, 70, dp)
    assert kf.shape == vf.shape == (1, 2, 90, dp)
    for x in (qf, kf, vf, gf):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
        assert not x[..., d:].any()
    monkeypatch.setattr(tring, "_scale", lambda _: 1.0 / np.sqrt(d))
    got = (tring.flash_bwd_dq_reference(qf, kf, vf, gf, *args),
           *tring.flash_bwd_dkv_reference(qf, kf, vf, gf, *args))
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else BF16_TOL
    for name, x, want in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == dtype and x.shape[-1] == dp
        assert not x[..., d:].float().any(), name
        torch.testing.assert_close(x[..., :d].float(), want.float(), **tol,
                                   msg=name)
