"""Port parity: B4, the matrix product with the BatchNorm statistics in its
epilogue (``deeplearning4j_tpu_torch/ops/fused.py``), against the JAX
package's ``ops/pallas_fused.py``.

On the CPU the port's ``matmul_bn_stats`` runs its plain version (the
Hopper kernel ``csrc/matmul_bn_stats.cu`` runs only on a CUDA tensor,
checked on the card by ``chip_smoke.py``); the JAX kernel runs in Pallas's
interpret mode, as ``tests/test_pallas_fused.py`` runs it.  Inputs come
from a seeded numpy RandomState and go to both.

Tolerances: y is the same f32 product, rounded once to x's dtype, in both:
f32 y differs by summation order only (atol 1e-5 on values up to ~10);
bf16 y is compared to one bf16 ulp (a bf16 value's spacing is at most
2**-7 of it, so rtol 2**-7): a product near a rounding boundary may land on
the other side.  The column sums add M values in another order than the
TPU kernel's tile-by-tile sweep, so they hold to a relative 1e-5 of Σ|y|
and of Σy² (float32 epsilon times the depth of the sums' trees, with
margin).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_fused as jf
from deeplearning4j_tpu_torch.ops import fused as tf

pytestmark = pytest.mark.torch_port

SUM_RTOL = 1e-5
BF16_ULP = 2.0 ** -7


def _sums_close(got, want, scale):
    """|got - want| <= SUM_RTOL * scale, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= SUM_RTOL * scale + 1e-6), \
        float(np.abs(got - want).max())


def _check_against(jout, tout, x32, w32):
    """Hold the port's (y, s, ss) against a JAX (y, s, ss)."""
    jy, js, jss = (np.asarray(a.astype(jnp.float32)) for a in jout)
    ty, ts, tss = (a.float().numpy() for a in tout)
    y32 = x32.astype(np.float64) @ w32.astype(np.float64)
    if tout[0].dtype == torch.bfloat16:
        np.testing.assert_allclose(ty, jy, rtol=BF16_ULP, atol=1e-6)
    else:
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    _sums_close(ts, js, np.abs(y32).sum(0))
    _sums_close(tss, jss, (y32 * y32).sum(0))


def _bf16(a):
    """numpy f32 -> (JAX bf16, torch bf16, the bf16 values as f32)."""
    j = jnp.asarray(a, jnp.bfloat16)
    f = np.asarray(j.astype(jnp.float32))
    return j, torch.from_numpy(f.copy()).to(torch.bfloat16), f


def test_matmul_bn_stats_f32_matches_pallas_kernel():
    """tests/test_pallas_fused.py's f32 shape and blocks."""
    rng = np.random.RandomState(0)
    x = rng.randn(1024, 192).astype(np.float32)
    w = (rng.randn(192, 256) * 0.05).astype(np.float32)
    jout = jf.matmul_bn_stats(jnp.asarray(x), jnp.asarray(w), block_m=256,
                              block_n=128, interpret=True)
    tout = tf.matmul_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    assert tout[0].dtype == torch.float32 and tout[0].shape == (1024, 256)
    assert tout[1].shape == tout[2].shape == (256,)
    _check_against(jout, tout, x, w)


def test_matmul_bn_stats_bf16_sums_the_unrounded_product():
    """bf16 inputs: y in bf16, the sums in f32 of the unrounded product —
    as the Pallas kernel, not as ``matmul_bn_stats_reference``, which
    rounds y first."""
    rng = np.random.RandomState(1)
    jx, tx, x32 = _bf16(rng.randn(512, 128))
    jw, tw, w32 = _bf16(rng.randn(128, 128) * 0.05)
    jout = jf.matmul_bn_stats(jx, jw, block_m=256, interpret=True)
    tout = tf.matmul_bn_stats(tx, tw)
    assert tout[0].dtype == torch.bfloat16
    assert tout[1].dtype == tout[2].dtype == torch.float32
    _check_against(jout, tout, x32, w32)
    # the rounded-y sums of the reference function are further away
    rs = np.asarray(jf.matmul_bn_stats_reference(jx, jw)[1])
    assert np.abs(rs - tout[1].numpy()).max() > \
        10 * np.abs(np.asarray(jout[1]) - tout[1].numpy()).max()


def test_conv1x1_bn_stats_matches_pallas_kernel():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    w = (rng.randn(32, 64) * 0.1).astype(np.float32)
    jy, js, jss = jf.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                      block_m=256, block_n=64,
                                      interpret=True)
    ty, ts, tss = tf.conv1x1_bn_stats(torch.from_numpy(x),
                                      torch.from_numpy(w))
    assert ty.shape == (2, 16, 16, 64)
    _check_against((jy.reshape(-1, 64), js, jss),
                   (ty.reshape(-1, 64), ts, tss), x.reshape(-1, 32), w)


@pytest.mark.parametrize("m,k,n", [(1000, 72, 40), (7, 16, 8), (12544, 8, 3),
                                   (33, 1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_shapes_match_the_reference_function(m, k, n, dtype):
    """Shapes the Pallas kernel's tiling refuses (M, N not multiples of
    its blocks), against ``matmul_bn_stats_reference`` on the f32 values
    (for bf16: the product of the bf16 inputs in f32, the kernel's
    arithmetic)."""
    rng = np.random.RandomState(m + k + n)
    x, w = rng.randn(m, k), rng.randn(k, n) / np.sqrt(k)
    if dtype == "bfloat16":
        _, tx, x32 = _bf16(x)
        _, tw, w32 = _bf16(w)
    else:
        x32, w32 = x.astype(np.float32), w.astype(np.float32)
        tx, tw = torch.from_numpy(x32), torch.from_numpy(w32)
    jout = jf.matmul_bn_stats_reference(jnp.asarray(x32), jnp.asarray(w32))
    tout = tf.matmul_bn_stats(tx, tw)
    assert tout[0].dtype == tx.dtype and tout[0].shape == (m, n)
    _check_against(jout, tout, x32, w32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_function_matches(dtype):
    rng = np.random.RandomState(5)
    x, w = rng.randn(300, 48), rng.randn(48, 24) * 0.2
    if dtype == "bfloat16":
        jx, tx, x32 = _bf16(x)
        jw, tw, w32 = _bf16(w)
    else:
        x32, w32 = x.astype(np.float32), w.astype(np.float32)
        jx, jw = jnp.asarray(x32), jnp.asarray(w32)
        tx, tw = torch.from_numpy(x32), torch.from_numpy(w32)
    jout = jf.matmul_bn_stats_reference(jx, jw)
    tout = tf.matmul_bn_stats_reference(tx, tw)
    assert tout[0].dtype == tx.dtype
    ty, jy = tout[0].float().numpy(), np.asarray(jout[0].astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(ty, jy, rtol=BF16_ULP, atol=1e-6)
        # both sum the rounded y, so the sums are near each other's
        yr = jy.astype(np.float64)
    else:
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
        yr = x32.astype(np.float64) @ w32
    for g, j, scale in ((tout[1], jout[1], np.abs(yr).sum(0)),
                        (tout[2], jout[2], (yr * yr).sum(0))):
        # bf16: one y in 256 may round the other way, moving a sum by an
        # ulp of that y
        tol = SUM_RTOL if dtype == "float32" else 2 * BF16_ULP
        assert np.all(np.abs(g.numpy() - np.asarray(j)) <= tol * scale
                      + 1e-6)


def test_bn_moments_from_the_sums():
    """mean = s/M and var = ss/M − mean² match the mean and biased
    variance over y's rows — BatchNorm's use of the sums."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(768, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 64) * 0.1).astype(np.float32))
    y, s, ss = tf.matmul_bn_stats(x, w)
    mean = s / 768
    var = ss / 768 - mean * mean
    torch.testing.assert_close(mean, y.mean(0), atol=1e-5, rtol=0)
    torch.testing.assert_close(var, y.var(0, unbiased=False), atol=1e-5,
                               rtol=0)


def test_cpu_calls_do_not_count_as_launches():
    before = tf.matmul_bn_stats.launches
    tf.matmul_bn_stats(torch.ones(4, 3), torch.ones(3, 2))
    tf.conv1x1_bn_stats(torch.ones(1, 2, 2, 3), torch.ones(3, 2))
    assert tf.matmul_bn_stats.launches == before == 0


def test_inputs_are_checked():
    with pytest.raises(ValueError, match="x \\(M, K\\)"):
        tf.matmul_bn_stats(torch.ones(4, 3), torch.ones(2, 2))
    with pytest.raises(TypeError, match="one dtype"):
        tf.matmul_bn_stats(torch.ones(4, 3), torch.ones(3, 2,
                                                        dtype=torch.float64))
    with pytest.raises(TypeError, match="one dtype"):
        tf.matmul_bn_stats(torch.ones(4, 3, dtype=torch.float16),
                           torch.ones(3, 2, dtype=torch.float16))
    with pytest.raises(ValueError, match="0 < M"):
        tf.matmul_bn_stats(torch.ones(0, 3), torch.ones(3, 2))


def test_devices_other_than_cpu_and_cuda_raise():
    """Only a CPU tensor takes the plain version: any device but the CPU
    and CUDA raises rather than falling back (a CUDA tensor needs the card,
    and ``chip_smoke.py`` runs it there)."""
    x = torch.ones(4, 3, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tf.matmul_bn_stats(x, torch.ones(3, 2, device="meta"))


# Shapes for the kernel's layout: aligned ones (passed as they are) and
# ones whose K or N rows are not 16-byte multiples in one dtype or both.
LAYOUT_SHAPES = [(1024, 192, 256), (200, 64, 64), (1000, 72, 40), (7, 16, 8),
                 (12544, 8, 3), (33, 1, 1), (300, 36, 130)]


def _layout_inputs(m, k, n, dtype):
    rng = np.random.RandomState(m + 7 * k + 13 * n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32))
    dt = getattr(torch, dtype)
    return x.to(dt), w.to(dt)


@pytest.mark.parametrize("m,k,n", LAYOUT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_padding_keeps_the_plain_result(m, k, n, dtype):
    """The wrapper's layout step pads x's and w's K and w's N with zeros to
    16-byte rows; the plain function on the padded operands, sliced back,
    gives the plain function's result on the originals.  The zero columns
    add exact zeros to every product, but the padded product may be blocked
    differently, so f32 y and the sums hold to 1e-6 relative; bf16 y, the
    same f32 value rounded once, to one bf16 ulp."""
    x, w = _layout_inputs(m, k, n, dtype)
    xp, wp = tf._mm_layout(x, w)
    per = 16 // x.element_size()
    kp, np_ = -(-k // per) * per, -(-n // per) * per
    assert xp.shape == (m, kp) and wp.shape == (kp, np_)
    assert xp.dtype == wp.dtype == x.dtype
    assert torch.equal(xp[:, :k], x) and not xp[:, k:].any()
    assert torch.equal(wp[:k, :n], w) and not wp[k:].any() \
        and not wp[:, n:].any()
    if (kp, np_) == (k, n):
        assert xp is x and wp is w
    y, s, ss = tf._mm_unpad(*tf.matmul_bn_stats_plain(xp, wp), n)
    ry, rs, rss = tf.matmul_bn_stats_plain(x, w)
    assert y.shape == ry.shape and s.shape == rs.shape == ss.shape == (n,)
    assert y.dtype == x.dtype and y.is_contiguous()
    if dtype == "bfloat16":
        torch.testing.assert_close(y.float(), ry.float(), rtol=BF16_ULP,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(y, ry, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(ss, rss, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("m,k,n", LAYOUT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_rows_are_16_byte_multiples(m, k, n, dtype):
    """What TMA needs of every operand the kernel maps: contiguous, a
    16-byte aligned base and row strides of a multiple of 16 bytes — x, w
    and y (M, Np), whose rows are w's."""
    x, w = _layout_inputs(m, k, n, dtype)
    for a in tf._mm_layout(x, w):
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
        assert a.stride(0) * a.element_size() % 16 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_realigns_a_misaligned_operand(dtype):
    """An operand of aligned rows whose data does not start on 16 bytes,
    or that is not contiguous, is copied: the values are kept."""
    x, w = _layout_inputs(64, 32, 16, dtype)
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    shifted = buf[1:].view(64, 32)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    xp, wp = tf._mm_layout(shifted, w.t().contiguous().t())
    assert xp.data_ptr() % 16 == 0 and torch.equal(xp, x)
    assert wp.is_contiguous() and torch.equal(wp, w)
