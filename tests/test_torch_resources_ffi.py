"""The runtime leftovers of ROADMAP A12h beside the AOT cache: the port's
``utils/resources.py`` held to ``tests/test_datavec_breadth.py``'s body in
both packages, and ``native/ffi.py`` — the native kernels as torch custom
ops, the twin of ``native/xla_ffi.py`` — held to ``tests/test_native.py``'s
FFI bodies and, bit for bit, to the reference's own lowering of the bitmap
codec at n = 1, 15, 16, 17 and 10,001."""
import ctypes
import hashlib
import importlib
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.native import ffi

pytestmark = pytest.mark.torch_port

TAU = 0.7
SIZES = (1, 15, 16, 17, 10_001)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests' small CPU ops run on one intra-op thread: beside the
    suite's other workers, a thread pool per op mostly waits."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# utils/resources.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["deeplearning4j_tpu",
                                 "deeplearning4j_tpu_torch"])
def test_resources_and_downloader(pkg, tmp_path, monkeypatch):
    """``test_datavec_breadth.py``'s body, run against each package."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    utils = importlib.import_module(f"{pkg}.utils")
    DL4JResources, Downloader, Resources = (
        utils.DL4JResources, utils.Downloader, utils.Resources)
    d = DL4JResources.getDirectory("datasets", "mnist")
    assert os.path.isdir(d) and str(tmp_path) in d
    (tmp_path / "fixture.txt").write_text("hello")
    Resources.registerDirectory(str(tmp_path))
    assert Resources.asFile("fixture.txt").endswith("fixture.txt")
    assert Resources.exists("fixture.txt")
    assert not Resources.exists("nope.bin")
    # downloader resolves from the local mirror with checksum check
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    payload = b"weights-blob"
    (mirror / "vgg16.bin").write_bytes(payload)
    md5 = hashlib.md5(payload).hexdigest()
    target = str(tmp_path / "cache" / "vgg16.bin")
    got = Downloader.download("vgg16", "http://x/y/vgg16.bin", target,
                              md5=md5)
    assert open(got, "rb").read() == payload
    # cached + checksum-verified on re-call
    assert Downloader.download("vgg16", "http://x/y/vgg16.bin", target,
                               md5=md5) == target
    with pytest.raises(FileNotFoundError, match="mirror"):
        Downloader.download("absent", "http://x/absent.bin",
                            str(tmp_path / "c2" / "absent.bin"))
    with pytest.raises(IOError, match="checksum"):
        Downloader.download("vgg16", "http://x/y/vgg16.bin",
                            str(tmp_path / "c3" / "v.bin"), md5="0" * 32)


def test_downloader_refetches_a_corrupt_cached_file(tmp_path, monkeypatch):
    """A cached target whose checksum no longer matches is replaced from
    the mirror, in both packages alike."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    payload = b"weights-blob"
    md5 = hashlib.md5(payload).hexdigest()
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    (mirror / "w.bin").write_bytes(payload)
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_tpu_torch"):
        Downloader = importlib.import_module(f"{pkg}.utils").Downloader
        target = tmp_path / pkg / "w.bin"
        target.parent.mkdir()
        target.write_bytes(b"torn")
        Downloader.download("w", "http://x/w.bin", str(target), md5=md5)
        assert target.read_bytes() == payload


# ---------------------------------------------------------------------------
# native/ffi.py
# ---------------------------------------------------------------------------

def test_the_four_ops_are_registered_under_dl4j():
    for name in ("threshold_count", "bitmap_encode", "bitmap_decode",
                 "philox_uniform"):
        assert callable(getattr(torch.ops.dl4j, name))
    assert ffi.register() is native.available() is True


def test_ffi_custom_calls():
    """``test_native.py::test_xla_ffi_custom_calls``'s body on the port:
    the count as an op and inside a function, and the graph-side Philox
    equal to the host stream bit for bit."""
    g = np.random.RandomState(0).randn(1000).astype(np.float32)
    assert int(ffi.threshold_count(g, 0.5)) == int((np.abs(g) >= 0.5).sum())

    def twice(x):
        return ffi.threshold_count(x, 0.5) * 2

    assert int(twice(torch.from_numpy(g))) == \
        2 * int((np.abs(g) >= 0.5).sum())
    u = ffi.philox_uniform(42, 0, 64)
    assert u.device.type == "cpu" and u.dtype == torch.float32
    lib = native._load()
    host = np.zeros(64, np.float32)
    lib.dl4j_philox_uniform(
        42, 0, host.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 64)
    np.testing.assert_array_equal(u.numpy(), host)
    np.testing.assert_array_equal(u.numpy(), native.philox_uniform(42, 0,
                                                                   64))


def test_ffi_bitmap_encode_decode_roundtrip():
    """``test_native.py::test_xla_ffi_bitmap_encode_decode_roundtrip``'s
    body on the port's ops."""
    rng = np.random.RandomState(3)
    r = rng.randn(1000).astype(np.float32)
    tau = 0.7
    new_r, words, count = ffi.bitmap_encode(torch.from_numpy(r), tau)
    new_r, words = new_r.numpy(), words
    mask_p, mask_n = r >= tau, r <= -tau
    assert int(count) == int(mask_p.sum() + mask_n.sum())
    # residual semantics: +/-tau subtracted exactly where encoded
    np.testing.assert_allclose(new_r[mask_p], r[mask_p] - tau, atol=1e-6)
    np.testing.assert_allclose(new_r[mask_n], r[mask_n] + tau, atol=1e-6)
    np.testing.assert_array_equal(new_r[~(mask_p | mask_n)],
                                  r[~(mask_p | mask_n)])

    delta = ffi.bitmap_decode(words, tau, r.size).numpy()
    np.testing.assert_allclose(delta[mask_p], tau, atol=1e-6)
    np.testing.assert_allclose(delta[mask_n], -tau, atol=1e-6)
    assert (delta[~(mask_p | mask_n)] == 0).all()
    # encode(x) + decode == x wherever |x| < 2*tau (single-step mass)
    np.testing.assert_allclose((new_r + delta)[np.abs(r) < 2 * tau],
                               r[np.abs(r) < 2 * tau], atol=1e-6)


def _codec_input(n):
    rng = np.random.RandomState(n)
    r = rng.randn(n).astype(np.float32)
    r[::7] = np.float32(TAU)          # the >= / <= boundaries exactly
    r[3::11] = -np.float32(TAU)
    return r


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("n", SIZES)
def test_bitmap_codec_equals_the_references_lowering_bit_for_bit(
        n, monkeypatch):
    """The reference's pure-XLA lowering (its off-CPU path, forced here),
    the port's CPU op (the native kernel) and the port's CUDA lowering
    (run on CPU tensors): new residual, words, count and the decoded delta
    bit-equal."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.native import xla_ffi
    monkeypatch.setattr(xla_ffi, "register", lambda: False)
    r = _codec_input(n)
    ref_r, ref_w, ref_c = xla_ffi.bitmap_encode(jnp.asarray(r), TAU)
    ref_d = xla_ffi.bitmap_decode(ref_w, TAU, n)
    ops = ffi.bitmap_encode(torch.from_numpy(r), TAU)
    low = ffi._bitmap_encode_cuda(torch.from_numpy(r), TAU)
    for new_r, words, count in (ops, low):
        assert words.dtype == torch.uint32 and words.numel() == (n + 15) // 16
        np.testing.assert_array_equal(_bits(new_r.numpy()), _bits(ref_r))
        np.testing.assert_array_equal(words.view(torch.int32).numpy(),
                                      _bits(ref_w))
        assert int(count) == int(ref_c) and count.dtype == torch.int64
        for d in (ffi.bitmap_decode(words, TAU, n),
                  ffi._bitmap_decode_cuda(words, TAU, n)):
            np.testing.assert_array_equal(_bits(d.numpy()), _bits(ref_d))


def test_ops_raise_without_the_native_library(monkeypatch):
    """Where the native library cannot be had, the CPU ops raise, as the
    reference's ``philox_uniform`` does: nothing falls back."""
    monkeypatch.setattr(native, "_load", lambda: None)
    x = torch.ones(20)
    for call in (lambda: ffi.threshold_count(x, 0.5),
                 lambda: ffi.bitmap_encode(x, 0.5),
                 lambda: ffi.bitmap_decode(torch.zeros(2, dtype=torch.int32)
                                           .view(torch.uint32), 0.5, 20),
                 lambda: ffi.philox_uniform(1, 0, 8)):
        with pytest.raises(RuntimeError, match="native library"):
            call()


def test_the_ops_fake_kernels_agree_with_the_real_ones():
    """``torch.library.opcheck`` on the CPU: schema, fake (meta) kernels
    and registration of each op agree with what it computes."""
    r = torch.from_numpy(_codec_input(33))
    words = ffi.bitmap_encode(r, TAU)[1]
    torch.library.opcheck(torch.ops.dl4j.bitmap_encode.default, (r, TAU))
    torch.library.opcheck(torch.ops.dl4j.bitmap_decode.default,
                          (words, TAU, 33))
    torch.library.opcheck(torch.ops.dl4j.threshold_count.default, (r, TAU))
