"""Port parity: the dataset iterators and normalizers
(``deeplearning4j_tpu_torch/datasets``) against the JAX package's.

The iterators make the reference's numpy draws, so the same arguments
give the same batches bit for bit, in the same order, across ``reset``:
the synthetic MNIST, CIFAR-10, EMNIST and Iris sets, MNIST and CIFAR-10
read from files in ``$DL4J_TPU_DATA_DIR``, and the array iterators.  The
normalizers' statistics are float64 sums in a different order (numpy's
and torch's): they and the transformed features hold to 1e-6.
"""
import gzip
import logging
import struct

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu_torch.datasets as tds
from deeplearning4j_tpu_torch.datasets import fetchers as tfetchers

from _torch_parity import _np

pytestmark = pytest.mark.torch_port

NORM_TOL = dict(atol=1e-6, rtol=1e-6)


def _batches(it, epochs=2):
    """Every batch of ``epochs`` passes (reset before each) as numpy."""
    out = []
    for _ in range(epochs):
        it.reset()
        while it.hasNext():
            ds = it.next()
            out.append((_np(ds.features), _np(ds.labels)))
    return out


def _assert_same_batches(jit, tit, epochs=2):
    jb, tb = _batches(jit, epochs), _batches(tit, epochs)
    assert len(jb) == len(tb) > 0
    for (jf, jl), (tf, tl) in zip(jb, tb):
        assert tf.dtype == jf.dtype and tl.dtype == jl.dtype
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tl, jl)


@pytest.fixture(autouse=True)
def _no_data_dir(monkeypatch, tmp_path):
    """No real data unless a test writes some: an empty data dir and a
    HOME without ``.deeplearning4j_tpu``."""
    monkeypatch.delenv("DL4J_TPU_DATA_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


@pytest.mark.parametrize("kw", [
    dict(batch=64, train=True, seed=123, numExamples=300),
    dict(batch=50, train=False, seed=7, numExamples=200),
    dict(batch=64, train=True, seed=123, numExamples=256, shuffle=False),
    dict(batch=32, train=True, seed=5, numExamples=96, binarize=True)],
    ids=["train", "test", "no-shuffle", "binarize"])
def test_synthetic_mnist_batches_bit_for_bit(kw):
    jit, tit = jds.MnistDataSetIterator(**kw), tds.MnistDataSetIterator(**kw)
    assert tit.isSynthetic and jit.isSynthetic
    assert (tit.batch(), tit.totalOutcomes(), tit.inputColumns()) == \
        (jit.batch(), jit.totalOutcomes(), jit.inputColumns())
    _assert_same_batches(jit, tit)


def test_synthetic_mnist_bytes_equal_the_reference():
    from deeplearning4j_tpu.datasets import mnist as jmnist
    from deeplearning4j_tpu_torch.datasets import mnist as tmnist
    for seed in (123, 124):
        ji, jl = jmnist._synthesize(500, seed)
        ti, tl = tmnist._synthesize(500, seed)
        assert ti.dtype == ji.dtype == np.uint8
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("form", ["idx", "idx.gz", "npz"])
def test_mnist_reads_files_from_the_data_dir(form, tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (70, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 70).astype(np.uint8)
    d = tmp_path / "data"
    d.mkdir()
    if form == "npz":
        np.savez(d / "mnist_t10k.npz", images=images, labels=labels)
    else:
        sfx = ".gz" if form == "idx.gz" else ""
        _write_idx(d / f"t10k-images-idx3-ubyte{sfx}", images, bool(sfx))
        _write_idx(d / f"t10k-labels-idx1-ubyte{sfx}", labels, bool(sfx))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(d))
    kw = dict(batch=16, train=False, seed=9, numExamples=60)
    jit, tit = jds.MnistDataSetIterator(**kw), tds.MnistDataSetIterator(**kw)
    assert not tit.isSynthetic and not jit.isSynthetic
    _assert_same_batches(jit, tit)
    np.testing.assert_array_equal(
        np.sort(_np(tit._f), axis=0),
        np.sort(images[:60].reshape(60, 784) / np.float32(255.0), axis=0))


@pytest.mark.parametrize("name,args", [
    ("Cifar10DataSetIterator", (32, True, 123, 80)),
    ("Cifar10DataSetIterator", (20, False, 4, 50)),
    ("EmnistDataSetIterator", ("LETTERS", 32, True, 123, 100)),
    ("EmnistDataSetIterator", ("BALANCED", 25, False, 2, 60)),
    ("IrisDataSetIterator", ()),
    ("IrisDataSetIterator", (40, 90, 11))],
    ids=lambda v: str(v))
def test_fetcher_iterators_bit_for_bit(name, args):
    jit, tit = getattr(jds, name)(*args), getattr(tds, name)(*args)
    assert getattr(tit, "isSynthetic", True) == \
        getattr(jit, "isSynthetic", True)
    assert tit.totalOutcomes() == jit.totalOutcomes()
    _assert_same_batches(jit, tit)


def test_cifar10_reads_binary_batches(tmp_path, monkeypatch):
    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    rng = np.random.RandomState(8)
    rec = rng.randint(0, 256, (30, 3073)).astype(np.uint8)
    rec[:, 0] %= 10
    (base / "test_batch.bin").write_bytes(rec.tobytes())
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    jit = jds.Cifar10DataSetIterator(8, False, 1, 25)
    tit = tds.Cifar10DataSetIterator(8, False, 1, 25)
    assert not tit.isSynthetic and not jit.isSynthetic
    _assert_same_batches(jit, tit)


def test_fetch_retries_then_falls_back(caplog):
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("mirror hiccup")

    with caplog.at_level(logging.WARNING):
        got = tfetchers._fetch_with_retries("cifar10", flaky, attempts=3,
                                            baseDelay=0.0)
    assert got is None and len(calls) == 3
    assert "falling back to the synthetic set" in caplog.text
    assert tfetchers._fetch_with_retries("x", lambda: (1, 2)) == (1, 2)


def test_array_iterators_bit_for_bit():
    rng = np.random.RandomState(4)
    f = rng.randn(37, 5).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 37)]
    for shuffle in (False, True):
        _assert_same_batches(
            jds.INDArrayDataSetIterator(f, l, 8, shuffle=shuffle, seed=2),
            tds.INDArrayDataSetIterator(f, l, 8, shuffle=shuffle, seed=2),
            epochs=3)
    sets = [(f[i:i + 10], l[i:i + 10]) for i in range(0, 37, 10)]
    jit = jds.ExistingDataSetIterator([jds.DataSet(*p) for p in sets])
    tit = tds.ExistingDataSetIterator([tds.DataSet(*p) for p in sets])
    _assert_same_batches(jit, tit)
    assert [d.numExamples() for d in tit] == [10, 10, 10, 7]


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------

def _norm_data():
    rng = np.random.RandomState(6)
    return [(rng.randn(12, 2, 3, 3).astype(np.float32) * 4 + 1,
             np.eye(2, dtype=np.float32)[rng.randint(0, 2, 12)])
            for _ in range(3)]


@pytest.mark.parametrize("kind", ["NormalizerStandardize",
                                  "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler"])
def test_normalizers_match_the_reference(kind):
    data = _norm_data()
    args = (-1.0, 2.0) if kind == "NormalizerMinMaxScaler" else ()
    jn, tn = getattr(jds, kind)(*args), getattr(tds, kind)(*args)
    jn.fit(jds.ListDataSetIterator([jds.DataSet(*p) for p in data]))
    tn.fit(tds.ListDataSetIterator([tds.DataSet(*p) for p in data]))
    for attr in ("mean", "std", "dataMin", "dataMax"):
        if hasattr(jn, attr):
            np.testing.assert_allclose(getattr(tn, attr), getattr(jn, attr),
                                       **NORM_TOL)
    f, l = data[1]
    jd, td = jds.DataSet(f, l), tds.DataSet(f, l)
    jn.transform(jd)
    tn.transform(td)
    assert td.features.dtype == torch.float32
    np.testing.assert_allclose(_np(td.features), jd.features.numpy(),
                               **NORM_TOL)
    jn.revert(jd)
    tn.revert(td)
    np.testing.assert_allclose(_np(td.features), jd.features.numpy(),
                               **NORM_TOL)
    np.testing.assert_allclose(_np(td.features), f, atol=1e-4)
    # as an iterator's preprocessor: every batch, the cached sets untouched
    it = tds.ListDataSetIterator([tds.DataSet(*p) for p in data])
    it.setPreProcessor(tn)
    got = [_np(d.features) for d in it]
    jit = jds.ListDataSetIterator([jds.DataSet(*p) for p in data])
    jit.setPreProcessor(jn)
    want = [d.features.numpy() for d in jit]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **NORM_TOL)
    np.testing.assert_array_equal(_np(it._ds[0].features), data[0][0])


def test_standardize_save_load_both_ways(tmp_path):
    data = _norm_data()
    tn = tds.NormalizerStandardize()
    tn.fit(tds.DataSet(*data[0]))
    tn.save(tmp_path / "port.npz")
    back = jds.NormalizerStandardize.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(back.mean, tn.mean)
    np.testing.assert_array_equal(back.std, tn.std)
    jn = jds.NormalizerStandardize()
    jn.fit(jds.DataSet(*data[0]))
    jn.save(tmp_path / "jax.npz")
    back = tds.NormalizerStandardize.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(back.mean, jn.mean)
    assert back.std.dtype == np.float64


# ---------------------------------------------------------------------------
# DataSet's methods (reference datasets/dataset.py:47-140)
# ---------------------------------------------------------------------------

def _ds_pair(masks=True):
    """The same DataSet in both packages: 10 examples of (3, 4) features,
    one-hot labels and, with ``masks``, (10, 4) masks."""
    rng = np.random.RandomState(41)
    arrs = [rng.randn(10, 3, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, 10)]]
    if masks:
        arrs += [(rng.rand(10, 4) > 0.3).astype(np.float32),
                 (rng.rand(10, 4) > 0.5).astype(np.float32)]
    return jds.DataSet(*arrs), tds.DataSet(*arrs)


def _parts(ds):
    return [None if a is None else _np(a) for a in
            (ds.features, ds.labels, ds.featuresMask, ds.labelsMask)]


def _assert_same(jd, td):
    for a, b in zip(_parts(jd), _parts(td)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", [0, 7, None])
def test_shuffle_gives_the_references_order(seed):
    """``RandomState(seed).permutation``, over every array; a None seed
    draws from the OS in both, so only the pairing of rows is held."""
    jd, td = _ds_pair()
    jd.shuffle(seed)
    td.shuffle(seed)
    if seed is None:
        f, l = _parts(td)[:2]
        _, t0 = _ds_pair()
        order = [int(np.argmax((_np(t0.features) == row).all(axis=(1, 2))))
                 for row in f]
        np.testing.assert_array_equal(l, _np(t0.labels)[order])
        return
    _assert_same(jd, td)


@pytest.mark.parametrize("k", [0.7, 3, 0.0, 10])
def test_split_test_and_train(k):
    jd, td = _ds_pair()
    js, ts = jd.splitTestAndTrain(k), td.splitTestAndTrain(k)
    _assert_same(js.getTrain(), ts.getTrain())
    _assert_same(js.getTest(), ts.getTest())
    assert type(ts).__name__ == "SplitTestAndTrain"


@pytest.mark.parametrize("masks", [True, False])
def test_sample_merge_and_as_list(masks):
    jd, td = _ds_pair(masks)
    _assert_same(jd.sample(4, seed=3), td.sample(4, seed=3))
    parts = [_ds_pair(masks), _ds_pair(False)]
    _assert_same(jds.DataSet.merge([p[0] for p in parts]),
                 tds.DataSet.merge([p[1] for p in parts]))
    _assert_same(jds.DataSet.merge([jd, jd]), tds.DataSet.merge([td, td]))
    jl, tl = jd.asList(), td.asList()
    assert len(jl) == len(tl) == 10
    for a, b in zip(jl, tl):
        _assert_same(a, b)


@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages(writer, masks, tmp_path):
    """The reference's ``.npz`` keys: a file either package writes loads
    in the other, array for array."""
    jd, td = _ds_pair(masks)
    path = str(tmp_path / "ds.npz")
    (jd if writer == "jax" else td).save(path)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["features", "labels"] + (["featuresMask", "labelsMask"]
                                      if masks else []))
    _assert_same(jds.DataSet.load(path), tds.DataSet.load(path))
    _assert_same(jd, tds.DataSet.load(path))


def test_get_offsets():
    offsets = np.array([0, 2, 5], np.int64)
    td = tds.DataSet(np.zeros((2, 3)), np.zeros((2, 1)), offsets=offsets)
    np.testing.assert_array_equal(_np(td.getOffsets()), offsets)
    assert tds.DataSet(np.zeros((1, 1))).getOffsets() is None
