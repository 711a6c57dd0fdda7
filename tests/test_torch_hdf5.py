"""The port's HDF5 reader (``deeplearning4j_tpu_torch/imports/hdf5.py``)
against h5py: every committed Keras fixture and files written here with
h5py, object by object — the visit order, every attribute (value and
Python type, as h5py gives them), every dataset's shape, dtype and
values — and the refusals outside the subset keras writes."""
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.imports import hdf5  # noqa: E402

pytestmark = pytest.mark.torch_port

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MANIFEST = "keras_fixtures_manifest.json"


def _same_attrs(a, b):
    assert list(b.attrs.keys()) == sorted(a.attrs.keys())
    for k in a.attrs.keys():
        u, v = a.attrs[k], b.attrs[k]
        assert isinstance(v, bytes) == isinstance(u, bytes), k
        assert isinstance(v, str) == isinstance(u, str), k
        if isinstance(u, np.ndarray):
            assert (u.dtype, u.shape) == (v.dtype, v.shape), k
            assert (u == v).all(), k
        else:
            assert u == v, k


def _same_as_h5py(source):
    """Every object of ``source`` (a path or bytes) read by both readers."""
    def opened(mod):
        return mod.File(source if isinstance(source, str)
                        else io.BytesIO(source), "r")
    with opened(h5py) as a, opened(hdf5) as b:
        na, nb = [], []
        a.visititems(lambda n, o: na.append(n))
        b.visititems(lambda n, o: nb.append(n))
        assert na == nb
        _same_attrs(a, b)
        for n in na:
            x, y = a[n], b[n]
            assert isinstance(y, hdf5.Dataset) == isinstance(x, h5py.Dataset)
            _same_attrs(x, y)
            if isinstance(x, h5py.Dataset):
                assert (x.shape, x.dtype) == (y.shape, y.dtype), n
                u, v = x[()], y[()]
                assert type(u) is type(v) or isinstance(u, np.ndarray), n
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
            else:
                assert list(x.keys()) == list(y.keys())
        return len(na)


def _fixture_files():
    out = [os.path.join(FIXTURES, f) for f in sorted(os.listdir(FIXTURES))
           if f.endswith(".h5")]
    return out + [os.path.join(FIXTURES, f) for f in sorted(
        os.listdir(FIXTURES)) if f.endswith(".keras")]


def _weights_of(path):
    if path.endswith(".keras"):
        with zipfile.ZipFile(path) as z:
            return z.read("model.weights.h5")
    return path


@pytest.mark.parametrize("path", _fixture_files(), ids=os.path.basename)
def test_committed_fixture_reads_as_h5py_reads_it(path):
    assert _same_as_h5py(_weights_of(path)) > 10


@pytest.mark.parametrize("path", _fixture_files(), ids=os.path.basename)
def test_committed_fixture_matches_its_manifest(path):
    """The manifest ``chip_smoke``'s ``keras_hdf5`` phase checks on the
    card, where h5py is absent, read here against the port's reader."""
    with open(os.path.join(FIXTURES, MANIFEST)) as fh:
        man = json.load(fh)
    key = os.path.basename(path) + (":model.weights.h5"
                                    if path.endswith(".keras") else "")
    want = man[key]
    src = _weights_of(path)
    f = hdf5.File(src if isinstance(src, str) else io.BytesIO(src))
    groups, datasets, attrs = [], {}, {"/": list(f.attrs.keys())}

    def visit(name, obj):
        attrs[name] = list(obj.attrs.keys())
        if isinstance(obj, hdf5.Dataset):
            datasets[name] = [list(obj.shape), obj.dtype.str, obj.allocated]
        else:
            groups.append(name)
    f.visititems(visit)
    assert groups == want["groups"]
    assert datasets == want["datasets"]
    assert attrs == want["attrs"]


def test_resnet50_skeleton_holds_no_weights():
    f = hdf5.File(os.path.join(FIXTURES, "keras_resnet50_skeleton.h5"))
    found = []
    f.visititems(lambda n, o: found.append(o)
                 if isinstance(o, hdf5.Dataset) else None)
    assert len(found) == 320 and not any(d.allocated for d in found)
    assert not np.asarray(found[0]).any()           # unallocated: zeros
    assert len(f["model_weights"].keys()) == 178    # a multi-leaf B-tree
    assert len(f.attrs["model_config"]) > 100_000   # a GCOL vlen string


@pytest.fixture
def written(tmp_path):
    """A file written here with h5py: every datatype, dataspace and layout
    the reader takes."""
    p = str(tmp_path / "w.h5")
    with h5py.File(p, "w") as f:
        f.attrs["big"] = "x" * 150_000 + "é"               # 147 KB vlen
        f.attrs["names"] = np.array([b"alpha", b"be", b""])  # fixed length
        f.attrs["vnames"] = np.array(["a", "bc", "déf"],
                                     dtype=h5py.string_dtype())
        f.attrs["scalar_f"] = np.float64(2.5)
        f.attrs["scalar_i"] = np.int16(-3)
        f.attrs["fixed"] = np.bytes_(b"fixed")
        f.attrs["empty"] = np.zeros((0,), np.float64)
        f.attrs.create("arr", np.arange(3, dtype=np.float32),
                       dtype=np.dtype(("<f4", (3,))))
        for dt in ("<i1", "<u1", "<i2", "<u2", "<i4", "<u4", "<i8", "<u8",
                   "<f2", "<f4", "<f8"):
            f.create_dataset(f"numbers/{dt[1:]}",
                             data=(np.arange(24) - 7).astype(dt)
                             .reshape(2, 3, 4))
        f.create_dataset("scalar", data=np.float32(1.5))
        f.create_dataset("unallocated", shape=(5, 3), dtype="<f4")
        f.create_dataset("filled", shape=(4,), dtype="<f4", fillvalue=3.0)
        f.create_dataset("strings", data=np.array(["u", "vw"],
                                                  dtype=h5py.string_dtype()))
        big = f.create_group("many")
        for i in range(600):                     # a two-level B-tree
            big.create_group(f"g{i:04d}").attrs["i"] = i
        sid = h5py.h5s.create_simple((6,))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dset = h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F64LE, sid,
                               dcpl=dcpl)
        dset.write(h5py.h5s.ALL, h5py.h5s.ALL,
                   np.linspace(0, 1, 6).astype("<f8"))
    return p


def test_written_file_reads_as_h5py_reads_it(written):
    assert _same_as_h5py(written) > 600
    f = hdf5.File(written)
    assert f.attrs["big"].endswith("xé") and len(f.attrs["big"]) == 150_001
    np.testing.assert_array_equal(f["filled"][()], np.full(4, 3.0))
    assert not f["unallocated"].allocated and f["compact"].allocated
    assert "many/g0599" in f and "many/g0600" not in f
    with open(written, "rb") as fh:               # a binary file object
        assert _same_as_h5py(fh.read()) > 600


def test_reader_never_falls_back_to_h5py(written, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    f = hdf5.File(written)
    assert f["numbers/f4"][()].sum() == pytest.approx(
        float(np.arange(24).sum() - 7 * 24))


@pytest.mark.parametrize("kind,match", [
    ("chunked", "chunked layout"), ("gzip", "filter"),
    ("latest", "version 2 object header"), ("bigendian", "big-endian"),
    ("compound", "compound"), ("not_hdf5", "not an HDF5 file")])
def test_refusals_name_what_they_met(tmp_path, kind, match):
    p = str(tmp_path / "r.h5")
    if kind == "not_hdf5":
        with open(p, "wb") as fh:
            fh.write(b"\0" * 2048)
    else:
        kw = {"libver": "latest"} if kind == "latest" else {}
        with h5py.File(p, "w", **kw) as f:
            data = np.arange(64, dtype="<f4")
            if kind == "chunked":
                f.create_dataset("d", data=data, chunks=(16,))
            elif kind == "gzip":
                f.create_dataset("d", data=data, compression="gzip")
            elif kind == "bigendian":
                f.create_dataset("d", data=data.astype(">f4"))
            elif kind == "compound":
                f.create_dataset("d", data=np.zeros(
                    3, dtype=[("a", "<f4"), ("b", "<i4")]))
            else:
                f.create_dataset("d", data=data)
    with pytest.raises(ValueError, match=match):
        hdf5.File(p)["d"][()]


def test_only_read_mode():
    with pytest.raises(ValueError, match="only reads"):
        hdf5.File(os.path.join(FIXTURES, "keras_transformer_t2048.h5"), "w")
