"""The image pipeline of DataVec in the port (``datavec/image.py`` on the
port's own codec ``datavec/png.py``), held against PIL and the JAX
package:

- the PNG reader equals PIL's decode exactly for 8-bit L, LA, RGB, RGBA
  and palette images and for each of the five row filters (files written
  by PIL, and by a row-filter encoder here that forces each filter);
  PGM/PPM (``P5``/``P6``) likewise; what it does not read raises naming
  it, and a format that needs PIL raises naming the format when PIL is
  absent;
- ``convert`` equals PIL's L/RGB conversion exactly; the bilinear resize
  is within 1 of 255 of ``Image.resize(..., BILINEAR)`` (``RESIZE_TOL``;
  it is equal on every case here); the float rotation is within
  ``ROTATE_ULPS`` float32 ulps of PIL's ``"F"``-mode ``rotate``;
- ``NativeImageLoader``, ``ImageRecordReader`` with every
  ``ImageTransform`` and a seeded ``PipelineImageTransform``, and the
  ``RecordReaderDataSetIterator`` over it, give the reference's pixels and
  labels bit for bit on the same folder (shards and epochs too).
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import deeplearning4j_tpu.datavec as J
import deeplearning4j_tpu_torch.datavec as T
from deeplearning4j_tpu.datasets.normalizers import \
    ImagePreProcessingScaler as JScaler
from deeplearning4j_tpu_torch.datasets.normalizers import \
    ImagePreProcessingScaler as TScaler
from deeplearning4j_tpu_torch.datavec import image as timage
from deeplearning4j_tpu_torch.datavec import png

pytestmark = pytest.mark.torch_port

#: the resize's bound against PIL, in 8-bit levels
RESIZE_TOL = 1
#: the rotation's bound against PIL: float32 ulps of the largest value
ROTATE_ULPS = 2

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(h, w, c, seed):
    """A smooth image (so PIL's adaptive filter picks every filter type)
    with noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 5 + xx * 3)[:, :, None] + np.arange(c) * 40
    return ((base + rng.randint(0, 30, (h, w, c))) % 256).astype(np.uint8)


def _pil_png(path, arr, mode):
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_decode_equals_pil_for_every_colour_type(mode, tmp_path):
    arr = _image(37, 45, MODES[mode], 1)
    p = tmp_path / f"{mode}.png"
    _pil_png(p, arr, mode)
    px, got_mode, pal = png.read_image(p)
    assert got_mode == mode and pal is None
    np.testing.assert_array_equal(px.reshape(arr.shape), arr)
    for target in ("L", "RGB"):
        np.testing.assert_array_equal(
            png.convert(px, got_mode, pal, target),
            np.asarray(Image.open(p).convert(target)))


def test_palette_png_decodes_through_its_palette(tmp_path):
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 40, (21, 30)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.randint(0, 256, 40 * 3).tolist())
    p = tmp_path / "p.png"
    im.save(p)
    px, mode, pal = png.read_image(p)
    assert mode == "P"
    np.testing.assert_array_equal(px[..., 0], np.asarray(Image.open(p)))
    for target in ("L", "RGB"):
        np.testing.assert_array_equal(png.convert(px, mode, pal, target),
                                      np.asarray(Image.open(p).convert(
                                          target)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(arr, filters):
    """A PNG whose row y is filtered with ``filters[y % len(filters)]``."""
    h, w, c = arr.shape
    x = arr.astype(np.int64).reshape(h, w * c)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
                4: _paeth(left, up, ul)}[f]
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_each_row_filter_decodes_as_pil_does(filt, channels, tmp_path):
    arr = _image(19, 23, channels, 3)
    filters = [0, 1, 2, 3, 4] if filt == "mixed" else [filt]
    p = tmp_path / "f.png"
    p.write_bytes(_encode(arr, filters))
    np.testing.assert_array_equal(np.asarray(Image.open(p)).reshape(
        arr.shape), arr)                     # the file is a valid PNG
    np.testing.assert_array_equal(png.read_image(p)[0], arr)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_writer_output_reads_in_pil(channels, tmp_path):
    arr = _image(31, 17, channels, 4)
    p = tmp_path / "w.png"
    png.write_png(p, arr if channels > 1 else arr[..., 0])
    np.testing.assert_array_equal(
        np.asarray(Image.open(p)).reshape(arr.shape), arr)
    np.testing.assert_array_equal(png.read_image(p)[0], arr)


@pytest.mark.parametrize("kind", ["pgm", "ppm", "pgm_comment"])
def test_pnm_decodes_as_pil_does(kind, tmp_path):
    arr = _image(13, 11, 3, 5)
    p = tmp_path / f"x.{kind[:3]}"
    if kind == "pgm_comment":
        p.write_bytes(b"P5\n# a comment\n11 13\n255\n"
                      + arr[..., 0].tobytes())
    else:
        Image.fromarray(arr[..., 0] if kind == "pgm" else arr).save(p)
    px, mode, _ = png.read_image(p)
    assert mode == ("RGB" if kind == "ppm" else "L")
    np.testing.assert_array_equal(
        px.reshape(np.asarray(Image.open(p)).shape),
        np.asarray(Image.open(p)))


def test_unsupported_files_raise_naming_what_they_are(tmp_path,
                                                      monkeypatch):
    p16 = tmp_path / "i16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)).save(p16)
    with pytest.raises(ValueError, match="16 bits"):
        png.read_image(p16)
    raw = bytearray(_encode(_image(4, 4, 3, 0), [0]))
    raw[28] = 1                                   # IHDR interlace byte
    body = bytes(raw[12:29])
    raw[29:33] = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    pil = tmp_path / "interlaced.png"
    pil.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_image(pil)
    jpg = tmp_path / "x.jpg"
    Image.fromarray(_image(8, 8, 3, 0)).save(jpg)
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_image(jpg)
    loader = T.NativeImageLoader(8, 8, 3)
    assert loader.asMatrix(str(jpg)).shape == (3, 8, 8)   # PIL here
    monkeypatch.setattr(timage, "_pil", lambda: None)     # as on the card
    with pytest.raises(RuntimeError, match="JPG files needs PIL"):
        loader.asMatrix(str(jpg))
    png16 = T.NativeImageLoader(8, 8, 1)
    with pytest.raises(ValueError, match="16 bits"):
        png16.asMatrix(str(p16))


RESIZES = [(37, 45, 20, 30), (37, 45, 74, 90), (37, 45, 37, 20),
           (37, 45, 12, 45), (37, 45, 224, 224), (300, 260, 224, 224),
           (64, 64, 63, 65), (10, 12, 8, 8), (5, 7, 1, 1)]


@pytest.mark.parametrize("h,w,oh,ow", RESIZES)
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_bilinear_resize_matches_pil(h, w, oh, ow, mode):
    arr = _image(h, w, 3, h + w)
    src = arr[..., 0] if mode == "L" else arr
    want = np.asarray(Image.fromarray(src, mode).resize((ow, oh),
                                                        Image.BILINEAR))
    got = png.resize_bilinear(src, oh, ow)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= RESIZE_TOL


@pytest.mark.parametrize("angle", [0.0, 7.3, -29.9, 45.0, 90.0, 180.0,
                                   -135.5, 270.0])
@pytest.mark.parametrize("shape", [(32, 32), (33, 40)])
def test_float_rotation_matches_pil(angle, shape):
    rng = np.random.RandomState(int(abs(angle) * 10) + shape[1])
    x = (rng.rand(*shape) * 300 - 20).astype(np.float32)
    want = np.asarray(Image.fromarray(x, "F").rotate(angle, Image.BILINEAR),
                      dtype=np.float32)
    got = png.rotate_bilinear_f(x, angle)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= ROTATE_ULPS * ulp


def _folder(tmp_path, n=12, size=(20, 26)):
    """Label folders of images of every colour type, written by PIL."""
    modes = ["RGB", "L", "RGBA", "LA"]
    for i in range(n):
        d = tmp_path / f"class{i % 3}"
        d.mkdir(exist_ok=True)
        mode = modes[i % len(modes)]
        _pil_png(d / f"img{i:02d}.png",
                 _image(size[0] + i % 5, size[1], MODES[mode], i), mode)
    return tmp_path


@pytest.mark.parametrize("channels", [1, 3])
def test_native_image_loader_equals_the_reference(channels, tmp_path):
    root = _folder(tmp_path)
    jl = J.NativeImageLoader(16, 18, channels)
    tl = T.NativeImageLoader(16, 18, channels)
    for f in sorted(root.rglob("*.png")):
        np.testing.assert_array_equal(tl.asMatrix(str(f)),
                                      jl.asMatrix(str(f)))
    arr = _image(9, 7, channels, 0).astype(np.float32)
    np.testing.assert_array_equal(tl.asMatrix(arr[..., 0] if channels == 1
                                              else arr),
                                  jl.asMatrix(arr[..., 0] if channels == 1
                                              else arr))


def _transforms(P):
    return {
        "flip_h": P.FlipImageTransform(1), "flip_v": P.FlipImageTransform(0),
        "flip_both": P.FlipImageTransform(-1),
        "flip_random": P.FlipImageTransform(None),
        "crop": P.CropImageTransform(3), "rotate": P.RotateImageTransform(25),
        "color": P.ColorConversionTransform(0.3, 0.2),
        "scale": P.ScaleImageTransform(0.2),
        "pipeline": P.PipelineImageTransform(
            (P.FlipImageTransform(None), 0.5), P.CropImageTransform(4),
            (P.RotateImageTransform(15), 0.7), shuffle=True),
    }


@pytest.mark.parametrize("name", sorted(_transforms(T)))
def test_image_record_reader_with_each_transform_equals_the_reference(
        name, tmp_path):
    root = _folder(tmp_path)
    jr = J.ImageRecordReader(16, 16, 3, J.ParentPathLabelGenerator(),
                             _transforms(J)[name], seed=11)
    tr = T.ImageRecordReader(16, 16, 3, T.ParentPathLabelGenerator(),
                             _transforms(T)[name], seed=11)
    jr.initialize(J.FileSplit(root))
    tr.initialize(T.FileSplit(root))
    assert tr.getLabels() == jr.getLabels() == ["class0", "class1",
                                                 "class2"]
    for _ in range(2):      # the rng runs on across resets, in both
        while jr.hasNext():
            (ji, jl), (ti, tl) = jr.next(), tr.next()
            assert tl.toInt() == jl.toInt()
            assert ti.value.dtype == ji.value.dtype
            np.testing.assert_allclose(ti.value, ji.value, rtol=0,
                                       atol=ROTATE_ULPS * 2 ** -15)
        assert not tr.hasNext()
        jr.reset()
        tr.reset()
    jr.setEpoch(2)
    tr.setEpoch(2)
    js, ts = jr.shard(1, 3), tr.shard(1, 3)
    while js.hasNext():
        np.testing.assert_allclose(ts.next()[0].value, js.next()[0].value,
                                   rtol=0, atol=ROTATE_ULPS * 2 ** -15)
    assert not ts.hasNext()


def test_image_iterator_with_scaler_gives_the_reference_datasets(tmp_path):
    root = _folder(tmp_path, n=10)

    def it(P, scaler):
        rr = P.ImageRecordReader(12, 12, 3, P.ParentPathLabelGenerator(),
                                 P.PipelineImageTransform(
                                     P.FlipImageTransform(None),
                                     P.CropImageTransform(2)), seed=3)
        rr.initialize(P.FileSplit(root))
        out = P.RecordReaderDataSetIterator(rr, 4, labelIndex=1,
                                            numPossibleLabels=3)
        out.setPreProcessor(scaler)
        return out

    jit, tit = it(J, JScaler()), it(T, TScaler())
    assert tit.streaming() and jit.streaming()
    n = 0
    while jit.hasNext():
        jd, td = jit.next(), tit.next()
        assert td.features.torch.device.type == "cpu"
        np.testing.assert_array_equal(td.features.numpy(),
                                      np.asarray(jd.features.numpy()))
        np.testing.assert_array_equal(td.labels.numpy(),
                                      np.asarray(jd.labels.numpy()))
        n += 1
    assert n == 3 and not tit.hasNext()
