"""DataVec's format readers in the port (ROADMAP "A12 datavec formats"):
``datavec/{excel,columnar,audio,codec,arrow}.py`` and the port's own
codecs beside them, ``datavec/gif.py`` (PIL's GIF frames) and
``datavec/arrowipc.py`` (Arrow IPC stream and Feather v2, LZ4 bodies).

- the reference's own tests of these readers (``test_datavec_breadth.py``
  ``TestAudio``, ``TestColumnar`` and its two codec cases;
  ``test_datavec_distributed.py``'s Arrow and Excel cases) run against the
  port;
- every reader's records equal the reference's on the same files, type
  and value, bit for bit: xlsx and sqlite and ``.npz`` from either
  package's writer; 8-, 16- and 32-bit WAVs, stereo averaged, 24-bit
  refused; spectrogram, mel filterbank and MFCC arrays; GIF and ``.npy``
  clips with ``startFrame`` / ``numFrames`` / ``ravel`` / ``outputHW``
  (PIL's BICUBIC default), the ``(T, H, W)`` clip's ``TypeError``;
  Feather and IPC-stream files written by the port, the reference and
  pyarrow (LZ4_FRAME and plain), read by all three;
- the GIF decoder against PIL on GIFs PIL writes in the test (palettes
  local and global, transparency, disposal 0-3, frames at offsets,
  interlaced single frames) and on the port's own writer's files;
- the LZ4 frame decoder on pyarrow's LZ4 frames; a ZSTD body raises by
  name;
- the committed fixtures (``tests/fixtures/make_format_fixtures.py``);
- ROADMAP C24: ``toTable`` returns the port's ``ArrowTable``.
"""
import io
import json
import os
import sqlite3
import wave
import warnings

import numpy as np
import pytest

import deeplearning4j_tpu.datavec as J
import deeplearning4j_tpu_torch.datavec as T
from deeplearning4j_tpu_torch.datavec import arrowipc, gif, png
from tests._torch_parity import _reference_tests, _run_reference_test

pytestmark = pytest.mark.torch_port

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

# the rest of test_datavec_breadth.py runs in test_torch_datavec.py
_, _BREADTH = _reference_tests(
    "test_datavec_breadth.py",
    exclude=("TestCodecAndResources.test_resources_and_downloader",))
_, _DIST = _reference_tests(
    "test_datavec_distributed.py",
    exclude=("test_distributed_transform_two_processes",
             "test_distributed_join_reduce_two_processes"))
_FORMAT_CASES = [(f"breadth::{i}", c) for i, c in _BREADTH
                 if i.startswith(("TestAudio", "TestColumnar",
                                  "TestCodecAndResources"))] + \
    [(f"distributed::{i}", c) for i, c in _DIST]


@pytest.mark.parametrize("case", [c for _, c in _FORMAT_CASES],
                         ids=[i for i, _ in _FORMAT_CASES])
def test_reference_format_tests_pass_on_the_port(case, tmp_path,
                                                 monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # pyarrow.feather
        _run_reference_test(case, tmp_path, monkeypatch)


def _rec(records):
    """Records as (writable class name, value) rows."""
    out = []
    for r in records:
        row = []
        for w in r:
            v = w.value
            if isinstance(v, np.ndarray):
                v = (v.dtype.str, v.shape, v.tobytes())
            row.append((type(w).__name__, v))
        out.append(row)
    return out


def _drain(rr):
    out = []
    while rr.hasNext():
        out.append(rr.next())
    return out


# ---------------------------------------------------------------- excel ----

_XLSX_ROWS = [["name", "count", "score", "flag"],
              ["alpha", 3, 0.5, "x&y<z>"], ["beta", -2, 1.25, ""],
              ["gamma", 10 ** 12, -3.5e-7, "ünï"], [7, 8.0, "9", 1e20]]


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("skip", [0, 1])
def test_excel_records_equal_the_references(tmp_path, writer, skip):
    p = str(tmp_path / "t.xlsx")
    (J if writer == "reference" else T).excel.writeXlsx(p, _XLSX_ROWS)
    got = _rec(_drain(T.ExcelRecordReader(skipNumLines=skip).initialize(p)))
    want = _rec(_drain(J.ExcelRecordReader(skipNumLines=skip).initialize(p)))
    assert got == want and len(got) == len(_XLSX_ROWS) - skip


def test_excel_shared_strings_and_booleans_match(tmp_path):
    """A workbook with a shared-string table, booleans and a gap in a row
    (cells the writer never makes) reads the same in both packages."""
    import zipfile
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    sheet = (f'<worksheet xmlns="{ns}"><sheetData>'
             '<row r="1"><c r="A1" t="s"><v>1</v></c><c r="C1" t="b">'
             '<v>1</v></c></row><row r="2"><c r="B2"><v>2.50</v></c>'
             '<c r="D2" t="s"><v>0</v></c></row></sheetData></worksheet>')
    shared = (f'<sst xmlns="{ns}"><si><t>zero</t></si><si><r><t>on</t>'
              '</r><r><t>e</t></r></si></sst>')
    p = str(tmp_path / "s.xlsx")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("xl/worksheets/sheet1.xml", sheet)
        z.writestr("xl/sharedStrings.xml", shared)
    got = _rec(_drain(T.ExcelRecordReader().initialize(p)))
    assert got == _rec(_drain(J.ExcelRecordReader().initialize(p)))
    assert got[0][0] == ("Text", "one") and got[1][1] == (
        "DoubleWritable", 2.5)
    with pytest.raises(ValueError, match="sheet 1 not in"):
        T.ExcelRecordReader(sheetIndex=1).initialize(p)


# -------------------------------------------------------------- columnar ----

def _people_db(path):
    with sqlite3.connect(path) as conn:
        conn.execute("CREATE TABLE p (name TEXT, age INTEGER, score REAL, "
                     "blob BLOB)")
        conn.executemany("INSERT INTO p VALUES (?, ?, ?, ?)",
                         [("ann", 31, 1.5, None), ("bob", -4, None, None),
                          ("cy", 2 ** 40, 2.25, None)])


def test_jdbc_records_equal_the_references(tmp_path):
    db = str(tmp_path / "p.db")
    _people_db(db)
    q = "SELECT name, age, score FROM p ORDER BY rowid"
    tr, jr = T.JDBCRecordReader(q), J.JDBCRecordReader(q)
    tr.initialize(T.FileSplit(db))
    jr.initialize(J.FileSplit(db))
    got = _rec(_drain(tr))
    assert got == _rec(_drain(jr)) and len(got) == 3
    with sqlite3.connect(db) as conn:
        r = T.JDBCRecordReader(q, conn)
        r.initialize()
        assert _rec(_drain(r)) == got
    with pytest.raises(ValueError, match="needs a connection"):
        T.JDBCRecordReader(q).initialize()


def _columnar_schema(pkg):
    return (pkg.Schema.Builder().addColumnInteger("i").addColumnLong("l")
            .addColumnFloat("f").addColumnDouble("d").addColumnString("s")
            .build())


def _columnar_records(pkg):
    return [[pkg.IntWritable(i), pkg.LongWritable(2 ** 40 + i),
             pkg.FloatWritable(i / 3), pkg.DoubleWritable(i / 7),
             pkg.Text(f"r{i}")] for i in range(6)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_columnar_round_trip_both_ways(tmp_path, writer):
    W = J if writer == "reference" else T
    cols = W.ColumnarConverter.toColumnar(_columnar_records(W),
                                          _columnar_schema(W))
    p = str(tmp_path / "c.npz")
    W.ColumnarConverter.save(p, cols, _columnar_schema(W))
    tcols, tschema = T.ColumnarConverter.load(p)
    jcols, jschema = J.ColumnarConverter.load(p)
    assert tschema.toJson() == jschema.toJson()
    for k in jcols:
        assert tcols[k].dtype == jcols[k].dtype
        np.testing.assert_array_equal(tcols[k], jcols[k])
    assert _rec(T.ColumnarConverter.fromColumnar(tcols, tschema)) == \
        _rec(J.ColumnarConverter.fromColumnar(jcols, jschema))


# ----------------------------------------------------------------- audio ----

def _wav(path, width, channels, n=1200, rate=8000, seed=0):
    rng = np.random.RandomState(seed)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dt)
    x = rng.randint(info.min, info.max, n * channels, dtype=np.int64)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(x.astype(dt).tobytes())


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (4, 1),
                                            (4, 2)])
def test_read_wav_equals_the_references(tmp_path, width, channels):
    p = str(tmp_path / "a.wav")
    _wav(p, width, channels)
    x, rate = T.read_wav(p)
    jx, jrate = J.audio.read_wav(p)
    assert rate == jrate == 8000 and x.dtype == jx.dtype
    np.testing.assert_array_equal(x, jx)


def test_24_bit_wav_raises_in_both(tmp_path):
    p = str(tmp_path / "a.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(8000)
        w.writeframes(b"\0" * 300)
    for pkg in (T, J):
        with pytest.raises(ValueError, match="sample width: 3"):
            pkg.read_wav(p)


@pytest.mark.parametrize("frame,hop,rate,coeffs", [(256, None, 8000, 13),
                                                   (480, 160, 16000, 40),
                                                   (300, 77, 11025, 20)])
def test_features_equal_the_references(frame, hop, rate, coeffs):
    x = np.random.RandomState(1).randn(rate // 2).astype(np.float32)
    np.testing.assert_array_equal(
        T.spectrogram(x, frame, hop), J.audio.spectrogram(x, frame, hop))
    np.testing.assert_array_equal(
        T.audio.spectrogram(x[:100], frame, hop, window="rect"),
        J.audio.spectrogram(x[:100], frame, hop, window="rect"))
    np.testing.assert_array_equal(
        T.audio.mel_filterbank(26, frame // 2 + 1, rate),
        J.audio.mel_filterbank(26, frame // 2 + 1, rate))
    m = T.mfcc(x, rate, coeffs, 26, frame, hop)
    assert m.dtype == np.float32
    np.testing.assert_array_equal(m, J.audio.mfcc(x, rate, coeffs, 26,
                                                  frame, hop))


@pytest.mark.parametrize("features", ["waveform", "spectrogram", "mfcc"])
def test_audio_records_equal_the_references(tmp_path, features):
    for i, (w, ch) in enumerate([(2, 1), (1, 2), (4, 1)]):
        _wav(str(tmp_path / f"s{i}.wav"), w, ch, seed=i)
    (tmp_path / "notes.txt").write_text("not audio")
    kw = dict(features=features, numCoefficients=7, frameLength=128, hop=50)
    tr, jr = T.AudioFeatureRecordReader(**kw), \
        J.AudioFeatureRecordReader(**kw)
    tr.initialize(T.FileSplit(str(tmp_path)))
    jr.initialize(J.FileSplit(str(tmp_path)))
    assert tr.featureShape is None
    got = _rec(_drain(tr))
    assert got == _rec(_drain(jr)) and len(got) == 3
    assert tr.featureShape == jr.featureShape
    tw, jw = T.WavFileRecordReader(), J.WavFileRecordReader()
    tw.initialize(T.FileSplit(str(tmp_path)))
    jw.initialize(J.FileSplit(str(tmp_path)))
    assert _rec(_drain(tw)) == _rec(_drain(jw))
    with pytest.raises(ValueError, match="Unknown audio features"):
        T.AudioFeatureRecordReader(features="chroma")


# ------------------------------------------------------------------- gif ----

def _pil_frames(data):
    from PIL import Image, ImageSequence
    with Image.open(io.BytesIO(data)) as im:
        return np.stack([np.asarray(f.convert("RGB"))
                         for f in ImageSequence.Iterator(im)])


def _pil_gif(rng, kind, T_, H, W, **kw):
    """An animated GIF PIL writes from random frames that each change a
    random rectangle of the last (so PIL writes frames at offsets)."""
    from PIL import Image
    frames = []
    base = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    gpal = rng.randint(0, 256, 64 * 3).astype(np.uint8)
    for t in range(T_):
        f = base.copy()
        y0, x0 = rng.randint(0, H), rng.randint(0, W)
        y1, x1 = rng.randint(y0, H) + 1, rng.randint(x0, W) + 1
        f[y0:y1, x0:x1] = rng.randint(0, 256, (y1 - y0, x1 - x0, 3))
        base = f
        if kind == "rgb":
            frames.append(Image.fromarray(f))
        elif kind == "L":
            frames.append(Image.fromarray(f[..., 0]))
        elif kind == "P":              # one palette for every frame
            q = f // 64
            im = Image.fromarray((q[..., 0] * 16 + q[..., 1] * 4
                                  + q[..., 2]).astype(np.uint8), "P")
            im.putpalette(gpal.tolist())
            frames.append(im)
        else:                          # "Plocal": a palette a frame
            q = f // 128
            im = Image.fromarray((q[..., 0] * 4 + q[..., 1] * 2
                                  + q[..., 2]).astype(np.uint8), "P")
            im.putpalette(rng.randint(0, 256, 24).tolist())
            frames.append(im)
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   duration=40, loop=0, **kw)
    return buf.getvalue()


_GIF_KINDS = [(k, d, tr) for k in ("rgb", "L", "P", "Plocal")
              for d in (0, 1, 2, 3, "mixed") for tr in (None, 3)
              if not (k == "rgb" and tr is not None)]


@pytest.mark.parametrize("kind,disposal,transparency", _GIF_KINDS,
                         ids=[f"{k}-d{d}-t{t}" for k, d, t in _GIF_KINDS])
def test_gif_frames_equal_pils(kind, disposal, transparency):
    """Animations PIL writes (frames at offsets, local palettes, a
    transparency index, each disposal method and a mix) decode to PIL's
    composited frames, several sizes and seeds a case."""
    pytest.importorskip("PIL")
    rng = np.random.RandomState(hash((kind, str(disposal),
                                      transparency)) % 2 ** 31)
    for _ in range(3):
        T_ = rng.randint(2, 6)
        disp = tuple(int(v) for v in rng.randint(0, 4, T_)) \
            if disposal == "mixed" else disposal
        kw = {"disposal": disp, "optimize": bool(rng.rand() < 0.5)}
        if transparency is not None:
            kw["transparency"] = transparency
        data = _pil_gif(rng, kind, T_, rng.randint(2, 40),
                        rng.randint(2, 40), **kw)
        np.testing.assert_array_equal(gif.read_gif(data), _pil_frames(data))


def _frame_flags(data):
    """Each image descriptor's flags byte, by walking the blocks."""
    pos, out = 13, []
    if data[10] & 128:
        pos += 3 << ((data[10] & 7) + 1)
    while pos < len(data) and data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos += 2
        else:
            flags = data[pos + 9]
            out.append(flags)
            pos += 10 + ((3 << ((flags & 7) + 1)) if flags & 128 else 0) + 1
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return out


@pytest.mark.parametrize("mode", ["P", "L", "RGB"])
def test_gif_interlaced_single_frames_equal_pils(mode):
    """PIL interlaces a lone frame of 16 px or more (never a frame of an
    animation: the committed fixture holds an interlaced animation)."""
    from PIL import Image
    rng = np.random.RandomState(5)
    for h, w in ((16, 16), (37, 19), (64, 3 + 16)):
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        im = Image.fromarray(a if mode == "RGB" else a[..., 0])
        if mode == "P":
            im = im.convert("P")
        buf = io.BytesIO()
        im.save(buf, "GIF", interlace=True, transparency=7)
        data = buf.getvalue()
        assert all(f & 64 for f in _frame_flags(data))   # interlaced
        np.testing.assert_array_equal(gif.read_gif(data), _pil_frames(data))


def test_gif_fixture_equals_pils_frames():
    """The committed animation (interlaced frames at offsets, local
    palettes, transparency, disposal 1, 2, 3, 2): PIL's frames are
    committed beside it, as the card's machine has no PIL."""
    frames = gif.read_gif(os.path.join(FIXTURES, "gif_composited.gif"))
    want = np.load(os.path.join(FIXTURES,
                                "gif_composited_frames.npz"))["frames"]
    np.testing.assert_array_equal(frames, want)
    with open(os.path.join(FIXTURES, "gif_composited.gif"), "rb") as f:
        np.testing.assert_array_equal(_pil_frames(f.read()), want)


@pytest.mark.parametrize("ncolors", [2, 3, 16, 200, 256])
def test_port_written_gifs_read_back_in_pil_and_the_port(tmp_path, ncolors):
    rng = np.random.RandomState(ncolors)
    pal = rng.randint(0, 256, (ncolors, 3)).astype(np.uint8)
    idx = rng.randint(0, ncolors, (4, 23, 41)).astype(np.uint8)
    p = str(tmp_path / "w.gif")
    gif.write_gif(p, idx, pal, disposal=2,
                  transparency=None if ncolors == 2 else 1)
    with open(p, "rb") as f:
        data = f.read()
    ref = _pil_frames(data)
    np.testing.assert_array_equal(gif.read_gif(p), ref)
    if ncolors > 2:                        # no grey ramp: P, then RGB
        np.testing.assert_array_equal(ref[0], pal[idx[0]])


def test_gif_refusals():
    with pytest.raises(ValueError, match="not a GIF"):
        gif.read_gif(b"PNG....")
    with pytest.raises(ValueError, match="broken GIF LZW"):
        gif.lzw_decode(bytes([0b11111111, 0b00000111]), 2, 4)
    with pytest.raises(ValueError, match="truncated GIF frame"):
        gif.lzw_decode(bytes([0b00000100]), 2, 4)
    # a frame past the logical screen (Pillow grows the canvas)
    data = bytearray(_pil_gif(np.random.RandomState(0), "P", 1, 8, 8))
    data[6] = 4                                   # screen width 4 < 8
    with pytest.raises(NotImplementedError, match="past the"):
        gif.read_gif(bytes(data))


# ----------------------------------------------------------------- codec ----

def _codec_dir(tmp_path):
    rng = np.random.RandomState(3)
    data = _pil_gif(rng, "Plocal", 5, 20, 26, disposal=(1, 2, 3, 2, 1),
                    transparency=2)
    (tmp_path / "a.gif").write_bytes(data)
    np.save(str(tmp_path / "b.npy"), rng.rand(6, 12, 10, 3)
            .astype(np.float32))
    (tmp_path / "c.txt").write_text("skip me")
    return str(tmp_path)


@pytest.mark.parametrize("kw", [dict(), dict(startFrame=1, numFrames=3),
                                dict(ravel=True), dict(outputHW=(9, 13)),
                                dict(ravel=True, outputHW=(32, 40),
                                     startFrame=2)],
                         ids=["plain", "window", "ravel", "resize",
                              "ravel-resize-up"])
def test_codec_records_equal_the_references(tmp_path, kw):
    d = _codec_dir(tmp_path)
    tr, jr = T.CodecRecordReader(**kw), J.CodecRecordReader(**kw)
    tr.initialize(T.FileSplit(d))
    jr.initialize(J.FileSplit(d))
    got, want = [], []
    while jr.hasNext():
        got.append(_rec(tr.nextSequence()))
        want.append(_rec(jr.nextSequence()))
    assert not tr.hasNext() and len(got) == 2
    assert got == want


def test_codec_resize_is_pils_default_bicubic():
    from PIL import Image
    a = np.random.RandomState(2).randint(0, 256, (31, 17, 3)).astype(
        np.uint8)
    for h, w in ((8, 8), (40, 9), (31, 17), (5, 60)):
        np.testing.assert_array_equal(
            png.resize_bicubic(a, h, w),
            np.asarray(Image.fromarray(a).resize((w, h))))


def test_codec_one_channel_clip_resize_raises_as_pil(tmp_path):
    """A (T, H, W) ``.npy`` clip gains a channel axis; resizing (H, W, 1)
    uint8 frames makes PIL's ``fromarray`` raise ``TypeError``, and the
    port raises the same."""
    np.save(str(tmp_path / "v.npy"), np.random.RandomState(0).rand(
        3, 6, 6).astype(np.float32))
    for pkg in (T, J):
        rr = pkg.CodecRecordReader(outputHW=(4, 4))
        rr.initialize(pkg.FileSplit(str(tmp_path)))
        with pytest.raises(TypeError, match="Cannot handle this data type"):
            rr.nextSequence()
    rr = T.CodecRecordReader()                     # no resize: fine
    rr.initialize(T.FileSplit(str(tmp_path)))
    assert rr.nextSequence()[0][0].value.shape == (6, 6, 1)


# ----------------------------------------------------------------- arrow ----

def _arrow_schema(pkg):
    return (pkg.Schema.Builder().addColumnInteger("i").addColumnLong("l")
            .addColumnFloat("f").addColumnDouble("d").addColumnString("s")
            .addColumnCategorical("c", ["a", "b"]).addColumnBoolean("b")
            .addColumnTime("t").build())


def _arrow_records(pkg, n=25):
    return [[pkg.IntWritable(i - 12), pkg.LongWritable(2 ** 40 * i),
             pkg.FloatWritable(i / 3), pkg.DoubleWritable(i / 7),
             pkg.Text(f"rö{i}"), pkg.Text("ab"[i % 2]),
             pkg.IntWritable(i % 2), pkg.LongWritable(1_600_000_000 + i)]
            for i in range(n)]


@pytest.mark.parametrize("fmt", ["feather", "ipc"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_arrow_files_read_the_same_everywhere(tmp_path, fmt, writer):
    """Files the port or the reference (pyarrow) writes read the same in
    the port, the reference and pyarrow."""
    pa = pytest.importorskip("pyarrow")
    W = J if writer == "reference" else T
    p = str(tmp_path / f"t.{fmt}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if fmt == "feather":
            W.ArrowConverter.writeFeather(_arrow_records(W),
                                          _arrow_schema(W), p)
            got, gs = T.ArrowConverter.readFeather(p)
            want, ws = J.ArrowConverter.readFeather(p)
            import pyarrow.feather as feather
            table = feather.read_table(p)
        else:
            W.ArrowConverter.writeIpcStream(_arrow_records(W),
                                            _arrow_schema(W), p)
            got, gs = T.ArrowConverter.readIpcStream(p)
            want, ws = J.ArrowConverter.readIpcStream(p)
            import pyarrow.ipc as ipc
            with ipc.open_stream(p) as r:
                table = r.read_all()
        assert _rec(got) == _rec(want) and len(got) == 25
        assert gs.toJson() == ws.toJson()
        assert [str(f.type) for f in table.schema] == [
            "int32", "int64", "float", "double", "string", "string", "bool",
            "int64"]
        assert _rec(T.ArrowConverter.fromTable(table)) == _rec(want)
        tr = T.ArrowRecordReader().initialize(p)
        assert _rec(_drain(tr)) == _rec(want)
        assert pa is not None


@pytest.mark.parametrize("compression", ["lz4", "uncompressed"])
def test_pyarrow_feather_reads_in_the_port(tmp_path, compression):
    """pyarrow's ``write_feather`` (LZ4_FRAME by default) with nulls,
    several record batches and every column type the readers map."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.feather as feather
    rng = np.random.RandomState(4)
    n = 3000

    def nul(v):
        return [None if rng.rand() < 0.1 else x for x in v]

    table = pa.table({
        "i8": pa.array(rng.randint(-128, 127, n).tolist(), pa.int8()),
        "u16": pa.array(rng.randint(0, 65535, n).tolist(), pa.uint16()),
        "i32": pa.array(nul(rng.randint(-9, 9, n).tolist()), pa.int32()),
        "i64": pa.array(rng.randint(-2 ** 62, 2 ** 62, n).tolist(),
                        pa.int64()),
        "f32": pa.array(nul(np.round(rng.randn(n), 2).tolist()),
                        pa.float32()),
        "f64": pa.array(rng.randn(n).tolist(), pa.float64()),
        "b": pa.array(nul([bool(v) for v in rng.randint(0, 2, n)])),
        "s": pa.array(nul(["w" * int(k) for k in rng.randint(0, 9, n)])),
        "ls": pa.array(["é" * int(k) for k in rng.randint(0, 3, n)],
                       pa.large_string())})
    p = str(tmp_path / "t.feather")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        feather.write_feather(table, p, compression=compression,
                              chunksize=1000)
        want, ws = J.ArrowConverter.readFeather(p)
    port = arrowipc.read_ipc_file(p)
    assert port.to_pydict() == table.to_pydict()
    assert [str(f.type) for f in port.schema] == \
        [str(f.type) for f in table.schema]
    got, gs = T.ArrowConverter.readFeather(p)
    assert _rec(got) == _rec(want) and gs.toJson() == ws.toJson()


def test_lz4_frames_decode_as_pyarrows():
    pa = pytest.importorskip("pyarrow")
    rng = np.random.RandomState(6)
    for data in (b"", b"a", b"abc" * 1000, rng.bytes(5000),
                 bytes(rng.randint(0, 4, 200_000).astype(np.uint8)),
                 b"x" * 70_000 + rng.bytes(100)):
        frame = pa.compress(data, codec="lz4", asbytes=True)
        assert arrowipc.lz4_frame_decompress(frame) == data


def test_zstd_body_raises_by_name(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.feather as feather
    p = str(tmp_path / "z.feather")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        feather.write_feather(pa.table({"a": list(range(500))}), p,
                              compression="zstd")
    with pytest.raises(NotImplementedError, match="ZSTD"):
        T.ArrowConverter.readFeather(p)


def test_lz4_feather_fixture_reads_as_pyarrow_read_it():
    with open(os.path.join(FIXTURES, "arrow_lz4_records.json")) as f:
        want = json.load(f)
    table = arrowipc.read_ipc_file(os.path.join(FIXTURES,
                                                "arrow_lz4.feather"))
    assert table.column_names == [c["name"] for c in want]
    for col in want:
        assert str(table.column(col["name"]).type) == col["type"]
        assert table.column(col["name"]).to_pylist() == col["values"]
    recs, schema = T.ArrowConverter.readFeather(
        os.path.join(FIXTURES, "arrow_lz4.feather"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        jrecs, jschema = J.ArrowConverter.readFeather(
            os.path.join(FIXTURES, "arrow_lz4.feather"))
    assert _rec(recs) == _rec(jrecs)
    assert schema.toJson() == jschema.toJson()


def test_c24_to_table_returns_the_ports_arrow_table():
    """ROADMAP C24: where the reference's ``toTable`` returns a
    ``pyarrow.Table``, the port's returns its own ``ArrowTable`` with the
    same columns, types and values."""
    table = T.ArrowConverter.toTable(_arrow_records(T), _arrow_schema(T))
    assert isinstance(table, arrowipc.ArrowTable)
    jtable = J.ArrowConverter.toTable(_arrow_records(J), _arrow_schema(J))
    assert type(jtable).__module__.startswith("pyarrow")
    assert table.num_rows == jtable.num_rows == 25
    assert table.column_names == jtable.column_names
    assert [str(f.type) for f in table.schema] == \
        [str(f.type) for f in jtable.schema]
    assert table.to_pydict() == jtable.to_pydict()
    assert table.column("f").to_pylist() == jtable.column("f").to_pylist()
    assert _rec(T.ArrowConverter.fromTable(table)) == \
        _rec(J.ArrowConverter.fromTable(jtable))
    assert T.ArrowConverter.schemaFromTable(table).toJson() == \
        J.ArrowConverter.schemaFromTable(jtable).toJson()
    with pytest.raises(OverflowError, match="int32"):
        T.ArrowConverter.toTable([[T.IntWritable(2 ** 31)]],
                                 T.Schema.Builder().addColumnInteger("i")
                                 .build())
