"""Write the DataVec format fixtures the port's readers are held to where
neither PIL nor pyarrow is installed (``chip_smoke.py``'s
``datavec_formats`` phase reads them on the card's machine):

- ``gif_composited.gif``: an animated GIF (32 x 32, five frames) whose
  frames PIL encoded one by one (each interlaced, as PIL writes a lone
  frame), assembled with a global palette then local ones, frames at
  offsets, transparency indices and disposal methods 1, 2, 3 and 2; and
  ``gif_composited_frames.npz``, the (5, 32, 32, 3) uint8 frames PIL
  reads back from it (``ImageSequence.Iterator`` + ``convert("RGB")``),
  under the key ``frames``;
- ``arrow_lz4.feather``: a Feather v2 file that ``pyarrow.feather.
  write_feather`` compresses with LZ4_FRAME (its default), and
  ``arrow_lz4_records.json``, its columns as pyarrow reads them (name,
  type, values; null as JSON null).

Run from the repository root with PIL and pyarrow installed:
``python tests/fixtures/make_format_fixtures.py``.
"""
import json
import os
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _pil_single(idx, pal, **kw):
    """One frame encoded by PIL as a one-frame GIF: (its colour table,
    its image block — descriptor, LZW code size and data sub-blocks)."""
    import io
    import struct

    from PIL import Image
    im = Image.fromarray(idx, "P")
    im.putpalette(pal.tolist())
    buf = io.BytesIO()
    im.save(buf, "GIF", **kw)
    b = buf.getvalue()
    flags = b[10]
    pos = 13
    table = b""
    if flags & 128:
        table = b[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(table)
    while b[pos] == 0x21:                       # skip PIL's extensions
        pos += 2
        while b[pos]:
            pos += b[pos] + 1
        pos += 1
    assert b[pos] == 0x2C
    end = pos + 10
    end += 1                                    # LZW minimum code size
    while b[end]:
        end += b[end] + 1
    end += 1
    x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", b, pos + 1)
    return table, (flags & 7), b[pos:end], iflags


def make_gif(path_gif, path_npz):
    """An animated GIF assembled from frames PIL encoded one at a time
    (PIL interlaces a single frame of 16 px or more, never a frame of an
    animation it writes): a global palette, then local ones, frames at
    offsets, interlace, transparency indices and disposal methods 1, 2, 3
    and 2."""
    import struct

    from PIL import Image, ImageSequence
    rng = np.random.RandomState(7)
    W = H = 32
    # (x0, y0, w, h, disposal, transparency index or None)
    plan = [(0, 0, 32, 32, 1, 3), (5, 7, 20, 18, 2, 5),
            (10, 2, 16, 16, 3, 2), (0, 16, 24, 16, 2, None),
            (0, 0, 32, 32, 1, None)]
    out = [b"GIF89a"]
    for i, (x0, y0, w, h, disp, tr) in enumerate(plan):
        idx = rng.randint(0, 8, (h, w)).astype(np.uint8)
        pal = rng.randint(0, 256, 8 * 3).astype(np.uint8)
        kw = {"interlace": True, "optimize": False}
        table, bits, block, iflags = _pil_single(idx, pal, **kw)
        if i == 0:
            out.append(struct.pack("<HHBBB", W, H, 0x80 | 0x70 | bits, 0,
                                   0) + table)
            out.append(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        gflags = disp << 2 | (1 if tr is not None else 0)
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, gflags, 4,
                               tr or 0, 0))
        body = block[10:]
        iflags &= 64                                # keep PIL's interlace
        if i > 0:
            iflags |= 0x80 | bits                   # its table, local
        out.append(struct.pack("<BHHHHB", 0x2C, x0, y0, w, h, iflags))
        if i > 0:
            out.append(table)
        out.append(body)
    out.append(b"\x3b")
    with open(path_gif, "wb") as f:
        f.write(b"".join(out))
    with Image.open(path_gif) as im:
        frames = np.stack([np.asarray(f.convert("RGB"))
                           for f in ImageSequence.Iterator(im)])
    np.savez_compressed(path_npz, frames=frames)


def make_feather(path_feather, path_json):
    import pyarrow as pa
    import pyarrow.feather as feather
    n = 160
    rng = np.random.RandomState(11)
    words = ["alpha", "beta", "gamma", "delta"]
    table = pa.table({
        "id": pa.array(list(range(n)), pa.int32()),
        "count": pa.array([int(v) for v in rng.randint(0, 4, n)],
                          pa.int64()),
        "score": pa.array([float(v) for v in
                           np.round(rng.rand(n), 1).astype(np.float32)],
                          pa.float32()),
        "weight": pa.array([None if i % 17 == 0 else float(i % 5) * 0.25
                            for i in range(n)], pa.float64()),
        "ok": pa.array([bool(i % 3) for i in range(n)], pa.bool_()),
        "word": pa.array([None if i % 29 == 0 else words[i % 4]
                          for i in range(n)], pa.string()),
    })
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        feather.write_feather(table, path_feather)      # LZ4_FRAME
        back = feather.read_table(path_feather)
    with open(path_json, "w") as f:
        json.dump([{"name": fld.name, "type": str(fld.type),
                    "values": back.column(fld.name).to_pylist()}
                   for fld in back.schema], f)


if __name__ == "__main__":
    make_gif(os.path.join(HERE, "gif_composited.gif"),
             os.path.join(HERE, "gif_composited_frames.npz"))
    make_feather(os.path.join(HERE, "arrow_lz4.feather"),
                 os.path.join(HERE, "arrow_lz4_records.json"))
