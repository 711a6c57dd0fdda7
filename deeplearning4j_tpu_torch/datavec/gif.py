"""The port's own GIF codec, beside ``png.py``: a reader that gives the
frames PIL gives, and a small writer for test clips — what
``datavec/codec.py`` needs on a machine without PIL (the reference decodes
with PIL: ``deeplearning4j_tpu/datavec/codec.py:25-30`` iterates
``ImageSequence.Iterator`` and takes ``convert("RGB")`` of each frame).

Read: GIF87a and GIF89a, LZW codes of 2 to 12 bits, global and local
palettes, interlaced frames, the graphic control extension's transparency
index and disposal methods 0-3.  The frames are composited as Pillow 12's
``GifImagePlugin`` composites them under its default loading strategy
(``RGB_AFTER_FIRST``):

- a palette equal to the grey ramp ``(i, i, i)`` counts as no palette: the
  file is greyscale (``L``) and its frames are drawn onto one canvas,
  transparent pixels skipped;
- otherwise frame 0 is an index image (``P``) — pixels outside its
  rectangle take the transparency index, or 0 — and from frame 1 the
  canvas is RGB: each later frame is decoded onto its own index image,
  turned into RGB by its palette (local, else global) and pasted inside
  its rectangle, its transparent pixels masked out;
- before a frame is drawn, the previous frame's disposal acts on the
  previous frame's rectangle: 2 fills it with the transparency colour
  (else the background colour) and 3 (and 4-7, as Pillow reads them)
  restores what was there before the previous frame was drawn; a frame
  whose control block names no disposal keeps the last one named;
- a palette index past the palette reads black.

Anything outside that raises naming it: a frame reaching past the logical
screen (Pillow grows the canvas), a greyscale file whose later frame
brings a colour palette, broken LZW data.

Write: frames of palette indices under one global palette, each frame
the whole screen, LZW codes that never widen (a clear code every
``2**m - 2`` literals: valid GIF, and packed with numpy, no encode loop).
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

__all__ = ["read_gif", "write_gif", "lzw_decode"]


def _blocks(buf: bytes, pos: int):
    """The data sub-blocks from ``pos``: (joined payload, position after
    the zero-length terminator)."""
    out = []
    n = len(buf)
    while pos < n:
        size = buf[pos]
        pos += 1
        if size == 0:
            break
        out.append(buf[pos:pos + size])
        pos += size
    return b"".join(out), pos


def lzw_decode(data: bytes, minCodeSize: int, count: int) -> bytes:
    """GIF LZW: at most ``count`` pixel indices from ``data`` (codes packed
    least significant bit first, the width growing from ``minCodeSize + 1``
    to 12 bits as the table fills)."""
    if not 0 <= minCodeSize <= 11:
        raise ValueError(f"GIF LZW code size {minCodeSize} is out of range")
    clear = 1 << minCodeSize
    eoi = clear + 1
    base = [bytes((i,)) for i in range(clear)] + [b"", b""]
    table = list(base)
    width = minCodeSize + 1
    mask = (1 << width) - 1
    nxt = clear + 2
    prev = None
    out: List[bytes] = []
    got = 0
    buf = data + b"\0\0\0"
    nbits = len(data) * 8
    bit = 0
    while got < count and bit + width <= nbits:
        i = bit >> 3
        code = ((buf[i] | buf[i + 1] << 8 | buf[i + 2] << 16)
                >> (bit & 7)) & mask
        bit += width
        if code == clear:
            table = list(base)
            width = minCodeSize + 1
            mask = (1 << width) - 1
            nxt = clear + 2
            prev = None
            continue
        if code == eoi:
            break
        if code < nxt:
            entry = table[code]
            grow = prev is not None
        elif code == nxt and prev is not None:
            entry = prev + prev[:1]
            grow = True
        else:
            raise ValueError(f"broken GIF LZW data: code {code} with the "
                             f"table at {nxt}")
        # Pillow's GifDecode.c: the width grows when the entry added is
        # the last one the current width can name
        if grow and nxt < 4096:
            table.append(prev + entry[:1])
            if nxt == mask and width < 12:
                width += 1
                mask = (1 << width) - 1
            nxt += 1
        out.append(entry)
        got += len(entry)
        prev = entry
    pix = b"".join(out)
    if len(pix) < count:
        raise ValueError(f"truncated GIF frame: {len(pix)} of {count} "
                         "pixels")
    return pix[:count]


def _row_order(h: int) -> np.ndarray:
    """Row of each decoded line in an interlaced frame (passes from rows
    0, 4, 2 and 1 with steps 8, 8, 4 and 2)."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def _palette(p: bytes):
    """Pillow's ``_is_palette_needed``: the grey ramp is no palette
    (``False``); else the (n, 3) uint8 table."""
    arr = np.frombuffer(p, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(arr))
    if np.array_equal(arr[:, 0], ramp) and np.array_equal(arr[:, 1], ramp) \
            and np.array_equal(arr[:, 2], ramp):
        return False
    return arr


def _lookup(idx: np.ndarray, pal) -> np.ndarray:
    """Index image -> RGB through ``pal`` (black past its end), or grey
    when there is no palette."""
    if pal is None or pal is False:
        return np.repeat(idx[..., None], 3, axis=-1)
    full = np.zeros((256, 3), np.uint8)
    full[:len(pal)] = pal[:256]
    return full[idx]


def _rgb(color: int, pal) -> np.ndarray:
    """Pillow's ``_rgb`` of a disposal colour: the palette entry (entry 0
    when the index is past the palette), or grey."""
    if pal is not None and pal is not False:
        if color * 3 + 3 > len(pal) * 3:
            color = 0
        return np.asarray(pal[color], np.uint8)
    return np.asarray((color,) * 3, np.uint8)


def read_gif(source) -> np.ndarray:
    """Every frame of a GIF file (a path or its bytes) as PIL gives it
    through ``ImageSequence.Iterator`` and ``convert("RGB")``: (T, H, W, 3)
    uint8."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        buf = bytes(source)
    else:
        with open(source, "rb") as f:
            buf = f.read()
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    W, H, flags = struct.unpack_from("<HHB", buf, 6)
    pos = 13
    gpal = None
    info_background = None
    if flags & 128:
        info_background = buf[11]
        n = 3 << ((flags & 7) + 1)
        gpal = _palette(buf[pos:pos + n])
        if gpal is False:
            gpal = None
        pos += n
    frames: List[np.ndarray] = []
    canvas = None          # index image (P, L) or RGB array
    mode = None
    pal0 = None            # the P canvas's palette (frame 0's)
    info_trans = None      # info["transparency"]: frame 0's index
    dispose = None         # ("index", v) | ("rgb", (3,)) | ("copy", arr)
    dispose_extent = None
    disposal_method = 0
    frame = 0
    n = len(buf)
    while True:
        ft = None
        interlace = None
        lpal = None        # None: no local table; False: the grey ramp
        extent = None
        bits = 0
        data = b""
        while pos < n:
            s = buf[pos]
            pos += 1
            if s == 0x3B:                              # trailer
                pos = n
                break
            if s == 0x21:                              # extension
                label = buf[pos]
                pos += 1
                size = buf[pos] if pos < n else 0
                first = buf[pos + 1:pos + 1 + size] if size else None
                _, pos = _blocks(buf, pos)
                if label == 0xF9 and first is not None:
                    gflags = first[0]
                    if gflags & 1:
                        ft = first[3]
                    d = (gflags & 0b00011100) >> 2
                    if d:
                        disposal_method = d
                continue
            if s == 0x2C:                              # image descriptor
                x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", buf, pos)
                pos += 9
                extent = (x0, y0, x0 + w, y0 + h)
                interlace = bool(iflags & 64)
                if iflags & 128:
                    m = 3 << ((iflags & 7) + 1)
                    lpal = _palette(buf[pos:pos + m])
                    pos += m
                bits = buf[pos]
                pos += 1
                data, pos = _blocks(buf, pos)
                break
            # anything else: skipped a byte at a time, as Pillow does
        if interlace is None:
            break
        x0, y0, x1, y1 = extent
        if x1 > W or y1 > H:
            raise NotImplementedError(
                f"GIF frame {frame} reaches {x1} x {y1} past the {W} x {H} "
                "screen (Pillow grows the canvas; this reader does not)")
        w, h = x1 - x0, y1 - y0
        pix = np.frombuffer(lzw_decode(data, bits, w * h),
                            np.uint8).reshape(h, w)
        if interlace:
            out = np.empty_like(pix)
            out[_row_order(h)] = pix
            pix = out
        # the previous frame's disposal, in the previous frame's rectangle
        if dispose is not None:
            a0, b0, a1, b1 = dispose_extent
            kind, val = dispose
            canvas[b0:b1, a0:a1] = val
        frame_pal = lpal if lpal is not None else gpal
        if frame == 0:
            mode = "P" if frame_pal is not None and frame_pal is not False \
                else "L"
            pal0 = frame_pal if mode == "P" else None
        elif mode == "P":
            canvas = _lookup(canvas, pal0)
            mode = "RGB"
            info_trans = None
        rgb_canvas = mode == "RGB"
        # this frame's disposal, applied before the next frame
        dispose = None
        dispose_extent = extent
        if disposal_method >= 2:
            if disposal_method == 2:
                color = info_trans if info_trans is not None else ft
                if color is None:
                    color = info_background if info_background is not None \
                        else 0
                dispose = ("rgb", _rgb(color, frame_pal)) if rgb_canvas \
                    else ("index", color)
            elif frame > 0:
                dispose = ("copy", canvas[y0:y1, x0:x1].copy())
            elif ft is not None:
                dispose = ("rgb", _rgb(ft, frame_pal)) if rgb_canvas \
                    else ("index", ft)
        if frame == 0:
            if ft is not None:
                info_trans = ft
            canvas = np.full((H, W), ft if ft is not None else 0, np.uint8)
            canvas[y0:y1, x0:x1] = pix
        elif rgb_canvas:
            rgb = _lookup(pix, frame_pal if frame_pal is not False
                          else None)
            if ft is not None:
                keep = pix != ft
                region = canvas[y0:y1, x0:x1]
                region[keep] = rgb[keep]
            else:
                canvas[y0:y1, x0:x1] = rgb
        else:
            if frame_pal is not None and frame_pal is not False:
                raise NotImplementedError(
                    f"GIF frame {frame} brings a colour palette to a "
                    "greyscale file (Pillow redraws such a frame alone)")
            region = canvas[y0:y1, x0:x1]
            if ft is not None:
                keep = pix != ft
                region[keep] = pix[keep]
            else:
                region[...] = pix
        if mode == "P":
            frames.append(_lookup(canvas, pal0))
        elif mode == "L":
            frames.append(np.repeat(canvas[..., None], 3, axis=-1))
        else:
            frames.append(canvas.copy())
        frame += 1
    if not frames:
        raise ValueError("image not found in GIF file")
    return np.stack(frames)


def _lzw_encode_flat(idx: np.ndarray, m: int) -> bytes:
    """Literal-only LZW at a fixed width of ``m + 1`` bits: a clear code,
    then runs of ``2**m - 2`` literals each followed by a clear code (so
    the table never reaches the next width), then the end code."""
    clear = 1 << m
    run = clear - 2
    lit = idx.reshape(-1).astype(np.uint32)
    nrun = -(-len(lit) // run)
    codes = np.full(len(lit) + nrun + 2, clear, np.uint32)
    k = np.arange(len(lit))
    codes[1 + k + k // run] = lit
    codes[-1] = clear + 1
    width = m + 1
    bits = np.unpackbits(codes.astype("<u4").view(np.uint8).reshape(-1, 4),
                         axis=1, bitorder="little")[:, :width]
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def write_gif(path: str, frames: np.ndarray, palette: np.ndarray,
              disposal: int = 1, transparency: Optional[int] = None) -> None:
    """Write (T, H, W) uint8 palette indices under one global ``palette``
    ((n, 3) uint8, n <= 256) as an animated GIF89a that loops: every frame
    the whole screen, 40 ms, with a graphic control block naming the
    ``disposal`` method and an optional transparency index."""
    frames = np.asarray(frames, np.uint8)
    if frames.ndim == 2:
        frames = frames[None]
    T, H, W = frames.shape
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    size = 2
    while size < len(pal):
        size *= 2
    if size > 256:
        raise ValueError(f"a GIF palette holds at most 256 colours, not "
                         f"{len(pal)}")
    table = np.zeros((size, 3), np.uint8)
    table[:len(pal)] = pal
    m = max(2, size.bit_length() - 1)
    out = [b"GIF89a", struct.pack("<HHBBB", W, H,
                                  0x80 | 0x70 | (size.bit_length() - 2),
                                  0, 0), table.tobytes()]
    out.append(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
    gflags = (disposal & 7) << 2 | (1 if transparency is not None else 0)
    for t in range(T):
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, gflags, 4,
                               transparency or 0, 0))
        out.append(struct.pack("<BHHHHB", 0x2C, 0, 0, W, H, 0))
        body = _lzw_encode_flat(frames[t], m)
        out.append(bytes((m,)))
        for i in range(0, len(body), 255):
            chunk = body[i:i + 255]
            out.append(bytes((len(chunk),)) + chunk)
        out.append(b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))
