"""The port's own image codec, built on ``zlib``: a PNG reader and writer,
a binary PGM/PPM reader, and PIL's ``convert``, ``resize`` (BILINEAR and BICUBIC) and
float ``rotate(BILINEAR)`` in numpy — what ``datavec/image.py`` needs on a
machine without PIL (the H100 machine has none; the reference decodes
with PIL, ``deeplearning4j_tpu/datavec/image.py:25-53``).

Read: PNG at 8 bits a sample — grey (``L``), grey with alpha (``LA``), RGB,
RGBA and palette (``P``) — all five row filters, not interlaced; binary
PGM (``P5``) and PPM (``P6``) with a maxval of at most 255.  Anything else
raises naming what it is.  Write: PNG from a uint8 array of 1, 2, 3 or 4
channels, every row with filter 1 (Sub), which the reader undoes with one
vectorised cumulative sum.

The numeric rules are PIL's (Pillow 12's ``Convert.c``, ``Resample.c``
and ``Geometry.c``), so the pixels equal PIL's: RGB to L is
``(19595 r + 38470 g + 7471 b + 2^15) >> 16``; the bilinear resize widens
its triangle filter by the scale factor on a downscale, runs a horizontal
pass then a vertical one in 22-bit fixed point, rounding to 8 bits
between them; the rotation maps each output pixel centre through PIL's
affine matrix and interpolates in double precision, zero outside.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["read_image", "read_png", "read_pnm", "write_png", "convert",
           "resize_bilinear", "resize_bicubic", "rotate_bilinear_f", "is_native_format"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> (mode, samples a pixel)
_PNG_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
              6: ("RGBA", 4)}


def is_native_format(head: bytes) -> bool:
    """True when a file starting with ``head`` is one this module reads."""
    return head.startswith(_PNG_SIG) or head[:2] in (b"P5", b"P6")


def read_image(path) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """``(pixels, mode, palette)`` of a PNG or binary PGM/PPM file: pixels
    uint8 (h, w, samples), the palette (n, 3) uint8 for mode ``P``."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return read_png(data)
    if data[:2] in (b"P5", b"P6"):
        return read_pnm(data) + (None,)
    raise ValueError(f"{path}: not a PNG or binary PGM/PPM file")


def _chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def read_png(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    hdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if ctype not in _PNG_TYPES:
        raise ValueError(f"PNG colour type {ctype} is not supported")
    mode, spp = _PNG_TYPES[ctype]
    if depth != 8:
        raise ValueError(f"PNG of {depth} bits a sample is not supported "
                         "(8 only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if comp or filt:
        raise ValueError("unknown PNG compression or filter method")
    if mode == "P" and palette is None:
        raise ValueError("palette PNG without PLTE")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * spp
    if raw.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: a running sum along each sample
            cur = np.cumsum(line.reshape(w, spp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ftype == 2:        # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = _unfilter_slow(int(ftype), line, prev, spp)
        else:
            raise ValueError(f"bad PNG row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, spp), mode, palette


def _unfilter_slow(ftype: int, line: np.ndarray, prev: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): recurrences along the row, byte by byte."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    n = len(cur)
    if ftype == 3:
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(n):
            if i >= bpp:
                a, c = cur[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_pnm(data: bytes) -> Tuple[np.ndarray, str]:
    """Binary PGM (``P5``) and PPM (``P6``) with maxval <= 255."""
    magic = data[:2]
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n",
                                                                b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("malformed PNM header")
        fields.append(int(data[start:pos]))
    pos += 1                    # the one whitespace byte before the raster
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"PNM with maxval {maxval} is not supported "
                         "(8 bits only)")
    spp = 1 if magic == b"P5" else 3
    px = np.frombuffer(data, np.uint8, count=w * h * spp, offset=pos)
    return px.reshape(h, w, spp), ("L" if spp == 1 else "RGB")


def write_png(path, pixels: np.ndarray, level: int = 6) -> None:
    """Write a uint8 (h, w) or (h, w, c) array, c in 1-4, as an 8-bit PNG
    (every row filtered with Sub)."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError("write_png takes uint8 pixels")
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    sub = a.copy()
    sub[:, 1:] -= a[:, :-1]     # Sub: each sample less its left neighbour
    raw = np.concatenate([np.ones((h, 1), np.uint8),
                          sub.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def _l24(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def convert(pixels: np.ndarray, mode: str, palette: Optional[np.ndarray],
            target: str) -> np.ndarray:
    """PIL's ``convert(target)`` for ``target`` L or RGB: (h, w) for L,
    (h, w, 3) for RGB.  Alpha is dropped, not composited (PIL's rule); a
    palette index past the palette reads black."""
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        rgb = pal[pixels[..., 0]]
        return _l24(rgb) if target == "L" else rgb
    if mode in ("L", "LA"):
        grey = pixels[..., 0]
        return grey if target == "L" else np.repeat(grey[..., None], 3,
                                                    axis=2)
    if mode in ("RGB", "RGBA"):
        rgb = pixels[..., :3]
        return _l24(rgb) if target == "L" else rgb
    raise ValueError(f"cannot convert mode {mode}")


# ------------------------------------------------------------ resize ----

_PRECISION_BITS = 32 - 8 - 2


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    """PIL's ``bicubic_filter`` (a = -0.5)."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# filter -> (function, support): Resample.c's BILINEAR and BICUBIC
_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str = "bilinear"):
    """PIL's ``precompute_coeffs`` for a filter of ``_FILTERS``, then
    ``normalize_coeffs_8bpc``: per output index the first input index,
    and fixed-point weights (out, ksize) with zeros past each window."""
    filt, fsupport = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(ws)
        for x, wv in enumerate(ws):
            kk[xx, x] = wv / total if total != 0.0 else wv
        bounds[xx] = (xmin, xmax)
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + kk * (1 << _PRECISION_BITS)))
    return bounds, fixed.astype(np.int64), ksize


def _pass(img: np.ndarray, axis: int, bounds, k, ksize: int) -> np.ndarray:
    """One fixed-point pass along ``axis`` of a uint8 (h, w, c) image."""
    n_in = img.shape[axis]
    acc = np.full(img.shape[:axis] + (len(bounds),) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for x in range(ksize):
        idx = np.minimum(bounds[:, 0] + x, n_in - 1)
        w = np.where(x < bounds[:, 1], k[:, x], 0)
        shape = [1] * img.ndim
        shape[axis] = len(bounds)
        acc += np.take(src, idx, axis=axis) * w.reshape(shape)
    out = acc >> _PRECISION_BITS
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, height: int, width: int,
            kind: str) -> np.ndarray:
    squeeze = img.ndim == 2
    a = img[:, :, None] if squeeze else img
    h, w = a.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    bv, kv, ksv = _coeffs(h, height, kind)
    if w != width:
        # the horizontal pass runs over the rows the vertical one reads
        first = int(bv[0, 0])
        last = int(bv[-1, 0] + bv[-1, 1])
        bh, kh, ksh = _coeffs(w, width, kind)
        a = _pass(a[first:last], 1, bh, kh, ksh)
        bv = bv.copy()
        bv[:, 0] -= first
    if h != height:
        a = _pass(a, 0, bv, kv, ksv)
    return a[:, :, 0] if squeeze else a


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), BILINEAR)`` of a uint8
    (h, w) or (h, w, c) image."""
    return _resize(img, height, width, "bilinear")


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height))`` of a uint8 (h, w) L or
    (h, w, 3) RGB image: Pillow's default filter for those modes is
    BICUBIC (support 2, a = -0.5), in the same fixed point as the
    bilinear pass."""
    return _resize(img, height, width, "bicubic")


# ------------------------------------------------------------ rotate ----

def rotate_bilinear_f(img: np.ndarray, angle: float) -> np.ndarray:
    """PIL's ``Image.fromarray(img, "F").rotate(angle, BILINEAR)`` of a
    float32 (h, w) image: same size, about the centre, zero outside."""
    a = np.asarray(img, np.float32)
    h, w = a.shape
    angle = angle % 360.0
    if angle == 0:
        return a.copy()
    if angle == 180:
        return a[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.rot90(a, 1 if angle == 90 else 3).copy()
    cx, cy = w / 2, h / 2
    t = -math.radians(angle)
    m = [round(math.cos(t), 15), round(math.sin(t), 15), 0.0,
         round(-math.sin(t), 15), round(math.cos(t), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5,
                         indexing="ij")
    xin = m[0] * xs + m[1] * ys + m[2]
    yin = m[3] * xs + m[4] * ys + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin = xin - 0.5
    yin = yin - 0.5
    x = np.floor(xin).astype(np.int64)
    y = np.floor(yin).astype(np.int64)
    dx = xin - x
    dy = yin - y
    x0 = np.clip(x, 0, w - 1)
    x1 = np.clip(x + 1, 0, w - 1)
    yc = np.clip(y, 0, h - 1)
    src = a.astype(np.float64)
    r0a, r0b = src[yc, x0], src[yc, x1]
    v1 = r0a + (r0b - r0a) * dx
    y1ok = (y + 1 >= 0) & (y + 1 < h)
    y1 = np.clip(y + 1, 0, h - 1)
    r1a, r1b = src[y1, x0], src[y1, x1]
    v2 = np.where(y1ok, r1a + (r1b - r1a) * dx, v1)
    v = v1 + (v2 - v1) * dy
    return np.where(inside, v, 0.0).astype(np.float32)
