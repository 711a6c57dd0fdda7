"""The port's own Arrow IPC codec: the stream format and the file format
(Feather v2), read and written without pyarrow, which the H100 machine
lacks — what ``datavec/arrow.py`` needs (the reference writes and reads
through pyarrow: ``deeplearning4j_tpu/datavec/arrow.py:108-129``).

Layout (the Arrow columnar format, metadata version V5): a stream is a
run of encapsulated messages — ``0xFFFFFFFF``, the metadata length, a
flatbuffer ``Message`` padded to 8 bytes, then the message body — ending
with ``0xFFFFFFFF 0x00000000``.  A file is ``ARROW1`` and two pad bytes,
the same stream, a flatbuffer ``Footer`` (the schema and the offset of
each record batch), its length and ``ARROW1`` again.  The flatbuffer
tables (``Message``, ``Schema``, ``Field``, ``RecordBatch``,
``BodyCompression``, ``Footer``) are written and read by hand below, with
every scalar at its natural alignment, as flatbuffers' verifier (which
pyarrow runs) asks.

Columns: int8/16/32/64 and their unsigned kinds, float32 and float64,
bool (one bit a value) and utf8 / large utf8, each with its validity
bitmap (bit ``i`` clear = row ``i`` is null).  Bodies are read plain or
compressed buffer by buffer with LZ4_FRAME — ``pyarrow.feather.
write_feather``'s default — by the LZ4 frame decoder here; a ZSTD body
raises naming it.  The writer emits plain bodies, one record batch, every
buffer 8-byte aligned: valid Feather v2, which pyarrow reads.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ArrowType", "ArrowField", "ArrowColumn", "ArrowTable",
           "read_ipc_file", "read_ipc_stream", "write_ipc_file",
           "write_ipc_stream", "lz4_frame_decompress", "is_ipc_file"]

_MAGIC = b"ARROW1"
_CONT = 0xFFFFFFFF
_V5 = 4                     # MetadataVersion.V5

# Type union members (Schema.fbs)
_T_INT, _T_FLOAT, _T_UTF8, _T_BOOL, _T_LARGE_UTF8 = 2, 3, 5, 6, 20
# MessageHeader union members
_H_SCHEMA, _H_DICT, _H_BATCH = 1, 2, 3


# ------------------------------------------------------------- types ----

class ArrowType:
    """A column type, named as pyarrow names it (``str(pa.int32())`` is
    ``"int32"``, ``str(pa.float32())`` is ``"float"``)."""

    __slots__ = ("name", "kind", "bitWidth", "signed")

    def __init__(self, name: str, kind: str, bitWidth: int = 0,
                 signed: bool = True):
        self.name, self.kind = name, kind
        self.bitWidth, self.signed = bitWidth, signed

    def __eq__(self, other):
        return isinstance(other, ArrowType) and other.name == self.name

    def __hash__(self):
        return hash(self.name)

    def __str__(self):
        return self.name

    __repr__ = __str__

    @property
    def dtype(self) -> np.dtype:
        if self.kind == "int":
            return np.dtype(f"<{'i' if self.signed else 'u'}"
                            f"{self.bitWidth // 8}")
        if self.kind == "float":
            return np.dtype("<f4" if self.bitWidth == 32 else "<f8")
        raise TypeError(f"{self.name} has no fixed-width dtype")


def _int(bits: int, signed: bool = True) -> ArrowType:
    return ArrowType(f"{'' if signed else 'u'}int{bits}", "int", bits, signed)


INT32, INT64 = _int(32), _int(64)
FLOAT32 = ArrowType("float", "float", 32)
FLOAT64 = ArrowType("double", "float", 64)
BOOL = ArrowType("bool", "bool")
STRING = ArrowType("string", "utf8")
LARGE_STRING = ArrowType("large_string", "utf8", 64)


class ArrowField:
    __slots__ = ("name", "type", "nullable")

    def __init__(self, name: str, type: ArrowType, nullable: bool = True):
        self.name, self.type, self.nullable = name, type, nullable

    def __repr__(self):
        return f"{self.name}: {self.type}"


class ArrowColumn:
    """One column: Python values, ``None`` for a null."""

    def __init__(self, type: ArrowType, values: Sequence):
        self.type = type
        self._values = list(values)

    def __len__(self):
        return len(self._values)

    def to_pylist(self) -> list:
        return list(self._values)


class ArrowTable:
    """The port's stand-in for ``pyarrow.Table`` where the reference hands
    one out: named columns, ``num_rows``, ``schema`` (its fields, each with
    ``name`` and ``type``), ``column(name)`` and ``column_names``."""

    def __init__(self, fields: List[ArrowField], columns: List[ArrowColumn]):
        if len(fields) != len(columns):
            raise ValueError("one column per field")
        lens = {len(c) for c in columns}
        if len(lens) > 1:
            raise ValueError(f"columns of different lengths {sorted(lens)}")
        self.schema = list(fields)
        self.columns = list(columns)
        self.num_rows = lens.pop() if lens else 0

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.schema]

    def column(self, name):
        i = name if isinstance(name, int) else self.column_names.index(name)
        return self.columns[i]

    def to_pydict(self) -> Dict[str, list]:
        return {f.name: c.to_pylist() for f, c in zip(self.schema,
                                                      self.columns)}

    def __repr__(self):
        return (f"ArrowTable({self.num_rows} rows: "
                f"{', '.join(map(repr, self.schema))})")


# ------------------------------------------------- flatbuffer reading ----

class _Table:
    """A flatbuffer table at ``pos`` of ``buf``."""

    __slots__ = ("buf", "pos", "vt", "vlen")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vlen = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, field: int) -> int:
        o = 4 + 2 * field
        if o >= self.vlen:
            return 0
        return struct.unpack_from("<H", self.buf, self.vt + o)[0]

    def scalar(self, field: int, fmt: str, default=0):
        o = self._off(field)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] \
            if o else default

    def _ref(self, field: int) -> Optional[int]:
        o = self._off(field)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, field: int) -> Optional["_Table"]:
        p = self._ref(field)
        return None if p is None else _Table(self.buf, p)

    def string(self, field: int) -> Optional[str]:
        p = self._ref(field)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return self.buf[p + 4:p + 4 + n].decode("utf-8")

    def vector(self, field: int) -> Tuple[int, int]:
        """(element start, count) of a vector field; (0, 0) if absent."""
        p = self._ref(field)
        if p is None:
            return 0, 0
        return p + 4, struct.unpack_from("<I", self.buf, p)[0]

    def tables(self, field: int) -> List["_Table"]:
        start, n = self.vector(field)
        out = []
        for i in range(n):
            q = start + 4 * i
            out.append(_Table(self.buf, q + struct.unpack_from(
                "<I", self.buf, q)[0]))
        return out


def _root(buf: bytes, pos: int = 0) -> _Table:
    return _Table(buf, pos + struct.unpack_from("<I", buf, pos)[0])


# ------------------------------------------------- flatbuffer writing ----

class _FB:
    """A flatbuffer written front to back: an object's children are laid
    out after it, so every unsigned offset points forward, and each
    table's vtable sits just before it (a positive signed offset)."""

    def __init__(self):
        self.buf = bytearray(b"\0\0\0\0")       # the root offset

    def _align(self, n: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % n:
            self.buf.append(0)

    def finish(self, root) -> bytes:
        pos = self.write(root)
        struct.pack_into("<I", self.buf, 0, pos)
        self._align(8)
        return bytes(self.buf)

    def write(self, obj) -> int:
        kind = obj[0]
        if kind == "table":
            return self._table(obj[1])
        if kind == "string":
            self._align(4)
            pos = len(self.buf)
            raw = obj[1].encode("utf-8")
            self.buf += struct.pack("<I", len(raw)) + raw + b"\0"
            return pos
        if kind == "structs":           # (align, [bytes, ...])
            align, items = obj[1], obj[2]
            self._align(max(align, 4), 4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(items))
            for it in items:
                self.buf += it
            return pos
        if kind == "scalars":           # (fmt, [values])
            fmt, items = obj[1], obj[2]
            self._align(max(struct.calcsize(fmt), 4), 4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(items))
            for v in items:
                self.buf += struct.pack("<" + fmt, v)
            return pos
        if kind == "tables":
            items = obj[1]
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(items))
            slots = []
            for _ in items:
                slots.append(len(self.buf))
                self.buf += b"\0\0\0\0"
            for slot, it in zip(slots, items):
                child = self.write(it)
                struct.pack_into("<I", self.buf, slot, child - slot)
            return pos
        raise ValueError(kind)

    def _table(self, fields) -> int:
        """``fields``: per field id, None (absent), ``(fmt, value)`` for a
        scalar, ``("struct", align, bytes)`` inline, or a child object."""
        n = len(fields)
        layout = []
        for fid, f in enumerate(fields):
            if f is None:
                continue
            if f[0] == "struct":
                layout.append((fid, f[1], len(f[2]), f))
            elif f[0] in ("table", "string", "structs", "scalars",
                          "tables"):
                layout.append((fid, 4, 4, f))
            else:
                size = struct.calcsize(f[0])
                layout.append((fid, size, size, f))
        layout.sort(key=lambda e: -e[1])
        # vtable first (2-aligned), then the table (8-aligned for safety)
        vt_size = 4 + 2 * n
        self._align(2)
        vt = len(self.buf)
        self.buf += b"\0" * vt_size
        self._align(8)
        tpos = len(self.buf)
        self.buf += struct.pack("<i", tpos - vt)
        offs = [0] * n
        children = []
        for fid, align, size, f in layout:
            self._align(align)
            offs[fid] = len(self.buf) - tpos
            if f[0] == "struct":
                self.buf += f[2]
            elif f[0] in ("table", "string", "structs", "scalars",
                          "tables"):
                children.append((len(self.buf), f))
                self.buf += b"\0\0\0\0"
            else:
                self.buf += struct.pack("<" + f[0], f[1])
        tsize = len(self.buf) - tpos
        struct.pack_into("<HH", self.buf, vt, vt_size, tsize)
        for fid in range(n):
            struct.pack_into("<H", self.buf, vt + 4 + 2 * fid, offs[fid])
        for slot, f in children:
            child = self.write(f)
            struct.pack_into("<I", self.buf, slot, child - slot)
        return tpos


# ------------------------------------------------------------ schema ----

def _type_of(field: _Table) -> ArrowType:
    tt = field.scalar(2, "B")
    t = field.table(3)
    if tt == _T_INT:
        return _int(t.scalar(0, "i"), bool(t.scalar(1, "B")))
    if tt == _T_FLOAT:
        prec = t.scalar(0, "h")
        if prec == 1:
            return FLOAT32
        if prec == 2:
            return FLOAT64
        raise NotImplementedError("float16 Arrow columns are not ported")
    if tt == _T_UTF8:
        return STRING
    if tt == _T_LARGE_UTF8:
        return LARGE_STRING
    if tt == _T_BOOL:
        return BOOL
    raise NotImplementedError(
        f"Arrow column type {tt} (Schema.fbs Type union) is not ported: "
        "int, float32/64, bool and utf8 are")


def _read_schema(schema: _Table) -> List[ArrowField]:
    if schema.scalar(0, "h") != 0:
        raise NotImplementedError("big-endian Arrow data is not ported")
    out = []
    for f in schema.tables(1):
        if f.table(4) is not None:
            raise NotImplementedError(
                f"dictionary-encoded Arrow column {f.string(0)!r} is not "
                "ported")
        out.append(ArrowField(f.string(0) or "", _type_of(f),
                              bool(f.scalar(1, "B"))))
    return out


def _type_fields(t: ArrowType):
    if t.kind == "int":
        return _T_INT, ("table", [("i", t.bitWidth), ("B", int(t.signed))])
    if t.kind == "float":
        return _T_FLOAT, ("table", [("h", 1 if t.bitWidth == 32 else 2)])
    if t.kind == "bool":
        return _T_BOOL, ("table", [])
    if t.kind == "utf8":
        return (_T_LARGE_UTF8 if t.bitWidth == 64 else _T_UTF8), \
            ("table", [])
    raise NotImplementedError(str(t))


def _schema_obj(fields: Sequence[ArrowField]):
    fobjs = []
    for f in fields:
        tt, tobj = _type_fields(f.type)
        fobjs.append(("table", [("string", f.name), ("B", int(f.nullable)),
                                ("B", tt), tobj, None,
                                ("tables", [])]))
    return ("table", [("h", 0), ("tables", fobjs)])


def _message(header_type: int, header, body_len: int) -> bytes:
    return _FB().finish(("table", [("h", _V5), ("B", header_type), header,
                                   ("q", body_len)]))


# ------------------------------------------------------------- LZ4 ------

def _lz4_block(src: bytes, out: bytearray) -> None:
    """Decode one LZ4 block onto ``out`` (earlier output is the window)."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break
        off = src[i] | src[i + 1] << 8
        i += 2
        if off == 0:
            raise ValueError("corrupt LZ4 block: match offset 0")
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - off
        if start < 0:
            raise ValueError("corrupt LZ4 block: match before the start")
        if off >= ml:
            out += out[start:start + ml]
        else:
            pat = bytes(out[start:])
            out += (pat * (ml // off + 1))[:ml]


def lz4_frame_decompress(data: bytes) -> bytes:
    """The LZ4 frame format (magic ``0x184D2204``): linked or independent
    blocks, stored blocks, optional content size, block and content
    checksums (skipped, not verified); skippable frames are passed over."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        magic = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:          # skippable frame
            size = struct.unpack_from("<I", data, pos)[0]
            pos += 4 + size
            continue
        if magic != 0x184D2204:
            raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
        flg = data[pos]
        pos += 2                                      # FLG, BD
        if (flg >> 6) != 1:
            raise ValueError(f"LZ4 frame version {flg >> 6} is not 1")
        if flg & 8:
            pos += 8                                  # content size
        if flg & 1:
            pos += 4                                  # dictionary id
        pos += 1                                      # header checksum
        block_sum = bool(flg & 16)
        while True:
            size = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            if size == 0:
                break
            stored = size & 0x80000000
            size &= 0x7FFFFFFF
            block = data[pos:pos + size]
            pos += size
            if stored:
                out += block
            else:
                _lz4_block(block, out)
            if block_sum:
                pos += 4
        if flg & 4:
            pos += 4                                  # content checksum
    return bytes(out)


# ------------------------------------------------------------ reading ----

def _buffers(batch: _Table, body: bytes) -> List[bytes]:
    start, n = batch.vector(2)
    bufs = []
    for i in range(n):
        off, ln = struct.unpack_from("<qq", batch.buf, start + 16 * i)
        bufs.append(body[off:off + ln])
    comp = batch.table(3)
    if comp is not None:
        codec = comp.scalar(0, "b")
        if codec != 0:
            raise NotImplementedError(
                "a ZSTD-compressed Arrow body is not ported (LZ4_FRAME is)")
        out = []
        for b in bufs:
            if len(b) == 0:
                out.append(b)
                continue
            raw_len = struct.unpack_from("<q", b, 0)[0]
            if raw_len == -1:
                out.append(b[8:])
            else:
                dec = lz4_frame_decompress(b[8:])
                if len(dec) != raw_len:
                    raise ValueError(f"LZ4 buffer of {len(dec)} bytes, "
                                     f"{raw_len} declared")
                out.append(dec)
        bufs = out
    return bufs


def _valid(buf: bytes, length: int, nulls: int) -> Optional[np.ndarray]:
    if nulls == 0 or len(buf) == 0:
        return None
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    return bits[:length].astype(bool)


def _decode_batch(fields: List[ArrowField], batch: _Table,
                  body: bytes) -> List[list]:
    length = batch.scalar(0, "q")
    nstart, nn = batch.vector(1)
    nodes = [struct.unpack_from("<qq", batch.buf, nstart + 16 * i)
             for i in range(nn)]
    bufs = _buffers(batch, body)
    cols = []
    bi = 0
    for fi, f in enumerate(fields):
        n, nulls = nodes[fi]
        valid = _valid(bufs[bi], n, nulls)
        t = f.type
        if t.kind in ("int", "float"):
            vals = np.frombuffer(bufs[bi + 1], t.dtype, count=n)
            py = [v.item() for v in vals]
            bi += 2
        elif t.kind == "bool":
            bits = np.unpackbits(np.frombuffer(bufs[bi + 1], np.uint8),
                                 bitorder="little")[:n]
            py = [bool(v) for v in bits]
            bi += 2
        else:
            ot = np.dtype("<i8" if t.bitWidth == 64 else "<i4")
            offs = np.frombuffer(bufs[bi + 1], ot, count=n + 1)
            data = bufs[bi + 2]
            py = [data[offs[i]:offs[i + 1]].decode("utf-8")
                  for i in range(n)]
            bi += 3
        if valid is not None:
            py = [v if ok else None for v, ok in zip(py, valid)]
        if n != length:
            raise ValueError(f"column {f.name!r} has {n} rows of {length}")
        cols.append(py)
    return cols


def _table_of(fields: List[ArrowField], batches: List[List[list]]
              ) -> ArrowTable:
    cols = [ArrowColumn(f.type, [v for b in batches for v in b[i]])
            for i, f in enumerate(fields)]
    return ArrowTable(fields, cols)


def _read_message(buf: bytes, pos: int):
    """(message table or None at the end, body, position after)."""
    if pos + 4 > len(buf):
        return None, b"", pos
    first = struct.unpack_from("<I", buf, pos)[0]
    if first == _CONT:
        ln = struct.unpack_from("<i", buf, pos + 4)[0]
        pos += 8
    else:                                   # pre-0.15 framing
        ln = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
    if ln == 0:
        return None, b"", pos
    msg = _root(buf, pos)
    pos += ln
    body_len = msg.scalar(3, "q")
    body = buf[pos:pos + body_len]
    return msg, body, pos + body_len


def _read_messages(buf: bytes, pos: int) -> ArrowTable:
    fields = None
    batches = []
    while True:
        msg, body, pos = _read_message(buf, pos)
        if msg is None:
            break
        ht = msg.scalar(1, "B")
        if ht == _H_SCHEMA:
            fields = _read_schema(msg.table(2))
        elif ht == _H_BATCH:
            if fields is None:
                raise ValueError("record batch before the schema")
            batches.append(_decode_batch(fields, msg.table(2), body))
        elif ht == _H_DICT:
            raise NotImplementedError(
                "Arrow dictionary batches are not ported")
    if fields is None:
        raise ValueError("no Arrow schema message")
    return _table_of(fields, batches)


def is_ipc_file(head: bytes) -> bool:
    return head[:6] == _MAGIC


def read_ipc_stream(path: str) -> ArrowTable:
    with open(path, "rb") as f:
        buf = f.read()
    return _read_messages(buf, 0)


def read_ipc_file(path: str) -> ArrowTable:
    """A Feather v2 / Arrow IPC file, through its footer's schema and
    record-batch blocks."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:6] == b"FEA1":
        raise NotImplementedError("Feather v1 files are not ported (v2, "
                                  "the Arrow IPC file format, is)")
    if not (is_ipc_file(buf) and buf[-6:] == _MAGIC):
        raise ValueError(f"{path} is not an Arrow IPC file")
    flen = struct.unpack_from("<i", buf, len(buf) - 10)[0]
    footer = _root(buf, len(buf) - 10 - flen)
    fields = _read_schema(footer.table(1))
    start, n = footer.vector(3)
    batches = []
    for i in range(n):
        off, mlen, blen = struct.unpack_from("<qi4xq", buf, start + 24 * i)
        msg, body, _ = _read_message(buf, off)
        if msg is None or msg.scalar(1, "B") != _H_BATCH:
            raise ValueError(f"block {i} is not a record batch")
        batches.append(_decode_batch(fields, msg.table(2), body))
    return _table_of(fields, batches)


# ------------------------------------------------------------ writing ----

def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _column_buffers(t: ArrowType, vals: list) -> Tuple[int, List[bytes]]:
    n = len(vals)
    valid = np.asarray([v is not None for v in vals], bool)
    nulls = int(n - valid.sum())
    vbuf = np.packbits(valid, bitorder="little").tobytes() if nulls else b""
    if t.kind in ("int", "float"):
        data = np.asarray([0 if v is None else v for v in vals],
                          t.dtype).tobytes()
        return nulls, [vbuf, data]
    if t.kind == "bool":
        bits = np.asarray([bool(v) if v is not None else False
                           for v in vals], bool)
        return nulls, [vbuf, np.packbits(bits, bitorder="little").tobytes()]
    raw = [b"" if v is None else str(v).encode("utf-8") for v in vals]
    offs = np.zeros(n + 1, np.int64 if t.bitWidth == 64 else np.int32)
    np.cumsum([len(r) for r in raw], out=offs[1:])
    return nulls, [vbuf, offs.tobytes(), b"".join(raw)]


def _batch_message(table: ArrowTable) -> Tuple[bytes, bytes]:
    nodes, bufspecs, body = [], [], bytearray()
    for f, c in zip(table.schema, table.columns):
        nulls, bufs = _column_buffers(f.type, c.to_pylist())
        nodes.append(struct.pack("<qq", len(c), nulls))
        for b in bufs:
            bufspecs.append(struct.pack("<qq", len(body), len(b)))
            body += _pad8(b)
    header = ("table", [("q", table.num_rows), ("structs", 8, nodes),
                        ("structs", 8, bufspecs)])
    return _message(_H_BATCH, header, len(body)), bytes(body)


def _framed(meta: bytes) -> bytes:
    meta = _pad8(meta)
    return struct.pack("<Ii", _CONT, len(meta)) + meta


def write_ipc_stream(table: ArrowTable, path: str) -> None:
    meta, body = _batch_message(table)
    out = [_framed(_message(_H_SCHEMA, _schema_obj(table.schema), 0)),
           _framed(meta), body, struct.pack("<Ii", _CONT, 0)]
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_ipc_file(table: ArrowTable, path: str) -> None:
    """Feather v2: the stream between the magics, then the footer."""
    out = bytearray(_MAGIC + b"\0\0")
    out += _framed(_message(_H_SCHEMA, _schema_obj(table.schema), 0))
    meta, body = _batch_message(table)
    block_off = len(out)
    framed = _framed(meta)
    out += framed + body
    out += struct.pack("<Ii", _CONT, 0)
    block = struct.pack("<qi4xq", block_off, len(framed), len(body))
    footer = _FB().finish(("table", [
        ("h", _V5), _schema_obj(table.schema), ("structs", 8, []),
        ("structs", 8, [block])]))
    out += footer
    out += struct.pack("<i", len(footer)) + _MAGIC
    with open(path, "wb") as f:
        f.write(bytes(out))
