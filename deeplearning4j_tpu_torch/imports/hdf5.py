"""A read-only HDF5 decoder: the part of the format that Keras writes.

The counterpart of what the reference takes from the installed ``h5py``
(``deeplearning4j_tpu/imports/keras_import.py``, ``h5py.File`` at the
``.h5`` route and on ``model.weights.h5`` inside a ``.keras`` zip): the
port reads Keras files without h5py, so a card's machine that has none
imports them all the same.  The file format is public and stable (the
HDF Group's "HDF5 File Format Specification Version 3.0").

Covered, which is what keras writes through h5py at its default
``libver="earliest"``:

- superblock versions 0 and 1 (versions 2 and 3 are read up to their root
  object header, which is a version 2 one and refused);
- version 1 object headers, with continuation blocks;
- symbol-table groups: a version 1 B-tree of any depth over symbol-table
  nodes (``SNOD``) and a local heap of names;
- attribute messages (versions 1-3);
- datatypes: fixed-point and IEEE floating point (2, 4 or 8 bytes,
  little-endian), fixed-length strings, variable-length strings through
  global heap collections (``GCOL``), and arrays of these;
- scalar and simple dataspaces;
- compact and contiguous layouts; an undefined address (storage never
  allocated) reads as the fill value, zeros unless one is stored.

Anything else raises ``ValueError`` naming what was met: chunked layout,
filters, version 2 object headers, new-style (link message) groups,
fractal heaps, shared messages, big-endian numbers, other datatypes.
There is no fallback to h5py.

The classes answer what the importer asks of ``h5py``: groups by path,
``keys()``, ``in``, ``attrs`` (``get``; variable-length strings come back
as ``str``, fixed-length ones as ``bytes``, as h5py gives them), datasets
with ``shape``, ``dtype``, ``[()]`` and ``np.asarray``, and
``visititems`` in h5py's order (names ascending, a group before its
members).
"""
from __future__ import annotations

import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "AttributeManager"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types (spec section IV.A.2)
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x04, 0x05, 0x06, 0x08
_FILTERS, _ATTRIBUTE, _CONTINUATION = 0x0B, 0x0C, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time",
                3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length",
                10: "array"}


def _refuse(what: str):
    raise ValueError(f"HDF5: {what} is outside the subset this reader "
                     "decodes (the one keras writes through h5py)")


class _Type:
    """A decoded datatype: ``kind`` is "number", "fstring", "vstring" or
    "array"; ``size`` is the element's size in the file."""

    def __init__(self, kind, size, np_dtype=None, base=None, dims=(),
                 utf8=False):
        self.kind, self.size, self.np_dtype = kind, size, np_dtype
        self.base, self.dims, self.utf8 = base, dims, utf8

    def numpy_dtype(self) -> np.dtype:
        if self.kind == "number":
            return self.np_dtype
        if self.kind == "fstring":
            return np.dtype(f"S{self.size}")
        if self.kind == "vstring":
            return np.dtype("O")
        return np.dtype((self.base.numpy_dtype(), self.dims))


class File:
    """An HDF5 file opened for reading: ``File(path)`` or ``File(fileobj)``
    (a binary file object, e.g. ``io.BytesIO``); mode ``"r"`` only.  The
    root group's API is the file's (``f["a/b"]``, ``f.attrs``, ...)."""

    def __init__(self, source, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"HDF5: mode {mode!r}: this reader only reads")
        if isinstance(source, (str, os.PathLike)):
            with open(source, "rb") as fh:
                data = fh.read()
            self.filename = os.fspath(source)
        else:
            source.seek(0)
            data = source.read()
            self.filename = getattr(source, "name", "<file object>")
        self._buf = memoryview(data)
        self._objects: Dict[int, object] = {}
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        self._read_superblock()
        self._root = self._object(self._root_addr, "/")

    # -- the root group's API ------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._root, name)

    def __getitem__(self, path):
        return self._root[path]

    def __contains__(self, path) -> bool:
        return path in self._root

    def __iter__(self):
        return iter(self._root)

    def __len__(self) -> int:
        return len(self._root)

    def close(self) -> None:
        self._buf = memoryview(b"")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- low-level reads -----------------------------------------------
    def _u(self, pos: int, n: int) -> int:
        return int.from_bytes(self._buf[pos:pos + n], "little")

    def _addr(self, pos: int) -> Optional[int]:
        """An address of ``sizeof_offsets`` bytes at ``pos``, relative to
        the base address; None for the undefined address (all ones)."""
        raw = self._u(pos, self._so)
        return None if raw == (1 << (8 * self._so)) - 1 else raw + self._base

    def _sig(self, pos: int, sig: bytes, what: str) -> None:
        if bytes(self._buf[pos:pos + 4]) != sig:
            raise ValueError(f"HDF5: no {what} signature {sig!r} at {pos}")

    def _read_superblock(self) -> None:
        pos, n = 0, len(self._buf)
        while pos + 8 <= n and bytes(self._buf[pos:pos + 8]) != _SIGNATURE:
            pos = 512 if pos == 0 else pos * 2
        if pos + 8 > n:
            raise ValueError(f"HDF5: {self.filename} is not an HDF5 file "
                             "(no superblock signature)")
        version = self._buf[pos + 8]
        if version in (0, 1):
            self._so, self._sl = self._buf[pos + 13], self._buf[pos + 14]
            p = pos + 24 + (4 if version == 1 else 0)
            self._base = self._u(p, self._so)
            # four addresses (the base first), then the root group's
            # symbol table entry (its object header address second)
            self._root_addr = self._addr(p + 4 * self._so + self._so)
        elif version in (2, 3):
            self._so, self._sl = self._buf[pos + 9], self._buf[pos + 10]
            self._base = self._u(pos + 12, self._so)
            self._root_addr = self._addr(pos + 12 + 3 * self._so)
        else:
            _refuse(f"superblock version {version}")

    # -- object headers ------------------------------------------------
    def _messages(self, addr: int) -> List[Tuple[int, int, memoryview]]:
        """The ``(type, flags, data)`` messages of the version 1 object
        header at ``addr``, continuation blocks followed."""
        if bytes(self._buf[addr:addr + 4]) == b"OHDR":
            _refuse("a version 2 object header (OHDR, written under "
                    "libver='latest')")
        if self._buf[addr] != 1:
            _refuse(f"object header version {self._buf[addr]}")
        size = self._u(addr + 8, 4)
        blocks = [(addr + 16, addr + 16 + size)]
        out = []
        while blocks:
            pos, end = blocks.pop(0)
            while pos + 8 <= end:
                mtype, msize = self._u(pos, 2), self._u(pos + 2, 2)
                flags = self._buf[pos + 4]
                data = self._buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _NIL:
                    continue
                if flags & 0x02:
                    _refuse(f"a shared message (type {mtype:#x})")
                if mtype == _CONTINUATION:
                    start = self._addr_in(data, 0)
                    blocks.append((start, start + int.from_bytes(
                        data[self._so:self._so + self._sl], "little")))
                    continue
                out.append((mtype, flags, data))
        return out

    def _addr_in(self, data: memoryview, pos: int) -> Optional[int]:
        raw = int.from_bytes(data[pos:pos + self._so], "little")
        return None if raw == (1 << (8 * self._so)) - 1 else raw + self._base

    def _object(self, addr: int, name: str):
        obj = self._objects.get(addr)
        if obj is None:
            msgs = self._messages(addr)
            types = {m[0] for m in msgs}
            if _LINK in types or _LINK_INFO in types:
                _refuse("a new-style group (link messages)")
            if _SYMBOL_TABLE in types:
                obj = Group(self, addr, name, msgs)
            elif _LAYOUT in types:
                obj = Dataset(self, addr, name, msgs)
            else:
                _refuse(f"an object at {addr} that is neither a group nor "
                        "a dataset (a committed datatype?)")
            self._objects[addr] = obj
        return obj

    # -- groups: B-tree, symbol-table nodes, local heap ----------------
    def _local_heap(self, addr: int) -> int:
        self._sig(addr, b"HEAP", "local heap")
        return self._addr(addr + 8 + 2 * self._sl)

    def _links(self, btree: int, heap: int) -> List[Tuple[str, int]]:
        """The ``(name, object header address)`` entries of a symbol-table
        group, in the B-tree's order (names ascending)."""
        data = self._local_heap(heap)
        out: List[Tuple[str, int]] = []
        self._btree_entries(btree, data, out)
        return out

    def _btree_entries(self, node: int, heap_data: int, out) -> None:
        self._sig(node, b"TREE", "v1 B-tree node")
        if self._buf[node + 4] != 0:
            _refuse(f"a v1 B-tree of type {self._buf[node + 4]} in a group")
        level, used = self._buf[node + 5], self._u(node + 6, 2)
        pos = node + 8 + 2 * self._so + self._sl   # past key 0
        for _ in range(used):
            child = self._addr(pos)
            if level > 0:
                self._btree_entries(child, heap_data, out)
            else:
                self._snod_entries(child, heap_data, out)
            pos += self._so + self._sl

    def _snod_entries(self, addr: int, heap_data: int, out) -> None:
        self._sig(addr, b"SNOD", "symbol table node")
        n = self._u(addr + 6, 2)
        entry = 2 * self._so + 24
        for i in range(n):
            e = addr + 8 + i * entry
            off = heap_data + self._u(e, self._so)
            end = off
            while self._buf[end] != 0:
                end += 1
            out.append((bytes(self._buf[off:end]).decode("utf-8"),
                        self._addr(e + self._so)))

    # -- global heap ---------------------------------------------------
    def _global(self, addr: int, index: int) -> bytes:
        coll = self._heaps.get(addr)
        if coll is None:
            self._sig(addr, b"GCOL", "global heap collection")
            end = addr + self._u(addr + 8, self._sl)
            coll, pos = {}, addr + 8 + self._sl
            while pos + 8 + self._sl <= end:
                idx, size = self._u(pos, 2), self._u(pos + 8, self._sl)
                if idx == 0:          # the collection's free space
                    break
                data = pos + 8 + self._sl
                coll[idx] = bytes(self._buf[data:data + size])
                pos = data + (size + 7) // 8 * 8
            self._heaps[addr] = coll
        if index not in coll:
            raise ValueError(f"HDF5: global heap collection {addr} has no "
                             f"object {index}")
        return coll[index]

    # -- datatypes, dataspaces, values ---------------------------------
    def _datatype(self, d: memoryview, pos: int = 0) -> Tuple[_Type, int]:
        """The datatype message at ``d[pos:]`` -> ``(type, end)``."""
        cls, version = d[pos] & 0x0F, d[pos] >> 4
        bits = int.from_bytes(d[pos + 1:pos + 4], "little")
        size = int.from_bytes(d[pos + 4:pos + 8], "little")
        p = pos + 8
        if cls in (0, 1):
            if bits & 0x01 or (cls == 1 and bits & 0x40):
                _refuse(f"a big-endian or VAX-order {_CLASS_NAMES[cls]} "
                        "datatype")
            offset, prec = struct.unpack_from("<HH", d, p)
            if offset != 0 or prec != 8 * size:
                _refuse(f"a {_CLASS_NAMES[cls]} datatype with bit offset "
                        f"{offset} and precision {prec} in {size} bytes")
            if cls == 0:
                if size not in (1, 2, 4, 8):
                    _refuse(f"a {size}-byte integer")
                kind = "i" if bits & 0x08 else "u"
                return _Type("number", size,
                             np.dtype(f"<{kind}{size}")), p + 4
            ieee = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
                    8: (52, 11, 52, 1023)}
            layout = struct.unpack_from("<BBBBI", d, p + 4)
            if size not in ieee or \
                    (layout[0], layout[1], layout[3], layout[4]) \
                    != ieee[size] or layout[2] != 0:
                _refuse(f"a non-IEEE {size}-byte floating-point datatype")
            return _Type("number", size, np.dtype(f"<f{size}")), p + 12
        if cls == 3:
            return _Type("fstring", size, utf8=bool(bits >> 4 & 1)), p
        if cls == 9:
            if bits & 0x0F != 1:
                _refuse("a variable-length sequence datatype")
            base, end = self._datatype(d, p)
            return _Type("vstring", size, base=base,
                         utf8=bool(bits >> 8 & 0x0F)), end
        if cls == 10:
            # version 3 dropped version 2's reserved bytes and permutation
            ndims = d[p]
            p += 1 if version >= 3 else 4
            dims = struct.unpack_from(f"<{ndims}I", d, p)
            p += 4 * ndims * (1 if version >= 3 else 2)
            base, end = self._datatype(d, p)
            if base.kind == "array":
                _refuse("an array of arrays")
            return _Type("array", size, base=base, dims=tuple(dims)), end
        _refuse(f"a {_CLASS_NAMES.get(cls, f'class {cls}')} datatype")

    def _dataspace(self, d: memoryview) -> Tuple[int, ...]:
        version, ndims, flags = d[0], d[1], d[2]
        if version == 1:
            p = 8
        elif version == 2:
            if d[3] == 2:
                _refuse("a null dataspace")
            p = 4
        else:
            _refuse(f"dataspace version {version}")
        return tuple(int.from_bytes(d[p + i * self._sl:p + (i + 1) *
                                      self._sl], "little")
                     for i in range(ndims))

    def _values(self, t: _Type, shape: Tuple[int, ...], raw) -> np.ndarray:
        """The ``shape`` array of ``t`` elements stored in ``raw`` bytes."""
        n = int(np.prod(shape, dtype=np.int64))
        if t.kind == "number":
            return np.frombuffer(raw, t.np_dtype, n).reshape(shape).copy()
        if t.kind == "fstring":
            return np.frombuffer(raw, f"S{t.size}", n).reshape(shape).copy()
        if t.kind == "array":
            inner = self._values(t.base, (n, *t.dims), raw)
            return inner.reshape((*shape, *t.dims))
        out = np.empty(n, dtype=object)
        for i in range(n):
            base = i * t.size
            length = int.from_bytes(raw[base:base + 4], "little")
            addr = self._addr_in(raw, base + 4)
            index = int.from_bytes(raw[base + 4 + self._so:
                                       base + 8 + self._so], "little")
            out[i] = b"" if addr is None else \
                self._global(addr, index)[:length]
        return out.reshape(shape)

    def _attributes(self, msgs) -> Dict[str, np.ndarray]:
        out = {}
        for mtype, _flags, d in msgs:
            if mtype == _ATTRIBUTE_INFO:
                heap = self._addr_in(d, 2 + (2 if d[1] & 1 else 0))
                if heap is not None:
                    _refuse("dense attribute storage (a fractal heap)")
            if mtype != _ATTRIBUTE:
                continue
            version = d[0]
            if version not in (1, 2, 3):
                _refuse(f"attribute message version {version}")
            if version > 1 and d[1] & 0x03:
                _refuse("an attribute with a shared datatype or dataspace")
            nlen, tlen, slen = struct.unpack_from("<HHH", d, 2)
            p = 8 + (1 if version == 3 else 0)

            def step(n):
                return (n + 7) // 8 * 8 if version == 1 else n
            name = bytes(d[p:p + nlen]).split(b"\0")[0].decode("utf-8")
            p += step(nlen)
            t, _ = self._datatype(d, p)
            p += step(tlen)
            shape = self._dataspace(d[p:p + slen])
            p += step(slen)
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = (t, shape, d[p:p + n * t.size])
        return out


class AttributeManager:
    """``obj.attrs``: names ascending; a scalar comes back as a numpy
    scalar, ``str`` (variable-length string) or ``bytes`` (fixed-length),
    an array as a numpy array (variable-length strings as ``str`` in an
    object array), as h5py gives them."""

    def __init__(self, f: File, msgs):
        self._f = f
        self._raw = f._attributes(msgs)

    def _decode(self, t: _Type, shape, raw):
        v = self._f._values(t, shape, raw)
        if t.kind == "vstring":
            v = np.vectorize(lambda b: b.decode("utf-8", "surrogateescape"),
                             otypes=[object])(v) if v.size else v
        if shape == ():
            v = v[()]
            if t.kind == "fstring":
                v = bytes(v)
        return v

    def __getitem__(self, name: str):
        if name not in self._raw:
            raise KeyError(f"no attribute {name!r}")
        return self._decode(*self._raw[name])

    def get(self, name: str, default=None):
        return self[name] if name in self._raw else default

    def __contains__(self, name) -> bool:
        return name in self._raw

    def keys(self) -> List[str]:
        return sorted(self._raw)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._raw)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]


class _Object:
    def __init__(self, f: File, addr: int, name: str, msgs):
        self.file, self._addr, self.name, self._msgs = f, addr, name, msgs
        self._attrs = None

    @property
    def attrs(self) -> AttributeManager:
        if self._attrs is None:
            self._attrs = AttributeManager(self.file, self._msgs)
        return self._attrs


class Group(_Object):
    """A symbol-table group: members by (slash-separated) path."""

    def __init__(self, f: File, addr: int, name: str, msgs):
        super().__init__(f, addr, name, msgs)
        d = next(m[2] for m in msgs if m[0] == _SYMBOL_TABLE)
        self._members = dict(f._links(f._addr_in(d, 0),
                                      f._addr_in(d, f._so)))

    def _child(self, key: str):
        if key not in self._members:
            raise KeyError(f"no member {key!r} in group {self.name!r}")
        path = self.name.rstrip("/") + "/" + key
        return self.file._object(self._members[key], path)

    def __getitem__(self, path: str):
        obj = self.file._root if path.startswith("/") else self
        for part in (p for p in path.split("/") if p and p != "."):
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name!r} is a dataset, not a group")
            obj = obj._child(part)
        return obj

    def get(self, path: str, default=None):
        return self[path] if path in self else default

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return list(self._members)

    def __iter__(self):
        return iter(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def items(self):
        return [(k, self._child(k)) for k in self._members]

    def values(self):
        return [self._child(k) for k in self._members]

    def visititems(self, fn: Callable):
        """``fn(relative path, object)`` for every member below, names
        ascending and a group before its members; stops at the first
        call that returns something other than None, and returns it."""
        def walk(group, prefix):
            for k in group.keys():
                obj = group._child(k)
                got = fn(prefix + k, obj)
                if got is not None:
                    return got
                if isinstance(obj, Group):
                    got = walk(obj, prefix + k + "/")
                    if got is not None:
                        return got
            return None
        return walk(self, "")

    def visit(self, fn: Callable):
        return self.visititems(lambda name, _obj: fn(name))


class Dataset(_Object):
    """A dataset with compact or contiguous storage."""

    def __init__(self, f: File, addr: int, name: str, msgs):
        super().__init__(f, addr, name, msgs)
        by = {}
        for mtype, _flags, d in msgs:
            by.setdefault(mtype, d)
        if _FILTERS in by:
            _refuse(f"a filter pipeline (dataset {name!r})")
        self._type, _ = f._datatype(by[_DATATYPE])
        self.shape = f._dataspace(by[_DATASPACE])
        self._fill = self._fill_value(by)
        self._layout(by[_LAYOUT])

    def _fill_value(self, by) -> Optional[memoryview]:
        d = by.get(_FILL)
        if d is not None:
            if d[0] in (1, 2) and (d[0] == 1 or d[3]):
                n = int.from_bytes(d[4:8], "little")
                return d[8:8 + n] if n else None
            if d[0] == 3 and d[1] & 0x20:
                n = int.from_bytes(d[2:6], "little")
                return d[6:6 + n] if n else None
            return None
        d = by.get(_FILL_OLD)
        if d is not None:
            n = int.from_bytes(d[0:4], "little")
            return d[4:4 + n] if n else None
        return None

    def _layout(self, d: memoryview) -> None:
        version, f = d[0], self.file
        nbytes = self.size * self._type.size
        self._raw = self._address = None
        if version == 3:
            cls = d[1]
            if cls == 0:
                n = int.from_bytes(d[2:4], "little")
                self._raw = d[4:4 + n]
            elif cls == 1:
                self._address = f._addr_in(d, 2)
            elif cls == 2:
                _refuse(f"chunked layout (dataset {self.name!r})")
            else:
                _refuse(f"layout class {cls} (dataset {self.name!r})")
        elif version in (1, 2):
            ndims, cls = d[1], d[2]
            if cls == 0:
                p = 8 + 4 * ndims
                n = int.from_bytes(d[p:p + 4], "little")
                self._raw = d[p + 4:p + 4 + n]
            elif cls == 1:
                self._address = f._addr_in(d, 8)
            else:
                _refuse(f"chunked layout (dataset {self.name!r})")
        else:
            _refuse(f"layout message version {version} (dataset "
                    f"{self.name!r})")
        if self._raw is not None and len(self._raw) < nbytes:
            raise ValueError(f"HDF5: compact dataset {self.name!r} holds "
                             f"{len(self._raw)} of {nbytes} bytes")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> np.dtype:
        return self._type.numpy_dtype()

    @property
    def allocated(self) -> bool:
        """Whether the dataset's storage was ever written: an unallocated
        contiguous dataset (a weight-stripped skeleton's) reads as its
        fill value."""
        return self._raw is not None or self._address is not None

    def _bytes(self):
        n = self.size * self._type.size
        if self._raw is not None:
            return self._raw[:n]
        if self._address is not None:
            return self.file._buf[self._address:self._address + n]
        if self._fill is not None and len(self._fill) == self._type.size:
            return bytes(self._fill) * self.size
        return bytes(n)

    def __getitem__(self, key):
        v = self.file._values(self._type, self.shape, self._bytes())
        if key == () or key is Ellipsis:
            return v[()] if self.shape == () else v
        return v[key]

    def __array__(self, dtype=None, copy=None):
        v = self[()]
        v = np.asarray(v)
        return v if dtype is None else v.astype(dtype)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("a scalar dataset has no len()")
        return self.shape[0]
