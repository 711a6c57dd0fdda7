"""A TensorFlow ``GraphDef`` read from its protobuf wire bytes.

The counterpart of what the reference takes from the installed
tensorflow package (``tensorflow.core.framework.graph_pb2`` and
``tensor_util.MakeNdarray``, ``deeplearning4j_tpu/imports/tf_import.py``):
the port reads a frozen graph without tensorflow, so a card's machine that
has none imports it all the same.  The wire format and TensorFlow's field
numbers are public and stable (``graph.proto``, ``node_def.proto``,
``attr_value.proto``, ``tensor.proto``, ``tensor_shape.proto``,
``types.proto``).  The reader is the reference's ONNX wire reader
(``onnx_import.py``) in the port's own copy.

The classes answer the attribute names the importer reads from
tensorflow's protobuf classes (``node.attr[k].WhichOneof("value")``,
``tensor.tensor_content``, ``shape.dim[i].size``); fields it does not read
are skipped.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["GraphDef", "NodeDef", "AttrValue", "TensorProto",
           "TensorShapeProto", "decode_graphdef", "tensor_value",
           "dtype_name"]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:                      # varint
            val, i = _varint(buf, i)
        elif wt == 1:                    # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wt == 2:                    # length-delimited
            ln, i = _varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:                    # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"GraphDef: unsupported wire type {wt}")
        yield fnum, wt, val


def _collect(buf: bytes) -> Dict[int, List]:
    out: Dict[int, List] = {}
    for fnum, _wt, val in _fields(buf):
        out.setdefault(fnum, []).append(val)
    return out


def _signed64(v: int) -> int:
    """Two's complement: a negative int32 or int64 is a ten-byte varint
    of 2^64 + v on the wire."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _varints(vals) -> List[int]:
    """A repeated varint field, packed (one length-delimited blob, as
    proto3 writes it) or not (one varint each)."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            j = 0
            while j < len(v):
                x, j = _varint(v, j)
                out.append(x)
        else:
            out.append(v)
    return out


def _fixed(vals, fmt: str, size: int) -> List:
    """A repeated fixed-width field (float ``<f``, double ``<d``), packed
    or not: a packed blob holds several values, an unpacked one one."""
    out: List = []
    for v in vals:
        out.extend(struct.unpack(f"<{len(v) // size}{fmt}", v))
    return out


def _str(v: bytes) -> str:
    return v.decode("utf-8")


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------
class _Dim:
    __slots__ = ("size", "name")

    def __init__(self, buf: bytes):
        f = _collect(buf)
        self.size = _signed64(f.get(1, [0])[-1])
        self.name = _str(f.get(2, [b""])[-1])


class TensorShapeProto:
    """``dim`` (each with ``size``, -1 unknown) and ``unknown_rank``."""

    def __init__(self, buf: bytes = b""):
        f = _collect(buf)
        self.dim = [_Dim(v) for v in f.get(2, [])]
        self.unknown_rank = bool(f.get(3, [0])[-1])


class TensorProto:
    """``dtype``, ``tensor_shape``, ``tensor_content`` and the typed
    repeated fields ``float_val``, ``double_val``, ``int_val``,
    ``int64_val``, ``bool_val``, ``string_val``, ``half_val`` (float16 and
    bfloat16 as their 16 bits), ``uint32_val`` and ``uint64_val``.
    Signed ints come back with their sign (two's-complement varints)."""

    def __init__(self, buf: bytes = b""):
        f = _collect(buf)
        self.dtype = f.get(1, [0])[-1]
        self.tensor_shape = TensorShapeProto(f.get(2, [b""])[-1])
        self.tensor_content = bytes(f.get(4, [b""])[-1])
        self.float_val = _fixed(f.get(5, []), "f", 4)
        self.double_val = _fixed(f.get(6, []), "d", 8)
        self.int_val = [_signed64(v) for v in _varints(f.get(7, []))]
        self.string_val = [bytes(v) for v in f.get(8, [])]
        self.int64_val = [_signed64(v) for v in _varints(f.get(10, []))]
        self.bool_val = _varints(f.get(11, []))
        self.half_val = _varints(f.get(13, []))
        self.uint32_val = _varints(f.get(16, []))
        self.uint64_val = _varints(f.get(17, []))


class _ListValue:
    """``AttrValue.list``: ``s``, ``i``, ``f``, ``b``, ``type``, ``shape``
    and ``tensor``."""

    def __init__(self, buf: bytes = b""):
        f = _collect(buf)
        self.s = [bytes(v) for v in f.get(2, [])]
        self.i = [_signed64(v) for v in _varints(f.get(3, []))]
        self.f = _fixed(f.get(4, []), "f", 4)
        self.b = [bool(v) for v in _varints(f.get(5, []))]
        self.type = _varints(f.get(6, []))
        self.shape = [TensorShapeProto(v) for v in f.get(7, [])]
        self.tensor = [TensorProto(v) for v in f.get(8, [])]


# AttrValue's oneof "value": field number -> (arm name, reader)
_ATTR_ARMS = {1: ("list", _ListValue), 2: ("s", bytes),
              3: ("i", _signed64), 4: ("f", lambda v: struct.unpack(
                  "<f", v)[0]), 5: ("b", bool), 6: ("type", int),
              7: ("shape", TensorShapeProto), 8: ("tensor", TensorProto),
              9: ("placeholder", _str), 10: ("func", bytes)}


class AttrValue:
    """One arm of the oneof ``value`` is set: ``s`` (bytes), ``i``, ``f``,
    ``b``, ``type``, ``shape``, ``tensor``, ``list``, ``placeholder`` or
    ``func`` (its bytes); the others read as their defaults."""

    def __init__(self, buf: bytes = b""):
        self._arm: Optional[str] = None
        self.s, self.i, self.f, self.b, self.type = b"", 0, 0.0, False, 0
        self.shape, self.tensor = TensorShapeProto(), TensorProto()
        self.list, self.placeholder, self.func = _ListValue(), "", b""
        for fnum, _wt, val in _fields(buf):
            if fnum in _ATTR_ARMS:
                self._arm, read = _ATTR_ARMS[fnum]
                setattr(self, self._arm, read(val))

    def WhichOneof(self, group: str) -> Optional[str]:
        if group != "value":
            raise ValueError(f"AttrValue has no oneof {group!r}")
        return self._arm


class NodeDef:
    """``name``, ``op``, ``input`` (control inputs ``^x`` kept), ``device``
    and ``attr`` (a dict of ``AttrValue``)."""

    def __init__(self, buf: bytes = b""):
        f = _collect(buf)
        self.name = _str(f.get(1, [b""])[-1])
        self.op = _str(f.get(2, [b""])[-1])
        self.input = [_str(v) for v in f.get(3, [])]
        self.device = _str(f.get(4, [b""])[-1])
        self.attr: Dict[str, AttrValue] = {}
        for entry in f.get(5, []):              # map entry: key 1, value 2
            e = _collect(entry)
            self.attr[_str(e.get(1, [b""])[-1])] = AttrValue(
                e.get(2, [b""])[-1])


class GraphDef:
    """``node``, in the graph's order."""

    def __init__(self, buf: bytes = b""):
        self.node = [NodeDef(v) for v in _collect(buf).get(1, [])]


def decode_graphdef(graph) -> GraphDef:
    """A ``GraphDef`` from bytes, a path to a ``.pb``, the decoder's own
    ``GraphDef``, or any object with ``SerializeToString()`` (a
    tensorflow ``GraphDef``), which is decoded from its bytes."""
    if isinstance(graph, GraphDef):
        return graph
    if isinstance(graph, (bytes, bytearray, memoryview)):
        return GraphDef(bytes(graph))
    if isinstance(graph, str):
        with open(graph, "rb") as f:
            return GraphDef(f.read())
    if hasattr(graph, "SerializeToString"):
        return GraphDef(graph.SerializeToString())
    raise TypeError(f"Cannot import {type(graph)}")


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------
# DataType (types.proto) -> numpy dtype.  numpy has no bfloat16: a
# bfloat16 tensor's values come back as the float32 array that holds them
# exactly, and ``dtype_name`` still says "bfloat16".
_NUMPY = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
                5: np.int16, 6: np.int8, 7: np.object_, 8: np.complex64,
                9: np.int64, 10: np.bool_, 14: np.float32, 17: np.uint16,
                18: np.complex128, 19: np.float16, 22: np.uint32,
                23: np.uint64}
_NAMES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
          6: "int8", 7: "string", 8: "complex64", 9: "int64", 10: "bool",
          14: "bfloat16", 17: "uint16", 18: "complex128", 19: "float16",
          22: "uint32", 23: "uint64"}
_DT_BFLOAT16, _DT_HALF, _DT_STRING = 14, 19, 7
# where MakeNdarray reads each dtype's values when there is no content
_TYPED_FIELD = {1: "float_val", 2: "double_val", 3: "int_val",
                4: "int_val", 5: "int_val", 6: "int_val", 17: "int_val",
                9: "int64_val", 10: "bool_val", 22: "uint32_val",
                23: "uint64_val"}


def dtype_name(dt: int) -> str:
    """The numpy name of a ``DataType`` ("bfloat16" for 14)."""
    if dt not in _NAMES:
        raise TypeError(f"GraphDef: unsupported tensor dtype {dt}")
    return _NAMES[dt]


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def tensor_value(t: TensorProto) -> np.ndarray:
    """What ``tensor_util.MakeNdarray`` gives for ``t``: its
    ``tensor_content`` when set, else its typed field, where a field
    shorter than the shape is padded with its last value (a scalar
    ``Fill``-style Const) and an empty one gives zeros."""
    shape = [d.size for d in t.tensor_shape.dim]
    n = int(np.prod(shape, dtype=np.int64))
    dt = t.dtype
    dtype_name(dt)
    if dt in (8, 18):
        raise TypeError(f"GraphDef: complex tensors are not read "
                        f"(dtype {dt})")
    if t.tensor_content:
        if dt == _DT_BFLOAT16:
            bits = np.frombuffer(t.tensor_content, np.uint16)
            return _bf16_bits_to_f32(bits).reshape(shape)
        return np.frombuffer(t.tensor_content,
                             _NUMPY[dt]).copy().reshape(shape)
    if dt == _DT_STRING:
        vals = list(t.string_val)
        if n - len(vals) > 0:
            vals.extend([vals[-1] if vals else b""] * (n - len(vals)))
        return np.array(vals, dtype=object).reshape(shape)
    if dt in (_DT_HALF, _DT_BFLOAT16):
        bits = np.asarray(t.half_val, np.uint16)
        vals = bits.view(np.float16) if dt == _DT_HALF \
            else _bf16_bits_to_f32(bits)
    else:
        vals = np.asarray(getattr(t, _TYPED_FIELD[dt]),
                          _NUMPY[dt])
    if vals.size == 0:
        return np.zeros(shape, vals.dtype)
    if vals.size != n:
        vals = np.pad(vals, (0, n - vals.size), "edge")
    return vals.reshape(shape)
