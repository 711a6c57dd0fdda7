"""NDArray — ND4J's ``INDArray`` surface over a ``torch.Tensor``, the port of
``deeplearning4j_tpu/ops/ndarray.py``.

The reference simulates ND4J's aliasing views on immutable ``jax.Array``s:
a view records ``(parent, index)`` and a write through it rebuilds every
ancestor with ``value.at[index].set``.  Torch tensors are mutable and
basic indexing (integers, slices, ``None``) returns a real view, so those
views alias natively and a write lands in the parent's storage.  Advanced
indexing (an index array or a mask, ``NDArrayIndex.indices``) returns a
copy, so a view made that way keeps the reference's ``(parent, index)``
record, and every write through it is put back into its parent with
``index_put_``, up the chain (:meth:`NDArray._propagate`).

The other methods return independent arrays, as the reference's do: a
result that would share storage with its source (``reshape``,
``transpose``, ``permute``, ``dup``, ``castTo`` to the same type) is
copied.  In-place methods (``addi``, ``assign``, ``putScalar``) write
into the tensor, so a view of it sees the write.

``.torch`` is the port's twin of the reference's ``.jax``; ``.numpy()`` and
``__array__`` copy a CUDA array to the host once (a CPU array's numpy is a
read-only view, like the reference's ``np.asarray`` of a ``jax.Array``).
Wrapping never moves data: ``NDArray(t)`` keeps ``t``'s device, and a
numpy array or a list becomes a CPU tensor (copied, so an in-place
method never writes into the caller's numpy array).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.dtype import DataType, from_np, promote

__all__ = ["NDArray", "NDArrayIndex", "host_only_arrays",
           "set_host_only_arrays"]

# True inside an ETL producer-pool worker (``datavec.pipeline``): array
# creation there stays on the CPU and touches no CUDA state (the worker is
# a fork of a process whose CUDA context it must never use), and readers
# skip telemetry, which belongs to the parent.
_HOST_ONLY = False


def set_host_only_arrays(on: bool = True) -> None:
    global _HOST_ONLY
    _HOST_ONLY = bool(on)


def host_only_arrays() -> bool:
    """True inside an ETL producer-pool worker (CPU only, no parent
    telemetry)."""
    return _HOST_ONLY


class NDArrayIndex:
    """Index builders mirroring ``org.nd4j.linalg.indexing.NDArrayIndex``."""

    def __init__(self, raw):
        self.raw = raw

    @staticmethod
    def all():
        return NDArrayIndex(slice(None))

    @staticmethod
    def point(i: int):
        return NDArrayIndex(int(i))

    @staticmethod
    def interval(start: int, end: int, step: int = 1):
        return NDArrayIndex(slice(int(start), int(end), int(step)))

    @staticmethod
    def indices(*idx: int):
        return NDArrayIndex(np.asarray(idx, dtype=np.int64))

    @staticmethod
    def newAxis():
        return NDArrayIndex(None)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a`` (bfloat16 through its bits)."""
    a = np.array(a)
    if "bfloat16" in str(a.dtype):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
            return t.cpu().view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        except ImportError:        # numpy has no bfloat16 of its own
            return t.cpu().float().numpy()
    return t.cpu().numpy()


def _unwrap(x):
    return x._value if isinstance(x, NDArray) else x


def _tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (an NDArray's own tensor, a tensor as
    it is, anything else through numpy), cast to ``dtype`` when given."""
    x = _unwrap(x)
    if not isinstance(x, torch.Tensor):
        x = _from_numpy(np.asarray(x))
    if device is not None and x.device != torch.device(device):
        x = x.to(device)
    return x if dtype is None else x.to(dtype)


def _as_index(args, device) -> Tuple:
    out = []
    for a in args:
        if isinstance(a, NDArrayIndex):
            a = a.raw
        if isinstance(a, NDArray):
            a = a._value
        if isinstance(a, (np.integer,)):
            a = int(a)
        elif isinstance(a, (np.ndarray, list)):
            a = torch.as_tensor(np.asarray(a))
        if isinstance(a, torch.Tensor):
            a = a.to(device)
        out.append(a)
    return tuple(out)


def _is_basic(idx) -> bool:
    """True when indexing by ``idx`` returns a view (no index arrays)."""
    return all(i is None or i is Ellipsis or isinstance(i, (int, slice))
               for i in idx)


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _dims(dims) -> Optional[Tuple[int, ...]]:
    return tuple(int(d) for d in dims) if dims else None


def _floating(t: torch.Tensor) -> torch.Tensor:
    """Integer and boolean inputs of a mean/std/var in float64, as
    ``jnp.mean`` gives under x64."""
    return t if t.is_floating_point() else t.to(torch.float64)


class NDArray:
    """A dense n-d tensor with ND4J ``INDArray`` semantics over torch."""

    __slots__ = ("_value", "_parent", "_index")

    def __init__(self, value, parent: Optional["NDArray"] = None, index=None):
        if isinstance(value, NDArray):
            value = value._value
        if not isinstance(value, torch.Tensor):
            value = _from_numpy(np.asarray(value))
        self._value = value
        self._parent = parent
        self._index = index

    # -- core accessors -------------------------------------------------
    @property
    def torch(self) -> torch.Tensor:
        return self._value

    def numpy(self) -> np.ndarray:
        a = _to_numpy(self._value)
        if self._value.device.type == "cpu" and a.flags.writeable \
                and self._value.dtype != torch.bfloat16:
            a = a.view()
            a.flags.writeable = False
        return a

    def toDoubleMatrix(self):
        return self.numpy().astype(np.float64)

    def toFloatVector(self):
        return self.numpy().astype(np.float32).ravel()

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._value.shape)

    def shapeOf(self):
        return self.shape

    def rank(self) -> int:
        return self._value.dim()

    @property
    def ndim(self) -> int:
        return self._value.dim()

    def length(self) -> int:
        return int(self._value.numel()) if self._value.dim() else 1

    def size(self, dim: int) -> int:
        return int(self._value.shape[dim])

    def rows(self) -> int:
        return self.size(0)

    def columns(self) -> int:
        return self.size(1)

    def isEmpty(self) -> bool:
        return self.length() == 0

    def isScalar(self) -> bool:
        return self._value.dim() == 0 or self.length() == 1

    def isVector(self) -> bool:
        return self._value.dim() == 1 or (
            self._value.dim() == 2 and 1 in self.shape)

    def isMatrix(self) -> bool:
        return self._value.dim() == 2

    def isView(self) -> bool:
        return self._parent is not None

    def dataType(self) -> DataType:
        return from_np(self._value.dtype)

    @property
    def dtype(self) -> DataType:
        return self.dataType()

    def _fresh(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, copied when it shares this array's storage."""
        return t.clone() if _shares(t, self._value) else t

    # -- mutation core --------------------------------------------------
    def _propagate(self) -> "NDArray":
        """Carry this array's tensor into every ancestor that does not
        alias it: an advanced-index link is a copy, put back with
        ``index_put_``; a basic-index link is a view, already written."""
        node = self
        while node._parent is not None:
            p = node._parent
            if not _is_basic(node._index):
                p._value[node._index] = node._value.to(p._value.dtype)
            node = p
        return self

    def _write(self, new_value) -> "NDArray":
        """Overwrite this array in place (broadcasting ``new_value``) and
        carry the write up the view chain."""
        t = self._value
        new = _tensor(new_value, t.device)
        if _shares(new, t):
            new = new.clone()
        t.copy_(new)
        return self._propagate()

    def assign(self, other) -> "NDArray":
        """In-place overwrite (``INDArray.assign``)."""
        return self._write(other)

    def assignIf(self, other, cond) -> "NDArray":
        t = self._value
        mask = cond(t) if callable(cond) else _tensor(cond, t.device)
        return self._write(torch.where(
            mask.to(torch.bool), _tensor(other, t.device, t.dtype), t))

    def detach(self) -> "NDArray":
        return NDArray(self._value.detach().clone())

    def dup(self, order: str = "c") -> "NDArray":
        return NDArray(self._value.detach().clone())

    # -- casting --------------------------------------------------------
    def castTo(self, dt) -> "NDArray":
        dt = dt if isinstance(dt, DataType) else from_np(dt)
        return NDArray(self._value.to(dt.torch, copy=True))

    def asDataType(self, dt) -> "NDArray":
        return self.castTo(dt)

    # -- indexing / views ----------------------------------------------
    def _view(self, idx) -> "NDArray":
        return NDArray(self._value[idx], parent=self, index=idx)

    def get(self, *indices) -> "NDArray":
        """A view (writes reach the parent), like ``INDArray.get``."""
        return self._view(_as_index(indices, self._value.device))

    def put(self, indices, value) -> "NDArray":
        if not isinstance(indices, (list, tuple)):
            indices = (indices,)
        idx = _as_index(tuple(indices), self._value.device)
        self._value[idx] = _tensor(value, self._value.device,
                                   self._value.dtype)
        return self._propagate()

    def putScalar(self, *args) -> "NDArray":
        *idx, v = args
        if len(idx) == 1 and isinstance(idx[0], (list, tuple, np.ndarray)):
            idx = list(idx[0])
        idx = tuple(int(i) for i in idx)
        if self._value.dim() > len(idx) and len(idx) == 1:
            # a linear index into the flattened array
            idx = tuple(int(i) for i in np.unravel_index(idx[0], self.shape))
        self._value[idx] = v
        return self._propagate()

    def getScalar(self, *idx) -> "NDArray":
        return NDArray(self._value[tuple(int(i) for i in idx)].clone())

    def getDouble(self, *idx) -> float:
        return float(self._pick(idx))

    def getFloat(self, *idx) -> float:
        return float(self._pick(idx))

    def getInt(self, *idx) -> int:
        return int(self._pick(idx))

    def _pick(self, idx):
        t = self._value
        if not idx:
            return t.reshape(-1)[0].item()
        if len(idx) == 1 and t.dim() != 1:
            return t.reshape(-1)[int(idx[0])].item()
        return t[tuple(int(i) for i in idx)].item()

    def getRow(self, i: int) -> "NDArray":
        return self.get(NDArrayIndex.point(i))

    def getColumn(self, i: int) -> "NDArray":
        return self._view((slice(None), int(i)))

    def getRows(self, *rows) -> "NDArray":
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                              device=self._value.device)
        return NDArray(self._value[idx])

    def getColumns(self, *cols) -> "NDArray":
        idx = torch.as_tensor(np.asarray(cols, dtype=np.int64),
                              device=self._value.device)
        return NDArray(self._value[:, idx])

    def putRow(self, i: int, row) -> "NDArray":
        return self.put((NDArrayIndex.point(i),), row)

    def putColumn(self, i: int, col) -> "NDArray":
        t = self._value
        t[:, int(i)] = _tensor(col, t.device, t.dtype).reshape(-1)
        return self._propagate()

    def slice_(self, i: int, dim: int = 0) -> "NDArray":
        return self._view(tuple([slice(None)] * dim + [int(i)]))

    # DL4J's name for it
    slice = slice_

    def tensorAlongDimension(self, index: int, *dims) -> "NDArray":
        """The ``index``-th sub-tensor spanning ``dims`` (TAD semantics)."""
        dims = tuple(sorted(d % self.ndim for d in dims))
        other = [d for d in range(self.ndim) if d not in dims]
        counts = [self.shape[d] for d in other]
        sub = np.unravel_index(index, counts) if counts else ()
        idx: list = [slice(None)] * self.ndim
        for d, i in zip(other, sub):
            idx[d] = int(i)
        return self._view(tuple(idx))

    def tensorsAlongDimension(self, *dims) -> int:
        dims_n = {d % self.ndim for d in dims}
        other = [self.shape[d] for d in range(self.ndim) if d not in dims_n]
        return int(np.prod(other)) if other else 1

    def __getitem__(self, idx) -> "NDArray":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self._view(_as_index(idx, self._value.device))

    def __setitem__(self, idx, value) -> None:
        if not isinstance(idx, tuple):
            idx = (idx,)
        idx = _as_index(idx, self._value.device)
        self._value[idx] = _tensor(value, self._value.device,
                                   self._value.dtype)
        self._propagate()

    # -- shape manipulation --------------------------------------------
    def reshape(self, *shape) -> "NDArray":
        if shape and isinstance(shape[0], str):  # ND4J order char ('c')
            shape = shape[1:]
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return NDArray(self._fresh(
            self._value.reshape(tuple(int(s) for s in shape))))

    def ravel(self) -> "NDArray":
        return NDArray(self._fresh(self._value.reshape(-1)))

    def flatten(self) -> "NDArray":
        return self.ravel()

    def _t(self) -> torch.Tensor:
        return self._value.permute(*reversed(range(self._value.dim())))

    def transpose(self) -> "NDArray":
        return NDArray(self._t().clone())

    def transposei(self) -> "NDArray":
        return self._write_reshaped(self._t().contiguous())

    def permute(self, *dims) -> "NDArray":
        return NDArray(self._value.permute(
            *(int(d) for d in dims)).clone())

    def swapAxes(self, a: int, b: int) -> "NDArray":
        return NDArray(self._value.transpose(int(a), int(b)).clone())

    def broadcast(self, *shape) -> "NDArray":
        return NDArray(self._fresh(torch.broadcast_to(
            self._value, tuple(int(s) for s in shape)).contiguous()))

    def repeat(self, dim: int, n: int) -> "NDArray":
        return NDArray(torch.repeat_interleave(self._value, int(n),
                                               dim=int(dim)))

    def _write_reshaped(self, v) -> "NDArray":
        # a shape-changing in-place op: only legal on arrays that are not
        # views (the reference's rule); rebinds the tensor
        self._value = v
        return self

    # -- arithmetic helpers --------------------------------------------
    def _coerce(self, other):
        o = _tensor(other, self._value.device)
        out_dt = promote(self.dataType(), from_np(o.dtype)) \
            if isinstance(other, NDArray) else self.dataType()
        return o, out_dt

    def _binary(self, other, fn) -> "NDArray":
        o, out_dt = self._coerce(other)
        return NDArray(self._fresh(fn(self._value.to(out_dt.torch),
                                      o.to(out_dt.torch))))

    def _binary_i(self, other, fn) -> "NDArray":
        o = _tensor(other, self._value.device, self._value.dtype)
        return self._write(fn(self._value, o))

    # copies
    def add(self, o):  return self._binary(o, torch.add)
    def sub(self, o):  return self._binary(o, torch.sub)
    def mul(self, o):  return self._binary(o, torch.mul)
    def div(self, o):  return self._binary(o, torch.true_divide)
    def rsub(self, o): return self._binary(o, lambda a, b: b - a)
    def rdiv(self, o): return self._binary(o, lambda a, b: b / a)
    def fmod(self, o): return self._binary(o, torch.fmod)

    # in-place
    def addi(self, o):  return self._binary_i(o, torch.add)
    def subi(self, o):  return self._binary_i(o, torch.sub)
    def muli(self, o):  return self._binary_i(o, torch.mul)
    def divi(self, o):  return self._binary_i(o, torch.true_divide)
    def rsubi(self, o): return self._binary_i(o, lambda a, b: b - a)
    def rdivi(self, o): return self._binary_i(o, lambda a, b: b / a)

    # broadcast-along-dimension ops (ND4J addRowVector etc.)
    def addRowVector(self, v):  return self._binary(v, lambda a, b: a + b.reshape(1, -1))
    def addColumnVector(self, v): return self._binary(v, lambda a, b: a + b.reshape(-1, 1))
    def subRowVector(self, v):  return self._binary(v, lambda a, b: a - b.reshape(1, -1))
    def subColumnVector(self, v): return self._binary(v, lambda a, b: a - b.reshape(-1, 1))
    def mulRowVector(self, v):  return self._binary(v, lambda a, b: a * b.reshape(1, -1))
    def mulColumnVector(self, v): return self._binary(v, lambda a, b: a * b.reshape(-1, 1))
    def divRowVector(self, v):  return self._binary(v, lambda a, b: a / b.reshape(1, -1))
    def divColumnVector(self, v): return self._binary(v, lambda a, b: a / b.reshape(-1, 1))
    def addiRowVector(self, v):  return self._binary_i(v, lambda a, b: a + b.reshape(1, -1))
    def addiColumnVector(self, v): return self._binary_i(v, lambda a, b: a + b.reshape(-1, 1))
    def muliRowVector(self, v):  return self._binary_i(v, lambda a, b: a * b.reshape(1, -1))
    def muliColumnVector(self, v): return self._binary_i(v, lambda a, b: a * b.reshape(-1, 1))

    def neg(self):  return NDArray(-self._value)

    def negi(self):
        return self._write(-self._value)

    # -- linear algebra -------------------------------------------------
    def _matmul_operands(self, other):
        o = _tensor(other, self._value.device)
        dt = promote(self.dataType(), from_np(o.dtype)).torch
        return self._value.to(dt), o.to(dt)

    def mmul(self, other, out: Optional["NDArray"] = None) -> "NDArray":
        r = NDArray(torch.matmul(*self._matmul_operands(other)))
        if out is not None:
            out.assign(r)
            return out
        return r

    matmul = mmul

    def mmuli(self, other) -> "NDArray":
        return self._write_reshaped(
            torch.matmul(*self._matmul_operands(other)))

    def dot(self, other) -> float:
        a, b = self._matmul_operands(other)
        return float(torch.dot(a.reshape(-1), b.reshape(-1)))

    # -- reductions -----------------------------------------------------
    def _reduce(self, fn, dims, keep=False) -> "NDArray":
        axis = _dims(dims)
        t = self._value
        return NDArray(fn(t, dim=axis, keepdim=keep) if axis is not None
                       else fn(t))

    def sum(self, *dims, keepDims: bool = False):
        return self._reduce(torch.sum, dims, keepDims)

    def mean(self, *dims, keepDims: bool = False):
        return self._reduce(lambda t, **kw: torch.mean(_floating(t), **kw),
                            dims, keepDims)

    def max(self, *dims, keepDims: bool = False):
        return self._reduce(torch.amax, dims, keepDims)

    def min(self, *dims, keepDims: bool = False):
        return self._reduce(torch.amin, dims, keepDims)

    def prod(self, *dims, keepDims: bool = False):
        axis = _dims(dims)
        t = self._value
        if axis is None:
            return NDArray(torch.prod(t))
        for d in sorted((d % t.dim() for d in axis), reverse=True):
            t = torch.prod(t, dim=d, keepdim=keepDims)
        return NDArray(t)

    def std(self, *dims, biasCorrected: bool = True):
        return NDArray(torch.std(_floating(self._value), dim=_dims(dims),
                                 correction=1 if biasCorrected else 0))

    def var(self, *dims, biasCorrected: bool = True):
        return NDArray(torch.var(_floating(self._value), dim=_dims(dims),
                                 correction=1 if biasCorrected else 0))

    def norm1(self, *dims):
        return self._reduce(lambda v, **kw: torch.sum(torch.abs(v), **kw),
                            dims)

    def norm2(self, *dims):
        return self._reduce(
            lambda v, **kw: torch.sqrt(torch.sum(v * v, **kw)), dims)

    def normmax(self, *dims):
        return self._reduce(
            lambda v, **kw: torch.amax(torch.abs(v), **kw)
            if kw else torch.max(torch.abs(v)), dims)

    def argMax(self, *dims):
        return NDArray(torch.argmax(self._value, dim=int(dims[0]))
                       if dims else torch.argmax(self._value))

    def argMin(self, *dims):
        return NDArray(torch.argmin(self._value, dim=int(dims[0]))
                       if dims else torch.argmin(self._value))

    def cumsum(self, dim: int = 0):
        return NDArray(torch.cumsum(self._value, dim=int(dim)))

    def cumprod(self, dim: int = 0):
        return NDArray(torch.cumprod(self._value, dim=int(dim)))

    def sumNumber(self) -> float:
        return float(torch.sum(self._value))

    def meanNumber(self) -> float:
        return float(torch.mean(_floating(self._value)))

    def maxNumber(self) -> float:
        return float(torch.max(self._value))

    def minNumber(self) -> float:
        return float(torch.min(self._value))

    def norm1Number(self) -> float:
        return float(torch.sum(torch.abs(self._value)))

    def norm2Number(self) -> float:
        return float(torch.sqrt(torch.sum(self._value * self._value)))

    def scan(self, cond) -> int:
        return int(torch.sum(cond(self._value)))

    # -- comparison -----------------------------------------------------
    def gt(self, o):  return self._binary(o, torch.gt)
    def gte(self, o): return self._binary(o, torch.ge)
    def lt(self, o):  return self._binary(o, torch.lt)
    def lte(self, o): return self._binary(o, torch.le)
    def eq(self, o):  return self._binary(o, torch.eq)
    def neq(self, o): return self._binary(o, torch.ne)

    def equalsWithEps(self, other, eps: float = 1e-5) -> bool:
        o = np.asarray(other)
        mine = self.numpy()
        if mine.shape != o.shape:
            return False
        return bool(np.allclose(mine.astype(np.float64), o.astype(np.float64),
                                atol=eps, rtol=0))

    def equalShapes(self, other) -> bool:
        o = _unwrap(other)
        return self.shape == tuple(o.shape if isinstance(o, torch.Tensor)
                                   else np.asarray(o).shape)

    # -- python protocol -------------------------------------------------
    def __add__(self, o):  return self.add(o)
    def __radd__(self, o): return self.add(o)
    def __sub__(self, o):  return self.sub(o)
    def __rsub__(self, o): return self.rsub(o)
    def __mul__(self, o):  return self.mul(o)
    def __rmul__(self, o): return self.mul(o)
    def __truediv__(self, o):  return self.div(o)
    def __rtruediv__(self, o): return self.rdiv(o)
    def __matmul__(self, o):   return self.mmul(o)
    def __neg__(self):     return self.neg()
    def __pow__(self, o):  return self._binary(o, torch.pow)
    def __abs__(self):     return NDArray(torch.abs(self._value))
    def __len__(self):     return self.shape[0] if self.ndim else 0
    def __float__(self):   return float(self._value)
    def __int__(self):     return int(self._value)

    def __bool__(self):
        if self.length() != 1:
            raise ValueError("Truth value of non-scalar NDArray is ambiguous")
        return bool(self._value.reshape(-1)[0].item())

    def __eq__(self, other):  # ND4J: elementwise via .eq; equality here
        if isinstance(other, NDArray):
            return self.equalsWithEps(other, 1e-5)
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __array__(self, dtype=None, copy=None):
        a = _to_numpy(self._value)
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"NDArray(dtype={self.dataType().name}, shape={self.shape})"
                f"\n{_to_numpy(self._value)}")

    def toString(self):
        return repr(self)

    def toStringFull(self):
        return repr(self)
