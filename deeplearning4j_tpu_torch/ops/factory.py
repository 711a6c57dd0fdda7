"""``Nd4j`` — the static factory and op facade, the port of
``deeplearning4j_tpu/ops/factory.py`` (the reference's ``Nd4j.java``:
creation, gemm, exec, rng and serde entry points, and the transform ops).

Creation (``create``, ``zeros``, ``ones``, ``valueArrayOf``, ``scalar``,
``arange``, ``linspace``, ``eye``, ``empty``, ``rand``, ``randn``,
``randomBernoulli``) is an entry point: it places the new array on
``cuda`` unless the caller passes ``device=`` (``"cpu"`` on the CPU) or
the process is in host-only mode (an ETL producer worker), and raises
when no card is present.  Every other method computes on its inputs'
device: an ``NDArray`` or tensor stays where it is, and a numpy array or
list is taken as a CPU array, as ``NDArray(x)`` takes it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.dtype import (DataType, default_float,
                                                from_np, set_default_float)
from deeplearning4j_tpu_torch.ops.ndarray import (NDArray, NDArrayIndex,
                                                  _tensor, host_only_arrays)
from deeplearning4j_tpu_torch.ops.random import RandomGenerator, get_random
from deeplearning4j_tpu_torch.ops import serde as _serde

__all__ = ["Nd4j", "NDArrayIndex"]


def _v(x) -> torch.Tensor:
    return _tensor(x)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``ref``'s device."""
    return _tensor(x, ref.device)


def _dt(dtype) -> DataType:
    if dtype is None:
        return default_float()
    return dtype if isinstance(dtype, DataType) else from_np(dtype)


def _place(device) -> torch.device:
    """Where a new array goes: ``device`` when given, the CPU in host-only
    mode, else ``cuda`` (raising without a card)."""
    from deeplearning4j_tpu_torch import resolve_device
    if device is None and host_only_arrays():
        return torch.device("cpu")
    return resolve_device(device)


def _shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
        shape = tuple(shape[0])
    return tuple(int(s) for s in shape)


class Nd4j:
    """Static tensor factory and op facade (``org.nd4j.linalg.factory.Nd4j``)."""

    @staticmethod
    def getEnvironment():
        """Runtime flag mirror (reference: Nd4j.getEnvironment())."""
        from deeplearning4j_tpu_torch.config import Environment
        return Environment.getInstance()

    # ---------------- creation ----------------
    @staticmethod
    def create(data=None, shape=None, dtype=None, device=None) -> NDArray:
        dev = _place(device)
        if data is None and shape is not None:
            return Nd4j.zeros(*shape, dtype=dtype, device=dev)
        if isinstance(data, NDArray):
            data = data.numpy()
        elif isinstance(data, torch.Tensor):
            data = NDArray(data).numpy()
        a = np.asarray(data)
        if shape is not None and not np.isscalar(data):
            a = a.reshape(tuple(shape))
            return NDArray(_tensor(a, dev, _dt(dtype or a.dtype).torch))
        if dtype is None and a.dtype == np.float64:
            dtype = default_float()  # ND4J creates float unless configured
        return NDArray(_tensor(a, dev, _dt(dtype or a.dtype).torch))

    @staticmethod
    def zeros(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(torch.zeros(_shape(shape), dtype=_dt(dtype).torch,
                                   device=_place(device)))

    @staticmethod
    def ones(*shape, dtype=None, device=None) -> NDArray:
        return NDArray(torch.ones(_shape(shape), dtype=_dt(dtype).torch,
                                  device=_place(device)))

    @staticmethod
    def zerosLike(a) -> NDArray:
        return NDArray(torch.zeros_like(_v(a)))

    @staticmethod
    def onesLike(a) -> NDArray:
        return NDArray(torch.ones_like(_v(a)))

    @staticmethod
    def valueArrayOf(shape, value, dtype=None, device=None) -> NDArray:
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(torch.full(tuple(shape), value,
                                  dtype=_dt(dtype).torch,
                                  device=_place(device)))

    full = valueArrayOf

    @staticmethod
    def scalar(value, dtype=None, device=None) -> NDArray:
        if dtype is None:
            if isinstance(value, bool):
                dtype = DataType.BOOL
            elif isinstance(value, int):
                dtype = DataType.INT64
            else:
                dtype = default_float()
        return NDArray(torch.tensor(value, dtype=_dt(dtype).torch,
                                    device=_place(device)))

    @staticmethod
    def arange(*args, dtype=None, device=None) -> NDArray:
        return NDArray(torch.arange(*args,
                                    dtype=_dt(dtype or DataType.FLOAT).torch,
                                    device=_place(device)))

    @staticmethod
    def linspace(start, stop, num, dtype=None, device=None) -> NDArray:
        dt = _dt(dtype).torch
        # computed in float64 and cast, as jnp.linspace rounds once
        return NDArray(torch.linspace(start, stop, int(num),
                                      dtype=torch.float64,
                                      device=_place(device)).to(dt))

    @staticmethod
    def eye(n, dtype=None, device=None) -> NDArray:
        return NDArray(torch.eye(int(n), dtype=_dt(dtype).torch,
                                 device=_place(device)))

    @staticmethod
    def diag(a) -> NDArray:
        return NDArray(torch.diag(_v(a)))

    @staticmethod
    def empty(dtype=None, device=None) -> NDArray:
        return NDArray(torch.zeros((0,), dtype=_dt(dtype).torch,
                                   device=_place(device)))

    # ---------------- random ----------------
    @staticmethod
    def getRandom() -> RandomGenerator:
        return get_random()

    @staticmethod
    def rand(*shape, seed: Optional[int] = None, dtype=None,
             device=None) -> NDArray:
        rng = RandomGenerator(seed) if seed is not None else get_random()
        return NDArray(rng.uniform(_shape(shape), dtype=_dt(dtype),
                                   device=_place(device)))

    @staticmethod
    def randn(*shape, seed: Optional[int] = None, dtype=None,
              device=None) -> NDArray:
        rng = RandomGenerator(seed) if seed is not None else get_random()
        return NDArray(rng.normal(_shape(shape), dtype=_dt(dtype),
                                  device=_place(device)))

    @staticmethod
    def randomBernoulli(p, *shape, device=None) -> NDArray:
        return NDArray(get_random().bernoulli(
            _shape(shape), p, device=_place(device)).to(
                default_float().torch))

    # ---------------- dtype config ----------------
    @staticmethod
    def setDefaultDataTypes(dtype, *_):
        set_default_float(_dt(dtype))

    @staticmethod
    def defaultFloatingPointType() -> DataType:
        return default_float()

    # ---------------- linalg ----------------
    @staticmethod
    def gemm(a, b, transposeA: bool = False, transposeB: bool = False,
             alpha: float = 1.0, beta: float = 0.0, c=None) -> NDArray:
        av = _v(a)
        bv = _like(b, av)
        if transposeA:
            av = av.T
        if transposeB:
            bv = bv.T
        r = alpha * torch.matmul(av, bv)
        if c is not None and beta != 0.0:
            r = r + beta * _like(c, av)
        out = NDArray(r)
        if c is not None and isinstance(c, NDArray):
            c.assign(out)
            return c
        return out

    @staticmethod
    def matmul(a, b) -> NDArray:
        av = _v(a)
        return NDArray(torch.matmul(av, _like(b, av)))

    @staticmethod
    def tensorMmul(a, b, axes) -> NDArray:
        av = _v(a)
        return NDArray(torch.tensordot(av, _like(b, av), dims=axes))

    @staticmethod
    def dot(a, b) -> NDArray:
        av = _v(a)
        return NDArray(torch.dot(av.reshape(-1), _like(b, av).reshape(-1)))

    # ---------------- shape ops ----------------
    @staticmethod
    def _all(arrs):
        first = _v(arrs[0])
        return [first] + [_like(a, first) for a in arrs[1:]]

    @staticmethod
    def concat(dim: int, *arrs) -> NDArray:
        return NDArray(torch.cat(Nd4j._all(arrs), dim=int(dim)))

    @staticmethod
    def hstack(*arrs) -> NDArray:
        return NDArray(torch.hstack(Nd4j._all(arrs)))

    @staticmethod
    def vstack(*arrs) -> NDArray:
        return NDArray(torch.vstack(Nd4j._all(arrs)))

    @staticmethod
    def stack(dim: int, *arrs) -> NDArray:
        return NDArray(torch.stack(Nd4j._all(arrs), dim=int(dim)))

    @staticmethod
    def split(a, n: int, dim: int = 0):
        v = _v(a)
        if v.shape[int(dim)] % int(n):
            raise ValueError("array split does not result in an equal "
                             "division")
        return [NDArray(x.clone())
                for x in torch.tensor_split(v, int(n), dim=int(dim))]

    @staticmethod
    def tile(a, *reps) -> NDArray:
        return NDArray(torch.tile(_v(a), tuple(int(r) for r in reps)))

    @staticmethod
    def repeat(a, n: int, dim: int = 0) -> NDArray:
        return NDArray(torch.repeat_interleave(_v(a), int(n), dim=int(dim)))

    @staticmethod
    def pad(a, pad_width, mode: str = "constant", value=0) -> NDArray:
        v = _v(a)
        pw = np.broadcast_to(np.asarray(pad_width, dtype=np.int64),
                             (v.dim(), 2))
        flat = [int(x) for pair in pw[::-1] for x in pair]
        if mode == "constant":
            return NDArray(F.pad(v, flat, value=value))
        torch_mode = {"edge": "replicate", "wrap": "circular"}.get(mode, mode)
        return NDArray(F.pad(v[None, None], flat, mode=torch_mode)[0, 0])

    @staticmethod
    def expandDims(a, dim: int) -> NDArray:
        return NDArray(torch.unsqueeze(_v(a), int(dim)).clone())

    @staticmethod
    def squeeze(a, dim: Optional[int] = None) -> NDArray:
        v = _v(a)
        return NDArray((torch.squeeze(v) if dim is None
                        else torch.squeeze(v, int(dim))).clone())

    @staticmethod
    def flip(a, *dims) -> NDArray:
        v = _v(a)
        return NDArray(torch.flip(v, tuple(int(d) for d in dims)
                                  or tuple(range(v.dim()))))

    @staticmethod
    def roll(a, shift: int, dim: Optional[int] = None) -> NDArray:
        return NDArray(torch.roll(_v(a), shift, dims=dim))

    @staticmethod
    def reverse(a) -> NDArray:
        v = _v(a)
        return NDArray(torch.flip(v, tuple(range(v.dim()))))

    @staticmethod
    def where(cond, x=None, y=None):
        c = _v(cond)
        if x is None:
            return [NDArray(i) for i in torch.where(c)]
        return NDArray(torch.where(c.to(torch.bool), _like(x, c),
                                   _like(y, c)))

    @staticmethod
    def gather(a, indices, dim: int = 0) -> NDArray:
        v = _v(a)
        return NDArray(torch.index_select(
            v, int(dim), _like(indices, v).to(torch.int64)))

    @staticmethod
    def scatterUpdate(a, indices, updates, dim: int = 0) -> NDArray:
        av = _v(a)
        idx = _like(indices, av).to(torch.int64)
        upd = _like(updates, av).to(av.dtype)
        dim = int(dim)
        # scatter on a copy with the scatter axis moved to the front
        avm = torch.movedim(av, dim, 0).clone()
        if upd.dim() == av.dim():
            upd = torch.movedim(upd, dim, 0)
        avm[idx] = upd
        return NDArray(torch.movedim(avm, 0, dim).contiguous())

    @staticmethod
    def oneHot(indices, depth: int, dtype=None) -> NDArray:
        return NDArray(F.one_hot(_v(indices).to(torch.int64),
                                 int(depth)).to(_dt(dtype).torch))

    @staticmethod
    def sort(a, dim: int = -1, ascending: bool = True) -> NDArray:
        s = torch.sort(_v(a), dim=int(dim), stable=True).values
        return NDArray(s if ascending else s.flip(int(dim)))

    @staticmethod
    def argsort(a, dim: int = -1, ascending: bool = True) -> NDArray:
        s = torch.argsort(_v(a), dim=int(dim), stable=True)
        return NDArray(s if ascending else s.flip(int(dim)))

    @staticmethod
    def topK(a, k: int):
        vals, idx = torch.topk(_v(a), int(k), sorted=True)
        return NDArray(vals), NDArray(idx)

    @staticmethod
    def unique(a):
        return NDArray(torch.unique(_v(a), sorted=True))

    # ---------------- elementwise math ----------------
    # (reference: libnd4j legacy transform ops, include/loops/legacy_ops.h)
    @staticmethod
    def exp(a):      return NDArray(torch.exp(_v(a)))
    @staticmethod
    def log(a):      return NDArray(torch.log(_v(a)))
    @staticmethod
    def log1p(a):    return NDArray(torch.log1p(_v(a)))
    @staticmethod
    def sqrt(a):     return NDArray(torch.sqrt(_v(a)))
    @staticmethod
    def square(a):   return NDArray(torch.square(_v(a)))
    @staticmethod
    def abs(a):      return NDArray(torch.abs(_v(a)))
    @staticmethod
    def sign(a):     return NDArray(torch.sign(_v(a)))
    @staticmethod
    def floor(a):    return NDArray(torch.floor(_v(a)))
    @staticmethod
    def ceil(a):     return NDArray(torch.ceil(_v(a)))
    @staticmethod
    def round(a):    return NDArray(torch.round(_v(a)))
    @staticmethod
    def sin(a):      return NDArray(torch.sin(_v(a)))
    @staticmethod
    def cos(a):      return NDArray(torch.cos(_v(a)))
    @staticmethod
    def tan(a):      return NDArray(torch.tan(_v(a)))
    @staticmethod
    def asin(a):     return NDArray(torch.asin(_v(a)))
    @staticmethod
    def acos(a):     return NDArray(torch.acos(_v(a)))
    @staticmethod
    def atan(a):     return NDArray(torch.atan(_v(a)))
    @staticmethod
    def sinh(a):     return NDArray(torch.sinh(_v(a)))
    @staticmethod
    def cosh(a):     return NDArray(torch.cosh(_v(a)))
    @staticmethod
    def tanh(a):     return NDArray(torch.tanh(_v(a)))
    @staticmethod
    def erf(a):      return NDArray(torch.erf(_v(a)))
    @staticmethod
    def sigmoid(a):  return NDArray(torch.sigmoid(_v(a)))
    @staticmethod
    def softplus(a):
        # log1p(exp(x)) as jax.nn.softplus computes it (no linear cut-off)
        return NDArray(torch.logaddexp(_v(a), torch.zeros_like(_v(a))))
    @staticmethod
    def softsign(a): return NDArray(F.softsign(_v(a)))
    @staticmethod
    def relu(a):     return NDArray(torch.relu(_v(a)))
    @staticmethod
    def relu6(a):    return NDArray(F.relu6(_v(a)))
    @staticmethod
    def leakyRelu(a, alpha=0.01):
        return NDArray(F.leaky_relu(_v(a), alpha))
    @staticmethod
    def elu(a, alpha=1.0):
        return NDArray(F.elu(_v(a), alpha))
    @staticmethod
    def gelu(a):
        # jax.nn.gelu's default is the tanh approximation
        return NDArray(F.gelu(_v(a), approximate="tanh"))
    @staticmethod
    def swish(a):    return NDArray(F.silu(_v(a)))
    @staticmethod
    def mish(a):
        v = _v(a)
        return NDArray(v * torch.tanh(torch.logaddexp(v, torch.zeros_like(v))))
    @staticmethod
    def hardSigmoid(a):
        return NDArray(torch.clamp(0.2 * _v(a) + 0.5, 0.0, 1.0))
    @staticmethod
    def hardTanh(a):
        return NDArray(torch.clamp(_v(a), -1.0, 1.0))
    @staticmethod
    def softmax(a, dim: int = -1):
        return NDArray(torch.softmax(_v(a), dim=int(dim)))
    @staticmethod
    def logSoftmax(a, dim: int = -1):
        return NDArray(torch.log_softmax(_v(a), dim=int(dim)))
    @staticmethod
    def pow(a, p):
        v = _v(a)
        return NDArray(torch.pow(v, p if isinstance(p, (int, float))
                                 else _like(p, v)))
    @staticmethod
    def clip(a, lo, hi):
        return NDArray(torch.clamp(_v(a), lo, hi))
    @staticmethod
    def reciprocal(a):
        return NDArray(1.0 / _v(a))
    @staticmethod
    def rsqrt(a):
        return NDArray(torch.rsqrt(_v(a)))
    @staticmethod
    def maximum(a, b):
        v = _v(a)
        return NDArray(torch.maximum(v, _like(b, v)))
    @staticmethod
    def minimum(a, b):
        v = _v(a)
        return NDArray(torch.minimum(v, _like(b, v)))
    @staticmethod
    def isNaN(a):    return NDArray(torch.isnan(_v(a)))
    @staticmethod
    def isInf(a):    return NDArray(torch.isinf(_v(a)))
    @staticmethod
    def replaceNaN(a, value):
        v = _v(a)
        return NDArray(torch.where(torch.isnan(v),
                                   torch.as_tensor(value, dtype=v.dtype,
                                                   device=v.device), v))

    # ---------------- reductions (facade) ----------------
    @staticmethod
    def sum(a, *dims):  return NDArray(a).sum(*dims)
    @staticmethod
    def mean(a, *dims): return NDArray(a).mean(*dims)
    @staticmethod
    def max(a, *dims):  return NDArray(a).max(*dims)
    @staticmethod
    def min(a, *dims):  return NDArray(a).min(*dims)
    @staticmethod
    def argMax(a, *dims): return a.argMax(*dims)
    @staticmethod
    def norm2(a, *dims):  return a.norm2(*dims)

    @staticmethod
    def cosineSim(a, b) -> float:
        av = _v(a).reshape(-1)
        bv = _like(b, av).reshape(-1)
        return float(torch.dot(av, bv) /
                     (torch.linalg.norm(av) * torch.linalg.norm(bv) + 1e-12))

    @staticmethod
    def euclideanDistance(a, b) -> float:
        av = _v(a).reshape(-1)
        return float(torch.linalg.norm(av - _like(b, av).reshape(-1)))

    @staticmethod
    def manhattanDistance(a, b) -> float:
        av = _v(a).reshape(-1)
        return float(torch.sum(torch.abs(av - _like(b, av).reshape(-1))))

    # ---------------- im2col / conv helpers ----------------
    @staticmethod
    def im2col(img, kh: int, kw: int, sy: int, sx: int, ph: int, pw: int,
               dh: int = 1, dw: int = 1) -> NDArray:
        """Reference: libnd4j ``im2col`` (NCHW in, (n, c, kh, kw, oh, ow)
        out), here ``torch.nn.functional.unfold``."""
        v = _v(img)
        n, c, h, w = v.shape
        cols = F.unfold(v, (kh, kw), dilation=(dh, dw), padding=(ph, pw),
                        stride=(sy, sx))
        oh = (h + 2 * ph - dh * (kh - 1) - 1) // sy + 1
        ow = (w + 2 * pw - dw * (kw - 1) - 1) // sx + 1
        return NDArray(cols.reshape(n, c, kh, kw, oh, ow))

    # ---------------- serde ----------------
    writeAsNumpy = staticmethod(_serde.write_as_numpy)
    createFromNpyFile = staticmethod(_serde.from_npy_file)
    toNpyByteArray = staticmethod(_serde.to_npy_bytes)
    createNpyFromByteArray = staticmethod(_serde.from_npy_bytes)

    # ---------------- environment ----------------
    @staticmethod
    def getBackend() -> str:
        return "cuda" if torch.cuda.is_available() else "cpu"

    @staticmethod
    def getAffinityManager():
        if torch.cuda.is_available():
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    @staticmethod
    def exec(op_result):
        """Ops run eagerly; identity, as in the reference."""
        return op_result
