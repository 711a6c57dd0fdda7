"""The stateful RNG facade — the port of ``deeplearning4j_tpu/ops/random.py``
(the reference's libnd4j ``RandomGenerator`` and ``Nd4j.getRandom()``).

The reference splits a threefry key per draw.  The port draws from an
explicit ``torch.Generator`` on the array's device, one per device, each
seeded from the generator's seed: CUDA's generator is itself a Philox
counter RNG, advanced by the offset every draw consumes.  The bits differ
from JAX's threefry, so a seed gives the same draws in the port on a given
device, not the reference's draws.

``split`` returns fresh integer seeds drawn from the chain (the
reference returns subkeys): the port's code that wants an explicit
stream seeds its own ``torch.Generator`` with one.  Scalar draws
(``nextDouble``, ``nextGaussian``, ``nextInt``) are host values and come
from the CPU generator.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.ops.dtype import DataType, default_float

__all__ = ["RandomGenerator", "get_random"]


def _default_device():
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.ops.ndarray import host_only_arrays
    return torch.device("cpu") if host_only_arrays() else resolve_device()


class RandomGenerator:
    """Stateful facade over one seeded ``torch.Generator`` per device."""

    def __init__(self, seed: int = 119):
        self._lock = threading.Lock()
        self.setSeed(seed)

    def setSeed(self, seed: int) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self._seed = int(seed)
            self._gens: Dict[str, torch.Generator] = {}

    def getSeed(self) -> int:
        return self._seed

    def generator(self, device=None) -> torch.Generator:
        """The chain's generator on ``device`` (the default device when
        None), made and seeded on first use."""
        dev = torch.device(device) if device is not None \
            else _default_device()
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        with self._lock:
            g = self._gens.get(key)
            if g is None:
                g = self._gens[key] = torch.Generator(device=dev)
                g.manual_seed(self._seed & 0xFFFFFFFFFFFFFFFF)
        return g

    def split(self, n: int = 1):
        """Advance the chain and return ``n`` fresh 63-bit seeds."""
        g = self.generator("cpu")
        seeds = torch.randint(0, 2 ** 63 - 1, (int(n),), generator=g,
                              dtype=torch.int64).tolist()
        return seeds[0] if n == 1 else seeds

    # -- draw methods ---------------------------------------------------
    def _where(self, device):
        g = self.generator(device)
        return g, g.device

    def uniform(self, shape, minval=0.0, maxval=1.0,
                dtype: Optional[DataType] = None, device=None):
        g, dev = self._where(device)
        dt = (dtype or default_float()).torch
        u = torch.rand(tuple(shape), generator=g, device=dev, dtype=dt)
        return u * (maxval - minval) + minval

    def normal(self, shape, mean=0.0, std=1.0,
               dtype: Optional[DataType] = None, device=None):
        g, dev = self._where(device)
        dt = (dtype or default_float()).torch
        return torch.randn(tuple(shape), generator=g, device=dev,
                           dtype=dt) * std + mean

    def bernoulli(self, shape, p=0.5, device=None):
        g, dev = self._where(device)
        return torch.rand(tuple(shape), generator=g, device=dev) < p

    def randint(self, shape, minval, maxval,
                dtype: DataType = DataType.INT32, device=None):
        g, dev = self._where(device)
        return torch.randint(int(minval), int(maxval), tuple(shape),
                             generator=g, device=dev, dtype=dtype.torch)

    def permutation(self, n: int, device=None):
        g, dev = self._where(device)
        return torch.randperm(int(n), generator=g, device=dev)

    def nextDouble(self) -> float:
        return float(torch.rand((), generator=self.generator("cpu"),
                                dtype=torch.float64))

    def nextGaussian(self) -> float:
        return float(torch.randn((), generator=self.generator("cpu"),
                                 dtype=torch.float64))

    def nextInt(self, bound: int) -> int:
        return int(torch.randint(0, int(bound), (),
                                 generator=self.generator("cpu")))


_DEFAULT = RandomGenerator(119)


def get_random() -> RandomGenerator:
    return _DEFAULT
