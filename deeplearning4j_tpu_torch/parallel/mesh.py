"""Device mesh and the collectives of the parallel layer — the port of
``deeplearning4j_tpu/parallel/mesh.py``.

The reference's mesh is one controller's ``jax.sharding.Mesh`` over chips,
and GSPMD inserts the collectives.  Here one process is one mesh position:
a rank of the default ``torch.distributed`` process group, laid out over
the reference's axes and order ``("data", "model", "seq", "stage")`` by
``torch.distributed.device_mesh.init_device_mesh``, which gives each axis
its sub-group.  Collectives are explicit calls on those sub-groups
(:func:`all_reduce_`, :func:`reduce_scatter`, :func:`all_gather_cat`,
:func:`broadcast_`, :func:`ring_exchange`), and :class:`AllReduceSum` is
the differentiable sum that BatchNormalization's global statistics take.
``deviceIds`` are ranks (ROADMAP C44).

A process that started no group is a world of one rank: its mesh is
``1x1x1x1`` over its own device and every collective is the identity.

Transport by backend, never by catching an error: an ``nccl`` group takes
CUDA tensors as they are; a ``gloo`` group takes CPU tensors, and a CUDA
tensor bound for one goes through a pinned host buffer (four ranks that
share one card cannot use NCCL, which refuses two ranks on one device;
ROADMAP C45).

Axes beyond ``data`` and ``seq`` wait for ROADMAP A10b: a ``model`` axis
(tensor, expert and table parallelism) and a ``stage`` axis (GPipe) build
their groups but every path that would shard over them raises.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["DeviceMesh", "P", "activate_mesh", "active_mesh",
           "shard_params", "all_reduce_", "reduce_scatter",
           "all_gather_cat", "broadcast_", "ring_exchange", "AllReduceSum",
           "transport", "A10B", "waits_for_a10b"]

AXES = ("data", "model", "seq", "stage")

#: the queue item every path that waits for the model/stage axes names
A10B = "ROADMAP A10b"


def waits_for_a10b(name: str, what: str):
    """A reference name of the model or stage axes, or of re-meshing: it
    imports, and raises naming ROADMAP A10b when called."""
    def waiting(*args, **kwargs):
        raise NotImplementedError(f"{name}: {what} waits for {A10B}")
    waiting.__name__ = waiting.__qualname__ = name
    waiting.__doc__ = f"{what}: waits for {A10B} (raises when called)."
    return waiting


class P(tuple):
    """A partition spec: one mesh-axis name (or None) per tensor dimension,
    as ``jax.sharding.PartitionSpec``; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class DeviceMesh:
    """An N-D mesh of ranks with named axes (data, model, seq, stage).

    ``data=-1`` takes the world size over ``model*seq*stage``.  ``devices``
    (ranks) defaults to the whole world, in rank order; a mesh must cover
    the world exactly (a mesh over part of it is a re-mesh, ROADMAP A10b).
    """

    def __init__(self, data: int = -1, model: int = 1, seq: int = 1,
                 stage: int = 1, devices: Optional[Sequence] = None):
        world = _world()
        ranks = [int(getattr(d, "id", d)) for d in devices] \
            if devices is not None else list(range(world))
        n = len(ranks)
        if data == -1:
            rest = model * seq * stage
            if n % rest:
                raise ValueError(
                    f"{n} ranks not divisible by model*seq*stage={rest}")
            data = n // rest
        if data * model * seq * stage != n:
            raise ValueError(
                f"mesh {data}x{model}x{seq}x{stage} != {n} ranks")
        if sorted(ranks) != list(range(world)):
            raise NotImplementedError(
                f"a mesh over ranks {ranks} of a world of {world}: a mesh "
                f"over part of the world is a re-mesh, {A10B}")
        self.dataSize, self.modelSize = data, model
        self.seqSize, self.stageSize = seq, stage
        self.shape = (data, model, seq, stage)
        self._ranks = ranks
        self.rank = _rank()
        pos = ranks.index(self.rank)
        self.coords = dict(zip(AXES, _unravel(pos, self.shape)))
        self._groups = _axis_groups(self.shape) if world > 1 else {}

    # -- elastic rebuild ------------------------------------------------
    @classmethod
    def largest_from(cls, devices: Sequence, model: int = 1, seq: int = 1,
                     stage: int = 1) -> "DeviceMesh":
        """Largest valid mesh over ``devices`` (ranks) that keeps the
        non-data axis sizes; raises ``ValueError`` when fewer than
        ``model*seq*stage`` survive."""
        devices = list(devices)
        rest = int(model) * int(seq) * int(stage)
        usable = (len(devices) // rest) * rest
        if usable < rest:
            raise ValueError(
                f"{len(devices)} surviving devices cannot host a mesh "
                f"with model*seq*stage={rest}")
        return cls(data=usable // rest, model=model, seq=seq, stage=stage,
                   devices=devices[:usable])

    @classmethod
    def largest_from_ids(cls, ids, model: int = 1, seq: int = 1,
                         stage: int = 1,
                         devices: Optional[Sequence] = None) -> "DeviceMesh":
        """:meth:`largest_from` over the ranks among ``ids`` (ids that are
        not ranks of this world are ignored)."""
        pool = list(devices) if devices is not None \
            else list(range(_world()))
        want = {int(i) for i in ids}
        picked = [d for d in pool if int(getattr(d, "id", d)) in want]
        return cls.largest_from(picked, model=model, seq=seq, stage=stage)

    def deviceIds(self):
        """The participating ranks, flat in mesh order."""
        return list(self._ranks)

    # -- placement ------------------------------------------------------
    def group(self, axis: str):
        """The sub-group of this rank along ``axis``, or None where the
        axis has one rank (every collective over it is the identity)."""
        return self._groups.get(axis) if self.axisSize(axis) > 1 else None

    def axisSize(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def shardBatch(self, *arrays):
        """This rank's contiguous rows of each global batch array (dim 0
        over the data axis); a batch that does not divide raises."""
        out = tuple(self.localRows(a) for a in arrays)
        return out if len(out) > 1 else out[0]

    def localRows(self, a, axis: str = "data"):
        if a is None:
            return None
        n, size = a.shape[0], self.axisSize(axis)
        if n % size:
            raise ValueError(
                f"the batch is sharded over the {axis!r} axis of {self!r}, "
                f"which implies that the global size of its dimension 0 "
                f"should be divisible by {size}, but it is equal to {n}")
        per = n // size
        i = self.coords[axis]
        return a[i * per:(i + 1) * per]

    def numDevices(self) -> int:
        return int(math.prod(self.shape))

    def __repr__(self):
        return (f"DeviceMesh(data={self.dataSize}, model={self.modelSize}, "
                f"seq={self.seqSize}, stage={self.stageSize}, "
                f"devices={self.numDevices()})")


def _unravel(pos: int, shape) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(pos % n)
        pos //= n
    return tuple(reversed(out))


#: ``init_device_mesh``'s sub-groups, by (default group, mesh shape):
#: building them is a collective of every rank, so each shape builds once
#: a process group
_GROUPS: Dict = {}


def _axis_groups(shape) -> Dict:
    key = (id(dist.group.WORLD), tuple(shape))
    groups = _GROUPS.get(key)
    if groups is None:
        from torch.distributed.device_mesh import init_device_mesh
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        tmesh = init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=AXES)
        groups = {axis: tmesh.get_group(axis) for axis in AXES}
        _GROUPS[key] = groups
    return groups


# ---------------------------------------------------------------------------
# the active mesh: a routing signal for layers (ring attention)
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[DeviceMesh] = None


def active_mesh() -> Optional[DeviceMesh]:
    """The DeviceMesh of the enclosing ``ParallelWrapper.fit`` /
    ``MeshTrainer`` step, if any.  The attention layers route to ring
    attention when it has a seq axis."""
    return _ACTIVE_MESH


class activate_mesh:
    """Context manager marking ``mesh`` active for layer routing."""

    def __init__(self, mesh: Optional[DeviceMesh]):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


#: the ShardingPlan of the enclosing MeshTrainer step: the models read it
#: between their gradients and their updaters, BatchNormalization for its
#: statistics (kept here, beside the mesh, so the layers reach it without
#: importing the trainer)
_ACTIVE_PLAN = None


def active_plan():
    """The ``ShardingPlan`` of the enclosing ``MeshTrainer`` step, if
    any."""
    return _ACTIVE_PLAN


class activate_plan:
    """Context manager marking ``plan`` active for the models' step."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        global _ACTIVE_PLAN
        self._prev = _ACTIVE_PLAN
        _ACTIVE_PLAN = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _ACTIVE_PLAN
        _ACTIVE_PLAN = self._prev
        return False


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def transport(group) -> str:
    """How a CUDA tensor reaches ``group``: ``"device"`` (NCCL takes it as
    it is) or ``"host"`` (a gloo group: through a pinned host buffer)."""
    return "device" if dist.get_backend(group) == "nccl" else "host"


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and transport(group) == "host"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (None: the identity)."""
    if group is None:
        return t
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of a flat tensor, of which this rank keeps
    its contiguous 1/size (the length must divide)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.numel() % n:
        raise ValueError(f"reduce_scatter of {t.numel()} elements over "
                         f"{n} ranks")
    src = _to_host(t) if _staged(t, group) else t
    out = src.new_empty(t.numel() // n)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device) if out.device != t.device else out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape) of ``group``, concatenated along
    ``dim`` in group-rank order (None: ``t``)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = _to_host(t) if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if out.device != t.device else out


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s (the default group when
    ``group`` is None; the identity in a world of one)."""
    if not dist.is_initialized() or _world() == 1:
        return t
    if _staged(t, group or dist.group.WORLD):
        h = _to_host(t)
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def ring_exchange(tensors, group):
    """One hop around the ring of ``group``: send the tensors to the next
    group rank and return the previous one's (same shapes and dtypes).
    They travel as one byte buffer: NCCL posts the hop as one
    ``batch_isend_irecv`` on the device; a gloo group sends a host copy
    point to point."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    send = _to_host(flat) if _staged(flat, group) else flat
    recv = torch.empty_like(send)
    if transport(group) == "device":
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, send, nxt, group),
             dist.P2POp(dist.irecv, recv, prv, group)])
    else:
        works = [dist.isend(send, nxt, group=group),
                 dist.irecv(recv, prv, group=group)]
    for w in works:
        w.wait()
    recv = recv.to(flat.device)
    out, pos = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        out.append(recv[pos:pos + nb].view(t.dtype).reshape(t.shape))
        pos += nb
    return out


class AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, differentiable: the gradient of each rank's
    input is the sum of every rank's output gradient (each rank's loss
    reaches every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------

def shard_params(mesh: DeviceMesh, params: Dict,
                 tensorParallel: bool = False):
    """Place a params tree on the mesh: replicated, rank 0's values on
    every rank (broadcast in place).  The tensor-parallel rule over the
    ``model`` axis waits for ROADMAP A10b."""
    if tensorParallel and mesh.modelSize > 1:
        raise NotImplementedError(
            f"shard_params(tensorParallel=True) over a model axis of "
            f"{mesh.modelSize}: tensor parallelism waits for {A10B}")
    from deeplearning4j_tpu_torch.parallel.meshtrainer import broadcast_tree
    broadcast_tree(params)
    return params
