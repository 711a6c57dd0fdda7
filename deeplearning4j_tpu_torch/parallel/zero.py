"""ZeRO-1 optimizer-state sharding — the port of
``deeplearning4j_tpu/parallel/zero.py``.

The reference places each updater-state leaf sharded over the ``data``
axis and lets GSPMD insert the collectives.  Here a sharded leaf is this
rank's slice along the dim :func:`_leaf_spec` picks (each rank holds
1/data of it); ``MeshTrainer``'s step reduce-scatters the gradients into
the slices, runs this rank's slice of the updater and all-gathers the
parameters (``parallel.meshtrainer.ShardingPlan.update``).  The result
equals data parallelism within the updater's rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.mesh import P, DeviceMesh

__all__ = ["shard_optimizer_state", "ZeroStage1"]


def _leaf_dim(shape: Tuple[int, ...], axis_size: int) -> Optional[int]:
    """The largest dim that ``axis_size`` divides (the first such among
    equals), or None for scalars and odd shapes."""
    for d, n in sorted(enumerate(shape), key=lambda t: -t[1]):
        if n % axis_size == 0 and n >= axis_size:
            return d
    return None


def _leaf_spec(val, axis: str, axis_size: int) -> P:
    """Shard the largest divisible dim of a leaf; replicate scalars/odd
    shapes.  Moment tensors mirror param shapes, so this divides Adam's
    m/v memory by the axis size for every weight matrix."""
    shape = tuple(val.shape)
    d = _leaf_dim(shape, axis_size)
    if d is None:
        return P()
    spec = [None] * len(shape)
    spec[d] = axis
    return P(*spec)


def _slice(leaf: torch.Tensor, d: int, size: int, index: int):
    per = leaf.shape[d] // size
    return leaf.narrow(d, index * per, per).clone()


def shard_optimizer_state(mesh: DeviceMesh, optState: Dict,
                          axis: str = "data") -> Dict:
    """This rank's slice of every optimizer-state array over ``axis``
    (ZeRO-1): each leaf of one or more dims keeps its ``1/size`` along the
    dim :func:`_leaf_spec` picks; scalars and odd shapes stay whole."""
    from deeplearning4j_tpu_torch.models.multilayer import _tree_map
    size = mesh.axisSize(axis)
    if size == 1:
        return optState
    index = mesh.coords[axis]

    def place(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        d = _leaf_dim(tuple(leaf.shape), size)
        return leaf if d is None else _slice(leaf, d, size, index)

    return _tree_map(place, optState)


def _slice_net(plan, net) -> None:
    """Replace each whole updater-state leaf that ``plan.opt_shardings``
    shards with this rank's slice (a leaf already sliced stays)."""
    specs = plan.opt_shardings(net)
    if not specs:
        return
    mesh = plan.mesh
    size, index = mesh.dataSize, mesh.coords["data"]
    for key, sub in specs.items():
        for path, spec_tree in sub.items():
            pval = _param(net, key, path)

            def cut(leaf, spec):
                if not tuple(spec) or tuple(leaf.shape) != tuple(pval.shape):
                    return leaf
                return _slice(leaf, list(spec).index(plan.zeroAxis), size,
                              index)
            net.optState_[key][path] = _zip_map(
                cut, net.optState_[key][path], spec_tree)


def _param(net, key, path):
    d = net.params_[key]
    for p in path.split("/"):
        d = d[p]
    return d


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (a ``P`` is a
    leaf, though it is a tuple)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(specs, P):
        return tuple(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


class ZeroStage1:
    """Apply ZeRO-1 placement to a model (params replicated, updater state
    sharded over the data axis)::

        ZeroStage1(mesh).apply(net)    # before ParallelWrapper.fit

    ``apply`` brings rank 0's updater state to every rank, keeps this
    rank's slices, and tags the net so ``ShardingPlan.for_model`` builds
    the ZeRO-1 plan.  A frozen layer, and one whose gradient is normalised
    over the layer, keep their updater state whole (their update needs
    the whole gradient)."""

    def __init__(self, mesh: DeviceMesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis

    def apply(self, net):
        from deeplearning4j_tpu_torch.parallel.meshtrainer import (
            ShardingPlan, _sliced_ids, broadcast_tree)
        if net.params_ is None:
            net.init()
        sliced = _sliced_ids(net, self.mesh.axisSize(self.axis))
        broadcast_tree(net.optState_, skip=lambda t: id(t) in sliced)
        net._zero1Axis = self.axis
        _slice_net(ShardingPlan.for_model(net, self.mesh), net)
        return net
