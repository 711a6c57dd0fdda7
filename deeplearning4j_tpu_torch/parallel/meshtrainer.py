"""The sharded train step over one mesh — the port of
``deeplearning4j_tpu/parallel/meshtrainer.py``, its data and sequence
axes and ZeRO-1.

The reference compiles one GSPMD executable whose in/out shardings come
from a :class:`ShardingPlan`; XLA inserts the collectives.  Here every
rank runs the model's own eager step on its rows of the batch, and the
plan's collectives are explicit, between ``_grads_of`` and the updaters
(:meth:`ShardingPlan.update`):

- **data parallel**: the gradients of every trainable leaf, flattened in
  the reference's ``ravel_pytree`` order (``models.multilayer._ravel``),
  with the step's loss-times-rows and rows appended, go out as ONE
  bucket: one all-reduce over the ranks that hold a replica (the data and
  seq axes), the sum divided by their count.  A synchronous mean over the
  global batch equals the single-device step on that batch, which is the
  reference's arithmetic (``tests/test_parallel.py:74-86``); the loss the
  model then reports (``score()``) is the global one;
- **ZeRO-1** (``zero1``): each updater-state leaf that ``_leaf_spec``
  shards keeps this rank's slice; the gradients of those leaves are
  reduce-scattered into the slices (one bucket), this rank's slice of the
  updater runs, and the updated slices are all-gathered (one bucket) back
  into whole parameters; every other leaf goes through the data-parallel
  bucket;
- **seq axis**: the ranks of a seq group hold the same rows; ring
  attention (``parallel.ring``) splits the time axis between them inside
  the attention layers.

BatchNormalization reduces its batch statistics over the data group under
an active plan (``nn.conf.layers``), as the reference's ``jnp.mean`` over a
batch sharded on ``data`` is a mean over the global batch.

A ``model`` or ``stage`` axis, tensor parallelism, expert and table
sharding, and re-meshing wait for ROADMAP A10b and raise naming it.
Nothing is compiled per signature (ROADMAP C3): ``jitCacheSize`` answers
as the serving tier's ``compileCacheSize`` does.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (A10B, P, DeviceMesh,
                                                    activate_mesh,
                                                    active_plan,
                                                    activate_plan,
                                                    all_gather_cat,
                                                    all_reduce_,
                                                    broadcast_,
                                                    reduce_scatter,
                                                    waits_for_a10b)
from deeplearning4j_tpu_torch.parallel.zero import _leaf_dim, _leaf_spec

__all__ = ["ShardingPlan", "MeshTrainer", "active_plan", "activate_plan",
           "broadcast_tree", "reshard_tree", "apply_inference_plan",
           "place_replica"]

#: the reference's re-mesh and serving-TP helpers (ROADMAP A10b)
reshard_tree = waits_for_a10b("reshard_tree", "re-sharding onto a new mesh")
apply_inference_plan = waits_for_a10b(
    "apply_inference_plan", "the serving tier's tensor-parallel path")
place_replica = waits_for_a10b(
    "place_replica", "the serving tier's tensor-parallel replicas (one "
    "card: ContinuousBatcher(device=))")


def _units(net):
    """``(key, layer)`` pairs for a MultiLayerNetwork (index keys) or a
    ComputationGraph (node-name keys) — the shared addressing of
    ``params_``/``optState_``."""
    conf = net.conf
    if hasattr(conf, "layers"):
        return [(str(i), layer) for i, layer in enumerate(conf.layers)]
    return [(name, conf.nodes[name][0]) for name in conf.topoOrder]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def broadcast_tree(*trees, src: int = 0, skip=None) -> None:
    """Overwrite every tensor of ``trees`` with global rank ``src``'s, in
    place: one broadcast a dtype (the identity in a world of one).
    ``skip(t)`` leaves a tensor out (ZeRO-1's per-rank slices)."""
    by_dtype: Dict = {}
    for t in (t for tree in trees for t in _tensors(tree)):
        if skip is None or not skip(t):
            by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        broadcast_(flat, src)
        pos = 0
        for t in ts:
            t.copy_(flat[pos:pos + t.numel()].view(t.shape))
            pos += t.numel()


class _BatchRows:
    """A plan's batch sharding as the models' ``setBatchSharding`` takes
    it: ``rows(a)`` is this rank's rows of a global batch array (dim 0
    over the data axis)."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.spec = P(axis)

    def rows(self, a):
        return self.mesh.localRows(a, self.axis)

    def __repr__(self):
        return f"BatchSharding({self.spec!r} over {self.mesh!r})"


class ShardingPlan:
    """Where every tensor lives over one named-axis DeviceMesh.

    - batch arrays shard dim 0 over ``data`` (DP);
    - with ``zero1``, optimizer-state leaves shard their largest divisible
      dim over ``data`` (the arXiv:2004.13336 sharded weight update);
    - parameters and everything else replicate; a ``seq`` axis routes the
      attention layers to ring attention.

    ``tensorParallel``, a ``model`` or ``stage`` axis (and with them the
    expert and table-parallel keys) wait for ROADMAP A10b and raise.
    """

    def __init__(self, mesh: DeviceMesh, tensorParallel: bool = False,
                 zero1: bool = False, dataAxis: str = "data",
                 modelAxis: str = "model", zeroAxis: str = "data"):
        if tensorParallel:
            raise NotImplementedError(
                f"tensorParallel=True: the model axis waits for {A10B}")
        if mesh.modelSize > 1 or mesh.stageSize > 1:
            raise NotImplementedError(
                f"{mesh!r}: a model axis (tensor, expert and table "
                f"parallelism) and a stage axis (GPipe) wait for {A10B}")
        if dataAxis != "data" or zeroAxis != "data":
            raise ValueError("the data and ZeRO axes are the mesh's "
                             "'data' axis")
        self.mesh = mesh
        self.tensorParallel = False
        self.zero1 = bool(zero1)
        self.dataAxis = dataAxis
        self.modelAxis = modelAxis
        self.zeroAxis = zeroAxis

    @classmethod
    def for_model(cls, net, mesh: DeviceMesh,
                  tensorParallel: bool = False) -> "ShardingPlan":
        """Plan for ``net`` on ``mesh``, honouring a ZeRO-1 tag left by
        :class:`~deeplearning4j_tpu_torch.parallel.zero.ZeroStage1`."""
        zeroAxis = getattr(net, "_zero1Axis", None)
        return cls(mesh, tensorParallel=tensorParallel,
                   zero1=zeroAxis is not None, zeroAxis=zeroAxis or "data")

    # -- specs ----------------------------------------------------------
    def param_spec(self, layer, pname: str, shape: Tuple[int, ...]) -> P:
        """Every parameter replicates (the model axis's rules are A10b)."""
        return P()

    def opt_shardings(self, net):
        """A spec tree matching ``net.optState_``: under ZeRO-1 a leaf of
        a param's shape shards its largest divisible dim over the data
        axis, but the leaves of a frozen layer or one whose gradient is
        normalised over the layer stay whole (their update needs the
        whole gradient); everything else replicates."""
        if net.optState_ is None:
            return None
        from deeplearning4j_tpu_torch.models.multilayer import (
            _iter_leaf_params, _tree_map)
        zsize = self.mesh.dataSize if self.zero1 else 1
        out: Dict = {}
        for key, layer in _units(net):
            if key not in net.optState_:
                continue
            pshape = {path: tuple(val.shape) for path, _n, val
                      in _iter_leaf_params((net.params_ or {}).get(key, {}))}
            whole = not self.zero1 or not _zero_shardable(layer)
            out[key] = {}
            for path, sub in net.optState_[key].items():
                def leaf_sh(leaf, _shape=pshape.get(path)):
                    shape = tuple(getattr(leaf, "shape", ()))
                    if whole or not shape or shape != _shape:
                        return P()
                    return _leaf_spec(leaf, self.zeroAxis, zsize)
                out[key][path] = _tree_map(leaf_sh, sub)
        return out

    def batch_sharding(self) -> _BatchRows:
        return _BatchRows(self.mesh, self.dataAxis)

    # -- accounting -----------------------------------------------------
    def axis_sizes(self) -> Dict[str, int]:
        m = self.mesh
        return {"data": m.dataSize, "model": m.modelSize,
                "seq": m.seqSize, "stage": m.stageSize}

    def collective_bytes_per_step(self, net) -> Dict[Tuple[str, str], int]:
        """The reference's static estimate of a step's collective traffic,
        ``(axis, collective) -> bytes``: a leaf replicated across an axis
        of size ``s`` costs an all-reduce of ``2*(s-1)/s * nbytes``; under
        ZeRO-1 the data axis's splits into a reduce-scatter and an
        all-gather of ``(s-1)/s * nbytes`` each.  An estimate of the plan,
        not a measurement."""
        from deeplearning4j_tpu_torch.models.multilayer import \
            _iter_leaf_params
        out: Dict[Tuple[str, str], int] = {}

        def add(axis, coll, nbytes):
            key = (axis, coll)
            out[key] = int(out.get(key, 0) + nbytes)

        zsize = self.mesh.dataSize
        for key, layer in _units(net):
            if key not in (net.params_ or {}) or \
                    getattr(layer, "frozen", False):
                continue
            for _path, pname, val in _iter_leaf_params(net.params_[key]):
                nbytes = val.numel() * val.element_size()
                for axis, size in self.axis_sizes().items():
                    if size <= 1 or axis == "stage":
                        continue
                    frac = (size - 1) / size
                    if self.zero1 and axis == self.zeroAxis and \
                            _zero_shardable(layer) and \
                            len(_leaf_spec(val, self.zeroAxis, zsize)) > 0:
                        add(axis, "reduce_scatter", frac * nbytes)
                        add(axis, "all_gather", frac * nbytes)
                    else:
                        add(axis, "all_reduce", 2 * frac * nbytes)
        return out

    # -- the step's collectives -------------------------------------------
    def _replica_size(self) -> int:
        return self.mesh.dataSize * self.mesh.seqSize

    def update(self, net, units, grads, loss, rows: int):
        """The updaters of one step under this plan, from this rank's
        gradients of its ``rows`` of the batch and its loss: ``(params,
        optState, global loss)``.  Called by the models between
        ``_grads_of`` and the updaters."""
        from deeplearning4j_tpu_torch.models.multilayer import \
            _apply_updates
        if self._replica_size() > 1:
            if self.zero1 and self.mesh.dataSize > 1:
                return self._zero_update(net, units, grads, loss, rows)
            grads, loss = self._mean_grads(grads, loss, rows)
        return (*_apply_updates(
            units, net.conf.globalConf, net.params_, grads, net.optState_,
            net.iterationCount, net.epochCount, net._lrScale), loss)

    def _mean_grads(self, grads, loss, rows):
        """One all-reduce over the replica ranks (the world) of the
        gradient bucket and the loss: the mean gradient over the global
        batch, and the global loss (rows-weighted)."""
        from deeplearning4j_tpu_torch.models.multilayer import _ravel
        stats = torch.stack([loss.detach().float() * rows,
                             loss.new_tensor(float(rows),
                                             dtype=torch.float32)])
        if not grads:
            all_reduce_(stats, self._world_group())
            return grads, stats[0] / stats[1]
        flat, unravel = _ravel(grads)
        bucket = torch.cat([flat.float(), stats.to(flat.device)])
        all_reduce_(bucket, self._world_group())
        n = flat.numel()
        mean = (bucket[:n] / self._replica_size()).to(flat.dtype)
        return unravel(mean), bucket[n] / bucket[n + 1]

    def _world_group(self):
        import torch.distributed as dist
        return dist.group.WORLD

    def _zero_update(self, net, units, grads, loss, rows):
        """ZeRO-1: reduce-scatter the sharded leaves' gradients into this
        rank's slices, run the updater on the slices, all-gather the
        updated slices; the other leaves take the data-parallel mean."""
        from deeplearning4j_tpu_torch.models.multilayer import (
            _get_leaf, _grad_normalize, _iter_leaf_params, _set_leaf,
            _update_leaf)
        mesh = self.mesh
        D = mesh.dataSize
        me = mesh.coords["data"]
        gconf = net.conf.globalConf
        sharded, whole = [], {}
        for key, layer in units:
            if key not in net.params_ or getattr(layer, "frozen", False):
                continue
            for path, pname, pval in _iter_leaf_params(net.params_[key]):
                d = _sharded_dim(pval, net.optState_[key][path], D)
                if d is None:
                    _set_leaf(whole.setdefault(key, {}), path,
                              _get_leaf(grads[key], path))
                    continue
                if not _zero_shardable(layer):
                    raise ValueError(
                        f"layer {key}: ZeRO-1 over a layer whose gradient "
                        "is normalised over the layer, or that is frozen, "
                        "needs its whole gradient; ZeroStage1.apply keeps "
                        "its updater state whole")
                sharded.append((key, layer, path, pname, pval, d))
        # rank-major chunks: rank r's slices of every sharded leaf, in turn
        g_chunks = [[_get_leaf(grads[k], p).narrow(
                        d, r * (v.shape[d] // D), v.shape[d] // D)
                     .reshape(-1) for k, _l, p, _n, v, d in sharded]
                    for r in range(D)]
        mine = None
        if sharded:
            bucket = torch.cat([c for chunks in g_chunks for c in chunks])
            if mesh.seqSize > 1:
                all_reduce_(bucket, mesh.group("seq")).div_(mesh.seqSize)
            mine = reduce_scatter(bucket, mesh.group("data")).div_(D)
        whole, loss = self._mean_grads(whole, loss, rows)
        new_params, new_opt = {}, {}
        for key, layer in units:
            if key not in net.params_:
                continue
            if getattr(layer, "frozen", False):
                new_params[key] = net.params_[key]
                new_opt[key] = net.optState_[key]
                continue
            new_params[key], new_opt[key] = {}, {}
            if key in whole:
                gw = _grad_normalize(layer, whole[key])
                for path, pname, pval in _iter_leaf_params(net.params_[key]):
                    if _get_leaf_or_none(gw, path) is None:
                        continue
                    new, new_opt[key][path] = _update_leaf(
                        gconf, layer, pname, pval, _get_leaf(gw, path),
                        net.optState_[key][path], net.iterationCount,
                        net.epochCount, net._lrScale)
                    _set_leaf(new_params[key], path, new)
        new_chunks, pos = [], 0
        for key, layer, path, pname, pval, d in sharded:
            per = pval.shape[d] // D
            n = pval.numel() // D
            g = mine[pos:pos + n].view(
                *pval.shape[:d], per, *pval.shape[d + 1:]).to(pval.dtype)
            pos += n
            new, new_opt[key][path] = _update_leaf(
                gconf, layer, pname, pval.narrow(d, me * per, per), g,
                net.optState_[key][path], net.iterationCount,
                net.epochCount, net._lrScale)
            new_chunks.append(new.reshape(-1))
        if sharded:
            gathered = all_gather_cat(torch.cat(new_chunks),
                                      mesh.group("data")).view(D, -1)
            pos = 0
            for key, layer, path, pname, pval, d in sharded:
                n = pval.numel() // D
                per = pval.shape[d] // D
                parts = [gathered[r, pos:pos + n].view(
                    *pval.shape[:d], per, *pval.shape[d + 1:])
                    for r in range(D)]
                _set_leaf(new_params[key], path, torch.cat(parts, dim=d))
                pos += n
        # leaves keep the params' key order, as _apply_updates builds them
        ordered = {}
        for key, _layer in units:
            if key in new_params:
                ordered[key] = {}
                for path, _n, _v in _iter_leaf_params(net.params_[key]):
                    _set_leaf(ordered[key], path,
                              _get_leaf(new_params[key], path))
        return ordered, new_opt, loss

    def __repr__(self):
        return (f"ShardingPlan({self.mesh!r}, tp={self.tensorParallel}, "
                f"zero1={self.zero1})")


def _get_leaf_or_none(tree, path):
    for p in path.split("/"):
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _zero_shardable(layer) -> bool:
    """Whether ZeRO-1 may shard a layer's updater state: not a frozen
    layer, and no gradient normalisation over the layer or a parameter
    (elementwise clipping is fine)."""
    from deeplearning4j_tpu_torch.nn.conf import GradientNormalization
    if getattr(layer, "frozen", False):
        return False
    mode = getattr(layer, "gradientNormalization", None)
    return mode in (None, GradientNormalization.None_,
                    GradientNormalization.ClipElementWiseAbsoluteValue)


def _sharded_dim(pval, ostate, size: int) -> Optional[int]:
    """The dim along which ``ostate``'s leaves hold this rank's slice of
    a ``pval``-shaped tensor, or None where they are whole."""
    d = _leaf_dim(tuple(pval.shape), size)
    if d is None:
        return None
    leaves = [t for t in _tensors(ostate) if t.dim() == pval.dim()]
    if leaves and all(t.shape[d] * size == pval.shape[d] for t in leaves):
        return d
    return None


class MeshTrainer:
    """The one stepping path for every mesh shape of this slice.

    Steps the model's own ``fit`` (its TBPTT chunking, listeners and
    telemetry run unchanged) with the plan's batch sharding set and the
    mesh and plan active, so the models take their rows and the plan's
    collectives (:meth:`ShardingPlan.update`):

    - :meth:`step` — one train step on a single batch;
    - :meth:`fit` — iterator/epochs training;
    - :meth:`syncToNet` / :meth:`placeAfterRestore` — the checkpoint hooks.
    """

    def __init__(self, model, plan: Optional[ShardingPlan] = None,
                 mesh: Optional[DeviceMesh] = None,
                 tensorParallel: bool = False):
        self.net = model
        if plan is None:
            plan = ShardingPlan.for_model(model, mesh or DeviceMesh(),
                                          tensorParallel=tensorParallel)
        self.plan = plan
        self._placed = None          # the params_ dict place() left
        self._bytes = None           # cached per-step collective estimate

    # -- placement ------------------------------------------------------
    def place(self) -> None:
        """Rank 0's parameters, layer state and updater state on every
        rank (ZeRO-1's slices stay each rank's own), then the ZeRO-1
        slicing of whole updater state."""
        net = self.net
        if net.params_ is None:
            net.init()
        sliced = _sliced_ids(net, self.plan.mesh.dataSize)
        broadcast_tree(net.params_, net.state_, net.optState_,
                       skip=lambda t: id(t) in sliced)
        if self.plan.zero1:
            from deeplearning4j_tpu_torch.parallel.zero import _slice_net
            _slice_net(self.plan, net)
        self._placed = net.params_

    def _ensure_ready(self) -> None:
        net = self.net
        if net.params_ is None:
            net.init()
        if net.params_ is not self._placed:
            self.place()
            from deeplearning4j_tpu_torch.telemetry import mesh_metrics
            g = mesh_metrics().axis_size()
            for axis, size in self.plan.axis_sizes().items():
                g.set(size, axis=axis)

    def jitCacheSize(self) -> Optional[int]:
        """Fresh compiler runs of the net's AOT-dispatched step; None with
        the AOT cache off (nothing is compiled per signature)."""
        from deeplearning4j_tpu_torch.compile.aotcache import \
            _dispatch_cache_size
        return _dispatch_cache_size(self.net)

    # -- telemetry ------------------------------------------------------
    def _per_step_bytes(self) -> Dict[Tuple[str, str], int]:
        if self._bytes is None:
            self._bytes = self.plan.collective_bytes_per_step(self.net)
        return self._bytes

    def _record(self, steps: int, seconds: float, misses) -> None:
        if steps <= 0:
            return
        from deeplearning4j_tpu_torch.telemetry import mesh_metrics
        from deeplearning4j_tpu_torch.telemetry.instrument import \
            observe_exemplar
        from deeplearning4j_tpu_torch.telemetry.runlog import current_run
        mm = mesh_metrics()
        mm.steps().inc(steps)
        mm.step_seconds()
        rc = current_run()
        observe_exemplar(
            "dl4j_tpu_mesh_step_seconds", seconds / steps,
            rc.runId if rc is not None else None,
            attrs=None if rc is None else {
                "generation": int(rc.generation),
                "step": int(self.net.iterationCount)})
        if misses:
            mm.jit_cache_misses().inc(misses)
        cb = mm.collective_bytes()
        for (axis, coll), nbytes in self._per_step_bytes().items():
            cb.inc(nbytes * steps, axis=axis, collective=coll)

    def _run(self, fn):
        net = self.net
        self._ensure_ready()
        it0, misses0 = net.iterationCount, self.jitCacheSize()
        t0 = time.perf_counter()
        net.setBatchSharding(self.plan.batch_sharding())
        try:
            with activate_mesh(self.plan.mesh), activate_plan(self.plan):
                fn()
        finally:
            net.setBatchSharding(None)
            self._placed = net.params_
        misses1 = self.jitCacheSize()
        self._record(net.iterationCount - it0, time.perf_counter() - t0,
                     None if misses0 is None else misses1 - misses0)

    # -- stepping -------------------------------------------------------
    def step(self, ds) -> None:
        """One train step on a single (global) batch: this rank takes its
        rows, the plan's collectives make it the global step."""
        self._run(lambda: self.net.fit(ds))

    def fit(self, iterator, epochs: int = 1) -> None:
        """Iterator training: the model's own epoch loop, listeners, TBPTT
        and telemetry, each step sharded by the plan."""
        self._run(lambda: self.net.fit(iterator, epochs=epochs))

    def remesh(self, plan: ShardingPlan, reshard: bool = True) -> None:
        raise NotImplementedError(
            f"MeshTrainer.remesh: elastic re-meshing waits for {A10B}")

    # -- supervision hooks ----------------------------------------------
    def syncToNet(self) -> None:
        """Every mesh shape of this slice trains ``net.params_`` in place,
        so there is nothing to flush."""

    def placeAfterRestore(self) -> None:
        """Re-assert the plan's placement after a checkpoint restore."""
        self.place()


def _sliced_ids(net, size: int) -> set:
    """The ids of the updater-state tensors that hold this rank's ZeRO-1
    slice (they differ between ranks, so no broadcast touches them)."""
    from deeplearning4j_tpu_torch.models.multilayer import _iter_leaf_params
    out = set()
    for key, lp in (net.params_ or {}).items():
        for path, _pname, v in _iter_leaf_params(lp):
            st = (net.optState_ or {}).get(key, {}).get(path)
            if st is not None and _sharded_dim(v, st, size) is not None:
                out.update(id(t) for t in _tensors(st))
    return out
