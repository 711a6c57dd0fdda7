"""MultiLayerNetwork — the linear-stack model; the port of
``deeplearning4j_tpu/models/multilayer.py`` (the reference's
``MultiLayerNetwork.java``: fit/output/score, flattened param views, the
per-iteration updater step).

One train step runs forward, loss, backward (``torch.autograd.grad``),
per-layer gradient normalization, the updaters, weight decay and L1/L2 —
the same sequence the JAX package fuses into one executable, here in eager
PyTorch on the net's device (``cuda`` unless the caller asks for another).
Parameters are a dict of dicts of tensors, keyed as the JAX net's
``params_`` (``{"0": {"Wq": ...}, ...}``), so ``init(params=)`` takes the
JAX net's parameters as numpy arrays.  Layer state (BatchNormalization's
running statistics) is ``state_``, keyed the same way: built by each
layer's ``initState`` at ``init``, passed to every layer's forward, and
replaced by what the layers return after each train step.

``dataType`` BFLOAT16 / HALF / FLOAT16 means bf16 compute over float32
master parameters, optimizer state and loss: the parameters are cast for
the forward and the gradients flow back through the casts into the f32
masters.

Recurrent layers (``isRNN``) run through ``scanSeq`` with a carry per
layer: zeros for fresh sequences, or the carries of the previous TBPTT
chunk (detached, so the backward stops at the chunk's start) or of the
previous ``rnnTimeStep`` call (the reference's rnn ``stateMap``).

Around the step: training listeners (``onEpochStart`` / ``onEpochEnd``
per epoch, ``iterationDone`` once per batch, however many TBPTT chunks it
has), ``evaluate`` (one device-to-host copy per batch, the metrics in
numpy), the line-search solvers over the flat parameter vector
(``optimizationAlgo`` other than SGD), and frozen layers (transfer
learning): their parameters take no gradient and no update.

``pretrain`` trains the ``isPretrainLayer`` layers (``AutoEncoder``,
``VariationalAutoencoder``) layer by layer on their own loss.

Each logical step reports through ``telemetry.train_step_span`` (the
step counter, step-time histogram, ``step`` span and flight record); the
fault supervisor's learning-rate scale (``setLrScale``) multiplies every
updater's step.  The step dispatches through ``_trainStep``: with the AOT
cache configured (``compile.aotcache``; off unless configured) that is an
``AotDispatch`` whose ladder lists the kernel libraries the step uses, so
a warm boot loads them instead of compiling; with it off, the step itself.

Under a ``parallel.MeshTrainer`` step (``setBatchSharding`` set, a plan
active) the step takes this rank's rows of the batch, and the plan's
collectives run between the gradients and the updaters
(``ShardingPlan.update``): the mean gradient over the global batch, and
the global loss for ``score()``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.eval.evaluation import (Evaluation,
                                                      RegressionEvaluation,
                                                      ROC)
from deeplearning4j_tpu_torch.learning.config import Sgd
from deeplearning4j_tpu_torch.learning.regularization import (
    L1Regularization, L2Regularization, WeightDecay)
from deeplearning4j_tpu_torch.nn.conf import (BackpropType,
                                              GradientNormalization,
                                              MultiLayerConfiguration)
from deeplearning4j_tpu_torch.ops.ndarray import NDArray
from deeplearning4j_tpu_torch.optimize.listeners import notifyListeners
from deeplearning4j_tpu_torch.profiler import check_panic, panic_enabled
from deeplearning4j_tpu_torch.telemetry.instrument import (in_microbatch,
                                                           train_step_span)

__all__ = ["MultiLayerNetwork"]

Params = Dict[str, Dict[str, torch.Tensor]]

#: canonical intra-layer param order (DL4J's flattened-view layout — input
#: weights, recurrent weights, bias; BN gamma/beta; GravesLSTM peepholes;
#: Bidirectional halves); other keys follow, sorted
_PARAM_ORDER = ["W", "RW", "b", "gamma", "beta", "pI", "pF", "pO",
                "fwd", "bwd"]

_HALF_TYPES = ("BFLOAT16", "HALF", "FLOAT16")


def _param_key_order(keys):
    known = [k for k in _PARAM_ORDER if k in keys]
    return known + sorted(k for k in keys if k not in _PARAM_ORDER)


def _iter_leaf_params(lp: Dict, prefix: str = ""):
    """Yield ``(path, pname, value)`` over a layer's params in canonical
    order, descending into nested dicts."""
    for k in _param_key_order(lp.keys()):
        v = lp[k]
        if isinstance(v, dict):
            yield from _iter_leaf_params(v, prefix + k + "/")
        else:
            yield prefix + k, k, v


def _get_leaf(d: Dict, path: str):
    for p in path.split("/"):
        d = d[p]
    return d


def _set_leaf(d: Dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _clone_tree(tree, device=None):
    """Copies of every tensor of a parameter, state or updater tree (on
    ``device``, else where each lies)."""
    return _tree_map(lambda t: t.to(device or t.device, copy=True), tree)


def _cast_tree(tree, dtype):
    """f32 leaves -> the compute ``dtype`` (a no-op at full precision)."""
    if dtype == torch.float32 or tree is None:
        return tree
    return _tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                     else a, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _detached_leaves(params, frozen):
    """``(leaves, tree)``: every param leaf detached, as ``(key, path,
    leaf)`` rows and as a tree of the same leaves; the leaves of keys not
    in ``frozen`` require grad."""
    leaves = [(k, path, v.detach().requires_grad_(k not in frozen))
              for k, lp in params.items()
              for path, _pname, v in _iter_leaf_params(lp)]
    tree: Dict = {}
    for k, path, v in leaves:
        _set_leaf(tree.setdefault(k, {}), path, v)
    return leaves, tree


def _grads_of(loss, leaves):
    """The gradient tree of ``loss`` over the leaves that require grad; a
    leaf the loss does not reach gets zeros (``jax.grad``'s answer)."""
    train = [(k, path, v) for k, path, v in leaves if v.requires_grad]
    grads: Dict = {}
    if train:
        flat = torch.autograd.grad(
            loss, [v for _k, _p, v in train], allow_unused=True) \
            if loss.requires_grad else [None] * len(train)
        for (k, path, v), g in zip(train, flat):
            _set_leaf(grads.setdefault(k, {}), path,
                      torch.zeros_like(v) if g is None else g)
    return grads


def _sorted_leaves(tree, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _sorted_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _ravel(tree):
    """``(flat, unravel)``: the leaves in sorted key order (the reference's
    ``ravel_pytree`` order) as one vector, and the map from such a vector
    back to a tree of views of it."""
    items = [(path, tuple(v.shape), v.numel())
             for path, v in _sorted_leaves(tree)]
    flat = torch.cat([v.reshape(-1) for _p, v in _sorted_leaves(tree)])

    def unravel(vec):
        out: Dict = {}
        pos = 0
        for path, shape, n in items:
            _set_leaf(out, path, vec[pos:pos + n].view(shape))
            pos += n
        return out

    return flat, unravel


def _frozen_keys(units):
    """The keys of the frozen layers among ``(key, layer)`` pairs."""
    return {k for k, layer in units if getattr(layer, "frozen", False)}


def _solver_step(model, algo: str, seed: int, loss_of, *batch) -> None:
    """One line-searched iteration of the ``optimizationAlgo`` solver over
    the flat vector of ``model.params_`` (the reference's Solver
    semantics, ``optimize/solvers.py``).  ``loss_of(params, gen, *batch)``
    is the model's training loss; every probe draws dropout from a
    generator seeded with ``seed``, so it sees the same masks.  The
    solver, and L-BFGS's history, stays on the model across calls."""
    from deeplearning4j_tpu_torch.optimize.solvers import make_solver
    flat, unravel = _ravel(model.params_)
    if model._solver is None or model._solverAlgo != algo or \
            model._solverSize != flat.numel():
        model._solver = make_solver(
            algo, int(model.conf.globalConf.get(
                "maxNumLineSearchIterations") or 5))
        model._solverAlgo, model._solverSize = algo, flat.numel()

        def loss_flat(v, *b):
            gen = torch.Generator(device=model.device).manual_seed(seed)
            return loss_of(unravel(v), gen, *b)

        model._solver.bind(loss_flat)
    new_flat, f_new = model._solver.step(flat, *batch)
    model.params_ = unravel(new_flat.detach())
    model._score = float(f_new)
    model._scoreArr = None


def _to_tensor(v, device) -> torch.Tensor:
    if isinstance(v, NDArray):
        v = v.torch
    if isinstance(v, torch.Tensor):
        return v.detach().to(device).clone()
    return torch.from_numpy(np.array(v)).to(device)


def _to_device(a, device, dtype=None):
    """An ``NDArray``, tensor, numpy array or nested list on ``device``
    (None passes).  An ``NDArray`` gives its tensor, so a batch already on
    the card never goes through the host."""
    if a is None:
        return None
    if isinstance(a, NDArray):
        a = a.torch
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device, dtype)


def _grad_normalize(layer, g):
    """Per-layer gradient normalization (reference:
    ``BaseMultiLayerUpdater.preApply``) over a layer's gradient tree."""
    mode = getattr(layer, "gradientNormalization", None)
    if not mode or mode == GradientNormalization.None_:
        return g
    thr = getattr(layer, "gradientNormalizationThreshold", None) or 1.0

    def layer_norm():
        return torch.sqrt(sum(torch.sum(v * v) for v in _leaves(g)) + 1e-12)

    if mode == GradientNormalization.RenormalizeL2PerLayer:
        norm = layer_norm()
        return _tree_map(lambda v: v / norm, g)
    if mode == GradientNormalization.RenormalizeL2PerParamType:
        return _tree_map(lambda v: v / torch.sqrt(torch.sum(v * v) + 1e-12),
                         g)
    if mode == GradientNormalization.ClipElementWiseAbsoluteValue:
        return _tree_map(lambda v: torch.clamp(v, -thr, thr), g)
    if mode == GradientNormalization.ClipL2PerLayer:
        scale = torch.clamp(thr / layer_norm(), max=1.0)
        return _tree_map(lambda v: v * scale, g)
    if mode == GradientNormalization.ClipL2PerParamType:
        return _tree_map(lambda v: v * torch.clamp(
            thr / torch.sqrt(torch.sum(v * v) + 1e-12), max=1.0), g)
    raise ValueError(f"Unknown gradient normalization {mode}")


def _updater_for(globalConf, layer, pname: str):
    """Effective updater for one param."""
    if pname == "b" and getattr(layer, "biasUpdater", None) is not None:
        return layer.biasUpdater
    return getattr(layer, "updater", None) or globalConf.get("updater") \
        or Sgd(1e-2)


def _apply_updates(units, globalConf, params, grads, optState, iteration,
                   epoch, lrScale: float = 1.0):
    """Apply the updaters over every parameter leaf.  ``units`` is an
    iterable of ``(key, layer)``; a frozen layer (transfer learning) keeps
    its parameters and updater state; a layer with gradient normalization
    gets its norms over exactly its own leaves; weight decay (the
    reference's ``WeightDecay``, applied after the updater and scaled by
    the learning rate) touches weights only; ``lrScale`` (the fault
    supervisor's rollback backoff) multiplies every step; at 1 the
    multiply is skipped (the same bits).
    Returns ``(new_params, new_opt)``."""
    new_params: Dict = {}
    new_opt: Dict = {}
    for key, layer in units:
        if key not in params:
            continue
        if getattr(layer, "frozen", False):
            new_params[key] = params[key]
            new_opt[key] = optState[key]
            continue
        new_params[key] = {}
        new_opt[key] = {}
        g = _grad_normalize(layer, grads[key])
        for path, pname, pval in _iter_leaf_params(params[key]):
            new, new_opt[key][path] = _update_leaf(
                globalConf, layer, pname, pval, _get_leaf(g, path),
                optState[key][path], iteration, epoch, lrScale)
            _set_leaf(new_params[key], path, new)
    return new_params, new_opt


def _update_leaf(globalConf, layer, pname: str, pval, g, ostate, iteration,
                 epoch, lrScale: float = 1.0):
    """One leaf's step of :func:`_apply_updates`: ``(new value, new
    updater state)``.  Elementwise, so it takes a slice of a leaf with
    the same slice of its gradient and state (ZeRO-1's sharded update)."""
    up = _updater_for(globalConf, layer, pname)
    lr = up.currentLr(iteration, epoch)
    update, ostate = up.apply(g, ostate, lr, iteration, epoch, param=pval)
    wd = getattr(layer, "weightDecay", None)
    if wd and pname in layer.weightParamKeys():
        update = WeightDecay(coeff=wd).apply(pval, update, lr)
    if lrScale != 1.0:
        update = update * lrScale
    return pval - update, ostate


def _reg_penalty(pairs):
    """L1/L2 penalty over (layer, layer_params) pairs, added to the loss
    (the same gradient as the reference's BEFORE_UPDATER modification)."""
    total = 0.0
    for layer, lp in pairs:
        l1 = getattr(layer, "l1", None)
        l2 = getattr(layer, "l2", None)
        if not l1 and not l2:
            continue
        wkeys = layer.weightParamKeys()
        for _path, pname, w in _iter_leaf_params(lp):
            if pname in wkeys:
                if l2:
                    total = total + L2Regularization(l2).score(w)
                if l1:
                    total = total + L1Regularization(l1).score(w)
    return total


def _local_rows(model, *arrays):
    """This rank's rows of each batch array under a MeshTrainer step (the
    arrays as they are otherwise)."""
    if model._batchSharding is None:
        return arrays
    return tuple(model._batchSharding.rows(a) for a in arrays)


def _step_updates(model, units, grads, loss, rows: int):
    """``(params, optState, loss)`` after one step's updaters: under an
    active ``ShardingPlan`` through its collectives (the global mean
    gradient and the global loss), else the updaters as they are."""
    from deeplearning4j_tpu_torch.parallel.mesh import active_plan
    plan = active_plan()
    if plan is not None:
        return plan.update(model, units, grads, loss, int(rows))
    return (*_apply_updates(units, model.conf.globalConf, model.params_,
                            grads, model.optState_, model.iterationCount,
                            model.epochCount, model._lrScale), loss)


def _check_solver_unsharded(model) -> None:
    """The line-search solvers probe the loss many times a step; under a
    data plan each probe would need the global loss (ROADMAP A10b)."""
    from deeplearning4j_tpu_torch.parallel.mesh import A10B, active_plan
    plan = active_plan()
    if plan is not None and plan._replica_size() > 1:
        raise NotImplementedError(
            "the line-search solvers (optimizationAlgo other than SGD) over "
            f"a data-parallel mesh wait for {A10B}")


def _panic_step(model) -> None:
    """NAN_PANIC/INF_PANIC (reference: profilingConfigurableHookOut): with
    panic mode on, one host read of the step's loss, to fail on the exact
    step; with it off, the loss stays on the device."""
    if panic_enabled():
        model._score = float(model._scoreArr)
        model._scoreArr = None
        check_panic(model._score)


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.params_: Optional[Params] = None
        self.state_: Dict[str, Dict[str, torch.Tensor]] = {}
        self.optState_: Optional[Dict] = None
        self.iterationCount = 0
        self.epochCount = 0
        self.lastBatchSize = 0
        self._score = 0.0
        self._scoreArr = None   # the last step's loss, left on the device
        self._listeners: List = []
        self._rngSeed = int(conf.globalConf.get("seed", 123) or 123)
        self._dtype = torch.float32
        dt = str(conf.globalConf.get("dataType") or "FLOAT").upper()
        self._computeDtype = torch.bfloat16 if dt in _HALF_TYPES \
            else torch.float32
        # input dropout draws from here (on the net's device)
        self._fitGen = torch.Generator(device=self.device).manual_seed(
            self._rngSeed ^ 0x5EED)
        self._rnnCarries = None  # rnnTimeStep's stored state, by layer
        self._solver = None      # the line-search solver, once bound
        self._lrScale = 1.0      # FaultTolerantTrainer's divergence backoff
        self._batchSharding = None  # set by MeshTrainer (DP over a mesh)

    def setLrScale(self, scale: float) -> None:
        """Global multiplier on every updater's step size (the fault
        supervisor's rollback backoff knob).  No effect on the line-search
        solvers (they pick their own step length)."""
        self._lrScale = float(scale)

    def getLrScale(self) -> float:
        return self._lrScale

    def setBatchSharding(self, sharding) -> None:
        """Set by ``parallel.MeshTrainer`` around its steps: each step takes
        ``sharding.rows(a)`` of every batch array (this rank's rows over
        the data axis); None (the default) takes the whole batch."""
        self._batchSharding = sharding

    def _cast_compute(self, tree):
        return _cast_tree(tree, self._computeDtype)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def init(self, params: Optional[Dict] = None) -> "MultiLayerNetwork":
        """Draw the parameters from a generator seeded with the config's
        seed, or take ``params`` (the JAX net's ``params_`` as numpy
        arrays, or tensors; copied onto the net's device); then build
        fresh layer state and updater state."""
        for i, layer in enumerate(self.conf.layers):
            if getattr(layer, "nOut", None) and \
                    not getattr(layer, "nIn", True):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}): nIn not set and "
                    "not inferrable — set .nIn(...) on the layer or "
                    ".setInputType(...) on the configuration")
        if params is not None:
            self.params_ = _tree_map(
                lambda v: _to_tensor(v, self.device), dict(params))
        else:
            gen = torch.Generator().manual_seed(self._rngSeed)
            self.params_ = {}
            for i, layer in enumerate(self.conf.layers):
                p = layer.initParams(gen, self.conf.layerInputTypes[i],
                                     self._dtype, self.device)
                if p:
                    self.params_[str(i)] = p
        self.state_ = {
            str(i): layer.initState(self.conf.layerInputTypes[i],
                                    self._dtype, self.device)
            for i, layer in enumerate(self.conf.layers)
            if hasattr(layer, "initState")}
        self._initOptState()
        return self

    def _initOptState(self) -> None:
        self.optState_ = {
            li: {path: self._updaterFor(self.conf.layers[int(li)], pname)
                 .init(pval)
                 for path, pname, pval in _iter_leaf_params(lp)}
            for li, lp in self.params_.items()}

    def _updaterFor(self, layer, pname: str):
        return _updater_for(self.conf.globalConf, layer, pname)

    # ------------------------------------------------------------------
    # forward and loss
    # ------------------------------------------------------------------
    def _forward(self, params: Params, state, x, train: bool, gen,
                 mask=None, carries=None):
        """Run the stack; ``mask`` is the (b, t) feature/timestep mask,
        passed to the layers that take one (a ``producesMask`` layer
        replaces it); ``carries`` maps RNN layer index -> initial carry
        (missing = zeros, a fresh sequence).  Returns ``(out, new_state,
        new_carries)``: the state of each layer that returned one and the
        final carry of each RNN layer."""
        miniBatch = x.shape[0]
        new_state = {}
        new_carries = {}
        for i, layer in enumerate(self.conf.layers):
            if i in self.conf.preProcessors:
                x = self.conf.preProcessors[i].preProcess(x, miniBatch)
            p = params.get(str(i), {})
            st = state.get(str(i), {})
            if getattr(layer, "producesMask", False):
                mask = layer.computeMask(x, mask)
            if getattr(layer, "isRNN", False):
                c0 = (carries or {}).get(str(i))
                if c0 is None:
                    c0 = layer.initialCarry(x.shape[0], x.dtype, x.device)
                x, new_carries[str(i)] = layer.scanSeq(p, x, train, gen, c0,
                                                       mask)
                st2 = st
            elif getattr(layer, "acceptsMask", False):
                x, st2 = layer.forward(p, x, train, gen, st, mask=mask)
            else:
                x, st2 = layer.forward(p, x, train, gen, st)
            if st2:
                new_state[str(i)] = st2
        return x, new_state, new_carries

    def _regScore(self, params: Params):
        return _reg_penalty((layer, params[str(i)])
                            for i, layer in enumerate(self.conf.layers)
                            if str(i) in params)

    def _score_of(self, params: Params, x, y, fmask, lmask, train: bool,
                  gen=None, carries=None):
        """Mean per-example loss of the output layer (in f32 under bf16
        compute) plus the L1/L2 penalty of the f32 masters, the layers'
        new state and the RNN layers' final carries.  The state stays
        float32 under bf16 compute: the running statistics accumulate in
        it; carries pass through the compute cast as activations do."""
        out, new_state, new_carries = self._forward(
            self._cast_compute(params), self.state_, self._cast_compute(x),
            train, gen, fmask, self._cast_compute(carries))
        outLayer = self.conf.layers[-1]
        if not outLayer.hasLoss():
            raise ValueError("Last layer must be an output/loss layer to fit")
        if self._computeDtype != torch.float32:
            out = out.float()
        per_ex = outLayer.computeScore(y, out, lmask)
        return per_ex.mean() + self._regScore(params), new_state, new_carries

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1) -> None:
        """Train on a ``DataSet`` (one step), a ``DataSetIterator``
        (``epochs`` passes, one step per batch) or ``(features, labels)``
        (one step)."""
        if self.params_ is None:
            self.init()
        if isinstance(data, DataSet):
            self._fitBatch(data)
        elif isinstance(data, DataSetIterator):
            # a streaming source (file decode, CSV parse per record)
            # engages the producer pool and its staging ring onto the
            # net's device, as the reference's fit does; an in-memory
            # iterator passes through.  hostShard stays off: a bare fit
            # has no cross-process all-reduce, so every process sees the
            # whole stream
            from deeplearning4j_tpu_torch.datavec.pipeline import \
                maybe_prefetch
            it = maybe_prefetch(data, hostShard=False, device=self.device)
            try:
                for _ in range(epochs):
                    notifyListeners(self._listeners, "onEpochStart", self)
                    it.reset()
                    while it.hasNext():
                        self._fitBatch(it.next())
                    self.epochCount += 1
                    notifyListeners(self._listeners, "onEpochEnd", self)
            finally:
                if it is not data:
                    it.close()      # stops the pool, frees its slots
        elif labels is not None:
            self._fitBatch(DataSet(data, labels))
        else:
            raise TypeError(f"Cannot fit on {type(data)}")

    def _on_device(self, a, dtype=None):
        return _to_device(a, self.device, dtype)

    def _fitBatch(self, ds: DataSet) -> None:
        x = self._on_device(ds.features, self._dtype)
        y = self._on_device(ds.labels)
        fmask = self._on_device(ds.featuresMask)
        lmask = self._on_device(ds.labelsMask)
        self.lastBatchSize = int(x.shape[0])
        x, y, fmask, lmask = _local_rows(self, x, y, fmask, lmask)
        self._lastInput = x      # StatsListener's activations read it
        algo = str(self.conf.globalConf.get("optimizationAlgo")
                   or "STOCHASTIC_GRADIENT_DESCENT").upper()
        # TBPTT needs per-timestep (rank-3) labels; otherwise standard BP
        # (the reference's doTruncatedBPTT label-rank requirement).  The
        # iteration counts the batch once, whatever its number of chunks
        with train_step_span(self, self.lastBatchSize):
            if algo != "STOCHASTIC_GRADIENT_DESCENT":
                self._runSolverStep(x, y, fmask, lmask, algo)
            elif (self.conf.backpropType == BackpropType.TruncatedBPTT
                    and x.dim() == 3 and y.dim() == 3
                    and x.shape[2] > self.conf.tbpttFwdLength):
                self._fitTbptt(x, y, fmask, lmask)
            else:
                self._trainStep(x, y, fmask, lmask)
        self.iterationCount += 1
        if not in_microbatch():
            # OOM-retry halves share one logical iteration — the
            # supervisor fires iterationDone ONCE at the step boundary
            notifyListeners(self._listeners, "iterationDone", self,
                            self.iterationCount, self.epochCount)

    def _runSolverStep(self, x, y, fmask, lmask, algo: str) -> None:
        _check_solver_unsharded(self)
        _solver_step(self, algo, self._rngSeed ^ 0x5EED,
                     lambda p, gen, xb, yb, fm, lm: self._score_of(
                         p, xb, yb, fm, lm, True, gen)[0],
                     x, y, fmask, lmask)

    @property
    def _trainStep(self):
        """``_runTrainStep``, or its ``AotDispatch`` with the AOT cache
        configured (``compile.aotcache.train_step``)."""
        from deeplearning4j_tpu_torch.compile.aotcache import train_step
        return train_step(self)

    def _runTrainStep(self, x, y, fmask, lmask, carries=None):
        """One step of forward, loss, backward and updates from
        ``carries``; returns the RNN layers' final carries, detached."""
        units = [(str(i), layer) for i, layer in enumerate(self.conf.layers)]
        leaves, params = _detached_leaves(self.params_, _frozen_keys(units))
        loss, new_state, new_carries = self._score_of(
            params, x, y, fmask, lmask, True, self._fitGen, carries)
        grads = _grads_of(loss, leaves)
        with torch.no_grad():
            self.params_, self.optState_, loss = _step_updates(
                self, units, grads, loss, x.shape[0])
        self.state_.update(new_state)
        # left on the device: score() reads it, so a step never waits on
        # the host
        self._scoreArr = loss.detach()
        _panic_step(self)
        return _tree_map(lambda c: c.detach(), new_carries)

    def _fitTbptt(self, x, y, fmask, lmask) -> None:
        """Truncated BPTT: chunk the time axis, carry RNN state across
        chunks, detached (the reference truncates gradients at chunk
        edges).  Reference: ``MultiLayerNetwork.doTruncatedBPTT`` +
        ``rnnActivateUsingStoredState``; only the forward length is read."""
        t = x.shape[2]
        L = self.conf.tbpttFwdLength
        carries = self._zeroCarries(x.shape[0])
        for start in range(0, t, L):
            end = min(start + L, t)
            carries = self._trainStep(
                x[:, :, start:end], y[:, :, start:end],
                None if fmask is None else fmask[:, start:end],
                None if lmask is None else lmask[:, start:end], carries)

    def _zeroCarries(self, batch: int):
        """Fresh-sequence carries of every RNN layer, or None when the net
        has none."""
        out = {str(i): layer.initialCarry(batch, self._dtype, self.device)
               for i, layer in enumerate(self.conf.layers)
               if getattr(layer, "isRNN", False)}
        return out or None

    def output(self, x, train: bool = False, featuresMask=None) -> NDArray:
        """Inference-mode forward (as in the reference, ``train`` does not
        turn on dropout here): an ``NDArray`` of float32 on the net's
        device."""
        return NDArray(self._output(x, featuresMask))

    def _output(self, x, featuresMask=None) -> torch.Tensor:
        with torch.no_grad():
            xv = self._on_device(x, self._dtype)
            fm = None if featuresMask is None else \
                self._on_device(featuresMask)
            out, _, _ = self._forward(self._cast_compute(self.params_),
                                      self.state_, self._cast_compute(xv),
                                      False, None, fm)
        return out.float()

    def feedForward(self, x) -> List[NDArray]:
        """Every layer's activation (inference mode), the input first, each
        an ``NDArray``."""
        with torch.no_grad():
            cur = self._on_device(x, self._dtype)
            acts = [cur]
            for i, layer in enumerate(self.conf.layers):
                if i in self.conf.preProcessors:
                    cur = self.conf.preProcessors[i].preProcess(
                        cur, cur.shape[0])
                cur, _ = layer.forward(self.params_.get(str(i), {}), cur,
                                       False, None,
                                       self.state_.get(str(i), {}))
                acts.append(cur)
        return [NDArray(a) for a in acts]

    def predict(self, x) -> np.ndarray:
        """Class indices: the argmax over the class axis, which is axis 1
        of an RNN output (b, nOut, t), not the trailing time axis."""
        out = self._output(x)
        return out.argmax(dim=1 if out.dim() == 3 else -1).cpu().numpy()

    # ------------------------------------------------------------------
    # stateful RNN inference (reference: MultiLayerNetwork.rnnTimeStep /
    # rnnClearPreviousState / rnnGetPreviousState — the ``stateMap``)
    # ------------------------------------------------------------------
    def rnnTimeStep(self, x) -> NDArray:
        """Feed one or more timesteps, carrying hidden state across calls:
        a 2-D input (b, nIn) is one step and gives (b, nOut); a 3-D input
        (b, nIn, t) gives (b, nOut, t).  The state persists until
        ``rnnClearPreviousState``."""
        if any(type(layer).__name__ == "Bidirectional"
               for layer in self.conf.layers):
            # one step at a time cannot see the future the backward half
            # needs (the reference throws here too)
            raise ValueError(
                "rnnTimeStep is not supported for bidirectional networks")
        with torch.no_grad():
            xv = self._on_device(x, self._dtype)
            single = xv.dim() == 2
            if single:
                xv = xv[:, :, None]
            if self._rnnCarries is None:
                self._rnnCarries = self._zeroCarries(int(xv.shape[0]))
            out, _, self._rnnCarries = self._forward(
                self._cast_compute(self.params_), self.state_,
                self._cast_compute(xv), False, None, None,
                self._cast_compute(self._rnnCarries))
        out = out.float()
        return NDArray(out[:, :, -1] if single and out.dim() == 3 else out)

    def rnnClearPreviousState(self) -> None:
        self._rnnCarries = None

    def rnnGetPreviousState(self, layerIdx: int):
        if self._rnnCarries is None:
            return None
        return self._rnnCarries.get(str(layerIdx))

    def rnnSetPreviousState(self, layerIdx: int, state) -> None:
        if self._rnnCarries is None:
            self._rnnCarries = {}
        self._rnnCarries[str(layerIdx)] = state

    def pretrain(self, iterator, epochs: int = 1) -> None:
        """Layerwise unsupervised pretraining (reference:
        ``MultiLayerNetwork.pretrain(DataSetIterator)``): every layer with
        ``isPretrainLayer`` trains its own ``pretrainLoss`` on the
        activations feeding it, the layers upstream of it frozen and run
        at inference.  Each layer starts a fresh updater state from the
        global updater (``Sgd(1e-2)`` when none is set) and counts its own
        iterations; the step applies ``currentLr(it, 0)`` and no
        regularization, as the reference's does.  The layers' noise
        (corruption, ε) is drawn from the net's fit generator; the last
        step's loss becomes the score."""
        if self.params_ is None:
            self.init()
        updater = self.conf.globalConf.get("updater") or Sgd(1e-2)
        for li, layer in enumerate(self.conf.layers):
            if not getattr(layer, "isPretrainLayer", False):
                continue
            key = str(li)
            params = self.params_[key]
            opt = {n: updater.init(v) for n, v in params.items()}
            it_count = 0
            loss = None
            for _ in range(int(epochs)):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for ds in iterator:
                    with torch.no_grad():
                        h = self._pretrainInput(li, self._on_device(
                            ds.features, self._dtype))
                    p = {n: v.detach().requires_grad_(True)
                         for n, v in params.items()}
                    loss = layer.pretrainLoss(p, h, self._fitGen)
                    grads = torch.autograd.grad(loss, list(p.values()))
                    lr = updater.currentLr(it_count, 0)
                    with torch.no_grad():
                        new = {}
                        for (n, v), g in zip(params.items(), grads):
                            upd, opt[n] = updater.apply(g, opt[n], lr,
                                                        it_count, param=v)
                            new[n] = v - upd
                    params = new
                    it_count += 1
            self.params_[key] = params
            if loss is not None:
                self._scoreArr = loss.detach()

    def _pretrainInput(self, li: int, x):
        """The input of layer ``li``: the layers before it at inference,
        and the preprocessors up to and including its own."""
        for j in range(li):
            if j in self.conf.preProcessors:
                x = self.conf.preProcessors[j].preProcess(x, x.shape[0])
            x, _ = self.conf.layers[j].forward(
                self.params_.get(str(j), {}), x, False, None,
                self.state_.get(str(j), {}))
        if li in self.conf.preProcessors:
            x = self.conf.preProcessors[li].preProcess(x, x.shape[0])
        return x

    def score(self, ds: Optional[DataSet] = None) -> float:
        """The last fit step's loss, or the loss of ``ds`` (inference mode,
        L1/L2 penalty included)."""
        if ds is None:
            if self._scoreArr is not None:
                self._score = float(self._scoreArr)
                self._scoreArr = None
            return self._score
        with torch.no_grad():
            return float(self._score_of(
                self.params_, self._on_device(ds.features, self._dtype),
                self._on_device(ds.labels), self._on_device(ds.featuresMask),
                self._on_device(ds.labelsMask), False)[0])

    def evaluate(self, it: DataSetIterator, metric: str = "classification"):
        """Run ``it`` through ``output`` and accumulate an ``Evaluation``
        (``metric`` "regression": ``RegressionEvaluation``, "roc":
        ``ROC``); each batch's output is copied to the host once."""
        ev = {"classification": Evaluation, "regression": RegressionEvaluation,
              "roc": ROC}[metric]()
        it.reset()
        while it.hasNext():
            ds = it.next()
            out = self._output(ds.features, featuresMask=ds.featuresMask)
            ev.eval(ds.labels, out.cpu(), ds.labelsMask)
        it.reset()
        return ev

    def evaluateROC(self, it: DataSetIterator) -> ROC:
        return self.evaluate(it, metric="roc")

    def evaluateRegression(self, it: DataSetIterator) -> RegressionEvaluation:
        return self.evaluate(it, metric="regression")

    # -- listeners -------------------------------------------------------
    def setListeners(self, *listeners) -> None:
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        self._listeners = list(listeners)

    def addListeners(self, *listeners) -> None:
        self._listeners.extend(listeners)

    def getListeners(self) -> List:
        return self._listeners

    def removeListener(self, listener) -> None:
        if listener in self._listeners:
            self._listeners.remove(listener)

    # -- params ----------------------------------------------------------
    def _leaf_items(self):
        for i in range(len(self.conf.layers)):
            li = str(i)
            if li in self.params_:
                for path, _pname, v in _iter_leaf_params(self.params_[li]):
                    yield li, path, v

    def params(self) -> NDArray:
        """Single flattened param vector in the reference's order (layers
        in order; within a layer ``_param_key_order``)."""
        chunks = [v.reshape(-1) for _li, _path, v in self._leaf_items()]
        return NDArray(torch.cat(chunks) if chunks else
                       torch.zeros((0,), device=self.device))

    def setParams(self, flat) -> None:
        """Write a flat vector back into the param tree."""
        vec = _to_device(flat, self.device).reshape(-1)
        pos = 0
        for li, path, cur in list(self._leaf_items()):
            n = cur.numel()
            _set_leaf(self.params_[li], path,
                      vec[pos:pos + n].reshape(cur.shape).to(cur.dtype))
            pos += n
        if pos != vec.numel():
            raise ValueError(f"Param vector length {vec.numel()} != model "
                             f"{pos}")

    def numParams(self) -> int:
        if self.params_ is None:
            return 0
        return sum(v.numel() for v in _leaves(self.params_))

    def paramTable(self) -> Dict[str, NDArray]:
        """Each parameter as an ``NDArray`` over the net's own tensor (an
        in-place write through it reaches the net, as in ND4J)."""
        return {f"{li}_{path}": NDArray(v)
                for li, path, v in self._leaf_items()}

    def getParam(self, key: str) -> NDArray:
        """The parameter ``"<layer>_<path>"`` (``paramTable``'s keys)."""
        li, path = key.split("_", 1)
        return NDArray(_get_leaf(self.params_[li], path))

    def setParam(self, key: str, value) -> None:
        li, path = key.split("_", 1)
        cur = _get_leaf(self.params_[li], path)
        _set_leaf(self.params_[li], path,
                  _to_device(value, self.device, cur.dtype)
                  .reshape(cur.shape))

    # -- bookkeeping ----------------------------------------------------
    def getEpochCount(self) -> int:
        return self.epochCount

    def getIterationCount(self) -> int:
        return self.iterationCount

    def getLayerWiseConfigurations(self) -> MultiLayerConfiguration:
        return self.conf

    def getnLayers(self) -> int:
        return len(self.conf.layers)

    def clone(self) -> "MultiLayerNetwork":
        """A new net on the same device with copies of the parameters,
        layer state and updater state (not the counters, as in the
        reference)."""
        net = MultiLayerNetwork(self.conf, device=self.device)
        net.params_ = _clone_tree(self.params_)
        net.state_ = _clone_tree(self.state_)
        net.optState_ = _clone_tree(self.optState_)
        return net

    def summary(self) -> str:
        lines = [f"{'idx':<4} {'layer':<28} {'params':>10} {'in -> out'}"]
        total = 0
        for i, layer in enumerate(self.conf.layers):
            n = sum(v.numel() for _p, _k, v in
                    _iter_leaf_params((self.params_ or {}).get(str(i), {})))
            total += n
            it = self.conf.layerInputTypes[i]
            ot = layer.getOutputType(it) if it else None
            lines.append(f"{i:<4} {type(layer).__name__:<28} {n:>10} "
                         f"{it.getShape() if it else '?'} -> "
                         f"{ot.getShape() if ot else '?'}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
