"""ComputationGraph — the DAG model; the port of
``deeplearning4j_tpu/models/graph.py`` (the reference's
``ComputationGraph.java``: topological-order forward, every output layer's
loss, the per-iteration updater step, the flat param views).

One train step runs the forward over ``conf.topoOrder``, the summed losses
of the output layers, backward (``torch.autograd.grad``) and the updaters,
in eager PyTorch on the graph's device (``cuda`` unless the caller asks for
another), reusing the update step, the L1/L2 penalty and the param-tree
helpers of ``models/multilayer.py`` as the reference reuses its own.
Parameters and layer state (BatchNormalization's running statistics) are
dicts keyed by vertex name, as the JAX graph's ``params_``/``state_``, so
``init(params=)`` takes the JAX graph's parameters as numpy arrays.
``dataType`` BFLOAT16 / HALF / FLOAT16 means bf16 compute over float32
master parameters, state, optimizer state and losses.  Recurrent vertices
carry their state as in ``MultiLayerNetwork``: truncated BPTT passes each
chunk's final carries, detached, to the next, and ``rnnTimeStep`` keeps
them between calls.  Listeners, ``evaluate``, the line-search solvers and
frozen vertices, the step telemetry and the fault supervisor's
``setLrScale`` work as in ``MultiLayerNetwork``.  ``fit`` and
``score`` take a ``MultiDataSet`` (one array per input and per output, its
masks aligned with them) as well as a ``DataSet``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.models.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.models.multilayer import (
    _HALF_TYPES, _cast_tree, _check_solver_unsharded,
    _detached_leaves, _frozen_keys, _grads_of, _iter_leaf_params, _leaves,
    _local_rows, _panic_step, _reg_penalty, _set_leaf, _solver_step,
    _step_updates, _to_device, _to_tensor, _tree_map, _updater_for)
from deeplearning4j_tpu_torch.nn.conf import BackpropType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.ops.ndarray import NDArray
from deeplearning4j_tpu_torch.optimize.listeners import notifyListeners
from deeplearning4j_tpu_torch.telemetry.instrument import (in_microbatch,
                                                           train_step_span)

__all__ = ["ComputationGraph"]


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.params_: Optional[Dict] = None
        self.state_: Dict[str, Dict[str, torch.Tensor]] = {}
        self.optState_: Optional[Dict] = None
        self.iterationCount = 0
        self.epochCount = 0
        self.lastBatchSize = 0
        self._score = 0.0
        self._scoreArr = None   # the last step's loss, left on the device
        self._rngSeed = int(conf.globalConf.get("seed", 123) or 123)
        self._dtype = torch.float32
        dt = str(conf.globalConf.get("dataType") or "FLOAT").upper()
        self._computeDtype = torch.bfloat16 if dt in _HALF_TYPES \
            else torch.float32
        # input dropout draws from here (on the graph's device)
        self._fitGen = torch.Generator(device=self.device).manual_seed(
            self._rngSeed ^ 0x6EED)
        self._rnnCarries = None  # rnnTimeStep's stored state, by vertex
        self._listeners: List = []
        self._solver = None      # the line-search solver, once bound
        self._lrScale = 1.0      # FaultTolerantTrainer's divergence backoff
        self._batchSharding = None  # set by MeshTrainer (DP over a mesh)

    def setLrScale(self, scale: float) -> None:
        """See ``MultiLayerNetwork.setLrScale`` — the fault supervisor's
        rollback backoff."""
        self._lrScale = float(scale)

    def getLrScale(self) -> float:
        return self._lrScale

    def setBatchSharding(self, sharding) -> None:
        """See ``MultiLayerNetwork.setBatchSharding``: every input, label
        and mask array of a step is cut to this rank's rows."""
        self._batchSharding = sharding

    # ------------------------------------------------------------------
    def init(self, params: Optional[Dict] = None) -> "ComputationGraph":
        """Draw the parameters from a generator seeded with the config's
        seed, vertex by vertex in topological order, or take ``params``
        (the JAX graph's ``params_`` as numpy arrays, or tensors; copied
        onto the graph's device); then build fresh layer state (running
        mean 0, variance 1) and updater state."""
        order = self.conf.topoOrder
        if params is not None:
            self.params_ = _tree_map(
                lambda v: _to_tensor(v, self.device), dict(params))
        else:
            gen = torch.Generator().manual_seed(self._rngSeed)
            self.params_ = {}
            for name in order:
                node = self.conf.nodes[name][0]
                if isinstance(node, Layer):
                    p = node.initParams(
                        gen, self.conf.vertexInputTypes.get(name),
                        self._dtype, self.device)
                    if p:
                        self.params_[name] = p
        self.state_ = {
            name: self.conf.nodes[name][0].initState(
                self.conf.vertexInputTypes.get(name), self._dtype,
                self.device)
            for name in order
            if hasattr(self.conf.nodes[name][0], "initState")}
        self._initOptState()
        return self

    def _initOptState(self) -> None:
        self.optState_ = {
            name: {path: self._updaterFor(self.conf.nodes[name][0], pname)
                   .init(pval)
                   for path, pname, pval in _iter_leaf_params(lp)}
            for name, lp in self.params_.items()}

    def _updaterFor(self, layer, pname: str):
        return _updater_for(self.conf.globalConf, layer, pname)

    # ------------------------------------------------------------------
    def _forward(self, params, state, inputs: Sequence, train: bool, gen,
                 mask=None, carries=None):
        """Forward over the topological order (the reference's
        ``topologicalSortOrder()`` and per-vertex ``doForward``).  ``mask``
        is a tuple of per-input (b, t) masks aligned with ``conf.inputs``,
        or None; each vertex sees its first masked input's mask (a
        ``producesMask`` layer replaces it), and the mask stops where the
        output format leaves RNN.  ``carries`` maps RNN vertex name ->
        initial carry (missing = zeros, a fresh sequence).  Returns
        ``(activations by name, new state by name, final carries by
        name)``."""
        acts: Dict[str, torch.Tensor] = {}
        miniBatch = inputs[0].shape[0]
        mmap: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(self.conf.inputs):
            acts[name] = inputs[i]
            if mask is not None and i < len(mask):
                mmap[name] = mask[i]
        out_types = self.conf.vertexOutputTypes
        new_state: Dict[str, Dict] = {}
        new_carries: Dict = {}
        for name in self.conf.topoOrder:
            node, ins = self.conf.nodes[name]
            xs = [acts[i] for i in ins]
            m = next((mmap[i] for i in ins if mmap.get(i) is not None), None)
            if isinstance(node, Layer):
                x = xs[0]
                if name in self.conf.preProcessors:
                    x = self.conf.preProcessors[name].preProcess(x, miniBatch)
                p, st = params.get(name, {}), state.get(name, {})
                if getattr(node, "producesMask", False):
                    m = node.computeMask(x, m)
                    mmap[name] = m
                if getattr(node, "isRNN", False):
                    c0 = (carries or {}).get(name)
                    if c0 is None:
                        c0 = node.initialCarry(x.shape[0], x.dtype, x.device)
                    y, new_carries[name] = node.scanSeq(p, x, train, gen, c0,
                                                        m)
                    st2 = {}
                elif getattr(node, "acceptsMask", False):
                    y, st2 = node.forward(p, x, train, gen, st, mask=m)
                else:
                    y, st2 = node.forward(p, x, train, gen, st)
                if st2:
                    new_state[name] = st2
                acts[name] = y
            else:
                acts[name] = node.forward(*xs)
            ot = out_types.get(name)
            if m is not None and (ot is None or ot.kind == "RNN"):
                mmap[name] = m
        return acts, new_state, new_carries

    def _sumLosses(self, acts, labels, masks):
        """Every output layer's mean loss, summed — the loss of training
        and of ``score``; 0 for a graph whose outputs carry no loss (an
        embedding graph such as FaceNetNN4Small2, where a step then moves
        nothing but BatchNormalization's running statistics, as in the
        reference)."""
        total = torch.zeros((), device=self.device)
        for i, name in enumerate(self.conf.outputs):
            node = self.conf.nodes[name][0]
            if isinstance(node, Layer) and node.hasLoss():
                mask = masks[i] if masks is not None else None
                total = total + node.computeScore(labels[i], acts[name],
                                                  mask).mean()
        return total

    def _lossFn(self, params, inputs, labels, masks, train: bool, gen=None,
                fmask=None, carries=None):
        """Summed losses (in f32 under bf16 compute) plus the L1/L2 penalty
        of the f32 masters, the layers' new state and the RNN vertices'
        final carries.  The state stays float32: the running statistics
        accumulate in it; carries pass through the compute cast."""
        cd = self._computeDtype
        acts, new_state, new_carries = self._forward(
            _cast_tree(params, cd), self.state_,
            _cast_tree(tuple(inputs), cd), train, gen, fmask,
            _cast_tree(carries, cd))
        if self._computeDtype != torch.float32:
            acts = {n: a.float() for n, a in acts.items()}
        reg = _reg_penalty((self.conf.nodes[name][0], lp)
                           for name, lp in params.items())
        return (self._sumLosses(acts, labels, masks) + reg, new_state,
                new_carries)

    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1) -> None:
        """Train on a ``DataSet`` or ``MultiDataSet`` (one step), a
        ``DataSetIterator`` (``epochs`` passes, one step per batch) or
        ``(features, labels)`` (one step)."""
        if self.params_ is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            self._fitBatch(data)
        elif isinstance(data, DataSetIterator):
            for _ in range(epochs):
                notifyListeners(self._listeners, "onEpochStart", self)
                data.reset()
                while data.hasNext():
                    self._fitBatch(data.next())
                self.epochCount += 1
                notifyListeners(self._listeners, "onEpochEnd", self)
        elif labels is not None:
            self._fitBatch(DataSet(data, labels))
        else:
            raise TypeError(f"Cannot fit on {type(data)}")

    def _on_device(self, a, dtype=None):
        return _to_device(a, self.device, dtype)

    def _batch(self, ds):
        """``(inputs, labels, labels' masks, features' masks)`` of a
        ``DataSet`` or ``MultiDataSet`` on the graph's device, as tuples
        aligned with ``conf.inputs`` / ``conf.outputs`` (a masks tuple is
        None when the batch has none; a features' mask may be None inside
        it)."""
        dev = self._on_device
        if isinstance(ds, MultiDataSet):
            inputs = tuple(dev(f, self._dtype) for f in ds.features)
            labels = tuple(dev(l) for l in ds.labels)
            masks = tuple(dev(m) for m in ds.labelsMasks) \
                if ds.labelsMasks else None
            fmask = tuple(dev(m) for m in ds.featuresMasks) \
                if ds.featuresMasks else None
            return inputs, labels, masks, fmask
        masks = (dev(ds.labelsMask),) if ds.labelsMask is not None else None
        fmask = (dev(ds.featuresMask),) \
            if ds.featuresMask is not None else None
        return ((dev(ds.features, self._dtype),), (dev(ds.labels),), masks,
                fmask)

    def _fitBatch(self, ds) -> None:
        inputs, labels, masks, fmask = self._batch(ds)
        self.lastBatchSize = int(inputs[0].shape[0])
        if self._batchSharding is not None:
            inputs, labels, masks, fmask = (
                None if t is None else _local_rows(self, *t)
                for t in (inputs, labels, masks, fmask))
        algo = str(self.conf.globalConf.get("optimizationAlgo")
                   or "STOCHASTIC_GRADIENT_DESCENT").upper()
        # TBPTT needs per-timestep (rank-3) labels on every output (the
        # reference's ComputationGraph.doTruncatedBPTT); one iteration per
        # batch, whatever its number of chunks
        with train_step_span(self, self.lastBatchSize):
            if algo != "STOCHASTIC_GRADIENT_DESCENT":
                self._runSolverStep(inputs, labels, masks, fmask, algo)
            elif self.conf.backpropType == BackpropType.TruncatedBPTT \
                    and all(i.dim() == 3 for i in inputs) \
                    and all(l.dim() == 3 for l in labels) \
                    and inputs[0].shape[2] > self.conf.tbpttFwdLength:
                self._fitTbptt(inputs, labels, masks, fmask)
            else:
                self._trainStep(inputs, labels, masks, fmask)
        self.iterationCount += 1
        if not in_microbatch():
            notifyListeners(self._listeners, "iterationDone", self,
                            self.iterationCount, self.epochCount)

    def _runSolverStep(self, inputs, labels, masks, fmask, algo: str):
        _check_solver_unsharded(self)
        _solver_step(self, algo, self._rngSeed ^ 0x6EED,
                     lambda p, gen, ins, labs, mks, fm: self._lossFn(
                         p, ins, labs, mks, True, gen, fm)[0],
                     inputs, labels, masks, fmask)

    @property
    def _trainStep(self):
        """``_runTrainStep``, or its ``AotDispatch`` with the AOT cache
        configured (see ``MultiLayerNetwork._trainStep``)."""
        from deeplearning4j_tpu_torch.compile.aotcache import train_step
        return train_step(self)

    def _runTrainStep(self, inputs, labels, masks, fmask, carries=None):
        """One step of forward, losses, backward and updates from
        ``carries``; returns the RNN vertices' final carries, detached."""
        units = [(name, self.conf.nodes[name][0]) for name in self.params_]
        leaves, params = _detached_leaves(self.params_, _frozen_keys(units))
        loss, new_state, new_carries = self._lossFn(
            params, inputs, labels, masks, True, self._fitGen, fmask,
            carries)
        grads = _grads_of(loss, leaves)
        with torch.no_grad():
            self.params_, self.optState_, loss = _step_updates(
                self, units, grads, loss, inputs[0].shape[0])
        self.state_.update(new_state)
        # left on the device: score() reads it, so a step never waits on
        # the host
        self._scoreArr = loss.detach()
        _panic_step(self)
        return _tree_map(lambda c: c.detach(), new_carries)

    def _fitTbptt(self, inputs, labels, masks, fmask) -> None:
        """Truncated BPTT over the DAG: chunk the time axis of every input,
        label and mask, carry the RNN vertices' state, detached, across
        chunks.  Reference: ``ComputationGraph.doTruncatedBPTT``."""
        t = inputs[0].shape[2]
        L = self.conf.tbpttFwdLength
        carries = self._zeroCarries(int(inputs[0].shape[0]))
        for start in range(0, t, L):
            end = min(start + L, t)
            ic = tuple(x[:, :, start:end] for x in inputs)
            lc = tuple(y[:, :, start:end] for y in labels)
            mc = tuple(m[:, start:end] for m in masks) \
                if masks is not None else None
            fc = tuple(None if m is None else m[:, start:end]
                       for m in fmask) if fmask is not None else None
            carries = self._trainStep(ic, lc, mc, fc, carries)

    def _zeroCarries(self, batch: int):
        """Fresh-sequence carries of every RNN vertex, or None when the
        graph has none."""
        out = {name: self.conf.nodes[name][0].initialCarry(
                   batch, self._dtype, self.device)
               for name in self.conf.topoOrder
               if getattr(self.conf.nodes[name][0], "isRNN", False)}
        return out or None

    # ------------------------------------------------------------------
    def output(self, *inputs, featuresMask=None):
        """Inference-mode forward; each output an ``NDArray`` of float32 on
        the graph's device, one for one output, else a list."""
        res = self._output(*inputs, featuresMask=featuresMask)
        return NDArray(res) if isinstance(res, torch.Tensor) \
            else [NDArray(o) for o in res]

    def _output(self, *inputs, featuresMask=None):
        with torch.no_grad():
            xs = tuple(self._on_device(x, self._dtype) for x in inputs)
            fm = None
            if featuresMask is not None:
                if not isinstance(featuresMask, (tuple, list)):
                    featuresMask = (featuresMask,)
                fm = tuple(None if m is None else self._on_device(m)
                           for m in featuresMask)
            acts, _, _ = self._forward(
                _cast_tree(self.params_, self._computeDtype), self.state_,
                _cast_tree(xs, self._computeDtype), False, None, fm)
        res = [acts[n].float() for n in self.conf.outputs]
        return res[0] if len(res) == 1 else res

    def outputSingle(self, *inputs) -> NDArray:
        out = self.output(*inputs)
        return out[0] if isinstance(out, list) else out

    def score(self, ds=None) -> float:
        """The last fit step's loss, or the loss of the ``DataSet`` or
        ``MultiDataSet`` ``ds`` (inference mode, L1/L2 penalty included)."""
        if ds is None:
            if self._scoreArr is not None:
                self._score = float(self._scoreArr)
                self._scoreArr = None
            return self._score
        inputs, labels, masks, fmask = self._batch(ds)
        with torch.no_grad():
            loss, _, _ = self._lossFn(self.params_, inputs, labels, masks,
                                      False, None, fmask)
        return float(loss)

    # ------------------------------------------------------------------
    # stateful RNN inference (reference: ComputationGraph.rnnTimeStep /
    # rnnClearPreviousState / rnnGetPreviousState — the vertex stateMap)
    # ------------------------------------------------------------------
    def rnnTimeStep(self, *inputs):
        """Feed one or more timesteps, carrying the RNN vertices' state
        across calls: 2-D inputs (b, nIn) are one step and give (b, nOut);
        3-D inputs (b, nIn, t) give (b, nOut, t).  One tensor for one
        output, else a list."""
        if any(type(self.conf.nodes[n][0]).__name__ == "Bidirectional"
               for n in self.conf.topoOrder):
            # one step at a time cannot see the future the backward half
            # needs (the reference throws here too)
            raise ValueError("rnnTimeStep is not supported for "
                             "bidirectional networks")
        cd = self._computeDtype
        with torch.no_grad():
            xs = [self._on_device(x, self._dtype) for x in inputs]
            single = any(x.dim() == 2 for x in xs)
            xs = tuple(x[:, :, None] if x.dim() == 2 else x for x in xs)
            if self._rnnCarries is None:
                self._rnnCarries = self._zeroCarries(int(xs[0].shape[0]))
            acts, _, self._rnnCarries = self._forward(
                _cast_tree(self.params_, cd), self.state_,
                _cast_tree(xs, cd), False, None, None,
                _cast_tree(self._rnnCarries, cd))
        res = [acts[n].float() for n in self.conf.outputs]
        res = [NDArray(o[:, :, -1] if single and o.dim() == 3 else o)
               for o in res]
        return res[0] if len(res) == 1 else res

    def rnnClearPreviousState(self) -> None:
        self._rnnCarries = None

    def rnnGetPreviousState(self, vertexName: str):
        if self._rnnCarries is None:
            return None
        return self._rnnCarries.get(vertexName)

    def rnnSetPreviousState(self, vertexName: str, state) -> None:
        if self._rnnCarries is None:
            self._rnnCarries = {}
        self._rnnCarries[vertexName] = state

    def evaluate(self, it: DataSetIterator) -> Evaluation:
        """Run ``it`` through ``output`` (the first output) and accumulate
        an ``Evaluation``; one device-to-host copy per batch."""
        ev = Evaluation()
        it.reset()
        while it.hasNext():
            ds = it.next()
            out = self._output(ds.features, featuresMask=ds.featuresMask)
            if isinstance(out, list):
                out = out[0]
            ev.eval(ds.labels, out.cpu(), ds.labelsMask)
        it.reset()
        return ev

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
        for name in self.conf.topoOrder:
            if name in (self.params_ or {}):
                for path, _pname, v in _iter_leaf_params(self.params_[name]):
                    yield name, path, v

    def params(self) -> NDArray:
        """Single flattened param vector: vertices in topological order,
        within a vertex ``_param_key_order``."""
        chunks = [v.reshape(-1) for _n, _p, v in self._leaf_items()]
        return NDArray(torch.cat(chunks) if chunks else
                       torch.zeros((0,), device=self.device))

    def setParams(self, flat) -> None:
        """Write a flat vector back into the param tree."""
        vec = _to_device(flat, self.device).reshape(-1)
        pos = 0
        for name, path, cur in list(self._leaf_items()):
            n = cur.numel()
            _set_leaf(self.params_[name], path,
                      vec[pos:pos + n].reshape(cur.shape).to(cur.dtype))
            pos += n
        if pos != vec.numel():
            raise ValueError(f"Param vector length {vec.numel()} != model "
                             f"{pos}")

    def numParams(self) -> int:
        return sum(v.numel() for v in _leaves(self.params_ or {}))

    def paramTable(self) -> Dict[str, NDArray]:
        return {f"{name}_{k}": NDArray(v) if isinstance(v, torch.Tensor)
                else v
                for name, lp in self.params_.items() for k, v in lp.items()}

    def getEpochCount(self) -> int:
        return self.epochCount

    def getNumLayers(self) -> int:
        return sum(1 for n, _ in self.conf.nodes.values()
                   if isinstance(n, Layer))

    def summary(self) -> str:
        lines = [f"{'vertex':<24} {'type':<26} {'params':>10} inputs"]
        total = 0
        for name in self.conf.topoOrder:
            node, ins = self.conf.nodes[name]
            n = sum(v.numel() for _p, _k, v in
                    _iter_leaf_params((self.params_ or {}).get(name, {})))
            total += n
            lines.append(f"{name:<24} {type(node).__name__:<26} {n:>10} "
                         f"{ins}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
