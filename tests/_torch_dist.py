"""A world of ranks for the port's distributed tests, and what each rank
runs.

``World`` starts ``world`` child processes (``torch.multiprocessing``,
spawn) that join one ``gloo`` process group by ``file://`` rendezvous
under the test's directory (several pytest workers never fight over a TCP
port), each with one intra-op thread and a 60 s collective timeout.  Every
rank runs the named cases of this module in order and writes its results
(numpy arrays, or the traceback of a case that raised) to a file; the
parent joins with a deadline and kills what is left, so a hung collective
fails a test and never hangs the suite.

This module imports torch and the port only: a rank starts without JAX.
The builders take a package name, so the tests build the same nets from
the reference with them.
"""
import datetime
import hashlib
import importlib
import os
import pickle
import time
import traceback
from types import SimpleNamespace

import numpy as np

RANK_TIMEOUT_S = 60
PORT, REF = "deeplearning4j_tpu_torch", "deeplearning4j_tpu"


def pkg(name):
    """One package's DSL: conf, layers, learning, models, datasets,
    parallel, zoo."""
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")
    return SimpleNamespace(
        conf=m("nn.conf"), layers=m("nn.conf.layers"), learn=m("learning"),
        models=m("models"), ds=m("datasets"), parallel=m("parallel"),
        att=m("nn.conf.attention"), rec=m("nn.conf.recurrent"),
        zoo=m("zoo"))


# ---------------------------------------------------------------------------
# the nets, built alike in both packages
# ---------------------------------------------------------------------------

def mlp(p, device=None):
    """``tests/test_parallel.py``'s ``mlp()``: 8 -> 16 relu -> 4 softmax,
    Adam 0.01."""
    L = p.layers
    conf = (p.conf.NeuralNetConfiguration.builder().seed(3)
            .updater(p.learn.Adam(0.01)).list()
            .layer(L.DenseLayer.builder().nIn(8).nOut(16).activation("relu")
                   .build())
            .layer(L.OutputLayer.builder("mcxent").nOut(4)
                   .activation("softmax").build())
            .setInputType(p.conf.InputType.feedForward(8)).build())
    return _net(p, p.models.MultiLayerNetwork, conf, device)


def bn_cnn(p, device=None):
    """A small CNN with BatchNormalization: conv 3x3 -> BN (relu) -> max
    pool -> softmax over 3 classes, Nesterovs 0.1 (ResNet-50's updater)."""
    L = p.layers
    conf = (p.conf.NeuralNetConfiguration.builder().seed(7)
            .updater(p.learn.Nesterovs(learningRate=0.1, momentum=0.9)).list()
            .layer(L.ConvolutionLayer.builder().nOut(4).kernelSize(3, 3)
                   .hasBias(False).build())
            .layer(L.BatchNormalization.builder().activation("relu").build())
            .layer(L.SubsamplingLayer.builder().poolingType("MAX")
                   .kernelSize(2, 2).stride(2, 2).build())
            .layer(L.OutputLayer.builder("mcxent").nOut(3)
                   .activation("softmax").build())
            .setInputType(p.conf.InputType.convolutional(6, 6, 2)).build())
    return _net(p, p.models.MultiLayerNetwork, conf, device)


def attention_net(p, t, device=None):
    """``bench.py``'s long-context net at narrow widths: two
    SelfAttentionLayers (2 heads of 4) over 8 features, an mse head."""
    conf = (p.conf.NeuralNetConfiguration.builder().seed(5)
            .updater(p.learn.Adam(1e-2)).list()
            .layer(p.att.SelfAttentionLayer(nHeads=2, headSize=4, nOut=8))
            .layer(p.att.SelfAttentionLayer(nHeads=2, headSize=4, nOut=8))
            .layer(p.rec.RnnOutputLayer.builder("mse").nOut(3)
                   .activation("identity").build())
            .setInputType(p.conf.InputType.recurrent(8, t)).build())
    return _net(p, p.models.MultiLayerNetwork, conf, device)


def _net(p, cls, conf, device):
    return cls(conf) if device is None else cls(conf, device=device)


def toy(n=64, nin=8, nout=4, seed=0):
    """``tests/test_parallel.py``'s ``toy()``: labels from a fixed
    random projection."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, nin).astype(np.float32)
    w = np.random.RandomState(1).randn(nin, nout)
    return x, np.eye(nout, dtype=np.float32)[np.argmax(x @ w, axis=1)]


def numpy_tree(tree):
    """A params or state tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree.detach().cpu() if hasattr(tree, "detach")
                    else tree)


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

class World:
    """``world`` ranks running ``cases`` (names of ``case_*`` functions of
    this module) on the inputs pickled into ``tmp``; :meth:`results`
    joins them."""

    def __init__(self, world, tmp, cases, inputs):
        import torch.multiprocessing as mp
        self.tmp, self.world = str(tmp), world
        with open(os.path.join(self.tmp, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, self.tmp, list(cases)),
                                  daemon=True) for r in range(world)]
        for proc in self.procs:
            proc.start()
        self._results = None

    def results(self, timeout=240.0):
        """Every rank's ``{case: result}`` in rank order; raises if a rank
        died, or kills the ranks and raises at the deadline."""
        if self._results is not None:
            return self._results
        deadline = time.monotonic() + timeout
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5)
        if hung:
            raise RuntimeError(f"ranks {hung} did not finish in {timeout} s")
        out = []
        for r, proc in enumerate(self.procs):
            path = os.path.join(self.tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited {proc.exitcode} "
                                   "without its results")
            with open(path, "rb") as fh:
                out.append(pickle.load(fh))
        self._results = out
        return out

    def case(self, name):
        """Every rank's result of one case; a case that raised on a rank
        fails with that rank's traceback."""
        res = [r[name] for r in self.results()]
        for rank, r in enumerate(res):
            if isinstance(r, dict) and "__error__" in r:
                raise AssertionError(f"rank {rank}, case {name}:\n"
                                     + r["__error__"])
        return res


def _rank_main(rank, world, tmp, cases):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    out = {}
    try:
        for name in cases:
            t0 = time.perf_counter()
            try:
                out[name] = globals()[f"case_{name}"](
                    SimpleNamespace(rank=rank, world=world, tmp=tmp),
                    inputs.get(name))
            except Exception:
                out[name] = {"__error__": traceback.format_exc()}
            out.setdefault("__seconds__", {})[name] = \
                time.perf_counter() - t0
    finally:
        with open(os.path.join(tmp, f"rank{rank}.pkl.part"), "wb") as fh:
            pickle.dump(out, fh)
        os.replace(os.path.join(tmp, f"rank{rank}.pkl.part"),
                   os.path.join(tmp, f"rank{rank}.pkl"))
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the data-parallel world's cases (data 4)
# ---------------------------------------------------------------------------

def _port_fit(ctx, build, inp, epochs=1, zero=False, batch=-1):
    p = pkg(PORT)
    net = build(p, device="cpu").init(params=inp["params"])
    mesh = p.parallel.DeviceMesh(data=ctx.world)
    if zero:
        p.parallel.ZeroStage1(mesh).apply(net)
    it = p.ds.ListDataSetIterator([p.ds.DataSet(inp["x"], inp["y"])],
                                  batch=batch)
    p.parallel.ParallelWrapper(net, mesh=mesh).fit(it, epochs=epochs)
    return net


def case_mlp(ctx, inp):
    net = _port_fit(ctx, mlp, inp)
    return {"params": net.params().numpy(), "score": net.score()}


def case_zero(ctx, inp):
    """ZeRO-1 over the MLP's Adam state: the same step as case_mlp, each
    rank holding its quarter of every sharded moment."""
    net = _port_fit(ctx, mlp, inp, zero=True)
    shapes = {f"{k}/{path}": [tuple(t.shape) for t in _leaves(st)]
              for k, sub in net.optState_.items()
              for path, st in sub.items()}
    return {"params": net.params().numpy(), "score": net.score(),
            "opt_shapes": shapes,
            "param_shapes": {f"{k}/{n}": tuple(v.shape)
                             for k, lp in net.params_.items()
                             for n, v in lp.items()}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def case_bn(ctx, inp):
    net = _port_fit(ctx, bn_cnn, inp)
    return {"params": net.params().numpy(), "state": numpy_tree(net.state_),
            "score": net.score()}


def case_config5(ctx, inp):
    """BASELINE config 5: ResNet-50 through SharedTrainingMaster and
    SparkDl4jMultiLayer, one step of the global batch over data 4."""
    import pickle as pk
    p = pkg(PORT)
    with open(inp["params_file"], "rb") as fh:
        params = pk.load(fh)
    net = p.zoo.ResNet50(numClasses=4, inputShape=(3, 32, 32)).init(
        device="cpu")
    net.init(params=params)
    tm = (p.parallel.SharedTrainingMaster.Builder(
        p.parallel.VoidConfiguration()).batchSizePerWorker(4)
        .mesh(p.parallel.DeviceMesh(data=ctx.world)).build())
    spark = p.parallel.SparkDl4jMultiLayer(None, net, tm)
    spark.fit(p.ds.ListDataSetIterator([p.ds.DataSet(inp["x"], inp["y"])],
                                       batch=16), epochs=1)
    flat = net.params().numpy()
    state = numpy_tree(net.state_)
    out = {"digest": digest(flat), "score": net.score()}
    if ctx.rank == 0:
        out.update(params=flat, state=state)
    return out


def case_averaging(ctx, inp):
    """``tests/test_parallel2.py``'s ``ParameterAveragingTrainingMaster``
    body, every rank one worker."""
    p = pkg(PORT)
    L = p.layers
    conf = (p.conf.NeuralNetConfiguration.builder().seed(5)
            .updater(p.learn.Adam(1e-2)).list()
            .layer(L.DenseLayer.builder().nIn(4).nOut(8).activation("relu")
                   .build())
            .layer(L.OutputLayer.builder("mcxent").nIn(8).nOut(2)
                   .activation("softmax").build())
            .build())
    net = p.models.MultiLayerNetwork(conf, device="cpu").init()
    tm = (p.parallel.ParameterAveragingTrainingMaster.Builder()
          .batchSizePerWorker(16).averagingFrequency(5).build())
    rng = np.random.RandomState(1)
    cls = rng.randint(0, 2, 64)
    ds = p.ds.DataSet((rng.randn(64, 4) + 2 * cls[:, None]).astype(
        np.float32), np.eye(2, dtype=np.float32)[cls])
    s0 = net.score(ds)
    tm.fitMultiLayerNetwork(net, p.ds.ListDataSetIterator([ds], batch=64),
                            epochs=15)
    return {"s0": s0, "s1": net.score(ds),
            "digest": digest(net.params().numpy())}


def case_raises(ctx, inp):
    """What a world of four refuses: a mesh larger than the world, and
    the model and stage axes (A10b)."""
    p = pkg(PORT)
    par = p.parallel
    out = {}

    def msg(fn):
        try:
            fn()
        except Exception as e:        # the type and text are the result
            return f"{type(e).__name__}: {e}"
        return None
    out["larger"] = msg(lambda: par.DeviceMesh(data=8))
    out["model"] = msg(lambda: par.ShardingPlan(
        par.DeviceMesh(data=2, model=2)))
    out["stage"] = msg(lambda: par.MeshTrainer(
        mlp(p, device="cpu").init(), mesh=par.DeviceMesh(data=2, stage=2)))
    out["tp"] = msg(lambda: par.shard_params(
        par.DeviceMesh(data=2, model=2), {}, tensorParallel=True))
    m = par.DeviceMesh(data=ctx.world)
    out["coords"] = dict(m.coords)
    out["ids"] = m.deviceIds()
    out["transport"] = par.mesh.transport(m.group("data"))
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    out["rows"] = m.shardBatch(x)
    out["odd"] = msg(lambda: m.shardBatch(x[:6]))
    return out


def _plain(tree):
    """Spec trees with plain tuples at the leaves (``P`` is a tuple)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


def case_plan(ctx, inp):
    """The plan's placements and its collective estimate at data 4."""
    p = pkg(PORT)
    par = p.parallel
    net = mlp(p, device="cpu").init(params=inp["params"])
    mesh = par.DeviceMesh(data=ctx.world)
    out = {"axis_sizes": par.ShardingPlan(mesh).axis_sizes(),
           "batch": tuple(par.ShardingPlan(mesh).batch_sharding().spec)}
    for tag, zero1 in (("dp", False), ("zero", True)):
        plan = par.ShardingPlan(mesh, zero1=zero1)
        out[f"{tag}_bytes"] = plan.collective_bytes_per_step(net)
        out[f"{tag}_opt"] = _plain(plan.opt_shardings(net))
    return out


def case_inference(ctx, inp):
    """ParallelInference over the data axis: each rank its rows, the
    outputs all-gathered; BATCHED over several data ranks refuses."""
    p = pkg(PORT)
    par = p.parallel
    net = mlp(p, device="cpu").init(params=inp["params"])
    mesh = par.DeviceMesh(data=ctx.world)
    pi = par.ParallelInference(net, mesh=mesh,
                               inferenceMode=par.InferenceMode.SEQUENTIAL)
    out = {"out": pi.output(inp["x"][:16]).numpy()}
    try:
        par.ParallelInference(net, mesh=mesh)
        out["batched"] = None
    except ValueError as e:
        out["batched"] = f"ValueError: {e}"
    return out


# ---------------------------------------------------------------------------
# the sequence-parallel world's cases (data 2 x seq 2)
# ---------------------------------------------------------------------------

CP_VARIANTS = [(c, m) for c in (False, True) for m in (False, True)]


def _counting(monkeypatch_targets):
    """Wrap the ring's per-block kernel entry points with call counters:
    ``(counts, undo)``."""
    from deeplearning4j_tpu_torch.parallel import ring
    counts = {name: 0 for name in monkeypatch_targets}
    saved = {name: getattr(ring, name) for name in monkeypatch_targets}

    def wrap(name):
        fn = saved[name]

        def counted(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return counted
    for name in monkeypatch_targets:
        setattr(ring, name, wrap(name))

    def undo():
        for name, fn in saved.items():
            setattr(ring, name, fn)
    return counts, undo


BLOCK_FNS = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")


def case_cp(ctx, inp):
    """context_parallel_attention over (data 2, seq 2), causal and not,
    masked and not: this rank's rows of the outputs and of dq/dk/dv, and
    how many times each block ran the flash entry points."""
    import torch
    p = pkg(PORT)
    mesh = p.parallel.DeviceMesh(data=2, seq=2)
    out = {"coords": dict(mesh.coords)}
    for causal, masked in CP_VARIANTS:
        q, k, v, w = (torch.from_numpy(mesh.shardBatch(inp[n])).clone()
                      .requires_grad_(n != "w") for n in "qkvw")
        mask = torch.from_numpy(mesh.shardBatch(inp["mask"])) \
            if masked else None
        counts, undo = _counting(BLOCK_FNS)
        try:
            o = p.parallel.context_parallel_attention(mesh, q, k, v,
                                                      mask=mask,
                                                      causal=causal)
            (o * w).sum().backward()
        finally:
            undo()
        out[(causal, masked)] = {
            "out": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(), "calls": counts}
    return out


def case_ring(ctx, inp):
    """ring_attention on the seq group: this rank's time chunk of q, k, v
    in, its chunk of the causal output out."""
    import torch
    p = pkg(PORT)
    mesh = p.parallel.DeviceMesh(data=2, seq=2)
    t = inp["q"].shape[2] // 2
    s = mesh.coords["seq"]
    q, k, v = (torch.from_numpy(mesh.shardBatch(inp[n])[:, :, s * t:
                                                        (s + 1) * t])
               for n in "qkv")
    o = p.parallel.ring_attention(q, k, v, causal=True,
                                  group=mesh.group("seq"))
    return {"out": o.numpy(), "coords": dict(mesh.coords)}


def case_seq_net(ctx, inp):
    """The SelfAttentionLayer net's step under ParallelWrapper over (data
    2, seq 2): its attention layers route to ring attention."""
    p = pkg(PORT)
    net = attention_net(p, inp["x"].shape[2], device="cpu").init(
        params=inp["params"])
    mesh = p.parallel.DeviceMesh(data=2, seq=2)
    counts, undo = _counting(BLOCK_FNS)
    try:
        p.parallel.ParallelWrapper(net, mesh=mesh).fit(
            p.ds.ListDataSetIterator([p.ds.DataSet(inp["x"], inp["y"])]),
            epochs=1)
    finally:
        undo()
    return {"params": net.params().numpy(), "score": net.score(),
            "calls": counts}
