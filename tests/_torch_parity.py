"""The parity harness the port's tests share: one config DSL per package
(``_Pkg``), the models the slices are held on, built the same way in
both packages, and the helpers that fit a JAX net and a port net side by
side from copied parameters.

- ``_conf`` / ``_nets`` / ``_fit_both``: ``bench.py``'s long-context
  attention net at small widths (the training slice);
- ``_narrow`` / ``_flat_state``: a narrow ResNet built as ``ResNet50``
  builds ResNet-50 (the ResNet slice);
- ``_char_conf``: the GravesLSTM char-RNN of
  ``examples/lstm_charmodelling.py`` (the recurrent slice);
- ``_bert_pair`` / ``_bert_batches``: BERT on SameDiff at small widths and
  ``bench.py``'s seeded MLM batches (the BERT slice);
- ``_layer_parity`` / ``_loss_parity`` / ``_json_round_trip``: one layer
  through both packages (the layers of the zoo slice);
- ``_zoo_conf`` / ``_carried`` / ``_yolo_labels``: zoo configurations,
  zoo nets carrying the same parameters, DL4J-format YOLO labels.

The reference's parameters of any layer, the 3-D ``KerasMultiHeadAttention``
kernels and the VAE's ``We{i}`` / ``Wd{i}`` among them, cross into the
port through ``init(params=)`` (``MultiLayerNetwork``,
``ComputationGraph``) as numpy arrays of their own shapes.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.models as jmodels
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu_torch.datasets as tds
import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.models as tmodels
import deeplearning4j_tpu_torch.nn.conf as tconf
from deeplearning4j_tpu.models import graph_conf as jgc
from deeplearning4j_tpu.nn.conf import attention as jatt
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import misc as jmisc
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu.zoo.bert import Bert as JBert
from deeplearning4j_tpu.zoo.bert import BertConfig as JBertConfig
from deeplearning4j_tpu_torch.models import graph_conf as tgc
from deeplearning4j_tpu_torch.nn.conf import attention as tatt
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import misc as tmisc
from deeplearning4j_tpu_torch.nn.conf import recurrent as trec
from deeplearning4j_tpu_torch.zoo.bert import Bert, BertConfig


class _Pkg:
    """One package's config DSL, in the names the builders need."""

    def __init__(self, conf, learn, att, rec, layers, models, ds, gc, misc):
        self.conf, self.learn, self.att, self.rec = conf, learn, att, rec
        self.layers, self.models, self.ds = layers, models, ds
        self.gc, self.misc = gc, misc


JAX = _Pkg(jconf, jlearn, jatt, jrec, jlayers, jmodels, jds, jgc, jmisc)
PORT = _Pkg(tconf, tlearn, tatt, trec, tlayers, tmodels, tds, tgc, tmisc)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fit_both(jnet, net, batches, steps):
    """Fit both nets on the (features, labels) batches in turn; returns
    the two loss curves as rows of (JAX, port)."""
    curve = []
    for s in range(steps):
        f, l = batches[s % len(batches)]
        jnet.fit(JAX.ds.DataSet(f, l))
        net.fit(PORT.ds.DataSet(f, l))
        curve.append((jnet.score(), net.score()))
    return np.array(curve)


# ---------------------------------------------------------------------------
# the long-context attention net (bench.py bench_long_context)
# ---------------------------------------------------------------------------

NIN, HEADS, HEAD, NOUT, T, B = 16, 2, 8, 4, 32, 3
LR = 1e-3


def _conf(pkg, dataType="FLOAT", updater=None, t=T, **layer_kw):
    """The slice's model (bench.py bench_long_context) at small widths."""
    updater = updater(pkg) if updater else pkg.learn.Adam(LR)
    return (pkg.conf.NeuralNetConfiguration.builder().seed(5)
            .updater(updater).dataType(dataType).list()
            .layer(pkg.att.SelfAttentionLayer(nHeads=HEADS, headSize=HEAD,
                                              nOut=NIN, **layer_kw))
            .layer(pkg.att.SelfAttentionLayer(nHeads=HEADS, headSize=HEAD,
                                              nOut=NIN, **layer_kw))
            .layer(pkg.rec.RnnOutputLayer.builder("mse").nOut(NOUT)
                   .activation("identity").build())
            .setInputType(pkg.conf.InputType.recurrent(NIN, t)).build())


def _nets(params0, dataType="FLOAT"):
    """(JAX net, port net on the CPU), both from copies of ``params0``."""
    jnet = JAX.models.MultiLayerNetwork(_conf(JAX, dataType)).init(
        params=jax.tree.map(np.array, params0))
    net = PORT.models.MultiLayerNetwork(_conf(PORT, dataType),
                                        device="cpu").init(params=params0)
    return jnet, net


# ---------------------------------------------------------------------------
# a narrow ResNet
# ---------------------------------------------------------------------------

NARROW_BATCH, NARROW_CLASSES = 4, 5


def _narrow(pkg, dataType):
    """Built as ``ResNet50.graphBuilder`` builds ResNet-50 (the same
    conv_bn and bottleneck blocks, SAME 7x7/2 stem and 3x3/2 max-pool,
    Nesterovs(0.1, 0.9), RELU init), at widths 4-8 over a 16x16 input: a
    downsampling bottleneck per stage, and an identity bottleneck."""
    L = pkg.layers
    gb = (pkg.conf.NeuralNetConfiguration.builder().seed(3)
          .updater(pkg.learn.Nesterovs(0.1, momentum=0.9))
          .weightInit("RELU").dataType(dataType).graphBuilder())
    gb.addInputs("input").setInputTypes(
        pkg.conf.InputType.convolutional(16, 16, 3))

    def conv_bn(name, inp, nOut, k, s, act="relu"):
        gb.addLayer(name + "_conv", L.ConvolutionLayer.builder().nOut(nOut)
                    .kernelSize(k, k).stride(s, s).convolutionMode("Same")
                    .hasBias(False).build(), inp)
        gb.addLayer(name + "_bn", L.BatchNormalization.builder()
                    .activation(act).build(), name + "_conv")
        return name + "_bn"

    def bottleneck(name, inp, nOut, stride, down):
        x = conv_bn(name + "_a", inp, nOut, 1, stride)
        x = conv_bn(name + "_b", x, nOut, 3, 1)
        x = conv_bn(name + "_c", x, nOut * 4, 1, 1, act="identity")
        sc = conv_bn(name + "_sc", inp, nOut * 4, 1, stride,
                     act="identity") if down else inp
        gb.addVertex(name + "_add", pkg.gc.ElementWiseVertex("Add"), x, sc)
        gb.addLayer(name + "_relu", L.ActivationLayer.builder()
                    .activation("relu").build(), name + "_add")
        return name + "_relu"

    x = conv_bn("stem", "input", 8, 7, 2)
    gb.addLayer("stem_pool", L.SubsamplingLayer.builder().poolingType("MAX")
                .kernelSize(3, 3).stride(2, 2).convolutionMode("Same")
                .build(), x)
    x = "stem_pool"
    for si, (n, reps, s) in enumerate([(4, 2, 1), (8, 1, 2)]):
        for r in range(reps):
            x = bottleneck(f"res{si}_{r}", x, n, s if r == 0 else 1, r == 0)
    gb.addLayer("avgpool", L.GlobalPoolingLayer.builder().poolingType("AVG")
                .build(), x)
    gb.addLayer("fc", L.OutputLayer.builder("negativeloglikelihood")
                .nOut(NARROW_CLASSES).activation("softmax").build(),
                "avgpool")
    gb.setOutputs("fc")
    return gb.build()


def _flat_state(net):
    """(BN running statistics, Nesterovs momentum buffers) of a graph of
    either package, each flattened in sorted key order."""
    st = np.concatenate([_np(net.state_[k][q]).ravel()
                         for k in sorted(net.state_) for q in ("mean", "var")])
    v = np.concatenate([_np(net.optState_[k][p]["v"]).ravel()
                        for k in sorted(net.optState_)
                        for p in sorted(net.optState_[k])])
    return st, v


# ---------------------------------------------------------------------------
# the GravesLSTM char-RNN (examples/lstm_charmodelling.py)
# ---------------------------------------------------------------------------

#: the example's corpus (examples/lstm_charmodelling.py ``_TEXT``)
CHAR_TEXT = ("to be or not to be that is the question "
             "whether tis nobler in the mind to suffer "
             "the slings and arrows of outrageous fortune ") * 40


def _char_conf(pkg, nChars, hidden=96, tbptt=25, l2=None, dataType="FLOAT"):
    """The example's net: 2 x GravesLSTM(hidden, tanh), RnnOutputLayer
    mcxent softmax, Adam(5e-3), XAVIER, seed 12345, truncated BPTT."""
    g = (pkg.conf.NeuralNetConfiguration.builder().seed(12345)
         .updater(pkg.learn.Adam(5e-3)).weightInit("XAVIER")
         .dataType(dataType))
    if l2:
        g = g.l2(l2)
    G = pkg.rec.GravesLSTM
    return (g.list()
            .layer(G.builder().nIn(nChars).nOut(hidden).activation("tanh")
                   .build())
            .layer(G.builder().nIn(hidden).nOut(hidden).activation("tanh")
                   .build())
            .layer(pkg.rec.RnnOutputLayer.builder("mcxent").nIn(hidden)
                   .nOut(nChars).activation("softmax").build())
            .backpropType(pkg.conf.BackpropType.TruncatedBPTT)
            .tBPTTForwardLength(tbptt).tBPTTBackwardLength(tbptt).build())


# ---------------------------------------------------------------------------
# BERT on SameDiff (zoo/bert.py, examples/bert_finetune.py)
# ---------------------------------------------------------------------------

#: examples/bert_finetune.py's corpus (``_CORPUS``)
BERT_CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a deep learning framework compiles graphs for the tpu",
    "attention layers weigh tokens by learned similarity",
    "masked language modelling predicts hidden words",
] * 16

#: a small BERT: every piece of BertBase at narrow widths
BERT_SMALL = dict(vocabSize=97, hiddenSize=32, numLayers=2, numHeads=4,
                  intermediateSize=64, maxSeqLength=16)


def _bert_pair(task="mlm", **kw):
    """(JAX Bert, port Bert on the CPU) from one config: the same seeded
    RandomState draws, so the same initial variables."""
    cfg = dict(BERT_SMALL, task=task, **kw)
    return JBert(JBertConfig(**cfg)), Bert(BertConfig(**cfg), device="cpu")


def _bert_batches(pkg, n, batch, seq, vocab, seed=0):
    """``bench.py`` ``bench_bert``'s seeded MultiDataSets (token ids and
    labels from ``RandomState(seed)``, zero segments, an all-ones feature
    mask, a 15 % label mask) at the given size, except that the first
    row's last quarter is masked out of attention."""
    rng = np.random.RandomState(seed)
    pool = []
    for _ in range(n):
        toks = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
        segs = np.zeros((batch, seq), np.int32)
        mask = np.ones((batch, seq), np.float32)
        mask[0, -seq // 4:] = 0.0
        labels = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
        lmask = (rng.rand(batch, seq) < 0.15).astype(np.float32)
        pool.append(pkg.ds.MultiDataSet(features=[toks, segs, mask],
                                        labels=[labels, lmask]))
    return pool


# ---------------------------------------------------------------------------
# one layer through both packages (the layer slices' tests)
# ---------------------------------------------------------------------------

def _layer_parity(jl, tl, params, x, state=None, train=False, mask=None,
                  grad=True, atol=1e-5, rtol=1e-5, seed=0):
    """``jl.forward`` against ``tl.forward`` on the same numpy ``params``,
    input ``x`` (and ``state`` / ``mask``), then the gradients of
    sum(output · R), R a seeded random array, with respect to every
    parameter and to a floating-point ``x`` (``jax.grad`` against
    autograd).  The reference runs under one ``jax.jit`` (a compile per
    case instead of one per op).  Returns (port output, reference
    output)."""
    state = state or {}
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}
    floating = np.issubdtype(np.asarray(x).dtype, np.floating)
    tx = torch.tensor(x, requires_grad=grad and floating)
    jkw = {} if mask is None else {"mask": jax.numpy.asarray(mask)}
    tkw = {} if mask is None else {"mask": torch.tensor(mask)}
    jst = {k: jax.numpy.asarray(v) for k, v in state.items()}
    tst = {k: torch.tensor(v) for k, v in state.items()}
    jx = jax.numpy.asarray(x)

    def fwd(p, xx):
        return jl.forward(p, xx, train, None, jst, **jkw)[0]

    shape = jax.eval_shape(fwd, jp, jx)
    r = np.random.RandomState(seed).randn(*shape.shape).astype(shape.dtype)
    argnums = (0, 1) if floating else (0,)

    def ref_and_grads(p, xx):
        gs = jax.grad(lambda p, xx: jax.numpy.sum(fwd(p, xx) * r),
                      argnums=argnums)(p, xx) if grad else None
        return fwd(p, xx), gs

    ref, gs = jax.jit(ref_and_grads)(jp, jx)
    ref = np.asarray(ref)
    out, _ = tl.forward(tp, tx, train, None, tst, **tkw)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=atol,
                               rtol=rtol)
    if grad:
        (out * torch.from_numpy(r)).sum().backward()
        for k in params:
            # a parameter the forward does not reach (an autoencoder's
            # decoder) gets jax.grad's zeros
            g = tp[k].grad if tp[k].grad is not None else \
                torch.zeros_like(tp[k])
            np.testing.assert_allclose(g.numpy(), np.asarray(gs[0][k]),
                                       atol=atol, rtol=rtol,
                                       err_msg=f"d/d{k}")
        if floating:
            # no path to the input (ids read as integers) is a zero gradient
            gx = tx.grad if tx.grad is not None else torch.zeros_like(tx)
            np.testing.assert_allclose(gx.numpy(), np.asarray(gs[1]),
                                       atol=atol, rtol=rtol,
                                       err_msg="d/dx")
    return out.detach(), ref


def _loss_parity(jl, tl, labels, output, mask=None, atol=1e-5, rtol=1e-5):
    """``computeScore`` of both layers (per example) on the same labels,
    output and mask, and its mean's gradient with respect to the output
    (the reference under one ``jax.jit``).  Returns (port scores,
    reference scores)."""
    jm = None if mask is None else jax.numpy.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    jlab = jax.numpy.asarray(labels)

    def ref_and_grad(o):
        score = lambda o: jl.computeScore(jlab, o, jm)  # noqa: E731
        return score(o), jax.grad(lambda o: jax.numpy.mean(score(o)))(o)

    ref, g = jax.jit(ref_and_grad)(jax.numpy.asarray(output))
    to = torch.tensor(output, requires_grad=True)
    got = tl.computeScore(torch.tensor(labels), to, tm)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)
    got.mean().backward()
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(g), atol=atol,
                               rtol=rtol, err_msg="d/doutput")
    return got.detach(), np.asarray(ref)


def _json_round_trip(jlayer):
    """The reference layer's JSON read by the port's ``layer_from_json``
    and written back: (port layer, reference JSON text, port JSON text)."""
    import json
    ref = json.dumps(jlayer.toJson(), default=str)
    layer = tlayers.layer_from_json(json.loads(ref))
    return layer, ref, json.dumps(layer.toJson(), default=str)


# ---------------------------------------------------------------------------
# the zoo (the zoo slice's tests)
# ---------------------------------------------------------------------------

def _zoo_conf(model, monkeypatch):
    """A zoo model's configuration, built as its ``init`` builds it; for a
    MultiLayerNetwork, ``init`` is stubbed for the call, so nothing is
    drawn."""
    if hasattr(model, "graphBuilder"):
        return model.graphBuilder().build()
    torch_side = type(model).__module__.startswith("deeplearning4j_tpu_torch")
    mln = tmodels.MultiLayerNetwork if torch_side else \
        jmodels.MultiLayerNetwork
    with monkeypatch.context() as m:
        m.setattr(mln, "init", lambda self, *a, **k: self)
        return model.init(**({"device": "cpu"} if torch_side else {})).conf


def _carried(name, kw):
    """(port zoo net on the CPU, the reference's) from the port's drawn
    parameters, carried by ``init(params=)``."""
    import deeplearning4j_tpu.zoo as jz
    import deeplearning4j_tpu_torch.zoo as tz
    net = getattr(tz, name)(**kw).init(device="cpu")
    model = getattr(jz, name)(**kw)
    jmodel = jmodels.ComputationGraph if hasattr(model, "graphBuilder") \
        else jmodels.MultiLayerNetwork
    jnet = jmodel(_zoo_conf(model, pytest.MonkeyPatch()))
    jnet.init(params=jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                                  net.params_))
    return net, jnet


def _yolo_labels(rng, b, nC, grid):
    """DL4J's YOLO labels (b, 4 + nC, g, g): one or two boxes an image in
    grid units, [x1, y1, x2, y2] and a one-hot class; zero elsewhere."""
    lab = np.zeros((b, 4 + nC, grid, grid), np.float32)
    for e in range(b):
        for _ in range(1 + e % 2):
            i, j = rng.randint(0, grid, 2)
            cx, cy = j + rng.rand(), i + rng.rand()
            w, h = 0.3 + rng.rand() * 1.5, 0.3 + rng.rand() * 1.5
            lab[e, 0:4, i, j] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2)
            lab[e, 4:, i, j] = 0.0
            lab[e, 4 + rng.randint(0, nC), i, j] = 1.0
    return lab


def _narrow_yolo2(pkg, numClasses=3, size=32):
    """Built as ``YOLO2.graphBuilder`` builds YOLO2 (the same conv-BN
    leaky-ReLU blocks, pools, the 26x26-equivalent passthrough through
    ``SpaceToDepthLayer(2)`` and ``MergeVertex``, the 1x1 head and
    ``Yolo2OutputLayer`` with the five COCO priors), at a 16th of its
    widths over a ``size`` x ``size`` input."""
    L = pkg.layers
    from importlib import import_module
    conv = import_module(pkg.layers.__name__.rsplit(".", 1)[0]
                         + ".convolutional")
    gb = (pkg.conf.NeuralNetConfiguration.builder().seed(4)
          .updater(pkg.learn.Adam(1e-3)).weightInit("RELU")
          .convolutionMode("Same").graphBuilder())
    gb.addInputs("input").setInputTypes(
        pkg.conf.InputType.convolutional(size, size, 3))

    def conv_bn(name, inp, n, k):
        gb.addLayer(name, L.ConvolutionLayer.builder().nOut(n)
                    .kernelSize(k, k).hasBias(False).build(), inp)
        gb.addLayer(name + "_bn", L.BatchNormalization.builder()
                    .activation("leakyrelu").build(), name)
        return name + "_bn"

    def pool(name, inp):
        gb.addLayer(name, L.SubsamplingLayer.builder().poolingType("MAX")
                    .kernelSize(2, 2).stride(2, 2).build(), inp)
        return name

    x = pool("p1", conv_bn("c1", "input", 2, 3))
    x = pool("p2", conv_bn("c2", x, 4, 3))
    x = pool("p3", conv_bn("c5", conv_bn("c4", conv_bn("c3", x, 8, 3), 4,
                                           1), 8, 3))
    route = conv_bn("c13", conv_bn("c9", x, 32, 3), 32, 3)
    x = conv_bn("c20", conv_bn("c14", pool("p5", route), 64, 3), 64, 3)
    r = conv_bn("route_r", route, 4, 1)
    gb.addLayer("reorg", conv.SpaceToDepthLayer.builder().blockSize(2)
                .build(), r)
    gb.addVertex("concat", pkg.gc.MergeVertex(), "reorg", x)
    x = conv_bn("c21", "concat", 64, 3)
    gb.addLayer("pred", L.ConvolutionLayer.builder()
                .nOut(5 * (5 + numClasses)).kernelSize(1, 1).build(), x)
    gb.addLayer("yolo", conv.Yolo2OutputLayer.builder().boundingBoxes(
        np.asarray(((0.57273, 0.677385), (1.87446, 2.06253),
                    (3.33843, 5.47434), (7.88282, 3.52778),
                    (9.77052, 9.16828)))).build(), "pred")
    gb.setOutputs("yolo")
    return gb.build()


# ---------------------------------------------------------------------------
# the reference's own test bodies against the port (the DataVec slice)
# ---------------------------------------------------------------------------

def _reference_tests(filename, exclude=()):
    """The test functions and methods of the reference's ``tests/<filename>``
    with every ``deeplearning4j_tpu`` import swapped for the port's: a
    module built from the reference's source (registered in
    ``sys.modules``, so the factories its pool tests pickle can be found
    by a worker) and a list of ``(id, callable)``, one a test, for
    ``pytest.mark.parametrize``.  ``exclude`` names tests (``Class`` or
    ``Class.method`` or ``function``) left out, each for a reason its
    caller states."""
    import inspect
    import sys
    import types
    from pathlib import Path
    src = (Path(__file__).resolve().parent / filename).read_text()
    src = src.replace("deeplearning4j_tpu.", "deeplearning4j_tpu_torch.") \
        .replace("from deeplearning4j_tpu import",
                 "from deeplearning4j_tpu_torch import")
    name = "_port_" + filename[:-3]
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        mod.__file__ = str(Path(__file__).resolve().parent / filename)
        sys.modules[name] = mod
        exec(compile(src, f"<port {filename}>", "exec"), mod.__dict__)
    cases = []
    for key, obj in vars(mod).items():
        if key.startswith("test_") and inspect.isfunction(obj) \
                and key not in exclude:
            cases.append((key, obj))
        elif key.startswith("Test") and inspect.isclass(obj) \
                and key not in exclude:
            for m in sorted(vars(obj)):
                if m.startswith("test_") and f"{key}.{m}" not in exclude:
                    cases.append((f"{key}.{m}", (obj, m)))
    return mod, cases


def _cpu_default(monkeypatch):
    """For a reference test body that names no device (the SameDiff
    slice's): every port module's ``resolve_device`` defaults to the CPU
    for the test."""
    import sys
    import deeplearning4j_tpu_torch as port
    orig = port.resolve_device
    for name, mod in list(sys.modules.items()):
        if name.startswith("deeplearning4j_tpu_torch") and \
                getattr(mod, "resolve_device", None) is orig:
            monkeypatch.setattr(mod, "resolve_device",
                                lambda d=None: orig("cpu" if d is None
                                                    else d))


def _run_reference_test(case, tmp_path, monkeypatch):
    """Run one case of :func:`_reference_tests`, giving it the fixtures it
    names (``tmp_path``, ``monkeypatch``), in host-only mode: ``Nd4j``
    creation without ``device=`` lands on the CPU, as in an ETL worker."""
    import inspect
    from deeplearning4j_tpu_torch.ops.ndarray import (host_only_arrays,
                                                      set_host_only_arrays)
    fn = case
    if isinstance(case, tuple):
        cls, meth = case
        fn = getattr(cls(), meth)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    kwargs = {p: fixtures[p] for p in inspect.signature(fn).parameters}
    prev = host_only_arrays()
    set_host_only_arrays(True)
    try:
        fn(**kwargs)
    finally:
        set_host_only_arrays(prev)
