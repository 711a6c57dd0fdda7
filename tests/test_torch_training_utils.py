"""Port parity: the training user's loop around ``fit`` — listeners, early
stopping, transfer learning and the rest of ``MultiLayerNetwork``'s
surface — against the JAX package, and LeNet-MNIST as
``examples/lenet_mnist.py`` runs it.

The early-stopping and transfer-learning cases mirror
``tests/test_training_utils.py`` on the port; where the result is
deterministic (termination reason and details, epochs, best epoch, frozen
parameters) it must equal the JAX package's from copied parameters, and
the held-out scores agree to 1e-5.  Listeners fire in the reference's
order with its counts, under standard fit and under TBPTT.
"""
import os

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.optimize as jopt
import deeplearning4j_tpu_torch.optimize as topt
from deeplearning4j_tpu.models import (FineTuneConfiguration as JFTC,
                                       TransferLearning as JTL)
from deeplearning4j_tpu_torch.models import (FineTuneConfiguration,
                                             TransferLearning)
from deeplearning4j_tpu_torch.utils import ModelSerializer

from _torch_parity import JAX, PORT, _char_conf, _np

pytestmark = pytest.mark.torch_port

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _toy_data(pkg, n=128, seed=0):
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, 2, n)
    x = rng.randn(n, 4).astype(np.float32) + cls[:, None] * 2.0
    y = np.eye(2, dtype=np.float32)[cls]
    return pkg.ds.DataSet(x, y)


def _conf(pkg, seed=1, lr=5e-2):
    L = pkg.layers
    return (pkg.conf.NeuralNetConfiguration.builder().seed(seed)
            .updater(pkg.learn.Adam(lr)).list()
            .layer(L.DenseLayer.builder().nIn(4).nOut(16).activation("relu")
                   .build())
            .layer(L.DenseLayer.builder().nIn(16).nOut(8).activation("relu")
                   .build())
            .layer(L.OutputLayer.builder("mcxent").nIn(8).nOut(2)
                   .activation("softmax").build())
            .build())


def _nets():
    """(JAX net, port net on the CPU) from the same parameters."""
    jnet = JAX.models.MultiLayerNetwork(_conf(JAX)).init()
    net = PORT.models.MultiLayerNetwork(_conf(PORT), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    return jnet, net


def _its(pkg, train_batch=32):
    return (pkg.ds.ListDataSetIterator([_toy_data(pkg)], batch=train_batch),
            pkg.ds.ListDataSetIterator([_toy_data(pkg, seed=9)], batch=64))


def _es_both(build):
    """Run ``build(opt_module, pkg, test_iterator) -> configuration`` as an
    early-stopping fit in both packages from the same parameters."""
    jnet, net = _nets()
    out = []
    for opt, pkg, model in ((jopt, JAX, jnet), (topt, PORT, net)):
        train, test = _its(pkg)
        out.append(opt.EarlyStoppingTrainer(build(opt, pkg, test), model,
                                            train).fit())
    return out


def _assert_same_result(jr, tr):
    assert tr.terminationReason == jr.terminationReason
    assert tr.terminationDetails == jr.terminationDetails
    assert tr.totalEpochs == jr.totalEpochs
    assert tr.bestModelEpoch == jr.bestModelEpoch
    assert sorted(tr.scoreVsEpoch) == sorted(jr.scoreVsEpoch)
    np.testing.assert_allclose([tr.scoreVsEpoch[e] for e in
                                sorted(tr.scoreVsEpoch)],
                               [jr.scoreVsEpoch[e] for e in
                                sorted(jr.scoreVsEpoch)], **SCORE_TOL)


# ------------------------------------------------------- early stopping ----

def test_early_stopping_max_epochs():
    jr, tr = _es_both(lambda o, p, test: (
        o.EarlyStoppingConfiguration.builder()
        .epochTerminationConditions(o.MaxEpochsTerminationCondition(3))
        .scoreCalculator(o.DataSetLossCalculator(test)).build()))
    _assert_same_result(jr, tr)
    assert tr.terminationReason == topt.TerminationReason.EpochTerminationCondition
    assert tr.totalEpochs == 3
    assert tr.getBestModel() is not None and tr.bestModelScore is not None
    assert tr.bestModelScore == tr.scoreVsEpoch[tr.bestModelEpoch]


def test_early_stopping_score_improvement_patience():
    jr, tr = _es_both(lambda o, p, test: (
        o.EarlyStoppingConfiguration.builder()
        .epochTerminationConditions(
            o.ScoreImprovementEpochTerminationCondition(2, 1e9),
            o.MaxEpochsTerminationCondition(50))
        .scoreCalculator(o.DataSetLossCalculator(test)).build()))
    _assert_same_result(jr, tr)
    assert tr.totalEpochs <= 4
    assert "ScoreImprovement" in tr.terminationDetails


def test_early_stopping_divergence_abort():
    jr, tr = _es_both(lambda o, p, test: (
        o.EarlyStoppingConfiguration.builder()
        .epochTerminationConditions(o.MaxEpochsTerminationCondition(50))
        .iterationTerminationConditions(
            o.MaxScoreIterationTerminationCondition(1e-9)).build()))
    assert tr.terminationReason == jr.terminationReason == \
        topt.TerminationReason.IterationTerminationCondition
    assert tr.terminationDetails == jr.terminationDetails


def test_early_stopping_best_model_usable():
    jr, tr = _es_both(lambda o, p, test: (
        o.EarlyStoppingConfiguration.builder()
        .epochTerminationConditions(o.MaxEpochsTerminationCondition(5))
        .scoreCalculator(o.DataSetLossCalculator(test)).build()))
    _assert_same_result(jr, tr)
    _, test = _its(PORT)
    ev = tr.getBestModel().evaluate(test)
    assert ev.accuracy() > 0.8


def test_patience_respects_evaluate_every_n():
    jr, tr = _es_both(lambda o, p, test: (
        o.EarlyStoppingConfiguration.builder()
        .epochTerminationConditions(
            o.ScoreImprovementEpochTerminationCondition(2, 1e9),
            o.MaxEpochsTerminationCondition(50))
        .scoreCalculator(o.DataSetLossCalculator(test))
        .evaluateEveryNEpochs(5).build()))
    _assert_same_result(jr, tr)
    assert tr.totalEpochs == 11, tr.totalEpochs


def test_early_stopping_local_file_saver(tmp_path):
    """``LocalFileModelSaver`` writes a zip through ``ModelSerializer``;
    the best model restores onto the saved model's device and scores its
    recorded best score; a ``ClassificationScoreCalculator`` maximizes."""
    _, net = _nets()
    train, test = _its(PORT)
    saver = topt.LocalFileModelSaver(str(tmp_path / "es"))
    es = (topt.EarlyStoppingConfiguration.builder()
          .epochTerminationConditions(topt.MaxEpochsTerminationCondition(4))
          .scoreCalculator(topt.DataSetLossCalculator(test))
          .modelSaver(saver).saveLastModel().build())
    r = topt.EarlyStoppingTrainer(es, net, train).fit()
    assert os.path.exists(tmp_path / "es" / "bestModel.zip")
    assert os.path.exists(tmp_path / "es" / "latestModel.zip")
    best = r.getBestModel()
    assert best.device == net.device
    score = topt.DataSetLossCalculator(test).calculateScore(best)
    assert score == pytest.approx(r.bestModelScore, rel=1e-6)
    es2 = (topt.EarlyStoppingConfiguration.builder()
           .epochTerminationConditions(topt.MaxEpochsTerminationCondition(2))
           .scoreCalculator(topt.ClassificationScoreCalculator(test))
           .build())
    r2 = topt.EarlyStoppingTrainer(es2, _conf(PORT), train,
                                   device="cpu").fit()
    assert max(r2.scoreVsEpoch.values()) == r2.bestModelScore


def test_best_model_and_original_both_trainable():
    train, _ = _its(PORT)
    _, net = _nets()
    net.fit(train, epochs=1)
    saver = topt.InMemoryModelSaver()
    saver.saveBestModel(net, 0.0)
    saved = _np(net.params()).copy()
    best = saver.getBestModel()
    best.fit(train, epochs=1)
    net.fit(train, epochs=1)
    best2 = saver.getBestModel()
    np.testing.assert_array_equal(_np(best2.params()), saved)
    assert np.isfinite(best2.score(_toy_data(PORT)))


# ----------------------------------------------------- transfer learning ----

def _head(pkg, nOut=3):
    return pkg.layers.OutputLayer.builder("mcxent").nIn(8).nOut(nOut) \
        .activation("softmax").build()


def test_transfer_learning_freeze_and_replace_head():
    jnet, net = _nets()
    jtrain, _ = _its(JAX, 64)
    ttrain, _ = _its(PORT, 64)
    jnet.fit(jtrain, epochs=3)
    net.fit(ttrain, epochs=3)
    w0_before = _np(net.params_["0"]["W"]).copy()
    # the new head draws its own init in each package: copy the JAX one
    j2 = (JTL.Builder(jnet)
          .fineTuneConfiguration(JFTC.builder().updater(
              JAX.learn.Sgd(1e-2)).build())
          .setFeatureExtractor(1).removeOutputLayer()
          .addLayer(_head(JAX)).build())
    t2 = (TransferLearning.Builder(net)
          .fineTuneConfiguration(FineTuneConfiguration.builder().updater(
              PORT.learn.Sgd(1e-2)).build())
          .setFeatureExtractor(1).removeOutputLayer()
          .addLayer(_head(PORT)).build(device="cpu"))
    assert t2.conf.toJson() == j2.conf.toJson()
    np.testing.assert_array_equal(_np(t2.params_["0"]["W"]), w0_before)
    assert t2.conf.layers[0].frozen and t2.conf.layers[1].frozen
    assert not getattr(t2.conf.layers[2], "frozen", False)
    t2.params_["2"] = {k: torch.from_numpy(np.array(v))
                       for k, v in j2.params_["2"].items()}
    t2._initOptState()

    rng = np.random.RandomState(3)
    cls3 = rng.randint(0, 3, 64)
    x3 = rng.randn(64, 4).astype(np.float32) + cls3[:, None]
    y3 = np.eye(3, dtype=np.float32)[cls3]
    head0 = _np(t2.params_["2"]["W"]).copy()
    j2.fit(JAX.ds.ListDataSetIterator([JAX.ds.DataSet(x3, y3)], 32), epochs=3)
    t2.fit(PORT.ds.ListDataSetIterator([PORT.ds.DataSet(x3, y3)], 32),
           epochs=3)
    # frozen layers bit-unchanged, the head trained as the reference's
    np.testing.assert_array_equal(_np(t2.params_["0"]["W"]), w0_before)
    np.testing.assert_array_equal(_np(t2.params_["1"]["W"]),
                                  _np(net.params_["1"]["W"]))
    assert not np.array_equal(_np(t2.params_["2"]["W"]), head0)
    np.testing.assert_allclose(_np(t2.params_["2"]["W"]),
                               np.asarray(j2.params_["2"]["W"]), atol=1e-5)
    assert tuple(t2.output(x3).shape) == (64, 3)


def test_transfer_learning_nout_replace():
    jnet, net = _nets()
    t2 = TransferLearning.Builder(net).nOutReplace(1, 12).build(device="cpu")
    j2 = JTL.Builder(jnet).nOutReplace(1, 12).build()
    assert t2.conf.toJson() == j2.conf.toJson()
    assert tuple(t2.params_["1"]["W"].shape) == (16, 12)
    assert tuple(t2.params_["2"]["W"].shape) == (12, 2)
    np.testing.assert_array_equal(_np(t2.params_["0"]["W"]),
                                  _np(net.params_["0"]["W"]))
    assert tuple(t2.output(np.zeros((2, 4), np.float32)).shape) == (2, 2)


def test_frozen_layer_in_computation_graph():
    def conf(pkg):
        L = pkg.layers
        gb = (pkg.conf.NeuralNetConfiguration.builder().seed(3)
              .updater(pkg.learn.Adam(5e-2)).graphBuilder())
        gb.addInputs("in")
        l0 = L.DenseLayer.builder().nIn(4).nOut(8).activation("relu").build()
        l0.frozen = True
        gb.addLayer("fc0", l0, "in")
        gb.addLayer("out", L.OutputLayer.builder("mcxent").nIn(8).nOut(2)
                    .activation("softmax").build(), "fc0")
        return gb.setOutputs("out").build()

    jg = JAX.models.ComputationGraph(conf(JAX)).init()
    g = PORT.models.ComputationGraph(conf(PORT), device="cpu").init(
        params=jax.tree.map(np.array, jg.params_))
    w0 = _np(g.params_["fc0"]["W"]).copy()
    out0 = _np(g.params_["out"]["W"]).copy()
    for _ in range(3):
        jg.fit(_toy_data(JAX))
        g.fit(_toy_data(PORT))
    np.testing.assert_array_equal(_np(g.params_["fc0"]["W"]), w0)
    assert not np.array_equal(_np(g.params_["out"]["W"]), out0)
    np.testing.assert_allclose(_np(g.params_["out"]["W"]),
                               np.asarray(jg.params_["out"]["W"]), atol=1e-5)


def test_transfer_graph_builder_freezes_ancestors():
    from _torch_parity import _narrow
    jg = JAX.models.ComputationGraph(_narrow(JAX, "FLOAT")).init()
    g = PORT.models.ComputationGraph(_narrow(PORT, "FLOAT"),
                                     device="cpu").init(
        params=jax.tree.map(np.array, jg.params_))

    def surgery(tl, pkg):
        return (tl.GraphBuilder(jg if pkg is JAX else g)
                .setFeatureExtractor("avgpool")
                .removeVertexKeepConnections("fc")
                .addLayer("fc", pkg.layers.OutputLayer.builder(
                    "negativeloglikelihood").nOut(3).activation("softmax")
                    .build(), "avgpool")
                .setOutputs("fc"))

    j2 = surgery(JTL, JAX).build()
    t2 = surgery(TransferLearning, PORT).build(device="cpu")
    assert t2.conf.toJson() == j2.conf.toJson()
    jfrozen = sorted(n for n, (node, _) in j2.conf.nodes.items()
                     if getattr(node, "frozen", False))
    tfrozen = sorted(n for n, (node, _) in t2.conf.nodes.items()
                     if getattr(node, "frozen", False))
    assert tfrozen == jfrozen and "stem_conv" in tfrozen
    assert "fc" not in tfrozen
    before = _np(t2.params_["stem_conv"]["W"]).copy()
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 16, 16).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    t2.fit(PORT.ds.DataSet(x, y))
    np.testing.assert_array_equal(_np(t2.params_["stem_conv"]["W"]), before)


# ------------------------------------------------------------- listeners ----

def _recorder(base):
    """A listener of ``base``'s package recording every hook as (event,
    iteration, epoch)."""

    class Recorder(base):
        def __init__(self):
            self.events = []

        def iterationDone(self, model, iteration, epoch):
            self.events.append(("iterationDone", iteration, epoch))

        def onEpochStart(self, model):
            self.events.append(("onEpochStart", model.iterationCount,
                                model.epochCount))

        def onEpochEnd(self, model):
            self.events.append(("onEpochEnd", model.iterationCount,
                                model.epochCount))

    return Recorder()


@pytest.mark.parametrize("path", ["standard", "tbptt"])
def test_listeners_fire_as_the_reference(path):
    if path == "standard":
        jnet, net = _nets()
        jits, tits = _its(JAX)[0], _its(PORT)[0]
    else:
        jnet = JAX.models.MultiLayerNetwork(_char_conf(JAX, 6, hidden=8,
                                                       tbptt=4)).init()
        net = PORT.models.MultiLayerNetwork(
            _char_conf(PORT, 6, hidden=8, tbptt=4), device="cpu").init(
            params=jax.tree.map(np.array, jnet.params_))
        rng = np.random.RandomState(2)
        x = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (6, 10))] \
            .transpose(0, 2, 1).copy()
        jits = JAX.ds.ListDataSetIterator([JAX.ds.DataSet(x, x)], 3)
        tits = PORT.ds.ListDataSetIterator([PORT.ds.DataSet(x, x)], 3)
    jrec, trec = _recorder(jopt.TrainingListener), \
        _recorder(topt.TrainingListener)
    jcol, tcol = jopt.CollectScoresIterationListener(), \
        topt.CollectScoresIterationListener()
    jnet.setListeners(jrec, jcol)
    net.setListeners(trec, tcol)
    jnet.fit(jits, epochs=2)
    net.fit(tits, epochs=2)
    jits.reset()
    tits.reset()
    jnet.fit(_toy_data(JAX) if path == "standard" else jits.next())
    net.fit(_toy_data(PORT) if path == "standard" else tits.next())
    assert trec.events == jrec.events
    assert net.getListeners() == [trec, tcol]
    assert [i for i, _ in tcol.getScores()] == [i for i, _ in jcol.scores]
    np.testing.assert_allclose([s for _, s in tcol.getScores()],
                               [s for _, s in jcol.scores], **SCORE_TOL)
    net.removeListener(trec)
    assert net.getListeners() == [tcol]


def test_graph_listeners_fire_as_the_reference():
    from _torch_parity import _narrow
    jg = JAX.models.ComputationGraph(_narrow(JAX, "FLOAT")).init()
    g = PORT.models.ComputationGraph(_narrow(PORT, "FLOAT"),
                                     device="cpu").init(
        params=jax.tree.map(np.array, jg.params_))
    rng = np.random.RandomState(4)
    x = rng.randn(8, 3, 16, 16).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 8)]
    jrec, trec = _recorder(jopt.TrainingListener), \
        _recorder(topt.TrainingListener)
    jg.setListeners(jrec)
    g.addListeners(trec)
    jg.fit(JAX.ds.ListDataSetIterator([JAX.ds.DataSet(x, y)], 4), epochs=2)
    g.fit(PORT.ds.ListDataSetIterator([PORT.ds.DataSet(x, y)], 4), epochs=2)
    assert trec.events == jrec.events and len(trec.events) == 8


def test_stock_listeners(tmp_path, capsys):
    _, net = _nets()
    train, test = _its(PORT)
    perf = topt.PerformanceListener(frequency=2, reportScore=True)
    ckpt = topt.CheckpointListener(str(tmp_path / "ck"),
                                   saveEveryNIterations=2, keepLast=2)
    evl = topt.EvaluativeListener(test, frequency=1)
    net.setListeners(topt.ScoreIterationListener(2), perf, ckpt, evl,
                     topt.TimeIterationListener(8, frequency=2))
    net.fit(train, epochs=2)
    out = capsys.readouterr().out
    assert "Score at iteration 2 is" in out
    assert "samples/sec" in out and perf.samplesPerSecond > 0
    assert "Remaining time estimate" in out
    assert "Accuracy" in out and evl.lastEvaluation.getNumRowCounter() == 128
    assert sorted(os.listdir(tmp_path / "ck")) == \
        ["checkpoint_iter_6.zip", "checkpoint_iter_8.zip"]
    back = ModelSerializer.restoreMultiLayerNetwork(
        str(tmp_path / "ck" / "checkpoint_iter_8.zip"), device="cpu")
    np.testing.assert_array_equal(_np(back.params()), _np(net.params()))
    assert back.iterationCount == 8


def test_a_failing_monitor_is_swallowed_and_a_checkpoint_is_not():
    from deeplearning4j_tpu_torch.optimize import listeners as L

    class Bad(topt.TrainingListener):
        def iterationDone(self, model, iteration, epoch):
            raise RuntimeError("monitor bug")

    _, net = _nets()
    before = L.dl4j_tpu_train_listener_errors_total
    net.setListeners(Bad())
    net.fit(_toy_data(PORT))
    assert L.dl4j_tpu_train_listener_errors_total == before + 1
    bad = Bad()
    bad.failOnError = True
    net.setListeners(bad)
    with pytest.raises(RuntimeError, match="monitor bug"):
        net.fit(_toy_data(PORT))


# ----------------------------------------------- the rest of the surface ----

def test_feed_forward_params_clone_summary():
    jnet, net = _nets()
    x = _toy_data(JAX).features.numpy()[:5]
    jacts, tacts = jnet.feedForward(x), net.feedForward(x)
    assert len(tacts) == len(jacts) == 4
    for a, b in zip(tacts, jacts):
        np.testing.assert_allclose(_np(a), b.numpy(), atol=1e-6)
    np.testing.assert_array_equal(_np(net.getParam("1_W")),
                                  np.asarray(jnet.getParam("1_W").jax))
    net.setParam("2_b", np.array([0.5, -0.5], np.float32))
    assert net.getParam("2_b").torch.tolist() == [0.5, -0.5]
    net.fit(_toy_data(PORT))
    c = net.clone()
    assert c.device == net.device and c.iterationCount == 0
    np.testing.assert_array_equal(_np(c.params()), _np(net.params()))
    c.fit(_toy_data(PORT))
    assert not np.array_equal(_np(c.params()), _np(net.params()))
    assert net.summary() == jnet.summary()
    assert net.getnLayers() == 3
    assert net.getLayerWiseConfigurations() is net.conf


# ------------------------------------------------------------ LeNet-MNIST ----

def test_lenet_mnist_end_to_end():
    """``examples/lenet_mnist.py``'s flow at ``tests/test_multilayer.py``'s
    sizes (2048 training and 512 test images of the synthetic set, 8
    epochs): the reference's bar, accuracy > 0.90."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.zoo import LeNet
    net = LeNet().init(device="cpu")
    col = topt.CollectScoresIterationListener(8)
    net.setListeners(col)
    net.fit(MnistDataSetIterator(128, True, 123, numExamples=2048), epochs=8)
    assert net.iterationCount == 128
    assert all(np.isfinite(s) for _, s in col.getScores())
    ev = net.evaluate(MnistDataSetIterator(256, False, 123, numExamples=512))
    assert ev.getNumRowCounter() == 512
    assert ev.accuracy() > 0.90, ev.stats()


def test_c17_frozen_batchnorm_moves_its_statistics_as_in_the_reference():
    """ROADMAP C17, a reference behaviour the port keeps: a frozen vertex
    runs in training mode (DL4J's ``FrozenLayer`` runs it as at
    inference), so a frozen BatchNormalization normalises with batch
    statistics and moves its running statistics — in both packages, by
    the same amounts (1e-5); its parameters stay bit for bit."""
    from _torch_parity import _narrow
    jg = JAX.models.ComputationGraph(_narrow(JAX, "FLOAT")).init()
    g = PORT.models.ComputationGraph(_narrow(PORT, "FLOAT"),
                                     device="cpu").init(
        params=jax.tree.map(np.array, jg.params_))

    def surgery(tl, pkg, net):
        return (tl.GraphBuilder(net).setFeatureExtractor("avgpool")
                .removeVertexKeepConnections("fc")
                .addLayer("fc", pkg.layers.OutputLayer.builder("mcxent")
                          .nOut(3).activation("softmax").build(), "avgpool")
                .setOutputs("fc"))

    j2 = surgery(JTL, JAX, jg).build()
    t2 = surgery(TransferLearning, PORT, g).build(device="cpu")
    t2.params_["fc"] = {k: torch.from_numpy(np.array(v))
                        for k, v in j2.params_["fc"].items()}
    t2._initOptState()
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 16, 16).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    st0 = {k: _np(st["mean"]).copy() for k, st in t2.state_.items()}
    w0 = _np(t2.params_["stem_conv"]["W"]).copy()
    t2.fit(PORT.ds.DataSet(x, y))
    j2.fit(JAX.ds.DataSet(x, y))
    assert abs(t2.score() - j2.score()) <= 1e-5
    np.testing.assert_array_equal(_np(t2.params_["stem_conv"]["W"]), w0)
    assert not np.array_equal(_np(t2.state_["stem_bn"]["mean"]),
                              st0["stem_bn"])
    for k, st in t2.state_.items():
        np.testing.assert_allclose(_np(st["mean"]),
                                   np.asarray(j2.state_[k]["mean"]),
                                   atol=1e-5, rtol=1e-5)
