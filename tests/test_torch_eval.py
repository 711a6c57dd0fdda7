"""Port parity: the evaluation classes (``deeplearning4j_tpu_torch/eval``)
and ``evaluate`` on both models and SameDiff, against the JAX package.

Every class gets the same seeded labels, predictions and masks in both
packages (tensors for the port, numpy for the reference) and every metric
and ``stats()`` string must be equal: the arithmetic is the reference's
numpy in both.  ``MultiLayerNetwork.evaluate`` and
``ComputationGraph.evaluate`` run from copied parameters and must give
the same confusion matrix (the outputs differ by float32 rounding, far
from any argmax tie on these inputs).
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.eval as jeval
import deeplearning4j_tpu_torch.eval as teval

from _torch_parity import JAX, PORT, _narrow, _np, NARROW_BATCH, \
    NARROW_CLASSES

pytestmark = pytest.mark.torch_port

R = np.random.RandomState(0)
C = 4
PROBS = R.dirichlet(np.ones(C), 64).astype(np.float32)
ONEHOT = np.eye(C, dtype=np.float32)[R.randint(0, C, 64)]
# predictions that agree with the labels most of the time
PROBS = (0.6 * PROBS + 0.4 * ONEHOT).astype(np.float32)
SEQ_LABELS = np.eye(C, dtype=np.float32)[R.randint(0, C, (5, 7))] \
    .transpose(0, 2, 1).copy()
SEQ_PROBS = R.dirichlet(np.ones(C), (5, 7)).astype(np.float32) \
    .transpose(0, 2, 1).copy()
SEQ_MASK = (R.rand(5, 7) > 0.3).astype(np.float32)


def _eval_both(cls, batches, *args):
    """One instance per package, each fed the same batches of (labels,
    predictions[, mask])."""
    j, t = getattr(jeval, cls)(*args), getattr(teval, cls)(*args)
    for b in batches:
        j.eval(*b)
        t.eval(*(None if a is None else torch.from_numpy(a) for a in b))
    return j, t


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("form", ["onehot", "ids", "sequence"])
def test_evaluation_every_metric(form):
    if form == "onehot":
        batches = [(ONEHOT[:40], PROBS[:40]), (ONEHOT[40:], PROBS[40:])]
    elif form == "ids":
        batches = [(ONEHOT.argmax(1).astype(np.int64),
                    PROBS.argmax(1).astype(np.int64))]
    else:
        batches = [(SEQ_LABELS, SEQ_PROBS, SEQ_MASK)]
    j, t = _eval_both("Evaluation", batches)
    _same(t.confusionMatrix(), j.confusionMatrix())
    assert t.stats() == j.stats() and str(t) == str(j)
    for m in ("accuracy", "precision", "recall", "f1", "gMeasure",
              "getNumRowCounter"):
        assert getattr(t, m)() == getattr(j, m)(), m
    for c in range(C):
        for m in ("precision", "recall", "f1", "gMeasure",
                  "matthewsCorrelation", "falsePositiveRate"):
            assert getattr(t, m)(c) == getattr(j, m)(c), (m, c)
    for n in (1, 2, 3):
        assert t.topNAccuracy(n, torch.from_numpy(ONEHOT),
                              torch.from_numpy(PROBS)) == \
            j.topNAccuracy(n, ONEHOT, PROBS)


def test_evaluation_names_and_growth():
    names = ["a", "b", "c", "d", "e"]
    j, t = _eval_both("Evaluation", [(np.array([0, 1, 2]), np.array([0, 2, 2])),
                                     (np.array([4]), np.array([1]))], 0, names)
    assert t.stats() == j.stats()
    _same(t.confusionMatrix(), j.confusionMatrix())


def test_evaluation_binary():
    y = (R.rand(30, 3) > 0.5).astype(np.float32)
    p = np.clip(y * 0.6 + R.rand(30, 3) * 0.5, 0, 1).astype(np.float32)
    mask = (R.rand(30, 3) > 0.2).astype(np.float32)
    j, t = _eval_both("EvaluationBinary", [(y[:20], p[:20], mask[:20]),
                                           (y[20:], p[20:], mask[20:])], 0.4)
    for i in range(3):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert getattr(t, m)(i) == getattr(j, m)(i), (m, i)


@pytest.mark.parametrize("cls", ["ROC", "ROCMultiClass", "ROCBinary"])
def test_roc_family(cls):
    y2 = np.eye(2, dtype=np.float32)[R.randint(0, 2, 50)]
    p2 = np.clip(y2 * 0.5 + R.rand(50, 2) * 0.6, 0, 1).astype(np.float32)
    batches = [(y2[:30], p2[:30]), (y2[30:], p2[30:])]
    if cls == "ROC":
        j, t = _eval_both(cls, batches)
        assert t.calculateAUC() == j.calculateAUC()
        assert t.calculateAUCPR() == j.calculateAUCPR()
    elif cls == "ROCMultiClass":
        j, t = _eval_both(cls, [(ONEHOT, PROBS)])
        for c in range(C):
            assert t.calculateAUC(c) == j.calculateAUC(c)
        assert t.calculateAverageAUC() == j.calculateAverageAUC()
    else:
        j, t = _eval_both(cls, batches)
        assert t.numLabels() == j.numLabels() == 2
        for c in range(2):
            assert t.calculateAUC(c) == j.calculateAUC(c)
            assert t.calculateAUCPR(c) == j.calculateAUCPR(c)


def test_regression_evaluation():
    y = R.randn(40, 3).astype(np.float32)
    p = (y + R.randn(40, 3) * 0.3).astype(np.float32)
    j, t = _eval_both("RegressionEvaluation", [(y[:25], p[:25]),
                                               (y[25:], p[25:])])
    assert t.stats() == j.stats()
    for c in range(3):
        for m in ("meanSquaredError", "meanAbsoluteError",
                  "rootMeanSquaredError", "rSquared", "pearsonCorrelation"):
            assert getattr(t, m)(c) == getattr(j, m)(c), (m, c)
    assert t.averageMeanSquaredError() == j.averageMeanSquaredError()


def test_evaluation_calibration():
    j, t = _eval_both("EvaluationCalibration",
                      [(ONEHOT, PROBS), (SEQ_LABELS, SEQ_PROBS, SEQ_MASK)],
                      5, 8)
    for c in range(C):
        for a, b in zip(t.getReliabilityInfo(c), j.getReliabilityInfo(c)):
            _same(a, b)
        assert t.expectedCalibrationError(c) == j.expectedCalibrationError(c)
    _same(t.getLabelCountsEachClass(), j.getLabelCountsEachClass())
    _same(t.getPredictionCountsEachClass(), j.getPredictionCountsEachClass())
    for a, b in zip(t.getResidualPlotAllClasses(),
                    j.getResidualPlotAllClasses()):
        _same(a, b)


# ---------------------------------------------------------------------------
# evaluate on the models, from copied parameters
# ---------------------------------------------------------------------------

def _iris_conf(pkg, outAct="softmax", loss="mcxent", nOut=3):
    L = pkg.layers
    return (pkg.conf.NeuralNetConfiguration.builder().seed(7)
            .updater(pkg.learn.Adam(5e-2)).list()
            .layer(L.DenseLayer.builder().nIn(4).nOut(10).activation("tanh")
                   .build())
            .layer(L.OutputLayer.builder(loss).nIn(10).nOut(nOut)
                   .activation(outAct).build())
            .build())


def test_multilayer_evaluate_matches_the_reference():
    jnet = JAX.models.MultiLayerNetwork(_iris_conf(JAX)).init()
    net = PORT.models.MultiLayerNetwork(_iris_conf(PORT), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    jit, tit = JAX.ds.IrisDataSetIterator(50), PORT.ds.IrisDataSetIterator(50)
    for _ in range(3):
        jnet.fit(jit)
        net.fit(tit)
    jev, tev = jnet.evaluate(jit), net.evaluate(tit)
    _same(tev.confusionMatrix(), jev.confusionMatrix())
    assert tev.stats() == jev.stats()
    assert tev.getNumRowCounter() == 150
    jr, tr = jnet.evaluateRegression(jit), net.evaluateRegression(tit)
    np.testing.assert_allclose(tr.meanSquaredError(1),
                               jr.meanSquaredError(1), rtol=1e-5)
    jroc, troc = jnet.evaluateROC(jit), net.evaluateROC(tit)
    assert abs(troc.calculateAUC() - jroc.calculateAUC()) < 1e-6


def test_graph_evaluate_matches_the_reference():
    jg = JAX.models.ComputationGraph(_narrow(JAX, "FLOAT")).init()
    g = PORT.models.ComputationGraph(_narrow(PORT, "FLOAT"),
                                     device="cpu").init(
        params=jax.tree.map(np.array, jg.params_))
    rng = np.random.RandomState(5)
    x = rng.randn(3 * NARROW_BATCH, 3, 16, 16).astype(np.float32)
    y = np.eye(NARROW_CLASSES, dtype=np.float32)[
        rng.randint(0, NARROW_CLASSES, 3 * NARROW_BATCH)]
    jev = jg.evaluate(JAX.ds.ListDataSetIterator([JAX.ds.DataSet(x, y)],
                                                 NARROW_BATCH))
    tev = g.evaluate(PORT.ds.ListDataSetIterator([PORT.ds.DataSet(x, y)],
                                                 NARROW_BATCH))
    _same(tev.confusionMatrix(), jev.confusionMatrix())
    assert tev.getNumRowCounter() == 3 * NARROW_BATCH


def test_samediff_evaluate_matches_the_reference():
    from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
    from deeplearning4j_tpu.autodiff import TrainingConfig as JTC
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    rng = np.random.RandomState(2)
    w = rng.randn(4, 3).astype(np.float32)
    runs = []
    for sd, tc, it in (
            (JSameDiff.create(), JTC, JAX.ds.IrisDataSetIterator(30)),
            (SameDiff.create("cpu"), TrainingConfig,
             PORT.ds.IrisDataSetIterator(30))):
        x = sd.placeholder("x", shape=(None, 4))
        sd.placeholder("label", shape=(None, 3))
        sd.nn().softmax(x.mmul(sd.var("w", w)), name="probs")
        sd.setTrainingConfig(tc.Builder().dataSetFeatureMapping("x")
                             .dataSetLabelMapping("label").build())
        runs.append(sd.evaluate(it, "probs"))
    jev, tev = runs
    _same(tev.confusionMatrix(), jev.confusionMatrix())
    assert tev.getNumRowCounter() == 150
