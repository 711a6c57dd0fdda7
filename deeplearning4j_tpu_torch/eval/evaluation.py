"""Evaluation metrics — the port of ``deeplearning4j_tpu/eval/evaluation.py``
(nd4j's ``org/nd4j/evaluation/classification/{Evaluation,
EvaluationBinary,ROC,ROCMultiClass,ROCBinary,EvaluationCalibration}.java``
and ``regression/RegressionEvaluation.java``): confusion-matrix
classification metrics (accuracy, precision, recall, F1 with macro
averaging, MCC, G-measure, top-N), per-label binary metrics, ROC/AUC,
column-wise regression metrics and calibration.

As in the reference, the arithmetic is numpy on the host: ``eval`` takes
tensors (on any device, copied to the host once) or numpy arrays.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["Evaluation", "EvaluationBinary", "ROC", "ROCMultiClass",
           "ROCBinary", "RegressionEvaluation", "EvaluationCalibration"]

#: numpy 2 renamed ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Evaluation:
    """Multi-class classification evaluation via confusion matrix."""

    def __init__(self, numClasses: int = 0, labels: Optional[List[str]] = None):
        self.labelNames = labels
        self.numClasses = numClasses or (len(labels) if labels else 0)
        self._cm: Optional[np.ndarray] = None

    def _ensure(self, n):
        if self._cm is None:
            self.numClasses = self.numClasses or n
            self._cm = np.zeros((self.numClasses, self.numClasses), dtype=np.int64)
        elif n > self._cm.shape[0]:
            # grow when integer-id labels reveal a higher class id later
            grown = np.zeros((n, n), dtype=np.int64)
            grown[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
            self._cm = grown
            self.numClasses = n

    def eval(self, labels, predictions, mask=None) -> None:
        """labels/predictions: one-hot or probability (batch, C), or int ids.
        Time-series (b, C, t) handled with optional (b, t) mask."""
        y, p = _np(labels), _np(predictions)
        if y.ndim == 3:  # (b, C, t) -> flatten time with mask
            b, c, t = y.shape
            y = y.transpose(0, 2, 1).reshape(b * t, c)
            p = p.transpose(0, 2, 1).reshape(b * t, c)
            if mask is not None:
                m = _np(mask).reshape(b * t) > 0
                y, p = y[m], p[m]
        yi = y.argmax(-1) if y.ndim > 1 else y.astype(np.int64)
        pi = p.argmax(-1) if p.ndim > 1 else p.astype(np.int64)
        needed = max(int(yi.max(initial=0)), int(pi.max(initial=0))) + 1
        self._ensure(max(needed, self.numClasses))
        np.add.at(self._cm, (yi, pi), 1)

    # -- metrics ---------------------------------------------------------
    def accuracy(self) -> float:
        cm = self._cm
        return float(np.trace(cm) / max(cm.sum(), 1))

    def _tp(self):
        return np.diag(self._cm).astype(np.float64)

    def precision(self, cls: Optional[int] = None) -> float:
        cm = self._cm
        denom = cm.sum(axis=0).astype(np.float64)
        per = np.divide(self._tp(), denom, out=np.zeros_like(denom),
                        where=denom > 0)
        if cls is not None:
            return float(per[cls])
        present = denom > 0
        return float(per[present].mean()) if present.any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        cm = self._cm
        denom = cm.sum(axis=1).astype(np.float64)
        per = np.divide(self._tp(), denom, out=np.zeros_like(denom),
                        where=denom > 0)
        if cls is not None:
            return float(per[cls])
        present = denom > 0
        return float(per[present].mean()) if present.any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 0.0 if p + r == 0 else 2 * p * r / (p + r)

    def topNAccuracy(self, n: int, labels, predictions) -> float:
        """Reference: Evaluation(topN) — fraction where the true class is in
        the top-n predicted probabilities.  Stateless (needs raw probs, which
        the confusion matrix no longer has)."""
        y, p = _np(labels), _np(predictions)
        yi = y.argmax(-1) if y.ndim > 1 else y.astype(np.int64)
        top = np.argsort(-p, axis=-1)[:, :n]
        return float(np.mean([yi[i] in top[i] for i in range(len(yi))]))

    def matthewsCorrelation(self, cls: int) -> float:
        """Reference: Evaluation.matthewsCorrelation — binary MCC one-vs-all."""
        cm = self._cm
        tp = float(cm[cls, cls])
        fp = float(cm[:, cls].sum()) - tp
        fn = float(cm[cls, :].sum()) - tp
        tn = float(cm.sum()) - tp - fp - fn
        # double throughout: the int64 product (tp+fp)(tp+fn)(tn+fp)(tn+fn)
        # overflows past ~55k evaluated samples
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return 0.0 if denom == 0 else float((tp * tn - fp * fn) / denom)

    def gMeasure(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return float(np.sqrt(p * r))

    def falsePositiveRate(self, cls: int) -> float:
        cm = self._cm
        fp = cm[:, cls].sum() - cm[cls, cls]
        tn = cm.sum() - cm[cls, :].sum() - cm[:, cls].sum() + cm[cls, cls]
        return float(fp / max(fp + tn, 1))

    def confusionMatrix(self) -> np.ndarray:
        return self._cm.copy()

    def getNumRowCounter(self) -> int:
        return int(self._cm.sum()) if self._cm is not None else 0

    def stats(self) -> str:
        cm = self._cm
        names = self.labelNames or [str(i) for i in range(self.numClasses)]
        lines = ["", "========================Evaluation Metrics========================",
                 f" # of classes:    {self.numClasses}",
                 f" Accuracy:        {self.accuracy():.4f}",
                 f" Precision:       {self.precision():.4f}",
                 f" Recall:          {self.recall():.4f}",
                 f" F1 Score:        {self.f1():.4f}",
                 "", "=========================Confusion Matrix=========================",
                 "   " + " ".join(f"{n:>5}" for n in names)]
        for i, row in enumerate(cm):
            lines.append(f"{names[i]:>2} " + " ".join(f"{v:>5}" for v in row))
        lines.append("===================================================================")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()


class EvaluationBinary:
    """Per-output-column binary metrics (multi-label)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._tp = self._fp = self._tn = self._fn = None

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _np(labels), _np(predictions)
        pred = (p >= self.threshold)
        act = (y >= 0.5)
        if mask is not None:
            m = _np(mask).astype(bool)
            w = m.reshape(m.shape[0], -1)
        else:
            w = np.ones(y.shape, dtype=bool).reshape(y.shape[0], -1)
        yf, pf = act.reshape(act.shape[0], -1), pred.reshape(pred.shape[0], -1)
        tp = ((yf & pf) & w).sum(axis=0)
        fp = ((~yf & pf) & w).sum(axis=0)
        tn = ((~yf & ~pf) & w).sum(axis=0)
        fn = ((yf & ~pf) & w).sum(axis=0)
        if self._tp is None:
            self._tp, self._fp, self._tn, self._fn = tp, fp, tn, fn
        else:
            self._tp += tp; self._fp += fp; self._tn += tn; self._fn += fn

    def accuracy(self, i: int) -> float:
        tot = self._tp[i] + self._fp[i] + self._tn[i] + self._fn[i]
        return float((self._tp[i] + self._tn[i]) / max(tot, 1))

    def precision(self, i: int) -> float:
        return float(self._tp[i] / max(self._tp[i] + self._fp[i], 1))

    def recall(self, i: int) -> float:
        return float(self._tp[i] / max(self._tp[i] + self._fn[i], 1))

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 0.0 if p + r == 0 else 2 * p * r / (p + r)


class ROC:
    """Binary ROC / AUC (exact, sort-based like reference's exact mode)."""

    def __init__(self, thresholdSteps: int = 0):
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _np(labels), _np(predictions)
        if y.ndim > 1 and y.shape[-1] == 2:  # two-column one-hot: P(class 1)
            y, p = y[..., 1], p[..., 1]
        self._labels.append(y.ravel())
        self._scores.append(p.ravel())

    def calculateAUC(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s, kind="stable")
        y = y[order] > 0.5
        P, N = y.sum(), (~y).sum()
        if P == 0 or N == 0:
            return 0.0
        tps = np.cumsum(y)
        fps = np.cumsum(~y)
        tpr = np.concatenate([[0], tps / P])
        fpr = np.concatenate([[0], fps / N])
        return float(_trapezoid(tpr, fpr))

    def calculateAUCPR(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s, kind="stable")
        y = y[order] > 0.5
        P = y.sum()
        if P == 0:
            return 0.0
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / P
        return float(_trapezoid(precision, recall))


class ROCMultiClass:
    def __init__(self, thresholdSteps: int = 0):
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _np(labels), _np(predictions)
        n = y.shape[-1]
        if not self._rocs:
            self._rocs = [ROC() for _ in range(n)]
        for c in range(n):
            self._rocs[c].eval(y[..., c], p[..., c])

    def calculateAUC(self, cls: int) -> float:
        return self._rocs[cls].calculateAUC()

    def calculateAverageAUC(self) -> float:
        return float(np.mean([r.calculateAUC() for r in self._rocs]))


class RegressionEvaluation:
    """Column-wise MSE/MAE/RMSE/R^2/correlation."""

    def __init__(self, nColumns: int = 0):
        self._y: List[np.ndarray] = []
        self._p: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        y = _np(labels).reshape(_np(labels).shape[0], -1)
        p = _np(predictions).reshape(y.shape[0], -1)
        self._y.append(y)
        self._p.append(p)

    def _cat(self):
        return np.concatenate(self._y), np.concatenate(self._p)

    def meanSquaredError(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def meanAbsoluteError(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def rootMeanSquaredError(self, col: int = 0) -> float:
        return float(np.sqrt(self.meanSquaredError(col)))

    def rSquared(self, col: int = 0) -> float:
        y, p = self._cat()
        ss_res = np.sum((y[:, col] - p[:, col]) ** 2)
        ss_tot = np.sum((y[:, col] - y[:, col].mean()) ** 2)
        return float(1 - ss_res / max(ss_tot, 1e-12))

    def pearsonCorrelation(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def averageMeanSquaredError(self) -> float:
        y, p = self._cat()
        return float(np.mean((y - p) ** 2))

    def stats(self) -> str:
        y, p = self._cat()
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in range(y.shape[1]):
            lines.append(f"col_{c}   {self.meanSquaredError(c):<14.6f} "
                         f"{self.meanAbsoluteError(c):<14.6f} "
                         f"{self.rootMeanSquaredError(c):<14.6f} "
                         f"{self.rSquared(c):<.6f}")
        return "\n".join(lines)


class ROCBinary:
    """Per-output-column ROC for multi-label binary outputs.

    Reference: nd4j-api ``org/nd4j/evaluation/classification/ROCBinary.java``.
    """

    def __init__(self, thresholdSteps: int = 0):
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _np(labels), _np(predictions)
        y = y.reshape(y.shape[0], -1)
        p = p.reshape(p.shape[0], -1)
        if not self._rocs:
            self._rocs = [ROC() for _ in range(y.shape[1])]
        for c in range(y.shape[1]):
            self._rocs[c].eval(y[:, c], p[:, c])

    def calculateAUC(self, col: int) -> float:
        return self._rocs[col].calculateAUC()

    def calculateAUCPR(self, col: int) -> float:
        return self._rocs[col].calculateAUCPR()

    def numLabels(self) -> int:
        return len(self._rocs)


class EvaluationCalibration:
    """Reliability diagram + label/prediction count histograms.

    Reference: nd4j-api ``org/nd4j/evaluation/classification/
    EvaluationCalibration.java`` — bins predicted probabilities and tracks
    observed accuracy per bin (reliability), plus residual plots.
    """

    def __init__(self, reliabilityDiagNumBins: int = 10,
                 histogramNumBins: int = 10):
        self.nBins = reliabilityDiagNumBins
        self.histBins = histogramNumBins
        self._binCounts: Optional[np.ndarray] = None   # (C, bins)
        self._binCorrect: Optional[np.ndarray] = None
        self._probSum: Optional[np.ndarray] = None
        self._labelCounts: Optional[np.ndarray] = None
        self._predCounts: Optional[np.ndarray] = None
        self._residuals: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _np(labels), _np(predictions)
        if y.ndim == 3:
            b, c, t = y.shape
            y = y.transpose(0, 2, 1).reshape(b * t, c)
            p = p.transpose(0, 2, 1).reshape(b * t, c)
            if mask is not None:
                m = _np(mask).reshape(b * t) > 0
                y, p = y[m], p[m]
        nC = y.shape[1]
        if self._binCounts is None:
            self._binCounts = np.zeros((nC, self.nBins), dtype=np.int64)
            self._binCorrect = np.zeros((nC, self.nBins), dtype=np.int64)
            self._probSum = np.zeros((nC, self.nBins), dtype=np.float64)
            self._labelCounts = np.zeros(nC, dtype=np.int64)
            self._predCounts = np.zeros(nC, dtype=np.int64)
        yi = y.argmax(-1)
        bins = np.clip((p * self.nBins).astype(np.int64), 0, self.nBins - 1)
        for c in range(nC):
            np.add.at(self._binCounts[c], bins[:, c], 1)
            np.add.at(self._probSum[c], bins[:, c], p[:, c])
            np.add.at(self._binCorrect[c], bins[:, c], (yi == c))
        np.add.at(self._labelCounts, yi, 1)
        np.add.at(self._predCounts, p.argmax(-1), 1)
        self._residuals.append(np.abs(y - p).ravel())

    def getReliabilityInfo(self, cls: int):
        """(mean predicted prob per bin, observed frequency per bin, counts)."""
        counts = self._binCounts[cls]
        safe = np.maximum(counts, 1)
        return (self._probSum[cls] / safe,
                self._binCorrect[cls] / safe, counts.copy())

    def expectedCalibrationError(self, cls: int) -> float:
        mean_p, obs, counts = self.getReliabilityInfo(cls)
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(mean_p - obs)))

    def getLabelCountsEachClass(self) -> np.ndarray:
        return self._labelCounts.copy()

    def getPredictionCountsEachClass(self) -> np.ndarray:
        return self._predCounts.copy()

    def getResidualPlotAllClasses(self):
        """Histogram of |label - prediction| residuals over [0, 1]."""
        r = np.concatenate(self._residuals)
        return np.histogram(r, bins=self.histBins, range=(0.0, 1.0))
