"""DataSet container — the port of ``deeplearning4j_tpu/datasets/
dataset.py`` (the reference's ``org/nd4j/linalg/dataset/DataSet.java``
and ``MultiDataSet.java``): the (features, labels, featuresMask,
labelsMask) quadruple, and its multi-input form of lists.

Arrays are held as ``torch.Tensor`` (numpy arrays and nested lists are
converted, on the CPU); a model moves a batch to its own device when it
fits on it.  The ``NDArray`` facade waits for ROADMAP A2.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["DataSet", "MultiDataSet"]


def _tensor(x) -> Optional[torch.Tensor]:
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


class DataSet:
    def __init__(self, features=None, labels=None, featuresMask=None,
                 labelsMask=None):
        self.features = _tensor(features)
        self.labels = _tensor(labels)
        self.featuresMask = _tensor(featuresMask)
        self.labelsMask = _tensor(labelsMask)

    # DL4J accessors
    def getFeatures(self) -> torch.Tensor:
        return self.features

    def getLabels(self) -> torch.Tensor:
        return self.labels

    def getFeaturesMaskArray(self):
        return self.featuresMask

    def getLabelsMaskArray(self):
        return self.labelsMask

    def numExamples(self) -> int:
        return int(self.features.shape[0]) if self.features is not None \
            else 0

    def _parts(self):
        return (self.features, self.labels, self.featuresMask,
                self.labelsMask)

    def batchBy(self, batchSize: int) -> List["DataSet"]:
        n = self.numExamples()
        return [DataSet(*(None if a is None else a[i:i + batchSize]
                          for a in self._parts()))
                for i in range(0, n, batchSize)]


class MultiDataSet:
    """Lists of features, labels and their masks (a mask list may hold
    None for an input without one) — the multi-input form a SameDiff graph
    binds to its placeholders."""

    def __init__(self, features, labels, featuresMasks=None,
                 labelsMasks=None):
        as_list = lambda v: [_tensor(x) for x in v] \
            if isinstance(v, (list, tuple)) else [_tensor(v)]
        self.features = as_list(features)
        self.labels = as_list(labels)
        self.featuresMasks = [_tensor(x) for x in featuresMasks] \
            if featuresMasks else None
        self.labelsMasks = [_tensor(x) for x in labelsMasks] \
            if labelsMasks else None

    def getFeatures(self, i: Optional[int] = None):
        return self.features if i is None else self.features[i]

    def getLabels(self, i: Optional[int] = None):
        return self.labels if i is None else self.labels[i]

    def numExamples(self) -> int:
        return int(self.features[0].shape[0])
