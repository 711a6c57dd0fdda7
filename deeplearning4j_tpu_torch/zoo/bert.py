"""BERT built as a SameDiff graph — BASELINE config 3; the port of
``deeplearning4j_tpu/zoo/bert.py``.

The reference has no native BERT model class: BERT arrives by TF import
into SameDiff and is fine-tuned with ``SameDiff.fit``.  This builder gives
the same end state natively — embeddings, N transformer encoder blocks and
an MLM or classifier head on one SameDiff graph — so the importer (ROADMAP
A12c) and the builder meet at the same graph API.

The initial variables are drawn from numpy's ``RandomState(seed)`` in the
reference's order, so one config gives bit-identical initial variables in
both packages.  Attention is the graph's ``multiHeadDotProductAttention``
op (plain ops with a -1e9 key mask), never the flash kernels, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import (History, SameDiff,
                                                        TrainingConfig)
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.learning.config import Adam

__all__ = ["BertConfig", "Bert", "BertBase"]


@dataclasses.dataclass
class BertConfig:
    vocabSize: int = 30522
    hiddenSize: int = 768
    numLayers: int = 12
    numHeads: int = 12
    intermediateSize: int = 3072
    maxSeqLength: int = 128
    typeVocabSize: int = 2
    initializerRange: float = 0.02
    task: str = "mlm"              # "mlm" | "classification"
    numLabels: int = 2
    seed: int = 12345


class Bert:
    """Builds the BERT graph on a SameDiff on ``device`` (``cuda`` unless
    the caller asks for another) and exposes fit/output.

    ``sd`` is a plain SameDiff — save/load, calculateGradients and
    TrainingConfig work on it unchanged."""

    def __init__(self, config: BertConfig, device=None):
        self.config = config
        self.sd = SameDiff.create(device)
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        c = self.config
        sd = self.sd
        rng = np.random.RandomState(c.seed)
        init = lambda *shape: (rng.randn(*shape) * c.initializerRange
                               ).astype(np.float32)

        T, H = c.maxSeqLength, c.hiddenSize

        tokens = sd.placeholder("tokenIds", dtype=np.int32, shape=(None, T))
        segments = sd.placeholder("segmentIds", dtype=np.int32,
                                  shape=(None, T))
        featMask = sd.placeholder("featMask", shape=(None, T))

        wordEmb = sd.var("bert/embeddings/word", init(c.vocabSize, H))
        posEmb = sd.var("bert/embeddings/position", init(T, H))
        segEmb = sd.var("bert/embeddings/token_type", init(c.typeVocabSize, H))
        embLnG = sd.var("bert/embeddings/LayerNorm/gamma",
                        np.ones(H, np.float32))
        embLnB = sd.var("bert/embeddings/LayerNorm/beta",
                        np.zeros(H, np.float32))

        x = sd.nn().embeddingLookup(wordEmb, tokens)            # (b, T, H)
        x = x + sd.nn().embeddingLookup(segEmb, segments)
        x = x + posEmb                                          # bcast (T,H)
        x = sd.nn().layerNorm(x, embLnG, embLnB, name="embeddings_out")

        for i in range(c.numLayers):
            x = self._block(x, featMask, i, init)
        self.encoderOut = x.rename("encoder_out")               # (b, T, H)

        if c.task == "mlm":
            labels = sd.placeholder("labels", dtype=np.int32, shape=(None, T))
            labelMask = sd.placeholder("labelMask", shape=(None, T))
            g = sd.var("cls/transform/gamma", np.ones(H, np.float32))
            b = sd.var("cls/transform/beta", np.zeros(H, np.float32))
            tw = sd.var("cls/transform/W", init(H, H))
            tb = sd.var("cls/transform/b", np.zeros(H, np.float32))
            h = sd.nn().gelu(sd.nn().linear(x, tw, tb))
            h = sd.nn().layerNorm(h, g, b)
            outB = sd.var("cls/predictions/bias",
                          np.zeros(c.vocabSize, np.float32))
            # the MLM decoder reuses the word embeddings: their gradient
            # sums over both uses
            logits = (h.mmul(wordEmb, transposeB=True) + outB).rename(
                "mlm_logits")                                   # (b, T, V)
            sd.loss().sparseSoftmaxCrossEntropy(logits, labels,
                                                weights=labelMask,
                                                name="loss")
        else:
            labels = sd.placeholder("labels", shape=(None, c.numLabels))
            cls0 = sd.constant(np.zeros(1, np.int32), name="cls_index")
            cls = sd._op("gather", [x, cls0], {"axis": 1})      # (b, 1, H)
            cls = sd._op("squeeze", [cls], {"axis": 1})         # (b, H)
            pw = sd.var("bert/pooler/W", init(H, H))
            pb = sd.var("bert/pooler/b", np.zeros(H, np.float32))
            pooled = sd.math().tanh(sd.nn().linear(cls, pw, pb),
                                    name="pooled")
            cw = sd.var("classifier/W", init(H, c.numLabels))
            cb = sd.var("classifier/b", np.zeros(c.numLabels, np.float32))
            logits = sd.nn().linear(pooled, cw, cb, name="logits")
            sd.loss().softmaxCrossEntropy(labels, logits, name="loss")

    # ------------------------------------------------------------------
    def _block(self, x, featMask, i: int, init):
        c = self.config
        sd = self.sd
        H = c.hiddenSize
        p = f"bert/encoder/layer_{i}"
        Wq = sd.var(f"{p}/attention/Wq", init(H, H))
        Wk = sd.var(f"{p}/attention/Wk", init(H, H))
        Wv = sd.var(f"{p}/attention/Wv", init(H, H))
        Wo = sd.var(f"{p}/attention/Wo", init(H, H))
        attn = sd.nn().multiHeadDotProductAttention(
            x, x, x, Wq, Wk, Wv, Wo, mask=featMask, nHeads=c.numHeads)
        g1 = sd.var(f"{p}/attention/LayerNorm/gamma", np.ones(H, np.float32))
        b1 = sd.var(f"{p}/attention/LayerNorm/beta", np.zeros(H, np.float32))
        x = sd.nn().layerNorm(x + attn, g1, b1)

        Wi = sd.var(f"{p}/intermediate/W", init(H, c.intermediateSize))
        Bi = sd.var(f"{p}/intermediate/b",
                    np.zeros(c.intermediateSize, np.float32))
        Wo2 = sd.var(f"{p}/output/W", init(c.intermediateSize, H))
        Bo2 = sd.var(f"{p}/output/b", np.zeros(H, np.float32))
        ffn = sd.nn().linear(sd.nn().gelu(sd.nn().linear(x, Wi, Bi)),
                             Wo2, Bo2)
        g2 = sd.var(f"{p}/output/LayerNorm/gamma", np.ones(H, np.float32))
        b2 = sd.var(f"{p}/output/LayerNorm/beta", np.zeros(H, np.float32))
        return sd.nn().layerNorm(x + ffn, g2, b2)

    # ------------------------------------------------------------------
    def setTrainingConfig(self, updater=None, **kw):
        c = self.config
        feats = ["tokenIds", "segmentIds", "featMask"]
        labs = ["labels", "labelMask"] if c.task == "mlm" else ["labels"]
        self.sd.setTrainingConfig(TrainingConfig(
            updater=updater or Adam(2e-5),
            dataSetFeatureMapping=feats, dataSetLabelMapping=labs, **kw))

    def fit(self, iterator, epochs: int = 1) -> History:
        """Feed BertIterator MultiDataSets into SameDiff.fit bindings."""
        if self.sd._training_config is None:
            self.setTrainingConfig()
        return self.sd.fit(_BertBatches(iterator, self.config), epochs)

    def output(self, tokenIds, segmentIds, featMask, out="encoder_out"):
        ph = {"tokenIds": tokenIds, "segmentIds": segmentIds,
              "featMask": featMask}
        return self.sd.output(ph, out)[out]

    def save(self, path, saveUpdaterState=False):
        self.sd.save(path, saveUpdaterState)

    @staticmethod
    def load(path, task="mlm", config: Optional[BertConfig] = None,
             device=None) -> "Bert":
        b = object.__new__(Bert)
        b.config = config or BertConfig(task=task)
        b.sd = SameDiff.load(path, device=device)
        return b


class _BertBatches:
    """Adapts BertIterator MultiDataSets to the TrainingConfig's mappings:
    features (tokenIds, segmentIds[, featMask]) and labels (labels[,
    labelMask])."""

    def __init__(self, it, config: BertConfig):
        self.it = it
        self.config = config

    def reset(self):
        if hasattr(self.it, "reset"):
            self.it.reset()

    def __iter__(self):
        for mds in self.it:
            feats = [mds.features[0], mds.features[1]]
            fm = mds.featuresMasks[0] if mds.featuresMasks else None
            labs = list(mds.labels)
            lm = (mds.labelsMasks[0] if mds.labelsMasks else None)
            features = feats + ([fm] if fm is not None else [])
            labels = labs + ([lm] if lm is not None else [])
            yield MultiDataSet(features=features, labels=labels)


def BertBase(task="mlm", device=None, **kw) -> Bert:
    """BERT-base (12L/768H/12A) — the config-3 flagship."""
    return Bert(BertConfig(task=task, **kw), device=device)
