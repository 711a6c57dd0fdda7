"""BertIterator — masked-LM / sequence-classification batch producer; the
port of ``deeplearning4j_tpu/nlp/bert_iterator.py``.  The masker draws from
numpy's ``RandomState(seed)`` as the reference's does, so both packages
give the same batches bit for bit; the batches hold CPU tensors (a model
moves them to its device).

Reference: deeplearning4j-nlp ``org/deeplearning4j/iterator/BertIterator.java``
(Task.UNSUPERVISED masked-LM and Task.SEQ_CLASSIFICATION; FIXED_LENGTH
handling; BertMaskedLMMasker 80/10/10 rule) feeding features
(tokenIds, segmentIds[, featureMask]) and MLM labels.

FIXED_LENGTH padding gives every batch the same shape.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.nlp.tokenization import (
    BertWordPieceTokenizerFactory)

__all__ = ["Task", "LengthHandling", "BertMaskedLMMasker", "BertIterator"]


class Task:
    UNSUPERVISED = "UNSUPERVISED"          # masked LM
    SEQ_CLASSIFICATION = "SEQ_CLASSIFICATION"


class LengthHandling:
    FIXED_LENGTH = "FIXED_LENGTH"
    ANY_LENGTH = "ANY_LENGTH"


class BertMaskedLMMasker:
    """80% [MASK] / 10% random / 10% unchanged, 15% of positions
    (reference: iterator/bert/BertMaskedLMMasker.java)."""

    def __init__(self, maskProb=0.15, maskTokenProb=0.8, randomTokenProb=0.1,
                 seed=12345):
        self.maskProb = maskProb
        self.maskTokenProb = maskTokenProb
        self.randomTokenProb = randomTokenProb
        self.rng = np.random.RandomState(seed)

    def maskSequence(self, ids: np.ndarray, maskTokenId: int, vocabSize: int,
                     special: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        out = ids.copy()
        labelMask = np.zeros_like(ids)
        for i, tok in enumerate(ids):
            if tok in special:
                continue
            if self.rng.rand() < self.maskProb:
                labelMask[i] = 1
                r = self.rng.rand()
                if r < self.maskTokenProb:
                    out[i] = maskTokenId
                elif r < self.maskTokenProb + self.randomTokenProb:
                    out[i] = self.rng.randint(0, vocabSize)
        return out, labelMask


class BertIterator:
    """Builder-configured iterator over sentences (reference API surface:
    BertIterator.Builder — tokenizer, lengthHandling, minibatchSize, task,
    vocabMap, sentenceProvider / sentencePairProvider)."""

    Task = Task
    LengthHandling = LengthHandling

    def __init__(self, tokenizer: BertWordPieceTokenizerFactory,
                 sentences: Sequence, task: str = Task.UNSUPERVISED,
                 maxLength: int = 128, batchSize: int = 32,
                 numLabels: int = 0,
                 masker: Optional[BertMaskedLMMasker] = None,
                 prependToken: str = "[CLS]", appendToken: str = "[SEP]"):
        """``sentences``: list of str (UNSUPERVISED) or (str, labelIdx)
        pairs (SEQ_CLASSIFICATION)."""
        self.tok = tokenizer
        self.vocab = tokenizer.getVocab()
        self.sentences = list(sentences)
        self.task = task
        self.maxLength = maxLength
        self.batchSize = batchSize
        self.numLabels = numLabels
        self.masker = masker or BertMaskedLMMasker()
        self.prepend = prependToken
        self.append = appendToken
        self._pos = 0
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.mask_id = self.vocab.get("[MASK]", 0)
        self.unk_id = self.vocab.get("[UNK]", 0)
        self._special = {self.pad_id, self.vocab.get(prependToken, -1),
                         self.vocab.get(appendToken, -1)}

    @staticmethod
    def builder():
        return _Builder()

    # -- iterator protocol -------------------------------------------------
    def hasNext(self) -> bool:
        return self._pos < len(self.sentences)

    def next(self) -> MultiDataSet:
        batch = self.sentences[self._pos:self._pos + self.batchSize]
        self._pos += len(batch)
        return self._encode(batch)

    def reset(self):
        self._pos = 0

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()

    # -- encoding ----------------------------------------------------------
    def _ids(self, text: str) -> List[int]:
        toks = self.tok.create(text).getTokens()
        ids = [self.vocab.get(t, self.unk_id) for t in toks]
        budget = self.maxLength - 2
        ids = ids[:budget]
        out = []
        if self.prepend:
            out.append(self.vocab[self.prepend])
        out.extend(ids)
        if self.append:
            out.append(self.vocab[self.append])
        return out

    def _encode(self, batch) -> MultiDataSet:
        b, T = len(batch), self.maxLength
        tokens = np.full((b, T), self.pad_id, np.int32)
        segments = np.zeros((b, T), np.int32)
        featMask = np.zeros((b, T), np.float32)
        if self.task == Task.SEQ_CLASSIFICATION:
            labels = np.zeros((b, self.numLabels), np.float32)
            for i, (text, lab) in enumerate(batch):
                ids = self._ids(text)
                tokens[i, :len(ids)] = ids
                featMask[i, :len(ids)] = 1.0
                labels[i, int(lab)] = 1.0
            return MultiDataSet(
                features=[tokens, segments],
                labels=[labels],
                featuresMasks=[featMask, None])
        # masked LM: labels = original ids; labelMask = masked positions
        V = len(self.vocab)
        mlm_in = tokens  # (pre-filled with PAD); receives the MASKED ids
        labelIds = np.full((b, T), self.pad_id, np.int32)
        labelMask = np.zeros((b, T), np.float32)
        for i, text in enumerate(batch):
            ids = np.asarray(self._ids(text), np.int32)
            masked, lm = self.masker.maskSequence(
                ids, self.mask_id, V, self._special)
            mlm_in[i, :len(masked)] = masked
            labelIds[i, :len(ids)] = ids
            labelMask[i, :len(ids)] = lm
            featMask[i, :len(ids)] = 1.0
        return MultiDataSet(
            features=[mlm_in, segments],
            labels=[labelIds],
            featuresMasks=[featMask, None],
            labelsMasks=[labelMask])


class _Builder:
    def __init__(self):
        self._kw: Dict = {}
        self._tok = None

    def tokenizer(self, t):
        self._tok = t
        return self

    def task(self, t):
        self._kw["task"] = t
        return self

    def lengthHandling(self, _mode, fixedLength: int):
        self._kw["maxLength"] = fixedLength
        return self

    def minibatchSize(self, n):
        self._kw["batchSize"] = n
        return self

    def sentenceProvider(self, sentences):
        self._kw["sentences"] = sentences
        return self

    def numLabels(self, n):
        self._kw["numLabels"] = n
        return self

    def masker(self, m):
        self._kw["masker"] = m
        return self

    def build(self) -> BertIterator:
        return BertIterator(self._tok, **self._kw)
