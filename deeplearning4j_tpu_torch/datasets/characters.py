"""Character-sequence iterator for char-RNN language modelling — the port
of ``deeplearning4j_tpu/datasets/characters.py`` (dl4j-examples'
``CharacterIterator.java``, the GravesLSTM char-modelling example,
BASELINE config 4): one-hot encodes a text corpus into ``(miniBatch,
nChars, exampleLength)`` feature sequences with labels one step ahead.

The example starts, the character set and the seeded shuffle
(``numpy.random.default_rng``) are the reference's, so one seed gives the
same batches in both packages.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

__all__ = ["CharacterIterator"]

_DEFAULT_CHARS = ("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                  "0123456789"
                  " \n\t!\"#$%&'()*+,-./:;<=>?@[]_")


class CharacterIterator(DataSetIterator):
    """One-hot char sequences from a text corpus.

    Each example is a slice of ``exampleLength + 1`` chars at a shuffled
    (seeded) multiple of ``exampleLength``: features = chars [0, L),
    labels = chars [1, L+1) — next-char prediction."""

    def __init__(self, text: str, miniBatchSize: int, exampleLength: int,
                 validChars: Optional[Sequence[str]] = None, seed: int = 123):
        chars = list(validChars) if validChars is not None \
            else sorted(set(text) | set(_DEFAULT_CHARS))
        self.charToIdx = {c: i for i, c in enumerate(chars)}
        self.idxToChar = {i: c for i, c in enumerate(chars)}
        # characters outside the valid set are dropped (the reference's
        # behaviour)
        self._data = np.asarray([self.charToIdx[c] for c in text
                                 if c in self.charToIdx], dtype=np.int32)
        if len(self._data) <= exampleLength + 1:
            raise ValueError("Corpus shorter than one example")
        self.miniBatchSize = int(miniBatchSize)
        self.exampleLength = int(exampleLength)
        self._seed = seed
        self.reset()

    def _numExamples(self) -> int:
        return (len(self._data) - 1) // self.exampleLength

    def reset(self) -> None:
        rng = np.random.default_rng(self._seed)
        starts = np.arange(self._numExamples()) * self.exampleLength
        rng.shuffle(starts)
        self._starts: List[int] = list(starts)

    def hasNext(self) -> bool:
        return len(self._starts) >= 1

    def numCharacters(self) -> int:
        return len(self.charToIdx)

    def inputColumns(self) -> int:
        return self.numCharacters()

    def totalOutcomes(self) -> int:
        return self.numCharacters()

    def batch(self) -> int:
        return self.miniBatchSize

    def next(self, num: int = 0) -> DataSet:
        n = min(num or self.miniBatchSize, len(self._starts))
        L, C = self.exampleLength, self.numCharacters()
        feats = np.zeros((n, C, L), dtype=np.float32)
        labels = np.zeros((n, C, L), dtype=np.float32)
        for i in range(n):
            s = self._starts.pop()
            seq = self._data[s:s + L + 1]
            feats[i, seq[:-1], np.arange(L)] = 1.0
            labels[i, seq[1:], np.arange(L)] = 1.0
        return self._applyPre(DataSet(feats, labels))

    def convertCharacterToIndex(self, c: str) -> int:
        return self.charToIdx[c]

    def convertIndexToCharacter(self, i: int) -> str:
        return self.idxToChar[int(i)]
