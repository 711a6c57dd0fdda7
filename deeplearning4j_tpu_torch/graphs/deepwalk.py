"""DeepWalk vertex embeddings — the port of
``deeplearning4j_tpu/graphs/deepwalk.py``.

Reference: deeplearning4j-graph ``org/deeplearning4j/graph/models/deepwalk/
DeepWalk.java`` + ``graph/Graph.java`` + ``iterator/RandomWalkIterator.java``
— uniform random walks fed to skip-gram with hierarchical softmax.

Walks and their (vertex, context) pairs are generated host-side from the
reference's ``RandomState`` draws, in its order (each walk's pairs
gathered by a cached index pattern), then train
through the same negative-sampling step as Word2Vec
(:class:`~deeplearning4j_tpu_torch.nlp.word2vec._EmbeddingTrainer`, the
tables on the device; negative sampling replaces the reference's
hierarchical softmax, as in the reference).  ``syn0`` / ``syn1`` start the
tables from given arrays.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.word2vec import (VocabCache, WordVectors,
                                                   _EmbeddingTrainer,
                                                   _shuffle_rows)


@functools.lru_cache(maxsize=None)
def _window_pairs(n: int, window: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (position, context position) index pairs of a walk of ``n``
    within ``window``, in the reference's loop order."""
    ii, jj = [], []
    for i in range(n):
        for j in range(max(0, i - window), min(n, i + window + 1)):
            if j != i:
                ii.append(i)
                jj.append(j)
    return np.asarray(ii, np.int64), np.asarray(jj, np.int64)


class Graph:
    """Undirected-by-default adjacency graph (reference: graph/Graph.java)."""

    def __init__(self, numVertices: int, allowMultipleEdges: bool = False):
        self.n = numVertices
        self._adj: List[List[int]] = [[] for _ in range(numVertices)]
        self._allowMulti = allowMultipleEdges

    def addEdge(self, a: int, b: int, directed: bool = False,
                value=None) -> None:
        if not self._allowMulti and b in self._adj[a]:
            return
        self._adj[a].append(b)
        if not directed and a != b:
            self._adj[b].append(a)

    def getConnectedVertices(self, v: int) -> List[int]:
        return list(self._adj[v])

    def numVertices(self) -> int:
        return self.n


class RandomWalkIterator:
    """Uniform random walks from every vertex (reference:
    iterator/RandomWalkIterator.java)."""

    def __init__(self, graph: Graph, walkLength: int, seed: int = 123):
        self.graph = graph
        self.walkLength = walkLength
        self.rng = np.random.RandomState(seed)
        self._order = self.rng.permutation(graph.numVertices())
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._order)

    def next(self) -> List[int]:
        v = int(self._order[self._i])
        self._i += 1
        walk = [v]
        for _ in range(self.walkLength - 1):
            nbrs = self.graph.getConnectedVertices(walk[-1])
            if not nbrs:
                break
            # the draw rng.choice(nbrs) makes, without its list-to-array
            # conversion
            walk.append(int(nbrs[self.rng.randint(len(nbrs))]))
        return walk

    def reset(self) -> None:
        self._i = 0
        self.rng.shuffle(self._order)


class DeepWalk:
    """Reference: DeepWalk.Builder().vectorSize(d).windowSize(w)
    .learningRate(lr).build(); initialize(graph); fit(iterator)."""

    def __init__(self, vectorSize: int = 64, windowSize: int = 4,
                 learningRate: float = 0.025, seed: int = 123,
                 walksPerVertex: int = 10, walkLength: int = 20,
                 negative: int = 5, batchSize: int = 1024, device=None,
                 syn0=None, syn1=None):
        self.vectorSize = vectorSize
        self.windowSize = windowSize
        self.learningRate = learningRate
        self.seed = seed
        self.walksPerVertex = walksPerVertex
        self.walkLength = walkLength
        self.negative = negative
        self.batchSize = batchSize
        self._device = resolve_device(device)
        self._syn0, self._syn1 = syn0, syn1
        self._trainer: Optional[_EmbeddingTrainer] = None
        self._graph: Optional[Graph] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(v):
                self._kw[name] = v
                return self

            return setter

        def build(self) -> "DeepWalk":
            import inspect
            known = set(inspect.signature(DeepWalk.__init__).parameters)
            return DeepWalk(**{k: v for k, v in self._kw.items()
                               if k in known})

    @staticmethod
    def builder() -> "DeepWalk.Builder":
        return DeepWalk.Builder()

    def initialize(self, graph: Graph) -> None:
        self._graph = graph
        self._trainer = _EmbeddingTrainer(graph.numVertices(),
                                          self.vectorSize, self.seed,
                                          self.learningRate, self.negative,
                                          device=self._device,
                                          syn0=self._syn0, syn1=self._syn1)

    def fit(self, iterator: Optional[RandomWalkIterator] = None) -> None:
        if self._trainer is None:
            raise RuntimeError("call initialize(graph) first")
        g = self._graph
        rng = np.random.RandomState(self.seed)
        pairs: List[np.ndarray] = []
        for rep in range(self.walksPerVertex):
            it = iterator or RandomWalkIterator(g, self.walkLength,
                                                seed=self.seed + rep)
            it.reset()
            while it.hasNext():
                walk = np.asarray(it.next(), np.int32)
                ii, jj = _window_pairs(len(walk), self.windowSize)
                pairs.append(np.stack([walk[ii], walk[jj]], 1))
        pairs_arr = np.concatenate(pairs) if pairs else \
            np.zeros((0, 2), np.int32)
        _shuffle_rows(rng, pairs_arr)
        n = g.numVertices()
        steps = max(1, (len(pairs_arr) + self.batchSize - 1) // self.batchSize)
        for si, i in enumerate(range(0, len(pairs_arr), self.batchSize)):
            b = pairs_arr[i:i + self.batchSize]
            negs = rng.randint(0, n, size=(len(b), self.negative)
                               ).astype(np.int32)
            # linear lr decay (reference: DeepWalk inherits word2vec decay);
            # without it the sum-reduced SGD diverges on dense pair streams
            lr = max(1e-4, self.learningRate * (1.0 - si / steps))
            self._trainer._step(b[:, 0], b[:, 1], negs, lr)

    def _wordvectors(self) -> WordVectors:
        """Vertex embeddings as a WordVectors over stringified vertex ids —
        one canonical implementation of the similarity math."""
        vocab = VocabCache()
        for v in range(self._graph.numVertices()):
            vocab.addToken(str(v))
        return WordVectors(vocab, self._trainer.syn0)

    def getVertexVector(self, v: int) -> np.ndarray:
        return self._trainer.syn0[v].cpu().numpy()

    def verticesNearest(self, v: int, n: int = 10) -> List[int]:
        return [int(w) for w in self._wordvectors().wordsNearest(str(v), n)]

    def similarity(self, a: int, b: int) -> float:
        return self._wordvectors().similarity(str(a), str(b))
