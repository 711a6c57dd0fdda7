"""Word2Vec / GloVe / ParagraphVectors / FastText — the port of
``deeplearning4j_tpu/nlp/word2vec.py``.

Reference: deeplearning4j-nlp ``org/deeplearning4j/models/word2vec/
Word2Vec.java`` (+ ``SkipGram``/``CBOW`` learning algorithms in
``models/embeddings/learning/impl/elements``), ``models/glove/Glove.java``,
``models/paragraphvectors/ParagraphVectors.java``, vocab machinery
(``models/word2vec/wordstore/inmemory/AbstractCache``), and
``WordVectorSerializer``.

The host side — vocabulary, subsampling, the unigram^0.75 negative table,
Huffman codes, window pairs, shuffles — is the reference's, drawing from
the same ``RandomState`` in the same order, so both packages see the same
batches; the pairs are built as arrays, and the negatives' table search
runs on the device from the host's uniforms.  The tables (syn0, syn1; GloVe's factors, biases and AdaGrad
accumulators) are tensors on the model's device.  A step gathers the
batch's rows, computes the reference's sum-reduced loss and its gradient
with respect to those rows in closed form, and applies the reference's
plain SGD step as a scatter-add of the touched rows (``index_add_``):
SGD has no state, so this is the same function as the reference's dense
``syn0 - lr * g0``, and duplicate ids in a batch sum as the dense gradient
does.  The fit loops leave each step's loss on the device; only the
public ``train_batch*`` methods read it back, as the reference's return
it.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import (DefaultTokenizerFactory,
                                                       TokenizerFactory)

__all__ = ["VocabCache", "WordVectors", "Word2Vec", "ParagraphVectors",
           "Glove", "WordVectorSerializer", "FastText"]


class VocabCache:
    """Reference: wordstore/inmemory/AbstractCache — word <-> index + counts."""

    def __init__(self):
        self._words: List[str] = []
        self._index: Dict[str, int] = {}
        self._counts: Counter = Counter()

    def addToken(self, word: str, count: int = 1) -> None:
        if word not in self._index:
            self._index[word] = len(self._words)
            self._words.append(word)
        self._counts[word] += count

    def indexOf(self, word: str) -> int:
        return self._index.get(word, -1)

    def wordAtIndex(self, idx: int) -> str:
        return self._words[idx]

    def containsWord(self, word: str) -> bool:
        return word in self._index

    def numWords(self) -> int:
        return len(self._words)

    def wordFrequency(self, word: str) -> int:
        return self._counts[word]

    def words(self) -> List[str]:
        return list(self._words)


def _build_vocab(sentences: Sequence[List[str]], minWordFrequency: int
                 ) -> VocabCache:
    counts = Counter(w for s in sentences for w in s)
    vocab = VocabCache()
    for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if c >= minWordFrequency:
            vocab.addToken(w, c)
    return vocab


class _NegativeSampler:
    """Unigram^0.75 sampler (reference table), cumsum precomputed ONCE so a
    draw is searchsorted O(log V) instead of np.random.choice's per-call
    O(V) distribution rebuild."""

    def __init__(self, vocab: VocabCache, power: float = 0.75):
        f = np.array([vocab.wordFrequency(w) for w in vocab.words()],
                     dtype=np.float64) ** power
        self._cum = np.cumsum(f / f.sum())
        self._dev: Dict[torch.device, torch.Tensor] = {}

    def draw(self, rng, shape) -> np.ndarray:
        u = rng.random_sample(shape)
        return np.searchsorted(self._cum, u).astype(np.int32)

    def draw_on(self, rng, shape, device) -> torch.Tensor:
        """``draw``'s ids on ``device``: the same uniforms from ``rng``, the
        table search on the device (float64 both, the same left-side
        rule), so the ids are ``draw``'s."""
        cum = self._dev.get(device)
        if cum is None:
            cum = self._dev[device] = torch.from_numpy(self._cum).to(device)
        u = torch.from_numpy(rng.random_sample(shape)).to(device)
        return torch.searchsorted(cum, u)


def _subsample(ids: List[List[int]], vocab: VocabCache, t: float, rng
               ) -> List[List[int]]:
    """Frequent-word subsampling: discard with p = 1 - sqrt(t/f) (the
    word2vec heuristic the reference's ``sampling`` knob applies)."""
    if t <= 0:
        return ids
    total = sum(vocab.wordFrequency(w) for w in vocab.words())
    freq = np.array([vocab.wordFrequency(w) / total for w in vocab.words()])
    keep = np.minimum(1.0, np.sqrt(t / np.maximum(freq, 1e-12)))
    return [[w for w in sent if rng.random_sample() < keep[w]]
            for sent in ids]


def _build_huffman(vocab: "VocabCache"):
    """Frequency-Huffman coding of the vocabulary (reference:
    ``models/word2vec/Huffman.java``).  Returns padded arrays
    ``(points (V, L) inner-node ids, codes (V, L) 0/1, mask (V, L))`` —
    the per-word root-to-leaf paths hierarchical softmax walks."""
    import heapq
    V = vocab.numWords()
    heap = [(vocab.wordFrequency(vocab.wordAtIndex(i)), i)
            for i in range(V)]
    heapq.heapify(heap)
    parent: Dict[int, int] = {}
    binary: Dict[int, int] = {}
    nxt = V
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1], parent[n2] = nxt, nxt
        binary[n1], binary[n2] = 0, 1
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = heap[0][1]
    paths, codes = [], []
    for i in range(V):
        p, c, n = [], [], i
        while n != root:
            c.append(binary[n])
            n = parent[n]
            p.append(n - V)          # inner-node row in syn1
        paths.append(p[::-1])
        codes.append(c[::-1])
    L = max(1, max(len(p) for p in paths))
    P = np.zeros((V, L), np.int32)
    C = np.zeros((V, L), np.float32)
    M = np.zeros((V, L), np.float32)
    for i, (p, c) in enumerate(zip(paths, codes)):
        P[i, :len(p)] = p
        C[i, :len(c)] = c
        M[i, :len(p)] = 1.0
    return P, C, M


def _shuffle_rows(rng, pairs: np.ndarray) -> None:
    """``rng.shuffle`` of an (N, 2) int32 array's rows, in place, through
    its 1-D int64 view: the same draws and the same permutation as
    shuffling the 2-D array (or the reference's list of pairs), without
    the 2-D path's per-row Python swaps."""
    rng.shuffle(pairs.view(np.int64).reshape(-1))


def _sgns(c, o, n):
    """The negative-sampling objective of hidden rows ``c`` (B, D) against
    positive rows ``o`` (B, D) and negative rows ``n`` (B, K, D):
    ``sum softplus(-c.o) + sum softplus(c.n)`` (= -log sig(c.o) -
    sum log sig(-c.n)), and its gradient with respect to c, o and n."""
    pos = (c * o).sum(-1)
    negd = torch.einsum("bd,bkd->bk", c, n)
    loss = (F.softplus(-pos) + F.softplus(negd).sum(-1)).sum()
    gpos = -torch.sigmoid(-pos)                    # d loss / d pos
    gneg = torch.sigmoid(negd)                     # d loss / d negd
    gc = gpos[:, None] * o + torch.einsum("bk,bkd->bd", gneg, n)
    return loss, gc, gpos[:, None] * c, gneg[..., None] * c[:, None, :]


class _EmbeddingTrainer:
    """Shared SGNS/CBOW/HS/subword machinery on device tables.

    ``syn0`` / ``syn1`` (numpy arrays or tensors of the tables' shapes)
    start the tables from given values — the reference's trainer's, in the
    tests — instead of the draw from a host ``torch.Generator`` seeded
    with ``seed`` (the same table on the card and on the CPU)."""

    def __init__(self, vocabSize: int, layerSize: int, seed: int,
                 learningRate: float, negative: int, extraRows: int = 0,
                 hs: bool = False, device=None, syn0=None, syn1=None):
        self.vocabSize = vocabSize
        self.layerSize = layerSize
        self.negative = max(1, int(negative))
        self.lr = learningRate
        self.device = resolve_device(device)
        rows = vocabSize + extraRows
        # HS: one output row per Huffman INNER node (V-1); SGNS: per word
        out_rows = max(1, vocabSize - 1) if hs else vocabSize
        if syn0 is None:
            # uniform(-0.5/d, 0.5/d) like the reference; syn1 zeros.  The
            # host generator makes the same table on every device
            gen = torch.Generator().manual_seed(int(seed))
            syn0 = (torch.rand((rows, layerSize), generator=gen) - 0.5) \
                / layerSize
        self.syn0 = self._table(syn0, (rows, layerSize))
        self.syn1 = self._table(
            torch.zeros((out_rows, layerSize)) if syn1 is None else syn1,
            (out_rows, layerSize))

    def _table(self, value, shape):
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.array(value, np.float32))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"table of shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        return t.to(self.device, torch.float32).clone()

    def _ids(self, *arrays):
        """Integer ids on the device as int64 (the gathers' and scatters'
        index type): the host arrays in one copy, each back in its own
        shape; tensors as they are."""
        out = [a.to(self.device, torch.int64)
               if isinstance(a, torch.Tensor) else None for a in arrays]
        host = [(i, np.asarray(a)) for i, a in enumerate(arrays)
                if out[i] is None]
        if host:
            flat = torch.from_numpy(np.concatenate(
                [a.reshape(-1).astype(np.int64) for _, a in host]))
            flat = flat.to(self.device)
            at = 0
            for i, a in host:
                out[i] = flat[at:at + a.size].view(a.shape)
                at += a.size
        return out

    def _mask(self, m):
        return torch.as_tensor(np.asarray(m, np.float32)).to(self.device)

    def _lr(self, lr):
        return float(lr if lr is not None else self.lr)

    # -- the steps: loss / batch on the device ----------------------------
    def _step(self, centers, contexts, negatives, lr=None):
        """SGNS minibatch: maximize log sig(c.o) + sum log sig(-c.n).

        SUM reduction (not mean): the gradient each pair contributes then
        matches the reference's per-pair SGD step, so ``learningRate``
        has the same meaning as Word2Vec.java's 0.025 default — the batch
        merely applies many reference-sized steps at once."""
        lr = self._lr(lr)
        ce, co, ne = self._ids(centers, contexts, negatives)
        loss, gc, go, gn = _sgns(self.syn0[ce], self.syn1[co],
                                 self.syn1[ne])
        self.syn0.index_add_(0, ce, gc, alpha=-lr)
        self.syn1.index_add_(0, co, go, alpha=-lr)
        self.syn1.index_add_(0, ne.reshape(-1),
                             gn.reshape(-1, self.layerSize), alpha=-lr)
        return loss / ce.shape[0]

    def _mean_rows(self, ids, mask):
        """The mean of each row's valid (mask 1) syn0 rows and the count
        it divides by."""
        cnt = mask.sum(-1, keepdim=True).clamp_min(1.0)
        return (self.syn0[ids] * mask[..., None]).sum(1) / cnt, cnt

    def _scatter_mean_grad(self, ids, mask, cnt, gh, lr):
        """The gradient of a masked mean back onto its syn0 rows."""
        g = (gh / cnt)[:, None, :] * mask[..., None]
        self.syn0.index_add_(0, ids.reshape(-1),
                             g.reshape(-1, self.layerSize), alpha=-lr)

    def _step_cbow(self, ctx, ctx_mask, centers, negatives, lr=None):
        """True CBOW: the MEAN of the window's input vectors predicts the
        center (vs skip-gram's per-pair prediction).  ctx is (B, C)
        padded, ctx_mask its validity."""
        lr = self._lr(lr)
        cx, ce, ne = self._ids(ctx, centers, negatives)
        mask = self._mask(ctx_mask)
        h, cnt = self._mean_rows(cx, mask)
        loss, gh, go, gn = _sgns(h, self.syn1[ce], self.syn1[ne])
        self._scatter_mean_grad(cx, mask, cnt, gh, lr)
        self.syn1.index_add_(0, ce, go, alpha=-lr)
        self.syn1.index_add_(0, ne.reshape(-1),
                             gn.reshape(-1, self.layerSize), alpha=-lr)
        return loss / ce.shape[0]

    def _step_hs(self, centers, points, codes, mask, lr=None):
        """Hierarchical softmax (reference SkipGram HS path): walk the
        context word's Huffman path, maximize sig(±center·node) per
        branch."""
        lr = self._lr(lr)
        ce, pt = self._ids(centers, points)
        codes, mask = self._mask(codes), self._mask(mask)
        v, nodes = self.syn0[ce], self.syn1[pt]          # (B, D), (B, L, D)
        dots = torch.einsum("bd,bld->bl", v, nodes)
        sgn = 1.0 - 2.0 * codes             # code 0 -> +1, 1 -> -1
        loss = (F.softplus(-sgn * dots) * mask).sum()
        gd = -sgn * torch.sigmoid(-sgn * dots) * mask    # d loss / d dots
        gv = torch.einsum("bl,bld->bd", gd, nodes)
        self.syn0.index_add_(0, ce, gv, alpha=-lr)
        self.syn1.index_add_(0, pt.reshape(-1),
                             (gd[..., None] * v[:, None, :]).reshape(
                                 -1, self.layerSize), alpha=-lr)
        return loss / ce.shape[0]

    def _step_subword(self, sub, sub_mask, contexts, negatives, lr=None):
        """fastText skip-gram: center = MEAN of subword rows (word +
        hashed n-grams — fastText's Model::computeHidden divides by the
        input count), SGNS objective against syn1."""
        lr = self._lr(lr)
        sb, co, ne = self._ids(sub, contexts, negatives)
        mask = self._mask(sub_mask)
        c, cnt = self._mean_rows(sb, mask)
        loss, gc, go, gn = _sgns(c, self.syn1[co], self.syn1[ne])
        self._scatter_mean_grad(sb, mask, cnt, gc, lr)
        self.syn1.index_add_(0, co, go, alpha=-lr)
        self.syn1.index_add_(0, ne.reshape(-1),
                             gn.reshape(-1, self.layerSize), alpha=-lr)
        return loss / sb.shape[0]

    # -- the reference's API: the step's loss as a float -------------------
    def train_batch_subword(self, sub, sub_mask, contexts, negatives,
                            lr=None):
        return float(self._step_subword(sub, sub_mask, contexts, negatives,
                                        lr))

    def train_batch_hs(self, centers, points, codes, mask, lr=None):
        return float(self._step_hs(centers, points, codes, mask, lr))

    def train_batch(self, centers, contexts, negatives, lr=None):
        return float(self._step(centers, contexts, negatives, lr))

    def train_batch_cbow(self, ctx, ctx_mask, centers, negatives, lr=None):
        return float(self._step_cbow(ctx, ctx_mask, centers, negatives, lr))


class WordVectors:
    """Lookup API shared by all embedding models (reference:
    ``models/embeddings/wordvectors/WordVectors.java``).  The vectors and
    their unit rows stay on the device; nearest-word queries rank there and
    bring back the top rows' indices."""

    def __init__(self, vocab: VocabCache, vectors, device=None):
        self.vocab = vocab
        if device is None and isinstance(vectors, torch.Tensor):
            device = vectors.device
        self._device = resolve_device(device)
        self._vec = torch.as_tensor(
            vectors if isinstance(vectors, torch.Tensor)
            else np.asarray(vectors)).to(self._device)
        norms = torch.linalg.vector_norm(self._vec, dim=1, keepdim=True)
        self._unit = self._vec / norms.clamp_min(1e-12)

    @property
    def device(self) -> torch.device:
        return self._device

    def getWordVector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.indexOf(word)
        return None if i < 0 else self._vec[i].cpu().numpy()

    def getWordVectorMatrix(self) -> np.ndarray:
        return self._vec.cpu().numpy()

    def hasWord(self, word: str) -> bool:
        return self.vocab.containsWord(word)

    def similarity(self, w1: str, w2: str) -> float:
        i, j = self.vocab.indexOf(w1), self.vocab.indexOf(w2)
        if i < 0 or j < 0:
            return float("nan")
        return float(self._unit[i] @ self._unit[j])

    def _top(self, sims, exclude, n: int) -> List[str]:
        """The ``n`` best-ranked words outside ``exclude``: a device top-k
        of ``n + len(exclude)``, then the host filter."""
        k = min(int(sims.shape[0]), n + len(exclude))
        order = torch.topk(sims, k).indices.cpu().tolist()
        return [self.vocab.wordAtIndex(i) for i in order
                if i not in exclude][:n]

    def wordsNearest(self, positive, negative=None, n: int = 10
                     ) -> List[str]:
        """Nearest words; with lists, the classic analogy arithmetic
        (reference: WordVectors.wordsNearest(positive, negative, n) —
        king - man + woman).  A single word/vector behaves as before."""
        if isinstance(negative, int):      # old 2-positional form:
            negative, n = None, negative   # wordsNearest(word, n)
        if isinstance(positive, (list, tuple)) or negative is not None:
            pos = list(positive) if isinstance(positive, (list, tuple)) \
                else [positive]
            neg = list(negative or [])
            ids = [self.vocab.indexOf(w) for w in pos + neg]
            if any(i < 0 for i in ids):
                return []
            # float64 arithmetic, as the reference's numpy does it
            unit = self._unit.double()
            sign = torch.tensor([1.0] * len(pos) + [-1.0] * len(neg),
                                dtype=torch.float64, device=self.device)
            vec = (unit[ids] * sign[:, None]).sum(0)
            nv = torch.linalg.vector_norm(vec).clamp_min(1e-12)
            return self._top(unit @ (vec / nv), set(ids), n)
        return self._wordsNearestSingle(positive, n)

    wordsNearestSum = wordsNearest

    def _wordsNearestSingle(self, word_or_vec, n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            i = self.vocab.indexOf(word_or_vec)
            if i < 0:
                return []
            v = self._unit[i]
            exclude = {i}
        else:
            v = torch.as_tensor(np.asarray(word_or_vec, np.float32)).to(
                self.device)
            v = v / torch.linalg.vector_norm(v).clamp_min(1e-12)
            exclude = set()
        return self._top(self._unit @ v, exclude, n)


class Word2Vec(WordVectors):
    """Skip-gram / CBOW with negative sampling.

    Reference: Word2Vec.Builder(minWordFrequency/layerSize/windowSize/
    negativeSample/learningRate/iterations/epochs/elementsLearningAlgorithm)
    .build(); fit().  ``syn0`` / ``syn1`` start the tables from given
    arrays (the reference's trainer's, in the tests)."""

    def __init__(self, sentences: Optional[Iterable[str]] = None,
                 minWordFrequency: int = 1, layerSize: int = 64,
                 windowSize: int = 5, seed: int = 123, iterations: int = 1,
                 epochs: int = 1, learningRate: float = 0.025,
                 minLearningRate: float = 1e-4, negativeSample: int = 5,
                 batchSize: int = 512, useCBOW: bool = False,
                 subsampling: float = 0.0,
                 tokenizerFactory: Optional[TokenizerFactory] = None,
                 elementsLearningAlgorithm: Optional[str] = None,
                 workers: int = 1, useHierarchicSoftmax: bool = False,
                 device=None, syn0=None, syn1=None):
        self.sentencesSrc = sentences
        self.minWordFrequency = minWordFrequency
        self.layerSize = layerSize
        self.windowSize = windowSize
        self.seed = seed
        self.iterations = iterations
        self.epochs = epochs
        self.learningRate = learningRate
        self.minLearningRate = minLearningRate
        self.negativeSample = negativeSample
        self.batchSize = batchSize
        self.useCBOW = useCBOW or (elementsLearningAlgorithm == "CBOW")
        self.subsampling = subsampling
        self.tokenizerFactory = tokenizerFactory or DefaultTokenizerFactory()
        # workers>1 = distributed SGNS over a device mesh (reference P5:
        # Word2Vec.Builder#workers fed VoidParameterServer shards)
        self.workers = int(workers)
        # reference default objective is HS; ours is SGNS — HS is opt-in
        # (skip-gram only, like the reference's SkipGram HS learner)
        self.useHierarchicSoftmax = bool(useHierarchicSoftmax)
        self._device = resolve_device(device)
        self._syn0, self._syn1 = syn0, syn1
        self._fitted = False

    class Builder:
        def __init__(self):
            self._kw = {}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(v=True):
                key = {"iterate": "sentences",
                       "negativeSampling": "negativeSample"}.get(name, name)
                self._kw[key] = v
                return self

            return setter

        def build(self) -> "Word2Vec":
            import inspect
            cls = self.__dict__.get("_cls", Word2Vec)
            kw = dict(self._kw)
            if cls is not Word2Vec and "sentences" in kw:
                kw["documents"] = kw.pop("sentences")
            known = set(inspect.signature(cls.__init__).parameters) | \
                set(inspect.signature(Word2Vec.__init__).parameters)
            return cls(**{k: v for k, v in kw.items() if k in known})

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    # -- training ---------------------------------------------------------
    def _tokenize(self) -> List[List[str]]:
        out = []
        for s in self.sentencesSrc:
            toks = self.tokenizerFactory.create(s).getTokens()
            if toks:
                out.append(toks)
        return out

    def _trainer(self, vocabSize: int, extraRows: int = 0,
                 hs: bool = False) -> _EmbeddingTrainer:
        return _EmbeddingTrainer(vocabSize, self.layerSize, self.seed,
                                 self.learningRate, self.negativeSample,
                                 extraRows=extraRows, hs=hs,
                                 device=self._device, syn0=self._syn0,
                                 syn1=self._syn1)

    def fit(self) -> "Word2Vec":
        if self.workers > 1:
            raise NotImplementedError(
                f"workers={self.workers} (distributed SGNS over a device "
                "mesh) is not ported yet: ROADMAP queue A10b, the mesh "
                "half of the parallel layer")
        sents = self._tokenize()
        vocab = _build_vocab(sents, self.minWordFrequency)
        rng = np.random.RandomState(self.seed)
        ids = [[vocab.indexOf(w) for w in s if vocab.containsWord(w)]
               for s in sents]
        ids = _subsample(ids, vocab, self.subsampling, rng)
        sampler = _NegativeSampler(vocab)
        trainer = self._trainer(vocab.numWords(),
                                hs=self.useHierarchicSoftmax)
        if self.useHierarchicSoftmax:
            if self.useCBOW:
                raise ValueError("useHierarchicSoftmax currently pairs "
                                 "with skip-gram (like the reference's "
                                 "SkipGram HS learner); disable CBOW")
            self._fit_skipgram_hs(ids, trainer, vocab, rng)
        elif self.useCBOW:
            self._fit_cbow(ids, trainer, sampler, rng)
        else:
            self._fit_skipgram(ids, trainer, sampler, rng)
        WordVectors.__init__(self, vocab, trainer.syn0)
        self.vocab = vocab
        self._fitted = True
        return self

    def _decayed_lr(self, step: int, total_steps: int) -> float:
        # linear lr decay to minLearningRate (reference behavior)
        return max(self.minLearningRate,
                   self.learningRate * (1.0 - step / total_steps))

    def _fit_skipgram(self, ids, trainer, sampler, rng) -> None:
        pairs = self._pairs(ids, rng)
        total = max(1, self.epochs * self.iterations *
                    ((len(pairs) + self.batchSize - 1) // self.batchSize))
        step = 0
        for _ in range(self.epochs):
            for _ in range(self.iterations):
                _shuffle_rows(rng, pairs)
                for i in range(0, len(pairs), self.batchSize):
                    batch = pairs[i:i + self.batchSize]
                    negs = sampler.draw_on(
                        rng, (len(batch), self.negativeSample),
                        trainer.device)
                    trainer._step(batch[:, 0], batch[:, 1], negs,
                                  self._decayed_lr(step, total))
                    step += 1

    def _fit_skipgram_hs(self, ids, trainer, vocab, rng) -> None:
        """Skip-gram with hierarchical softmax: (center, context) pairs;
        the CONTEXT word's Huffman path is the prediction target."""
        P, C, M = _build_huffman(vocab)
        pairs = self._pairs(ids, rng)
        total = max(1, self.epochs * self.iterations *
                    ((len(pairs) + self.batchSize - 1) // self.batchSize))
        step = 0
        for _ in range(self.epochs):
            for _ in range(self.iterations):
                _shuffle_rows(rng, pairs)
                for i in range(0, len(pairs), self.batchSize):
                    batch = pairs[i:i + self.batchSize]
                    ctx = batch[:, 1]
                    trainer._step_hs(batch[:, 0], P[ctx], C[ctx], M[ctx],
                                     self._decayed_lr(step, total))
                    step += 1

    def _cbow_examples(self, ids, rng) -> list:
        """(center, context ids) of every position with a context, with
        the reference's random window shrink."""
        examples = []
        for sent in ids:
            for pos, c in enumerate(sent):
                b = rng.randint(1, self.windowSize + 1)
                ctx = [sent[pos + off] for off in range(-b, b + 1)
                       if off != 0 and 0 <= pos + off < len(sent)]
                if ctx:
                    examples.append((c, ctx))
        return examples

    @staticmethod
    def _padded(batch, width: int):
        """A batch of (center, ids) as centers, (B, width) ids padded with
        0 and their 0/1 mask."""
        B = len(batch)
        centers = np.array([b_[0] for b_ in batch], np.int32)
        ctx = np.zeros((B, width), np.int32)
        mask = np.zeros((B, width), np.float32)
        for r, (_, cx) in enumerate(batch):
            ctx[r, :len(cx)] = cx
            mask[r, :len(cx)] = 1.0
        return centers, ctx, mask

    def _fit_cbow(self, ids, trainer, sampler, rng) -> None:
        """CBOW: window-mean of input vectors predicts the center word."""
        C = 2 * self.windowSize
        examples = self._cbow_examples(ids, rng)
        total = max(1, self.epochs * self.iterations *
                    ((len(examples) + self.batchSize - 1) // self.batchSize))
        step = 0
        for _ in range(self.epochs):
            for _ in range(self.iterations):
                rng.shuffle(examples)
                for i in range(0, len(examples), self.batchSize):
                    centers, ctx, mask = self._padded(
                        examples[i:i + self.batchSize], C)
                    negs = sampler.draw_on(
                        rng, (len(centers), self.negativeSample),
                        trainer.device)
                    trainer._step_cbow(ctx, mask, centers, negs,
                                       self._decayed_lr(step, total))
                    step += 1

    def _pairs(self, ids: List[List[int]], rng) -> np.ndarray:
        """Skip-gram (center, context) pairs with the reference's random
        window shrink, as an (N, 2) int32 array in the reference's order:
        by sentence, position, then offset.  A sentence's shrinks are one
        vectorised draw, which gives the reference's per-token draws
        (``RandomState.randint``'s array and scalar forms read the stream
        alike), and shuffling the array permutes as shuffling the
        reference's list does."""
        w = self.windowSize
        offs = np.array([o for o in range(-w, w + 1) if o != 0])
        out = []
        for sent in ids:
            n = len(sent)
            if not n:
                continue
            b = rng.randint(1, w + 1, size=n)
            j = np.arange(n)[:, None] + offs[None, :]
            keep = (np.abs(offs)[None, :] <= b[:, None]) & (j >= 0) & (j < n)
            s = np.asarray(sent, np.int32)
            out.append(np.stack([np.broadcast_to(s[:, None], j.shape)[keep],
                                 s[j[keep]]], 1))
        return np.concatenate(out) if out else np.zeros((0, 2), np.int32)


class ParagraphVectors(Word2Vec):
    """Doc embeddings (reference: models/paragraphvectors/
    ParagraphVectors.java, labels = doc ids).  Two modes:

    - ``sequenceLearningAlgorithm="PV-DBOW"`` (default, the reference's
      ``DBOW``): the doc vector predicts each of its words (SGNS pairs).
    - ``"PV-DM"`` (the reference's ``DM``, distributed-memory mean): the
      MEAN of window context vectors + the doc vector predicts the center
      word — reuses the CBOW step with the doc row as an always-valid
      extra context slot.
    """

    def __init__(self, documents: Optional[Sequence[str]] = None,
                 labels: Optional[Sequence[str]] = None,
                 sequenceLearningAlgorithm: str = "PV-DBOW", **kw):
        super().__init__(sentences=documents, **kw)
        self._labels = list(labels) if labels else None
        alg = sequenceLearningAlgorithm.upper().replace("_", "-")
        if alg in ("DBOW", "PV-DBOW"):
            self.sequenceLearningAlgorithm = "PV-DBOW"
        elif alg in ("DM", "PV-DM"):
            self.sequenceLearningAlgorithm = "PV-DM"
        else:
            raise ValueError(
                f"Unknown sequenceLearningAlgorithm {sequenceLearningAlgorithm!r}")

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        b = Word2Vec.Builder()
        b._cls = ParagraphVectors
        return b

    def fit(self) -> "ParagraphVectors":
        # one row PER INPUT DOCUMENT (empty docs keep their row so
        # user-supplied labels stay aligned; they just contribute no pairs)
        docs = [self.tokenizerFactory.create(s).getTokens()
                for s in self.sentencesSrc]
        if self._labels is None:
            self._labels = [f"DOC_{i}" for i in range(len(docs))]
        if len(self._labels) != len(docs):
            raise ValueError(f"{len(self._labels)} labels for "
                             f"{len(docs)} documents")
        vocab = _build_vocab([d for d in docs if d], self.minWordFrequency)
        nW = vocab.numWords()
        ids = [[vocab.indexOf(w) for w in s if vocab.containsWord(w)]
               for s in docs]
        sampler = _NegativeSampler(vocab)
        trainer = self._trainer(nW, extraRows=len(docs))
        rng = np.random.RandomState(self.seed)
        if self.sequenceLearningAlgorithm == "PV-DM":
            self._fit_pvdm(ids, nW, trainer, sampler, rng)
        else:
            # PV-DBOW pairs: (doc_row, word)
            pairs = np.array([(nW + d, w) for d, sent in enumerate(ids)
                              for w in sent], np.int32).reshape(-1, 2)
            for _ in range(max(1, self.epochs)):
                for _ in range(max(1, self.iterations)):
                    _shuffle_rows(rng, pairs)
                    for i in range(0, len(pairs), self.batchSize):
                        batch = pairs[i:i + self.batchSize]
                        negs = sampler.draw_on(
                            rng, (len(batch), self.negativeSample),
                            trainer.device)
                        trainer._step(batch[:, 0], batch[:, 1], negs)
        WordVectors.__init__(self, vocab, trainer.syn0[:nW])
        docs_host = trainer.syn0[nW:].cpu().numpy()
        self._docvecs = {lbl: docs_host[i]
                         for i, lbl in enumerate(self._labels)}
        return self

    def _fit_pvdm(self, ids, nW, trainer, sampler, rng) -> None:
        """PV-DM: window context + doc vector (always-valid extra context
        slot) averaged to predict the center word via the CBOW step."""
        C = 2 * self.windowSize + 1          # + 1 slot for the doc row
        examples = []
        for d, sent in enumerate(ids):
            for pos, c in enumerate(sent):
                b = rng.randint(1, self.windowSize + 1)
                ctx = [sent[pos + off] for off in range(-b, b + 1)
                       if off != 0 and 0 <= pos + off < len(sent)]
                examples.append((c, ctx + [nW + d]))
        for _ in range(max(1, self.epochs)):
            for _ in range(max(1, self.iterations)):
                rng.shuffle(examples)
                for i in range(0, len(examples), self.batchSize):
                    centers, ctx, mask = self._padded(
                        examples[i:i + self.batchSize], C)
                    negs = sampler.draw_on(
                        rng, (len(centers), self.negativeSample),
                        trainer.device)
                    trainer._step_cbow(ctx, mask, centers, negs)

    def getVector(self, label: str) -> Optional[np.ndarray]:
        return self._docvecs.get(label)

    def similarityToLabel(self, text_or_label1: str, label2: str) -> float:
        v1 = self._docvecs.get(text_or_label1)
        v2 = self._docvecs.get(label2)
        if v1 is None or v2 is None:
            return float("nan")
        den = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(v1 @ v2 / max(den, 1e-12))


class _GloveTrainer:
    """GloVe's factors W, C, biases bw, bc and their AdaGrad accumulators
    (initialised to ones) on the device; one step is the reference's
    minibatch AdaGrad on the mean weighted squared error (the factors
    drawn from a host generator, as the embedding tables are).  The gradient of
    the batch is scattered into dense zeros (``index_add_``), so rows the
    batch does not touch get the reference's zero gradient exactly.
    ``params`` = (W, C, bw, bc) starts from given arrays instead of the
    seeded draw."""

    def __init__(self, n: int, d: int, seed: int, lr: float, xMax: float,
                 alpha: float, device=None, params=None):
        self.device = resolve_device(device)
        self.lr, self.xMax, self.alpha = lr, xMax, alpha
        if params is None:
            gen = torch.Generator().manual_seed(int(seed))
            params = [(torch.rand((n, d), generator=gen) - 0.5) / d
                      for _ in range(2)]
            params += [torch.zeros(n), torch.zeros(n)]
        shapes = [(n, d), (n, d), (n,), (n,)]
        self.params = []
        for p, shape in zip(params, shapes):
            t = p if isinstance(p, torch.Tensor) else \
                torch.from_numpy(np.array(p, np.float32))
            if tuple(t.shape) != shape:
                raise ValueError(f"GloVe table of shape {tuple(t.shape)}, "
                                 f"expected {shape}")
            self.params.append(t.to(self.device, torch.float32).clone())
        self.accum = [torch.ones_like(p) for p in self.params]

    def step(self, r, c, x):
        """One AdaGrad step on co-occurrences (r, c, x); the batch's mean
        loss, on the device."""
        W, C, bw, bc = self.params
        r = torch.as_tensor(np.asarray(r, np.int64)).to(self.device)
        c = torch.as_tensor(np.asarray(c, np.int64)).to(self.device)
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        wgt = torch.clamp_max((x / self.xMax) ** self.alpha, 1.0)
        wr, cc = W[r], C[c]
        err = (wr * cc).sum(-1) + bw[r] + bc[c] - torch.log(x)
        loss = (wgt * err * err).mean()
        gp = 2.0 * wgt * err / x.shape[0]        # d loss / d pred
        grads = [torch.zeros_like(W).index_add_(0, r, gp[:, None] * cc),
                 torch.zeros_like(C).index_add_(0, c, gp[:, None] * wr),
                 torch.zeros_like(bw).index_add_(0, r, gp),
                 torch.zeros_like(bc).index_add_(0, c, gp)]
        for p, a, g in zip(self.params, self.accum, grads):
            a.add_(g * g)
            p.sub_(self.lr * g / a.sqrt())
        return loss


class Glove(WordVectors):
    """GloVe: weighted least squares on log co-occurrence.

    Reference: models/glove/Glove.java.  The co-occurrence matrix builds
    host-side (sparse dict), then AdaGrad minibatch steps on the dense
    factorization (the reference's Glove also uses AdaGrad), its
    accumulators on the device with the factors.  ``params`` = (W, C, bw,
    bc) starts from given arrays."""

    def __init__(self, sentences: Optional[Iterable[str]] = None,
                 minWordFrequency: int = 1, layerSize: int = 64,
                 windowSize: int = 5, seed: int = 123, epochs: int = 25,
                 learningRate: float = 0.05, xMax: float = 100.0,
                 alpha: float = 0.75, batchSize: int = 4096,
                 tokenizerFactory: Optional[TokenizerFactory] = None,
                 device=None, params=None):
        self.sentencesSrc = sentences
        self.minWordFrequency = minWordFrequency
        self.layerSize = layerSize
        self.windowSize = windowSize
        self.seed = seed
        self.epochs = epochs
        self.learningRate = learningRate
        self.xMax = xMax
        self.alpha = alpha
        self.batchSize = batchSize
        self.tokenizerFactory = tokenizerFactory or DefaultTokenizerFactory()
        self._device = resolve_device(device)
        self._params = params

    def _cooccurrences(self, sents, vocab):
        cooc: Dict = {}
        for sent in sents:
            idx = [vocab.indexOf(w) for w in sent if vocab.containsWord(w)]
            for i, wi in enumerate(idx):
                for j in range(max(0, i - self.windowSize), i):
                    wj = idx[j]
                    inc = 1.0 / (i - j)
                    cooc[(wi, wj)] = cooc.get((wi, wj), 0.0) + inc
                    cooc[(wj, wi)] = cooc.get((wj, wi), 0.0) + inc
        items = list(cooc.items())
        rows = np.array([k[0] for k, _ in items], np.int32)
        cols = np.array([k[1] for k, _ in items], np.int32)
        vals = np.array([v for _, v in items], np.float32)
        return rows, cols, vals

    def fit(self) -> "Glove":
        sents = []
        for s in self.sentencesSrc:
            toks = self.tokenizerFactory.create(s).getTokens()
            if toks:
                sents.append(toks)
        vocab = _build_vocab(sents, self.minWordFrequency)
        rows, cols, vals = self._cooccurrences(sents, vocab)
        tr = _GloveTrainer(vocab.numWords(), self.layerSize, self.seed,
                           self.learningRate, self.xMax, self.alpha,
                           device=self._device, params=self._params)
        rng = np.random.RandomState(self.seed)
        order = np.arange(len(vals))
        for _ in range(self.epochs):
            rng.shuffle(order)
            for i in range(0, len(order), self.batchSize):
                sl = order[i:i + self.batchSize]
                tr.step(rows[sl], cols[sl], vals[sl])
        WordVectors.__init__(self, vocab, tr.params[0] + tr.params[1])
        return self


class WordVectorSerializer:
    """Text-format vector serde (reference: WordVectorSerializer.java —
    writeWord2VecModel / readWord2VecModel with the standard
    '<word> <v0> <v1> ...' lines)."""

    @staticmethod
    def writeWord2VecModel(model: WordVectors, path: str) -> None:
        mat = model.getWordVectorMatrix()
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{mat.shape[0]} {mat.shape[1]}\n")
            for i, w in enumerate(model.vocab.words()):
                vec = " ".join(f"{v:.6f}" for v in mat[i])
                f.write(f"{w} {vec}\n")

    writeWordVectors = writeWord2VecModel

    @staticmethod
    def readWord2VecModel(path: str, device=None) -> WordVectors:
        vocab = VocabCache()
        vecs = []
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline().split()
            # "<count> <dim>" header is OPTIONAL in the wild — a 2-int first
            # line is a header, anything else is the first data row
            expect = None
            if len(first) == 2 and all(t.lstrip("-").isdigit()
                                       for t in first):
                expect = (int(first[0]), int(first[1]))
            elif first:
                vocab.addToken(first[0])
                vecs.append([float(v) for v in first[1:]])
            for line in f:
                parts = line.split()   # tolerate runs of whitespace
                if len(parts) < 2:
                    continue
                vocab.addToken(parts[0])
                vecs.append([float(v) for v in parts[1:]])
        if expect is not None and expect[0] != len(vecs):
            raise ValueError(f"vector file header promises {expect[0]} "
                             f"rows, found {len(vecs)} (truncated file?)")
        return WordVectors(vocab, np.asarray(vecs, dtype=np.float32),
                           device=device)

    loadTxtVectors = readWord2VecModel


class FastText(Word2Vec):
    """Subword (character n-gram) embeddings — fastText.

    Reference: deeplearning4j-nlp ``models/fasttext/FastText.java`` (a
    JFastText wrapper in the reference; native here).  A word's vector is
    the MEAN of its own row and its hashed character-n-gram rows
    (boundary-marked ``<word>``, fastText's computeHidden average), so
    morphology is shared across the vocabulary and **out-of-vocabulary
    words get vectors from their n-grams alone**.

    Training is skip-gram negative sampling where the center
    representation is the subword mean: one batched step (padded
    subword-id gather + mean) instead of fastText's per-pair loop.
    """

    def __init__(self, sentences=None, minN: int = 3, maxN: int = 6,
                 bucket: int = 20000, **kw):
        super().__init__(sentences=sentences, **kw)
        self.minN = int(minN)
        self.maxN = int(maxN)
        self.bucket = int(bucket)

    def _ngrams(self, word: str) -> List[str]:
        w = f"<{word}>"
        out = []
        for n in range(self.minN, self.maxN + 1):
            for i in range(0, max(0, len(w) - n) + 1):
                g = w[i:i + n]
                if g != w:          # the full token has its own row
                    out.append(g)
        return out

    @staticmethod
    def _hash(s: str) -> int:
        # fastText's FNV-1a 32-bit
        h = 2166136261
        for ch in s.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h

    def _subword_ids(self, word: str, word_idx: int, nW: int) -> List[int]:
        return [word_idx] + [nW + (self._hash(g) % self.bucket)
                             for g in self._ngrams(word)]

    def _subword_table(self, vocab):
        """(SUB (V, L) padded subword rows of each word, SM its mask)."""
        nW = vocab.numWords()
        sub = [self._subword_ids(vocab.wordAtIndex(i), i, nW)
               for i in range(nW)]
        L = max(len(s) for s in sub)
        SUB = np.zeros((nW, L), np.int32)
        SM = np.zeros((nW, L), np.float32)
        for i, s in enumerate(sub):
            SUB[i, :len(s)] = s
            SM[i, :len(s)] = 1.0
        return SUB, SM

    def fit(self) -> "FastText":
        if self.workers > 1:
            raise NotImplementedError(
                f"workers={self.workers} (distributed SGNS over a device "
                "mesh) is not ported yet: ROADMAP queue A10b, the mesh "
                "half of the parallel layer")
        sents = self._tokenize()
        vocab = _build_vocab(sents, self.minWordFrequency)
        nW = vocab.numWords()
        rng = np.random.RandomState(self.seed)
        ids = [[vocab.indexOf(w) for w in s if vocab.containsWord(w)]
               for s in sents]
        ids = _subsample(ids, vocab, self.subsampling, rng)
        sampler = _NegativeSampler(vocab)
        trainer = self._trainer(nW, extraRows=self.bucket)
        SUB, SM = self._subword_table(vocab)
        pairs = self._pairs(ids, rng)
        total = max(1, self.epochs * self.iterations *
                    ((len(pairs) + self.batchSize - 1) // self.batchSize))
        step = 0
        for _ in range(self.epochs):
            for _ in range(self.iterations):
                _shuffle_rows(rng, pairs)
                for i in range(0, len(pairs), self.batchSize):
                    batch = pairs[i:i + self.batchSize]
                    centers = batch[:, 0]
                    negs = sampler.draw_on(
                        rng, (len(batch), self.negativeSample),
                        trainer.device)
                    trainer._step_subword(
                        SUB[centers], SM[centers], batch[:, 1], negs,
                        self._decayed_lr(step, total))
                    step += 1
        table = trainer.syn0
        # combined per-word vectors (subword mean), like fastText's .vec
        sub = torch.as_tensor(SUB, dtype=torch.int64).to(table.device)
        sm = torch.as_tensor(SM).to(table.device)
        combined = (table[sub] * sm[..., None]).sum(1) \
            / sm.sum(1, keepdim=True).clamp_min(1.0)
        WordVectors.__init__(self, vocab, combined)
        self.vocab = vocab
        self._table = table
        self._nW = nW
        self._fitted = True
        return self

    def getWordVector(self, word: str):
        v = super().getWordVector(word)
        if v is not None:
            return v
        # OOV: n-gram rows alone (fastText's signature behavior)
        gids = [self._nW + (self._hash(g) % self.bucket)
                for g in self._ngrams(word)]
        if not gids:
            return None
        return self._table[gids].mean(0).cpu().numpy()
