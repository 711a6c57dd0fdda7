"""The port's embedding tier (ROADMAP A12f) against the reference: Word2Vec's
family, DeepWalk and clustering.

- the reference's own ``tests/test_embeddings.py`` bodies and
  ``test_misc_breadth.py``'s t-SNE and k-means cases run against the port
  (``_torch_parity._reference_tests``), on the CPU, on the port's own
  draws but for GloVe's and DeepWalk's, which hold similarity orderings
  that a tiny corpus leaves to the draw (ROADMAP C37): those two run with
  the reference's initial tables carried into the port's trainers (the
  two RNGs never give the same bits);
- one step of every trainer kind (SGNS, CBOW, hierarchical softmax,
  fastText subwords, PV-DM, GloVe) against the reference's jitted step
  from the same tables and batch, duplicate ids included, at atol 1e-6;
- whole ``Word2Vec.fit`` / ``DeepWalk.fit`` runs against the reference's
  final tables; Lloyd's centers and assignments; t-SNE's Y from a
  carried start over 30 iterations at a rate the float noise does not
  outgrow (at the default rate the early exaggerated iterations grow a
  float difference ~10x an iteration, so a carried start does not carry
  a long run);
- ``workers > 1`` raises naming ROADMAP A10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp.word2vec as rw2v
import deeplearning4j_tpu_torch.nlp.word2vec as tw2v
from tests._torch_parity import (_cpu_default, _reference_tests,
                                 _run_reference_test)
from tests.test_embeddings import _corpus

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests' small CPU ops run on one intra-op thread: beside the
    suite's other workers, a thread pool per op mostly waits."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

#: float32 tables after one step: the same sums in another order
STEP_ATOL = 1e-6
#: after a whole small fit (2 epochs, ~100 steps), measured ~5e-7
FIT_ATOL = 1e-5

# the reference's distributed case trains over an 8-device mesh
# (Word2Vec(workers=8)): it waits for the parallel layer (ROADMAP A10);
# test_workers_raise_naming_a10 holds the port's refusal
_A10 = ("test_word2vec_distributed_workers_quality_parity",)
_, _EMB = _reference_tests("test_embeddings.py", exclude=_A10)
_, _BREADTH = _reference_tests("test_misc_breadth.py")
_CLUSTER = [c for c in _BREADTH if c[0] in (
    "test_barnes_hut_tsne_separates_clusters",
    "test_kmeans_clustering_recovers_blobs")]
_CASES = _EMB + _CLUSTER


def _ref_glove_params(n, d, seed):
    kw, kc = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.uniform(kw, (n, d), jnp.float32,
                                          -0.5 / d, 0.5 / d)),
            np.asarray(jax.random.uniform(kc, (n, d), jnp.float32,
                                          -0.5 / d, 0.5 / d)),
            np.zeros(n, np.float32), np.zeros(n, np.float32))


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's trainers start from the reference's draws for the same
    seed (syn0, GloVe's factors) unless given tables."""
    emb_init = tw2v._EmbeddingTrainer.__init__
    glove_init = tw2v._GloveTrainer.__init__

    def emb(self, vocabSize, layerSize, seed, learningRate, negative,
            extraRows=0, hs=False, device=None, syn0=None, syn1=None):
        if syn0 is None:
            syn0 = np.asarray(rw2v._EmbeddingTrainer(
                vocabSize, layerSize, seed, learningRate, negative,
                extraRows=extraRows, hs=hs).syn0)
        emb_init(self, vocabSize, layerSize, seed, learningRate, negative,
                 extraRows, hs, device, syn0, syn1)

    def glove(self, n, d, seed, lr, xMax, alpha, device=None, params=None):
        glove_init(self, n, d, seed, lr, xMax, alpha, device,
                   params or _ref_glove_params(n, d, seed))
    monkeypatch.setattr(tw2v._EmbeddingTrainer, "__init__", emb)
    monkeypatch.setattr(tw2v._GloveTrainer, "__init__", glove)


#: the reference's cases whose orderings the initial draw decides (C37)
_DRAWN = ("test_glove_learns_cooccurrence", "test_deepwalk_two_cliques")


@pytest.mark.parametrize("name,case", _CASES, ids=[i for i, _ in _CASES])
def test_reference_embedding_suite(name, case, tmp_path, monkeypatch,
                                   request):
    if name in _DRAWN:
        request.getfixturevalue("reference_draws")
    _cpu_default(monkeypatch)
    _run_reference_test(case, tmp_path, monkeypatch)


def test_only_the_a10_case_is_left_out():
    names = [n for n, _ in _EMB]
    assert len(names) == 22 and not set(_A10) & set(names)
    assert set(_DRAWN) <= set(names) and len(_CLUSTER) == 2


@pytest.mark.parametrize("cls", ["Word2Vec", "FastText"])
def test_workers_raise_naming_a10(cls):
    model = getattr(tw2v, cls)(sentences=_corpus(), workers=2,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A10"):
        model.fit()


def test_own_draw_is_the_seeded_host_generator():
    """Without carried tables: syn0 from a host ``torch.Generator``
    (uniform in ±0.5/d, the same on every device), syn1 zeros."""
    tr = tw2v._EmbeddingTrainer(50, 8, 3, 0.025, 5, extraRows=4,
                                device="cpu")
    want = (torch.rand((54, 8), generator=torch.Generator()
                       .manual_seed(3)) - 0.5) / 8
    assert torch.equal(tr.syn0, want) and tr.syn0.abs().max() <= 0.5 / 8
    assert tr.syn1.shape == (50, 8) and not tr.syn1.any()
    hs = tw2v._EmbeddingTrainer(50, 8, 3, 0.025, 5, hs=True, device="cpu")
    assert hs.syn1.shape == (49, 8)
    with pytest.raises(ValueError, match="expected"):
        tw2v._EmbeddingTrainer(50, 8, 3, 0.025, 5, device="cpu",
                               syn0=np.zeros((3, 8)))


# ---------------------------------------------------------------------------
# one step of each trainer kind against the reference's jitted step
# ---------------------------------------------------------------------------

V, D, K, B, EXTRA = 40, 16, 5, 64, 12


def _pair(hs=False, extra=0, seed=0):
    """(reference trainer, port trainer) from the same tables, syn1
    nonzero so both tables' gradients are exercised."""
    rng = np.random.RandomState(seed)
    ref = rw2v._EmbeddingTrainer(V, D, seed, 0.05, K, extraRows=extra,
                                 hs=hs)
    syn1 = rng.randn(*ref.syn1.shape).astype(np.float32) * 0.1
    ref.syn1 = jnp.asarray(syn1)
    syn0 = np.asarray(ref.syn0)
    port = tw2v._EmbeddingTrainer(V, D, seed, 0.05, K, extraRows=extra,
                                  hs=hs, device="cpu", syn0=syn0,
                                  syn1=syn1)
    return ref, port, rng


def _ids(rng, hi, shape):
    """Ids with duplicates: a quarter of the batch repeats id 3."""
    a = rng.randint(0, hi, shape).astype(np.int32)
    a.reshape(-1)[::4] = 3
    return a


def _check(ref, port, loss_ref, loss):
    assert loss == pytest.approx(loss_ref, rel=1e-6, abs=STEP_ATOL)
    np.testing.assert_allclose(port.syn0.numpy(), np.asarray(ref.syn0),
                               atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose(port.syn1.numpy(), np.asarray(ref.syn1),
                               atol=STEP_ATOL, rtol=0)


def test_sgns_step_equals_the_references():
    ref, port, rng = _pair()
    args = (_ids(rng, V, B), _ids(rng, V, B), _ids(rng, V, (B, K)))
    _check(ref, port, ref.train_batch(*args, lr=0.05),
           port.train_batch(*args, lr=0.05))


def _padded(rng, hi, width, extra_col=None):
    ids = _ids(rng, hi, (B, width))
    mask = (rng.rand(B, width) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[5] = 0.0                       # a row with no valid context
    if extra_col is not None:           # PV-DM's always-valid doc slot
        ids[:, -1] = extra_col
        mask[:, -1] = 1.0
    return ids, mask


def test_cbow_step_equals_the_references():
    ref, port, rng = _pair()
    ctx, mask = _padded(rng, V, 6)
    args = (ctx, mask, _ids(rng, V, B), _ids(rng, V, (B, K)))
    _check(ref, port, ref.train_batch_cbow(*args, lr=0.05),
           port.train_batch_cbow(*args, lr=0.05))


def test_pvdm_step_equals_the_references():
    """PV-DM: the CBOW step over window + doc rows (rows V.. of syn0)."""
    ref, port, rng = _pair(extra=EXTRA)
    ctx, mask = _padded(rng, V, 5, extra_col=V + rng.randint(0, EXTRA, B))
    args = (ctx, mask, _ids(rng, V, B), _ids(rng, V, (B, K)))
    _check(ref, port, ref.train_batch_cbow(*args),
           port.train_batch_cbow(*args))


def test_hierarchical_softmax_step_equals_the_references():
    sents = [[f"w{i}"] * (1 + (i * 7) % 13) for i in range(V)]
    P, C, M = rw2v._build_huffman(rw2v._build_vocab(sents, 1))
    ref, port, rng = _pair(hs=True)
    ctx = _ids(rng, V, B)
    args = (_ids(rng, V, B), P[ctx], C[ctx], M[ctx])
    _check(ref, port, ref.train_batch_hs(*args, lr=0.05),
           port.train_batch_hs(*args, lr=0.05))


def test_subword_step_equals_the_references():
    ref, port, rng = _pair(extra=EXTRA)
    sub, mask = _padded(rng, V + EXTRA, 7)
    args = (sub, mask, _ids(rng, V, B), _ids(rng, V, (B, K)))
    _check(ref, port, ref.train_batch_subword(*args, lr=0.05),
           port.train_batch_subword(*args, lr=0.05))


def test_glove_step_equals_the_references():
    """One AdaGrad step: the whole co-occurrence set in one batch of one
    epoch, from the reference's draw of the factors."""
    kw = dict(sentences=_corpus(), layerSize=D, epochs=1, seed=3,
              windowSize=3, batchSize=1 << 16, learningRate=0.05)
    ref = rw2v.Glove(**kw).fit()
    n = ref.vocab.numWords()
    port = tw2v.Glove(device="cpu", params=_ref_glove_params(n, D, 3),
                      **kw).fit()
    np.testing.assert_allclose(port.getWordVectorMatrix(),
                               ref.getWordVectorMatrix(), atol=STEP_ATOL,
                               rtol=0)
    assert port.vocab.words() == ref.vocab.words()


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------

def _vocab_size(min_freq=1):
    from deeplearning4j_tpu_torch.nlp import DefaultTokenizerFactory
    tok = DefaultTokenizerFactory()
    return rw2v._build_vocab([tok.create(s).getTokens() for s in _corpus()],
                             min_freq).numWords()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(useCBOW=True),
    dict(useHierarchicSoftmax=True, learningRate=0.05),
    dict(subsampling=1e-2, batchSize=64),
], ids=["sgns", "cbow", "hs", "subsampled"])
def test_word2vec_fit_equals_the_references(kw):
    kw = dict(sentences=_corpus(), layerSize=D, epochs=2, seed=7,
              windowSize=3, **kw)
    syn0 = np.asarray(rw2v._EmbeddingTrainer(
        _vocab_size(), D, 7, 0.025, 5,
        hs=kw.get("useHierarchicSoftmax", False)).syn0)
    ref = rw2v.Word2Vec(**kw).fit()
    port = tw2v.Word2Vec(device="cpu", syn0=syn0, **kw).fit()
    np.testing.assert_allclose(port.getWordVectorMatrix(),
                               ref.getWordVectorMatrix(), atol=FIT_ATOL,
                               rtol=0)
    for w in ("truck", "apple"):
        assert port.wordsNearest(w, 4) == ref.wordsNearest(w, 4)
    assert port.wordsNearest(["apple", "car"], ["banana"], n=5) == \
        ref.wordsNearest(["apple", "car"], ["banana"], n=5)
    assert port.similarity("apple", "banana") == pytest.approx(
        ref.similarity("apple", "banana"), abs=1e-5)


def test_fasttext_and_paragraph_vectors_fit_equal_the_references():
    kw = dict(sentences=_corpus(), layerSize=D, epochs=2, seed=7,
              windowSize=3, minN=3, maxN=4, bucket=200)
    n = _vocab_size()
    syn0 = np.asarray(rw2v._EmbeddingTrainer(n, D, 7, 0.025, 5,
                                             extraRows=200).syn0)
    ref = rw2v.FastText(**kw).fit()
    port = tw2v.FastText(device="cpu", syn0=syn0, **kw).fit()
    np.testing.assert_allclose(port.getWordVectorMatrix(),
                               ref.getWordVectorMatrix(), atol=FIT_ATOL)
    np.testing.assert_allclose(port.getWordVector("applesauce"),
                               ref.getWordVector("applesauce"),
                               atol=FIT_ATOL)
    docs = _corpus()[:16]
    for alg in ("PV-DM", "PV-DBOW"):
        pkw = dict(documents=docs, layerSize=D, epochs=3, seed=5,
                   windowSize=2, sequenceLearningAlgorithm=alg)
        rp = rw2v.ParagraphVectors(**pkw).fit()
        s0 = np.asarray(rw2v._EmbeddingTrainer(
            rp.vocab.numWords(), D, 5, 0.025, 5, extraRows=16).syn0)
        tp = tw2v.ParagraphVectors(device="cpu", syn0=s0, **pkw).fit()
        np.testing.assert_allclose(tp.getVector("DOC_3"),
                                   rp.getVector("DOC_3"), atol=FIT_ATOL)
        np.testing.assert_allclose(tp.getWordVectorMatrix(),
                                   rp.getWordVectorMatrix(), atol=FIT_ATOL)


def test_deepwalk_fit_equals_the_references():
    from deeplearning4j_tpu.graphs import DeepWalk as RDW
    from deeplearning4j_tpu.graphs import Graph as RG
    from deeplearning4j_tpu_torch.graphs import DeepWalk, Graph

    def ring(G):
        g = G(20)
        for i in range(20):
            g.addEdge(i, (i + 1) % 20)
            g.addEdge(i, (i + 5) % 20)
        return g
    kw = dict(vectorSize=D, windowSize=3, walksPerVertex=3, walkLength=10,
              seed=11, batchSize=128)
    ref = RDW(**kw)
    ref.initialize(ring(RG))
    syn0 = np.asarray(ref._trainer.syn0)
    ref.fit()
    port = DeepWalk(device="cpu", syn0=syn0, **kw)
    port.initialize(ring(Graph))
    port.fit()
    np.testing.assert_allclose(port._trainer.syn0.numpy(),
                               np.asarray(ref._trainer.syn0), atol=FIT_ATOL)
    assert port.verticesNearest(3, 4) == ref.verticesNearest(3, 4)
    np.testing.assert_allclose(port.getVertexVector(7),
                               ref.getVertexVector(7), atol=FIT_ATOL)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------

def _blobs(n=200, d=8, k=5, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 6
    return np.concatenate([rng.randn(n // k, d) + c for c in centers])


@pytest.mark.parametrize("pp", [True, False], ids=["kmeanspp", "random"])
def test_lloyd_centers_and_assignments_equal_the_references(pp):
    from deeplearning4j_tpu.clustering import KMeansClustering as RKM
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    X = _blobs()
    ref = RKM(8, maxIterations=20, useKMeansPlusPlus=pp, seed=2).applyTo(X)
    got = KMeansClustering(8, maxIterations=20, useKMeansPlusPlus=pp,
                           seed=2, device="cpu").applyTo(X)
    np.testing.assert_array_equal(got.assignments, ref.assignments)
    np.testing.assert_allclose(got.centers, ref.centers, atol=1e-5)
    assert got.inertia == pytest.approx(ref.inertia, rel=1e-5)


def test_tsne_from_a_carried_start_equals_the_references():
    """30 iterations through the lying and momentum switches at rate 10."""
    from deeplearning4j_tpu.clustering import BarnesHutTsne as RT
    from deeplearning4j_tpu_torch.clustering import BarnesHutTsne
    X = _blobs(seed=4)
    kw = dict(perplexity=10.0, seed=3, maxIter=30, learningRate=10.0,
              stopLyingIteration=20, switchMomentumIteration=25)
    ref = RT(**kw)
    Yr = ref.fit(X)
    y0 = np.asarray(1e-4 * jax.random.normal(jax.random.PRNGKey(3),
                                             (200, 2), jnp.float32))
    port = BarnesHutTsne(device="cpu", initialY=y0, **kw)
    Y = port.fit(X)
    np.testing.assert_allclose(Y, Yr, atol=1e-4 * np.abs(Yr).max(), rtol=0)
    assert port.klDivergence == pytest.approx(ref.klDivergence, rel=1e-5)


def test_c37_orderings_follow_the_draw_in_the_reference_too():
    """ROADMAP C37: from the reference's seed-4 draw (where its fit and
    the port's agree, test_glove_step_equals_the_references) GloVe fails
    the ordering the reference's test holds at seed 3; from the port's
    own seed-3 draw too."""
    kw = dict(sentences=_corpus(), layerSize=D, epochs=30, windowSize=3,
              device="cpu")
    n = _vocab_size()
    for g in (tw2v.Glove(seed=4, params=_ref_glove_params(n, D, 4), **kw),
              tw2v.Glove(seed=3, **kw)):
        g.fit()
        assert g.similarity("apple", "banana") <= \
            g.similarity("apple", "truck")


def test_host_batching_equals_the_references_loops():
    """The port builds the reference's batches with arrays: the window
    pairs, the row shuffle, the negatives' table search and the walks
    are the reference's loops' results, from the same draws (and leave
    the generator where the loops leave it)."""
    from deeplearning4j_tpu.graphs import Graph as RG
    from deeplearning4j_tpu.graphs import RandomWalkIterator as RWalk
    from deeplearning4j_tpu_torch.graphs import Graph, RandomWalkIterator
    rng = np.random.RandomState(0)
    ids = [list(rng.randint(0, 30, n)) for n in (0, 1, 2, 7, 40, 3)]
    ref_w2v = rw2v.Word2Vec(windowSize=4)
    port_w2v = tw2v.Word2Vec(windowSize=4, device="cpu")
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    want = ref_w2v._pairs(ids, r1)
    got = port_w2v._pairs(ids, r2)
    assert got.dtype == np.int32 and got.tolist() == [list(p) for p in want]
    r1.shuffle(want)
    tw2v._shuffle_rows(r2, got)
    assert got.tolist() == [list(p) for p in want]
    vocab = rw2v._build_vocab([[f"w{i}"] * (1 + i % 7) for i in range(30)], 1)
    samp = tw2v._NegativeSampler(vocab)
    np.testing.assert_array_equal(samp.draw_on(r2, (50, 5), "cpu").numpy(),
                                  rw2v._NegativeSampler(vocab).draw(r1,
                                                                    (50, 5)))
    assert r1.random_sample() == r2.random_sample()

    def graph(G):
        g = G(15)
        for i in range(15):
            for j in (1, 3, 7):
                g.addEdge(i, (i * j + 1) % 15)
        return g
    rw, pw = RWalk(graph(RG), 9, seed=4), RandomWalkIterator(graph(Graph), 9,
                                                             seed=4)
    while rw.hasNext():
        assert pw.next() == rw.next()
    assert not pw.hasNext()
