"""Port parity: the BERT slice — WordPiece (``nlp/tokenization.py``),
``BertIterator`` (``nlp/bert_iterator.py``) and BERT built on SameDiff
(``zoo/bert.py``) — against the JAX package.

The tokenizer and the iterator are pure Python and numpy in both packages
(the masker draws from ``RandomState(seed)``), so their tokens and batches
must be equal bit for bit; so must ``Bert``'s initial variables, drawn from
``RandomState(config.seed)`` in the same order.  The model runs at
``BERT_SMALL`` (vocab 97, hidden 32, 2 layers of 4 heads, FFN 64, 16
positions): the encoder output and the MLM loss within 2e-5 (float32, the
same ops in another summation order), an 8-step FLOAT fit's losses and
variables within 1e-4 relative, and a BFLOAT16 fit's losses (bf16 compute
over f32 masters, the per-token loss in bf16 as the reference's) within
2e-2 relative.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nlp import bert_iterator as jbi
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.zoo.bert import Bert as JBert
from deeplearning4j_tpu.zoo.bert import BertConfig as JBertConfig
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nlp import bert_iterator as tbi
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.zoo import Bert, BertBase, BertConfig

from _torch_parity import (BERT_CORPUS, BERT_SMALL, JAX, PORT, _bert_batches,
                           _bert_pair, _np)

pytestmark = pytest.mark.torch_port

FWD_ATOL = 2e-5
FIT_RTOL = 1e-4
BF16_RTOL = 2e-2
B, T = 4, BERT_SMALL["maxSeqLength"]
TEXTS = BERT_CORPUS[:4] + ["Unbelievable!! Naïve café-goers, 42 times.",
                           "xylophone quizzically", ""]


def _j(a):
    return np.asarray(a.numpy())


def _iterators(task, sentences, batch=4, seq=16, seed=7):
    out = []
    for tok, bi in ((jtok, jbi), (ttok, tbi)):
        vocab = tok.make_vocab(BERT_CORPUS, size=60)
        out.append(bi.BertIterator.builder()
                   .tokenizer(tok.BertWordPieceTokenizerFactory(vocab))
                   .lengthHandling("FIXED_LENGTH", seq).minibatchSize(batch)
                   .sentenceProvider(sentences).task(task)
                   .masker(bi.BertMaskedLMMasker(0.3, seed=seed)).numLabels(3)
                   .build())
    return out


# ---------------------------------------------------------------------------
# tokenization and the iterator
# ---------------------------------------------------------------------------
def test_vocab_and_wordpiece_tokens_equal(tmp_path):
    jv = jtok.make_vocab(BERT_CORPUS + TEXTS, size=80)
    tv = ttok.make_vocab(BERT_CORPUS + TEXTS, size=80)
    assert jv == tv
    # a vocab without whole words, so words split into ## pieces
    pieces = {k: i for i, k in enumerate(k for k in tv if len(k) <= 3
                                         or k.startswith("["))}
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(pieces) + "\n")
    assert ttok.load_vocab(str(path)) == jtok.load_vocab(str(path))
    for v in (tv, str(path)):
        jf = jtok.BertWordPieceTokenizerFactory(v)
        tf = ttok.BertWordPieceTokenizerFactory(v)
        for text in TEXTS:
            assert tf.create(text).getTokens() == jf.create(text).getTokens()
    assert any(t.startswith("##") for t in ttok.BertWordPieceTokenizerFactory(
        str(path)).create(TEXTS[0]).getTokens())
    for text in TEXTS:
        assert ttok.DefaultTokenizerFactory().create(text).getTokens() == \
            jtok.DefaultTokenizerFactory().create(text).getTokens()


@pytest.mark.parametrize("task", ["UNSUPERVISED", "SEQ_CLASSIFICATION"])
def test_bert_iterator_batches_equal(task):
    sentences = BERT_CORPUS[:10] + TEXTS[4:]
    if task == "SEQ_CLASSIFICATION":
        sentences = [(s, i % 3) for i, s in enumerate(sentences)]
    jit, tit = _iterators(task, sentences)
    masked = 0
    for _epoch in range(2):
        n = 0
        for jm, tm in zip(jit, tit):
            for part in ("features", "labels", "featuresMasks",
                         "labelsMasks"):
                ja, ta = getattr(jm, part), getattr(tm, part)
                assert (ja is None) == (ta is None), part
                for x, y in zip(ja or [], ta or []):
                    assert (x is None) == (y is None), part
                    if x is not None:
                        assert isinstance(y, torch.Tensor)
                        np.testing.assert_array_equal(_np(y), _j(x))
                        assert _np(y).dtype == _j(x).dtype
            if tm.labelsMasks:
                masked += float(tm.labelsMasks[0].sum())
            n += 1
        assert n == 4 and not tit.hasNext()
    assert (masked > 0) == (task == "UNSUPERVISED")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_initial_variables_are_bit_identical():
    for task in ("mlm", "classification"):
        jb, tb = _bert_pair(task)
        jv, tv = jb.sd._var_values(), tb.sd._var_values()
        assert list(jv) == list(tv)
        for n in jv:
            np.testing.assert_array_equal(_np(tv[n]), np.asarray(jv[n]))
        assert [v.name() for v in tb.sd.variables()] == \
            [v.name() for v in jb.sd.variables()]


def test_encoder_output_and_mlm_loss_match():
    jb, tb = _bert_pair()
    (mds,) = _bert_batches(PORT, 1, B, T, BERT_SMALL["vocabSize"])
    toks, segs, mask = (_np(a) for a in mds.features)
    labels, lmask = (_np(a) for a in mds.labels)
    toks[1, 0], toks[2, 3] = -1, BERT_SMALL["vocabSize"] - 1
    ph = {"tokenIds": toks, "segmentIds": segs, "featMask": mask,
          "labels": labels, "labelMask": lmask}
    jo = jb.sd.output(ph, "encoder_out", "mlm_logits", "loss")
    to = tb.sd.output(ph, "encoder_out", "mlm_logits", "loss")
    for k in jo:
        np.testing.assert_allclose(_np(to[k]), _j(jo[k]), atol=FWD_ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(_np(tb.output(toks, segs, mask)),
                               _j(jb.output(toks, segs, mask)),
                               atol=FWD_ATOL, rtol=0)


def test_classifier_logits_and_loss_match():
    jb, tb = _bert_pair("classification", numLabels=3)
    (mds,) = _bert_batches(PORT, 1, B, T, BERT_SMALL["vocabSize"], seed=2)
    toks, segs, mask = (_np(a) for a in mds.features)
    labels = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    ph = {"tokenIds": toks, "segmentIds": segs, "featMask": mask,
          "labels": labels}
    jo = jb.sd.output(ph, "logits", "pooled", "loss")
    to = tb.sd.output(ph, "logits", "pooled", "loss")
    for k in jo:
        np.testing.assert_allclose(_np(to[k]), _j(jo[k]), atol=FWD_ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(_np(tb.output(toks, segs, mask, "logits")),
                               _j(jo["logits"]), atol=FWD_ATOL, rtol=0)


def _fit_pair(dataType, steps=8, lr=1e-3):
    jb, tb = _bert_pair()
    jb.setTrainingConfig(updater=JAdam(lr), dataType=dataType)
    tb.setTrainingConfig(updater=Adam(lr), dataType=dataType)
    V = BERT_SMALL["vocabSize"]
    jh = jb.sd.fit(_bert_batches(JAX, 2, B, T, V), epochs=steps // 2)
    th = tb.sd.fit(_bert_batches(PORT, 2, B, T, V), epochs=steps // 2)
    return jb, tb, np.array(jh.lossCurve()), np.array(th.lossCurve())


def test_float_fit_follows_the_reference():
    jb, tb, jl, tl = _fit_pair("FLOAT")
    assert tb.sd.iterationCount == jb.sd.iterationCount == 8
    np.testing.assert_allclose(tl, jl, rtol=FIT_RTOL)
    assert tl[-1] < tl[0]
    jv, tv = jb.sd._var_values(), tb.sd._var_values()
    for n in jv:
        j = np.asarray(jv[n])
        np.testing.assert_allclose(_np(tv[n]), j, rtol=FIT_RTOL,
                                   atol=FIT_RTOL * np.abs(j).max(),
                                   err_msg=n)
    for n in jb.sd._opt_state:
        for k in ("m", "v"):
            j = np.asarray(jb.sd._opt_state[n][k])
            np.testing.assert_allclose(
                _np(tb.sd._opt_state[n][k]), j, rtol=1e-3,
                atol=1e-3 * np.abs(j).max() + 1e-30, err_msg=f"{n}/{k}")


def test_bfloat16_fit_follows_the_reference():
    jb, tb, jl, tl = _fit_pair("BFLOAT16")
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=BF16_RTOL)
    # the masters stay float32
    assert all(v.dtype == torch.float32 for v in tb.sd._var_values().values())


def test_fit_through_bert_iterator_matches():
    """examples/bert_finetune.py's flow (the _BertBatches adapter) at 8 x 16,
    FLOAT, both packages from the same vocab, batches and variables."""
    curves = []
    for tok, bi, model, config, adam, kw in (
            (jtok, jbi, JBert, JBertConfig, JAdam, {}),
            (ttok, tbi, Bert, BertConfig, Adam, {"device": "cpu"})):
        vocab = tok.make_vocab(BERT_CORPUS, size=60)
        it = (bi.BertIterator.builder()
              .tokenizer(tok.BertWordPieceTokenizerFactory(vocab))
              .lengthHandling("FIXED_LENGTH", 16).minibatchSize(16)
              .sentenceProvider(BERT_CORPUS[:32])
              .task(bi.BertIterator.Task.UNSUPERVISED)
              .masker(bi.BertMaskedLMMasker(0.15)).build())
        m = model(config(**dict(BERT_SMALL, vocabSize=len(vocab))), **kw)
        m.setTrainingConfig(updater=adam(1e-3))
        curves.append(m.fit(it, epochs=2).lossCurve())
    assert len(curves[1]) == 4
    np.testing.assert_allclose(curves[1], curves[0], rtol=FIT_RTOL)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_bert_zip_loads_in_the_other_package(tmp_path, direction):
    jb, tb, _, _ = _fit_pair("FLOAT", steps=2)
    path = str(tmp_path / "bert.sdz")
    (mds,) = _bert_batches(PORT, 1, B, T, BERT_SMALL["vocabSize"], seed=3)
    toks, segs, mask = (_np(a) for a in mds.features)
    src, load = (jb, lambda: Bert.load(path, device="cpu")) \
        if direction == "jax->port" else (tb, lambda: JBert.load(path))
    src.save(path, saveUpdaterState=True)
    back = load()
    want = {n: np.asarray(_np(a)) for n, a in src.sd._arrays.items()}
    got = {n: np.asarray(_np(a)) for n, a in back.sd._arrays.items()}
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    out = lambda m: np.asarray(_np(m.output(toks, segs, mask)))
    np.testing.assert_allclose(out(back), out(src),
                               atol=FWD_ATOL, rtol=0)


def test_bert_base_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertBase()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Bert(BertConfig(**BERT_SMALL))
