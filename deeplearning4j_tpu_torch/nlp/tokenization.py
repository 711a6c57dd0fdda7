"""Tokenizers — the port of ``deeplearning4j_tpu/nlp/tokenization.py``, a
copy of its pure Python (the port imports nothing of the JAX package).

Reference: deeplearning4j-nlp ``org/deeplearning4j/text/tokenization/
tokenizer/**`` — ``DefaultTokenizer`` (whitespace/punct) and
``BertWordPieceTokenizer`` + factory (greedy longest-match-first WordPiece
with ``##`` continuations, matching the original BERT reference
implementation the Java class mirrors).
"""
from __future__ import annotations

import re
import unicodedata
from typing import Dict, Iterable, List, Optional

__all__ = ["Tokenizer", "TokenizerFactory", "DefaultTokenizer",
           "DefaultTokenizerFactory", "BertWordPieceTokenizer",
           "BertWordPieceTokenizerFactory", "load_vocab", "make_vocab"]


class Tokenizer:
    """One document's token stream (reference: tokenizer/Tokenizer.java)."""

    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def hasMoreTokens(self) -> bool:
        return self._pos < len(self._tokens)

    def nextToken(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return t

    def countTokens(self) -> int:
        return len(self._tokens)

    def getTokens(self) -> List[str]:
        return list(self._tokens)


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


_PUNCT_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class DefaultTokenizer(Tokenizer):
    def __init__(self, text: str):
        super().__init__(_PUNCT_RE.findall(text))


class DefaultTokenizerFactory(TokenizerFactory):
    def create(self, text: str) -> Tokenizer:
        return DefaultTokenizer(text)


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _basic_tokenize(text: str, lower: bool) -> List[str]:
    if lower:
        text = _strip_accents(text.lower())
    out: List[str] = []
    for tok in text.split():
        buf = ""
        for ch in tok:
            cat = unicodedata.category(ch)
            if cat.startswith("P") or cat.startswith("S"):
                if buf:
                    out.append(buf)
                    buf = ""
                out.append(ch)
            else:
                buf += ch
        if buf:
            out.append(buf)
    return out


class BertWordPieceTokenizer(Tokenizer):
    """Greedy longest-match-first WordPiece (reference:
    tokenizer/BertWordPieceTokenizer.java)."""

    UNK = "[UNK]"

    def __init__(self, text: str, vocab: Dict[str, int], lower: bool = True,
                 maxCharsPerWord: int = 100):
        tokens: List[str] = []
        for word in _basic_tokenize(text, lower):
            if len(word) > maxCharsPerWord:
                tokens.append(self.UNK)
                continue
            sub, start, ok = [], 0, True
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    if piece in vocab:
                        cur = piece
                        break
                    end -= 1
                if cur is None:
                    ok = False
                    break
                sub.append(cur)
                start = end
            tokens.extend(sub if ok else [self.UNK])
        super().__init__(tokens)


class BertWordPieceTokenizerFactory(TokenizerFactory):
    """Reference: tokenizerfactory/BertWordPieceTokenizerFactory.java."""

    def __init__(self, vocab, lower: bool = True):
        """``vocab``: dict token->id, or a path to a BERT vocab.txt."""
        self.vocab = load_vocab(vocab) if isinstance(vocab, str) else dict(vocab)
        self.lower = lower

    def create(self, text: str) -> BertWordPieceTokenizer:
        return BertWordPieceTokenizer(text, self.vocab, self.lower)

    def getVocab(self) -> Dict[str, int]:
        return dict(self.vocab)


def load_vocab(path: str) -> Dict[str, int]:
    """Read a BERT vocab.txt (one token per line, id = line number)."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def make_vocab(corpus: Iterable[str], size: int = 1000,
               lower: bool = True) -> Dict[str, int]:
    """Build a small WordPiece-style vocab from a corpus (whole words +
    single chars + specials) — for tests and from-scratch training; real
    pretrained runs load the published vocab.txt."""
    from collections import Counter
    counts: Counter = Counter()
    chars: set = set()
    for text in corpus:
        for w in _basic_tokenize(text, lower):
            counts[w] += 1
            chars.update(w)
    vocab: Dict[str, int] = {}
    for tok in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]:
        vocab[tok] = len(vocab)
    for ch in sorted(chars):
        if ch not in vocab:
            vocab[ch] = len(vocab)
        cont = "##" + ch
        if cont not in vocab:
            vocab[cont] = len(vocab)
    for w, _n in counts.most_common():
        if len(vocab) >= size:
            break
        if w not in vocab:
            vocab[w] = len(vocab)
    return vocab
