"""NLP of the port: :mod:`.transformer` (``TransformerLM``),
:mod:`.tokenization` (the WordPiece tokenizer and vocab helpers),
:mod:`.bert_iterator` (``BertIterator``) and :mod:`.word2vec` (Word2Vec,
ParagraphVectors, GloVe, FastText and the vector serializer)."""
from deeplearning4j_tpu_torch.nlp.bert_iterator import (  # noqa: F401
    BertIterator, BertMaskedLMMasker)
from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    BertWordPieceTokenizer, BertWordPieceTokenizerFactory, DefaultTokenizer,
    DefaultTokenizerFactory, load_vocab, make_vocab)
from deeplearning4j_tpu_torch.nlp.transformer import (  # noqa: F401
    TransformerLM, TransformerLMConfig)
from deeplearning4j_tpu_torch.nlp.word2vec import (  # noqa: F401
    FastText, Glove, ParagraphVectors, VocabCache, Word2Vec, WordVectors,
    WordVectorSerializer)
