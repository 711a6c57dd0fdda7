"""NLP of the port: :mod:`.transformer` (``TransformerLM``),
:mod:`.tokenization` (the WordPiece tokenizer and vocab helpers) and
:mod:`.bert_iterator` (``BertIterator``).  Word2Vec and its family wait
for ROADMAP A12."""
from deeplearning4j_tpu_torch.nlp.bert_iterator import (  # noqa: F401
    BertIterator, BertMaskedLMMasker)
from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    BertWordPieceTokenizer, BertWordPieceTokenizerFactory, DefaultTokenizer,
    DefaultTokenizerFactory, load_vocab, make_vocab)
from deeplearning4j_tpu_torch.nlp.transformer import (  # noqa: F401
    TransformerLM, TransformerLMConfig)
