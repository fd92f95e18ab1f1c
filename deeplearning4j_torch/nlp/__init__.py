"""NLP / embeddings on the card — the port of the JAX package's ``nlp/``
(``deeplearning4j-nlp-parent``): tokenizers and iterators, the vocabulary
and its Huffman tree, SequenceVectors with Word2Vec, ParagraphVectors and
GloVe, the word2vec file formats, bag-of-words and TF-IDF, and
``CnnSentenceIterator``.

Training is batched index arrays through one update function on tensors —
gather rows, compute the negative-sampling / hierarchical-softmax objective,
scatter-add the sparse updates. The CJK and annotation tokenizers of the
reference are not ported yet.
"""

from .tokenization import (
    CommonPreprocessor,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    BasicLineIterator,
    CollectionSentenceIterator,
    LabelledDocument,
    CollectionLabelledIterator,
)
from .vocab import VocabWord, VocabCache, VocabConstructor, build_huffman
from .sequencevectors import SequenceVectors, SkipGram, CBOW
from .word2vec import Word2Vec
from .paragraphvectors import ParagraphVectors
from .glove import Glove, CoOccurrences
from .serializer import (
    write_word_vectors,
    read_word_vectors,
    write_word2vec_binary,
    read_word2vec_binary,
)
from .bagofwords import BagOfWordsVectorizer, TfidfVectorizer
from .iterator import CnnSentenceIterator

__all__ = [
    "CommonPreprocessor", "DefaultTokenizerFactory", "NGramTokenizerFactory",
    "BasicLineIterator", "CollectionSentenceIterator", "LabelledDocument",
    "CollectionLabelledIterator",
    "VocabWord", "VocabCache", "VocabConstructor", "build_huffman",
    "SequenceVectors", "SkipGram", "CBOW",
    "Word2Vec", "ParagraphVectors", "Glove", "CoOccurrences",
    "write_word_vectors", "read_word_vectors",
    "write_word2vec_binary", "read_word2vec_binary",
    "BagOfWordsVectorizer", "TfidfVectorizer", "CnnSentenceIterator",
]
