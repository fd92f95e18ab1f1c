"""Word2Vec — user-facing embedding model atop SequenceVectors, parity with
``models/word2vec/Word2Vec.java`` (builder surface: minWordFrequency,
layerSize, windowSize, negativeSample, learningRate/minLearningRate, sampling,
epochs/iterations, seed, elementsLearningAlgorithm). Its tables live on the
card unless the caller passes ``device``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .sequencevectors import CBOW, SequenceVectors, SkipGram
from .tokenization import (DefaultTokenizerFactory, SentenceIterator,
                           TokenizerFactory)
from .vocab import VocabCache, VocabConstructor, vocab_from_counts


class Word2Vec:
    """Builder-style Word2Vec (Word2Vec.java:633 LoC).

    >>> w2v = Word2Vec(min_word_frequency=1, layer_size=32, window_size=5)
    >>> w2v.fit(["the quick brown fox", ...])
    >>> w2v.words_nearest("fox", 5)
    """

    def __init__(self, min_word_frequency: int = 5, layer_size: int = 100,
                 window_size: int = 5, negative_sample: int = 5,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 sampling: float = 0.0, epochs: int = 1, batch_size: int = 2048,
                 seed: int = 42, use_cbow: bool = False,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.negative_sample = negative_sample
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.sampling = sampling
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.use_cbow = use_cbow
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None
        self.sv: Optional[SequenceVectors] = None

    # -- training ----------------------------------------------------------

    def _tokenize(self, sentences: Iterable[str]) -> List[List[str]]:
        return [self.tokenizer.create(s).get_tokens() for s in sentences]

    def _trainer(self) -> SequenceVectors:
        return SequenceVectors(
            self.vocab, layer_size=self.layer_size, window=self.window_size,
            negative=self.negative_sample, learning_rate=self.learning_rate,
            min_learning_rate=self.min_learning_rate, sampling=self.sampling,
            epochs=self.epochs, batch_size=self.batch_size, seed=self.seed,
            algorithm=CBOW() if self.use_cbow else SkipGram(),
            device=self.device)

    def fit(self, sentences: Iterable[str]) -> List[float]:
        sents = list(sentences) if not isinstance(sentences, SentenceIterator) else list(sentences)
        token_lists = self._tokenize(sents)
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=self.negative_sample == 0).build(token_lists)
        self.sv = self._trainer()
        seqs = [[self.vocab.index_of(t) for t in toks if t in self.vocab]
                for toks in token_lists]
        return self.sv.fit([s for s in seqs if len(s) > 1])

    def load_tables(self, syn0, syn1, words: Optional[Sequence[str]] = None,
                    counts: Optional[Sequence[int]] = None,
                    total_count: Optional[int] = None) -> None:
        """Carry trained (V, D) tables in (numpy arrays). With ``words`` and
        ``counts`` (another package's vocabulary, in its order) the
        vocabulary is rebuilt from them first; without, the model must have
        been fit."""
        if words is not None:
            self.vocab = vocab_from_counts(
                words, counts, build_huffman_tree=self.negative_sample == 0,
                total_count=total_count)
            self.sv = self._trainer()
        if self.sv is None:
            raise RuntimeError("fit the model, or pass words and counts")
        self.sv.load_tables(syn0, syn1)

    # -- WordVectors query surface (models/embeddings/wordvectors) ---------

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and word in self.vocab

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        if not self.has_word(word):
            return None
        return self.sv.vector(self.vocab.index_of(word))

    def similarity(self, a: str, b: str) -> float:
        if not (self.has_word(a) and self.has_word(b)):
            return float("nan")
        return self.sv.similarity(self.vocab.index_of(a), self.vocab.index_of(b))

    def words_nearest(self, word: str, top_n: int = 10) -> List[Tuple[str, float]]:
        if not self.has_word(word):
            return []
        pairs = self.sv.nearest(self.vocab.index_of(word), top_n)
        return [(self.vocab.word_for(i), s) for i, s in pairs]

    @property
    def vectors(self) -> np.ndarray:
        return self.sv.vectors

    def vocab_words(self) -> List[str]:
        return [w.word for w in self.vocab.words]
