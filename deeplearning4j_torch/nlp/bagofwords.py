"""Bag-of-words / TF-IDF vectorizers (the port's copy of the JAX package's
``nlp/bagofwords.py``, on the host) — parity with the reference's
``bagofwords/vectorizer/`` (``BagOfWordsVectorizer.java``,
``TfidfVectorizer.java``).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    """Counts per-document term frequencies over the fitted vocab."""

    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None

    def fit(self, documents: Iterable[str]) -> "BagOfWordsVectorizer":
        token_lists = [self.tokenizer.create(d).get_tokens() for d in documents]
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False).build(token_lists)
        return self

    def transform(self, documents: Iterable[str]) -> np.ndarray:
        docs = list(documents)
        out = np.zeros((len(docs), len(self.vocab)), np.float32)
        for r, d in enumerate(docs):
            for t in self.tokenizer.create(d).get_tokens():
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[r, i] += 1.0
        return out

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        return self.fit(documents).transform(documents)


class TfidfVectorizer(BagOfWordsVectorizer):
    """``TfidfVectorizer.java`` — tf * log(N / df) weighting (the reference
    uses the classic idf; smoothed variant selectable)."""

    def __init__(self, min_word_frequency: int = 1, smooth: bool = True,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        super().__init__(min_word_frequency, tokenizer_factory)
        self.smooth = smooth
        self.idf: Optional[np.ndarray] = None

    def fit(self, documents: Iterable[str]) -> "TfidfVectorizer":
        docs = list(documents)
        super().fit(docs)
        df = np.zeros(len(self.vocab), np.float64)
        for d in docs:
            seen = {self.vocab.index_of(t)
                    for t in self.tokenizer.create(d).get_tokens()}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        n = len(docs)
        if self.smooth:
            self.idf = np.log((1.0 + n) / (1.0 + df)) + 1.0
        else:
            self.idf = np.log(np.maximum(n / np.maximum(df, 1.0), 1.0))
        return self

    def transform(self, documents: Iterable[str]) -> np.ndarray:
        tf = super().transform(documents)
        return (tf * self.idf[None, :].astype(np.float32))
