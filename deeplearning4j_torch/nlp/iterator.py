"""CnnSentenceIterator (the port's copy of the JAX package's
``nlp/iterator.py``, on the host) — parity with
``iterator/CnnSentenceDataSetIterator.java`` (516 LoC): turns labelled
sentences + word vectors into fixed-shape (B, maxlen, dim) tensors + one-hot
labels + a sequence mask, ready for Convolution1D sentence classifiers.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .tokenization import (DefaultTokenizerFactory, LabelledDocument,
                           TokenizerFactory)


class CnnSentenceIterator:
    def __init__(self, docs: Sequence[LabelledDocument], word_vectors,
                 batch_size: int = 32, max_length: int = 64,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 shuffle_seed: Optional[int] = None):
        """``word_vectors``: any object with has_word(w) + get_word_vector(w)
        (e.g. Word2Vec) — mirrors the reference taking a WordVectors."""
        self.docs = list(docs)
        self.wv = word_vectors
        self.batch_size = batch_size
        self.max_length = max_length
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.labels = sorted({lab for d in self.docs for lab in d.labels})
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self._rng = np.random.default_rng(shuffle_seed) if shuffle_seed is not None else None
        probe = self.wv.get_word_vector(next(
            w for d in self.docs for w in self.tokenizer.create(d.content).get_tokens()
            if self.wv.has_word(w)))
        self.dim = len(probe)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = np.arange(len(self.docs))
        if self._rng is not None:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            B = len(idx)
            x = np.zeros((B, self.max_length, self.dim), np.float32)
            y = np.zeros((B, len(self.labels)), np.float32)
            mask = np.zeros((B, self.max_length), np.float32)
            for r, di in enumerate(idx):
                d = self.docs[di]
                toks = [t for t in self.tokenizer.create(d.content).get_tokens()
                        if self.wv.has_word(t)][:self.max_length]
                for c, t in enumerate(toks):
                    x[r, c] = self.wv.get_word_vector(t)
                    mask[r, c] = 1.0
                for lab in d.labels:
                    y[r, self._label_idx[lab]] = 1.0
            yield x, y, mask
