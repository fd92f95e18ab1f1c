"""DeepWalk — ``graph/models/deepwalk/DeepWalk.java`` (255 LoC) equivalent.

The reference trains skip-gram with hierarchical softmax over a Huffman tree
built on vertex degrees (``GraphHuffman.java``, coded by degree as
frequency). Here DeepWalk composes the shared pieces:

- walks: vectorized ``RandomWalkIterator`` batches (host)
- vocab: one VocabWord per vertex, count = degree → the Huffman builder
  (``nlp/vocab.py``) reproduces GraphHuffman's code assignment
- training: ``SequenceVectors`` with ``negative=0`` → the batched
  hierarchical-softmax skip-gram step on the card.

API parity: ``initialize``, ``fit(iterator)``, ``get_vertex_vector``,
``similarity``, ``verticesNearest`` (via SequenceVectors.nearest).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..nlp.sequencevectors import SequenceVectors, SkipGram
from ..nlp.vocab import VocabCache, VocabWord, build_huffman
from .graph import Graph
from .walks import RandomWalkIterator


def degree_vocab(graph: Graph) -> VocabCache:
    """One VocabWord per vertex, its degree as its count (degree 0 still
    gets a leaf: the reference uses degree as frequency)."""
    cache = VocabCache()
    degrees = graph.degrees()
    for v in range(graph.n):
        cache.add(VocabWord(word=str(v), count=max(int(degrees[v]), 1)))
    cache.total_count = int(sum(max(int(d), 1) for d in degrees))
    return cache


class DeepWalk:
    """DeepWalk.Builder parity: vectorSize, windowSize, learningRate, seed;
    ``fit(graph, walk_length)`` runs walks + skip-gram-HS in one call, on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.01, epochs: int = 1,
                 batch_size: int = 2048, seed: int = 12345,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.sv: Optional[SequenceVectors] = None

    # DeepWalk.java initialize(graph): build degree-frequency Huffman tree
    def initialize(self, graph: Graph) -> None:
        cache = degree_vocab(graph)
        build_huffman(cache)
        self.sv = SequenceVectors(cache, layer_size=self.vector_size,
                                  window=self.window_size, negative=0,
                                  learning_rate=self.learning_rate,
                                  min_learning_rate=self.learning_rate * 1e-2,
                                  epochs=self.epochs, batch_size=self.batch_size,
                                  seed=self.seed, algorithm=SkipGram(),
                                  device=self.device)

    def fit(self, graph: Graph, walk_length: int = 40,
            walks: Optional[Iterable[np.ndarray]] = None) -> List[float]:
        """Run random walks and train; pass ``walks`` to use a custom iterator
        (weighted walks, precomputed corpora...)."""
        if self.sv is None:
            self.initialize(graph)
        if walks is None:
            walks = RandomWalkIterator(graph, walk_length, seed=self.seed)
        return self.sv.fit(list(walks))

    def load_tables(self, syn0, syn1) -> None:
        """Carry trained (V, D) tables in (numpy arrays); the model must have
        been initialized or fit."""
        if self.sv is None:
            raise RuntimeError("initialize or fit the model first")
        self.sv.load_tables(syn0, syn1)

    # --- GraphVectors surface (models/GraphVectors.java) ---
    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self.sv.vector(v)

    @property
    def vectors(self) -> np.ndarray:
        return self.sv.vectors

    def similarity(self, a: int, b: int) -> float:
        return self.sv.similarity(a, b)

    def vertices_nearest(self, v: int, top_n: int = 10) -> List[Tuple[int, float]]:
        return self.sv.nearest(v, top_n)
