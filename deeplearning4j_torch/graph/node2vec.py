"""node2vec — second-order biased random walks + skip-gram, on the card.

The reference ships only a stub (``models/node2vec/``); this is the full
Grover & Leskovec 2016 algorithm, as the JAX package has it: walk transition
probability reweighted by return parameter ``p`` and in-out parameter ``q``
relative to the previous step, then the shared SequenceVectors skip-gram
trainer (negative sampling) on the walk corpus.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..nlp.sequencevectors import SequenceVectors, SkipGram
from .deepwalk import degree_vocab
from .graph import Graph


class Node2Vec:
    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 p: float = 1.0, q: float = 1.0, negative: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 batch_size: int = 2048, seed: int = 12345,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.p = p
        self.q = q
        self.negative = negative
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.sv: Optional[SequenceVectors] = None

    def _biased_walks(self, g: Graph, rng: np.random.Generator) -> List[np.ndarray]:
        """Second-order walks: weight * (1/p if back, 1 if neighbor-of-prev,
        1/q otherwise). The per-step reweight is vectorized over the current
        vertex's whole neighbor slice; membership in the previous vertex's
        neighbors is a binary search of its sorted slice (the JAX package's
        ``np.isin`` gives the same booleans, at a sort a step). The walks and
        the draws from ``rng`` are the JAX package's."""
        sorted_nbrs = [np.sort(g.neighbors(v)) for v in range(g.n)]
        walks = []
        for _ in range(self.walks_per_vertex):
            for start in rng.permutation(g.n):
                walk = [int(start)]
                while len(walk) < self.walk_length + 1:
                    cur = walk[-1]
                    nbrs = g.neighbors(cur)
                    if len(nbrs) == 0:
                        break
                    w = g.neighbor_weights(cur).astype(np.float64)  # a copy
                    if len(walk) >= 2:
                        prev = walk[-2]
                        back = nbrs == prev
                        sp = sorted_nbrs[prev]
                        common = sp[np.minimum(np.searchsorted(sp, nbrs),
                                               len(sp) - 1)] == nbrs
                        w[back] /= self.p
                        w[~back & ~common] /= self.q
                    total = w.sum()
                    if total <= 0:
                        break
                    walk.append(int(nbrs[np.searchsorted(np.cumsum(w),
                                                         rng.random() * total)]))
                walks.append(np.asarray(walk, np.int64))
        return walks

    def initialize(self, graph: Graph) -> None:
        """The degree vocabulary and a fresh trainer (``fit`` calls it)."""
        self.sv = SequenceVectors(degree_vocab(graph), layer_size=self.vector_size,
                                  window=self.window_size, negative=self.negative,
                                  learning_rate=self.learning_rate,
                                  min_learning_rate=self.learning_rate * 1e-2,
                                  epochs=self.epochs, batch_size=self.batch_size,
                                  seed=self.seed, algorithm=SkipGram(),
                                  device=self.device)

    def fit(self, graph: Graph) -> List[float]:
        self.initialize(graph)
        rng = np.random.default_rng(self.seed)
        return self.sv.fit(self._biased_walks(graph, rng))

    def load_tables(self, syn0, syn1) -> None:
        """Carry trained (V, D) tables in (numpy arrays); the model must have
        been initialized or fit."""
        if self.sv is None:
            raise RuntimeError("initialize or fit the model first")
        self.sv.load_tables(syn0, syn1)

    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self.sv.vector(v)

    @property
    def vectors(self) -> np.ndarray:
        return self.sv.vectors

    def similarity(self, a: int, b: int) -> float:
        return self.sv.similarity(a, b)

    def vertices_nearest(self, v: int, top_n: int = 10) -> List[Tuple[int, float]]:
        return self.sv.nearest(v, top_n)
