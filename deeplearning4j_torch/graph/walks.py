"""Random-walk iterators (the port's copy of the JAX package's
``graph/walks.py``) — ``graph/iterator/RandomWalkIterator.java`` and
``WeightedRandomWalkIterator.java``.

The reference walks one vertex at a time through object adjacency lists; here
walks are generated in vectorized batches over the CSR arrays (one
``np.random`` gather per step for the whole batch), which keeps the host-side
ETL fast enough to feed the batched skip-gram step.

NoEdgeHandling parity: SELF_LOOP_ON_DISCONNECTED (default here, walk stays)
or EXCEPTION_ON_DISCONNECTED (raise NoEdgesException).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .graph import Graph, NoEdgesException


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex (shuffled order),
    matching RandomWalkIterator semantics: each epoch yields one walk per
    starting vertex."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 no_edge_handling: str = "self_loop", batch: int = 512):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.batch = batch

    def _step(self, current: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        g = self.graph
        deg = g.offsets[current + 1] - g.offsets[current]
        if self.no_edge_handling == "exception" and np.any(deg == 0):
            raise NoEdgesException(
                f"Vertex {int(current[np.argmax(deg == 0)])} has no edges")
        # disconnected vertices self-loop; others pick a uniform neighbor
        pick = (rng.random(len(current)) * np.maximum(deg, 1)).astype(np.int64)
        nxt = g.targets[np.minimum(g.offsets[current] + pick,
                                   len(g.targets) - 1 if len(g.targets) else 0)] \
            if len(g.targets) else current
        return np.where(deg > 0, nxt, current)

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(self.graph.n)
        for s in range(0, len(order), self.batch):
            starts = order[s: s + self.batch]
            walk = np.empty((len(starts), self.walk_length + 1), np.int64)
            walk[:, 0] = starts
            cur = starts
            for t in range(self.walk_length):
                cur = self._step(cur, rng)
                walk[:, t + 1] = cur
            yield from walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """``WeightedRandomWalkIterator.java`` — transition probability
    proportional to edge weight.

    Vectorized like the uniform walker: one prefix-sum of all edge weights is
    built lazily, then each step is a single ``searchsorted`` over the whole
    batch (inverse-CDF sampling within each vertex's CSR slice)."""

    def _step(self, current: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        g = self.graph
        if not hasattr(self, "_prefix"):
            self._prefix = np.concatenate([[0.0], np.cumsum(g.weights)])
        deg = g.offsets[current + 1] - g.offsets[current]
        lo = self._prefix[g.offsets[current]] if len(g.targets) else np.zeros(0)
        hi = self._prefix[g.offsets[current + 1]] if len(g.targets) else lo
        # zero total weight is as stuck as zero degree: same handling
        stuck = (deg == 0) if len(g.targets) == 0 else (hi - lo <= 0)
        if self.no_edge_handling == "exception" and np.any(stuck):
            raise NoEdgesException(
                f"Vertex {int(current[np.argmax(stuck)])} has no traversable "
                f"edges (zero degree or zero total weight)")
        if len(g.targets) == 0:
            return current
        target = lo + rng.random(len(current)) * (hi - lo)
        pos = np.searchsorted(self._prefix, target, side="right") - 1
        pos = np.clip(pos, g.offsets[current],
                      np.maximum(g.offsets[current + 1] - 1, g.offsets[current]))
        return np.where(~stuck, g.targets[np.minimum(pos, len(g.targets) - 1)],
                        current)
