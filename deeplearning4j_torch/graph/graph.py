"""In-memory graph (the port's copy of the JAX package's ``graph/graph.py``)
— parity with ``graph/api/IGraph.java`` + ``graph/Graph.java``.

The reference stores vertices as objects with a value payload and adjacency
lists of Edge objects. Here the graph is CSR-style numpy adjacency (offsets +
targets + weights) built once from an edge list — the layout random-walk
generation wants (vectorized sampling over contiguous neighbor slices), and
the natural host-side feed for batched DeepWalk training on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


class NoEdgesException(Exception):
    """Walk hit a vertex with no outgoing edges under NoEdgeHandling.EXCEPTION
    (``graph/exception/NoEdgesException.java``)."""


@dataclass(frozen=True)
class Edge(object):
    """``graph/api/Edge.java`` — directed flag matches the reference."""

    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """``graph/Graph.java`` — vertices are 0..n-1; optional value payloads
    (VertexFactory equivalent is just the ``values`` list)."""

    def __init__(self, n_vertices: int, edges: Iterable[Edge] = (),
                 values: Optional[Sequence] = None):
        self.n = int(n_vertices)
        self.values = list(values) if values is not None else None
        adj: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]
        for e in edges:
            adj[e.src].append((e.dst, e.weight))
            if not e.directed:
                adj[e.dst].append((e.src, e.weight))
        counts = np.array([len(a) for a in adj], np.int64)
        self.offsets = np.zeros(self.n + 1, np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self.targets = np.zeros(int(self.offsets[-1]), np.int64)
        self.weights = np.zeros(int(self.offsets[-1]), np.float64)
        for v, nbrs in enumerate(adj):
            o = self.offsets[v]
            for k, (t, w) in enumerate(nbrs):
                self.targets[o + k] = t
                self.weights[o + k] = w

    # --- IGraph surface ---
    def num_vertices(self) -> int:
        return self.n

    def num_edges(self) -> int:
        return int(self.offsets[-1])

    def degree(self, v: int) -> int:
        return int(self.offsets[v + 1] - self.offsets[v])

    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)

    def neighbors(self, v: int) -> np.ndarray:
        return self.targets[self.offsets[v]: self.offsets[v + 1]]

    def neighbor_weights(self, v: int) -> np.ndarray:
        return self.weights[self.offsets[v]: self.offsets[v + 1]]

    def vertex_value(self, v: int):
        return self.values[v] if self.values is not None else v


def load_delimited_edges(path: str, n_vertices: int, delim: str = ",",
                         directed: bool = False) -> Graph:
    """``data/impl/DelimitedEdgeLineProcessor.java`` + ``GraphLoader`` — each
    line "src<delim>dst"; blank lines and ``//`` comments skipped."""
    edges = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("//"):
                continue
            a, b = line.split(delim)[:2]
            edges.append(Edge(int(a), int(b), directed=directed))
    return Graph(n_vertices, edges)


def load_weighted_edges(path: str, n_vertices: int, delim: str = ",",
                        directed: bool = False) -> Graph:
    """``data/impl/WeightedEdgeLineProcessor.java`` — "src<delim>dst<delim>w"."""
    edges = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("//"):
                continue
            parts = line.split(delim)
            edges.append(Edge(int(parts[0]), int(parts[1]), float(parts[2]),
                              directed=directed))
    return Graph(n_vertices, edges)
