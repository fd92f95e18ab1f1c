"""VP-tree — the port's copy of the JAX package's ``knn/vptree.py``
(``clustering/vptree/VPTree.java`` of the reference).

A host structure in numpy float64: exact metric-tree search, including
``VPTreeFillSearch``'s radius semantics through ``search(...,
max_distance=...)``. The scan on the card (``brute.py``) answers the same
queries; this is the structure the reference's API exposes.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def _metric(distance: str):
    if distance == "euclidean":
        return lambda a, b: float(np.linalg.norm(a - b))
    if distance == "manhattan":
        return lambda a, b: float(np.abs(a - b).sum())
    if distance == "cosinesimilarity":
        # angular distance arccos(cos) — a true metric (1-cos violates the
        # triangle inequality and would break VP pruning); same neighbor
        # ranking as 1-cos since arccos is monotone
        def d(a, b):
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            return float(np.arccos(np.clip((a @ b) / max(na * nb, 1e-12),
                                           -1.0, 1.0)))
        return d
    raise ValueError(f"Unknown distance '{distance}'")


@dataclass
class _Node:
    index: int
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None


class VPTree:
    """Vantage-point tree: random vantage point, median-distance split —
    matching VPTree.java's buildFromData recursion."""

    def __init__(self, points, distance: str = "euclidean", seed: int = 12345):
        self.items = np.asarray(points, np.float64)
        self.dist = _metric(distance)
        self._rng = np.random.default_rng(seed)
        idx = list(range(len(self.items)))
        self.root = self._build(idx)

    def _build(self, idx: List[int]) -> Optional[_Node]:
        if not idx:
            return None
        if len(idx) == 1:
            return _Node(idx[0])
        vp_pos = int(self._rng.integers(len(idx)))
        idx[0], idx[vp_pos] = idx[vp_pos], idx[0]
        vp = idx[0]
        rest = idx[1:]
        d = np.array([self.dist(self.items[vp], self.items[i]) for i in rest])
        median = float(np.median(d))
        inner = [i for i, di in zip(rest, d) if di < median]
        outer = [i for i, di in zip(rest, d) if di >= median]
        if not inner:
            # median == min (ties at the bottom): move ties left so both
            # invariants still hold (left d <= threshold, right d >= threshold)
            inner = [i for i, di in zip(rest, d) if di <= median]
            outer = [i for i, di in zip(rest, d) if di > median]
        if not inner or not outer:
            # every distance equals the median (duplicate/equidistant points):
            # an empty side would recurse once per point and blow the stack;
            # any balanced split keeps both invariants since all d == threshold
            mid = len(rest) // 2
            inner, outer = rest[:mid], rest[mid:]
        return _Node(vp, median, self._build(inner), self._build(outer))

    def search(self, query, k: int, max_distance: Optional[float] = None
               ) -> Tuple[List[int], List[float]]:
        """k nearest neighbors; with ``max_distance`` set, returns ALL points
        within that radius (VPTreeFillSearch parity) capped at k if k>0."""
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        tau = [max_distance if max_distance is not None else np.inf]

        def visit(node: Optional[_Node]):
            if node is None:
                return
            d = self.dist(query, self.items[node.index])
            if d < tau[0] or (max_distance is not None and d <= max_distance):
                heapq.heappush(heap, (-d, node.index))
                if max_distance is None and len(heap) > k:
                    heapq.heappop(heap)
                if max_distance is None and len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.left is None and node.right is None:
                return
            if d < node.threshold:
                if d - tau[0] <= node.threshold:
                    visit(node.left)
                if d + tau[0] >= node.threshold:
                    visit(node.right)
            else:
                if d + tau[0] >= node.threshold:
                    visit(node.right)
                if d - tau[0] <= node.threshold:
                    visit(node.left)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        if k > 0:
            out = out[:k]
        return [i for _, i in out], [d for d, _ in out]
