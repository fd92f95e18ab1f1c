"""KD-tree — the port's copy of the JAX package's ``knn/kdtree.py``
(``clustering/kdtree/KDTree.java`` and ``HyperRect.java`` of the reference).

A host structure in numpy float64: axis-cycling median splits, k-NN and
range search. The scan on the card (``brute.py``) answers the same k-NN
queries.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class _KDNode:
    index: int
    axis: int
    left: Optional["_KDNode"] = None
    right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, points):
        self.items = np.asarray(points, np.float64)
        self.dims = self.items.shape[1]
        self.root = self._build(list(range(len(self.items))), 0)

    def _build(self, idx: List[int], depth: int) -> Optional[_KDNode]:
        if not idx:
            return None
        axis = depth % self.dims
        idx.sort(key=lambda i: self.items[i, axis])
        mid = len(idx) // 2
        return _KDNode(idx[mid], axis,
                       self._build(idx[:mid], depth + 1),
                       self._build(idx[mid + 1:], depth + 1))

    def nn(self, query) -> Tuple[int, float]:
        idx, d = self.knn(query, 1)
        return idx[0], d[0]

    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            p = self.items[node.index]
            d = float(np.linalg.norm(query - p))
            heapq.heappush(heap, (-d, node.index))
            if len(heap) > k:
                heapq.heappop(heap)
            delta = query[node.axis] - p[node.axis]
            near, far = (node.left, node.right) if delta < 0 else (node.right, node.left)
            visit(near)
            tau = -heap[0][0] if len(heap) == k else np.inf
            if abs(delta) < tau:
                visit(far)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in out], [d for d, _ in out]

    def range_search(self, lower, upper) -> List[int]:
        """All points inside the axis-aligned box [lower, upper] (HyperRect)."""
        lower, upper = np.asarray(lower, np.float64), np.asarray(upper, np.float64)
        out: List[int] = []

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            p = self.items[node.index]
            if np.all(p >= lower) and np.all(p <= upper):
                out.append(node.index)
            if p[node.axis] >= lower[node.axis]:
                visit(node.left)
            if p[node.axis] <= upper[node.axis]:
                visit(node.right)

        visit(self.root)
        return out
