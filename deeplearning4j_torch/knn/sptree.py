"""SPTree / QuadTree — the port's copy of the JAX package's
``knn/sptree.py``: Barnes-Hut space-partitioning trees
(``clustering/sptree/SpTree.java``, generic d dimensions, centre-of-mass
aggregation, ``computeNonEdgeForces`` with the theta criterion, and
``clustering/quadtree/QuadTree.java``, the 2-D case).

A host structure in numpy float64 by design: building it is pointer
chasing. The card's t-SNE repulsion is the blocked exact sum in
``plot/tsne.py``; this tree serves the reference's host algorithm
(``BarnesHutTsne(mode="tree")``) and its public API.

Nodes live in flat numpy arrays (children table, centres of mass, counts)
rather than the reference's node objects.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SPTree:
    """d-dimensional Barnes-Hut tree over a point set.

    Nodes are stored in flat arrays; node 0 is the root. Each internal node
    has 2^d children (octant split at the cell midpoint).
    """

    QT_NODE_CAPACITY = 1  # leaf capacity (SpTree.java QT_NODE_CAPACITY)

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, np.float64)
        n, d = data.shape
        self.data = data
        self.dim = d
        self.n_children = 2 ** d

        # conservative upper bound on node count: every insert can split once
        cap = max(4 * n * (1 if d <= 3 else 2), 64)
        self._center = np.zeros((cap, d))      # cell center
        self._width = np.zeros((cap, d))       # cell half-width
        self._com = np.zeros((cap, d))         # center of mass
        self._count = np.zeros(cap, np.int64)  # points in subtree
        self._point = np.full(cap, -1, np.int64)   # leaf payload (point index)
        self._children = np.full((cap, self.n_children), -1, np.int64)
        self._is_leaf = np.ones(cap, bool)
        self._n_nodes = 1

        lo, hi = data.min(0), data.max(0)
        mid = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2, 1e-10) * (1 + 1e-6)
        self._center[0], self._width[0] = mid, half

        for i in range(n):
            self._insert(0, i)

    # --- construction ---
    def _child_index(self, node: int, p: np.ndarray) -> int:
        """Which octant of `node` contains p."""
        bits = p > self._center[node]
        return int(bits @ (1 << np.arange(self.dim)))

    def _ensure_capacity(self):
        while self._n_nodes + self.n_children >= len(self._count):
            grow = max(len(self._count), self.n_children)
            for name in ("_center", "_width", "_com"):
                arr = getattr(self, name)
                setattr(self, name, np.vstack([arr, np.zeros((grow, self.dim))]))
            self._count = np.concatenate([self._count, np.zeros(grow, np.int64)])
            self._point = np.concatenate([self._point, np.full(grow, -1, np.int64)])
            self._children = np.vstack([self._children,
                                        np.full((grow, self.n_children), -1, np.int64)])
            self._is_leaf = np.concatenate([self._is_leaf, np.ones(grow, bool)])

    def _subdivide(self, node: int):
        self._ensure_capacity()
        half = self._width[node] / 2
        for c in range(self.n_children):
            idx = self._n_nodes
            self._n_nodes += 1
            offs = np.array([(1 if (c >> k) & 1 else -1) for k in range(self.dim)])
            self._center[idx] = self._center[node] + offs * half
            self._width[idx] = half
            self._children[node, c] = idx
        self._is_leaf[node] = False

    def _insert(self, node: int, i: int):
        p = self.data[i]
        while True:
            # update aggregate (com/count) on the way down
            c = self._count[node]
            self._com[node] = (self._com[node] * c + p) / (c + 1)
            self._count[node] = c + 1
            if self._is_leaf[node]:
                if self._count[node] <= self.QT_NODE_CAPACITY:
                    self._point[node] = i
                    return
                # occupied leaf: EXACTLY coincident points are absorbed into
                # the aggregates (count > 1, com == the point); a cell cannot
                # be subdivided to separate identical coordinates
                j = self._point[node]
                if j >= 0 and np.array_equal(self.data[j], p):
                    return
                self._subdivide(node)
                if j >= 0:
                    # push the stored point down WITH its absorbed duplicate
                    # mass: everything in this leaf except the new point `i`
                    # sits exactly at data[j]
                    child = self._children[node, self._child_index(node, self.data[j])]
                    self._com[child] = self.data[j]
                    self._count[child] = self._count[node] - 1
                    self._point[child] = j
                    self._point[node] = -1
            node = self._children[node, self._child_index(node, p)]

    # --- queries ---
    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    def depth(self) -> int:
        d, frontier = 0, [0]
        while frontier:
            nxt = []
            for n in frontier:
                if not self._is_leaf[n]:
                    nxt.extend(c for c in self._children[n] if c >= 0)
            if not nxt:
                return d
            frontier, d = nxt, d + 1
        return d

    def is_correct(self) -> bool:
        """Every point lies inside its leaf cell (SpTree.java isCorrect)."""
        for node in range(self._n_nodes):
            i = self._point[node]
            if self._is_leaf[node] and i >= 0:
                p = self.data[i]
                if np.any(np.abs(p - self._center[node]) > self._width[node] * (1 + 1e-9)):
                    return False
        return True

    def compute_non_edge_forces(self, point: np.ndarray, theta: float,
                                ) -> Tuple[np.ndarray, float]:
        """Barnes-Hut repulsion for one query point (SpTree.java
        computeNonEdgeForces): returns (negative-force vector, sum_Q).

        A cell is summarized when max_width / dist < theta.
        """
        neg = np.zeros(self.dim)
        sum_q = 0.0
        stack = [0]
        while stack:
            node = stack.pop()
            cnt = self._count[node]
            if cnt == 0:
                continue
            diff = point - self._com[node]
            d2 = float(diff @ diff)
            if self._is_leaf[node] or (np.max(self._width[node]) ** 2 < theta * theta * d2):
                if self._is_leaf[node] and d2 == 0.0:
                    # the query's own leaf: exclude self, but coincident
                    # duplicates still contribute q=1 each (zero direction)
                    sum_q += cnt - 1
                    continue
                q = 1.0 / (1.0 + d2)
                mult = cnt * q
                sum_q += mult
                neg += mult * q * diff
            else:
                stack.extend(c for c in self._children[node] if c >= 0)
        return neg, sum_q


class QuadTree(SPTree):
    """2-D specialization (clustering/quadtree/QuadTree.java parity)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, np.float64)
        if data.shape[1] != 2:
            raise ValueError(f"QuadTree requires 2-D points, got {data.shape[1]}-D")
        super().__init__(data)
