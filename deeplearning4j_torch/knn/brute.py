"""Brute-force k-NN on the card.

A (Q, D) x (D, N) product and ``torch.topk`` answer every query; there is
no index to build. The distance menu of the reference's VPTree.java is kept:
"euclidean", "cosinesimilarity", "dot" and "manhattan". Products stay in
f32 (the port leaves ``torch.backends.cuda.matmul.allow_tf32`` at its
default, off).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.distances import pairwise_sq_dists

# manhattan has no product form: queries are scored this many at a time, so
# the (block, N, D) difference bounds the peak memory
MANHATTAN_BLOCK = 32
DISTANCES = ("euclidean", "cosinesimilarity", "dot", "manhattan")


def _knn(points: torch.Tensor, queries: torch.Tensor, k: int,
         distance: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, distances) of the k best rows of ``points`` for each query,
    best first: the smallest distance, or the largest similarity."""
    if distance not in DISTANCES:
        raise ValueError(f"Unknown distance '{distance}'")
    if queries.shape[-1] != points.shape[-1]:
        raise TypeError(f"queries of width {queries.shape[-1]} against "
                        f"points of width {points.shape[-1]}")
    if distance == "euclidean":
        score = -pairwise_sq_dists(queries, points)
    elif distance == "cosinesimilarity":
        qn = queries / torch.clamp_min(
            torch.linalg.vector_norm(queries, dim=-1, keepdim=True), 1e-12)
        pn = points / torch.clamp_min(
            torch.linalg.vector_norm(points, dim=-1, keepdim=True), 1e-12)
        score = qn @ pn.T
    elif distance == "dot":
        score = queries @ points.T
    else:  # manhattan
        score = -torch.cat([
            (blk[:, None, :] - points[None]).abs().sum(-1)
            for blk in queries.split(MANHATTAN_BLOCK)]) if len(queries) \
            else queries.new_zeros((0, points.shape[0]))
    if k < 0:
        raise ValueError(f"k argument to top_k must be nonnegative, got {k}")
    top, idx = torch.topk(score, k, dim=-1)
    if distance == "euclidean":
        top = torch.sqrt(torch.clamp_min(-top, 0.0))
    elif distance == "manhattan":
        top = -top
    return idx, top


class BruteForceKNN:
    """An index over a fixed point set on ``device`` (the card unless the
    caller names another); ``search`` returns (indices (Q, k), distances or
    similarities (Q, k)) as numpy arrays."""

    def __init__(self, points, distance: str = "euclidean",
                 dtype=torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        # the index owns its points, as the reference's immutable array does
        self.points = torch.as_tensor(points, dtype=dtype).to(self.device,
                                                              copy=True)
        self.distance = distance

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(queries, dtype=self.points.dtype,
                            device=self.device)
        single = q.ndim == 1
        if single:
            q = q[None]
        k = min(int(k), self.points.shape[0])
        idx, d = _knn(self.points, q, k, self.distance)
        idx = idx.to(torch.int32).cpu().numpy()
        d = d.cpu().numpy()
        return (idx[0], d[0]) if single else (idx, d)

    def search_excluding_self(self, query_index: int, k: int):
        """k nearest excluding the query point itself (server semantics)."""
        n = self.points.shape[0]
        if not (0 <= query_index < n):
            raise IndexError(f"query_index {query_index} out of range [0, {n})")
        idx, d = self.search(self.points[query_index], k + 1)
        keep = idx != query_index
        return idx[keep][:k], d[keep][:k]
