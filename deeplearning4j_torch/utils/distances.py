"""Pairwise distances shared by the port's nearest-neighbour code — the
port's own copy of ``deeplearning4j_tpu/utils/distances.py``.

The squared-euclidean identity ``||a-b||^2 = ||a||^2 - 2ab + ||b||^2`` runs
as one matmul; its rounding can go slightly below 0, so it is clamped.
"""

from __future__ import annotations

import torch


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor = None) -> torch.Tensor:
    """Squared euclidean distances (N, M) between rows of a (N, D) and b
    (M, D); b=None means b=a. Clamped at 0."""
    if b is None:
        b = a
    cross = a @ b.T
    d2 = ((a * a).sum(-1, keepdim=True) - 2.0 * cross
          + (b * b).sum(-1)[None, :])
    return torch.clamp_min(d2, 0.0)
