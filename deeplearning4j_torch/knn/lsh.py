"""Random-projection LSH on the card — the port of the JAX package's
``knn/lsh.py`` (``clustering/lsh/RandomProjectionLSH.java`` of the
reference).

Signed random projections hash points into buckets; a query's bucket is
re-ranked exactly. Hashing and re-ranking run on ``device``; the bucket
table is a host dict. The hyperplanes are the reference's draw
(``default_rng(seed).standard_normal`` in f64, cast to f32), and a
signature's bits are packed in int64 (torch has no uint32 arithmetic) and
handed out as the reference's uint32 values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _signatures(points: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """int64 (N,): bit b set where the point lies on the positive side of
    hyperplane b."""
    bits = (points @ planes.T) > 0
    weights = 2 ** torch.arange(planes.shape[0], dtype=torch.int64,
                                device=planes.device)
    return (bits.to(torch.int64) * weights).sum(-1)


class RandomProjectionLSH:
    def __init__(self, points, hash_length: int = 12, seed: int = 12345,
                 device: DeviceLike = None):
        if not (1 <= hash_length <= 32):
            raise ValueError(
                f"hash_length must be in [1, 32] (uint32 signature packing), "
                f"got {hash_length}")
        self.device = resolve_device(device)
        self.points = torch.as_tensor(np.asarray(points, np.float32),
                                      device=self.device)
        rng = np.random.default_rng(seed)
        dim = self.points.shape[1]
        self.planes = torch.as_tensor(
            rng.standard_normal((hash_length, dim)).astype(np.float32),
            device=self.device)
        self.signatures = _signatures(self.points, self.planes).cpu() \
            .numpy().astype(np.uint32)
        # bucket -> point indices
        self._buckets = {}
        for i, s in enumerate(self.signatures.tolist()):
            self._buckets.setdefault(s, []).append(i)

    def _query(self, query) -> torch.Tensor:
        return torch.as_tensor(np.asarray(query, np.float32),
                               device=self.device)

    def bucket(self, query) -> np.ndarray:
        sig = int(_signatures(self._query(query)[None], self.planes)[0])
        return np.asarray(self._buckets.get(sig, []), np.int64)

    def search(self, query, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate k-NN: exact re-rank within the query's bucket, or of
        every point when the bucket holds fewer than k. Equal distances
        keep the candidates' order."""
        cand = self.bucket(query)
        if len(cand) < k:
            cand = np.arange(self.points.shape[0])
        sub = self.points[torch.as_tensor(cand, device=self.device)]
        q = self._query(query)
        d = torch.linalg.vector_norm(sub - q[None, :], dim=-1)
        k = min(k, len(cand))
        top = torch.argsort(d, stable=True)[:k]
        return cand[top.cpu().numpy()], d[top].cpu().numpy()
