"""K-means on the card — the port of the JAX package's ``knn/kmeans.py``
(``clustering/kmeans/KMeansClustering.java`` of the reference, with its
variation-rate termination).

One Lloyd step is a few device operations: the (N, K) squared distances
as one product, an argmin (the first index among ties), and the centroid
update as a one-hot product. The host loop reads the cost once a step,
which is its convergence test. The kmeans++ seeding runs on the host in
numpy, as the reference's does, so both draw the same centroids from a
seed.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..utils.distances import pairwise_sq_dists


def _lloyd_step(points: torch.Tensor, centroids: torch.Tensor, k: int):
    """(new centroids, assignments, cost): each point to its nearest
    centroid, each centroid to its points' mean (kept where it has none),
    the cost the sum of the points' squared distances to their centroid
    before the move."""
    d2 = pairwise_sq_dists(points, centroids)
    assign = torch.argmin(d2, dim=1)
    one_hot = F.one_hot(assign, k).to(points.dtype)
    counts = one_hot.sum(0)
    sums = one_hot.T @ points
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp_min(counts[:, None], 1.0),
                                centroids)
    cost = d2.gather(1, assign[:, None]).sum()
    return new_centroids, assign, cost


# the host seeding's distance pass goes in blocks of rows over a few
# threads (numpy lets go of the interpreter lock inside each operation)
SEED_BLOCK_ROWS = 8192
SEED_THREADS = min(4, os.cpu_count() or 1)


def _sq_dists_to(points: np.ndarray, c: np.ndarray,
                 buf: np.ndarray) -> np.ndarray:
    """``((points - c) ** 2).sum(-1)``, the same bits (each row's sum is
    its own), through one reused buffer (each fresh (N, D) temporary costs
    its page faults), in blocks of rows over SEED_THREADS threads."""
    out = np.empty(len(points), np.result_type(points, c))

    def block(s):
        rows = slice(s, s + SEED_BLOCK_ROWS)
        np.subtract(points[rows], c, out=buf[rows])
        np.square(buf[rows], out=buf[rows])
        buf[rows].sum(-1, out=out[rows])

    with ThreadPoolExecutor(SEED_THREADS) as pool:
        list(pool.map(block, range(0, len(points), SEED_BLOCK_ROWS)))
    return out


def _kmeanspp_init(points: np.ndarray, k: int,
                   rng: np.random.Generator) -> np.ndarray:
    n = len(points)
    centroids = [points[rng.integers(n)]]
    d2 = np.full(n, np.inf)
    buf = np.empty_like(points)
    for _ in range(1, k):
        d2 = np.minimum(d2, _sq_dists_to(points, centroids[-1], buf))
        p = d2 / d2.sum() if d2.sum() > 0 else None
        centroids.append(points[rng.choice(n, p=p)])
    return np.stack(centroids)


class KMeans:
    """setup(k, maxIterations | minDistributionVariationRate) of the
    reference; ``device`` is the card unless the caller names another."""

    def __init__(self, k: int, max_iterations: int = 100,
                 variation_tolerance: Optional[float] = 1e-4,
                 seed: int = 12345, init: str = "kmeans++",
                 device: DeviceLike = None):
        self.k = k
        self.max_iterations = max_iterations
        self.variation_tolerance = variation_tolerance
        self.seed = seed
        self.init = init
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.cost_: Optional[float] = None

    def fit(self, points) -> "KMeans":
        host = np.asarray(points, np.float32)
        pts = torch.as_tensor(host, device=self.device)
        rng = np.random.default_rng(self.seed)
        if self.init == "kmeans++":
            c = torch.as_tensor(_kmeanspp_init(host, self.k, rng),
                                device=self.device)
        else:
            c = pts[torch.as_tensor(rng.choice(len(pts), self.k,
                                               replace=False),
                                    device=self.device)]
        prev_cost = np.inf
        for _ in range(self.max_iterations):
            c, assign, cost = _lloyd_step(pts, c, self.k)
            cost = float(cost)
            # VarianceVariationCondition: stop when the relative
            # improvement stalls
            if self.variation_tolerance is not None and np.isfinite(prev_cost):
                if abs(prev_cost - cost) <= self.variation_tolerance * max(
                        prev_cost, 1e-12):
                    prev_cost = cost
                    break
            prev_cost = cost
        self.centroids = c.cpu().numpy()
        self.cost_ = prev_cost
        return self

    def predict(self, points) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)
        _, assign, _ = _lloyd_step(
            pts, torch.as_tensor(self.centroids, device=self.device), self.k)
        return assign.to(torch.int32).cpu().numpy()
