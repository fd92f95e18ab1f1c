"""The clustering framework on the card — the port of the JAX package's
``knn/clustering.py``: strategies, termination conditions, iteration
history and cluster statistics (``clustering/algorithm/
BaseClusteringAlgorithm.java``, ``strategy/{FixedClusterCountStrategy,
OptimisationStrategy}``, ``condition/{FixedIterationCountCondition,
VarianceVariationCondition,ConvergenceCondition}``, ``info/{ClusterInfo,
ClusterSetInfo}``, ``optimisation/ClusteringOptimizationType`` of the
reference).

One iteration is one pass on the device (``_cluster_pass``): the distance
product, the assignment, the new centres and every per-cluster statistic
through segment reductions with the same bits every run. The host keeps the
reference's control plane (history, conditions, and the strategy's actions
that change K between passes) and reads the statistics once a pass, as its
strategy needs them. A split finds each point's owner on the device in row
blocks, with the reference's distances and argmin.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..utils.distances import pairwise_sq_dists
from ..utils.segments import segment_max, segment_sum
from .kmeans import _sq_dists_to

# _split holds a (rows, K, D) f32 difference; rows are chosen so it stays
# under this many elements
SPLIT_BLOCK_ELEMENTS = 1 << 26


# ---------------------------------------------------------------------------
# One classify + refresh + statistics pass on the device
# ---------------------------------------------------------------------------


def _cluster_pass(points, centers, prev_assign, k: int):
    """Assign points, recentre, and compute every ClusterInfo statistic
    (ClusterUtils.classifyPoints + refreshClustersCenters +
    computeClusterInfos). Returns (assign, centers, counts, average
    distance, distance variance, max distance, each point's distance, the
    number of points that changed cluster)."""
    d2 = pairwise_sq_dists(points, centers)
    assign = torch.argmin(d2, dim=1)
    dist = torch.sqrt(d2.gather(1, assign[:, None])[:, 0])

    one_hot = F.one_hot(assign, k).to(points.dtype)
    counts = one_hot.sum(0)
    new_centers = torch.where(
        counts[:, None] > 0,
        (one_hot.T @ points) / torch.clamp_min(counts[:, None], 1.0),
        centers)

    sum_d = segment_sum(dist, assign, k)
    sum_d2 = segment_sum(dist * dist, assign, k)
    max_d = segment_max(torch.where(counts[assign] > 0, dist, -torch.inf),
                        assign, k)
    avg = torch.where(counts > 0, sum_d / torch.clamp_min(counts, 1.0), 0.0)
    var = torch.where(counts > 0,
                      sum_d2 / torch.clamp_min(counts, 1.0) - avg * avg, 0.0)
    changes = (assign != prev_assign).sum()
    return (assign, new_centers, counts, avg, torch.clamp_min(var, 0.0),
            torch.where(torch.isfinite(max_d), max_d, 0.0), dist, changes)


# ---------------------------------------------------------------------------
# Info / history (ClusterInfo, ClusterSetInfo, IterationHistory)
# ---------------------------------------------------------------------------


@dataclass
class ClusterInfo:
    """Per-cluster statistics (info/ClusterInfo.java)."""

    point_count: int
    average_point_distance_from_center: float
    point_distance_from_center_variance: float
    max_point_distance_from_center: float


@dataclass
class ClusterSetInfo:
    """Aggregate statistics for one iteration (info/ClusterSetInfo.java)."""

    clusters: List[ClusterInfo]
    point_location_change: int
    points_count: int

    @property
    def point_distance_from_cluster_variance(self) -> float:
        """Mean of per-cluster distance variances (getPointDistanceFromClusterVariance)."""
        if not self.clusters:
            return 0.0
        return float(np.mean([c.point_distance_from_center_variance
                              for c in self.clusters]))

    @property
    def average_point_distance_from_center(self) -> float:
        n = sum(c.point_count for c in self.clusters)
        if n == 0:
            return 0.0
        return float(sum(c.average_point_distance_from_center * c.point_count
                         for c in self.clusters) / n)


@dataclass
class IterationInfo:
    index: int
    cluster_set_info: ClusterSetInfo
    strategy_applied: bool = False


class IterationHistory:
    """iteration/IterationHistory.java."""

    def __init__(self):
        self.iterations: Dict[int, IterationInfo] = {}

    @property
    def iteration_count(self) -> int:
        return len(self.iterations)

    def most_recent(self) -> Optional[IterationInfo]:
        if not self.iterations:
            return None
        return self.iterations[max(self.iterations)]

    def get(self, i: int) -> IterationInfo:
        return self.iterations[i]


# ---------------------------------------------------------------------------
# Termination / application conditions
# ---------------------------------------------------------------------------


class FixedIterationCountCondition:
    """condition/FixedIterationCountCondition.java."""

    def __init__(self, count: int):
        self.count = count

    @classmethod
    def iteration_count_greater_than(cls, n: int):
        return cls(n)

    def is_satisfied(self, history: IterationHistory) -> bool:
        return history.iteration_count >= self.count


class ConvergenceCondition:
    """condition/ConvergenceCondition.java: fraction of points that changed
    cluster this iteration below a rate."""

    def __init__(self, rate: float):
        self.rate = rate

    @classmethod
    def distribution_variation_rate_less_than(cls, rate: float):
        return cls(rate)

    def is_satisfied(self, history: IterationHistory) -> bool:
        if history.iteration_count <= 1:
            return False
        info = history.most_recent().cluster_set_info
        return (info.point_location_change / max(info.points_count, 1)) < self.rate


class VarianceVariationCondition:
    """condition/VarianceVariationCondition.java: relative change of the
    cluster distance variance below a threshold for `period` iterations."""

    def __init__(self, variation: float, period: int):
        self.variation = variation
        self.period = period

    @classmethod
    def variance_variation_less_than(cls, variation: float, period: int):
        return cls(variation, period)

    def is_satisfied(self, history: IterationHistory) -> bool:
        if history.iteration_count <= self.period:
            return False
        j = max(history.iterations)
        for i in range(self.period):
            cur = history.get(j - i).cluster_set_info.point_distance_from_cluster_variance
            prev = history.get(j - i - 1).cluster_set_info.point_distance_from_cluster_variance
            if prev == 0:
                continue
            if abs((cur - prev) / prev) >= self.variation:
                return False
        return True


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


class ClusteringOptimizationType(Enum):
    """optimisation/ClusteringOptimizationType.java."""

    MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE = "avg_point_to_center"
    MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE = "max_point_to_center"
    MINIMIZE_PER_CLUSTER_POINT_COUNT = "per_cluster_point_count"


class BaseClusteringStrategy:
    """strategy/BaseClusteringStrategy.java: initial K, distance, termination."""

    def __init__(self, initial_cluster_count: int, distance_function: str = "euclidean",
                 allow_empty_clusters: bool = False):
        self.initial_cluster_count = initial_cluster_count
        self.distance_function = distance_function
        self.allow_empty_clusters = allow_empty_clusters
        self.termination_condition = None

    # the reference's fluent setters (endWhenIterationCountEquals /
    # endWhenDistributionVariationRateLessThan)
    def end_when_iteration_count_equals(self, n: int):
        self.termination_condition = FixedIterationCountCondition(n)
        return self

    def end_when_distribution_variation_rate_less_than(self, rate: float):
        self.termination_condition = ConvergenceCondition(rate)
        return self

    def is_optimization_defined(self) -> bool:
        return False

    def is_optimization_applicable_now(self, history: IterationHistory) -> bool:
        return False


class FixedClusterCountStrategy(BaseClusteringStrategy):
    """strategy/FixedClusterCountStrategy.java: K stays fixed; empty clusters
    are removed and the most spread-out clusters split to restore K."""

    @classmethod
    def setup(cls, initial_cluster_count: int, distance_function: str = "euclidean",
              allow_empty_clusters: bool = False):
        return cls(initial_cluster_count, distance_function, allow_empty_clusters)


class OptimisationStrategy(BaseClusteringStrategy):
    """strategy/OptimisationStrategy.java: periodically split clusters that
    violate the optimization target."""

    def __init__(self, initial_cluster_count: int, distance_function: str = "euclidean"):
        super().__init__(initial_cluster_count, distance_function,
                         allow_empty_clusters=False)
        self.optimization_type: Optional[ClusteringOptimizationType] = None
        self.optimization_value: float = 0.0
        self.application_condition = None

    @classmethod
    def setup(cls, initial_cluster_count: int, distance_function: str = "euclidean"):
        return cls(initial_cluster_count, distance_function)

    def optimize(self, opt_type: ClusteringOptimizationType, value: float):
        self.optimization_type = opt_type
        self.optimization_value = value
        return self

    def optimize_when_iteration_count_multiple_of(self, n: int):
        self.application_condition = FixedIterationCountCondition(n)
        return self

    def optimize_when_point_distribution_variation_rate_less_than(self, rate: float):
        self.application_condition = ConvergenceCondition(rate)
        return self

    def is_optimization_defined(self) -> bool:
        return self.optimization_type is not None

    def is_optimization_applicable_now(self, history: IterationHistory) -> bool:
        if self.application_condition is None:
            return True
        return self.application_condition.is_satisfied(history)


# ---------------------------------------------------------------------------
# ClusterSet + the algorithm's loop
# ---------------------------------------------------------------------------


def _norms(diff: torch.Tensor) -> torch.Tensor:
    """Euclidean norms over the last axis, as numpy's: sqrt of the summed
    squares. ``diff`` is a temporary and is overwritten."""
    return diff.square_().sum(-1).sqrt_()


@dataclass
class ClusterSet:
    """cluster/ClusterSet.java: centers + assignments of the final model."""

    centers: np.ndarray                  # (K, D)
    assignments: np.ndarray              # (N,)
    distances: np.ndarray                # (N,) distance to own center
    info: ClusterSetInfo

    @property
    def cluster_count(self) -> int:
        return len(self.centers)

    def classify_point(self, p) -> int:
        d = np.linalg.norm(self.centers - np.asarray(p)[None, :], axis=1)
        return int(np.argmin(d))


class BaseClusteringAlgorithm:
    """algorithm/BaseClusteringAlgorithm.java: iterate classify/refresh under
    the strategy until the termination condition is satisfied; the passes
    run on ``device``, the card unless the caller names another."""

    #: hard backstop: the reference loops while the strategy keeps acting
    #: (BaseClusteringAlgorithm.iterations), which can cycle forever on
    #: degenerate data (e.g. duplicate coordinates keep producing an empty
    #: cluster); total iterations are bounded so apply_to always returns
    MAX_TOTAL_ITERATIONS = 1000

    def __init__(self, strategy: BaseClusteringStrategy, seed: int = 12345,
                 device: DeviceLike = None):
        self.strategy = strategy
        self.seed = seed
        self.device = resolve_device(device)
        self.history = IterationHistory()
        # (host points, their device copy) while apply_to runs
        self._points = None

    @classmethod
    def setup(cls, strategy: BaseClusteringStrategy, seed: int = 12345,
              device: DeviceLike = None):
        return cls(strategy, seed, device)

    # --- d²-weighted initial centers (initClusters :147-160, == kmeans++) ---
    def _init_centers(self, pts: np.ndarray, k: int, rng) -> np.ndarray:
        centers = [pts[rng.integers(len(pts))]]
        d2 = np.full(len(pts), np.inf)
        buf = np.empty_like(pts)
        while len(centers) < k:
            d2 = np.minimum(d2, _sq_dists_to(pts, centers[-1], buf))
            r = rng.random() * d2.max()
            idx = int(np.argmax(d2 >= r))
            centers.append(pts[idx])
        return np.stack(centers)

    def _pass(self, pts_t, centers, assign, n):
        """One ``_cluster_pass``; the statistics the strategy needs come to
        the host. Returns (assign on the device, centers, counts, avg, mx,
        dist on the device, info)."""
        k = len(centers)
        (assign, centers_t, counts, avg, var, mx, dist,
         changes) = _cluster_pass(pts_t, torch.as_tensor(centers,
                                                         device=self.device),
                                  assign, k)
        centers, counts, avg, var, mx = (
            t.cpu().numpy() for t in (centers_t, counts, avg, var, mx))
        info = ClusterSetInfo(
            clusters=[ClusterInfo(int(counts[i]), float(avg[i]),
                                  float(var[i]), float(mx[i]))
                      for i in range(k)],
            point_location_change=int(changes), points_count=n)
        return assign, centers, counts, avg, mx, dist, info

    def apply_to(self, points) -> ClusterSet:
        pts = np.asarray(points, np.float32)
        n = len(pts)
        rng = np.random.default_rng(self.seed)
        k = min(self.strategy.initial_cluster_count, n)
        centers = self._init_centers(pts, k, rng)
        pts_t = torch.as_tensor(pts, device=self.device)
        assign = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        self.history = IterationHistory()
        self._points = (pts, pts_t)
        try:
            it = 0
            while True:
                it += 1
                (assign, centers, counts, avg, mx, dist,
                 info) = self._pass(pts_t, centers, assign, n)
                self.history.iterations[it] = IterationInfo(it, info)

                strategy_applied = self._apply_strategy(pts, centers, counts,
                                                        avg, mx, info)
                self.history.iterations[it].strategy_applied = \
                    strategy_applied
                if strategy_applied:
                    centers = self._pending_centers

                cond = self.strategy.termination_condition
                satisfied = (cond.is_satisfied(self.history)
                             if cond is not None
                             else it >= 100)  # defaultIterationCount
                # loop again whenever the strategy acted, but always stop
                # at the hard backstop (see MAX_TOTAL_ITERATIONS)
                if it >= self.MAX_TOTAL_ITERATIONS or (
                        satisfied and not strategy_applied):
                    break
            if strategy_applied:
                # the backstop fired right after the strategy changed K:
                # classify once against the final centers so assignments
                # and info agree with what is returned
                assign, _, _, _, _, dist, info = self._pass(
                    pts_t, centers, assign, n)
        finally:
            self._points = None
        return ClusterSet(centers, assign.to(torch.int32).cpu().numpy(),
                          dist.cpu().numpy(), info)

    # --- strategy actions (applyClusteringStrategy :173-195) ---
    def _apply_strategy(self, pts, centers, counts, avg, mx, info) -> bool:
        applied = False
        k0 = self.strategy.initial_cluster_count
        if not self.strategy.allow_empty_clusters and (counts == 0).any():
            keep = counts > 0
            centers = centers[keep]
            avg, mx, counts = avg[keep], mx[keep], counts[keep]
            applied = True
        # FIXED_CLUSTER_COUNT: restore K by splitting the most spread out
        if isinstance(self.strategy, FixedClusterCountStrategy) and len(centers) < k0:
            while len(centers) < k0:
                centers = self._split(pts, centers, int(np.argmax(avg)))
                avg = np.append(avg, 0.0)
            applied = True
        if (self.strategy.is_optimization_defined()
                and self.history.iteration_count > 0
                and self.strategy.is_optimization_applicable_now(self.history)):
            split_idx = self._optimization_violations(counts, avg, mx)
            for i in split_idx:
                centers = self._split(pts, centers, i)
            applied = applied or bool(split_idx)
        self._pending_centers = centers
        return applied

    def _optimization_violations(self, counts, avg, mx) -> List[int]:
        s: OptimisationStrategy = self.strategy  # type: ignore
        t, v = s.optimization_type, s.optimization_value
        T = ClusteringOptimizationType
        if t == T.MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE:
            return [int(i) for i in np.nonzero(avg > v)[0]]
        if t == T.MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE:
            return [int(i) for i in np.nonzero(mx > v)[0]]
        if t == T.MINIMIZE_PER_CLUSTER_POINT_COUNT:
            return [int(i) for i in np.nonzero(counts > v)[0]]
        return []

    def _split(self, pts, centers, cluster_idx) -> np.ndarray:
        """ClusterUtils.splitCluster: the new center is the member point
        farthest from the split cluster's center (the first among equal
        distances). Each point's owner, its nearest center by euclidean
        norm (the first among ties), is found on the device a block of
        rows at a time, so the (N, K, D) difference is never held whole."""
        if self._points is not None and self._points[0] is pts:
            dev = self._points[1]
        else:
            dev = torch.as_tensor(np.asarray(pts, np.float32),
                                  device=self.device)
        c = torch.as_tensor(np.asarray(centers, np.float32),
                            device=self.device)
        d = _norms(dev - c[cluster_idx][None, :])
        rows = max(1, SPLIT_BLOCK_ELEMENTS // max(1, c.numel()))
        owner = torch.cat([torch.argmin(_norms(blk[:, None, :] - c[None]),
                                        dim=1) for blk in dev.split(rows)])
        members = torch.nonzero(owner == cluster_idx)[:, 0]
        if len(members) == 0:
            far = int(torch.argmax(d))
        else:
            far = int(members[torch.argmax(d[members])])
        return np.vstack([centers, pts[far]])


class KMeansClustering(BaseClusteringAlgorithm):
    """kmeans/KMeansClustering.java — the setup() surface of the reference."""

    @classmethod
    def setup(cls, cluster_count: int, max_iterations: int,
              distance_function: str = "euclidean",
              allow_empty_clusters: bool = False, seed: int = 12345,
              device: DeviceLike = None):
        strat = (FixedClusterCountStrategy
                 .setup(cluster_count, distance_function, allow_empty_clusters)
                 .end_when_iteration_count_equals(max_iterations))
        return cls(strat, seed, device)

    @classmethod
    def setup_with_variation(cls, cluster_count: int, variation_rate: float,
                             distance_function: str = "euclidean",
                             seed: int = 12345, device: DeviceLike = None):
        strat = (FixedClusterCountStrategy.setup(cluster_count, distance_function)
                 .end_when_distribution_variation_rate_less_than(variation_rate))
        return cls(strat, seed, device)
