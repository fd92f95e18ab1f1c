"""t-SNE on the card — the port of the JAX package's ``plot/tsne.py``
(``plot/BarnesHutTsne.java`` and ``plot/Tsne.java`` of the reference).

- ``Tsne``: exact t-SNE. The (N, N) input affinities are calibrated by a
  per-row binary search over Gaussian bandwidths, all rows at once; every
  step then forms the (N, N) Student-t affinities of the layout. It holds
  several (N, N) f32 matrices: about five times 4·N² bytes in a step.
- ``BarnesHutTsne``: large-N t-SNE. Input affinities over the 3·perplexity
  nearest neighbours (a sparse, symmetrized P), attraction over that graph
  as a segmented sum, repulsion either exactly in (block, N) tiles on the
  device (``mode="blocked"``) or by the reference's Barnes-Hut walk of a
  host ``SPTree`` (``mode="tree"``).

Both share the reference's schedule: early exaggeration 12 for the first
250 iterations, momentum 0.5 then 0.8 from iteration 250, per-coordinate
gains (+0.2 / x0.8, floor 0.01). The start layout is 1e-4 times the
reference's normal draw from its seed, computed here with numpy
(``_start_points``), so ``Tsne(seed=s)`` starts where the reference does.
Numpy goes in and comes out; the work runs on ``device``, the card unless
the caller names another.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.distances import pairwise_sq_dists
from ..utils.segments import segment_sum

# ---------------------------------------------------------------------------
# The reference's start points: jax.random.normal(PRNGKey(seed), shape, f32)
# under threefry2x32 with jax_threefry_partitionable on, in numpy
# ---------------------------------------------------------------------------

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's single-precision erfinv (Giles' polynomial in w = -log1p(-x²)),
# coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(k1: np.uint32, k2: np.uint32, x0: np.ndarray,
                  x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under the key
    (k1, k2); uint32 arithmetic wraps."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _random_bits(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """uint32 words equal to ``jax.random.bits(PRNGKey(seed), shape)``: the
    key is (0, seed mod 2^32); element i of the flattened shape is the XOR
    of the two words threefry makes from the counter (i >> 32, i mod 2^32)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(np.uint32(0), np.uint32(int(seed) & 0xFFFFFFFF),
                             hi, lo)
    return (a ^ b).reshape(shape)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv on f32 ``x``: log1p correctly rounded, each Horner
    step one fused multiply-add (c + p·w rounded once)."""
    x = x.astype(np.float32)
    w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(small, np.float32(a), np.float32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0].astype(np.float32)
    w64 = w.astype(np.float64)
    for c in coef[1:]:
        p = (c.astype(np.float64) + p.astype(np.float64) * w64).astype(
            np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def _normal_f32(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape, float32)``: the bits' top
    23 as a float in [1, 2), minus 1, scaled to (nextafter(-1, 0), 1), then
    sqrt(2)·erfinv. Equal in its uniforms; within 3 ulps after erfinv."""
    bits = _random_bits(seed, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    # maxval - minval rounds to 2 in f32
    u = np.maximum(lo, (f - np.float32(1.0)) * np.float32(2.0) + lo)
    return np.float32(np.sqrt(2.0)) * _erfinv_f32(u)


def _start_points(seed: int, n: int, n_components: int) -> np.ndarray:
    """The reference's start layout, 1e-4 times its normal draw, f32."""
    return np.float32(1e-4) * _normal_f32(seed, (n, n_components))


# ---------------------------------------------------------------------------
# Input affinities
# ---------------------------------------------------------------------------


def _row_bandwidth_search(d2: torch.Tensor, target_entropy,
                          diagonal: bool = False) -> torch.Tensor:
    """Binary-search each row's Gaussian bandwidth beta (50 steps from 1)
    for the target entropy over the (R, C) squared distances ``d2``; returns
    the rows of P, each normalized. ``diagonal`` leaves out entry (i, i),
    as the reference's self-mask does on the dense (N, N) matrix."""

    def h_beta(beta):
        p = torch.mul(d2, beta[:, None]).neg_().exp_()
        if diagonal:
            p.fill_diagonal_(0.0)
        s = torch.clamp_min(p.sum(1), 1e-12)
        h = torch.log(s) + beta * (p * d2).sum(1) / s
        return h, p, s

    rows = d2.shape[0]
    beta = torch.ones(rows, dtype=d2.dtype, device=d2.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    for _ in range(50):
        h, _, _ = h_beta(beta)
        too_high = h > target_entropy   # entropy too high: raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0,
                           torch.where(torch.isinf(lo), beta / 2.0,
                                       (lo + hi) / 2.0))
    _, p, s = h_beta(beta)
    return p.div_(s[:, None])


def _calibrate_p(d2: torch.Tensor, target_entropy) -> torch.Tensor:
    """Conditional P over the full (N, N) distance matrix, diagonal left
    out."""
    return _row_bandwidth_search(d2, target_entropy, diagonal=True)


def _target_entropy(perplexity: float, device) -> torch.Tensor:
    return torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                  device=device))


# ---------------------------------------------------------------------------
# Exact t-SNE
# ---------------------------------------------------------------------------


def _tsne_step(y, velocity, gains, p, momentum: float, lr: float,
               exaggeration: float, with_kl: bool = True):
    """One exact gradient step from (y, velocity, gains) under P. Returns
    the new (y, velocity, gains) and the KL divergence of the un-exaggerated
    P from this step's Q (None when ``with_kl`` is off: its four (N, N)
    passes are needed only at the last step)."""
    num = pairwise_sq_dists(y).add_(1.0).reciprocal_()
    num.fill_diagonal_(0.0)
    q = num / torch.clamp_min(num.sum(), 1e-12)
    pq = (exaggeration * p).sub_(q).mul_(num)
    del num
    # grad_i = 4 sum_j pq_ij (y_i - y_j): a row scale and one product
    grad = 4.0 * (pq.sum(1, keepdim=True) * y - pq @ y)
    del pq
    same_sign = torch.sign(grad) == torch.sign(velocity)
    gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            0.01)
    velocity = momentum * velocity - lr * gains * grad
    y = y + velocity
    y = y - y.mean(0)
    kl = None
    if with_kl:
        kl = torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-12)
                                              / torch.clamp_min(q, 1e-12)),
                         0.0).sum()
    return y, velocity, gains, kl


class Tsne:
    """Exact t-SNE (BarnesHutTsne.Builder's perplexity, maxIter,
    learningRate, gains, numDimension). ``theta`` is accepted for the
    reference's API and ignored: the computation is exact."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, max_iter: int = 1000,
                 early_exaggeration: float = 12.0,
                 exaggeration_iters: int = 250,
                 momentum_switch_iter: int = 250, theta: float = 0.0,
                 seed: int = 12345, device: DeviceLike = None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.momentum_switch_iter = momentum_switch_iter
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_: Optional[float] = None

    def fit_transform(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        n = x.shape[0]
        if n <= self.n_components:
            return x[:, : self.n_components].cpu().numpy()
        p_cond = _calibrate_p(pairwise_sq_dists(x),
                              _target_entropy(self.perplexity, self.device))
        p = (p_cond + p_cond.T).div_(2.0 * n).clamp_min_(1e-12)
        del p_cond
        y = torch.as_tensor(_start_points(self.seed, n, self.n_components),
                            device=self.device)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        kl = 0.0
        for it in range(self.max_iter):
            momentum = 0.5 if it < self.momentum_switch_iter else 0.8
            ex = self.early_exaggeration if it < self.exaggeration_iters \
                else 1.0
            y, vel, gains, kl_t = _tsne_step(
                y, vel, gains, p, momentum, self.learning_rate, ex,
                with_kl=it == self.max_iter - 1)
            if kl_t is not None:
                kl = kl_t
        self.kl_ = float(kl)
        return y.cpu().numpy()


# ---------------------------------------------------------------------------
# Barnes-Hut t-SNE (large N)
# ---------------------------------------------------------------------------


def _knn_sparse_p(x: torch.Tensor, perplexity: float, chunk: int = 1024):
    """Sparse input affinities over each point's 3·perplexity nearest
    neighbours, by a brute-force scan in chunks of rows. Returns the COO
    (rows, cols, vals) of the symmetrized P = (P + Pᵀ) / 2N on x's device,
    ordered by (row, col): int64, int64, f32.

    A chunk's k + 1 nearest are taken in the order (distance, index), as
    the reference's ``lax.top_k`` orders equal distances by index, and the
    first is dropped as self: with repeated points that first may be an
    earlier copy, and self stays."""
    n = x.shape[0]
    k = min(n - 1, max(1, int(3 * perplexity)))
    target_h = _target_entropy(perplexity, x.device)
    col_ids = torch.arange(n, device=x.device)
    rows_l, cols_l, vals_l = [], [], []
    for s in range(0, n, chunk):
        xc = x[s: s + chunk]
        m = xc.shape[0]
        d2 = pairwise_sq_dists(xc, x)
        # d2 >= +0.0 (never -0.0), so its bits order as its values: the key
        # (bits, column) sorts by distance, then by index
        key = (d2.view(torch.int32).to(torch.int64) << 32) | col_ids
        _, nearest = torch.topk(key, k + 1, dim=1, largest=False,
                                sorted=True)
        del key
        idx = nearest[:, 1:]
        pc = _row_bandwidth_search(d2.gather(1, idx), target_h)
        rows_l.append(torch.arange(s, s + m, device=x.device)
                      .repeat_interleave(k))
        cols_l.append(idx.reshape(-1))
        vals_l.append(pc.reshape(-1).double())
    rows, cols, vals = torch.cat(rows_l), torch.cat(cols_l), torch.cat(vals_l)

    # P = (P + Pᵀ) / 2N, duplicate (i, j) pairs summed. A pair comes at most
    # twice (once from each end's list), and a + b == b + a, so the sum has
    # the same bits in any order.
    keys, order = torch.sort(torch.cat([rows * n + cols, cols * n + rows]),
                             stable=True)
    v = torch.cat([vals, vals])[order]
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    seg = torch.repeat_interleave(
        torch.arange(len(uniq), device=x.device), counts)
    sums = torch.zeros(len(uniq), dtype=torch.float64,
                       device=x.device).index_add_(0, seg, v)
    return uniq // n, uniq % n, (sums / (2.0 * n)).float()


def _dot_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c]·b[..., c] (broadcast), each product and each add its
    own operation, in column order. A product kernel may fuse a multiply
    with an add and round once; here |y_i|² and y_i·y_i are the same
    operations, so a point's squared distance to itself (or to an exact
    copy) comes out exactly 0, as in the reference."""
    out = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        out.add_(a[..., c] * b[..., c])
    return out


def _repulsion_rows(yb, sqb, y, sq):
    """One tile of the blocked repulsion: (rep of the rows ``yb``, their
    part of Z) against every point ``y``; ``sqb`` and ``sq`` are the rows'
    and the points' ``_dot_columns`` squares."""
    # |a|² - 2a·b + |b|², as pairwise_sq_dists; its clamp at 0 is left out:
    # every entry it would change is masked below
    d2 = torch.add(sqb[:, None], _dot_columns(yb[:, None, :], y[None]),
                   alpha=-2.0).add_(sq)
    self_or_dup = d2 <= 1e-12
    num = d2.add_(1.0).reciprocal_().masked_fill_(self_or_dup, 0.0)
    del self_or_dup
    z = num.sum()
    num2 = num.square_()
    return num2.sum(1, keepdim=True) * yb - num2 @ y, z


def _attraction(y, rows, cols, vals, exaggeration: float) -> torch.Tensor:
    """(N, d): sum over each row's edges of exaggeration·p_ij·num_ij·(y_i -
    y_j), a segmented sum over the sorted rows."""
    dy = y[rows] - y[cols]
    num = 1.0 / (1.0 + (dy * dy).sum(1))
    w = (exaggeration * vals) * num
    return segment_sum(w[:, None] * dy, rows, y.shape[0])


def _sparse_kl(y, rows, cols, vals, block: int) -> torch.Tensor:
    """KL(P || Q) over P's support, Q normalized by the exact Z."""
    dy = y[rows] - y[cols]
    num = 1.0 / (1.0 + (dy * dy).sum(1))
    _, z = BarnesHutTsne._repulsion_blocked(y, block)
    q = torch.clamp_min(num / torch.clamp_min(z, 1e-12), 1e-12)
    p = torch.clamp_min(vals, 1e-12)
    return (vals * (torch.log(p) - torch.log(q))).sum()


class BarnesHutTsne:
    """Large-N t-SNE (plot/BarnesHutTsne.java).

    ``mode="blocked"`` (default): the repulsion summed exactly over (block,
    N) tiles on the device, so N² is never held at once (theta is unused).
    ``mode="tree"``: the reference's Barnes-Hut algorithm, a host ``SPTree``
    built every iteration and walked per point with the theta criterion;
    host speed, for parity and small N.

    Same schedule as ``Tsne``.
    """

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, max_iter: int = 1000,
                 early_exaggeration: float = 12.0,
                 exaggeration_iters: int = 250,
                 momentum_switch_iter: int = 250, theta: float = 0.5,
                 mode: str = "blocked", block: int = 2048,
                 seed: int = 12345, device: DeviceLike = None):
        if mode not in ("blocked", "tree"):
            raise ValueError(f"mode must be 'blocked' or 'tree', got {mode!r}")
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.momentum_switch_iter = momentum_switch_iter
        self.theta = theta
        self.mode = mode
        self.block = block
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_: Optional[float] = None

    @staticmethod
    def _repulsion_blocked(y: torch.Tensor, block: int):
        """(rep, Z): rep_i = sum_j num_ij² (y_i - y_j), Z = sum_ij num_ij,
        with num = 1 / (1 + |y_i - y_j|²) and pairs at most 1e-12 apart in
        squared distance (self, duplicates) left out. Rows go ``block`` at a
        time (``_repulsion_rows``), so a (block, N) tile is the most held
        at once."""
        sq = _dot_columns(y, y)
        reps, zs = [], []
        for s in range(0, y.shape[0], block):
            rep, z = _repulsion_rows(y[s: s + block], sq[s: s + block], y, sq)
            reps.append(rep)
            zs.append(z)
        return torch.cat(reps), torch.stack(zs).sum()

    @staticmethod
    def _step_blocked_update(y, velocity, gains, attr, rep, z,
                             momentum: float, lr: float):
        grad = 4.0 * (attr - rep / torch.clamp_min(z, 1e-12))
        same_sign = torch.sign(grad) == torch.sign(velocity)
        gains = torch.clamp_min(torch.where(same_sign, gains * 0.8,
                                            gains + 0.2), 0.01)
        velocity = momentum * velocity - lr * gains * grad
        y = y + velocity
        y = y - y.mean(0)
        return y, velocity, gains

    def fit_transform(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        n = int(x.shape[0])
        if n <= self.n_components:
            return x[:, : self.n_components].cpu().numpy()
        rows, cols, vals = _knn_sparse_p(x, self.perplexity)
        y = torch.as_tensor(_start_points(self.seed, n, self.n_components),
                            device=self.device)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        blk = min(self.block, max(64, n))
        for it in range(self.max_iter):
            momentum = 0.5 if it < self.momentum_switch_iter else 0.8
            ex = self.early_exaggeration if it < self.exaggeration_iters \
                else 1.0
            attr = _attraction(y, rows, cols, vals, ex)
            if self.mode == "blocked":
                rep, z = self._repulsion_blocked(y, blk)
            else:
                rep, z = self._repulsion_tree(y.cpu().numpy())
                rep = torch.as_tensor(rep, device=self.device)
                z = torch.tensor(z, dtype=torch.float32, device=self.device)
            y, vel, gains = self._step_blocked_update(
                y, vel, gains, attr, rep, z, momentum, self.learning_rate)
        self.kl_ = float(_sparse_kl(y, rows, cols, vals, blk))
        return y.cpu().numpy()

    def _repulsion_tree(self, y: np.ndarray):
        """The host Barnes-Hut repulsion: an ``SPTree`` over y, walked for
        every point with theta. Returns (rep f32 (N, d), Z f32)."""
        from ..knn.sptree import SPTree

        tree = SPTree(y)
        rep = np.zeros_like(y, np.float64)
        z = 0.0
        for i in range(y.shape[0]):
            neg, sq = tree.compute_non_edge_forces(y[i], self.theta)
            rep[i] = neg
            z += sq
        return rep.astype(np.float32), np.float32(z)
