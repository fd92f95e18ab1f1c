"""Gradient compression — counterpart of
``deeplearning4j_tpu/parallel/compression.py`` (ND4J's threshold and
bitmap encodings, Strom style, and the exact top-k codec).

- ``threshold_encode(g, t)``: the ``capacity`` entries of ``g + residual``
  largest in magnitude whose magnitude is at least ``t`` go out as ±t
  (index and sign); the residual keeps the rest, ``g + residual`` minus
  what was sent.
- ``topk_encode``: the same selection with the exact values.
- ``bitmap_encode``: a dense int8 code in {-1, 0, +1} a entry.

Plain tensor code (``torch.topk``, ``index_add_``), on whatever device the
gradient is. Messages have a fixed capacity; ``count`` says how many of
their slots are over the threshold (the rest carry 0). Indices are int32,
as the reference's. The order of a message's slots is not the
reference's (``lax.top_k`` sorts them by magnitude; here they come as
``torch.topk(sorted=False)`` gives them, and in index order at full
capacity): decoding does not depend on it. Which of several entries of
equal magnitude at the capacity's edge is taken is ``torch.topk``'s
choice (the reference takes the lower index); the residual and the
decoded update are the reference's whenever no such tie straddles the
edge.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def auto_capacity_frac(n_workers: int) -> float:
    """Default message capacity as a fraction of the param count: half the
    per-worker wire break-even of a quantized message (5 bytes a slot,
    all-gathered to n workers) against a dense ring all-reduce (about
    2(n-1)/n x 4 bytes a param), which is 1.6/n; capped at 0.05."""
    return min(0.05, 0.8 / max(n_workers, 1))


class SparseUpdate(NamedTuple):
    """Fixed-capacity ±threshold message: indices (k,) int32, signs (k,)
    int8, count (int32), threshold."""

    indices: torch.Tensor
    signs: torch.Tensor
    count: torch.Tensor
    threshold: torch.Tensor


class TopKUpdate(NamedTuple):
    """Fixed-capacity exact message: indices (k,) int32, values (k,),
    count (int32)."""

    indices: torch.Tensor
    values: torch.Tensor
    count: torch.Tensor


def _select(absg: torch.Tensor, capacity: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(magnitudes, int64 indices) of the ``capacity`` largest entries of
    ``absg``: every entry, in index order, at full capacity."""
    n = absg.numel()
    if not 0 < capacity <= n:
        raise ValueError(f"capacity {capacity} outside 1..{n}")
    if capacity == n:
        return absg, torch.arange(n, device=absg.device)
    vals, idx = torch.topk(absg, capacity, sorted=False)
    return vals, idx


def _g(grad: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    return grad.reshape(-1) + residual


def threshold_encode(grad: torch.Tensor, threshold: float, capacity: int,
                     residual: torch.Tensor
                     ) -> Tuple[SparseUpdate, torch.Tensor]:
    """Encode flat ``grad + residual``: returns (update, new residual)."""
    g = _g(grad, residual)
    vals, idx = _select(g.abs(), capacity)
    over = vals >= threshold
    signs = torch.sign(g[idx]) * over
    # new residual = g minus what went out (±threshold at the slots)
    new_residual = g.index_add_(0, idx, signs * -threshold)
    return (SparseUpdate(idx.to(torch.int32), signs.to(torch.int8),
                         over.sum(dtype=torch.int32),
                         torch.tensor(threshold, dtype=g.dtype,
                                      device=g.device)),
            new_residual)


def threshold_decode(update: SparseUpdate, size: Optional[int] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode into a dense flat f32 vector (``out``, which it adds into,
    or a new one of ``size``)."""
    if out is None:
        if size is None:
            raise ValueError("threshold_decode needs size or out")
        out = torch.zeros(size, dtype=torch.float32,
                          device=update.indices.device)
    contrib = update.signs.to(out.dtype) * update.threshold.to(out.dtype)
    return out.index_add_(0, update.indices, contrib)


def topk_encode(grad: torch.Tensor, threshold: float, capacity: int,
                residual: torch.Tensor) -> Tuple[TopKUpdate, torch.Tensor]:
    """Encode flat ``grad + residual`` as (indices, exact values); entries
    under the threshold or past the capacity stay in the residual."""
    g = _g(grad, residual)
    vals, idx = _select(g.abs(), capacity)
    over = vals >= threshold
    values = g[idx] * over
    new_residual = g.index_add_(0, idx, -values)
    return (TopKUpdate(idx.to(torch.int32), values,
                       over.sum(dtype=torch.int32)), new_residual)


def topk_decode(update: TopKUpdate, size: Optional[int] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if out is None:
        if size is None:
            raise ValueError("topk_decode needs size or out")
        out = torch.zeros(size, dtype=torch.float32,
                          device=update.indices.device)
    return out.index_add_(0, update.indices, update.values.to(out.dtype))


def bitmap_encode(grad: torch.Tensor, threshold: float,
                  residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense code: int8 in {-1, 0, +1} a entry (the wire packs four to a
    byte; that is the IO layer's business); returns (code, new
    residual)."""
    g = _g(grad, residual)
    code = torch.where(g >= threshold, 1,
                       torch.where(g <= -threshold, -1, 0)).to(torch.int8)
    return code, g - code.to(g.dtype) * threshold


def bitmap_decode(code: torch.Tensor, threshold: float) -> torch.Tensor:
    return code.to(torch.float32) * threshold


class EncodedGradientsAccumulator:
    """Workers ``store_update`` their flat gradients, each encoded against
    its own residual; ``apply_updates`` folds every pending message into
    one dense f32 vector and clears them (EncodedGradientsAccumulator
    parity)."""

    def __init__(self, size: int, threshold: float = 1e-3,
                 capacity_frac: Optional[float] = None, n_workers: int = 8):
        self.size = size
        self.threshold = threshold
        if capacity_frac is None:
            capacity_frac = auto_capacity_frac(n_workers)
        self.capacity = max(1, int(size * capacity_frac))
        self.residuals = {}
        self.pending = []

    def store_update(self, worker_id, grad_flat: torch.Tensor) -> SparseUpdate:
        grad_flat = torch.as_tensor(grad_flat, dtype=torch.float32)
        res = self.residuals.get(worker_id)
        if res is None:
            res = torch.zeros(self.size, dtype=torch.float32,
                              device=grad_flat.device)
        enc, new_res = threshold_encode(grad_flat, self.threshold,
                                        self.capacity, res)
        self.residuals[worker_id] = new_res
        self.pending.append(enc)
        return enc

    def apply_updates(self) -> torch.Tensor:
        dev = self.pending[0].indices.device if self.pending else None
        out = torch.zeros(self.size, dtype=torch.float32, device=dev)
        for enc in self.pending:
            out = threshold_decode(enc, out=out)
        self.pending.clear()
        return out
