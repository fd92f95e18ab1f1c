"""Scatter-adds and segment reductions with the same bits every run: the
port's counterparts of XLA's scatter-add, ``jax.ops.segment_sum`` and
``segment_max``.

A sum adds each row's terms one after another in the order of the
indices. Each device has its own deterministic form: on the card
``index_put_(accumulate=True)`` (a stable sort of the indices, then each
row's additions in turn; ``index_add_`` there uses float atomics, whose
order changes from run to run), on the CPU ``index_add_`` (a serial loop;
``index_put_`` there adds in parallel). A max does not depend on the
order of its terms.
"""

from __future__ import annotations

import torch


def scatter_add_(table: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """``table[idx[i]] += rows[i]`` for every i, in place, repeated rows
    summed one after another in the order of ``idx``."""
    if table.is_cuda:
        table.index_put_((idx,), rows, accumulate=True)
    else:
        table.index_add_(0, idx, rows)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, *values.shape[1:]): the sum of the rows of ``values``
    that ``seg`` names for each segment; 0 for a segment named by none."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    scatter_add_(out, seg, values)
    return out


def segment_max(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments,): the largest of the 1-D ``values`` that ``seg`` names
    for each segment; -inf for a segment named by none."""
    out = values.new_full((num_segments,), float("-inf"))
    return out.scatter_reduce_(0, seg, values, reduce="amax",
                               include_self=True)
