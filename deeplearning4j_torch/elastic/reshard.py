"""Optimizer-state redistribution planning for mesh resizes — counterpart
of ``deeplearning4j_tpu/elastic/reshard.py``.

When the elastic trainer resizes its data-parallel ladder (dp_from ->
dp_to), every ZeRO-1 updater-state leaf moves from its old block layout
to the new one. Both layouts are described as per-replica index blocks
(contiguous equal slices along the dimension
:func:`~..parallel.sharding.zero_shard_dim` picks), the blocks are
intersected, and only the **non-resident** bytes count as traffic: a
replica keeps whatever slice of the leaf it already holds and fetches
the set difference (arXiv 2112.01075). The naive comparator is the full
re-gather: every new replica fetches the whole leaf but what it holds.

The plan is host arithmetic over shapes and item sizes; its moved and
naive bytes are the reference planner's, number for number. The trainer
copies the blocks (``ElasticTrainer._resize``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.sharding import zero_shard_dim

Box = List[Tuple[int, int]]


class LeafLayout(NamedTuple):
    """One tree leaf's block layout at dp width ``dp``: ``dim`` is the
    sharded dimension (None: whole on every replica)."""

    path: str
    shape: Tuple[int, ...]
    itemsize: int
    dim: Optional[int]
    dp: int


class LeafMove(NamedTuple):
    """One leaf's planned traffic: bytes fetched under the overlap plan
    and under the naive full re-gather."""

    path: str
    bytes_moved: int
    bytes_naive: int


class ReshardPlan(NamedTuple):
    """The redistribution bill of one dp_from -> dp_to resize."""

    dp_from: int
    dp_to: int
    moves: Tuple[LeafMove, ...]
    bytes_moved: int
    bytes_naive: int
    bytes_total: int  # size of everything being redistributed

    def summary(self) -> dict:
        """JSON-safe headline (what the resize log and flight record
        carry)."""
        return {"dp_from": self.dp_from, "dp_to": self.dp_to,
                "bytes_moved": self.bytes_moved,
                "bytes_naive": self.bytes_naive,
                "bytes_total": self.bytes_total,
                "leaves": len(self.moves)}


def leaf_layout(path: str, shape: Sequence[int], itemsize: int,
                dp: int) -> LeafLayout:
    """The layout of one updater-state leaf at width ``dp`` under the
    ZeRO-1 rule (largest dp-divisible dim, else whole)."""
    shape = tuple(int(s) for s in shape)
    return LeafLayout(path, shape, int(itemsize),
                      zero_shard_dim(shape, dp), int(dp))


def block(shape: Sequence[int], dim: Optional[int], dp: int,
          replica: int) -> Optional[Box]:
    """Half-open index intervals per dimension that ``replica`` holds at
    width ``dp``, or None when it is past the ladder's width."""
    if replica >= dp:
        return None
    ivs = [(0, int(s)) for s in shape]
    if dim is not None:
        per = shape[dim] // dp
        ivs[dim] = (replica * per, (replica + 1) * per)
    return ivs


def elems(ivs: Optional[Box]) -> int:
    if ivs is None:
        return 0
    n = 1
    for lo, hi in ivs:
        n *= max(0, hi - lo)
    return n


def intersect(a: Optional[Box], b: Optional[Box]) -> Optional[Box]:
    """The intersection of two axis-aligned blocks (None when empty)."""
    if a is None or b is None:
        return None
    out = [(max(alo, blo), min(ahi, bhi))
           for (alo, ahi), (blo, bhi) in zip(a, b)]
    return out if all(hi > lo for lo, hi in out) or not out else None


def box_index(box: Box, origin: Box) -> Tuple[slice, ...]:
    """The slices that pick ``box`` out of a block whose box is
    ``origin``."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in zip(box, origin))


def plan_leaf(old: LeafLayout, new: LeafLayout) -> LeafMove:
    """One leaf's traffic: for every replica of the NEW layout, the bytes
    of its block not resident from the OLD layout; the naive comparator
    re-gathers the whole leaf to every new replica that does not hold all
    of it."""
    if old.shape != new.shape:
        raise ValueError(f"leaf {old.path!r}: shape changed across resize "
                         f"({old.shape} -> {new.shape})")
    moved = naive = 0
    total = elems([(0, s) for s in new.shape])
    for r in range(new.dp):
        need = block(new.shape, new.dim, new.dp, r)
        have = block(old.shape, old.dim, old.dp, r)
        moved += elems(need) - elems(intersect(need, have))
        naive += total - elems(have)
    return LeafMove(new.path, moved * new.itemsize, naive * new.itemsize)


def _itemsize(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.element_size()
    return np.dtype(getattr(leaf, "dtype", np.float32)).itemsize


def tree_paths(tree, prefix="") -> List[Tuple[str, object]]:
    """(path, leaf) of every leaf, dict keys sorted and sequences (tuples,
    lists, named tuples) by position, as the reference names them."""
    out: List[Tuple[str, object]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(tree_paths(v, f"{prefix}{i}/"))
    elif tree is not None:
        out.append((prefix.rstrip("/"), tree))
    return out


def plan_reshard(opt_state, dp_from: int, dp_to: int) -> ReshardPlan:
    """Plan redistributing ``opt_state`` (a tree of tensors or arrays)
    from a dp_from-wide ZeRO-1 layout to dp_to."""
    if dp_from < 1 or dp_to < 1:
        raise ValueError("dp widths must be >= 1")
    moves: List[LeafMove] = []
    total = 0
    for path, leaf in tree_paths(opt_state):
        shape = tuple(int(s) for s in leaf.shape)
        itemsize = _itemsize(leaf)
        total += int(np.prod(shape, dtype=np.int64)) * itemsize
        moves.append(plan_leaf(leaf_layout(path, shape, itemsize, dp_from),
                               leaf_layout(path, shape, itemsize, dp_to)))
    return ReshardPlan(int(dp_from), int(dp_to), tuple(moves),
                       sum(m.bytes_moved for m in moves),
                       sum(m.bytes_naive for m in moves), total)
