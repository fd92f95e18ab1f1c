"""Differentiable collectives over a process group: what GSPMD inserts
between sharded operands in the JAX package, written out for tensor,
sequence and pipeline parallelism.

Each op runs through its group at every size, a group of one rank too.
Their backwards are the adjoints that the layer layouts need:

- :func:`copy_to` (Megatron's ``f``): identity forward, all-reduce
  backward — a replicated input entering rank-specific work;
- :func:`reduce_from` (``g``): all-reduce forward, identity backward —
  partial sums leaving rank-specific work as a replicated output;
- :func:`gather_split`: all-gather forward, this rank's slice backward —
  a shard whose gathered value feeds work every rank does alike;
- :func:`gather_sum`: all-gather forward, reduce-scatter backward — a
  shard whose gathered value feeds rank-specific work (sequence blocks,
  local heads);
- :func:`ppermute`: each rank's tensor to the rank ``perm`` names (one
  ``dist.batch_isend_irecv``), backward the inverse permutation; the
  pipeline's hops. The ring rotates K/V by :func:`ppermute_start` and
  :func:`ppermute_wait`, so a hop overlaps the step before it.

gloo has no reduce-scatter: there the backward all-reduces and slices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def global_rank(group, r: int) -> int:
    """The default group's rank of ``group``'s rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, in place (``t`` is made contiguous
    first)."""
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    n = dist.get_world_size(group)
    flat = t.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, flat, group=group)
    if n == 1:  # one block: it is the whole
        return out.view(t.shape)
    parts = out.view((n,) + tuple(t.shape)).unbind(0)
    return torch.cat(parts, dim=dim)


def local_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (which the group's size
    divides)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's block along ``dim``."""
    if dist.get_backend(group) == "nccl":
        n = dist.get_world_size(group)
        if n == 1:  # one block: no reordering of the input needed
            t = t.contiguous()
            out = torch.empty_like(t)
            dist.reduce_scatter_tensor(out, t, group=group)
            return out
        parts = t.movedim(dim, 0)
        parts = parts.reshape((n, parts.shape[0] // n) + tuple(parts.shape[1:]))
        out = torch.empty(parts.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, parts.contiguous(), group=group)
        return out.movedim(0, dim).contiguous()
    return local_slice(all_reduce(t.clone(), group), group, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward over ``group``, identity backward."""
    return _ReduceFrom.apply(x, group)


def gather_split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, this rank's slice backward."""
    return _GatherSplit.apply(x, group, dim % x.ndim)


def gather_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward."""
    return _GatherSum.apply(x, group, dim % x.ndim)


def ppermute_start(tensors: Sequence[torch.Tensor], group,
                   perm: Sequence[Tuple[int, int]], tag: int = 0):
    """Issue :func:`ppermute_raw`'s sends and receives without waiting:
    returns the handle that :func:`ppermute_wait` completes. Work issued in
    between overlaps the transfer (NCCL runs it on its own stream, gloo on
    its own threads); ``tensors`` must not change before the wait. Hops in
    flight at once between the same ranks take distinct ``tag``s."""
    me = dist.get_rank(group)
    outs = [torch.zeros(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = []
    for s, d in perm:
        if s == me and d == me:
            for o, t in zip(outs, tensors):
                o.copy_(t)
            continue
        if s == me:
            ops += [dist.P2POp(dist.isend, t.contiguous(),
                               global_rank(group, d), group, tag)
                    for t in tensors]
        if d == me:
            ops += [dist.P2POp(dist.irecv, o, global_rank(group, s), group,
                               tag) for o in outs]
    return outs, (dist.batch_isend_irecv(ops) if ops else [])


def ppermute_wait(handle) -> List[torch.Tensor]:
    """What this rank receives from a :func:`ppermute_start` (on NCCL the
    current stream waits for it; the host does not)."""
    outs, reqs = handle
    for req in reqs:
        req.wait()
    return outs


def ppermute_raw(tensors: Sequence[torch.Tensor], group,
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Each of ``tensors`` sent to the ranks that ``perm`` ((source,
    destination) group ranks) pairs with this rank as source; returns what
    this rank receives (zeros where no pair names it as destination), in
    one ``batch_isend_irecv``. A pair of a rank with itself is a copy."""
    return ppermute_wait(ppermute_start(tensors, group, perm))


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perm, *tensors):
        ctx.group, ctx.perm = group, perm
        outs = tuple(ppermute_raw(tensors, group, perm))
        ctx.like = [(o.shape, o.dtype, o.device) for o in outs]
        return outs

    @staticmethod
    def backward(ctx, *grads):
        inverse = tuple((d, s) for s, d in ctx.perm)
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None
                 else g for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, None) + tuple(ppermute_raw(grads, ctx.group, inverse))


def ppermute(tensors, group, perm: Sequence[Tuple[int, int]]):
    """Differentiable :func:`ppermute_raw`: a tensor or a list of them in,
    the same out; the backward sends the gradients the inverse way."""
    single = torch.is_tensor(tensors)
    ts = [tensors] if single else list(tensors)
    out = _Ppermute.apply(group, tuple(perm), *ts)
    return out[0] if single else list(out)


def ring_perm(n: int, shift: int = 1) -> Tuple[Tuple[int, int], ...]:
    """Each rank to the rank ``shift`` after it, cyclically."""
    return tuple((j, (j + shift) % n) for j in range(n))


def stage_perm(n: int) -> Tuple[Tuple[int, int], ...]:
    """Each stage to the next, the last to none (the pipeline's hop)."""
    return tuple((j, j + 1) for j in range(n - 1))
