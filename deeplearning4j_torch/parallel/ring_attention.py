"""Ring attention — counterpart of
``deeplearning4j_tpu/parallel/ring_attention.py``: sequence parallelism
for long sequences, on the flash kernels.

Sequences shard over the ``seq`` group; each rank holds a (B, T/n, H, D)
block of q, k and v, and the K/V blocks rotate around the ring
(``collectives.ppermute_start``, one ``batch_isend_irecv`` a step) while
each rank attends its query block to the block it holds:

- forward, per held block (:func:`ring_step`): K1 causal on the diagonal
  block, K1 non-causal on an earlier block, no launch for a later block
  under ``causal``; each launch gives ``(o, lse)`` and the blocks merge in
  f32 by ``exp(lse_i - lse)`` (the reference accumulates einsum blocks
  with an online softmax: the same sums, grouped by block);
- backward, from the merged output's global ``lse`` and ``delta =
  rowsum(dO * O)`` (:func:`ring_step_backward`): each held block runs K2
  for its dQ contribution and K3 for its dK and dV; dK and dV travel
  around the ring one step behind their block and end at its owner.

Every hop is double-buffered: it is issued before the step whose kernels
read the block it sends, and waited on only before the next step, so the
K/V rotation (and the backward's dK/dV hop) overlaps the kernels.

On CPU tensors the same composition calls the plain versions
(``flash_attention_reference``, ``flash_attention_backward_reference``),
as ``ops.flash_attention`` does; there ``k_chunk`` bounds the score
memory (a block pair is cut into square sub-blocks of at most
``k_chunk`` positions a side, the largest that divides the block). On the
card ``k_chunk`` has no effect. A shape the kernels refuse raises.

:func:`ring_step` needs no group, and the schedule takes its hop as a
parameter: :func:`ring_attention_local` hops over the seq group,
:func:`ring_attention_blocks` runs the same loops over ``n`` blocks in one
process (the tests and the card's check use it).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.flash_attention import (flash_attention_backward_reference,
                                   flash_attention_reference,
                                   flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                   flash_fwd_cuda)
from .mesh import SEQ_AXIS

State = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _chunk(T: int, k_chunk: Optional[int]) -> int:
    """The sub-block side: the largest divisor of T up to ``k_chunk``."""
    if not k_chunk or k_chunk >= T:
        return T
    return max(c for c in range(1, int(k_chunk) + 1) if T % c == 0)


def merge(state: State, o_i: torch.Tensor, lse_i: torch.Tensor) -> State:
    """``state`` (f32 normalized output and lse, or (None, None)) merged
    with a block's ``(o_i, lse_i)``."""
    o, lse = state
    if o is None:
        return o_i.float(), lse_i
    new = torch.logaddexp(lse, lse_i)
    return (o * torch.exp(lse - new)[..., None]
            + o_i.float() * torch.exp(lse_i - new)[..., None], new)


def _pair_fwd(q, k, v, *, scale, diag, k_chunk):
    """(o, lse) of (BH, T, D) ``q`` over one held block, causal within it
    when ``diag``: one K1 launch on the card; on the CPU the plain
    version, over square sub-blocks of ``k_chunk``."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, scale=scale, causal=diag)
    T = q.shape[1]
    c = _chunk(T, k_chunk)
    if c == T:
        return flash_attention_reference(q, k, v, scale=scale, causal=diag)
    outs, lses = [], []
    for a in range(0, T, c):
        st: State = (None, None)
        for b in range(0, T, c):
            if diag and b > a:
                continue
            st = merge(st, *flash_attention_reference(
                q[:, a:a + c], k[:, b:b + c], v[:, b:b + c], scale=scale,
                causal=diag and a == b))
        outs.append(st[0].to(q.dtype))
        lses.append(st[1])
    return torch.cat(outs, 1), torch.cat(lses, 1)


def ring_step(q, k, v, q_block: int, k_block: int, state: State, *,
              causal: bool, scale: float, k_chunk: Optional[int] = None
              ) -> State:
    """One step of the ring: (BH, T, D) query block ``q_block`` attends the
    held K/V block ``k_block``; returns the merged f32 state (unchanged for
    a later block under ``causal``, which launches nothing)."""
    if causal and k_block > q_block:
        return state
    return merge(state, *_pair_fwd(q, k, v, scale=scale,
                                   diag=causal and k_block == q_block,
                                   k_chunk=k_chunk))


def ring_step_backward(q, k, v, do, lse, delta, q_block: int, k_block: int,
                       *, causal: bool, scale: float,
                       k_chunk: Optional[int] = None):
    """The held block's gradient contributions ``(dq, dk, dv)`` (f32) from
    the merged output's ``lse`` and ``delta`` ((BH, T) f32), or None for a
    later block under ``causal``: K2 and K3 once each on the card, the
    plain backward on the CPU."""
    if causal and k_block > q_block:
        return None
    diag = causal and k_block == q_block
    if q.is_cuda:
        kw = dict(scale=scale, causal=diag)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        return dq.float(), dk.float(), dv.float()
    T = q.shape[1]
    c = _chunk(T, k_chunk)
    dq = torch.zeros(q.shape, dtype=torch.float32)
    dk = torch.zeros(k.shape, dtype=torch.float32)
    dv = torch.zeros(v.shape, dtype=torch.float32)
    for a in range(0, T, c):
        for b in range(0, T, c):
            if diag and b > a:
                continue
            g = flash_attention_backward_reference(
                q[:, a:a + c], k[:, b:b + c], v[:, b:b + c], do[:, a:a + c],
                lse[:, a:a + c], delta[:, a:a + c], scale=scale,
                causal=diag and a == b)
            dq[:, a:a + c] += g[0].float()
            dk[:, b:b + c] += g[1].float()
            dv[:, b:b + c] += g[2].float()
    return dq, dk, dv


def _to_bh(a):
    B, T, H, D = a.shape
    return a.permute(0, 2, 1, 3).reshape(B * H, T, D)


def _from_bh(a, B, H):
    BH, T, D = a.shape
    return a.reshape(B, H, T, D).permute(0, 2, 1, 3)


class _GroupRotation:
    """The ring over ``group``: this process is one rank; a hop is one
    :func:`collectives.ppermute_start` to the next rank."""

    def __init__(self, group):
        from .collectives import ring_perm

        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = [dist.get_rank(group)]
        self.perm = ring_perm(self.n)

    def start(self, held, tag):
        from .collectives import ppermute_start

        return ppermute_start(held[0], self.group, self.perm, tag)

    def wait(self, hop):
        from .collectives import ppermute_wait

        return [ppermute_wait(hop)]


class _LocalRotation:
    """The ring over ``n`` blocks in this process: rank ``i``'s block is
    the ``i``-th; a hop shifts the list by one."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = list(range(n))

    def start(self, held, tag):
        return [held[(i - 1) % self.n] for i in range(self.n)]

    def wait(self, hop):
        return hop


def _cat(parts):
    """Blocks joined along T (one block as it is)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


_KV, _ACC = 0, 1  # the tags of the two hops in flight in the backward


def _plus(acc, g):
    """A travelling (dk, dv) accumulator with this step's contribution
    (either may be None: nothing arrived yet, or a later block)."""
    if g is None:
        return acc
    if acc is None:
        return [g[1], g[2]]
    return [acc[0] + g[1], acc[1] + g[2]]


class _Ring(torch.autograd.Function):
    """The ring's schedule on (BH, T, D) q, k, v: the blocks of the ranks
    that ``rot`` puts in this process, concatenated along T (see the module
    docstring). Each hop is issued before the step that reads what it
    sends, so the transfer overlaps that step's kernels."""

    @staticmethod
    def forward(ctx, q, k, v, rot, causal, scale, k_chunk):
        m, n = len(rot.ranks), rot.n
        qs, ks, vs = (t.split(t.shape[1] // m, dim=1) for t in (q, k, v))
        held = [[k_, v_] for k_, v_ in zip(ks, vs)]
        states = [(None, None)] * m
        for step in range(n):
            hop = rot.start(held, _KV) if step < n - 1 else None
            for i, r in enumerate(rot.ranks):
                states[i] = ring_step(qs[i], *held[i], r, (r - step) % n,
                                      states[i], causal=causal, scale=scale,
                                      k_chunk=k_chunk)
            if hop is not None:
                held = rot.wait(hop)
        o = _cat([st[0].to(q.dtype) for st in states])
        ctx.save_for_backward(q, k, v, o, _cat([st[1] for st in states]))
        ctx.args = (rot, causal, scale, k_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        rot, causal, scale, k_chunk = ctx.args
        m, n = len(rot.ranks), rot.n
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        T = q.shape[1] // m
        qs, ks, vs, dos = (t.split(T, dim=1) for t in (q, k, v, do))
        lses, deltas = lse.split(T, dim=1), delta.split(T, dim=1)
        dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in qs]
        held = [[k_, v_] for k_, v_ in zip(ks, vs)]
        # the held block's (dk, dv) travel with it one step behind: the hop
        # of step s's sums overlaps step s + 1's kernels; after the last
        # step they reach the block's owner
        kv_hop = rot.start(held, _KV) if n > 1 else None
        acc_hop = None
        for step in range(n):
            gs = [ring_step_backward(qs[i], *held[i], dos[i], lses[i],
                                     deltas[i], r, (r - step) % n,
                                     causal=causal, scale=scale,
                                     k_chunk=k_chunk)
                  for i, r in enumerate(rot.ranks)]
            acc = rot.wait(acc_hop) if acc_hop is not None else [None] * m
            for i, g in enumerate(gs):
                if g is not None:
                    dq[i] += g[0]
            acc_hop = rot.start([_plus(a, g) for a, g in zip(acc, gs)], _ACC)
            if kv_hop is not None:
                held = rot.wait(kv_hop)
                kv_hop = rot.start(held, _KV) if step < n - 2 else None
        dkv = rot.wait(acc_hop)
        return (_cat(dq).to(q.dtype), _cat([a[0] for a in dkv]).to(k.dtype),
                _cat([a[1] for a in dkv]).to(v.dtype), None, None, None, None)


def ring_attention_local(q, k, v, *, group, causal: bool = False,
                         scale: Optional[float] = None,
                         k_chunk: int = 1024):
    """Per-rank body: q, k, v (B, T_local, H, D), this rank's sequence
    block (block i on rank i of ``group``, the seq process group); returns
    (B, T_local, H, D) exact attention over the whole sequence,
    differentiable."""
    B, T, H, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    o = _Ring.apply(_to_bh(q), _to_bh(k), _to_bh(v), _GroupRotation(group),
                    causal, scale, k_chunk)
    return _from_bh(o, B, H)


def ring_attention(q, k, v, mesh, *, causal: bool = False,
                   seq_axis: str = SEQ_AXIS, k_chunk: int = 1024,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None):
    """Global (B, T, H, D) q, k, v (every rank holds them whole) through the
    ring: this rank's block (T over ``seq_axis``, B over ``batch_axis``,
    heads over ``head_axis``: the dp x sp and tp x sp compositions), the
    ring over the seq group, the blocks gathered back. T must divide by
    the seq axis. Differentiable: the gradient of each input is whole on
    every rank."""
    from .collectives import copy_to, gather_split

    axes = [(1, seq_axis), (0, batch_axis), (2, head_axis)]
    axes = [(d, a) for d, a in axes if a is not None and a in mesh.shape]
    group = mesh.axis_group([a for _, a in axes])
    blocks = []
    for t in (q, k, v):
        t = copy_to(t, group)
        for d, a in axes:
            sl = mesh.rows(t.shape[d], a)
            t = t.narrow(d, sl.start, sl.stop - sl.start)
        blocks.append(t)
    o = ring_attention_local(*blocks, group=mesh.axis_group(seq_axis),
                             causal=causal, k_chunk=k_chunk)
    for d, a in reversed(axes):
        o = gather_split(o, mesh.axis_group(a), d)
    return o


def reference_attention(q, k, v, causal: bool = False):
    """Dense single-device attention, f32 scores (the equivalence
    tests' oracle)."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        T = q.shape[1]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep[None, None], s, torch.full_like(s, -math.inf))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def ring_attention_blocks(q, k, v, n: int, *, causal: bool = False,
                          scale: Optional[float] = None,
                          k_chunk: int = 1024):
    """The ring over ``n`` sequence blocks in one process: (B, T, H, D) q,
    k, v, T divisible by ``n``; the same schedule as
    :func:`ring_attention_local` (its forward and backward loops, with a
    hop that shifts a list of blocks in place of one over a group), so
    each query block's merge and each key block's gradient accumulation
    run as rank by rank. Differentiable."""
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"T={T} does not divide into {n} blocks")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    o = _Ring.apply(_to_bh(q), _to_bh(k), _to_bh(v), _LocalRotation(int(n)),
                    causal, scale, k_chunk)
    return _from_bh(o, B, H)
