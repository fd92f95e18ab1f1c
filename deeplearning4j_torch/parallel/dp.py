"""Data parallelism over a process group: what GSPMD does implicitly for
the JAX package's sharded step, done explicitly with collectives.

**Reduction by loss mass.** The JAX package's sharded step takes the
gradient of ONE loss over the global batch: each loss-bearing output's
masked mean, ``sum(loss x mask) / max(sum(mask), 1)``. So a rank's
gradient counts by its share of the mass, not as 1/n of a mean of
means. Each rank scores its rows in parts (``score_parts``: each
output's masked-mean loss and its ``reduction_mass``), the masses are
summed over the group (one small all-reduce), and the rank's objective is

    sum_o loss_o x (max(w_o, 1) / max(W_o, 1))  +  aux / world

(``w_o`` its own mass of output ``o``, ``W_o`` the group's; the first
factor recovers the rank's masked sum exactly). The gradients of that
objective and its value are summed over the group in one all-reduce of
one flat buffer: the global loss and its gradient, as one device would
compute them, whatever the ranks' masks and row counts. An auxiliary loss
(an MoE's load balancing, a function of the whole batch) is taken as the
mean of the ranks' own. A mesh whose other axes hold several ranks with
the same data block counts each block as often in the masses as in the
sums, so the quotient is unchanged.

Every collective runs through the group at every world size: a world of
one rank calls them too.

The net state (BatchNorm's running statistics) comes from each rank's
own rows and is averaged over the group after the step; the JAX package
takes the statistics of the global batch (not the same numbers).

:class:`ZeroOne` is ZeRO-1 (weight-update sharding): each updater-state
leaf held for this rank's shard only (``sharding.zero_shard_dim``; at
one rank every leaf that has a dimension is one whole shard, so the
path still gathers through the group), the updater run on the shards,
the updated shards all-gathered in one collective.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..nn.model import Graph
from ..ops.losses import reduction_mass
from ..ops.updaters import tree_leaves, tree_unflatten
from .mesh import DATA_AXIS
from .sharding import zero_shard_dim


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), stacked: (world, *t.shape)."""
    flat = t.contiguous().reshape(-1)
    world = dist.get_world_size(group)
    out = torch.empty(world * flat.numel(), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, flat, group=group)
    return out.view((world,) + tuple(t.shape))


def score_parts(model, params, state, x, y, *, training, rng, mask,
                label_mask):
    """``model.score_parts`` with the mask keywords of its container."""
    if isinstance(model, Graph):
        return model.score_parts(params, state, x, y, training=training,
                                 rng=rng, masks=mask, label_masks=label_mask)
    return model.score_parts(params, state, x, y, training=training,
                             rng=rng, mask=mask, label_mask=label_mask)


def masses(reductions, device) -> torch.Tensor:
    """The ``reduction_mass`` of each (labels, mask) pair, f32 on
    ``device``."""
    return torch.stack([reduction_mass(*r).to(device, torch.float32)
                        for r in reductions])


def take_rows(t, rows):
    """Rows ``rows`` (a slice or index) of a tensor, or of each tensor in
    a dict or list; None stays None."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: take_rows(v, rows) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(take_rows(v, rows) for v in t)
    return t[rows]


def n_rows(t) -> int:
    if isinstance(t, dict):
        return n_rows(next(iter(t.values())))
    if isinstance(t, (list, tuple)):
        return n_rows(t[0])
    return t.shape[0]


class DataParallel:
    """The collectives of data parallelism over ``mesh``'s group; with
    ``reduce_axes`` (tensor and sequence parallelism: every axis but
    ``model``) the loss masses, the gradients and the net state reduce
    over that sub-group only, whose ranks hold distinct rows or sequence
    blocks — the model axis's ranks hold shards of one computation."""

    def __init__(self, mesh, reduce_axes: Optional[Sequence[str]] = None):
        self.mesh = mesh
        self.device = mesh.device
        if reduce_axes is None:
            self.group, self.world = mesh.group, mesh.size
        else:
            self.group = mesh.axis_group(reduce_axes)
            self.world = dist.get_world_size(self.group)

    # --- collectives ---
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Sums over the group of ``tensors`` (f32), in one all-reduce of
        one flat buffer; returns views of it, shaped as the inputs."""
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        self.all_reduce(flat)
        out, o = [], 0
        for t in tensors:
            out.append(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()
        return out

    def mean_floats(self, tree):
        """``tree`` with its floating tensors replaced by their mean over
        the group (one all-reduce); other leaves kept."""
        leaves = tree_leaves(tree)
        idx = [i for i, t in enumerate(leaves)
               if torch.is_tensor(t) and t.is_floating_point()]
        if not idx:
            return tree
        summed = self.all_reduce_flat([leaves[i].detach() for i in idx])
        leaves = list(leaves)
        for i, s in zip(idx, summed):
            leaves[i] = (s / self.world).to(leaves[i].dtype)
        return tree_unflatten(tree, leaves)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data block's ``t`` (equal shapes), concatenated along dim
        0 in data order (one rank per block: the one at coordinate 0 of
        every other axis)."""
        out = all_gather(t, self.mesh.group)
        return torch.cat([out[r] for r in self.block_ranks()], dim=0)

    def block_ranks(self) -> List[int]:
        """The rank that speaks for each data block, in data order."""
        m = self.mesh
        if len(m.shape) == 1:
            return list(range(m.size))
        ax = m.axis_names.index(DATA_AXIS) if DATA_AXIS in m.shape else None
        sel = [slice(0, 1)] * len(m.shape)
        if ax is not None:
            sel[ax] = slice(None)
        return [int(r) for r in m.devices[tuple(sel)].reshape(-1)]

    # --- the step ---
    def loss_and_grads(self, model, params, trained, state, x, y, gen,
                       mask, label_mask):
        """The global loss (0-d), the new net state and the global
        gradient of each of ``trained`` from this rank's rows (see the
        module docstring)."""
        with torch.enable_grad():
            losses, reductions, aux, new_state = score_parts(
                model, params, state, x, y, training=True, rng=gen,
                mask=mask, label_mask=label_mask)
            w = masses(reductions, self.device)
            w_all = self.all_reduce(w.clone())
            # the ratio first: at one rank it is exactly 1, so the step is
            # Trainer's bit for bit
            obj = sum(l * (torch.clamp(wi, min=1.0)
                           / torch.clamp(wa, min=1.0))
                      for l, wi, wa in zip(losses, w, w_all))
            if aux is not None:
                obj = obj + aux / self.world
            grads = torch.autograd.grad(obj, trained, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(trained, grads)]
        *grads, loss = self.all_reduce_flat(grads + [obj.detach()])
        if tree_leaves(new_state):
            new_state = self.mean_floats(new_state)
        return loss, new_state, grads

    def accum_loss_and_grads(self, model, params, trained, state, x, y, gen,
                             mask, label_mask, n: int):
        """``grad_accum=n`` over the mesh: this rank's rows as ``n``
        strided microbatches (row i to microbatch i mod n, as the
        reference regroups the global batch), each one's masked sum and
        mass accumulated, then one all-reduce and the division by the
        group's mass. For one loss-bearing output and no auxiliary
        loss."""
        g_sum, s_sum = None, None
        w_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for j in range(n):
            part = [take_rows(t, slice(j, None, n))
                    for t in (x, y, mask, label_mask)]
            with torch.enable_grad():
                losses, reductions, _, state = score_parts(
                    model, params, state, part[0], part[1], training=True,
                    rng=gen, mask=part[2], label_mask=part[3])
                w = masses(reductions, self.device)[0]
                s = losses[0] * w
                grads = torch.autograd.grad(s, trained, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(trained, grads)]
            g_sum = grads if g_sum is None else [a + b for a, b in
                                                 zip(g_sum, grads)]
            s_sum = s.detach() if s_sum is None else s_sum + s.detach()
            w_sum = w_sum + w
        *g_sum, s_all, w_all = self.all_reduce_flat(g_sum + [s_sum, w_sum])
        w_all = torch.clamp(w_all, min=1.0)
        if tree_leaves(state):
            state = self.mean_floats(state)
        return s_all / w_all, state, [g / w_all for g in g_sum]

    def score(self, model, params, state, x, y, mask, label_mask,
              split: bool = True):
        """The inference-mode loss of one global batch: with ``split``
        every rank holds all its rows and scores its block (blocks as even
        as the rows allow; an empty block adds nothing), else each rank
        holds only its own rows. Sums and masses are summed over the
        group: equal to scoring the whole batch on one device."""
        rows = n_rows(x)
        k = self.mesh.data_size
        i = self.mesh.data_index
        lo, hi = ((i * rows // k, (i + 1) * rows // k) if split
                  else (0, rows))
        part = [take_rows(t, slice(lo, hi)) for t in (x, y, mask, label_mask)]
        with torch.no_grad():
            if hi > lo:
                losses, reductions, aux, _ = score_parts(
                    model, params, state, part[0], part[1], training=False,
                    rng=None, mask=part[2], label_mask=part[3])
                w = masses(reductions, self.device)
                sums = torch.stack([l.float() * torch.clamp(wi, min=1.0)
                                    for l, wi in zip(losses, w)])
                aux = (torch.zeros((), device=self.device) if aux is None
                       else aux.float())
            else:
                n_out = len(model.outputs) if isinstance(model, Graph) else 1
                w = torch.zeros(n_out, device=self.device)
                sums = torch.zeros(n_out, device=self.device)
                aux = torch.zeros((), device=self.device)
            has = torch.ones((), device=self.device) * (hi > lo)
            sums, w, aux, has = self.all_reduce_flat([sums, w, aux, has])
            # the aux loss: the mean over the ranks that scored rows
            loss = (sums / torch.clamp(w, min=1.0)).sum() \
                + aux / torch.clamp(has, min=1.0)
        return loss

    def infer(self, model, params, state, x, mask=None) -> torch.Tensor:
        """The primary output for a global batch whose rows every rank
        holds: rows padded to a multiple of the data axis by cycling, this
        rank's block forwarded, the blocks all-gathered, the padding cut."""
        from ..train.trainer import _inference

        rows = n_rows(x)
        k = self.mesh.data_size
        pad = (-rows) % k
        if pad:
            idx = torch.cat([torch.arange(rows), torch.arange(pad) % rows])
            x, mask = take_rows(x, idx), take_rows(mask, idx)
        sl = self.mesh.rows(rows + pad)
        preds = _inference(model, params, state, take_rows(x, sl),
                           take_rows(mask, sl))
        return self.all_gather_rows(preds)[:rows]


def zero_layout(shape, n: int) -> Optional[int]:
    """The dimension a leaf shards over in :class:`ZeroOne`:
    ``zero_shard_dim`` over ``n`` data ranks; at one rank the largest
    dimension (one whole shard), so every leaf with a dimension still
    travels the gather."""
    if n > 1:
        return zero_shard_dim(shape, n)
    if not len(shape):
        return None
    return max(range(len(shape)), key=lambda d: shape[d])


class ZeroOne:
    """ZeRO-1 over ``dp``'s data axis for ``tx`` and the params
    ``leaves``: ``init`` the sharded updater state, ``updates`` the full
    updates from full gradients (None where the updater gives None). A
    leaf marked in ``whole`` (one the rules shard over ``model``) keeps
    its updater state whole."""

    def __init__(self, dp: DataParallel, tx, leaves, whole=None):
        self.dp, self.tx = dp, tx
        self.n = dp.mesh.data_size
        self.r = dp.mesh.data_index
        whole = whole or [False] * len(leaves)
        self.dims = [None if w else zero_layout(tuple(p.shape), self.n)
                     for p, w in zip(leaves, whole)]

    def shards(self, tensors):
        out = []
        for t, d in zip(tensors, self.dims):
            if t is None or d is None:
                out.append(t)
            else:
                s = t.shape[d] // self.n
                out.append(t.narrow(d, self.r * s, s))
        return out

    def init(self, leaves):
        return self.tx.init(self.shards(leaves))

    @torch.no_grad()
    def updates(self, grads, opt_state, leaves):
        upd, opt_state = self.tx.update(self.shards(grads), opt_state,
                                        self.shards(leaves))
        upd = list(upd)
        sharded = [i for i, (u, d) in enumerate(zip(upd, self.dims))
                   if u is not None and d is not None]
        if sharded:
            mine = torch.cat([upd[i].reshape(-1) for i in sharded])
            blocks = self.dp.all_gather_rows(mine[None])  # (n, numel)
            o = 0
            for i in sharded:
                numel = upd[i].numel()
                pieces = [blocks[q, o:o + numel].view(upd[i].shape)
                          for q in range(self.n)]
                upd[i] = torch.cat(pieces, dim=self.dims[i])
                o += numel
        return upd, opt_state
