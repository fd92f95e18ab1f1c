"""Pipeline parallelism — counterpart of
``deeplearning4j_tpu/parallel/pipeline.py``: the GPipe microbatch schedule
over a ``pipe`` mesh axis.

The pipelined body is a stack of uniform stages, each mapping a
``(mb, ...)`` activation to one of the same shape (transformer blocks are
the canonical case); embedding and head layers run outside it. Each rank
runs one stage: rank ``s`` of the pipe group takes stage ``s`` of the
stacked params. Microbatches stream through ``M + S - 1`` ticks; at each
tick every stage runs on what it holds and hands its output to the next
stage (``collectives.ppermute``, one ``batch_isend_irecv``); stage 0 takes
microbatch ``t`` and the last stage's outputs from tick ``S - 1`` on are
the results. A stage in a bubble (no microbatch in it yet, or none left)
sends a zero buffer and launches nothing. The last stage's results are
summed over the pipe group (only it holds non-zero ones), so every rank
returns them, as the reference's ``psum`` does.

Differentiable: one ``torch.autograd.Function`` runs the schedule, and its
backward runs it in reverse, tick by tick — the output gradient
(the same on every rank: every rank holds the same loss) enters at the
last stage, each stage runs its stage again with autograd on the input it
kept (GPipe's re-materialization) and hands its input's gradient to the
stage before it — then sums every stage's param gradient and stage 0's
microbatch gradient over the group in one all-reduce. Each rank ends with
the whole gradient of ``stacked_params`` and of ``microbatches``, as of a
global array. The collectives are explicit, not left to autograd's order,
so every rank runs them in the same order.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.updaters import tree_leaves, tree_unflatten
from .mesh import PIPE_AXIS


def stack_stage_params(params_list: Sequence):
    """Stack S identically shaped per-stage param trees along a new
    leading stage axis (the axis :func:`pipeline_apply` splits)."""
    first = params_list[0]
    leaves = [tree_leaves(p) for p in params_list]
    return tree_unflatten(first, [torch.stack(ts) for ts in zip(*leaves)])


class _Pipeline(torch.autograd.Function):
    """The schedule, forward and backward written out (see the module
    docstring): autograd never orders the hops, so every rank runs the
    same collectives in the same order."""

    @staticmethod
    def forward(ctx, stage_fn, template, s, S, group, mbs, *stacked):
        from .collectives import all_reduce, ppermute_raw, stage_perm

        me = [t[s] for t in stacked]
        M = mbs.shape[0]
        inputs = {}
        outs = torch.zeros_like(mbs)
        buf = torch.zeros_like(mbs[0])
        with torch.no_grad():
            for t in range(M + S - 1):
                y = torch.zeros_like(buf)
                if s <= t < s + M:  # microbatch t - s is at this stage
                    inputs[t] = mbs[t] if s == 0 else buf
                    y = stage_fn(tree_unflatten(template, me), inputs[t])
                    if s == S - 1:
                        outs[t - s] = y
                if S > 1:
                    buf = ppermute_raw([y], group, stage_perm(S))[0]
            total = all_reduce(outs, group)
        ctx.args = (stage_fn, template, s, S, group, M, inputs)
        ctx.save_for_backward(mbs, *stacked)
        return total

    @staticmethod
    def backward(ctx, d_total):
        from .collectives import all_reduce, ppermute_raw

        stage_fn, template, s, S, group, M, inputs = ctx.args
        mbs, *stacked = ctx.saved_tensors
        inverse = tuple((j, j - 1) for j in range(1, S))
        g_params = [torch.zeros(t.shape[1:], dtype=torch.float32,
                                device=t.device) for t in stacked]
        d_mbs = torch.zeros(mbs.shape, dtype=torch.float32, device=mbs.device)
        g_send = torch.zeros_like(mbs[0])
        for t in reversed(range(M + S - 1)):
            # the gradient of this tick's output comes back from the next
            # stage (the last stage takes it from the summed results)
            g_y = (ppermute_raw([g_send], group, inverse)[0] if S > 1
                   else torch.zeros_like(g_send))
            g_send = torch.zeros_like(mbs[0])
            if not s <= t < s + M:
                continue
            if s == S - 1:
                g_y = d_total[t - s]
            with torch.enable_grad():
                x_in = inputs[t].detach().requires_grad_()
                p = [a[s].detach().requires_grad_(a.is_floating_point())
                     for a in stacked]
                y = stage_fn(tree_unflatten(template, p), x_in)
                wrt = [x_in] + [q for q in p if q.requires_grad]
                grads = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
            g_x, rest = grads[0], iter(grads[1:])
            for i, q in enumerate(p):
                g = next(rest) if q.requires_grad else None
                if g is not None:
                    g_params[i] += g.float()
            if g_x is not None:
                if s == 0:
                    d_mbs[t] += g_x.float()
                else:
                    g_send = g_x.to(g_send.dtype)
        # each stage's gradient and the microbatches' (stage 0's) summed
        # over the group in one all-reduce
        full = []
        for a, g in zip(stacked, g_params):
            z = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            z[s] = g
            full.append(z)
        flat = all_reduce(torch.cat([z.reshape(-1) for z in full]
                                    + [d_mbs.reshape(-1)]), group)
        out, o = [], 0
        for a in list(stacked) + [mbs]:
            out.append(flat[o:o + a.numel()].view(a.shape).to(a.dtype))
            o += a.numel()
        d_stacked, d_mb = out[:-1], out[-1]
        return (None, None, None, None, None, d_mb) + tuple(d_stacked)


def pipeline_apply(stage_fn: Callable, stacked_params, microbatches, mesh, *,
                   axis_name: str = PIPE_AXIS):
    """Run ``microbatches`` (M, mb, ...) through S pipelined stages, S the
    size of ``axis_name`` in ``mesh``. ``stage_fn(stage_params, x) -> y``
    with ``y.shape == x.shape``, deterministic (the backward runs each
    stage again, GPipe's re-materialization); ``stacked_params`` has a
    leading S axis on every leaf (every rank holds the whole stack).
    Returns the last stage's outputs (M, mb, ...) on every rank;
    differentiable in ``microbatches`` and ``stacked_params``."""
    S = mesh.shape[axis_name]
    leaves = tree_leaves(stacked_params)
    for leaf in leaves:
        if leaf.shape[0] != S:
            raise ValueError(
                f"stacked_params leading axis {leaf.shape[0]} != pipe axis "
                f"size {S}: one stage per rank (a larger multiple would "
                f"silently drop stages)")
    return _Pipeline.apply(stage_fn, stacked_params, mesh.index(axis_name), S,
                           mesh.axis_group(axis_name), microbatches, *leaves)


def to_microbatches(x, num_microbatches: int):
    """(B, ...) -> (M, B/M, ...)."""
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} does not divide into "
                         f"{num_microbatches} microbatches")
    return x.reshape((num_microbatches, B // num_microbatches)
                     + tuple(x.shape[1:]))


def from_microbatches(x):
    """(M, mb, ...) -> (M * mb, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))
