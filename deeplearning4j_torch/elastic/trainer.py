"""ElasticTrainer — counterpart of ``deeplearning4j_tpu/elastic/trainer.py``:
fault-tolerant data-parallel training on the serving control plane.

One :class:`ElasticTrainer` owns a ladder of data-parallel widths
(``dp_min .. dp_max``) and, per step:

1. supervises one virtual worker per replica through
   :class:`~..cluster.membership.Membership` on a **logical clock** (one
   tick per step); a chaos-killed worker (the ``elastic.step`` seam)
   stops beating, is swept ``alive -> suspect -> dead``, reaped, and the
   ladder steps down;
2. runs one ZeRO-1 step (arXiv 2004.13336) at the current width;
3. feeds the wall (or injected) step time into a
   :class:`~..autoscale.signals.StepTimeSignalReader` and asks the stock
   :class:`~..autoscale.policy.AutoscalePolicy` whether to grow or
   shrink.

**One controller, virtual replicas.** As in the reference, one process
drives replicas ``devices[:d]``; here the replicas of a ladder share one
device (``[cuda:0] * 4`` on one card, ``[cpu] * 4`` in the tests): NCCL
puts no two ranks of a group on one card, so a ladder on one card exists
only as replicas of one process. Replica ``r`` runs the forward and
backward of its contiguous block of the global rows (``Mesh.rows``'s
convention); each block's loss weighs in by its share of the batch's
loss mass (``parallel/dp.py``), and the gradients are summed in replica
order: the global batch's loss and gradient, as the reference's one
device program computes them. Batches are ``(x, y)`` with no masks, as
the reference's ``fit`` takes them, so the masses come from the labels.

**ZeRO-1.** Each width has its own updater buffers: replica ``r`` holds
block ``r`` of every leaf that :func:`~..parallel.sharding.zero_shard_dim`
splits at that width, and runs the updater on its blocks of the
gradients and params; its updates land in its block of the params, which
every replica reads (one card holds one copy: the all-gather is the
params themselves). A leaf no dimension of which divides by the width is
held once and updated by replica 0 (every replica on one card would hold
the same bytes); a scalar leaf (adam's count) is read by every replica
and written from replica 0's result. The net state (BatchNorm's
statistics) is the mean of the replicas'.

**Warming.** On the card, :meth:`warm` captures one CUDA graph of the
step per ladder width, each after a warm-up of its gradient pass, each
in its own memory pool; a step copies the batch into the graphs'
input buffers and replays the width's graph. A graph reads fixed
addresses, so a resize copies the optimizer blocks into the new width's
buffers and never rebinds a tensor a graph reads.
``elastic_pstep_traces_total{dp}`` counts the captures after
:meth:`warm` (a batch of a new shape). A capture that fails raises. On
the CPU the same step runs eagerly.

**Resize**, in the reference's order: checkpoint at the old layout, the
``elastic.resize`` seam, :func:`~.reshard.plan_reshard`, the copy of the
optimizer blocks into the new width's buffers (the non-resident bytes,
``plan.bytes_moved``, counted on ``elastic_reshard_bytes_total``), a
checkpoint at the new layout. A death mid-step, mid-resize or
mid-checkpoint resumes (:meth:`resume`) from the last published triple,
bit-identical to the uninterrupted run.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..autoscale.policy import IN, OUT, AutoscalePolicy
from ..autoscale.signals import StepTimeSignalReader
from ..chaos import faults
from ..cluster.membership import DEAD, Membership
from ..obs import flight as _flight
from ..ops.losses import reduction_mass
from ..ops.updaters import tree_leaves, tree_unflatten
from ..parallel.dp import n_rows, score_parts, take_rows
from ..parallel.mesh import DATA_AXIS
from ..parallel.sharding import zero_shard_dim
from ..train.staging import BatchStager
from ..train.trainer import _batch_sig, build_updater, frozen_leaves
from .checkpoint import CheckpointInfo, latest, save_atomic
from .reshard import (ReshardPlan, block, box_index, intersect,
                      plan_reshard)


class ElasticError(RuntimeError):
    """Base class for typed elastic-training failures."""


class QuorumLostError(ElasticError):
    """Fewer live workers remain than ``dp_min``: training cannot go on at
    any ladder width; resume once capacity returns."""


class NoCheckpointError(ElasticError):
    """``resume()`` found no published checkpoint pointer in the
    workdir."""


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _slice(t, dim: Optional[int], d: int, r: int):
    """Replica ``r``'s block of ``t`` at width ``d`` along ``dim``; for a
    leaf held whole, the leaf at replica 0 (and a 0-d leaf at every
    replica), an empty view elsewhere."""
    if t is None:
        return None
    if dim is not None:
        s = t.shape[dim] // d
        return t.narrow(dim, r * s, s)
    if t.dim() == 0 or r == 0:
        return t
    return t.narrow(0, 0, 0)


class ElasticTrainer:
    """Membership-supervised elastic data-parallel trainer.

    ``dp`` is the starting width, ``dp_min``/``dp_max`` bound the ladder.
    ``devices`` (default: the visible CUDA cards) hold the replicas, one a
    replica; the ladder's must be one device, the model's. The global
    batch must divide by every ladder width. ``store`` is taken for the
    reference's signature: a CUDA graph cannot be written to disk, so
    nothing is stored. Control flow runs on the logical clock (1.0 a
    step); wall time is only measured."""

    def __init__(self, model, *, workdir: str, dp: int = 4, dp_min: int = 2,
                 dp_max: Optional[int] = None, seed: int = 0,
                 store=None, metrics=None, devices=None,
                 suspect_after_steps: float = 1.5,
                 dead_after_steps: float = 2.5,
                 step_time_budget_s: Optional[float] = None,
                 policy: Optional[AutoscalePolicy] = None):
        dp, dp_min = int(dp), int(dp_min)
        dp_max = int(dp_max) if dp_max is not None else dp
        if not 1 <= dp_min <= dp <= dp_max:
            raise ValueError("need 1 <= dp_min <= dp <= dp_max")
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [_device(d) for d in devices]
        if dp_max > len(devices):
            raise ValueError(f"dp_max={dp_max} exceeds {len(devices)} devices")
        if len(set(devices[:dp_max])) > 1:
            raise NotImplementedError(
                "the ladder's replicas run in one process on one device; a "
                "ladder over several cards is not ported: pass "
                "devices=[device] * dp_max")
        self.device = devices[0]
        if model.params is None:
            model.init()
        if _device(model.device) != self.device:
            raise ValueError(f"the model is on {model.device}, the replicas "
                             f"on {self.device}")
        if model.config.gradient_normalization:
            raise ValueError("ZeRO-1 runs the updater on blocks of each "
                             "leaf; gradient normalization needs whole leaves")
        self.model = model
        self.tx = build_updater(model)
        self.store = store
        self.workdir = os.path.abspath(workdir)
        self.dp, self.dp_min, self.dp_max = dp, dp_min, dp_max
        self.iteration = 0
        self._tick = 0.0          # the logical clock: 1.0 per step
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._devices = devices
        self._ladder = tuple(range(dp_min, dp_max + 1))
        self._metrics = metrics
        self._init_metrics(metrics)

        # the params every replica reads (leaf tensors updated in place)
        frozen = frozen_leaves(model)
        self.params = tree_unflatten(model.params, [
            p.detach().requires_grad_(p.is_floating_point() and not f)
            for p, f in zip(tree_leaves(model.params), frozen)])
        self.state = model.state if model.state is not None else {}
        leaves = tree_leaves(self.params)
        self._grads = [torch.zeros_like(p) for p in leaves
                       if p.requires_grad]
        grads = iter(self._grads)
        # per leaf: its summed gradient, zeros for an untrained leaf, None
        # for a frozen one (the noop updater gives it no update)
        self._full_grads = [None if f else (next(grads) if p.requires_grad
                                            else torch.zeros_like(p))
                            for p, f in zip(leaves, frozen)]
        self._loss = torch.zeros((), dtype=torch.float32, device=self.device)
        # the updater state's structure and whole shapes, on the meta device
        self._opt_meta = self.tx.init([p.detach().to("meta") for p in leaves])
        opt0 = tree_leaves(self.tx.init([p.detach() for p in leaves]))
        self._dims = {d: [zero_shard_dim(tuple(t.shape), d) for t in opt0]
                      for d in self._ladder}
        # each width's buffers: per leaf, one block a replica (or one whole)
        self._opt = {d: self._alloc(d, opt0 if d == dp else None)
                     for d in self._ladder}
        del opt0

        self._stage = BatchStager(self.device)
        self._slots: Dict[tuple, tuple] = {}
        self._graphs: Dict[tuple, object] = {}
        self._graph_stream = None
        self.captures = {}       # width -> {"seconds", "pool_bytes"} at warm
        self._trace_counts = {d: 0 for d in self._ladder}
        self._warmed = False

        # one virtual worker per replica, supervised on the logical clock
        self.membership = Membership(
            suspect_after_s=float(suspect_after_steps),
            dead_after_s=float(dead_after_steps),
            clock=lambda: self._tick, metrics=metrics)
        self._workers: List[str] = []
        self._crashed: set = set()
        self._next_worker = 0
        for _ in range(dp):
            self._spawn_worker()

        # step-time burn -> the stock AutoscalePolicy: burn 1.0 means each
        # step spends exactly its budget
        self.budget_s = (float(step_time_budget_s)
                         if step_time_budget_s is not None else None)
        self.signals = (StepTimeSignalReader(
            budget_s=self.budget_s, clock=lambda: self._tick)
            if self.budget_s is not None else None)
        self.policy = policy if policy is not None else (AutoscalePolicy(
            min_replicas=dp_min, max_replicas=dp_max,
            burn_out={"train": 1.0}, queue_high=1e9, queue_low=1e9,
            sustain_out_s=2.0, sustain_in_s=6.0,
            cooldown_out_s=4.0, cooldown_in_s=4.0)
            if self.budget_s is not None else None)

        self.last_loss = None            # device scalar (no per-step sync)
        self.last_resize: Optional[dict] = None
        self.resizes: List[dict] = []

    # ------------------------------------------------------------- metrics
    def _init_metrics(self, metrics) -> None:
        if metrics is None:
            from ..obs.metrics import MetricsRegistry

            metrics = MetricsRegistry(enabled=False)
        self._m_resizes = lambda cause: metrics.counter(
            "elastic_resizes_total", {"cause": cause},
            help="mesh resizes by trigger cause")
        self._m_step = metrics.histogram(
            "elastic_step_seconds", {},
            help="elastic step wall time (dispatch)")
        self._m_reshard = metrics.counter(
            "elastic_reshard_bytes_total", {},
            help="optimizer-state bytes moved by resize redistribution")
        self._m_ckpt = metrics.histogram(
            "elastic_checkpoint_seconds", {},
            help="atomic checkpoint publish wall time")
        self._m_resize_s = metrics.histogram(
            "elastic_resize_seconds", {},
            help="full resize wall time (checkpoints + reshard)")
        self._m_dp = metrics.gauge(
            "elastic_dp", {}, help="current data-parallel mesh width")
        self._m_dp.set(self.dp)
        self._m_traces = lambda d: metrics.counter(
            "elastic_pstep_traces_total", {"dp": str(d)},
            help="step captures after warm() by mesh width")

    # ------------------------------------------------------ updater state
    def _alloc(self, d: int, whole=None) -> List[List[torch.Tensor]]:
        """Width ``d``'s updater buffers (filled from the ``whole`` leaves
        when given, else zeros)."""
        out = []
        for j, meta in enumerate(tree_leaves(self._opt_meta)):
            dim = self._dims[d][j]
            n = d if dim is not None else 1
            bufs = []
            for r in range(n):
                src = None if whole is None else _slice(whole[j], dim, d, r)
                shape = (meta.shape if dim is None
                         else _slice(meta, dim, d, r).shape)
                t = torch.empty(shape, dtype=meta.dtype, device=self.device)
                bufs.append(t.copy_(src) if src is not None else t.zero_())
            out.append(bufs)
        return out

    def _replica_state(self, d: int, r: int):
        """Replica ``r``'s updater tree at width ``d``."""
        return tree_unflatten(self._opt_meta, [
            b[r] if dim is not None else _slice(b[0], None, d, r)
            for b, dim in zip(self._opt[d], self._dims[d])])

    @property
    def opt_state(self):
        """The updater state with every leaf whole (the replicas' blocks
        concatenated: a copy)."""
        d = self.dp
        return tree_unflatten(self._opt_meta, [
            b[0] if dim is None else torch.cat(b, dim)
            for b, dim in zip(self._opt[d], self._dims[d])])

    def checkpoint_pieces(self):
        """``train.orbax_io``'s blocks of this trainer: params, net state
        and the generator from replica 0, each updater block from the
        replica that holds it (a whole leaf from replica 0)."""
        from ..elastic.reshard import tree_paths
        from ..train.orbax_io import split, whole

        out = [whole(f"params/{p}", t, "replica0")
               for p, t in tree_paths(self.params)]
        out += [whole(f"net_state/{p}", t, "replica0")
                for p, t in tree_paths(self.state)]
        d = self.dp
        for (path, _), bufs, dim in zip(tree_paths(self._opt_meta),
                                        self._opt[d], self._dims[d]):
            for r, b in enumerate(bufs):
                out.append(split(f"opt_state/{path}", b, dim, r, d,
                                 f"replica{r}"))
        out.append(whole("extras/generator", self._gen.get_state(),
                         "replica0"))
        return out

    # ---------------------------------------------------------------- step
    def _step(self, d: int, x, y, update: bool = True) -> None:
        """One ZeRO-1 step at width ``d`` (see the module docstring):
        every replica's gradient summed into the gradient buffers, then
        (``update``) the net state, each replica's updater and the loss,
        all written in place. Without ``update`` it writes the gradient
        buffers alone: the warm-up before a capture."""
        leaves = tree_leaves(self.params)
        trained = [p for p in leaves if p.requires_grad]
        b = n_rows(x) // d
        rows = [slice(r * b, (r + 1) * b) for r in range(d)]
        ys = [take_rows(y, sl) for sl in rows]
        outs = ys[0] if isinstance(ys[0], list) else None
        # the loss mass of each output over the global batch (no masks)
        total = [sum(reduction_mass(yr[o] if outs is not None else yr)
                     for yr in ys)
                 for o in range(len(outs) if outs is not None else 1)]
        torch._foreach_zero_(self._grads)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        states = []
        for r in range(d):
            with torch.enable_grad():
                losses, reductions, aux, new_state = score_parts(
                    self.model, self.params, self.state,
                    take_rows(x, rows[r]), ys[r], training=True,
                    rng=self._gen, mask=None, label_mask=None)
                obj = sum(l * (torch.clamp(reduction_mass(*red), min=1.0)
                               / torch.clamp(w, min=1.0))
                          for l, red, w in zip(losses, reductions, total))
                if aux is not None:
                    obj = obj + aux / d
                g = torch.autograd.grad(obj, trained, allow_unused=True)
            pairs = [(a, gi) for a, gi in zip(self._grads, g)
                     if gi is not None]
            if pairs:
                torch._foreach_add_([a for a, _ in pairs],
                                    [gi for _, gi in pairs])
            loss += obj.detach()
            states.append(new_state)
        if update:
            self._merge_state(states)
            self._update(d, leaves)
            self._loss.copy_(loss)

    @torch.no_grad()
    def _update(self, d, leaves) -> None:
        """Each replica's updater on its blocks; its updates into its block
        of the params, its new state into its buffers (scalars after every
        replica has read them)."""
        full = self._full_grads
        scalars = None
        for r in range(d):
            st = self._replica_state(d, r)
            upd, new = self.tx.update([_slice(g, zero_shard_dim(
                tuple(g.shape), d) if g is not None else None, d, r)
                for g in full], st, [
                _slice(p, zero_shard_dim(tuple(p.shape), d), d, r)
                for p in leaves])
            old, new = tree_leaves(st), tree_leaves(new)
            if r == 0:
                scalars = [(o, n) for o, n in zip(old, new) if o.dim() == 0]
            for o, n in zip(old, new):
                if o.dim() and o.numel() and o is not n:
                    o.copy_(n)
            pairs = [(_slice(p, zero_shard_dim(tuple(p.shape), d), d, r), u)
                     for p, u in zip(leaves, upd)
                     if u is not None and u.numel() and (u.dim() or r == 0)]
            if pairs:
                torch._foreach_add_([p for p, _ in pairs],
                                    [u for _, u in pairs])
        for o, n in scalars:
            if o is not n:
                o.copy_(n)

    @torch.no_grad()
    def _merge_state(self, states) -> None:
        """The replicas' new net state into the trainer's in place: the
        mean of the floating leaves, replica 0's others."""
        dst = tree_leaves(self.state)
        got = [tree_leaves(s) for s in states]
        if any(len(g) != len(dst) for g in got):
            raise RuntimeError("the net state changed its structure in a "
                               "step; the elastic trainer holds it fixed")
        for i, t in enumerate(dst):
            if t.is_floating_point():
                t.copy_(sum(g[i].float() for g in got) / len(got))
            else:
                t.copy_(got[0][i])

    # ------------------------------------------------------ graphs (card)
    def _fill_slots(self, x, y):
        """The batch copied into its signature's input buffers (made on
        first use); returns the signature."""
        sig = (_batch_sig(x), _batch_sig(y))
        if sig not in self._slots:
            self._slots[sig] = (torch.empty_like(x), torch.empty_like(y))
        xs, ys = self._slots[sig]
        xs.copy_(x)
        ys.copy_(y)
        return sig

    def _capture(self, d: int, sig) -> object:
        """Width ``d``'s step as one CUDA graph over the signature's input
        buffers, after a warm-up of its gradient pass on the graph stream
        (it writes the gradient buffers alone; the generator is put back),
        so what a library or kernel wrapper makes lazily for the stream is
        made outside the capture. Raises if the capture fails."""
        xs, ys = self._slots[sig]
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        gs = self._graph_stream
        user = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        gen_state = self._gen.get_state()
        gs.wait_stream(user)
        with torch.cuda.stream(gs):
            self._step(d, xs, ys, update=False)
        self._gen.set_state(gen_state)
        gs.synchronize()
        # torch.cuda.graph empties the cache first: measure from there
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph, stream=gs):
            self._step(d, xs, ys)
        user.wait_stream(gs)
        torch.cuda.synchronize(self.device)
        self.captures[d] = {
            "seconds": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - before}
        return graph

    def _run(self, x, y) -> None:
        """One step at the current width: a replay on the card (captured
        first, and counted, if this width has no graph for the batch's
        signature), the eager step on the CPU."""
        d = self.dp
        if self.device.type != "cuda":
            self._step(d, x, y)
            return
        sig = self._fill_slots(x, y)
        graph = self._graphs.get((d, sig))
        if graph is None:
            graph = self._graphs[(d, sig)] = self._capture(d, sig)
            if self._warmed:
                self._trace_counts[d] += 1
                self._m_traces(d).inc()
        user = torch.cuda.current_stream(self.device)
        gs = self._graph_stream
        gs.wait_stream(user)
        with torch.cuda.stream(gs):
            graph.replay()
        user.wait_stream(gs)

    def trace_count(self) -> int:
        """Step captures after :meth:`warm`, over the ladder (0 when every
        width was warmed for the batches fit saw)."""
        return sum(self._trace_counts.values())

    # ------------------------------------------------------------- workers
    def _spawn_worker(self) -> str:
        wid = f"w{self._next_worker}"
        self._next_worker += 1
        self.membership.add(wid, f"elastic://{wid}")
        self._workers.append(wid)
        return wid

    def _retire_worker(self) -> str:
        wid = self._workers.pop()
        self.membership.remove(wid)
        self._crashed.discard(wid)
        return wid

    def _supervise(self) -> None:
        """One supervision round: the per-worker ``elastic.step`` seam (an
        injected error: that worker crashed and stops beating), the
        survivors' leases renewed, a sweep, the dead reaped, which
        resizes the ladder."""
        fp = faults.ACTIVE
        for wid in list(self._workers):
            if wid in self._crashed:
                continue
            if fp is not None:
                try:
                    fp.hit("elastic.step", scope=wid)
                except (RuntimeError, OSError):
                    # the worker "process" died; its lease now ages out
                    self._crashed.add(wid)
                    continue
            self.membership.report(wid, {"queue_depth": 0,
                                         "kv_utilization": 0.0,
                                         "step": self.iteration})
        states = self.membership.sweep()
        dead = sorted(w for w, s in states.items() if s == DEAD)
        if not dead:
            return
        for wid in dead:
            self.membership.remove(wid)
            self._workers.remove(wid)
            self._crashed.discard(wid)
        alive = len(self._workers)
        if alive < self.dp_min:
            raise QuorumLostError(
                f"{alive} workers remain, dp_min={self.dp_min}; resume "
                f"from {self.workdir} once capacity returns")
        self._resize(min(alive, self.dp_max), cause="worker_death")

    def _autoscale(self) -> None:
        """The stock policy over the step-time burn window: OUT spawns
        workers and climbs the ladder, IN retires them and steps down;
        the cooldown arms (``commit``) after the resize."""
        decision = self.policy.decide(self.signals, current=self.dp,
                                      now=self._tick)
        if decision.direction == OUT:
            target = min(self.dp + decision.amount, self.dp_max)
            if target <= self.dp:
                return
            for _ in range(target - self.dp):
                self._spawn_worker()
            self._resize(target, cause="autoscale")
            self.policy.commit(decision, self._tick)
        elif decision.direction == IN:
            target = max(self.dp - decision.amount, self.dp_min)
            if target >= self.dp:
                return
            for _ in range(self.dp - target):
                self._retire_worker()
            self._resize(target, cause="autoscale")
            self.policy.commit(decision, self._tick)

    # -------------------------------------------------------------- resize
    def _checkpoint(self, cause: str) -> CheckpointInfo:
        t0 = time.perf_counter()
        info = save_atomic(self.workdir, self, step=self.iteration,
                           dp=self.dp, mesh_shape=((DATA_AXIS, self.dp),),
                           cause=cause)
        self._m_ckpt.observe(time.perf_counter() - t0)
        return info

    @torch.no_grad()
    def _move(self, d_old: int, d_new: int) -> None:
        """Copy the updater state from width ``d_old``'s buffers into
        ``d_new``'s: each new block from the old blocks it overlaps."""
        for j, meta in enumerate(tree_leaves(self._opt_meta)):
            shape = tuple(meta.shape)
            old_dim, new_dim = self._dims[d_old][j], self._dims[d_new][j]
            old = self._opt[d_old][j]
            for r, dst in enumerate(self._opt[d_new][j]):
                need = block(shape, new_dim, d_new, r)
                for q, src in enumerate(old):
                    have = block(shape, old_dim, d_old, q)
                    inter = intersect(need, have)
                    if inter is not None:
                        dst[box_index(inter, need)].copy_(
                            src[box_index(inter, have)])

    def _resize(self, dp_new: int, cause: str) -> ReshardPlan:
        """Checkpoint at the OLD layout -> the ``elastic.resize`` seam (a
        death here resumes from that checkpoint) -> plan and copy the
        redistribution -> checkpoint at the NEW layout."""
        dp_old = self.dp
        t0 = time.perf_counter()
        self._m_resizes(cause).inc()
        self._checkpoint(cause=f"pre_resize_{cause}")
        fp = faults.ACTIVE
        if fp is not None:
            # a chaos error here is the coordinator dying mid-resize: it
            # propagates typed, and the checkpoint just published is the
            # consistent resume point
            fp.hit("elastic.resize", scope=cause)
        plan = plan_reshard(self._opt_meta, dp_old, dp_new)
        self._move(dp_old, dp_new)
        self._m_reshard.inc(plan.bytes_moved)
        self.dp = dp_new
        self._m_dp.set(dp_new)
        self._checkpoint(cause=f"post_resize_{cause}")
        dt = time.perf_counter() - t0
        self._m_resize_s.observe(dt)
        self.last_resize = {"step": self.iteration, "from": dp_old,
                            "to": dp_new, "cause": cause,
                            "seconds": dt, **plan.summary()}
        self.resizes.append(self.last_resize)
        if _flight.ACTIVE is not None:
            _flight.ACTIVE.record_event("elastic", "resize", cause,
                                        dp_from=dp_old, dp_to=dp_new,
                                        bytes_moved=plan.bytes_moved)
        return plan

    # ---------------------------------------------------------------- warm
    def warm(self, x, y) -> None:
        """Capture every ladder width's step for this batch's signature
        (the card; a no-op on the CPU). After this, a resize replays a
        graph that exists: a capture at resize time means a batch of a
        new shape."""
        if self.device.type == "cuda":
            sig = self._fill_slots(self._stage(x), self._stage(y))
            for d in self._ladder:
                if (d, sig) not in self._graphs:
                    self._graphs[(d, sig)] = self._capture(d, sig)
        self._warmed = True

    # ----------------------------------------------------------------- fit
    def fit(self, batch_fn: Callable[[int], tuple], steps: int, *,
            step_time_fn: Optional[Callable[[int], float]] = None
            ) -> "ElasticTrainer":
        """Train until ``self.iteration == steps``. ``batch_fn(step)``
        must be a pure function of the step index returning host
        ``(x, y)`` whose global batch divides by every ladder width: the
        purity makes a killed-and-resumed run replay the bytes of an
        uninterrupted one. ``step_time_fn(step)`` overrides the step time
        (seconds) fed to the autoscale window: the deterministic handle
        drills stage a step-time regression with."""
        x0, y0 = batch_fn(self.iteration)
        b = int(np.shape(x0)[0])
        for d in self._ladder:
            if b % d != 0:
                raise ValueError(
                    f"global batch {b} must divide by every ladder width "
                    f"{self._ladder} (got remainder at dp={d})")
        if not self._warmed:
            self.warm(x0, y0)
        while self.iteration < int(steps):
            self._supervise()
            x, y = batch_fn(self.iteration)
            x, y = self._stage(x), self._stage(y)
            t0 = time.perf_counter()
            self._run(x, y)
            self.last_loss = self._loss.clone()
            dt = time.perf_counter() - t0
            self._m_step.observe(dt)
            self.iteration += 1
            self._tick += 1.0
            if self.signals is not None:
                observed = (float(step_time_fn(self.iteration - 1))
                            if step_time_fn is not None else dt)
                self.signals.observe(observed, alive=self.dp)
                self._autoscale()
        self.model.params, self.model.state = self.params, self.state
        return self

    def final_loss(self) -> float:
        """The last step's loss as a host float (the one host sync of the
        training loop, after fit returns)."""
        if self.last_loss is None:
            raise ElasticError("no step has run yet")
        return float(self.last_loss)

    # -------------------------------------------------------------- resume
    def checkpoint_now(self, cause: str = "manual") -> CheckpointInfo:
        """Publish an atomic checkpoint outside a resize boundary."""
        return self._checkpoint(cause=cause)

    @classmethod
    def resume(cls, workdir: str, *, dp: Optional[int] = None, model=None,
               **kwargs) -> "ElasticTrainer":
        """A trainer rebuilt from the workdir's last published triple.
        ``dp`` may differ from the checkpoint's width: the restore places
        every block onto the new width's buffers (a ``resume`` entry in
        the resize log records the plan). The model comes from the
        checkpoint's JSON on ``devices[0]`` (the card) unless given."""
        from ..train import orbax_io

        info = latest(workdir)
        if info is None:
            raise NoCheckpointError(f"no checkpoint pointer in {workdir}")
        if model is None:
            devices = kwargs.get("devices")
            model = orbax_io.load_model_json(
                info.path, device=devices[0] if devices else None)
        dp_new = int(dp) if dp is not None else info.dp
        t = cls(model, workdir=workdir, dp=dp_new, **kwargs)
        orbax_io.restore_trainer(info.path, t)
        t._tick = float(t.iteration)
        if dp_new != info.dp:
            plan = plan_reshard(t._opt_meta, info.dp, dp_new)
            t._m_reshard.inc(plan.bytes_moved)
            t.last_resize = {"step": t.iteration, "from": info.dp,
                             "to": dp_new, "cause": "resume",
                             **plan.summary()}
            t.resizes.append(t.last_resize)
        t._m_dp.set(t.dp)
        return t
