"""Data-parallel training — counterpart of
``deeplearning4j_tpu/parallel/wrapper.py`` (ParallelWrapper's four
training modes) over a process group.

Every rank builds the wrapper on its copy of the model and feeds the same
global batches to ``fit``; rank ``r`` trains on its contiguous block of
each batch's rows, as device ``r`` of the reference's mesh does. A batch
that does not divide over the ranks is padded by cycling its rows first,
as the reference pads it. Rank 0's params and net state are broadcast to
the others at construction.

- ``shared_gradients``: one global step per batch; the loss and the
  gradients reduced over the group by loss mass (``parallel.dp``), so the
  step is the global batch's step (the reference's GSPMD all-reduce).
  The port's ``Trainer(mesh=)`` underneath.
- ``zero_sharded``: the same step with ZeRO-1: the updater state held
  for this rank's shard of each leaf (``sharding.zero_shard_dim``), the
  updates all-gathered. An updater with gradient normalization needs
  whole leaves and is refused here.
- ``averaging``: each rank trains its replica on its block alone (its
  own generator); every ``averaging_frequency`` iterations the params,
  and with ``average_updater_state`` the floating updater state, are
  averaged over the group.
- ``encoded_gradients``: each rank's updater runs on its own gradient;
  the update (flattened in ``tree_leaves`` order, the reference's
  ``ravel_pytree`` order) plus the rank's residual is encoded
  (``compression.threshold_encode`` with ``quantize``, else
  ``topk_encode``), the messages all-gathered, and every rank adds the
  decoded mean. ``staleness=1`` applies a rank's own update at once and
  its peers' one step late; ``_sync_model`` delivers the last round.

The loss reported for a step is the global loss in the sync modes and
the mean of the ranks' losses in the replica modes, on every rank.
``rules=`` (tensor and sequence parallelism, ``parallel/sharding.py``)
applies to the sync modes: the trainer underneath is
``Trainer(mesh=, rules=)``, and under ``zero_sharded`` the leaves the
rules shard over ``model`` keep that layout while every other leaf's
updater state shards over ``data``. The replica modes refuse rules.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.updaters import tree_leaves
from ..train.listeners import (DeferredScoreReporter, PerformanceListener,
                               TrainingListener)
from ..train.trainer import (Trainer, _score, dp_evaluate,
                             dp_score_iterator)
from .compression import auto_capacity_frac, threshold_encode, topk_encode
from .dp import DataParallel, ZeroOne, all_gather
from .mesh import DATA_AXIS, make_mesh

_SYNC_MODES = ("shared_gradients", "zero_sharded")


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed of its own for each rank's replica."""
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1)[0])


class ParallelWrapper:
    """Data-parallel trainer over a mesh's process group
    (ParallelWrapper.Builder parity); see the module docstring.
    ``updater`` replaces the config's (``MultiHostTrainer`` passes its
    own through)."""

    def __init__(self, model, mesh=None, mode: str = "shared_gradients",
                 averaging_frequency: int = 5,
                 average_updater_state: bool = True, seed: int = 0,
                 threshold: float = 1e-3,
                 capacity_frac: Optional[float] = None, quantize: bool = True,
                 rules=None, grad_accum: int = 1, staleness: int = 0,
                 updater=None):
        self.model = model
        self._updater = updater
        self.mesh = mesh if mesh is not None else make_mesh()
        self.mode = mode
        self.rules = tuple(rules) if rules is not None else ()
        if rules and mode not in _SYNC_MODES:
            raise ValueError("rules= (tensor/seq parallelism) applies to "
                             "mode='shared_gradients'/'zero_sharded' only — "
                             "averaging/encoded modes replicate full model "
                             "copies per worker")
        self.grad_accum = max(1, int(grad_accum))
        if self.grad_accum > 1 and mode not in _SYNC_MODES:
            raise ValueError("grad_accum applies to mode="
                             "'shared_gradients'/'zero_sharded' only")
        self.averaging_frequency = averaging_frequency
        self.average_updater_state = average_updater_state
        if model.params is None:
            model.init()
        self.n_dev = self.mesh.size
        self.seed = seed
        self.iteration = 0
        self.epoch = 0
        self.threshold = threshold
        self.capacity_frac = (capacity_frac if capacity_frac is not None
                              else auto_capacity_frac(self.n_dev))
        self.quantize = quantize
        self.staleness = int(staleness)
        if self.staleness not in (0, 1):
            raise ValueError("staleness must be 0 (synchronous exchange) or "
                             "1 (apply peers' previous-step updates)")
        if self.staleness and mode != "encoded_gradients":
            raise ValueError("staleness applies to mode='encoded_gradients' "
                             "only (sync modes are exact by definition)")
        self._dp = DataParallel(self.mesh)
        if mode == "shared_gradients":
            self._init_sync()
        elif mode == "zero_sharded":
            self._init_sync(shard_opt_state=True)
        elif mode == "averaging":
            self._init_replicas()
        elif mode == "encoded_gradients":
            self._init_encoded()
        else:
            raise ValueError(f"Unknown mode '{mode}'")

    # the trainer's trees, under the reference's attribute names
    @property
    def params(self):
        return self.trainer.params

    @property
    def opt_state(self):
        return self.trainer.opt_state

    @property
    def state(self):
        return self.trainer.state

    @property
    def tx(self):
        return self.trainer.tx

    @property
    def device(self):
        return self.trainer.device

    # --- shared_gradients / zero_sharded ---
    def _init_sync(self, shard_opt_state: bool = False):
        self.trainer = Trainer(self.model, self._updater, seed=self.seed,
                               mesh=self.mesh, rules=self.rules or None,
                               grad_accum=self.grad_accum)
        if shard_opt_state:
            if self.model.config.gradient_normalization:
                raise ValueError(
                    "mode='zero_sharded' runs the updater on shards of each "
                    "leaf; gradient normalization needs whole leaves — use "
                    "mode='shared_gradients'")
            tr = self.trainer
            leaves = tree_leaves(tr.params)
            # rules + ZeRO-1 compose: a leaf the rules shard over the model
            # axis keeps that layout, every other leaf's updater state
            # shards over the data axis
            tr._zero = ZeroOne(tr._dp, tr.tx, leaves,
                               whole=getattr(tr, "_sharded", None))
            tr.opt_state = tr._zero.init(leaves)

    def _require_pure_data_mesh(self):
        """averaging/encoded modes hold one full replica a rank over the
        data axis; a mesh with other axes would replicate work and drop
        batch rows. Reject it up front."""
        if self.mesh.shape.get(DATA_AXIS, 0) != self.n_dev:
            raise ValueError(
                f"mode='{self.mode}' needs a pure data-parallel mesh "
                f"({DATA_AXIS}={self.n_dev}); got axes {self.mesh.shape}. "
                f"Use mode='shared_gradients' for meshes with model/seq "
                f"axes.")

    # --- averaging and encoded_gradients: one replica a rank ---
    def _init_replicas(self):
        self._require_pure_data_mesh()
        from .mesh import replicate

        replicate(self.model.params, self.mesh)
        self.model.state = replicate(self.model.state or {}, self.mesh)
        self.trainer = Trainer(self.model, self._updater,
                               seed=rank_seed(self.seed, self.mesh.rank))

    def _init_encoded(self):
        self._require_pure_data_mesh()
        if self.quantize and self.threshold <= 0:
            raise ValueError(
                "encoded_gradients with quantize=True transmits ±threshold "
                "messages; threshold<=0 would be an all-zero (no-op) update "
                "stream. Use threshold>0, or quantize=False for exact top-k.")
        self._init_replicas()
        leaves = tree_leaves(self.trainer.params)
        self._sizes = [p.numel() for p in leaves]
        self.size = sum(self._sizes)
        self.capacity = max(1, min(self.size,
                                   int(self.size * self.capacity_frac)))
        dev = self.trainer.device
        self.residual = torch.zeros(self.size, dtype=torch.float32,
                                    device=dev)
        if self.staleness:
            # this rank's message of the previous step, not yet applied by
            # its peers (slot 0 and value 0: a no-op for the first round)
            self.pending_idx = torch.zeros(self.capacity, dtype=torch.int32,
                                           device=dev)
            self.pending_val = torch.zeros(self.capacity, dtype=torch.float32,
                                           device=dev)

    def _add_flat(self, dense: torch.Tensor) -> None:
        """Add a flat vector to the params, leaf by leaf in
        ``tree_leaves`` order."""
        leaves = tree_leaves(self.trainer.params)
        with torch.no_grad():
            torch._foreach_add_(leaves, [
                c.view(p.shape).to(p.dtype)
                for p, c in zip(leaves, dense.split(self._sizes))])

    def _add_decoded(self, idx, val):
        """Add a decoded message (indices and values, any equal shapes)
        to the params."""
        dense = torch.zeros(self.size, dtype=torch.float32, device=val.device)
        self._add_flat(dense.index_add_(0, idx.reshape(-1), val.reshape(-1)))

    def _gather_message(self, idx, val):
        """Every rank's message: (n, k) indices and values."""
        return (all_gather(idx, self.mesh.group),
                all_gather(val, self.mesh.group))

    def _apply_pending(self):
        """Add the peers' pending messages (this rank's own was added
        when it was made), each divided by n."""
        n = self.n_dev
        g_idx, g_val = self._gather_message(self.pending_idx,
                                            self.pending_val)
        keep = (torch.arange(n, device=g_val.device)
                != self.mesh.rank)[:, None]
        self._add_decoded(g_idx, torch.where(keep, g_val, 0.0) / n)

    def _encoded_step(self, x, y, mask, label_mask):
        tr = self.trainer
        x, y, mask, label_mask = (tr._stage(a)
                                  for a in (x, y, mask, label_mask))
        if self.staleness:
            self._apply_pending()
        leaves = tree_leaves(tr.params)
        trained = [p for p in leaves if p.requires_grad]
        with torch.enable_grad():
            loss, new_state = _score(self.model, tr.params, tr.state, x, y,
                                     training=True, rng=tr._gen, mask=mask,
                                     label_mask=label_mask)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        # the updater runs first, on this rank's gradient; its update, not
        # the gradient, is what gets encoded and shared
        updates, tr.opt_state = tr._updates(leaves, grads, tr.opt_state)
        tr.state = new_state
        flat = torch.cat([(torch.zeros_like(p) if u is None else u)
                          .reshape(-1).to(torch.float32)
                          for p, u in zip(leaves, updates)])
        del updates
        if self.quantize:
            enc, self.residual = threshold_encode(
                flat, self.threshold, self.capacity, self.residual)
            values = enc.signs.to(torch.float32) * self.threshold
        else:
            enc, self.residual = topk_encode(
                flat, self.threshold, self.capacity, self.residual)
            values = enc.values
        del flat
        self.last_count = enc.count
        n = self.n_dev
        if self.staleness:  # own now, to the peers at the next step
            self._add_decoded(enc.indices, values / n)
            self.pending_idx, self.pending_val = enc.indices, values
        else:
            g_idx, g_val = self._gather_message(enc.indices, values)
            self._add_decoded(g_idx, g_val / n)
        return loss.detach()

    def _replica_step(self, x, y, mask, label_mask):
        tr = self.trainer
        tr.params, tr.opt_state, tr.state, loss = tr.step(
            tr.params, tr.opt_state, tr.state, x, y, tr._gen, mask,
            label_mask)
        if (self.iteration + 1) % self.averaging_frequency == 0:
            self._average()
        return loss

    def _average(self):
        """Params (and the floating updater state) averaged over the
        group, in place."""
        tr = self.trainer
        trees = [tr.params] + ([tr.opt_state]
                               if self.average_updater_state else [])
        with torch.no_grad():
            for tree in trees:
                leaves = [t for t in tree_leaves(tree)
                          if torch.is_tensor(t) and t.is_floating_point()]
                if not leaves:
                    continue
                means = self._dp.all_reduce_flat(leaves)
                for t, m in zip(leaves, means):
                    t.copy_(m / self.n_dev)

    # --- fit loop (ParallelWrapper.fit :467) ---
    def fit(self, iterator, epochs: int = 1,
            listeners: Sequence[TrainingListener] = (), telemetry=None):
        """Train on the global batches of ``iterator`` (every rank the
        same). ``telemetry``: an ``obs.StepTelemetry``-shaped object, or
        the first listener's ``.telemetry``; steps go through its
        ``parallel_step`` (per-replica step times and throughput)."""
        from ..data.iterators import AsyncIterator

        reporter = DeferredScoreReporter(self, listeners)
        tel = telemetry
        if tel is None:
            for lst in listeners:
                tel = getattr(lst, "telemetry", None)
                if tel is not None:
                    break
        for epoch in range(epochs):
            self.epoch = epoch
            if tel is not None:
                tel.tracer.instant("epoch_start", epoch=epoch)
            for lst in listeners:
                lst.on_epoch_start(self, epoch)
            it = AsyncIterator(iterator)
            if tel is not None:
                it = tel.wrap_iterator(it)
            for ds in it:
                x, y, mask, lmask = (None if a is None else np.asarray(a)
                                     for a in (ds.features, ds.labels,
                                               ds.features_mask,
                                               ds.labels_mask))
                b = x.shape[0]
                for lst in listeners:
                    if isinstance(lst, PerformanceListener):
                        lst.step_begin(b)
                if tel is not None:
                    loss = tel.parallel_step(
                        lambda: self._fit_batch(x, y, mask, lmask),
                        batch_size=b)
                else:
                    loss = self._fit_batch(x, y, mask, lmask)
                reporter.report(self.iteration, epoch, loss)
                self.iteration += 1
            reporter.flush()
            if hasattr(iterator, "reset"):
                iterator.reset()
            for lst in listeners:
                lst.on_epoch_end(self, epoch)
        self._sync_model()
        return self

    def _fit_batch(self, x, y, mask=None, label_mask=None):
        """One global batch: padded to divide over the ranks, this rank's
        block of rows through the mode's step. Returns the device loss."""
        x, y, mask, label_mask = (None if a is None else self._pad_rows(a)
                                  for a in (x, y, mask, label_mask))
        rows = self.mesh.rows(x.shape[0])
        x, y, mask, label_mask = (None if a is None else a[rows]
                                  for a in (x, y, mask, label_mask))
        tr = self.trainer
        if self.mode in _SYNC_MODES:
            if self.rules:  # the seq blocks under rules
                x, y, mask, label_mask = tr._rank_batch(
                    (x, y, mask, label_mask), rows=False)
            return tr._dispatch_train_step(x, y, mask, label_mask)
        if self.mode == "encoded_gradients":
            loss = self._encoded_step(x, y, mask, label_mask)
        else:
            loss = self._replica_step(x, y, mask, label_mask)
        # the mean of the ranks' losses
        return self._dp.all_reduce(loss.reshape(1).float())[0] / self.n_dev

    def _sync_model(self):
        """Deliver any pending round, then point the model at this rank's
        params and state (every rank's are the same after a sync mode's
        step, an averaging or a delivered round; under rules, this rank's
        shards, as ``Trainer.fit`` leaves them)."""
        if self.mode == "encoded_gradients" and self.staleness:
            self._apply_pending()
            self.pending_idx = torch.zeros_like(self.pending_idx)
            self.pending_val = torch.zeros_like(self.pending_val)
        self.model.params = self.trainer.params
        self.model.state = self.trainer.state

    def evaluate(self, iterator, evaluation=None):
        """Evaluation with each global batch's forward split over the
        ranks; every rank evaluates the whole batch."""
        self._sync_model()
        return dp_evaluate(self._dp, self.model, self.trainer.full_params(),
                           self.model.state, iterator, evaluation,
                           self.trainer._stage)

    def save(self, path: str, normalizer=None):
        """The synced model as the model zip, written by rank 0 (call it
        on every rank: the others wait for the write)."""
        self._sync_model()
        from ..train.serialization import save_model

        params = self.trainer.full_params()
        if self.mesh.rank == 0:
            save_model(path, self.model, params=params,
                       state=self.model.state, normalizer=normalizer)
        dist.barrier(group=self.mesh.group)

    def _pad_rows(self, a: np.ndarray) -> np.ndarray:
        """Pad dim 0 to a multiple of the data axis by cycling rows (safe
        when the batch is smaller than the pad)."""
        pad = (-a.shape[0]) % self.mesh.data_size
        if not pad:
            return a
        idx = np.arange(pad) % a.shape[0]
        return np.concatenate([a, a[idx]])

    def score_iterator(self, iterator) -> float:
        """Average loss over an iterator, the mean of batch means (the
        ``Trainer.score_iterator`` contract, masks included): each batch
        split over the ranks unpadded, reduced by loss mass, so a ragged
        or masked batch scores exactly as on one device."""
        self._sync_model()
        return dp_score_iterator(self._dp, self.model,
                                 self.trainer.full_params(),
                                 self.model.state, iterator,
                                 self.trainer._stage)
