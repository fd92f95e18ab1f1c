"""Training-time failure recovery — divergence rollback and segmented
checkpoint-resume, folded into the chaos fault plane; the port's copy of
``deeplearning4j_tpu/chaos/recovery.py`` over the port's ``Trainer``.

The segmented fit exercises the ``train.segment`` injection point, so
preemption between segments is a seeded scenario. ``train.faults`` is an
import shim for the same names.

Module-level imports stay stdlib-only (the chaos base-layer rule —
``chaos/__init__.py``): torch and the train serialization helpers load
inside the methods that need them, so arming a fault plane never drags
the training stack into the process.

- :class:`DivergenceListener` — NaN/inf loss detection with configurable
  action: raise (fail fast), or restore the last good snapshot and
  continue with a reduced learning-rate scale.
- :class:`FaultTolerantFit` — checkpoint-resume wrapper: runs
  ``Trainer.fit`` in segments, persisting params/opt-state every
  segment, so a preempted process restarted with the same directory
  continues where it left off.
"""

from __future__ import annotations

import json
import math
import os

from . import faults as _faults


class TrainingDivergedException(RuntimeError):
    pass


def _host_copy(tree):
    """The tree with every tensor leaf copied to host memory (a snapshot
    the trainer's in-place updates cannot reach)."""
    import torch

    from ..ops.updaters import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [
        t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor)
        else t for t in tree_leaves(tree)])


def _assign_params(trainer, params) -> None:
    """Write ``params``' values into the trainer's parameter tensors in
    place: they are the leaves autograd differentiates (``requires_grad``
    as the trainer set it) and the tensors a captured step reads."""
    import torch

    from ..ops.updaters import tree_leaves

    dst, src = tree_leaves(trainer.params), tree_leaves(params)
    if [tuple(t.shape) for t in dst] != [tuple(t.shape) for t in src]:
        raise ValueError("snapshot params do not match the trainer's")
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)


def _on_device(tree, device):
    import torch

    from ..ops.updaters import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [
        t.to(device, copy=True) if isinstance(t, torch.Tensor) else t
        for t in tree_leaves(tree)])


class RecoveryListener:
    """Minimal training-listener surface (duck-typed — the fit loops only
    ever call these and read the two class flags, so the chaos layer does
    not need to import ``train.listeners`` at module scope)."""

    requires_sync = False
    snapshots_state = False

    def on_epoch_start(self, trainer, epoch):
        pass

    def on_epoch_end(self, trainer, epoch):
        pass

    def iteration_done(self, trainer, iteration, epoch, loss):
        pass


class DivergenceListener(RecoveryListener):
    """Watches the per-iteration loss; on NaN/inf either raises
    ``TrainingDivergedException`` (action='raise') or rolls the trainer back
    to the last finite-loss snapshot (action='rollback')."""

    # steers the loop from iteration_done (rollback must act before the next
    # dispatch), so the fit loops must not defer this listener's reporting,
    # and steps_per_execution windows stay off: a rollback never writes
    # params under a captured graph
    requires_sync = True

    def __init__(self, action: str = "raise", snapshot_every: int = 10,
                 max_rollbacks: int = 3, lr_backoff: float = 0.5):
        if action not in ("raise", "rollback"):
            raise ValueError(f"action must be 'raise' or 'rollback', got "
                             f"{action!r}")
        self.action = action
        self.snapshot_every = max(snapshot_every, 1)
        self.max_rollbacks = max_rollbacks
        self.lr_backoff = lr_backoff
        self.lr_scale = 1.0
        self.rollbacks = 0
        # two-stage snapshot: the loss reported at iteration k was computed
        # from the params BEFORE that step's update, so the params captured at
        # iteration k are unvalidated until a LATER finite loss confirms them.
        # _pending holds the newest (unvalidated) capture; _snap only ever
        # holds a capture whose params a later step scored finite.
        self._pending = None
        self._snap = None
        # the trainer's updater before the first rollback chained a scale
        # stage onto it (the reference keeps it on the trainer)
        self._base_tx = None

    def iteration_done(self, trainer, iteration, epoch, loss):
        if math.isfinite(loss):
            if self._pending is not None:
                self._snap = self._pending  # validated by this finite loss
                self._pending = None
            if iteration % self.snapshot_every == 0:
                # host copies: the trainer updates its device tensors in
                # place. Record whether the opt state was captured in the
                # chained (post-rollback) structure so a later restore can
                # re-wrap.
                self._pending = (_host_copy(trainer.params),
                                 _host_copy(trainer.opt_state),
                                 self._base_tx is not None)
            return
        self._pending = None  # produced this non-finite loss: poison
        if self.action == "raise" or self._snap is None:
            raise TrainingDivergedException(
                f"loss {loss} at iteration {iteration} (epoch {epoch})")
        if self.rollbacks >= self.max_rollbacks:
            raise TrainingDivergedException(
                f"diverged {self.rollbacks + 1}x despite rollbacks")
        from ..ops import updaters
        from ..ops.updaters import tree_leaves

        self.rollbacks += 1
        params, opt_state, snap_chained = self._snap
        _assign_params(trainer, params)
        opt_state = _on_device(opt_state, trainer.device)
        # shrink the learning rate so a deterministic replay of the same data
        # order doesn't re-diverge identically: chain a (stateless) scale
        # stage onto the updater
        self.lr_scale *= self.lr_backoff
        if not snap_chained:
            # opt-state gains the scale stage's empty state; snapshots taken
            # after the first rollback already carry the chained structure
            opt_state = (opt_state, updaters.scale(1.0).init(
                tree_leaves(trainer.params)))
        if self._base_tx is None:
            self._base_tx = trainer.tx
        trainer.replace_updater(
            updaters.chain(self._base_tx, updaters.scale(self.lr_scale)),
            opt_state)


class FaultTolerantFit:
    """Segmented fit with durable progress: every ``segment_epochs`` the
    model + optimizer state land in ``directory``; a relaunched process picks
    up from the recorded epoch (resume semantics on the shared model-zip
    format). Each segment boundary passes through the ``train.segment``
    chaos seam *before* its checkpoint lands, so a seeded scenario can
    preempt the process with the previous segment still the durable truth —
    exactly the window a real preemption hits."""

    def __init__(self, trainer, directory: str, segment_epochs: int = 1):
        self.trainer = trainer
        self.directory = directory
        self.segment_epochs = max(segment_epochs, 1)
        os.makedirs(directory, exist_ok=True)

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.directory, "progress.json")

    @property
    def _ckpt_path(self) -> str:
        return os.path.join(self.directory, "fault_tolerant.zip")

    def completed_epochs(self) -> int:
        if not os.path.exists(self._meta_path):
            return 0
        with open(self._meta_path) as f:
            return int(json.load(f).get("completed_epochs", 0))

    def fit(self, iterator, epochs: int, listeners=(), prefetch: bool = True):
        from ..train.serialization import (load_model, load_opt_state,
                                           save_model)

        done = self.completed_epochs()
        if done > 0 and os.path.exists(self._ckpt_path):
            _, params, state = load_model(self._ckpt_path,
                                          device=self.trainer.device)
            _assign_params(self.trainer, params)
            self.trainer.state = state
            opt_state = load_opt_state(self._ckpt_path,
                                       self.trainer.opt_state)
            if opt_state is not None:
                self.trainer.opt_state = opt_state
            self.trainer.epoch = done
        while done < epochs:
            seg = min(self.segment_epochs, epochs - done)
            self.trainer.fit(iterator, epochs=seg, listeners=listeners,
                             prefetch=prefetch)
            done += seg
            if _faults.ACTIVE is not None:
                # preemption window: the segment ran but its checkpoint has
                # not landed — a relaunch must redo exactly this segment
                _faults.ACTIVE.hit("train.segment", scope=str(done))
            save_model(self._ckpt_path, self.trainer.model,
                       params=self.trainer.params, state=self.trainer.state,
                       opt_state=self.trainer.opt_state)
            with open(self._meta_path, "w") as f:
                json.dump({"completed_epochs": done}, f)
        return self.trainer
