"""Multi-process data-parallel training — counterpart of
``deeplearning4j_tpu/parallel/multihost.py``.

Each process is one rank of a ``torch.distributed`` group
(:func:`initialize_multihost`) and feeds only its own shard of every
global batch (:class:`ProcessShardIterator`: contiguous rows, rank order,
the reference's ``VirtualDataSetIterator``). :class:`MultiHostTrainer`
steps on the global batch those shards make:

- ``shared_gradients``: the loss and gradients reduced over the group by
  loss mass (``parallel.dp``), so with the same global batch stream and
  seeds a step is ``Trainer.fit``'s step on the whole batch, whatever the
  shards' masks; ``grad_accum`` as the reference's (strided microbatches
  of each rank's rows);
- ``encoded_gradients``: each rank's update encoded against its residual
  and exchanged (``ParallelWrapper``'s encoded step, staleness 0).

Listeners fire on rank 0 only (those with ``every_rank`` set, as early
stopping's guard, on every rank). ``score_iterator`` and ``evaluate`` are
distributed too: the loss by loss mass over the shards, the evaluation
accumulated on each rank's rows and merged on every rank.
``save`` is collective (rank 0 writes the model zip with its updater
state, whole params under rules; every rank waits at a barrier),
``restore`` reads it on every rank (each takes its shards under rules),
or a ``train/orbax_io`` checkpoint directory (``orbax_io.save_trainer``),
which continues exactly: generator, iteration and residual included.
``rules=`` (shared_gradients) trains through ``Trainer(mesh=, rules=)``:
tensor and sequence parallelism, ``parallel/sharding.py``; each process
feeds its ``data_shard()``, so tp/sp peers feed the same rows.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.updaters import tree_leaves
from ..train.listeners import (DeferredScoreReporter, PerformanceListener,
                               TrainingListener)
from ..train.trainer import default_evaluation, unpack_batch
from .mesh import distributed_init, make_mesh
from .wrapper import ParallelWrapper


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device=None, backend: Optional[str] = None) -> bool:
    """Join the process group (SharedTrainingMaster.java:457):
    ``coordinator`` is ``host:port`` (or a ``tcp://``/``file://`` URL).
    With no arguments the environment (``MASTER_ADDR``...) is read.
    Returns True when this call made the group; False for one process, a
    group that exists, or nothing to join. Explicit arguments that do not
    work raise: no silent single-process fallback."""
    if num_processes is not None and num_processes <= 1:
        return False
    url = coordinator
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    return distributed_init(url, num_processes, process_id, device=device,
                            backend=backend)


class ProcessShardIterator:
    """This process's contiguous slice of every global batch: rows
    ``[pid*local_b, (pid+1)*local_b)`` of batch ``i``. The ragged tail is
    dropped so every process sees the same number of batches."""

    def __init__(self, features, labels, global_batch_size: int,
                 process_id: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 features_mask=None, labels_mask=None):
        self.x = np.asarray(features)
        self.y = np.asarray(labels)
        self.fm = None if features_mask is None else np.asarray(features_mask)
        self.lm = None if labels_mask is None else np.asarray(labels_mask)
        self.gb = int(global_batch_size)
        ready = dist.is_initialized()
        self.pid = ((dist.get_rank() if ready else 0) if process_id is None
                    else process_id)
        self.np_ = ((dist.get_world_size() if ready else 1)
                    if num_processes is None else num_processes)
        if self.gb % self.np_:
            raise ValueError(f"global batch {self.gb} not divisible by "
                             f"{self.np_} processes")
        self.local_b = self.gb // self.np_
        self.n_batches = self.x.shape[0] // self.gb

    def __iter__(self):
        from ..data.iterators import DataSet

        for i in range(self.n_batches):
            lo = i * self.gb + self.pid * self.local_b
            sl = slice(lo, lo + self.local_b)
            yield DataSet(self.x[sl], self.y[sl],
                          self.fm[sl] if self.fm is not None else None,
                          self.lm[sl] if self.lm is not None else None)

    def reset(self):
        pass


class MultiHostTrainer:
    """Synchronous data-parallel trainer over every rank of a group, fed
    per-rank shards; see the module docstring."""

    def __init__(self, model, mesh=None, updater=None, seed: int = 0,
                 rules=None, mode: str = "shared_gradients",
                 threshold: float = 1e-3,
                 capacity_frac: Optional[float] = None,
                 quantize: bool = True, grad_accum: int = 1):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh()
        self.mode = mode
        self.grad_accum = max(1, int(grad_accum))
        if self.grad_accum > 1 and mode == "encoded_gradients":
            raise ValueError("grad_accum requires mode='shared_gradients'")
        if mode == "encoded_gradients" and rules:
            raise ValueError("encoded_gradients replicates full model "
                             "copies per worker; rules= (tp/sp sharding) "
                             "only applies to mode='shared_gradients'")
        if mode not in ("shared_gradients", "encoded_gradients"):
            raise ValueError(f"Unknown mode '{mode}'")
        self.rules = tuple(rules) if rules else ()
        self._pw = ParallelWrapper(model, self.mesh, mode=mode, seed=seed,
                                   rules=self.rules,
                                   threshold=threshold,
                                   capacity_frac=capacity_frac,
                                   quantize=quantize,
                                   grad_accum=self.grad_accum,
                                   updater=updater)
        self.trainer = self._pw.trainer
        self.iteration = 0
        self.epoch = 0

    @property
    def params(self):
        return self.trainer.params

    @property
    def state(self):
        return self.trainer.state

    @property
    def opt_state(self):
        return self.trainer.opt_state

    @property
    def tx(self):
        return self.trainer.tx

    @property
    def device(self):
        return self.trainer.device

    @property
    def residual(self):
        return self._pw.residual

    @property
    def is_main(self) -> bool:
        return self.mesh.rank == 0

    def data_shard(self) -> "tuple[int, int]":
        """(shard index, number of shards) this process feeds: its block on
        the data axis (ranks that differ only on other axes feed the same
        rows)."""
        return self.mesh.data_index, self.mesh.data_size

    def _fit_batch(self, ds):
        x, y, fm, lm = unpack_batch(self.model, ds)
        if self.rules:  # the seq blocks of this rank's rows
            x, y, fm, lm = self.trainer._rank_batch((x, y, fm, lm), rows=False)
        if self.mode == "encoded_gradients":
            pw = self._pw
            loss = pw._encoded_step(x, y, fm, lm)
            return pw._dp.all_reduce(loss.reshape(1).float())[0] / pw.n_dev
        return self.trainer._dispatch_train_step(x, y, fm, lm)

    def fit(self, iterator: Iterable, epochs: int = 1,
            listeners: Sequence[TrainingListener] = ()) -> "MultiHostTrainer":
        """``iterator`` yields this rank's shard of each global batch; every
        rank must yield the same number of batches an epoch (lockstep).
        Listeners fire on rank 0."""
        listeners = [l for l in listeners
                     if self.is_main or getattr(l, "every_rank", False)]
        reporter = DeferredScoreReporter(self, listeners)
        for epoch in range(epochs):
            self.epoch = epoch
            for lst in listeners:
                lst.on_epoch_start(self, epoch)
            for ds in iterator:
                for lst in listeners:
                    if isinstance(lst, PerformanceListener):
                        lst.step_begin(ds.num_examples * self.mesh.data_size)
                loss = self._fit_batch(ds)
                reporter.report(self.iteration, epoch, loss)
                self.iteration += 1
            reporter.flush()
            if hasattr(iterator, "reset"):
                iterator.reset()
            for lst in listeners:
                lst.on_epoch_end(self, epoch)
        self._sync_model()
        return self

    def _sync_model(self):
        self._pw._sync_model()

    def score_iterator(self, iterator) -> float:
        """Average loss over an iterator of this rank's shards: each global
        batch's loss reduced by loss mass over the group (lockstep)."""
        self._sync_model()
        tr = self.trainer
        dp = tr._dp if tr._dp is not None else self._pw._dp
        total, n = 0.0, 0
        for ds in iterator:
            x, y, fm, lm = (tr._stage(a) for a in unpack_batch(self.model, ds))
            with tr._sharded_step(seq_input=False):
                total += float(dp.score(self.model, tr.params, tr.state, x,
                                        y, fm, lm, split=False))
            n += 1
        if hasattr(iterator, "reset"):
            iterator.reset()
        return total / max(n, 1)

    def evaluate(self, iterator, evaluation=None,
                 global_mesh: Optional[bool] = None):
        """Distributed evaluation for any mergeable evaluation: each rank
        forwards its own rows into a fresh instance, the instances' states
        are all-gathered and merged into ``evaluation`` on every rank.

        ``global_mesh``: forward through the training step's layout (the
        rules' shards and their collectives, whole sequences) — needed for
        rules-sharded params; default: on when ``rules`` are set or a layer
        is ``ring=True``. Then each process feeds its ``data_shard()`` rows
        (tp/sp peers the same rows, as for ``fit``) and only one rank per
        data block is merged. Otherwise (mesh-free: the synced whole
        params on each rank) every rank feeds distinct rows and every rank
        is merged."""
        from ..train.trainer import evaluate_model

        if global_mesh is None:
            global_mesh = self._needs_global_mesh_eval()
        if evaluation is None:
            evaluation = default_evaluation(self.model)
        for attr in ("new_like", "state", "load_state", "merge", "eval"):
            if not hasattr(evaluation, attr):
                raise TypeError(
                    f"distributed evaluate requires a mergeable evaluation "
                    f"(new_like/state/load_state/merge); "
                    f"{type(evaluation).__name__} lacks .{attr}")
        self._sync_model()
        tr = self.trainer
        if global_mesh:
            with tr._sharded_step(seq_input=False):
                local = evaluate_model(self.model, tr.params, tr.state,
                                       iterator, evaluation.new_like(),
                                       tr._stage)
            merged = self._pw._dp.block_ranks()
        else:
            local = evaluate_model(self.model, tr.full_params(), tr.state,
                                   iterator, evaluation.new_like(),
                                   tr._stage)
            merged = range(self.mesh.size)
        states = [None] * self.mesh.size
        dist.all_gather_object(states, local.state(), group=self.mesh.group)
        for r in merged:
            evaluation.merge(evaluation.new_like().load_state(states[r]))
        return evaluation

    def _needs_global_mesh_eval(self) -> bool:
        """Rules-sharded params, or a mesh-aware (``ring=True``) layer."""
        if self.mode == "encoded_gradients":
            return False
        if self.rules:
            return True
        from ..train.trainer import _named_layers

        return any(getattr(l, "ring", False)
                   for _, l in _named_layers(self.model))

    def save(self, path: str, normalizer=None):
        """Model zip with the updater state, written by rank 0. Collective:
        call it on every rank (the others wait at a barrier, so a rank that
        restores next never reads a partial file)."""
        from ..train.serialization import save_model

        self._sync_model()
        params = self.trainer.full_params()
        opt_state = self.trainer.full_opt_state()
        if self.is_main:
            save_model(path, self.model, params=params,
                       state=self.trainer.state, opt_state=opt_state,
                       normalizer=normalizer)
        dist.barrier(group=self.mesh.group)

    def restore(self, path: str):
        """Resume on every rank from a ``save`` zip (params, net state and
        updater state; the zip carries no generator stream, iteration or
        residual, so the encoded mode's residual restarts at 0 and
        continuation is exact for models without dropout) or from an
        ``orbax_io.save_trainer`` directory (each rank's own shards, the
        generator, the iteration and the residual too: exact
        continuation)."""
        from ..train.serialization import load_model, load_opt_state

        if os.path.isdir(path):
            from ..train.orbax_io import restore_trainer

            return restore_trainer(path, self)
        tr = self.trainer
        _, params, state = load_model(path, device=tr.device)
        full = tree_leaves(params)
        if tr._specs is not None:  # this rank's shards of the whole leaves
            from .sharding import shard_leaf, shard_opt_state, spec_leaves

            specs = spec_leaves(tr._specs)
            full = [shard_leaf(p, sp, self.mesh) for p, sp in zip(full, specs)]
        with torch.no_grad():
            for dst, src in zip(tree_leaves(tr.params), full):
                dst.copy_(src)
        tr.state = state
        opt = load_opt_state(path, tr.full_opt_state(), device=tr.device)
        if opt is not None:
            if tr._specs is not None:
                opt = shard_opt_state(opt, tree_leaves(params), specs,
                                      self.mesh)
            tr.opt_state = opt
        if self.mode == "encoded_gradients":
            self._pw.residual.zero_()
        self._sync_model()
        return self
