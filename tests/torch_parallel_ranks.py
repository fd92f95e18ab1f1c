"""Rank-side cases of the port's data-parallel tests.

The functions here run inside spawned gloo ranks
(``deeplearning4j_torch.parallel.RankGroup``), which import this module
to unpickle them: it imports no JAX and nothing of the JAX package. Each
takes plain data (a model's JSON, its params as numpy trees, numpy
batches), builds the port model on the CPU and returns numpy results
from the rank (the group hands back rank 0's unless asked for all).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_torch.data import DataSet
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener,
                                        model_from_json, params_from_numpy,
                                        state_from_numpy)


def build(js, params, state=None):
    """The port model of ``js`` on the CPU, with ``params`` (numpy
    tree)."""
    m = model_from_json(js, device="cpu")
    m.params = params_from_numpy(m, params)
    m.state = state_from_numpy(state, "cpu") if state else {}
    return m


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


class Batches:
    """An iterator over fixed (x, y, features mask, labels mask) batches."""

    def __init__(self, batches):
        self.batches = [tuple(b) + (None,) * (4 - len(b)) for b in batches]

    def __iter__(self):
        return iter([DataSet(*b) for b in self.batches])

    def reset(self):
        pass


def jax_modules():
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib",
                                         "deeplearning4j_tpu"))


def rank_info():
    """This rank's view: rank, world, backend, threads, loaded modules."""
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend(), threads=torch.get_num_threads(),
                jax=jax_modules(),
                env=sorted(k for k in os.environ
                           if k.startswith(("MASTER_", "RANK", "WORLD_"))))


def _mesh(axes=None):
    from deeplearning4j_torch.parallel import make_mesh

    return make_mesh(axes)


def wrapper_fit(js, params, batches, epochs, mode="shared_gradients",
                kw=None, axes=None):
    """ParallelWrapper(mode, **kw).fit over a mesh of ``axes`` (default:
    every rank on the data axis): final params, losses, the updater
    state's leaf shapes, the residual's total magnitude."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh(axes), mode=mode,
                         **(kw or {}))
    col = CollectScoresListener()
    pw.fit(Batches(batches), epochs=epochs, listeners=[col])
    res = getattr(pw, "residual", None)
    return dict(params=np_tree(pw.model.params),
                losses=np.asarray([s for _, s in col.scores]),
                opt_shapes=[tuple(t.shape) for t in tree_leaves(pw.opt_state)
                            if torch.is_tensor(t)],
                residual=None if res is None else float(res.abs().sum()))


def wrapper_state(js, params, state, batches, epochs):
    """shared_gradients' net state after ``epochs`` (this rank's)."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params, state), mesh=_mesh())
    pw.fit(Batches(batches), epochs=epochs)
    return np_tree(pw.state)


def wrapper_rejects(js, params, mode, kw=None, axes=None):
    """The error a ParallelWrapper constructor raises, as (type, text)."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    try:
        ParallelWrapper(build(js, params), mesh=_mesh(axes), mode=mode,
                        **(kw or {}))
    except Exception as e:  # noqa: BLE001 - returned to the test
        return type(e).__name__, str(e)
    return None


def staleness_round(js, params, batch, kw):
    """One encoded step at staleness 1: every rank's params and pending
    magnitude in flight, then after the flush."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh(),
                         mode="encoded_gradients", **kw)
    pw._fit_batch(*batch)

    def every():
        mine = (np_tree(pw.params), float(pw.pending_val.abs().sum()))
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, mine)
        return out

    before = every()
    pw._sync_model()
    return before, every()


def wrapper_score(js, params, batches):
    """ParallelWrapper.score_iterator."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh())
    return pw.score_iterator(Batches(batches))


def wrapper_evaluate(js, params, batches, axes=None):
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh(axes))
    ev = pw.evaluate(Batches(batches))
    return ev.confusion.copy()


def trainer_mesh_fit(js, params, batches, epochs, grad_accum=1):
    """Trainer(mesh=make_mesh({"data": world})).fit, then its
    score_iterator and evaluate on the same batches."""
    from deeplearning4j_torch.parallel import DATA_AXIS
    from deeplearning4j_torch.train import Trainer

    tr = Trainer(build(js, params), mesh=_mesh({DATA_AXIS: -1}),
                 grad_accum=grad_accum)
    col = CollectScoresListener()
    tr.fit(Batches(batches), epochs=epochs, listeners=[col], prefetch=False)
    return dict(params=np_tree(tr.params),
                losses=np.asarray([s for _, s in col.scores]),
                score=tr.score_iterator(Batches(batches)),
                confusion=tr.evaluate(Batches(batches)).confusion.copy())


def multihost_fit(js, params, x, y, gb, epochs, mode="shared_gradients",
                  kw=None, fm=None, lm=None):
    """MultiHostTrainer over ProcessShardIterator shards: params, rank 0's
    losses, the distributed score and evaluation."""
    from deeplearning4j_torch.parallel import (MultiHostTrainer,
                                               ProcessShardIterator)

    mh = MultiHostTrainer(build(js, params), mesh=_mesh(), mode=mode,
                          **(kw or {}))
    it = ProcessShardIterator(x, y, gb, features_mask=fm, labels_mask=lm)
    col = CollectScoresListener()
    mh.fit(it, epochs=epochs, listeners=[col])
    return dict(params=np_tree(mh.params),
                losses=np.asarray([s for _, s in col.scores]),
                score=mh.score_iterator(it),
                confusion=mh.evaluate(it).confusion.copy(),
                shard=mh.data_shard())


def multihost_rejects(js, params):
    """(error type, the expected phrase if the message has it) for each
    refused MultiHostTrainer: encoded with grad_accum, an unknown mode,
    rules= with the encoded mode (it replicates whole models), and
    restoring a directory that holds no checkpoint."""
    from deeplearning4j_torch.parallel import MultiHostTrainer

    out = []
    for kw, phrase in (({"mode": "encoded_gradients", "grad_accum": 2},
                        "grad_accum"),
                       ({"mode": "averaging"}, "Unknown mode"),
                       ({"rules": [(".*", ())],
                         "mode": "encoded_gradients"}, "rules")):
        try:
            MultiHostTrainer(build(js, params), mesh=_mesh(), **kw)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - returned to the test
            out.append((type(e).__name__, phrase if phrase in str(e)
                        else str(e)))
    mh = MultiHostTrainer(build(js, params), mesh=_mesh())
    try:
        mh.restore(os.path.dirname(os.path.abspath(__file__)))
        out.append(None)
    except FileNotFoundError as e:
        out.append(("FileNotFoundError",
                    "no checkpoint" if "no checkpoint" in str(e) else str(e)))
    return out


def multihost_resume(js, params, x, y, gb, path):
    """Two epochs, save, a fresh trainer restored from the zip, two more
    epochs; and an unbroken run of four. Both runs' params."""
    from deeplearning4j_torch.parallel import (MultiHostTrainer,
                                               ProcessShardIterator)

    it = ProcessShardIterator(x, y, gb)
    a = MultiHostTrainer(build(js, params), mesh=_mesh())
    a.fit(it, epochs=2)
    a.save(path)
    b = MultiHostTrainer(build(js, params), mesh=_mesh(), seed=999)
    b.restore(path)
    b.fit(it, epochs=2)
    c = MultiHostTrainer(build(js, params), mesh=_mesh())
    c.fit(it, epochs=4)
    return dict(resumed=np_tree(b.params), unbroken=np_tree(c.params))


def early_stopping(js, params, train, held_out, which, max_epochs,
                   patience, directory=None):
    """EarlyStoppingParallelTrainer over ParallelWrapper (``train`` global
    batches) or MultiHostTrainer (``train`` and ``held_out`` as (x, y,
    global batch) for ProcessShardIterator): the result's fields and the
    best model's params."""
    from deeplearning4j_torch.parallel import (MultiHostTrainer,
                                               ParallelWrapper,
                                               ProcessShardIterator)
    from deeplearning4j_torch.train import earlystopping as ES

    if which == "wrapper":
        trainer = ParallelWrapper(build(js, params), mesh=_mesh())
        tr_it, val_it = Batches(train), Batches(held_out)
    else:
        trainer = MultiHostTrainer(build(js, params), mesh=_mesh())
        tr_it = ProcessShardIterator(*train)
        val_it = ProcessShardIterator(*held_out)
    saver = (ES.LocalFileModelSaver(directory) if directory
             else ES.InMemoryModelSaver())
    cfg = ES.EarlyStoppingConfiguration(
        score_calculator=ES.DataSetLossCalculator(val_it),
        epoch_terminations=[ES.MaxEpochsTermination(max_epochs),
                            ES.ScoreImprovementEpochTermination(patience)],
        iteration_terminations=[ES.InvalidScoreIterationTermination()],
        model_saver=saver)
    res = ES.EarlyStoppingParallelTrainer(cfg, trainer).fit(tr_it)
    best = saver.get_best()
    best_params = best[1] if directory else best[0]
    return dict(reason=res.termination_reason,
                details=res.termination_details, best_epoch=res.best_epoch,
                best_score=res.best_score, total_epochs=res.total_epochs,
                scores=dict(res.score_vs_epoch),
                best_params=np_tree(best_params))


def parallel_telemetry(js, params, batches, fence):
    """ParallelWrapper.fit with a StepTelemetry on every rank: the replica
    gauges, steps counted and the step histogram's count."""
    from deeplearning4j_torch.obs import StepTelemetry
    from deeplearning4j_torch.parallel import ParallelWrapper

    tel = StepTelemetry(fence=fence)
    pw = ParallelWrapper(build(js, params), mesh=_mesh())
    pw.fit(Batches(batches), epochs=1, telemetry=tel)
    text = tel.to_prometheus()
    gauges = sorted(line.split(" ")[0] for line in text.splitlines()
                    if line.startswith("parallel_replica_step_seconds{"))
    return dict(gauges=gauges, steps=tel.snapshot()["steps"],
                has_rate="parallel_samples_per_second" in text)
