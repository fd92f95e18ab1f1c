"""Rank-side cases of the port's checkpoint (``train/orbax_io``) tests.

The functions here run inside spawned gloo ranks
(``deeplearning4j_torch.parallel.RankGroup``), which import this module
to unpickle them: it imports no JAX and nothing of the JAX package. Each
takes plain data (a model's JSON, its params as numpy trees, numpy
batches, a checkpoint directory every rank sees) and returns numpy
results from the rank.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import orbax_io

from torch_parallel_ranks import Batches, build, np_tree


def _mesh(axes=None):
    from deeplearning4j_torch.parallel import make_mesh

    return make_mesh(axes)


def _leaves(tree):
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def wrapper_resume(js, params, batches, path, mode, before, after):
    """ParallelWrapper(mode): ``before`` epochs, save_trainer, a fresh
    wrapper (another seed) restored, then ``after`` more epochs on both.
    Whether the restore and the continuations are bit-equal, the restored
    updater leaves' shapes beside the params', the final params."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    a = ParallelWrapper(build(js, params), mesh=_mesh(), mode=mode)
    a.fit(Batches(batches), epochs=before)
    orbax_io.save_trainer(path, a)
    b = ParallelWrapper(build(js, params), mesh=_mesh(), mode=mode, seed=7)
    orbax_io.restore_trainer(path, b)
    restored = (_equal(a.params, b.params) and _equal(a.opt_state, b.opt_state)
                and a.iteration == b.iteration)
    if mode == "encoded_gradients":
        restored = restored and torch.equal(a.residual, b.residual)
    a.fit(Batches(batches), epochs=after)
    b.fit(Batches(batches), epochs=after)
    return dict(restored=restored,
                continued=_equal(a.params, b.params)
                and _equal(a.opt_state, b.opt_state),
                opt_shapes=[tuple(t.shape) for t in tree_leaves(b.opt_state)],
                param_shapes=[tuple(t.shape) for t in tree_leaves(b.params)],
                params=np_tree(b.params))


def zero_save(js, params, batches, path, epochs):
    """ParallelWrapper(zero_sharded) trained ``epochs``, then saved; its
    params."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh(), mode="zero_sharded")
    pw.fit(Batches(batches), epochs=epochs)
    orbax_io.save_trainer(path, pw)
    return np_tree(pw.params)


def zero_restore(js, params, path):
    """A zero_sharded wrapper restored from ``path``: this rank's params,
    updater leaves and the ZeRO-1 dimension of each param."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh(), mode="zero_sharded")
    orbax_io.restore_trainer(path, pw)
    return dict(params=np_tree(pw.params), opt=_leaves(pw.opt_state),
                dims=list(pw.trainer._zero.dims), iteration=pw.iteration)


def multihost_dir_resume(js, params, x, y, gb, path):
    """MultiHostTrainer: two epochs, save_trainer into a directory, a fresh
    trainer (another seed) that ``restore``s it and trains two more; and an
    unbroken run of four. Whether the two end bit-equal, and the resumed
    trainer's iteration."""
    from deeplearning4j_torch.parallel import (MultiHostTrainer,
                                               ProcessShardIterator)

    it = ProcessShardIterator(x, y, gb)
    a = MultiHostTrainer(build(js, params), mesh=_mesh())
    a.fit(it, epochs=2)
    orbax_io.save_trainer(path, a)
    b = MultiHostTrainer(build(js, params), mesh=_mesh(), seed=999)
    b.restore(path)
    iteration = b.iteration
    b.fit(it, epochs=2)
    c = MultiHostTrainer(build(js, params), mesh=_mesh())
    c.fit(it, epochs=4)
    return dict(equal=_equal(b.params, c.params)
                and _equal(b.opt_state, c.opt_state),
                iteration=iteration, params=np_tree(b.params))


def rules_resume(js, params, batches, path, axes, rules):
    """Trainer(mesh=, rules=) over ``axes``: one epoch, save_trainer, a
    fresh trainer restored (each rank its own shards), one more epoch on
    both. Whether the restore and the continuation are bit-equal, and
    this rank's param shapes."""
    import deeplearning4j_torch.parallel.sharding as S
    from deeplearning4j_torch.train import Trainer

    rules = getattr(S, rules)
    mesh = _mesh(axes)
    a = Trainer(build(js, params), mesh=mesh, rules=rules)
    a.fit(Batches(batches), epochs=1, prefetch=False)
    orbax_io.save_trainer(path, a)
    b = Trainer(build(js, params), mesh=mesh, rules=rules, seed=5)
    orbax_io.restore_trainer(path, b)
    restored = _equal(a.params, b.params) and _equal(a.opt_state, b.opt_state)
    a.fit(Batches(batches), epochs=1, prefetch=False)
    b.fit(Batches(batches), epochs=1, prefetch=False)
    return dict(restored=restored,
                continued=_equal(a.params, b.params),
                shapes=[tuple(t.shape) for t in tree_leaves(b.params)])
