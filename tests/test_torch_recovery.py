"""The port's training recovery (deeplearning4j_torch/chaos/recovery.py,
``train.faults``) against the JAX package's: a poisoned batch (a NaN in
the features) gives a NaN loss at the same iteration in both, and
``DivergenceListener(action="rollback")`` restores the same snapshot and
scales the learning rate alike, so the loss trajectories and the final
params agree within 1e-5; the raise path and the rollback limit alike; a
``FaultTolerantFit`` preempted at the ``train.segment`` seam resumes from
its checkpoint bit-equal to an uninterrupted run, and its zip (updater
state of the chained, post-rollback structure included) loads in the JAX
package.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.chaos import faults as tfaults
from deeplearning4j_torch.data import ArrayIterator
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener,
                                        DivergenceListener,
                                        FaultTolerantFit, Trainer,
                                        TrainingDivergedException,
                                        load_opt_state, params_from_numpy)
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.train.faults import \
    DivergenceListener as JDivergenceListener
from deeplearning4j_tpu.train.faults import \
    TrainingDivergedException as JTrainingDivergedException
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.serialization import load_model as jload_model
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

TRAJ_RTOL = 1e-5
B = 4


def _net(mod):
    layers = [mod.Dense(n_out=8, activation="tanh"),
              mod.Output(n_out=3, activation="softmax", loss="mcxent")]
    cfg = dict(seed=1, updater={"type": "adamw", "learning_rate": 5e-2})
    if mod is JL:
        return JSequential(JNetConfig(**cfg), layers, (4,))
    return Sequential(NetConfig(**cfg), layers, (4,), device="cpu")


def _data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    bad = x.copy()
    bad[2 * B + 1, 3] = np.nan                   # poisons the third batch
    return x, y, bad


def _pair():
    jm = _net(JL)
    jm.init()
    tm = _net(TL)
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    return jm, tm


def _rollback_run(side):
    """One clean epoch, one epoch whose third batch is poisoned, one clean
    epoch, under a rollback listener (snapshot every iteration). Returns
    the scores, the listener and the final params."""
    x, y, bad = _data()
    jm, tm = _pair()
    lst = (JDivergenceListener if side == "jax" else DivergenceListener)(
        action="rollback", snapshot_every=1, max_rollbacks=2,
        lr_backoff=0.5)
    if side == "jax":
        rec, tr, It = JCollectScoresListener(), JTrainer(jm), JArrayIterator
        kw = {"prefetch": False}
    else:
        rec, tr, It = CollectScoresListener(), Trainer(tm), ArrayIterator
        kw = {}
    for feats in (x, bad, x):
        tr.fit(It(feats, y, batch_size=B), epochs=1, listeners=[lst, rec],
               **kw)
    params = [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
              for a in (tree_leaves(tr.params) if side == "port"
                        else jax.tree_util.tree_leaves(tr.params))]
    return [s for _, s in rec.scores], lst, params, tr


def test_rollback_matches_reference():
    jscores, jlst, jparams, _ = _rollback_run("jax")
    tscores, tlst, tparams, tt = _rollback_run("port")
    assert len(tscores) == len(jscores) == 12
    jnan = [i for i, s in enumerate(jscores) if not math.isfinite(s)]
    tnan = [i for i, s in enumerate(tscores) if not math.isfinite(s)]
    assert tnan == jnan == [6]                   # the poisoned batch
    finite = [i for i in range(12) if i not in jnan]
    np.testing.assert_allclose([tscores[i] for i in finite],
                               [jscores[i] for i in finite], rtol=TRAJ_RTOL)
    assert (tlst.rollbacks, tlst.lr_scale) == (jlst.rollbacks,
                                               jlst.lr_scale) == (1, 0.5)
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=1e-6)
    assert all(np.isfinite(p).all() for p in tparams)
    # the updater state took the scale stage's (empty) state, as optax's
    assert tlst._base_tx is not None
    assert len(tt.opt_state) == 2 and tt.opt_state[1] == ()


def test_rollback_restores_the_validated_snapshot():
    """The params restored are the ones captured two iterations before the
    NaN (the capture at the poisoned iteration's predecessor is validated
    only by a later finite loss), and the trainer's own tensors are
    written in place."""
    x, y, _ = _data()
    _, tm = _pair()
    tr = Trainer(tm)
    lst = DivergenceListener(action="rollback", snapshot_every=1)
    tr.fit(ArrayIterator(x, y, batch_size=B), epochs=1, listeners=[lst])
    snap = [t.clone() for t in tree_leaves(lst._snap[0])]
    leaves = tree_leaves(tr.params)
    with torch.no_grad():
        for p in leaves:
            p.mul_(float("nan"))
    lst.iteration_done(tr, 99, 0, float("nan"))
    assert all(a is b for a, b in zip(tree_leaves(tr.params), leaves))
    for got, want in zip(tree_leaves(tr.params), snap):
        assert torch.equal(got.detach(), want)
    assert tree_leaves(tr.params)[0].requires_grad


def test_raise_path_and_rollback_limit_alike():
    x, y, bad = _data()
    out = {}
    for side in ("jax", "port"):
        jm, tm = _pair()
        if side == "jax":
            tr, It, L, E = JTrainer(jm), JArrayIterator, \
                JDivergenceListener, JTrainingDivergedException
            kw = {"prefetch": False}
        else:
            tr, It, L, E = Trainer(tm), ArrayIterator, DivergenceListener, \
                TrainingDivergedException
            kw = {}
        msgs = []
        with pytest.raises(E) as ei:
            tr.fit(It(bad, y, batch_size=B), epochs=1,
                   listeners=[L(action="raise")], **kw)
        msgs.append(str(ei.value))
        lst = L(action="rollback", snapshot_every=1, max_rollbacks=1)
        with pytest.raises(E) as ei:
            tr2 = JTrainer(_pair()[0]) if side == "jax" else Trainer(
                _pair()[1])
            tr2.fit(It(x, y, batch_size=B), epochs=1, listeners=[lst], **kw)
            for _ in range(2):
                tr2.fit(It(bad, y, batch_size=B), epochs=1, listeners=[lst],
                        **kw)
        msgs.append(str(ei.value))
        out[side] = (msgs, lst.rollbacks, lst.lr_scale)
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError):
        DivergenceListener(action="ignore")


def test_preempted_fit_resumes_bit_equal(tmp_path):
    """Three one-epoch segments; a ``train.segment`` fault preempts the run
    after segment 2, before its checkpoint lands. A fresh trainer resumes
    from segment 1's checkpoint and finishes: its params and updater state
    equal an uninterrupted run's bit for bit."""
    x, y, _ = _data()
    _, tm = _pair()
    base = Trainer(tm)
    base.fit(ArrayIterator(x, y, batch_size=B), epochs=3)
    want = [t.detach().clone() for t in tree_leaves((base.params,
                                                     base.opt_state))]

    d = str(tmp_path / "ckpt")
    plane = tfaults.install(tfaults.FaultPlane(seed=0))
    try:
        plane.inject_spec("train.segment:error:type=runtime,scope=2,times=1")
        first = FaultTolerantFit(Trainer(_pair()[1]), d, segment_epochs=1)
        with pytest.raises(RuntimeError, match="train.segment"):
            first.fit(ArrayIterator(x, y, batch_size=B), epochs=3)
    finally:
        tfaults.uninstall()
    assert first.completed_epochs() == 1
    resumed = FaultTolerantFit(Trainer(_pair()[1]), d, segment_epochs=1)
    tr = resumed.fit(ArrayIterator(x, y, batch_size=B), epochs=3)
    assert resumed.completed_epochs() == 3
    got = tree_leaves((tr.params, tr.opt_state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)
    with open(os.path.join(d, "progress.json")) as f:
        assert json.load(f) == {"completed_epochs": 3}


def test_chained_opt_state_zip_roundtrips_across_packages(tmp_path):
    """After a rollback the updater state is (inner, scale's empty state):
    the checkpoint zip carries its leaves, the port reloads it with the
    chained template and the JAX package with its own chained optax
    template, params and updater state equal."""
    import optax

    x, y, bad = _data()
    _, tm = _pair()
    tr = Trainer(tm)
    lst = DivergenceListener(action="rollback", snapshot_every=1)
    tr.fit(ArrayIterator(x, y, batch_size=B), epochs=1, listeners=[lst])
    tr.fit(ArrayIterator(bad, y, batch_size=B), epochs=1, listeners=[lst])
    assert lst.rollbacks == 1
    path = str(tmp_path / "m.zip")
    tr.save(path)
    back = load_opt_state(path, tr.opt_state)
    for a, b in zip(tree_leaves(back), tree_leaves(tr.opt_state)):
        assert torch.equal(a, b)
    jm = _net(JL)
    jm.init()
    jt = JTrainer(jm)
    template = (jt.opt_state, optax.scale(1.0).init(jt.params))
    _, params, _, opt_state, _ = jload_model(path, opt_state_template=template)
    for a, b in zip(jax.tree_util.tree_leaves(opt_state),
                    tree_leaves(tr.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    tree_leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
