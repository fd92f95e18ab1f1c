"""The port's early stopping (``deeplearning4j_torch/train/earlystopping.py``)
and the listeners ported with it, held against the JAX package.

From the same params (the reference's, carried across) and the same data,
``EarlyStoppingTrainer`` gives the reference's termination reason and
details, best epoch, epoch count and score by epoch (scores within 1e-5
relative), for each score calculator that the two packages compute the
same way; the best model kept by either saver is the best epoch's. The
VAE's scores draw noise from each package's own generator, so they are
held to being repeatable, not to the reference's values.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CheckpointListener,
                                        CollectScoresListener,
                                        EvaluativeListener,
                                        SleepyTrainingListener,
                                        TimeIterationListener, Trainer,
                                        load_model, params_from_numpy)
from deeplearning4j_torch.train import earlystopping as TES
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.train import earlystopping as JES
from deeplearning4j_tpu.train import serialization as JS
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

SCORE_TOL = 1e-5


def _mlp(L, S, NC, out="softmax", loss="mcxent", n_out=3, lr=0.3, **kw):
    return S(NC(seed=0, updater={"type": "nesterovs", "learning_rate": lr,
                                 "momentum": 0.9}), [
        L.Dense(n_out=16, activation="tanh"),
        L.Dense(n_out=16, activation="tanh"),
        L.Output(n_out=n_out, activation=out, loss=loss)], (6,), **kw)


def _data(seed, n, n_out=3, regression=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    if regression:
        return x, (x[:, :n_out] * 0.5 + 0.1 * rng.standard_normal(
            (n, n_out))).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[
        (x[:, 0] + 0.7 * rng.standard_normal(n) > 0).astype(int)
        + (x[:, 1] > 1).astype(int)]
    return x, y


def _both(**kw):
    jm = _mlp(JL, JSequential, JNetConfig, **kw)
    jp, _ = jm.init()
    tm = _mlp(TL, Sequential, NetConfig, device="cpu", **kw)
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jp))
    tm.state = {}
    return jm, tm


CALCULATORS = {
    "loss": ("DataSetLossCalculator", {}, {}),
    "classification": ("ClassificationScoreCalculator", {}, {}),
    "roc": ("ROCScoreCalculator", {"num_classes": 3}, {}),
    "regression_mse": ("RegressionScoreCalculator", {"metric": "mse"},
                       dict(out="identity", loss="mse", lr=0.01)),
    "regression_r2": ("RegressionScoreCalculator", {"metric": "r2"},
                      dict(out="identity", loss="mse", lr=0.01)),
}


def _run(pkg, model, calc, ckw, epoch_terms, iter_terms, regression, saver,
         nan_at=None):
    ES, It, T = ((JES, JArrayIterator, JTrainer) if pkg == "jax"
                 else (TES, ArrayIterator, Trainer))
    n_out = 3
    xtr, ytr = _data(0, 96, n_out, regression)
    if nan_at is not None:  # a corrupt example: that batch's loss is NaN
        xtr[nan_at, 2] = np.nan
    xva, yva = _data(1, 48, n_out, regression)
    cfg = ES.EarlyStoppingConfiguration(
        score_calculator=getattr(ES, calc)(It(xva, yva, batch_size=16),
                                           **ckw),
        epoch_terminations=[getattr(ES, n)(*a) for n, a in epoch_terms],
        iteration_terminations=[getattr(ES, n)(*a) for n, a in iter_terms],
        model_saver=saver)
    trainer = T(model)
    kw = {} if pkg == "jax" else {}
    res = ES.EarlyStoppingTrainer(cfg, trainer).fit(
        It(xtr, ytr, batch_size=16), max_epochs=8, **kw)
    return res, trainer, cfg.model_saver


def _same_result(tr, jr):
    assert (tr.termination_reason, tr.termination_details, tr.best_epoch,
            tr.total_epochs) == (jr.termination_reason,
                                 jr.termination_details, jr.best_epoch,
                                 jr.total_epochs)
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e in jr.score_vs_epoch:
        np.testing.assert_allclose(tr.score_vs_epoch[e], jr.score_vs_epoch[e],
                                   rtol=SCORE_TOL, atol=1e-7)
    np.testing.assert_allclose(tr.best_score, jr.best_score, rtol=SCORE_TOL,
                               atol=1e-7)


@pytest.mark.parametrize("calc", sorted(CALCULATORS))
def test_early_stopping_matches_reference(calc):
    name, ckw, mkw = CALCULATORS[calc]
    jm, tm = _both(**mkw)
    reg = "out" in mkw
    terms = [("MaxEpochsTermination", (6,)),
             ("ScoreImprovementEpochTermination", (1,))]
    guards = [("InvalidScoreIterationTermination", ())]
    jr, _, _ = _run("jax", jm, name, ckw, terms, guards, reg,
                    JES.InMemoryModelSaver())
    tr, tt, saver = _run("torch", tm, name, ckw, terms, guards, reg,
                         TES.InMemoryModelSaver())
    _same_result(tr, jr)
    best_params, _, best = saver.get_best()
    assert best == tr.best_score
    if tr.best_epoch != tr.total_epochs - 1:  # the saved copy is not live
        assert any(not torch.equal(a, b) for a, b in zip(
            tree_leaves(best_params), tree_leaves(tt.params)))


@pytest.mark.parametrize("case", ["best_score", "max_score", "invalid"])
def test_terminations_match_reference(case, tmp_path):
    jm, tm = _both()
    terms = [("MaxEpochsTermination", (8,))]
    guards = []
    if case == "best_score":
        terms.append(("BestScoreEpochTermination", (0.9,)))
    elif case == "max_score":
        guards.append(("MaxScoreIterationTermination", (0.5,)))
    else:
        guards.append(("InvalidScoreIterationTermination", ()))
        guards.append(("MaxScoreIterationTermination", (1e6,)))
    nan_at = 40 if case == "invalid" else None
    jr, _, _ = _run("jax", jm, "DataSetLossCalculator", {}, terms, guards,
                    False, JES.LocalFileModelSaver(str(tmp_path / "j")),
                    nan_at)
    tr, tt, saver = _run("torch", tm, "DataSetLossCalculator", {}, terms,
                         guards, False,
                         TES.LocalFileModelSaver(str(tmp_path / "t")),
                         nan_at)
    if case != "best_score":
        assert tr.termination_reason == "IterationTermination"
    _same_result(tr, jr)
    if tr.best_epoch >= 0:
        model, params, _ = saver.get_best()
        _, jparams, _, _, _ = JS.load_model(str(tmp_path / "t" /
                                                "bestModel.zip"))
        for a, b in zip(tree_leaves(params),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ae_model(L, S, NC, **kw):
    return S(NC(seed=0, updater={"type": "adam", "learning_rate": 1e-2}), [
        L.Dense(n_out=8, activation="tanh"),
        L.AutoEncoder(n_out=4, activation="sigmoid"),
        L.Output(n_out=3, activation="softmax")], (6,), **kw)


def test_autoencoder_score_matches_reference():
    jm = _ae_model(JL, JSequential, JNetConfig)
    jp, _ = jm.init()
    tm = _ae_model(TL, Sequential, NetConfig, device="cpu")
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jp))
    tm.state = {}
    x, y = _data(3, 32)
    js = JES.AutoencoderScoreCalculator(JArrayIterator(x, y, batch_size=8))
    ts = TES.AutoencoderScoreCalculator(ArrayIterator(x, y, batch_size=8))
    np.testing.assert_allclose(ts.score(Trainer(tm)), js.score(JTrainer(jm)),
                               rtol=SCORE_TOL)


def test_vae_scores_are_repeatable():
    m = Sequential(NetConfig(seed=0), [
        TL.VAE(n_out=3, encoder_sizes=(8,), decoder_sizes=(8,)),
        TL.Output(n_out=2, activation="softmax")], (6,), device="cpu")
    m.init()
    x, _ = _data(4, 16)
    y = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    t = Trainer(m)
    for cls in ("VAEReconErrorScoreCalculator",
                "VAEReconProbScoreCalculator"):
        calc = getattr(TES, cls)(ArrayIterator(x, y, batch_size=8))
        a, b = calc.score(t), calc.score(t)
        assert a == b and np.isfinite(a)


def test_iteration_guard_syncs_only_with_conditions():
    assert not TES._IterationGuard([]).requires_sync
    assert TES._IterationGuard(
        [TES.InvalidScoreIterationTermination()]).requires_sync


def test_listeners(tmp_path):
    _, tm = _both()
    x, y = _data(0, 64)
    logs = []
    ev = EvaluativeListener(ArrayIterator(x, y, batch_size=16),
                            log_fn=logs.append)
    ev_it = EvaluativeListener(ArrayIterator(x, y, batch_size=16),
                               frequency=2, invocation="iteration",
                               log_fn=logs.append)
    ck = CheckpointListener(str(tmp_path), every_n_iterations=3,
                            every_n_epochs=1, keep_last=2)
    tl = TimeIterationListener(8, frequency=2, log_fn=logs.append)
    rec = CollectScoresListener()
    t = Trainer(tm).fit(ArrayIterator(x, y, batch_size=16), epochs=2,
                        listeners=[ev, ev_it, ck, tl, rec,
                                   SleepyTrainingListener(1.0)])
    assert len(rec.scores) == 8
    assert ev.last_evaluation.num_examples == 64
    assert ev_it.snapshots_state and ck.snapshots_state
    assert sum("eval accuracy" in s for s in logs) == 2 + 3
    assert sum("ETA" in s for s in logs) == 3
    assert len(ck.saved) == 2 and all(os.path.exists(p) for p in ck.saved)
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in ck.saved)
    # the last checkpoint (epoch 2) is the trained model, and the
    # reference loads it
    model, params, _ = load_model(ck.saved[-1], device="cpu")
    _, jparams, _, _, _ = JS.load_model(ck.saved[-1])
    for a, b, c in zip(tree_leaves(params), tree_leaves(t.params),
                       jax.tree_util.tree_leaves(jparams)):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(c))
