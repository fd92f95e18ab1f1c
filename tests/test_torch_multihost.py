"""The port's multi-process training (``deeplearning4j_torch/parallel/
multihost.py``: ``ProcessShardIterator``, ``MultiHostTrainer`` in both
modes, save, restore and resume) and ``EarlyStoppingParallelTrainer``
held against the JAX package's.

The port runs in spawned gloo ranks through the port's own group helper
(``RankGroup``; cases in ``torch_parallel_ranks.py``, which imports no
JAX), one process a rank fed its ``ProcessShardIterator`` shards. The
reference runs here: its ``MultiHostTrainer`` over ``cpu_test_mesh(n)``
in one process, fed the whole global batches (one process's shard), which
is the same global step.

Tolerances: params and losses ``rtol=1e-5, atol=1e-6`` (the reference's
multi-process test's), scores ``rtol=1e-5``, confusion matrices and
early-stopping decisions exact; a resumed run equals an unbroken one
within ``rtol=1e-6, atol=1e-7``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from deeplearning4j_torch.parallel import (ProcessShardIterator,
                                           RankGroup)
from deeplearning4j_tpu.nn import NetConfig, SequentialBuilder
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.parallel import MultiHostTrainer as JMH
from deeplearning4j_tpu.parallel import ProcessShardIterator as JPSI
from deeplearning4j_tpu.parallel import cpu_test_mesh
from deeplearning4j_tpu.train import earlystopping as JES
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollect

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    groups = {}

    def get(n):
        if n not in groups:
            groups[n] = RankGroup(n, str(tmp_path_factory.mktemp(f"g{n}")))
        return groups[n]

    yield get
    for g in groups.values():
        g.close()


def make_data(n=64, seed=42):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    w = rng.randn(6, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def build_net(updater="nesterovs", lr=5e-2):
    upd = {"type": updater, "learning_rate": lr}
    if updater == "nesterovs":
        upd["momentum"] = 0.9
    return (SequentialBuilder(NetConfig(seed=7, updater=upd))
            .input_shape(6)
            .layer(L.Dense(n_out=16, activation="tanh"))
            .layer(L.Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())


def carry(net):
    net.init()
    return net.to_json(), jax.tree.map(np.asarray, net.params)


def fresh(net, params):
    net.params = jax.tree.map(lambda a: jnp.array(np.array(a)), params)
    net.state = {}
    return net


class It:
    """Fixed global batches for the reference's wrapper."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        from deeplearning4j_tpu.data.iterators import DataSet

        return iter([DataSet(*b) for b in self.batches])

    def reset(self):
        pass


def tree_close(got, want, rtol=RTOL, atol=ATOL):
    for k in want:
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], np.asarray(want[k][kk]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{k}/{kk}")


@pytest.mark.parametrize("pid,nproc", [(0, 2), (1, 2), (3, 4)])
def test_process_shard_iterator_matches_reference(pid, nproc):
    x, y = make_data(70)
    lm = (np.arange(70 * 3).reshape(70, 3) % 2).astype(np.float32)
    a = ProcessShardIterator(x, y, 16, process_id=pid, num_processes=nproc,
                             labels_mask=lm)
    b = JPSI(x, y, 16, process_id=pid, num_processes=nproc, labels_mask=lm)
    got, want = list(a), list(b)
    assert len(got) == len(want) == 4 and a.local_b == b.local_b
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.labels_mask, w.labels_mask)
        assert g.features_mask is None and w.features_mask is None
    with pytest.raises(ValueError, match="not divisible"):
        ProcessShardIterator(x, y, 15, process_id=0, num_processes=2)


def _jax_run(n, params, gb, epochs, mode="shared_gradients", kw=None):
    x, y = make_data()
    mh = JMH(fresh(build_net(), params), mesh=cpu_test_mesh(n), mode=mode,
             **(kw or {}))
    it = JPSI(x, y, gb, process_id=0, num_processes=1)
    col = JCollect()
    mh.fit(it, epochs=epochs, listeners=[col])
    return mh, it, np.asarray([s for _, s in col.scores])


@pytest.mark.parametrize("n,mode,kw", [
    (2, "shared_gradients", {}),
    (4, "shared_gradients", {}),
    (2, "shared_gradients", {"grad_accum": 2}),
    (4, "encoded_gradients",
     {"threshold": 0.0, "capacity_frac": 1.0, "quantize": False}),
    (2, "encoded_gradients", {"threshold": 1e-3, "capacity_frac": 0.5}),
], ids=["shared-2", "shared-4", "accum-2", "encoded-dense-4",
        "encoded-quantized-2"])
def test_multihost_matches_reference(ranks, n, mode, kw):
    """3 epochs of 4 global batches of 16, each rank fed its shard:
    params, rank 0's losses, the distributed score and the merged
    evaluation against the reference's over ``n`` devices."""
    x, y = make_data()
    js, p0 = carry(build_net())
    mh, it, wloss = _jax_run(n, p0, 16, 3, mode, kw)
    got = ranks(n).run(R.multihost_fit, js, p0, x, y, 16, 3, mode, kw)
    tree_close(got["params"], jax.tree.map(np.asarray, mh.model.params))
    np.testing.assert_allclose(got["losses"], wloss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["score"], mh.score_iterator(it),
                               rtol=1e-5)
    conf = mh.evaluate(it).confusion
    np.testing.assert_array_equal(got["confusion"], conf)
    assert got["confusion"].sum() == 64 and got["shard"] == (0, n)


def test_multihost_masked_rnn_equals_reference(ranks):
    """A label-masked recurrent batch whose shards carry different mask
    mass: the global step is the reference's (reduction by loss mass)."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 6, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (16, 6))]
    lm = np.zeros((16, 6), np.float32)
    for i in range(16):
        lm[i, : 1 + i % 6] = 1.0

    def net():
        return (SequentialBuilder(NetConfig(seed=0, updater={
            "type": "nesterovs", "learning_rate": 5e-2, "momentum": 0.9}))
                .input_shape(6, 4).layer(L.LSTM(n_out=8))
                .layer(L.RnnOutput(n_out=3, activation="softmax",
                                   loss="mcxent")).build())

    jn = net()
    jn.init()
    js, p0 = jn.to_json(), jax.tree.map(np.asarray, jn.params)
    mh = JMH(fresh(net(), p0), mesh=cpu_test_mesh(4))
    it = JPSI(x, y, 16, process_id=0, num_processes=1, labels_mask=lm)
    col = JCollect()
    mh.fit(it, epochs=2, listeners=[col])
    got = ranks(4).run(R.multihost_fit, js, p0, x, y, 16, 2, lm=lm)
    tree_close(got["params"], jax.tree.map(np.asarray, mh.model.params))
    np.testing.assert_allclose(got["losses"], [s for _, s in col.scores],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["score"], mh.score_iterator(it),
                               rtol=1e-5)


def test_save_restore_resume_equals_unbroken(ranks, tmp_path):
    """2 epochs, a collective save, a fresh trainer (another seed)
    restored from the zip, 2 more epochs: the unbroken 4-epoch run's
    params; and the reference's 4-epoch run's."""
    x, y = make_data()
    js, p0 = carry(build_net())
    got = ranks(2).run(R.multihost_resume, js, p0, x, y, 16,
                       str(tmp_path / "mh.zip"))
    tree_close(got["resumed"], got["unbroken"], rtol=1e-6, atol=1e-7)
    mh, _, _ = _jax_run(2, p0, 16, 4)
    tree_close(got["resumed"], jax.tree.map(np.asarray, mh.model.params))


def _jax_early_stopping(p0, trainer, train_it, val_it):
    cfg = JES.EarlyStoppingConfiguration(
        score_calculator=JES.DataSetLossCalculator(val_it),
        epoch_terminations=[JES.MaxEpochsTermination(12),
                            JES.ScoreImprovementEpochTermination(2)],
        iteration_terminations=[JES.InvalidScoreIterationTermination()],
        model_saver=JES.InMemoryModelSaver())
    res = JES.EarlyStoppingParallelTrainer(cfg, trainer).fit(train_it)
    return res, cfg.model_saver.get_best()


@pytest.mark.parametrize("which", ["wrapper", "multihost"])
def test_early_stopping_parallel_matches_reference(ranks, tmp_path, which):
    """EarlyStoppingParallelTrainer over ParallelWrapper and over
    MultiHostTrainer on 2 ranks: the reference's termination, best epoch,
    best score and scores by epoch, and the best model it kept (a file
    saver on the port's side: the collective save)."""
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW

    x, y = make_data(96, seed=1)
    xv, yv = make_data(32, seed=2)
    js, p0 = carry(build_net(lr=0.3))
    net = fresh(build_net(lr=0.3), p0)
    if which == "wrapper":
        trainer = JPW(net, mesh=cpu_test_mesh(2))
        train = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 96, 32)]
        val = [(xv, yv)]
        res, best = _jax_early_stopping(p0, trainer, It(train), It(val))
    else:
        trainer = JMH(net, mesh=cpu_test_mesh(2))
        train, val = (x, y, 32), (xv, yv, 16)
        res, best = _jax_early_stopping(
            p0, trainer, JPSI(*train, process_id=0, num_processes=1),
            JPSI(*val, process_id=0, num_processes=1))
    got = ranks(2).run(R.early_stopping, js, p0, train, val, which, 12, 2,
                       str(tmp_path / "best"))
    assert (got["reason"], got["best_epoch"], got["total_epochs"]) == \
        (res.termination_reason, res.best_epoch, res.total_epochs)
    assert got["details"] == res.termination_details
    assert sorted(got["scores"]) == sorted(res.score_vs_epoch)
    for e, s in res.score_vs_epoch.items():
        np.testing.assert_allclose(got["scores"][e], s, rtol=1e-5)
    np.testing.assert_allclose(got["best_score"], res.best_score, rtol=1e-5)
    tree_close(got["best_params"], jax.tree.map(np.asarray, best[0]))


def test_multihost_rejections(ranks):
    js, p0 = carry(build_net())
    for mode, kw, match in (("encoded_gradients", {"grad_accum": 2},
                             "grad_accum"),
                            ("averaging", {}, "Unknown mode")):
        with pytest.raises(ValueError, match=match):
            JMH(fresh(build_net(), p0), mesh=cpu_test_mesh(2), mode=mode,
                **kw)
    err = ranks(2).run(R.multihost_rejects, js, p0)
    assert err == [("ValueError", "grad_accum"),
                   ("ValueError", "Unknown mode"),
                   ("ValueError", "rules"),
                   ("FileNotFoundError", "no checkpoint")]
