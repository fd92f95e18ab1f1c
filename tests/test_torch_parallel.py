"""The port's data parallelism (``deeplearning4j_torch/parallel``:
``ParallelWrapper`` in its four modes, ``ParallelInference``,
``Trainer(mesh=)`` and ``StepTelemetry.parallel_step``) held against the
JAX package's over a mesh of the same size.

The JAX side runs here over ``cpu_test_mesh(n)``; the port runs in ``n``
spawned gloo ranks (``RankGroup``, one group of 2 and one of 4 for the
whole file, rank ``r`` standing for device ``r``), whose cases live in
``torch_parallel_ranks.py`` (no JAX there). Inputs come from numpy
seeds; params are the reference's, carried across through the model's
JSON and ``params_from_numpy``.

Tolerances: params and losses within the reference's own test tolerance
``rtol=1e-4, atol=1e-5`` (the sync modes reduce in another order than
GSPMD; the encoded modes pick the same entries). The ragged flash BERT
keeps the reference test's band (``rtol=6e-3, atol=3e-4``: AdamW
amplifies reduction-order noise on near-zero gradients). Scores within
``rtol=1e-5``, confusion matrices exact.
"""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from deeplearning4j_torch.parallel import RankGroup
from deeplearning4j_tpu.data import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.data.datasets import load_iris
from deeplearning4j_tpu.data.iterators import DataSet as JDataSet
from deeplearning4j_tpu.nn import NetConfig, SequentialBuilder
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import cpu_test_mesh
from deeplearning4j_tpu.train import Trainer as JTrainer
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollect

RTOL, ATOL = 1e-4, 1e-5


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


@pytest.fixture(scope="module")
def iris():
    return load_iris()


def iris_net(seed=0, lr=0.1, updater="sgd", act="tanh", n_in=4):
    return (SequentialBuilder(NetConfig(seed=seed, updater={
        "type": updater, "learning_rate": lr}))
            .input_shape(n_in)
            .layer(L.Dense(n_out=16, activation=act))
            .layer(L.Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())


def seq_net():
    return (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "adam", "learning_rate": 1e-2}))
            .input_shape(6, 4)
            .layer(L.LSTM(n_out=8))
            .layer(L.RnnOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())


def carry(net):
    """(JSON, numpy params) of an initialized JAX net."""
    if net.params is None:
        net.init()
    return net.to_json(), jax.tree.map(np.asarray, net.params)


def fresh(net, params):
    """``net`` with fresh copies of ``params`` (the JAX trainers donate
    their buffers)."""
    net.params = jax.tree.map(lambda a: jnp.array(np.array(a)), params)
    net.state = {}
    return net


class It:
    """Fixed global batches for the JAX side."""

    def __init__(self, batches):
        self.batches = [tuple(b) + (None,) * (4 - len(b)) for b in batches]

    def __iter__(self):
        return iter([JDataSet(*b) for b in self.batches])

    def reset(self):
        pass


def jax_fit(net, params, batches, epochs, mesh_n, **kw):
    pw = JPW(fresh(net, params), mesh=cpu_test_mesh(mesh_n), **kw)
    col = JCollect()
    pw.fit(It(batches), epochs=epochs, listeners=[col])
    pw._sync_model()
    return (jax.tree.map(np.asarray, pw.model.params),
            np.asarray([s for _, s in col.scores]))


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], rtol, atol, f"{what}{k}/")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what}{k}")


# ------------------------------------------------------------ the modes
MODES = [  # (mode, world, updater, wrapper kwargs)
    ("shared_gradients", 2, "sgd", {}),
    ("shared_gradients", 4, "sgd", {}),
    ("zero_sharded", 4, "nesterovs", {}),
    ("averaging", 4, "sgd", {"averaging_frequency": 1}),
    ("averaging", 2, "nesterovs", {"averaging_frequency": 2}),
    ("encoded_gradients", 4, "sgd",
     {"threshold": 0.0, "capacity_frac": 1.0, "quantize": False}),
    ("encoded_gradients", 2, "sgd",
     {"threshold": 5e-3, "capacity_frac": 0.5, "quantize": True}),
]


@pytest.mark.parametrize("mode,n,updater,kw", MODES,
                         ids=[f"{m[0]}-{m[1]}-{m[2]}" for m in MODES])
def test_mode_matches_reference(ranks, iris, mode, n, updater, kw):
    """Each mode, 3 epochs of one global batch of 96 iris rows, against
    the reference wrapper over a mesh of ``n``: params and losses."""
    x, y = iris[0][:96], iris[1][:96]
    lr = 5e-2 if updater == "nesterovs" else 0.1
    js, p0 = carry(iris_net(updater=updater, lr=lr))
    want, wloss = jax_fit(iris_net(updater=updater, lr=lr), p0, [(x, y)], 3,
                          n, mode=mode, **kw)
    got = ranks(n).run(R.wrapper_fit, js, p0, [(x, y)], 3, mode, kw)
    assert_tree_close(got["params"], want)
    np.testing.assert_allclose(got["losses"], wloss, rtol=RTOL, atol=ATOL)
    if mode == "zero_sharded":  # the updater state is held in shards
        full = [tuple(a.shape) for a in jax.tree.leaves(p0)]
        assert any(s not in full and len(s) for s in got["opt_shapes"]), \
            got["opt_shapes"]


def test_zero_sharded_adam_equals_shared_gradients(ranks, iris):
    """ZeRO-1 is a placement change: adam on shards of each leaf gives the
    shared_gradients run's params bit for bit, with the moments held in
    shards. (Against the reference adam is left to momentum updaters:
    adam's m/sqrt(v) turns the sync modes' reduction-order noise on
    near-zero gradients into 1e-3 relative differences.)"""
    x, y = iris[0][:96], iris[1][:96]
    js, p0 = carry(iris_net(updater="adam", lr=5e-2, act="relu"))
    got = {mode: ranks(4).run(R.wrapper_fit, js, p0, [(x, y)], 3, mode)
           for mode in ("shared_gradients", "zero_sharded")}
    a, b = got["shared_gradients"], got["zero_sharded"]
    for k in a["params"]:
        for kk in a["params"][k]:
            np.testing.assert_array_equal(b["params"][k][kk],
                                          a["params"][k][kk])
    assert len(b["opt_shapes"]) == len(a["opt_shapes"])
    assert sum(np.prod(s) for s in b["opt_shapes"]) < \
        sum(np.prod(s) for s in a["opt_shapes"])


def test_sync_modes_equal_single_device(ranks, iris):
    """shared_gradients and averaging_frequency=1 over 4 ranks are the
    single-device trainer's steps (sgd: the mean of per-replica steps is
    the step on the mean gradient)."""
    x, y = iris[0][:96], iris[1][:96]
    js, p0 = carry(iris_net())
    tr = JTrainer(fresh(iris_net(), p0))
    tr.fit(JArrayIterator(x, y, 96), epochs=2, prefetch=False)
    want = jax.tree.map(np.asarray, tr.params)
    for mode, kw in (("shared_gradients", {}),
                     ("averaging", {"averaging_frequency": 1})):
        got = ranks(4).run(R.wrapper_fit, js, p0, [(x, y)], 2, mode, kw)
        assert_tree_close(got["params"], want, what=mode + ":")


def test_encoded_quantized_trains(ranks, iris):
    """ND4J's quantized messages still learn over 80 steps (the
    reference's case): loss down by 10%, the residual active."""
    x, y = iris[0][:96], iris[1][:96]
    js, p0 = carry(iris_net())
    got = ranks(4).run(R.wrapper_fit, js, p0, [(x, y)], 80,
                       "encoded_gradients",
                       {"threshold": 5e-3, "capacity_frac": 0.5})
    assert got["residual"] > 0
    assert got["losses"][-3:].mean() < got["losses"][:3].mean() * 0.9


@pytest.mark.parametrize("mode,kw,match", [
    ("encoded_gradients", {"threshold": 0.0, "quantize": True}, "threshold"),
    ("shared_gradients", {"staleness": 1}, "staleness"),
    ("encoded_gradients", {"staleness": 2}, "staleness"),
    ("averaging", {"grad_accum": 2}, "grad_accum"),
    ("bogus", {}, "Unknown mode"),
])
def test_constructor_rejections(ranks, mode, kw, match):
    js, p0 = carry(iris_net())
    with pytest.raises(ValueError, match=match):
        JPW(fresh(iris_net(), p0), mesh=cpu_test_mesh(2), mode=mode, **kw)
    err = ranks(2).run(R.wrapper_rejects, js, p0, mode, kw)
    assert err is not None and err[0] == "ValueError" and match in err[1]


def test_rules_name_item_19(ranks):
    """rules= was refused, naming its queue item, until tensor and
    sequence parallelism were ported: now the sync modes take a rule table
    and the replica modes refuse one, as the reference's do."""
    js, p0 = carry(iris_net())
    assert ranks(2).run(R.wrapper_rejects, js, p0, "shared_gradients",
                        {"rules": [(".*", ())]}) is None
    err = ranks(2).run(R.wrapper_rejects, js, p0, "averaging",
                       {"rules": [(".*", ())]})
    assert err[0] == "ValueError" and "rules" in err[1]


def test_shared_gradients_on_a_data_model_mesh(ranks, iris):
    """shared_gradients on a data 2 x model 2 mesh (no rules: the model
    axis replicates): the ranks that share a data block train on the same
    rows, and the step, the score and the evaluation are the reference's
    on the same mesh of 4 devices."""
    from deeplearning4j_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake

    x, y = iris[0][:96], iris[1][:96]
    axes = {DATA_AXIS: 2, MODEL_AXIS: 2}
    js, p0 = carry(iris_net())
    jpw = JPW(fresh(iris_net(), p0),
              mesh=jmake(axes, devices=jax.devices()[:4]))
    col = JCollect()
    jpw.fit(It([(x, y)]), epochs=3, listeners=[col])
    got = ranks(4).run(R.wrapper_fit, js, p0, [(x, y)], 3, axes=axes)
    assert_tree_close(got["params"], jax.tree.map(np.asarray,
                                                  jpw.model.params))
    np.testing.assert_allclose(got["losses"], [s for _, s in col.scores],
                               rtol=RTOL, atol=ATOL)
    conf = ranks(4).run(R.wrapper_evaluate, js, got["params"], [iris], axes)
    np.testing.assert_array_equal(conf, jpw.evaluate(It([iris])).confusion)


def test_sync_mode_averages_net_state(ranks):
    """A BatchNorm's running statistics under shared_gradients: each rank
    takes its own rows' statistics, then the group's mean, so every rank
    holds the same state (the reference takes the global batch's)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 6)).astype(np.float32) * 3 + 1
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    net = (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "sgd", "learning_rate": 0.1}))
           .input_shape(6).layer(L.Dense(n_out=8, activation="relu"))
           .layer(L.BatchNorm())
           .layer(L.Output(n_out=3, activation="softmax", loss="mcxent"))
           .build())
    js, p0 = carry(net)
    s0 = jax.tree.map(np.asarray, net.state)
    states = ranks(4).run_all(R.wrapper_state, js, p0, s0, [(x, y)], 2)
    for s in states[1:]:
        for k in states[0]:
            for kk in states[0][k]:
                np.testing.assert_array_equal(s[k][kk], states[0][k][kk])
    moved = [not np.allclose(states[0][k][kk], s0[k][kk])
             for k in s0 for kk in s0[k]]
    assert any(moved), "the running statistics did not move"


@pytest.mark.parametrize("mode", ["averaging", "encoded_gradients"])
def test_replica_modes_reject_multi_axis_mesh(ranks, mode):
    js, p0 = carry(iris_net())
    from deeplearning4j_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake

    with pytest.raises(ValueError, match="pure data-parallel"):
        JPW(fresh(iris_net(), p0), mesh=jmake({DATA_AXIS: 4, MODEL_AXIS: 2}),
            mode=mode)
    err = ranks(4).run(R.wrapper_rejects, js, p0, mode, None,
                       {"data": 2, "model": 2})
    assert err[0] == "ValueError" and "pure data-parallel" in err[1]


# ------------------------------------------------------------ staleness
def test_staleness_round_in_flight_then_flushed(ranks, iris):
    """staleness=1: after one step each rank has applied only its own
    update (replicas differ, a round pending); the flush makes them equal
    again and equal to the reference's flushed replica."""
    x, y = iris[0][:96], iris[1][:96]
    kw = dict(threshold=0.0, capacity_frac=1.0, quantize=False, staleness=1)
    js, p0 = carry(iris_net())
    before, after = ranks(4).run(R.staleness_round, js, p0,
                                 (x, y, None, None), kw)
    w0 = before[0][0]["layer_0"]["w"]
    assert not np.allclose(w0, before[1][0]["layer_0"]["w"])
    assert before[0][1] > 0
    jpw = JPW(fresh(iris_net(), p0), mesh=cpu_test_mesh(4),
              mode="encoded_gradients", **kw)
    jpw._fit_batch(np.asarray(x), np.asarray(y))
    stacked = jax.device_get(jpw.params)
    np.testing.assert_allclose(w0, stacked["layer_0"]["w"][0], rtol=RTOL,
                               atol=ATOL)
    jpw._sync_model()
    for params, pending in after:  # the reference test's tolerance: each
        assert pending == 0         # rank adds its peers in its own order
        assert_tree_close(params, after[0][0], rtol=1e-6, atol=1e-7)
    assert_tree_close(after[0][0], jax.tree.map(np.asarray, jpw.model.params))


@pytest.mark.parametrize("stale", [0, 1])
def test_staleness_trajectory_matches_reference(ranks, iris, stale):
    """60 exact top-k steps at staleness 0 and 1 (the reference's
    convergence case) against the reference's params and losses."""
    x, y = iris[0][:96], iris[1][:96]
    kw = dict(threshold=0.0, capacity_frac=1.0, quantize=False,
              staleness=stale)
    js, p0 = carry(iris_net())
    want, wloss = jax_fit(iris_net(), p0, [(x, y)], 60, 4,
                          mode="encoded_gradients", **kw)
    got = ranks(4).run(R.wrapper_fit, js, p0, [(x, y)], 60,
                       "encoded_gradients", kw)
    assert_tree_close(got["params"], want)
    np.testing.assert_allclose(got["losses"], wloss, rtol=RTOL, atol=ATOL)
    assert got["losses"][-5:].mean() < 0.5


# ------------------------------------------------------------ masks
def _seq_data():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 6, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (16, 6))]
    lm = np.zeros((16, 6), np.float32)
    lm[:, :2] = 1.0
    return x, y, lm


@pytest.mark.parametrize("mode", ["averaging", "encoded_gradients"])
def test_masked_rnn_batches_in_replica_modes(ranks, mode):
    """Garbage under a feature mask changes nothing in the replica modes,
    and the masked run is the reference's."""
    T, B = 6, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, 3)).astype(np.float32)
    y = np.zeros((B, T, 2), np.float32)
    y[..., 0] = 1
    mask = np.ones((B, T), np.float32)
    mask[:, 4:] = 0.0
    xg = x.copy()
    xg[:, 4:] += 100.0

    def net():
        return (SequentialBuilder(NetConfig(seed=0, updater={
            "type": "sgd", "learning_rate": 1e-2}))
                .input_shape(T, 3).layer(L.LSTM(n_out=5))
                .layer(L.RnnOutput(n_out=2, activation="softmax",
                                   loss="mcxent")).build())

    kw = {"averaging_frequency": 1, "threshold": 1e-3}
    js, p0 = carry(net())
    want, _ = jax_fit(net(), p0, [(x, y, mask)], 2, 4, mode=mode, **kw)
    clean = ranks(4).run(R.wrapper_fit, js, p0, [(x, y, mask)], 2, mode, kw)
    dirty = ranks(4).run(R.wrapper_fit, js, p0, [(xg, y, mask)], 2, mode, kw)
    assert_tree_close(clean["params"], want)
    assert_tree_close(dirty["params"], clean["params"])


def test_shared_gradients_label_mask_equals_reference(ranks):
    x, y, lm = _seq_data()
    js, p0 = carry(seq_net())
    want, wloss = jax_fit(seq_net(), p0, [(x, y, None, lm)], 2, 4)
    got = ranks(4).run(R.wrapper_fit, js, p0, [(x, y, None, lm)], 2)
    assert_tree_close(got["params"], want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], wloss, rtol=2e-5)


@pytest.mark.parametrize("mode", ["averaging", "encoded_gradients"])
def test_replica_modes_use_label_mask(ranks, mode):
    """The label mask reaches every replica's loss: masked and unmasked
    runs differ (the reference's case), and the masked run is the
    reference's. The encoded mode is held to the reference at full
    capacity: adam's first updates are all about ±lr, so at half capacity
    the entries at the edge tie to rounding and either library may send
    another one."""
    x, y, lm = _seq_data()
    kw = ({"threshold": 1e-5, "capacity_frac": 0.5, "quantize": False}
          if mode == "encoded_gradients" else {})
    js, p0 = carry(seq_net())
    masked = ranks(4).run(R.wrapper_fit, js, p0, [(x, y, None, lm)], 2,
                          mode, kw)
    plain = ranks(4).run(R.wrapper_fit, js, p0, [(x, y)], 2, mode, kw)
    flat = [np.concatenate([v.ravel() for d in r["params"].values()
                            for v in d.values()]) for r in (masked, plain)]
    assert not np.allclose(*flat), f"{mode}: labels_mask had no effect"
    assert np.isfinite(flat[0]).all()
    if mode == "encoded_gradients":
        kw = dict(kw, capacity_frac=1.0)
        masked = ranks(4).run(R.wrapper_fit, js, p0, [(x, y, None, lm)], 2,
                              mode, kw)
    want, _ = jax_fit(seq_net(), p0, [(x, y, None, lm)], 2, 4, mode=mode,
                      **kw)
    assert_tree_close(masked["params"], want)


def test_bert_ragged_flash_under_data_parallel(ranks):
    """BertBase(small, flash, ragged) through shared_gradients on 4 ranks
    against the reference wrapper on 4 devices, right-padded batch."""
    from deeplearning4j_tpu.models import BertBase

    rng = np.random.default_rng(0)
    B, T = 8, 16
    x = rng.integers(1, 1000, (B, T)).astype(np.int32)
    lens = rng.integers(3, T + 1, B)
    fm = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]

    def net():
        return BertBase(small=True, num_classes=2, seed=0, input_shape=(T,),
                        flash=True).build()

    js, p0 = carry(net())
    want, _ = jax_fit(net(), p0, [(x, y, fm)], 2, 4)
    got = ranks(4).run(R.wrapper_fit, js, p0, [(x, y, fm)], 2)
    assert_tree_close(got["params"], want, rtol=6e-3, atol=3e-4)


# ------------------------------------------------------------ scoring
def _jax_score(net, p0, batches, mesh_n):
    pw = JPW(fresh(net, p0), mesh=cpu_test_mesh(mesh_n))
    return pw.score_iterator(It(batches))


@pytest.mark.parametrize("rows,batch", [(9, 4), (96, 32), (29, 10)],
                         ids=["tiny-tail", "divisible", "nondivisible-tail"])
def test_score_iterator_matches_reference(ranks, iris, rows, batch):
    x, y = iris[0][:rows], iris[1][:rows]
    batches = [(x[i:i + batch], y[i:i + batch])
               for i in range(0, rows, batch)]
    js, p0 = carry(iris_net(seed=11))
    want = _jax_score(iris_net(seed=11), p0, batches, 4)
    single = JTrainer(fresh(iris_net(seed=11), p0)).score_iterator(
        It(batches))
    got = ranks(4).run(R.wrapper_score, js, p0, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, single, rtol=1e-5)


def test_score_iterator_label_masks(ranks):
    """A distinct label mask changes the score; a ragged batch (10 rows
    over 4 ranks) with per-row coverage from 1 to 6 steps scores as one
    device does."""
    x, y, lm = _seq_data()
    js, p0 = carry(seq_net())
    single = JTrainer(fresh(seq_net(), p0))
    s_masked = single.score_iterator(It([(x, y, None, lm)]))
    s_plain = single.score_iterator(It([(x, y)]))
    assert abs(s_masked - s_plain) > 1e-6
    got = ranks(4).run(R.wrapper_score, js, p0, [(x, y, None, lm)])
    np.testing.assert_allclose(got, s_masked, rtol=1e-5)
    rng = np.random.RandomState(1)
    n = 10
    xr = rng.randn(n, 6, 4).astype(np.float32)
    yr = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (n, 6))]
    lr = np.zeros((n, 6), np.float32)
    for i in range(n):
        lr[i, : 1 + (i % 6)] = 1.0
    want = single.score_iterator(It([(xr, yr, None, lr)]))
    got = ranks(4).run(R.wrapper_score, js, p0, [(xr, yr, None, lr)])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluate_matches_reference(ranks, iris):
    """Sharded evaluation (a 150-row batch padded over 4 ranks and cut
    back) gives the reference wrapper's confusion matrix."""
    x, y = iris
    js, p0 = carry(iris_net(seed=3))
    jpw = JPW(fresh(iris_net(seed=3), p0), mesh=cpu_test_mesh(4))
    want = jpw.evaluate(It([(x, y)])).confusion
    got = ranks(4).run(R.wrapper_evaluate, js, p0, [(x, y)])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ grad_accum
@pytest.mark.parametrize("mode", ["shared_gradients", "zero_sharded"])
def test_grad_accum_matches_reference(ranks, mode):
    rng = np.random.RandomState(3)
    x = rng.randn(128, 10).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 128)]
    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 128, 32)]

    def net():
        return iris_net(seed=4, lr=1e-2, updater="adam", act="relu", n_in=10)

    js, p0 = carry(net())
    want, wloss = jax_fit(net(), p0, batches, 2, 4, mode=mode, grad_accum=2)
    tr = JTrainer(fresh(net(), p0), grad_accum=2)
    tr.fit(JArrayIterator(x, y, 32, shuffle=False), epochs=2)
    got = ranks(4).run(R.wrapper_fit, js, p0, batches, 2, mode,
                       {"grad_accum": 2})
    assert_tree_close(got["params"], want, rtol=5e-5, atol=1e-6)
    assert_tree_close(got["params"], jax.tree.map(np.asarray, tr.params),
                      rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], wloss, rtol=5e-5, atol=1e-6)


# ------------------------------------------------------------ the slice
def test_causal_lm_flash_shared_gradients_world_2(ranks):
    """The slice as a whole: the 2-layer flash CausalLM (d_model 64, f32)
    under shared_gradients on 2 ranks against the reference wrapper on 2
    devices, 3 steps of params and losses. With nesterovs in place of the
    model's adamw: the key projection's bias has a gradient that is zero
    but for rounding (softmax ignores a shift shared by every key), and
    adamw turns that noise into steps of about lr either way."""
    from deeplearning4j_tpu.models import CausalLM as JCausalLM

    LM = dict(seed=0, input_shape=(32,), num_layers=2, d_model=64,
              num_heads=4, vocab=97)
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 97, (4, 32)).astype(np.int32),
                rng.randint(0, 97, (4, 32)).astype(np.int32))
               for _ in range(3)]

    def lm():
        m = JCausalLM(flash=True, **LM).build()
        m.config.updater = {"type": "nesterovs", "learning_rate": 1e-2,
                            "momentum": 0.9}
        return m

    js, p0 = carry(lm())
    want, wloss = jax_fit(lm(), p0, batches, 1, 2)
    got = ranks(2).run(R.wrapper_fit, js, p0, batches, 1)
    assert_tree_close(got["params"], want)
    np.testing.assert_allclose(got["losses"], wloss, rtol=RTOL, atol=ATOL)


def test_trainer_data_mesh_matches_reference(ranks, iris):
    """Trainer(mesh=make_mesh({"data": 4})) against the reference's
    Trainer(mesh=) on 4 devices: params, losses, score and evaluation
    (and grad_accum=2)."""
    x, y = iris[0][:96], iris[1][:96]
    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 96, 32)]
    js, p0 = carry(iris_net(updater="nesterovs", lr=5e-2))
    for accum in (1, 2):
        tr = JTrainer(fresh(iris_net(updater="nesterovs", lr=5e-2), p0),
                      mesh=cpu_test_mesh(4), grad_accum=accum)
        col = JCollect()
        tr.fit(It(batches), epochs=2, listeners=[col], prefetch=False)
        got = ranks(4).run(R.trainer_mesh_fit, js, p0, batches, 2, accum)
        assert_tree_close(got["params"], jax.tree.map(np.asarray, tr.params),
                          what=f"accum {accum}:")
        np.testing.assert_allclose(got["losses"],
                                   [s for _, s in col.scores],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["score"], tr.score_iterator(
            It(batches)), rtol=1e-5)
        np.testing.assert_array_equal(got["confusion"],
                                      tr.evaluate(It(batches)).confusion)


def test_trainer_rules_name_item_19():
    """Trainer(rules=) trains over a mesh now (tests/test_torch_sharding.py);
    rules without a mesh have nothing to shard over and are refused."""
    from deeplearning4j_torch.models import CausalLM
    from deeplearning4j_torch.train import Trainer

    m = CausalLM(device="cpu", num_layers=1, d_model=16, num_heads=2,
                 vocab=11, input_shape=(8,)).build()
    with pytest.raises(ValueError, match="mesh="):
        Trainer(m, rules=[(".*", ())])


# ------------------------------------------------------------ inference
def test_parallel_inference_matches_direct(iris):
    """Five concurrent single-row requests coalesced by the port's
    ParallelInference: each the port model's direct forward, and the
    reference's."""
    from deeplearning4j_torch.parallel import ParallelInference

    x, y = iris
    tr = JTrainer(iris_net())
    tr.fit(JArrayIterator(x, y, 50), epochs=3, prefetch=False)
    js, params = tr.model.to_json(), jax.tree.map(np.asarray, tr.params)
    direct_j = np.asarray(tr.model.output(x[:5], tr.params, tr.state))
    m = R.build(js, params)
    server = ParallelInference(m, batch_limit=16, max_wait_ms=1.0)
    try:
        direct = m.output(x[:5]).numpy()
        with cf.ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda i: server.output(x[i]), range(5)))
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o[0], direct[i], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(o[0], direct_j[i], rtol=1e-5,
                                       atol=1e-6)
        assert server.buckets == [1, 2, 4, 8, 16]
    finally:
        server.shutdown()


# ------------------------------------------------------------ telemetry
@pytest.mark.parametrize("fence", [True, False])
def test_parallel_step_telemetry(ranks, iris, fence):
    """StepTelemetry.parallel_step on every rank: with the fence, one
    gauge a replica (the reference's metric names); without it, none."""
    x, y = iris[0][:96], iris[1][:96]
    js, p0 = carry(iris_net())
    got = ranks(2).run(R.parallel_telemetry, js, p0,
                       [(x[:48], y[:48]), (x[48:], y[48:])], fence)
    assert got["steps"] == 2 and got["has_rate"]
    assert got["gauges"] == ([
        'parallel_replica_step_seconds{replica="0"}',
        'parallel_replica_step_seconds{replica="1"}'] if fence else [])


def test_spawned_ranks_load_no_jax(ranks):
    """A rank has no JAX module, one intra-op thread, its gloo group, and
    no rendezvous variable in its environment."""
    for n in (2, 4):
        infos = ranks(n).run_all(R.rank_info)
        assert [i["rank"] for i in infos] == list(range(n))
        for i in infos:
            assert i["world"] == n and i["backend"] == "gloo"
            assert i["threads"] == 1 and i["jax"] == [] and i["env"] == []
