"""The port's elastic training (``deeplearning4j_torch/elastic``) held
against the JAX package's on the CPU.

- The reshard planner: the reference's hand-computed shrinks, and every
  ``dp_from -> dp_to`` pair in 1..8 over the updater states of an MLP and
  of a transformer block, moved, naive and per-leaf bytes equal to the
  reference planner's.
- Atomic publish: a torn staging directory is invisible, no pointer means
  ``None`` and a typed resume error, and each package's ``latest`` reads
  the other's pointer.
- ``ElasticTrainer`` on ``[cpu] * 4`` against the reference's on 4 of the
  8 forced host devices, from the same params (carried across by the
  model's JSON and ``params_from_numpy``), on the same batches: the
  fault-free run's loss per step and params, the kill drill's resize log
  and params, the mid-resize death's pointer and restored params, typed
  quorum loss, the autoscale growth's resize log. Within the data-parallel
  tests' ``RTOL, ATOL = 1e-4, 1e-5``; resize logs exactly.
- The port's resumed trainer bit-equal to its own uninterrupted run, with
  no step capture after ``warm()``. (The reference's own resume fails on
  this JAX: its drills stop before it.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.chaos import faults as pfaults
from deeplearning4j_torch.elastic import (ElasticTrainer, NoCheckpointError,
                                          QuorumLostError, latest,
                                          leaf_layout, plan_leaf,
                                          plan_reshard)
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import model_from_json, params_from_numpy
from deeplearning4j_torch.train.trainer import build_updater
from deeplearning4j_tpu.chaos import faults as jfaults
from deeplearning4j_tpu.elastic import ElasticTrainer as JElastic
from deeplearning4j_tpu.elastic import QuorumLostError as JQuorumLostError
from deeplearning4j_tpu.elastic import checkpoint as jcheckpoint
from deeplearning4j_tpu.elastic import plan_reshard as jplan_reshard
from deeplearning4j_tpu.nn import NetConfig, SequentialBuilder
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.train.trainer import build_updater as jbuild_updater

RTOL, ATOL = 1e-4, 1e-5
CPU4 = [torch.device("cpu")] * 4
KEYS = ("step", "from", "to", "cause", "bytes_moved", "bytes_naive")


def _net():
    # hidden 24 / output 12: every weight dim divides by each ladder width
    # in 2..4, so updater leaves shard at every rung
    return (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "adam", "learning_rate": 1e-2}))
            .input_shape(8)
            .layer(L.Dense(n_out=24, activation="relu"))
            .layer(L.Output(n_out=12, activation="softmax", loss="mcxent"))
            .build())


def _block_net():
    return (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "adamw", "learning_rate": 1e-3}))
            .input_shape(6, 24)
            .layer(L.TransformerEncoderBlock(num_heads=2, causal=True))
            .layer(L.RnnOutput(n_out=12, activation="softmax", loss="mcxent"))
            .build())


def _batch(step):
    # a pure function of the step index: the replay contract fit relies on
    rng = np.random.RandomState(1000 + step)
    x = rng.randn(12, 8).astype(np.float32)
    y = np.eye(12, dtype=np.float32)[rng.randint(0, 12, 12)]
    return x, y


@pytest.fixture(scope="module")
def start():
    """The reference MLP's JSON and initial params (numpy)."""
    m = _net()
    m.init()
    return m.to_json(), jax.tree.map(np.asarray, m.params)


def jmodel(start):
    m = _net()
    m.init()
    m.params = jax.tree.map(jnp.asarray, start[1])
    return m


def pmodel(start):
    m = model_from_json(start[0], device="cpu")
    m.params = params_from_numpy(m, start[1])
    m.state = {}
    return m


def port(start, wd, **kw):
    kw.setdefault("dp", 4)
    return ElasticTrainer(pmodel(start), workdir=str(wd), dp_min=2, seed=0,
                          devices=CPU4, **kw)


def ref(start, wd, **kw):
    kw.setdefault("dp", 4)
    return JElastic(jmodel(start), workdir=str(wd), dp_min=2, seed=0, **kw)


def assert_params_close(jparams, pparams, rtol=RTOL, atol=ATOL):
    for k in jparams:
        for pk in jparams[k]:
            np.testing.assert_allclose(pparams[k][pk].detach().numpy(),
                                       np.asarray(jparams[k][pk]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{k}/{pk}")


def assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def log(resizes):
    return [{k: r[k] for k in KEYS} for r in resizes]


def kill(faults, t, spec, steps):
    faults.install(faults.FaultPlane(seed=0).inject_spec(spec))
    try:
        t.fit(_batch, steps)
    finally:
        faults.uninstall()


# --------------------------------------------------------------- planner

class TestReshardPlanner:
    @pytest.mark.parametrize("shape,itemsize,dp_from,dp_to,want", [
        # (24,) over 4 holds 6-element blocks, over 2 needs 12: replica 0
        # keeps [0, 6) and fetches 6, replica 1 held [6, 12) and needs
        # [12, 24): 18 elements moved, the naive (24 - 6) * 2 = 36
        ((24,), 4, 4, 2, (72, 144)),
        # 4 -> 3: new 8-element blocks overlap the old by 6/4/2
        ((24,), 4, 4, 3, (48, 216)),
        # a scalar (adam's count) is whole everywhere: nothing moves
        ((), 8, 4, 2, (0, 0)),
    ])
    def test_hand_computed(self, shape, itemsize, dp_from, dp_to, want):
        mv = plan_leaf(leaf_layout("m/w", shape, itemsize, dp_from),
                       leaf_layout("m/w", shape, itemsize, dp_to))
        assert (mv.bytes_moved, mv.bytes_naive) == want

    def test_shape_change_is_typed_error(self):
        with pytest.raises(ValueError, match="shape changed"):
            plan_leaf(leaf_layout("m/w", (24,), 4, 4),
                      leaf_layout("m/w", (25,), 4, 2))

    def test_plan_beats_naive_on_real_opt_state(self, start):
        m = pmodel(start)
        opt = build_updater(m).init(tree_leaves(m.params))
        for dp_to in (2, 3):
            plan = plan_reshard(opt, 4, dp_to)
            assert (plan.dp_from, plan.dp_to) == (4, dp_to)
            assert 0 < plan.bytes_moved < plan.bytes_naive
            assert plan.bytes_moved <= plan.bytes_total
            assert plan.summary()["leaves"] == len(plan.moves)


@pytest.fixture(scope="module")
def opt_states():
    """(reference updater state, port updater state) of the MLP and of a
    transformer block."""
    out = {}
    for name, build in (("mlp", _net), ("block", _block_net)):
        jm = build()
        jm.init()
        pm = model_from_json(jm.to_json(), device="cpu")
        pm.params = params_from_numpy(pm, jax.tree.map(np.asarray,
                                                       jm.params))
        out[name] = (jbuild_updater(jm).init(jm.params),
                     build_updater(pm).init(tree_leaves(pm.params)))
    return out


@pytest.mark.parametrize("dp_to", range(1, 9))
@pytest.mark.parametrize("dp_from", range(1, 9))
@pytest.mark.parametrize("net", ["mlp", "block"])
def test_plan_matches_reference(opt_states, net, dp_from, dp_to):
    jopt, popt = opt_states[net]
    want = jplan_reshard(jopt, dp_from, dp_to)
    got = plan_reshard(popt, dp_from, dp_to)
    assert (got.bytes_moved, got.bytes_naive, got.bytes_total) == \
        (want.bytes_moved, want.bytes_naive, want.bytes_total)
    assert [(m.bytes_moved, m.bytes_naive) for m in got.moves] == \
        [(m.bytes_moved, m.bytes_naive) for m in want.moves]


# ------------------------------------------------------- atomic publish

class TestAtomicCheckpoint:
    def test_publish_and_latest_roundtrip(self, start, tmp_path):
        t = port(start, tmp_path, dp=2)
        info = t.checkpoint_now(cause="manual")
        got = latest(str(tmp_path))
        assert (got.step, got.dp, got.cause) == (0, 2, "manual")
        assert os.path.isdir(got.path) and got.path == info.path
        assert got.mesh_shape == (("data", 2),)

    def test_torn_staging_is_invisible(self, start, tmp_path):
        wd = str(tmp_path)
        t = port(start, wd, dp=2)
        t.checkpoint_now(cause="manual")
        before = latest(wd)
        # a writer dying mid-save: garbage under staging/ and a half-written
        # pointer temp file change nothing latest() sees
        os.makedirs(os.path.join(wd, "staging", "step00000099_dp2.777"))
        with open(os.path.join(wd, ".LATEST.json.777.tmp"), "w") as f:
            f.write('{"truncat')
        assert latest(wd) == before

    def test_no_pointer_means_none_and_typed_resume_error(self, tmp_path):
        assert latest(str(tmp_path)) is None
        with pytest.raises(NoCheckpointError):
            ElasticTrainer.resume(str(tmp_path), devices=CPU4)

    def test_each_package_reads_the_others_pointer(self, start, tmp_path):
        pwd, jwd = tmp_path / "port", tmp_path / "ref"
        port(start, pwd, dp=2).checkpoint_now(cause="manual")
        got = jcheckpoint.latest(str(pwd))
        assert (got.step, got.dp, got.mesh_shape, got.layout, got.cause) \
            == (0, 2, (("data", 2),), "zero1", "manual")
        os.makedirs(jwd)
        jcheckpoint._write_pointer(str(jwd), {
            "path": str(jwd / "ckpt" / "step00000007_dp3"), "step": 7,
            "dp": 3, "mesh_shape": [["data", 3]], "layout": "zero1",
            "cause": "post_resize_worker_death"})
        assert tuple(latest(str(jwd))) == tuple(jcheckpoint.latest(str(jwd)))


def test_ladder_bounds(start, tmp_path):
    with pytest.raises(ValueError, match="exceeds 2 devices"):
        ElasticTrainer(pmodel(start), workdir=str(tmp_path), dp=4,
                       devices=CPU4[:2])
    with pytest.raises(ValueError, match="dp_min <= dp"):
        port(start, tmp_path, dp=1)


# --------------------------------------------------------------- drills

def test_fault_free_fit_matches_reference(start, tmp_path):
    jt, pt = ref(start, tmp_path / "j"), port(start, tmp_path / "p")
    jl, pl = [], []
    for s in range(1, 7):
        jt.fit(_batch, s)
        pt.fit(_batch, s)
        jl.append(jt.final_loss())
        pl.append(pt.final_loss())
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert_params_close(jt.params, pt.params)
    assert pt.dp == 4 and pt.resizes == [] and pt.trace_count() == 0


def test_kill_reap_reshard_resume(start, tmp_path):
    """The acceptance drill: a chaos-killed worker is reaped, the ladder
    reshards 4 -> 3 through two atomic checkpoints as the reference's
    does, the params follow the reference's over 10 steps, and a trainer
    resumed from the post-resize pointer finishes bit-equal."""
    jt, pt = ref(start, tmp_path / "j"), port(start, tmp_path / "p")
    spec = "elastic.step:error:scope=w1,times=1"
    for t, f in ((jt, jfaults), (pt, pfaults)):
        t.fit(_batch, 3)
        kill(f, t, spec, 8)
    assert pt.dp == 3
    assert log(pt.resizes) == log(jt.resizes)
    assert [r["cause"] for r in pt.resizes] == ["worker_death"]
    assert 0 < pt.resizes[0]["bytes_moved"] < pt.resizes[0]["bytes_naive"]
    info = latest(str(tmp_path / "p"))
    assert info.dp == 3 and info.mesh_shape == (("data", 3),)
    assert info.cause.startswith("post_resize")
    jt.fit(_batch, 10)
    pt.fit(_batch, 10)
    assert_params_close(jt.params, pt.params)
    np.testing.assert_allclose(pt.final_loss(), jt.final_loss(), rtol=RTOL,
                               atol=ATOL)
    assert pt.trace_count() == 0

    t2 = ElasticTrainer.resume(str(tmp_path / "p"), dp=3, seed=0,
                               devices=CPU4)
    assert (t2.iteration, t2.dp) == (info.step, 3)
    t2.fit(_batch, 10)
    assert t2.final_loss() == pt.final_loss()
    assert_bit_equal(pt.params, t2.params)
    assert_bit_equal(pt.opt_state, t2.opt_state)


def test_mid_resize_death_resumes(start, tmp_path):
    """A coordinator death on the ``elastic.resize`` seam surfaces typed in
    both packages after the same pre-resize checkpoint; the port's resume
    restores the reference's state at that step and trains on, at the
    checkpoint's width and at the post-resize width."""
    jt, pt = ref(start, tmp_path / "j"), port(start, tmp_path / "p")
    specs = ("elastic.step:error:scope=w2,times=1",
             "elastic.resize:error:times=1")
    for t, f in ((jt, jfaults), (pt, pfaults)):
        t.fit(_batch, 3)
        plane = f.FaultPlane(seed=0)
        for s in specs:
            plane.inject_spec(s)
        f.install(plane)
        try:
            with pytest.raises(RuntimeError, match="elastic.resize"):
                t.fit(_batch, 8)
        finally:
            f.uninstall()
    pinfo = latest(str(tmp_path / "p"))
    jinfo = jcheckpoint.latest(str(tmp_path / "j"))
    assert (pinfo.step, pinfo.dp, pinfo.cause) == \
        (jinfo.step, jinfo.dp, jinfo.cause)
    assert pinfo.cause.startswith("pre_resize") and pinfo.dp == 4
    for dp in (None, 3):
        t2 = ElasticTrainer.resume(str(tmp_path / "p"), dp=dp, seed=0,
                                   devices=CPU4)
        assert t2.iteration == pinfo.step
        assert_params_close(jt.params, t2.params)
        if dp == 3:
            assert t2.resizes[-1]["cause"] == "resume"
        t2.fit(_batch, 8)
        assert t2.iteration == 8 and np.isfinite(t2.final_loss())


def test_quorum_loss_is_typed(start, tmp_path):
    for t, f, err in ((ref(start, tmp_path / "j", dp=2), jfaults,
                       JQuorumLostError),
                      (port(start, tmp_path / "p", dp=2), pfaults,
                       QuorumLostError)):
        t.fit(_batch, 1)
        with pytest.raises(err):
            kill(f, t, "elastic.step:error:scope=w0,times=1", 8)


def test_autoscale_regression_grows_the_ladder(start, tmp_path):
    """A sustained step-time regression (4x the budget, injected) drives
    the stock AutoscalePolicy to scale out, at the same steps and with
    the same plan as the reference."""
    kw = dict(dp=2, dp_max=3, step_time_budget_s=0.05)
    jt, pt = ref(start, tmp_path / "j", **kw), port(start, tmp_path / "p",
                                                     **kw)
    for t in (jt, pt):
        t.fit(_batch, 8, step_time_fn=lambda i: 0.2)
    assert pt.dp == 3
    assert {r["cause"] for r in pt.resizes} == {"autoscale"}
    assert log(pt.resizes) == log(jt.resizes)
    assert_params_close(jt.params, pt.params)
