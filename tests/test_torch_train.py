"""The port's training path (deeplearning4j_torch: schedules, losses,
updaters, Sequential.score, iterators, listeners, Trainer and updater-state
zips) held against the JAX package.

Inputs, labels and gradients come from numpy seeds; params are the
reference's, carried across with ``params_from_numpy``. Tolerances:

- losses and schedules: f32 1e-6 relative (same formulas, f32 both sides);
- updaters: 10 steps of one numpy gradient sequence against optax, each
  param within 1e-6 of optax's relative to the param's largest entry
  (torch's CPU sqrt is not correctly rounded: an ulp per step, measured
  6e-6 element-wise relative on entries near 0 and under 1e-8 of the
  param's scale);
- Trainer, f32 compute: first-step gradients within 1e-5 of
  ``jax.value_and_grad`` relative to each param's largest entry (measured
  8.2e-7); a 20-step loss trajectory within 1e-4 relative of the JAX
  ``Trainer`` (measured 5.5e-7 to 6.2e-7 across runs);
- Trainer, bf16 compute, against the JAX model with its Pallas backward
  (``jfa.BACKWARD = "pallas"``, the rounding K2/K3 share): a 10-step loss
  trajectory within 6e-4 relative (measured 3.3e-4: torch's autograd
  rounds the bf16 elementwise backward at other points than JAX's), with a
  control — the port computing in f32 — that misses the reference by more
  (measured 1.4e-3);
- updater-state zips: training resumed in the other package gives the next
  step's loss within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator, AsyncIterator, DataSet
from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import GraphBuilder, NetConfig, Sequential
from deeplearning4j_torch.obs import StepTelemetry
from deeplearning4j_torch.ops import losses, schedules, updaters
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener,
                                        DeferredScoreReporter,
                                        PerformanceListener,
                                        ScoreIterationListener, Trainer,
                                        TrainingListener, load_opt_state,
                                        opt_state_from_numpy,
                                        params_from_numpy)
from deeplearning4j_torch.train.trainer import accum_supported
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.data.iterators import DataSet as JDataSet
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.ops import schedules as jschedules
from deeplearning4j_tpu.ops import updaters as jupdaters
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

LM = dict(seed=0, input_shape=(48,), num_layers=2, d_model=64, num_heads=4,
          vocab=97)
TRAJ_RTOL = 1e-4
BF16_TRAJ_RTOL = 6e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_to_max(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------- losses
def _loss_inputs(kind, masked, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 5, 11)) * 2).astype(np.float32)
    if kind == "sparse":
        y = rng.integers(0, 11, (3, 5)).astype(np.int32)
    else:
        y = rng.random((3, 5, 11)).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    return logits, y, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("name", ["mcxent_logits", "mcxent",
                                  "negativeloglikelihood",
                                  "softmax_cross_entropy_logits"])
def test_loss_matches_reference(name, kind, masked):
    logits, y, mask = _loss_inputs(kind, masked)
    pred = logits if "logits" in name else np.asarray(
        jax.nn.softmax(jnp.asarray(logits)))
    want = jlosses.get(name)(jnp.asarray(pred), jnp.asarray(y),
                             mask=None if mask is None else jnp.asarray(mask))
    got = losses.get(name)(torch.from_numpy(pred), torch.from_numpy(y),
                           mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_reduction_mass_matches_reference(kind, masked):
    _, y, mask = _loss_inputs(kind, masked, seed=1)
    want = jlosses.reduction_mass(jnp.asarray(y),
                                  None if mask is None else jnp.asarray(mask))
    got = losses.reduction_mass(torch.from_numpy(y),
                                None if mask is None else torch.from_numpy(mask))
    assert float(got) == float(want)


def test_ambiguous_integer_labels_raise_like_reference():
    logits = np.zeros((2, 4), np.float32)
    onehot_int = np.eye(4, dtype=np.int32)[[0, 3]]
    with pytest.raises(ValueError, match="ambiguous"):
        jlosses.mcxent_logits(jnp.asarray(logits), jnp.asarray(onehot_int))
    with pytest.raises(ValueError, match="ambiguous"):
        losses.mcxent_logits(torch.from_numpy(logits),
                             torch.from_numpy(onehot_int))


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.get("no_such_loss")


def test_sparse_gradient_matches_dense_one_hot():
    """The gathered sparse loss and the one-hot dense loss agree in value
    and in gradient, without the sparse path building a one-hot."""
    logits, y, _ = _loss_inputs("sparse", False)
    a = torch.from_numpy(logits).requires_grad_()
    b = torch.from_numpy(logits).requires_grad_()
    ls = losses.mcxent_logits(a, torch.from_numpy(y))
    ld = losses.mcxent_logits(b, torch.nn.functional.one_hot(
        torch.from_numpy(y).long(), 11).float())
    ls.backward()
    ld.backward()
    torch.testing.assert_close(ls, ld)
    torch.testing.assert_close(a.grad, b.grad)


# ---------------------------------------------------------- schedules
SCHEDULES = {
    "constant": 0.25,
    "exponential": {"type": "exponential", "initial": 0.1, "gamma": 0.97},
    "inverse": {"type": "inverse", "initial": 0.1, "gamma": 0.3, "power": 0.75},
    "poly": {"type": "poly", "initial": 0.1, "power": 2.0, "max_iter": 15},
    "sigmoid": {"type": "sigmoid", "initial": 0.1, "gamma": 0.5, "step_size": 6},
    "step": {"type": "step", "initial": 0.1, "decay_rate": 0.5, "step_size": 4},
    "map": {"type": "map", "values": {0: 0.1, 5: 0.05, 12: 0.01}},
    "warmup_cosine": {"type": "warmup_cosine", "peak": 0.1, "warmup_steps": 4,
                      "total_steps": 16, "end_value": 0.001},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    cfg = SCHEDULES[name]
    jf, tf = jschedules.from_config(cfg), schedules.from_config(cfg)
    for count in range(20):
        want = float(jf(jnp.asarray(count, jnp.int32)))
        got = tf(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-9)


def test_per_epoch_schedule():
    s = schedules.per_epoch(schedules.from_config(SCHEDULES["step"]), 3)
    assert float(s(torch.tensor(7))) == float(
        schedules.from_config(SCHEDULES["step"])(torch.tensor(2)))


# ----------------------------------------------------------- updaters
UPDATERS = {
    "sgd": ({"type": "sgd", "learning_rate": 0.1}, {}),
    "adam": ({"type": "adam", "learning_rate": 1e-2}, {}),
    "adamw": ({"type": "adamw", "learning_rate": 3e-2}, {}),
    "adamw_l2": ({"type": "adamw", "learning_rate": 3e-2}, {"l2": 0.05}),
    "adam_l1_schedule": ({"type": "adam", "lr": {"type": "step", "initial": 1e-2,
                                                 "decay_rate": 0.5,
                                                 "step_size": 3}},
                         {"l1": 1e-3}),
    "sgd_string": ("sgd", {}),
}
SHAPES = {"layer_1": {"w": (3, 4), "b": (4,)}, "layer_0": {"w": (7,)},
          "layer_10": {"g": (2, 2)}}


def _tree(rng):
    return {k: {n: rng.standard_normal(s).astype(np.float32)
                for n, s in v.items()} for k, v in SHAPES.items()}


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_matches_optax(name):
    cfg, kw = UPDATERS[name]
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(10)]
    jt = jupdaters.build(cfg, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jt.init(jp)
    tt = updaters.build(cfg, **kw)
    tp = [torch.from_numpy(a.copy()) for a in tree_leaves(p0)]
    ts = tt.init(tp)
    for g in grads:
        u, js = jt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        u, ts = tt.update([torch.from_numpy(a) for a in tree_leaves(g)], ts, tp)
        torch._foreach_add_(tp, list(u))
    for want, got in zip(jax.tree_util.tree_leaves(jp), tp):
        assert _rel_to_max(got.numpy(), want) <= 1e-6
    # the state crosses leaf for leaf: same count, order, shapes, dtypes
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    tleaves = [a.numpy() for a in tree_leaves(ts)]
    assert [(a.shape, a.dtype) for a in jleaves] == \
        [(a.shape, a.dtype) for a in tleaves]
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["nesterovs", "noop"])
def test_unported_updater_raises(kind):
    # ported since: the updater builds, with optax's state leaves
    # (tests/test_torch_updaters.py holds its math against optax)
    params = {"a": jnp.ones((2, 3)), "b": jnp.zeros((3,))}
    tx = updaters.build({"type": kind})
    state = tx.init([torch.ones(2, 3), torch.zeros(3)])
    want = jax.tree_util.tree_leaves(jupdaters.build({"type": kind})
                                     .init(params))
    assert [tuple(t.shape) for t in tree_leaves(state)] == \
        [tuple(a.shape) for a in want]


def test_gradient_normalization_raises():
    # ported since: ClipL2PerLayer clips each layer's update to the
    # threshold's norm, as the reference's does
    tx = updaters.build("sgd", gradient_normalization="ClipL2PerLayer",
                        gradient_normalization_threshold=0.5,
                        owners=["a", "a", "b"])
    grads = [torch.full((2,), 3.0), torch.full((2,), 4.0),
             torch.full((1,), 0.1)]
    updates, _ = tx.update(grads, tx.init(grads), grads)
    assert float(torch.sqrt(sum((u ** 2).sum() for u in updates[:2]))) == \
        pytest.approx(0.05, rel=1e-6)  # 0.1 x the clipped norm 0.5
    assert float(updates[2][0]) == pytest.approx(-0.01, rel=1e-6)


def test_tree_unflatten_round_trip():
    tree = {"b": {"y": 1, "x": 2}, "a": (3, [4, 5])}
    leaves = tree_leaves(tree)
    assert leaves == [3, 4, 5, 2, 1]
    assert updaters.tree_unflatten(tree, leaves) == tree


# ------------------------------------------------- the CausalLM trainer
@pytest.fixture(scope="module")
def lm_batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, LM["vocab"], (4, 48)).astype(np.int32)
    y = rng.randint(0, LM["vocab"], (4, 48)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def reference_params():
    m = JCausalLM(flash=True, **LM).build()
    m.init()
    return _np_tree(m.params)


def _port_lm(params, compute_dtype=None):
    m = CausalLM(flash=True, device="cpu", **LM).build()
    m.config.compute_dtype = compute_dtype
    m.params = params_from_numpy(m, params)
    m.state = {}
    return m


def _reference_lm(params, compute_dtype=None):
    m = JCausalLM(flash=True, **LM).build()
    m.config.compute_dtype = compute_dtype
    # fresh buffers: the JAX trainer donates them
    m.params = jax.tree.map(lambda a: jnp.array(np.array(a)), params)
    m.state = {}
    return m


def _repeat(x, y, n):
    return np.repeat(x, n, 0), np.repeat(y, n, 0)


def _reference_losses(params, x, y, n, compute_dtype=None):
    jm = _reference_lm(params, compute_dtype)
    rec = JCollectScoresListener()
    JTrainer(jm).fit(JArrayIterator(*_repeat(x, y, n), batch_size=4),
                     listeners=[rec], prefetch=False)
    return np.array([l for _, l in rec.scores])


def _port_losses(params, x, y, n, compute_dtype=None):
    rec = CollectScoresListener()
    Trainer(_port_lm(params, compute_dtype)).fit(
        ArrayIterator(*_repeat(x, y, n), batch_size=4), listeners=[rec])
    return np.array([l for _, l in rec.scores])


def test_first_step_gradients_match_reference(reference_params, lm_batch):
    x, y = lm_batch
    jm = _reference_lm(reference_params)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jm.score(p, {}, jnp.asarray(x), jnp.asarray(y))[0]))(jm.params)
    tm = _port_lm(reference_params)
    leaves = [p.requires_grad_() for p in tree_leaves(tm.params)]
    loss_t, _ = tm.score(tm.params, {}, torch.from_numpy(x),
                         torch.from_numpy(y))
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves(grads_j)
    assert len(jleaves) == len(grads_t)
    for want, got in zip(jleaves, grads_t):
        assert got.shape == want.shape
        assert _rel_to_max(got.numpy(), want) <= 1e-5


def test_loss_trajectory_matches_reference_trainer(reference_params, lm_batch):
    x, y = lm_batch
    want = _reference_losses(reference_params, x, y, 20)
    got = _port_losses(reference_params, x, y, 20)
    assert len(got) == len(want) == 20
    assert float(np.max(np.abs(got - want) / np.abs(want))) <= TRAJ_RTOL
    assert got[-1] < got[0]


@pytest.fixture(scope="module")
def bf16_reference_losses(reference_params, lm_batch):
    """The JAX Trainer at bf16 compute with the Pallas backward kernels,
    whose rounding K2/K3 (and the port's plain backward) share."""
    saved = jfa.BACKWARD
    jfa.BACKWARD = "pallas"
    try:
        return _reference_losses(reference_params, *lm_batch, 10, "bfloat16")
    finally:
        jfa.BACKWARD = saved


def test_bf16_trajectory_matches_reference_pallas_backward(
        reference_params, lm_batch, bf16_reference_losses):
    got = _port_losses(reference_params, *lm_batch, 10, "bfloat16")
    gap = np.abs(got - bf16_reference_losses) / bf16_reference_losses
    assert float(gap.max()) <= BF16_TRAJ_RTOL


def test_bf16_limit_rejects_f32_compute(reference_params, lm_batch,
                                        bf16_reference_losses):
    """The control of the test above: the port training in f32 misses the
    reference's bf16 trajectory by more than the limit."""
    got = _port_losses(reference_params, *lm_batch, 10, None)
    gap = np.abs(got - bf16_reference_losses) / bf16_reference_losses
    assert float(gap.max()) > BF16_TRAJ_RTOL


def _next_loss_jax(trainer, x, y):
    """The loss of the second step from here: the first step's update
    reads the (resumed) updater state."""
    step = trainer._make_step()
    for _ in range(2):
        trainer.params, trainer.opt_state, trainer.state, loss = step(
            trainer.params, trainer.opt_state, trainer.state, jnp.asarray(x),
            jnp.asarray(y), trainer.next_rng())
    return float(loss)


def _next_loss_port(trainer, x, y):
    for _ in range(2):
        trainer.params, trainer.opt_state, trainer.state, loss = trainer.step(
            trainer.params, trainer.opt_state, trainer.state, x, y)
    return loss.item()


def test_reference_zip_resumes_in_port(reference_params, lm_batch, tmp_path):
    x, y = lm_batch
    jt = JTrainer(_reference_lm(reference_params))
    jt.fit(JArrayIterator(*_repeat(x, y, 3), batch_size=4), prefetch=False)
    path = str(tmp_path / "ref.zip")
    jt.save(path)
    port = Trainer.load(path, device="cpu")
    assert int(tree_leaves(port.opt_state)[0]) == 3  # adam's count
    want = _next_loss_jax(jt, x, y)
    np.testing.assert_allclose(_next_loss_port(port, x, y), want, rtol=1e-5)


def test_port_zip_resumes_in_reference(reference_params, lm_batch, tmp_path):
    x, y = lm_batch
    port = Trainer(_port_lm(reference_params))
    port.fit(ArrayIterator(*_repeat(x, y, 3), batch_size=4))
    path = str(tmp_path / "port.zip")
    port.save(path)
    jt = JTrainer.load(path)
    assert int(jax.tree_util.tree_leaves(jt.opt_state)[0]) == 3
    want = _next_loss_port(port, x, y)
    np.testing.assert_allclose(_next_loss_jax(jt, x, y), want, rtol=1e-5)


def test_opt_state_from_numpy_carries_optax_state(reference_params):
    jm = _reference_lm(reference_params)
    jstate = JTrainer(jm).opt_state
    port = Trainer(_port_lm(reference_params))
    leaves = [np.asarray(a) + 1 for a in jax.tree_util.tree_leaves(jstate)]
    state = opt_state_from_numpy(port.opt_state, leaves)
    for a, b in zip(leaves, tree_leaves(state)):
        np.testing.assert_array_equal(b.numpy(), a)
    with pytest.raises(ValueError, match="leaves"):
        opt_state_from_numpy(port.opt_state, leaves[:-1])
    with pytest.raises(ValueError, match="leaf 0"):
        opt_state_from_numpy(port.opt_state,
                             [leaves[0].astype(np.float32)] + leaves[1:])


def test_zip_without_updater_state(reference_params, tmp_path):
    from deeplearning4j_torch.train import save_model

    m = _port_lm(reference_params)
    path = str(tmp_path / "m.zip")
    save_model(path, m)
    assert load_opt_state(path, Trainer(m).opt_state) is None


# ------------------------------------------ per-layer updater overrides
def _small_seq(mod, updater_on_dense):
    layers = [mod.Dense(n_out=5, activation="gelu",
                        updater=({"type": "sgd", "learning_rate": 0.05}
                                 if updater_on_dense else None)),
              mod.Output(n_out=3, activation="softmax", loss="mcxent")]
    cfg = dict(seed=1, updater={"type": "adamw", "learning_rate": 1e-2})
    if mod is JL:
        return JSequential(JNetConfig(**cfg), layers, (4,))
    return Sequential(NetConfig(**cfg), layers, (4,), device="cpu")


@pytest.mark.parametrize("override", [False, True],
                         ids=["global", "per_layer"])
def test_dense_classifier_trains_like_reference(override):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jm = _small_seq(JL, override)
    jm.init()
    tm = _small_seq(TL, override)
    tm.params = params_from_numpy(tm, _np_tree(jm.params))
    tm.state = {}
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    jt = JTrainer(jm)
    jt.fit(JArrayIterator(x, y, batch_size=4), epochs=3, listeners=[jrec],
           prefetch=False)
    tt = Trainer(tm)
    tt.fit(ArrayIterator(x, y, batch_size=4), epochs=3, listeners=[trec])
    np.testing.assert_allclose([l for _, l in trec.scores],
                               [l for _, l in jrec.scores], rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jt.opt_state)
    assert [tuple(np.shape(a)) for a in jleaves] == \
        [tuple(a.shape) for a in tree_leaves(tt.opt_state)]
    for want, got in zip(jax.tree_util.tree_leaves(jt.params),
                         tree_leaves(tt.params)):
        assert _rel_to_max(got.detach().numpy(), want) <= 1e-5


def test_score_iterator_matches_reference(reference_params, lm_batch):
    from deeplearning4j_tpu.train.trainer import score_model

    x, y = lm_batch
    it = JArrayIterator(*_repeat(x, y, 2), batch_size=4)
    want = score_model(_reference_lm(reference_params),
                       jax.tree.map(jnp.asarray, reference_params), {}, it)
    got = Trainer(_port_lm(reference_params)).score_iterator(
        ArrayIterator(*_repeat(x, y, 2), batch_size=4))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_label_mask_reduces_like_reference(reference_params, lm_batch):
    x, y = lm_batch
    lm = (np.random.default_rng(2).random((4, 48)) > 0.4).astype(np.float32)
    jm = _reference_lm(reference_params)
    want, _ = jm.score(jm.params, {}, jnp.asarray(x), jnp.asarray(y),
                       label_mask=jnp.asarray(lm))
    tm = _port_lm(reference_params)
    got, _, mass = tm.score(tm.params, {}, torch.from_numpy(x),
                            torch.from_numpy(y),
                            label_mask=torch.from_numpy(lm), with_mass=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert float(mass) == lm.sum()


# ------------------------------------------------------------- remat
@pytest.mark.parametrize("where", ["net", "block"])
def test_remat_gives_the_same_gradients(reference_params, lm_batch, where):
    x, y = (torch.from_numpy(a) for a in lm_batch)
    plain = _port_lm(reference_params)
    if where == "net":
        remat = _port_lm(reference_params)
        remat.config.remat = True
    else:
        remat = CausalLM(flash=True, device="cpu", remat=True, **LM).build()
        remat.params = params_from_numpy(remat, reference_params)
        remat.state = {}
        assert all(l.remat for l in remat.layers
                   if isinstance(l, TL.TransformerEncoderBlock))
    grads = []
    for m in (plain, remat):
        leaves = [p.requires_grad_() for p in tree_leaves(m.params)]
        loss, _ = m.score(m.params, {}, x, y)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_is_not_nested():
    """A layer that checkpoints itself is not wrapped again by the net."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)

    m = CausalLM(flash=True, device="cpu", remat=True, **LM).build()
    m.init(seed=0)
    m.config.remat = True
    ids = torch.zeros((1, 48), dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.utils.checkpoint, "checkpoint", spy)
        leaves = [p.requires_grad_() for p in tree_leaves(m.params)]
        loss, _ = m.score(m.params, {}, ids, ids)
        torch.autograd.grad(loss, leaves)
    # embedding, positions and the final LayerNorm by the net; each of the
    # 2 blocks once, by itself
    assert len(calls) == 3 + LM["num_layers"]


# ------------------------------------------------ iterators, listeners
def test_array_iterator_batches_like_reference():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.int32)
    for kw in (dict(), dict(shuffle=True, seed=3), dict(drop_last=True)):
        want = [(np.asarray(b.features), np.asarray(b.labels))
                for b in JArrayIterator(x, y, batch_size=4, **kw)]
        it = ArrayIterator(x, y, batch_size=4, **kw)
        got = [(b.features, b.labels) for b in it]
        assert len(it) == len(want) == len(got)
        for (wf, wl), (gf, gl) in zip(want, got):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gl, wl)


def test_async_iterator_keeps_order_and_host_arrays():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    batches = list(AsyncIterator(ArrayIterator(x, x, batch_size=3),
                                 queue_size=2))
    assert [b.num_examples for b in batches] == [3] * 6 + [2]
    assert all(isinstance(b.features, np.ndarray) for b in batches)
    np.testing.assert_array_equal(np.concatenate([b.features for b in batches]), x)


def test_async_iterator_reraises_producer_error():
    def gen():
        yield DataSet(np.zeros((1, 2)), np.zeros((1,)))
        raise KeyError("boom")

    seen = []
    with pytest.raises(KeyError, match="boom"):
        for b in AsyncIterator(gen()):
            seen.append(b)
    assert len(seen) == 1


def test_async_iterator_early_exit_stops_the_producer():
    x = np.zeros((100, 1), np.float32)
    it = iter(AsyncIterator(ArrayIterator(x, x, batch_size=1), queue_size=1))
    next(it)
    it.close()  # must not hang on the producer's full queue


class _Recorder(TrainingListener):
    def __init__(self, sync=False):
        self.requires_sync = sync
        self.events = []

    def on_epoch_start(self, trainer, epoch):
        self.events.append(("start", epoch))

    def on_epoch_end(self, trainer, epoch):
        self.events.append(("end", epoch))

    def iteration_done(self, trainer, iteration, epoch, loss):
        self.events.append((iteration, epoch, loss))


@pytest.mark.parametrize("sync", [False, True], ids=["lagged", "sync"])
def test_deferred_reporter_reports_each_iteration_once(sync):
    rec = _Recorder(sync)
    rep = DeferredScoreReporter(None, [rec])
    assert rep.lagged is not sync
    rep.report(0, 0, torch.tensor(1.5))
    assert rec.events == ([] if not sync else [(0, 0, 1.5)])
    rep.report(1, 0, torch.tensor(2.5))
    rep.flush()
    rep.flush()
    assert rec.events == [(0, 0, 1.5), (1, 0, 2.5)]


def test_fit_reports_in_order_with_epochs(reference_params, lm_batch):
    rec = _Recorder()
    logged = []
    perf = PerformanceListener(frequency=2, log_fn=logged.append)
    score = ScoreIterationListener(print_every=2, log_fn=logged.append)
    t = Trainer(_port_lm(reference_params))
    t.fit(ArrayIterator(*_repeat(*lm_batch, 3), batch_size=4), epochs=2,
          listeners=[rec, perf, score], prefetch=False)
    its = [e for e in rec.events if len(e) == 3]
    assert [(i, ep) for i, ep, _ in its] == [(0, 0), (1, 0), (2, 0),
                                             (3, 1), (4, 1), (5, 1)]
    assert rec.events[0] == ("start", 0) and rec.events[4] == ("end", 0)
    assert t.iteration == 6 and perf.samples_per_sec > 0
    assert sum("samples/sec" in s for s in logged) == 3
    assert sum("score" in s for s in logged) == 3


# ------------------------------------------- grad_accum (mirrors the JAX
# package's TestGradAccum, tests/test_train.py)
ACCUM_RTOL, ACCUM_ATOL = 2e-5, 1e-6  # the reference's own accum tolerance


def _pair(build):
    """A JAX model and the port's with the JAX model's params: ``build``
    takes a layers module, a Sequential class, a NetConfig class and the
    port's device keywords."""
    jm = build(JL, JSequential, JNetConfig, {})
    jm.init()
    tm = build(TL, Sequential, NetConfig, {"device": "cpu"})
    tm.params = params_from_numpy(tm, _np_tree(jm.params))
    tm.state = ({k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
                 for k, v in _np_tree(jm.state).items()} if jm.state else {})
    return jm, tm


def _blob_net(L, Seq, NC, kw, bn=False, drop=0.0):
    layers = [L.Dense(n_out=12, activation="relu")]
    if bn:
        layers.append(L.BatchNorm())
    if drop:
        layers.append(L.DropoutLayer(rate=drop))
    layers.append(L.Output(n_out=3, activation="softmax", loss="mcxent"))
    return Seq(NC(seed=0, updater={"type": "adam", "learning_rate": 1e-2}),
               layers, (6,), **kw)


def _seq_net(L, Seq, NC, kw, T=8):
    """A per-timestep classifier (no recurrent layer): Dense over (B, T, 3)
    features, then RnnOutput, scored with a (B, T) label mask."""
    return Seq(NC(seed=0, updater={"type": "sgd", "learning_rate": 1e-1}),
               [L.Dense(n_out=5, activation="relu"),
                L.RnnOutput(n_out=2, activation="softmax", loss="mcxent")],
               (T, 3), **kw)


def _blobs(n=120, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _seq_batch(B=8, T=8, seed=3, coverage=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 3)).astype(np.float32)
    y = np.zeros((B, T, 2), np.float32)
    y[np.arange(B)[:, None], np.arange(T)[None, :],
      rng.integers(0, 2, (B, T))] = 1.0
    lm = np.ones((B, T), np.float32)
    if coverage:
        lm[B // 2:, 2:] = 0.0  # the 2nd microbatch carries 1/4 the mass
    return x, y, lm


def _fit(trainer, it, epochs=1, **kw):
    rec = CollectScoresListener()
    trainer.fit(it, epochs=epochs, listeners=[rec], **kw)
    return np.array([l for _, l in rec.scores])


def _jfit(trainer, it, epochs=1, **kw):
    rec = JCollectScoresListener()
    trainer.fit(it, epochs=epochs, listeners=[rec], prefetch=False, **kw)
    return np.array([l for _, l in rec.scores])


def _assert_params_close(got, want, rtol=ACCUM_RTOL, atol=ACCUM_ATOL):
    """Port params against a JAX tree or another port tree."""
    if isinstance(tree_leaves(want)[0], torch.Tensor):
        want = [w.detach().numpy() for w in tree_leaves(want)]
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def _count_calls(trainer, name):
    calls = []
    fn = getattr(trainer, name)

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    setattr(trainer, name, spy)
    return calls


def test_grad_accum_unmasked_equals_big_batch_and_reference():
    x, y = _blobs()
    jm, tm = _pair(_blob_net)
    plain = Trainer(_pair(_blob_net)[1])
    _fit(plain, ArrayIterator(x, y, batch_size=60), epochs=2)
    acc = Trainer(tm, grad_accum=2)
    calls = _count_calls(acc, "accum_step")
    got = _fit(acc, ArrayIterator(x, y, batch_size=60), epochs=2)
    assert len(calls) == 4 and acc.iteration == plain.iteration == 4
    _assert_params_close(acc.params, plain.params)
    jt = JTrainer(jm, grad_accum=2)
    want = _jfit(jt, JArrayIterator(x, y, batch_size=60), epochs=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(acc.params, jt.params)


def test_grad_accum_masked_is_mass_weighted_like_reference():
    """Mask coverage that varies across microbatches: the mass-weighted
    recombination equals the single step's masked mean, and the JAX
    package's accumulation."""
    x, y, lm = _seq_batch()
    one = Trainer(_pair(_seq_net)[1])
    _fit(one, iter([DataSet(x, y, labels_mask=lm)]), prefetch=False)
    jm, tm = _pair(_seq_net)
    acc = Trainer(tm, grad_accum=2)
    calls = _count_calls(acc, "accum_step")
    got = _fit(acc, iter([DataSet(x, y, labels_mask=lm)]), prefetch=False)
    assert len(calls) == 1
    _assert_params_close(acc.params, one.params, rtol=1e-5)
    jt = JTrainer(jm, grad_accum=2)
    want = _jfit(jt, iter([JDataSet(x, y, labels_mask=lm)]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(acc.params, jt.params, rtol=1e-5)


def test_grad_accum_masked_graph_takes_the_plain_step():
    x, y, lm = _seq_batch()

    def graph():
        return (GraphBuilder(NetConfig(seed=0, updater={
                    "type": "sgd", "learning_rate": 1e-1}), device="cpu")
                .add_input("in", (8, 3))
                .add_layer("d", TL.Dense(n_out=5, activation="relu"), "in")
                .add_layer("out", TL.RnnOutput(n_out=2, activation="softmax",
                                               loss="mcxent"), "d")
                .set_outputs("out").build())

    g = graph()
    g.init(seed=4)
    g2 = graph()
    g2.params = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in g.params.items()}
    g2.state = {}
    acc, plain = Trainer(g, grad_accum=2), Trainer(g2)
    calls = _count_calls(acc, "accum_step")
    for t in (acc, plain):
        t.fit(iter([DataSet(x, y, labels_mask=lm)]), prefetch=False)
    assert calls == [] and acc.iteration == 1
    for a, b in zip(tree_leaves(acc.params), tree_leaves(plain.params)):
        assert torch.equal(a, b)
    assert not accum_supported(g, None, lm)
    assert accum_supported(g, None, None)


def test_grad_accum_indivisible_batch_takes_the_plain_step():
    x, y = _blobs(150)  # batch 40: 40, 40, 40, 30 (30 % 4 != 0)
    tr = Trainer(_pair(_blob_net)[1], grad_accum=4)
    accum, plain = _count_calls(tr, "accum_step"), _count_calls(tr, "step")
    _fit(tr, ArrayIterator(x, y, batch_size=40))
    assert tr.iteration == 4 and len(accum) == 3 and len(plain) == 1


def test_grad_accum_all_masked_batch_gives_zero_not_nan():
    x, y, _ = _seq_batch()
    lm = np.zeros((8, 8), np.float32)
    tm = _pair(_seq_net)[1]
    before = [p.detach().clone() for p in tree_leaves(tm.params)]
    tr = Trainer(tm, grad_accum=2)
    got = _fit(tr, iter([DataSet(x, y, labels_mask=lm)]), prefetch=False)
    assert got.tolist() == [0.0]
    for a, b in zip(before, tree_leaves(tr.params)):
        assert torch.equal(a, b)


def test_grad_accum_threads_batchnorm_state_like_reference():
    x, y = _blobs(64)
    jm, tm = _pair(lambda *a: _blob_net(*a, bn=True))
    tr = Trainer(tm, grad_accum=4)
    got = _fit(tr, ArrayIterator(x, y, batch_size=32), epochs=3)
    jt = JTrainer(jm, grad_accum=4)
    want = _jfit(jt, JArrayIterator(x, y, batch_size=32), epochs=3)
    assert tr.iteration == 6
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(tr.params, jt.params, rtol=1e-5)
    for k, v in _np_tree(jt.state).items():
        for n, a in v.items():
            np.testing.assert_allclose(tr.state[k][n].numpy(), a, rtol=1e-5,
                                       atol=1e-6)


def test_grad_accum_and_steps_per_execution_exclude_each_other():
    x, y = _blobs()
    tr = Trainer(_pair(_blob_net)[1], grad_accum=2)
    _fit(tr, ArrayIterator(x, y, batch_size=20), steps_per_execution=2)
    assert tr.windows == 0 and tr.iteration == 6


# ------------------------------ steps_per_execution (mirrors the JAX
# package's TestStepsPerExecution, tests/test_train.py)
def _spe_run(spe, epochs=2, n=150, batch=30, listeners=(), build=_blob_net,
             seed=0):
    x, y = _blobs(n, seed)
    tr = Trainer(_pair(build)[1], seed=seed)
    rec = CollectScoresListener()
    tr.fit(ArrayIterator(x, y, batch_size=batch), epochs=epochs,
           listeners=[rec, *listeners], steps_per_execution=spe)
    return tr, rec.scores


def test_megastep_equals_single_steps_bit_for_bit_and_reference():
    a, sa = _spe_run(1)
    b, sb = _spe_run(4)
    assert a.windows == 0 and b.windows == 2  # per epoch: 1 single, 1 x 4
    assert b.iteration == a.iteration == 10
    assert sb == sa
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    for p, q in zip(tree_leaves(a.opt_state), tree_leaves(b.opt_state)):
        assert torch.equal(p, q)
    x, y = _blobs(150)
    jm, _ = _pair(_blob_net)
    jt = JTrainer(jm)
    want = _jfit(jt, JArrayIterator(x, y, batch_size=30), epochs=2,
                 steps_per_execution=4)
    np.testing.assert_allclose([l for _, l in sb], want, rtol=1e-5)
    _assert_params_close(b.params, jt.params, rtol=1e-5)


def test_megastep_reports_every_iteration_in_order():
    tr, scores = _spe_run(3)
    # 5 batches x 2 epochs; per epoch iteration 0 or a window of 3, then
    # the ragged tail as singles
    assert [i for i, _ in scores] == list(range(10))
    assert all(np.isfinite(s) for _, s in scores)
    assert tr.windows == 2


def test_megastep_ragged_tail_and_signature_change_run_as_singles():
    """4 batches of 16 and a ragged 8, with BatchNorm state and dropout
    draws engaged: every batch trains, and the result is the single
    steps' bit for bit."""
    build = lambda *a: _blob_net(*a, bn=True, drop=0.25)
    a, sa = _spe_run(1, n=72, batch=16, build=build)
    b, sb = _spe_run(2, n=72, batch=16, build=build)
    # per epoch: iteration 0 (epoch 0 only) alone, windows of 2, then a
    # buffered pair whose signatures differ (16 and 8) run alone
    assert b.iteration == a.iteration == 10 and b.windows == 3
    assert sb == sa
    for p, q in zip(tree_leaves((a.params, a.state)),
                    tree_leaves((b.params, b.state))):
        assert torch.equal(p, q)


@pytest.mark.parametrize("flag", ["requires_sync", "snapshots_state"])
def test_megastep_is_off_for_sync_and_snapshot_listeners(flag):
    lst = TrainingListener()
    setattr(lst, flag, True)
    tr, scores = _spe_run(4, listeners=[lst])
    assert tr.windows == 0 and len(scores) == 10
    tr2, _ = _spe_run(4, listeners=[TrainingListener()])
    assert tr2.windows == 2


def test_performance_listener_gets_one_step_begin_per_window():
    class Spy(PerformanceListener):
        def __init__(self):
            super().__init__(frequency=9)
            self.begins = []

        def step_begin(self, batch_size):
            self.begins.append(batch_size)
            super().step_begin(batch_size)

    spy = Spy()
    _spe_run(4, epochs=1, n=90, batch=10, listeners=[spy])
    # iteration 0 alone, two windows of 4 batches of 10
    assert spy.begins == [10, 40, 40]
    assert spy.samples_per_sec > 0


# ---------------------------------------------- the graphed step (card)
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [breadth] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


def _card_run(device, spe, build, n=96, batch=16, seed=0, junk=False):
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    x, y = _blobs(n, seed)
    m = build(TL, Sequential, NetConfig, {"device": device})
    m.init(seed=5)
    tr = Trainer(m, seed=seed)
    rec = CollectScoresListener()
    tr.fit(ArrayIterator(x[:batch], y[:batch], batch_size=batch),
           listeners=[rec])
    if junk:  # allocations between capture and replay move nothing
        _ = [torch.empty(1 << 20, device=device) for _ in range(8)]
    tr.fit(ArrayIterator(x, y, batch_size=batch), listeners=[rec],
           steps_per_execution=spe)
    return tr, [l for _, l in rec.scores]


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [False, True], ids=["dense", "batchnorm"])
def test_graphed_megastep_is_bit_equal_to_eager(cuda, bn):
    build = lambda *a: _blob_net(*a, bn=bn)
    a, la = _card_run(cuda, 1, build)
    b, lb = _card_run(cuda, 3, build, junk=True)
    assert b.captures == 1 and b.windows == 2 and la == lb
    for p, q in zip(tree_leaves((a.params, a.opt_state, a.state)),
                    tree_leaves((b.params, b.opt_state, b.state))):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_graph_replays_draw_new_dropout_masks(cuda):
    """lr 0: the params never move, so a loss differs from another only
    through its dropout mask; two replays must not repeat their masks."""
    def build(L, Seq, NC, kw):
        return Seq(NC(seed=0, updater={"type": "sgd", "learning_rate": 0.0}),
                   [L.Dense(n_out=64, activation="relu", dropout=0.5),
                    L.Output(n_out=3, activation="softmax", loss="mcxent")],
                   (6,), **kw)

    tr, losses = _card_run(cuda, 2, build, n=64, batch=16)
    assert tr.captures == 1 and tr.windows == 2
    window1, window2 = losses[1:3], losses[3:5]
    assert window1 != window2 and window1[0] != window1[1]


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw", [dict(rules=[(".*", ())])],
                         ids=["mesh"])
def test_trainer_refuses_unported_options(reference_params, kw):
    """A data mesh trains (``parallel/``) and a mesh with sharding rules
    too (tensor and sequence parallelism); sharding rules without a mesh
    are refused."""
    with pytest.raises(ValueError, match="mesh="):
        Trainer(_port_lm(reference_params), **kw)


@pytest.mark.parametrize("kw", [dict(telemetry=StepTelemetry)],
                         ids=["telemetry"])
def test_fit_refuses_unported_options(reference_params, lm_batch, kw):
    """``fit`` refused ``telemetry=`` until the obs plane was ported; now
    it refuses none of its options: a ``StepTelemetry`` times every step
    (``rules=`` without a mesh is refused, by the Trainer, above)."""
    kw = {k: make() for k, make in kw.items()}
    t = Trainer(_port_lm(reference_params))
    t.fit(ArrayIterator(*lm_batch, batch_size=4), **kw)
    assert kw["telemetry"].snapshot()["steps"] == t.iteration > 0


def test_trainer_load_without_cuda_raises(reference_params, tmp_path,
                                          monkeypatch):
    path = str(tmp_path / "m.zip")
    Trainer(_port_lm(reference_params)).save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.load(path)
    assert Trainer.load(path, device="cpu").device.type == "cpu"
