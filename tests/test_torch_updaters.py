"""The port's updaters and gradient normalizations
(``deeplearning4j_torch/ops/updaters.py``) held against the JAX
package's optax pipelines.

The same params (a small MLP's, from a numpy seed) and the same five
gradients go through both: every updater alone, every gradient
normalization before adam and before sgd, and ``build_updater``'s
multi-transform over a model with a ``Frozen`` layer and a layer with its
own updater. After each step every param, and at the end every leaf of
the updater state, is within 1e-6 of optax's, relative to the largest
entry of the reference's leaf (counts exactly); the state has optax's
leaves in optax's order, and crosses between the packages through the
model zip in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops import updaters as TU
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (Trainer, build_updater,
                                        load_opt_state, params_from_numpy,
                                        save_model)
from deeplearning4j_torch.train.trainer import _leaf_owners
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.ops import updaters as JU
from deeplearning4j_tpu.train import serialization as JS
from deeplearning4j_tpu.train.trainer import build_updater as jbuild_updater

TOL = 1e-6
STEPS = 5

UPDATERS = {
    "sgd": {"type": "sgd", "learning_rate": 0.1},
    "nesterovs": {"type": "nesterovs", "learning_rate": 0.05,
                  "momentum": 0.9},
    "adam": {"type": "adam", "learning_rate": 1e-2},
    "adamw": {"type": "adamw", "learning_rate": 1e-2, "weight_decay": 0.1},
    "amsgrad": {"type": "amsgrad", "learning_rate": 1e-2},
    "adamax": {"type": "adamax", "learning_rate": 1e-2},
    "nadam": {"type": "nadam", "learning_rate": 1e-2},
    "adagrad": {"type": "adagrad", "learning_rate": 0.1},
    "adadelta": {"type": "adadelta", "rho": 0.9},
    "rmsprop": {"type": "rmsprop", "learning_rate": 1e-2},
    "noop": {"type": "noop"},
}
GRADNORMS = ["RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
             "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
             "ClipL2PerParamType", "clip_l2_per_layer"]


def _mlp(pkg):
    L, NC, S = ((JL, JNetConfig, JSequential) if pkg == "jax"
                else (TL, NetConfig, Sequential))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return S(NC(seed=0), [L.Dense(n_out=4, activation="tanh"),
                          L.Dense(n_out=3, activation="tanh"),
                          L.Output(n_out=2, activation="softmax")],
             (3,), **kw)


@pytest.fixture(scope="module")
def mlp_params():
    p, _ = _mlp("jax").init()
    return jax.tree.map(np.asarray, p)


def _grads(params, seed):
    """STEPS gradient trees shaped as ``params``, from a numpy seed (some
    entries large, so the clips and norms bite)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    return [jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(a.shape) * (1 + 3 * (i % 2))).astype(np.float32)
        for a in leaves]) for i in range(STEPS)]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3g}"


def _run_both(jtx, ttx, params, grads):
    """STEPS updates in both packages from the same params and gradients;
    the params are compared after every step. Returns the two states."""
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = [torch.tensor(a) for a in jax.tree_util.tree_leaves(params)]
    ts = ttx.init(tp)
    for i, g in enumerate(grads):
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update([torch.tensor(a) for a in
                             jax.tree_util.tree_leaves(g)], ts, tp)
        with torch.no_grad():
            for p, d in zip(tp, tu):
                if d is not None:
                    p.add_(d)
        for k, (a, b) in enumerate(zip(tp, jax.tree_util.tree_leaves(jp))):
            _close(a.numpy(), b, f"step {i} param {k}")
    return js, ts


def _same_state(js, ts):
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    tl = [a.numpy() for a in tree_leaves(ts)]
    assert [(a.shape, a.dtype) for a in tl] == [(a.shape, a.dtype) for a in jl]
    for k, (a, b) in enumerate(zip(tl, jl)):
        _close(a, b, f"state leaf {k}")


@pytest.mark.parametrize("kind", sorted(UPDATERS))
def test_updater_matches_optax(mlp_params, kind):
    cfg = UPDATERS[kind]
    js, ts = _run_both(JU.build(dict(cfg)), TU.build(dict(cfg)), mlp_params,
                       _grads(mlp_params, 1))
    _same_state(js, ts)


@pytest.mark.parametrize("base", ["adam", "sgd"])
@pytest.mark.parametrize("norm", GRADNORMS)
def test_gradient_normalization_matches_reference(mlp_params, norm, base):
    owners = _leaf_owners(mlp_params)
    jtx = JU.build(dict(UPDATERS[base]), gradient_normalization=norm,
                   gradient_normalization_threshold=0.5)
    ttx = TU.build(dict(UPDATERS[base]), gradient_normalization=norm,
                   gradient_normalization_threshold=0.5, owners=owners)
    js, ts = _run_both(jtx, ttx, mlp_params, _grads(mlp_params, 2))
    _same_state(js, ts)


def _masked_model(pkg, updater, norm):
    """A Sequential with a frozen layer between trainable ones and a layer
    with its own updater (the reference's multi-transform labels)."""
    L, NC, S = ((JL, JNetConfig, JSequential) if pkg == "jax"
                else (TL, NetConfig, Sequential))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    cfg = NC(seed=0, updater=dict(UPDATERS[updater]),
             gradient_normalization=norm,
             gradient_normalization_threshold=0.5, l2=1e-3)
    return S(cfg, [
        L.Dense(n_out=5, activation="tanh"),
        L.Frozen(inner=L.Dense(n_out=4, activation="tanh").to_dict()),
        L.Dense(n_out=3, activation="tanh",
                updater={"type": "adam", "learning_rate": 1e-2}),
        L.Output(n_out=2, activation="softmax")], (3,), **kw)


@pytest.mark.parametrize("norm", ["RenormalizeL2PerLayer", "ClipL2PerLayer",
                                  "ClipElementWiseAbsoluteValue"])
@pytest.mark.parametrize("updater", ["nesterovs", "adagrad", "amsgrad"])
def test_multi_transform_with_frozen_and_override(updater, norm):
    jm = _masked_model("jax", updater, norm)
    params = jax.tree.map(np.asarray, jm.init()[0])
    tm = _masked_model("torch", updater, norm)
    js, ts = _run_both(jbuild_updater(jm), build_updater(tm), params,
                       _grads(params, 3))
    _same_state(js, ts)
    # the frozen layer's leaves: untouched, and no state of their own
    frozen = jax.tree_util.tree_leaves(params["layer_1"])
    assert all(np.array_equal(a, b) for a, b in zip(
        frozen, jax.tree_util.tree_leaves(params["layer_1"])))


def test_trainer_keeps_frozen_leaves_out_of_autograd(mlp_params):
    tm = _masked_model("torch", "nesterovs", "RenormalizeL2PerLayer")
    tm.init()
    t = Trainer(tm)
    frozen = {id(p) for p in tree_leaves(t.params["layer_1"])}
    assert all(p.requires_grad == (id(p) not in frozen)
               for p in tree_leaves(t.params))
    before = [p.clone() for p in tree_leaves(t.params["layer_1"])]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    t.params, t.opt_state, t.state, loss = t.step(
        t.params, t.opt_state, t.state, x, y)
    assert np.isfinite(float(loss))
    for a, b in zip(before, tree_leaves(t.params["layer_1"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(UPDATERS))
def test_updater_state_crosses_the_zip(mlp_params, kind, tmp_path):
    cfg = UPDATERS[kind]
    js, ts = _run_both(JU.build(dict(cfg)), TU.build(dict(cfg)), mlp_params,
                       _grads(mlp_params, 4))
    jm, tm = _mlp("jax"), _mlp("torch")
    tparams = params_from_numpy(tm, mlp_params)
    # the port's state into the reference
    path = str(tmp_path / "port.zip")
    save_model(path, tm, params=tparams, opt_state=ts)
    template = JU.build(dict(cfg)).init(jax.tree.map(jnp.asarray, mlp_params))
    _, _, _, loaded, _ = JS.load_model(path, opt_state_template=template)
    _same_state(loaded, ts)
    # the reference's state into the port
    path = str(tmp_path / "ref.zip")
    JS.save_model(path, jm, params=mlp_params, opt_state=js)
    got = load_opt_state(path, TU.build(dict(cfg)).init(
        tree_leaves(tparams)))
    _same_state(js, got)


def test_unknown_gradient_normalization_raises():
    with pytest.raises(ValueError, match="Unknown gradient normalization"):
        TU.build("sgd", gradient_normalization="ClipSomething")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [train_api] phase "
                    "runs this check on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(UPDATERS))
def test_updater_on_card_matches_cpu(cuda, mlp_params, kind):
    """The same gradients through the updater on the card and on the CPU:
    params within 1e-6 of each leaf's largest entry."""
    leaves = [torch.tensor(a) for a in jax.tree_util.tree_leaves(mlp_params)]
    dev = [t.to(cuda) for t in leaves]
    tx_cpu, tx_dev = TU.build(dict(UPDATERS[kind])), TU.build(
        dict(UPDATERS[kind]))
    s_cpu, s_dev = tx_cpu.init(leaves), tx_dev.init(dev)
    for g in _grads(mlp_params, 5):
        g = [torch.tensor(a) for a in jax.tree_util.tree_leaves(g)]
        u_cpu, s_cpu = tx_cpu.update(g, s_cpu, leaves)
        u_dev, s_dev = tx_dev.update([t.to(cuda) for t in g], s_dev, dev)
        for ps, us in ((leaves, u_cpu), (dev, u_dev)):
            for p, u in zip(ps, us):
                if u is not None:
                    p.add_(u)
    for a, b in zip(dev, leaves):
        _close(a.cpu().numpy(), b.numpy(), kind)


def test_own_updater_gets_zeros_for_frozen_leaves():
    """A caller's updater sees a frozen leaf's zero gradient (the
    reference's stop-gradient), so weight decay moves it as optax's would;
    the leaf still takes no gradient."""
    tm = _masked_model("torch", "nesterovs", None)
    tm.init()
    t = Trainer(tm, updater=TU.build("sgd", l2=0.5))
    before = [p.clone() for p in tree_leaves(t.params["layer_1"])]
    assert not any(p.requires_grad for p in tree_leaves(t.params["layer_1"]))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    t.step(t.params, t.opt_state, t.state, x, y)
    for a, b in zip(before, tree_leaves(t.params["layer_1"])):
        torch.testing.assert_close(b, a - 0.1 * 0.5 * a)
