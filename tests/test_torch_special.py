"""The port's special layers and solvers held against the JAX package:
``AutoEncoder`` and ``VAE`` (``nn/layers/special.py``) with
``Trainer.pretrain_layer``, the line-search solvers
(``train/solvers.py``), ``Lambda`` and ``CustomLayer``
(``nn/layers/custom.py``) and ``MoE``/``MoETransformerBlock``
(``nn/layers/moe.py``).

The two packages draw different random streams, so the sampled losses
are held at the same noise, drawn with numpy and fed to the port's loss
(``keep=``/``eps=``) and to the reference's closed form written here with
the reference layer's own encode/decode; and statistically, each
package's loss over its own draws. Tolerances: deterministic parts 1e-6
(relative to the largest entry), sampled losses at the same noise 1e-5,
``pretrain_layer`` trajectories at that noise 1e-5 of each leaf's largest
entry, solver iterates 1e-5 over the first 4 iterations and 1e-4 at 10, custom layers' forward and gradients 1e-6,
MoE forward, gradients and aux loss 1e-5 in f32 with the same tokens
dropped, and its bf16 forward one bf16 ulp (2**-7) of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        params_from_numpy)
from deeplearning4j_torch.train import solvers as TS
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.layers import moe as JMOE
from deeplearning4j_tpu.nn.layers import special as JSP
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.ops import activations as JA
from deeplearning4j_tpu.ops import losses as JLOSS
from deeplearning4j_tpu.train import solvers as JS
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

DET_TOL = 1e-6
NOISE_TOL = 1e-5
MOE_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


# ------------------------------------------------------------ AE / VAE
def _jax_ae_loss(layer, p, x, keep):
    corrupted = jnp.where(keep, x, 0.0)
    h = JA.get(layer.activation)(corrupted @ p["w"] + p["b"])
    return JLOSS.get(layer.loss)(layer.reconstruct(p, h), x)


def _jax_log_px_z(layer, out, x):
    if layer.reconstruction == "gaussian":
        rec_mu, rec_logvar = jnp.split(out, 2, axis=-1)
        return -0.5 * jnp.sum(rec_logvar + jnp.square(x - rec_mu)
                              / jnp.exp(rec_logvar) + jnp.log(2 * jnp.pi),
                              axis=-1)
    p = jnp.clip(jax.nn.sigmoid(out), 1e-7, 1 - 1e-7)
    return jnp.sum(x * jnp.log(p) + (1 - x) * jnp.log(1 - p), axis=-1)


def _jax_vae_loss(layer, p, x, eps):
    """The reference's ``VAE.pretrain_loss`` with its draws replaced by
    ``eps`` (S, B, n_out)."""
    mu, logvar = layer.encode(p, x)
    kl = -0.5 * jnp.sum(1 + logvar - jnp.square(mu) - jnp.exp(logvar),
                        axis=-1)

    def one(e):
        z = mu + jnp.exp(0.5 * logvar) * e
        return -_jax_log_px_z(layer, layer.decode(p, z), x)

    return jnp.mean(jnp.mean(jax.vmap(one)(eps), axis=0) + kl)


def _jax_vae_logp(layer, p, x, eps):
    mu, logvar = layer.encode(p, x)
    std = jnp.exp(0.5 * logvar)

    def one(e):
        z = mu + std * e
        log_pz = -0.5 * jnp.sum(jnp.square(z) + jnp.log(2 * jnp.pi), axis=-1)
        log_qz_x = -0.5 * jnp.sum(logvar + jnp.square(e)
                                  + jnp.log(2 * jnp.pi), axis=-1)
        return _jax_log_px_z(layer, layer.decode(p, z), x) + log_pz - log_qz_x

    return (jax.nn.logsumexp(jax.vmap(one)(eps), axis=0)
            - jnp.log(eps.shape[0]))


VAE_CASES = {
    "gaussian": dict(n_out=3, encoder_sizes=(10,), decoder_sizes=(9,),
                     num_samples=2),
    "bernoulli": dict(n_out=4, encoder_sizes=(8, 6), decoder_sizes=(7,),
                      reconstruction="bernoulli", activation="tanh"),
}


def _vae_pair(case):
    j = JSP.VAE(**VAE_CASES[case])
    t = TL.VAE(**VAE_CASES[case])
    p = _np(j.init(jax.random.PRNGKey(0), (12,))[0])
    rng = np.random.default_rng(1)
    x = rng.random((6, 12)).astype(np.float32)
    if case == "bernoulli":
        x = (x > 0.5).astype(np.float32)
    return j, t, p, x


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_deterministic_parts(case):
    j, t, p, x = _vae_pair(case)
    assert t.to_dict() == j.to_dict()
    tp = _t(p)
    for got, want in zip(t.encode(tp, torch.from_numpy(x)),
                         jax.jit(j.encode)(p, jnp.asarray(x))):
        assert _rel(got.numpy(), want) <= DET_TOL
    z = np.random.default_rng(2).standard_normal((6, t.n_out)).astype(
        np.float32)
    assert _rel(t.generate(tp, torch.from_numpy(z)).numpy(),
                jax.jit(j.generate)(p, jnp.asarray(z))) <= DET_TOL
    y, _, _ = t.apply(tp, {}, torch.from_numpy(x))
    assert _rel(y.numpy(), jax.jit(lambda q, v: j.apply(q, {}, v)[0])(
        p, jnp.asarray(x))) <= DET_TOL
    assert t.param_count((12,)) == j.param_count((12,))


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_sampled_losses_at_the_same_noise(case):
    j, t, p, x = _vae_pair(case)
    tp = _t(p)
    rng = np.random.default_rng(3)
    eps = rng.standard_normal((t.num_samples, 6, t.n_out)).astype(np.float32)
    got = t.pretrain_loss(tp, torch.from_numpy(x), eps=eps)
    want = jax.jit(lambda q, v, e: _jax_vae_loss(j, q, v, e))(
        p, jnp.asarray(x), jnp.asarray(eps))
    assert _rel(got.item(), want) <= NOISE_TOL
    eps = rng.standard_normal((16, 6, t.n_out)).astype(np.float32)
    got = t.reconstruction_log_probability(tp, torch.from_numpy(x), eps=eps)
    want = jax.jit(lambda q, v, e: _jax_vae_logp(j, q, v, e))(
        p, jnp.asarray(x), jnp.asarray(eps))
    assert _rel(got.numpy(), want) <= NOISE_TOL
    # the gradients at that noise
    leaves = [a.requires_grad_() for a in tree_leaves(tp)]
    g = torch.autograd.grad(t.pretrain_loss(tp, torch.from_numpy(x),
                                            eps=eps[:t.num_samples]), leaves)
    jg = jax.jit(jax.grad(lambda q: _jax_vae_loss(
        j, q, jnp.asarray(x), jnp.asarray(eps[:t.num_samples]))))(p)
    for a, b in zip(g, jax.tree_util.tree_leaves(jg)):
        assert _rel(a.numpy(), b) <= NOISE_TOL


def test_vae_sampled_loss_statistically():
    """Each package's loss over its own 256 draws: the means agree within
    5 standard errors of their difference."""
    j, t, p, x = _vae_pair("gaussian")
    tp = _t(p)
    gen = torch.Generator().manual_seed(0)
    tl = np.array([t.pretrain_loss(tp, torch.from_numpy(x), gen).item()
                   for _ in range(256)])
    f = jax.jit(lambda k: j.pretrain_loss(p, jnp.asarray(x), k))
    jl = np.array([float(f(k)) for k in jax.random.split(
        jax.random.PRNGKey(0), 256)])
    se = np.sqrt(tl.var() / len(tl) + jl.var() / len(jl))
    assert abs(tl.mean() - jl.mean()) <= 5 * se
    assert tl.std() > 0


def _ae_pair(level=0.3, loss="mse"):
    j = JSP.AutoEncoder(n_out=5, corruption_level=level, loss=loss)
    t = TL.AutoEncoder(n_out=5, corruption_level=level, loss=loss)
    p = _np(j.init(jax.random.PRNGKey(0), (9,))[0])
    p["b"] = p["b"] + 0.1
    p["vb"] = p["vb"] - 0.05
    x = np.random.default_rng(1).random((7, 9)).astype(np.float32)
    return j, t, p, x


@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_at_the_same_noise(loss):
    j, t, p, x = _ae_pair(loss=loss)
    tp = _t(p)
    y, _, _ = t.apply(tp, {}, torch.from_numpy(x))
    assert _rel(y.numpy(), j.apply(p, {}, jnp.asarray(x))[0]) <= DET_TOL
    h = y
    assert _rel(t.reconstruct(tp, h).numpy(),
                j.reconstruct(p, jnp.asarray(h.numpy()))) <= DET_TOL
    keep = np.random.default_rng(2).random(x.shape) < 0.7
    got = t.pretrain_loss(tp, torch.from_numpy(x), keep=keep)
    assert _rel(got.item(), _jax_ae_loss(j, p, jnp.asarray(x),
                                         jnp.asarray(keep))) <= NOISE_TOL
    # no noise: the reference's own loss
    assert _rel(t.pretrain_loss(tp, torch.from_numpy(x)).item(),
                j.pretrain_loss(p, jnp.asarray(x))) <= DET_TOL


def test_autoencoder_corruption_statistically():
    """The port's corruption keeps each input with probability 0.7: over
    4096 entries, within 4 sigma; and the loss uses that mask."""
    t = TL.AutoEncoder(n_out=2, corruption_level=0.3)
    x = torch.ones((64, 64))
    keep = t.corruption_mask(x, torch.Generator().manual_seed(0))
    kept = keep.float().mean().item()
    assert abs(kept - 0.7) <= 4 * np.sqrt(0.7 * 0.3 / 4096)
    p, _ = t.init(torch.Generator().manual_seed(1), (64,))
    drawn = t.pretrain_loss(p, x, torch.Generator().manual_seed(0))
    assert drawn.item() == t.pretrain_loss(p, x, keep=keep).item()


def _pre_model(L, S, NC, layer, **kw):
    return S(NC(seed=0), [L.Dense(n_out=9, activation="tanh"), layer,
                          L.Output(n_out=3, activation="softmax")], (6,),
             **kw)


@pytest.mark.parametrize("kind", ["ae", "vae"])
def test_pretrain_layer_trajectory_at_the_same_noise(kind):
    if kind == "ae":
        jl, tl = (JSP.AutoEncoder(n_out=4, corruption_level=0.25),
                  TL.AutoEncoder(n_out=4, corruption_level=0.25))
    else:
        jl, tl = JSP.VAE(**VAE_CASES["gaussian"]), TL.VAE(
            **VAE_CASES["gaussian"])
    jm = _pre_model(JL, JSequential, JNetConfig, jl)
    jp, _ = jm.init()
    jp = _np(jp)
    tm = _pre_model(TL, Sequential, NetConfig, tl, device="cpu")
    tm.params = params_from_numpy(tm, jp)
    tm.state = {}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((24, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    steps, lr = 6, 1e-2
    if kind == "ae":
        noise = [rng.random((8, 9)) < 0.75 for _ in range(steps)]
        loss_j = lambda p, f, n: _jax_ae_loss(jl, p, f, n)
    else:
        noise = [rng.standard_normal((2, 8, 3)).astype(np.float32)
                 for _ in range(steps)]
        loss_j = lambda p, f, n: _jax_vae_loss(jl, p, f, n)
    # the reference's pretrain loop (optax adam on the layer's params, the
    # features of the layers below in inference mode) at this noise
    tx = optax.adam(lr)
    lp = jax.tree.map(jnp.asarray, jp["layer_1"])
    opt = tx.init(lp)
    @jax.jit
    def step(lp, opt, xb, n):
        feats, _ = jm.forward(jp, {}, xb, training=False, up_to=1)
        loss, g = jax.value_and_grad(loss_j)(lp, feats, n)
        u, opt = tx.update(g, opt, lp)
        return optax.apply_updates(lp, u), opt, loss

    for i in range(steps):
        xb = jnp.asarray(x[(i % 3) * 8:(i % 3 + 1) * 8])
        lp, opt, loss = step(lp, opt, xb, jnp.asarray(noise[i]))
    t = Trainer(tm)
    got = t.pretrain_layer(1, ArrayIterator(x, y, batch_size=8), epochs=2,
                           learning_rate=lr,
                           noise=lambda step, feats: noise[step])
    assert _rel(got, loss) <= NOISE_TOL
    for a, b in zip(tree_leaves(t.params["layer_1"]),
                    jax.tree_util.tree_leaves(lp)):
        assert _rel(a.detach().numpy(), b) <= NOISE_TOL
    # the layers around it are untouched
    for k in ("layer_0", "layer_2"):
        for a, b in zip(tree_leaves(t.params[k]),
                        jax.tree_util.tree_leaves(jp[k])):
            assert np.array_equal(a.detach().numpy(), b)


def test_pretrain_layer_matches_reference_without_noise():
    """An AutoEncoder with no corruption pretrains deterministically in
    both packages: the reference's own ``pretrain_layer``."""
    jl, tl = (JSP.AutoEncoder(n_out=4, corruption_level=0.0),
              TL.AutoEncoder(n_out=4, corruption_level=0.0))
    jm = _pre_model(JL, JSequential, JNetConfig, jl)
    jp, _ = jm.init()
    jp = _np(jp)
    tm = _pre_model(TL, Sequential, NetConfig, tl, device="cpu")
    tm.params = params_from_numpy(tm, jp)
    tm.state = {}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jt = JTrainer(jm)
    want = jt.pretrain_layer(1, JArrayIterator(x, y, batch_size=8), epochs=3)
    t = Trainer(tm)
    got = t.pretrain_layer(1, ArrayIterator(x, y, batch_size=8), epochs=3)
    assert _rel(got, want) <= NOISE_TOL
    for a, b in zip(tree_leaves(t.params["layer_1"]),
                    jax.tree_util.tree_leaves(jt.params["layer_1"])):
        assert _rel(a.detach().numpy(), b) <= NOISE_TOL


def test_pretrain_layer_refuses_other_layers():
    tm = _pre_model(TL, Sequential, NetConfig, TL.Dense(n_out=4),
                    device="cpu")
    tm.init()
    with pytest.raises(TypeError, match="not pretrainable"):
        Trainer(tm).pretrain_layer(1, [])


# ------------------------------------------------------------ solvers
def _solver_net(L, S, NC, **kw):
    return S(NC(seed=0), [L.Dense(n_out=6, activation="tanh"),
                          L.Output(n_out=3, activation="softmax")], (4,),
             **kw)


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_solver_iterates_match_reference(algo):
    jm = _solver_net(JL, JSequential, JNetConfig)
    jp, _ = jm.init()
    tm = _solver_net(TL, Sequential, NetConfig, device="cpu")
    tm.params = params_from_numpy(tm, _np(jp))
    tm.state = {}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    # the first iterates within 1e-5; later ones within 1e-4: the two sum
    # the f32 dot products in other orders, and the line search's and the
    # curvature pairs' decisions carry that forward (lbfgs at 8 iterations
    # measured 1.6e-5, at 10 4.5e-6)
    for iters, tol in ((1, NOISE_TOL), (2, NOISE_TOL), (4, NOISE_TOL),
                       (10, 1e-4)):
        jm.params = jax.tree.map(jnp.asarray, _np(jp))
        jr = JS.Solver(jm, algo, max_iterations=iters).optimize(x, y)
        tm.params = params_from_numpy(tm, _np(jp))
        tr = TS.Solver(tm, algo, max_iterations=iters).optimize(x, y)
        assert (tr.iterations, tr.converged) == (jr.iterations, jr.converged)
        assert _rel(tr.score, jr.score) <= tol
        for a, b in zip(tree_leaves(tr.params),
                        jax.tree_util.tree_leaves(jr.params)):
            assert _rel(a.numpy(), b) <= tol
    assert tr.score < float(jm.score(jax.tree.map(jnp.asarray, _np(jp)), {},
                                     x, y, training=False)[0])


def test_backtrack_line_search_matches_reference():
    rng = np.random.default_rng(7)
    a = rng.standard_normal(5).astype(np.float32)
    x = rng.standard_normal(5).astype(np.float32)
    d = (-3 * rng.standard_normal(5)).astype(np.float32) * 40

    def fj(v):
        return jnp.sum(jnp.square(v - a)) + jnp.sum(jnp.cos(v))

    def ft(v):
        return torch.sum(torch.square(v - torch.from_numpy(a))) \
            + torch.sum(torch.cos(v))

    g = jax.grad(fj)(jnp.asarray(x))
    js, jf = JS.backtrack_line_search(fj, jnp.asarray(x), fj(jnp.asarray(x)),
                                      g, jnp.asarray(d))
    ts, tf = TS.backtrack_line_search(ft, torch.from_numpy(x),
                                      ft(torch.from_numpy(x)),
                                      torch.from_numpy(np.asarray(g)),
                                      torch.from_numpy(d))
    assert _rel(ts.item(), js) <= NOISE_TOL and _rel(tf.item(), jf) <= NOISE_TOL


# ------------------------------------------------------------ custom
def test_lambda_forward_and_gradient():
    jl = JL.Lambda(fn="jax_custom_fns:scaled_tanh", config={"scale": 1.5})
    tl = TL.Lambda(fn="torch_custom_fns:scaled_tanh", config={"scale": 1.5})
    d = dict(tl.to_dict())
    assert d == {**jl.to_dict(), "fn": "torch_custom_fns:scaled_tanh"}
    assert not tl.has_params()
    x = np.random.default_rng(8).standard_normal((3, 5)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    y, _, _ = tl.apply({}, {}, xt)
    assert _rel(y.detach().numpy(), jl.apply({}, {}, jnp.asarray(x))[0]) \
        <= DET_TOL
    (g,) = torch.autograd.grad(y.sum(), xt)
    jg = jax.grad(lambda v: jl.apply({}, {}, v)[0].sum())(jnp.asarray(x))
    assert _rel(g.numpy(), jg) <= DET_TOL


@pytest.mark.parametrize("training", [False, True])
def test_custom_layer_forward_and_gradients(training):
    cfg = {"n_out": 4}
    jl = JL.CustomLayer(fn="jax_custom_fns:affine",
                        init_fn="jax_custom_fns:affine_init", config=cfg,
                        out_shape=(4,))
    tl = TL.CustomLayer(fn="torch_custom_fns:affine",
                        init_fn="torch_custom_fns:affine_init", config=cfg,
                        out_shape=(4,))
    p, _ = jl.init(jax.random.PRNGKey(0), (5,))
    p = _np(p)
    tp, _ = tl.init(torch.Generator().manual_seed(0), (5,))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in p.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    x = np.random.default_rng(9).standard_normal((3, 5)).astype(np.float32)
    y, _, _ = tl.apply(tp, {}, torch.from_numpy(x), training=training)
    assert _rel(y.detach().numpy(),
                jl.apply(p, {}, jnp.asarray(x), training=training)[0]) \
        <= DET_TOL
    g = torch.autograd.grad((y * y).sum(), [tp["b"], tp["w"]])
    jg = jax.grad(lambda q: jnp.sum(jnp.square(jl.apply(
        q, {}, jnp.asarray(x), training=training)[0])))(p)
    for a, b in zip(g, jax.tree_util.tree_leaves(jg)):
        assert _rel(a.numpy(), b) <= DET_TOL


def test_custom_layer_in_a_model_trains():
    m = Sequential(NetConfig(seed=0, updater={"type": "sgd",
                                              "learning_rate": 0.1}), [
        TL.CustomLayer(fn="torch_custom_fns:affine",
                       init_fn="torch_custom_fns:affine_init",
                       config={"n_out": 4}, out_shape=(4,)),
        TL.Lambda(fn="torch_custom_fns:scaled_tanh"),
        TL.Output(n_out=2, activation="softmax")], (5,), device="cpu")
    m.init()
    rng = np.random.default_rng(10)
    x = rng.standard_normal((16, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    rec = CollectScoresListener()
    Trainer(m).fit(ArrayIterator(x, y, batch_size=16), epochs=20,
                   listeners=[rec])
    assert rec.scores[-1][1] < rec.scores[0][1]
    assert Sequential.from_json(m.to_json(), device="cpu").to_json() == \
        m.to_json()


# ------------------------------------------------------------ MoE
MOE = dict(num_experts=4, top_k=2, mlp_ratio=2, capacity_factor=0.5)


def _moe_params(layer, d, seed=0):
    p, _ = layer.init(jax.random.PRNGKey(seed), (d,))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), p)


def _moe_out(layer, p, x, mask, training):
    y, s, _ = layer.apply(p, {}, x, training=training, mask=mask)
    return y, s["aux_loss"]


@pytest.mark.parametrize("masked", [False, True])
def test_moe_forward_gradients_and_aux(masked):
    j, t = JMOE.MoE(**MOE), TL.MoE(**MOE)
    assert t.to_dict() == j.to_dict()
    p = _moe_params(j, 8)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([[6], [4]])).astype(np.float32) \
        if masked else None
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jy, jaux = jax.jit(lambda q, v: _moe_out(j, q, v, mask, True))(
        p, jnp.asarray(x))
    tp = _t(p)
    leaves = [a.requires_grad_() for a in tree_leaves(tp)]
    xt = torch.tensor(x, requires_grad=True)
    ty, taux = _moe_out(t, tp, xt,
                        None if mask is None else torch.from_numpy(mask),
                        True)
    assert _rel(ty.detach().numpy(), jy) <= MOE_TOL
    assert _rel(taux.item(), jaux) <= MOE_TOL and taux.item() > 0
    # the same tokens dropped: their rows exactly 0 in both
    jz = np.all(np.asarray(jy) == 0, axis=-1)
    tz = np.all(ty.detach().numpy() == 0, axis=-1)
    np.testing.assert_array_equal(tz, jz)
    assert jz.sum() > (4 if masked else 0)
    g = torch.autograd.grad((ty * torch.from_numpy(dy)).sum() + taux,
                            [xt] + leaves)

    def f(q, xx):
        y, aux = _moe_out(j, q, xx, mask, True)
        return jnp.sum(y * dy) + aux

    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert _rel(g[0].numpy(), jgx) <= MOE_TOL
    for a, b in zip(g[1:], jax.tree_util.tree_leaves(jgp)):
        assert _rel(a.numpy(), b) <= MOE_TOL
    # inference: no aux loss
    _, aux = _moe_out(t, tp, xt, None, False)
    assert aux.item() == 0.0


def test_moe_ties_break_to_the_lower_expert():
    """Two router columns equal: their probabilities tie, and both
    packages route to the lower expert index first (jax.lax.top_k's
    order)."""
    j, t = JMOE.MoE(num_experts=4, top_k=1, mlp_ratio=2,
                    capacity_factor=4.0), \
        TL.MoE(num_experts=4, top_k=1, mlp_ratio=2, capacity_factor=4.0)
    p = _moe_params(j, 8, seed=1)
    p["w_router"][:, 3] = p["w_router"][:, 1]
    p["w_router"][:, 0] = -10.0 * np.abs(p["w_router"][:, 0])
    p["w_router"][:, 2] = -10.0 * np.abs(p["w_router"][:, 2])
    x = np.abs(np.random.default_rng(12).standard_normal((10, 8))).astype(
        np.float32)
    _, idx, dispatch, _ = t.route(_t(p), torch.from_numpy(x))
    assert (idx[:, 0] == 1).all()
    jy, _ = jax.jit(lambda q, v: _moe_out(j, q, v, None, False))(
        p, jnp.asarray(x))
    ty, _ = _moe_out(t, _t(p), torch.from_numpy(x), None, False)
    assert _rel(ty.numpy(), jy) <= MOE_TOL


def test_moe_capacity_is_the_reference_int():
    t = TL.MoE(num_experts=3, top_k=2, capacity_factor=1.25)
    p, _ = t.init(torch.Generator().manual_seed(0), (4,))
    _, _, dispatch, _ = t.route(p, torch.zeros((7, 4)))
    assert dispatch.shape == (7, 3, int(1.25 * 7 * 2 / 3))


BLOCK = dict(num_heads=2, num_experts=4, top_k=2, mlp_ratio=2, causal=True)


def _lm(L, S, NC, flash, **kw):
    return S(NC(seed=0), [
        L.EmbeddingSequence(n_in=20, n_out=16),
        L.MoETransformerBlock(flash=flash, **BLOCK),
        L.MoETransformerBlock(flash=flash, **BLOCK),
        L.RnnOutput(n_out=20)], (12,), **kw)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_moe_block_model_score_and_trajectory(flash):
    jm = _lm(JL, JSequential, JNetConfig, flash)
    jp, js = jm.init()
    jp = _np(jp)
    tm = _lm(TL, Sequential, NetConfig, flash, device="cpu")
    tm.params = params_from_numpy(tm, jp)
    tm.state = {}
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 20, (4, 12)).astype(np.int32)
    y = np.eye(20, dtype=np.float32)[rng.integers(0, 20, (4, 12))]
    jl, _ = jax.jit(lambda q, i, t: jm.score(q, js, i, t, training=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(ids), jnp.asarray(y))
    tl, tst = tm.score(tm.params, {}, torch.from_numpy(ids),
                       torch.from_numpy(y), training=True)
    aux = sum(float(s["aux_loss"]) for s in tst.values())
    assert aux > 0 and _rel(tl.item(), jl) <= MOE_TOL
    jm.params, jm.state = jax.tree.map(jnp.asarray, jp), js
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    jt = JTrainer(jm).fit(JArrayIterator(ids, y, batch_size=2), epochs=2,
                          listeners=[jrec], prefetch=False)
    tt = Trainer(tm).fit(ArrayIterator(ids, y, batch_size=2), epochs=2,
                         listeners=[trec], prefetch=False)
    np.testing.assert_allclose([l for _, l in trec.scores],
                               [l for _, l in jrec.scores], rtol=1e-4)
    for a, b in zip(tree_leaves(tt.params),
                    jax.tree_util.tree_leaves(jt.params)):
        assert _rel(a.detach().numpy(), b) <= 1e-4


def test_moe_block_bf16_forward():
    """bf16 compute: the block's output within one bf16 ulp of the largest
    entry of the reference's (compiled without excess precision)."""
    j = JMOE.MoETransformerBlock(**BLOCK)
    t = TL.MoETransformerBlock(**BLOCK)
    p = _moe_params(j, 16)
    x = np.random.default_rng(14).standard_normal((2, 10, 16)).astype(
        np.float32)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    f = jax.jit(lambda q, v: j.apply(q, {}, v)[0]).lower(
        pb, jnp.asarray(x, jnp.bfloat16)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(f(pb, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tpb = jax.tree.map(lambda a: torch.tensor(a).to(torch.bfloat16), p)
    got, _, _ = t.apply(tpb, {}, torch.tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= BF16_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [train_api] phase "
                    "runs the MoE LM with flash attention on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_moe_block_flash_on_card(cuda):
    """The MoE block with flash=True on the card: one flash forward launch
    (K1) a call, and its output within one bf16 ulp of the largest entry
    of the CPU's f32 forward on the same bf16 params."""
    from deeplearning4j_torch.ops.flash_attention import flash_fwd_cuda

    blk = TL.MoETransformerBlock(num_heads=2, num_experts=4, top_k=2,
                                 causal=True, flash=True)
    p, _ = blk.init(torch.Generator().manual_seed(0), (64,))
    x = torch.randn((2, 128, 64), generator=torch.Generator().manual_seed(1))
    want, _, _ = blk.apply(p, {}, x)
    before = flash_fwd_cuda.launches
    got, _, _ = blk.apply(jax.tree.map(lambda t: t.to(cuda), p), {},
                          x.to(cuda))
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == before + 1
    assert _rel(got.cpu().numpy(), want.numpy()) <= BF16_TOL


SPECIAL_TYPES = {
    "Frozen": dict(inner={"@type": "Dense", "n_out": 3}),
    "AutoEncoder": dict(n_out=4, corruption_level=0.1),
    "VAE": dict(n_out=3, encoder_sizes=(8,), reconstruction="bernoulli"),
    "Lambda": dict(fn="m:f", config={"a": 1}, out_shape=(2,)),
    "CustomLayer": dict(fn="m:f", init_fn="m:g"),
    "MoE": dict(num_experts=3, capacity_factor=2.0),
    "MoETransformerBlock": dict(num_heads=2, flash=True, causal=True),
}


@pytest.mark.parametrize("kind", sorted(SPECIAL_TYPES))
def test_special_layer_json_both_ways(kind):
    """Each layer type of the reference's special, custom and moe modules
    reads the JSON the JAX package writes and writes JSON it reads."""
    from deeplearning4j_torch.nn.api import layer_from_dict
    from deeplearning4j_tpu.nn.api import layer_from_dict as jfrom

    j = jfrom({"@type": kind, "name": f"my_{kind.lower()}",
               **SPECIAL_TYPES[kind]})
    t = layer_from_dict(j.to_dict())
    assert type(t).__name__ == kind
    assert t.to_dict() == j.to_dict()
    assert jfrom(t.to_dict()).to_dict() == j.to_dict()
    assert t.has_params() == j.has_params()
