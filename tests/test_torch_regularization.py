"""The port's dropout, noise and constraint ops and layers
(``deeplearning4j_torch/ops/regularization.py``, the dropout layers of
``nn/layers/core.py``, input dropout through ``nn/api.py``, attention and
block dropout) held against the JAX package.

Two RNGs cannot agree bit for bit, so random ops are checked by their
statistics and by their exact arithmetic: a kept unit is exactly
``x / keep`` (f32 and bf16), the keep fraction lies within 4 sigma of
``keep`` (binomial), alpha and gaussian dropout have the formula's mean
and variance within 4 sigma of the sample estimate. At rate 0 and in
eval mode every op is the identity, bit for bit. The constraints are
deterministic and equal the JAX package's exactly on seeded inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.api import (apply_input_dropout, draws_random,
                                         layer_from_dict)
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops import regularization as reg
from deeplearning4j_torch.ops.activations import weak_scalar
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.api import layer_from_dict as jlayer_from_dict
from deeplearning4j_tpu.ops import regularization as jreg

SIGMAS = 4.0


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _x(shape=(64, 257), dtype=torch.float32, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + 3.0).to(dtype)


# ------------------------------------------------------------ identities
@pytest.mark.parametrize("name", sorted(reg.DROPOUTS))
def test_dropouts_at_rate_zero_and_in_eval_are_identity(name):
    x = _x()
    fn = reg.DROPOUTS[name]
    assert fn(_gen(), x, 0.0) is x
    assert fn(_gen(), x, 0.5, training=False) is x
    assert reg.apply_dropout_config(_gen(), x, None, True) is x
    params = {"a": {"w": _x((3, 4))}, "b": _x((5,))}
    assert reg.weight_noise(_gen(), params, 0.0) is params
    assert reg.weight_noise(_gen(), params, 0.1, training=False) is params
    assert reg.drop_connect(_gen(), params, 0.0) is params
    assert reg.drop_connect(_gen(), params, 0.5, training=False) is params


@pytest.mark.parametrize("layer", [
    TL.DropoutLayer(rate=0.5), TL.GaussianNoise(stddev=0.3),
    TL.GaussianDropout(rate=0.4), TL.AlphaDropout(rate=0.2),
    TL.Dense(n_out=7, dropout=0.5), TL.Conv2D(n_out=3, dropout=0.5),
    TL.Output(n_out=5, dropout={"type": "gaussian_dropout", "rate": 0.3}),
], ids=lambda l: type(l).__name__)
def test_layers_in_eval_are_deterministic_and_rate_zero_is_identity(layer):
    shape = (2, 6, 6, 4) if isinstance(layer, TL.Conv2D) else (8, 12)
    x = _x(shape)
    params, state = layer.init(_gen(), shape[1:])
    y_eval, _, _ = layer.apply(params, state, x, training=False)
    y_eval2, _, _ = layer.apply(params, state, x, training=False, rng=_gen(9))
    assert torch.equal(y_eval, y_eval2)
    assert draws_random(layer)
    zero = dataclasses.replace(
        layer, **({"dropout": 0.0} if layer.dropout is not None else
                  {f: 0.0 for f in ("rate", "stddev") if hasattr(layer, f)}))
    assert not draws_random(zero)
    y0, _, _ = zero.apply(params, state, x, training=True, rng=_gen())
    assert torch.equal(y0, y_eval)


# ----------------------------------------------------- dropout statistics
def _within(count, n, p):
    sigma = (n * p * (1 - p)) ** 0.5
    return abs(count - n * p) <= SIGMAS * sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_dropout_keeps_exactly_x_over_keep(rate, dtype):
    x = _x(dtype=dtype)
    y = reg.dropout(_gen(3), x, rate)
    keep = 1.0 - rate
    kept = y != 0
    assert y.dtype == dtype
    # x / keep in x's dtype, keep rounded to it first (bf16: 0.8 is
    # 0.80078125) as a weakly typed JAX scalar is
    assert torch.equal(y[kept], x[kept] / weak_scalar(keep, dtype))
    assert _within(int(kept.sum()), x.numel(), keep)
    # JAX's own inverted dropout keeps the same values, in the same dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jy = np.asarray(jreg.dropout(jax.random.PRNGKey(0),
                                 jnp.asarray(x.float().numpy()).astype(jdt),
                                 rate).astype(jnp.float32))
    jk = jy != 0
    np.testing.assert_array_equal(
        jy[jk], (x[torch.from_numpy(jk)] / weak_scalar(keep, dtype))
        .float().numpy())


def test_spatial_dropout_draws_once_per_example_and_channel():
    x = _x((16, 5, 7, 32))
    y = reg.spatial_dropout(_gen(4), x, 0.5)
    kept = y != 0
    # every (example, channel) is kept or dropped as a whole map
    per_map = kept.all(dim=(1, 2)) | (~kept).all(dim=(1, 2))
    assert bool(per_map.all())
    maps = kept[:, 0, 0, :]
    assert _within(int(maps.sum()), maps.numel(), 0.5)
    assert torch.equal(y[kept], x[kept] / 0.5)


def test_alpha_dropout_keeps_mean_and_variance():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((400, 500)).astype(np.float32))
    y = reg.alpha_dropout(_gen(5), x, 0.3)
    n = y.numel()
    mean, var = float(y.mean()), float(y.var())
    # self-normalizing: a standard normal input keeps mean 0, variance 1
    assert abs(mean) <= SIGMAS * (var / n) ** 0.5
    assert abs(var - 1.0) <= SIGMAS * (2.0 / n) ** 0.5 * 2.0
    # the layer uses the reference layer's own constants
    yl, _, _ = TL.AlphaDropout(rate=0.3).apply({}, {}, x, training=True,
                                               rng=_gen(5))
    assert abs(float(yl.mean())) <= SIGMAS * (float(yl.var()) / n) ** 0.5


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_gaussian_dropout_has_unit_mean_noise_of_the_formulas_variance(rate):
    x = torch.ones((400, 500))
    y = reg.gaussian_dropout(_gen(6), x, rate)
    want_var = rate / (1.0 - rate)
    n = y.numel()
    assert abs(float(y.mean()) - 1.0) <= SIGMAS * (want_var / n) ** 0.5
    assert abs(float(y.var()) - want_var) <= SIGMAS * want_var * (2.0 / n) ** 0.5
    yl, _, _ = TL.GaussianDropout(rate=rate).apply({}, {}, x, training=True,
                                                   rng=_gen(6))
    assert torch.equal(yl, y)


def test_gaussian_noise_adds_zero_mean_noise():
    x = torch.full((400, 500), 2.0)
    y = reg.gaussian_noise(_gen(7), x, 0.3)
    n = y.numel()
    assert abs(float(y.mean()) - 2.0) <= SIGMAS * (0.09 / n) ** 0.5
    assert abs(float(y.var()) - 0.09) <= SIGMAS * 0.09 * (2.0 / n) ** 0.5
    yl, _, _ = TL.GaussianNoise(stddev=0.3).apply({}, {}, x, training=True,
                                                  rng=_gen(7))
    assert torch.equal(yl, y)


def test_weight_noise_and_drop_connect_act_on_every_leaf():
    params = {"a": {"w": torch.ones((50, 40))}, "b": torch.ones((300,))}
    noisy = reg.weight_noise(_gen(8), params, 0.1)
    mult = reg.weight_noise(_gen(8), params, 0.1, additive=False)
    dropped = reg.drop_connect(_gen(8), params, 0.5)
    for tree in (noisy, mult, dropped):
        assert [t.shape for t in tree_leaves(tree)] == \
            [t.shape for t in tree_leaves(params)]
    # all-ones weights: additive and multiplicative noise coincide
    for a, b in zip(tree_leaves(noisy), tree_leaves(mult)):
        assert torch.equal(a, b)
    leaves = torch.cat([t.flatten() for t in tree_leaves(dropped)])
    assert set(leaves.unique().tolist()) <= {0.0, 2.0}
    assert _within(int((leaves != 0).sum()), leaves.numel(), 0.5)


def test_same_seed_same_mask_other_seed_other_mask():
    x = _x()
    assert torch.equal(reg.dropout(_gen(11), x, 0.5),
                       reg.dropout(_gen(11), x, 0.5))
    assert not torch.equal(reg.dropout(_gen(11), x, 0.5),
                           reg.dropout(_gen(12), x, 0.5))
    g = _gen(11)
    first, second = reg.dropout(g, x, 0.5), reg.dropout(g, x, 0.5)
    assert not torch.equal(first, second)  # the generator advances


@pytest.mark.parametrize("cfg", [0.5, {"type": "dropout", "rate": 0.5},
                                 {"type": "spatial", "rate": 0.5},
                                 {"type": "alpha", "rate": 0.5},
                                 {"type": "gaussian_dropout", "rate": 0.5},
                                 {"type": "gaussian_noise", "stddev": 0.5}],
                         ids=["float", "dropout", "spatial", "alpha",
                              "gaussian_dropout", "gaussian_noise"])
def test_dropout_config_dispatches_like_reference(cfg):
    x = _x((4, 3, 3, 8))
    kind = "dropout" if isinstance(cfg, float) else cfg["type"]
    kw = {"rate": cfg} if isinstance(cfg, float) else \
        {k: v for k, v in cfg.items() if k != "type"}
    want = reg.DROPOUTS[kind](_gen(2), x, training=True, **kw)
    got = reg.apply_dropout_config(_gen(2), x, cfg, True)
    assert torch.equal(got, want)
    assert kind in jreg.DROPOUTS


# ------------------------------------------------------------- input dropout
def test_layer_with_dropout_and_no_generator_raises():
    layer = TL.Dense(n_out=4, dropout=0.5)
    params, _ = layer.init(_gen(), (6,))
    x = _x((3, 6))
    with pytest.raises(ValueError, match="has dropout but no rng"):
        layer.apply(params, {}, x, training=True)
    with pytest.raises(ValueError, match="needs rng"):
        TL.DropoutLayer(rate=0.5).apply({}, {}, x, training=True)
    y, _, _ = layer.apply(params, {}, x, training=False)  # eval: no rng needed
    assert y.shape == (3, 4)


def test_input_dropout_acts_on_the_layers_input():
    layer = TL.Dense(n_out=5, dropout=0.5, use_bias=False)
    params, _ = layer.init(_gen(), (40,))
    x = _x((8, 40))
    y, _, _ = layer.apply(params, {}, x, training=True, rng=_gen(13))
    dropped = apply_input_dropout(layer, x, _gen(13), True)
    assert torch.equal(y, dropped @ params["w"])
    assert torch.equal(dropped, reg.dropout(_gen(13), x, 0.5))


def test_dropout_layer_configs_cross_between_packages():
    for layer in (TL.DropoutLayer(rate=0.3), TL.GaussianNoise(stddev=0.2),
                  TL.GaussianDropout(rate=0.1), TL.AlphaDropout(rate=0.4),
                  TL.Dense(n_out=3, dropout={"type": "spatial", "rate": 0.2})):
        d = layer.to_dict()
        assert jlayer_from_dict(d).to_dict() == d
        assert layer_from_dict(d) == layer
    for jl in (JL.DropoutLayer(rate=0.3), JL.AlphaDropout(rate=0.4)):
        assert layer_from_dict(jl.to_dict()).to_dict() == jl.to_dict()


# ------------------------------------------------------ attention dropout
def _block_input():
    return _x((2, 10, 16))


def test_attention_dropout_routes_flash_to_the_dense_path():
    mha = TL.MultiHeadAttention(num_heads=2, flash=True, attn_dropout=0.3)
    params, _ = mha.init(_gen(), (10, 16))
    x = _block_input()
    dense = dataclasses.replace(mha, flash=False)
    y, _, _ = mha.apply(params, {}, x, training=True, rng=_gen(14))
    y_dense, _, _ = dense.apply(params, {}, x, training=True, rng=_gen(14))
    assert torch.equal(y, y_dense)
    # eval (and training with no generator): no dropout, the flash path
    y_eval, _, _ = mha.apply(params, {}, x, training=False)
    y_plain, _, _ = dataclasses.replace(mha, attn_dropout=0.0).apply(
        params, {}, x, training=True, rng=_gen(14))
    assert torch.equal(y_eval, y_plain)
    assert not torch.equal(y, y_eval)


def test_block_dropout_acts_on_the_mlp_branch():
    blk = TL.TransformerEncoderBlock(num_heads=2, dropout_rate=0.4,
                                     flash=True)
    params, _ = blk.init(_gen(), (10, 16))
    x = _block_input()
    y, _, _ = blk.apply(params, {}, x, training=True, rng=_gen(15))
    # by hand: attention undropped (flash), then the MLP branch dropped
    # with the generator's first draw
    from deeplearning4j_torch.nn.layers.norm import layer_norm
    from deeplearning4j_torch.ops import activations

    h = layer_norm(x, params["ln1_g"], params["ln1_b"])
    a, _, _ = blk._mha().apply(params["attn"], {}, h, training=True,
                               rng=_gen(15))
    xa = x + a
    h = layer_norm(xa, params["ln2_g"], params["ln2_b"])
    m = activations.get("gelu")(h @ params["w_up"] + params["b_up"]) \
        @ params["w_down"] + params["b_down"]
    assert torch.equal(y, xa + reg.dropout(_gen(15), m, 0.4))
    y_eval, _, _ = blk.apply(params, {}, x, training=False)
    assert torch.equal(y_eval, xa + m)


@pytest.mark.parametrize("where", ["block", "config"])
def test_remat_recomputes_with_the_forwards_dropout_masks(where):
    """A checkpointed layer's recompute in the backward must draw the
    masks its forward drew: gradients equal the plain forward's."""
    def model(remat):
        blk = TL.TransformerEncoderBlock(num_heads=2, dropout_rate=0.5,
                                         remat=remat and where == "block")
        cfg = NetConfig(seed=0, remat=remat and where == "config")
        return Sequential(cfg, [TL.Dense(n_out=16, dropout=0.5), blk,
                                TL.GlobalPooling(mode="avg"),
                                TL.Output(n_out=3)], (10, 16), device="cpu")

    plain, ckpt = model(False), model(True)
    params, _ = plain.init(seed=3)
    x = _block_input()
    y = torch.from_numpy(np.eye(3, dtype=np.float32)[[0, 2]])
    grads = []
    for m in (plain, ckpt):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        from deeplearning4j_torch.ops.updaters import tree_unflatten

        p = tree_unflatten(params, leaves)
        gen = _gen(21)
        loss, _ = m.score(p, {}, x, y, training=True, rng=gen)
        grads.append(torch.autograd.grad(loss, leaves))
        after = torch.rand((), generator=gen)
        grads[-1] = grads[-1] + (after,)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------------ constraints
def _w(shape, seed=17):
    """Seeded weights on a grid of quarters: their squares and every sum
    of them are exact in f32, so the norm does not depend on the order in
    which a backend sums (XLA's CPU reduction and torch's differ in it)
    and the projections compare bit for bit."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-12, 13, shape) / 4).astype(np.float32)


_CONSTRAINTS = [
    "max_norm", "unit_norm", "non_negative", "min_max_norm",
    {"type": "max_norm", "max_val": 1.5},
    {"type": "min_max_norm", "min_val": 0.5, "max_val": 2.0, "rate": 0.7}]
_IDS = ["max_norm", "unit_norm", "non_negative", "min_max_norm",
        "max_norm_1.5", "min_max_norm_rate"]


def _with_axis(cfg, axis):
    if cfg == "non_negative":
        return cfg
    return dict({"type": cfg} if isinstance(cfg, str) else cfg, axis=axis)


@pytest.mark.parametrize("shape,axis", [((6, 9), 0), ((6, 9), 1),
                                        ((3, 3, 4, 5), (0, 1, 2))],
                         ids=["dense_in", "dense_out", "conv_hwi"])
@pytest.mark.parametrize("cfg", _CONSTRAINTS, ids=_IDS)
def test_constraints_equal_reference_exactly(cfg, shape, axis):
    w = _w(shape)
    for c in (_with_axis(cfg, axis), cfg):  # with an axis; the defaults
        want = np.asarray(jreg.apply_constraint_config(jnp.asarray(w), c))
        got = reg.apply_constraint_config(torch.from_numpy(w), c).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", _CONSTRAINTS, ids=_IDS)
def test_constraints_on_normal_weights_within_an_ulp_of_reference(cfg):
    """Normal f32 weights: the two backends sum the squares in other
    orders, so the norms, and the projections, differ by at most an ulp
    or two (2.4e-7 relative: two f32 ulps)."""
    w = np.random.default_rng(3).standard_normal((40, 30)).astype(
        np.float32) * 1.7
    want = np.asarray(jreg.apply_constraint_config(jnp.asarray(w), cfg))
    got = reg.apply_constraint_config(torch.from_numpy(w), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
