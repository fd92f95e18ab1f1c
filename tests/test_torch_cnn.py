"""The port's CNN path (deeplearning4j_torch: Conv2D, Subsampling2D,
GlobalPooling, Flatten, ActivationLayer, the Merge and ElementWise
vertices, Graph and GraphBuilder, ResNet50, BenchmarkIterator, Trainer
and model zips over a Graph) held against the JAX package.

Inputs come from numpy seeds and params are the reference's, carried
across with ``params_from_numpy`` (state with ``state_from_numpy``).
Tolerances, relative to the largest entry of the reference's array:

- layers and vertices in f32, forward and gradients: 1e-5 (the two sum in
  other orders; measured 1e-6 at most); max pooling's gradient and the
  vertices' exactly; bf16 pooling one bf16 ulp (2**-8 relative), pnorm
  pooling two;
- the narrow residual graph (the node kinds of ResNet-50 at 32x32x3,
  batch 4), loss and gradients in f32: 5e-5 of the largest gradient entry
  of each param's node (its layer's params together; the stem BatchNorm's
  beta gradient is zero up to rounding, 1e-8 against 0.2 for its gamma,
  so its own largest entry is no scale); measured 1.0e-5, through five
  BatchNorm backwards whose per-channel algebra cancels;
- the same in bf16, against the reference run op by op: the loss within
  one bf16 ulp (measured equal); each gradient within 0.15 of its node's
  scale (measured 0.10), and the
  port's gradients no further from the f32 gradients, summed over the
  params, than 1.1 times the reference's. A bf16 forward through a
  random residual stack moves the gradients 2-40% from f32 in both
  packages (the reference's CPU backend also accumulates bf16 sums in
  bf16), so the test holds the port to the reference's accuracy rather
  than to its rounding;
- a 10-step f32 trajectory through ``Trainer.fit``: adam losses within
  1e-4 relative and sgd's within 1e-5, params and running statistics
  within the same of their largest entries (but for the stem's beta,
  whose gradient is rounding noise that adam scales up: see
  ``TRAJECTORY_CASES``);
- zips written by either package resume in the other with the next
  step's loss within 1e-5 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import BenchmarkIterator, DataSet, MultiDataSet
from deeplearning4j_torch.models import ResNet50
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn import vertices as TV
from deeplearning4j_torch.nn.model import Graph, GraphBuilder, NetConfig
from deeplearning4j_torch.ops import initializers
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        build_updater, params_from_numpy,
                                        state_from_numpy)
from deeplearning4j_tpu.data.iterators import \
    BenchmarkIterator as JBenchmarkIterator
from deeplearning4j_tpu.models import ResNet50 as JResNet50
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import vertices as JV
from deeplearning4j_tpu.nn.model import Graph as JGraph
from deeplearning4j_tpu.nn.model import GraphBuilder as JGraphBuilder
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

F32_TOL = 1e-5
ULP = 2.0 ** -8


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(np.asarray(b, np.float32), np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _layer_grads(jl, tl, params, x, dy):
    """Forward and the gradients of sum(y * dy) in both packages, f32."""
    def f(p, xx):
        y, _, _ = jl.apply(p, {}, xx)
        return jnp.sum(y * dy), y

    (_, yj), (gpj, gxj) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    yt, _, _ = tl.apply(tp, {}, tx)
    names = sorted(tp)
    g = torch.autograd.grad((yt * torch.tensor(dy)).sum(),
                            [tx] + [tp[k] for k in names])
    want = {"y": yj, "x": gxj, **{k: gpj[k] for k in names}}
    got = {"y": yt.detach().numpy(), "x": g[0].numpy(),
           **{k: v.numpy() for k, v in zip(names, g[1:])}}
    return got, want


# ------------------------------------------------------------ Conv2D
CONV_CASES = {
    "stem_7x7_s2_same": (dict(n_out=8, kernel=(7, 7), stride=(2, 2),
                              padding="same", use_bias=False), (16, 16, 3)),
    "3x3_same": (dict(n_out=6, kernel=(3, 3)), (9, 9, 4)),
    "1x1_s2_same": (dict(n_out=5, kernel=(1, 1), stride=(2, 2)), (9, 9, 4)),
    "2x2_same_uneven": (dict(n_out=4, kernel=(2, 2), activation="relu"),
                        (7, 7, 3)),
    "3x3_s2_valid": (dict(n_out=5, kernel=(3, 3), stride=(2, 2),
                          padding="valid", use_bias=False), (11, 10, 4)),
    "explicit_pad": (dict(n_out=5, kernel=(3, 2), padding=(1, 2)), (7, 8, 3)),
    "dilated_same": (dict(n_out=4, kernel=(3, 3), dilation=(2, 2)),
                     (10, 10, 3)),
    "dilated_s2_valid": (dict(n_out=4, kernel=(3, 3), stride=(2, 2),
                              dilation=(2, 1), padding="valid"), (13, 12, 3)),
    "grouped": (dict(n_out=6, kernel=(3, 3), groups=2), (8, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_reference(case):
    kw, shape = CONV_CASES[case]
    jl, tl = JL.Conv2D(**kw), TL.Conv2D(**kw)
    assert jl.to_dict() == tl.to_dict()
    assert tuple(tl.output_shape(shape)) == tuple(jl.output_shape(shape))
    rng = np.random.default_rng(0)
    pj, _ = jl.init(jax.random.PRNGKey(1), shape)
    params = {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in pj.items()}
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    dy = rng.standard_normal((2,) + jl.output_shape(shape)).astype(np.float32)
    got, want = _layer_grads(jl, tl, params, x, dy)
    assert got["y"].shape == want["y"].shape
    for k in want:
        assert _rel(got[k], want[k]) <= F32_TOL, k


def test_conv2d_bf16_forward_matches_reference():
    kw, shape = CONV_CASES["stem_7x7_s2_same"]
    jl, tl = JL.Conv2D(**kw), TL.Conv2D(**kw)
    pj, _ = jl.init(jax.random.PRNGKey(1), shape)
    x = np.random.default_rng(2).standard_normal((2,) + shape).astype(
        np.float32)
    yj, _, _ = jl.apply(jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj),
                        {}, jnp.asarray(x, jnp.bfloat16))
    yt, _, _ = tl.apply({"w": torch.from_numpy(np.asarray(pj["w"])).to(
        torch.bfloat16)}, {}, torch.from_numpy(x).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    assert _rel(yt.float().numpy(), yj) <= ULP


def test_conv_init_is_he_normal_in_hwio():
    """JAX's bits cannot be reproduced: the conv weight is held to its
    shape (HWIO) and distribution (std sqrt(2 / (kh kw c_in)) within 3%)."""
    p, _ = TL.Conv2D(n_out=64, kernel=(7, 7)).init(
        torch.Generator().manual_seed(0), (224, 224, 3))
    assert tuple(p["w"].shape) == (7, 7, 3, 64) and "b" in p
    assert initializers.compute_fans((7, 7, 3, 64), "conv") == (147, 3136)
    std = (2.0 / 147) ** 0.5
    assert abs(p["w"].std().item() / std - 1) < 0.03


# ------------------------------------------------------------ pooling
POOL_CASES = [(mode, k, s, pad) for mode in ("max", "avg", "sum")
              for k, s, pad in (((3, 3), (2, 2), "same"),
                                ((3, 3), (2, 2), "valid"),
                                ((2, 2), (2, 2), "valid"),
                                ((3, 2), (1, 2), (1, 1)))]


@pytest.mark.parametrize("mode,kernel,stride,padding", POOL_CASES)
def test_subsampling_matches_reference(mode, kernel, stride, padding):
    kw = dict(kernel=kernel, stride=stride, padding=padding, mode=mode)
    jl, tl = JL.Subsampling2D(**kw), TL.Subsampling2D(**kw)
    shape = (7, 8, 3)
    assert tuple(tl.output_shape(shape)) == tuple(jl.output_shape(shape))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    dy = rng.standard_normal((2,) + jl.output_shape(shape)).astype(np.float32)
    got, want = _layer_grads(jl, tl, {}, x, dy)
    for k in ("y", "x"):
        if mode == "max":
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        else:
            assert _rel(got[k], want[k]) <= F32_TOL, k


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_max_pool_ties_route_like_the_reference(padding):
    """A ReLU output has all-zero windows: the gradient goes to the same
    element as XLA's select-and-scatter (the first maximum)."""
    rng = np.random.default_rng(2)
    x = np.maximum(rng.standard_normal((2, 9, 9, 3)), 0).astype(np.float32)
    x[:, :4, :4, :] = 0.0   # whole windows of ties
    x[0, 5, 5:8, 1] = 1.5   # ties at a positive maximum
    kw = dict(kernel=(3, 3), stride=(2, 2), padding=padding)
    jl, tl = JL.Subsampling2D(**kw), TL.Subsampling2D(**kw)
    dy = rng.standard_normal((2,) + jl.output_shape((9, 9, 3))).astype(
        np.float32)
    got, want = _layer_grads(jl, tl, {}, x, dy)
    np.testing.assert_array_equal(got["y"], np.asarray(want["y"]))
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))


@pytest.mark.parametrize("mode", ["max", "avg", "sum"])
@pytest.mark.parametrize("padding", ["valid", "same"])
def test_subsampling_bf16_matches_reference(mode, padding):
    """bf16 window sums add in x's dtype in window order, as the
    reference's reduce_window does: bit-equal with valid padding. On padded
    windows the reference's CPU backend adds in another order, so "same"
    is held to 4 ulps of the largest output."""
    kw = dict(kernel=(3, 3), stride=(2, 2), padding=padding, mode=mode)
    x = np.random.default_rng(3).standard_normal((2, 9, 8, 4)).astype(
        np.float32)
    yj, _, _ = JL.Subsampling2D(**kw).apply({}, {}, jnp.asarray(
        x, jnp.bfloat16))
    yt, _, _ = TL.Subsampling2D(**kw).apply({}, {}, torch.from_numpy(x).to(
        torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    if padding == "valid" or mode == "max":
        np.testing.assert_array_equal(yt.float().numpy(),
                                      np.asarray(yj, np.float32))
    else:
        assert _rel(yt.float().numpy(), yj) <= 4 * ULP


@pytest.mark.parametrize("pnorm", [2, 3])
@pytest.mark.parametrize("padding", ["valid", "same", (1, 1)])
def test_pnorm_pooling_matches_reference(pnorm, padding):
    """|x| ** p as XLA's integer_pow (square and multiply), summed over
    the window in window order, ** (1/p): forward and gradient in f32, and
    bf16 forward within 2 ulps of the largest output."""
    kw = dict(kernel=(3, 3), stride=(2, 2), padding=padding, mode="pnorm",
              pnorm=pnorm)
    jl, tl = JL.Subsampling2D(**kw), TL.Subsampling2D(**kw)
    shape = (7, 8, 3)
    assert tuple(tl.output_shape(shape)) == tuple(jl.output_shape(shape))
    rng = np.random.default_rng(pnorm)
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    dy = rng.standard_normal((2,) + jl.output_shape(shape)).astype(np.float32)
    got, want = _layer_grads(jl, tl, {}, x, dy)
    assert _rel(got["y"], want["y"]) <= F32_TOL
    assert _rel(got["x"], want["x"]) <= F32_TOL
    yj, _, _ = jl.apply({}, {}, jnp.asarray(x, jnp.bfloat16))
    yt, _, _ = tl.apply({}, {}, torch.from_numpy(x).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    assert _rel(yt.float().numpy(), np.asarray(yj, np.float32)) <= 2 * ULP


@pytest.mark.parametrize("mode", ["avg", "max", "sum", "pnorm"])
@pytest.mark.parametrize("masked", [False, True], ids=["4d", "masked_3d"])
def test_global_pooling_matches_reference(mode, masked):
    rng = np.random.default_rng(4)
    shape = (3, 7, 5) if masked else (3, 4, 5, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 7), np.float32)
        mask[0, 4:] = 0
        mask[2, 1:] = 0  # a row with one step left
    jl, tl = JL.GlobalPooling(mode=mode), TL.GlobalPooling(mode=mode)
    yj, _, mj = jl.apply({}, {}, jnp.asarray(x),
                         mask=None if mask is None else jnp.asarray(mask))
    tx = torch.tensor(x, requires_grad=True)
    yt, _, mt = tl.apply({}, {}, tx,
                         mask=None if mask is None else torch.tensor(mask))
    assert mj is None and mt is None
    assert _rel(yt.detach().numpy(), yj) <= F32_TOL
    dy = rng.standard_normal(yj.shape).astype(np.float32)
    gj = jax.grad(lambda xx: jnp.sum(jl.apply(
        {}, {}, xx, mask=None if mask is None else jnp.asarray(mask))[0]
        * dy))(jnp.asarray(x))
    gt, = torch.autograd.grad((yt * torch.tensor(dy)).sum(), [tx])
    assert _rel(gt.numpy(), gj) <= F32_TOL


def test_global_avg_pooling_bf16_rounds_once():
    x = np.random.default_rng(5).standard_normal((2, 7, 7, 16)).astype(
        np.float32) * 3
    yj, _, _ = JL.GlobalPooling().apply({}, {}, jnp.asarray(x, jnp.bfloat16))
    yt, _, _ = TL.GlobalPooling().apply({}, {}, torch.from_numpy(x).to(
        torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    assert _rel(yt.float().numpy(), yj) <= ULP


def test_flatten_and_activation_layer_match_reference():
    x = np.random.default_rng(6).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    for jl, tl in ((JL.Flatten(), TL.Flatten()),
                   (JL.ActivationLayer(), TL.ActivationLayer())):
        assert jl.to_dict() == tl.to_dict()
        dy = np.ones(jl.apply({}, {}, jnp.asarray(x))[0].shape, np.float32)
        got, want = _layer_grads(jl, tl, {}, x, dy)
        np.testing.assert_array_equal(got["y"], np.asarray(want["y"]))
        np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    assert TL.Flatten().output_shape((3, 4, 5)) == (60,)


# ------------------------------------------------------------ vertices
@pytest.mark.parametrize("op", ["add", "subtract", "product", "average",
                                "max"])
def test_elementwise_vertex_matches_reference(op):
    rng = np.random.default_rng(7)
    n = 2 if op == "subtract" else 3
    xs = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(n)]
    xs[1][0, 0] = xs[0][0, 0]  # ties (max splits the gradient)
    jv, tv = JV.ElementWise(op=op), TV.ElementWise(op=op)
    assert jv.to_dict() == tv.to_dict()
    dy = rng.standard_normal((2, 3, 4)).astype(np.float32)
    gj = jax.grad(lambda *a: jnp.sum(jv.apply(list(a)) * dy),
                  argnums=tuple(range(n)))(*map(jnp.asarray, xs))
    txs = [torch.tensor(a, requires_grad=True) for a in xs]
    yt = tv.apply(txs)
    np.testing.assert_allclose(yt.detach().numpy(),
                               np.asarray(jv.apply(list(map(jnp.asarray, xs)))),
                               rtol=1e-6, atol=1e-6)
    gt = torch.autograd.grad((yt * torch.tensor(dy)).sum(), txs)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_merge_vertex_and_vertex_registry():
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, 3, s)).astype(np.float32) for s in (2, 5)]
    np.testing.assert_array_equal(
        TV.Merge().apply([torch.from_numpy(a) for a in xs]).numpy(),
        np.asarray(JV.Merge().apply([jnp.asarray(a) for a in xs])))
    assert TV.Merge().output_shape([(3, 2), (3, 5)]) == (3, 7)
    for kind, cls in sorted(JV.VERTEX_REGISTRY.items()):
        v = cls()
        assert TV.vertex_from_dict(v.to_dict()).to_dict() == v.to_dict(), kind
        assert type(TV.vertex_from_dict(v.to_dict())).__name__ == kind
    for v in (JV.ElementWise(op="max"), JV.Scale(factor=2.0)):
        assert TV.vertex_from_dict(v.to_dict()).to_dict() == v.to_dict()
    with pytest.raises(ValueError, match="Unknown vertex"):
        TV.vertex_from_dict({"@type": "Nope"})


# ------------------------------------------------------------ graphs
def _narrow(L, V, GB, NC, **kw):
    """A narrow residual graph with ResNet-50's node kinds: stem conv_bn
    7x7/2, SAME max pool 3x3/2, a bottleneck with a stride-2 projection,
    one without, global average pool, softmax output with mcxent."""
    g = GB(NC(seed=0, updater={"type": "adam", "learning_rate": 1e-3}),
           **kw).add_input("in", (32, 32, 3))

    def conv_bn(name, inp, n, k, s=1, act="relu"):
        g.add_layer(f"{name}_c", L.Conv2D(n_out=n, kernel=(k, k),
                                          stride=(s, s), padding="same",
                                          use_bias=False), inp)
        g.add_layer(name, L.BatchNorm(activation=act), f"{name}_c")
        return name

    def bottleneck(name, inp, mid, out, s, project):
        a = conv_bn(f"{name}_a", inp, mid, 1, s)
        b = conv_bn(f"{name}_b", a, mid, 3)
        g.add_layer(f"{name}_cc", L.Conv2D(n_out=out, kernel=(1, 1),
                                           padding="same", use_bias=False), b)
        g.add_layer(f"{name}_cbn", L.BatchNorm(activation="identity"),
                    f"{name}_cc")
        sc = (conv_bn(f"{name}_proj", inp, out, 1, s, act="identity")
              if project else inp)
        g.add_vertex(f"{name}_add", V.ElementWise(op="add"), f"{name}_cbn",
                     sc)
        g.add_layer(name, L.ActivationLayer(activation="relu"), f"{name}_add")
        return name

    x = conv_bn("stem", "in", 8, 7, 2)
    g.add_layer("pool1", L.Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                         padding="same"), x)
    x = bottleneck("b0", "pool1", 4, 16, 2, True)
    x = bottleneck("b1", x, 4, 16, 1, False)
    g.add_layer("gap", L.GlobalPooling(mode="avg"), x)
    g.add_layer("out", L.Output(n_out=5, activation="softmax", loss="mcxent"),
                "gap")
    return g.set_outputs("out").build()


def _jax_narrow():
    return _narrow(JL, JV, JGraphBuilder, JNetConfig)


def _port_narrow(jparams=None, jstate=None, compute_dtype=None):
    m = _narrow(TL, TV, GraphBuilder, NetConfig, device="cpu")
    m.config.compute_dtype = compute_dtype
    if jparams is not None:
        m.params = params_from_numpy(m, jparams)
        m.state = state_from_numpy(jstate, "cpu")
    return m


@pytest.fixture(scope="module")
def narrow_ref():
    m = _jax_narrow()
    params, state = m.init()
    return _np_tree(params), _np_tree(state)


@pytest.fixture(scope="module")
def narrow_batch():
    ds = next(iter(BenchmarkIterator((32, 32, 3), 5, 4, 1, seed=0)))
    return ds.features, ds.labels


def _node_scaled_errors(got, want, names):
    """Per param: max |got - want| over the largest entry of the param's
    node (all its params) in ``want``."""
    scale = {}
    for n, w in zip(names, want):
        scale[n] = max(scale.get(n, 0.0), float(np.abs(w).max()))
    return [float(np.abs(g - w).max()) / scale[n]
            for n, g, w in zip(names, got, want)]


def _grads_both(params, state, x, y, compute_dtype):
    jm = _jax_narrow()
    jm.config.compute_dtype = compute_dtype
    grad_fn = jax.value_and_grad(
        lambda p: jm.score(p, jax.tree.map(jnp.asarray, state),
                           jnp.asarray(x), jnp.asarray(y), training=True),
        has_aux=True)
    # bf16 op by op, as the port runs: under jit XLA fuses and rounds
    # elsewhere, which alone moves the reference's bf16 gradients by up to
    # 0.27 of their node's scale
    if compute_dtype is None:
        grad_fn = jax.jit(grad_fn)
    (lj, _), gj = grad_fn(jax.tree.map(jnp.asarray, params))
    tm = _port_narrow(params, state, compute_dtype)
    leaves = [p.requires_grad_() for p in tree_leaves(tm.params)]
    lt, _ = tm.score(tm.params, tm.state, torch.from_numpy(x),
                     torch.from_numpy(y))
    gt = torch.autograd.grad(lt, leaves)
    names = [k for k in sorted(params) for _ in tree_leaves(params[k])]
    return (float(lt), float(lj), [g.numpy() for g in gt],
            [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(gj)],
            names)


def test_narrow_graph_f32_loss_and_gradients(narrow_ref, narrow_batch):
    lt, lj, gt, gj, names = _grads_both(*narrow_ref, *narrow_batch, None)
    assert abs(lt - lj) <= F32_TOL * abs(lj)
    errs = _node_scaled_errors(gt, gj, names)
    assert max(errs) <= 5e-5, dict(zip(names, errs))


def test_narrow_graph_bf16_loss_and_gradients(narrow_ref, narrow_batch):
    lt, lj, gt, gj, names = _grads_both(*narrow_ref, *narrow_batch,
                                        "bfloat16")
    assert abs(lt - lj) <= ULP * abs(lj)
    errs = _node_scaled_errors(gt, gj, names)
    assert max(errs) <= 0.15, dict(zip(names, errs))
    _, _, _, truth, _ = _grads_both(*narrow_ref, *narrow_batch, None)
    port_off = sum(_node_scaled_errors(gt, truth, names))
    ref_off = sum(_node_scaled_errors(gj, truth, names))
    assert port_off <= 1.1 * ref_off


def test_graph_forward_output_and_state(narrow_ref, narrow_batch):
    params, state = narrow_ref
    x, _ = narrow_batch
    jm = _jax_narrow()
    tm = _port_narrow(params, state)
    for training in (False, True):
        (yj,), sj = jm.forward(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, state),
                               jnp.asarray(x), training=training)
        (yt,), st = tm.forward(tm.params, tm.state, torch.from_numpy(x),
                               training=training)
        assert _rel(yt.detach().numpy(), yj) <= F32_TOL
        for k in sj:
            for n in ("mean", "var"):
                assert _rel(st[k][n].numpy(), sj[k][n]) <= F32_TOL
    (yo,) = tm.output(x)
    assert yo.shape == (4, 5)
    torch.testing.assert_close(yo.sum(-1), torch.ones(4))


def _fit_losses_jax(params, state, steps, batch, updater=None):
    jm = _jax_narrow()
    if updater is not None:
        jm.config.updater = updater
    jm.params = jax.tree.map(jnp.array, params)
    jm.state = jax.tree.map(jnp.array, state)
    rec = JCollectScoresListener()
    jt = JTrainer(jm)
    jt.fit(JBenchmarkIterator((32, 32, 3), 5, batch, steps, seed=0),
           listeners=[rec], prefetch=False)
    return jt, np.array([l for _, l in rec.scores])


# The stem BatchNorm's beta gets a gradient that is rounding noise (its
# shift reaches only BatchNorms, through ReLU and max pooling: 1e-8 against
# 0.2 for its gamma). adam turns noise into steps of up to its learning
# rate, so under adam that beta may drift apart by lr per step in the two
# packages, and with it the running means of the two BatchNorms fed by the
# pool (b0_a and the projection b0_proj). sgd keeps the noise at noise.
TRAJECTORY_CASES = {
    "adam": ({"type": "adam", "learning_rate": 1e-3}, 1e-4, 1e-4),
    "sgd": ({"type": "sgd", "learning_rate": 0.1}, 1e-5, 1e-5),
}
NOISE_PARAM = ("stem", "beta")
NOISE_STATS = ("b0_a", "b0_proj")


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_narrow_graph_trajectory_matches_reference(narrow_ref, case):
    """Ten f32 steps of Trainer.fit on one BenchmarkIterator batch: losses
    within 1e-4 (adam; measured 5.7e-7) or 1e-5 (sgd; 1.8e-7) relative;
    params within that of their node's largest entry and running
    statistics of their own, but for the stem's beta and the two running
    means it moves under adam (above): beta within lr per step, those
    means within 5e-3 (measured 6.4e-3 abs and 2.0e-3)."""
    updater, loss_tol, tol = TRAJECTORY_CASES[case]
    params, state = narrow_ref
    jt, want = _fit_losses_jax(params, state, 10, 4, updater)
    tm = _port_narrow(params, state)
    tm.config.updater = updater
    rec = CollectScoresListener()
    tt = Trainer(tm).fit(BenchmarkIterator((32, 32, 3), 5, 4, 10, seed=0),
                         listeners=[rec])
    got = np.array([l for _, l in rec.scores])
    assert len(got) == 10
    np.testing.assert_allclose(got, want, rtol=loss_tol)
    assert got[-1] < got[0]
    assert tm.state is tt.state and tm.params is tt.params
    noisy = case == "adam"
    jparams = _np_tree(jt.params)
    for k in jparams:
        scale = max(np.abs(v).max() for v in jparams[k].values())
        for n, w in jparams[k].items():
            g = tt.params[k][n].detach().numpy()
            if noisy and (k, n) == NOISE_PARAM:
                assert np.abs(g - w).max() <= 10 * updater["learning_rate"]
            else:
                assert np.abs(g - w).max() <= tol * scale, (k, n)
    jstate = _np_tree(jt.state)
    for k in jstate:
        for n in ("mean", "var"):
            bound = 5e-3 if noisy and k in NOISE_STATS and n == "mean" \
                else tol
            assert _rel(tt.state[k][n].numpy(), jstate[k][n]) <= bound, k


def _next_loss_jax(trainer, x, y):
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


def test_reference_graph_zip_resumes_in_port(narrow_ref, narrow_batch,
                                             tmp_path):
    jt, _ = _fit_losses_jax(*narrow_ref, 3, 4)
    path = str(tmp_path / "ref.zip")
    jt.save(path)
    port = Trainer.load(path, device="cpu")
    assert isinstance(port.model, Graph)
    assert int(tree_leaves(port.opt_state)[0]) == 3
    jstate = _np_tree(jt.state)
    for k in jstate:
        np.testing.assert_array_equal(port.state[k]["mean"].numpy(),
                                      jstate[k]["mean"])
    want = _next_loss_jax(jt, *narrow_batch)
    np.testing.assert_allclose(_next_loss_port(port, *narrow_batch), want,
                               rtol=1e-5)


def test_port_graph_zip_resumes_in_reference(narrow_ref, narrow_batch,
                                             tmp_path):
    tm = _port_narrow(*narrow_ref)
    tt = Trainer(tm).fit(BenchmarkIterator((32, 32, 3), 5, 4, 3, seed=0))
    path = str(tmp_path / "port.zip")
    tt.save(path)
    jt = JTrainer.load(path)
    assert isinstance(jt.model, JGraph)
    for k, s in tt.state.items():
        np.testing.assert_array_equal(np.asarray(jt.state[k]["var"]),
                                      s["var"].numpy())
    want = _next_loss_port(tt, *narrow_batch)
    np.testing.assert_allclose(_next_loss_jax(jt, *narrow_batch), want,
                               rtol=1e-5)


def test_graph_json_crosses_both_ways():
    jm, tm = _jax_narrow(), _port_narrow()
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    back = JGraph.from_json(tm.to_json())
    assert back.topo_order == tm.topo_order
    again = Graph.from_json(jm.to_json(), device="cpu")
    assert again.topo_order == jm.topo_order
    assert again.output_shapes == [tuple(s) for s in jm.output_shapes]
    assert json.loads(again.to_json()) == json.loads(jm.to_json())


def test_graph_builder_inserts_flatten_like_the_reference():
    def build(L, GB, NC, **kw):
        return (GB(NC(), **kw).add_input("in", (6, 6, 2))
                .add_layer("c", L.Conv2D(n_out=3, kernel=(3, 3)), "in")
                .add_layer("d", L.Dense(n_out=4), "c")
                .add_layer("out", L.Output(n_out=2), "d")
                .set_outputs("out").build())

    jm = build(JL, JGraphBuilder, JNetConfig)
    tm = build(TL, GraphBuilder, NetConfig, device="cpu")
    assert "d_flatten" in tm.nodes and tm.nodes["d"].inputs == ("d_flatten",)
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    assert tm.node_shape("d_flatten") == (108,)
    jp, _ = jm.init()
    tm.params, tm.state = params_from_numpy(tm, _np_tree(jp)), {}
    x = np.random.default_rng(9).standard_normal((3, 6, 6, 2)).astype(
        np.float32)
    (yj,) = jm.output(jnp.asarray(x))
    (yt,) = tm.output(x)
    assert _rel(yt.numpy(), yj) <= F32_TOL
    # from_json does not insert twice
    assert len(Graph.from_json(tm.to_json(), device="cpu").nodes) == 4


def test_graph_threads_masks_like_the_reference():
    """A (B, T, F) input with a (B, T) mask: the mask reaches the masked
    GlobalPooling through a Dense layer and a vertex, in forward and
    score."""
    def build(L, V, GB, NC, **kw):
        return (GB(NC(), **kw).add_input("in", (7, 3))
                .add_layer("h", L.Dense(n_out=4, activation="relu"), "in")
                .add_vertex("sum", V.ElementWise(op="add"), "h", "h")
                .add_layer("gp", L.GlobalPooling(mode="avg"), "sum")
                .add_layer("out", L.Output(n_out=2), "gp")
                .set_outputs("out").build())

    jm = build(JL, JV, JGraphBuilder, JNetConfig)
    tm = build(TL, TV, GraphBuilder, NetConfig, device="cpu")
    jp, _ = jm.init()
    tm.params, tm.state = params_from_numpy(tm, _np_tree(jp)), {}
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 7, 3)).astype(np.float32)
    mask = np.ones((3, 7), np.float32)
    mask[0, 3:] = 0
    mask[1, 5:] = 0
    y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    (yj,) = jm.output(jnp.asarray(x), masks=jnp.asarray(mask))
    (yt,) = tm.output(x, masks=torch.from_numpy(mask))
    assert _rel(yt.numpy(), yj) <= F32_TOL
    (unmasked,) = tm.output(x)
    assert _rel(unmasked.numpy(), yj) > 1e-3  # the mask matters
    lj, _ = jm.score(jax.tree.map(jnp.asarray, jp), {}, jnp.asarray(x),
                     jnp.asarray(y), masks=jnp.asarray(mask))
    lt, _ = tm.score(tm.params, {}, torch.from_numpy(x), torch.from_numpy(y),
                     masks=torch.from_numpy(mask))
    assert abs(float(lt) - float(lj)) <= F32_TOL * abs(float(lj))


def test_graph_rejects_cycles_and_unknown_inputs():
    g = GraphBuilder(NetConfig(), device="cpu").add_input("in", (3,))
    g.add_layer("a", TL.Dense(n_out=2), "b").add_layer("b", TL.Dense(n_out=2),
                                                       "a")
    with pytest.raises(ValueError, match="cycle"):
        g.set_outputs("b").build()
    g = GraphBuilder(NetConfig(), device="cpu").add_input("in", (3,))
    with pytest.raises(ValueError, match="unknown input"):
        g.add_layer("a", TL.Dense(n_out=2), "nope").set_outputs("a").build()


def test_resnet50_matches_reference_tree_and_config():
    jm = JResNet50(num_classes=1000, seed=0,
                   input_shape=(224, 224, 3)).build()
    tm = ResNet50(num_classes=1000, seed=0, input_shape=(224, 224, 3),
                  device="cpu").build()
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    assert tm.topo_order == jm.topo_order
    jshapes, jstate = jax.eval_shape(jm.init)
    want = jax.tree.map(lambda s: tuple(s.shape), jshapes)
    assert tm.param_shapes() == want
    assert sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        want, is_leaf=lambda t: isinstance(t, tuple))) == 25557032
    _, tstate = tm._init_on(None, torch.device("meta"))
    assert jax.tree.map(lambda t: tuple(t.shape), tstate) == \
        jax.tree.map(lambda s: tuple(s.shape), jstate)
    assert tm.config.updater == {"type": "adam", "learning_rate": 1e-3}


def test_benchmark_iterator_serves_the_reference_batch():
    j = next(iter(JBenchmarkIterator((5, 5, 3), 10, 4, 1, seed=3)))
    it = BenchmarkIterator((5, 5, 3), 10, 4, 2, seed=3)
    batches = list(it)
    assert len(batches) == len(it) == 2 and it.batch_size == 4
    np.testing.assert_array_equal(batches[0].features, j.features)
    np.testing.assert_array_equal(batches[1].labels, j.labels)


def test_graph_updater_overrides_are_keyed_by_node():
    def build(L, GB, NC, **kw):
        return (GB(NC(updater={"type": "adam", "learning_rate": 1e-3}), **kw)
                .add_input("in", (4,))
                .add_layer("h", L.Dense(n_out=3, updater={
                    "type": "sgd", "learning_rate": 0.5}), "in")
                .add_layer("out", L.Output(n_out=2), "h")
                .set_outputs("out").build())

    tm = build(TL, GraphBuilder, NetConfig, device="cpu")
    jm = build(JL, JGraphBuilder, JNetConfig)
    jp, _ = jm.init()
    tm.params = params_from_numpy(tm, _np_tree(jp))
    tm.state = {}
    tx = build_updater(tm)
    leaves = tree_leaves(tm.params)
    grads = [torch.ones_like(p) for p in leaves]
    updates, _ = tx.update(grads, tx.init(leaves), leaves)
    names = [k for k in sorted(tm.params) for _ in tree_leaves(tm.params[k])]
    for n, u in zip(names, updates):
        want = -0.5 if n == "h" else -1e-3
        torch.testing.assert_close(u, torch.full_like(u, want), rtol=1e-4,
                                   atol=1e-7)


def test_multi_input_batches_are_not_ported_yet():
    # ported since: a MultiDataSet batch (features by input, labels by
    # output) trains a Graph as its DataSet does
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[0, 1]]
    losses = []
    for batch in (DataSet(x, y), MultiDataSet([x], [y])):
        tm = _port_narrow()
        tm.init(seed=0)
        rec = CollectScoresListener()
        Trainer(tm).fit([batch, batch], listeners=[rec])
        losses.append([loss for _, loss in rec.scores])
    assert losses[0] == losses[1]
