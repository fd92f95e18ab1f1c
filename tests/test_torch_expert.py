"""Expert-parallel MoE in the port (``nn/layers/moe.py`` under an expert
mesh, ``parallel/sharding.py``'s expert placement) held against the JAX
package's expert-sharded ``MoE.apply``.

The reference shards an MoE layer's ``w_up``, ``b_up``, ``w_down`` and
``b_down`` over an ``expert`` mesh axis on their leading dimension
(``tests/test_moe.py``, the multichip dry run) and lets GSPMD run the
layer. The port runs in spawned gloo ranks at ep 2 and 4 (cases in
``torch_sharding_ranks.py``): each rank holds E/ep experts, routes every
token with the replicated router and sums its experts' share of the
combine over the group. Outputs, the aux loss and every gradient within
the reference test's ``rtol=2e-4, atol=2e-5``; a rank holds only its
experts' leaves. Then an MoE LM trained by ``Trainer(mesh={"expert":
ep}, rules=)`` against the JAX package's ``Trainer`` on one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_sharding_ranks as R
from deeplearning4j_torch.parallel import RankGroup
from deeplearning4j_torch.parallel.sharding import check_specs
from deeplearning4j_tpu.data import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import NetConfig, SequentialBuilder
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.parallel import make_mesh as jmake
from deeplearning4j_tpu.train import Trainer as JTrainer

RTOL, ATOL = 2e-4, 2e-5
MOE = dict(num_experts=4, top_k=2, capacity_factor=4.0)
EXPERT_KEYS = ("w_up", "b_up", "w_down", "b_down")


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


def _reference(ep, params, state, x):
    """The reference's layer on ``ep`` host devices, its expert leaves
    placed over the expert axis: output, aux loss and gradients."""
    mesh = jmake({"expert": ep}, jax.devices()[:ep])
    moe = L.MoE(**MOE)
    placed = {k: jax.device_put(v, NamedSharding(
        mesh, P("expert") if k in EXPERT_KEYS else P()))
        for k, v in params.items()}

    @jax.jit
    def run(p, x):
        def loss(p, x):
            y, s, _ = moe.apply(p, state, x, training=True)
            return jnp.sum(jnp.square(y)) + s["aux_loss"], (y, s["aux_loss"])

        return jax.grad(loss, argnums=(0, 1), has_aux=True)(p, x)

    with mesh:
        (gp, gx), (y, aux) = run(placed, jax.device_put(
            x, NamedSharding(mesh, P())))
    return (np.asarray(y), float(aux),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_sharded_matches_reference(ranks, ep):
    d = 8
    moe = L.MoE(**MOE)
    params, state = moe.init(jax.random.PRNGKey(0), (d,))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (16, d)))
    y, aux, grads, gx = _reference(ep, params, state, x)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    got = ranks(ep).run_all(R.moe_expert, MOE, np_params, x, ep)
    n = MOE["num_experts"] // ep
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"], y, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["aux"], aux, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["gx"], gx, rtol=RTOL, atol=ATOL)
        for k, want in grads.items():
            mine = want[r * n:(r + 1) * n] if k in EXPERT_KEYS else want
            assert g["shapes"][k] == mine.shape  # only this rank's experts
            np.testing.assert_allclose(g["grads"][k], mine, rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {k}")


def test_expert_axis_only_on_expert_leaves():
    check_specs({"moe": {"w_up": ("expert",), "w_router": ()}})
    with pytest.raises(ValueError, match="expert"):
        check_specs({"moe": {"w_router": ("expert",)}})
    with pytest.raises(ValueError, match="expert"):
        check_specs({"moe": {"w_up": (None, "expert")}})


def _moe_lm():
    return (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "sgd", "learning_rate": 0.1}))
            .input_shape(8)
            .layer(L.EmbeddingSequence(n_in=20, n_out=8))
            .layer(L.MoETransformerBlock(num_heads=2, causal=True, **MOE))
            .layer(L.RnnOutput(n_out=20, activation="softmax",
                               loss="mcxent"))
            .build())


def test_trainer_on_an_expert_mesh(ranks):
    """Trainer(mesh={"expert": 2}, rules=the expert rule) trains an MoE LM
    as the reference's one-device Trainer does: the tokens are every
    rank's, the router's gradient whole on each, each rank's experts' its
    own (nothing reduced over the expert axis)."""
    net = _moe_lm()
    net.init()
    js, p0 = net.to_json(), jax.tree.map(np.asarray, net.params)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 20, (8, 8)).astype(np.int32)
    y = rng.randint(0, 20, (8, 8)).astype(np.int32)
    jt = JTrainer(net)
    jt.fit(JArrayIterator(x, y, 4, shuffle=False), epochs=1)
    got = ranks(2).run(R.moe_lm_fit, js, p0, [(x[:4], y[:4]), (x[4:], y[4:])],
                       2)
    assert got["local"]["layer_1"]["moe"]["w_up"][0] == 2
    flat_got = jax.tree_util.tree_leaves(got["params"])
    flat_want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jt.params))
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
