"""The port's tensor and sequence parallelism (``Trainer(mesh=, rules=)``,
the rule tables, ``place_params``, ``ParallelWrapper(rules=)``,
``MultiHostTrainer(rules=)``, ``sharded_lm_step``) held against the JAX
package's one sharding API on a mesh of the same shape.

The JAX side runs here over its forced host devices
(``make_mesh(axes, jax.devices()[:4])``); the port runs in 4 spawned gloo
ranks (one ``RankGroup`` for the whole file, rank ``r`` standing for
device ``r`` of the mesh), whose cases live in ``torch_sharding_ranks.py``
(no JAX there). Params are the reference's, carried across through the
model's JSON and ``params_from_numpy``; batches come from numpy seeds.

Tolerances are the reference tests' own (``tests/test_sharding_api.py``):
rtol 2e-5 / atol 1e-6 for the MLP and the masked Graph, 5e-5 / 1e-6 for
the CNN and grad_accum, 5e-5 / 1e-5 for the dp x tp x sp CausalLM, 1e-4 /
1e-5 for the ring, rope and GQA + window models. Scores within 1e-5,
confusion matrices exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import torch_sharding_ranks as R
from deeplearning4j_torch.parallel import RankGroup
from deeplearning4j_torch.parallel import sharding as S
from deeplearning4j_tpu.data import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.data.iterators import DataSet as JDataSet
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.nn import GraphBuilder, NetConfig, SequentialBuilder
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.parallel import make_mesh as jmake
from deeplearning4j_tpu.parallel import sharding as JS
from deeplearning4j_tpu.train import Trainer as JTrainer

MODEL = "model"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("g4")))
    yield g
    g.close()


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake(dict(axes), jax.devices()[:n])


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


def assert_tree_close(got, want, rtol, atol, what=""):
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], rtol, atol, f"{what}{k}/")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what}{k}")


def _mlp():
    return (SequentialBuilder(NetConfig(seed=7, updater={
        "type": "adam", "learning_rate": 1e-2}))
            .input_shape(12)
            .layer(L.Dense(n_out=16, activation="relu"))
            .layer(L.Dense(n_out=8, activation="tanh"))
            .layer(L.Output(n_out=4, activation="softmax", loss="mcxent"))
            .build())


def _cnn():
    return (SequentialBuilder(NetConfig(seed=2, updater={
        "type": "adam", "learning_rate": 1e-2}))
            .input_shape(8, 8, 3)
            .layer(L.Conv2D(n_out=8, kernel=(3, 3), activation="relu"))
            .layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
            .layer(L.Conv2D(n_out=4, kernel=(3, 3), activation="relu"))
            .layer(L.Flatten())
            .layer(L.Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())


def _lm(**kw):
    kw = dict(dict(num_layers=2, d_model=16, num_heads=2, vocab=32), **kw)
    return JCausalLM(seed=0, input_shape=(16,), **kw).build()


def _data(n=32, d=12, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return x, y


def _lm_data(seed, n=16):
    ids = np.random.default_rng(seed).integers(0, 32, (n, 17))
    return ids[:, :-1], np.eye(32, dtype=np.float32)[ids[:, 1:]]


def _batches(x, y, bs, steps=None):
    steps = steps if steps is not None else len(x) // bs
    return [(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
            for i in range(steps)]


def jfit(net, p0, x, y, steps, bs, axes=None, rules=None, **kw):
    """The JAX package's Trainer (over ``axes`` with ``rules`` when given)
    through ``steps`` batches in one fit: its params."""
    mesh = jmesh(axes) if axes else None
    tr = JTrainer(fresh(net, p0), mesh=mesh, rules=rules, **kw)
    it = JArrayIterator(x[:steps * bs], y[:steps * bs], bs, shuffle=False)
    tr.fit(it, epochs=1, prefetch=False)
    return tr, jax.tree.map(np.asarray, tr.params)


# ------------------------------------------------------------ specs

MESHES = [{"data": 2, MODEL: 2}, {MODEL: 4},
          {"data": 1, MODEL: 2, "seq": 2}]
RULES = ["TRANSFORMER_RULES", "CNN_RULES", "DENSE_RULES"]


@pytest.fixture(scope="module")
def trees():
    """The param trees of the CausalLM, the zoo's LeNet and the MLP, as
    zero arrays of their shapes (specs read shapes only)."""
    from deeplearning4j_tpu.models import LeNet

    def shapes(net):
        out = jax.eval_shape(lambda: net.init()[0])
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), out)

    return {"lm": shapes(_lm()), "lenet": shapes(LeNet(seed=0).build()),
            "mlp": shapes(_mlp())}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("rules", RULES)
def test_spec_for_matches_reference(trees, rules, axes):
    """spec_for and sharding_tree give the reference's specs, leaf for
    leaf, over the CausalLM's, LeNet's and the MLP's trees — the drop to
    replication for a missing or non-dividing axis included."""
    jm = jmesh(axes)
    pm = types.SimpleNamespace(shape=dict(axes))
    for name, params in trees.items():
        want = JS.sharding_tree(params, jm, getattr(JS, rules))
        got = S.sharding_tree(jax.tree.map(np.asarray, params), pm,
                              getattr(S, rules))
        for path, leaf in JS._tree_paths(params):
            j = want
            g = got
            for k in path.split("/"):
                j, g = j[k], g[k]
            assert g == tuple(j.spec), (name, path, g, j.spec)
            assert S.spec_for(path, np.asarray(leaf), getattr(S, rules),
                              pm) == tuple(JS.spec_for(
                                  path, leaf, getattr(JS, rules), jm))


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_place_params_matches_addressable_shards(ranks, axes):
    """Each rank's place_params shard of every leaf equals the reference's
    addressable shard on the device the rank stands for (the CausalLM
    under TRANSFORMER_RULES, the MLP under DENSE_RULES)."""
    jm = jmesh(axes)
    devices = list(jm.devices.reshape(-1))
    for net, rules in ((_lm(), "TRANSFORMER_RULES"), (_mlp(), "DENSE_RULES")):
        js, p0 = carry(net)
        placed = JS.place_params(p0, jm, getattr(JS, rules))
        got = ranks.run_all(R.local_shards, js, p0, axes, rules)
        for path, arr in JS._tree_paths(placed):
            for shard in arr.addressable_shards:
                r = devices.index(shard.device)
                g = got[r]
                for k in path.split("/"):
                    g = g[k]
                np.testing.assert_array_equal(g, np.asarray(shard.data),
                                              err_msg=f"{rules} {path} "
                                                      f"rank {r}")


@pytest.mark.parametrize("axis", ["data", "seq"])
def test_batch_placement_matches_reference(ranks, axis):
    """shard_batch over the data or the seq axis (dim 0 split over it) and
    place_batch's dp(+sp) layout by rank and dtype (a (B, T, F) float
    batch and (B, T) integer ids over data 2 x seq 2) give each rank the
    reference's addressable shard on its device."""
    from deeplearning4j_tpu.parallel import shard_batch as jshard

    axes = {"data": 2, "seq": 2}
    jm = jmesh(axes)
    devices = list(jm.devices.reshape(-1))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, 3)).astype(np.float32)
    ids = rng.integers(0, 9, (4, 8)).astype(np.int32)
    got = ranks.run_all(R.batch_blocks, x, ids, axes, axis)
    for arr, key in ((jshard(x, jm, axis), "shard"),
                     (JS.place_batch(jm, x, ids)[0], "x"),
                     (JS.place_batch(jm, x, ids)[1], "ids")):
        for shard in arr.addressable_shards:
            r = devices.index(shard.device)
            np.testing.assert_array_equal(got[r][key],
                                          np.asarray(shard.data),
                                          err_msg=f"{key} rank {r}")


# ------------------------------------------------------------ Trainer

def test_dp_tp_equivalence_mlp(ranks):
    """MLP + DENSE_RULES on a data 2 x model 2 mesh == the reference's on
    the same mesh (and unsharded); each kernel held as its column
    block, its adam moments too."""
    x, y = _data()
    js, p0 = carry(_mlp())
    _, want = jfit(_mlp(), p0, x, y, 4, 8, {"data": 2, MODEL: 2},
                   JS.DENSE_RULES, seed=3)
    got = ranks.run(R.trainer_fit, js, p0, _batches(x, y, 8, 4),
                    {"data": 2, MODEL: 2}, "DENSE_RULES", seed=3,
                    evaluate=False)
    assert_tree_close(got["params"], want, rtol=2e-5, atol=1e-6)
    assert got["local"]["layer_0"]["w"] == (12, 8)
    assert got["local"]["layer_2"]["b"] == (2,)
    assert (12, 8) in got["opt"]


def test_params_actually_sharded(ranks):
    """The rules distribute: over model 4, layer_0's (12, 16) kernel is a
    (12, 4) block on every rank, four distinct blocks, and its adam
    moments are held at the block's shape."""
    js, p0 = carry(_mlp())
    x, y = _data(8)
    outs = ranks.run_all(R.trainer_fit, js, p0, [(x, y)], {MODEL: 4},
                         "DENSE_RULES", evaluate=False)
    assert all(o["local"]["layer_0"]["w"] == (12, 4) for o in outs)
    assert all(o["opt"].count((12, 4)) == 2 for o in outs)  # mu and nu
    shards = ranks.run_all(R.local_shards, js, p0, {MODEL: 4}, "DENSE_RULES")
    cols = [s["layer_0"]["w"] for s in shards]
    np.testing.assert_array_equal(np.concatenate(cols, 1),
                                  p0["layer_0"]["w"])
    assert len({c.tobytes() for c in cols}) == 4


def test_evaluate_and_score_under_mesh(ranks):
    """score_iterator and evaluate under rules equal the reference's on
    the same mesh."""
    x, y = _data(24)
    js, p0 = carry(_mlp())
    tr, _ = jfit(_mlp(), p0, x, y, 3, 8, {"data": 2, MODEL: 2},
                 JS.DENSE_RULES)
    it = lambda: JArrayIterator(x, y, 8, shuffle=False)  # noqa: E731
    got = ranks.run(R.trainer_fit, js, p0, _batches(x, y, 8),
                    {"data": 2, MODEL: 2}, "DENSE_RULES")
    np.testing.assert_allclose(got["score"], tr.score_iterator(it()),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["confusion"],
                                  tr.evaluate(it()).confusion)
    assert got["confusion"].sum() == 24


LM_CASES = [  # (mesh, CausalLM kwargs, updater lr, rtol, atol)
    ({"data": 1, MODEL: 2, "seq": 2}, {}, 5e-5, 1e-5),
    ({MODEL: 4}, {}, 5e-5, 1e-5),
    ({"data": 2, "seq": 2}, {"ring": True}, 1e-4, 1e-5),
    ({MODEL: 2, "seq": 2}, {"ring": True, "pos": "rope"}, 1e-4, 1e-5),
    ({"data": 2, MODEL: 2}, {"num_heads": 4, "num_kv_heads": 2,
                             "pos": "rope", "window": 5}, 1e-4, 1e-5),
    ({MODEL: 2, "seq": 2}, {"num_heads": 4, "num_kv_heads": 2,
                            "pos": "rope", "window": 5}, 1e-4, 1e-5),
]


@pytest.mark.parametrize("axes,kw,rtol,atol", LM_CASES, ids=[
    "x".join(f"{k}{v}" for k, v in a.items()) + "-"
    + ("-".join(f"{k}{v}" for k, v in kw.items()) or "learned")
    for a, kw, _, _ in LM_CASES])
def test_causal_lm_rules_equivalence(ranks, axes, kw, rtol, atol):
    """The CausalLM with TRANSFORMER_RULES over dp x tp x sp meshes (ring
    attention on the seq blocks, rope at global positions, GQA with a
    window gathering K/V over seq) == the reference's Trainer(mesh=,
    rules=) on the same mesh, 2 SGD steps (SGD: linear in the gradients,
    so the comparison tests the collectives' math)."""
    x, y = _lm_data(1)
    js, p0 = carry(_lm(**kw))
    _, want = jfit(_lm(**kw), p0, x, y, 2, 8, axes, JS.TRANSFORMER_RULES,
                   seed=5, updater=optax.sgd(0.1))
    got = ranks.run(R.trainer_fit, js, p0, _batches(x, y, 8), axes,
                    "TRANSFORMER_RULES", updater=("sgd", 0.1), seed=5,
                    evaluate=False)
    assert_tree_close(got["params"], want, rtol=rtol, atol=atol)
    tp = axes.get(MODEL, 1)
    qkv = want["layer_2"]["attn"]["w_qkv"].shape
    assert got["local"]["layer_2"]["attn"]["w_qkv"] == (
        qkv[0], qkv[1] // tp)


def test_graph_model_with_masks(ranks):
    """A Graph with an LSTM and feature/label masks through the same API
    (DENSE_RULES on a data 2 x model 2 mesh)."""
    def build():
        g = (GraphBuilder(NetConfig(seed=11, updater={
            "type": "adam", "learning_rate": 1e-2}))
             .add_input("in", (10, 6))
             .add_layer("rnn", L.LSTM(n_out=8), "in")
             .add_layer("out", L.RnnOutput(n_out=3, activation="softmax",
                                           loss="mcxent"), "rnn")
             .set_outputs("out")
             .build())
        g.init()
        return g

    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 10, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (16, 10))]
    mask = (rng.random((16, 10)) > 0.2).astype(np.float32)
    batches = [(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8],
                mask[i * 8:(i + 1) * 8], mask[i * 8:(i + 1) * 8])
               for i in range(2)]
    js, p0 = carry(build())
    tr = JTrainer(fresh(build(), p0), seed=9,
                  mesh=jmesh({"data": 2, MODEL: 2}), rules=JS.DENSE_RULES)
    for b in batches:
        class _It:
            def __iter__(self, b=b):
                return iter([JDataSet(*b)])

            def reset(self):
                pass

        tr.fit(_It(), epochs=1, prefetch=False)
    want = jax.tree.map(np.asarray, tr.params)
    got = ranks.run(R.trainer_fit, js, p0, batches, {"data": 2, MODEL: 2},
                    "DENSE_RULES", seed=9, evaluate=False)
    assert_tree_close(got["params"], want, rtol=2e-5, atol=1e-6)


def test_dp_tp_equivalence_cnn(ranks):
    """CNN_RULES (output-channel-split HWIO kernels) on a data 2 x model 2
    mesh == the reference's on the same mesh."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((32, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    js, p0 = carry(_cnn())
    _, want = jfit(_cnn(), p0, x, y, 4, 8, {"data": 2, MODEL: 2},
                   JS.CNN_RULES, seed=1)
    got = ranks.run(R.trainer_fit, js, p0, _batches(x, y, 8, 4),
                    {"data": 2, MODEL: 2}, "CNN_RULES", seed=1,
                    evaluate=False)
    assert got["local"]["layer_0"]["w"] == (3, 3, 3, 4)
    assert_tree_close(got["params"], want, rtol=5e-5, atol=1e-6)


def test_grad_accum_dp_tp_equivalence(ranks):
    """grad_accum composes with rules: strided microbatches and one update
    over a data 2 x model 2 mesh == the reference's on the same mesh."""
    x, y = _data(n=64)
    js, p0 = carry(_mlp())
    _, want = jfit(_mlp(), p0, x, y, 4, 16, {"data": 2, MODEL: 2},
                   JS.DENSE_RULES, seed=5, grad_accum=2)
    got = ranks.run(R.trainer_fit, js, p0, _batches(x, y, 16, 4),
                    {"data": 2, MODEL: 2}, "DENSE_RULES", seed=5, accum=2,
                    evaluate=False)
    assert_tree_close(got["params"], want, rtol=5e-5, atol=1e-6)


# ------------------------------------------------- wrapper and multihost

def _jpw(axes, rules, mode, x, y):
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW

    js, p0 = carry(_mlp())
    pw = JPW(fresh(_mlp(), p0), mesh=jmesh(axes), seed=3, mode=mode,
             rules=rules)
    pw.fit(JArrayIterator(x, y, 8, shuffle=False), epochs=1)
    pw._sync_model()
    return js, p0, pw


def test_parallel_wrapper_rules(ranks):
    """ParallelWrapper(rules=) in shared_gradients over data 2 x model 2
    == the reference's."""
    x, y = _data(32)
    js, p0, pw = _jpw({"data": 2, MODEL: 2}, JS.DENSE_RULES,
                      "shared_gradients", x, y)
    got = ranks.run(R.wrapper_fit, js, p0, _batches(x, y, 8),
                    {"data": 2, MODEL: 2}, "DENSE_RULES")
    assert_tree_close(got["params"], jax.tree.map(np.asarray,
                                                  pw.model.params),
                      rtol=2e-5, atol=1e-6)
    assert got["local"]["layer_0"]["w"] == (12, 8)


def test_rules_compose_with_zero1(ranks):
    """zero_sharded + rules: the ruled leaf's moments keep its model-axis
    block, the others' moments shard over data (ZeRO-1) — and training
    equals the reference's wrapper with the same rules."""
    x, y = _data(32)
    rules_j = ((r"layer_0/w", P(None, MODEL)),)
    rules_p = ((r"layer_0/w", (None, MODEL)),)
    js, p0, pw = _jpw({"data": 2, MODEL: 2}, rules_j, "zero_sharded", x, y)
    mu = pw.opt_state[0].mu
    assert mu["layer_0"]["w"].sharding.spec == P(None, MODEL)
    got = ranks.run(R.wrapper_fit, js, p0, _batches(x, y, 8),
                    {"data": 2, MODEL: 2}, rules_p, "zero_sharded")
    assert_tree_close(got["params"], jax.tree.map(np.asarray,
                                                  pw.model.params),
                      rtol=2e-5, atol=1e-6)
    assert got["local"]["layer_0"]["w"] == (12, 8)
    # mu and nu: layer_0/w at its (12, 8) block, layer_1/w (16, 8) split
    # over data along its largest dim
    assert got["opt"].count((12, 8)) == 2 and got["opt"].count((8, 8)) == 2


@pytest.mark.parametrize("mode", ["averaging", "encoded_gradients"])
def test_rules_rejected_for_replica_modes(ranks, mode):
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW

    with pytest.raises(ValueError, match="rules"):
        JPW(_mlp(), mode=mode, rules=JS.DENSE_RULES)
    js, p0 = carry(_mlp())
    err = ranks.run(R.rejects, js, p0, {"data": 4},
                    {"mode": mode, "rules": "DENSE_RULES"})
    assert err is not None and err[0] == "ValueError" and "rules" in err[1]


@pytest.mark.parametrize("accum", [1, 2])
def test_multihost_trainer_rules(ranks, accum):
    """MultiHostTrainer(rules=) fed per data_shard() over data 2 x model 2
    == the reference's on the same mesh (grad_accum as its strided
    microbatches); evaluate(global_mesh=True) merges one rank a data block;
    save and restore round-trip the shards and the updater state."""
    from deeplearning4j_tpu.parallel import MultiHostTrainer as JMH
    from deeplearning4j_tpu.parallel import ProcessShardIterator as JPSI

    x, y = _data(n=64)
    js, p0 = carry(_mlp())
    mh = JMH(fresh(_mlp(), p0), mesh=jmesh({"data": 2, MODEL: 2}), seed=0,
             rules=JS.DENSE_RULES, grad_accum=accum)
    mh.fit(JPSI(x, y, global_batch_size=16), epochs=2)
    mh._sync_model()
    want = jax.tree.map(np.asarray, mh.model.params)
    ev = mh.evaluate(JPSI(x, y, global_batch_size=16), global_mesh=True)
    got = ranks.run(R.multihost_fit, js, p0, x, y, 16, 2,
                    {"data": 2, MODEL: 2}, "DENSE_RULES", accum)
    assert_tree_close(got["params"], want, rtol=5e-5, atol=1e-6)
    np.testing.assert_array_equal(got["confusion"], ev.confusion)
    assert got["confusion"].sum() == 64 and got["restored"]


# ------------------------------------------------- ring routing, save, step

@pytest.mark.parametrize("axes", [{MODEL: 2, "seq": 2}, {"data": 2,
                                                          "seq": 2}],
                         ids=["model2xseq2", "data2xseq2"])
def test_activation_sharding_forward(ranks, axes):
    """A forward of the shards on a rank's block inside activation_sharding
    (Megatron's block, the ring on the seq blocks, learned positions at
    global offsets) equals the plain forward's block on one device."""
    js, p0 = carry(_lm(ring=True))
    x, _ = _lm_data(6, 4)
    err = ranks.run_all(R.forward_under_context, js, p0, x, axes,
                        "TRANSFORMER_RULES")
    assert max(err) < 1e-5, err


def test_ring_falls_back_without_mesh():
    """ring=True outside a sharded step: the dense path, equal to
    ring=False."""
    import torch

    from deeplearning4j_torch.nn import layers as TL

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 8, 16)).astype(np.float32))
    blk_r = TL.TransformerEncoderBlock(num_heads=2, causal=True, ring=True)
    blk_d = TL.TransformerEncoderBlock(num_heads=2, causal=True)
    p, _ = blk_r.init(torch.Generator().manual_seed(0), (8, 16))
    yr, _, _ = blk_r.apply(p, {}, x, training=False)
    yd, _, _ = blk_d.apply(p, {}, x, training=False)
    np.testing.assert_array_equal(yr.numpy(), yd.numpy())


def test_save_writes_whole_params_the_reference_reads(ranks, tmp_path):
    """save under rules: rank 0 writes the whole params into the model zip,
    which the JAX package loads."""
    from deeplearning4j_tpu.train.serialization import load_model

    x, y = _lm_data(3, 8)
    js, p0 = carry(_lm())
    path = str(tmp_path / "lm.zip")
    got = ranks.run(R.save_whole, js, p0, _batches(x, y, 8),
                    {"data": 1, MODEL: 2, "seq": 2}, "TRANSFORMER_RULES",
                    path)
    params = load_model(path)[1]
    assert_tree_close(jax.tree.map(np.asarray, params), got, rtol=0, atol=0)


def test_sharded_lm_step(ranks):
    """sharded_lm_step's one step over data 1 x model 2 x seq 2: the loss
    and the params are the reference's sharded_lm_step's."""
    from deeplearning4j_tpu.models.transformer import \
        sharded_lm_step as jstep

    x, y = _lm_data(4, 8)
    js, p0 = carry(_lm())
    axes = {"data": 1, MODEL: 2, "seq": 2}
    m = fresh(_lm(), p0)
    step, params, opt, place = jstep(m, jmesh(axes), optax.sgd(0.1))
    params, opt, loss = step(params, opt, *place(x, y),
                             jax.random.PRNGKey(0))
    got = ranks.run(R.lm_step, js, p0, x, y, axes, 0.1)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    assert_tree_close(got["params"], jax.tree.map(np.asarray, params),
                      rtol=5e-5, atol=1e-5)


def test_early_stopping_and_telemetry_take_a_rules_wrapper(ranks):
    """EarlyStoppingParallelTrainer and StepTelemetry.parallel_step take a
    ParallelWrapper(rules=) as they take a data-parallel one: the best
    score, epoch and params equal the data-parallel run's on the same
    mesh, and every rank's step time is gauged."""
    x, y = _data(48)
    js, p0 = carry(_mlp())
    train, held = _batches(x[:32], y[:32], 8), _batches(x[32:], y[32:], 8)
    axes = {"data": 2, MODEL: 2}
    got = ranks.run(R.early_stopping_and_telemetry, js, p0, train, held,
                    axes, "DENSE_RULES", 3)
    want = ranks.run(R.early_stopping_and_telemetry, js, p0, train, held,
                     axes, None, 3)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["best_score"], want["best_score"],
                               rtol=1e-5)
    assert_tree_close(got["best_params"], want["best_params"], rtol=2e-5,
                      atol=1e-6)
    assert got["steps"] == len(train)
    for r in range(4):
        assert f'parallel_replica_step_seconds{{replica="{r}"}}' \
            in got["prom"]
