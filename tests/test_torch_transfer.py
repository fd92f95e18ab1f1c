"""The port's transfer learning (``deeplearning4j_torch/nn/transfer.py``,
``Frozen``, the trainer's frozen leaves, ``summary``) held against the
JAX package.

A small CNN, as a Graph and as a Sequential, each with BatchNorms: the
reference builds and initializes the source, its params and running
statistics are carried into the port's source, and both packages run the
same surgery (Nesterovs with RenormalizeL2PerLayer, frozen through the
second BatchNorm, a new 3-way head). Held:

- the JSON of the built network (``Frozen`` included) equal;
- the same entries carried and the same drawn afresh;
- 5 ``Trainer.fit`` steps from the reference's built params: losses and
  params within 1e-4 (relative to the largest entry of each leaf), frozen
  leaves and frozen running statistics bit-unchanged;
- a frozen layer between trainable ones passing its gradient down within
  1e-5 of the reference's gradient (of the largest entry);
- ``TransferLearningHelper``: features within 1e-5, the head fitted on
  them within 1e-4, ``merge_back`` writing it into the full network;
- ``summary()`` text equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import (GraphBuilder, NetConfig,
                                           Sequential)
from deeplearning4j_torch.nn.transfer import (FineTuneConfiguration,
                                              TransferGraphBuilder,
                                              TransferLearningBuilder,
                                              TransferLearningHelper)
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        params_from_numpy, state_from_numpy)
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import transfer as JT
from deeplearning4j_tpu.nn.model import GraphBuilder as JGraphBuilder
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

TRAJ_TOL = 1e-4
GRAD_TOL = 1e-5
FEAT_TOL = 1e-5
STEPS = 5
FTC = dict(updater={"type": "nesterovs", "learning_rate": 1e-2,
                    "momentum": 0.9},
           gradient_normalization="RenormalizeL2PerLayer")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _graph(L, GB, NC, **kw):
    g = GB(NC(seed=0, updater={"type": "adam", "learning_rate": 1e-3}),
           **kw).add_input("in", (8, 8, 3))
    g.add_layer("c1", L.Conv2D(n_out=4, kernel=(3, 3), use_bias=False), "in")
    g.add_layer("bn1", L.BatchNorm(activation="relu"), "c1")
    g.add_layer("c2", L.Conv2D(n_out=6, kernel=(3, 3), stride=(2, 2),
                               use_bias=False), "bn1")
    g.add_layer("bn2", L.BatchNorm(activation="relu"), "c2")
    g.add_layer("gap", L.GlobalPooling(mode="avg"), "bn2")
    g.add_layer("d1", L.Dense(n_out=8, activation="relu"), "gap")
    g.add_layer("act", L.ActivationLayer(activation="identity"), "d1")
    g.add_layer("out", L.Output(n_out=5, activation="softmax"), "act")
    return g.set_outputs("out").build()


def _seq(L, S, NC, **kw):
    return S(NC(seed=0), [
        L.Conv2D(n_out=4, kernel=(3, 3), use_bias=False),
        L.BatchNorm(activation="relu"),
        L.Subsampling2D(kernel=(2, 2), stride=(2, 2)),
        L.Conv2D(n_out=6, kernel=(3, 3), use_bias=False),
        L.BatchNorm(activation="relu"),
        L.GlobalPooling(mode="avg"),
        L.Dense(n_out=8, activation="relu"),
        L.Dense(n_out=6, activation="tanh"),
        L.Output(n_out=5, activation="softmax")], (8, 8, 3), **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return x, y


def _sources(kind):
    """The reference's source network (initialized, one training-mode
    forward so its running statistics are not the initial ones) and the
    port's with the same params and state."""
    if kind == "graph":
        j = _graph(JL, JGraphBuilder, JNetConfig)
        t = _graph(TL, GraphBuilder, NetConfig, device="cpu")
    else:
        j = _seq(JL, JSequential, JNetConfig)
        t = _seq(TL, Sequential, NetConfig, device="cpu")
    jp, js = j.init()
    x = np.random.default_rng(1).standard_normal((8, 8, 8, 3)).astype(
        np.float32)
    if kind == "graph":
        _, js = j.forward(jp, js, x, training=True)
    else:
        _, js = j.forward(jp, js, x, training=True)
    j.params, j.state = jp, js
    t.params = params_from_numpy(t, _np(jp))
    t.state = state_from_numpy(_np(js), "cpu")
    return j, t


def _surgery(kind, pkg, src):
    T = JT if pkg == "jax" else __import__(
        "deeplearning4j_torch.nn.transfer", fromlist=["x"])
    ftc = T.FineTuneConfiguration(**FTC)
    if kind == "graph":
        return (T.TransferGraphBuilder(src).fine_tune_configuration(ftc)
                .set_feature_extractor("bn2").n_out_replace("d1", 7)
                .n_out_replace("out", 3).build())
    return (T.TransferLearningBuilder(src).fine_tune_configuration(ftc)
            .set_feature_extractor(4).n_out_replace(8, 3).build())


@pytest.fixture(scope="module", params=["graph", "sequential"])
def built(request):
    kind = request.param
    jsrc, tsrc = _sources(kind)
    jnet, jp, js = _surgery(kind, "jax", jsrc)
    tnet, tp, ts = _surgery(kind, "torch", tsrc)
    return kind, jsrc, tsrc, (jnet, _np(jp), _np(js)), (tnet, tp, ts)


def _carried(src_params, params):
    """Keys whose params are the source's exactly."""
    out = set()
    for k, v in params.items():
        if k in src_params and all(
                np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(jax.tree_util.tree_leaves(_np_t(v)),
                                jax.tree_util.tree_leaves(
                                    _np_t(src_params[k])))):
            out.add(k)
    return out


def _np_t(tree):
    return jax.tree.map(lambda a: a.detach().numpy()
                        if isinstance(a, torch.Tensor) else np.asarray(a),
                        tree)


def test_built_json_equal(built):
    _, _, _, (jnet, _, _), (tnet, _, _) = built
    assert json.loads(tnet.to_json()) == json.loads(jnet.to_json())
    assert '"@type": "Frozen"' in tnet.to_json()


def test_same_entries_carried_and_redrawn(built):
    _, jsrc, tsrc, (_, jp, js), (_, tp, ts) = built
    assert set(tp) == set(jp) and set(ts) == set(js)
    assert _carried(tsrc.params, tp) == _carried(jsrc.params, jp)
    assert _carried(tsrc.state, ts) == _carried(jsrc.state, js)


def test_summary_text_equal(built):
    _, jsrc, tsrc, (jnet, _, _), (tnet, _, _) = built
    assert tnet.summary() == jnet.summary()
    assert tsrc.summary() == jsrc.summary()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_fine_tune_trajectory(built, data):
    kind, _, tsrc, (jnet, jp, js), (tnet, _, _) = built
    tnet.params = params_from_numpy(tnet, jp)
    tnet.state = state_from_numpy(js, "cpu")
    src_frozen = {k: _np_t(tsrc.params[k]) for k in tnet.params
                  if isinstance(_layer(tnet, k), TL.Frozen)}
    src_stats = {k: _np_t(tsrc.state[k]) for k in src_frozen
                 if k in tsrc.state}
    assert src_frozen and src_stats
    jnet.params, jnet.state = jax.tree.map(np.array, jp), \
        jax.tree.map(np.array, js)
    x, y = data
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    jt = JTrainer(jnet).fit(JArrayIterator(x, y, batch_size=4), epochs=1,
                            listeners=[jrec], prefetch=False)
    JTrainer.fit(jt, JArrayIterator(x[:4], y[:4], batch_size=4),
                 listeners=[jrec], prefetch=False)
    tt = Trainer(tnet).fit(ArrayIterator(x, y, batch_size=4), epochs=1,
                           listeners=[trec], prefetch=False)
    tt.fit(ArrayIterator(x[:4], y[:4], batch_size=4), listeners=[trec],
           prefetch=False)
    jl, tl = [l for _, l in jrec.scores], [l for _, l in trec.scores]
    assert len(tl) == STEPS and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL)
    for k in tt.params:
        for a, b in zip(tree_leaves(tt.params[k]),
                        jax.tree_util.tree_leaves(jt.params[k])):
            assert _rel(a.detach().numpy(), b) <= TRAJ_TOL, k
    for k, leaves in src_frozen.items():
        for a, b in zip(tree_leaves(tt.params[k]),
                        jax.tree_util.tree_leaves(leaves)):
            assert np.array_equal(a.detach().numpy(), b), k
    for k, st in src_stats.items():
        for a, b in zip(tree_leaves(tt.state[k]),
                        jax.tree_util.tree_leaves(st)):
            assert np.array_equal(a.numpy(), b), k
    # every unfrozen leaf moved
    for k in tt.params:
        if k not in src_frozen:
            assert not all(np.array_equal(a.detach().numpy(), np.asarray(b))
                           for a, b in zip(tree_leaves(tt.params[k]),
                                           jax.tree_util.tree_leaves(
                                               jp[k]))), k


def _layer(model, key):
    if hasattr(model, "nodes"):
        return model.nodes[key].spec
    from deeplearning4j_torch.nn.model import _layer_key
    return next(l for i, l in enumerate(model.layers)
                if _layer_key(i, l) == key)


def _sandwich(L, S, NC, **kw):
    return S(NC(seed=0), [
        L.Dense(n_out=6, activation="tanh"),
        L.Frozen(inner=L.Dense(n_out=5, activation="tanh").to_dict()),
        L.Dense(n_out=4, activation="tanh"),
        L.Output(n_out=3, activation="softmax")], (7,), **kw)


def test_frozen_layer_passes_gradient_down():
    jm = _sandwich(JL, JSequential, JNetConfig)
    jp, js = jm.init()
    tm = _sandwich(TL, Sequential, NetConfig, device="cpu")
    tp = params_from_numpy(tm, _np(jp))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 7)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    jg = jax.grad(lambda p: jm.score(p, js, x, y)[0])(jp)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss, _ = tm.score(tp, {}, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = [k for k in sorted(tp) for _ in tree_leaves(tp[k])]
    for n, g, w in zip(names, grads, jax.tree_util.tree_leaves(jg)):
        if n == "layer_1":  # frozen: no gradient reaches its params
            assert g is None and not np.asarray(w).any()
        else:
            assert _rel(g.numpy(), w) <= GRAD_TOL, n
    assert np.abs(np.asarray(jg["layer_0"]["w"])).max() > 0


def test_helper_featurize_fit_and_merge_back(data):
    jsrc, tsrc = _sources("sequential")
    jnet, jp, js = _surgery("sequential", "jax", jsrc)
    tnet, _, _ = _surgery("sequential", "torch", tsrc)
    jp, js = _np(jp), _np(js)
    tnet.params = params_from_numpy(tnet, jp)
    tnet.state = state_from_numpy(js, "cpu")
    jh = JT.TransferLearningHelper(jnet, jax.tree.map(np.array, jp), js)
    th = TransferLearningHelper(tnet)
    x, y = data
    jf = np.asarray(jh.featurize(x))
    tf = th.featurize(x)
    assert _rel(tf.numpy(), jf) <= FEAT_TOL
    assert json.loads(th.unfrozen_network().to_json()) == \
        json.loads(jh.unfrozen_network().to_json())
    jt = JTrainer(jh.unfrozen_network()).fit(
        JArrayIterator(jf, y, batch_size=8), epochs=2, prefetch=False)
    tt = Trainer(th.unfrozen_network()).fit(
        ArrayIterator(tf.numpy(), y, batch_size=8), epochs=2,
        prefetch=False)
    jh.unfrozen.params = jt.params
    jmerged, tmerged = jh.merge_back(), th.merge_back()
    assert set(tmerged) == set(jmerged)
    for k in tmerged:
        for a, b in zip(tree_leaves(tmerged[k]),
                        jax.tree_util.tree_leaves(jmerged[k])):
            assert _rel(a.detach().numpy(), b) <= TRAJ_TOL, k
    assert tnet.params is tmerged


def test_helper_needs_a_frozen_prefix():
    m = _seq(TL, Sequential, NetConfig, device="cpu")
    m.init()
    with pytest.raises(ValueError, match="no frozen prefix"):
        TransferLearningHelper(m)


def test_n_out_replace_needs_n_out():
    jsrc, tsrc = _sources("graph")
    with pytest.raises(ValueError, match="has no n_out"):
        TransferGraphBuilder(tsrc).n_out_replace("gap", 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [transfer] phase "
                    "runs these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fine_tune_on_card_matches_cpu(cuda, data):
    """The Graph fine-tune on the card against the same fine-tune on the
    CPU from the same params (TF32 off): losses within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, tsrc = _sources("graph")
    start, losses = None, []
    for dev in ("cpu", cuda):
        src = _graph(TL, GraphBuilder, NetConfig, device=dev)
        src.params = params_from_numpy(src, _np_t(tsrc.params), dev)
        src.state = state_from_numpy(_np_t(tsrc.state), dev)
        net, _, _ = _surgery("graph", "torch", src)
        start = start or (_np_t(net.params), _np_t(net.state))
        net.params = params_from_numpy(net, start[0], dev)
        net.state = state_from_numpy(start[1], dev)
        rec = CollectScoresListener()
        x, y = data
        Trainer(net).fit(ArrayIterator(x, y, batch_size=4), listeners=[rec],
                         prefetch=False)
        losses.append([l for _, l in rec.scores])
    np.testing.assert_allclose(losses[1], losses[0], rtol=TRAJ_TOL)
