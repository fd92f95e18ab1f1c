"""The rest of the port's core API held against the JAX package:
``TrainableModel`` (``model.fit`` with its four overloads, the cached
``trainer`` and its rebuild warning, ``output_iterator``, evaluation
through the cached trainer), ``Sequential.activations``, the small public
functions (``softmax_stable``, ``build_multi``, ``model_output_width``)
and the dataset loaders' synthetic replicas.

Models are a small LeNet (two 5x5 conv + pool stages, 4 and 6 channels,
on 12x12x1) and a small two-output ``Graph``, f32 on the CPU, the
reference's params carried across with ``params_from_numpy``; neither
draws random numbers in training, so the two packages' fits are the same
arithmetic. Tolerances: losses, outputs and params 1e-5 relative and
absolute (f32 reordering; measured gaps ~1e-7); the loaders' arrays bit
for bit.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_torch.data import datasets as tds
from deeplearning4j_torch.data.iterators import (ArrayIterator, DataSet,
                                                  MultiDataSet)
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import GraphBuilder, NetConfig, Sequential
from deeplearning4j_torch.ops import activations as tact
from deeplearning4j_torch.ops import updaters as tupd
from deeplearning4j_torch.train import (CollectScoresListener,
                                        model_output_width, params_from_numpy)
from deeplearning4j_tpu.data import datasets as jds
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.data.iterators import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import GraphBuilder as JGraphBuilder
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import \
    model_output_width as j_model_output_width

F32_TOL = 1e-5
UPDATER = {"type": "adam", "learning_rate": 1e-2}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _lenet_layers(L):
    return [L.Conv2D(n_out=4, kernel=(5, 5), stride=(1, 1), padding="same",
                     activation="relu"),
            L.Subsampling2D(kernel=(2, 2), stride=(2, 2)),
            L.Conv2D(n_out=6, kernel=(5, 5), stride=(1, 1), padding="same",
                     activation="relu"),
            L.Subsampling2D(kernel=(2, 2), stride=(2, 2)),
            L.Flatten(),
            L.Dense(n_out=16, activation="relu"),
            L.Output(n_out=10, activation="softmax", loss="mcxent")]


def _mlp_layers(L):
    return [L.Dense(n_out=4, activation="relu"),
            L.Output(n_out=3, activation="softmax", loss="mcxent")]


def _lenet_pair():
    jm = JSequential(JNetConfig(seed=0, updater=dict(UPDATER)),
                     _lenet_layers(JL), (12, 12, 1))
    jm.init()
    tm = Sequential(NetConfig(seed=0, updater=dict(UPDATER)),
                    _lenet_layers(TL), (12, 12, 1), device="cpu")
    tm.params = params_from_numpy(tm, _np_tree(jm.params))
    tm.state = {}
    return jm, tm


def _graph(B, L, **kw):
    return (B(NetConfig(seed=0, updater=dict(UPDATER)) if B is GraphBuilder
              else JNetConfig(seed=0, updater=dict(UPDATER)), **kw)
            .add_input("in", (6,))
            .add_layer("h", L.Dense(n_out=8, activation="tanh"), "in")
            .add_layer("cls", L.Output(n_out=3, activation="softmax",
                                       loss="mcxent"), "h")
            .add_layer("reg", L.Output(n_out=2, activation="identity",
                                       loss="mse"), "h")
            .set_outputs("cls", "reg").build())


def _graph_pair():
    jm = _graph(JGraphBuilder, JL)
    jm.init()
    tm = _graph(GraphBuilder, TL, device="cpu")
    tm.params = params_from_numpy(tm, _np_tree(jm.params))
    tm.state = {}
    return jm, tm


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12, 12, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _assert_params_close(t_params, j_params):
    for k, p in j_params.items():
        for name, a in p.items():
            np.testing.assert_allclose(t_params[k][name].detach().numpy(),
                                       np.asarray(a), rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=f"{k}/{name}")


# --------------------------------------------------------------- model.fit
OVERLOADS = ("iterator", "iterator_epochs", "dataset", "x_y")


def _fit_sequence(model, pkg):
    """model.fit through each overload in turn on one model, so each call
    resumes the cached trainer: (iteration, loss) pairs of each call and
    the trainer's iteration after it."""
    x, y = _images(32)
    Arr, DS, Collect = ((JArrayIterator, JDataSet, JCollectScoresListener)
                        if pkg == "jax" else
                        (ArrayIterator, DataSet, CollectScoresListener))
    out = {}
    for overload in OVERLOADS:
        c = Collect()
        if overload == "iterator":
            model.fit(Arr(x, y, batch_size=8), listeners=[c])
        elif overload == "iterator_epochs":
            model.fit(Arr(x, y, batch_size=8), 2, listeners=[c])
        elif overload == "dataset":  # one batch of the same shape as the
            model.fit(DS(x[:8], y[:8]), listeners=[c])  # iterator's
        else:
            model.fit(x[8:16], y[8:16], listeners=[c])
        out[overload] = (c.scores, model.trainer().iteration)
    return out


@pytest.fixture(scope="module")
def lenet_fits():
    jm, tm = _lenet_pair()
    return (jm, _fit_sequence(jm, "jax")), (tm, _fit_sequence(tm, "torch"))


@pytest.mark.parametrize("overload", OVERLOADS)
def test_lenet_fit_overload_matches_reference(lenet_fits, overload):
    """Each overload's losses and iteration numbers, resumed from the
    call before it on the same cached trainer, equal the reference's."""
    (_, want), (_, got) = lenet_fits
    (w_scores, w_it), (g_scores, g_it) = want[overload], got[overload]
    assert g_it == w_it
    assert [i for i, _ in g_scores] == [i for i, _ in w_scores]
    np.testing.assert_allclose([l for _, l in g_scores],
                               [l for _, l in w_scores], rtol=F32_TOL,
                               atol=F32_TOL)


def test_lenet_fit_params_and_eval_match_reference(lenet_fits):
    """After the four fits: the params, and evaluate / score_iterator /
    output_iterator, which go through the cached trainer."""
    (jm, _), (tm, _) = lenet_fits
    assert tm.trainer().iteration == 4 + 8 + 1 + 1
    _assert_params_close(tm.trainer().params, jm.trainer().params)
    _assert_params_close(tm.params, jm.params)
    x, y = _images(24, seed=3)
    np.testing.assert_allclose(
        tm.score_iterator(ArrayIterator(x, y, batch_size=8)),
        jm.score_iterator(JArrayIterator(x, y, batch_size=8)),
        rtol=F32_TOL)
    ev_t = tm.evaluate(ArrayIterator(x, y, batch_size=8))
    ev_j = jm.evaluate(JArrayIterator(x, y, batch_size=8))
    assert ev_t.accuracy() == ev_j.accuracy()
    got = tm.output_iterator(ArrayIterator(x, y, batch_size=8))
    want = jm.output_iterator(JArrayIterator(x, y, batch_size=8))
    assert got.shape == want.shape == (24, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_fit_x_y_needs_two_arrays():
    _, tm = _lenet_pair()
    with pytest.raises(TypeError, match="two arrays"):
        tm.fit([1, 2], [3, 4])


def test_trainer_cache_and_rebuild_warning():
    """No kwargs returns the cached trainer; other kwargs rebuild it, with
    a warning once it has trained unless reset=True; the same kwargs
    reuse it; reset=True alone rebuilds with the cached kwargs. The
    reference behaves the same."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            m, DS = JSequential(JNetConfig(seed=0), _mlp_layers(JL),
                                (5,)), JDataSet
        else:
            m, DS = Sequential(NetConfig(seed=0), _mlp_layers(TL), (5,),
                               device="cpu"), DataSet
        m.init()
        t0 = m.trainer()
        assert m.trainer() is t0
        assert m.trainer(seed=0) is t0  # the same kwargs as the cached
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t1 = m.trainer(grad_accum=2)  # untrained: no warning
        assert t1 is not t0
        m.fit(DS(x, y))
        assert m.trainer().iteration == 1
        with pytest.warns(UserWarning, match="discards the existing trainer"):
            t2 = m.trainer(grad_accum=1)
        assert t2 is not t1 and t2.iteration == 0
        m.fit(DS(x, y))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t3 = m.trainer(reset=True)
        assert t3 is not t2 and t3.iteration == 0
        assert m._trainer_kw == {"grad_accum": 1, "seed": 0}, pkg


# -------------------------------------------------------------- the Graph
@pytest.fixture(scope="module")
def graph_fits():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((12, 6)).astype(np.float32)
    yc = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    yr = rng.standard_normal((12, 2)).astype(np.float32)
    out = []
    for pkg, (m, MDS, Collect) in zip(
            ("jax", "torch"),
            zip(_graph_pair(), (JMultiDataSet, MultiDataSet),
                (JCollectScoresListener, CollectScoresListener))):
        batches = [MDS([x[i:i + 4]], [yc[i:i + 4], yr[i:i + 4]])
                   for i in range(0, 12, 4)]
        c = Collect()
        m.fit(batches, epochs=2, listeners=[c], prefetch=False)
        out.append((m, c.scores, x))
    return out


def test_graph_fit_matches_reference(graph_fits):
    (jm, want, _), (tm, got, _) = graph_fits
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(6))
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=F32_TOL, atol=F32_TOL)
    _assert_params_close(tm.params, jm.params)


def test_graph_output_iterator_returns_all_outputs(graph_fits):
    (jm, _, x), (tm, _, _) = graph_fits
    y = np.zeros((12, 3), np.float32)
    got = tm.output_iterator(ArrayIterator(x, y, batch_size=5))
    want = jm.output_iterator(JArrayIterator(x, y, batch_size=5))
    assert isinstance(got, list) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_output_iterator_without_a_trainer_uses_the_model():
    jm, tm = _lenet_pair()
    x, y = _images(6, seed=5)
    got = tm.output_iterator(ArrayIterator(x, y, batch_size=4))
    want = jm.output_iterator(JArrayIterator(x, y, batch_size=4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    assert tm._trainer is None
    assert tm.output_iterator(ArrayIterator(x[:0], y[:0])) == []


def test_sequential_activations_match_reference():
    jm, tm = _lenet_pair()
    x, _ = _images(3, seed=9)
    want = jm.activations(jm.params, jm.state, jnp.asarray(x),
                          training=False)
    got = tm.activations(tm.params, tm.state, torch.from_numpy(x),
                         training=False)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------ small functions
@pytest.mark.parametrize("axis", [-1, 0])
def test_softmax_stable_matches_reference(axis):
    x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    x[0, 0] = 80.0  # overflows exp() unless shifted
    got = tact.softmax_stable(torch.from_numpy(x), axis=axis).numpy()
    want = np.asarray(jact.softmax_stable(jnp.asarray(x), axis=axis))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=1e-7)
    assert np.isfinite(got).all()


def test_build_multi_matches_optax_multi_transform():
    """Three leaves labelled a, b, a by a label function: sgd on a, adam
    on b, three updates from the same gradients."""
    rng = np.random.default_rng(2)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32)
              for p in params] for _ in range(3)]
    labels = lambda leaves: ["a", "b", "a"]  # noqa: E731
    jtx = jupd.build_multi(labels, {"a": optax.sgd(0.1),
                                    "b": optax.adam(1e-2)})
    ttx = tupd.build_multi(labels, {"a": tupd.sgd(0.1),
                                    "b": tupd.adam(1e-2)})
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update([jnp.asarray(a) for a in g], js, jp)
        tu, ts = ttx.update([torch.from_numpy(a) for a in g], ts, tp)
        jp = optax.apply_updates(jp, ju)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=F32_TOL, atol=1e-7)
    assert sorted(ts) == ["a", "b"]


def test_build_multi_takes_a_label_sequence():
    tx = tupd.build_multi(["a", "b"], {"a": tupd.sgd(1.0),
                                       "b": tupd.set_to_zero()})
    p = [torch.ones(2), torch.ones(3)]
    u, _ = tx.update([torch.ones(2), torch.ones(3)], tx.init(p), p)
    assert torch.equal(u[0], -torch.ones(2))
    assert u[1] is None  # set_to_zero's "add nothing"


def test_model_output_width_matches_reference():
    jm, tm = _lenet_pair()
    assert model_output_width(tm) == j_model_output_width(jm) == 10
    jg, tg = _graph(JGraphBuilder, JL), _graph(GraphBuilder, TL,
                                                device="cpu")
    assert model_output_width(tg) == j_model_output_width(jg) == 3


# -------------------------------------------------------------- datasets
LOADERS = {
    "load_mnist": dict(train=True, num_examples=64),
    "load_mnist_test": dict(train=False),
    "load_iris": dict(),
    "load_cifar10": dict(train=True, num_examples=32),
    "load_emnist": dict(split="letters", train=True, num_examples=16),
    "load_svhn": dict(train=False, num_examples=16),
    "load_tiny_imagenet": dict(train=True, num_examples=8),
    "load_lfw": dict(num_examples=8, image_size=32),
    "load_uci_synthetic_control": dict(train=False),
}


@pytest.fixture
def empty_data_dir(tmp_path, monkeypatch):
    """Both packages pointed at an empty data directory."""
    for mod in (tds, jds):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path)
    monkeypatch.delenv("DL4J_TPU_STRICT_DATA", raising=False)
    return tmp_path


def _call(mod, name):
    fn = getattr(mod, name.replace("_test", ""))
    return fn(**LOADERS[name])


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_replica_equals_reference(empty_data_dir, name):
    got, want = _call(tds, name), _call(jds, name)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["load_mnist", "load_cifar10", "load_emnist",
                                  "load_svhn", "load_tiny_imagenet",
                                  "load_lfw"])
def test_strict_data_raises(empty_data_dir, monkeypatch, name):
    monkeypatch.setenv("DL4J_TPU_STRICT_DATA", "1")
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError, match="SYNTHETIC"):
            _call(mod, name)


def test_fallback_is_recorded(empty_data_dir):
    tds.synthetic_fallbacks.discard("svhn")
    tds.load_svhn(num_examples=2)
    assert "svhn" in tds.synthetic_fallbacks


def test_mnist_iterator_equals_reference(empty_data_dir):
    got = list(tds.mnist_iterator(batch_size=16, num_examples=40, seed=3))
    want = list(jds.mnist_iterator(batch_size=16, num_examples=40, seed=3))
    assert [d.num_examples for d in got] == [d.num_examples for d in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.features),
                                      np.asarray(w.features))
        np.testing.assert_array_equal(np.asarray(g.labels),
                                      np.asarray(w.labels))


def test_mnist_reads_local_idx_files(empty_data_dir):
    """Real IDX files under the data directory win over the replica, read
    the same way by both packages."""
    import struct

    d = empty_data_dir / "mnist"
    d.mkdir()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labs = rng.integers(0, 10, 5, dtype=np.uint8)
    (d / "t10k-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    (d / "t10k-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 0x801, 5) + labs.tobytes())
    got, want = tds.load_mnist(train=False), jds.load_mnist(train=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1].argmax(1), labs)


def test_port_and_chip_smoke_import_no_jax():
    """No module of deeplearning4j_torch/ and not chip_smoke.py imports
    jax, jaxlib, optax or anything of deeplearning4j_tpu (a walk over every
    import statement, lazy ones inside functions included)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    paths = sorted((root / "deeplearning4j_torch").rglob("*.py"))
    paths.append(root / "chip_smoke.py")
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "optax", "deeplearning4j_tpu"), \
                    f"{path.relative_to(root)} imports {n}"
