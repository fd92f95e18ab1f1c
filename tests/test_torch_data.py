"""The port's data side held against the JAX package: the normalizers
(``deeplearning4j_torch/data/normalizers.py``) and ``normalizer.json`` in
the model zip, ``MultiDataSet`` on a two-input Graph, and the iterators
``EarlyTerminationIterator``, ``MultipleEpochsIterator``,
``export_batches``/``FileDataSetIterator`` and ``split_iterator``.

Held: ``transform`` and ``revert`` exactly equal (numpy in, and tensors
in), ``to_dict`` JSON identical, a zip with a normalizer saved by either
package loading in the other; a two-input, two-output Graph's 5-step
``MultiDataSet`` trajectory within 1e-4 (losses relative, params relative
to each leaf's largest entry); the iterators yield the same batches.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import (ArrayIterator, DataSet,
                                       EarlyTerminationIterator,
                                       FileDataSetIterator, MultiDataSet,
                                       MultipleEpochsIterator,
                                       export_batches, split_iterator)
from deeplearning4j_torch.data import normalizers as TN
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn import vertices as TV
from deeplearning4j_torch.nn.model import GraphBuilder, NetConfig
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        load_model, load_normalizer,
                                        params_from_numpy, save_model)
from deeplearning4j_torch.train.trainer import unpack_batch
from deeplearning4j_tpu.data import iterators as JI
from deeplearning4j_tpu.data import normalizers as JN
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import vertices as JV
from deeplearning4j_tpu.nn.model import GraphBuilder as JGraphBuilder
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.train import serialization as JS
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

TRAJ_TOL = 1e-4


def _images(seed, shape=(4, 6, 6, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _features(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((40, 5)) * [1, 3, 0.1, 10, 1]
            + [0, 2, -1, 5, 0]).astype(np.float32)


NORMALIZERS = {
    "standardize": (lambda M: M.Standardize(), _features),
    "minmax": (lambda M: M.MinMaxScaler(lo=-1.0, hi=2.0), _features),
    "image_scaler": (lambda M: M.ImageScaler(), _images),
    "image_scaler_pm1": (lambda M: M.ImageScaler(lo=-1.0, hi=1.0), _images),
    "vgg16": (lambda M: M.VGG16Preprocessor(), _images),
}


def _pair(name):
    make, data = NORMALIZERS[name]
    x = data(0)
    j, t = make(JN), make(TN)
    j.fit(x)
    t.fit(torch.from_numpy(x))
    return j, t, x


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_transform_and_revert_exact(name):
    j, t, x = _pair(name)
    want = j.transform(x)
    for got in (t.transform(x), t.transform(torch.from_numpy(x)).numpy()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    back = j.revert(want)
    for got in (t.revert(want), t.revert(torch.from_numpy(want)).numpy()):
        np.testing.assert_array_equal(got, back)


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_json_identical(name):
    j, t, _ = _pair(name)
    assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
    back = TN.Normalizer.from_dict(json.loads(json.dumps(j.to_dict())))
    assert json.dumps(back.to_dict()) == json.dumps(j.to_dict())


def _mlp_pair():
    from deeplearning4j_torch.nn.model import Sequential
    from deeplearning4j_tpu.nn.model import Sequential as JSequential
    j = JSequential(JNetConfig(seed=0), [JL.Dense(n_out=3),
                                         JL.Output(n_out=2)], (5,))
    jp, _ = j.init()
    t = Sequential(NetConfig(seed=0), [TL.Dense(n_out=3), TL.Output(n_out=2)],
                   (5,), device="cpu")
    t.params = params_from_numpy(t, jax.tree.map(np.asarray, jp))
    return j, jp, t


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_zip_with_normalizer_loads_both_ways(name, tmp_path):
    jn, tn, x = _pair(name)
    j, jp, t = _mlp_pair()
    path = str(tmp_path / "port.zip")
    save_model(path, t, normalizer=tn)
    _, _, _, _, got = JS.load_model(path)
    np.testing.assert_array_equal(got.transform(x), jn.transform(x))
    path = str(tmp_path / "ref.zip")
    JS.save_model(path, j, params=jp, normalizer=jn)
    got = load_normalizer(path)
    np.testing.assert_array_equal(got.transform(x), jn.transform(x))
    model, _, _ = load_model(path, device="cpu")
    assert load_normalizer(str(tmp_path / "port.zip")).to_dict() == \
        tn.to_dict()


def test_zip_without_normalizer(tmp_path):
    _, _, t = _mlp_pair()
    path = str(tmp_path / "plain.zip")
    save_model(path, t)
    assert load_normalizer(path) is None


def _two_in(L, V, GB, NC, **kw):
    g = GB(NC(seed=0, updater={"type": "adam", "learning_rate": 1e-2}),
           **kw)
    g.add_input("a", (4,)).add_input("b", (3,))
    g.add_layer("da", L.Dense(n_out=6, activation="tanh"), "a")
    g.add_layer("db", L.Dense(n_out=5, activation="tanh"), "b")
    g.add_vertex("m", V.Merge(), "da", "db")
    g.add_layer("h", L.Dense(n_out=8, activation="relu"), "m")
    g.add_layer("cls", L.Output(n_out=3, activation="softmax"), "h")
    g.add_layer("reg", L.Output(n_out=2, activation="identity", loss="mse"),
                "h")
    return g.set_outputs("cls", "reg").build()


def _multi_batches(pkg, n=5):
    rng = np.random.default_rng(7)
    MD = JI.MultiDataSet if pkg == "jax" else MultiDataSet
    out = []
    for _ in range(n):
        a = rng.standard_normal((8, 4)).astype(np.float32)
        b = rng.standard_normal((8, 3)).astype(np.float32)
        c = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        r = rng.standard_normal((8, 2)).astype(np.float32)
        lm = (rng.random(8) < 0.75).astype(np.float32)
        out.append(MD([a, b], [c, r], labels_masks=[None, lm]))
    return out


def test_multidataset_fit_matches_reference():
    jm = _two_in(JL, JV, JGraphBuilder, JNetConfig)
    jp, _ = jm.init()
    tm = _two_in(TL, TV, GraphBuilder, NetConfig, device="cpu")
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jp))
    tm.state = {}
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    jt = JTrainer(jm).fit(_multi_batches("jax"), listeners=[jrec],
                          prefetch=False)
    tt = Trainer(tm).fit(_multi_batches("torch"), listeners=[trec],
                         prefetch=False, steps_per_execution=2)
    jl, tl = [l for _, l in jrec.scores], [l for _, l in trec.scores]
    assert len(tl) == 5
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL)
    for a, b in zip(tree_leaves(tt.params), jax.tree_util.tree_leaves(
            jt.params)):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= \
            TRAJ_TOL * np.abs(b).max()
    # evaluate and score on MultiDataSet batches: the first output
    ev = tt.evaluate(_multi_batches("torch", 2))
    jev = jt.evaluate(_multi_batches("jax", 2))
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    np.testing.assert_allclose(tt.score_iterator(_multi_batches("torch", 2)),
                               jt.score_iterator(_multi_batches("jax", 2)),
                               rtol=1e-5)


def test_unpack_batch_checks_counts():
    tm = _two_in(TL, TV, GraphBuilder, NetConfig, device="cpu")
    x = np.zeros((2, 4), np.float32)
    with pytest.raises(ValueError, match="feature arrays"):
        unpack_batch(tm, MultiDataSet([x], [x, x]))
    with pytest.raises(ValueError, match="label arrays"):
        unpack_batch(tm, MultiDataSet([x, x], [x]))
    from deeplearning4j_torch.nn.model import Sequential
    seq = Sequential(NetConfig(), [TL.Output(n_out=2)], (4,), device="cpu")
    with pytest.raises(TypeError, match="Graph"):
        unpack_batch(seq, MultiDataSet([x], [x]))


def _batches(it):
    return [(np.asarray(d.features), np.asarray(d.labels)) for d in it]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.fixture
def arrays():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((37, 3)).astype(np.float32),
            rng.standard_normal((37, 2)).astype(np.float32))


def test_early_termination_and_multiple_epochs(arrays):
    x, y = arrays
    for n in (0, 2, 10):
        _same_batches(_batches(EarlyTerminationIterator(
            ArrayIterator(x, y, 8), n)),
            _batches(JI.EarlyTerminationIterator(JI.ArrayIterator(x, y, 8),
                                                 n)))
    _same_batches(
        _batches(MultipleEpochsIterator(ArrayIterator(x, y, 8, shuffle=True,
                                                      seed=3), 3)),
        _batches(JI.MultipleEpochsIterator(JI.ArrayIterator(
            x, y, 8, shuffle=True, seed=3), 3)))


def test_export_and_file_iterator(arrays, tmp_path):
    x, y = arrays
    m = (np.arange(37) % 3 > 0).astype(np.float32)
    n = export_batches(ArrayIterator(x, y, 8, labels_mask=m), str(tmp_path),
                       "train")
    assert n == 5
    # the reference reads the port's export, and the port the reference's
    for shard in (None, (1, 2)):
        for shuffle in (False, True):
            _same_batches(
                _batches(FileDataSetIterator(str(tmp_path), "train",
                                             shuffle=shuffle, seed=1,
                                             shard=shard)),
                _batches(JI.FileDataSetIterator(str(tmp_path), "train",
                                                shuffle=shuffle, seed=1,
                                                shard=shard)))
    JI.export_batches(JI.ArrayIterator(x[:16], y[:16], 8), str(tmp_path),
                      "ref")
    got = list(FileDataSetIterator(str(tmp_path), "ref"))
    assert len(got) == 2 and got[0].labels_mask is None
    assert len(list(FileDataSetIterator(str(tmp_path), "train"))) == 5
    with pytest.raises(ValueError, match="no exported batches"):
        FileDataSetIterator(str(tmp_path), "nothing")


def test_export_reads_tensors(tmp_path):
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    export_batches([DataSet(x, x[:, :2])], str(tmp_path))
    (ds,) = list(FileDataSetIterator(str(tmp_path)))
    np.testing.assert_array_equal(ds.features, x.numpy())


@pytest.mark.parametrize("shuffle", [False, True])
def test_split_iterator(arrays, shuffle):
    x, y = arrays
    tr, te = split_iterator(x, y, 0.7, batch_size=8, seed=4, shuffle=shuffle)
    jtr, jte = JI.split_iterator(x, y, 0.7, batch_size=8, seed=4,
                                 shuffle=shuffle)
    for _ in range(2):  # two epochs: the shuffle stream too
        _same_batches(_batches(tr), _batches(jtr))
    _same_batches(_batches(te), _batches(jte))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [transfer] phase "
                    "normalizes on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_on_card_exact(cuda, name):
    j, t, x = _pair(name)
    got = t.transform(torch.from_numpy(x).to(cuda))
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), j.transform(x))
