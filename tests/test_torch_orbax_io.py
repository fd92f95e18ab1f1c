"""The port's sharded trainer checkpoint (``deeplearning4j_torch/train/
orbax_io.py``), case for case with the reference's ``tests/test_orbax.py``.

The two packages write different directory formats (the card's machine
has no orbax), so the port is held to exact round trips of its own and
its trainers to the JAX package's: single-device ``Trainer`` here; the
ZeRO-1 wrapper, the encoded wrapper's residual, ``MultiHostTrainer`` and
``Trainer(mesh=, rules=)`` in spawned gloo ranks (``RankGroup``, cases in
``torch_orbax_ranks.py``) beside the reference over ``cpu_test_mesh``.
Params after training within ``RTOL, ATOL = 1e-4, 1e-5`` of the
reference's; restores and continuations bit-equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_orbax_ranks as R
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.parallel import RankGroup, zero_shard_dim
from deeplearning4j_torch.train import (Trainer, orbax_io, params_from_numpy,
                                        model_from_json)
from deeplearning4j_tpu.data import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import NetConfig, SequentialBuilder
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import cpu_test_mesh
from deeplearning4j_tpu.train import Trainer as JTrainer
from torch_parallel_ranks import Batches

RTOL, ATOL = 1e-4, 1e-5


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


def _net():
    return (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "adam", "learning_rate": 1e-2}))
            .input_shape(4)
            .layer(L.Dense(n_out=16, activation="relu"))
            .layer(L.Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())


@pytest.fixture(scope="module")
def start():
    m = _net()
    m.init()
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 64)]
    return m.to_json(), jax.tree.map(np.asarray, m.params), x, y


def pmodel(start):
    m = model_from_json(start[0], device="cpu")
    m.params = params_from_numpy(m, start[1])
    m.state = {}
    return m


def batches(start, bs=32):
    x, y = start[2], start[3]
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x), bs)]


def jfit(start, epochs, trainer=None):
    """The reference's run over the same batches (no shuffle)."""
    m = _net()
    m.init()
    m.params = jax.tree.map(jax.numpy.asarray, start[1])
    t = trainer(m) if trainer is not None else JTrainer(m)
    t.fit(JArrayIterator(start[2], start[3], 32, shuffle=False),
          epochs=epochs)
    return t


def close(got, want):
    for k in want:
        for pk in want[k]:
            g = got[k][pk]
            g = g.detach().numpy() if torch.is_tensor(g) else g
            np.testing.assert_allclose(g, np.asarray(want[k][pk]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k}/{pk}")


def equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_trainer_roundtrip_exact_continuation(start, tmp_path):
    d = str(tmp_path / "ck")
    tr = Trainer(pmodel(start))
    tr.fit(Batches(batches(start)), epochs=5)
    orbax_io.save_trainer(d, tr)
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f)["iteration"] == 10
    tr2 = Trainer(orbax_io.load_model_json(d, device="cpu"), seed=3)
    orbax_io.restore_trainer(d, tr2)
    assert tr2.iteration == 10
    equal(tr.params, tr2.params)
    equal(tr.opt_state, tr2.opt_state)
    assert torch.equal(tr._gen.get_state(), tr2._gen.get_state())
    tr.fit(Batches(batches(start)), epochs=3)
    tr2.fit(Batches(batches(start)), epochs=3)
    equal(tr.params, tr2.params)
    close(tr2.params, jfit(start, 8).params)


def test_sharded_optimizer_state_restores_sharded(ranks, start, tmp_path):
    """zero_sharded at world 2: each rank restores its own block of every
    updater leaf (no whole leaf on a rank), and the restored wrapper
    continues bit-equal to the saved one, both within tolerance of the
    reference's zero_sharded run."""
    got = ranks(2).run(R.wrapper_resume, start[0], start[1],
                       batches(start), str(tmp_path / "ck"), "zero_sharded",
                       3, 2)
    assert got["restored"] and got["continued"]
    # adam's mu and nu: each rank's half of every param ZeRO-1 splits
    halves = []
    for p in got["param_shapes"]:
        d = zero_shard_dim(p, 2)
        halves.append(p if d is None else
                      tuple(s // 2 if i == d else s for i, s in enumerate(p)))
    assert got["opt_shapes"][1:1 + 2 * len(halves)] == halves * 2
    assert halves != got["param_shapes"]
    want = jfit(start, 5, lambda m: JPW(m, mesh=cpu_test_mesh(2),
                                        mode="zero_sharded"))
    close(got["params"], want.model.params)


def test_restore_redistributes_across_widths(ranks, start, tmp_path):
    """A checkpoint written by zero_sharded at world 4 restores at world 2
    (each rank's block of every updater leaf) and into one device's
    Trainer (whole leaves): the same bytes either way."""
    d = str(tmp_path / "ck")
    saved = ranks(4).run(R.zero_save, start[0], start[1], batches(start), d,
                         3)
    two = ranks(2).run_all(R.zero_restore, start[0], start[1], d)
    tr = Trainer(pmodel(start))
    orbax_io.restore_trainer(d, tr)
    assert tr.iteration == 6
    whole_opt = [t.numpy() for t in tree_leaves(tr.opt_state)]
    for k in saved:
        for pk in saved[k]:
            np.testing.assert_array_equal(tr.params[k][pk].detach().numpy(),
                                          saved[k][pk])
    n = len(two[0]["dims"])
    for r, got in enumerate(two):
        assert got["iteration"] == 6
        np.testing.assert_array_equal(got["opt"][0], whole_opt[0])  # count
        for j, (mine, whole) in enumerate(zip(got["opt"][1:1 + 2 * n],
                                              whole_opt[1:1 + 2 * n])):
            dim = got["dims"][j % n]  # mu's leaves, then nu's
            if dim is not None:
                s = whole.shape[dim] // 2
                whole = np.take(whole, range(r * s, (r + 1) * s), axis=dim)
            np.testing.assert_array_equal(mine, whole)


def test_model_only_checkpoint_restores_into_trainer(start, tmp_path):
    """save_checkpoint without updater state restores through
    restore_trainer (the fresh updater state kept) and points the model at
    the restored params."""
    d = str(tmp_path / "ck")
    tr = Trainer(pmodel(start))
    tr.fit(Batches(batches(start)), epochs=3)
    orbax_io.save_checkpoint(d, tr.model, params=tr.params, state=tr.state)
    tr2 = Trainer(orbax_io.load_model_json(d, device="cpu"))
    fresh = [t.clone() for t in tree_leaves(tr2.opt_state)]
    orbax_io.restore_trainer(d, tr2)
    equal(tr.params, tr2.params)
    for a, b in zip(fresh, tree_leaves(tr2.opt_state)):
        assert torch.equal(a, b)
    x = torch.from_numpy(start[2][:4])
    assert torch.equal(tr2.model.output(x), tr.model.output(x))
    back = orbax_io.restore_checkpoint(d, {"params": tr.params,
                                           "net_state": tr.state,
                                           "opt_state": tr.opt_state})
    equal(back["params"], tr.params)
    assert back["opt_state"] == {}
    with pytest.raises(FileExistsError):
        orbax_io.save_checkpoint(d, tr.model)


def test_multihost_restore_of_a_directory(ranks, start, tmp_path):
    """MultiHostTrainer.restore of a save_trainer directory continues
    exactly: the resumed run ends bit-equal to an unbroken one."""
    got = ranks(2).run(R.multihost_dir_resume, start[0], start[1], start[2],
                       start[3], 32, str(tmp_path / "ck"))
    assert got["equal"] and got["iteration"] == 4
    close(got["params"], jfit(start, 4).params)


def test_encoded_residual_roundtrip(ranks, start, tmp_path):
    """The encoded mode's residual (each rank's own row) comes back with the
    params and updater state, so the restored wrapper continues exactly."""
    got = ranks(2).run(R.wrapper_resume, start[0], start[1], batches(start),
                       str(tmp_path / "ck"), "encoded_gradients", 2, 2)
    assert got["restored"] and got["continued"]


def test_rules_trainer_roundtrip(ranks, start, tmp_path):
    """Trainer(mesh={data 2, model 2}, rules=DENSE_RULES): every rank
    restores its own shards and continues bit-equal."""
    got = ranks(4).run(R.rules_resume, start[0], start[1], batches(start, 8),
                       str(tmp_path / "ck"), {"data": 2, "model": 2},
                       "DENSE_RULES")
    assert got["restored"] and got["continued"]
    assert got["shapes"][:2] == [(8,), (4, 8)]  # layer_0 b, w: halves
