"""The port's GPipe schedule (``parallel/pipeline.py``) held against the
JAX package's ``pipeline_apply``: pipelined == sequential, values and
gradients, at S 2 and 4 stages and M 2 and 4 microbatches, and a
pipelined train step that learns.

The port runs in 4 spawned gloo ranks (one ``RankGroup`` for the file;
the cases in ``torch_sharding_ranks.py``, no JAX there); at S 2 the
other factor of the mesh is a data axis (each data slice runs its own
pipeline). Stage params are the reference's, drawn by its block's
``init``. Tolerances are the reference tests' (``tests/test_pipeline.py``):
values rtol 2e-4 / atol 2e-5, gradients rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_sharding_ranks as R
from deeplearning4j_torch.parallel import RankGroup
from deeplearning4j_tpu.nn import layers as L
from deeplearning4j_tpu.parallel import (PIPE_AXIS, from_microbatches,
                                         make_mesh, pipeline_apply,
                                         stack_stage_params, to_microbatches)

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("g4")))
    yield g
    g.close()


def _blocks(S, d=16):
    blk = L.TransformerEncoderBlock(num_heads=2, causal=True)
    plist = [blk.init(k, (8, d))[0] for k in jax.random.split(KEY, S)]

    def stage_fn(p, h):
        return blk.apply(p, {}, h, training=False)[0]

    return plist, stage_fn


def _axes(S):
    return {"data": 4 // S, PIPE_AXIS: S}


@pytest.mark.parametrize("S,M", [(2, 2), (4, 4), (4, 2)])
def test_pipeline_matches_reference(ranks, S, M):
    """Values and gradients of sum(out ** 2): the port == the reference's
    pipeline on S devices == the stages applied in turn."""
    plist, stage_fn = _blocks(S)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(S + M), (8, 8, 16)))
    mesh = make_mesh({PIPE_AXIS: S}, jax.devices()[:S])
    stacked = stack_stage_params(plist)
    mbs = to_microbatches(jnp.asarray(x), M)

    def loss(sp, mbs):
        out = pipeline_apply(stage_fn, sp, mbs, mesh)
        return jnp.sum(jnp.square(out)), out

    (_, out), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, mbs)

    def sequential(plist, h):
        for p in plist:
            h = stage_fn(p, h)
        return h

    ref = jax.jit(sequential)(plist, jnp.asarray(x))
    got = ranks.run(R.pipe, jax.tree.map(np.asarray, plist), x, M, _axes(S))
    np.testing.assert_allclose(got["out"], np.asarray(from_microbatches(out)),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["out"], np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    for path, want in jax.tree_util.tree_leaves_with_path(g_p):
        g = got["grads"]
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-3, atol=1e-4,
                                   err_msg=str(path))
    np.testing.assert_allclose(got["dx"],
                               np.asarray(from_microbatches(g_x)),
                               rtol=1e-3, atol=1e-4)


def test_pipelined_train_step_learns(ranks):
    """Embedding -> 2 pipelined blocks -> per-token head, trained end to end
    with adam through the pipeline: the loss halves within 60 steps."""
    S, M, T, V, d = 2, 4, 8, 20, 16
    blk = L.TransformerEncoderBlock(num_heads=2, causal=True)
    emb = L.EmbeddingSequence(n_in=V, n_out=d)
    head = L.RnnOutput(n_out=V, activation="softmax", loss="mcxent")
    ks = jax.random.split(KEY, S + 2)
    params = {
        "emb": emb.init(ks[0], (T,))[0],
        "blocks": stack_stage_params([blk.init(k, (T, d))[0]
                                      for k in ks[1:S + 1]]),
        "head": head.init(ks[S + 1], (T, d))[0],
    }
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (16, T)).astype(np.int32)
    y = ((x + 1) % V).astype(np.int32)  # learnable: the successor token
    losses = ranks.run(R.pipe_learns, jax.tree.map(np.asarray, params), x, y,
                       M, _axes(S), 60, 1e-2)
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5, losses
