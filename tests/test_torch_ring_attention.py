"""The port's ring attention (``parallel/ring_attention.py``) held
against the JAX package's ``ring_attention`` and ``reference_attention``:
values and gradients, causal and not, with key chunks, and with the
dp x sp and tp x sp compositions; and the ring's schedule over n blocks
in one process (``ring_attention_blocks``, the form the card's check
drives) against ``flash_attention`` over the whole sequence.

The port's ring runs in 4 spawned gloo ranks (one ``RankGroup`` for the
file; the ring cases in ``torch_sharding_ranks.py``, no JAX there); a
mesh of a 2-rank ring puts the other factor on the data axis (each data
slice runs its own ring). The JAX side runs over its forced host devices.
Tolerances are the reference tests' (``tests/test_parallel.py``): values
rtol 2e-4 / atol 2e-5 against dense, gradients rtol 1e-3 / atol 1e-4;
port against the reference's ring, values (every case) and gradients
(the causal 4-ring and the key-chunked case) within 1e-4 / 1e-5; in one
process the plain f32 ring against the plain flash within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_ranks as R
from deeplearning4j_torch.ops.flash_attention import flash_attention
from deeplearning4j_torch.parallel import (RankGroup, ring_attention_blocks,
                                           ring_step)
from deeplearning4j_tpu.parallel import make_mesh as jmake
from deeplearning4j_tpu.parallel.ring_attention import (reference_attention,
                                                        ring_attention)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("g4")))
    yield g
    g.close()


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_ring(q, k, v, cot, axes, causal, k_chunk, batch_axis=None,
              head_axis=None, grads=True):
    """The reference's ring (jitted: its eager shard_map takes 20 s a
    gradient): the output and, with ``grads``, the gradients of
    sum(o * cot)."""
    n = int(np.prod(list(axes.values())))
    mesh = jmake(dict(axes), jax.devices()[:n])

    def f(q, k, v):
        o = ring_attention(q, k, v, mesh, causal=causal, k_chunk=k_chunk,
                           batch_axis=batch_axis, head_axis=head_axis)
        return jnp.sum(o * cot), o

    if not grads:
        return np.asarray(jax.jit(f)(q, k, v)[1]), None
    (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(a) for a in g]


def _dense(q, k, v, cot, causal):
    def f(q, k, v):
        o = reference_attention(q, k, v, causal=causal)
        return jnp.sum(o * cot), o

    (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        q, k, v)
    return np.asarray(o), [np.asarray(a) for a in g]


CASES = [  # (axes, ring size, k_chunk, batch_axis, head_axis, H, causal,
    #          the reference ring's gradients too)
    ({"seq": 4}, 4, 1024, None, None, 2, True, True),
    ({"seq": 4}, 4, 1024, None, None, 2, False, False),
    ({"data": 2, "seq": 2}, 2, 5, None, None, 2, True, True),  # 5-wide cuts
    ({"data": 2, "seq": 2}, 2, 1024, "data", None, 2, False, False),  # dp sp
    ({"model": 2, "seq": 2}, 2, 1024, None, "model", 4, True, False),  # tp sp
]


@pytest.mark.parametrize(
    "axes,n,k_chunk,batch_axis,head_axis,H,causal,ring_grads", CASES,
    ids=["seq4-causal", "seq4-full", "seq2-chunk5-causal", "dp-sp-full",
         "tp-sp-causal"])
def test_ring_matches_reference(ranks, axes, n, k_chunk, batch_axis,
                                head_axis, H, causal, ring_grads):
    """The port's ring in ranks == the reference's ring on the same mesh
    (its output; its gradients where ``ring_grads``: a jitted reference
    gradient costs seconds a case) and == dense attention, output and the
    gradients of sum(o * cot)."""
    T = 24 if k_chunk < 1024 else 16
    q, k, v, cot = _qkv(n + H + k_chunk, (2, T, H, 8))
    got = ranks.run(R.ring, q, k, v, cot, axes, causal, k_chunk, batch_axis,
                    head_axis)
    jo, jg = _jax_ring(q, k, v, cot, axes, causal, k_chunk, batch_axis,
                       head_axis, grads=ring_grads)
    do, dg = _dense(q, k, v, cot, causal)
    np.testing.assert_allclose(got["o"], jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["o"], do, rtol=2e-4, atol=2e-5)
    for i, name in enumerate(("dq", "dk", "dv")):
        if jg is not None:
            np.testing.assert_allclose(got[name], jg[i], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[name], dg[i], rtol=1e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("k_chunk", [1024, 4])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_blocks_match_flash(n, k_chunk, causal):
    """The ring's schedule over n blocks in one process == flash attention
    over the whole sequence (the plain versions on the CPU), values and
    gradients; and == the reference's dense attention."""
    q, k, v, cot = _qkv(7 * n + k_chunk, (2, 16, 2, 8))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ring_attention_blocks(tq, tk, tv, n, causal=causal, k_chunk=k_chunk)
    (o * torch.as_tensor(cot)).sum().backward()
    fq, fk, fv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    f = flash_attention(fq, fk, fv, causal=causal)
    (f * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), f.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in ((tq, fq), (tk, fk), (tv, fv)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
    do, dg = _dense(q, k, v, cot, causal)
    np.testing.assert_allclose(o.detach().numpy(), do, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tq.grad.numpy(), dg[0], rtol=1e-3, atol=1e-4)


def test_ring_step_skips_later_blocks_under_causal():
    """A later block under causal launches nothing and leaves the state
    as it was; an earlier one merges."""
    q, k, v, _ = (torch.as_tensor(a) for a in _qkv(0, (4, 8, 8)))
    state = ring_step(q, k, v, 1, 1, (None, None), causal=True, scale=0.3)
    same = ring_step(q, k, v, 1, 2, state, causal=True, scale=0.3)
    assert same is state
    merged = ring_step(q, k, v, 1, 0, state, causal=True, scale=0.3)
    assert not torch.equal(merged[0], state[0])
    assert torch.all(merged[1] > state[1])
