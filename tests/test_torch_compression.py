"""The port's gradient codec (``deeplearning4j_torch/parallel/compression.py``)
held against the JAX package's, function by function, on fixed numpy
inputs.

Tolerances: exact. The residual, the decoded update, the signs or values
and ``count`` equal the reference's bit for bit. A message's slot order
is not compared as it stands (``lax.top_k`` sorts slots by magnitude;
the port takes ``torch.topk``'s unsorted order, and index order at full
capacity): each message is compared sorted by index. The inputs are drawn
so that no two entries tie in magnitude at the capacity's edge, where
the two libraries may pick different entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.parallel import compression as TC
from deeplearning4j_tpu.parallel import compression as JC


def _draw(seed, n, zeros=0):
    """A gradient and a residual, f32, with distinct magnitudes (``zeros``
    exact zeros in the gradient, which tie only below any threshold)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32) * 1e-2
    g[rng.choice(n, zeros, replace=False)] = 0.0
    r = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    mag = np.abs(g + r)
    nz = mag[mag > 0]
    assert len(np.unique(nz)) == len(nz), "tie in the drawn magnitudes"
    return g, r


def _by_index(idx, *cols):
    order = np.argsort(np.asarray(idx), kind="stable")
    return [np.asarray(idx)[order]] + [np.asarray(c)[order] for c in cols]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


CASES = [  # (seed, n, threshold, capacity, zeros)
    (0, 64, 5e-3, 16, 0),
    (1, 257, 1e-2, 40, 10),
    (2, 100, 0.0, 100, 0),       # full capacity, everything sent
    (3, 1000, 2e-2, 50, 100),    # fewer over the threshold than capacity
    (4, 33, 1e-4, 1, 0),
]


@pytest.mark.parametrize("seed,n,t,k,zeros", CASES)
def test_threshold_encode_decode(seed, n, t, k, zeros):
    g, r = _draw(seed, n, zeros)
    je, jres = JC.threshold_encode(jnp.asarray(g), t, k, jnp.asarray(r))
    te, tres = TC.threshold_encode(_t(g), t, k, _t(r))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    assert int(te.count) == int(je.count)
    assert te.indices.dtype == torch.int32 and te.signs.dtype == torch.int8
    ji, js = _by_index(je.indices, je.signs)
    ti, ts = _by_index(te.indices.numpy(), te.signs.numpy())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert float(te.threshold) == float(je.threshold)
    jd = JC.threshold_decode(je, size=n)
    td = TC.threshold_decode(te, size=n)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # decoded + residual gives back the input (Strom's telescoping)
    np.testing.assert_allclose(td.numpy() + tres.numpy(), g + r, atol=1e-7)


@pytest.mark.parametrize("seed,n,t,k,zeros", CASES)
def test_topk_encode_decode(seed, n, t, k, zeros):
    g, r = _draw(seed, n, zeros)
    je, jres = JC.topk_encode(jnp.asarray(g), t, k, jnp.asarray(r))
    te, tres = TC.topk_encode(_t(g), t, k, _t(r))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    assert int(te.count) == int(je.count)
    ji, jv = _by_index(je.indices, je.values)
    ti, tv = _by_index(te.indices.numpy(), te.values.numpy())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(TC.topk_decode(te, size=n).numpy(),
                                  np.asarray(JC.topk_decode(je, size=n)))


def test_decode_into_out_adds():
    g, r = _draw(5, 50)
    je, _ = JC.threshold_encode(jnp.asarray(g), 1e-3, 20, jnp.asarray(r))
    te, _ = TC.threshold_encode(_t(g), 1e-3, 20, _t(r))
    base = np.linspace(-1, 1, 50).astype(np.float32)
    want = JC.threshold_decode(je, out=jnp.asarray(base))
    got = TC.threshold_decode(te, out=_t(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kj, _ = JC.topk_encode(jnp.asarray(g), 0.0, 20, jnp.asarray(r))
    kt, _ = TC.topk_encode(_t(g), 0.0, 20, _t(r))
    np.testing.assert_array_equal(
        TC.topk_decode(kt, out=_t(base)).numpy(),
        np.asarray(JC.topk_decode(kj, out=jnp.asarray(base))))


@pytest.mark.parametrize("t", [0.0, 5e-3, 2e-2])
def test_bitmap_encode_decode(t):
    g, r = _draw(6, 300, zeros=20)
    jc, jres = JC.bitmap_encode(jnp.asarray(g), t, jnp.asarray(r))
    tc, tres = TC.bitmap_encode(_t(g), t, _t(r))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(TC.bitmap_decode(tc, t).numpy(),
                                  np.asarray(JC.bitmap_decode(jc, t)))


def test_residual_accumulates_like_the_reference():
    """Sub-threshold gradients transmit once the residual reaches the
    threshold (the reference's own case), step for step."""
    g = np.full(4, 0.04, np.float32)
    jr, tr = jnp.zeros(4), torch.zeros(4)
    jt, tt = jnp.zeros(4), torch.zeros(4)
    for _ in range(5):
        je, jr = JC.threshold_encode(jnp.asarray(g), 0.1, 4, jr)
        te, tr = TC.threshold_encode(_t(g), 0.1, 4, tr)
        jt = jt + JC.threshold_decode(je, size=4)
        tt = tt + TC.threshold_decode(te, size=4)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tt.numpy(), 0.1 * np.ones(4), atol=1e-6)


@pytest.mark.parametrize("n_workers", [1, 2, 4, 8, 16, 32, 100])
def test_auto_capacity_frac(n_workers):
    assert TC.auto_capacity_frac(n_workers) == JC.auto_capacity_frac(n_workers)


def test_accumulator_round_trip():
    """Two workers' updates stored and applied: the dense sum, each
    worker's residual and the pending list as the reference's."""
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(100).astype(np.float32) for _ in range(3)]
    ja = JC.EncodedGradientsAccumulator(size=100, threshold=0.01)
    ta = TC.EncodedGradientsAccumulator(size=100, threshold=0.01)
    assert ta.capacity == ja.capacity
    for w, g in [(0, grads[0]), (1, grads[1]), (0, grads[2])]:
        je = ja.store_update(w, jnp.asarray(g))
        te = ta.store_update(w, _t(g))
        assert int(te.count) == int(je.count)
    out_j, out_t = ja.apply_updates(), ta.apply_updates()
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert float(out_t.abs().sum()) > 0
    assert not ta.pending and not ja.pending
    for w in (0, 1):
        np.testing.assert_array_equal(ta.residuals[w].numpy(),
                                      np.asarray(ja.residuals[w]))


def test_capacity_out_of_range_raises():
    with pytest.raises(ValueError, match="capacity"):
        TC.threshold_encode(torch.ones(4), 0.1, 5, torch.zeros(4))
