"""The port's t-SNE (deeplearning4j_torch/plot/tsne.py) against the JAX
package's on the CPU, and the reference's own t-SNE behaviour tests run
against the port.

Tolerances, each stated where it is used:

- start points: the raw threefry words equal bit for bit; the normal draw
  within 4 ulps of ``jax.random.normal`` (its erfinv's f32 rounding; 3 seen);
- bandwidth search and calibrated P: within 1e-6 absolute (entries up to
  0.5; both run the same 50 halvings, the sums rounding apart);
- exact step: 5 steps at the reference's defaults (lr 200, exaggeration 12)
  from the same carried state, every output within 1e-5 of its largest
  entry. A whole fit at those settings magnifies rounding about 3 times a
  step on 60 points (the layout leaps from 1e-4 to 26 in one step), so two
  correct implementations part after about 10 steps; the whole-fit checks
  run at lr 10, exaggeration 4, where the descent is smooth and the two
  agree within 1e-5 of the layout's largest coordinate after 50 steps;
- ``_knn_sparse_p``: rows and columns equal, with repeated and near
  repeated points; values within 1e-5 of the largest (each row's bandwidth
  search sees distances a rounding apart, and exp(-beta·d2) scales that by
  beta·d2);
- blocked repulsion: Z within 1e-6 relative; rep_i, the difference of
  sum_j num²·y_i and sum_j num²·y_j, within 1e-5 of the larger of those
  sums (both are sums in another order).

The Barnes-Hut whole fits run on points without copies: copies in x pull
their y points together until their y distance reaches the 1e-12 edge
below which the repulsion leaves a pair out, and there the rounding of
|a|² - 2a·b + |b|² (1e-6 at |y| of 5) decides, differently in any two
implementations, whether the pair counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_torch.plot import BarnesHutTsne, Tsne
from deeplearning4j_torch.plot import tsne as tt
from deeplearning4j_tpu.plot import tsne as jt

CALIB_ATOL = 1e-6
STEP_RTOL = 1e-5      # of each output's largest entry
FIT_RTOL = 1e-5       # of the layout's largest coordinate
KL_RTOL = 1e-5
P_RTOL = 1e-5       # of the largest value
REP_RTOL = 1e-5
Z_RTOL = 1e-6
# smooth settings for whole-fit parity (see the module docstring)
SMOOTH = dict(learning_rate=10.0, early_exaggeration=4.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one torch thread: beside other test
    workers the intra-op pool's barriers cost far more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} of scale {scale}"


def _points(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# --- start points ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 3, 12345, 2**31 - 1, -7])
@pytest.mark.parametrize("shape", [(7, 2), (1000, 3), (333, 1)])
def test_start_bits_equal_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32))
    np.testing.assert_array_equal(tt._random_bits(seed, shape), want)


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_start_points_within_ulps(seed):
    shape = (20000, 2)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = tt._normal_f32(seed, shape)
    assert got.dtype == np.float32
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 4, ulps.max()
    start = np.asarray(1e-4 * jax.random.normal(jax.random.PRNGKey(seed),
                                                shape, jnp.float32))
    ulps = np.abs(tt._start_points(seed, *shape) - start) / np.spacing(
        np.abs(start))
    assert ulps.max() <= 5, ulps.max()


# --- calibration ----------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_row_bandwidth_search(masked):
    x = _points(0, 40, 6)
    d2 = np.array(jt._pairwise_sq_dists(jnp.asarray(x)))
    target = jnp.log(jnp.float32(8.0))
    if masked:
        want = jax.vmap(lambda r, m: jt._row_bandwidth_search(r, target, m))(
            jnp.asarray(d2), jnp.eye(40, dtype=bool))
    else:
        want = jax.vmap(lambda r: jt._row_bandwidth_search(r, target))(
            jnp.asarray(d2))
    got = tt._row_bandwidth_search(torch.as_tensor(d2),
                                   tt._target_entropy(8.0, "cpu"),
                                   diagonal=masked)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CALIB_ATOL)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)
    if masked:
        assert np.all(np.diag(got.numpy()) == 0)


def test_calibrate_p():
    x = _points(1, 70, 5)
    d2 = np.array(jt._pairwise_sq_dists(jnp.asarray(x)))
    want = jt._calibrate_p(jnp.asarray(d2), jnp.log(jnp.float32(15.0)))
    got = tt._calibrate_p(torch.as_tensor(d2), tt._target_entropy(15.0, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CALIB_ATOL)


# --- exact t-SNE ------------------------------------------------------------

def _dense_p(x, perplexity):
    n = len(x)
    d2 = jt._pairwise_sq_dists(jnp.asarray(x))
    pc = jt._calibrate_p(d2, jnp.log(jnp.float32(perplexity)))
    return np.array(jnp.maximum((pc + pc.T) / (2.0 * n), 1e-12))


def test_tsne_step_five_steps_at_defaults():
    x = _points(2, 60, 8)
    p = _dense_p(x, 10.0)
    y0 = np.array(1e-4 * jax.random.normal(jax.random.PRNGKey(3), (60, 2),
                                            jnp.float32))
    js = (jnp.asarray(y0), jnp.zeros((60, 2)), jnp.ones((60, 2)))
    ts = (torch.as_tensor(y0), torch.zeros(60, 2), torch.ones(60, 2))
    pj, pt = jnp.asarray(p), torch.as_tensor(p)
    for it in range(5):
        # carry the reference's state into both, one step each
        state = [np.array(a) for a in js]
        *js, klj = jt._tsne_step(*[jnp.asarray(a) for a in state], pj,
                                 jnp.float32(0.5), jnp.float32(200.0),
                                 jnp.float32(12.0))
        *ts, klt = tt._tsne_step(*[torch.as_tensor(a) for a in state], pt,
                                 0.5, 200.0, 12.0)
        for name, a, b in zip(("y", "velocity", "gains"), ts, js):
            _close(a.numpy(), np.asarray(b), STEP_RTOL, f"step {it} {name}")
        assert abs(float(klt) - float(klj)) <= KL_RTOL * abs(float(klj))


def test_tsne_step_without_kl_is_the_same_step():
    x = _points(3, 30, 4)
    p = torch.as_tensor(_dense_p(x, 5.0))
    y = torch.as_tensor(tt._start_points(0, 30, 2))
    a = tt._tsne_step(y, torch.zeros(30, 2), torch.ones(30, 2), p, 0.5,
                      200.0, 12.0)
    b = tt._tsne_step(y, torch.zeros(30, 2), torch.ones(30, 2), p, 0.5,
                      200.0, 12.0, with_kl=False)
    assert b[3] is None and torch.isfinite(a[3])
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("seed", [3, 11])
def test_tsne_fit_whole(seed):
    x = _points(seed, 60, 8)
    kw = dict(perplexity=10.0, max_iter=50, exaggeration_iters=25,
              momentum_switch_iter=25, seed=seed, **SMOOTH)
    ref = jt.Tsne(**kw)
    want = ref.fit_transform(x)
    port = Tsne(device="cpu", **kw)
    got = port.fit_transform(x)
    assert got.dtype == np.float32 and got.shape == (60, 2)
    assert np.abs(want).max() > 1.0      # the layout really moved
    _close(got, want, FIT_RTOL, "Tsne layout")
    assert abs(port.kl_ - ref.kl_) <= KL_RTOL * abs(ref.kl_)


def test_tsne_zero_iterations_keeps_the_start():
    x = _points(4, 20, 3)
    port = Tsne(max_iter=0, seed=5, device="cpu")
    ref = jt.Tsne(max_iter=0, seed=5)
    got, want = port.fit_transform(x), ref.fit_transform(x)
    np.testing.assert_array_equal(got, tt._start_points(5, 20, 2))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 5
    assert port.kl_ == ref.kl_ == 0.0


# --- Barnes-Hut t-SNE -------------------------------------------------------

def _with_repeats(seed=0, n=200, d=6, near=1e-2):
    """Gaussian points with exact copies (three of row 10, two of row 7, a
    last row equal to the first) and two near copies of row 7, ``near``
    away in each coordinate."""
    x = _points(seed, n, d)
    x[50] = x[10]
    x[51] = x[10]
    x[120] = x[7]
    x[121] = x[7] + near
    x[122] = x[7] - near
    x[199] = x[0]
    return x


@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("perplexity", [5.0, 10.0])
def test_knn_sparse_p_coo(chunk, perplexity):
    x = _with_repeats()
    rj, cj, vj = jt._knn_sparse_p(jnp.asarray(x), perplexity, chunk=chunk)
    rt, ct, vt = tt._knn_sparse_p(torch.as_tensor(x), perplexity, chunk=chunk)
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_array_equal(ct.numpy(), cj)
    _close(vt.numpy(), vj, P_RTOL, "P values")
    keys = rt.numpy().astype(np.int64) * len(x) + ct.numpy()
    assert np.all(np.diff(keys) > 0)     # sorted by (row, col), unique
    assert vt.dtype == torch.float32


def test_knn_sparse_p_unresolvable_near_copies():
    """Copies 1e-6 apart (squared distance 6e-12) are below what f32's
    |a|² - 2a·b + |b|² resolves at |a|² of about 10 (one rounding there is
    1e-6): both packages order such a cluster by rounding noise (the
    reference's self distance comes out 0, the port's 1.9e-6). The COO
    agrees everywhere outside the cluster {7, 120, 121, 122}, and inside
    it each row of P keeps at least three of the cluster's four points in
    both (its own scan drops the first as self; symmetrizing may add that
    one back)."""
    x = _with_repeats(near=1e-6)
    rj, cj, vj = jt._knn_sparse_p(jnp.asarray(x), 5.0, chunk=64)
    rt, ct, vt = tt._knn_sparse_p(torch.as_tensor(x), 5.0, chunk=64)
    cluster = {7, 120, 121, 122}
    ref = {(r, c) for r, c in zip(rj.tolist(), cj.tolist())}
    port = {(r, c) for r, c in zip(rt.tolist(), ct.tolist())}
    outside = lambda pairs: {(r, c) for r, c in pairs
                             if r not in cluster and c not in cluster}
    assert outside(port) == outside(ref)
    for r in cluster:
        for pairs in (ref, port):
            assert len(cluster & {c for q, c in pairs if q == r}) >= 3


def test_knn_sparse_p_repeated_points_keep_self():
    """With copies, the scan's first neighbour of a later copy is the
    earlier copy (distance 0, lower index); the reference drops that one
    and keeps self, and so does the port."""
    x = _with_repeats()
    rt, ct, _ = tt._knn_sparse_p(torch.as_tensor(x), 5.0)
    pairs = set(zip(rt.tolist(), ct.tolist()))
    assert (199, 199) in pairs and (0, 0) not in pairs
    assert (51, 51) in pairs and (10, 10) not in pairs


@pytest.mark.parametrize("scale", [1e-4, 1.0, 10.0])
@pytest.mark.parametrize("block", [32, 64, 130])
def test_repulsion_blocked(scale, block):
    y = (np.random.default_rng(5).standard_normal((130, 2)) * scale).astype(
        np.float32)
    y[17] = y[3]                               # an exact copy: left out
    rj, zj = jt.BarnesHutTsne._repulsion_blocked(jnp.asarray(y), block)
    rt, zt = BarnesHutTsne._repulsion_blocked(torch.as_tensor(y), block)
    assert abs(float(zt) - float(zj)) <= Z_RTOL * float(zj)
    err = np.abs(rt.numpy() - np.asarray(rj)).max()
    assert err <= REP_RTOL * _rep_terms(y), err


def _rep_terms(y):
    """The largest of the two sums whose difference is rep_i, in f64."""
    yn = y.astype(np.float64)
    d2 = ((yn[:, None] - yn[None]) ** 2).sum(-1)
    num2 = np.where(d2 <= 1e-12, 0.0, 1.0 / (1.0 + d2)) ** 2
    return max(np.abs(num2.sum(1)[:, None] * yn).max(),
               np.abs(num2 @ yn).max())


def test_repulsion_blocked_matches_dense():
    """The reference's own test: the tiled sums equal the naive O(N²)
    computation."""
    y = np.random.default_rng(5).standard_normal((130, 2)).astype(np.float32)
    rep, z = BarnesHutTsne._repulsion_blocked(torch.as_tensor(y), 32)
    yn = y.astype(np.float64)
    diff = yn[:, None, :] - yn[None, :, :]
    num = 1.0 / (1.0 + (diff ** 2).sum(-1))
    np.fill_diagonal(num, 0.0)
    np.testing.assert_allclose(float(z), num.sum(), rtol=1e-4)
    dense = (num[:, :, None] ** 2 * diff).sum(1)
    np.testing.assert_allclose(rep.numpy(), dense, rtol=1e-3, atol=1e-4)


def _ref_attraction(y, rows, cols, vals, ex):
    """The reference's attraction closure (BarnesHutTsne.fit_transform)."""
    dy = y[rows] - y[cols]
    num = 1.0 / (1.0 + jnp.sum(dy * dy, 1))
    w = (ex * vals) * num
    return jax.ops.segment_sum(w[:, None] * dy, rows, num_segments=len(y))


def test_one_blocked_step():
    """Attraction, repulsion and update from one carried state."""
    x = _with_repeats(1)
    rj, cj, vj = jt._knn_sparse_p(jnp.asarray(x), 10.0)
    rt, ct, vt = tt._knn_sparse_p(torch.as_tensor(x), 10.0)
    rng = np.random.default_rng(2)
    y = (3 * rng.standard_normal((200, 2))).astype(np.float32)
    vel = rng.standard_normal((200, 2)).astype(np.float32)
    gains = rng.uniform(0.5, 2, (200, 2)).astype(np.float32)
    aj = _ref_attraction(jnp.asarray(y), jnp.asarray(rj), jnp.asarray(cj),
                         jnp.asarray(vj), jnp.float32(12.0))
    at = tt._attraction(torch.as_tensor(y), rt, ct, vt, 12.0)
    _close(at.numpy(), np.asarray(aj), REP_RTOL, "attraction")
    repj, zj = jt.BarnesHutTsne._repulsion_blocked(jnp.asarray(y), 64)
    want = jt.BarnesHutTsne._step_blocked_update(
        jnp.asarray(y), jnp.asarray(vel), jnp.asarray(gains), aj, repj, zj,
        jnp.float32(0.5), jnp.float32(200.0))
    rept, zt = BarnesHutTsne._repulsion_blocked(torch.as_tensor(y), 64)
    got = BarnesHutTsne._step_blocked_update(
        torch.as_tensor(y), torch.as_tensor(vel), torch.as_tensor(gains), at,
        rept, zt, 0.5, 200.0)
    for name, a, b in zip(("y", "velocity", "gains"), got, want):
        _close(a.numpy(), np.asarray(b), STEP_RTOL, f"blocked step {name}")
    kl_j = jnp.sum(jnp.asarray(vj) * (jnp.log(jnp.maximum(vj, 1e-12)) - jnp.log(
        jnp.maximum(_ref_num(jnp.asarray(y), rj, cj) / zj, 1e-12))))
    kl_t = tt._sparse_kl(torch.as_tensor(y), rt, ct, vt, 64)
    assert abs(float(kl_t) - float(kl_j)) <= KL_RTOL * abs(float(kl_j))


def _ref_num(y, rows, cols):
    dy = y[rows] - y[cols]
    return 1.0 / (1.0 + jnp.sum(dy * dy, 1))


@pytest.mark.parametrize("mode,n,iters", [("blocked", 200, 50),
                                          ("tree", 100, 30)])
def test_barnes_hut_fit_whole(mode, n, iters):
    x = _points(3, n, 6)
    kw = dict(perplexity=10.0, max_iter=iters, mode=mode, block=64,
              exaggeration_iters=iters // 2,
              momentum_switch_iter=iters // 2, seed=4, **SMOOTH)
    ref = jt.BarnesHutTsne(**kw)
    want = ref.fit_transform(x)
    port = BarnesHutTsne(device="cpu", **kw)
    got = port.fit_transform(x)
    assert got.shape == (n, 2) and got.dtype == np.float32
    assert np.abs(want).max() > 1.0
    _close(got, want, FIT_RTOL, f"BarnesHutTsne {mode} layout")
    assert abs(port.kl_ - ref.kl_) <= KL_RTOL * abs(ref.kl_)


def test_tree_repulsion_matches_reference():
    y = (4 * np.random.default_rng(6).standard_normal((150, 2))).astype(
        np.float32)
    for theta in (0.0, 0.5):
        want = jt.BarnesHutTsne(theta=theta)._repulsion_tree(y)
        got = BarnesHutTsne(theta=theta, device="cpu")._repulsion_tree(y)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# --- the reference's behaviour tests, run against the port --------------------

def test_separates_clusters_and_reduces_kl():
    rng = np.random.RandomState(13)
    x = np.concatenate([rng.randn(40, 10) + 12, rng.randn(40, 10) - 12]) \
        .astype(np.float32)
    ts = Tsne(n_components=2, perplexity=15.0, max_iter=300,
              learning_rate=100.0, seed=3, device="cpu")
    y = ts.fit_transform(x)
    assert y.shape == (80, 2)
    a, b = y[:40], y[40:]
    centroid_gap = np.linalg.norm(a.mean(0) - b.mean(0))
    spread = max(a.std(), b.std())
    assert centroid_gap > 2 * spread, (centroid_gap, spread)
    assert np.isfinite(ts.kl_)


def test_tiny_input_passthrough():
    x = np.random.RandomState(14).randn(2, 5).astype(np.float32)
    y = Tsne(n_components=2, device="cpu").fit_transform(x)
    assert y.shape == (2, 2)
    assert BarnesHutTsne(device="cpu").fit_transform(x).shape == (2, 2)


def test_tsne_kl_is_true_divergence():
    rng = np.random.RandomState(44)
    x = np.concatenate([rng.randn(20, 5) + 6, rng.randn(20, 5) - 6]) \
        .astype(np.float32)
    ts = Tsne(perplexity=8, max_iter=100, exaggeration_iters=250, seed=1,
              device="cpu")
    ts.fit_transform(x)
    assert 0 <= ts.kl_ < 10, ts.kl_


def _blobs(n_per=60, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[6, 0, 0, 0], [0, 6, 0, 0], [0, 0, 6, 0]],
                       np.float64)
    x = np.concatenate([rng.standard_normal((n_per, 4)) * 0.4 + c
                        for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(3), n_per)


def _separation(y, labels):
    cents = np.stack([y[labels == k].mean(0) for k in range(3)])
    intra = np.mean([np.linalg.norm(y[labels == k] - cents[k], axis=1).mean()
                     for k in range(3)])
    inter = np.mean([np.linalg.norm(cents[a] - cents[b])
                     for a in range(3) for b in range(a + 1, 3)])
    return inter / intra


def test_blocked_separates_blobs():
    x, labels = _blobs()
    ts = BarnesHutTsne(max_iter=300, perplexity=15.0, block=64, seed=3,
                       device="cpu")
    y = ts.fit_transform(x)
    assert y.shape == (180, 2)
    assert np.isfinite(y).all()
    assert ts.kl_ is not None and np.isfinite(ts.kl_)
    assert _separation(y, labels) > 2.0


def test_tree_mode_separates_blobs():
    x, labels = _blobs(n_per=40, seed=1)
    ts = BarnesHutTsne(max_iter=150, perplexity=10.0, mode="tree", theta=0.5,
                       seed=4, device="cpu")
    y = ts.fit_transform(x)
    assert _separation(y, labels) > 1.5


def test_invalid_mode():
    with pytest.raises(ValueError):
        BarnesHutTsne(mode="octree", device="cpu")


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (Tsne, BarnesHutTsne):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


# --- the card against the CPU (chip_smoke.py's [analysis] runs these at full
# width on the H100) -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [analysis] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_step_and_repulsion_match_cpu(cuda):
    x = _with_repeats(1)
    rows, cols, vals = tt._knn_sparse_p(torch.as_tensor(x), 10.0)
    rc, cc, vc = tt._knn_sparse_p(torch.as_tensor(x, device=cuda), 10.0)
    assert torch.equal(rc.cpu(), rows) and torch.equal(cc.cpu(), cols)
    y = torch.as_tensor((3 * np.random.default_rng(2).standard_normal(
        (200, 2))).astype(np.float32))
    at = tt._attraction(y, rows, cols, vals, 12.0)
    ac = tt._attraction(y.to(cuda), rc, cc, vc, 12.0)
    _close(ac.cpu().numpy(), at.numpy(), REP_RTOL, "attraction")
    assert torch.equal(ac, tt._attraction(y.to(cuda), rc, cc, vc, 12.0))
    rt, zt = BarnesHutTsne._repulsion_blocked(y, 64)
    rcu, zc = BarnesHutTsne._repulsion_blocked(y.to(cuda), 64)
    err = np.abs(rcu.cpu().numpy() - rt.numpy()).max()
    assert err <= REP_RTOL * _rep_terms(y.numpy()), err
    assert abs(float(zc) - float(zt)) <= Z_RTOL * float(zt)


@pytest.mark.gpu
def test_card_fit_runs_twice_bit_equal(cuda):
    x = _with_repeats(2)
    a = BarnesHutTsne(max_iter=30, perplexity=10.0, block=64, seed=1,
                      device=cuda).fit_transform(x)
    b = BarnesHutTsne(max_iter=30, perplexity=10.0, block=64, seed=1,
                      device=cuda).fit_transform(x)
    np.testing.assert_array_equal(a, b)
