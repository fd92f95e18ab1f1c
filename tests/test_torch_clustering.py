"""The port's k-means and clustering framework (deeplearning4j_torch/knn/
kmeans.py, knn/clustering.py) against the JAX package's on the CPU, and
the reference's clustering behaviour tests (tests/test_clustering.py)
run against the port.

Tolerances: assignments, counts, point-location changes, iteration counts,
strategy actions and cluster counts equal; centres within 1e-5 of their
largest entry (CENTER_RTOL: the one-hot products add in another order);
costs within 1e-5 relative. A distance is the square root of
|x|² - 2x·c + |c|², whose f32 rounding is a few ulps of S, the largest
squared norm: squared distances are held within 8 eps·S, and distances
and the average and largest distance of each cluster within sqrt(8 eps·S)
(what that rounding becomes at a distance near 0, as where a centre is
one of the points); a cluster's distance variance within 8 eps·S plus
twice its largest distance times that. The data are blobs and gaussian
clouds with no point within rounding of two centres, so the argmins agree.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_torch.knn import (BaseClusteringAlgorithm,
                                      ClusteringOptimizationType,
                                      ConvergenceCondition,
                                      FixedIterationCountCondition,
                                      IterationHistory, KMeans,
                                      KMeansClustering, OptimisationStrategy,
                                      VarianceVariationCondition)
from deeplearning4j_torch.knn import clustering as tc
from deeplearning4j_torch.knn import kmeans as tk
from deeplearning4j_torch.knn.clustering import (ClusterInfo, ClusterSetInfo,
                                                 IterationInfo)
from deeplearning4j_tpu import knn as jknn
from deeplearning4j_tpu.knn import clustering as jc
from deeplearning4j_tpu.knn import kmeans as jk

import jax.numpy as jnp

CENTER_RTOL = 1e-5
COST_RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one torch thread: beside other test
    workers the intra-op pool's barriers cost far more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blobs(n_per=50, k=3, spread=0.3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, 4)) * 6
    x = np.concatenate([rng.standard_normal((n_per, 4)) * spread + c
                        for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(k), n_per)


def _sq_scale(x, *centers):
    """S: the largest squared norm among the points and centres."""
    return max(float((np.asarray(a, np.float64) ** 2).sum(1).max())
               for a in (x,) + centers)


def _dist_close(got, want, S, what, var=False):
    """Distances (or, with ``var``, variances of distances) within the
    rounding of the distance identity at scale S."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    d_tol = np.sqrt(8 * EPS32 * S)
    tol = 8 * EPS32 * S + 2 * np.sqrt(max(want.max(), 0.0)) * d_tol \
        if var else d_tol
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol, f"{what}: {err} against {tol}"


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rtol * scale, f"{what}: {err} of scale {scale}"


# --- k-means ---------------------------------------------------------------

def test_lloyd_step():
    x, _ = blobs(n_per=40, k=4, spread=1.0, seed=1)
    c0 = x[[0, 50, 90, 130]].copy()
    cj, aj, costj = jk._lloyd_step(jnp.asarray(x), jnp.asarray(c0), 4)
    ct, at, costt = tk._lloyd_step(torch.as_tensor(x), torch.as_tensor(c0), 4)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    _close(ct.numpy(), np.asarray(cj), CENTER_RTOL, "centroids")
    assert abs(float(costt) - float(costj)) <= COST_RTOL * float(costj)


def test_lloyd_step_keeps_an_empty_centroid():
    x, _ = blobs(n_per=20, k=2, seed=2)
    c0 = np.concatenate([x[[0, 30]], [[1e3, 1e3, 1e3, 1e3]]]).astype(
        np.float32)
    ct, at, _ = tk._lloyd_step(torch.as_tensor(x), torch.as_tensor(c0), 3)
    cj, aj, _ = jk._lloyd_step(jnp.asarray(x), jnp.asarray(c0), 3)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(ct.numpy()[2], c0[2])
    _close(ct.numpy(), np.asarray(cj), CENTER_RTOL, "centroids")


def _count_steps(monkeypatch, module):
    calls = []
    real = module._lloyd_step

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(module, "_lloyd_step", counted)
    return calls


@pytest.mark.parametrize("init", ["kmeans++", "random"])
@pytest.mark.parametrize("tol", [1e-4, None])
def test_kmeans_fit_predict(monkeypatch, init, tol):
    x, _ = blobs(n_per=60, k=5, spread=1.5, seed=3)
    kw = dict(k=5, max_iterations=40, variation_tolerance=tol, seed=7,
              init=init)
    nj, nt = _count_steps(monkeypatch, jk), _count_steps(monkeypatch, tk)
    ref = jknn.KMeans(**kw).fit(x)
    port = KMeans(device="cpu", **kw).fit(x)
    fit_steps = (len(nj), len(nt))
    assert fit_steps[0] == fit_steps[1] and fit_steps[0] > 1
    _close(port.centroids, ref.centroids, CENTER_RTOL, "centroids")
    assert abs(port.cost_ - ref.cost_) <= COST_RTOL * ref.cost_
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    assert port.predict(x).dtype == ref.predict(x).dtype


def test_kmeanspp_init_is_the_reference_draw():
    x, _ = blobs(n_per=30, k=4, seed=4)
    a = tk._kmeanspp_init(x, 6, np.random.default_rng(5))
    b = jk._kmeanspp_init(x, 6, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


# --- one clustering pass ----------------------------------------------------

def test_cluster_pass():
    x, _ = blobs(n_per=40, k=4, spread=1.0, seed=5)
    centers = np.concatenate([x[[0, 45, 90]], [[50.0, 50, 50, 50]]]) \
        .astype(np.float32)                      # the last one stays empty
    prev = np.random.default_rng(0).integers(0, 4, len(x))
    want = jc._cluster_pass(jnp.asarray(x), jnp.asarray(centers),
                            jnp.asarray(prev), 4)
    got = tc._cluster_pass(torch.as_tensor(x), torch.as_tensor(centers),
                           torch.as_tensor(prev), 4)
    names = ("assign", "centers", "counts", "avg", "var", "max", "dist",
             "changes")
    S = _sq_scale(x, centers)
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("assign", "counts", "changes"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "centers":
            _close(g, w, CENTER_RTOL, name)
        else:
            _dist_close(g, w, S, name, var=name == "var")
    assert float(got[2][3]) == 0 and float(got[5][3]) == 0


# --- apply_to under each strategy and condition ------------------------------

def _same_clusterset(got, want, S):
    assert got.cluster_count == want.cluster_count
    _close(got.centers, want.centers, CENTER_RTOL, "centers")
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert got.assignments.dtype == want.assignments.dtype
    err = np.abs(got.distances.astype(np.float64) ** 2
                 - want.distances.astype(np.float64) ** 2).max()
    assert err <= 8 * EPS32 * S, f"squared distances: {err}"
    _dist_close(got.distances, want.distances, S, "distances")
    _same_info(got.info, want.info, S, "final")


def _same_info(got, want, S, what):
    assert got.points_count == want.points_count
    assert got.point_location_change == want.point_location_change, what
    assert [c.point_count for c in got.clusters] == \
        [c.point_count for c in want.clusters], what
    for field in ("average_point_distance_from_center",
                  "point_distance_from_center_variance",
                  "max_point_distance_from_center"):
        _dist_close([getattr(c, field) for c in got.clusters],
                    [getattr(c, field) for c in want.clusters], S,
                    f"{what} {field}", var="variance" in field)


def _same_history(got, want, S):
    assert got.iteration_count == want.iteration_count
    for i in want.iterations:
        g, w = got.get(i), want.get(i)
        assert g.strategy_applied == w.strategy_applied, i
        _same_info(g.cluster_set_info, w.cluster_set_info, S,
                   f"iteration {i}")


def _algorithm(pkg, name, **kw):
    """The named algorithm of ``pkg`` (the port's gets ``kw``: its
    device)."""
    T = pkg.ClusteringOptimizationType
    if name == "fixed_count":
        return pkg.KMeansClustering.setup(3, 15, seed=1, **kw)
    if name == "variation":
        return pkg.KMeansClustering.setup_with_variation(3, 0.01, seed=2,
                                                         **kw)
    if name == "variance_condition":
        strat = pkg.FixedClusterCountStrategy.setup(3)
        strat.termination_condition = pkg.VarianceVariationCondition(0.01, 2)
        return pkg.BaseClusteringAlgorithm.setup(strat, 3, **kw)
    strat, seed = {
        "split_max_distance": (
            pkg.OptimisationStrategy.setup(1)
            .optimize(T.MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE, 3.0)
            .end_when_iteration_count_equals(15), 5),
        "split_average_distance": (
            pkg.OptimisationStrategy.setup(2)
            .optimize(T.MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE, 1.0)
            .optimize_when_iteration_count_multiple_of(3)
            .end_when_iteration_count_equals(10), 6),
        "split_point_count": (
            pkg.OptimisationStrategy.setup(1)
            .optimize(T.MINIMIZE_PER_CLUSTER_POINT_COUNT, 70)
            .optimize_when_point_distribution_variation_rate_less_than(0.5)
            .end_when_iteration_count_equals(12), 6),
    }[name]
    return pkg.BaseClusteringAlgorithm.setup(strat, seed, **kw)


@pytest.mark.parametrize("name", ["fixed_count", "variation",
                                  "variance_condition", "split_max_distance",
                                  "split_average_distance",
                                  "split_point_count"])
def test_apply_to(name):
    x, _ = blobs(n_per=50, k=3, spread=1.0, seed=6)
    ref = _algorithm(jknn, name)
    port = _algorithm(tc, name, device="cpu")
    want, got = ref.apply_to(x), port.apply_to(x)
    S = _sq_scale(x)
    _same_clusterset(got, want, S)
    _same_history(port.history, ref.history, S)
    if name.startswith("split"):
        assert want.cluster_count > ref.strategy.initial_cluster_count


def test_apply_to_empty_cluster_resplit():
    """FixedClusterCountStrategy's remove-and-split path: duplicate
    coordinates leave clusters empty on every pass until the backstop."""
    pts = np.array([[0.0, 0.0]] * 5 + [[1.0, 1.0]] * 5, np.float32)
    ref = jknn.KMeansClustering.setup(3, max_iterations=5, seed=0)
    port = KMeansClustering.setup(3, max_iterations=5, seed=0, device="cpu")
    ref.MAX_TOTAL_ITERATIONS = port.MAX_TOTAL_ITERATIONS = 9
    want, got = ref.apply_to(pts), port.apply_to(pts)
    assert any(i.strategy_applied for i in ref.history.iterations.values())
    _same_clusterset(got, want, _sq_scale(pts))
    _same_history(port.history, ref.history, _sq_scale(pts))


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_split(idx):
    x, _ = blobs(n_per=30, k=3, spread=1.0, seed=8)
    centers = x[[0, 35, 70]].copy()
    port = KMeansClustering.setup(3, 5, device="cpu")
    want = jknn.KMeansClustering.setup(3, 5)._split(x, centers, idx)
    port._points = (x, torch.as_tensor(x))
    np.testing.assert_array_equal(port._split(x, centers, idx), want)
    port._points = None      # and from host points alone
    np.testing.assert_array_equal(port._split(x, centers, idx), want)


def test_split_blocks_cover_every_row(monkeypatch):
    x, _ = blobs(n_per=30, k=3, spread=1.0, seed=9)
    centers = x[[0, 35, 70]].copy()
    want = jknn.KMeansClustering.setup(3, 5)._split(x, centers, 1)
    monkeypatch.setattr(tc, "SPLIT_BLOCK_ELEMENTS", 7 * centers.size)
    got = KMeansClustering.setup(3, 5, device="cpu")._split(x, centers, 1)
    np.testing.assert_array_equal(got, want)


def test_split_of_an_empty_cluster_takes_the_farthest_point():
    x, _ = blobs(n_per=20, k=2, seed=10)
    centers = np.concatenate([x[[0, 25]], [[90.0, 90, 90, 90]]]).astype(
        np.float32)
    want = jknn.KMeansClustering.setup(3, 5)._split(x, centers, 2)
    got = KMeansClustering.setup(3, 5, device="cpu")._split(x, centers, 2)
    np.testing.assert_array_equal(got, want)


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KMeansClustering.setup(3, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KMeans(3)


# --- the reference's behaviour tests (tests/test_clustering.py) ---------------

def _history(variances=(), changes=(), n_points=100):
    h = IterationHistory()
    for i, v in enumerate(variances or [0.0] * len(changes), start=1):
        ch = changes[i - 1] if changes else 0
        info = ClusterSetInfo(clusters=[ClusterInfo(n_points, 1.0, v, 2.0)],
                              point_location_change=ch, points_count=n_points)
        h.iterations[i] = IterationInfo(i, info)
    return h


class TestConditions:
    def test_fixed_iteration_count(self):
        c = FixedIterationCountCondition.iteration_count_greater_than(3)
        assert not c.is_satisfied(_history(variances=[1, 1]))
        assert c.is_satisfied(_history(variances=[1, 1, 1]))

    def test_convergence_rate(self):
        c = ConvergenceCondition.distribution_variation_rate_less_than(0.05)
        assert not c.is_satisfied(_history(changes=[90, 50]))
        assert c.is_satisfied(_history(changes=[90, 2]))
        assert not c.is_satisfied(_history(changes=[90]))

    def test_variance_variation(self):
        c = VarianceVariationCondition.variance_variation_less_than(
            0.01, period=2)
        assert c.is_satisfied(_history(variances=[5.0, 1.0, 1.001, 1.0011]))
        assert not c.is_satisfied(_history(variances=[5.0, 3.0, 2.0, 1.0]))
        assert not c.is_satisfied(_history(variances=[1.0, 1.0]))


class TestKMeansClustering:
    def test_recovers_blobs(self):
        x, labels = blobs()
        algo = KMeansClustering.setup(3, max_iterations=30, seed=1,
                                      device="cpu")
        cs = algo.apply_to(x)
        assert cs.cluster_count == 3
        mapping = [np.bincount(cs.assignments[labels == t],
                               minlength=3).argmax() for t in range(3)]
        assert len(set(mapping)) == 3
        purity = np.mean([np.bincount(cs.assignments[labels == t]).max()
                          / (labels == t).sum() for t in range(3)])
        assert purity > 0.95
        assert all(c.point_count > 0 for c in cs.info.clusters)
        assert cs.info.average_point_distance_from_center < 2.0

    def test_variation_termination_stops_early(self):
        x, _ = blobs(seed=2)
        algo = KMeansClustering.setup_with_variation(3, variation_rate=0.01,
                                                     seed=2, device="cpu")
        algo.apply_to(x)
        assert algo.history.iteration_count < 50

    def test_classify_point(self):
        x, _ = blobs(seed=3)
        cs = KMeansClustering.setup(3, 20, seed=3, device="cpu").apply_to(x)
        assert cs.classify_point(x[0]) == cs.assignments[0]

    def test_fixed_count_resplits_empty(self):
        x, _ = blobs(n_per=30, k=3, seed=4)
        cs = KMeansClustering.setup(4, 25, seed=4, device="cpu").apply_to(x)
        assert cs.cluster_count == 4
        assert all(c.point_count > 0 for c in cs.info.clusters)


class TestOptimisationStrategy:
    def test_split_on_max_distance(self):
        x, _ = blobs(n_per=40, k=2, seed=5)
        strat = (OptimisationStrategy.setup(1)
                 .optimize(ClusteringOptimizationType
                           .MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE, 3.0)
                 .end_when_iteration_count_equals(15))
        cs = BaseClusteringAlgorithm.setup(strat, seed=5,
                                           device="cpu").apply_to(x)
        assert cs.cluster_count >= 2
        assert all(c.max_point_distance_from_center < 4.0
                   for c in cs.info.clusters)

    def test_split_on_point_count(self):
        x, _ = blobs(n_per=60, k=2, seed=6)
        strat = (OptimisationStrategy.setup(1)
                 .optimize(ClusteringOptimizationType
                           .MINIMIZE_PER_CLUSTER_POINT_COUNT, 80)
                 .end_when_iteration_count_equals(12))
        cs = BaseClusteringAlgorithm.setup(strat, seed=6,
                                           device="cpu").apply_to(x)
        assert cs.cluster_count >= 2
        assert all(c.point_count <= 80 for c in cs.info.clusters)

    def test_application_condition_gates_optimization(self):
        x, _ = blobs(n_per=40, k=2, seed=7)
        strat = (OptimisationStrategy.setup(1)
                 .optimize(ClusteringOptimizationType
                           .MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE, 1e9)
                 .optimize_when_iteration_count_multiple_of(3)
                 .end_when_iteration_count_equals(8))
        cs = BaseClusteringAlgorithm.setup(strat, seed=7,
                                           device="cpu").apply_to(x)
        assert cs.cluster_count == 1


class TestDegenerateInputs:
    def test_duplicate_coordinates_terminate(self):
        pts = np.array([[0.0, 0.0]] * 5 + [[1.0, 1.0]] * 5, np.float32)
        algo = KMeansClustering.setup(3, max_iterations=5, seed=0,
                                      device="cpu")
        algo.MAX_TOTAL_ITERATIONS = 40
        cs = algo.apply_to(pts)
        assert cs.cluster_count >= 2
        assert algo.history.iteration_count <= 40

    def test_backstop_returns_consistent_clusterset(self):
        pts = np.array([[0.0, 0.0]] * 5 + [[1.0, 1.0]] * 5, np.float32)
        algo = KMeansClustering.setup(3, max_iterations=5, seed=0,
                                      device="cpu")
        algo.MAX_TOTAL_ITERATIONS = 7
        cs = algo.apply_to(pts)
        assert cs.cluster_count == len(cs.info.clusters)
        assert cs.assignments.max() < cs.cluster_count
        assert sum(c.point_count for c in cs.info.clusters) == len(pts)


# --- the reference's k-means tests (tests/test_knn_graph_tsne.py) -------------

def test_kmeans_separates_blobs():
    rng = np.random.RandomState(8)
    x = np.concatenate([rng.randn(50, 4) + 10, rng.randn(50, 4) - 10,
                        rng.randn(50, 4) + np.array([10, -10, 10, -10])])
    km = KMeans(k=3, max_iterations=50, device="cpu").fit(x)
    labels = km.predict(x)
    for s in range(0, 150, 50):
        assert len(set(labels[s:s + 50].tolist())) == 1
    assert len(set(labels.tolist())) == 3


def test_kmeans_convergence_cost_finite():
    x = np.random.RandomState(9).randn(200, 5)
    km = KMeans(k=4, max_iterations=30, variation_tolerance=None,
                device="cpu").fit(x)
    assert km.cost_ is not None and np.isfinite(km.cost_)


# --- the card against the CPU (chip_smoke.py's [analysis] runs these on the
# 71,290 word vectors on the H100) ------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [analysis] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_passes_match_cpu(cuda):
    x, _ = blobs(n_per=200, k=5, spread=1.0, seed=11)
    c0 = x[[0, 210, 420, 630, 840]].copy()
    prev = torch.zeros(len(x), dtype=torch.int64)
    cpu = tc._cluster_pass(torch.as_tensor(x), torch.as_tensor(c0), prev, 5)
    card = tc._cluster_pass(torch.as_tensor(x, device=cuda),
                            torch.as_tensor(c0, device=cuda), prev.to(cuda), 5)
    again = tc._cluster_pass(torch.as_tensor(x, device=cuda),
                             torch.as_tensor(c0, device=cuda), prev.to(cuda),
                             5)
    assert all(torch.equal(a, b) for a, b in zip(card, again))
    assert torch.equal(card[0].cpu(), cpu[0])
    _close(card[1].cpu().numpy(), cpu[1].numpy(), CENTER_RTOL, "centers")
    S = _sq_scale(x, c0)
    for name, i in (("avg", 3), ("var", 4), ("max", 5), ("dist", 6)):
        _dist_close(card[i].cpu().numpy(), cpu[i].numpy(), S, name,
                    var=name == "var")
    lc = tk._lloyd_step(torch.as_tensor(x, device=cuda),
                        torch.as_tensor(c0, device=cuda), 5)
    lp = tk._lloyd_step(torch.as_tensor(x), torch.as_tensor(c0), 5)
    assert torch.equal(lc[1].cpu(), lp[1])
    _close(lc[0].cpu().numpy(), lp[0].numpy(), CENTER_RTOL, "lloyd")


@pytest.mark.gpu
def test_card_apply_to_twice_bit_equal(cuda):
    x, _ = blobs(n_per=200, k=4, spread=1.0, seed=12)
    a = KMeansClustering.setup(4, 10, device=cuda).apply_to(x)
    b = KMeansClustering.setup(4, 10, device=cuda).apply_to(x)
    np.testing.assert_array_equal(a.centers, b.centers)
    np.testing.assert_array_equal(a.distances, b.distances)
