"""The port's VP, KD and SP trees and random-projection LSH
(deeplearning4j_torch/knn/{vptree,kdtree,sptree,lsh}.py) against the JAX
package's on the CPU, and the reference's own tree, SPTree and LSH tests
(tests/test_knn_graph_tsne.py) run against the port.

Tolerances: the trees are host numpy in both packages, so every answer is
equal bit for bit (indices, distances, node counts, centres of mass,
forces). LSH: the hyperplanes equal, the signatures equal in value and
dtype (uint32) and so the buckets, on gaussian data with no |point·plane|
within 1e-4 of 0 (f32 products of 16 terms round at 1e-6 there); the
re-ranked distances within 1e-6 relative, indices equal on data with no
near-tie among a query's k + 1 best.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_torch import knn as tknn
from deeplearning4j_torch.knn import (BruteForceKNN, KDTree, QuadTree,
                                      RandomProjectionLSH, SPTree, VPTree)
from deeplearning4j_torch.knn import lsh as tlsh
from deeplearning4j_torch.knn import vptree as tvp
from deeplearning4j_tpu import knn as jknn
from deeplearning4j_tpu.knn import lsh as jlsh
from deeplearning4j_tpu.knn import vptree as jvp

LSH_DIST_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one torch thread: beside other test
    workers the intra-op pool's barriers cost far more than the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_all_equals_the_reference():
    assert tknn.__all__ == jknn.__all__
    for name in tknn.__all__:
        assert hasattr(tknn, name)


def _linear_scan(points, q, k):
    d = np.linalg.norm(points - q[None], axis=1)
    idx = np.argsort(d)[:k]
    return idx, d[idx]


# --- VP tree ----------------------------------------------------------------

@pytest.mark.parametrize("distance", ["euclidean", "manhattan",
                                      "cosinesimilarity"])
def test_metric(distance):
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 9))
    assert tvp._metric(distance)(a, b) == jvp._metric(distance)(a, b)


def test_metric_unknown():
    with pytest.raises(ValueError):
        tvp._metric("hamming")


@pytest.mark.parametrize("distance", ["euclidean", "manhattan",
                                      "cosinesimilarity"])
@pytest.mark.parametrize("seed", [0, 12345])
def test_vptree_search_equals_reference(distance, seed):
    rng = np.random.default_rng(seed + 1)
    pts = rng.standard_normal((300, 7))
    port = VPTree(pts, distance=distance, seed=seed)
    ref = jknn.VPTree(pts, distance=distance, seed=seed)
    for q in rng.standard_normal((6, 7)):
        assert port.search(q, 5) == ref.search(q, 5)
        assert port.search(q, 0, max_distance=1.5) == \
            ref.search(q, 0, max_distance=1.5)
        assert port.search(q, 3, max_distance=2.0) == \
            ref.search(q, 3, max_distance=2.0)


# --- KD tree ----------------------------------------------------------------

@pytest.mark.parametrize("dims", [2, 6])
def test_kdtree_equals_reference(dims):
    rng = np.random.default_rng(dims)
    pts = rng.standard_normal((250, dims))
    port, ref = KDTree(pts), jknn.KDTree(pts)
    for q in rng.standard_normal((6, dims)):
        assert port.knn(q, 5) == ref.knn(q, 5)
        assert port.nn(q) == ref.nn(q)
        lo, hi = q - 0.7, q + 0.7
        assert port.range_search(lo, hi) == ref.range_search(lo, hi)


# --- SP tree and quadtree -----------------------------------------------------

def _same_tree(port, ref):
    assert port.n_nodes == ref.n_nodes
    assert port.depth() == ref.depth()
    assert port.is_correct() and ref.is_correct()
    n = ref.n_nodes
    for name in ("_center", "_width", "_com", "_count", "_point",
                 "_children", "_is_leaf"):
        np.testing.assert_array_equal(getattr(port, name)[:n],
                                      getattr(ref, name)[:n], err_msg=name)


@pytest.mark.parametrize("dim", [2, 3])
def test_sptree_equals_reference(dim):
    rng = np.random.default_rng(dim)
    y = rng.standard_normal((300, dim))
    y[10] = y[3]                           # an absorbed duplicate
    port, ref = SPTree(y), jknn.SPTree(y)
    _same_tree(port, ref)
    for i in (0, 3, 10, 77):
        for theta in (0.0, 0.5, 1.2):
            neg_p, sq_p = port.compute_non_edge_forces(y[i], theta)
            neg_r, sq_r = ref.compute_non_edge_forces(y[i], theta)
            np.testing.assert_array_equal(neg_p, neg_r)
            assert sq_p == sq_r


def test_quadtree_equals_reference():
    y = np.random.default_rng(9).standard_normal((120, 2))
    _same_tree(QuadTree(y), jknn.QuadTree(y))


# --- LSH ----------------------------------------------------------------------

def _lsh_points(seed, n=500, dim=16, hash_length=8):
    """Gaussian points whose products with the seed-12345 hyperplanes all
    lie at least 1e-4 from 0 (resampled where one does not)."""
    rng = np.random.default_rng(seed)
    planes = np.random.default_rng(12345).standard_normal(
        (hash_length, dim)).astype(np.float32)
    pts = rng.standard_normal((n, dim)).astype(np.float32)
    while True:
        bad = np.abs(pts.astype(np.float64) @ planes.T.astype(np.float64)) \
            .min(1) < 1e-4
        if not bad.any():
            return pts
        pts[bad] = rng.standard_normal((bad.sum(), dim))


@pytest.mark.parametrize("hash_length", [1, 8, 12, 32])
def test_lsh_equals_reference(hash_length):
    pts = _lsh_points(0, hash_length=hash_length)
    port = RandomProjectionLSH(pts, hash_length=hash_length, device="cpu")
    ref = jknn.RandomProjectionLSH(pts, hash_length=hash_length)
    np.testing.assert_array_equal(port.planes.numpy(), np.asarray(ref.planes))
    np.testing.assert_array_equal(port.signatures, ref.signatures)
    assert port.signatures.dtype == ref.signatures.dtype == np.uint32
    assert port._buckets == ref._buckets
    for i in (0, 42, 499):
        np.testing.assert_array_equal(port.bucket(pts[i]), ref.bucket(pts[i]))


def test_signatures_equal_reference():
    pts = _lsh_points(1, n=200, hash_length=32)
    planes = np.random.default_rng(12345).standard_normal((32, 16)).astype(
        np.float32)
    got = tlsh._signatures(torch.as_tensor(pts), torch.as_tensor(planes))
    want = jlsh._signatures(jnp.asarray(pts), jnp.asarray(planes))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 5, 600])
def test_lsh_search_equals_reference(k):
    pts = _lsh_points(2)
    rng = np.random.default_rng(3)
    port = RandomProjectionLSH(pts, hash_length=8, device="cpu")
    ref = jknn.RandomProjectionLSH(pts, hash_length=8)
    for i in (5, 42, 300):
        q = pts[i] + 0.01 * rng.standard_normal(16).astype(np.float32)
        gi, gd = port.search(q, k)
        wi, wd = ref.search(q, k)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=LSH_DIST_RTOL, atol=0)


def test_lsh_hash_length_bound():
    pts = np.random.RandomState(42).randn(10, 4).astype(np.float32)
    for bad in (0, 33, 40):
        with pytest.raises(ValueError):
            RandomProjectionLSH(pts, hash_length=bad, device="cpu")


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RandomProjectionLSH(np.zeros((3, 2), np.float32))


# --- the reference's behaviour tests, run against the port -------------------

class TestTrees:
    def test_vptree_matches_scan(self):
        rng = np.random.RandomState(4)
        pts = rng.randn(300, 10)
        tree = VPTree(pts)
        for _ in range(5):
            q = rng.randn(10)
            idx, d = tree.search(q, 7)
            want_idx, want_d = _linear_scan(pts, q, 7)
            np.testing.assert_array_equal(np.sort(idx), np.sort(want_idx))
            np.testing.assert_allclose(sorted(d), sorted(want_d), rtol=1e-9)

    def test_vptree_radius(self):
        rng = np.random.RandomState(5)
        pts = rng.randn(200, 3)
        tree = VPTree(pts)
        q = pts[0]
        idx, d = tree.search(q, k=0, max_distance=1.0)
        all_d = np.linalg.norm(pts - q[None], axis=1)
        assert set(idx) == set(np.nonzero(all_d <= 1.0)[0])

    def test_kdtree_matches_scan(self):
        rng = np.random.RandomState(6)
        pts = rng.randn(250, 6)
        tree = KDTree(pts)
        for _ in range(5):
            q = rng.randn(6)
            idx, d = tree.knn(q, 5)
            want_idx, _ = _linear_scan(pts, q, 5)
            np.testing.assert_array_equal(np.sort(idx), np.sort(want_idx))

    def test_kdtree_range(self):
        rng = np.random.RandomState(7)
        pts = rng.rand(100, 2)
        tree = KDTree(pts)
        got = set(tree.range_search([0.2, 0.2], [0.6, 0.6]))
        want = set(np.nonzero(np.all((pts >= 0.2) & (pts <= 0.6), axis=1))[0])
        assert got == want


class TestReviewRegressions:
    def test_vptree_cosine_matches_brute_ranking(self):
        rng = np.random.RandomState(40)
        pts = rng.randn(300, 8)
        tree = VPTree(pts, distance="cosinesimilarity")
        bf = BruteForceKNN(pts.astype(np.float32),
                           distance="cosinesimilarity", device="cpu")
        for _ in range(5):
            q = rng.randn(8)
            vi, _ = tree.search(q, 6)
            bi, _ = bf.search(q.astype(np.float32), 6)
            assert set(vi) == set(bi.tolist())

    def test_vptree_many_duplicates_no_recursion_blowup(self):
        pts = np.tile(np.eye(4), (500, 1))
        tree = VPTree(pts)
        idx, d = tree.search(np.array([1.0, 0, 0, 0]), 3)
        assert len(idx) == 3
        assert min(d) == 0.0


class TestLSH:
    def test_bucket_recall(self):
        rng = np.random.RandomState(10)
        pts = rng.randn(500, 16).astype(np.float32)
        lsh = RandomProjectionLSH(pts, hash_length=8, device="cpu")
        q = pts[42] + 0.001 * rng.randn(16).astype(np.float32)
        idx, d = lsh.search(q, 5)
        assert 42 in idx
        assert np.all(np.diff(d) >= -1e-6)


class TestSPTree:
    def test_structure_invariants(self):
        pts = np.random.default_rng(0).standard_normal((200, 3))
        t = SPTree(pts)
        assert t.is_correct()
        assert t._count[0] == 200
        np.testing.assert_allclose(t._com[0], pts.mean(0), atol=1e-9)
        assert t.depth() >= 1

    def test_quadtree_requires_2d(self):
        with pytest.raises(ValueError):
            QuadTree(np.zeros((5, 3)))
        t = QuadTree(np.random.default_rng(1).standard_normal((50, 2)))
        assert t.is_correct()

    def test_duplicate_points_absorbed(self):
        t = QuadTree(np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]]))
        assert t._count[0] == 3

    def test_bh_force_approximates_exact(self):
        y = np.random.default_rng(2).standard_normal((300, 2))
        tree = SPTree(y)
        i = 7
        diff = y[i] - y
        num = 1.0 / (1.0 + (diff ** 2).sum(1))
        num[i] = 0.0
        exact_rep = (num[:, None] ** 2 * diff).sum(0)
        exact_z = num.sum()
        approx_rep, approx_z = tree.compute_non_edge_forces(y[i], theta=0.5)
        np.testing.assert_allclose(approx_z, exact_z, rtol=0.05)
        assert (np.linalg.norm(approx_rep - exact_rep)
                < 0.1 * np.linalg.norm(exact_rep) + 1e-3)
        exact0_rep, exact0_z = tree.compute_non_edge_forces(y[i], theta=0.0)
        np.testing.assert_allclose(exact0_z, exact_z, rtol=1e-9)
        np.testing.assert_allclose(exact0_rep, exact_rep, rtol=1e-7,
                                   atol=1e-12)

    def test_near_duplicates_keep_mass(self):
        pts = np.array([[1.0, 1.0], [1.0 + 1e-6, 1.0], [5.0, 5.0]])
        t = SPTree(pts)
        _, z = t.compute_non_edge_forces(pts[0], theta=0.0)
        num = 1.0 / (1.0 + ((pts[0] - pts) ** 2).sum(1))
        np.testing.assert_allclose(z, num.sum() - 1.0, rtol=1e-9)
        pts2 = np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [4.0, 4.0]])
        t2 = SPTree(pts2)
        _, z2 = t2.compute_non_edge_forces(pts2[3], theta=0.0)
        np.testing.assert_allclose(z2, 3.0 / (1.0 + 32.0), rtol=1e-9)
        _, z3 = t2.compute_non_edge_forces(pts2[0], theta=0.0)
        np.testing.assert_allclose(z3, 2.0 + 1.0 / 33.0, rtol=1e-9)


# --- the card against the CPU (chip_smoke.py's [analysis] runs this on the
# 71,290 word vectors on the H100) ------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [analysis] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_lsh_matches_cpu(cuda):
    pts = np.random.default_rng(4).standard_normal((4000, 32)).astype(
        np.float32)
    card = RandomProjectionLSH(pts, hash_length=12, device=cuda)
    cpu = RandomProjectionLSH(pts, hash_length=12, device="cpu")
    flips = card.signatures != cpu.signatures
    dots = np.abs(pts.astype(np.float64) @ cpu.planes.numpy().T
                  .astype(np.float64)).min(1)
    # a bit may differ only where the product is within rounding of 0
    assert np.all(dots[flips] < 1e-4)
    q = pts[7] + 0.01
    gi, gd = card.search(q, 5)
    wi, wd = cpu.search(q, 5)
    np.testing.assert_allclose(gd, wd, rtol=1e-5)
