"""The port's brute-force k-NN, its server and client
(deeplearning4j_torch/knn/, utils/distances.py) against the JAX package's,
on the CPU.

Tolerances: on tie-free inputs (gaussian points; no two of a query's best
scores within 1e-5 of the scores' scale, ten times f32's rounding there)
the indices are equal and the distances within
rtol 1e-5, atol 1e-6 (DIST_*); squared distances within the same bounds.
The two servers answer the same requests with the same status and JSON,
numbers within the same bounds; the one 400 whose message comes from the
array library (a query of the wrong width) is held to its status alone.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_torch import knn as tknn
from deeplearning4j_torch.obs.promcheck import check_text
from deeplearning4j_torch.utils.distances import pairwise_sq_dists as t_sq
from deeplearning4j_tpu import knn as jknn
from deeplearning4j_tpu.utils.distances import pairwise_sq_dists as j_sq

DIST_ATOL, DIST_RTOL = 1e-6, 1e-5
DISTANCES = ("euclidean", "cosinesimilarity", "dot", "manhattan")
N, DIM = 300, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one torch thread. On a loaded machine
    the intra-op pool's barriers cost far more than the work: one
    skip-gram fit of these tests took 54 s on 8 threads beside 8 busy
    processes, 0.6 s on 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=0, n=N):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)


def _tie_free_rows(points, queries, distance, k):
    """Per query: no two of its k + 1 best reference scores lie within 1e-5
    of the largest score's magnitude (at least 1)."""
    q = queries.astype(np.float64)
    p = points.astype(np.float64)
    if distance == "euclidean":
        s = ((q[:, None] - p[None]) ** 2).sum(-1)
    elif distance == "manhattan":
        s = np.abs(q[:, None] - p[None]).sum(-1)
    elif distance == "dot":
        s = q @ p.T
    else:
        s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ \
            (p / np.linalg.norm(p, axis=1, keepdims=True)).T
    s = np.sort(s, axis=1)
    best = s[:, :k + 1] if distance in ("euclidean", "manhattan") \
        else s[:, -(k + 1):]
    scale = np.maximum(np.abs(s).max(axis=1, keepdims=True), 1.0)
    return np.all(np.diff(best, axis=1) > 1e-5 * scale, axis=1)


def _tie_free(points, queries, distance, k):
    return bool(np.all(_tie_free_rows(points, queries, distance, k)))


def _queries(seed, n, k, points=None):
    """n gaussian queries, each tie-free at k under every distance (drawn
    from 4n candidates, the first n that are)."""
    points = _points() if points is None else points
    cand = _points(seed, 4 * n)
    ok = np.all([_tie_free_rows(points, cand, d, k) for d in DISTANCES],
                axis=0)
    assert ok.sum() >= n
    return cand[ok][:n]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    np.testing.assert_allclose(got[1], want[1], atol=DIST_ATOL,
                               rtol=DIST_RTOL)


def test_pairwise_sq_dists():
    a, b = _points(1, 40), _points(2, 30)
    for args in ((a, b), (a,)):
        got = t_sq(*[torch.from_numpy(x) for x in args]).numpy()
        want = np.asarray(j_sq(*[jnp.asarray(x) for x in args]))
        assert got.min() >= 0.0
        np.testing.assert_allclose(got, want, atol=DIST_ATOL * 10,
                                   rtol=DIST_RTOL)


@pytest.mark.parametrize("distance", DISTANCES)
@pytest.mark.parametrize("k", [1, 7])
def test_search_batched(distance, k):
    pts, qs = _points(), _queries(3, 70, 7)  # manhattan's blocks: 32+32+6
    got = tknn.BruteForceKNN(pts, distance=distance, device="cpu").search(qs, k)
    want = jknn.BruteForceKNN(pts, distance=distance).search(qs, k)
    assert got[0].shape == (70, k)
    _same(got, want)


@pytest.mark.parametrize("distance", DISTANCES)
def test_search_single_and_clamped_k(distance):
    pts, q = _points(), _queries(4, 1, 5)[0]
    t = tknn.BruteForceKNN(pts, distance=distance, device="cpu")
    j = jknn.BruteForceKNN(pts, distance=distance)
    _same(t.search(q, 5), j.search(q, 5))
    got = t.search(q[None], N + 10)        # k above N is clamped to N
    assert got[0].shape == (1, N)
    np.testing.assert_array_equal(np.sort(got[0][0]), np.arange(N))


@pytest.mark.parametrize("distance", DISTANCES)
def test_search_excluding_self(distance):
    pts = _points()
    t = tknn.BruteForceKNN(pts, distance=distance, device="cpu")
    j = jknn.BruteForceKNN(pts, distance=distance)
    rows = np.flatnonzero(np.all([_tie_free_rows(pts, pts, d, 7)
                                  for d in DISTANCES], axis=0))
    for row in (rows[0], rows[len(rows) // 2], rows[-1]):
        got, want = t.search_excluding_self(row, 6), \
            j.search_excluding_self(row, 6)
        assert row not in got[0] and len(got[0]) == 6
        _same(got, want)


@pytest.mark.parametrize("row", [-1, N, N + 5])
def test_search_excluding_self_index_error(row):
    t = tknn.BruteForceKNN(_points(), device="cpu")
    j = jknn.BruteForceKNN(_points())
    with pytest.raises(IndexError) as te:
        t.search_excluding_self(row, 3)
    with pytest.raises(IndexError) as je:
        j.search_excluding_self(row, 3)
    assert str(te.value) == str(je.value)


def test_bad_arguments_raise_as_the_reference():
    pts = _points()
    with pytest.raises(ValueError, match="Unknown distance 'foo'"):
        tknn.BruteForceKNN(pts, distance="foo", device="cpu").search(pts[0], 2)
    t = tknn.BruteForceKNN(pts, device="cpu")
    with pytest.raises(ValueError, match="must be nonnegative, got -1"):
        t.search(pts[0], -1)
    with pytest.raises(TypeError):
        t.search(pts[0, :3], 2)
    idx, d = t.search(pts[:0], 3)
    assert idx.shape == d.shape == (0, 3)


def test_index_owns_its_points():
    pts = _points()
    t = tknn.BruteForceKNN(pts, device="cpu")
    want = t.search(pts[5], 3)
    pts[:] = 0.0  # the caller's array changes; the index does not
    _same(t.search(_points()[5], 3), want)


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tknn.BruteForceKNN(_points())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tknn.NearestNeighborsServer(_points(), port=0)


# --------------------------------------------------------------------------
# the servers
# --------------------------------------------------------------------------

def _request(port, path, body=None):
    """(status, parsed JSON) of one request; ``body`` bytes POSTs."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"} if body is not None
        else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _body(obj):
    return json.dumps(obj).encode()


def _requests(pts, distance):
    q = _queries(5, 4, 5, pts)
    # every answer below is tie-free: row r's best 50, q's best 5
    r = int(np.flatnonzero(_tie_free_rows(pts, pts, distance, 50))[0])
    return [
        ("/health", None), ("/nope", None),
        ("/knn", _body({"ndarray": r, "k": 4})),
        ("/knn", _body({"ndarray": r})),
        ("/knn", _body({"ndarray": r, "k": 0})),
        ("/knn", _body({"ndarray": r, "k": 49})),
        ("/knnnew", _body({"ndarray": q[0].tolist(), "k": 3})),
        ("/knnnew", _body({"ndarray": q.tolist(), "k": 2})),
        ("/knnnew", _body({"ndarray": q.tolist()})),
        ("/knn", _body({"ndarray": -1, "k": 2})),
        ("/knn", _body({"ndarray": N})),
        ("/knn", _body({"k": 2})),
        ("/knn", b"[1, 2]"),
        ("/knn", b"{not json"),
        ("/knn", _body({"ndarray": "abc"})),
        ("/knn", _body({"ndarray": 3, "k": "x"})),
        ("/knnnew", _body({"ndarray": [[1.0, 2.0], [3.0]]})),
        ("/knnnew", _body({"ndarray": q[0].tolist(), "k": -1})),
        ("/other", _body({})),
    ]


def _json_close(got, want):
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _json_close(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _json_close(a, b)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, atol=DIST_ATOL, rtol=DIST_RTOL)
    else:
        assert got == want


@pytest.mark.parametrize("distance", ["euclidean", "cosinesimilarity"])
def test_servers_answer_alike(distance):
    pts = _points()
    t = tknn.NearestNeighborsServer(pts, distance=distance, port=0,
                                    device="cpu").start()
    j = jknn.NearestNeighborsServer(pts, distance=distance, port=0).start()
    try:
        statuses = []
        for path, body in _requests(pts, distance):
            got, want = _request(t.port, path, body), \
                _request(j.port, path, body)
            assert got[0] == want[0], (path, body, got, want)
            _json_close(got[1], want[1])
            statuses.append(got[0])
        assert statuses.count(400) == 9 and statuses.count(404) == 2
        # a query of the wrong width: 400 from both, each library's message
        bad = _body({"ndarray": [1.0, 2.0, 3.0]})
        got, want = _request(t.port, "/knnnew", bad), \
            _request(j.port, "/knnnew", bad)
        assert got[0] == want[0] == 400 and isinstance(got[1]["error"], str)
        time.sleep(0.05)  # the handler counts a request after replying
        status, _ = _request(t.port, "/health")
        with urllib.request.urlopen(f"http://127.0.0.1:{t.port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert status == 200 and check_text(text) == []
        assert 'endpoint="/knn"' in text and 'endpoint="/knnnew"' in text
    finally:
        t.stop()
        j.stop()


def test_clients_alike():
    pts = _points()
    t = tknn.NearestNeighborsServer(pts, port=0, device="cpu").start()
    try:
        tc = tknn.NearestNeighborsClient(port=t.port)
        jc = jknn.NearestNeighborsClient(port=t.port)
        assert tc.health() == jc.health() == {"status": "ok", "points": N}
        assert tc.knn(5, 3) == jc.knn(5, 3)
        assert tc.knn_new(pts[9].tolist(), 2) == jc.knn_new(pts[9].tolist(), 2)
        assert tc.knn_new(pts[9].tolist(), 1)[0]["index"] == 9
        want = jknn.BruteForceKNN(pts).search_excluding_self(5, 3)[0]
        assert [r["index"] for r in tc.knn(5, 3)] == want.tolist()
    finally:
        t.stop()
