"""The port's graph embeddings (deeplearning4j_torch/graph/) against the JAX
package's, on the CPU.

Tolerances: walks, the CSR arrays and the degree Huffman tree are equal
exactly (the host draws the same numpy streams); DeepWalk and Node2Vec fits
from the same seed hold tables and per-epoch losses within rtol 1e-4,
atol 1e-5 (FIT_*), as the nlp fits do; nearest vertices from the same
tables are the same, their similarities within 1e-6.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_torch import graph as tgraph
from deeplearning4j_tpu import graph as jgraph
from deeplearning4j_tpu.graph.graph import NoEdgesException as JNoEdges
from deeplearning4j_torch.graph.graph import NoEdgesException as TNoEdges

FIT_ATOL, FIT_RTOL = 1e-5, 1e-4
N, D = 60, 16


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


def _edges(seed=0, n_edges=300):
    """Random weighted undirected edges, with repeats and an isolated vertex
    (N - 1 is never named)."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, N - 1, n_edges), rng.integers(0, N - 1, n_edges)
    w = rng.random(n_edges) + 0.1
    return [(int(x), int(y), float(z)) for x, y, z in zip(a, b, w) if x != y]


def _graphs(edges=None, directed=False):
    edges = _edges() if edges is None else edges
    return tuple(pkg.Graph(N, [pkg.Edge(a, b, w, directed) for a, b, w in edges])
                 for pkg in (tgraph, jgraph))


def _fit_close(got, want):
    # FIT tolerance: rtol 1e-4, atol 1e-5
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=FIT_ATOL, rtol=FIT_RTOL)


@pytest.mark.parametrize("directed", [False, True])
def test_csr_arrays(directed):
    t, j = _graphs(directed=directed)
    for name in ("offsets", "targets", "weights"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_array_equal(t.degrees(), j.degrees())


@pytest.mark.parametrize("loader", ["load_delimited_edges",
                                    "load_weighted_edges"])
def test_edge_loaders(tmp_path, loader):
    path = tmp_path / "edges.csv"
    lines = ["// a comment", ""] + [f"{a},{b},{w:.3f}" for a, b, w in _edges()]
    path.write_text("\n".join(lines) + "\n")
    t = getattr(tgraph, loader)(str(path), N)
    j = getattr(jgraph, loader)(str(path), N)
    np.testing.assert_array_equal(t.targets, j.targets)
    np.testing.assert_array_equal(t.weights, j.weights)


@pytest.mark.parametrize("cls", ["RandomWalkIterator",
                                 "WeightedRandomWalkIterator"])
@pytest.mark.parametrize("seed", [3, 12345])
def test_walks_identical(cls, seed):
    t, j = _graphs()
    got = list(getattr(tgraph, cls)(t, 10, seed=seed, batch=16))
    want = list(getattr(jgraph, cls)(j, 10, seed=seed, batch=16))
    assert len(got) == len(want) == N
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[[w[0] for w in got].index(N - 1)].tolist() == [N - 1] * 11


@pytest.mark.parametrize("cls", ["RandomWalkIterator",
                                 "WeightedRandomWalkIterator"])
def test_no_edges_exception(cls):
    t, j = _graphs()
    with pytest.raises(TNoEdges) as te:
        list(getattr(tgraph, cls)(t, 5, no_edge_handling="exception"))
    with pytest.raises(JNoEdges) as je:
        list(getattr(jgraph, cls)(j, 5, no_edge_handling="exception"))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 0.25), (4.0, 0.5)])
def test_biased_walks_identical(p, q):
    t, j = _graphs()
    kw = dict(vector_size=D, walk_length=12, walks_per_vertex=2, p=p, q=q)
    got = tgraph.Node2Vec(device="cpu", **kw)._biased_walks(
        t, np.random.default_rng(5))
    want = jgraph.Node2Vec(**kw)._biased_walks(j, np.random.default_rng(5))
    assert len(got) == len(want) == 2 * N
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_degree_huffman_tree():
    t, j = _graphs()
    tw = tgraph.DeepWalk(vector_size=D, device="cpu")
    jw = jgraph.DeepWalk(vector_size=D)
    tw.initialize(t)
    jw.initialize(j)
    assert [(w.word, w.count, w.codes, w.points) for w in tw.sv.vocab.words] \
        == [(w.word, w.count, w.codes, w.points) for w in jw.sv.vocab.words]
    assert tw.sv.vocab.total_count == jw.sv.vocab.total_count


@pytest.mark.parametrize("weighted", [False, True])
def test_deepwalk_fit(weighted):
    t, j = _graphs()
    kw = dict(vector_size=D, window_size=4, batch_size=64, epochs=2)
    tw, jw = tgraph.DeepWalk(device="cpu", **kw), jgraph.DeepWalk(**kw)
    if weighted:
        tl = tw.fit(t, walks=tgraph.WeightedRandomWalkIterator(t, 10, seed=2))
        jl = jw.fit(j, walks=jgraph.WeightedRandomWalkIterator(j, 10, seed=2))
    else:
        tl, jl = tw.fit(t, 10), jw.fit(j, 10)
    _fit_close(tl, jl)
    _fit_close(tw.vectors, jw.vectors)
    _fit_close(tw.sv.syn1.numpy(), np.asarray(jw.sv.syn1))
    assert [v for v, _ in tw.vertices_nearest(3, 5)] == \
           [v for v, _ in jw.vertices_nearest(3, 5)]


def test_node2vec_fit():
    t, j = _graphs()
    kw = dict(vector_size=D, window_size=4, walk_length=10,
              walks_per_vertex=2, p=0.25, q=0.25, batch_size=64, epochs=2)
    tn, jn = tgraph.Node2Vec(device="cpu", **kw), jgraph.Node2Vec(**kw)
    tl, jl = tn.fit(t), jn.fit(j)
    assert tl[-1] < tl[0]
    _fit_close(tl, jl)
    _fit_close(tn.vectors, jn.vectors)
    _fit_close(tn.sv.syn1.numpy(), np.asarray(jn.sv.syn1))
    np.testing.assert_allclose(tn.similarity(1, 2), jn.similarity(1, 2),
                               atol=FIT_ATOL)


@pytest.mark.parametrize("cls", ["DeepWalk", "Node2Vec"])
def test_carried_tables(cls):
    """The reference's trained tables loaded into the port answer the
    lookup API as the reference does (vectors exactly; neighbours the same,
    similarities within 1e-6)."""
    t, j = _graphs()
    jm = getattr(jgraph, cls)(vector_size=D, batch_size=64)
    if cls == "DeepWalk":
        jm.fit(j, 8)
    else:
        jm.fit(j)
    tm = getattr(tgraph, cls)(vector_size=D, batch_size=64, device="cpu")
    with pytest.raises(RuntimeError):
        tm.load_tables(np.asarray(jm.sv.syn0), np.asarray(jm.sv.syn1))
    tm.initialize(t)
    tm.load_tables(np.asarray(jm.sv.syn0), np.asarray(jm.sv.syn1))
    np.testing.assert_array_equal(tm.get_vertex_vector(4),
                                  np.asarray(jm.get_vertex_vector(4)))
    got, want = tm.vertices_nearest(4, 6), jm.vertices_nearest(4, 6)
    assert [v for v, _ in got] == [v for v, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cls", ["DeepWalk", "Node2Vec"])
def test_no_card_no_device_raises(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tgraph, cls)()
