"""CUDA graphs of the prebuilt-executable store (deeplearning4j_torch/aot)
on the card: a captured step replays the eager function's results bit for
bit, a strict second boot captures from the store's records and nothing on
a call, and a release returns the graphs' memory. Each test needs a CUDA
card and skips without one; chip_smoke.py's ``[aot]`` phase runs the same
checks at full width on the H100. This file imports no JAX."""

import numpy as np
import pytest
import torch

from deeplearning4j_torch.aot import AotStore
from deeplearning4j_torch.aot.compile import AotFunction, graphable


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [aot] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


@graphable
def _mlp(weights, x):
    h = torch.relu(x.to(weights["w1"].device) @ weights["w1"])
    return torch.softmax(h @ weights["w2"], dim=-1), h.sum(-1)


def _weights(device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return {"w1": torch.randn(64, 128, generator=g).to(device),
            "w2": torch.randn(128, 32, generator=g).to(device)}


@pytest.mark.gpu
def test_replay_equals_eager_bit_for_bit(cuda, tmp_path):
    f = AotFunction(_mlp, tag="mlp", store=AotStore(str(tmp_path)),
                    device=cuda)
    w = _weights(cuda)
    for rows in (1, 4):
        f.warm(1, w, torch.zeros(rows, 64))
        for seed in range(3):
            x = torch.randn(rows, 64, generator=torch.Generator()
                            .manual_seed(seed))
            got = [t.clone() for t in f(1, w, x)]
            want = _mlp(w, x.to(cuda))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert f.captures == 2 and f.call_captures == 0 and f.replays == 6
    assert f.pool_bytes() > 0


@pytest.mark.gpu
def test_strict_second_boot_and_generations(cuda, tmp_path):
    store = AotStore(str(tmp_path))
    AotFunction(_mlp, tag="mlp", store=store, device=cuda).warm(
        1, _weights(cuda), torch.zeros(2, 64))
    f = AotFunction(_mlp, tag="mlp", store=store, device=cuda, strict=True)
    w1, w2 = _weights(cuda), _weights(cuda, seed=1)
    x = torch.ones(2, 64)
    f.warm(1, w1, x)
    f.warm(2, w2, x)  # a publish candidate
    assert torch.equal(f(1, w1, x)[0], _mlp(w1, x)[0])
    assert torch.equal(f(2, w2, x)[0], _mlp(w2, x)[0])
    assert f.generations() == [2] and f.call_captures == 0


def _graph_cycle(cuda, store):
    """Capture, replay and release one wrapper; returns the bytes
    allocated while its graph lived."""
    f = AotFunction(_mlp, tag="mlp", store=store, device=cuda)
    w = _weights(cuda)
    f.warm(1, w, torch.zeros(256, 64))
    f(1, w, torch.zeros(256, 64))
    del w
    live = torch.cuda.memory_allocated()
    f.release()
    np.testing.assert_equal(f.generations(), [])
    torch.cuda.synchronize()
    return live


@pytest.mark.gpu
def test_release_returns_the_graphs_memory(cuda, tmp_path):
    # the first cycle also makes what a process keeps for good (the
    # capture stream's library workspace); every later one returns all
    store = AotStore(str(tmp_path))
    _graph_cycle(cuda, store)
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        assert _graph_cycle(cuda, store) > base
        assert torch.cuda.memory_allocated() == base
