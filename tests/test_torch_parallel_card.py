"""Data parallelism on the card: a world-1 NCCL group's wrapper steps
against ``Trainer``'s, and the gradient codec on the card against the
CPU's. Each test needs a CUDA card and skips without one; chip_smoke.py's
``[parallel]`` phase runs the same checks on the H100 at full width. This
file imports no JAX."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_torch.nn import NetConfig, SequentialBuilder
from deeplearning4j_torch.nn import layers as L
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.parallel import compression as C


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [parallel] phase "
                    "runs these checks on the H100)")
    return torch.device("cuda")


@pytest.fixture
def nccl_world_1(cuda, tmp_path):
    from deeplearning4j_torch.parallel import distributed_init, make_mesh

    assert distributed_init(f"file://{tmp_path}/store", 1, 0, device=cuda)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def _net(device):
    net = (SequentialBuilder(NetConfig(seed=0, updater={
        "type": "adam", "learning_rate": 1e-2}), device=device)
           .input_shape(32).layer(L.Dense(n_out=64, activation="tanh"))
           .layer(L.Output(n_out=5, activation="softmax", loss="mcxent"))
           .build())
    net.init()
    return net


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["shared_gradients", "zero_sharded",
                                  "averaging", "encoded_gradients"])
def test_world_1_wrapper_steps_equal_trainer(nccl_world_1, mode):
    """3 steps of each mode on a world-1 NCCL group against 3 plain
    ``Trainer`` steps from the same params (the encoded mode at threshold
    0, full capacity, exact values)."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.parallel import ParallelWrapper
    from deeplearning4j_torch.train import Trainer

    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 32)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 48)]
    ref = Trainer(_net("cuda"))
    ref.fit(ArrayIterator(x, y, 16), epochs=1)
    kw = ({"threshold": 0.0, "capacity_frac": 1.0, "quantize": False}
          if mode == "encoded_gradients" else {})
    pw = ParallelWrapper(_net("cuda"), mesh=nccl_world_1, mode=mode, **kw)
    pw.fit(ArrayIterator(x, y, 16), epochs=1)
    for a, b in zip(tree_leaves(pw.model.params), tree_leaves(ref.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [True, False])
def test_codec_on_card_equals_cpu(cuda, quantize):
    rng = np.random.default_rng(1)
    n, k, t = 1 << 20, 1 << 15, 1e-3
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-3)
    r = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-4)
    enc_fn = C.threshold_encode if quantize else C.topk_encode
    dec_fn = C.threshold_decode if quantize else C.topk_decode
    e_cpu, r_cpu = enc_fn(g, t, k, r)
    e_gpu, r_gpu = enc_fn(g.to(cuda), t, k, r.to(cuda))
    assert int(e_gpu.count) == int(e_cpu.count)
    assert torch.equal(r_gpu.cpu(), r_cpu)
    assert torch.equal(dec_fn(e_gpu, size=n).cpu(), dec_fn(e_cpu, size=n))
