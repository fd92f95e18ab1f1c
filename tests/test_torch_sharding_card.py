"""Tensor and sequence parallelism on the card: a world-1 NCCL group's
``Trainer(mesh=, rules=TRANSFORMER_RULES)`` steps against ``Trainer``'s,
and the ring's schedule over 4 blocks on the flash kernels against one
``flash_attention`` call over the whole sequence. Each test needs a CUDA
card and skips without one; chip_smoke.py's ``[tp_sp]`` phase runs the
same checks on the H100 at full width. This file imports no JAX."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_torch.ops.updaters import tree_leaves


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [tp_sp] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


@pytest.fixture
def nccl_world_1(cuda, tmp_path):
    from deeplearning4j_torch.parallel import distributed_init, make_mesh

    assert distributed_init(f"file://{tmp_path}/store", 1, 0, device=cuda)
    try:
        yield make_mesh({"data": 1, "model": 1, "seq": 1})
    finally:
        dist.destroy_process_group()


def _lm():
    from deeplearning4j_torch.models import CausalLM

    m = CausalLM(seed=0, input_shape=(128,), num_layers=2, d_model=256,
                 num_heads=4, vocab=512, flash=True, ring=True,
                 device="cuda").build()
    m.config.compute_dtype = "bfloat16"
    m.init(seed=0)
    return m


@pytest.mark.gpu
def test_world_1_rules_trainer_equals_trainer(nccl_world_1):
    """3 steps of Trainer(mesh=, rules=TRANSFORMER_RULES) on a world-1
    group (every collective through the group) against 3 plain Trainer
    steps from the same params: at one rank each collective passes its
    operand through, so the params are bit-equal."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.parallel import TRANSFORMER_RULES
    from deeplearning4j_torch.train import Trainer

    rng = np.random.default_rng(0)
    x = rng.integers(0, 512, (12, 128)).astype(np.int32)
    y = rng.integers(0, 512, (12, 128)).astype(np.int32)
    ref = Trainer(_lm())
    ref.fit(ArrayIterator(x, y, 4), epochs=1)
    tr = Trainer(_lm(), mesh=nccl_world_1, rules=TRANSFORMER_RULES)
    tr.fit(ArrayIterator(x, y, 4), epochs=1)
    for a, b in zip(tree_leaves(tr.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_blocks_on_kernels_equal_flash(cuda, dtype, causal):
    """The ring over 4 blocks of 64 (K1 a held block, K2 and K3 a block's
    gradient) against flash_attention over the whole 256: f32 within
    1e-5; bf16 within 2e-2 (each block's output is rounded to bf16 before
    the f32 merge, where one call rounds once)."""
    from deeplearning4j_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_fwd_cuda)
    from deeplearning4j_torch.parallel import ring_attention_blocks

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, cot = (torch.randn((2, 256, 4, 64), generator=g, device=cuda)
                    .to(dtype) for _ in range(4))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = [w.launches for w in (flash_fwd_cuda, flash_bwd_dq_cuda,
                                   flash_bwd_dkv_cuda)]
    o = ring_attention_blocks(*a, 4, causal=causal)
    (o.float() * cot.float()).sum().backward()
    launched = [w.launches - c for w, c in zip(
        (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda), counts)]
    f = flash_attention(*b, causal=causal)
    (f.float() * cot.float()).sum().backward()
    assert launched == [10 if causal else 16] * 3
    torch.testing.assert_close(o.float(), f.float(), rtol=tol, atol=tol)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad.float(), y.grad.float(), rtol=tol,
                                   atol=tol)
