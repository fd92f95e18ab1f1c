#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero without its
last line):

1. build — compile every CUDA kernel of the port from ``deeplearning4j_torch/
   kernels/csrc`` with nvcc for sm_90a, one nvcc per source side by side,
   print each kernel's registers and spills (gated: none for the Hopper
   kernels of K1, K2 and K3 at D 64, none in any BatchNorm kernel) and the
   card.
2. kernels — each kernel against its plain PyTorch version on the card:
   the flash forward (K1) and the flash backward's dQ (K2) and dK/dV (K3)
   passes in f32 and bf16, several head dims, ragged T, causal, windows,
   lengths (a 0 among them) and a key mask with a hole; K1 also over its
   Hopper kernel's edges (bf16 D 64 and 128: T = 1 and below a tile, T
   off the tile grid, lengths either side of a tile edge, windows of 1,
   64 and 200); K2 and K3 likewise over their Hopper kernels' edges
   (``BWD_EDGE_CASES``, a scale <= 0, and two launches bit-identical);
   the column broadcast probe (K5) bit for bit. Then K1 at the serving
   shape and K2, K3 at the training shape, timed beside the plain version
   and the PyTorch library call (each time the median of one call at a
   time between two CUDA events; also with 20 calls back to back between
   the events, which leaves out the host's launch work).
3. serve — a 738M-parameter CausalLM (12 layers, d_model 2048, 32 heads,
   vocab 32000, T 1024, learned positions, bf16 compute, flash attention)
   with random weights from seed 0, served through ``ServeEngine`` to 12
   requests from 4 threads. Launch counts are zeroed just before and read
   just after: every engine batch must launch the flash kernel once per
   layer.
4. generate — the same model through ``nn.generation.decode_forward``, the
   continuous batcher and the HTTP server. Gated in f32 compute (TF32
   off): two prompts (200 and 333 tokens) prefilled in chunks of 64 then
   32 single-token steps, every log-prob within GEN_LOGP_TOL of one full
   forward (K1) over the same tokens, through dense and through paged
   caches, the paged ``cache_read`` bit-equal to the dense one; the paged
   batcher (4 slots, capacity 1024, block 16, chunks of 64, prefix cache)
   serving 6 greedy requests of 64-700 prompt tokens, 32 new each, every
   token the argmax of a full forward teacher-forced on its row unless the
   top-two gap there is at most GEN_GAP_TOL (a random-weight model's
   argmax has near-ties: such steps are counted and skipped); a prefix
   adopted; a fork's tokens equal to the parent's tail; the dense
   batcher's tokens under the same rule against their own rows' forwards.
   Measured in bf16, a smoke load with no published source: the paged
   batcher at 8 slots serving 32 requests (prompts 64-768, 64 new tokens,
   8 sharing a 256-token prefix, half sampled at temperature 0.8, top_k
   40) from 4 client threads: tokens/s, time to first token and
   inter-token p50/p99 read by the clients, decode tick on the host clock
   (the batcher's histogram) and replayed on the device (torch.profiler,
   CUDA events) beside its bound, prefill chunk times, KV blocks, prefix
   hits, shapes run, peak memory. Then a ``ModelServer``
   on 127.0.0.1: SSE and buffered ``/generate`` (tokens equal to the
   batcher's under the gap rule, gap from a bf16 full forward),
   ``/predict``, ``/health``, ``/ready``, ``/metrics``, and a drain that
   answers 503 on ``/ready`` while an admitted stream finishes. The
   batcher launches no kernel (its attention is the reference's dense
   einsums); K1 launches in the checks' full forwards are counted.
5. flash vs dense — the same params through the dense attention path on one
   4 x 1024 batch: in bf16 (the served precision; reported) and in f32
   (gated: top-1 agreement at least 99%).
6. train — the same model trained by ``Trainer(model).fit`` (adamw, bf16
   compute, f32 head) for 12 steps on one repeated 4 x 1024 batch of
   random tokens and labels: 2 warm-up steps in one fit, the other 10 in
   a second fit timed as one window. Launch counts are zeroed just before
   and read just after: every step launches K1, K2 and K3 once per layer.
   Gated: every loss finite, the last below the first. Printed: step time
   (window / steps), tokens/s, model FLOP per step, MFU and peak memory,
   and where a step's time goes (forward, backward, the f32 head, the
   updater, each timed alone).
7. flash vs dense gradients — a 2-layer model of the same width, one
   2 x 1024 batch: in f32 every param's gradient within 1e-3 of the dense
   path's, relative to its largest entry (gated); bf16 reported.
8. bn kernels — BatchNorm's backward kernels, K4a (per-channel Σdy and
   Σdy·x, on each of its routes) and K4b (dx), K4a's fused mode (its
   per-channel outputs bit-equal to ``bn_backward_coeffs_reference``) and
   their composition ``bn_bwd`` against the plain versions over a case
   list (f32 and bf16, C from 5 to 2048, M from 1 and not a multiple of any
   block, a constant channel; two launches bit-identical; the first case
   again after the others), then at the microbench's shape (bf16, M =
   128·56·56, C = 256, seed 0), timed one call at a time and back to back
   beside the plain versions, the whole BatchNorm backward as a step runs
   it and the library's BatchNorm backward, with the device operations of
   one BatchNorm backward counted under torch.profiler.
9. resnet — ``ResNet50(num_classes=1000, seed=0, input_shape=(224, 224,
   3))`` (bf16 compute, f32 params, adam 1e-3) trained by
   ``Trainer(model).fit`` on ``BenchmarkIterator`` batches of 128 for 12
   steps: 2 warm-up steps in one fit, 10 in a second fit timed as one
   window. Launch counts are zeroed before and read after: every step
   launches the fused K4a and K4b once per BatchNorm (53). Gated: losses
   finite and the last below the first; every running mean and var finite
   and changed. Printed: step time, images/s, model FLOP and MFU, peak
   memory, where a step's time goes (forward, backward, K4a, K4b and the
   whole BatchNorm backward at every BatchNorm's shape, one call at a time
   and back to back, adam), a step with the batch already on the card, and
   the card's busy share and device operations a step over 3 steps under
   torch.profiler.
10. resnet gradients — the same model in f32 on one batch of 8: every
   param's gradient through K4a/K4b within 1e-3 of the plain BN
   backward's, relative to the largest entry of its node (gated).

Prints a JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Needs one CUDA card.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
F32_TOL = 1e-5                  # kernel vs plain, f32: abs and rel
BF16_ATOL, BF16_RTOL = 8e-3, 1e-2   # kernel vs plain, bf16 o (max seen 3.9e-3)
# backward kernels vs plain, bf16 dq/dk/dv: both round ds and p to bf16,
# and a score that lands on the other side of a rounding boundary moves
# one product by an ulp (max seen 3.9e-3 on entries up to 6.6)
BWD_BF16_ATOL, BWD_BF16_RTOL = 1e-2, 1e-2
GRAD_RTOL = 1e-3                # f32 flash vs dense gradient, per param
TRAIN_STEPS, TRAIN_WARMUP = 12, 2
# engine vs direct forward, relative per probability: a request served in a
# padded batch meets other GEMM shapes than alone, and a bf16 rounding that
# flips there carries through 12 layers; a wrong row or time slice is off
# by more than 100% (the control below shows it)
ENGINE_RTOL = 0.1
FLASH_DENSE_RTOL = 1e-3         # f32 probabilities, flash vs dense path


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_b2b_ms(fn, reps: int = 20, warmup: int = 3, rounds: int = 3) -> float:
    """Device time of one call with ``reps`` calls back to back between two
    CUDA events, the median of ``rounds`` such rounds. The host's launch
    work then overlaps the device's run, so a kernel that runs longer than
    its launch is timed alone; ``time_ms`` includes that launch work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_build():
    from deeplearning4j_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] {len(libs)} kernel source(s) in {dt:.2f} s: "
          + ", ".join(p.name for p in libs))
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line
                    or "Performance Loss" in line):
                print(f"[build] {name}: {line.strip()}")
    for source, kernel in SM90_GATED:
        spills = sm90_spills(_build.build_log(source), 64, kernel)
        check(spills == "0 bytes spill stores, 0 bytes spill loads",
              f"{kernel} at D 64 spills: {spills!r}")
    for kernel in BN_GATED:
        spills = kernel_spills(_build.build_log("bn_bwd"), kernel)
        check(bool(spills) and all(
            v == "0 bytes spill stores, 0 bytes spill loads" for v in spills),
            f"{kernel} spills (or was not reported): {spills!r}")
    print(f"[build] card: {card()}")


# (source, kernel) of the Hopper kernels whose D 64 build must not spill
SM90_GATED = (("flash_fwd_sm90", "flash_fwd_sm90_kernel"),
              ("flash_bwd_sm90", "flash_bwd_dq_sm90_kernel"),
              ("flash_bwd_sm90", "flash_bwd_dkv_sm90_kernel"))


# the BatchNorm kernels of bn_bwd.cu whose builds (every instantiation)
# must not spill
BN_GATED = ("bn_reduce_bulk_kernel", "bn_reduce_scalar_kernel",
            "bn_dx_kernel")


def kernel_spills(log: str, kernel: str) -> list:
    """The spill counts that ``-Xptxas -v`` reports in ``log`` for every
    function whose mangled name holds ``kernel``."""
    out, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line and fn and kernel in fn:
            out.append(line.split(",", 1)[1].strip())
    return out


def sm90_spills(log: str, d: int, kernel: str = "flash_fwd_sm90_kernel") -> str:
    """The spill counts that ``-Xptxas -v`` reports in ``log`` for the
    Hopper kernel template ``kernel`` at head dim ``d`` ('' if not
    found)."""
    fn = None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line and fn and f"{kernel}ILi{d}E" in fn:
            return line.split(",", 1)[1].strip()
    return ""


# the kernels' case list: (dtype, BH, T, D, causal, window, lengths,
# key-mask hole)
KERNEL_CASES = [
    (torch.float32, 6, 200, 16, False, 0, None, False),
    (torch.float32, 6, 200, 64, True, 0, None, False),
    (torch.float32, 4, 130, 128, True, 37, None, False),
    (torch.float32, 6, 150, 32, True, 0, [150, 0, 77, 1, 64, 149], False),
    (torch.float32, 4, 100, 64, False, 0, None, True),
    (torch.bfloat16, 6, 200, 16, True, 0, None, False),
    (torch.bfloat16, 4, 333, 64, False, 0, None, False),
    (torch.bfloat16, 4, 200, 128, True, 0, [200, 0, 65, 130], False),
    (torch.bfloat16, 4, 190, 64, True, 50, None, True),
]

# K1's edges, forward only: bf16 at D 64 and 128 runs flash_fwd_sm90.cu
# (128 query rows a CTA; 128 keys a tile at D 64, 64 at D 128), bf16 at D 32
# stays on flash_fwd.cu. T below a tile and T = 1; T off the tile grid; BH 1;
# lengths 0, 1 and either side of a tile edge; a key-mask hole; windows of
# 1, 64 and 200; causal and not.
FWD_EDGE_CASES = [
    (torch.bfloat16, 3, 1, 64, True, 0, None, False),
    (torch.bfloat16, 3, 100, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1, 128, False, 0, None, False),
    (torch.bfloat16, 3, 50, 128, True, 0, None, False),
    (torch.bfloat16, 4, 333, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1000, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1000, 64, False, 0, None, False),
    (torch.bfloat16, 2, 1000, 128, True, 0, None, False),
    (torch.bfloat16, 2, 333, 128, False, 0, None, False),
    (torch.bfloat16, 1, 257, 64, True, 0, None, False),
    (torch.bfloat16, 1, 257, 128, True, 0, None, False),
    (torch.bfloat16, 5, 300, 64, True, 0, [0, 1, 127, 128, 129], False),
    (torch.bfloat16, 5, 300, 64, False, 0, [0, 1, 127, 128, 129], False),
    (torch.bfloat16, 5, 300, 128, False, 0, [0, 1, 127, 128, 129], False),
    (torch.bfloat16, 5, 300, 128, True, 0, [0, 1, 63, 64, 65], False),
    (torch.bfloat16, 4, 300, 64, True, 0, None, True),
    (torch.bfloat16, 3, 200, 128, False, 0, None, True),
    (torch.bfloat16, 3, 400, 64, True, 1, None, False),
    (torch.bfloat16, 3, 400, 64, True, 64, None, False),
    (torch.bfloat16, 3, 400, 64, True, 200, None, False),
    (torch.bfloat16, 3, 400, 128, True, 1, None, False),
    (torch.bfloat16, 3, 400, 128, True, 64, [400, 130, 7], False),
    (torch.bfloat16, 3, 400, 128, True, 200, None, True),
    (torch.bfloat16, 4, 200, 32, True, 0, [200, 0, 99, 150], False),
]


# K2 and K3's edges, backward only: bf16 at D 64 runs flash_bwd_sm90.cu
# (dK/dV: 128 keys a CTA, query tiles of 64; dQ: 128 queries a CTA, key
# tiles of 64), bf16 at D 128 stays on flash_bwd.cu. T = 1 and below a
# tile; T off the tile grid; BH 1; lengths 0, 1 and either side of 64 and
# 128; a key-mask hole; windows of 1, 64 and 200; causal and not.
BWD_EDGE_CASES = [
    (torch.bfloat16, 3, 1, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1, 128, False, 0, None, False),
    (torch.bfloat16, 3, 50, 64, False, 0, None, False),
    (torch.bfloat16, 3, 100, 128, True, 0, None, False),
    (torch.bfloat16, 2, 333, 64, True, 0, None, False),
    (torch.bfloat16, 2, 333, 64, False, 0, None, False),
    (torch.bfloat16, 2, 1000, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1000, 128, True, 0, None, False),
    (torch.bfloat16, 1, 257, 64, True, 0, None, False),
    (torch.bfloat16, 1, 257, 128, False, 0, None, False),
    (torch.bfloat16, 8, 300, 64, True, 0, [0, 1, 63, 64, 65, 127, 128, 129],
     False),
    (torch.bfloat16, 8, 300, 64, False, 0, [0, 1, 63, 64, 65, 127, 128, 129],
     False),
    (torch.bfloat16, 8, 300, 128, True, 0, [0, 1, 63, 64, 65, 127, 128, 129],
     False),
    (torch.bfloat16, 4, 300, 64, True, 0, None, True),
    (torch.bfloat16, 3, 200, 64, False, 0, None, True),
    (torch.bfloat16, 3, 200, 128, True, 0, None, True),
    (torch.bfloat16, 3, 400, 64, True, 1, None, False),
    (torch.bfloat16, 3, 400, 64, True, 64, None, False),
    (torch.bfloat16, 3, 400, 64, True, 200, [400, 130, 7], False),
    (torch.bfloat16, 3, 400, 128, True, 1, None, False),
    (torch.bfloat16, 3, 400, 128, True, 64, None, True),
    (torch.bfloat16, 3, 400, 128, True, 200, None, False),
]


def _qkv(gen, bh, t, d, dtype, n=3):
    return tuple(torch.randn((bh, t, d), generator=gen, device="cuda",
                             dtype=torch.float32).to(dtype) for _ in range(n))


def _masks(bh, t, lens, hole):
    """The case's lengths (int32) and key mask (int8) on the card, or None."""
    lens_t = (None if lens is None
              else torch.tensor(lens, dtype=torch.int32, device="cuda"))
    kmask = None
    if hole:
        kmask = torch.ones((bh, t), dtype=torch.int8, device="cuda")
        kmask[:, t // 3: t // 2] = 0     # a hole mid-sequence
        kmask[0, : t // 4] = 0           # and left padding on one row
    return lens_t, kmask


def _what(dt, bh, t, d, causal, window, lens, hole):
    return (f"{str(dt)[6:]} BH={bh} T={t} D={d} causal={causal} "
            f"window={window} lengths={lens} hole={hole}")


def _compare(o, lse, o_ref, lse_ref, what):
    atol, rtol = ((F32_TOL, F32_TOL) if o.dtype == torch.float32
                  else (BF16_ATOL, BF16_RTOL))
    err = (o.float() - o_ref.float()).abs()
    check(bool(torch.all(err <= atol + rtol * o_ref.float().abs())),
          f"{what}: o differs from the plain version (max abs err "
          f"{err.max().item():.3g}, tolerance {atol} abs + {rtol} rel)")
    live = lse_ref > -1e29
    lerr = (lse - lse_ref).abs()[live]
    check(lerr.numel() == 0 or bool(torch.all(
        lerr <= 1e-4 + F32_TOL * lse_ref[live].abs())),
        f"{what}: lse differs from the plain version")
    check(bool(torch.all(lse[~live] <= -1e29)),
          f"{what}: a fully masked row has a finite lse")
    return err.max().item()


def phase_kernels():
    from deeplearning4j_torch.ops.flash_attention import (
        _fwd_route, flash_attention_reference, flash_fwd_cuda)

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    for i, case in enumerate(KERNEL_CASES + FWD_EDGE_CASES):
        dt, bh, t, d, causal, window, lens, hole = case
        gen.manual_seed(i)
        q, k, v = _qkv(gen, bh, t, d, dt)
        lens_t, kmask = _masks(bh, t, lens, hole)
        scale = 1.0 / d ** 0.5
        o, lse = flash_fwd_cuda(q, k, v, lens_t, kmask, scale=scale,
                                causal=causal, window=window)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_reference(
            q, k, v, lens_t, kmask, scale=scale, causal=causal, window=window)
        what = f"{_what(*case)} ({_fwd_route(dt, d)})"
        err = _compare(o, lse, o_ref, lse_ref, what)
        print(f"[kernels] ok {what}: max abs err {err:.3g}")
    # a negative scale: the Hopper kernel then masks-tests every tile
    gen.manual_seed(99)
    q, k, v = _qkv(gen, 3, 300, 64, bf16)
    o, lse = flash_fwd_cuda(q, k, v, scale=-0.125, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_reference(q, k, v, scale=-0.125,
                                               causal=True)
    err = _compare(o, lse, o_ref, lse_ref, "bf16 D=64 scale=-0.125")
    print(f"[kernels] ok bf16 BH=3 T=300 D=64 causal scale=-0.125: max abs "
          f"err {err:.3g}")

    # the serving shape: batch 4 x 32 heads, T 1024, head dim 64, bf16
    bh, t, d = 128, 1024, 64
    gen.manual_seed(100)
    q, k, v = _qkv(gen, bh, t, d, bf16)
    scale = 1.0 / d ** 0.5
    o, lse = flash_fwd_cuda(q, k, v, scale=scale, causal=True)
    o_ref, lse_ref = flash_attention_reference(q, k, v, scale=scale,
                                               causal=True)
    err = _compare(o, lse, o_ref, lse_ref, "serving shape")
    del o_ref, lse_ref
    ms = time_ms(lambda: flash_fwd_cuda(q, k, v, scale=scale, causal=True))
    ms_b2b = time_b2b_ms(lambda: flash_fwd_cuda(q, k, v, scale=scale,
                                                causal=True))
    plain_ms = time_ms(lambda: flash_attention_reference(
        q, k, v, scale=scale, causal=True), reps=5, warmup=1)
    q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale))
    library_ms_b2b = time_b2b_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale))
    # least work the inputs need: each of q, k, v read once, o and lse
    # written once; 2 FLOP per multiply-add over the T(T+1)/2 causal pairs,
    # for q.k and for p.v
    nbytes = 4 * bh * t * d * q.element_size() + bh * t * 4
    flops = 2 * 2 * d * (t * (t + 1) // 2) * bh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    route = _fwd_route(bf16, d)
    row = {"name": "flash_fwd", "route": "cuda",
           "source": f"deeplearning4j_torch/kernels/csrc/{route}.cu",
           "replaces": "deeplearning4j_tpu/ops/flash_attention.py:41",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "design": "tma+wgmma",
           "tflops": flops / (ms * 1e-3) / 1e12, "ms_b2b": ms_b2b,
           "library_ms_b2b": library_ms_b2b,
           "tflops_b2b": flops / (ms_b2b * 1e-3) / 1e12}
    print(f"[kernels] serving shape BH={bh} T={t} D={d} bf16 causal "
          f"({route}): kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max abs err "
          f"{err:.3g}; back to back: kernel {ms_b2b:.4f} ms "
          f"({row['tflops_b2b']:.1f} TFLOP/s), sdpa {library_ms_b2b:.4f} ms")
    return row


def _bwd_compare(got, want, what):
    """dq, dk, dv of the kernels against the plain backward's; returns the
    largest abs error."""
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        atol, rtol = ((F32_TOL, F32_TOL) if a.dtype == torch.float32
                      else (BWD_BF16_ATOL, BWD_BF16_RTOL))
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {name}")
        err = (a.float() - b.float()).abs()
        check(bool(torch.all(err <= atol + rtol * b.float().abs())),
              f"{what}: {name} differs from the plain backward (max abs err "
              f"{err.max().item():.3g}, tolerance {atol} abs + {rtol} rel)")
        worst = max(worst, err.max().item())
    return worst


def _bwd_case(gen, case, seed, scale=None):
    """K2 and K3 on one case against the plain backward, from the plain
    forward's lse; keys past a length must get exactly 0. Returns the
    largest abs error."""
    from deeplearning4j_torch.ops.flash_attention import (
        _bwd_route, flash_attention_backward_reference,
        flash_attention_reference, flash_bwd_cuda)

    dt, bh, t, d, causal, window, lens, hole = case
    gen.manual_seed(seed)
    q, k, v, do = _qkv(gen, bh, t, d, dt, n=4)
    lens_t, kmask = _masks(bh, t, lens, hole)
    kw = dict(scale=1.0 / d ** 0.5 if scale is None else scale,
              causal=causal, window=window)
    o, lse = flash_attention_reference(q, k, v, lens_t, kmask, **kw)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_bwd_cuda(q, k, v, do, lse, delta, lens_t, kmask, **kw)
    torch.cuda.synchronize()
    want = flash_attention_backward_reference(q, k, v, do, lse, delta,
                                              lens_t, kmask, **kw)
    what = (f"bwd {_what(*case)}"
            + ("" if scale is None else f" scale={scale}")
            + f" ({_bwd_route(dt, d)})")
    err = _bwd_compare(got, want, what)
    if lens is not None:
        for b, n in enumerate(lens):
            check(bool((got[1][b, n:] == 0).all() and (got[2][b, n:] == 0).all()),
                  f"{what}: keys past the length got a gradient")
    print(f"[kernels] ok {what}: max abs err {err:.3g}")
    return err


def _bwd_deterministic(args, kw, what):
    """Two launches of K2 and K3 on the same inputs give the same bits."""
    from deeplearning4j_torch.ops.flash_attention import flash_bwd_cuda

    first = flash_bwd_cuda(*args, **kw)
    second = flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        check(torch.equal(a, b), f"{what}: two launches give different {name}")
    print(f"[kernels] ok {what}: two launches bit-identical (dq, dk, dv)")


def phase_bwd_kernels():
    """K2 and K3 against the plain backward over the K1 case list and their
    Hopper kernels' edges, two launches bit for bit, K5 bit for bit, then
    K2 and K3 timed at the training shape."""
    from deeplearning4j_torch.ops.flash_attention import (
        _bwd_route, column_broadcast_cuda, flash_attention_backward_reference,
        flash_attention_reference, flash_bwd_cuda, flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda)

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda")
    errs = {f32: 0.0, bf16: 0.0}
    for i, case in enumerate(KERNEL_CASES):
        errs[case[0]] = max(errs[case[0]], _bwd_case(gen, case, 200 + i))
    for i, case in enumerate(BWD_EDGE_CASES):
        errs[bf16] = max(errs[bf16], _bwd_case(gen, case, 500 + i))
    # a scale <= 0: the Hopper kernels then test every tile element by
    # element, as K1 does
    for i, scale in enumerate((-0.125, 0.0)):
        errs[bf16] = max(errs[bf16], _bwd_case(
            gen, (bf16, 3, 300, 64, True, 0, None, False), 600 + i, scale))
    print(f"[kernels] backward: largest abs err f32 {errs[f32]:.3g} (gate "
          f"{F32_TOL} abs + rel), bf16 {errs[bf16]:.3g} (gate "
          f"{BWD_BF16_ATOL} abs + {BWD_BF16_RTOL} rel)")
    # the same bits from two launches, under lengths and a window too
    gen.manual_seed(610)
    q, k, v, do = _qkv(gen, 3, 400, 64, bf16, n=4)
    lens_t, _ = _masks(3, 400, [400, 130, 7], False)
    kw = dict(scale=0.125, causal=True, window=200)
    o, lse = flash_attention_reference(q, k, v, lens_t, **kw)
    delta = (do.float() * o.float()).sum(-1)
    _bwd_deterministic((q, k, v, do, lse, delta, lens_t), kw,
                       "bwd bf16 BH=3 T=400 D=64 causal window=200 lengths")

    # K5, the (rows, 1) column broadcast probe, at the reference's shape
    gen.manual_seed(300)
    x = torch.randn((1, 512, 1), generator=gen, device="cuda")
    y = column_broadcast_cuda(x, 128)
    torch.cuda.synchronize()
    k5_err = (y - x.expand(1, 512, 128)).abs().max().item()
    check(k5_err == 0.0, f"K5 differs from x.expand by {k5_err:.3g}")
    k5_ms = time_ms(lambda: column_broadcast_cuda(x, 128))
    k5_plain = time_ms(lambda: x.expand(1, 512, 128).contiguous())
    k5_library = time_ms(lambda: x.repeat(1, 1, 128))
    k5_bytes = x.numel() * 4 + y.numel() * 4
    k5 = {"name": "column_broadcast", "route": "cuda",
          "source": "deeplearning4j_torch/kernels/csrc/flash_bwd.cu",
          "replaces": "scripts/debug_flashbwd.py:59",
          "launches": None, "on_main_path": False, "max_abs_err": k5_err,
          "ms": k5_ms, "plain_ms": k5_plain,
          "bound_ms": k5_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
          "library_ms": k5_library, "library": "x.repeat(1, 1, 128)"}
    print(f"[kernels] K5 (1, 512, 1) -> (1, 512, 128), max abs err {k5_err} "
          f"against x.expand: kernel {k5_ms:.4f} ms, plain (x.expand("
          f"...).contiguous()) {k5_plain:.4f} ms, library (x.repeat) "
          f"{k5_library:.4f} ms")

    # the training shape: batch 4 x 32 heads, T 1024, head dim 64, bf16
    bh, t, d = 128, 1024, 64
    gen.manual_seed(101)
    q, k, v, do = _qkv(gen, bh, t, d, bf16, n=4)
    kw = dict(scale=1.0 / d ** 0.5, causal=True)
    o, lse = flash_attention_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    got = flash_bwd_cuda(q, k, v, do, lse, delta, **kw)
    want = flash_attention_backward_reference(q, k, v, do, lse, delta, **kw)
    err = _bwd_compare(got, want, "training shape")
    del got, want
    _bwd_deterministic((q, k, v, do, lse, delta), kw, "training shape")
    dq_ms = time_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw))
    dkv_ms = time_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))
    dq_b2b = time_b2b_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                   **kw))
    dkv_b2b = time_b2b_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                     **kw))
    plain_ms = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, do, lse, delta, **kw), reps=5, warmup=1)
    # the library's backward for dq, dk and dv together: fwd+bwd through
    # autograd minus the forward, same inputs
    q4, k4, v4 = (a.view(1, bh, t, d).detach().requires_grad_()
                  for a in (q, k, v))
    do4 = do.view(1, bh, t, d)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                           scale=kw["scale"])

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                       scale=kw["scale"]).backward(do4)

    library_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
    library_ms_b2b = time_b2b_ms(sdpa_fwd_bwd) - time_b2b_ms(sdpa_fwd)
    pairs = t * (t + 1) // 2
    esize = q.element_size()
    route = _bwd_route(bf16, d)
    rows = []
    for name, ms, ms_b2b, flop_per_pair, n_out, replaces in (
            ("flash_bwd_dq", dq_ms, dq_b2b, 6, 1,
             "deeplearning4j_tpu/ops/flash_attention.py:278"),
            ("flash_bwd_dkv", dkv_ms, dkv_b2b, 8, 2,
             "deeplearning4j_tpu/ops/flash_attention.py:330")):
        # least work the inputs need: q, k, v, do read once, lse and delta
        # read once, the outputs written once; recomputing s and dp and
        # forming the outputs is 2 FLOP per multiply-add, D per product
        nbytes = (4 + n_out) * bh * t * d * esize + 2 * bh * t * 4
        flops = flop_per_pair * d * pairs * bh
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        rows.append({"name": name, "route": "cuda",
                     "source": f"deeplearning4j_torch/kernels/csrc/{route}.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": library_ms, "design": "tma+wgmma",
                     "tflops": flops / (ms * 1e-3) / 1e12, "ms_b2b": ms_b2b,
                     "library_ms_b2b": library_ms_b2b,
                     "tflops_b2b": flops / (ms_b2b * 1e-3) / 1e12,
                     "library": "scaled_dot_product_attention backward, "
                                "dq+dk+dv together",
                     "plain": "flash_attention_backward_reference, "
                              "dq+dk+dv together"})
        print(f"[kernels] training shape BH={bh} T={t} D={d} bf16 causal, "
              f"{name} ({route}): kernel {ms:.4f} ms "
              f"({rows[-1]['tflops']:.1f} TFLOP/s), back to back "
              f"{ms_b2b:.4f} ms ({rows[-1]['tflops_b2b']:.1f} TFLOP/s), bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); plain "
              f"backward (dq, dk, dv) {plain_ms:.4f} ms; max abs err "
              f"{err:.3g}")
    print(f"[kernels] training shape: K2 + K3 {dq_ms + dkv_ms:.4f} ms, back "
          f"to back {dq_b2b + dkv_b2b:.4f} ms; sdpa backward (dq, dk, dv) "
          f"{library_ms:.4f} ms, back to back {library_ms_b2b:.4f} ms")
    return rows + [k5]


# K4a/K4b case list: (dtype, M, C, constant channel); M not a multiple of
# any block, C from the stem's 64 to stage 4's 2048 (several channel
# chunks), C that takes only the scalar route (5, 12 in bf16), one row
BN_CASES = [
    (torch.float32, 1000, 64, False),
    (torch.float32, 4099, 256, True),
    (torch.float32, 777, 5, False),
    (torch.float32, 301, 2048, False),
    (torch.bfloat16, 4099, 64, True),
    (torch.bfloat16, 1003, 256, False),
    (torch.bfloat16, 301, 2048, False),
    (torch.bfloat16, 999, 12, False),
    (torch.bfloat16, 1, 64, False),
    (torch.bfloat16, 20011, 1024, False),
]
# K4a vs plain, per channel: both sum in f32 in different orders; the
# error is held to this share of the sum of the terms' magnitudes
BN_SUM_RTOL = 2e-5


def _bn_sums_check(got, x, dy, what):
    from deeplearning4j_torch.ops.batch_norm import bn_reduce_reference

    xf, dyf = x.float(), dy.float()
    for name, g, want, terms in zip(
            ("sum dy", "sum dy*x"), got, bn_reduce_reference(x, dy),
            (dyf, dyf * xf)):
        err = (g - want).abs()
        bound = BN_SUM_RTOL * terms.abs().sum(0) + 1e-6
        check(bool(torch.isfinite(g).all() and (err <= bound).all()),
              f"{what}: K4a {name} differs from the plain version (max abs "
              f"err {err.max().item():.3g})")


def _bn_offset(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary: the scalar routes' input at any width."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _bn_inputs(x, dy):
    """(x, dy, K4a's route) for each route these operands reach: as they
    are (bulk where a row is whole 16-byte vectors, fresh tensors being
    aligned), and, where that is bulk, an offset copy (scalar)."""
    fits = x.shape[1] * x.element_size() % 16 == 0
    out = [(x, dy, "bulk" if fits else "scalar")]
    if fits:
        out.append((_bn_offset(x), _bn_offset(dy), "scalar"))
    return out


def _bn_compare(x, dy, a, c1, c2, what):
    """K4a and K4b on every route the case reaches, and their composition,
    against the plain versions on one (M, C) case; returns the largest abs
    error of the composed dx against the plain composition."""
    from deeplearning4j_torch.ops import batch_norm
    from deeplearning4j_torch.ops.batch_norm import (
        bn_bwd, bn_bwd_reference, bn_dx, bn_dx_reference, bn_reduce)

    for xi, dyi, route in _bn_inputs(x, dy):
        before = bn_reduce.routes[route]
        s = bn_reduce(xi, dyi)
        dx = bn_dx(xi, dyi, a, c1, c2)
        torch.cuda.synchronize()
        check(bn_reduce.routes[route] == before + 1,
              f"{what}: K4a's route {route} was not the one launched")
        _bn_sums_check(s, xi, dyi, f"{what} route {route}")
        want = bn_dx_reference(xi, dyi, a, c1, c2)
        check(bool(torch.equal(dx, want)), f"{what}: K4b differs from the "
              f"plain version with K4a on route {route} (max abs err "
              f"{(dx.float() - want.float()).abs().max().item():.3g}; both "
              f"round the same ops in the same order)")
    s = torch.stack(bn_reduce(x, dy))
    again = torch.stack(bn_reduce(x, dy))
    composed = bn_bwd(x, dy, a)
    torch.cuda.synchronize()
    check(torch.equal(s, again), f"{what}: two K4a launches differ")
    # the composition, bit for bit: the plain composition fed K4a's own
    # sums computes c1 and c2 by the same ops from the same bits, and K4b
    # is bit-equal to its plain version
    own = batch_norm._bwd(x, dy, a, lambda *_: s, bn_dx_reference)
    err_own = (composed.float() - own.float()).abs().max().item()
    check(bool(torch.equal(composed, own)), f"{what}: bn_bwd differs from "
          f"the plain composition fed K4a's own sums (max abs err "
          f"{err_own:.3g})")
    # against the fully plain composition: K4a's sums are held above, this
    # is reported
    return (composed.float() - bn_bwd_reference(x, dy, a).float()).abs() \
        .max().item()


def _bn_saved(x, gamma):
    """The per-channel tensors that the training forward saves for x."""
    xf = x.float()
    mean = xf.mean(0)
    gap = (xf * xf).mean(0) - mean * mean
    var = torch.clamp(gap, min=0.0)
    inv = torch.rsqrt(var + 1e-5)
    a = inv if gamma is None else inv * gamma.float()
    return mean, var, inv, a, gap


def _bn_fused_compare(x, dy, gamma, what):
    """K4a's fused mode on every route the case reaches: the coefficients
    (K4b's a, c1, c2; dgamma, dbeta) bit for bit against
    bn_backward_coeffs_reference on K4a's own sums (the sums mode on the
    same inputs runs the same grid), two launches bit-identical, and
    bn_backward's dx against the plain K4b on those coefficients."""
    from deeplearning4j_torch.ops.batch_norm import (
        bn_backward, bn_backward_coeffs_reference, bn_dx_reference,
        bn_reduce, bn_reduce_coeffs)

    stats = _bn_saved(x, gamma)
    for xi, dyi, route in _bn_inputs(x, dy):
        before = bn_reduce_coeffs.routes[route]
        got = bn_reduce_coeffs(xi, dyi, *stats, gamma, 1e-5)
        again = bn_reduce_coeffs(xi, dyi, *stats, gamma, 1e-5)
        s1, s2 = bn_reduce(xi, dyi)
        torch.cuda.synchronize()
        check(bn_reduce_coeffs.routes[route] == before + 2,
              f"{what}: fused K4a's route {route} was not the one launched")
        want = bn_backward_coeffs_reference(s1, s2, *stats, gamma, 1e-5,
                                            x.shape[0], x.dtype)
        for name, g, w, g2 in zip(("a, c1, c2", "dgamma", "dbeta"), got,
                                  want, again):
            check((g is None) == (w is None) and (g is None or (
                torch.equal(g, w) and torch.equal(g, g2))),
                f"{what} route {route}: fused K4a's {name} differ from the "
                f"plain coefficient function on K4a's sums, or between two "
                f"launches")
        dx, _, _ = bn_backward(xi, dyi, gamma, *stats, 1e-5)
        torch.cuda.synchronize()
        check(torch.equal(dx, bn_dx_reference(xi, dyi, *got[0])),
              f"{what} route {route}: bn_backward's dx differs from the "
              f"plain K4b")


def phase_bn_kernels():
    """K4a on each of its routes, its fused mode, K4b and their composition
    against the plain versions over BN_CASES (two launches bit-identical;
    the first case again at the end, after other shapes' tickets), then at
    the microbench's shape (bf16, M = 128*56*56, C = 256, seed 0 as
    scripts/bn_reduce_bench.py draws it), timed beside the plain versions
    and the library's BatchNorm backward."""
    from deeplearning4j_torch.ops.batch_norm import (
        bn_dx_reference, bn_reduce, bn_reduce_coeffs, bn_reduce_reference)

    gen = torch.Generator(device="cuda")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    first = None
    for i, (dt, M, C, const) in enumerate(BN_CASES):
        gen.manual_seed(400 + i)
        x, dy = (torch.randn((M, C), generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        if const:
            x[:, 3] = 0.75
        a = torch.randn((C,), generator=gen, device="cuda").to(dt)
        c1, c2 = (1e-2 * torch.randn((C,), generator=gen, device="cuda")
                  for _ in range(2))
        gamma = (None, torch.bfloat16, torch.float32)[i % 3]
        if gamma is not None:
            gamma = (1 + 0.1 * torch.randn((C,), generator=gen,
                                           device="cuda")).to(gamma)
        what = f"{str(dt)[6:]} M={M} C={C} constant channel={const}"
        err = _bn_compare(x, dy, a, c1, c2, what)
        _bn_fused_compare(x, dy, gamma, f"{what} gamma="
                          f"{None if gamma is None else str(gamma.dtype)[6:]}")
        worst[dt] = max(worst[dt], err)
        if first is None:
            first = (x, dy, torch.stack(bn_reduce(x, dy)))
        print(f"[bn] ok {what}: routes "
              f"{'/'.join(r for _, _, r in _bn_inputs(x, dy))}, fused "
              f"coefficients bit-equal, two launches bit-identical, composed "
              f"dx bit-equal on K4a's sums; max abs err against the plain "
              f"composition {err:.3g}")
    x, dy, s = first
    check(torch.equal(torch.stack(bn_reduce(x, dy)), s), "K4a's first case "
          "gives other bits after the other shapes' calls (tickets not reset)")
    print(f"[bn] K4a routes launched: {bn_reduce.routes}; fused "
          f"{bn_reduce_coeffs.routes}")

    M, C = 128 * 56 * 56, 256
    rng = np.random.RandomState(0)
    x, dy = (torch.from_numpy(rng.randn(M, C).astype(np.float32)).cuda()
             .to(torch.bfloat16) for _ in range(2))
    a = torch.from_numpy(rng.randn(C).astype(np.float32)).cuda().to(
        torch.bfloat16)
    s_dy, s_dyx = bn_reduce_reference(x, dy)
    c1 = (s_dy * (1.0 / M)).to(x.dtype)
    c2 = (s_dyx * (2.0 / M)).to(x.dtype)
    err = _bn_compare(x, dy, a, c1, c2, "microbench shape")
    t = bn_timing(x, dy, a, c1, c2, nhw=(128, 56, 56))
    # K4a's fused mode, as the backward runs it, at the same shape
    gamma = (1 + 0.1 * torch.from_numpy(rng.randn(C).astype(np.float32))
             ).cuda().to(torch.bfloat16)
    _bn_fused_compare(x, dy, gamma, "microbench shape")
    stats = _bn_saved(x, gamma)

    def fused():
        bn_reduce_coeffs(x, dy, *stats, gamma, 1e-5)

    t["k4a_fused"] = time_ms(fused)
    t["k4a_fused_b2b"] = time_b2b_ms(fused)
    t["k4a_plain"] = time_ms(lambda: bn_reduce_reference(x, dy), reps=5,
                             warmup=1)
    t["k4b_plain"] = time_ms(lambda: bn_dx_reference(x, dy, a, c1, c2),
                             reps=5, warmup=1)
    rows = []
    for name, key, n_io, replaces in (
            ("bn_reduce", "k4a", 2, "scripts/bn_reduce_bench.py:41"),
            ("bn_dx", "k4b", 3, "scripts/bn_reduce_bench.py:68")):
        # least work: x and dy read once (and dx written once); a few f32
        # FLOP per element on the CUDA cores
        nbytes = n_io * M * C * x.element_size() + (2 if n_io == 2 else 3) \
            * C * 4
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = 3 * M * C / PEAK_F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_torch/kernels/csrc/bn_bwd.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": t[key], "plain_ms": t[key + "_plain"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library"], "ms_b2b": t[key + "_b2b"],
            "library_ms_b2b": t["library_b2b"],
            "whole_bn_backward_ms": t["bwd"],
            "whole_bn_backward_ms_b2b": t["bwd_b2b"],
            "library": "native_batch_norm_backward (dx, dgamma, dbeta), "
                       "K4a + K4b together"})
        print(f"[bn] microbench shape M={M} C={C} bf16, {name}: kernel "
              f"{t[key]:.4f} ms, back to back {t[key + '_b2b']:.4f} ms, "
              f"plain {t[key + '_plain']:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB); composed dx max abs err {err:.3g}")
    rows[0]["ms_fused"] = t["k4a_fused"]
    rows[0]["ms_fused_b2b"] = t["k4a_fused_b2b"]
    print(f"[bn] microbench shape, K4a fused (sums and per-channel algebra, "
          f"as the backward runs it): {t['k4a_fused']:.4f} ms, back to back "
          f"{t['k4a_fused_b2b']:.4f} ms")
    print(f"[bn] microbench shape: K4a + K4b {t['k4a'] + t['k4b']:.4f} ms, "
          f"back to back {t['k4a_b2b'] + t['k4b_b2b']:.4f} ms; BatchNorm "
          f"backward as the step runs it (autograd.grad of batch_norm_train's"
          f" y: dx, dgamma, dbeta) {t['bwd']:.4f} ms, back to back "
          f"{t['bwd_b2b']:.4f} ms; library (native_batch_norm_backward) "
          f"{t['library']:.4f} ms, back to back {t['library_b2b']:.4f} ms")
    ops = _device_ops(t["bwd_fn"])
    print(f"[bn] device operations in one BatchNorm backward at the "
          f"microbench shape: {ops}")
    print(f"[bn] composed dx largest abs err: f32 {worst[torch.float32]:.3g}, "
          f"bf16 {worst[torch.bfloat16]:.3g}")
    return rows


def bn_backward_fn(x, dy):
    """One training-mode BatchNorm backward as a ResNet-50 step runs it:
    ``torch.autograd.grad`` of ``batch_norm_train``'s y over (x, gamma,
    beta), gamma and beta in x's dtype as the bf16 Graph casts them; the
    graph is kept, so each call runs the backward alone."""
    from deeplearning4j_torch.ops.batch_norm import batch_norm_train

    C = x.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(11)
    g = (1 + 0.1 * torch.randn((C,), generator=gen, device="cuda")).to(
        x.dtype).requires_grad_()
    b = (0.1 * torch.randn((C,), generator=gen, device="cuda")).to(
        x.dtype).requires_grad_()
    xr = x.detach().requires_grad_()
    y, _, _ = batch_norm_train(xr, g, b, 1e-5)
    return lambda: torch.autograd.grad(y, (xr, g, b), dy, retain_graph=True)


def bn_library_fn(x, dy, nhw=None):
    """The library's BN backward (dx, dgamma, dbeta of a standard BN in one
    call) on (M, C) x and dy viewed as channels_last NCHW, (N, H, W) =
    ``nhw`` (default (1, M, 1))."""
    M, C = x.shape
    n, h, w = nhw or (1, M, 1)
    x4, dy4 = (t.view(n, h, w, C).permute(0, 3, 1, 2) for t in (x, dy))
    mean = x.float().mean(0)
    invstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    weight = torch.ones(C, device="cuda")
    return lambda: torch.ops.aten.native_batch_norm_backward(
        dy4, x4, weight, None, None, mean, invstd, True, 1e-5, [True, True, True])


def bn_timing(x, dy, a, c1, c2, reps=20, nhw=None):
    """K4a, K4b, the whole BatchNorm backward and the library's, each one
    call at a time (``time_ms``) and back to back (``time_b2b_ms``), on
    (M, C) x, dy. Uses only ``bn_reduce``, ``bn_dx`` and
    ``batch_norm_train``, so it times an older tree's kernels too."""
    from deeplearning4j_torch.ops.batch_norm import bn_dx, bn_reduce

    out = {}
    for key, fn in (("k4a", lambda: bn_reduce(x, dy)),
                    ("k4b", lambda: bn_dx(x, dy, a, c1, c2)),
                    ("bwd", bn_backward_fn(x, dy)),
                    ("library", bn_library_fn(x, dy, nhw))):
        out[key] = time_ms(fn, reps=reps)
        out[key + "_b2b"] = time_b2b_ms(fn, reps=reps)
        out[key + "_fn"] = fn
    return out


def device_ms(fn, reps: int = 10):
    """(ms, operations) of device work per call of ``fn``: the summed
    durations of the device events that torch.profiler's CUDA activity
    records over ``reps`` calls back to back, and their count, each over
    ``reps``; host work is left out. (nan, 0) where it records none."""
    from torch.profiler import ProfilerActivity

    ev = _on_card(_profiled(fn, [ProfilerActivity.CUDA], reps))
    if not ev:
        return float("nan"), 0.0
    us = sum(e.time_range.end - e.time_range.start for e in ev)
    return us / 1e3 / reps, len(ev) / reps


def bn_shape_times(shapes, reps=10):
    """``bn_timing`` and ``device_ms`` of K4a, K4b, the whole BatchNorm
    backward and the library's at every distinct (M, C) of ``shapes``
    (bf16, random inputs), as {(M, C): {key: ms}}. Uses only
    ``bn_reduce``, ``bn_dx`` and ``batch_norm_train``, so it times an older
    tree's kernels too."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for M, C in shapes:
        if (M, C) in out:
            continue
        xb, dyb = (torch.randn((M, C), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(2))
        cv = torch.randn((C,), generator=gen, device="cuda")
        tm = bn_timing(xb, dyb, cv, cv, cv, reps=reps)
        row = {k: v for k, v in tm.items() if not k.endswith("_fn")}
        for key in ("k4a", "k4b", "bwd", "library"):
            row[key + "_dev"], row[key + "_ops"] = device_ms(tm[key + "_fn"])
        out[(M, C)] = row
        del xb, dyb, tm
    return out


def print_bn_shapes(shapes, per_shape, tag):
    """The per-shape table of ``bn_shape_times`` and its sums over
    ``shapes`` (one entry per BatchNorm)."""
    tot = {k: sum(per_shape[sh][k] for sh in shapes)
           for k in next(iter(per_shape.values()))}
    elems = sum(M * C for M, C in shapes)
    # K4a reads x and dy, K4b reads them and writes dx: 5 bf16 tensors of
    # (M, C) a BatchNorm; the function itself needs only 3 (x, dy read once,
    # dx written once)
    bound = 5 * 2 * elems / PEAK_BYTES_PER_S * 1e3
    bound_fn = 3 * 2 * elems / PEAK_BYTES_PER_S * 1e3
    print(f"[{tag}] over the {len(shapes)} BatchNorms, back to back: K4a "
          f"{tot['k4a_b2b']:.2f} ms, K4b {tot['k4b_b2b']:.2f}, K4a + K4b "
          f"{tot['k4a_b2b'] + tot['k4b_b2b']:.2f} (bound {bound:.2f}); on the "
          f"device (profiler) K4a {tot['k4a_dev']:.2f}, K4b "
          f"{tot['k4b_dev']:.2f}, K4a + K4b "
          f"{tot['k4a_dev'] + tot['k4b_dev']:.2f}; whole BatchNorm backward "
          f"{tot['bwd']:.2f} ms, back to back {tot['bwd_b2b']:.2f}, on the "
          f"device {tot['bwd_dev']:.2f} in {tot['bwd_ops']:.0f} device "
          f"operations (the function's bound {bound_fn:.2f}); library BN "
          f"backward {tot['library']:.2f}, back to back "
          f"{tot['library_b2b']:.2f}, on the device {tot['library_dev']:.2f}")
    print(f"[{tag}] per (M, C) x count, ms one call / back to back / on the "
          f"device: K4a; K4b; whole BN backward (device operations); "
          f"library; bytes bounds of K4a, K4b -- " + "; ".join(
              f"{M}x{C} x{shapes.count((M, C))} "
              f"{v['k4a']:.4f}/{v['k4a_b2b']:.4f}/{v['k4a_dev']:.4f}, "
              f"{v['k4b']:.4f}/{v['k4b_b2b']:.4f}/{v['k4b_dev']:.4f}, "
              f"{v['bwd']:.4f}/{v['bwd_b2b']:.4f}/{v['bwd_dev']:.4f} "
              f"({v['bwd_ops']:.0f}), "
              f"{v['library']:.4f}/{v['library_b2b']:.4f}/"
              f"{v['library_dev']:.4f}, "
              f"{4 * M * C / PEAK_BYTES_PER_S * 1e3:.4f}, "
              f"{6 * M * C / PEAK_BYTES_PER_S * 1e3:.4f}"
              for (M, C), v in per_shape.items()))
    return tot, bound


def phase_bn_shapes():
    """K4a, K4b and the whole BatchNorm backward at the (M, C) of every
    BatchNorm of the bf16 ResNet-50 at batch 128, timed alone, without
    training: the per-shape reading that an A/B of two trees compares in
    one call (``python3 -c "import chip_smoke as c; c.phase_bn_shapes()"``
    in each tree's root)."""
    shapes = [(M, C) for _, M, C in _bn_nodes(_resnet50("bfloat16"),
                                               RN_BATCH)]
    print_bn_shapes(shapes, bn_shape_times(shapes), "bn shapes")
    print(card())


def _profiled(fn, activities, reps: int = 1):
    """torch.profiler over ``reps`` calls of ``fn``: the profile of the
    active step of a session that first traces one warm-up step and drops
    it (a session that is not the process's first was seen to lose the
    first kernels it should record)."""
    from torch.profiler import profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return prof


def _on_card(prof):
    """The device events of a profile, without the step's own annotation
    (``ProfilerStep*``, which spans the whole step on the card's timeline
    when CPU activity is traced)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def _device_ops(fn):
    """The device operations (kernels, copies, sets) that torch.profiler's
    CUDA activity records in one call of ``fn``, as 'N: name, name, ...';
    where it records none, the top-level aten calls on the host instead,
    said so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    prof = _profiled(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    dev = [e.name for e in _on_card(prof)]
    events = list(prof.events())
    if dev:
        return f"{len(dev)} on the card: " + ", ".join(n[:48] for n in dev)
    host = [e.name for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::")
            and (e.cpu_parent is None
                 or e.cpu_parent.name.startswith("ProfilerStep"))]
    return (f"profiler recorded no device events; {len(host)} top-level aten "
            f"calls on the host: " + ", ".join(host))


def _lm(flash: bool):
    from deeplearning4j_torch.models import CausalLM

    model = CausalLM(seed=0, input_shape=(1024,), num_layers=12,
                     d_model=2048, num_heads=32, vocab=32000,
                     flash=flash).build()
    model.config.compute_dtype = "bfloat16"
    return model


def phase_serve(model):
    from deeplearning4j_torch.ops.flash_attention import flash_fwd_cuda
    from deeplearning4j_torch.serve import ServeEngine

    eng = ServeEngine(model, batch_buckets=(1, 2, 4),
                      length_buckets=(256, 1024))
    rng = np.random.RandomState(0)
    reqs = [rng.randint(0, 32000, (1, int(rng.randint(100, 1025))))
            .astype(np.int32) for _ in range(12)]
    answers, lat, errors = [None] * 12, [None] * 12, []

    def client(ids):
        for i in ids:
            try:
                t0 = time.perf_counter()
                answers[i] = eng.predict(reqs[i])
                lat[i] = time.perf_counter() - t0
            except Exception as e:  # reported below, fails the phase
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    flash_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(range(c, 12, 4),))
                   for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        launches = flash_fwd_cuda.launches
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "clients hung")
    finally:
        eng.shutdown()
    check(not errors, "; ".join(errors))
    batches = int(eng.metrics.counter("serve_batches_total").value)
    check(batches > 0 and launches == 12 * batches,
          f"flash kernel launched {launches} times for {batches} batches "
          f"of a 12-layer model")
    for x, y in zip(reqs, answers):
        check(y.shape == (1, x.shape[1], 32000),
              f"answer shape {y.shape} for a request of {x.shape}")
        check(bool(np.isfinite(y).all()), "non-finite probabilities")
        check(float(np.abs(y.sum(-1) - 1.0).max()) <= 2e-2,
              "probabilities do not sum to 1")
    lat_ms = sorted(1e3 * s for s in lat)
    dev_s = eng.metrics.histogram("serve_device_seconds")
    print(f"[serve] {len(reqs)} requests answered in {batches} batches, "
          f"{wall:.3f} s wall; latency p50 {np.percentile(lat_ms, 50):.1f} ms "
          f"p99 {np.percentile(lat_ms, 99):.1f} ms; flash launches "
          f"{launches} (12 per batch)")
    # every answer against its request run alone through model.forward;
    # the control holds each answer against the next request's direct
    # output (their common prefix), which the limit must reject
    direct = [model.output(x).cpu().numpy() for x in reqs]

    def rel_gap(y, ref):
        n = min(y.shape[1], ref.shape[1])
        return float((np.abs(y[:, :n] - ref[:, :n]) / ref[:, :n]).max())

    own = [rel_gap(y, ref) for y, ref in zip(answers, direct)]
    other = min(rel_gap(y, direct[(i + 1) % 12])
                for i, y in enumerate(answers))
    print(f"[serve] engine vs direct, max rel diff per request: "
          + " ".join(f"{g:.3g}" for g in own)
          + f"; control (another request's output) least {other:.3g}")
    check(max(own) <= ENGINE_RTOL, "an engine answer differs from "
          "model.forward on its request")
    check(other > ENGINE_RTOL, "the engine-vs-direct limit accepts another "
          "request's output")
    del direct
    # where a full batch's time goes: the forward on the card alone, against
    # the engine's forward-and-copy-back time per batch
    x4 = torch.from_numpy(np.random.RandomState(2).randint(
        0, 32000, (4, 1024)).astype(np.int32)).cuda()

    def fwd():
        with torch.inference_mode():
            model.forward(model.params, model.state, x4)

    print(f"[serve] 4 x 1024 forward on the card {time_ms(fwd, reps=5):.2f} "
          f"ms; engine batch (forward + result to host) mean "
          f"{1e3 * dev_s.sum / dev_s.count:.2f} ms over {dev_s.count}")
    return launches


def phase_flash_vs_dense(model):
    """Gated in f32 compute, where the two attention paths differ only by
    summation order: each probability within FLASH_DENSE_RTOL of the dense
    path's, and top-1 agreement of at least 99%. In bf16 (the served
    precision) they round at different places, and a random-weight model's
    near-uniform output makes its argmax ill-conditioned, so that
    comparison is reported, not gated."""
    dense = _lm(flash=False)
    x = np.random.RandomState(1).randint(0, 32000, (4, 1024)).astype(np.int32)
    for cdt in ("bfloat16", None):
        model.config.compute_dtype = dense.config.compute_dtype = cdt
        yf = model.output(x)
        yd = dense.output(x, model.params, model.state)
        diff = (yf - yd).abs().max().item()
        rel = ((yf - yd).abs() / yd).max().item()
        top1 = (yf.argmax(-1) == yd.argmax(-1)).float().mean().item()
        print(f"[flash-vs-dense] 4 x 1024, compute {cdt or 'float32'}: max "
              f"abs prob diff {diff:.3g}, max rel {rel:.3g}, top-1 "
              f"agreement {top1:.4f}")
        del yf, yd
    model.config.compute_dtype = "bfloat16"
    check(rel <= FLASH_DENSE_RTOL, f"f32 flash vs dense max rel diff "
          f"{rel:.3g}")
    check(top1 >= 0.99, f"f32 top-1 agreement {top1:.4f} < 0.99")


# --------------------------------------------------------------------------
# [generate]: KV-cache decode, the continuous batcher and the HTTP server
# on the served model. Gates run in f32 compute (TF32 off); a random-weight
# model's 32000-way argmax has near-ties, so a token gate applies the gap
# rule: a decoded token must be the argmax of a teacher-forced full forward
# over the row's own tokens unless the top-two log-prob gap there is at
# most the gap tolerance (such steps are counted and skipped, and the
# comparison goes on). Two token sequences compared with each other stop
# at their first difference, which must sit at such a near-tie.
GEN_LOGP_TOL = 1e-3     # f32 decode vs the full forward (K1, f32) per log-prob
GEN_GAP_TOL = 2e-3      # f32 token gates: 2 x GEN_LOGP_TOL
GEN_GAP_TOL_BF16 = 0.05  # bf16 HTTP tokens vs the batcher's (two decode shapes)
GEN_SLOTS, GEN_CAPACITY, GEN_BLOCK, GEN_CHUNK = 8, 1024, 16, 64


def _teacher_logp(model, seq):
    """Log-probs (T, V) of one full forward over ``seq`` through the flash
    path (K1), in the model's current compute dtype."""
    with torch.inference_mode():
        probs = model.output(np.asarray(seq, np.int32)[None])[0]
    return torch.log(probs.float())


def _top2(logp, rows):
    top = torch.topk(logp[rows], 2, dim=-1)
    vals = top.values.cpu().numpy()
    return top.indices[:, 0].cpu().numpy(), vals[:, 0] - vals[:, 1]


def _gap_rule(tokens, logp, tp, what, tol):
    """``tokens`` decoded after a prompt of ``tp`` against the log-probs of
    a forward teacher-forced on them: each the argmax of its row, except
    where the top-two gap there is <= ``tol`` (skipped). Returns (tokens
    compared, near-ties skipped)."""
    n = len(tokens)
    best, gap = _top2(logp, slice(tp - 1, tp - 1 + n))
    ties = int((gap <= tol).sum())
    for i, tok in enumerate(tokens):
        check(gap[i] <= tol or int(tok) == int(best[i]),
              f"{what}: token {i} is {int(tok)}, the reference's argmax is "
              f"{int(best[i])} by a top-two gap of {gap[i]:.3g} > {tol}")
    return n - ties, ties


def _teacher_gate(model, prompts, outs, what):
    """The gap rule over every row, each against its own teacher-forced
    f32 forward. Returns (forwards run, tokens compared, near-ties, the
    forwards' log-probs)."""
    compared, ties, logps = 0, 0, []
    for i, (p, o) in enumerate(zip(prompts, outs)):
        check(o.shape == (32,), f"{what} request {i} returned {o.shape}")
        lp = _teacher_logp(model, np.concatenate([p, o[:-1]]))
        logps.append(lp)
        c, t = _gap_rule(o, lp, len(p), f"{what} request {i}", GEN_GAP_TOL)
        compared, ties = compared + c, ties + t
    return len(logps), compared, ties, logps


def _same_tokens(got, want, logp, tp, what, tol):
    """``got`` equals ``want`` up to the first position where the teacher's
    top-two gap (``logp`` over prompt + want) is <= ``tol``."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    check(len(got) == len(want), f"{what}: {len(got)} tokens, want "
          f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            _, gap = _top2(logp, slice(tp - 1 + i, tp + i))
            check(gap[0] <= tol, f"{what}: token {i} is {a}, want {b}, at a "
                  f"top-two gap of {gap[0]:.3g} > {tol}")
            return i, 1
    return len(got), 0


def _decode_run(model, prompt, caches, n_steps, feed=None, chunk=GEN_CHUNK):
    """``decode_forward`` over ``prompt`` in chunks of ``chunk``, then
    ``n_steps`` single-token steps feeding the argmax (or ``feed``).
    Returns (tokens fed, log-probs (len(prompt) + n_steps, V))."""
    from deeplearning4j_torch.nn.generation import decode_forward

    ids = torch.as_tensor(np.asarray(prompt), device="cuda")[None].long()
    tp, rows, fed = len(prompt), [], []
    with torch.inference_mode():
        for off in range(0, tp, chunk):
            lg, caches = decode_forward(model, model.params, model.state,
                                        ids[:, off:off + chunk], caches, off)
            rows.append(lg[0])
        last = rows[-1][-1]
        for i in range(n_steps):
            tok = last.argmax() if feed is None else feed[i]
            fed.append(tok)
            lg, caches = decode_forward(model, model.params, model.state,
                                        tok.view(1, 1), caches, tp + i)
            rows.append(lg[0])
            last = lg[0, -1]
        return torch.stack(fed), torch.log_softmax(torch.cat(rows), dim=-1)


def _paged_row(model, tokens, seed):
    """Paged caches for one row: pools of just its blocks (+ trash), the
    table a permutation of them."""
    from deeplearning4j_torch.serve.paged import blocks_needed, build_pools

    maxb = blocks_needed(tokens, GEN_BLOCK)
    pools = build_pools(model, maxb + 1, GEN_BLOCK, model.dtype)
    table = torch.from_numpy(
        1 + np.random.RandomState(seed).permutation(maxb)).cuda()[None]
    return {lk: {"k_pool": p["k"], "v_pool": p["v"], "tables": table}
            for lk, p in pools.items()}, maxb * GEN_BLOCK


def gen_decode_equivalence(model):
    """f32: two prompts (200 and 333 tokens) prefilled in chunks of 64,
    then 32 single-token steps, through dense and through paged caches,
    each position's log-probs against one full forward (K1) over the same
    tokens. Returns the full forwards' count."""
    from deeplearning4j_torch.nn.generation import cache_read, init_caches

    rng = np.random.RandomState(11)
    teachers = 0
    for n, tp in enumerate((200, 333)):
        prompt = rng.randint(0, 32000, tp).astype(np.int32)
        paged, cap = _paged_row(model, tp + 32, seed=n)
        dense = init_caches(model, 1, cap, model.dtype)
        fed, lp_dense = _decode_run(model, prompt, dense, 32)
        _, lp_paged = _decode_run(model, prompt, paged, 32, feed=fed)
        seq = np.concatenate([prompt, fed.cpu().numpy().astype(np.int32)])
        want = _teacher_logp(model, seq)
        teachers += 1
        d_dense = (lp_dense - want).abs().max().item()
        d_paged = (lp_paged - want).abs().max().item()
        control = (lp_dense[1:] - want[:-1]).abs().max().item()
        same_read = all(
            torch.equal(a, b) for lk in dense
            for a, b in zip(cache_read(dense[lk]), cache_read(paged[lk])))
        print(f"[generate] decode equivalence, f32, prompt {tp} (chunks of "
              f"{GEN_CHUNK}) + 32 steps: max |d log-prob| against the full "
              f"forward: dense {d_dense:.3g}, paged {d_paged:.3g} (gate "
              f"{GEN_LOGP_TOL}); dense vs paged logits "
              f"{(lp_dense - lp_paged).abs().max().item():.3g}; paged "
              f"cache_read bit-equal to dense: {same_read}; control (one "
              f"position off) {control:.3g}")
        check(max(d_dense, d_paged) <= GEN_LOGP_TOL,
              f"decode log-probs differ from the full forward by "
              f"{max(d_dense, d_paged):.3g}")
        check(control > GEN_LOGP_TOL, "the decode limit accepts log-probs "
              "one position off")
        check(same_read, "paged cache_read differs from the dense one")
        del paged, dense
    return teachers


def _gen_prompts(rng, lens, shared, sharers):
    out = []
    for i, n in enumerate(lens):
        p = rng.randint(0, 32000, n).astype(np.int32)
        if i in sharers:
            p[:len(shared)] = shared
        out.append(p)
    return out


def _fork_mid_decode(cb, req, timeout=120.0):
    from deeplearning4j_torch.serve import ServeError

    deadline = time.monotonic() + timeout
    while not req.event.is_set() and time.monotonic() < deadline:
        try:
            return cb.fork(req)
        except ServeError:
            time.sleep(0.0005)  # still queued or prefilling
    return None


def gen_batcher_tokens(model):
    """f32: the paged batcher (4 slots, capacity 1024, block 16, chunks of
    64, prefix cache) serves 6 greedy requests of 64-700 prompt tokens, 32
    new each; two share a 256-token prefix (the second adopts it); one is
    forked mid-decode. Every token of the paged and of the dense batcher
    against a full forward teacher-forced on its own row, under the gap
    rule; the child's tokens against the parent's tail. Returns the full
    forwards' count."""
    from deeplearning4j_torch.serve import ContinuousBatcher

    rng = np.random.RandomState(12)
    shared = rng.randint(0, 32000, 256).astype(np.int32)
    prompts = _gen_prompts(rng, (64, 700, 321, 450, 300, 512), shared,
                           sharers=(2, 4))
    cb = ContinuousBatcher(model, kv="paged", slots=4, capacity=1024,
                           block_size=GEN_BLOCK, prefill_chunk=GEN_CHUNK,
                           prefix_cache=True, seed=0)
    try:
        first = [cb.submit(p, 32, temperature=0.0) for p in prompts[:4]]
        outs = [r.wait() for r in first]
        second = [cb.submit(p, 32, temperature=0.0) for p in prompts[4:]]
        child = _fork_mid_decode(cb, second[1])
        outs += [r.wait() for r in second]
        check(child is not None, "no fork landed while the parent decoded")
        cout = child.wait()
        stats = cb.kv_block_stats()
        sigs = cb.compile_signatures
    finally:
        cb.shutdown()
    px = stats["prefix_cache"]
    check(px["hits"] >= 1, f"the second prefix sharer adopted nothing: {px}")
    teachers, compared, ties, logps = _teacher_gate(model, prompts, outs,
                                                    "paged batcher")
    tail = outs[5][-len(cout):]
    c, t = _same_tokens(cout, tail, logps[5], len(prompts[5]) + 32 - len(cout),
                        "forked child vs the parent's tail", GEN_GAP_TOL)
    print(f"[generate] batcher, f32, paged (4 slots, capacity 1024, block "
          f"{GEN_BLOCK}, chunks of {GEN_CHUNK}, prefix cache): 6 greedy "
          f"requests of {[len(p) for p in prompts]} prompt tokens, 32 new "
          f"each: {compared} of {6 * 32} tokens equal the teacher-forced "
          f"full forward's argmax, {ties} near-ties (gap <= {GEN_GAP_TOL}) "
          f"skipped; prefix hits {px['hits']} misses "
          f"{px['misses']}; fork: child {len(cout)} tokens, {c} equal the "
          f"parent's tail (near-ties {t}), cow copies {stats['cow_copies']}; "
          f"signatures {sorted(sigs)}")
    dense = ContinuousBatcher(model, kv="dense", slots=4, capacity=1024,
                              seed=0)
    try:
        douts = [r.wait() for r in [dense.submit(p, 32, temperature=0.0)
                                    for p in prompts]]
    finally:
        dense.shutdown()
    n, compared, ties, _ = _teacher_gate(model, prompts, douts,
                                         "dense batcher")
    same = sum(int(np.array_equal(d, o)) for d, o in zip(douts, outs))
    print(f"[generate] batcher, f32, dense (4 slots): {compared} of {6 * 32} "
          f"tokens equal the argmax of their own teacher-forced full "
          f"forward, {ties} near-ties skipped; {same} of 6 rows equal the "
          f"paged batcher's")
    return teachers + n


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def gen_measured(model):
    """bf16: the paged batcher at 8 slots, capacity 1024, block 16, chunks
    of 64, prefix cache on, serves 32 requests from 4 client threads (a
    burst: each thread submits its 8 at once), prompts uniform in 64-768
    tokens (seed 0), 64 new tokens each, 8 sharing a 256-token prefix; half
    greedy, half sampled (temperature 0.8, top_k 40). A smoke load with no
    published source. Token stamps are taken on the client side, one
    reader a request on its ``stream()``; tick and chunk host times come
    from the batcher's own histograms; device times from ``step_probe``
    replays. Returns what the HTTP check and the records need."""
    from deeplearning4j_torch.nn.generation import cache_read, cache_spec
    from deeplearning4j_torch.ops.flash_attention import flash_fwd_cuda
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.serve import ContinuousBatcher
    from deeplearning4j_torch.serve.paged import block_bytes, build_pools

    rng = np.random.RandomState(0)
    lens = rng.randint(64, 769, 32)
    shared = rng.randint(0, 32000, 256).astype(np.int32)
    sharers = [i for i in range(32) if lens[i] > 272][:8]
    prompts = _gen_prompts(rng, lens, shared, sharers)
    sampled = set(range(1, 32, 2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb = ContinuousBatcher(model, kv="paged", slots=GEN_SLOTS,
                           capacity=GEN_CAPACITY, block_size=GEN_BLOCK,
                           prefill_chunk=GEN_CHUNK, prefix_cache=True,
                           seed=0)
    S, buckets = GEN_SLOTS, list(cb.chunk_buckets)
    submitted, stamps, reqs = {}, {i: [] for i in range(32)}, [None] * 32
    readers = []

    def read(i):
        for _ in reqs[i].stream():
            stamps[i].append(time.perf_counter())

    def client(ids):
        for i in ids:
            kw = dict(temperature=0.8, top_k=40) if i in sampled \
                else dict(temperature=0.0)
            submitted[i] = time.perf_counter()
            reqs[i] = cb.submit(prompts[i], 64, **kw)
            th = threading.Thread(target=read, args=(i,))
            th.start()
            readers.append(th)

    try:
        # warm the decode tick and every chunk bucket (and the params'
        # compute copies) on the trash block, outside the batcher's metrics
        tick = cb.step_probe("decode", sampled=S // 2, temperature=0.8,
                             top_k=40)
        prefill = {b: cb.step_probe("prefill", b) for b in buckets}
        for _ in range(2):
            tick()
            for f in prefill.values():
                f()
        torch.cuda.synchronize()
        flash_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(range(c, 32, 4),))
                   for c in range(4)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(900)
        for th in readers:
            th.join(900)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in clients + readers),
              "clients hung")
        k1_generate = flash_fwd_cuda.launches
        outs = [r.wait() for r in reqs]
        stats = cb.kv_block_stats()
        sigs = cb.compile_signatures
        peak_mem = torch.cuda.max_memory_allocated()
        memo = cb.cast_bytes()
        dec_h = cb.metrics.histogram("serve_gen_decode_seconds")
        pre_h = cb.metrics.histogram("serve_gen_prefill_seconds")
        # one tick of 4 greedy and 4 sampled slots, and one chunk of each
        # bucket, replayed alone (the batcher is idle: nothing in flight)
        tick_dev_ms, tick_ops = device_ms(tick, reps=5)
        # each tick ends in its host sync, so back to back they overlap no
        # host work with device work
        tick_b2b = time_b2b_ms(tick, reps=5, rounds=3)
        chunk_ms = {b: time_ms(f, reps=10) for b, f in prefill.items()}
    finally:
        cb.shutdown()
    # the gathered views of a tick: every table row zero, so one pool
    # block (the trash) serves the gather of all S x maxb entries
    maxb = GEN_CAPACITY // GEN_BLOCK
    zero = torch.zeros((S, maxb), dtype=torch.long, device="cuda")
    views = [{"k_pool": p["k"], "v_pool": p["v"], "tables": zero}
             for p in build_pools(model, 1, GEN_BLOCK, model.dtype).values()]

    def gather():
        for c in views:
            cache_read(c)

    gather_ms = time_ms(gather, reps=10)
    del views
    params = model.params
    cast_ms = time_ms(lambda: [t.to(torch.bfloat16)
                               for t in tree_leaves(params)], reps=5)
    for i, o in enumerate(outs):
        check(o.shape == (64,), f"request {i} returned {o.shape}")
        check(int(o.min()) >= 0 and int(o.max()) < 32000,
              f"request {i}: ids outside [0, 32000)")
        check(len(stamps[i]) == 64, f"request {i}: the client read "
              f"{len(stamps[i])} tokens of 64")
    check(len(sigs) <= len(buckets) + 1,
          f"{len(sigs)} shapes run, more than {len(buckets)} chunk buckets "
          f"+ 1: {sorted(sigs)}")
    check(k1_generate == 0, f"the batcher launched K1 {k1_generate} times")
    ttft = [1e3 * (stamps[i][0] - submitted[i]) for i in range(32)]
    itl = [1e3 * (b - a) for i in range(32)
           for a, b in zip(stamps[i], stamps[i][1:])]
    tokens = 32 * 64
    # bound of one tick at 8 slots: the function's own traffic, the bf16
    # weights and the live KV of a full tick (8 x the mean live length)
    # read once; the gathered views (written and read once) are the port's
    # cost, printed beside it
    n_params = sum(t.numel() for t in tree_leaves(params))
    blk_bytes = block_bytes(model, GEN_BLOCK, model.dtype)
    kv_bytes_token = blk_bytes // GEN_BLOCK
    mean_live = float(np.mean(lens)) + 32
    view_bytes = 2 * S * maxb * GEN_BLOCK * kv_bytes_token
    w_bytes = 2 * n_params
    live_bytes = S * mean_live * kv_bytes_token
    bound_ms = 1e3 * (w_bytes + live_bytes) / PEAK_BYTES_PER_S
    views_ms = 1e3 * view_bytes / PEAK_BYTES_PER_S
    print(f"[generate] measured, bf16 compute (f32 KV, the model's param "
          f"dtype, as the reference keeps it), paged, {GEN_SLOTS} slots, "
          f"capacity {GEN_CAPACITY}, block {GEN_BLOCK}, chunks of "
          f"{GEN_CHUNK}, prefix cache: a smoke load with no published "
          f"source, 32 requests (prompts {int(lens.min())}-{int(lens.max())}, "
          f"mean {lens.mean():.1f}; 8 share 256 tokens; 16 greedy, 16 at "
          f"temperature 0.8 top_k 40), 64 new each, 4 client threads: "
          f"{tokens} tokens in {wall:.3f} s, {tokens / wall:.1f} generated "
          f"tokens/s")
    print(f"[generate] client side: time to first token p50 "
          f"{_pct(ttft, 50):.1f} ms p99 {_pct(ttft, 99):.1f} ms (burst: queue "
          f"wait included); inter-token p50 {_pct(itl, 50):.2f} ms p99 "
          f"{_pct(itl, 99):.2f} ms")
    print(f"[generate] decode tick (serve_gen_decode_seconds, host clock, "
          f"{dec_h.count} ticks): mean {1e3 * dec_h.mean:.3f} ms, p50 "
          f"{1e3 * dec_h.quantile(0.5):.3f} ms p99 "
          f"{1e3 * dec_h.quantile(0.99):.3f} ms (bucket-interpolated); one "
          f"tick replayed (4 greedy + 4 sampled slots): on the device "
          f"(torch.profiler) {tick_dev_ms:.3f} ms in {tick_ops:.0f} device "
          f"operations, back to back {tick_b2b:.3f} ms a tick (CUDA "
          f"events); bound {bound_ms:.3f} ms (bf16 weights "
          f"{w_bytes / 1e9:.3f} GB + live KV {live_bytes / 1e9:.3f} GB over "
          f"3.35 TB/s); the port's gathered views add "
          f"{view_bytes / 1e9:.3f} GB written and read, {views_ms:.3f} ms at "
          f"that rate")
    print(f"[generate] prefill chunks (serve_gen_prefill_seconds, host "
          f"clock, {pre_h.count} chunks): mean {1e3 * pre_h.mean:.3f} ms p50 "
          f"{1e3 * pre_h.quantile(0.5):.3f} ms p99 "
          f"{1e3 * pre_h.quantile(0.99):.3f} ms; one chunk replayed, ms by "
          f"bucket (CUDA events): "
          + "; ".join(f"{b}: {v:.3f}" for b, v in sorted(chunk_ms.items())))
    print(f"[generate] KV: peak {stats['blocks_peak']} blocks of "
          f"{stats['blocks_total']} "
          f"({stats['blocks_peak'] * blk_bytes / 2**20:.1f} MiB, "
          f"{blk_bytes} bytes a block); prefix hits "
          f"{stats['prefix_cache']['hits']} misses "
          f"{stats['prefix_cache']['misses']}; {len(sigs)} shapes run "
          f"{sorted(sigs)} (chunk buckets {buckets}); K1 launches in the "
          f"batcher 0 (decode and prefill attention are the reference's "
          f"dense einsums, no kernel); peak memory "
          f"{peak_mem / 2**30:.2f} GiB; the params' compute copies held for "
          f"the generation (bf16, and f32 of the bf16 values where the "
          f"reference promotes) {memo / 2**30:.3f} GiB")
    print(f"[generate] the port's own costs: one bf16 cast of the f32 params "
          f"(what decode_forward does every call without the per-generation "
          f"copies) {cast_ms:.3f} ms; the gathered paged views of the "
          f"{len(cache_spec(model))} layers at {S} slots x {maxb * GEN_BLOCK} "
          f"positions {gather_ms:.3f} ms")
    greedy = [i for i in range(32) if i not in sampled]
    return {"prompts": prompts, "outs": outs, "greedy": greedy,
            "k1_generate": k1_generate}


def _http(port, path, body=None, timeout=300):
    """An open response from the server on 127.0.0.1 (GET, or POST of
    ``body`` as JSON); raises urllib's HTTPError on a non-2xx answer."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _http_json(port, path, body=None):
    with _http(port, path, body) as r:
        return json.loads(r.read())


def gen_http(model, measured):
    """bf16: a ModelServer on 127.0.0.1 (port 0, 4 generation slots): one
    SSE /generate and one buffered /generate of greedy prompts the batcher
    answered, one /predict, /health, /ready, /metrics; the greedy tokens
    against the batcher's under the gap rule (gap from a teacher-forced
    bf16 full forward); then stop(drain=True) flips /ready to 503 while an
    admitted stream finishes. Returns the full forwards' count."""
    import urllib.error

    from deeplearning4j_torch.serve import ModelServer

    srv = ModelServer(model, port=0, input_dtype=np.int32, gen_slots=4,
                      gen_capacity=GEN_CAPACITY).start()
    teachers = 0
    try:
        a, b = measured["greedy"][:2]
        pa, pb = measured["prompts"][a], measured["prompts"][b]
        with _http(srv.port, "/generate",
                   {"prompt": pa.tolist(), "max_new_tokens": 64,
                    "temperature": 0.0}) as r:
            check(r.headers["Content-Type"] == "text/event-stream",
                  "SSE /generate did not stream")
            events = [json.loads(line[6:]) for line in r
                      if line.startswith(b"data: ")]
        check(events and events[-1].get("done") is True,
              f"SSE stream ended without done: {events[-1:]}")
        sse = [e["token"] for e in events[:-1]]
        check(events[-1]["tokens"] == sse, "SSE done event disagrees")
        buffered = _http_json(srv.port, "/generate?stream=false",
                              {"prompt": pb.tolist(), "max_new_tokens": 64,
                               "temperature": 0.0})["tokens"]
        res = []
        for what, p, got, i in (("SSE", pa, sse, a),
                                ("buffered", pb, buffered, b)):
            want = measured["outs"][i]
            lp = _teacher_logp(model, np.concatenate([p, want[:-1]]))
            teachers += 1
            res.append(_same_tokens(got, want, lp, len(p),
                                    f"HTTP {what} vs the batcher",
                                    GEN_GAP_TOL_BF16))
        x = np.random.RandomState(3).randint(0, 32000, (1, 16))
        y = np.asarray(_http_json(srv.port, "/predict",
                                  {"ndarray": x.tolist()})["output"],
                       np.float32)
        direct = model.output(x.astype(np.int32)).cpu().numpy()
        rel = float((np.abs(y - direct) / direct).max())
        check(y.shape == (1, 16, 32000) and np.isfinite(y).all(),
              f"/predict answered {y.shape}")
        check(rel <= ENGINE_RTOL, f"/predict differs from model.output by "
              f"{rel:.3g}")
        health = _http_json(srv.port, "/health")
        ready = _http_json(srv.port, "/ready")
        time.sleep(0.05)  # request metrics land after the reply
        with _http(srv.port, "/metrics") as r:
            scrape = r.read().decode()
        check(health["status"] == "ok" and ready["status"] == "ready",
              f"/health {health}, /ready {ready}")
        for name in ("serve_gen_tokens_total", "serve_kv_live_bytes",
                     "serve_prefix_cache_misses_total", "http_request_seconds",
                     "serve_batches_total"):
            check(name in scrape, f"{name} missing from /metrics")
        # drain: an admitted stream finishes while /ready answers 503
        got, codes = [], set()

        def stream():
            with _http(srv.port, "/generate",
                       {"prompt": pa[:128].tolist(), "max_new_tokens": 64,
                        "temperature": 0.0}) as r:
                for line in r:
                    if line.startswith(b"data: "):
                        got.append(json.loads(line[6:]))

        th = threading.Thread(target=stream)
        th.start()
        deadline = time.monotonic() + 120
        while not got and time.monotonic() < deadline:
            time.sleep(0.001)
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        while srv.ready() and time.monotonic() < deadline:
            time.sleep(0.001)
        while stopper.is_alive() and time.monotonic() < deadline:
            try:
                _http_json(srv.port, "/ready")
                codes.add(200)
            except urllib.error.HTTPError as e:
                codes.add(e.code)
            except OSError:
                break  # the listener closed after the drain
            time.sleep(0.005)
        stopper.join(120)
        th.join(120)
        check(503 in codes and 200 not in codes,
              f"/ready during the drain answered {sorted(codes)}")
        check(got and got[-1].get("done") is True and
              len(got[-1]["tokens"]) == 64,
              "the admitted stream did not finish through the drain")
    finally:
        srv.stop()
    print(f"[generate] HTTP (bf16, 4 generation slots): SSE /generate "
          f"{len(sse)} tokens, {res[0][0]} equal the batcher's before a "
          f"near-tie ({res[0][1]} met, gap <= {GEN_GAP_TOL_BF16}); buffered "
          f"{len(buffered)} tokens, {res[1][0]} equal ({res[1][1]} met); "
          f"/predict max rel diff {rel:.3g} against model.output; /health "
          f"{health['status']}, /ready {ready['status']}; drain: /ready "
          f"answered {sorted(codes)}, the admitted stream finished with "
          f"{len(got[-1]['tokens'])} tokens")
    return teachers


def phase_generate(model):
    """Generation on the served model: f32 gates (decode equivalence,
    batcher tokens, prefix adoption, fork, paged vs dense), then the bf16
    measured run and the HTTP server. Returns K1's launches in the
    teacher-forced full forwards and in the batcher."""
    from deeplearning4j_torch.ops.flash_attention import flash_fwd_cuda

    flash_fwd_cuda.launches = 0
    model.config.compute_dtype = None
    t0 = time.perf_counter()
    teachers = gen_decode_equivalence(model)
    teachers += gen_batcher_tokens(model)
    check_launches = flash_fwd_cuda.launches
    model.config.compute_dtype = "bfloat16"
    t1 = time.perf_counter()
    measured = gen_measured(model)
    flash_fwd_cuda.launches = 0
    teachers += gen_http(model, measured)
    check_launches += flash_fwd_cuda.launches
    gc.collect()  # free the batchers: pools and cast copies
    torch.cuda.empty_cache()
    # the checks' full forwards: the teachers, /predict and its direct twin
    check(check_launches == 12 * (teachers + 2),
          f"K1 launched {check_launches} times in {teachers + 2} full "
          f"forwards of a 12-layer model")
    print(f"[generate] phase: f32 gates {t1 - t0:.1f} s, measured run and "
          f"HTTP {time.perf_counter() - t1:.1f} s; K1 launches in the checks' "
          f"{teachers + 2} full forwards {check_launches} (12 each), in the "
          f"batcher {measured['k1_generate']}")
    return {"generate_check": check_launches,
            "generate": measured["k1_generate"]}


def phase_train(model):
    """Trainer(model).fit at full width: TRAIN_WARMUP steps in one fit,
    then the rest in a second fit timed as one window (the card idle at
    both ends). Returns the launches of K1, K2, K3 and K5 over both."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.ops.flash_attention import (
        column_broadcast_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_fwd_cuda)
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    B, T, V, L, d, H = 4, 1024, 32000, 12, 2048, 32
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (B, T)).astype(np.int32)
    y = rng.randint(0, V, (B, T)).astype(np.int32)

    def batches(n):
        return ArrayIterator(np.repeat(x, n, 0), np.repeat(y, n, 0),
                             batch_size=B)

    model.config.compute_dtype = "bfloat16"
    trainer = Trainer(model)
    scores = CollectScoresListener()
    timed = TRAIN_STEPS - TRAIN_WARMUP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda,
                column_broadcast_cuda)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    trainer.fit(batches(TRAIN_WARMUP), listeners=[scores])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.fit(batches(timed), listeners=[scores])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = tuple(w.launches for w in wrappers)
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in scores.scores]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} losses reported for "
          f"{TRAIN_STEPS} steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts[:3] == (L * TRAIN_STEPS,) * 3,
          f"launches K1, K2, K3 {counts[:3]}: want {L} each per step of a "
          f"{L}-layer model over {TRAIN_STEPS} steps")
    step_ms = 1e3 * (t2 - t1) / timed
    tokens = B * T
    pairs = T * (T + 1) // 2
    f_blocks = 6 * tokens * 12 * L * d * d
    f_head = 6 * tokens * d * V
    f_attn = 12 * (d // H) * pairs * B * H * L
    flops = f_blocks + f_head + f_attn
    print(f"[train] {TRAIN_STEPS} steps of Trainer.fit (adamw 3e-4, bf16 "
          f"compute, f32 head), B={B} T={T}: losses "
          + " ".join(f"{l:.4f}" for l in losses))
    print(f"[train] launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]} "
          f"({L} each per step), K5 {counts[3]}; warm-up fit of "
          f"{TRAIN_WARMUP} steps {t1 - t0:.2f} s")
    print(f"[train] step ms (one fit of {timed} steps after the warm-up, "
          f"synchronized at both ends, window / steps): {step_ms:.2f} ms "
          f"({1e3 * (t2 - t1):.1f} ms window), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s")
    print(f"[train] model FLOP/step = 6*tokens*12*L*d^2 (blocks, bf16) "
          f"{f_blocks:.4g} + 6*tokens*d*V (head, f32) {f_head:.4g} + "
          f"12*D*pairs*BH*L (attention) {f_attn:.4g} = {flops:.4g}; MFU "
          f"{flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s; "
          f"peak memory {peak / 2**30:.2f} GiB")
    return counts, trainer, x, y


def train_breakdown(trainer, x, y, attn_ms):
    """Where one training step's time goes, each part timed alone by CUDA
    events on the trained model: the forward with its loss, forward plus
    backward, the f32 head (output layer's score) alone, and the updater.
    ``attn_ms`` maps K1, K2, K3 to their per-launch times at this shape."""
    from deeplearning4j_torch.nn.layers import TransformerEncoderBlock
    from deeplearning4j_torch.nn.model import _layer_key
    from deeplearning4j_torch.ops.updaters import tree_leaves

    model, params, state = trainer.model, trainer.params, trainer.state
    x, y = (torch.from_numpy(a).cuda() for a in (x, y))
    leaves = tree_leaves(params)
    L = len(model.layers) - 1
    head, head_key = model.layers[L], _layer_key(L, model.layers[L])

    def fwd():
        model.score(params, state, x, y)

    def fwd_bwd():
        loss, _ = model.score(params, state, x, y)
        torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        feats, _ = model.forward(params, state, x, up_to=L)
    feats.requires_grad_()
    head_leaves = tree_leaves(params[head_key])

    def head_fwd():
        head.score(params[head_key], {}, feats, y)

    def head_fwd_bwd():
        loss = head.score(params[head_key], {}, feats, y)
        torch.autograd.grad(loss, [feats] + head_leaves)

    loss, _ = model.score(params, state, x, y)
    grads = list(torch.autograd.grad(loss, leaves))
    del loss

    def update():
        trainer.tx.update(grads, trainer.opt_state, leaves)

    t = {name: time_ms(fn, reps=5, warmup=1) for name, fn in (
        ("fwd", fwd), ("fwd_bwd", fwd_bwd), ("head_fwd", head_fwd),
        ("head_fwd_bwd", head_fwd_bwd), ("update", update))}
    n = sum(isinstance(l, TransformerEncoderBlock) for l in model.layers)
    k1, k23 = n * attn_ms["K1"], n * (attn_ms["K2"] + attn_ms["K3"])
    print(f"[train] step breakdown (CUDA events, median of 5, each part "
          f"alone): forward + loss {t['fwd']:.2f} ms (f32 head + log-softmax "
          f"{t['head_fwd']:.2f}, K1 {n} x {attn_ms['K1']:.4f} = {k1:.2f}); "
          f"backward {t['fwd_bwd'] - t['fwd']:.2f} ms (f32 head "
          f"{t['head_fwd_bwd'] - t['head_fwd']:.2f}, K2 + K3 {n} x "
          f"{attn_ms['K2'] + attn_ms['K3']:.4f} = {k23:.2f}); adamw update "
          f"{t['update']:.2f} ms")
    return t


def phase_grad_flash_vs_dense():
    """A 2-layer model of the full width: the flash path's gradients (K1,
    K2, K3) against the dense path's on one 2 x 1024 batch; gated in f32,
    reported in bf16."""
    from deeplearning4j_torch.models import CausalLM
    from deeplearning4j_torch.ops.updaters import tree_leaves

    def lm(flash):
        return CausalLM(seed=0, input_shape=(1024,), num_layers=2,
                        d_model=2048, num_heads=32, vocab=32000,
                        flash=flash).build()

    flash, dense = lm(True), lm(False)
    params, _ = flash.init(seed=0)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, 32000, (2, 1024)).astype(np.int32)).cuda()
    y = torch.from_numpy(rng.randint(0, 32000, (2, 1024)).astype(np.int32)).cuda()
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    for cdt in ("bfloat16", None):
        grads = []
        for m in (flash, dense):
            m.config.compute_dtype = cdt
            loss, _ = m.score(params, {}, x, y)
            grads.append(torch.autograd.grad(loss, leaves))
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(*grads))
        print(f"[grad flash-vs-dense] 2 layers, 2 x 1024, compute "
              f"{cdt or 'float32'}: max over params of max |flash - dense| "
              f"/ max |dense| = {rel:.3g}")
        del grads
    check(rel <= GRAD_RTOL, f"f32 flash vs dense gradient rel diff {rel:.3g}")


RN_BATCH, RN_STEPS, RN_WARMUP = 128, 12, 2
RN_GRAD_BATCH = 8
RN_GRAD_RTOL = 1e-3     # f32 gradients, kernels vs plain BN backward


def _resnet50(compute_dtype):
    from deeplearning4j_torch.models import ResNet50

    model = ResNet50(num_classes=1000, seed=0,
                     input_shape=(224, 224, 3)).build()
    model.config.compute_dtype = compute_dtype
    return model


def _bn_nodes(model, batch):
    """(name, M, C) of every BatchNorm of a Graph at this batch size."""
    from deeplearning4j_torch.nn.layers import BatchNorm

    out = []
    for name in model.topo_order:
        node = model.nodes[name]
        if isinstance(node.spec, BatchNorm):
            h, w, c = model.node_shape(node.inputs[0])
            out.append((name, batch * h * w, c))
    return out


def _model_flop(model, batch):
    """Model FLOP of one training step: 2 FLOP per multiply-add of every
    conv and dense layer's forward, times 3 (forward, and the input and
    weight gradients of the backward)."""
    from deeplearning4j_torch.nn.layers import Conv2D, Output

    macs = 0
    for name in model.topo_order:
        node = model.nodes[name]
        if isinstance(node.spec, Conv2D):
            oh, ow, co = model.node_shape(name)
            kh, kw = node.spec.kernel
            ci = model.node_shape(node.inputs[0])[-1] // node.spec.groups
            macs += oh * ow * co * kh * kw * ci
        elif isinstance(node.spec, Output):
            macs += model.node_shape(node.inputs[0])[-1] * node.spec.n_out
    return 6 * macs * batch


def phase_resnet_train():
    """Trainer(ResNet50).fit at full width (224², batch 128, bf16 compute,
    adam 1e-3): RN_WARMUP steps in one fit, the rest in a second fit timed
    as one window. Launch counts of K4a and K4b are zeroed before the first
    fit and read after the second: 53 each per step."""
    from deeplearning4j_torch.data import BenchmarkIterator
    from deeplearning4j_torch.ops.batch_norm import (
        bn_dx, bn_reduce, bn_reduce_coeffs)
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    t0 = time.perf_counter()
    model = _resnet50("bfloat16")
    model.init(seed=0)
    torch.cuda.synchronize()
    n_bn = len(_bn_nodes(model, RN_BATCH))
    print(f"[resnet] ResNet50 graph of {len(model.nodes)} nodes ({n_bn} "
          f"BatchNorms), {model.param_count()} params, initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    stats0 = {k: {n: t.clone() for n, t in v.items()}
              for k, v in model.state.items()}
    trainer = Trainer(model)
    scores = CollectScoresListener()
    timed = RN_STEPS - RN_WARMUP

    def batches(n):
        return BenchmarkIterator((224, 224, 3), 1000, RN_BATCH, n, seed=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = (bn_reduce_coeffs, bn_dx, bn_reduce)
    for w in wrappers:
        w.launches = 0
        w.routes = dict.fromkeys(w.routes, 0)
    t0 = time.perf_counter()
    trainer.fit(batches(RN_WARMUP), listeners=[scores])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.fit(batches(timed), listeners=[scores])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = (bn_reduce_coeffs.launches, bn_dx.launches)
    routes = {"K4a": dict(bn_reduce_coeffs.routes), "K4b": dict(bn_dx.routes)}
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in scores.scores]
    check(len(losses) == RN_STEPS, f"{len(losses)} losses for {RN_STEPS} "
          f"steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts == (n_bn * RN_STEPS,) * 2 and bn_reduce.launches == 0,
          f"launches fused K4a, K4b {counts} (K4a's sums mode "
          f"{bn_reduce.launches}): want {n_bn} each per step over "
          f"{RN_STEPS} steps, all K4a in the fused mode")
    moved = 0
    for k, v in trainer.state.items():
        for n, t in v.items():
            check(bool(torch.isfinite(t).all()), f"non-finite running {n} "
                  f"in {k}")
            moved += int(not torch.equal(t, stats0[k][n]))
    check(moved == 2 * n_bn, f"{moved} of {2 * n_bn} running statistics "
          f"changed over the fit")
    step_ms = 1e3 * (t2 - t1) / timed
    flop = _model_flop(model, RN_BATCH)
    print(f"[resnet] {RN_STEPS} steps of Trainer.fit (adam 1e-3, bf16 "
          f"compute, f32 params), BenchmarkIterator batch {RN_BATCH} at "
          f"224x224x3: losses " + " ".join(f"{l:.4f}" for l in losses))
    print(f"[resnet] launches K4a (fused) {counts[0]}, K4b {counts[1]} "
          f"({n_bn} each per step); routes {routes}; running mean and var of all {n_bn} BatchNorms finite "
          f"and changed; warm-up fit of {RN_WARMUP} steps {t1 - t0:.2f} s")
    print(f"[resnet] step ms (one fit of {timed} steps after the warm-up, "
          f"synchronized at both ends, window / steps): {step_ms:.2f} ms "
          f"({1e3 * (t2 - t1):.1f} ms window), "
          f"{RN_BATCH / step_ms * 1e3:.1f} images/s")
    print(f"[resnet] model FLOP/step = 6 x conv and dense multiply-adds x "
          f"batch = {flop:.4g}; MFU {flop / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f}"
          f" of 989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB")
    return counts, routes, trainer


def resnet_breakdown(trainer):
    """Where one ResNet-50 step's time goes, each part timed alone by CUDA
    events on the trained model: forward with the loss, forward plus
    backward, the adam update; and K4a + K4b at every BatchNorm's shape,
    summed over the 53 BatchNorms."""
    from deeplearning4j_torch.data import BenchmarkIterator
    from deeplearning4j_torch.ops.updaters import tree_leaves

    model, params, state = trainer.model, trainer.params, trainer.state
    ds = next(iter(BenchmarkIterator((224, 224, 3), 1000, RN_BATCH, 1,
                                     seed=0)))
    x, y = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    leaves = tree_leaves(params)

    def fwd():
        model.score(params, state, x, y)

    def fwd_bwd():
        loss, _ = model.score(params, state, x, y)
        torch.autograd.grad(loss, leaves)

    loss, _ = model.score(params, state, x, y)
    grads = list(torch.autograd.grad(loss, leaves))
    del loss

    def update():
        trainer.tx.update(grads, trainer.opt_state, leaves)

    t = {name: time_ms(fn, reps=5, warmup=1) for name, fn in (
        ("fwd", fwd), ("fwd_bwd", fwd_bwd), ("update", update))}
    del grads
    shapes = [(M, C) for _, M, C in _bn_nodes(model, RN_BATCH)]
    tot, bound = print_bn_shapes(shapes, bn_shape_times(shapes), "resnet")
    elems = sum(M * C for M, C in shapes)
    bn_total = tot["k4a"] + tot["k4b"]
    print(f"[resnet] step breakdown (CUDA events, median of 5, each part "
          f"alone): forward + loss {t['fwd']:.2f} ms; backward "
          f"{t['fwd_bwd'] - t['fwd']:.2f} ms (K4a + K4b over the {len(shapes)} "
          f"BatchNorms {bn_total:.2f} ms: K4a {tot['k4a']:.2f}, K4b "
          f"{tot['k4b']:.2f}; their bytes bound {bound:.2f} ms over "
          f"{elems / 1e9:.3f} G elements); adam update {t['update']:.2f} ms")
    return t, bn_total


def resnet_step_anatomy(trainer):
    """What separates the fit's step time from the device parts: steps
    with the batch already on the card (5, one window), the host time to
    enqueue one such step, and a torch.profiler trace of 3 fit steps, whose
    kernel intervals give the card's busy and idle share under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_torch.data import BenchmarkIterator

    ds = next(iter(BenchmarkIterator((224, 224, 3), 1000, RN_BATCH, 1,
                                     seed=0)))
    x, y = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    p, o, s = trainer.params, trainer.opt_state, trainer.state
    p, o, s, _ = trainer.step(p, o, s, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, o, s, _ = trainer.step(p, o, s, x, y)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        p, o, s, _ = trainer.step(p, o, s, x, y)
    torch.cuda.synchronize()
    on_card_ms = 1e3 * (time.perf_counter() - t0) / 5
    trainer.opt_state, trainer.state = o, s
    print(f"[resnet] step with the batch already on the card (5 steps, one "
          f"window): {on_card_ms:.2f} ms; host time to enqueue one such "
          f"step: {enqueue_ms:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(BenchmarkIterator((224, 224, 3), 1000, RN_BATCH, 3,
                                      seed=0))
        torch.cuda.synchronize()
    events = list(prof.events())
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA)
    if not kernels:
        print("[resnet] profiler: no device events recorded; busy and idle "
              "share not measured")
        return None
    busy, cur_s, cur_e = 0.0, None, None
    for st, en in kernels:
        if cur_e is None or st > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    span = max(e.time_range.end for e in events) \
        - min(e.time_range.start for e in events)
    top = sorted(prof.key_averages(), key=lambda a: -a.device_time_total)[:6]
    print(f"[resnet] profiler, 3 fit steps: card busy {busy / 1e3:.2f} ms "
          f"of a {span / 1e3:.2f} ms trace, idle share "
          f"{1 - busy / span:.4f}; {len(kernels)} device events "
          f"({len(kernels) / 3:.0f} a step); top by "
          f"device time: " + "; ".join(
              f"{a.key[:60]} {a.device_time_total / 1e3:.2f} ms" for a in top))
    return 1 - busy / span


def phase_resnet_grad_gate():
    """f32 gradients of every ResNet-50 param on one batch of 8 at 224²:
    through K4a/K4b against through their plain versions. Each param's
    largest difference is held to RN_GRAD_RTOL of the largest gradient
    entry of its node (its layer's params together): a BatchNorm whose
    output reaches only BatchNorms through ReLU and max pooling (the stem)
    has a beta gradient that is zero up to rounding, whose own largest
    entry is no scale."""
    from deeplearning4j_torch.data import BenchmarkIterator
    from deeplearning4j_torch.ops import batch_norm
    from deeplearning4j_torch.ops.updaters import tree_leaves

    model = _resnet50(None)
    params, state = model.init(seed=0)
    ds = next(iter(BenchmarkIterator((224, 224, 3), 1000, RN_GRAD_BATCH, 1,
                                     seed=1)))
    x, y = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    names = [k for k in sorted(params) for _ in tree_leaves(params[k])]
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.score(params, state, x, y)
    got = torch.autograd.grad(loss, leaves)
    # the BatchNorm Function's backward calls the module's bn_backward:
    # point it at the plain version for the reference gradients
    kernels = batch_norm.bn_backward
    batch_norm.bn_backward = batch_norm.bn_backward_reference
    try:
        loss_p, _ = model.score(params, state, x, y)
        want = torch.autograd.grad(loss_p, leaves)
    finally:
        batch_norm.bn_backward = kernels
    scale = {}
    for n, w in zip(names, want):
        scale[n] = max(scale.get(n, 0.0), w.abs().max().item())
    rel_node = max(((g - w).abs().max().item() / scale[n])
                   for n, g, w in zip(names, got, want))
    rel_own = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                  .item() for g, w in zip(got, want))
    print(f"[resnet grad] f32, batch {RN_GRAD_BATCH} at 224x224x3, loss "
          f"{loss.item():.6f} (plain {loss_p.item():.6f}): max over params "
          f"of max |kernels - plain| / largest gradient entry of the node "
          f"{rel_node:.3g} (gate {RN_GRAD_RTOL}); of the param itself "
          f"{rel_own:.3g}")
    check(rel_node <= RN_GRAD_RTOL, f"f32 ResNet-50 gradient, kernels vs "
          f"plain BN backward, rel diff {rel_node:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    k1 = phase_kernels()
    bwd_rows = phase_bwd_kernels()
    t0 = time.perf_counter()
    model = _lm(flash=True)
    model.init(seed=0)
    torch.cuda.synchronize()
    print(f"[serve] CausalLM with {model.param_count()} params initialized "
          f"in {time.perf_counter() - t0:.2f} s")
    serve_launches = phase_serve(model)
    gen_launches = phase_generate(model)
    phase_flash_vs_dense(model)
    (k1_train, k2_train, k3_train, k5_train), trainer, x, y = \
        phase_train(model)
    train_breakdown(trainer, x, y, {"K1": k1["ms"], "K2": bwd_rows[0]["ms"],
                                    "K3": bwd_rows[1]["ms"]})
    del model, trainer
    torch.cuda.empty_cache()
    phase_grad_flash_vs_dense()
    bn_rows = phase_bn_kernels()
    (k4a_train, k4b_train), bn_routes, trainer = phase_resnet_train()
    resnet_breakdown(trainer)
    resnet_step_anatomy(trainer)
    del trainer
    torch.cuda.empty_cache()
    phase_resnet_grad_gate()
    k1["launches"] = serve_launches
    k1["launches_by_path"] = {"serve": serve_launches, "train": k1_train,
                              **gen_launches}
    bwd_rows[0]["launches"] = k2_train
    bwd_rows[1]["launches"] = k3_train
    bwd_rows[2]["launches"] = k5_train
    for row, n, key in zip(bn_rows, (k4a_train, k4b_train), ("K4a", "K4b")):
        row["launches"] = n
        row["launches_by_path"] = {"train": n}
        row["routes_on_path"] = bn_routes[key]
    print(json.dumps({"kernels": [k1] + bwd_rows + bn_rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
