#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero without its
last line):

1. build — compile every CUDA kernel of the port from ``deeplearning4j_torch/
   kernels/csrc`` with nvcc for sm_90a, one nvcc per source side by side,
   print each kernel's registers and spills (gated: none for K1's Hopper
   kernel at D 64) and the card.
2. kernels — each kernel against its plain PyTorch version on the card:
   the flash forward (K1) and the flash backward's dQ (K2) and dK/dV (K3)
   passes in f32 and bf16, several head dims, ragged T, causal, windows,
   lengths (a 0 among them) and a key mask with a hole; K1 also over its
   Hopper kernel's edges (bf16 D 64 and 128: T = 1 and below a tile, T
   off the tile grid, lengths either side of a tile edge, windows of 1,
   64 and 200); the column broadcast probe (K5) bit for bit. Then K1 at
   the serving shape and K2, K3 at the training shape, timed beside the
   plain version and the PyTorch library call (each time the median of
   one call at a time between two CUDA events; K1 and SDPA also with 20
   calls back to back between the events, which leaves out the host's
   launch work).
3. serve — a 738M-parameter CausalLM (12 layers, d_model 2048, 32 heads,
   vocab 32000, T 1024, learned positions, bf16 compute, flash attention)
   with random weights from seed 0, served through ``ServeEngine`` to 12
   requests from 4 threads. Launch counts are zeroed just before and read
   just after: every engine batch must launch the flash kernel once per
   layer.
4. flash vs dense — the same params through the dense attention path on one
   4 x 1024 batch: in bf16 (the served precision; reported) and in f32
   (gated: top-1 agreement at least 99%).
5. train — the same model trained by ``Trainer(model).fit`` (adamw, bf16
   compute, f32 head) for 12 steps on one repeated 4 x 1024 batch of
   random tokens and labels: 2 warm-up steps in one fit, the other 10 in
   a second fit timed as one window. Launch counts are zeroed just before
   and read just after: every step launches K1, K2 and K3 once per layer.
   Gated: every loss finite, the last below the first. Printed: step time
   (window / steps), tokens/s, model FLOP per step, MFU and peak memory,
   and where a step's time goes (forward, backward, the f32 head, the
   updater, each timed alone).
6. flash vs dense gradients — a 2-layer model of the same width, one
   2 x 1024 batch: in f32 every param's gradient within 1e-3 of the dense
   path's, relative to its largest entry (gated); bf16 reported.
7. bn kernels — BatchNorm's backward kernels, K4a (per-channel Σdy and
   Σdy·x) and K4b (dx), and their composition ``bn_bwd`` against the plain
   versions over a case list (f32 and bf16, C from 5 to 2048, M not a
   multiple of any block, a constant channel), then at the microbench's
   shape (bf16, M = 128·56·56, C = 256, seed 0), timed beside the plain
   versions and the library's BatchNorm backward.
8. resnet — ``ResNet50(num_classes=1000, seed=0, input_shape=(224, 224,
   3))`` (bf16 compute, f32 params, adam 1e-3) trained by
   ``Trainer(model).fit`` on ``BenchmarkIterator`` batches of 128 for 12
   steps: 2 warm-up steps in one fit, 10 in a second fit timed as one
   window. Launch counts are zeroed before and read after: every step
   launches K4a and K4b once per BatchNorm (53). Gated: losses finite and
   the last below the first; every running mean and var finite and
   changed. Printed: step time, images/s, model FLOP and MFU, peak memory,
   where a step's time goes (forward, backward, K4a + K4b at every
   BatchNorm's shape, adam), a step with the batch already on the card,
   and the card's busy share over 3 steps under torch.profiler.
9. resnet gradients — the same model in f32 on one batch of 8: every
   param's gradient through K4a/K4b within 1e-3 of the plain BN
   backward's, relative to the largest entry of its node (gated).

Prints a JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Needs one CUDA card.
"""

from __future__ import annotations

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
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    spills = sm90_spills(_build.build_log("flash_fwd_sm90"), 64)
    check(spills == "0 bytes spill stores, 0 bytes spill loads",
          f"flash_fwd_sm90 at D 64 spills: {spills!r}")
    print(f"[build] card: {card()}")


def sm90_spills(log: str, d: int) -> str:
    """The spill counts that ``-Xptxas -v`` reports in ``log`` for
    flash_fwd_sm90.cu's kernel at head dim ``d`` ('' if not found)."""
    fn = None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line and fn and f"flash_fwd_sm90_kernelILi{d}E" in fn:
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


def phase_bwd_kernels():
    """K2 and K3 against the plain backward over the K1 case list, K5 bit
    for bit, then K2 and K3 timed at the training shape."""
    from deeplearning4j_torch.ops.flash_attention import (
        column_broadcast_cuda, flash_attention_backward_reference,
        flash_attention_reference, flash_bwd_cuda, flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda)

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda")
    errs = {f32: 0.0, bf16: 0.0}
    for i, case in enumerate(KERNEL_CASES):
        dt, bh, t, d, causal, window, lens, hole = case
        gen.manual_seed(200 + i)
        q, k, v, do = _qkv(gen, bh, t, d, dt, n=4)
        lens_t, kmask = _masks(bh, t, lens, hole)
        kw = dict(scale=1.0 / d ** 0.5, causal=causal, window=window)
        o, lse = flash_attention_reference(q, k, v, lens_t, kmask, **kw)
        delta = (do.float() * o.float()).sum(-1)
        got = flash_bwd_cuda(q, k, v, do, lse, delta, lens_t, kmask, **kw)
        torch.cuda.synchronize()
        want = flash_attention_backward_reference(q, k, v, do, lse, delta,
                                                  lens_t, kmask, **kw)
        what = "bwd " + _what(*case)
        err = _bwd_compare(got, want, what)
        if lens is not None:
            for b, n in enumerate(lens):
                check(bool((got[1][b, n:] == 0).all() and (got[2][b, n:] == 0).all()),
                      f"{what}: keys past the length got a gradient")
        errs[dt] = max(errs[dt], err)
        print(f"[kernels] ok {what}: max abs err {err:.3g}")
    print(f"[kernels] backward: largest abs err f32 {errs[f32]:.3g} (gate "
          f"{F32_TOL} abs + rel), bf16 {errs[bf16]:.3g} (gate "
          f"{BWD_BF16_ATOL} abs + {BWD_BF16_RTOL} rel)")

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
    dq_ms = time_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw))
    dkv_ms = time_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))
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
    pairs = t * (t + 1) // 2
    esize = q.element_size()
    rows = []
    for name, ms, flop_per_pair, n_out, replaces in (
            ("flash_bwd_dq", dq_ms, 6, 1,
             "deeplearning4j_tpu/ops/flash_attention.py:278"),
            ("flash_bwd_dkv", dkv_ms, 8, 2,
             "deeplearning4j_tpu/ops/flash_attention.py:330")):
        # least work the inputs need: q, k, v, do read once, lse and delta
        # read once, the outputs written once; recomputing s and dp and
        # forming the outputs is 2 FLOP per multiply-add, D per product
        nbytes = (4 + n_out) * bh * t * d * esize + 2 * bh * t * 4
        flops = flop_per_pair * d * pairs * bh
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplearning4j_torch/kernels/csrc/flash_bwd.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": library_ms,
                     "library": "scaled_dot_product_attention backward, "
                                "dq+dk+dv together",
                     "plain": "flash_attention_backward_reference, "
                              "dq+dk+dv together"})
        print(f"[kernels] training shape BH={bh} T={t} D={d} bf16 causal, "
              f"{name}: kernel {ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} "
              f"ms ({rows[-1]['bound_by']}); plain backward (dq, dk, dv) "
              f"{plain_ms:.4f} ms; sdpa backward (dq, dk, dv) "
              f"{library_ms:.4f} ms; max abs err {err:.3g}")
    return rows + [k5]


# K4a/K4b case list: (dtype, M, C, constant channel); M not a multiple of
# any block, C from the stem's 64 to stage 4's 2048, and C that takes the
# one-element path (5, 12 in bf16)
BN_CASES = [
    (torch.float32, 1000, 64, False),
    (torch.float32, 4099, 256, True),
    (torch.float32, 777, 5, False),
    (torch.float32, 301, 2048, False),
    (torch.bfloat16, 4099, 64, True),
    (torch.bfloat16, 1003, 256, False),
    (torch.bfloat16, 301, 2048, False),
    (torch.bfloat16, 999, 12, False),
]
# K4a vs plain, per channel: both sum in f32 in different orders; the
# error is held to this share of the sum of the terms' magnitudes
BN_SUM_RTOL = 2e-5


def _bn_compare(x, dy, a, c1, c2, what):
    """K4a, K4b and their composition against the plain versions on one
    (M, C) case; returns the largest abs error of the composed dx."""
    from deeplearning4j_torch.ops.batch_norm import (
        bn_bwd, bn_bwd_reference, bn_dx, bn_dx_reference, bn_reduce,
        bn_reduce_reference)

    s = bn_reduce(x, dy)
    dx = bn_dx(x, dy, a, c1, c2)
    composed = bn_bwd(x, dy, a)
    torch.cuda.synchronize()
    xf, dyf = x.float(), dy.float()
    for name, got, want, terms in zip(
            ("sum dy", "sum dy*x"), s, bn_reduce_reference(x, dy),
            (dyf, dyf * xf)):
        err = (got - want).abs()
        bound = BN_SUM_RTOL * terms.abs().sum(0) + 1e-6
        check(bool(torch.isfinite(got).all() and (err <= bound).all()),
              f"{what}: K4a {name} differs from the plain version (max abs "
              f"err {err.max().item():.3g})")
    want = bn_dx_reference(x, dy, a, c1, c2)
    check(bool(torch.equal(dx, want)), f"{what}: K4b differs from the plain "
          f"version (max abs err {(dx.float() - want.float()).abs().max().item():.3g}; "
          f"both round the same ops in the same order)")
    # the composition: a summation-order difference in K4a can move c1 or
    # c2 by one rounding in x's dtype, and dx by one rounding of its own
    ref = bn_bwd_reference(x, dy, a)
    M = x.shape[0]
    c1r = (bn_reduce_reference(x, dy)[0] * (1.0 / M)).abs()
    c2r = (bn_reduce_reference(x, dy)[1] * (2.0 / M)).abs()
    r = 1e-5 if x.dtype == torch.float32 else 2.0 ** -7
    bound = r * (ref.float().abs() + c1r + xf.abs() * c2r) + 1e-30
    err = (composed.float() - ref.float()).abs()
    check(bool((err <= bound).all()), f"{what}: bn_bwd differs from the "
          f"plain composition (max abs err {err.max().item():.3g})")
    return err.max().item()


def phase_bn_kernels():
    """K4a and K4b against their plain versions over BN_CASES, then at the
    microbench's shape (bf16, M = 128*56*56, C = 256, seed 0 as
    scripts/bn_reduce_bench.py draws it), timed beside the plain versions
    and the library's BatchNorm backward."""
    from deeplearning4j_torch.ops.batch_norm import (
        bn_dx, bn_dx_reference, bn_reduce, bn_reduce_reference)

    gen = torch.Generator(device="cuda")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (dt, M, C, const) in enumerate(BN_CASES):
        gen.manual_seed(400 + i)
        x, dy = (torch.randn((M, C), generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        if const:
            x[:, 3] = 0.75
        a = torch.randn((C,), generator=gen, device="cuda").to(dt)
        c1, c2 = (1e-2 * torch.randn((C,), generator=gen, device="cuda")
                  for _ in range(2))
        what = f"{str(dt)[6:]} M={M} C={C} constant channel={const}"
        err = _bn_compare(x, dy, a, c1, c2, what)
        worst[dt] = max(worst[dt], err)
        print(f"[bn] ok {what}: composed dx max abs err {err:.3g}")

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
    k4a_ms = time_ms(lambda: bn_reduce(x, dy))
    k4b_ms = time_ms(lambda: bn_dx(x, dy, a, c1, c2))
    k4a_plain = time_ms(lambda: bn_reduce_reference(x, dy), reps=5, warmup=1)
    k4b_plain = time_ms(lambda: bn_dx_reference(x, dy, a, c1, c2), reps=5,
                        warmup=1)
    # the library's BN backward (dx, dgamma, dbeta of a standard BN in one
    # call) on the same tensors viewed as channels_last NCHW: it stands for
    # K4a + K4b together
    x4, dy4 = (t.view(128, 56, 56, C).permute(0, 3, 1, 2) for t in (x, dy))
    mean = x.float().mean(0)
    invstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    w = torch.ones(C, device="cuda")
    library_ms = time_ms(lambda: torch.ops.aten.native_batch_norm_backward(
        dy4, x4, w, None, None, mean, invstd, True, 1e-5, [True, True, True]))
    rows = []
    for name, ms, plain_ms, n_io, replaces in (
            ("bn_reduce", k4a_ms, k4a_plain, 2,
             "scripts/bn_reduce_bench.py:41"),
            ("bn_dx", k4b_ms, k4b_plain, 3,
             "scripts/bn_reduce_bench.py:68")):
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
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library": "native_batch_norm_backward (dx, dgamma, dbeta), "
                       "K4a + K4b together"})
        print(f"[bn] microbench shape M={M} C={C} bf16, {name}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB); library BN backward {library_ms:.4f} "
              f"ms; composed dx max abs err {err:.3g}")
    print(f"[bn] composed dx largest abs err: f32 {worst[torch.float32]:.3g}, "
          f"bf16 {worst[torch.bfloat16]:.3g}")
    return rows


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
    from deeplearning4j_torch.ops.batch_norm import bn_dx, bn_reduce
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
    bn_reduce.launches = bn_dx.launches = 0
    t0 = time.perf_counter()
    trainer.fit(batches(RN_WARMUP), listeners=[scores])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.fit(batches(timed), listeners=[scores])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = (bn_reduce.launches, bn_dx.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in scores.scores]
    check(len(losses) == RN_STEPS, f"{len(losses)} losses for {RN_STEPS} "
          f"steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts == (n_bn * RN_STEPS,) * 2,
          f"launches K4a, K4b {counts}: want {n_bn} each per step over "
          f"{RN_STEPS} steps")
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
    print(f"[resnet] launches K4a {counts[0]}, K4b {counts[1]} ({n_bn} each "
          f"per step); running mean and var of all {n_bn} BatchNorms finite "
          f"and changed; warm-up fit of {RN_WARMUP} steps {t1 - t0:.2f} s")
    print(f"[resnet] step ms (one fit of {timed} steps after the warm-up, "
          f"synchronized at both ends, window / steps): {step_ms:.2f} ms "
          f"({1e3 * (t2 - t1):.1f} ms window), "
          f"{RN_BATCH / step_ms * 1e3:.1f} images/s")
    print(f"[resnet] model FLOP/step = 6 x conv and dense multiply-adds x "
          f"batch = {flop:.4g}; MFU {flop / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f}"
          f" of 989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB")
    return counts, trainer


def resnet_breakdown(trainer):
    """Where one ResNet-50 step's time goes, each part timed alone by CUDA
    events on the trained model: forward with the loss, forward plus
    backward, the adam update; and K4a + K4b at every BatchNorm's shape,
    summed over the 53 BatchNorms."""
    from deeplearning4j_torch.data import BenchmarkIterator
    from deeplearning4j_torch.ops.batch_norm import bn_dx, bn_reduce
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
    gen = torch.Generator(device="cuda").manual_seed(7)
    per_shape = {}
    bn_total = 0.0
    shapes = _bn_nodes(model, RN_BATCH)
    for _, M, C in shapes:
        if (M, C) not in per_shape:
            xb, dyb = (torch.randn((M, C), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(2))
            cv = torch.randn((C,), generator=gen, device="cuda")
            per_shape[(M, C)] = (time_ms(lambda: bn_reduce(xb, dyb), reps=10),
                                 time_ms(lambda: bn_dx(xb, dyb, cv, cv, cv),
                                         reps=10))
            del xb, dyb
        bn_total += sum(per_shape[(M, C)])
    k4a = sum(per_shape[(M, C)][0] for _, M, C in shapes)
    elems = sum(M * C for _, M, C in shapes)
    bound = sum((2 + 3) * M * C * 2 for _, M, C in shapes) \
        / PEAK_BYTES_PER_S * 1e3
    print(f"[resnet] step breakdown (CUDA events, median of 5, each part "
          f"alone): forward + loss {t['fwd']:.2f} ms; backward "
          f"{t['fwd_bwd'] - t['fwd']:.2f} ms (K4a + K4b over the {len(shapes)} "
          f"BatchNorms {bn_total:.2f} ms: K4a {k4a:.2f}, K4b "
          f"{bn_total - k4a:.2f}; their bytes bound {bound:.2f} ms over "
          f"{elems / 1e9:.3f} G elements); adam update {t['update']:.2f} ms")
    print("[resnet] K4a, K4b ms per (M, C): " + "; ".join(
        f"{M}x{C} {a:.4f}, {b:.4f}" for (M, C), (a, b) in per_shape.items()))
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
          f"{1 - busy / span:.4f}; {len(kernels)} device events; top by "
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
    # the BatchNorm Function's backward calls the module's bn_reduce and
    # bn_dx: point them at the plain versions for the reference gradients
    kernels = batch_norm.bn_reduce, batch_norm.bn_dx
    batch_norm.bn_reduce = batch_norm.bn_reduce_reference
    batch_norm.bn_dx = batch_norm.bn_dx_reference
    try:
        loss_p, _ = model.score(params, state, x, y)
        want = torch.autograd.grad(loss_p, leaves)
    finally:
        batch_norm.bn_reduce, batch_norm.bn_dx = kernels
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
    phase_flash_vs_dense(model)
    (k1_train, k2_train, k3_train, k5_train), trainer, x, y = \
        phase_train(model)
    train_breakdown(trainer, x, y, {"K1": k1["ms"], "K2": bwd_rows[0]["ms"],
                                    "K3": bwd_rows[1]["ms"]})
    del model, trainer
    torch.cuda.empty_cache()
    phase_grad_flash_vs_dense()
    bn_rows = phase_bn_kernels()
    (k4a_train, k4b_train), trainer = phase_resnet_train()
    resnet_breakdown(trainer)
    resnet_step_anatomy(trainer)
    del trainer
    torch.cuda.empty_cache()
    phase_resnet_grad_gate()
    k1["launches"] = serve_launches
    k1["launches_by_path"] = {"serve": serve_launches, "train": k1_train}
    bwd_rows[0]["launches"] = k2_train
    bwd_rows[1]["launches"] = k3_train
    bwd_rows[2]["launches"] = k5_train
    for row, n in zip(bn_rows, (k4a_train, k4b_train)):
        row["launches"] = n
        row["launches_by_path"] = {"train": n}
    print(json.dumps({"kernels": [k1] + bwd_rows + bn_rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
