#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero without its
last line):

1. build — compile every CUDA kernel of the port from ``deeplearning4j_torch/
   kernels/csrc`` with nvcc for sm_90a, one nvcc per source side by side,
   and print the card.
2. kernels — each kernel against its plain PyTorch version on the card:
   the flash forward (K1) and the flash backward's dQ (K2) and dK/dV (K3)
   passes in f32 and bf16, several head dims, ragged T, causal, windows,
   lengths (a 0 among them) and a key mask with a hole; the column
   broadcast probe (K5) bit for bit. Then K1 at the serving shape and K2,
   K3 at the training shape, timed beside the plain version and the
   PyTorch library call.
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
    print(f"[build] card: {card()}")


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
        flash_attention_reference, flash_fwd_cuda)

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    for i, case in enumerate(KERNEL_CASES):
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
        what = _what(*case)
        err = _compare(o, lse, o_ref, lse_ref, what)
        print(f"[kernels] ok {what}: max abs err {err:.3g}")

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
    plain_ms = time_ms(lambda: flash_attention_reference(
        q, k, v, scale=scale, causal=True), reps=5, warmup=1)
    q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale))
    # least work the inputs need: each of q, k, v read once, o and lse
    # written once; 2 FLOP per multiply-add over the T(T+1)/2 causal pairs,
    # for q.k and for p.v
    nbytes = 4 * bh * t * d * q.element_size() + bh * t * 4
    flops = 2 * 2 * d * (t * (t + 1) // 2) * bh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "deeplearning4j_torch/kernels/csrc/flash_fwd.cu",
           "replaces": "deeplearning4j_tpu/ops/flash_attention.py:41",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    print(f"[kernels] serving shape BH={bh} T={t} D={d} bf16 causal: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), max abs err {err:.3g}")
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
    k1["launches"] = serve_launches
    k1["launches_by_path"] = {"serve": serve_launches, "train": k1_train}
    bwd_rows[0]["launches"] = k2_train
    bwd_rows[1]["launches"] = k3_train
    bwd_rows[2]["launches"] = k5_train
    print(json.dumps({"kernels": [k1] + bwd_rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
