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

11. breadth — the non-recurrent training configs of ``bench.py:_breadth``
   at full width. BERT-base (``BertBase(num_classes=2, input_shape=(128,),
   flash=True)``, adamw 1e-4, bf16) on one batch of 64 random token ids,
   right-padded to lengths uniform in 16-128 (seed 0), 12 fit steps:
   K1, K2, K3 launch 12 times each a step, every attention call on the
   lengths route; losses finite and falling; step time, device time and
   operations, MFU. f32 gradients flash against dense on 8 padded
   examples within GRAD_RTOL; ``Trainer(grad_accum=2)`` against one step
   of 64 (loss, the gradients the updater gets, params after the update;
   ACCUM_* tolerances); K1-K3 at BERT's shape (BH 768, T 128, D 64,
   lengths) against their plain versions, timed beside SDPA's forward and
   backward and their bounds; BERT at steps_per_execution=2 with 1 GiB of
   other allocations made between its replays, bit-equal to eager steps.
   LeNet (batch 1024) at steps_per_execution=16: 16 graphed steps
   bit-equal to 16 eager ones in f32 and in bf16; host step time at spe=1
   and 16, device operations and device time of an eager step and of a
   replay. VGG16 (batch 64, bf16, dropout 0.5): two replays at lr 0 draw
   new masks; 12 fit steps, losses finite; step time, images/s, MFU, peak
   memory; each Dense input keeps a fraction within 4 sigma of 0.5, kept
   values exactly x / 0.5. ResNet-50 at steps_per_execution=4 (K4a and
   K4b inside a graph): 8 graphed steps bit-equal to 8 eager ones
   (losses, params, updater state, running statistics); step time and
   device time, eager against graphed. The bit-equality gates run with
   deterministic cuDNN and PyTorch's deterministic mode (warn-only); an
   op with no deterministic version would turn a gate into a comparison
   with two eager runs' spread, and say so. Launch counts under a graph
   are the launches captured times the replays.
12. rnn — the recurrent path, which reaches no kernel of the port (every
   kernel's launch count is zeroed before the phase and read after, and
   goes into the kernels line under ``launches_by_path["rnn"]``).
   ``GravesLSTMCharRNN(seed=0, tbptt=0)`` as ``bench.py:_breadth`` trains
   it (2 x GravesLSTM 200, batch 128, T 64, V 98 one-hot from
   ``np.random.RandomState(0)``, bf16 compute, rmsprop 0.1): 8 graphed
   steps (steps_per_execution=8) bit-equal to 8 eager ones in f32 and in
   bf16; host ms a step eager and graphed (eager, graph, graph, eager),
   sequences/s and characters/s, device ms and operations of an eager
   step and of a replay with the idle share, the capture's time, peak
   memory; a step's bf16 gate sigmoids op for op against
   ``torch.sigmoid``. Gated:
   losses finite; on the char corpus (rmsprop 1e-3) the loss falls by 0.5
   in 16 steps; one f32 step's gradients within 1e-4 of the CPU's from the
   same params (TF32 off); the model's own tBPTT of 50 (a 50-step chunk
   and a 14-step tail padded and masked) with one batch's loss within
   1e-4 of the CPU's, ms a batch; greedy one-hot generation of 64
   characters after 8 prompts of 16 (``TextGenerationLSTM`` and the
   char-RNN, f32), every token the argmax of one full forward at its
   position unless the top-two gap there is at most RNN_GEN_GAP_TOL
   (counted), tokens/s and device ms a decode step.

13. zoo — the rest of the CNN zoo (every kernel's launch count is zeroed
   before each path and read after it, into the kernels line under
   ``launches_by_path``). ``YOLO2(seed=0)`` at 416², 80 classes, the zoo's
   five COCO anchors, bf16 compute, adam 1e-3, batch 64 (``yolov2.cfg``'s
   ``batch=64``) on one synthetic batch from ``default_rng(0)`` (images
   N(0, 1); labels (64, 13, 13, 5, 85), 1-8 objects an image, each in the
   cell of its centre and the anchor of best IoU) repeated: 12 fit steps,
   losses finite and the last below the first, K4a and K4b 21 launches
   each a step; step ms, images/s, MFU, device ms and operations of a
   step, idle share, peak memory. ``ServeEngine`` (buckets 1, 4, 16, no
   length buckets) answering 1, 3, 16 and 5 images: in bf16 each answer
   within ENGINE_RTOL (element by element, relative with a floor) of
   ``Graph.output`` on its padded bucket batch and its x, y, confidence
   and classes within 0.05 absolute of ``Graph.output`` on its images
   alone, in f32 within ENGINE_RTOL of ``Graph.output`` on its images
   alone; a control outside each. K4a (both modes, both routes) and K4b
   against their plain versions at c1 (11,075,584 x 32), c14 and c21
   (10,816 x 1024), then every BatchNorm's shape timed with CUDA events
   beside the library's BatchNorm backward and the bytes bound, with the
   routes the wrappers counted. 8 steps at
   steps_per_execution=4 bit-equal to eager ones (K4a, K4b 21 x (1 + 1 +
   4) launches), host ms eager and graphed, device ms of a replay, the
   capture's time. f32 gradients at batch 2 (TF32 off) through K4a/K4b
   within 1e-3 of each node's largest entry of the plain versions'
   gradients. Then AlexNet, Darknet19, TinyYOLO, GoogLeNet
   (3 fit steps each, losses finite) and InceptionResNetV1,
   FaceNetNN4Small2 (embeddings served, unit norm within 1e-2) at their
   zoo sizes, bf16, batch 8, each freed after.

Prints a JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

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


def bn_shape_times(shapes, reps=10, device=True):
    """``bn_timing`` of K4a, K4b, the whole BatchNorm backward and the
    library's at every distinct (M, C) of ``shapes`` (bf16, random
    inputs), with their ``device_ms`` when ``device``, as {(M, C): {key:
    ms}}; each row also holds the routes that K4a's and K4b's wrappers
    counted in its timed calls (``k4a_routes``, ``k4b_routes``). Uses only
    ``bn_reduce``, ``bn_dx`` and ``batch_norm_train``, so it times an older
    tree's kernels too."""
    from deeplearning4j_torch.ops.batch_norm import bn_dx, bn_reduce

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for M, C in shapes:
        if (M, C) in out:
            continue
        xb, dyb = (torch.randn((M, C), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(2))
        cv = torch.randn((C,), generator=gen, device="cuda")
        routes = [getattr(w, "routes", {}) for w in (bn_reduce, bn_dx)]
        for r in routes:
            r.update(dict.fromkeys(r, 0))
        tm = bn_timing(xb, dyb, cv, cv, cv, reps=reps)
        row = {k: v for k, v in tm.items() if not k.endswith("_fn")}
        row["k4a_routes"], row["k4b_routes"] = (
            sorted(k for k, n in r.items() if n) for r in routes)
        if device:
            for key in ("k4a", "k4b", "bwd", "library"):
                row[key + "_dev"], row[key + "_ops"] = device_ms(
                    tm[key + "_fn"])
        out[(M, C)] = row
        del xb, dyb, tm
    return out


def print_bn_shapes(shapes, per_shape, tag):
    """The per-shape table of ``bn_shape_times`` and its sums over
    ``shapes`` (one entry per BatchNorm); device readings where it took
    them."""
    tot = {k: sum(per_shape[sh][k] for sh in shapes)
           for k, v in next(iter(per_shape.values())).items()
           if not isinstance(v, list)}
    dev = "k4a_dev" in tot
    elems = sum(M * C for M, C in shapes)
    # K4a reads x and dy, K4b reads them and writes dx: 5 bf16 tensors of
    # (M, C) a BatchNorm; the function itself needs only 3 (x, dy read once,
    # dx written once)
    bound = 5 * 2 * elems / PEAK_BYTES_PER_S * 1e3
    bound_fn = 3 * 2 * elems / PEAK_BYTES_PER_S * 1e3

    def on_card(key, ops=False):
        if not dev:
            return ""
        return (f", on the device {tot[key + '_dev']:.2f}"
                + (f" in {tot[key + '_ops']:.0f} device operations"
                   if ops else ""))

    print(f"[{tag}] over the {len(shapes)} BatchNorms, back to back: K4a "
          f"{tot['k4a_b2b']:.2f} ms, K4b {tot['k4b_b2b']:.2f}, K4a + K4b "
          f"{tot['k4a_b2b'] + tot['k4b_b2b']:.2f} (bound {bound:.2f})"
          + (f"; on the device (profiler) K4a {tot['k4a_dev']:.2f}, K4b "
             f"{tot['k4b_dev']:.2f}, K4a + K4b "
             f"{tot['k4a_dev'] + tot['k4b_dev']:.2f}" if dev else "")
          + f"; whole BatchNorm backward {tot['bwd']:.2f} ms, back to back "
          f"{tot['bwd_b2b']:.2f}{on_card('bwd', True)} (the function's "
          f"bound {bound_fn:.2f}); library BN backward {tot['library']:.2f}"
          f", back to back {tot['library_b2b']:.2f}{on_card('library')}")

    def times(v, key):
        return "/".join(f"{v[k]:.4f}" for k in (key, key + "_b2b",
                                                 key + "_dev") if k in v)

    print(f"[{tag}] per (M, C) x count, ms one call / back to back"
          + (" / on the device" if dev else "") + ": K4a; K4b; whole BN "
          "backward" + (" (device operations)" if dev else "") + "; library; "
          "bytes bounds of K4a, K4b; routes K4a, K4b -- " + "; ".join(
              f"{M}x{C} x{shapes.count((M, C))} {times(v, 'k4a')}, "
              f"{times(v, 'k4b')}, {times(v, 'bwd')}"
              + (f" ({v['bwd_ops']:.0f})" if dev else "")
              + f", {times(v, 'library')}, "
              f"{4 * M * C / PEAK_BYTES_PER_S * 1e3:.4f}, "
              f"{6 * M * C / PEAK_BYTES_PER_S * 1e3:.4f}, "
              f"{'+'.join(v['k4a_routes'])}, {'+'.join(v['k4b_routes'])}"
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


def _op_counts(fn, per: int = 1):
    """Device operations by name that torch.profiler records in one call
    of ``fn``, divided by ``per`` (the steps the call runs)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity

    names = Counter(e.name[:60] for e in _on_card(
        _profiled(fn, [ProfilerActivity.CUDA])))
    return {k: v / per for k, v in names.items()}


def _op_diff(a, b, top=6):
    """The names whose per-step counts differ most between two
    ``_op_counts``, as 'name a->b'."""
    keys = sorted(set(a) | set(b), key=lambda k: -abs(a.get(k, 0)
                                                      - b.get(k, 0)))
    return "; ".join(f"{k} {a.get(k, 0):g}->{b.get(k, 0):g}"
                     for k in keys[:top])


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


def _bn_grad_gate(model, params, state, x, y, rtol, what, tag):
    """f32 gradients of every param of ``model`` on (x, y): through
    K4a/K4b against through their plain versions. Each param's largest
    difference is held to ``rtol`` of the largest gradient entry of its
    node (its layer's params together): a BatchNorm whose output reaches
    only BatchNorms through ReLU and max pooling (ResNet-50's stem) has a
    beta gradient that is zero up to rounding, whose own largest entry is
    no scale."""
    from deeplearning4j_torch.ops import batch_norm
    from deeplearning4j_torch.ops.updaters import tree_leaves

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
    rel_node, worst = max(((g - w).abs().max().item() / scale[n], n)
                          for n, g, w in zip(names, got, want))
    rel_own = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                  .item() for g, w in zip(got, want))
    print(f"[{tag}] {what}, loss {loss.item():.6f} (plain "
          f"{loss_p.item():.6f}): max over params of max |kernels - plain| "
          f"/ largest gradient entry of the node {rel_node:.3g} at {worst} "
          f"(gate {rtol}); of the param itself {rel_own:.3g}")
    check(rel_node <= rtol, f"f32 {what} gradient, kernels vs plain BN "
          f"backward, rel diff {rel_node:.3g}")


def phase_resnet_grad_gate():
    """f32 gradients of every ResNet-50 param on one batch of 8 at 224²,
    through K4a/K4b against their plain versions (``_bn_grad_gate``)."""
    from deeplearning4j_torch.data import BenchmarkIterator

    model = _resnet50(None)
    params, state = model.init(seed=0)
    ds = next(iter(BenchmarkIterator((224, 224, 3), 1000, RN_GRAD_BATCH, 1,
                                     seed=1)))
    x, y = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    _bn_grad_gate(model, params, state, x, y, RN_GRAD_RTOL,
                  f"ResNet-50, batch {RN_GRAD_BATCH} at 224x224x3",
                  "resnet grad")


# ----------------------------------------------------------------- breadth
BERT_B, BERT_T, BERT_L, BERT_H = 64, 128, 12, 12
BERT_STEPS, BERT_WARMUP = 12, 2
BERT_GRAD_B = 8
LENET_B, LENET_SPE = 1024, 16
VGG_B, VGG_STEPS, VGG_WARMUP = 64, 12, 2
RN_SPE = 4
# grad_accum against one step of the whole batch, f32: the reference's
# own tolerance for the same comparison (tests/test_train.py), the
# gradients relative to each param's largest entry, and adam's eps
ACCUM_RTOL, ACCUM_ATOL = 2e-5, 1e-6
ACCUM_GRAD_RTOL = 1e-5
ADAM_EPS = 1e-8
KEEP_SIGMAS = 4.0


def _release():
    """Return what the caller has dropped (``del``) to the card."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _deterministic():
    """The bit-equality gates' settings: cuDNN's deterministic algorithms
    (benchmark off, so eager and capture pick the same ones) and PyTorch's
    deterministic mode in warn-only form, whose warnings the caller reads
    to learn whether an op on the path has no deterministic version. The
    cuBLAS workspace variable is what that mode asks for; it is read at
    each check, while the workspace size was fixed at cuBLAS's first use.
    The mode's filling of every new allocation (a kernel per ``empty``,
    for finding reads of unwritten memory) is left off: it adds device
    work that eager and captured steps would not otherwise run, and
    nothing here reads unwritten memory (the gates compare full results).
    Everything is put back after."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn = torch.backends.cudnn
    det = torch.utils.deterministic
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield caught
        finally:
            cudnn.deterministic, cudnn.benchmark = saved[:2]
            torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
            det.fill_uninitialized_memory = saved[4]


def _nondeterministic(caught):
    return sorted({str(w.message)[:160] for w in caught
                   if "deterministic" in str(w.message)})


def _trees(trainer):
    from deeplearning4j_torch.ops.updaters import tree_leaves

    return tree_leaves((trainer.params, trainer.opt_state, trainer.state))


def _max_diff(a, b):
    return max(((x.float() - y.float()).abs().max().item() if x.numel()
                else 0.0) for x, y in zip(a, b))


def _graph_vs_eager(build, batches, n, spe, what, between=None,
                    wrappers=(), tag="breadth"):
    """From one start (``build()`` twice: the same seed), 1 + ``n`` eager
    steps against iteration 0 alone then ``n`` steps at
    ``steps_per_execution=spe`` (``n // spe`` windows of one captured
    graph); ``between`` (if given) runs after the first window, before
    the others. Gated: every loss and every leaf of the params, updater
    state and net state bit-equal, under ``_deterministic``; where an op
    of the path has no deterministic version, within the spread of two
    eager runs instead (and said so). Returns (eager trainer, graphed
    trainer, eager losses, graphed losses)."""
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    def run(mode):
        rec = CollectScoresListener()
        t = Trainer(build())
        t.fit(batches(1), listeners=[rec])
        if mode == "eager":
            t.fit(batches(n), listeners=[rec])
        else:
            t.fit(batches(spe), listeners=[rec], steps_per_execution=spe)
            if between is not None:
                between()
            t.fit(batches(n - spe), listeners=[rec], steps_per_execution=spe)
        torch.cuda.synchronize()
        return t, [l for _, l in rec.scores]

    with _deterministic() as caught:
        eager, le = run("eager")
        for w in wrappers:
            w.launches = 0
        graphed, lg = run("graph")
        launches = tuple(w.launches for w in wrappers)
        nondet = _nondeterministic(caught)
        spread = None
        if nondet:
            again, la = run("eager")
            spread = max(_max_diff(_trees(eager), _trees(again)),
                         max(abs(a - b) for a, b in zip(le, la)))
            del again
            _release()
    check(graphed.captures == 1 and graphed.windows == n // spe,
          f"{what}: {graphed.captures} captures and {graphed.windows} "
          f"windows, want 1 and {n // spe}")
    check(len(le) == len(lg) == n + 1, f"{what}: {len(le)} eager and "
          f"{len(lg)} graphed losses for {n + 1} steps")
    check(all(np.isfinite(le)), f"{what}: non-finite loss {le}")
    diff = max(_max_diff(_trees(eager), _trees(graphed)),
               max(abs(a - b) for a, b in zip(le, lg)))
    if spread is None:
        check(le == lg and diff == 0.0, f"{what}: graphed steps differ from "
              f"eager ones (max diff {diff:.3g})")
        how = "bit-equal"
    else:
        check(diff <= spread, f"{what}: graphed steps differ from eager by "
              f"{diff:.3g}, beyond two eager runs' spread {spread:.3g} "
              f"(ops without a deterministic version: {nondet})")
        how = (f"within two eager runs' spread {spread:.3g} (max diff "
               f"{diff:.3g}; ops without a deterministic version: {nondet})")
    print(f"[{tag}] {what}: {n} steps as {n // spe} replays of one graph "
          f"(steps_per_execution={spe}) against {n} eager steps from the "
          f"same start: losses, params, updater and net state {how}; "
          f"losses " + " ".join(f"{l:.5f}" for l in lg))
    return eager, graphed, launches


def _seq_flop(model, batch):
    """Model FLOP of one training step of a Sequential: 2 FLOP per
    multiply-add of every conv and dense layer's forward (the input and
    weight gradients make it x 3)."""
    from deeplearning4j_torch.nn.layers import Conv2D, Dense, Output

    macs = 0
    for i, layer in enumerate(model.layers):
        shape_in, shape_out = model._shapes[i], model._shapes[i + 1]
        if isinstance(layer, Conv2D):
            kh, kw = layer.kernel
            macs += (shape_out[0] * shape_out[1] * shape_out[2] * kh * kw
                     * shape_in[-1] // layer.groups)
        elif isinstance(layer, (Dense, Output)):
            macs += int(np.prod(shape_in)) * layer.n_out
    return 6 * macs * batch


def _bert_batch(n, seed=0):
    """n padded BERT-base examples: lengths uniform in 16-128, token ids in
    [1, 30522) up to the length and 0 after, a (n, T) f32 mask, one-hot
    labels of 2 classes (numpy, seed ``seed``)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, BERT_T + 1, n)
    mask = (np.arange(BERT_T)[None] < lens[:, None]).astype(np.float32)
    x = np.where(mask > 0, rng.integers(1, 30522, (n, BERT_T)),
                 0).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y, mask, lens


def _bert(compute_dtype, flash=True):
    from deeplearning4j_torch.models import BertBase

    model = BertBase(num_classes=2, seed=0, input_shape=(BERT_T,),
                     flash=flash).build()
    model.config.compute_dtype = compute_dtype
    return model


def _bert_iter(x, y, mask, n):
    from deeplearning4j_torch.data import ArrayIterator

    return ArrayIterator(np.tile(x, (n, 1)), np.tile(y, (n, 1)),
                         batch_size=x.shape[0],
                         features_mask=np.tile(mask, (n, 1)))


def phase_bert():
    """BERT-base (12 layers, d_model 768, 12 heads, vocab 30522, adamw
    1e-4, bf16 compute, flash) trained by ``Trainer.fit`` on one padded
    batch of 64 (lengths 16-128) for 12 steps: 2 warm-up steps in one fit,
    10 timed in a second. Gated: K1, K2 and K3 launch 12 times each a step,
    on the lengths route (every K1 launch there gets a lengths vector);
    losses finite, the last below the first. Returns the launches of K1,
    K2, K3, the step time, the per-step device ms and the lengths."""
    from deeplearning4j_torch.nn.layers import attention
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    x, y, mask, lens = _bert_batch(BERT_B)
    t0 = time.perf_counter()
    model = _bert("bfloat16")
    model.init(seed=0)
    torch.cuda.synchronize()
    print(f"[breadth] BERT-base with {model.param_count()} params "
          f"initialized in {time.perf_counter() - t0:.2f} s; batch "
          f"{BERT_B} x {BERT_T}, lengths uniform in 16-128 (seed 0): mean "
          f"{lens.mean():.1f}, {int(lens.sum())} real tokens of "
          f"{BERT_B * BERT_T}")
    wrappers = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda,
                fa.flash_bwd_dkv_cuda)
    # every attention call of the fit, on the lengths route or not
    lens_seen = []
    attn = attention.flash_attention

    def attn_spy(q, k, v, **kw):
        lens_seen.append(kw.get("lengths") is not None
                         and kw.get("key_mask") is None)
        return attn(q, k, v, **kw)

    trainer = Trainer(model)
    scores = CollectScoresListener()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    attention.flash_attention = attn_spy
    try:
        t0 = time.perf_counter()
        trainer.fit(_bert_iter(x, y, mask, BERT_WARMUP), listeners=[scores])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(_bert_iter(x, y, mask, BERT_STEPS - BERT_WARMUP),
                    listeners=[scores])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        attention.flash_attention = attn
    counts = tuple(w.launches for w in wrappers)
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in scores.scores]
    check(len(losses) == BERT_STEPS, f"BERT: {len(losses)} losses for "
          f"{BERT_STEPS} steps")
    check(all(np.isfinite(losses)), f"BERT: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"BERT: loss did not fall: {losses}")
    check(counts == (BERT_L * BERT_STEPS,) * 3,
          f"BERT: launches K1, K2, K3 {counts}: want {BERT_L} each per step "
          f"over {BERT_STEPS} steps")
    check(len(lens_seen) == BERT_L * BERT_STEPS and all(lens_seen),
          f"BERT: {len(lens_seen)} attention calls, not all on the lengths "
          f"route")
    step_ms = 1e3 * (t2 - t1) / (BERT_STEPS - BERT_WARMUP)
    xs, ys, ms = (torch.from_numpy(a).cuda() for a in (x, y, mask))
    p, o, s = trainer.params, trainer.opt_state, trainer.state
    dev_ms, dev_ops = device_ms(lambda: trainer.step(p, o, s, xs, ys,
                                                     mask=ms), reps=3)
    d, L, B, T = 768, BERT_L, BERT_B, BERT_T
    pairs = T * int(lens.sum())  # every query row, the keys up to its length
    f_blocks = 6 * B * T * 12 * L * d * d
    f_attn = 12 * (d // BERT_H) * pairs * BERT_H * L
    flops = f_blocks + f_attn
    print(f"[breadth] BERT {BERT_STEPS} steps of Trainer.fit (adamw 1e-4, "
          f"bf16 compute, flash, padded): losses "
          + " ".join(f"{l:.4f}" for l in losses))
    print(f"[breadth] BERT launches K1 {counts[0]}, K2 {counts[1]}, K3 "
          f"{counts[2]} ({BERT_L} each per step, every K1 on the lengths "
          f"route); step {step_ms:.2f} ms (one fit of "
          f"{BERT_STEPS - BERT_WARMUP} steps after {BERT_WARMUP} warm-up, "
          f"window / steps), {B / step_ms * 1e3:.1f} sequences/s, "
          f"{lens.sum() / step_ms * 1e3:.0f} real tokens/s; one step on the "
          f"device {dev_ms:.2f} ms in {dev_ops:.0f} device operations "
          f"(profiler), idle share {1 - dev_ms / step_ms:.4f}; model "
          f"FLOP/step 6*B*T*12*L*d^2 {f_blocks:.4g} + 12*D*pairs*H*L "
          f"{f_attn:.4g}; MFU {flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f}"
          f" of 989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB")
    del trainer, model
    _release()
    return counts, step_ms, dev_ms, lens


def bert_grad_flash_vs_dense():
    """f32 gradients of every BERT-base param on 8 padded examples: the
    flash path (K1, K2, K3 on lengths) against the dense path's, each
    within GRAD_RTOL of the dense gradient's largest entry."""
    from deeplearning4j_torch.ops.updaters import tree_leaves

    x, y, mask, _ = _bert_batch(BERT_GRAD_B, seed=1)
    flash, dense = _bert(None, True), _bert(None, False)
    params, _ = flash.init(seed=0)
    xs, ys, ms = (torch.from_numpy(a).cuda() for a in (x, y, mask))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    grads = []
    for m in (flash, dense):
        loss, _ = m.score(params, {}, xs, ys, mask=ms)
        grads.append(torch.autograd.grad(loss, leaves))
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(*grads))
    print(f"[breadth] BERT grad flash-vs-dense, f32, {BERT_GRAD_B} padded "
          f"examples: max over params of max |flash - dense| / max |dense| "
          f"= {rel:.3g} (gate {GRAD_RTOL})")
    check(rel <= GRAD_RTOL, f"BERT f32 flash vs dense gradient rel diff "
          f"{rel:.3g}")
    del grads, leaves, params, flash, dense
    _release()


def bert_grad_accum():
    """``Trainer(grad_accum=2)`` on the padded batch of 64 against one
    step of the whole batch, f32 BERT-base from one start. Gated: the loss
    within 1e-5; the gradient each trainer hands its updater within
    ACCUM_GRAD_RTOL of the param's largest gradient entry (f32 sums in
    another order); every param after the update within ACCUM_ATOL +
    ACCUM_RTOL x |param| + (lr / eps) x |that gradient difference|: adam's
    first step maps g to lr x g / (|g| + eps), whose slope is at most
    lr / eps (1e4 here), so an entry below eps carries its f32 rounding
    difference into the param 1e4 times larger. The accumulating trainer
    ran K1 twice a layer (two microbatches)."""
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.ops.updaters import Transform, tree_leaves
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    x, y, mask, _ = _bert_batch(BERT_B)
    out = []
    for n in (1, 2):
        model = _bert(None)
        model.init(seed=0)
        rec = CollectScoresListener()
        fa.flash_fwd_cuda.launches = 0
        t = Trainer(model, grad_accum=n)
        seen = []
        update = t.tx.update

        def spy(grads, state, params=None, update=update, seen=seen):
            seen.append([g.detach().clone() for g in grads])
            return update(grads, state, params)

        t.tx = Transform(t.tx.init, spy)
        t.fit(_bert_iter(x, y, mask, 1), listeners=[rec])
        torch.cuda.synchronize()
        out.append((rec.scores[0][1], [p.detach().clone() for p in
                                       tree_leaves(t.params)],
                    seen[0], fa.flash_fwd_cuda.launches))
        cfg = model.config.updater
        del t, model
        _release()
    (l1, p1, g1, k1), (l2, p2, g2, k2) = out
    check(k1 == BERT_L and k2 == 2 * BERT_L, f"BERT grad_accum: K1 launches "
          f"{k1} (one step) and {k2} (accum 2): want {BERT_L} and "
          f"{2 * BERT_L}")
    slope = cfg["learning_rate"] / ADAM_EPS
    g_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                .item() for a, b in zip(g2, g1))
    excess = max(((a - b).abs() - ACCUM_RTOL * b.abs()
                  - slope * (ga - gb).abs()).max().item()
                 for a, b, ga, gb in zip(p2, p1, g2, g1))
    dmax = max((a - b).abs().max().item() for a, b in zip(p2, p1))
    print(f"[breadth] BERT grad_accum=2 vs one step of {BERT_B}, f32: loss "
          f"{l2:.7f} vs {l1:.7f} (rel {abs(l2 - l1) / abs(l1):.3g}); "
          f"gradients max over params of max |accum - one| / max |one| "
          f"{g_rel:.3g} (gate {ACCUM_GRAD_RTOL}); params max abs diff "
          f"{dmax:.3g}, largest excess over {ACCUM_ATOL} + {ACCUM_RTOL} x "
          f"|param| + {slope:.0f} x |gradient diff|: {excess:.3g} (gate <= "
          f"{ACCUM_ATOL})")
    check(abs(l2 - l1) <= 1e-5 * abs(l1), f"BERT grad_accum loss {l2} vs "
          f"{l1}")
    check(g_rel <= ACCUM_GRAD_RTOL, f"BERT grad_accum gradients differ by "
          f"{g_rel:.3g} of their largest entry")
    check(excess <= ACCUM_ATOL, f"BERT grad_accum params differ by "
          f"{dmax:.3g} beyond what the gradient difference explains")


def bert_kernels(lens):
    """K1, K2 and K3 at BERT-base's shape: BH = 64 x 12 = 768, T 128, D 64,
    bf16, non-causal, the fit batch's lengths repeated over each example's
    12 heads. Each against its plain version, then timed (one call, back
    to back) beside the plain version and SDPA's forward and backward on
    the same inputs with the same lengths as a boolean key mask. Bounds
    from the shape and this run's lengths: bytes read and written once,
    and 4 (forward), 6 (dQ), 8 (dK, dV) x D FLOP per (query, key) pair
    whose key is within the length."""
    from deeplearning4j_torch.ops.flash_attention import (
        flash_attention_backward_reference, flash_attention_reference,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_cuda,
        flash_fwd_cuda)

    bh, t, d = BERT_B * BERT_H, BERT_T, 64
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(102)
    q, k, v, do = _qkv(gen, bh, t, d, bf16, n=4)
    lens_t = torch.as_tensor(lens, dtype=torch.int32,
                             device="cuda").repeat_interleave(BERT_H)
    kw = dict(scale=1.0 / d ** 0.5, causal=False)
    o, lse = flash_fwd_cuda(q, k, v, lens_t, **kw)
    o_ref, lse_ref = flash_attention_reference(q, k, v, lens_t, **kw)
    err_f = _compare(o, lse, o_ref, lse_ref, "BERT shape forward")
    delta = (do.float() * o_ref.float()).sum(-1)
    got = flash_bwd_cuda(q, k, v, do, lse_ref, delta, lens_t, **kw)
    want = flash_attention_backward_reference(q, k, v, do, lse_ref, delta,
                                              lens_t, **kw)
    err_b = _bwd_compare(got, want, "BERT shape backward")
    del got, want, o_ref
    plain_f = time_ms(lambda: flash_attention_reference(q, k, v, lens_t,
                                                        **kw), reps=5,
                      warmup=1)
    plain_b = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, do, lse_ref, delta, lens_t, **kw), reps=5, warmup=1)
    keymask = (torch.arange(t, device="cuda")[None] < lens_t[:, None])
    am = keymask.view(1, bh, 1, t)
    q4, k4, v4 = (a.view(1, bh, t, d).detach().requires_grad_()
                  for a in (q, k, v))
    do4 = do.view(1, bh, t, d)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, attn_mask=am,
                                           scale=kw["scale"])

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=am,
                                       scale=kw["scale"]).backward(do4)

    lib_f, lib_f_b2b = time_ms(sdpa_fwd), time_b2b_ms(sdpa_fwd)
    lib_b = time_ms(sdpa_fwd_bwd) - lib_f
    lib_b_b2b = time_b2b_ms(sdpa_fwd_bwd) - lib_f_b2b
    pairs = t * int(lens_t.sum().item())
    esize = q.element_size()
    out = {}
    for key, fn, n_in, n_out, per_pair, plain, lib, lib_b2b in (
            ("K1", lambda: flash_fwd_cuda(q, k, v, lens_t, **kw), 3, 1, 4,
             plain_f, lib_f, lib_f_b2b),
            ("K2", lambda: flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta,
                                             lens_t, **kw), 4, 1, 6,
             plain_b, lib_b, lib_b_b2b),
            ("K3", lambda: flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta,
                                              lens_t, **kw), 4, 2, 8,
             plain_b, lib_b, lib_b_b2b)):
        # K1 also writes lse; K2, K3 read lse and delta; all read lengths
        nbytes = (n_in + n_out) * bh * t * d * esize + bh * 4 + (
            bh * t * 4 if key == "K1" else 2 * bh * t * 4)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = per_pair * d * pairs / PEAK_BF16_FLOPS * 1e3
        ms, ms_b2b = time_ms(fn), time_b2b_ms(fn)
        out[key] = {"shape": f"BH={bh} T={t} D={d} bf16 non-causal lengths",
                    "ms": ms, "ms_b2b": ms_b2b, "plain_ms": plain,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib, "library_ms_b2b": lib_b2b,
                    "max_abs_err": err_f if key == "K1" else err_b}
        print(f"[breadth] BERT shape BH={bh} T={t} D={d} bf16 non-causal "
              f"lengths (mean {float(np.mean(lens)):.1f}), {key}: kernel "
              f"{ms:.4f} ms, back to back {ms_b2b:.4f}; bound "
              f"{out[key]['bound_ms']:.4f} ms ({out[key]['bound_by']}); "
              f"plain {plain:.4f}; sdpa {'forward' if key == 'K1' else 'backward (dq, dk, dv)'} "
              f"{lib:.4f}, back to back {lib_b2b:.4f}")
    return out


def bert_graph_check():
    """BERT-base (bf16, flash, padded batch) at steps_per_execution=2:
    iteration 0, one window, then 1 GiB of other allocations filled with
    NaN and held, then a second window, against 5 eager steps from the
    same start, bit for bit: the graph replays K1-K3 with the TMA
    descriptors of its capture, right only while its buffers stay its
    own."""
    x, y, mask, _ = _bert_batch(BERT_B)
    junk = []

    def between():
        junk.extend(torch.full((1 << 26,), float("nan"), device="cuda")
                    for _ in range(4))

    def build():
        m = _bert("bfloat16")
        m.init(seed=0)
        return m

    from deeplearning4j_torch.ops import flash_attention as fa

    wrappers = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda,
                fa.flash_bwd_dkv_cuda)
    eager, graphed, launches = _graph_vs_eager(
        build, lambda n: _bert_iter(x, y, mask, n), 4, 2,
        "BERT-base bf16 flash, 1 GiB allocated between replays",
        between=between, wrappers=wrappers)
    want = BERT_L * (1 + 1 + 2)
    check(launches == (want,) * 3, f"BERT graph: K1, K2, K3 launches "
          f"{launches}: want {want} each (iteration 0, the warm-up step, 2 "
          f"captured steps)")
    print(f"[breadth] BERT graph: K1, K2, K3 {BERT_L * 2} launches each "
          f"captured, replayed {graphed.windows} times = "
          f"{BERT_L * 2 * graphed.windows} each")
    replayed = BERT_L * 2 * graphed.windows
    del eager, graphed, junk
    _release()
    return replayed


def _lenet(compute_dtype):
    from deeplearning4j_torch.models import LeNet

    model = LeNet(num_classes=10, seed=0, input_shape=(28, 28, 1)).build()
    model.config.compute_dtype = compute_dtype
    model.init(seed=0)
    return model


def phase_lenet():
    """LeNet (batch 1024, adam 1e-3) with steps_per_execution=16. Gated,
    in f32 and in bf16 compute: 16 graphed steps from one start equal 16
    eager steps bit for bit (losses, params, updater state). Then in bf16:
    the host step time at spe=1 and spe=16 (64 steps of a repeated batch,
    eager, graphed, graphed, eager), the device operations and device
    time of one eager step and of one replay (16 steps) under
    torch.profiler."""
    from deeplearning4j_torch.data import ArrayIterator, BenchmarkIterator

    rng = np.random.default_rng(0)
    n = 1 + LENET_SPE
    xs = rng.standard_normal((n * LENET_B, 28, 28, 1)).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n * LENET_B)]
    for cdt in (None, "bfloat16"):
        pos = [0]

        def batches(k):
            it = ArrayIterator(xs[pos[0] * LENET_B:(pos[0] + k) * LENET_B],
                               ys[pos[0] * LENET_B:(pos[0] + k) * LENET_B],
                               batch_size=LENET_B)
            pos[0] = (pos[0] + k) % n
            return it

        eager, graphed, _ = _graph_vs_eager(
            lambda: _lenet(cdt), batches, LENET_SPE, LENET_SPE,
            f"LeNet {cdt or 'float32'} batch {LENET_B}")
    times = {"eager": [], "graph": []}
    steps = 4 * LENET_SPE
    ds = next(iter(BenchmarkIterator((28, 28, 1), 10, LENET_B, 1, seed=0)))
    xb, yb = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    p, o, s = eager.params, eager.opt_state, eager.state
    window = [(xb, yb, None, None)] * LENET_SPE
    # the settings the graph was captured under (its cuDNN algorithms)
    with _deterministic():
        for which in ("eager", "graph", "graph", "eager"):
            t = eager if which == "eager" else graphed
            it = BenchmarkIterator((28, 28, 1), 10, LENET_B, steps, seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit(it, steps_per_execution=1 if which == "eager"
                  else LENET_SPE)
            torch.cuda.synchronize()
            times[which].append(1e3 * (time.perf_counter() - t0) / steps)
        step_dev, step_ops = device_ms(lambda: eager.step(p, o, s, xb, yb),
                                       reps=5)
        rep_dev, rep_ops = device_ms(lambda: graphed._replay(window), reps=3)
        diff = _op_diff(_op_counts(lambda: eager.step(p, o, s, xb, yb)),
                        _op_counts(lambda: graphed._replay(window),
                                   LENET_SPE))
    check(graphed.captures == 1, f"LeNet: {graphed.captures} captures")
    flop = _seq_flop(eager.model, LENET_B)
    print(f"[breadth] LeNet bf16 batch {LENET_B}, deterministic cuDNN, host "
          f"step time over {steps} steps (eager, graph, graph, eager): spe=1 "
          + ", ".join(f"{v:.3f}" for v in times["eager"]) + " ms; spe="
          f"{LENET_SPE} " + ", ".join(f"{v:.3f}" for v in times["graph"])
          + f" ms; one eager step on the device {step_dev:.3f} ms in "
          f"{step_ops:.0f} device operations; one replay ({LENET_SPE} steps)"
          f" {rep_dev:.3f} ms in {rep_ops:.0f} ({rep_dev / LENET_SPE:.3f} ms"
          f", {rep_ops / LENET_SPE:.1f} operations a step; the replay's "
          f"slot copies included); model FLOP/step {flop:.4g}")
    print(f"[breadth] LeNet device operations a step, eager -> graphed, "
          f"the names that differ most: {diff}")
    del eager, graphed
    _release()
    return {"eager_ms": times["eager"], "graph_ms": times["graph"],
            "step_dev_ms": step_dev, "step_ops": step_ops,
            "replay_dev_ms": rep_dev, "replay_ops": rep_ops}


def phase_vgg():
    """VGG16 (batch 64, bf16 compute, adam 1e-3, dropout 0.5 on the inputs
    of its two 4096-wide Dense layers) trained by ``Trainer.fit`` for 12
    steps (2 warm-up, 10 timed). Gated: losses finite; on the card each
    Dense input keeps a fraction within 4 sigma of 0.5, kept values exactly
    x / 0.5; at steps_per_execution=2 with the learning rate at 0 (the
    loss then moves only with the masks) two replays' losses differ, and
    so do a window's two."""
    from deeplearning4j_torch.data import BenchmarkIterator
    from deeplearning4j_torch.models import VGG16
    from deeplearning4j_torch.nn.api import apply_input_dropout
    from deeplearning4j_torch.nn.layers import Dense
    from deeplearning4j_torch.ops import updaters as upd
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    t0 = time.perf_counter()
    model = VGG16(num_classes=1000, seed=0, input_shape=(224, 224, 3)).build()
    model.config.compute_dtype = "bfloat16"
    model.init(seed=0)
    torch.cuda.synchronize()
    print(f"[breadth] VGG16 with {model.param_count()} params initialized "
          f"in {time.perf_counter() - t0:.2f} s")

    def batches(k):
        return BenchmarkIterator((224, 224, 3), 1000, VGG_B, k, seed=0)

    # the masks first, from the initial params (a trained model's loss
    # may round to the same value under two masks)
    frozen = Trainer(model, updater=upd.sgd(learning_rate=0.0))
    rec = CollectScoresListener()
    frozen.fit(batches(1), listeners=[rec])
    frozen.fit(batches(4), listeners=[rec], steps_per_execution=2)
    torch.cuda.synchronize()
    lz = [l for _, l in rec.scores]
    check(frozen.captures == 1 and frozen.windows == 2,
          f"VGG16 spe=2: {frozen.captures} captures, {frozen.windows} "
          f"windows")
    check(all(np.isfinite(lz)) and lz[1:3] != lz[3:5] and lz[1] != lz[2],
          f"VGG16 spe=2 at lr 0: replays repeated their dropout masks: {lz}")
    print(f"[breadth] VGG16 steps_per_execution=2 at lr 0, 2 replays of one "
          f"graph: losses {lz[1]:.6f} {lz[2]:.6f} | {lz[3]:.6f} "
          f"{lz[4]:.6f} (iteration 0 alone {lz[0]:.6f}): every step drew "
          f"new masks")
    del frozen
    _release()
    trainer = Trainer(model)
    scores = CollectScoresListener()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(batches(VGG_WARMUP), listeners=[scores])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.fit(batches(VGG_STEPS - VGG_WARMUP), listeners=[scores])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in scores.scores]
    check(len(losses) == VGG_STEPS and all(np.isfinite(losses)),
          f"VGG16: losses {losses}")
    step_ms = 1e3 * (t2 - t1) / (VGG_STEPS - VGG_WARMUP)
    flop = _seq_flop(model, VGG_B)
    ds = next(iter(batches(1)))
    xb, yb = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    p, o, s = trainer.params, trainer.opt_state, trainer.state
    dev_ms, dev_ops = device_ms(lambda: trainer.step(p, o, s, xb, yb,
                                                     trainer._gen), reps=3)
    print(f"[breadth] VGG16 {VGG_STEPS} steps of Trainer.fit (adam 1e-3, "
          f"bf16 compute, dropout 0.5), batch {VGG_B} at 224x224x3: losses "
          + " ".join(f"{l:.4f}" for l in losses))
    print(f"[breadth] VGG16 step {step_ms:.2f} ms (one fit of "
          f"{VGG_STEPS - VGG_WARMUP} steps after {VGG_WARMUP} warm-up), "
          f"{VGG_B / step_ms * 1e3:.1f} images/s; one step on the device "
          f"{dev_ms:.2f} ms in {dev_ops:.0f} device operations (profiler), "
          f"idle share {1 - dev_ms / step_ms:.4f}; model FLOP/step {flop:.4g}"
          f"; MFU {flop / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f} of 989 "
          f"TFLOP/s; peak memory {peak / 2**30:.2f} GiB")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            if not (isinstance(layer, Dense) and layer.dropout):
                continue
            feats, _ = model.forward(p, s, xb, up_to=i)
            feats = feats.to(torch.bfloat16)  # the dtype the step feeds it
            dropped = apply_input_dropout(layer, feats, gen, True)
            kept = dropped != 0
            live = feats != 0  # a 0 input stays 0 either way
            n_live = int(live.sum())
            n_kept = int((kept & live).sum())
            sigma = (n_live * 0.25) ** 0.5
            exact = torch.equal(dropped[kept], feats[kept] / 0.5)
            print(f"[breadth] VGG16 layer {i} (Dense {layer.n_out}) input "
                  f"{tuple(feats.shape)} bf16: kept {n_kept} of {n_live} "
                  f"nonzero ({n_kept / n_live:.5f}; 0.5 +- 4 sigma = "
                  f"{KEEP_SIGMAS * sigma / n_live:.5f}); kept values x / 0.5"
                  f" exactly: {exact}")
            check(abs(n_kept - 0.5 * n_live) <= KEEP_SIGMAS * sigma,
                  f"VGG16 layer {i}: kept {n_kept} of {n_live}")
            check(exact, f"VGG16 layer {i}: a kept value is not x / 0.5")
    del trainer, model
    _release()
    return step_ms


def phase_resnet_graph():
    """ResNet-50 (the [resnet] config, batch 128) at steps_per_execution=4:
    iteration 0 alone, then 8 steps as 2 replays of one graph, against 9
    eager steps from the same start: losses, params, updater state and the
    BatchNorm running statistics bit-equal (``_graph_vs_eager``). K4a and
    K4b launch 53 times each for iteration 0, the warm-up step and each
    of the 4 captured steps; a replay runs the captured 4 x 53 again.
    Then the step time, eager against graphed, over 8 steps (eager,
    graphed, graphed, eager) under the same deterministic settings."""
    from deeplearning4j_torch.data import BenchmarkIterator, DataSet
    from deeplearning4j_torch.ops.batch_norm import bn_dx, bn_reduce_coeffs

    n_bn = len(_bn_nodes(_resnet50("bfloat16"), RN_BATCH))

    def build():
        m = _resnet50("bfloat16")
        m.init(seed=0)
        return m

    def batches(k):
        return BenchmarkIterator((224, 224, 3), 1000, RN_BATCH, k, seed=0)

    eager, graphed, total = _graph_vs_eager(
        build, batches, 2 * RN_SPE, RN_SPE, f"ResNet-50 bf16 batch {RN_BATCH}",
        wrappers=(bn_reduce_coeffs, bn_dx))
    # iteration 0, the warm-up step and the 4 captured steps launch
    want = n_bn * (1 + 1 + RN_SPE)
    check(total == (want, want), f"ResNet-50 graph: K4a, K4b launches "
          f"{total}: want {want} each (iteration 0, the warm-up step, "
          f"{RN_SPE} captured steps)")
    counts = {"captured": n_bn * RN_SPE, "replays": graphed.windows}
    ds = next(iter(batches(1)))
    xb, yb = (torch.from_numpy(a).cuda() for a in (ds.features, ds.labels))
    p, o, s = eager.params, eager.opt_state, eager.state
    with _deterministic():
        step_dev, step_ops = device_ms(lambda: eager.step(p, o, s, xb, yb),
                                       reps=2)
        window = [(xb, yb, None, None)] * RN_SPE
        rep_dev, rep_ops = device_ms(lambda: graphed._replay(window), reps=2)
    print(f"[breadth] ResNet-50 on the device (profiler, deterministic "
          f"cuDNN): one eager step {step_dev:.2f} ms in {step_ops:.0f} "
          f"device operations; one replay ({RN_SPE} steps) {rep_dev:.2f} ms "
          f"in {rep_ops:.0f} ({rep_dev / RN_SPE:.2f} ms, "
          f"{rep_ops / RN_SPE:.0f} operations a step)")
    del p, o, s
    times = {"eager": [], "graph": [], "eager_on_card": [],
             "graph_on_card": []}
    steps = 2 * RN_SPE
    on_card = [DataSet(xb, yb)] * steps
    with _deterministic():
        for which in ("eager", "graph", "graph", "eager", "eager_on_card",
                      "graph_on_card", "graph_on_card", "eager_on_card"):
            t = eager if which.startswith("eager") else graphed
            it = on_card if which.endswith("on_card") else batches(steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit(it, steps_per_execution=1 if t is eager else RN_SPE)
            torch.cuda.synchronize()
            times[which].append(1e3 * (time.perf_counter() - t0) / steps)
    check(graphed.captures == 1, f"ResNet-50: {graphed.captures} captures")
    print(f"[breadth] ResNet-50 graph: K4a and K4b {n_bn * RN_SPE} launches "
          f"captured ({n_bn} x {RN_SPE} steps), replayed {counts['replays']} "
          f"times = {n_bn * RN_SPE * counts['replays']} each in the gate; "
          f"step time over "
          f"{steps} steps, deterministic cuDNN (eager, graphed, graphed, "
          f"eager): eager " + ", ".join(f"{v:.2f}" for v in times["eager"])
          + " ms; graphed " + ", ".join(f"{v:.2f}" for v in times["graph"])
          + f" ms at steps_per_execution={RN_SPE}; with the batch already on "
          f"the card: eager " + ", ".join(
              f"{v:.2f}" for v in times["eager_on_card"]) + " ms, graphed "
          + ", ".join(f"{v:.2f}" for v in times["graph_on_card"]) + " ms")
    del eager, graphed
    _release()
    return counts, times


def phase_breadth():
    """[breadth]: BERT-base, LeNet, VGG16 and ResNet-50 under a captured
    step. Returns what the kernels line needs."""
    bert_counts, bert_step_ms, bert_dev_ms, lens = phase_bert()
    bert_grad_flash_vs_dense()
    bert_grad_accum()
    bert_rows = bert_kernels(lens)
    share = BERT_L * sum(bert_rows[k]["ms_b2b"] for k in ("K1", "K2", "K3"))
    print(f"[breadth] BERT: K1 + K2 + K3 back to back x {BERT_L} layers = "
          f"{share:.2f} ms of a {bert_step_ms:.2f} ms step "
          f"({share / bert_step_ms:.4f}; of the device's {bert_dev_ms:.2f} "
          f"ms, {share / bert_dev_ms:.4f})")
    bert_graph = bert_graph_check()
    lenet = phase_lenet()
    vgg_ms = phase_vgg()
    rn_counts, rn_times = phase_resnet_graph()
    return {"bert_launches": bert_counts, "bert_rows": bert_rows,
            "bert_graph": bert_graph,
            "lenet": lenet, "vgg_ms": vgg_ms, "resnet_graph": rn_counts,
            "resnet_graph_ms": rn_times}


# --- [rnn]: the GravesLSTM char-RNN and one-hot generation ---
RNN_B, RNN_T, RNN_V, RNN_H = 128, 64, 98, 200
RNN_SPE = 8
RNN_TIMED = 2 * RNN_SPE        # steps of each host-time fit
RNN_GRAD_RTOL = 1e-4           # f32 card gradients vs the CPU's, per param
RNN_TBPTT_RTOL = 1e-4          # f32 tBPTT batch loss, card vs CPU
RNN_TBPTT_BATCHES = 6
RNN_LEARN_LR, RNN_LEARN_STEPS = 1e-3, 16
RNN_GEN_B, RNN_GEN_TP, RNN_GEN_N = 8, 16, 64
# f32 decode against the same model's full forward: the two differ only in
# the products' shapes (rounding near 1e-6 of a log-prob), so a top-two gap
# above 1e-4 must give the same argmax
RNN_GEN_GAP_TOL = 1e-4


def _kernel_wrappers():
    from deeplearning4j_torch.ops.batch_norm import (bn_dx, bn_reduce,
                                                     bn_reduce_coeffs)
    from deeplearning4j_torch.ops.flash_attention import (
        column_broadcast_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_fwd_cuda)

    return {"K1": flash_fwd_cuda, "K2": flash_bwd_dq_cuda,
            "K3": flash_bwd_dkv_cuda, "K4a": bn_reduce_coeffs,
            "K4a_unfused": bn_reduce, "K4b": bn_dx,
            "K5": column_broadcast_cuda}


def _charrnn(compute_dtype, tbptt=0, lr=None, device=None, init=True):
    """``GravesLSTMCharRNN(seed=0, tbptt=tbptt)`` (2 x GravesLSTM 200 over
    (64, 98) one-hot characters, rmsprop 0.1) on ``device`` (the card
    unless named), with its params from seed 0 when ``init``; ``lr``
    replaces rmsprop's learning rate."""
    from deeplearning4j_torch.models import GravesLSTMCharRNN

    model = GravesLSTMCharRNN(seed=0, tbptt=tbptt, device=device).build()
    model.config.compute_dtype = compute_dtype
    if lr is not None:
        model.config.updater = {"type": "rmsprop", "learning_rate": lr}
    if init:
        model.init(seed=0)
    return model


def _on_cpu(model, **kw):
    """``_charrnn(**kw)`` on the CPU holding a copy of ``model``'s
    params."""
    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten

    cpu = _charrnn(device="cpu", init=False, **kw)
    cpu.params = tree_unflatten(model.params, [
        t.detach().cpu().clone() for t in tree_leaves(model.params)])
    cpu.state = {}
    return cpu


def _rnn_bench_batch():
    """The bench's char-RNN batch: (128, 64) ids and labels uniform in
    [0, 98) from ``np.random.RandomState(0)``, one-hot (f32)."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, RNN_V, (RNN_B, RNN_T))
    x = np.eye(RNN_V, dtype=np.float32)[ids]
    y = np.eye(RNN_V, dtype=np.float32)[rng.randint(0, RNN_V, (RNN_B, RNN_T))]
    return x, y


def _rnn_iter(x, y, n):
    from deeplearning4j_torch.data import ArrayIterator

    return ArrayIterator(np.tile(x, (n, 1, 1)), np.tile(y, (n, 1, 1)),
                         batch_size=x.shape[0])


def _rnn_flop(batch, T):
    """Model FLOP of one char-RNN training step: 2 FLOP per multiply-add of
    the two layers' input and recurrent products and the output layer, x 3
    for the input and weight gradients."""
    H, V = RNN_H, RNN_V
    macs = batch * T * (V * 4 * H + H * 4 * H + H * 4 * H + H * 4 * H + H * V)
    return 6 * macs


def rnn_train(where):
    """The bench's char-RNN (bf16 compute, rmsprop 0.1, full BPTT) on its
    random batch. Gated: graphed steps (steps_per_execution=8) bit-equal to
    eager ones in bf16 and in f32, losses finite. Printed: host ms a step
    eager and graphed, sequences/s and characters/s, device ms and device
    operations of an eager step and of a replay, the idle share, the
    capture's time and peak memory."""
    from deeplearning4j_torch.train import Trainer

    x, y = _rnn_bench_batch()
    batches = lambda k: _rnn_iter(x, y, k)
    for cdt in (None, "bfloat16"):
        eager, graphed, _ = _graph_vs_eager(
            lambda: _charrnn(cdt), batches, RNN_SPE, RNN_SPE,
            f"GravesLSTMCharRNN {cdt or 'float32'} batch {RNN_B}",
            tag="rnn")
        if cdt is None:
            del eager, graphed
            _release()
    times = {"eager": [], "graph": []}
    xb, yb = (torch.from_numpy(a).cuda() for a in (x, y))
    window = [(xb, yb, None, None)] * RNN_SPE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _deterministic():
        for which in ("eager", "graph", "graph", "eager"):
            t = eager if which == "eager" else graphed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit(batches(RNN_TIMED), steps_per_execution=1
                  if which == "eager" else RNN_SPE)
            torch.cuda.synchronize()
            times[which].append(1e3 * (time.perf_counter() - t0) / RNN_TIMED)
        peak = torch.cuda.max_memory_allocated()
        p, o, s = eager.params, eager.opt_state, eager.state
        step_dev, step_ops = device_ms(lambda: eager.step(p, o, s, xb, yb),
                                       reps=3)
        rep_dev, rep_ops = device_ms(lambda: graphed._replay(window), reps=2)
        # a capture of its own, timed: the warm-up step and the recording
        fresh = Trainer(_charrnn("bfloat16"))
        fresh.fit(batches(1))
        staged = [tuple(fresh._stage(a) for a in (xb, yb, None, None))] \
            * RNN_SPE
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap = fresh._capture(staged)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        del cap, fresh
    eager_ms = statistics.median(times["eager"])
    graph_ms = statistics.median(times["graph"])
    flop = _rnn_flop(RNN_B, RNN_T)
    print(f"[rnn] GravesLSTMCharRNN bf16 batch {RNN_B} x T {RNN_T} x V "
          f"{RNN_V}, hidden {RNN_H}, rmsprop 0.1, full BPTT, on {where}: host "
          f"ms a step over {RNN_TIMED} steps (eager, graph, graph, eager): "
          f"eager " + ", ".join(f"{v:.3f}" for v in times["eager"])
          + f"; steps_per_execution={RNN_SPE} "
          + ", ".join(f"{v:.3f}" for v in times["graph"]) + " ms")
    print(f"[rnn] throughput on {where}: eager {RNN_B / eager_ms * 1e3:.1f} "
          f"sequences/s, {RNN_B * RNN_T / eager_ms * 1e3:.0f} characters/s; "
          f"graphed {RNN_B / graph_ms * 1e3:.1f} sequences/s, "
          f"{RNN_B * RNN_T / graph_ms * 1e3:.0f} characters/s")
    print(f"[rnn] device on {where}: one eager step {step_dev:.3f} ms in "
          f"{step_ops:.0f} device operations (idle share "
          f"{1 - step_dev / eager_ms:.4f} of the {eager_ms:.3f} ms host "
          f"step); one replay ({RNN_SPE} steps) {rep_dev:.3f} ms in "
          f"{rep_ops:.0f} ({rep_dev / RNN_SPE:.3f} ms, "
          f"{rep_ops / RNN_SPE:.1f} operations a step, the slot copies "
          f"included; idle share {1 - rep_dev / RNN_SPE / graph_ms:.4f} of "
          f"the {graph_ms:.3f} ms graphed host step)")
    print(f"[rnn] capture of {RNN_SPE} steps on {where} (its warm-up step "
          f"included): {capture_s:.3f} s; peak memory "
          f"{peak / 2**30:.3f} GiB; model FLOP/step {flop:.4g} "
          f"({flop / (graph_ms * 1e-3) / PEAK_BF16_FLOPS:.5f} of 989 "
          f"TFLOP/s at the graphed step; the step's bound at that rate "
          f"{1e3 * flop / PEAK_BF16_FLOPS:.4f} ms, so a replayed step is "
          f"{rep_dev / RNN_SPE / (1e3 * flop / PEAK_BF16_FLOPS):.0f}x it)")
    del eager, graphed
    _release()
    return {"eager_ms": times["eager"], "graph_ms": times["graph"],
            "step_dev_ms": step_dev, "step_ops": step_ops,
            "replay_dev_ms": rep_dev, "replay_ops": rep_ops,
            "capture_s": capture_s, "peak_gib": peak / 2**30}


def rnn_sigmoid_cost(where):
    """The bf16 sigmoid written op for op (negate, exp, add 1, reciprocal,
    as XLA rounds it) against ``torch.sigmoid``: a step's 3 x 64 x 2 gate
    sigmoids forward at the gate shape (128, 200), on the device and on
    the host clock (the backward is the same formula both ways)."""
    from deeplearning4j_torch.ops.activations import sigmoid

    z = torch.randn(RNN_B, RNN_H, device="cuda").bfloat16()
    n = 3 * RNN_T * 2
    out = {}
    for name, fn in (("op for op", sigmoid), ("torch.sigmoid", torch.sigmoid)):
        run = lambda: [fn(z) for _ in range(n)]
        with torch.no_grad():
            out[name] = (time_ms(run, reps=5, warmup=2),
                         *device_ms(run, reps=3))
    (h1, d1, o1), (h2, d2, o2) = out["op for op"], out["torch.sigmoid"]
    print(f"[rnn] a step's {n} bf16 gate sigmoids at ({RNN_B}, {RNN_H}) on "
          f"{where}: op for op {d1:.4f} ms on the device in {o1:.0f} "
          f"operations, {h1:.3f} ms on the host clock; torch.sigmoid "
          f"{d2:.4f} ms in {o2:.0f}, {h2:.3f} ms; the difference {d1 - d2:.4f}"
          f" ms of device time and {h1 - h2:.3f} ms of host a step")
    return d1 - d2


def rnn_learns(where):
    """The bench-width char-RNN (bf16) learns the char corpus: 16 fit
    steps of 128 windows of 64 characters (next-character labels) at
    rmsprop 1e-3, losses finite and the last four's mean at least 0.5
    below the first four's. At the config's own rate of 0.1 the loss rises
    after the second step in both packages (rmsprop's first update is
    lr / sqrt(1 - 0.95) = 4.5 lr a weight), so the learning gate takes a
    smaller rate."""
    from deeplearning4j_torch.data import ArrayIterator, char_rnn_corpus
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    ids, _ = char_rnn_corpus(200_000, seed=0)
    n = RNN_LEARN_STEPS * RNN_B
    starts = np.random.RandomState(0).randint(0, len(ids) - RNN_T - 1, n)
    seq = ids[starts[:, None] + np.arange(RNN_T + 1)]
    eye = np.eye(RNN_V, dtype=np.float32)
    rec = CollectScoresListener()
    Trainer(_charrnn("bfloat16", lr=RNN_LEARN_LR)).fit(
        ArrayIterator(eye[seq[:, :-1]], eye[seq[:, 1:]], batch_size=RNN_B),
        listeners=[rec])
    losses = [l for _, l in rec.scores]
    check(len(losses) == RNN_LEARN_STEPS and all(np.isfinite(losses)),
          f"char corpus: losses {losses}")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    check(last <= first - 0.5, f"char corpus: the loss did not fall "
          f"(first four {first:.4f}, last four {last:.4f}): {losses}")
    print(f"[rnn] char corpus on {where}, bf16, rmsprop {RNN_LEARN_LR}, "
          f"{RNN_LEARN_STEPS} steps: losses " + " ".join(
              f"{l:.4f}" for l in losses))


def rnn_grad_gate(where):
    """One f32 step's gradients on the card against the same step on the
    CPU from the same params (TF32 off): every param's within
    RNN_GRAD_RTOL of its largest entry."""
    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten

    x, y = _rnn_bench_batch()
    model = _charrnn(None)
    cpu = _on_cpu(model, compute_dtype=None)

    def grads(m, dev):
        leaves = [t.detach().clone().requires_grad_() for t in
                  tree_leaves(m.params)]
        params = tree_unflatten(m.params, leaves)
        loss, _ = m.score(params, {}, torch.from_numpy(x).to(dev),
                          torch.from_numpy(y).to(dev), training=True)
        return loss.item(), [g.double().cpu() for g in
                             torch.autograd.grad(loss, leaves)]

    l_card, g_card = grads(model, "cuda")
    l_cpu, g_cpu = grads(cpu, "cpu")
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(g_card, g_cpu))
    check(worst <= RNN_GRAD_RTOL, f"char-RNN f32 gradients: card vs CPU "
          f"{worst:.3g} of the largest entry > {RNN_GRAD_RTOL}")
    print(f"[rnn] f32 gradients of one full-width step, {where} against the "
          f"CPU from the same params (TF32 off): worst param "
          f"{worst:.3g} of its largest entry (gate {RNN_GRAD_RTOL}); loss "
          f"{l_card:.6f} on the card, {l_cpu:.6f} on the CPU")
    del model, cpu
    _release()


def rnn_tbptt(where):
    """The model's own tBPTT of 50 steps at T 64 (a 50-step chunk, then a
    14-step tail padded and masked), bf16 config (the chunks train in f32,
    the reference's contract). Gated: one batch's loss on the card within
    RNN_TBPTT_RTOL of the CPU's from the same params; losses finite over
    RNN_TBPTT_BATCHES batches. Printed: host ms a batch, device ms and
    operations of a batch."""
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    x, y = _rnn_bench_batch()
    model = _charrnn("bfloat16", tbptt=50)
    cpu = _on_cpu(model, compute_dtype="bfloat16", tbptt=50)
    first = []
    for m in (model, cpu):
        rec = CollectScoresListener()
        Trainer(m).fit(_rnn_iter(x, y, 1), listeners=[rec])
        first.append(rec.scores[0][1])
    rel = abs(first[0] - first[1]) / abs(first[1])
    check(rel <= RNN_TBPTT_RTOL, f"tBPTT batch loss: card {first[0]:.7f}, "
          f"CPU {first[1]:.7f} (relative {rel:.3g} > {RNN_TBPTT_RTOL})")
    trainer = Trainer(model)
    rec = CollectScoresListener()
    trainer.fit(_rnn_iter(x, y, 1), listeners=[rec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(_rnn_iter(x, y, RNN_TBPTT_BATCHES), listeners=[rec])
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0) / RNN_TBPTT_BATCHES
    losses = [l for _, l in rec.scores]
    check(all(np.isfinite(losses)), f"tBPTT losses {losses}")
    xb, yb = (torch.from_numpy(a).cuda() for a in (x, y))
    dev_ms, dev_ops = device_ms(
        lambda: trainer._fit_tbptt_batch(xb, yb, None, None), reps=2)
    print(f"[rnn] tBPTT 50 at T {RNN_T} (chunks of 50 and 14 padded to 50), "
          f"f32 chunks under the bf16 config, on {where}: first batch's "
          f"loss card {first[0]:.7f}, CPU {first[1]:.7f} (relative "
          f"{rel:.3g}, gate {RNN_TBPTT_RTOL}); host ms a batch over "
          f"{RNN_TBPTT_BATCHES} batches {batch_ms:.3f} ms "
          f"({RNN_B * RNN_T / batch_ms * 1e3:.0f} characters/s); one "
          f"batch on the device {dev_ms:.3f} ms in {dev_ops:.0f} device "
          f"operations; losses " + " ".join(f"{l:.4f}" for l in losses))
    del model, cpu, trainer
    _release()
    return batch_ms, dev_ms


def rnn_generate(where):
    """Greedy one-hot generation of RNN_GEN_N characters after RNN_GEN_B
    prompts of RNN_GEN_TP random characters (RandomState(1)), f32, for
    ``TextGenerationLSTM`` (2 x LSTM 256, V 77) and the char-RNN. Gated:
    every token is the argmax of one full forward over prompt + generated
    at its position, unless the top-two log-prob gap there is at most
    RNN_GEN_GAP_TOL (counted and skipped). Printed: tokens/s of ``generate``
    and device ms and operations of one decode step."""
    from deeplearning4j_torch.models import (GravesLSTMCharRNN,
                                             TextGenerationLSTM)
    from deeplearning4j_torch.nn.generation import (decode_forward,
                                                    generate, init_caches)

    out = {}
    for name, build in (("TextGenerationLSTM",
                         lambda: TextGenerationLSTM(seed=0).build()),
                        ("GravesLSTMCharRNN",
                         lambda: GravesLSTMCharRNN(seed=0, tbptt=0).build())):
        model = build()
        model.init(seed=0)
        V = model.input_shape[-1]
        ids = np.random.RandomState(1).randint(0, V, (RNN_GEN_B, RNN_GEN_TP))
        eye = np.eye(V, dtype=np.float32)
        prompt = eye[ids]
        toks = generate(model, prompt, RNN_GEN_N, temperature=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = generate(model, prompt, RNN_GEN_N, temperature=0.0)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        check(toks.shape == (RNN_GEN_B, RNN_GEN_N) and
              np.array_equal(toks, again), f"{name}: generate gave "
              f"{toks.shape}, or two calls differ")
        full = eye[np.concatenate([ids, toks], axis=1)]
        logp = torch.log(model.output(full).float())
        compared = ties = 0
        for b in range(RNN_GEN_B):
            c, t = _gap_rule(toks[b], logp[b], RNN_GEN_TP,
                             f"{name} row {b}", RNN_GEN_GAP_TOL)
            compared, ties = compared + c, ties + t
        caches = init_caches(model, RNN_GEN_B, RNN_GEN_TP + RNN_GEN_N,
                             model.dtype)
        x1 = torch.from_numpy(prompt[:, :1]).cuda()
        with torch.inference_mode():
            dev_ms, dev_ops = device_ms(lambda: decode_forward(
                model, model.params, model.state, x1, caches, RNN_GEN_TP),
                reps=10)
        n = RNN_GEN_B * RNN_GEN_N
        print(f"[rnn] generate {name} f32 on {where}: {RNN_GEN_B} one-hot "
              f"prompts of {RNN_GEN_TP}, {RNN_GEN_N} greedy characters "
              f"each: {compared} tokens equal to the full forward's argmax, "
              f"{ties} near-ties (top-two gap <= {RNN_GEN_GAP_TOL}) skipped; "
              f"{n / gen_s:.0f} tokens/s ({1e3 * gen_s / RNN_GEN_N:.3f} ms "
              f"of host time a step of {RNN_GEN_B}); one decode step on "
              f"the device {dev_ms:.4f} ms in {dev_ops:.0f} device "
              f"operations")
        out[name] = {"tokens_per_s": n / gen_s, "dev_ms": dev_ms,
                     "ties": ties}
        del model
        _release()
    return out


def phase_rnn():
    """[rnn]: the recurrent path. Kernel launch counts are zeroed before
    and read after: the path reaches no kernel of the port. Returns the
    counts by kernel."""
    where = card()
    print(f"[rnn] card: {where}")
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    train = rnn_train(where)
    rnn_sigmoid_cost(where)
    rnn_learns(where)
    rnn_grad_gate(where)
    tbptt_ms, tbptt_dev = rnn_tbptt(where)
    gen = rnn_generate(where)
    counts = {k: w.launches for k, w in wrappers.items()}
    print(f"[rnn] kernel launches over the phase: {counts}")
    eager_ms = statistics.median(train["eager_ms"])
    graph_ms = statistics.median(train["graph_ms"])
    print(f"[rnn] summary on {where}: char-RNN host ms a step eager "
          f"{eager_ms:.3f}, graphed {graph_ms:.3f}; device ms a step eager "
          f"{train['step_dev_ms']:.3f} ({train['step_ops']:.0f} operations), "
          f"graphed {train['replay_dev_ms'] / RNN_SPE:.3f} "
          f"({train['replay_ops'] / RNN_SPE:.1f} operations); idle share "
          f"eager {1 - train['step_dev_ms'] / eager_ms:.4f}, graphed "
          f"{1 - train['replay_dev_ms'] / RNN_SPE / graph_ms:.4f}; "
          f"characters/s graphed {RNN_B * RNN_T / graph_ms * 1e3:.0f}; "
          f"tBPTT ms a batch {tbptt_ms:.3f}; generate tokens/s "
          + ", ".join(f"{k} {v['tokens_per_s']:.0f}" for k, v in gen.items()))
    return counts



# --- [zoo]: YOLO2 at full width, and the other zoo CNNs ---
ZOO_B, ZOO_STEPS, ZOO_WARMUP = 64, 12, 2    # batch=64 as yolov2.cfg sets
ZOO_SIZE, ZOO_GRID, ZOO_CLASSES = 416, 13, 80
ZOO_SPE = 4
ZOO_GRAD_B = 2
ZOO_GRAD_RTOL = 1e-3    # f32 gradients, kernels vs plain BN backward
ZOO_SERVE_BUCKETS = (1, 4, 16)
ZOO_SERVE_REQS = (1, 3, 16, 5)
ZOO_SERVE_FLOOR = 1e-3  # served vs direct: |diff| / (|direct| + floor)
ZOO_SERVE_BF16_ATOL = 0.05  # bf16 x, y, confidence, classes: |diff|
ZOO_EMB_TOL = 1e-2      # served embeddings: |norm - 1|
ZOO_OTHER_B, ZOO_OTHER_STEPS = 8, 3
# (zoo name, constructor arguments, trained (else served embeddings))
ZOO_OTHERS = (
    ("alexnet", dict(input_shape=(224, 224, 3)), True),
    ("darknet19", dict(input_shape=(224, 224, 3)), True),
    ("tinyyolo", dict(input_shape=(416, 416, 3), num_classes=20), True),
    ("googlenet", dict(input_shape=(224, 224, 3)), True),
    ("inceptionresnetv1", dict(input_shape=(160, 160, 3)), False),
    ("facenetnn4small2", dict(input_shape=(96, 96, 3)), False),
)


class _Repeat:
    """One batch served ``n`` times, as the bench repeats its batch."""

    def __init__(self, x, y, n):
        self.x, self.y, self.n = x, y, n

    @property
    def batch_size(self):
        return self.x.shape[0]

    def __len__(self):
        return self.n

    def __iter__(self):
        from deeplearning4j_torch.data import DataSet

        ds = DataSet(self.x, self.y)
        for _ in range(self.n):
            yield ds


def _yolo2(compute_dtype):
    from deeplearning4j_torch.models import YOLO2

    model = YOLO2(seed=0, input_shape=(ZOO_SIZE, ZOO_SIZE, 3)).build()
    model.config.compute_dtype = compute_dtype
    return model


def _yolo2_batch(n, seed=0):
    """``n`` standard normal images at 416² and their labels, from
    ``numpy.random.default_rng(seed)``."""
    from deeplearning4j_torch.data import yolo_labels
    from deeplearning4j_torch.models import YOLO2

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ZOO_SIZE, ZOO_SIZE, 3)).astype(np.float32)
    y = yolo_labels(rng, n, ZOO_GRID, YOLO2.anchors, ZOO_CLASSES)
    return x, y


def zoo_yolo2_train(where, x, y):
    """YOLO2 (bf16, adam 1e-3) trained by ``Trainer.fit`` on the repeated
    batch: ZOO_WARMUP steps, then the rest timed as one fit. Gated: losses
    finite and the last below the first; K4a and K4b launch once per
    BatchNorm (21) a step. Printed: params, model FLOP a step, step ms,
    images/s, MFU, device ms and operations of one step (profiler) and
    the idle share, peak memory."""
    from deeplearning4j_torch.ops.batch_norm import bn_dx, bn_reduce_coeffs
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    t0 = time.perf_counter()
    model = _yolo2("bfloat16")
    model.init(seed=0)
    torch.cuda.synchronize()
    n_bn = len(_bn_nodes(model, ZOO_B))
    flop = _model_flop(model, ZOO_B)
    print(f"[zoo] YOLO2 graph of {len(model.nodes)} nodes ({n_bn} "
          f"BatchNorms), {model.param_count()} params, initialized in "
          f"{time.perf_counter() - t0:.2f} s; model FLOP/step = 6 x conv "
          f"multiply-adds x batch {ZOO_B} = {flop:.4g} "
          f"({flop / 6 / ZOO_B:.4g} forward an image)")
    wrappers = _kernel_wrappers()
    trainer = Trainer(model)
    scores = CollectScoresListener()
    timed = ZOO_STEPS - ZOO_WARMUP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "routes"):
            w.routes = dict.fromkeys(w.routes, 0)
    t0 = time.perf_counter()
    trainer.fit(_Repeat(x, y, ZOO_WARMUP), listeners=[scores])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.fit(_Repeat(x, y, timed), listeners=[scores])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in scores.scores]
    check(len(losses) == ZOO_STEPS and all(np.isfinite(losses)),
          f"YOLO2: losses {losses}")
    check(losses[-1] < losses[0], f"YOLO2: the loss did not fall: {losses}")
    check(counts["K4a"] == counts["K4b"] == n_bn * ZOO_STEPS
          and counts["K4a_unfused"] == 0, f"YOLO2: launches {counts}, want "
          f"fused K4a and K4b {n_bn} each a step over {ZOO_STEPS} steps")
    step_ms = 1e3 * (t2 - t1) / timed
    xb, yb = (torch.from_numpy(a).cuda() for a in (x, y))
    p, o, s = trainer.params, trainer.opt_state, trainer.state
    dev_ms, dev_ops = device_ms(lambda: trainer.step(p, o, s, xb, yb),
                                reps=2)
    print(f"[zoo] YOLO2 {ZOO_STEPS} steps of Trainer.fit (adam 1e-3, bf16 "
          f"compute, f32 params), batch {ZOO_B} at {ZOO_SIZE}x{ZOO_SIZE}x3, "
          f"labels ({ZOO_B}, {ZOO_GRID}, {ZOO_GRID}, 5, {5 + ZOO_CLASSES}) "
          f"on {where}: losses " + " ".join(f"{l:.4f}" for l in losses))
    print(f"[zoo] YOLO2 launches K4a (fused) {counts['K4a']}, K4b "
          f"{counts['K4b']} ({n_bn} each a step); routes K4a "
          f"{dict(bn_reduce_coeffs.routes)}, K4b {dict(bn_dx.routes)}; "
          f"warm-up fit of {ZOO_WARMUP} steps {t1 - t0:.2f} s")
    print(f"[zoo] YOLO2 step {step_ms:.2f} ms (one fit of {timed} steps "
          f"after the warm-up, window / steps), {ZOO_B / step_ms * 1e3:.1f} "
          f"images/s; MFU {flop / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f} of "
          f"989 TFLOP/s; one step on the device {dev_ms:.2f} ms in "
          f"{dev_ops:.0f} device operations (profiler), idle share "
          f"{1 - dev_ms / step_ms:.4f}; peak memory {peak / 2**30:.2f} GiB")
    out = {"step_ms": step_ms, "dev_ms": dev_ms, "dev_ops": dev_ops,
           "peak_gib": peak / 2**30, "flop": flop, "counts": counts,
           "n_bn": n_bn, "losses": losses}
    return trainer, out


def zoo_yolo2_graph(where, x, y, n_bn):
    """YOLO2 at steps_per_execution=4: iteration 0 alone, then 8 steps as
    2 replays of one graph, against 9 eager steps from the same start,
    bit-equal (``_graph_vs_eager``); K4a and K4b launch 21 times for
    iteration 0, the warm-up step and each captured step. Then host ms a
    step eager and graphed over 8 steps, device ms of a replay, and the
    time of one capture (its warm-up step included)."""
    def build():
        m = _yolo2("bfloat16")
        m.init(seed=0)
        return m

    wrappers = _kernel_wrappers()
    eager, graphed, total = _graph_vs_eager(
        build, lambda k: _Repeat(x, y, k), 2 * ZOO_SPE, ZOO_SPE,
        f"YOLO2 bf16 batch {ZOO_B}", wrappers=tuple(wrappers.values()),
        tag="zoo")
    total = dict(zip(wrappers, total))
    want = n_bn * (1 + 1 + ZOO_SPE)
    check(total["K4a"] == total["K4b"] == want, f"YOLO2 graph: launches "
          f"{total}: want K4a, K4b {want} each (iteration 0, the warm-up "
          f"step, {ZOO_SPE} captured steps)")
    # what one capture launched, of each kernel: the run's launches less
    # iteration 0's and the warm-up step's, which run the same kernels
    captured = {k: n * ZOO_SPE // (2 + ZOO_SPE) for k, n in total.items()}
    xb, yb = (torch.from_numpy(a).cuda() for a in (x, y))
    window = [(xb, yb, None, None)] * ZOO_SPE
    steps = 2 * ZOO_SPE
    times = {"eager": [], "graph": []}
    with _deterministic():
        rep_dev, rep_ops = device_ms(lambda: graphed._replay(window), reps=2)
        for which in ("eager", "graph"):
            t = eager if which == "eager" else graphed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit(_Repeat(x, y, steps),
                  steps_per_execution=1 if which == "eager" else ZOO_SPE)
            torch.cuda.synchronize()
            times[which].append(1e3 * (time.perf_counter() - t0) / steps)
        staged = [tuple(graphed._stage(a) for a in (xb, yb, None, None))] \
            * ZOO_SPE
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap = graphed._capture(staged)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        del cap
    print(f"[zoo] YOLO2 on {where}: host ms a step over {steps} steps eager "
          f"{times['eager'][0]:.2f}, graphed {times['graph'][0]:.2f} "
          f"(steps_per_execution={ZOO_SPE}); one replay ({ZOO_SPE} steps) "
          f"{rep_dev:.2f} ms on the device in {rep_ops:.0f} operations "
          f"({rep_dev / ZOO_SPE:.2f} ms, {rep_ops / ZOO_SPE:.0f} a step; "
          f"idle share {1 - rep_dev / ZOO_SPE / times['graph'][0]:.4f}); "
          f"capture of {ZOO_SPE} steps (its warm-up step included) "
          f"{capture_s:.2f} s; K4a and K4b {n_bn * ZOO_SPE} launches "
          f"captured, replayed {graphed.windows} times in the gate")
    out = {"captured": captured, "replays": graphed.windows,
           "eager_ms": times["eager"][0], "graph_ms": times["graph"][0],
           "replay_dev_ms": rep_dev, "replay_ops": rep_ops,
           "capture_s": capture_s}
    del eager, graphed
    _release()
    return out


def zoo_yolo2_grad_gate():
    """f32 YOLO2 gradients on a batch of 2 at 416², through K4a/K4b
    against their plain versions (``_bn_grad_gate``), with TF32 off
    whatever the caller set: with it on, the convolutions' own rounding
    moves a random YOLO2's gradients by more than the gate between two
    row orders of the same batch."""
    model = _yolo2(None)
    params, state = model.init(seed=0)
    x, y = (torch.from_numpy(a).cuda() for a in _yolo2_batch(ZOO_GRAD_B, 1))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _bn_grad_gate(model, params, state, x, y, ZOO_GRAD_RTOL,
                      f"YOLO2, batch {ZOO_GRAD_B} at {ZOO_SIZE}x{ZOO_SIZE}"
                      f"x3", "zoo grad")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    del model, params, state
    _release()


def zoo_bn_shapes(model):
    """K4a (fused and sums modes, every route) and K4b against their plain
    versions at YOLO2's narrowest BatchNorm (c1) and widest (c14; c21
    normalizes the 1024 channels of its conv over the concat, the same
    shape), bf16; then every BatchNorm's shape timed (``bn_shape_times``,
    CUDA events only). Returns the per-shape rows for the kernels line,
    each with the routes that K4a's and K4b's wrappers counted."""
    from deeplearning4j_torch.ops.batch_norm import bn_reduce

    nodes = _bn_nodes(model, ZOO_B)
    by_name = {n: (M, C) for n, M, C in nodes}
    gen = torch.Generator(device="cuda")
    for i, name in enumerate(("c1", "c14", "c21")):
        M, C = by_name[name]
        gen.manual_seed(900 + i)
        x, dy = (torch.randn((M, C), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        a = torch.randn((C,), generator=gen, device="cuda").to(torch.bfloat16)
        c1, c2 = (1e-2 * torch.randn((C,), generator=gen, device="cuda")
                  for _ in range(2))
        gamma = (1 + 0.1 * torch.randn((C,), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
        before = dict(bn_reduce.routes)
        err = _bn_compare(x, dy, a, c1, c2, f"YOLO2 {name} ({M}, {C})")
        _bn_fused_compare(x, dy, gamma, f"YOLO2 {name} ({M}, {C})")
        routes = [k for k, n in bn_reduce.routes.items() if n > before[k]]
        print(f"[zoo] K4a (both modes, routes {' and '.join(routes)}) "
              f"and K4b at YOLO2's {name} BatchNorm, bf16 ({M}, {C}): equal "
              f"to their plain versions (K4a's sums within {BN_SUM_RTOL} of "
              f"their terms; K4b and the coefficients bit for bit); composed "
              f"dx vs the plain composition max abs err {err:.3g}")
        del x, dy
    shapes = [(M, C) for _, M, C in nodes]
    # device readings left out: late in the whole script torch.profiler
    # was seen to lose K4a's events here (readings under the bytes bound)
    per_shape = bn_shape_times(shapes, device=False)
    tot, bound = print_bn_shapes(shapes, per_shape, "zoo")
    rows = []
    for name, M, C in nodes:
        if name not in ("c1", "c14", "c21") and (M, C) in {
                tuple(r["shape"]) for r in rows}:
            continue
        v = per_shape[(M, C)]
        rows.append({"bn": name, "shape": [M, C],
                     "k4a_route": "+".join(v["k4a_routes"]),
                     "k4b_route": "+".join(v["k4b_routes"]),
                     "k4a_ms": v["k4a"], "k4a_ms_b2b": v["k4a_b2b"],
                     "k4a_bound_ms": 4 * M * C / PEAK_BYTES_PER_S * 1e3,
                     "k4b_ms": v["k4b"], "k4b_ms_b2b": v["k4b_b2b"],
                     "k4b_bound_ms": 6 * M * C / PEAK_BYTES_PER_S * 1e3,
                     "library_ms": v["library"],
                     "library_ms_b2b": v["library_b2b"]})
    return rows, tot


def zoo_yolo2_serve(model, where):
    """``ServeEngine`` over YOLO2 (params from seed 0; batch buckets 1, 4,
    16, no length buckets) answering requests of 1, 3, 16 and 5 images,
    in bf16 and in f32 compute. Gated, element by element (relative, with
    a floor of ZOO_SERVE_FLOOR): each bf16 answer within ENGINE_RTOL of
    ``Graph.output`` on its images padded with zero rows to the bucket the
    engine ran; each f32 answer within ENGINE_RTOL of ``Graph.output`` on
    its images alone; a control (another request's output) outside it.
    Against the images alone, each bf16 answer's x, y, confidence and
    classes (values in (0, 1)) within ZOO_SERVE_BF16_ATOL absolute, and
    the control outside it: cuDNN rounds a bf16 convolution by the
    batch's shape, and the sigmoid's and softmax's exponential tails turn
    those few ulps of a pre-activation into up to 12% of a small value,
    as ``exp`` does for a box size."""
    from deeplearning4j_torch.serve import ServeEngine

    rng = np.random.default_rng(5)
    reqs = [rng.standard_normal((n, ZOO_SIZE, ZOO_SIZE, 3)).astype(np.float32)
            for n in ZOO_SERVE_REQS]

    def serve():
        eng = ServeEngine(model, batch_buckets=ZOO_SERVE_BUCKETS,
                          length_buckets=None)
        t0 = time.perf_counter()
        try:
            answers = [eng.predict(x) for x in reqs]
        finally:
            eng.shutdown()
        batches = int(eng.metrics.counter("serve_batches_total").value)
        return answers, batches, time.perf_counter() - t0

    def direct(x, rows):
        pad = np.zeros((rows - len(x),) + x.shape[1:], x.dtype)
        y = model.output(np.concatenate([x, pad]))[0]
        return y[:len(x)].float().cpu().numpy()

    def rel_gap(y, ref):
        # a class probability or confidence rounds to 0 in bf16
        n = min(len(y), len(ref))
        return float((np.abs(y[:n] - ref[:n])
                      / (np.abs(ref[:n]) + ZOO_SERVE_FLOOR)).max())

    # each anchor's x, y, confidence and classes: the channels that no exp
    # of a box size's pre-activation amplifies
    plain = np.tile(np.arange(5 + ZOO_CLASSES) // 2 != 1, 5)

    def abs_gap(y, ref):
        n = min(len(y), len(ref))
        return float(np.abs(y[:n, ..., plain] - ref[:n, ..., plain]).max())

    gaps = {}
    for cdt in ("bfloat16", None):
        model.config.compute_dtype = cdt
        answers, batches, wall = serve()
        for x, y in zip(reqs, answers):
            check(y.shape == (x.shape[0], ZOO_GRID, ZOO_GRID,
                              5 * (5 + ZOO_CLASSES)) and np.isfinite(y).all(),
                  f"YOLO2 served answer of shape {y.shape} for {x.shape}")
        bucket = [next(b for b in ZOO_SERVE_BUCKETS if b >= len(x))
                  for x in reqs]
        alone = [direct(x, len(x)) for x in reqs]
        gaps[cdt] = {
            "bucket": [rel_gap(y, direct(x, b))
                       for x, y, b in zip(reqs, answers, bucket)],
            "alone": [rel_gap(y, ref) for y, ref in zip(answers, alone)],
            "control": min(rel_gap(y, alone[(i + 1) % len(reqs)])
                           for i, y in enumerate(answers)),
            "plain_rel": [rel_gap(y[..., plain], ref[..., plain])
                          for y, ref in zip(answers, alone)],
            "plain_abs": [abs_gap(y, ref) for y, ref in zip(answers, alone)],
            "plain_control": min(abs_gap(y, alone[(i + 1) % len(reqs)])
                                 for i, y in enumerate(answers))}
        g = gaps[cdt]
        print(f"[zoo] YOLO2 served {cdt or 'float32'} on {where}: requests "
              f"of {list(ZOO_SERVE_REQS)} images in {batches} batches "
              f"(buckets {ZOO_SERVE_BUCKETS}), {wall:.3f} s wall; engine vs "
              f"direct, max rel diff per request: on the bucket's padded "
              f"batch " + " ".join(f"{v:.3g}" for v in g["bucket"])
              + "; on the images alone " + " ".join(
                  f"{v:.3g}" for v in g["alone"]) + f"; control (another "
              f"request's output) least {g['control']:.3g}; x, y, "
              f"confidence and classes alone, rel " + " ".join(
                  f"{v:.3g}" for v in g["plain_rel"]) + ", abs " + " ".join(
                  f"{v:.3g}" for v in g["plain_abs"]) + f" (control abs "
              f"{g['plain_control']:.3g})")
        check(g["control"] > ENGINE_RTOL, "the YOLO2 engine-vs-direct limit "
              "accepts another request's output")
    model.config.compute_dtype = "bfloat16"
    check(max(gaps["bfloat16"]["bucket"]) <= ENGINE_RTOL, "a bf16 YOLO2 "
          "engine answer differs from Graph.output on its padded batch")
    check(max(gaps["bfloat16"]["plain_abs"]) <= ZOO_SERVE_BF16_ATOL
          < gaps["bfloat16"]["plain_control"], "a bf16 YOLO2 engine "
          "answer's x, y, confidence or classes differ from Graph.output on "
          "its images, or the limit accepts another request's output")
    check(max(gaps[None]["alone"]) <= ENGINE_RTOL, "an f32 YOLO2 engine "
          "answer differs from Graph.output on its images")


def zoo_others(where):
    """The six other zoo CNNs at their zoo input sizes, bf16, batch 8, each
    alone and freed after: forward finite; AlexNet, Darknet19, TinyYOLO
    and GoogLeNet 3 ``Trainer.fit`` steps with finite losses (step ms and
    peak memory printed); InceptionResNetV1 and FaceNetNN4Small2 serve
    embeddings through ``ServeEngine``, each of unit L2 norm within
    ZOO_EMB_TOL. Returns each model's kernel launches."""
    from deeplearning4j_torch.data import BenchmarkIterator, yolo_labels
    from deeplearning4j_torch.models import model_by_name
    from deeplearning4j_torch.serve import ServeEngine
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    wrappers = _kernel_wrappers()
    launches = {}
    for name, kw, trained in ZOO_OTHERS:
        zm = model_by_name(name, seed=0, **kw)
        model = zm.build()
        model.config.compute_dtype = "bfloat16"
        model.init(seed=0)
        shape = tuple(zm.input_shape)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((ZOO_OTHER_B,) + shape).astype(np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        y0 = model.output(x)
        y0 = (y0[0] if isinstance(y0, list) else y0).float()
        check(bool(torch.isfinite(y0).all()), f"{name}: non-finite forward")
        what = (f"[zoo] {name} ({model.param_count()} params) bf16 batch "
                f"{ZOO_OTHER_B} at {'x'.join(map(str, shape))}: forward "
                f"{tuple(y0.shape)} finite")
        if trained:
            if name == "tinyyolo":
                lab = yolo_labels(rng, ZOO_OTHER_B, ZOO_GRID, zm.anchors,
                                  zm.num_classes)
                batches = lambda k: _Repeat(x, lab, k)
            else:
                batches = lambda k: BenchmarkIterator(
                    shape, zm.num_classes, ZOO_OTHER_B, k, seed=0)
            rec = CollectScoresListener()
            trainer = Trainer(model)
            trainer.fit(batches(1), listeners=[rec])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(batches(ZOO_OTHER_STEPS - 1), listeners=[rec])
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / (ZOO_OTHER_STEPS - 1)
            losses = [l for _, l in rec.scores]
            check(len(losses) == ZOO_OTHER_STEPS
                  and all(np.isfinite(losses)), f"{name}: losses {losses}")
            what += (f"; {ZOO_OTHER_STEPS} fit steps, losses "
                     + " ".join(f"{l:.4f}" for l in losses)
                     + f", step {step_ms:.2f} ms (the last "
                     f"{ZOO_OTHER_STEPS - 1})")
            del trainer
        else:
            eng = ServeEngine(model, batch_buckets=(1, 4, 8),
                              length_buckets=None)
            try:
                emb = np.concatenate([eng.predict(x[:3]), eng.predict(x[3:])])
            finally:
                eng.shutdown()
            norms = np.linalg.norm(emb.astype(np.float64), axis=-1)
            check(emb.shape == (ZOO_OTHER_B, zm.num_classes)
                  and float(np.abs(norms - 1).max()) <= ZOO_EMB_TOL,
                  f"{name}: served embeddings {emb.shape}, norms {norms}")
            what += (f"; served embeddings {emb.shape} through ServeEngine, "
                     f"L2 norms within {float(np.abs(norms - 1).max()):.3g} "
                     f"of 1")
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"{what}; peak memory {peak / 2**30:.2f} GiB; kernel launches "
              f"{launches[name]}")
        del model, y0
        _release()
    return launches


def phase_zoo():
    """[zoo]: YOLO2 trained at full width eagerly and under a captured
    step, its f32 gradient gate, K4a/K4b at its shapes, YOLO2 served, and
    the six other zoo CNNs. Kernel launch counts are zeroed before each
    path and read after it. Returns what the kernels line needs."""
    where = card()
    print(f"[zoo] card: {where}")
    x, y = _yolo2_batch(ZOO_B)
    trainer, train = zoo_yolo2_train(where, x, y)
    del trainer
    _release()
    model = _yolo2("bfloat16")
    model.init(seed=0)
    zoo_yolo2_serve(model, where)
    shape_rows, shape_tot = zoo_bn_shapes(model)
    del model
    _release()
    graph = zoo_yolo2_graph(where, x, y, train["n_bn"])
    zoo_yolo2_grad_gate()
    others = zoo_others(where)
    print(f"[zoo] summary on {where}: YOLO2 batch {ZOO_B} at {ZOO_SIZE}²: "
          f"step {train['step_ms']:.2f} ms eager "
          f"({ZOO_B / train['step_ms'] * 1e3:.1f} images/s, MFU "
          f"{train['flop'] / (train['step_ms'] * 1e-3) / PEAK_BF16_FLOPS:.4f}"
          f"), {graph['graph_ms']:.2f} ms graphed; device "
          f"{train['dev_ms']:.2f} ms a step in {train['dev_ops']:.0f} "
          f"operations (idle share {1 - train['dev_ms'] / train['step_ms']:.4f}"
          f"); peak {train['peak_gib']:.2f} GiB; K4a + K4b over the "
          f"{train['n_bn']} BatchNorms back to back "
          f"{shape_tot['k4a_b2b'] + shape_tot['k4b_b2b']:.2f} ms, library "
          f"{shape_tot['library_b2b']:.2f} ms")
    return {"yolo2": train["counts"], "graph": graph, "others": others,
            "shapes": shape_rows}


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
    breadth = phase_breadth()
    rnn_counts = phase_rnn()
    zoo = phase_zoo()
    k1["launches"] = serve_launches
    k1["launches_by_path"] = {"serve": serve_launches, "train": k1_train,
                              **gen_launches}
    bwd_rows[0]["launches"] = k2_train
    bwd_rows[1]["launches"] = k3_train
    bwd_rows[2]["launches"] = k5_train
    for row, key, n in zip((k1, bwd_rows[0], bwd_rows[1]), ("K1", "K2", "K3"),
                           breadth["bert_launches"]):
        row.setdefault("launches_by_path", {"train": row["launches"]})
        # bert: the 12-step fit; bert_graph: captured launches x replays
        row["launches_by_path"]["bert"] = n
        row["launches_by_path"]["bert_graph"] = breadth["bert_graph"]
        row["bert_shape"] = breadth["bert_rows"][key]
    rg = breadth["resnet_graph"]
    for row, n, key in zip(bn_rows, (k4a_train, k4b_train), ("K4a", "K4b")):
        row["launches"] = n
        # resnet_graph: the launches captured (53 x 4 steps) x the replays
        row["launches_by_path"] = {"train": n, "resnet_graph":
                                   rg["captured"] * rg["replays"]}
        row["routes_on_path"] = bn_routes[key]
    # the recurrent path reaches no kernel: its launches, counted
    for row, key in zip([k1] + bwd_rows + bn_rows,
                        ("K1", "K2", "K3", "K5", "K4a", "K4b")):
        row.setdefault("launches_by_path", {"train": row["launches"]})
        row["launches_by_path"]["rnn"] = rnn_counts[key]
        # the zoo: YOLO2's fit; under a graph, the launches captured x
        # the replays (0 captured for a kernel the path does not run);
        # each other zoo CNN's run
        row["launches_by_path"]["yolo2"] = zoo["yolo2"][key]
        row["launches_by_path"]["yolo2_graph"] = (
            zoo["graph"]["captured"][key] * zoo["graph"]["replays"])
        for name, counts in zoo["others"].items():
            row["launches_by_path"][name] = counts[key]
    for row in bn_rows:
        row["yolo2_shapes"] = zoo["shapes"]
    print(json.dumps({"kernels": [k1] + bwd_rows + bn_rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
