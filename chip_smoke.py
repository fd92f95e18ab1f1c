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
   updater, each timed alone). Then [telemetry] on the same trainer, from
   its params, updater state and generator snapshotted on the card and
   restored before each run: 4 steps plain, 4 with ``StepTelemetry``
   alone (the fence's cost: step time beside the plain steps', and the
   dispatch/device split), 4 with ``StepTelemetry`` and a
   ``ProfilerListener(start_iteration=1, num_iterations=2)``. Gated: the
   losses of both telemetered runs bit-equal to the plain run's; 4 steps
   and 1 compile miss counted, 4 observations in the data-wait, dispatch
   and device histograms; the ``peak_bytes_in_use`` gauge of ``cuda:0``
   within 1% of ``torch.cuda.max_memory_allocated()``; K1, K2 and K3 12
   launches each a step under telemetry as without it
   (``launches_by_path["telemetry"]``); the profiler's trace exactly
   iterations 1 and 2 by its markers, naming ``flash_fwd_sm90_kernel``,
   ``flash_bwd_dq_sm90_kernel`` and ``flash_bwd_dkv_sm90_kernel`` among
   its CUDA kernels, at most 24 launches of each; the exposition passes
   ``obs.promcheck``.
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

14. transfer — fine-tuning a frozen zoo network (every kernel's launch
   count is zeroed before each path and read after it, into the kernels
   line under ``launches_by_path``). ``ResNet50(seed=0)`` at 224², bf16,
   through ``TransferGraphBuilder``: frozen through ``s2b5`` (the stem and
   stages 0-2), a 5-way head, Nesterovs 1e-3 with RenormalizeL2PerLayer;
   synthetic uint8 images (5 classes, each a colour and a stripe frequency
   under noise, ``default_rng(0)``) through ``ImageScaler``; 4 training
   and 2 held-out batches of 128 under ``EarlyStoppingTrainer``
   (MaxEpochs 3, ScoreImprovementEpoch, InvalidScore, the held-out loss,
   in memory), then ``Trainer.evaluate``. Gated: K4a and K4b 10 launches
   a step (stage 3's BatchNorms), 0 in an inference forward, K1-K3 and K5
   0; frozen params and running statistics bit-equal to the source's,
   every unfrozen leaf changed; losses finite, the held-out score falling;
   the best model saved with its normalizer, loaded, and served through
   ``ServeEngine`` to raw uint8 images (normalized once, on the card)
   bit-equal to the forward of its padded bucket batch, within 0.05 of
   the images alone, a twice-normalized control outside; 8 steps at
   steps_per_execution=4 bit-equal to eager ones; f32 gradients of the
   unfrozen nodes through K4a/K4b within 1e-3 of the plain versions'; K4a
   and K4b against their plain versions at 6272 x 512 and 6272 x 2048,
   timed beside the library's BatchNorm backward. VGG16(seed=0) frozen
   through fc2 with ``TransferLearningBuilder``, a 5-way head,
   ``VGG16Preprocessor``: ``TransferLearningHelper.featurize`` of 2
   batches of 64 (timed), one head step on the features equal to one step
   of the full frozen network on the raw images, the head fitted and
   merged back. Printed: step ms eager and graphed, images/s, model FLOP
   (every layer's forward, the unfrozen ones' backward) and MFU, device
   ms and operations and the idle share, peak memory, the early-stopping
   result and the evaluation's accuracy and F1.
15. train_api — the rest of the training surface at small sizes: the
   seven new updaters and the five gradient normalizations (3 updates on
   the card within 1e-6 of the CPU's from the same gradients),
   ``pretrain_layer`` of an AutoEncoder and a VAE (784 wide, batch 256;
   the loss falls), ``Solver`` with L-BFGS and conjugate gradient (the
   loss falls), a two-input Graph on MultiDataSet batches, a ``Lambda``
   layer; an LM of two ``MoETransformerBlock`` (d_model 512, 8 heads, 8
   experts, top-2, T 1024, batch 4, bf16, flash): K1, K2, K3 once each a
   block and step, the aux loss finite and in the loss. ``model.fit`` on
   the LeNet of ``lenet_mnist`` (batch 1024, ``steps_per_execution=16``,
   its Dense layers drawn by ``lecun_normal``) over the port's
   ``load_mnist`` (its synthetic replica when no files are there): losses
   bit-equal to ``Trainer(model).fit`` from the same init, and a second
   ``model.fit`` resuming at the cached trainer's iteration. Every
   registered weight init drawn once on the card at 1024 x 1024, its
   mean, variance and bounds held to the reference's formula at 5 sigma
   (``identity``, ``zeros``, ``ones`` exact).

16. fleet — multi-model serving (every kernel's launch count is zeroed
   before the phase and read after it, into the kernels line under
   ``launches_by_path["fleet"]``). Three full-width CausalLMs (the serve
   phase's model, seeds 0, 1, 2: alpha, beta, gamma) in a
   ``FleetRegistry`` whose weight budget is 2.2 models, so at most two
   are resident; pinned host copies; page-ins on the one page-in stream.
   Predicts at the model's 1024 tokens (the HTTP predict at 16: its JSON
   answer). Tenants as
   ``bench.py:_bench_fleet`` registers them: gold (500/s, SLO gold)
   predicting on alpha and beta, standard (500/s) greedy-generating 8
   tokens on gamma with the generate phase's batcher options, free (2/s,
   burst 2, class batch) predicting on alpha, knn (200/s, standard)
   querying a ``BruteForceKNN`` of 512 x 16 points on the card through
   the same admission; closed loop, one thread a
   tenant, for FLEET_SECONDS, with request traces and a flight recorder
   installed. Gated: every knn answer the 5 nearest of a numpy scan;
   every predict bit-equal to its model's direct
   forward at the bucket it ran in, every generation equal to the
   batcher's tokens computed before the fleet (and ``generate()``'s under
   the gap rule); at least 3 page-ins and 2 evictions; generations that
   never repeat (page-ins 1, 2, 3... per model; a publish while resident
   adds one, and only then does the page-out copy the weights back, which
   a published cycle of each model shows); every page-out frees at least
   the weights (the
   allocator's freed counter during traffic, ``memory_allocated`` itself
   over quiet cycles); the free tenant shed; an injected
   ``fleet.page_in_transfer`` error and a copy torn part way each retried
   with bit-equal answers; injected ``serve.dispatch`` failures open beta's
   breaker, which sheds 503 with Retry-After until a half-open probe
   closes it; memory back to its level after the faults; a
   ``FleetServer``: a traced predict on a cold model (bit-equal, its
   stages and the ``fleet.page_in`` span), generate, ``/v1/fleet``
   residency, 404, 429 with Retry-After; K1 12 launches a predict batch,
   no other kernel. Printed with the card: page-in and page-out ms and
   GB/s beside the pinned-copy bound, the pinned allocation time, the knn
   tenant's p50/p99 in the window, gold p50/p99 in the window, at rest,
   while other models page and while
   their page-outs copy back (each request's stage medians, and a
   torch.profiler summary of each: the card's streams, copies and the
   host's waiting calls), gamma's
   time to first token and tokens/s, peak allocated and reserved memory
   against the budget.

17. aot — strict prebuilt serving (every kernel's launch count, set to 0
   before the strict boot and read in that process after the fleet cycle,
   goes into the kernels line under ``launches_by_path["aot"]``: K1's are
   the launches captured in each engine graph, measured at the boot,
   times the replays of the server's and the fleet's graphs). ``python -m
   deeplearning4j_torch.aot prebuild`` in a process of its own writes a
   store for the serve phase's model (738M CausalLM, bf16, flash, random
   weights from seed 0): the engine's batch buckets 1 and 4 by length
   buckets 256 and 1024, and the generate phase's paged batcher (8 slots,
   capacity 1024, blocks of 16, chunks of 64), with every kernel library
   built by nvcc. A second process, its kernel build directory empty,
   boots ``ModelServer(strict_aot=True, aot_manifest=...)`` on that store
   and is gated there: no nvcc build; 4 engine graphs and the batcher's
   sample, decode and 4 prefill-chunk graphs captured at boot and none on
   a call; predicts of mixed buckets bit-equal to the eager forward of the
   padded bucket batch they ran in; greedy and seeded (temperature 0.8,
   top_k 40) tokens of 6 concurrent prompts equal to an eager batcher's on
   the same params; an uncovered signature answered 503 (``aot_trace``)
   with nothing captured; a publish that captures the candidate's graphs
   before the flip and answers with the new params bit for bit; with the
   profiler installed, ``/v1/debug/profile`` listing engine, prefill and
   decode executables with padding waste and ``/metrics`` their device-time
   histograms; a strict fleet of two full-width models in a budget of one
   and a half, every page-out freeing at least the weights and the answers
   the same across the cycle, an entry with an uncovered bucket refused
   typed at page-in. Printed with the card: boot seconds
   (``serve_cold_start_seconds``), the graphs' static buffer bytes, the
   decode tick eager and replayed (host p50 and device ms) beside the
   eager tick measured before (17.7 ms on the host, 7.1 on the device).

18. cluster — the host control planes over a replica cluster (every
   kernel's launch count is zeroed after the references and read at the
   end, into the kernels line under ``launches_by_path["cluster"]``). The
   fleet phase's model at full width with seeds 0 and 1 (alpha, beta), on
   two replicas r1 and r2 (``spawn_replica`` over a ``FleetRegistry`` of
   both models in a budget of 2.2 models, engine buckets 1, 2, 4 by
   length buckets 16, 128, 1024, beta with the generate phase's batcher)
   behind one ``ClusterRouter`` in this process (tenants gold, standard,
   free as the fleet phase sets them; membership and SLO burn on a clock
   the drill pushes forward). A: gold and standard predicts of 16 and 128
   tokens and beta's generates (buffered, streamed) through the router,
   each equal to a replica's answer alone (bit for bit at some bucket and
   row position; tokens equal to the batcher's alone); the free tenant's
   third request 429 at the router; routed against direct p50. B: one
   ``serve.dispatch`` delay on the primary's dispatch: a gold predict's
   hedge wins with a correct answer, both attempts in one request trace,
   the loser's breaker closed. C: beta's primary crash-killed under mixed
   load: every answer correct or typed, none a raw 500; membership dead,
   placement re-planned, beta served again from the survivor after a
   page-in (failover time); the card synchronizes and K1 agrees with its
   plain version. The telemetry plane (a ``FederatedScraper`` attached as
   ``router.telemetry`` with a ``TimeSeriesStore`` and the default
   ``AlertEngine``, driven by hand on the drill's clock) scrapes the
   healthy cluster before A (every source ok, no alert), and F, after C,
   runs the reference's telemetry drill: the alive replicas partitioned at
   ``cluster.transport`` scrape as error and the dead as stale,
   replica_dead fires, two gold predicts shed typed, gold_burn_high
   pending, pending at +10 s, firing at +21 s (GET /v1/alerts, one
   notification, the burn's history on GET /v1/tsdb), resolved once after
   the heal; the router's and the replicas' /metrics pass promcheck (as
   do [generate]'s and [aot]'s). D: an ``AutoscaleController`` (min 2,
   max 3) reaps the
   dead replica and repairs the floor; the closed-loop rate of two
   replicas at the replay's mix is measured, then a ``WorkloadSpec``
   shaped as ``smoke_spec`` (lognormal prompts up to 1024 tokens, Pareto
   outputs up to 64, vocab 32000, bursts of 2.5x) at 0.6x that rate is
   replayed open loop through ``RouterTarget`` by ``LiveReplayer``, the
   controller forecasting each class's burn with a ``BurnForecaster`` over
   a store of the replay's own scrapes (one a tick): a scale-out on the
   burst (burn, queue or forecast; spawn, prewarm, first beat), then a
   scale-in
   through ``/v1/admin/drain`` with requests in flight; every outcome
   typed or correct (replayed predicts against the direct forward). E:
   the cost profile [aot] filed in its store calibrates a ``CostModel``;
   a seeded ``Tuner`` over the replayed workload; ``record_winner``; a
   store prebuilt for the winner's knobs and a strict replica booted with
   ``tuned_for=`` while r1/r2 serve: the winner's knobs, 0 compiles, its
   answers replayed graphs; ``AutoscalePolicy.from_config`` reads the
   winner. Gated: K1 12 launches a predict batch (eager, or captured in a
   strict replay), no other kernel; peak reserved below 90% of the card.
19. recovery — ``CausalLM(flash=True)`` at width 2048 with the depth cut
   to 2 layers (233M params; a 2.8 GB checkpoint with adamw state against
   8.9 GB at 12 layers), bf16: ``FaultTolerantFit`` over three one-epoch
   segments, preempted by a ``train.segment`` fault after segment 2 and
   resumed by a fresh ``Trainer`` from segment 1's checkpoint, bit-equal
   to an uninterrupted run (params and updater state); the checkpoint
   written and read, timed; a poisoned batch (a NaN in its label mask)
   rolled back by ``DivergenceListener(action="rollback")`` to the last
   validated snapshot, the learning rate scaled by 0.5, later losses
   finite. K1, K2, K3 once a layer and step (``launches_by_path
   ["recovery"]``).
20. parallel — data parallelism on a world-1 NCCL group (a file-store
   rendezvous; the last phase, one trainer resident at a time): the
   full-width CausalLM(flash=True) at [train]'s batch (B 4 x T 1024, bf16,
   adamw) from one snapshot of its seed-0 params, PAR_STEPS steps each of
   ``Trainer.fit`` and ``ParallelWrapper`` in shared_gradients,
   zero_sharded, averaging (frequency 2) and encoded_gradients (exact
   top-k, threshold 0, full capacity), each one's params held against
   Trainer's within PAR_PARAM_TOL (bit-equality reported);
   encoded_gradients quantized at staleness 1, default threshold and
   capacity, PAR_Q_STEPS steps under ``StepTelemetry`` (loss finite and
   falling, count within capacity, residual finite, ``replica="0"``
   gauged); ``MultiHostTrainer`` over ``ProcessShardIterator``, its
   PAR_MH_STEPS steps against Trainer's. K1, K2, K3 12 launches each a
   step in every run (``launches_by_path["parallel"]``, with
   ParallelInference's). Printed with the card: each mode's step ms beside
   Trainer's and its peak memory, the collectives at world 1, the codec's
   encode + decode ms over every param beside its bytes bound, ZeRO-1's
   update beside the plain updater's; ``ParallelInference`` coalescing
   PAR_PI_REQS concurrent 1024-token predicts, each answer held against its
   direct forward as [serve] holds answers. The group is destroyed after.
21. tp_sp — tensor, sequence and pipeline parallelism on a second
   world-1 NCCL group, mesh {data 1, model 1, seq 1}, every collective
   through its group: the full-width CausalLM(flash=True, ring=True) at
   [train]'s batch from one snapshot, TP_STEPS steps each of Trainer,
   Trainer(mesh=, rules=TRANSFORMER_RULES), ParallelWrapper(rules=) in
   shared_gradients and zero_sharded, held against Trainer's params
   (TP_PARAM_TOL, bit-equality reported), MultiHostTrainer(rules=)'s
   TP_MH_STEPS steps then ``evaluate(global_mesh=True)``, and
   ``sharded_lm_step``'s one step (its loss Trainer's first); K1, K2, K3
   12 launches each a step. The ring's schedule over RING_N blocks of
   RING_BLOCK at (B 4, T 1024, H 32, D 64), f32 and bf16, causal and not,
   against one flash_attention call and the dense reference element by
   element, each against its row's largest (RING_F32_TOL,
   RING_F32_DENSE_TOL, RING_BF16_TOL, RING_BF16_DENSE_TOL; a planted fault
   in the merge and the backward, RING_FAULT, must read above them), 10
   launches each of K1-K3 causal, 16 not, timed beside the call; ``pipeline_apply`` over pipe 1 with PIPE_M
   microbatches of one full-width block, equal to the block in turn.
   Step ms and peak memory of each run beside the card. The launches of
   the rules paths, the ring and the pipeline (the plain Trainer's
   reference runs excluded) are tallied against the count they must come
   to (``launches_by_path["tp_sp"]``). Quick call: ``python3 -c "import
   chip_smoke as c; c.phase_build(); c.phase_tp_sp()"``.
22. elastic (run after [recovery], before [parallel]; no process group)
   — ``ElasticTrainer`` on one card, its replicas ``[cuda:0] * 4``: one
   plain ``Trainer.fit`` step of the full-width CausalLM at EL_B x EL_T
   (12 x 256: 12 rows divide by every width 2..4; T cut from 1024 so three
   widths' graphs fit, reckoned before capture and gated under 90% of the
   card) for comparison; then the kill drill at full width and depth: a
   trainer at dp 4, ladder 2..4, warmed (one CUDA graph a width, 0
   captures after), fit to 3, ``elastic.step:error:scope=w1,times=1``,
   fit to 6: reaped, resized 4 -> 3 (``worker_death``, 0 < moved <
   naive) through two atomic checkpoints of 8.8 GB, the pointer at the
   post-resize triple; a second trainer ``resume``d from it at dp 3 and
   fit to 6, its params, updater state and last loss bit-equal to the
   first's; a third restored from the same checkpoint at dp 2 (the read
   timed) and fit 2 steps. Then on the 2-layer cut: a death on the
   ``elastic.resize`` seam (raised typed, the pointer at the pre-resize
   checkpoint, resumed there at dp 4 to step 6), quorum loss at the
   ladder's floor (``QuorumLostError``, no checkpoint), autoscale growth
   2 -> 3 from a staged 4x step-time burn. Gated: the resize logs, the
   pointers, bit-equality, 0 captures after ``warm()``, losses finite
   (falling in the kill drill), each width's graph capturing 12 (2)
   launches of K1-K3 a replica and the replays launching 12 (2) x the sum
   of the widths of the steps run, no other kernel
   (``launches_by_path["elastic"]``: warm-up steps plus captured x
   replays). Printed with the card: disk free, step ms a width (the
   replay, synchronized) beside the plain step, capture seconds and pool
   bytes a width, peak allocated, resize seconds with moved and naive
   bytes, checkpoint write and read seconds and GB/s.
23. moe_ep (last) — the MoE LM of [train_api] (MOE_BLOCKS blocks, d
   MOE_D, MOE_E experts) on a third world-1 NCCL group with a mesh
   {expert 1}, its expert leaves placed by EXPERT_RULES: the forward's
   output, the loss and every gradient bit-equal to the LM without a mesh
   (every expert collective through the group), then MOE_EP_STEPS steps
   of ``Trainer(mesh=, rules=EXPERT_RULES)`` bit-equal to ``Trainer``'s.
   K1-K3 counted (``launches_by_path["moe_ep"]``). Quick call:
   ``python3 -c "import chip_smoke as c; c.phase_build();
   c.phase_elastic(); c.phase_moe_ep()"``.

24. embeddings (after [elastic], before [parallel]; no process group) —
   word, document and graph embeddings at published widths on a synthetic
   corpus made from EMB_SEED: EMB_VOCAB words (text8's vocabulary at min
   count 5) each EMB_MIN_COUNT times in sentences of its topic, then
   EMB_FURTHER tokens in EMB_SENT-token sentences, each of one of
   EMB_TOPICS planted topics, its tokens Zipf(1) within the topic and
   EMB_GLOBAL of them Zipf(1) over all words. ``Word2Vec`` skip-gram with
   negative sampling at W2V_KW (Mikolov et al.'s 300 d, window 5, 5
   negatives, sample 1e-3, lr 0.025 -> 1e-4, batch 2048; one epoch), its
   topic precision@10 of ``words_nearest`` over EMB_PREC_WORDS of the
   EMB_PREC_POOL most frequent words gated at EMB_PREC_GATE (5x chance);
   hierarchical softmax and CBOW at the same width on an EMB_HEAD-token
   prefix; the same small fit twice with the sorted scatter-add (gated
   bit-equal) and twice with ``index_add_`` (reported); ParagraphVectors
   PV-DBOW on PV_DOCS labelled documents of PV_LEN tokens, then
   ``infer_vector`` on PV_UNSEEN unseen ones (gated: the nearest label's
   document shares the topic for most) and PV-DM on PV_DM_DOCS; GloVe at
   GLOVE_KW (300 d, window 10, x_max 100, alpha 0.75, lr 0.05, batch
   4096, 2 epochs) on an EMB_GLOVE_HEAD-token prefix; ``DeepWalk`` (HS
   over the degree Huffman tree) and ``Node2Vec`` (p = q = 0.25) at d 128,
   window 10, walks of 40, one walk a vertex, on a preferential-attachment
   graph of BlogCatalog's GRAPH_V vertices and GRAPH_E edges. Every run's
   per-step losses finite and falling (first tenth against last); one
   skip-gram NS, HS, CBOW and GloVe step on the card against the CPU from
   the trained tables and the last batch (EMB_STEP_ATOL, EMB_STEP_RTOL).
   Printed with the card: steps, host ms a step, device ms a step (CUDA
   events), set-up seconds, the Huffman depths, the phase's seconds. The
   path reaches no kernel (``launches_by_path["embeddings"]``, all 0).
25. knn — the 71,290 x 300 Word2Vec vectors written by
   ``write_word2vec_binary`` and read back, served by
   ``NearestNeighborsServer(distance="cosinesimilarity")`` on the card:
   KNN_ROWS /knn and KNN_NEW /knnnew requests of KNN_NEW_ROWS vectors
   through ``NearestNeighborsClient`` over 127.0.0.1, each answer held
   against a float64 numpy brute force (indices equal except scores
   within KNN_TIE, distances within KNN_DIST_TOL) and each /knn against
   ``Word2Vec.words_nearest`` of its word; ``/metrics`` through promcheck;
   one /knnnew batch under each other distance; ``BruteForceKNN`` on the
   card against the CPU. Printed: p50/p99 latency of each endpoint with
   the card; no kernel launched (``launches_by_path["knn"]``). Quick call
   for both: ``python3 -c "import chip_smoke as c; counts, emb =
   c.phase_embeddings(); c.phase_knn(emb)"``.

Prints a JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Needs one CUDA card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
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
        _promcheck(scrape, "[generate] the server's /metrics")
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


TEL_STEPS = 4


def _tel_trace(path):
    """(iterations marked, {kernel name: launches}) of a ProfilerListener
    trace: its ``ProfilerListener.iteration_<k>`` markers and its CUDA
    kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = sorted(int(e["name"].rsplit("_", 1)[1]) for e in events
                   if e.get("name", "").startswith(
                       "ProfilerListener.iteration_"))
    kernels = collections.Counter(e.get("name", "") for e in events
                                  if e.get("cat") == "kernel")
    return marks, kernels


def phase_telemetry(trainer, x, y):
    """[telemetry]: the full-width CausalLM's trainer (after [train]) from
    one snapshot of its params, updater state and generator, restored on
    the card before each run of TEL_STEPS steps on the training batch:
    plain, under ``StepTelemetry`` alone, and under ``StepTelemetry`` with
    a ``ProfilerListener(start_iteration=1, num_iterations=2)``. Returns
    each kernel's launches in the last run."""
    import shutil
    import tempfile

    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.obs import StepTelemetry
    from deeplearning4j_torch.obs.promcheck import check_text
    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
    from deeplearning4j_torch.train import (CollectScoresListener,
                                            ProfilerListener)

    where = card()
    t_phase = time.perf_counter()
    B, n, L = x.shape[0], TEL_STEPS, 12
    params = tree_leaves(trainer.params)
    saved_p = [p.detach().clone() for p in params]
    saved_opt = tree_unflatten(trainer.opt_state, [
        t.clone() for t in tree_leaves(trainer.opt_state)])
    saved_state, saved_gen = trainer.state, trainer._gen.get_state()
    wrappers = _kernel_wrappers()

    def run(tel=None, listeners=()):
        with torch.no_grad():
            for p, s in zip(params, saved_p):
                p.copy_(s)
        trainer.opt_state = tree_unflatten(saved_opt, [
            t.clone() for t in tree_leaves(saved_opt)])
        trainer.state = saved_state
        trainer._gen.set_state(saved_gen)
        trainer.iteration = 0
        it = ArrayIterator(np.repeat(x, n, 0), np.repeat(y, n, 0),
                           batch_size=B)
        scores = CollectScoresListener()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        trainer.fit(it, listeners=[scores, *listeners], telemetry=tel)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n
        return ([l for _, l in scores.scores], ms,
                {k: w.launches for k, w in wrappers.items()},
                torch.cuda.max_memory_allocated())

    plain, plain_ms, plain_counts, _ = run()
    tel_a = StepTelemetry()
    alone, alone_ms, alone_counts, _ = run(tel_a)
    log_dir = tempfile.mkdtemp()
    try:
        tel = StepTelemetry()
        prof = ProfilerListener(log_dir, start_iteration=1, num_iterations=2)
        losses, prof_ms, counts, peak = run(tel, [prof])
        check(len(prof.paths) == 1 and os.path.exists(prof.paths[0]),
              f"[telemetry] the profiler wrote {prof.paths}")
        marks, kernels = _tel_trace(prof.paths[0])
        trace_mb = os.path.getsize(prof.paths[0]) / 2**20
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    check(len(plain) == n and all(np.isfinite(plain)),
          f"[telemetry] plain losses {plain}")
    check(alone == plain and losses == plain, f"[telemetry] losses under "
          f"telemetry {alone}, with the profiler {losses}, plain {plain}")
    reg = tel.registry
    snap = tel.snapshot()
    hists = {name: reg.histogram(name).count for name in (
        "train_data_wait_seconds", "train_dispatch_seconds",
        "train_device_compute_seconds", "train_step_seconds")}
    check(snap["steps"] == n and snap["compile_cache_misses"] == 1
          and all(v == n for v in hists.values()),
          f"[telemetry] steps {snap['steps']}, compile misses "
          f"{snap['compile_cache_misses']}, histogram counts {hists}")
    gauge = reg.gauge("device_memory_bytes",
                      {"device": "cuda:0", "kind": "peak_bytes_in_use"}).value
    check(abs(gauge - peak) <= 0.01 * peak, f"[telemetry] peak_bytes_in_use "
          f"{gauge:.0f} against max_memory_allocated {peak}")
    for got, what in ((plain_counts, "plain"), (alone_counts, "telemetry"),
                      (counts, "telemetry + profiler")):
        check(all(got[k] == L * n for k in ("K1", "K2", "K3")),
              f"[telemetry] {what}: launches {got}, want {L} each a step")
    names = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
             "flash_bwd_dkv_sm90_kernel")
    in_trace = {k: sum(c for name, c in kernels.items() if k in name)
                for k in names}
    check(marks == [1, 2], f"[telemetry] the trace marks iterations {marks}")
    check(all(0 < v <= 2 * L for v in in_trace.values()),
          f"[telemetry] kernels in the trace {in_trace}")
    findings = check_text(tel.to_prometheus())
    check(findings == [], f"[telemetry] promcheck: {findings}")
    phases = {"dispatch": "train_dispatch_seconds",
              "device": "train_device_compute_seconds",
              "step": "train_step_seconds",
              "data_wait": "train_data_wait_seconds"}
    # the histograms' exact means (their quantiles are bucket estimates)
    split, split_a = ({k: 1e3 * r.histogram(name).mean
                       for k, name in phases.items()}
                      for r in (reg, tel_a.registry))
    print(f"[telemetry] {n} steps a run of the full-width CausalLM (B={B}, "
          f"T={x.shape[1]}, bf16, adamw) from one snapshot: losses "
          + " ".join(f"{l:.6f}" for l in plain) + " plain, bit-equal under "
          f"StepTelemetry and under StepTelemetry + ProfilerListener; "
          f"{where}")
    print(f"[telemetry] step ms (fit window / {n}, synchronized at both "
          f"ends): plain {plain_ms:.2f}, StepTelemetry {alone_ms:.2f} "
          f"({100 * (alone_ms / plain_ms - 1):+.2f}%: the fence), with the "
          f"profiler window {prof_ms:.2f}; StepTelemetry means, alone: step "
          f"{split_a['step']:.2f} = dispatch {split_a['dispatch']:.2f} + "
          f"device {split_a['device']:.2f} ms, data wait "
          f"{split_a['data_wait']:.3f} ms; with the profiler: step "
          f"{split['step']:.2f} = dispatch {split['dispatch']:.2f} + device "
          f"{split['device']:.2f} ms; {where}")
    print(f"[telemetry] snapshot {json.dumps(snap)}; peak_bytes_in_use "
          f"{gauge:.0f} B, max_memory_allocated {peak} B; launches K1 "
          f"{counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']} ({L} each "
          f"a step); trace {trace_mb:.1f} MB marks iterations {marks}, "
          f"kernels {in_trace}; promcheck clean; "
          f"{time.perf_counter() - t_phase:.1f} s")
    with torch.no_grad():
        for p, s in zip(params, saved_p):
            p.copy_(s)
    trainer.opt_state = saved_opt
    del saved_p
    return counts


PAR_STEPS = 3               # steps of each run (one warm-up, two timed)
PAR_MH_STEPS = 2            # MultiHostTrainer's steps against Trainer's
PAR_Q_STEPS = 5             # the quantized run: at threshold 1e-3 adamw's
#                             first updates (about lr = 3e-4 an entry) fill
#                             the residual to the threshold at step 4, so
#                             nothing is sent before it
PAR_PARAM_TOL = 1e-6        # f32 params after the steps, a mode vs Trainer:
#                             max |diff| / max |Trainer's| of each leaf
PAR_PI_REQS = 8             # ParallelInference's concurrent predicts


def _par_gap(got, want):
    """(max over leaves of max |a - b| / max |b|, every leaf bit-equal)."""
    gap, equal = 0.0, True
    for a, b in zip(got, want):
        equal = equal and torch.equal(a, b)
        gap = max(gap, float((a.detach().float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30))
    return gap, equal


def phase_parallel(device="cuda"):
    """[parallel]: data parallelism on a world-1 NCCL group on the card
    (loopback rendezvous through a file store), driving the full-width
    CausalLM(flash=True) of [train] (B 4 x T 1024, bf16, adamw) from one
    snapshot of its seed-0 params: PAR_STEPS steps each of Trainer.fit,
    ParallelWrapper in shared_gradients, zero_sharded, averaging
    (frequency 2) and encoded_gradients (exact top-k, threshold 0, full
    capacity), each one's params held against Trainer's (PAR_PARAM_TOL,
    bit-equality reported); encoded_gradients quantized at staleness 1 with
    the default threshold and capacity under StepTelemetry (loss finite
    and falling, count within capacity, residual finite, replica "0"
    gauged); MultiHostTrainer's PAR_MH_STEPS steps against Trainer's.
    Every run launches K1, K2 and K3 once a layer and step. Then the
    collectives at world 1, the codec over every param against its bytes
    bound, ZeRO-1's update against the plain updater's, and
    ParallelInference coalescing PAR_PI_REQS concurrent 1024-token
    predicts. One trainer at a time is resident. Returns each kernel's
    launches over the runs."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.obs import StepTelemetry
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.parallel import (MultiHostTrainer,
                                               ParallelInference,
                                               ParallelWrapper,
                                               ProcessShardIterator,
                                               distributed_init, make_mesh)
    from deeplearning4j_torch.parallel import compression as C
    from deeplearning4j_torch.parallel.dp import DataParallel, ZeroOne
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    where = card()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    check(distributed_init(f"file://{tmp}/store", 1, 0, device=device),
          "[parallel] no process group made")
    try:
        check(dist.get_backend() == ("nccl" if device == "cuda" else "gloo")
              and dist.get_world_size() == 1,
              f"[parallel] group {dist.get_backend()} of "
              f"{dist.get_world_size()}")
        mesh = make_mesh()
        model = _lm(True)
        model.init(seed=0)
        n_params = model.param_count()
        snap = [p.detach().clone() for p in tree_leaves(model.params)]
        B, T, V, L = 4, 1024, 32000, 12
        rng = np.random.RandomState(0)
        x = rng.randint(0, V, (B, T)).astype(np.int32)
        y = rng.randint(0, V, (B, T)).astype(np.int32)
        wrappers = _kernel_wrappers()
        total = collections.Counter()

        def restore():
            with torch.no_grad():
                for p, s in zip(tree_leaves(model.params), snap):
                    p.copy_(s)

        def run(name, make, fits=(1, PAR_STEPS - 1), shards=False,
                tel=None, after=None):
            """``make()``'s fits of ``fits`` steps each from the snapshot,
            every fit synchronized; all but the first timed
            (``after(i, trainer)`` runs after fit i, inside the timing
            when i > 0; ``tel`` goes to the last fit)."""
            restore()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            t = make()
            scores = CollectScoresListener()
            steps = sum(fits)

            def it(n):  # the batch n times over
                xs, ys = np.tile(x, (n, 1)), np.tile(y, (n, 1))
                return (ProcessShardIterator(xs, ys, B) if shards
                        else ArrayIterator(xs, ys, batch_size=B))

            t0 = None
            for i, n in enumerate(fits):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                kw = ({"telemetry": tel} if tel is not None
                      and i == len(fits) - 1 else {})
                t.fit(it(n), listeners=[scores], **kw)
                if after is not None:
                    after(i, t)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / (steps - fits[0])
            counts = {k: w.launches for k, w in wrappers.items()}
            total.update(counts)
            check(tuple(counts[k] for k in ("K1", "K2", "K3"))
                  == (L * steps,) * 3,
                  f"[parallel] {name}: launches K1, K2, K3 "
                  f"{[counts[k] for k in ('K1', 'K2', 'K3')]}, want "
                  f"{L * steps} each over {steps} steps")
            losses = [l for _, l in scores.scores]
            check(len(losses) == steps and all(np.isfinite(losses)),
                  f"[parallel] {name}: losses {losses}")
            return t, losses, ms, torch.cuda.max_memory_allocated()

        rows = {}
        after2 = {}

        def keep_after_2(i, t):
            if i == 1:
                after2["params"] = [p.detach().clone()
                                    for p in tree_leaves(t.params)]

        t, _, _, _ = run("Trainer (2 steps)", lambda: Trainer(model),
                         fits=(1, 1), after=keep_after_2)
        del t
        t, ref_losses, ref_ms, ref_peak = run("Trainer",
                                              lambda: Trainer(model))
        ref = [p.detach().clone() for p in tree_leaves(t.params)]
        del t
        rows["Trainer"] = (ref_ms, ref_peak, None, None, ref_losses)
        modes = (
            ("shared_gradients", {}),
            ("zero_sharded", {}),
            ("averaging", {"averaging_frequency": 2}),
            ("encoded_gradients", {"threshold": 0.0, "capacity_frac": 1.0,
                                   "quantize": False}),
        )
        for mode, kw in modes:
            t, losses, ms, peak = run(mode, lambda: ParallelWrapper(
                model, mesh=mesh, mode=mode, **kw))
            gap, equal = _par_gap(tree_leaves(t.model.params), ref)
            del t
            rows[mode] = (ms, peak, gap, equal, losses)
            check(gap <= PAR_PARAM_TOL,
                  f"[parallel] {mode}: params after {PAR_STEPS} steps "
                  f"{gap:.3g} off Trainer's (limit {PAR_PARAM_TOL})")
        tel = StepTelemetry()
        q, q_losses, q_ms, q_peak = run(
            "encoded_quantized", lambda: ParallelWrapper(
                model, mesh=mesh, mode="encoded_gradients", staleness=1),
            fits=(1, PAR_Q_STEPS - 1), tel=tel)
        count, cap = int(q.last_count), q.capacity
        res_ok = bool(torch.isfinite(q.residual).all())
        res_abs = float(q.residual.abs().sum())
        del q
        rows["encoded_quantized"] = (q_ms, q_peak, None, None, q_losses)
        check(q_losses[-1] < q_losses[0], f"[parallel] quantized encoded "
              f"loss did not fall: {q_losses}")
        check(count <= cap and res_ok,
              f"[parallel] quantized: count {count} of capacity {cap}, "
              f"residual finite {res_ok}")
        prom = tel.to_prometheus()
        check('parallel_replica_step_seconds{replica="0"}' in prom,
              "[parallel] parallel_step recorded no replica 0")
        t, mh_losses, mh_ms, mh_peak = run(
            "MultiHostTrainer", lambda: MultiHostTrainer(model, mesh=mesh),
            fits=(1, PAR_MH_STEPS - 1), shards=True)
        gap, equal = _par_gap(tree_leaves(t.params), after2["params"])
        del t
        rows["MultiHostTrainer"] = (mh_ms, mh_peak, gap, equal, mh_losses)
        check(gap <= PAR_PARAM_TOL, f"[parallel] MultiHostTrainer: params "
              f"after {PAR_MH_STEPS} steps {gap:.3g} off Trainer's")
        del after2["params"], ref
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[parallel] ({where}) world-1 NCCL group, CausalLM "
              f"{n_params} params, B={B} T={T}, bf16 compute, adamw; "
              f"{PAR_STEPS} steps a mode from one snapshot (a fit of one "
              f"warm-up step, then one fit of the rest timed), quantized "
              f"{PAR_Q_STEPS}, MultiHostTrainer {PAR_MH_STEPS} against a "
              f"Trainer run of as many")
        for name, (ms, peak, gap, equal, losses) in rows.items():
            vs = ("" if gap is None else
                  f"; params vs Trainer's {gap:.3g} "
                  f"({'bit-equal' if equal else 'not bit-equal'})")
            print(f"[parallel] ({where}) {name}: step {ms:.2f} ms "
                  f"({ms / ref_ms:.3f}x Trainer's {ref_ms:.2f}), peak "
                  f"allocated {peak / 2**30:.2f} GiB{vs}; losses "
                  + " ".join(f"{l:.6f}" for l in losses))
        print(f"[parallel] ({where}) quantized encoded: count {count} of "
              f"capacity {cap}, residual |sum| {res_abs:.4g}; launches K1, "
              f"K2, K3 {L} each a step in every run, {total['K1']} each in "
              f"all")
        dev = torch.device(device)
        dp = DataParallel(mesh)
        one = torch.ones(1, device=dev)
        flat = torch.randn(n_params, device=dev)
        k = max(1, int(n_params * C.auto_capacity_frac(1)))
        idx = torch.randint(0, n_params, (k,), device=dev,
                            dtype=torch.int32)
        val = torch.randn(k, device=dev)
        ar1 = time_ms(lambda: dist.all_reduce(one))
        arn = time_ms(lambda: dist.all_reduce(flat), reps=5)
        ag = time_ms(lambda: (dp.all_gather_rows(idx[None]),
                              dp.all_gather_rows(val[None])), reps=5)
        print(f"[parallel] ({where}) collectives at world 1: all-reduce of "
              f"1 f32 {ar1:.4f} ms, of {n_params} f32 (the flat gradient, "
              f"{4 * n_params / 1e9:.2f} GB) {arn:.3f} ms; all-gather of a "
              f"{k}-slot message (int32 + f32) {ag:.3f} ms")
        del idx, val
        g = flat.mul_(1e-3)
        r = torch.randn(n_params, device=dev).mul_(1e-4)
        box = {}

        def enc():
            box["e"] = C.threshold_encode(g, 1e-3, k, r)

        enc_ms = time_ms(enc, reps=5, warmup=1)
        e, r_new = box.pop("e")
        dense = torch.zeros(n_params, device=dev)
        dec_ms = time_ms(lambda: C.threshold_decode(e, out=dense), reps=5)
        count_q = int(e.count)
        del r_new, e, dense
        bound_ms = 1e3 * (12 * n_params + 5 * k) / PEAK_BYTES_PER_S
        print(f"[parallel] ({where}) codec over {n_params} f32 (capacity "
              f"{k} = auto_capacity_frac(1), threshold 1e-3, random "
              f"normal gradient, {count_q} over): encode {enc_ms:.3f} ms + "
              f"decode {dec_ms:.3f} ms = {enc_ms + dec_ms:.3f} ms against "
              f"a {bound_ms:.3f} ms bytes bound (gradient and residual "
              f"read, residual and {5 * k / 1e9:.3f} GB message written, "
              f"at 3.35 TB/s): {(enc_ms + dec_ms) / bound_ms:.2f}x")
        del g, r, flat
        gc.collect()
        torch.cuda.empty_cache()
        tx_model = Trainer(model)
        leaves = tree_leaves(tx_model.params)
        grads = [torch.randn_like(p).mul_(1e-3) for p in leaves]
        zero = ZeroOne(dp, tx_model.tx, leaves)
        z_state = zero.init(leaves)
        with torch.no_grad():
            plain_ms = time_ms(lambda: tx_model.tx.update(
                grads, tx_model.opt_state, leaves), reps=5)
            zero_ms = time_ms(lambda: zero.updates(grads, z_state, leaves),
                              reps=5)
        del z_state, grads, tx_model, zero, leaves
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[parallel] ({where}) ZeRO-1 update at world 1 (adamw on "
              f"the shards, the updates all-gathered): {zero_ms:.2f} ms "
              f"against the plain updater's {plain_ms:.2f} ms")
        restore()
        pi_counts = parallel_inference(model, where)
        total.update(pi_counts)
        del model, snap
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[parallel] ({where}) phase {time.perf_counter() - t_phase:.1f} s")
    return dict(total)


def parallel_inference(model, where):
    """PAR_PI_REQS concurrent 1024-token predicts through
    ParallelInference (buckets 1, 2, 4, 8): coalesced into fewer batches
    than requests, K1 once a layer and batch, each answer held against
    its request's direct forward as [serve] holds answers (ENGINE_RTOL,
    with another request's output as the control). Returns the kernels'
    launches."""
    from deeplearning4j_torch.parallel import ParallelInference

    wrappers = _kernel_wrappers()
    rng = np.random.RandomState(3)
    reqs = [rng.randint(0, 32000, (1, 1024)).astype(np.int32)
            for _ in range(PAR_PI_REQS)]
    answers, errors = [None] * PAR_PI_REQS, []
    pi = ParallelInference(model, batch_limit=8, max_wait_ms=50.0,
                           buckets=(1, 2, 4, 8))

    def client(i):
        try:
            answers[i] = pi.output(reqs[i])
        except Exception as e:  # reported below, fails the phase
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(PAR_PI_REQS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "clients hung")
        counts = {k: w.launches for k, w in wrappers.items()}
    finally:
        pi.shutdown()
    check(not errors, "; ".join(errors))
    batches = int(pi.engine.metrics.counter("serve_batches_total").value)
    check(0 < batches < PAR_PI_REQS,
          f"[parallel] {PAR_PI_REQS} predicts ran as {batches} batches")
    check(counts["K1"] == 12 * batches and counts["K2"] == 0,
          f"[parallel] ParallelInference launches {counts} for {batches} "
          f"batches")
    direct = [model.output(r).cpu().numpy() for r in reqs]

    def rel_gap(a, b):
        return float((np.abs(a - b) / b).max())

    own = [rel_gap(a, d) for a, d in zip(answers, direct)]
    other = min(rel_gap(a, direct[(i + 1) % PAR_PI_REQS])
                for i, a in enumerate(answers))
    check(max(own) <= ENGINE_RTOL and other > ENGINE_RTOL,
          f"[parallel] ParallelInference answers {own} against their "
          f"forwards, control {other}")
    print(f"[parallel] ({where}) ParallelInference: {PAR_PI_REQS} "
          f"concurrent 1 x 1024 predicts in {batches} batches, {wall:.3f} s "
          f"wall; max rel diff to the direct forward "
          f"{max(own):.3g} (control {other:.3g}); K1 {counts['K1']}")
    return counts


TP_STEPS = 5                # steps of each run (one warm-up, four timed:
#                             host time spreads about 10% between fits)
TP_MH_STEPS = 2             # MultiHostTrainer's steps against Trainer's
TP_PARAM_TOL = 1e-6         # f32 params after the steps, a rules run vs
#                             Trainer's, as [parallel]'s PAR_PARAM_TOL: at
#                             world 1 each collective passes its operand
#                             through, so bit-equality is expected and
#                             reported; the bound is the gate
RING_N, RING_BLOCK = 4, 256  # the ring's blocks at the full-width shape
# The ring's readings are element-wise: max |got - want| / (the largest
# |want| of the element's row, the D values of one (b, t, h), or the
# tensor's mean |want| where that is larger), so a row of small values is
# held to its own scale, not the tensor's largest.
# Limits: ring vs one flash call (the gate a ring fault meets), and ring
# vs the dense reference (f32 scores, no rounding inside, on the same
# inputs), where one flash call's own reading is printed beside: where a
# causal dq row's terms cancel (its first positions) the dense autograd's
# and the kernels' roundings part most. "sound": the largest reading of
# the unbroken ring on an H100 80GB HBM3 at 700 W.
RING_F32_TOL = 1e-5          # vs flash; sound 3.4e-6
RING_F32_DENSE_TOL = 1e-4    # vs dense; sound 1.74e-5 (causal dq)
# bf16: each block's output is rounded to bf16 by K1 before the f32 merge
# (one call rounds once), and each block's dq/dk/dv by K2/K3 before the f32
# sums; K2/K3 round p and ds to bf16 as the reference's Pallas kernels do
RING_BF16_TOL = 2.0 ** -5    # 8 bf16 ulps vs flash; sound 0.0142
RING_BF16_DENSE_TOL = 2.0 ** -3  # vs dense; sound 0.0786 (causal dq), 0.0104
#                                  elsewhere
RING_FAULT = math.log(2.0)  # the planted fault: one block's lse off by ln 2
#                             (its weight doubled) in the first merge of two
#                             blocks and in the first backward step off the
#                             diagonal; it read 0.70-1.12 in bf16, and its
#                             readings must exceed both limits
TP_SHAPE = dict(B=4, T=1024, V=32000, L=12, d=2048, H=32)  # [train]'s
PIPE_M = 4                  # microbatches of the pipeline check
PIPE_TOL = 1e-5             # f32 gradients, pipeline vs the block applied in
#                             turn: the same products summed in another
#                             order (max |diff| / max |want| a leaf)


class _TokenAccuracy:
    """A mergeable evaluation (the protocol of eval/evaluation.py's
    _Mergeable) of top-1 token accuracy: a confusion matrix at a 32000-way
    vocabulary would be 8 GB."""

    _STATE_FIELDS = ("correct", "total")

    def __init__(self):
        self.correct, self.total = 0, 0

    def new_like(self):
        return _TokenAccuracy()

    def eval(self, labels, predictions, mask=None):
        y = torch.as_tensor(np.asarray(labels)).to(predictions.device)
        self.correct += int((predictions.argmax(-1) == y.long()).sum())
        self.total += int(y.numel())
        return self

    def state(self):
        return {f: np.asarray(getattr(self, f)) for f in self._STATE_FIELDS}

    def load_state(self, d):
        self.correct, self.total = int(d["correct"]), int(d["total"])
        return self

    def merge(self, other):
        self.correct += other.correct
        self.total += other.total
        return self


def phase_tp_sp(device="cuda"):
    """[tp_sp]: tensor, sequence and pipeline parallelism on a world-1 NCCL
    group with a mesh of {data 1, model 1, seq 1} (every collective runs
    through its group), driving the full-width CausalLM(flash=True,
    ring=True) at [train]'s batch (B 4 x T 1024, bf16, adamw) from one
    snapshot of its seed-0 params: TP_STEPS steps each of Trainer.fit,
    Trainer(mesh=, rules=TRANSFORMER_RULES) (at seq 1 the layer takes
    flash, as the reference does), ParallelWrapper(rules=) in
    shared_gradients and zero_sharded, held against Trainer's params
    (TP_PARAM_TOL, bit-equality reported); MultiHostTrainer(rules=)'s
    TP_MH_STEPS steps against Trainer's, then evaluate(global_mesh=True);
    sharded_lm_step's one step, its loss against Trainer's first. K1, K2,
    K3 12 launches each a step in every run. Then the ring's schedule over
    RING_N blocks of RING_BLOCK at the full-width attention shape (B 4,
    T 1024, H 32, D 64), f32 and bf16, causal and not, held against one
    flash_attention call over the sequence and against the dense
    reference, launches counted, timed beside that call; and
    pipeline_apply over a pipe axis of 1 with PIPE_M microbatches of one
    full-width TransformerEncoderBlock(flash=True), equal to the block on
    each microbatch in turn. Peak allocated memory of each run. Returns
    each kernel's launches on the phase's paths (the reference calls
    excluded)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.models.transformer import sharded_lm_step
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.ops.flash_attention import flash_attention
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.parallel import (
        TRANSFORMER_RULES, MultiHostTrainer, ParallelWrapper,
        ProcessShardIterator, distributed_init, from_microbatches, make_mesh,
        pipeline_apply, reference_attention, ring_attention_blocks,
        stack_stage_params, to_microbatches)
    from deeplearning4j_torch.train import CollectScoresListener, Trainer
    from deeplearning4j_torch.train.trainer import build_updater

    where = card()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    check(distributed_init(f"file://{tmp}/store", 1, 0, device=device),
          "[tp_sp] no process group made")
    wrappers = _kernel_wrappers()
    total = collections.Counter()

    def launches():
        return {k: w.launches for k, w in wrappers.items()}

    def since(before):
        now = launches()
        return {k: now[k] - before[k] for k in now}

    def add_since(before):  # launches on the phase's paths
        got = since(before)
        total.update(got)
        return got

    rules_steps = [0]  # steps of the rules paths, for the closing tally

    try:
        mesh = make_mesh({"data": 1, "model": 1, "seq": 1})
        check(dist.get_backend() == ("nccl" if device == "cuda" else "gloo")
              and mesh.size == 1, f"[tp_sp] group {dist.get_backend()} of "
              f"{mesh.size}")
        from deeplearning4j_torch.models import CausalLM

        sh = TP_SHAPE
        B, T, V, L_ = sh["B"], sh["T"], sh["V"], sh["L"]
        model = CausalLM(seed=0, input_shape=(T,), num_layers=L_,
                         d_model=sh["d"], num_heads=sh["H"], vocab=V,
                         flash=True, ring=True, device=device).build()
        model.config.compute_dtype = "bfloat16"
        model.init(seed=0)
        n_params = model.param_count()
        snap = [p.detach().clone() for p in tree_leaves(model.params)]
        rng = np.random.RandomState(0)
        x = rng.randint(0, V, (B, T)).astype(np.int32)
        y = rng.randint(0, V, (B, T)).astype(np.int32)

        def restore():
            with torch.no_grad():
                for p, s in zip(tree_leaves(model.params), snap):
                    p.copy_(s)

        def run(name, make, fits=(1, TP_STEPS - 1), shards=False,
                after=None, path=True):
            """``path``: a run of the phase's paths (its launches count);
            the plain Trainer's reference runs are not."""
            restore()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = launches()
            t = make()
            scores = CollectScoresListener()
            steps = sum(fits)
            t0 = None
            for i, n in enumerate(fits):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                xs, ys = np.tile(x, (n, 1)), np.tile(y, (n, 1))
                it = (ProcessShardIterator(xs, ys, B, *t.data_shard())
                      if shards else ArrayIterator(xs, ys, batch_size=B))
                t.fit(it, listeners=[scores])
                if after is not None:
                    after(i, t)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / (steps - fits[0])
            counts = add_since(before) if path else since(before)
            rules_steps[0] += steps if path else 0
            check(tuple(counts[k] for k in ("K1", "K2", "K3"))
                  == (L_ * steps,) * 3,
                  f"[tp_sp] {name}: launches K1, K2, K3 "
                  f"{[counts[k] for k in ('K1', 'K2', 'K3')]}, want "
                  f"{L_ * steps} each over {steps} steps")
            losses = [l for _, l in scores.scores]
            check(len(losses) == steps and all(np.isfinite(losses)),
                  f"[tp_sp] {name}: losses {losses}")
            return t, losses, ms, torch.cuda.max_memory_allocated()

        rows, kept = {}, {}

        def keep(i, t):
            if i == 0:
                kept["first"] = [p.detach().clone()
                                 for p in tree_leaves(t.params)]
            if i == 1:
                kept["two"] = [p.detach().clone()
                               for p in tree_leaves(t.params)]

        # the first run of a process warms the allocator and the kernels'
        # libraries: its 2 steps are MultiHostTrainer's and
        # sharded_lm_step's references, the timed reference comes next
        t, *_ = run("Trainer (2 steps)", lambda: Trainer(model), fits=(1, 1),
                    after=keep, path=False)
        del t
        t, ref_losses, ref_ms, ref_peak = run(
            "Trainer", lambda: Trainer(model), path=False)
        ref = [p.detach().clone() for p in tree_leaves(t.params)]
        del t
        rows["Trainer"] = (ref_ms, ref_peak, None, None, ref_losses)
        runs = (
            ("Trainer(rules=)", lambda: Trainer(
                model, mesh=mesh, rules=TRANSFORMER_RULES)),
            ("ParallelWrapper shared_gradients", lambda: ParallelWrapper(
                model, mesh=mesh, rules=TRANSFORMER_RULES)),
            ("ParallelWrapper zero_sharded", lambda: ParallelWrapper(
                model, mesh=mesh, mode="zero_sharded",
                rules=TRANSFORMER_RULES)),
        )
        for name, make in runs:
            t, losses, ms, peak = run(name, make)
            gap, equal = _par_gap(tree_leaves(t.params), ref)
            del t
            rows[name] = (ms, peak, gap, equal, losses)
            check(gap <= TP_PARAM_TOL, f"[tp_sp] {name}: params after "
                  f"{TP_STEPS} steps {gap:.3g} off Trainer's (limit "
                  f"{TP_PARAM_TOL})")
        t, mh_losses, mh_ms, mh_peak = run(
            "MultiHostTrainer(rules=)", lambda: MultiHostTrainer(
                model, mesh=mesh, rules=TRANSFORMER_RULES),
            fits=(1, TP_MH_STEPS - 1), shards=True)
        gap, equal = _par_gap(tree_leaves(t.params), kept["two"])
        rows["MultiHostTrainer(rules=)"] = (mh_ms, mh_peak, gap, equal,
                                            mh_losses)
        check(gap <= TP_PARAM_TOL, f"[tp_sp] MultiHostTrainer(rules=): "
              f"params after {TP_MH_STEPS} steps {gap:.3g} off Trainer's")
        before = launches()
        ev = t.evaluate(ProcessShardIterator(x, y, B, *t.data_shard()),
                        _TokenAccuracy(), global_mesh=True)
        ev_counts = add_since(before)
        check(ev.total == B * T and ev_counts["K1"] == L_
              and ev_counts["K2"] == ev_counts["K3"] == 0,
              f"[tp_sp] evaluate(global_mesh=True): {ev.total} tokens, "
              f"launches {ev_counts}")
        del t
        # sharded_lm_step: one step from the snapshot
        restore()
        gc.collect()
        torch.cuda.empty_cache()
        before = launches()
        step, p, opt, place = sharded_lm_step(model, mesh,
                                              build_updater(model))
        toks, tgts = place(x, y)
        p, opt, loss = step(p, opt, toks, tgts)
        lm_loss = float(loss)
        lm_gap, lm_equal = _par_gap(tree_leaves(p), kept["first"])
        add_since(before)
        rules_steps[0] += 1
        del step, p, opt
        check(lm_loss == ref_losses[0] or abs(lm_loss - ref_losses[0])
              <= 1e-6 * abs(ref_losses[0]),
              f"[tp_sp] sharded_lm_step loss {lm_loss} against Trainer's "
              f"first {ref_losses[0]}")
        check(lm_gap <= TP_PARAM_TOL, f"[tp_sp] sharded_lm_step params "
              f"{lm_gap:.3g} off Trainer's first step")
        # where a rules step's time goes against a plain one's (the plain
        # one's launches are not the phase's)
        anatomy = {}
        for name, make in (("Trainer", lambda: Trainer(model)),
                           ("Trainer(rules=)", lambda: Trainer(
                               model, mesh=mesh, rules=TRANSFORMER_RULES))):
            restore()
            gc.collect()
            torch.cuda.empty_cache()
            before = launches()
            t = make()
            fits = [0]

            def fit_once():
                fits[0] += 1
                t.fit(ArrayIterator(x, y, batch_size=B))

            anatomy[name] = _step_anatomy(fit_once)
            if t.rules:
                add_since(before)
                rules_steps[0] += fits[0]
            del t
        del kept, ref, snap
        gc.collect()
        torch.cuda.empty_cache()
        for name, a in anatomy.items():
            print(f"[tp_sp] ({where}) {name} step anatomy: {a['wall']:.2f} "
                  f"ms on the host clock, the card busy {a['busy']:.2f} ms "
                  f"({a['busy'] / a['wall']:.3f}); NCCL {a['nccl_n']} "
                  f"kernels {a['nccl_ms']:.2f} ms; top device: {a['dev']}; "
                  f"top host (self): {a['host']}")
        print(f"[tp_sp] ({where}) world-1 NCCL group, mesh {{data 1, model "
              f"1, seq 1}}, CausalLM(flash, ring) {n_params} params, B={B} "
              f"T={T}, bf16 compute, adamw; {TP_STEPS} steps a run from one "
              f"snapshot (a fit of one warm-up step, the rest timed), "
              f"MultiHostTrainer {TP_MH_STEPS}")
        for name, (ms, peak, gap, equal, losses) in rows.items():
            vs = ("" if gap is None else
                  f"; params vs Trainer's {gap:.3g} "
                  f"({'bit-equal' if equal else 'not bit-equal'})")
            print(f"[tp_sp] ({where}) {name}: step {ms:.2f} ms "
                  f"({ms / ref_ms:.3f}x Trainer's {ref_ms:.2f}), peak "
                  f"allocated {peak / 2**30:.2f} GiB{vs}; losses "
                  + " ".join(f"{l:.6f}" for l in losses))
        print(f"[tp_sp] ({where}) evaluate(global_mesh=True): token "
              f"accuracy {ev.correct}/{ev.total}; sharded_lm_step loss "
              f"{lm_loss:.6f} (Trainer's first {ref_losses[0]:.6f}), params "
              f"{'bit-equal' if lm_equal else f'{lm_gap:.3g} off'}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        ring_rows = tp_ring_kernels(where, flash_attention,
                                    reference_attention,
                                    ring_attention_blocks, launches,
                                    add_since, device)
        tp_pipeline(where, L, stack_stage_params, to_microbatches,
                    from_microbatches, pipeline_apply, launches, add_since)
        # the tally: 12 a step of every rules path, evaluate's forward, the
        # ring's blocks, the pipeline's microbatches, and nothing else
        ring = 2 * (RING_N * (RING_N + 1) // 2 + RING_N ** 2)
        want = {k_: 0 for k_ in wrappers}
        want["K1"] = L_ * rules_steps[0] + L_ + ring + 2 * PIPE_M
        want["K2"] = want["K3"] = L_ * rules_steps[0] + ring + PIPE_M
        check(all(total[k_] == n for k_, n in want.items()),
              f"[tp_sp] launches on the phase's paths {dict(total)}, want "
              f"{want} ({rules_steps[0]} rules steps)")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[tp_sp] ({where}) phase {time.perf_counter() - t_phase:.1f} s")
    return dict(total), ring_rows


def _step_anatomy(fit_once, top: int = 6):
    """One step (``fit_once()``) timed on the host around a synchronize,
    and traced by torch.profiler (after a warm-up step): the device's busy
    ms (the sum of its kernels' and copies' self time), the top device
    operations by time, the top host operations by self time, and the
    NCCL kernels' count and ms."""
    from torch.profiler import ProfilerActivity

    fit_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_once()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    prof = _profiled(fit_once, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in _on_card(prof):  # kernels, copies and sets on the card
        by_name[e.name[:40]][0] += (e.time_range.end
                                    - e.time_range.start) / 1e3
        by_name[e.name[:40]][1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    nccl = [v for k, v in by_name.items() if "nccl" in k.lower()]
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    top_host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:top]
    return dict(
        wall=wall, busy=busy, nccl_n=sum(n for _, n in nccl),
        nccl_ms=sum(ms for ms, _ in nccl),
        dev=", ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in top_dev),
        host=", ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms"
                       f" x{e.count}" for e in top_host))


def _row_reading(got, want) -> float:
    """max |got - want| / the largest |want| of the element's row (the last
    dim), or the tensor's mean |want| where that is larger (a row of zeros,
    as dq's first under causal, is held to the tensor's scale)."""
    g, w = got.detach().float(), want.detach().float()
    row = w.abs().amax(dim=-1, keepdim=True).clamp_min(float(w.abs().mean()))
    return float(((g - w).abs() / row).max())


@contextlib.contextmanager
def _planted_ring_fault(delta):
    """The ring with one fault planted in it (nothing on disk changes):
    one block's lse off by ``delta`` in its first merge of two blocks and
    in its first backward step off the diagonal."""
    import importlib
    from unittest import mock

    # the package exports a function of the module's name
    RA = importlib.import_module(
        "deeplearning4j_torch.parallel.ring_attention")

    merge, backward = RA.merge, RA.ring_step_backward
    done = {"fwd": False, "bwd": False}

    def bad_merge(state, o_i, lse_i):
        if state[0] is not None and not done["fwd"]:
            done["fwd"] = True
            lse_i = lse_i + delta
        return merge(state, o_i, lse_i)

    def bad_backward(q, k, v, do, lse, delta_, q_block, k_block, **kw):
        if q_block > k_block or (q_block < k_block and not kw["causal"]):
            if not done["bwd"]:
                done["bwd"] = True
                lse = lse + delta
        return backward(q, k, v, do, lse, delta_, q_block, k_block, **kw)

    with mock.patch.object(RA, "merge", bad_merge), \
            mock.patch.object(RA, "ring_step_backward", bad_backward):
        yield done


def tp_ring_kernels(where, flash_attention, reference_attention,
                    ring_attention_blocks, launches, add_since,
                    dev="cuda"):
    """The ring's schedule over RING_N blocks in one process at the
    full-width attention shape, f32 and bf16, causal and not: output and
    dq, dk, dv against one flash_attention call over the sequence and the
    dense reference, element by element against the row's scale
    (``_row_reading``); the same readings of the ring with a planted fault
    (``_planted_ring_fault``) must exceed the limits. K1,
    K2, K3 launches counted (n(n+1)/2 causal, n^2 not); forward +
    backward timed beside the call's."""
    B, H = TP_SHAPE["B"], TP_SHAPE["H"]
    D = TP_SHAPE["d"] // H
    T = RING_N * RING_BLOCK
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol_f, tol_r = ((RING_F32_TOL, RING_F32_DENSE_TOL)
                        if dtype == torch.float32
                        else (RING_BF16_TOL, RING_BF16_DENSE_TOL))
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, cot = (torch.randn((B, T, H, D), generator=g,
                                    device=dev).to(dtype)
                        for _ in range(4))
        for causal in (True, False):
            want = RING_N * (RING_N + 1) // 2 if causal else RING_N ** 2
            what = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"

            def fwd_bwd(fn, ins):
                o = fn(*ins)
                (o.float() * cot.float()).sum().backward()
                return o

            def outs(fn, cast=torch.clone):
                a = [cast(t).requires_grad_() for t in (q, k, v)]
                o = fwd_bwd(fn, a)
                return [o.detach()] + [t.grad for t in a]

            ring = lambda *a: ring_attention_blocks(  # noqa: E731
                *a, RING_N, causal=causal)
            flash = lambda *a: flash_attention(*a, causal=causal)  # noqa: E731
            before = launches()
            got = outs(ring)
            torch.cuda.synchronize()
            n = add_since(before)
            check(tuple(n[k_] for k_ in ("K1", "K2", "K3")) == (want,) * 3,
                  f"[tp_sp] ring {what}: launches K1, K2, K3 "
                  f"{[n[k_] for k_ in ('K1', 'K2', 'K3')]}, want {want}")
            f = outs(flash)
            r = outs(lambda *t: reference_attention(*t, causal=causal),
                     cast=lambda t: t.to(torch.float32, copy=True))
            names = ("o", "dq", "dk", "dv")
            errs = {}
            for name, x_, y_, z_ in zip(names, got, f, r):
                errs[name] = (_row_reading(x_, y_), _row_reading(x_, z_),
                              _row_reading(y_, z_))
                check(errs[name][0] <= tol_f,
                      f"[tp_sp] ring {what} {name}: {errs[name][0]:.3g} of "
                      f"the row's largest off one flash call (limit "
                      f"{tol_f:.3g})")
                check(errs[name][1] <= tol_r,
                      f"[tp_sp] ring {what} {name}: {errs[name][1]:.3g} of "
                      f"the row's largest off the dense reference (limit "
                      f"{tol_r:.3g})")
            with _planted_ring_fault(RING_FAULT) as planted:
                bad = outs(ring)
            check(planted["fwd"] and planted["bwd"],
                  f"[tp_sp] ring {what}: the planted fault did not fire")
            fault = {name: (_row_reading(x_, y_), _row_reading(x_, z_))
                     for name, x_, y_, z_ in zip(names, bad, f, r)}
            for name, e in fault.items():
                check(e[0] > tol_f and e[1] > tol_r,
                      f"[tp_sp] ring {what} {name}: a planted fault reads "
                      f"{e[0]:.3g} / {e[1]:.3g}, within the limits {tol_f:.3g}"
                      f" / {tol_r:.3g}")
            del bad
            del got, f, r
            ring_ms = time_ms(lambda: fwd_bwd(ring, [
                t.clone().requires_grad_() for t in (q, k, v)]), reps=5)
            flash_ms = time_ms(lambda: fwd_bwd(flash, [
                t.clone().requires_grad_() for t in (q, k, v)]), reps=5)
            rows[what] = (ring_ms, flash_ms, errs, fault)
            print(f"[tp_sp] ({where}) ring {what}, {RING_N} blocks of "
                  f"{RING_BLOCK} at B={B} T={T} H={H} D={D}: launches K1, K2, "
                  f"K3 {want} each; forward + backward {ring_ms:.3f} ms "
                  f"against one flash_attention call's {flash_ms:.3f} ms; "
                  f"max |err| / row's largest, ring vs flash (limit "
                  f"{tol_f:.3g}) / ring vs dense (limit {tol_r:.3g}) / flash "
                  f"vs dense: " + ", ".join(
                      f"{n_} {e[0]:.3g} / {e[1]:.3g} / {e[2]:.3g}"
                      for n_, e in errs.items())
                  + f"; planted fault (one block's lse + {RING_FAULT:.3g}) vs "
                  "flash / vs dense: " + ", ".join(
                      f"{n_} {e[0]:.3g} / {e[1]:.3g}"
                      for n_, e in fault.items()))
    return rows


def tp_pipeline(where, L, stack_stage_params, to_microbatches,
                from_microbatches, pipeline_apply, launches, add_since):
    """pipeline_apply over a pipe axis of 1 (its own world-1 mesh) with
    PIPE_M microbatches of one full-width TransformerEncoderBlock
    (flash=True, f32): output bit-equal to the block on each microbatch in
    turn, gradients within PIPE_TOL; K1 2 x PIPE_M (forward and the
    backward's re-materialization), K2 and K3 PIPE_M."""
    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
    from deeplearning4j_torch.parallel import make_mesh

    mesh = make_mesh({"pipe": 1})
    T, d = TP_SHAPE["T"], TP_SHAPE["d"]
    blk = L.TransformerEncoderBlock(num_heads=TP_SHAPE["H"], causal=True,
                                    flash=True)
    g = torch.Generator(device=mesh.device).manual_seed(0)
    p, _ = blk.init(g, (T, d), device=mesh.device)
    x = torch.randn((PIPE_M, T, d), generator=g, device=mesh.device)

    def stage(sp, h):
        return blk.apply(sp, {}, h, training=False)[0]

    stacked = stack_stage_params([p])
    leaves = tree_leaves(stacked)
    for t in leaves:
        t.requires_grad_()
    xp = x.clone().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    before = launches()
    t0 = time.perf_counter()
    out = from_microbatches(pipeline_apply(stage, stacked,
                                           to_microbatches(xp, PIPE_M), mesh))
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    got = add_since(before)
    peak = torch.cuda.max_memory_allocated()
    check((got["K1"], got["K2"], got["K3"]) == (2 * PIPE_M, PIPE_M, PIPE_M),
          f"[tp_sp] pipeline: launches K1, K2, K3 "
          f"{[got[k] for k in ('K1', 'K2', 'K3')]}, want {2 * PIPE_M}, "
          f"{PIPE_M}, {PIPE_M}")
    ref_p = tree_unflatten(p, [t.detach().clone().requires_grad_()
                               for t in tree_leaves(p)])
    xr = x.clone().requires_grad_()
    ref = torch.cat([stage(ref_p, xr[i:i + 1]) for i in range(PIPE_M)])
    (ref.float() ** 2).sum().backward()
    check(torch.equal(out, ref), f"[tp_sp] pipeline output "
          f"{float((out - ref).abs().max()):.3g} off the block in turn")
    gaps = [float((a.grad[0] - b.grad).abs().max())
            / max(float(b.grad.abs().max()), 1e-30)
            for a, b in zip(leaves, tree_leaves(ref_p))]
    gaps.append(float((xp.grad - xr.grad).abs().max())
                / max(float(xr.grad.abs().max()), 1e-30))
    check(max(gaps) <= PIPE_TOL, f"[tp_sp] pipeline gradients {max(gaps):.3g}"
          f" off the block in turn (limit {PIPE_TOL})")
    print(f"[tp_sp] ({where}) pipeline_apply over pipe 1, {PIPE_M} "
          f"microbatches of (1, {T}, {d}) through one "
          f"TransformerEncoderBlock(flash, {TP_SHAPE['H']} heads, f32): "
          f"output bit-equal "
          f"to the block in turn, gradients max {max(gaps):.3g} of each "
          f"leaf's largest; K1 {got['K1']}, K2 {got['K2']}, K3 {got['K3']}; "
          f"forward + backward {pipe_s:.3f} s (first call), peak allocated "
          f"{peak / 2**30:.2f} GiB")


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


def _bn_grad_gate(model, params, state, x, y, rtol, what, tag, keys=None):
    """f32 gradients of every param of ``model`` on (x, y) (of the nodes
    in ``keys`` when given: a frozen node's params get none): through
    K4a/K4b against through their plain versions. Each param's largest
    difference is held to ``rtol`` of the largest gradient entry of its
    node (its layer's params together): a BatchNorm whose output reaches
    only BatchNorms through ReLU and max pooling (ResNet-50's stem) has a
    beta gradient that is zero up to rounding, whose own largest entry is
    no scale."""
    from deeplearning4j_torch.ops import batch_norm
    from deeplearning4j_torch.ops.updaters import tree_leaves

    keys = sorted(params) if keys is None else sorted(keys)
    names = [k for k in keys for _ in tree_leaves(params[k])]
    leaves = [p.requires_grad_() for k in keys
              for p in tree_leaves(params[k])]
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


# ---------------------------------------------------------------- transfer
TR_B, TR_TRAIN, TR_VAL = 128, 4, 2      # batch, training and held-out batches
TR_SIZE, TR_CLASSES = 224, 5
TR_FROZEN_TILL = "s2b5"
TR_MAX_EPOCHS = 3
TR_SPE = 4
TR_GRAD_B = 8
TR_GRAD_RTOL = 1e-3     # f32 gradients, kernels vs plain BN backward
TR_BN_SHAPES = ((TR_B * 7 * 7, 512), (TR_B * 7 * 7, 2048))
TR_SERVE_BUCKETS = (1, 4, 16)
TR_SERVE_REQS = (1, 3, 16, 5)
TR_VGG_B, TR_VGG_BATCHES, TR_VGG_EPOCHS = 64, 2, 5
TR_VGG_RTOL = 1e-2      # the helper's head step against the full net's
TR_FTC = dict(updater={"type": "nesterovs", "learning_rate": 1e-3,
                       "momentum": 0.9},
              gradient_normalization="RenormalizeL2PerLayer")


def _transfer_images(n, seed):
    """``n`` synthetic uint8 images at TR_SIZE² of TR_CLASSES classes from
    ``numpy.random.default_rng(seed)``: each class a colour and a stripe
    frequency of its own under per-pixel noise (sd 40), and its one-hot
    labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, TR_CLASSES, n)
    colours = np.array([[190, 70, 70], [70, 190, 70], [70, 70, 190],
                        [190, 190, 70], [70, 190, 190]], np.float32)
    yy, xx = np.mgrid[0:TR_SIZE, 0:TR_SIZE].astype(np.float32)
    x = np.empty((n, TR_SIZE, TR_SIZE, 3), np.uint8)
    for c in range(TR_CLASSES):
        idx = np.flatnonzero(labels == c)
        stripes = 40 * np.sin(2 * np.pi * (3 + 4 * c) * (xx + yy) / TR_SIZE)
        base = colours[c] + stripes[..., None]
        noise = 40 * rng.standard_normal((len(idx), TR_SIZE, TR_SIZE, 3),
                                         dtype=np.float32)
        x[idx] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return x, np.eye(TR_CLASSES, dtype=np.float32)[labels]


def _transfer_net(compute_dtype="bfloat16"):
    """The zoo's ResNet50(seed=0) (its params from seed 0 on the card) and
    the transfer network: frozen through TR_FROZEN_TILL, a TR_CLASSES-way
    head, Nesterovs with RenormalizeL2PerLayer."""
    from deeplearning4j_torch.nn.transfer import (FineTuneConfiguration,
                                                  TransferGraphBuilder)

    src = _resnet50(compute_dtype)
    src.init(seed=0)
    net, _, _ = (TransferGraphBuilder(src)
                 .fine_tune_configuration(FineTuneConfiguration(**TR_FTC))
                 .set_feature_extractor(TR_FROZEN_TILL)
                 .n_out_replace("out", TR_CLASSES).build())
    return src, net


def _frozen_keys(net):
    from deeplearning4j_torch.nn.layers import Frozen

    return {n for n in net.topo_order if isinstance(net.nodes[n].spec, Frozen)}


def _clones(tree, keys):
    from deeplearning4j_torch.ops.updaters import tree_leaves

    return {k: [t.detach().clone() for t in tree_leaves(tree[k])]
            for k in keys if k in tree}


def _transfer_flop(net, batch):
    """Model FLOP of one fine-tune step, 2 a multiply-add: every conv's and
    dense layer's forward; the backward of the unfrozen ones only, their
    weight gradient always and their input gradient where the input needs
    one (not for the first unfrozen stage's two convs, whose input comes
    from the frozen trunk)."""
    from deeplearning4j_torch.nn.layers import Conv2D, Frozen, Output

    frozen = _frozen_keys(net)
    fwd = bwd = 0
    for name in net.topo_order:
        node = net.nodes[name]
        spec = node.spec._sub() if isinstance(node.spec, Frozen) else node.spec
        if isinstance(spec, Conv2D):
            oh, ow, co = net.node_shape(name)
            kh, kw = spec.kernel
            ci = net.node_shape(node.inputs[0])[-1] // spec.groups
            macs = oh * ow * co * kh * kw * ci
        elif isinstance(spec, Output):
            macs = net.node_shape(node.inputs[0])[-1] * spec.n_out
        else:
            continue
        fwd += macs
        if name not in frozen:
            src = node.inputs[0]
            while src in net.nodes and not net.nodes[src].is_layer():
                src = net.nodes[src].inputs[0]
            bwd += macs * (1 if src == TR_FROZEN_TILL else 2)
    return 2 * (fwd + bwd) * batch, 2 * fwd * batch


def transfer_fine_tune(where, xtr, ytr, xva, yva):
    """The ResNet-50 fine-tune under ``EarlyStoppingTrainer``
    (MaxEpochsTermination(TR_MAX_EPOCHS), ScoreImprovementEpochTermination(1),
    InvalidScoreIterationTermination, DataSetLossCalculator on the held-out
    batches, InMemoryModelSaver), then ``Trainer.evaluate``. Gated: K4a and
    K4b launch 10 times a step (the unfrozen stage's BatchNorms) over the
    whole run and 0 times in an inference forward; frozen leaves and
    frozen running statistics bit-equal to the source's, every unfrozen
    leaf changed; losses finite; the last epoch's held-out score below the
    first. Printed: step ms, images/s, model FLOP and MFU, device ms and
    operations of a step and the idle share, peak memory, the result."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                            earlystopping as es)

    src, net = _transfer_net()
    frozen = _frozen_keys(net)
    n_bn = sum(1 for n, _, _ in _bn_nodes(net, TR_B) if n not in frozen)
    check(n_bn == 10, f"transfer: {n_bn} unfrozen BatchNorms, want 10")
    frozen_params = _clones(net.params, frozen)
    frozen_stats = _clones(net.state, frozen)
    start = _clones(net.params, set(net.params) - frozen)
    flop, flop_fwd = _transfer_flop(net, TR_B)
    n_frozen = sum(t.numel() for k in frozen_params
                   for t in frozen_params[k])
    print(f"[transfer] ResNet-50 source (seed 0, {src.param_count()} params) "
          f"-> frozen through {TR_FROZEN_TILL} ({len(frozen)} frozen nodes, "
          f"{n_frozen} frozen params), a {TR_CLASSES}-way head; unfrozen "
          f"stage s3 with {n_bn} BatchNorms; model FLOP a step {flop:.4g} "
          f"(forward of every layer {flop_fwd:.4g}, backward of the "
          f"unfrozen ones)")
    wrappers = _kernel_wrappers()
    trainer = Trainer(net)
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            ArrayIterator(xva, yva, batch_size=TR_B)),
        epoch_terminations=[es.MaxEpochsTermination(TR_MAX_EPOCHS),
                            es.ScoreImprovementEpochTermination(1)],
        iteration_terminations=[es.InvalidScoreIterationTermination()],
        model_saver=es.InMemoryModelSaver())
    rec = CollectScoresListener()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(cfg, trainer).fit(
        ArrayIterator(xtr, ytr, batch_size=TR_B), max_epochs=10,
        listeners=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in rec.scores]
    steps = len(losses)
    scores = [result.score_vs_epoch[e] for e in sorted(result.score_vs_epoch)]
    check(steps == result.total_epochs * TR_TRAIN and all(np.isfinite(losses)),
          f"transfer: losses {losses}")
    check(counts["K4a"] == counts["K4b"] == n_bn * steps
          and counts["K4a_unfused"] == 0
          and all(counts[k] == 0 for k in ("K1", "K2", "K3", "K5")),
          f"transfer: launches {counts} over {steps} steps, want fused K4a "
          f"and K4b {n_bn} each a step, no other kernel")
    check(len(scores) >= 2 and scores[-1] < scores[0],
          f"transfer: held-out scores by epoch {scores} did not fall")
    for k, leaves in frozen_params.items():
        check(all(torch.equal(a, b) for a, b in
                  zip(leaves, tree_leaves(trainer.params[k]))),
              f"transfer: frozen params of {k} changed")
    for k, leaves in frozen_stats.items():
        check(all(torch.equal(a, b) for a, b in
                  zip(leaves, tree_leaves(trainer.state[k]))),
              f"transfer: frozen running statistics of {k} changed")
    for k, leaves in start.items():
        for i, (a, b) in enumerate(zip(leaves, tree_leaves(trainer.params[k]))):
            check(not torch.equal(a, b), f"transfer: unfrozen leaf {i} of "
                  f"{k} did not change")
    # one step and one inference forward, launches counted alone
    xb, yb = (torch.from_numpy(a).cuda() for a in (xtr[:TR_B], ytr[:TR_B]))
    p, o, s = trainer.params, trainer.opt_state, trainer.state
    for w in wrappers.values():
        w.launches = 0
    trainer.step(p, o, s, xb, yb)
    torch.cuda.synchronize()
    one = {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():
        net.score(p, s, xb, yb, training=True)
    torch.cuda.synchronize()
    fwd = {k: w.launches for k, w in wrappers.items()}
    check(one["K4a"] == one["K4b"] == n_bn and fwd["K4a"] == fwd["K4b"] == 0,
          f"transfer: one step launched {one}, a forward {fwd}")
    ev = trainer.evaluate(ArrayIterator(xva, yva, batch_size=TR_B))
    # the step timed on its own: TR_TRAIN steps in one fit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(ArrayIterator(xtr, ytr, batch_size=TR_B))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / TR_TRAIN
    dev_ms, dev_ops = device_ms(lambda: trainer.step(p, o, s, xb, yb),
                                reps=2)
    print(f"[transfer] EarlyStoppingTrainer on {where}: {result.total_epochs} "
          f"epochs of {TR_TRAIN} batches of {TR_B} ({wall:.2f} s with the "
          f"scoring), reason {result.termination_reason} "
          f"({result.termination_details}), best epoch {result.best_epoch}, "
          f"held-out score by epoch " + " ".join(f"{v:.5f}" for v in scores)
          + "; training losses " + " ".join(f"{l:.4f}" for l in losses))
    print(f"[transfer] evaluate on the held-out batches: accuracy "
          f"{ev.accuracy():.4f}, F1 {ev.f1():.4f}")
    print(f"[transfer] launches over the run: K4a {counts['K4a']}, K4b "
          f"{counts['K4b']} ({n_bn} each a step x {steps} steps); one step "
          f"{one['K4a']}/{one['K4b']}; an inference forward of the whole "
          f"network {fwd['K4a']}/{fwd['K4b']}; K1-K3, K5 0")
    print(f"[transfer] step {step_ms:.2f} ms (a fit of {TR_TRAIN} steps, "
          f"window / steps), {TR_B / step_ms * 1e3:.1f} images/s; MFU "
          f"{flop / (step_ms * 1e-3) / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s; "
          f"one step on the device {dev_ms:.2f} ms in {dev_ops:.0f} device "
          f"operations (profiler), idle share {1 - dev_ms / step_ms:.4f}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    best_params, best_state, best_score = cfg.model_saver.get_best()
    out = {"counts": counts, "steps": steps, "step_ms": step_ms,
           "dev_ms": dev_ms, "dev_ops": dev_ops, "peak_gib": peak / 2**30,
           "flop": flop, "n_bn": n_bn, "scores": scores,
           "best_epoch": result.best_epoch,
           "reason": result.termination_reason,
           "accuracy": ev.accuracy(), "f1": ev.f1()}
    return net, best_params, best_state, out


def transfer_serve(net, params, state, where, tmp):
    """The best model saved with its ImageScaler (``save_model(...,
    normalizer=)``), loaded back on the card with ``load_model`` and
    ``load_normalizer``, and served through ``ServeEngine`` (buckets 1, 4,
    16) to raw uint8 images, the normalizer applied on the card inside the
    engine's forward. Gated: every answer bit-equal to ``Graph.output`` on
    its images padded to the bucket the engine ran (normalized once);
    within ZOO_SERVE_BF16_ATOL of ``Graph.output`` on its images alone; and
    a forward normalized twice, the control, outside that."""
    from deeplearning4j_torch.data import ImageScaler
    from deeplearning4j_torch.serve import ServeEngine
    from deeplearning4j_torch.train import (load_model, load_normalizer,
                                            save_model)

    path = os.path.join(tmp, "transfer.zip")
    save_model(path, net, params=params, state=state,
               normalizer=ImageScaler())
    model, _, _ = load_model(path)
    scaler = load_normalizer(path)
    check(isinstance(scaler, ImageScaler), f"loaded normalizer {scaler}")
    model.config.compute_dtype = "bfloat16"
    reqs = [_transfer_images(n, 20 + i)[0]
            for i, n in enumerate(TR_SERVE_REQS)]
    dev = model.device

    def forward(p, s, x):
        with torch.inference_mode():
            xt = scaler.transform(torch.from_numpy(x).to(dev))
            return model.forward(p, s, xt, training=False)[0][0] \
                .float().cpu().numpy()

    def direct(x, rows, times=1):
        xt = torch.from_numpy(np.concatenate(
            [x, np.zeros((rows - len(x),) + x.shape[1:], x.dtype)])).to(dev)
        for _ in range(times):
            xt = scaler.transform(xt)
        return model.output(xt)[0][:len(x)].float().cpu().numpy()

    with _deterministic():
        eng = ServeEngine(model, batch_buckets=TR_SERVE_BUCKETS,
                          length_buckets=None, forward=forward)
        t0 = time.perf_counter()
        try:
            answers = [eng.predict(x) for x in reqs]
        finally:
            eng.shutdown()
        wall = time.perf_counter() - t0
        bucket = [next(b for b in TR_SERVE_BUCKETS if b >= len(x))
                  for x in reqs]
        exact = [float(np.abs(y - direct(x, b)).max())
                 for x, y, b in zip(reqs, answers, bucket)]
        alone = [float(np.abs(y - direct(x, len(x))).max())
                 for x, y in zip(reqs, answers)]
        twice = [float(np.abs(y - direct(x, b, 2)).max())
                 for x, y, b in zip(reqs, answers, bucket)]
    for x, y in zip(reqs, answers):
        check(y.shape == (len(x), TR_CLASSES) and np.isfinite(y).all()
              and np.allclose(y.sum(-1), 1, atol=1e-2),
              f"transfer served answer of shape {y.shape}")
    print(f"[transfer] the best model saved with its normalizer, loaded and "
          f"served on {where}: requests of {list(TR_SERVE_REQS)} raw uint8 "
          f"images, {wall:.3f} s wall; max |served - Graph.output| on the "
          f"padded bucket batch " + " ".join(f"{v:.3g}" for v in exact)
          + "; on the images alone " + " ".join(f"{v:.3g}" for v in alone)
          + f" (gate {ZOO_SERVE_BF16_ATOL}); normalized twice (control) "
          + " ".join(f"{v:.3g}" for v in twice))
    check(max(exact) == 0.0, "a served answer differs from Graph.output on "
          "its padded bucket batch")
    check(max(alone) <= ZOO_SERVE_BF16_ATOL < min(twice), "served answers "
          "against the images alone, or the twice-normalized control")


def transfer_graph(where, x, y):
    """The fine-tune eagerly and at steps_per_execution=TR_SPE (one
    captured graph): iteration 0 alone, then 2 x TR_SPE steps as 2 replays,
    against as many eager steps from the same start, bit-equal
    (``_graph_vs_eager``); K4a and K4b 10 launches for iteration 0, the
    warm-up step and each captured step. Then host ms a step eager and
    graphed and device ms of a replay."""
    from deeplearning4j_torch.data import ArrayIterator

    def build():
        return _transfer_net()[1]

    wrappers = _kernel_wrappers()
    n = 2 * TR_SPE
    eager, graphed, total = _graph_vs_eager(
        build, lambda k: _Repeat(x, y, k), n, TR_SPE,
        f"ResNet-50 fine-tune bf16 batch {TR_B}",
        wrappers=tuple(wrappers.values()), tag="transfer")
    total = dict(zip(wrappers, total))
    want = 10 * (1 + 1 + TR_SPE)
    check(total["K4a"] == total["K4b"] == want, f"transfer graph: launches "
          f"{total}: want K4a, K4b {want} each")
    captured = {k: v * TR_SPE // (2 + TR_SPE) for k, v in total.items()}
    xb, yb = (torch.from_numpy(a).cuda() for a in (x, y))
    window = [(xb, yb, None, None)] * TR_SPE
    times = {}
    with _deterministic():
        rep_dev, rep_ops = device_ms(lambda: graphed._replay(window), reps=2)
        for which, t in (("eager", eager), ("graph", graphed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit(_Repeat(x, y, n),
                  steps_per_execution=1 if which == "eager" else TR_SPE)
            torch.cuda.synchronize()
            times[which] = 1e3 * (time.perf_counter() - t0) / n
    print(f"[transfer] on {where}: host ms a step over {n} steps eager "
          f"{times['eager']:.2f}, graphed {times['graph']:.2f} "
          f"(steps_per_execution={TR_SPE}); one replay ({TR_SPE} steps) "
          f"{rep_dev:.2f} ms on the device in {rep_ops:.0f} operations "
          f"({rep_dev / TR_SPE:.2f} ms a step; idle share "
          f"{1 - rep_dev / TR_SPE / times['graph']:.4f})")
    out = {"captured": captured, "replays": graphed.windows,
           "eager_ms": times["eager"], "graph_ms": times["graph"],
           "replay_dev_ms": rep_dev}
    del eager, graphed
    _release()
    return out


def transfer_grad_gate(x, y):
    """f32 gradients of the unfrozen nodes of the transfer network on a
    batch of TR_GRAD_B, through K4a/K4b against their plain versions
    (``_bn_grad_gate``), TF32 off."""
    _, net = _transfer_net(None)
    keys = set(net.params) - _frozen_keys(net)
    xb, yb = (torch.from_numpy(a[:TR_GRAD_B]).cuda() for a in (x, y))
    _bn_grad_gate(net, net.params, net.state, xb, yb, TR_GRAD_RTOL,
                  f"the transfer network's unfrozen nodes, batch {TR_GRAD_B}",
                  "transfer grad", keys=keys)
    del net
    _release()


def transfer_bn_shapes():
    """K4a and K4b at the unfrozen stage's two BatchNorm shapes, bf16,
    against their plain versions and timed one call at a time and back to
    back beside the library's BatchNorm backward (``bn_shape_times``, CUDA
    events). Returns the rows for the kernels line."""
    gen = torch.Generator(device="cuda")
    for i, (M, C) in enumerate(TR_BN_SHAPES):
        gen.manual_seed(950 + i)
        x, dy = (torch.randn((M, C), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        a = torch.randn((C,), generator=gen, device="cuda").to(torch.bfloat16)
        c1, c2 = (1e-2 * torch.randn((C,), generator=gen, device="cuda")
                  for _ in range(2))
        gamma = (1 + 0.1 * torch.randn((C,), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
        err = _bn_compare(x, dy, a, c1, c2, f"transfer ({M}, {C})")
        _bn_fused_compare(x, dy, gamma, f"transfer ({M}, {C})")
        print(f"[transfer] K4a (both modes) and K4b at ({M}, {C}) bf16: equal "
              f"to their plain versions; composed dx max abs err {err:.3g}")
    shapes = [TR_BN_SHAPES[0]] * 6 + [TR_BN_SHAPES[1]] * 4
    per_shape = bn_shape_times(shapes, device=False)
    print_bn_shapes(shapes, per_shape, "transfer")
    return [{"shape": [M, C], "count": shapes.count((M, C)),
             "k4a_ms": v["k4a"], "k4a_ms_b2b": v["k4a_b2b"],
             "k4a_bound_ms": 4 * M * C / PEAK_BYTES_PER_S * 1e3,
             "k4b_ms": v["k4b"], "k4b_ms_b2b": v["k4b_b2b"],
             "k4b_bound_ms": 6 * M * C / PEAK_BYTES_PER_S * 1e3,
             "library_ms": v["library"], "library_ms_b2b": v["library_b2b"]}
            for (M, C), v in per_shape.items()]


def transfer_vgg_helper(where):
    """DL4J's EditLastLayerOthersFrozen / FitFromFeaturized on the zoo's
    VGG16(seed=0) at 224²: ``TransferLearningBuilder`` frozen through fc2
    (layer 20), a TR_CLASSES-way output (layer 21), Nesterovs; the images
    through ``VGG16Preprocessor`` on the card;
    ``TransferLearningHelper.featurize`` on TR_VGG_BATCHES batches of
    TR_VGG_B (each timed), the unfrozen head fitted on the features, then
    ``merge_back``. Gated: one step of the helper's head on the features
    equals one step of the full frozen network on the raw images within
    TR_VGG_RTOL (bf16 compute); after ``merge_back`` the full network's
    head is the helper's."""
    from deeplearning4j_torch.data import ArrayIterator, VGG16Preprocessor
    from deeplearning4j_torch.models import VGG16
    from deeplearning4j_torch.nn.transfer import (FineTuneConfiguration,
                                                  TransferLearningBuilder,
                                                  TransferLearningHelper)
    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
    from deeplearning4j_torch.train import Trainer

    src = VGG16(num_classes=1000, seed=0,
                input_shape=(TR_SIZE, TR_SIZE, 3)).build()
    src.config.compute_dtype = "bfloat16"
    src.init(seed=0)
    net, _, _ = (TransferLearningBuilder(src)
                 .fine_tune_configuration(FineTuneConfiguration(
                     updater=TR_FTC["updater"]))
                 .set_feature_extractor(20).n_out_replace(21, TR_CLASSES)
                 .build())
    pre = VGG16Preprocessor()
    batches = [_transfer_images(TR_VGG_B, 40 + i)
               for i in range(TR_VGG_BATCHES)]
    raw = [pre.transform(torch.from_numpy(x).cuda()) for x, _ in batches]
    helper = TransferLearningHelper(net)
    feats, feat_ms = [], []
    for xr in raw:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats.append(helper.featurize(xr))
        torch.cuda.synchronize()
        feat_ms.append(1e3 * (time.perf_counter() - t0))
    head = helper.unfrozen_network()
    key = "layer_21"

    def copy(tree):
        return tree_unflatten(tree, [t.detach().clone()
                                     for t in tree_leaves(tree)])

    start = copy(net.params[key])
    # one step each from the same head: the helper's on the features, the
    # full frozen network's on the raw images
    head.params = {"layer_0": copy(start)}
    th = Trainer(head)
    th.fit(ArrayIterator(feats[0].cpu().numpy(), batches[0][1],
                         batch_size=TR_VGG_B))
    full_params = dict(net.params)
    full_params[key] = copy(start)
    net.params = full_params
    tf = Trainer(net)
    tf.step(tf.params, tf.opt_state, tf.state, raw[0], batches[0][1])
    diff = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(
        (t.detach() for t in tree_leaves(th.params["layer_0"])),
        (t.detach() for t in tree_leaves(tf.params[key]))))
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        tree_leaves(tf.params[key]), tree_leaves(start)))
    check(diff <= TR_VGG_RTOL and moved > 0, f"VGG16 helper: the head's step "
          f"on the features differs from the full network's by {diff:.3g}")
    # the head fitted on the features, then merged back
    helper = TransferLearningHelper(net)
    th = Trainer(helper.unfrozen_network())
    xf = torch.cat(feats).cpu().numpy()
    yf = np.concatenate([y for _, y in batches])
    from deeplearning4j_torch.train import CollectScoresListener
    rec = CollectScoresListener()
    th.fit(ArrayIterator(xf, yf, batch_size=TR_VGG_B), epochs=TR_VGG_EPOCHS,
           listeners=[rec])
    merged = helper.merge_back()
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(merged[key]), tree_leaves(th.params["layer_0"]))),
        "VGG16 helper: merge_back did not write the trained head")
    losses = [l for _, l in rec.scores]
    check(all(np.isfinite(losses)), f"VGG16 head losses {losses}")
    print(f"[transfer] VGG16 helper on {where}: frozen through fc2 (layer 20), "
          f"head {TR_CLASSES}-way; featurize of {TR_VGG_B} images (bf16, to "
          f"the (B, 4096) fc2 output) " + ", ".join(f"{v:.2f}" for v in
                                                    feat_ms) + " ms a batch; "
          f"one head step on the features vs one step of the full frozen "
          f"network on the raw images: rel diff {diff:.3g} (gate "
          f"{TR_VGG_RTOL}); head fitted on the features for {TR_VGG_EPOCHS} "
          f"epochs, losses " + " ".join(f"{l:.4f}" for l in losses)
          + "; merge_back wrote it into the full network")
    del src, net, raw, feats
    _release()
    return feat_ms


def phase_transfer():
    """[transfer]: the frozen ResNet-50 fine-tune under early stopping,
    evaluated, saved with its normalizer and served; the same fine-tune
    graphed against eager; its f32 gradient gate; K4a/K4b at its shapes;
    the VGG16 helper path. Kernel launch counts are zeroed before each
    path and read after it. Returns what the kernels line needs."""
    import tempfile

    where = card()
    print(f"[transfer] card: {where}")
    from deeplearning4j_torch.data import ImageScaler

    scaler = ImageScaler()
    x, y = _transfer_images(TR_B * (TR_TRAIN + TR_VAL), 0)
    xf = scaler.transform(x)
    xtr, ytr = xf[:TR_B * TR_TRAIN], y[:TR_B * TR_TRAIN]
    xva, yva = xf[TR_B * TR_TRAIN:], y[TR_B * TR_TRAIN:]
    net, best_p, best_s, fine = transfer_fine_tune(where, xtr, ytr, xva, yva)
    with tempfile.TemporaryDirectory() as tmp:
        transfer_serve(net, best_p, best_s, where, tmp)
    del net, best_p, best_s
    _release()
    graph = transfer_graph(where, xtr[:TR_B], ytr[:TR_B])
    transfer_grad_gate(xtr, ytr)
    shape_rows = transfer_bn_shapes()
    feat_ms = transfer_vgg_helper(where)
    print(f"[transfer] summary on {where}: ResNet-50 fine-tune, batch {TR_B} "
          f"at {TR_SIZE}²: step {fine['step_ms']:.2f} ms eager "
          f"({TR_B / fine['step_ms'] * 1e3:.1f} images/s, MFU "
          f"{fine['flop'] / (fine['step_ms'] * 1e-3) / PEAK_BF16_FLOPS:.4f}), "
          f"{graph['graph_ms']:.2f} ms graphed; device {fine['dev_ms']:.2f} ms "
          f"a step in {fine['dev_ops']:.0f} operations (idle share "
          f"{1 - fine['dev_ms'] / fine['step_ms']:.4f}); peak "
          f"{fine['peak_gib']:.2f} GiB; early stopping "
          f"{fine['reason']}, best epoch {fine['best_epoch']}, scores "
          + " ".join(f"{v:.5f}" for v in fine["scores"])
          + f"; accuracy {fine['accuracy']:.4f}, F1 {fine['f1']:.4f}; VGG16 "
          f"featurize " + ", ".join(f"{v:.2f}" for v in feat_ms) + " ms")
    return {"fine": fine, "graph": graph, "shapes": shape_rows}


# --------------------------------------------------------------- train_api
API_UPDATERS = ("nesterovs", "amsgrad", "adamax", "nadam", "adagrad",
                "adadelta", "noop")
API_NORMS = ("RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
             "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
             "ClipL2PerParamType")
API_RTOL = 1e-6         # card params vs the CPU's, of each leaf's largest
API_STEPS = 3
MOE_B, MOE_T, MOE_D, MOE_H, MOE_E, MOE_BLOCKS = 4, 1024, 512, 8, 8, 2
MOE_VOCAB, MOE_STEPS = 8192, 3
MOE_AUX_RTOL = 1e-5     # loss - (head loss + aux), of the loss


def _api_mlp(updater, norm, device):
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.nn.model import NetConfig, Sequential

    cfg = NetConfig(seed=0, updater=updater, gradient_normalization=norm,
                    gradient_normalization_threshold=0.5)
    return Sequential(cfg, [L.Dense(n_out=64, activation="tanh"),
                            L.Dense(n_out=32, activation="tanh"),
                            L.Output(n_out=10, activation="softmax")], (48,),
                      device=device)


def api_updaters(where):
    """Each new updater (and adam under each gradient normalization), as
    ``build_updater`` makes it for a small MLP: 3 updates on the card and
    on the CPU from the same params and the same gradients (the CPU
    model's, at the CPU's params: the card's own matmuls would round the
    gradients apart); every param within API_RTOL of the CPU's relative to
    its leaf's largest entry."""
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.train import build_updater

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((API_STEPS, 32, 48))
                         .astype(np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (API_STEPS, 32))])
    cases = [({"type": u} if u in ("adadelta", "noop")
              else {"type": u, "learning_rate": 1e-2}, None)
             for u in API_UPDATERS]
    cases += [({"type": "adam", "learning_rate": 1e-2}, n) for n in API_NORMS]
    worst = []
    for upd_cfg, norm in cases:
        cpu = _api_mlp(dict(upd_cfg), norm, "cpu")
        cpu.init(seed=0)
        leaves = [t.requires_grad_() for t in tree_leaves(cpu.params)]
        dev = [t.detach().clone().cuda() for t in leaves]
        tx_cpu, tx_dev = build_updater(cpu), build_updater(cpu)
        s_cpu, s_dev = tx_cpu.init(leaves), tx_dev.init(dev)
        for i in range(API_STEPS):
            loss, _ = cpu.score(cpu.params, {}, x[i], y[i])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                u_cpu, s_cpu = tx_cpu.update(list(grads), s_cpu, leaves)
                u_dev, s_dev = tx_dev.update([g.cuda() for g in grads],
                                             s_dev, dev)
                for p, u in zip(leaves, u_cpu):
                    if u is not None:
                        p.add_(u)
                for p, u in zip(dev, u_dev):
                    if u is not None:
                        p.add_(u)
        err = max(float((a.cpu() - b.detach()).abs().max()
                        / b.detach().abs().max().clamp_min(1e-30))
                  for a, b in zip(dev, leaves))
        worst.append((err, f"{upd_cfg['type']}+{norm}" if norm
                      else upd_cfg["type"]))
        check(err <= API_RTOL, f"{worst[-1][1]}: card params differ from the "
              f"CPU's by {err:.3g} of a leaf's largest entry")
    print(f"[train_api] {len(API_UPDATERS)} updaters and {len(API_NORMS)} "
          f"gradient normalizations, {API_STEPS} updates on {where} against "
          f"the CPU's from the same gradients: max rel diff "
          + ", ".join(f"{n} {e:.2g}" for e, n in worst)
          + f" (gate {API_RTOL})")


def api_pretrain(where):
    """``pretrain_layer`` of an AutoEncoder and of a VAE at 784-wide inputs
    (values in [0, 1]), batch 256, 4 batches an epoch, 5 epochs: the loss
    of the last epoch's last batch below the first epoch's."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.nn.model import NetConfig, Sequential
    from deeplearning4j_torch.train import Trainer

    rng = np.random.default_rng(1)
    protos = rng.random((10, 784)) < 0.2
    labels = rng.integers(0, 10, 1024)
    x = np.where(rng.random((1024, 784)) < 0.05, ~protos[labels],
                 protos[labels]).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[labels]
    out = {}
    for name, layer in (("AutoEncoder", L.AutoEncoder(n_out=256)),
                        ("VAE", L.VAE(n_out=32, encoder_sizes=(256,),
                                      decoder_sizes=(256,),
                                      reconstruction="bernoulli"))):
        m = Sequential(NetConfig(seed=0), [layer, L.Output(n_out=10)], (784,))
        m.init(seed=0)
        t = Trainer(m)
        losses = [t.pretrain_layer(0, ArrayIterator(x, y, batch_size=256),
                                   learning_rate=1e-3) for _ in range(5)]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"pretrain_layer {name}: losses {losses}")
        out[name] = losses
    print(f"[train_api] pretrain_layer on {where}, 784-wide, batch 256: "
          + "; ".join(f"{n} " + " ".join(f"{l:.4f}" for l in ls)
                      for n, ls in out.items()))


def api_solvers_graph_lambda(where):
    """``lbfgs_minimize`` and ``cg_minimize`` (through ``Solver``) on a
    small net: the loss falls. A two-input, two-output Graph fitted on
    MultiDataSet batches: losses finite and falling. A ``Lambda`` layer:
    its forward on the card equals the CPU's."""
    from deeplearning4j_torch.data import MultiDataSet
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.nn import vertices as V
    from deeplearning4j_torch.nn.model import (GraphBuilder, NetConfig,
                                               Sequential)
    from deeplearning4j_torch.train import CollectScoresListener, Trainer
    from deeplearning4j_torch.train.solvers import Solver

    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[(x[:, :2].sum(1) > 0) + 2 * (x[:, 2] > 0)]
    for algo in ("lbfgs", "conjugate_gradient"):
        m = Sequential(NetConfig(seed=0), [L.Dense(n_out=32, activation="tanh"),
                                           L.Output(n_out=4)], (16,))
        m.init(seed=0)
        before = float(m.score(m.params, {}, torch.from_numpy(x).cuda(),
                               torch.from_numpy(y).cuda(),
                               training=False)[0])
        res = Solver(m, algo, max_iterations=20).optimize(x, y)
        check(res.score < before, f"{algo}: {before} -> {res.score}")
        print(f"[train_api] Solver({algo}) on {where}: loss {before:.4f} -> "
              f"{res.score:.4f} in {res.iterations} iterations")
    g = GraphBuilder(NetConfig(seed=0, updater={"type": "adam",
                                                "learning_rate": 1e-2}))
    g.add_input("a", (16,)).add_input("b", (8,))
    g.add_layer("da", L.Dense(n_out=32, activation="tanh"), "a")
    g.add_layer("db", L.Dense(n_out=16, activation="tanh"), "b")
    g.add_vertex("m", V.Merge(), "da", "db")
    g.add_layer("cls", L.Output(n_out=4), "m")
    g.add_layer("reg", L.Output(n_out=2, activation="identity", loss="mse"),
                "m")
    gm = g.set_outputs("cls", "reg").build()
    gm.init(seed=0)
    b = rng.standard_normal((256, 8)).astype(np.float32)
    r = np.stack([x[:, 0] - b[:, 0], b[:, 1]], 1).astype(np.float32)
    batches = [MultiDataSet([x[i:i + 64], b[i:i + 64]],
                            [y[i:i + 64], r[i:i + 64]])
               for i in range(0, 256, 64)]
    rec = CollectScoresListener()
    Trainer(gm).fit(batches, epochs=5, listeners=[rec])
    losses = [l for _, l in rec.scores]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"MultiDataSet Graph fit: losses {losses}")
    print(f"[train_api] a two-input Graph fit on MultiDataSet batches on "
          f"{where}: losses {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps")
    lam = Sequential(NetConfig(seed=0), [
        L.Dense(n_out=8), L.Lambda(fn="torch:tanh"), L.Output(n_out=4)],
        (16,))
    lam.init(seed=0)
    cpu = Sequential.from_json(lam.to_json(), device="cpu")
    cpu.params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in lam.params.items()}
    cpu.state = {}
    diff = float((lam.output(x).cpu() - cpu.output(x)).abs().max())
    check(diff <= 1e-5, f"Lambda layer: card vs CPU {diff:.3g}")
    print(f"[train_api] a Lambda layer (torch:tanh) on {where}: card vs CPU "
          f"max abs diff {diff:.3g}")


API_FIT_BATCHES = 1 + LENET_SPE    # iteration 0 alone, then one window


def api_model_fit(where):
    """``model.fit`` on the LeNet of ``lenet_mnist`` (batch 1024, spe 16),
    its Dense layers drawn by ``lecun_normal``, over the port's
    ``load_mnist``: bit-equal to ``Trainer(model).fit`` from the same
    init, under the deterministic settings; a second ``model.fit`` resumes
    the cached trainer."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.data import datasets
    from deeplearning4j_torch.models import LeNet
    from deeplearning4j_torch.nn.layers import Dense
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    t_phase = time.perf_counter()
    x, y = datasets.load_mnist(train=True)
    n = API_FIT_BATCHES * LENET_B
    reps = -(-n // x.shape[0])
    x, y = np.concatenate([x] * reps)[:n], np.concatenate([y] * reps)[:n]
    synthetic = "mnist" in datasets.synthetic_fallbacks

    def net():
        m = LeNet(num_classes=10, seed=0, input_shape=(28, 28, 1)).build()
        m.layers = [dataclasses.replace(l, weight_init="lecun_normal")
                    if isinstance(l, Dense) else l for l in m.layers]
        m.init(seed=0)
        return m

    def batches(lo, hi):
        return ArrayIterator(x[lo * LENET_B:hi * LENET_B],
                             y[lo * LENET_B:hi * LENET_B],
                             batch_size=LENET_B)

    model, other = net(), net()
    w = model.params["layer_5"]["w"]
    fan_in = w.shape[0]
    std = float(w.float().std())
    check(abs(std / (1 / fan_in) ** 0.5 - 1) < 0.05,
          f"[train_api] lecun_normal Dense std {std:.5f}, fan_in {fan_in}")
    out = {}
    with _deterministic():
        for which, m in (("model.fit", model), ("Trainer.fit", other)):
            c = CollectScoresListener()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "model.fit":
                m.fit(batches(0, API_FIT_BATCHES), listeners=[c],
                      steps_per_execution=LENET_SPE)
                tr = m.trainer()
            else:
                tr = Trainer(m, seed=m.config.seed)
                tr.fit(batches(0, API_FIT_BATCHES), listeners=[c],
                       steps_per_execution=LENET_SPE)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / API_FIT_BATCHES
            c2 = CollectScoresListener()
            if which == "model.fit":
                m.fit(batches(0, 2), listeners=[c2])
                check(m.trainer() is tr, "[train_api] model.fit rebuilt "
                      "its trainer")
            else:
                tr.fit(batches(0, 2), listeners=[c2])
            out[which] = (c.scores, c2.scores, tr, ms)
    (a1, a2, ta, ms_a), (b1, b2, tb, ms_b) = out["model.fit"], \
        out["Trainer.fit"]
    check(len(a1) == API_FIT_BATCHES and a1 == b1 and ta.windows == 1
          and tb.windows == 1, f"[train_api] model.fit losses {a1[:3]}... "
          f"({ta.windows} windows) against Trainer.fit {b1[:3]}... "
          f"({tb.windows})")
    check([i for i, _ in a2] == [API_FIT_BATCHES, API_FIT_BATCHES + 1]
          and a2 == b2 and ta.iteration == API_FIT_BATCHES + 2,
          f"[train_api] the second model.fit reported {a2} (Trainer {b2}), "
          f"iteration {ta.iteration}")
    print(f"[train_api] model.fit: LeNet (lenet_mnist, batch {LENET_B}, "
          f"spe {LENET_SPE}, Dense drawn by lecun_normal: std {std:.5f} "
          f"against 1/sqrt({fan_in}) = {(1 / fan_in) ** 0.5:.5f}) over "
          f"load_mnist ({'its synthetic replica' if synthetic else 'IDX files'}"
          f", {n} rows): {API_FIT_BATCHES} losses bit-equal to Trainer.fit "
          f"({a1[0][1]:.6f} -> {a1[-1][1]:.6f}), {ta.windows} captured "
          f"window each, {ms_a:.3f} against {ms_b:.3f} ms a step with the "
          f"capture; the second model.fit resumed at iteration "
          f"{a2[0][0]}, bit-equal; {time.perf_counter() - t_phase:.1f} s; "
          f"{where}")
    del model, other, out
    _release()


def api_inits(where):
    """Every registered weight init drawn once on the card at 1024 x 1024
    (fan_in = fan_out = 1024): the mean within 5 standard errors of 0 and
    the variance within 5 standard errors of the reference's formula, a
    uniform's draws inside its bound; zero, zeros, ones and identity
    exact."""
    import math

    from deeplearning4j_torch.ops import initializers

    t0 = time.perf_counter()
    shape, f = (1024, 1024), 1024.0
    var = {"normal": 1 / f, "xavier": 2 / (2 * f), "xavier_fan_in": 1 / f,
           "xavier_legacy": 1 / (2 * f), "relu": 2 / f, "lecun_normal": 1 / f}
    bound = {"uniform": math.sqrt(3 / f),
             "xavier_uniform": math.sqrt(6 / (2 * f)),
             "relu_uniform": math.sqrt(6 / f),
             "lecun_uniform": math.sqrt(3 / f),
             "sigmoid_uniform": 4 * math.sqrt(6 / (2 * f))}
    for mode in ("fan_in", "fan_out", "fan_avg"):
        var[f"var_scaling_{mode}_normal"] = 1 / f
        bound[f"var_scaling_{mode}_uniform"] = math.sqrt(3 / f)
    exact = {"zero": torch.zeros, "zeros": torch.zeros, "ones": torch.ones,
             "identity": lambda s, **kw: torch.eye(s[0], **kw)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = shape[0] * shape[1]
    rows = []
    for name in initializers.names():
        w = initializers.init_param(gen, name, shape, device="cuda")
        check(w.is_cuda and w.shape == shape, f"[train_api] init {name}")
        if name in exact:
            want = exact[name](shape, dtype=torch.float32, device="cuda")
            check(torch.equal(w, want), f"[train_api] init {name} not exact")
            continue
        w = w.double()
        if name in bound:
            a = bound[name]
            v, kurt = a * a / 3, 0.8
            check(float(w.abs().max()) <= a, f"[train_api] init {name} past "
                  f"its bound {a}")
        else:
            v, kurt = var[name], 2.0
        mean, got = float(w.mean()), float(w.var())
        check(abs(mean) < 5 * math.sqrt(v / n)
              and abs(got - v) < 5 * math.sqrt(kurt / n) * v,
              f"[train_api] init {name}: mean {mean:.3g}, variance "
              f"{got:.6g} against {v:.6g}")
        rows.append(f"{name} {got / v:.4f}")
    print(f"[train_api] weight inits on the card, 1024 x 1024: every one of "
          f"{len(initializers.names())} registered schemes within 5 sigma "
          f"of the reference's formula (variance / formula: "
          + ", ".join(rows) + f"; zero, zeros, ones, identity exact); "
          f"{time.perf_counter() - t0:.2f} s; {where}")


def api_moe(where):
    """An LM of MOE_BLOCKS MoETransformerBlocks (d_model MOE_D, MOE_H heads
    of 64, MOE_E experts, top-2, causal, flash=True) at T MOE_T, batch
    MOE_B, bf16 compute, adam, MOE_STEPS fit steps. Gated: K1, K2 and K3
    launch once each per block per step; losses finite; the aux loss
    finite, positive and in the loss (the loss less the head's loss is the
    blocks' aux losses, within MOE_AUX_RTOL of the loss). Returns the
    launches."""
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.nn.model import NetConfig, Sequential
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    blocks = [L.MoETransformerBlock(num_heads=MOE_H, num_experts=MOE_E,
                                    top_k=2, causal=True, flash=True)
              for _ in range(MOE_BLOCKS)]
    m = Sequential(NetConfig(seed=0, compute_dtype="bfloat16",
                             updater={"type": "adam", "learning_rate": 1e-3}),
                   [L.EmbeddingSequence(n_in=MOE_VOCAB, n_out=MOE_D), *blocks,
                    L.RnnOutput(n_out=MOE_VOCAB)], (MOE_T,))
    m.init(seed=0)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, MOE_VOCAB, (MOE_B, MOE_T)).astype(np.int32)
    lab = rng.integers(0, MOE_VOCAB, (MOE_B, MOE_T)).astype(np.int64)
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    rec = CollectScoresListener()
    trainer = Trainer(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(_Repeat(ids, lab, MOE_STEPS), listeners=[rec])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / MOE_STEPS
    counts = {k: w.launches for k, w in wrappers.items()}
    losses = [l for _, l in rec.scores]
    check(all(np.isfinite(losses)), f"MoE LM losses {losses}")
    check(all(counts[k] == MOE_BLOCKS * MOE_STEPS for k in ("K1", "K2", "K3"))
          and counts["K4a"] == counts["K4b"] == 0,
          f"MoE LM launches {counts}: want K1, K2, K3 {MOE_BLOCKS} each a "
          f"step over {MOE_STEPS} steps")
    xb = torch.from_numpy(ids).cuda()
    yb = torch.from_numpy(lab).cuda()
    with torch.no_grad():
        loss, st = m.score(trainer.params, trainer.state, xb, yb,
                           training=True)
        aux = sum(float(s["aux_loss"]) for s in st.values()
                  if isinstance(s, dict) and "aux_loss" in s)
        feats, _ = m.forward(trainer.params, trainer.state, xb,
                             training=True, up_to=len(m.layers) - 1)
        head = m.layers[-1].score(trainer.params[f"layer_{len(m.layers) - 1}"],
                                  {}, feats, yb)
    gap = abs(float(loss) - float(head) - aux) / abs(float(loss))
    check(np.isfinite(aux) and aux > 0 and gap <= MOE_AUX_RTOL,
          f"MoE aux loss {aux}, loss {float(loss)}, head {float(head)}")
    print(f"[train_api] MoE LM on {where}: {MOE_BLOCKS} x "
          f"MoETransformerBlock(d {MOE_D}, {MOE_H} heads, {MOE_E} experts, "
          f"top-2, flash), T {MOE_T}, batch {MOE_B}, bf16: losses "
          + " ".join(f"{l:.4f}" for l in losses) + f"; {step_ms:.1f} ms a "
          f"step; aux loss {aux:.6f} (loss {float(loss):.6f} = head "
          f"{float(head):.6f} + aux, rel gap {gap:.2g}); launches K1 "
          f"{counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}")
    del m, trainer
    _release()
    return counts


def phase_train_api():
    """[train_api]: smoke runs of the trainer surface this slice adds, at
    small sizes, on the card. Returns the MoE LM's launches."""
    where = card()
    api_updaters(where)
    api_pretrain(where)
    api_solvers_graph_lambda(where)
    api_model_fit(where)
    api_inits(where)
    return api_moe(where)


# --- [fleet]: three full-width CausalLMs paged under one weight budget ---
FLEET_NAMES = ("alpha", "beta", "gamma")     # seeds 0, 1, 2
FLEET_DEVICE = "cuda"
FLEET_SECONDS = 10.0        # the closed-loop window
# predict prompt tokens (gold and free): the model's T, as
# bench.py:_bench_fleet predicts at its model's whole input length
FLEET_T = 1024
# the HTTP predict's prompt, cut: its JSON answer carries FLEET_VOCAB
# floats a token (the phase prints its bytes)
FLEET_HTTP_T = 16
FLEET_PROMPTS = 4
FLEET_BUCKETS = (1, 2, 4)
FLEET_VOCAB = 32000
FLEET_GEN_PROMPT = 6        # gamma's prompt, as bench.py:_bench_fleet
FLEET_GEN_TOKENS = 8
FLEET_BUDGET_MODELS = 2.2   # bench.py:712-715: at most two resident
FLEET_BREAKER = dict(breaker_failures=2, breaker_reset_s=3.0)
FLEET_WATCHDOG_S = 4.0
FLEET_CYCLES = 3            # quiet page cycles for the raw memory gate
FLEET_REST_N = 30           # gold predicts at rest and during page-ins
FLEET_PROF_N = 8            # of them again under torch.profiler, each way


def _fleet_lm(seed):
    """``_lm(flash=True)``'s model with its own seed: 12 layers, d_model
    2048, 32 heads, vocab 32000, T 1024, bf16 compute."""
    from deeplearning4j_torch.models import CausalLM

    model = CausalLM(seed=seed, input_shape=(1024,), num_layers=12,
                     d_model=2048, num_heads=32, vocab=32000, flash=True,
                     device=FLEET_DEVICE).build()
    model.config.compute_dtype = "bfloat16"
    model.init(seed=seed)
    return model


def _fleet_gen_opts():
    """The [generate] phase's measured batcher options."""
    return dict(kv="paged", slots=GEN_SLOTS, capacity=GEN_CAPACITY,
                block_size=GEN_BLOCK, prefill_chunk=GEN_CHUNK,
                prefix_cache=True, seed=0)


def _fleet_mem():
    """The caching allocator's counters on the card."""
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "peak_allocated": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved()}


def _fleet_link_rates():
    """Host-link rates (bytes/s) of one pinned 1 GiB copy each way, by CUDA
    events, median of 5."""
    n = 1 << 30
    h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(n, dtype=torch.uint8, device="cuda")
    h2d = time_ms(lambda: d.copy_(h, non_blocking=True), reps=5, warmup=1)
    d2h = time_ms(lambda: h.copy_(d, non_blocking=True), reps=5, warmup=1)
    del h, d
    return n / (h2d / 1e3), n / (d2h / 1e3)


def _fleet_refs(model, prompts):
    """Each prompt's direct forward at each bucket, as the engine runs it
    (the prompt in one row of a zero-padded bucket batch), row by row
    position: ``{(j, bucket): [distinct answers]}`` and whether an answer
    was the same at every row position."""
    from deeplearning4j_torch.serve.engine import _to_numpy

    refs, same = {}, True
    with torch.inference_mode():
        for b in FLEET_BUCKETS:
            for j, p in enumerate(prompts):
                rows = []
                for r in range(b):
                    x = np.zeros((b,) + p.shape[1:], np.int32)
                    x[r] = p[0]
                    y = _to_numpy(model.forward(
                        model.params, model.state,
                        torch.from_numpy(x).to(model.device),
                        training=False)[0][r])
                    if not any(np.array_equal(y, z) for z in rows):
                        rows.append(y)
                same = same and len(rows) == 1
                refs[(j, b)] = rows
    return refs, same


def _fleet_gen_refs(model, prompt):
    """gamma's greedy tokens from a ContinuousBatcher with the fleet's
    options run on its own (the gate), and ``generate``'s direct greedy
    tokens held to them under the [generate] phase's gap rule. Returns the
    tokens and the batcher's cast bytes."""
    from deeplearning4j_torch.nn.generation import generate
    from deeplearning4j_torch.serve import ContinuousBatcher

    cb = ContinuousBatcher(model, **_fleet_gen_opts())
    try:
        want = cb.generate(prompt, FLEET_GEN_TOKENS, temperature=0.0)
        cast = cb.cast_bytes()
    finally:
        cb.shutdown()
        cb.release_device()
    direct = generate(model, prompt[None], FLEET_GEN_TOKENS,
                      temperature=0.0)[0]
    lp = _teacher_logp(model, np.concatenate([prompt, want[:-1]]))
    met = _same_tokens(direct, want, lp, len(prompt),
                       "[fleet] generate() vs the batcher",
                       GEN_GAP_TOL_BF16)
    return [int(t) for t in want], cast, met


def _fleet_knn(rng):
    """The knn tenant's ``BruteForceKNN`` on the card over 512 x 16 uniform
    points, its query and the 5 nearest by a numpy scan
    (``bench.py:738-742``)."""
    from deeplearning4j_torch.knn import BruteForceKNN

    points = rng.rand(512, 16).astype(np.float32)
    query = rng.rand(16).astype(np.float32)
    want = np.argsort(np.linalg.norm(points - query, axis=1))[:5].tolist()
    return {"index": BruteForceKNN(points, device=FLEET_DEVICE),
            "query": query, "want": want}


def fleet_build(where):
    """The three models, their references, and the fleet (budget 2.2 x one
    model's weight bytes) holding pinned host copies; each model's device
    params are dropped once the fleet holds them."""
    from deeplearning4j_torch.fleet import FleetRegistry
    from deeplearning4j_torch.ops.updaters import tree_leaves

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, FLEET_VOCAB, (1, FLEET_T)).astype(np.int32)
               for _ in range(FLEET_PROMPTS)]
    http_prompt = rng.randint(0, FLEET_VOCAB, (1, FLEET_HTTP_T)).astype(
        np.int32)
    gen_prompt = rng.randint(0, FLEET_VOCAB, FLEET_GEN_PROMPT).astype(
        np.int32)
    knn = _fleet_knn(rng)
    fleet, refs, same_rows = None, {}, True
    gen_want = cast_bytes = gen_met = None
    t_alloc = t_fill = 0.0
    for seed, name in enumerate(FLEET_NAMES):
        t0 = time.perf_counter()
        m = _fleet_lm(seed)
        n_params = m.param_count()
        check(n_params == 737_504_512, f"{name} has {n_params} params")
        if name != "gamma":
            refs[name], same = _fleet_refs(m, prompts)
            same_rows = same_rows and same
        else:
            gen_want, cast_bytes, gen_met = _fleet_gen_refs(m, gen_prompt)
        if name == "alpha":
            refs["alpha_http"], _ = _fleet_refs(m, [http_prompt])
        if fleet is None:
            wb = sum(t.numel() * t.element_size() for t in
                     tree_leaves((m.params, m.state)))
            fleet = FleetRegistry(
                hbm_budget_bytes=int(FLEET_BUDGET_MODELS * wb),
                watchdog_s=FLEET_WATCHDOG_S, device=FLEET_DEVICE,
                **FLEET_BREAKER)
        entry = fleet.add(name, m, input_dtype=np.int32,
                          engine_opts={"batch_buckets": FLEET_BUCKETS,
                                       "queue_limit": 64},
                          gen_opts=_fleet_gen_opts()
                          if name == "gamma" else None)
        t_alloc += entry.host_alloc_s
        t_fill += entry.host_fill_s
        m.params, m.state = None, {}
        gc.collect()
        print(f"[fleet] {name}: {n_params} params (seed {seed}), "
              f"{entry.weight_bytes} weight bytes, references and host copy "
              f"in {time.perf_counter() - t0:.2f} s")
    print(f"[fleet] pinned host copies of {len(FLEET_NAMES)} models "
          f"({sum(fleet.get(n).weight_bytes for n in FLEET_NAMES)} bytes): "
          f"allocation {t_alloc:.3f} s, fill {t_fill:.3f} s on {where}")
    print(f"[fleet] direct answers the same at every row position of a "
          f"bucket: {same_rows}; gamma's batcher tokens {gen_want}, "
          f"generate() equal before a near-tie: {gen_met[0]} of "
          f"{FLEET_GEN_TOKENS} ({gen_met[1]} near-ties met, gap <= "
          f"{GEN_GAP_TOL_BF16})")
    return {"fleet": fleet, "prompts": prompts, "http_prompt": http_prompt,
            "gen_prompt": gen_prompt, "gen_want": gen_want, "refs": refs,
            "cast_bytes": cast_bytes, "knn": knn}


def _fleet_bucket(ctx):
    return next(st["args"]["bucket"] for st in ctx.stages
                if st["name"] == "device")


def fleet_predict(st, name, j, tenant, rt, stages=None):
    """One traced predict; returns (latency s, generation, bucket, bit-equal
    to the direct forward at that bucket). Appends the request's stage
    durations ({name: ms}) to ``stages`` when given."""
    ctx = rt.begin("predict", model=name, tenant=tenant)
    t0 = time.perf_counter()
    try:
        res = st["fleet"].predict(name, st["prompts"][j], tenant=tenant,
                                  ctx=ctx)
    except BaseException as e:
        ctx.finish(error=getattr(e, "cause", "internal"))
        raise
    dt = time.perf_counter() - t0
    ctx.finish()
    if stages is not None:
        stages.append({s["name"]: s["dur_ms"] for s in ctx.stages})
    bucket = _fleet_bucket(ctx)
    ok = any(np.array_equal(res.output[0], r)
             for r in st["refs"][name][(j, bucket)])
    return dt, res.generation, bucket, ok


def fleet_window(st, where):
    """FLEET_SECONDS of closed-loop traffic, one thread a tenant: gold
    predicts on alpha and beta, standard greedy generates on gamma, free
    predicts on alpha at 20/s offered against its 2/s quota, knn queries
    the tenant's BruteForceKNN through admission at 200/s."""
    from deeplearning4j_torch.fleet import QuotaError
    from deeplearning4j_torch.obs import reqtrace
    from deeplearning4j_torch.serve import ServeError

    fleet, rt = st["fleet"], reqtrace.ACTIVE
    fleet.tenants.register("gold", rate_per_s=500, slo="gold")
    fleet.tenants.register("standard", rate_per_s=500, slo="standard")
    fleet.tenants.register("free", rate_per_s=2.0, burst=2.0, slo="batch")
    fleet.tenants.register("knn", rate_per_s=200, slo="standard")
    lock = threading.Lock()
    rec = {"gold": [], "free": [], "gen": [], "wrong": [], "errors": [],
           "quota": [], "knn": [], "knn_quota": [],
           "gens": {n: set() for n in FLEET_NAMES}}
    stop_at = [0.0]

    def note(key, item):
        with lock:
            rec[key].append(item)

    def predictor(tenant, pick, pause):
        r = np.random.RandomState(10 if tenant == "gold" else 11)
        while time.perf_counter() < stop_at[0]:
            name, j = pick(r), int(r.randint(FLEET_PROMPTS))
            try:
                dt, gen, bucket, ok = fleet_predict(st, name, j, tenant, rt)
            except QuotaError as e:
                note("quota", e.retry_after_s)
            except ServeError as e:
                note("errors", f"{tenant} {name}: {e.cause}: {e}")
            else:
                note(tenant, (dt, name, bucket))
                with lock:
                    rec["gens"][name].add(gen)
                if not ok:
                    note("wrong", f"{tenant} {name} prompt {j} bucket "
                         f"{bucket} generation {gen}")
            time.sleep(pause)

    def generator():
        while time.perf_counter() < stop_at[0]:
            t0 = time.perf_counter()
            stamps = []
            try:
                h = fleet.submit_generate("gamma", st["gen_prompt"],
                                          FLEET_GEN_TOKENS, tenant="standard",
                                          temperature=0.0)
                toks = []
                for tok in h.stream():
                    stamps.append(time.perf_counter())
                    toks.append(int(tok))
            except ServeError as e:
                note("errors", f"standard gamma: {e.cause}: {e}")
                continue
            note("gen", (stamps[0] - t0, stamps))
            if toks != st["gen_want"]:
                note("wrong", f"gamma tokens {toks}, want {st['gen_want']}")

    def knn_client():
        # the tenant's queries go through the same admission as the models'
        # (bench.py:811-827): shed at its quota, else answered by the index
        knn = st["knn"]
        while time.perf_counter() < stop_at[0]:
            try:
                fleet.tenants.admit("knn", model="knn")
            except QuotaError as e:
                note("knn_quota", e.retry_after_s)
                time.sleep(0.01)
                continue
            t0 = time.perf_counter()
            idx, _ = knn["index"].search(knn["query"], 5)
            note("knn", time.perf_counter() - t0)
            if idx.tolist() != knn["want"]:
                note("wrong", f"knn {idx.tolist()}, want {knn['want']}")

    workers = [threading.Thread(target=predictor, args=(
                   "gold", lambda r: ("alpha", "beta")[r.randint(2)], 0.0)),
               threading.Thread(target=predictor, args=(
                   "free", lambda r: "alpha", 0.05)),
               threading.Thread(target=generator),
               threading.Thread(target=knn_client)]
    pager0 = dict(fleet.pager.stats())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stop_at[0] = time.perf_counter() + FLEET_SECONDS
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(FLEET_SECONDS + 300)
    wall = time.perf_counter() - t0
    check(not any(w.is_alive() for w in workers), "[fleet] clients hung")
    mem = _fleet_mem()
    pager = fleet.pager.stats()
    page_ins = pager["page_ins"] - pager0["page_ins"]
    page_outs = pager["page_outs"] - pager0["page_outs"]
    check(not rec["errors"], "[fleet] errors: " + "; ".join(rec["errors"][:5]))
    check(not rec["wrong"], f"[fleet] wrong_responses "
          f"{len(rec['wrong'])}: " + "; ".join(rec["wrong"][:5]))
    check(page_ins >= 3 and page_outs >= 2, f"[fleet] {page_ins} page-ins "
          f"and {page_outs} evictions in the window")
    check(rec["quota"], "[fleet] the free tenant was never shed")
    check(rec["gold"] and rec["gen"] and rec["knn"],
          "[fleet] a tenant got no answer")
    gold_ms = [1e3 * d for d, _, _ in rec["gold"]]
    knn_ms = [1e3 * d for d in rec["knn"]]
    ttft = [1e3 * t for t, _ in rec["gen"]]
    tps = [(len(s) - 1) / (s[-1] - s[0]) for _, s in rec["gen"]
           if len(s) > 1 and s[-1] > s[0]]
    budget = fleet.pager.budget_bytes
    print(f"[fleet] window {wall:.2f} s on {where}: gold {len(rec['gold'])} "
          f"predicts (p50 {_pct(gold_ms, 50):.2f} ms, p99 "
          f"{_pct(gold_ms, 99):.2f} ms, buckets "
          f"{sorted(collections.Counter(b for _, _, b in rec['gold']).items())}), "
          f"free {len(rec['free'])} admitted and {len(rec['quota'])} shed "
          f"(QuotaError, retry_after_s {min(rec['quota']):.3f}-"
          f"{max(rec['quota']):.3f}), standard {len(rec['gen'])} generations "
          f"of {FLEET_GEN_TOKENS} tokens, knn {len(knn_ms)} queries (p50 "
          f"{_pct(knn_ms, 50):.3f} ms, p99 {_pct(knn_ms, 99):.3f} ms, "
          f"{len(rec['knn_quota'])} shed at 200/s); wrong_responses 0; "
          f"page-ins {page_ins}, page-outs {page_outs}")
    print(f"[fleet] gamma on {where}: time to first token p50 "
          f"{_pct(ttft, 50):.2f} ms p99 {_pct(ttft, 99):.2f} ms (page-in "
          f"waits included); decode tokens/s median "
          f"{statistics.median(tps) if tps else float('nan'):.1f}")
    print(f"[fleet] memory on {where}: peak allocated {mem['peak_allocated']}"
          f" B, peak reserved {mem['peak_reserved']} B, against the weight "
          f"budget {budget} B (weights only; KV pools, activations and casts "
          f"outside it)")
    return {"page_ins": page_ins, "page_outs": page_outs, "gens": rec["gens"],
            "gold_ms": gold_ms, "ttft_ms": ttft, "tps": tps, "mem": mem,
            "knn_ms": knn_ms}


def fleet_generations(st, seen):
    """Each model's generations never repeat: its first page-in is 1, each
    later page-in one more than the page-out before it, and a page-out
    holds its page-in's generation unless one was published while
    resident, when (and only when) it copies the weights back. Every
    answer's generation is one that a page-in served."""
    for name in FLEET_NAMES:
        log = st["fleet"].get(name).page_log
        # a full log has lost its oldest records: start at its first
        prev_out = 0 if len(log) < log.maxlen else None
        last_in, ins = None, []
        for e in log:
            if e["kind"] == "page_in":
                check(prev_out is None or e["generation"] == prev_out + 1,
                      f"[fleet] {name} paged in as {e['generation']} after "
                      f"page-out {prev_out}")
                last_in = e["generation"]
                ins.append(last_in)
            elif last_in is not None:
                check(e["generation"] >= last_in
                      and e["copied"] == (e["generation"] != last_in),
                      f"[fleet] {name} page-out {e['generation']} (copied "
                      f"{e['copied']}) after page-in {last_in}")
                prev_out = e["generation"]
        check(seen.get(name, set()) <= set(ins), f"[fleet] {name} answered "
              f"from generations {sorted(seen.get(name, ()))} outside its "
              f"page-ins {ins}")
    print("[fleet] generations by page-in: " + "; ".join(
        f"{n} {[e['generation'] for e in st['fleet'].get(n).page_log if e['kind'] == 'page_in']}"
        for n in FLEET_NAMES))


def fleet_published_cycles(st):
    """Each model published again while resident (its own weights, a new
    generation), then paged out and back in: the page-out copies that
    generation back to the host copy (the reference's guarantee), and the
    next page-in serves it under the following generation, bit-equal."""
    from deeplearning4j_torch.obs import reqtrace

    fleet = st["fleet"]
    for name in FLEET_NAMES:
        fleet.ensure(name)
        e = fleet.get(name)
        cur = e.engine().registry.current()
        gen = fleet.publish(name, cur.params, cur.state,
                            version=f"{cur.version}-again")
        del cur
        fleet.pager.drop(e)
        rec = e.page_log[-1]
        check(rec["kind"] == "page_out" and rec["copied"]
              and rec["generation"] == gen, f"[fleet] page-out of {name} "
              f"after a publish (generation {gen}): {rec}")
        fleet.ensure(name)
        check(e.page_log[-1]["generation"] == gen + 1, f"[fleet] {name} "
              f"paged in as {e.page_log[-1]['generation']} after publishing "
              f"{gen}")
        if name != "gamma":
            _, got, _, ok = fleet_predict(st, name, 0, "gold",
                                          reqtrace.ACTIVE)
            check(ok and got == gen + 1, f"[fleet] {name} after its "
                  f"published page cycle: generation {got}, equal {ok}")
        fleet.pager.drop(e)


def fleet_transfers(st, where, link):
    """Page-in and page-out times per cycle from the entries' page logs,
    their rates, the host-link bound; the memory gates on every page-out
    (during traffic: the allocator's freed bytes across the drop, which
    other threads' allocations cannot mask; then FLEET_CYCLES quiet cycles:
    memory_allocated itself). A page-out copies the weights back only after
    a publish while resident: fleet_published_cycles makes those."""
    fleet = st["fleet"]
    freed = []
    for name in FLEET_NAMES:
        e = fleet.get(name)
        for rec in e.page_log:
            if rec["kind"] == "page_out":
                freed.append(rec["freed"] / rec["bytes"])
                check(rec["freed"] >= rec["bytes"], f"[fleet] page-out of "
                      f"{name} freed {rec['freed']} B < {rec['bytes']} B")
    # quiet cycles: nothing else runs, so memory_allocated must fall by the
    # victim's weight bytes at least
    falls = []
    for k in range(FLEET_CYCLES):
        for name in FLEET_NAMES:
            fleet.ensure(name)
            e = fleet.get(name)
            a0 = _fleet_mem()["allocated"]
            fleet.pager.drop(e)
            fall = a0 - _fleet_mem()["allocated"]
            falls.append(fall)
            check(fall >= e.weight_bytes, f"[fleet] quiet page-out of {name}"
                  f": memory_allocated fell {fall} B < {e.weight_bytes} B")
    logs = [r for n in FLEET_NAMES for r in fleet.get(n).page_log]
    ins = [r for r in logs if r["kind"] == "page_in"]
    outs = [r for r in logs if r["kind"] == "page_out"]
    copies = [r for r in outs if r["copied"]]
    wb = fleet.get("alpha").weight_bytes
    in_ms = [1e3 * r["seconds"] for r in ins]
    # a page-in that overlaps another shares the page-in stream with it
    spans = [(r["start"], r["start"] + r["seconds"]) for r in ins]
    shared = [any(a < e1 and a1 < e for a1, e1 in spans if (a1, e1) != (a, e))
              for a, e in spans]
    alone_ms = [t for t, o in zip(in_ms, shared) if not o]
    shared_ms = [t for t, o in zip(in_ms, shared) if o]
    issue_ms = [1e3 * r["issue_seconds"] for r in ins]
    copy_ms = [1e3 * r["seconds"] for r in copies]
    out_ms = [1e3 * r["total_seconds"] for r in outs if not r["copied"]]
    reserved = [r["reserved"] for r in outs]
    h2d, d2h = link
    print(f"[fleet] transfers on {where}: {len(ins)} page-ins, median "
          f"{_pct(in_ms, 50):.2f} ms (p10 {_pct(in_ms, 10):.2f}, p90 "
          f"{_pct(in_ms, 90):.2f}), {wb / (_pct(in_ms, 50) / 1e3) / 1e9:.2f} "
          f"GB/s ({len(alone_ms)} alone, median "
          f"{_pct(alone_ms, 50) if alone_ms else float('nan'):.2f} ms; "
          f"{len(shared_ms)} overlapping another, median "
          f"{_pct(shared_ms, 50) if shared_ms else float('nan'):.2f} ms; "
          f"the host issued the copies in a median {_pct(issue_ms, 50):.2f} "
          f"ms, p90 {_pct(issue_ms, 90):.2f}); {len(out_ms)} page-outs with nothing published, no copy: "
          f"median {_pct(out_ms, 50):.2f} ms in all (p10 "
          f"{_pct(out_ms, 10):.2f}, p90 {_pct(out_ms, 90):.2f}; drain and "
          f"drop); {len(copies)} copies back after a publish: median "
          f"{_pct(copy_ms, 50):.2f} ms ({min(copy_ms):.2f}-"
          f"{max(copy_ms):.2f}), {wb / (_pct(copy_ms, 50) / 1e3) / 1e9:.2f} "
          f"GB/s; bound {wb / h2d * 1e3:.2f} ms in / {wb / d2h * 1e3:.2f} ms "
          f"out at the pinned 1 GiB rates {h2d / 1e9:.2f} GB/s "
          f"host-to-device, {d2h / 1e9:.2f} GB/s device-to-host")
    print(f"[fleet] memory across page-outs on {where}: freed at each "
          f"page-out under traffic {min(freed):.4f}-{max(freed):.4f} x the "
          f"weights; quiet falls {min(falls)}-{max(falls)} B (weights {wb} "
          f"B); reserved "
          f"{min(reserved)}-{max(reserved)} B over {len(reserved)} "
          f"page-outs")
    return {"page_in_ms": _pct(in_ms, 50), "page_out_ms": _pct(out_ms, 50)}


def _fleet_pager_thread(fleet, errors, publish=False):
    """A thread that pages beta and gamma in and out until its event is
    set; with ``publish``, each residency publishes the model's weights
    again, so each page-out copies them back to the host. Its failures
    land in ``errors``. Returns (thread, event)."""
    done = threading.Event()

    def pager():
        try:
            while not done.is_set():
                for name in ("beta", "gamma"):
                    fleet.ensure(name)
                    if publish:
                        cur = fleet.get(name).engine().registry.current()
                        fleet.publish(name, cur.params, cur.state)
                        del cur
                    fleet.pager.drop(fleet.get(name))
        except Exception as e:  # reported by the caller, fails the phase
            errors.append(f"{type(e).__name__}: {e}")

    return threading.Thread(target=pager), done


def _fleet_alpha_run(st, n, paging, stages=None):
    """``n`` gold predicts on a resident alpha, each bit-equal, while beta
    and gamma page in and out when ``paging`` (``"publish"``: each
    residency publishes again, so each page-out copies back); their
    latencies in ms."""
    from deeplearning4j_torch.obs import reqtrace

    fleet, rt = st["fleet"], reqtrace.ACTIVE
    fleet.ensure("alpha")
    errors, out = [], []
    th, done = _fleet_pager_thread(fleet, errors, paging == "publish")
    if paging:
        th.start()
    try:
        for i in range(n):
            dt, _, _, ok = fleet_predict(st, "alpha", i % FLEET_PROMPTS,
                                         "gold", rt, stages)
            check(ok, "[fleet] a resident answer differs "
                  + ("during page-ins" if paging else "at rest"))
            out.append(1e3 * dt)
    finally:
        done.set()
        if paging:
            th.join(300)
    check(not errors and not th.is_alive(), f"[fleet] pager thread: {errors}")
    return out


def _trace_summary(path):
    """What a torch.profiler chrome trace holds, as numbers: its span; per
    stream the device busy time (kernels, copies, sets) and the copies'
    bytes and time each way; the default stream (the one K1 ran on) split
    into kernels and copies with its top kernels; and the host's CUDA
    runtime calls that can wait (count, total and longest ms)."""
    with open(path) as f:
        evs = [e for e in json.load(f).get("traceEvents", [])
               if e.get("ph") == "X"]
    dev = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy",
                                              "gpu_memset")]
    if not dev:
        return None
    t0 = min(e["ts"] for e in evs)
    span = max(e["ts"] + e.get("dur", 0) for e in evs) - t0
    k1 = [e for e in dev if e.get("cat") == "kernel" and "flash" in e["name"]]
    default = (k1[0].get("args", {}).get("stream") if k1 else None)
    streams = {}
    for e in dev:
        sid = e.get("args", {}).get("stream")
        row = streams.setdefault(sid, collections.Counter())
        row["busy_ms"] += e.get("dur", 0) / 1e3
        if e["cat"] == "gpu_memcpy":
            way = ("HtoD" if "HtoD" in e["name"] else
                   "DtoH" if "DtoH" in e["name"] else "DtoD")
            row[way + "_ms"] += e.get("dur", 0) / 1e3
            row[way + "_bytes"] += e.get("args", {}).get("bytes", 0)
            row[way + "_n"] += 1
            if sid == default and way == "DtoH":
                row["DtoH_max_ms"] = max(row["DtoH_max_ms"],
                                         e.get("dur", 0) / 1e3)
        elif e["cat"] == "kernel":
            row["kernel_ms"] += e.get("dur", 0) / 1e3
            row["kernels"] += 1
        else:
            row["memset_ms"] += e.get("dur", 0) / 1e3
    top = collections.Counter()
    for e in dev:
        if e["cat"] == "kernel" and e.get("args", {}).get("stream") == default:
            top[e["name"][:48]] += e.get("dur", 0) / 1e3
    waits = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(
                k in e["name"] for k in ("Malloc", "Free", "Synchronize",
                                         "Memcpy", "HostAlloc", "Wait")):
            w = waits.setdefault(e["name"], [0, 0.0, 0.0])
            w[0] += 1
            w[1] += e.get("dur", 0) / 1e3
            w[2] = max(w[2], e.get("dur", 0) / 1e3)
    return {"span_ms": span / 1e3, "default": default, "streams": streams,
            "top": top.most_common(4), "waits": waits}


def _print_trace_summary(tag, where, sm, lat):
    if sm is None:
        print(f"[fleet] {tag} on {where}: profiler recorded no device "
              f"events; not measured")
        return
    d = sm["streams"].get(sm["default"], collections.Counter())

    def copies(row):
        return ", ".join(
            f"{w} {row[w + '_n']} in {row[w + '_ms']:.2f} ms "
            f"({row[w + '_bytes'] / 1e9:.3f} GB)"
            for w in ("HtoD", "DtoH", "DtoD") if row[w + "_n"])
    print(f"[fleet] {tag} on {where} (torch.profiler, {len(lat)} predicts, "
          f"p50 {_pct(lat, 50):.2f} ms under the profiler): trace "
          f"{sm['span_ms']:.2f} ms; default stream {sm['default']} busy "
          f"{d['busy_ms']:.2f} ms (share {d['busy_ms'] / sm['span_ms']:.4f})"
          f": kernels {d['kernel_ms']:.2f} ms in {d['kernels']}, sets "
          f"{d['memset_ms']:.2f} ms, copies {copies(d) or 'none'}, longest "
          f"answer copy {d['DtoH_max_ms']:.2f} ms; top kernels "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in sm["top"])
          + "; other streams: " + ("; ".join(
              f"{sid} busy {row['busy_ms']:.2f} ms, kernels "
              f"{row['kernel_ms']:.2f} ms, {copies(row) or 'no copies'}"
              for sid, row in sm["streams"].items()
              if sid != sm["default"]) or "none")
          + "; host calls that wait (n, total ms, longest ms): "
          + "; ".join(f"{k} {v[0]}, {v[1]:.2f}, {v[2]:.2f}" for k, v in
                      sorted(sm["waits"].items(), key=lambda kv: -kv[1][1])
                      [:8]))


def fleet_rest_vs_paging(st, where):
    """Gold predicts on a resident alpha at rest, while another thread
    pages beta and gamma in and out, and while it also publishes each
    residency (so each page-out copies 2.95 GB back over the link); every
    answer bit-equal. Prints each request stage's median each way, then
    the same runs, shorter, under torch.profiler: what the card and the
    host's waiting calls did (the chrome traces go to chiprun_out/)."""
    from torch.profiler import ProfilerActivity, profile

    runs = (("at rest", False), ("while paging", True),
            ("while paging with copies back", "publish"))
    lat, stages = {}, {}
    for tag, paging in runs:
        stages[tag] = []
        lat[tag] = _fleet_alpha_run(st, FLEET_REST_N, paging, stages[tag])
    print(f"[fleet] gold on alpha on {where} ({FLEET_REST_N} predicts each, "
          f"bit-equal; beta and gamma paging in and out): " + "; ".join(
              f"{tag} p50 {_pct(v, 50):.2f} ms p99 {_pct(v, 99):.2f} ms"
              for tag, v in lat.items()))
    every = [x for v in stages.values() for x in v]
    names = [n for n in every[0] if all(n in x for x in every)]
    print(f"[fleet] gold on alpha, stage medians (ms) " + " / ".join(
        tag for tag, _ in runs) + ": " + "; ".join(
            f"{n} " + " / ".join(f"{_pct([x[n] for x in v], 50):.2f}"
                                 for v in stages.values()) for n in names))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for tag, paging in runs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = _fleet_alpha_run(st, FLEET_PROF_N, paging)
            torch.cuda.synchronize()
        path = os.path.join(out_dir, "fleet_trace_"
                            + tag.replace(" ", "_") + ".json")
        prof.export_chrome_trace(path)
        _print_trace_summary(f"gold on alpha {tag}", where,
                             _trace_summary(path), got)
    return lat


def fleet_faults(st, srv, where):
    """An injected page-in transfer failure and a torn copy, each retried;
    serve.dispatch failures that open beta's breaker, its 503 sheds, and
    the half-open probe that closes it; memory back to its level."""
    from deeplearning4j_torch.chaos import faults
    from deeplearning4j_torch.fleet import CircuitOpenError
    from deeplearning4j_torch.obs import reqtrace
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.serve import ServeError

    fleet, rt = st["fleet"], reqtrace.ACTIVE
    beta = fleet.get("beta")
    fleet.ensure("alpha")
    fleet.ensure("beta")
    mem0 = _fleet_mem()["allocated"]
    retry = fleet.metrics.counter(
        "fleet_retry_total", {"op": "fleet.page_in_transfer",
                              "outcome": "recovered"})
    r0 = retry.value
    # 1. the seam: one injected failure, retried
    fleet.pager.drop(beta)
    plane = faults.install(faults.FaultPlane(seed=0))
    try:
        plane.inject("fleet.page_in_transfer", error=OSError, times=1)
        _, _, _, ok = fleet_predict(st, "beta", 0, "gold", rt)
        fired = plane.injected()
    finally:
        faults.uninstall()
    check(ok and fired == {("fleet.page_in_transfer", "error"): 1},
          f"[fleet] page-in fault: fired {fired}, answer equal {ok}")
    # 2. a copy torn half way through the model's tensors, retried
    fleet.pager.drop(beta)
    real, calls = beta._device_leaf, [0]
    tear = len(tree_leaves(beta._host_params)) // 2

    def torn(h):
        calls[0] += 1
        if calls[0] == tear:
            raise OSError("host-to-device copy torn")
        return real(h)

    beta._device_leaf = torn
    try:
        _, _, _, ok = fleet_predict(st, "beta", 1, "gold", rt)
    finally:
        del beta._device_leaf
    recovered = int(retry.value - r0)
    check(ok and calls[0] > tear, "[fleet] torn page-in not retried")
    check(recovered == 2, f"[fleet] {recovered} page-ins recovered after "
          f"a retry, want 2")
    # 3. dispatch failures open beta's breaker; it sheds until a probe
    br = fleet._breaker("beta")
    plane = faults.install(faults.FaultPlane(seed=0))
    causes = []
    try:
        plane.inject("serve.dispatch", error=RuntimeError,
                     times=FLEET_BREAKER["breaker_failures"])
        for _ in range(FLEET_BREAKER["breaker_failures"]):
            try:
                fleet.predict("beta", st["prompts"][0], tenant="gold")
            except ServeError as e:
                causes.append(e.cause)
    finally:
        faults.uninstall()
    check(br.state() == "open", f"[fleet] beta's breaker {br.state()} after "
          f"{causes}")
    sheds = []
    for _ in range(3):
        code, body, retry_after = _fleet_http(
            srv.port, "/v1/models/beta/predict",
            {"ndarray": st["http_prompt"].tolist()}, "gold")
        sheds.append((code, body.get("cause"), retry_after))
    check(all(c == 503 and cause == "breaker_open" and ra is not None
              and int(ra) >= 1 for c, cause, ra in sheds),
          f"[fleet] open breaker answered {sheds}")
    try:
        fleet.predict("beta", st["prompts"][0], tenant="gold")
        check(False, "[fleet] an open breaker let a request through")
    except CircuitOpenError as e:
        check(e.retry_after_s > 0, "[fleet] breaker retry_after_s")
    deadline = time.monotonic() + 60
    probes = 0
    while br.state() != "closed" and time.monotonic() < deadline:
        time.sleep(0.25)
        try:
            _, _, _, ok = fleet_predict(st, "beta", 2, "gold", rt)
            probes += 1
            check(ok, "[fleet] the probe's answer differs")
        except ServeError:
            pass
    check(br.state() == "closed", "[fleet] beta's breaker never closed")
    fleet.ensure("alpha")
    fleet.ensure("beta")
    mem1 = _fleet_mem()["allocated"]
    check(abs(mem1 - mem0) <= st["cast_bytes"], f"[fleet] memory_allocated "
          f"{mem0} B before the faults, {mem1} B after")
    print(f"[fleet] faults on {where}: a fleet.page_in_transfer error and a "
          f"copy torn at tensor {tear} each retried (recovered {recovered}, "
          f"answers bit-equal); serve.dispatch x"
          f"{FLEET_BREAKER['breaker_failures']} -> {causes} opened beta's "
          f"breaker, 503 sheds {sheds}, closed after {probes} probe(s); "
          f"memory_allocated {mem0} B before, {mem1} B after")


def _fleet_http(port, path, body=None, tenant=None):
    """(status, JSON body, Retry-After) of one request to 127.0.0.1."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if tenant is not None:
        headers["X-Tenant"] = tenant
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), r.headers.get(
                "Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def fleet_http(st, srv, tracer, where):
    """The routed front door: a traced predict on a cold alpha (bit-equal,
    its stitched stages and the fleet.page_in span), gamma's generate, the
    fleet's residency, a 404, and the free tenant's 429."""
    fleet = st["fleet"]
    fleet.pager.drop(fleet.get("alpha"))
    code, body, _ = _fleet_http(srv.port, "/v1/models/alpha/predict",
                                {"ndarray": st["http_prompt"].tolist()},
                                "gold")
    check(code == 200, f"[fleet] HTTP predict answered {code}: {body}")
    # the answer's size sets the cut of the HTTP prompt (FLEET_HTTP_T)
    answer_bytes = len(json.dumps(body).encode())
    y = np.asarray(body["output"], np.float32)[0]
    check(any(np.array_equal(y, r) for r in st["refs"]["alpha_http"][(0, 1)]),
          "[fleet] HTTP predict differs from the direct forward")
    code, body, _ = _fleet_http(srv.port, "/v1/models/gamma/generate",
                                {"prompt": st["gen_prompt"].tolist(),
                                 "max_new_tokens": FLEET_GEN_TOKENS,
                                 "temperature": 0.0, "stream": False},
                                "standard")
    check(code == 200 and body["tokens"] == st["gen_want"],
          f"[fleet] HTTP generate answered {code}: {body}")
    code, body, _ = _fleet_http(srv.port, "/v1/fleet")
    resident = sorted(n for n, m in body["models"].items() if m["resident"])
    check(code == 200 and resident == sorted(fleet.pager.resident()),
          f"[fleet] /v1/fleet residency {resident}")
    code, _, _ = _fleet_http(srv.port, "/v1/models/nope/predict",
                             {"ndarray": [[1]]})
    check(code == 404, f"[fleet] an unknown model answered {code}")
    deadline = time.monotonic() + 10
    while True:  # the record lands when the handler's finally has run
        reqs = _fleet_http(srv.port, "/v1/debug/requests")[1]["requests"]
        traced = [r for r in reqs if r["kind"] == "predict"
                  and r["model"] == "alpha" and r["tenant"] == "gold"
                  and r["status"] == "ok" and any(
                      s["name"] == "flush" for s in r["stages"])]
        if traced or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    check(traced, "[fleet] no traced alpha predict in /v1/debug/requests")
    stages = {s["name"]: s for s in traced[-1]["stages"]}
    check({"admit", "page_in_wait", "queue", "device", "flush"} <=
          set(stages), f"[fleet] traced stages {sorted(stages)}")
    spans = [e for e in tracer.events if e.get("name") == "fleet.page_in"
             and e.get("args", {}).get("model") == "alpha"]
    check(spans, "[fleet] no fleet.page_in span for alpha")
    wait_ms = stages["page_in_wait"]["dur_ms"]
    check(wait_ms >= spans[-1]["dur"] / 1e3 * 0.999,
          f"[fleet] page_in_wait {wait_ms} ms shorter than the page-in "
          f"{spans[-1]['dur'] / 1e3} ms")
    quota = None
    for _ in range(40):  # one-token prompts: small answers, 20/s or more
        code, body, ra = _fleet_http(srv.port, "/v1/models/alpha/predict",
                                     {"ndarray": [[7]]}, "free")
        if code == 429:
            quota = (code, body.get("cause"), ra)
            break
        check(code == 200, f"[fleet] free tenant answered {code}: {body}")
    check(quota is not None and quota[1] == "quota" and int(quota[2]) >= 1,
          f"[fleet] the free tenant was not shed over HTTP: {quota}")
    print(f"[fleet] HTTP predict answer of {FLEET_HTTP_T} tokens: "
          f"{answer_bytes} B of JSON ({answer_bytes / FLEET_HTTP_T:.0f} B a "
          f"token; {answer_bytes / FLEET_HTTP_T * FLEET_T / 1e6:.1f} MB at "
          f"the {FLEET_T}-token prompt)")
    print(f"[fleet] HTTP on {where}: predict on a cold alpha bit-equal, its "
          f"stages {[s['name'] for s in traced[-1]['stages']]} "
          f"(page_in_wait {wait_ms:.2f} ms around a fleet.page_in span of "
          f"{spans[-1]['dur'] / 1e3:.2f} ms); generate tokens equal; "
          f"/v1/fleet residency {resident}; unknown model 404; free tenant "
          f"{quota[0]} with Retry-After {quota[2]}")


def phase_fleet():
    """[fleet]: three full-width CausalLMs (alpha, beta, gamma; seeds 0-2)
    in a weight budget of 2.2 models, tenants gold/standard/free as
    bench.py:_bench_fleet sets them, through FleetRegistry and FleetServer
    with request traces and a flight recorder installed. Returns every
    kernel's launches over the phase."""
    from deeplearning4j_torch.fleet import FleetServer
    from deeplearning4j_torch.obs import flight, reqtrace
    from deeplearning4j_torch.obs.trace import Tracer

    where = card()
    gc.collect()
    torch.cuda.empty_cache()
    base = _fleet_mem()["allocated"]
    link = _fleet_link_rates()
    st = fleet_build(where)
    fleet = st["fleet"]
    tracer = Tracer()
    flight.install(flight.FlightRecorder())
    reqtrace.install(reqtrace.RequestTracer(tracer=tracer))
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    srv = None
    try:
        window = fleet_window(st, where)
        fleet_generations(st, window["gens"])
        fleet_rest_vs_paging(st, where)
        srv = FleetServer(fleet, port=0).start()
        fleet_faults(st, srv, where)
        fleet_http(st, srv, tracer, where)
        fleet_published_cycles(st)
        fleet_generations(st, {})
        fleet_transfers(st, where, link)
        counts = {k: w.launches for k, w in wrappers.items()}
        batches = sum(int(fleet.metrics.counter(
            "serve_batches_total", {"model": n}).value) for n in FLEET_NAMES)
    finally:
        if srv is not None:
            srv.stop()
        fleet.shutdown()
        reqtrace.uninstall()
        flight.uninstall()
        st.pop("knn")
    left = _fleet_mem()["allocated"] - base
    check(counts["K1"] == 12 * batches, f"[fleet] K1 launched "
          f"{counts['K1']} times for {batches} predict batches")
    check(all(v == 0 for k, v in counts.items() if k != "K1"),
          f"[fleet] kernels other than K1 launched: {counts}")
    check(left <= st["cast_bytes"], f"[fleet] {left} B still allocated after "
          f"the fleet shut down")
    print(f"[fleet] kernel launches over the phase: {counts} ({batches} "
          f"predict batches, 12 each); after shutdown {left} B allocated "
          f"beyond the phase's start")
    return counts


AOT_DEVICE = "cuda"
AOT_BUCKETS = (1, 4)            # the engine's batch buckets
AOT_LENGTHS = (256, 1024)       # its length buckets, up to the model's T
AOT_PREDICTS = ((1, 100), (3, 700), (4, 1024), (1, 256), (2, 1000),
                (4, 37))        # (rows, tokens): every bucket, mixed
AOT_PROMPTS = (40, 90, 150, 300, 520, 700)   # no shared prefix
AOT_NEW = 16
AOT_TICKS = 40                  # decode ticks timed each way
AOT_TIMEOUT_S = 600


def _aot_config():
    """The serving config [aot] prebuilds and boots: the [serve] phase's
    model (738M CausalLM, bf16, flash) with random weights from seed 0,
    the engine's buckets up to its 1024 tokens, and the [generate] phase's
    paged batcher (8 slots, capacity 1024, blocks of 16, chunks of 64)."""
    return {"model": "causallm", "seed": 0, "dtype": "int32",
            "compute_dtype": "bfloat16",
            "model_kwargs": {"input_shape": [1024], "num_layers": 12,
                             "d_model": 2048, "num_heads": 32,
                             "vocab": 32000, "flash": True},
            "engine": {"batch_buckets": list(AOT_BUCKETS),
                       "length_buckets": list(AOT_LENGTHS)},
            "gen": {"slots": GEN_SLOTS, "capacity": GEN_CAPACITY,
                    "kv": "paged", "block_size": GEN_BLOCK,
                    "prefill_chunk": GEN_CHUNK, "prefix_cache": True,
                    "seed": 0}}


def _aot_server(model, store, manifest, metrics):
    """A strict ModelServer for [aot]'s config on 127.0.0.1."""
    from deeplearning4j_torch.serve import ModelServer

    cfg = _aot_config()
    gen = cfg["gen"]
    return ModelServer(
        model, port=0, batch_buckets=AOT_BUCKETS, length_buckets=AOT_LENGTHS,
        input_dtype=np.int32, gen_slots=gen["slots"],
        gen_capacity=gen["capacity"], gen_block_size=gen["block_size"],
        gen_prefill_chunk=gen["prefill_chunk"], seed=gen["seed"],
        metrics=metrics, aot_store=store, strict_aot=True,
        aot_manifest=manifest)


def _aot_predict_check(srv, model, snap, reqs):
    """Each request through the strict engine (graph replays) against the
    eager forward of the padded bucket batch it ran in, bit for bit:
    the replay runs the captured kernels on the same inputs. Returns the
    max abs difference and the graph replays they took."""
    eng = srv.engine
    fwd = eng.aot_functions()["engine_forward"]
    worst, r0 = 0.0, fwd.replays
    for x in reqs:
        y = eng.predict(x)
        rows, t = x.shape
        bucket = next(b for b in AOT_BUCKETS if b >= rows)
        length = next(L for L in AOT_LENGTHS if L >= t)
        pad = np.zeros((bucket, length), np.int32)
        pad[:rows, :t] = x
        with torch.inference_mode():
            ref = model.forward(snap.params, snap.state,
                                torch.from_numpy(pad).to(AOT_DEVICE),
                                training=False)[0]
        ref = ref.float().cpu().numpy()[:rows, :t]
        check(y.shape == ref.shape, f"[aot] answer {y.shape}, eager "
              f"{ref.shape}")
        worst = max(worst, float(np.abs(y - ref).max()))
    return worst, fwd.replays - r0


def _aot_generate(cb, prompts, sampled):
    reqs = [cb.submit(p, AOT_NEW, **(dict(temperature=0.8, top_k=40)
                                     if i in sampled else
                                     dict(temperature=0.0)))
            for i, p in enumerate(prompts)]
    return [r.wait().tolist() for r in reqs]


def _aot_ticks(cb, sampled):
    """Host ms p50 of a decode tick replayed alone (``step_probe``; 4
    greedy + 4 sampled slots, or all greedy), and its device ms and
    operations (torch.profiler)."""
    tick = cb.step_probe("decode", sampled=sampled, temperature=0.8,
                         top_k=40)
    for _ in range(3):
        tick()
    host = []
    for _ in range(AOT_TICKS):
        t0 = time.perf_counter()
        tick()
        host.append(1e3 * (time.perf_counter() - t0))
    dev, ops = device_ms(tick, reps=5)
    return statistics.median(host), dev, ops


def aot_serve(tmp):
    """[aot]'s second process: a strict ModelServer booted from the store
    the prebuild wrote, with the kernel build directory empty. Checks
    every gate and prints one JSON line of readings."""
    import urllib.error

    from deeplearning4j_torch.aot import AotStore
    from deeplearning4j_torch.aot.__main__ import serving_model
    from deeplearning4j_torch.fleet import FleetRegistry
    from deeplearning4j_torch.kernels import _build
    from deeplearning4j_torch.obs import profile
    from deeplearning4j_torch.obs.costmodel import (ProfileAccumulator,
                                                    put_profile)
    from deeplearning4j_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
    from deeplearning4j_torch.serve import ContinuousBatcher

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = _kernel_wrappers()
    k1 = wrappers["K1"]
    out = {"card": card()}
    check(not any(_build.BUILD_DIR.glob("*.so")),
          f"[aot] the build directory {_build.BUILD_DIR} is not empty")
    cfg = _aot_config()
    vocab = cfg["model_kwargs"]["vocab"]
    layers = cfg["model_kwargs"]["num_layers"]
    store = AotStore(os.path.join(tmp, "store"))
    manifest = os.path.join(tmp, "manifest.json")
    t0 = time.perf_counter()
    model = serving_model(cfg, AOT_DEVICE)
    torch.cuda.synchronize()
    out["model_init_s"] = time.perf_counter() - t0
    metrics = MetricsRegistry()
    for w in wrappers.values():  # every count from 0 before the boot
        w.launches = 0
    a0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = _aot_server(model, store, manifest, metrics).start()
    out["boot_s"] = time.perf_counter() - t0
    try:
        eng, cb = srv.engine, srv.batcher()
        fwd = eng.aot_functions()["engine_forward"]
        gfns = cb.aot_functions()
        k1_boot = k1.launches
        out["cold_start_s"] = {
            c: metrics.gauge("serve_cold_start_seconds",
                             {"component": c}).value
            for c in ("engine", "generate")}
        out["nvcc_builds"] = _build.BUILDS
        out["captures"] = {"engine_forward": fwd.captures,
                           **{t: f.captures for t, f in gfns.items()}}
        out["pool_bytes"] = fwd.pool_bytes() + sum(
            f.pool_bytes() for f in gfns.values())
        out["boot_allocated"] = torch.cuda.memory_allocated() - a0
        check(_build.BUILDS == 0, f"[aot] {_build.BUILDS} nvcc builds in "
              "a boot from a prebuilt store")
        n_eng = len(AOT_BUCKETS) * len(AOT_LENGTHS)
        check(fwd.captures == n_eng, f"[aot] {fwd.captures} engine graphs "
              f"at boot, want {n_eng}")
        # each engine graph: one eager warm-up and one capture of the same
        # K1 launches (12, one a layer); the batcher's graphs launch none
        k1_per_graph = k1_boot // (2 * n_eng)
        check(k1_boot == 2 * n_eng * k1_per_graph
              and k1_per_graph == layers, f"[aot] K1 launched {k1_boot} "
              f"times at boot for {n_eng} graphs")
        out["k1_captured_per_graph"] = k1_per_graph
        want_gen = 2 + len(cb.chunk_buckets)
        check(sum(f.captures for f in gfns.values()) == want_gen,
              f"[aot] batcher graphs at boot {out['captures']}, want "
              f"{want_gen}")

        # predicts of mixed buckets, bit for bit against the eager forward
        rng = np.random.RandomState(0)
        reqs = [rng.randint(0, vocab, (r, t)).astype(np.int32)
                for r, t in AOT_PREDICTS]
        snap = srv.registry.current()
        k1_before = k1.launches
        diff, replays = _aot_predict_check(srv, model, snap, reqs)
        eager_k1 = k1.launches - k1_before
        # the eager references launched 12 each; the served answers none
        check(eager_k1 == layers * len(reqs), f"[aot] {eager_k1} eager K1 "
              f"launches beside {len(reqs)} references")
        out["predict_max_abs_diff"] = diff
        out["predict_replays"] = replays
        check(diff == 0.0, f"[aot] graph answers differ from the eager "
              f"forward by {diff}")
        with _http(srv.port, "/predict",
                   {"ndarray": reqs[5][:1, :16].tolist()}) as r:
            body = json.loads(r.read())
        got = np.asarray(body["output"], np.float32)
        check(got.shape == (1, 16, vocab) and body["generation"] ==
              snap.generation, f"[aot] HTTP predict {got.shape}")

        # generation: greedy and seeded, against an eager batcher
        prompts = [rng.randint(0, vocab, (n,)).astype(np.int32)
                   for n in AOT_PROMPTS]
        sampled = {1, 3, 5}
        got = _aot_generate(cb, prompts, sampled)
        eager = ContinuousBatcher(
            model, registry=srv.registry, slots=GEN_SLOTS,
            capacity=GEN_CAPACITY, block_size=GEN_BLOCK,
            prefill_chunk=GEN_CHUNK, seed=0)
        try:
            want = _aot_generate(eager, prompts, sampled)
            out["eager_tick"] = _aot_ticks(eager, GEN_SLOTS // 2)
            out["eager_tick_greedy"] = _aot_ticks(eager, 0)
        finally:
            eager.shutdown()
            eager.release_device()
        del eager
        same = [a == b for a, b in zip(got, want)]
        out["tokens_equal"] = same
        check(all(same), f"[aot] batcher tokens under graphs differ from "
              f"the eager batcher's: {same}")
        with _http(srv.port, "/generate?stream=false",
                   {"prompt": prompts[0].tolist(),
                    "max_new_tokens": AOT_NEW, "temperature": 0.0}) as r:
            check(json.loads(r.read())["tokens"] == want[0],
                  "[aot] HTTP generate tokens")
        out["replayed_tick"] = _aot_ticks(cb, GEN_SLOTS // 2)
        out["replayed_tick_greedy"] = _aot_ticks(cb, 0)
        dec = metrics.histogram("serve_gen_decode_seconds")
        out["served_tick_p50_ms"] = 1e3 * dec.quantile(0.5)

        # an uncovered signature: a typed 503, nothing captured
        before = fwd.captures
        try:
            _http(srv.port, "/predict",
                  {"ndarray": np.zeros((1, 16, 2), np.int32).tolist()})
            status, cause = 200, None
        except urllib.error.HTTPError as e:
            status, cause = e.code, json.loads(e.read()).get("cause")
        out["uncovered"] = status
        check(status == 503 and cause == "aot_trace",
              f"[aot] uncovered signature answered {status}")
        check(fwd.captures == before and fwd.call_captures == 0,
              "[aot] a call captured a graph")

        # the profiler: per-executable device times and padding waste
        prof = profile.install(profile.Profiler(sample_rate=1,
                                                metrics=metrics))
        try:
            for x in reqs[:3]:
                eng.predict(x)
            _aot_generate(cb, prompts[:2], set())
            with _http(srv.port, "/v1/debug/profile") as r:
                payload = json.loads(r.read())
            with _http(srv.port, "/metrics") as r:
                scrape = r.read().decode()
            _promcheck(scrape, "[aot] the strict server's /metrics")
        finally:
            profile.uninstall()
        # the card's cost profile, filed in the store for [cluster]'s tuner
        cost = ProfileAccumulator().fold(
            prof.snapshot(include_pairs=True)).profile()
        check(put_profile(store, _aot_model_fp(), cost) is not None,
              "[aot] the cost profile was not stored")
        out["cost_profile"] = dict(cost.costs)
        tags = {e["tag"] for e in payload["executables"]}
        check(payload["enabled"] and {"engine_forward", "gen_decode_paged",
                                      "gen_prefill_chunk"} <= tags
              and all(e["sampled"] > 0 for e in payload["executables"])
              and any(k.startswith("engine/") for k in payload["padding"])
              and "profile_dispatch_device_seconds_bucket" in scrape,
              f"[aot] /v1/debug/profile: {sorted(tags)}")
        out["profile"] = [
            {k: e.get(k) for k in ("component", "tag", "dispatches",
                                   "us_per_dispatch", "waste_ratio")}
            for e in payload["executables"]]
        out["padding"] = {k: round(v["waste_ratio"], 4)
                          for k, v in payload["padding"].items()}

        # publish: the candidate's graphs before the flip, its answers
        new = tree_unflatten(snap.params, [
            t * 1.0078125 for t in tree_leaves(snap.params)])
        caps = fwd.captures, sum(f.captures for f in gfns.values())
        t0 = time.perf_counter()
        nsnap = srv.publish(new)
        out["publish_s"] = time.perf_counter() - t0
        check(fwd.captures == caps[0] + n_eng and sum(
            f.captures for f in gfns.values()) == caps[1] + want_gen,
            "[aot] the publish did not warm the candidate's graphs")
        diff2, _ = _aot_predict_check(srv, model, nsnap, reqs[:2])
        check(diff2 == 0.0, f"[aot] new generation's answers differ by "
              f"{diff2}")
        check(fwd.generations() == [nsnap.generation], "[aot] the old "
              f"generation's graphs are still held: {fwd.generations()}")
        check(fwd.call_captures == 0 and all(
            f.call_captures == 0 for f in gfns.values()),
            "[aot] a call captured a graph")
        out["engine_replays"] = fwd.replays
    finally:
        srv.stop()
    del srv, eng, cb, fwd, gfns, snap, new, nsnap
    gc.collect()
    torch.cuda.empty_cache()

    # one strict fleet page cycle of two models
    beta = serving_model({**cfg, "seed": 1}, AOT_DEVICE)
    wb = sum(t.numel() * t.element_size()
             for t in tree_leaves((model.params, model.state)))
    fleet = FleetRegistry(hbm_budget_bytes=int(1.5 * wb), aot_store=store,
                          strict_aot=True, metrics=MetricsRegistry(),
                          device=AOT_DEVICE)
    x = reqs[0]
    fleet_metrics = fleet.metrics
    try:
        engine_opts = dict(batch_buckets=AOT_BUCKETS,
                           length_buckets=AOT_LENGTHS)
        fleet.add("alpha", model, engine_opts=engine_opts,
                  input_dtype=np.int32)
        fleet.add("beta", beta, engine_opts=engine_opts,
                  input_dtype=np.int32)
        for m in (model, beta):  # the fleet's host copies hold them now
            m.params, m.state = None, {}
        del model, beta, m
        gc.collect()
        torch.cuda.empty_cache()
        order = ("alpha", "beta", "alpha", "beta")
        answers = [fleet.predict(n, x).output for n in order]
        check(np.array_equal(answers[0], answers[2])
              and np.array_equal(answers[1], answers[3]),
              "[aot] answers changed across a page cycle")
        outs = [r for n in ("alpha", "beta")
                for r in fleet.get(n).page_log if r["kind"] == "page_out"]
        check(len(outs) >= 3 and all(r["freed"] >= wb for r in outs),
              f"[aot] page-outs freed {[r['freed'] for r in outs]} B, "
              f"weights {wb} B")
        out["fleet_freed"] = [r["freed"] for r in outs]
        out["fleet_weight_bytes"] = wb
        # an entry whose buckets the store does not cover: typed page-in
        fleet.add("gamma", fleet.get("alpha").model,
                  params=fleet.get("alpha")._host_params,
                  engine_opts=dict(batch_buckets=(2,),
                                   length_buckets=AOT_LENGTHS),
                  input_dtype=np.int32)
        try:
            fleet.predict("gamma", x)
            cause = None
        except Exception as e:  # the typed refusal is the gate
            cause = getattr(e, "cause", type(e).__name__)
        out["fleet_uncovered"] = cause
        check(cause == "page_in_failed", f"[aot] uncovered page-in: {cause}")
    finally:
        fleet.shutdown()
    # every fleet batch replayed a graph: a strict fleet captures none on
    # a call (it raises instead)
    snapf = fleet_metrics.snapshot()
    out["fleet_batches"] = int(sum(s["value"] for s in snapf.get(
        "serve_batches_total", {}).get("series", [])))
    fleet_compiles = sum(s["value"] for s in snapf.get(
        "serve_compile_misses_total", {}).get("series", []))
    check(out["fleet_batches"] >= len(order) and fleet_compiles == 0,
          f"[aot] fleet batches {out['fleet_batches']}, compiles "
          f"{fleet_compiles}")
    # the kernels' counts over the whole path: K1's are its captured
    # launches times the replays (a replay moves no counter); every other
    # wrapper's counter as it stands (nothing here compares them)
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    out["launches"]["K1"] = k1_per_graph * (out["engine_replays"]
                                            + out["fleet_batches"])
    check(all(v == 0 for k, v in out["launches"].items() if k != "K1"),
          f"[aot] kernels other than K1 launched: {out['launches']}")
    print(json.dumps(out))
    return 0


def phase_aot(keep=None):
    """[aot]: prebuild a store for _aot_config in one process, then boot a
    strict ModelServer from it in another (an empty kernel build
    directory) and hold it to every gate there. Returns every kernel's
    launches on the path, counted in that process: K1's are the launches
    captured in each engine graph times the graphs' replays (the strict
    server's and the fleet's). ``keep``: a directory that holds the store
    afterwards (with the card's cost profile, for [cluster]), else a
    temporary one."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    gc.collect()
    torch.cuda.empty_cache()
    with (contextlib.nullcontext(keep) if keep is not None
          else tempfile.TemporaryDirectory()) as tmp:
        cfg = os.path.join(tmp, "config.json")
        with open(cfg, "w") as f:
            json.dump(_aot_config(), f)
        t0 = time.perf_counter()
        pb = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_torch.aot", "--store",
             os.path.join(tmp, "store"), "prebuild", "--config", cfg,
             "--manifest-out", os.path.join(tmp, "manifest.json")],
            cwd=here, capture_output=True, text=True, timeout=AOT_TIMEOUT_S)
        prebuild_s = time.perf_counter() - t0
        check(pb.returncode == 0, f"[aot] prebuild exited {pb.returncode}:"
              f"\n{pb.stdout[-3000:]}\n{pb.stderr[-3000:]}")
        report = json.loads(pb.stdout)
        print(f"[aot] prebuild in {prebuild_s:.1f} s (warm pass "
              f"{report['prebuild_seconds']:.1f} s): sites "
              f"{report['sites']}, kernels {report['kernels']}, store "
              f"{report['store']['entries']} entries "
              f"{report['store']['bytes']} B")
        env = dict(os.environ,
                   DL4J_TORCH_KERNEL_BUILD_DIR=os.path.join(tmp, "kbuild"))
        t0 = time.perf_counter()
        sv = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--aot-serve", tmp], cwd=here, env=env,
                            capture_output=True, text=True,
                            timeout=AOT_TIMEOUT_S)
        serve_s = time.perf_counter() - t0
    check(sv.returncode == 0, f"[aot] strict server exited "
          f"{sv.returncode}:\n{sv.stdout[-3000:]}\n{sv.stderr[-4000:]}")
    r = json.loads(sv.stdout.strip().splitlines()[-1])
    eh, ed, eo = r["eager_tick"]
    gh, gd, go = r["replayed_tick"]
    print(f"[aot] strict boot from the store in {r['boot_s']:.2f} s (model "
          f"init {r['model_init_s']:.2f} s before it; cold start engine "
          f"{r['cold_start_s']['engine']:.2f} s, generate "
          f"{r['cold_start_s']['generate']:.2f} s), nvcc builds "
          f"{r['nvcc_builds']}, graphs {r['captures']}, static buffers "
          f"{r['pool_bytes']} B, allocated by the boot "
          f"{r['boot_allocated']} B; the whole process {serve_s:.1f} s")
    print(f"[aot] predicts replayed {r['predict_replays']} graphs, max abs "
          f"diff to the eager forward {r['predict_max_abs_diff']}; tokens "
          f"equal to the eager batcher's {r['tokens_equal']}; uncovered "
          f"signature {r['uncovered']}; publish {r['publish_s']:.2f} s")
    print(f"[aot] decode tick (4 greedy + 4 sampled of 8 slots): eager "
          f"host p50 {eh:.3f} ms, device {ed:.3f} ms in {eo:.0f} ops; "
          f"replayed host p50 {gh:.3f} ms, device {gd:.3f} ms in {go:.0f} "
          f"ops (the eager tick measured before: 17.7 ms host, 7.1 ms "
          f"device); all greedy: eager "
          f"{r['eager_tick_greedy'][0]:.3f} / "
          f"{r['eager_tick_greedy'][1]:.3f} ms, replayed "
          f"{r['replayed_tick_greedy'][0]:.3f} / "
          f"{r['replayed_tick_greedy'][1]:.3f} ms (host p50 / device); "
          f"served tick p50 {r['served_tick_p50_ms']:.3f} ms; {r['card']}")
    print(f"[aot] profile: {r['profile']}; padding waste {r['padding']}; "
          f"cost profile filed for [cluster]: {r['cost_profile']}")
    print(f"[aot] fleet page cycle: freed {r['fleet_freed']} B a page-out "
          f"(weights {r['fleet_weight_bytes']} B); uncovered page-in "
          f"{r['fleet_uncovered']}")
    print(f"[aot] kernel launches on the path: {r['launches']} (K1: "
          f"{r['k1_captured_per_graph']} captured a graph x "
          f"{r['engine_replays']} server + {r['fleet_batches']} fleet "
          f"replays)")
    return r["launches"]


CLUSTER_NAMES = ("alpha", "beta")          # seeds 0, 1
CLUSTER_DEVICE = "cuda"
CLUSTER_BUCKETS = (1, 2, 4)
CLUSTER_LENGTHS = (16, 128, 1024)
# routed predicts: a JSON answer carries 32000 floats a token (744,024 B a
# token, as [fleet] measures), parsed and written again by the router, so
# the reference pass predicts at 16 tokens and once at 128; the 1024-token
# predict runs in [fleet], in process
CLUSTER_SHORT_T = 16
CLUSTER_LONG_T = 128
CLUSTER_PROMPTS = 2
CLUSTER_VOCAB = 32000
CLUSTER_SUSPECT_S, CLUSTER_DEAD_S = 2.0, 45.0
CLUSTER_BEAT_S = 1.0          # the heartbeat while a kill drill runs
CLUSTER_HEDGE_MS = 4000.0     # raised to 3x the routed p50 if that is more
CLUSTER_TIMING_N = 3          # routed and direct predicts, each way
CLUSTER_CLOSED_S = 8.0        # the closed loop that measures the rate:
CLUSTER_CLOSED_N = 30         # at least this long, and on to 30 answers,
CLUSTER_CLOSED_MAX_S = 60.0   # this long at most
CLUSTER_CLOSED_THREADS = 4
CLUSTER_REPLAY_S = 40.0       # the replayed day, in real time
CLUSTER_TUNE_LENGTHS = (16,)  # the tuned replica's traffic: 16 tokens
CLUSTER_TENANTS = {"gold": dict(rate_per_s=500.0, slo="gold"),
                   "standard": dict(rate_per_s=500.0),
                   "free": dict(rate_per_s=2.0, burst=2.0, slo="batch"),
                   "batch": dict(rate_per_s=500.0, slo="batch")}
CLUSTER_MEM_SHARE = 0.9       # peak reserved below this share of the card


def _cluster_engine_opts():
    return {"batch_buckets": CLUSTER_BUCKETS,
            "length_buckets": CLUSTER_LENGTHS, "queue_limit": 64}


class _SkewClock:
    """Membership leases, SLO burn and the autoscaler's signals on one
    clock that a drill can push forward: death detection and the burn
    window never wait on wall time."""

    def __init__(self):
        self.skew = 0.0

    def __call__(self):
        return time.monotonic() + self.skew


def _cluster_replica(rid, sources, budget, **fleet_kw):
    """One replica: a FleetRegistry holding ``sources`` ({name: (model,
    params, state)}) under ``budget`` weight bytes, served by
    spawn_replica. Without a tuned config each model gets the cluster's
    engine options and beta the [generate] phase's batcher."""
    from deeplearning4j_torch.cluster import spawn_replica
    from deeplearning4j_torch.fleet import FleetRegistry

    fleet = FleetRegistry(hbm_budget_bytes=budget, device=CLUSTER_DEVICE,
                          **fleet_kw)
    tuned = fleet_kw.get("tuned_for") is not None
    for name, (model, params, state) in sources.items():
        fleet.add(name, model, params=params, state=state,
                  input_dtype=np.int32,
                  engine_opts=None if tuned else _cluster_engine_opts(),
                  gen_opts=(None if tuned or name != "beta"
                            else _fleet_gen_opts()))
    return spawn_replica(rid, fleet)


def _pinned_bytes(handle):
    return sum(handle.fleet.get(n).weight_bytes for n in handle.fleet.names())


def _routed(port, path, body, tenant):
    """(status, JSON body, seconds) of one POST to 127.0.0.1:``port``."""
    t0 = time.perf_counter()
    code, payload, _ = _fleet_http(port, path, body, tenant=tenant)
    return code, payload, time.perf_counter() - t0


def _answer_ok(refs, name, j, payload):
    out = np.asarray(payload["output"], np.float32)
    return any(np.array_equal(out[0], r)
               for b in CLUSTER_BUCKETS for r in refs[name][(j, b)])


def cluster_build(where):
    """alpha and beta at full width; every reference (predicts at every
    bucket and row position, beta's batcher tokens); two replicas r1, r2,
    each holding both models under a budget of 2.2 models."""
    from deeplearning4j_torch.ops.updaters import tree_leaves

    rng = np.random.RandomState(7)
    prompts = ([rng.randint(0, CLUSTER_VOCAB, (1, CLUSTER_SHORT_T)).astype(
        np.int32) for _ in range(CLUSTER_PROMPTS)]
        + [rng.randint(0, CLUSTER_VOCAB, (1, CLUSTER_LONG_T)).astype(
            np.int32)])
    gen_prompt = rng.randint(0, CLUSTER_VOCAB, FLEET_GEN_PROMPT).astype(
        np.int32)
    models, refs = {}, {}
    gen_want = cast_bytes = None
    for seed, name in enumerate(CLUSTER_NAMES):
        t0 = time.perf_counter()
        m = _fleet_lm(seed)
        refs[name], _ = _fleet_refs(m, prompts)
        if name == "beta":
            gen_want, cast_bytes, _ = _fleet_gen_refs(m, gen_prompt)
        models[name] = m
        print(f"[cluster] {name}: {m.param_count()} params (seed {seed}), "
              f"references in {time.perf_counter() - t0:.2f} s; {where}")
    wb = sum(t.numel() * t.element_size() for t in
             tree_leaves((models["alpha"].params, models["alpha"].state)))
    budget = int(FLEET_BUDGET_MODELS * wb)
    sources = {n: (m, m.params, m.state) for n, m in models.items()}
    handles = {}
    for rid in ("r1", "r2"):
        t0 = time.perf_counter()
        handles[rid] = _cluster_replica(rid, sources, budget)
        print(f"[cluster] replica {rid} at {handles[rid].base_url}: pinned "
              f"host copies {_pinned_bytes(handles[rid])} B in "
              f"{time.perf_counter() - t0:.2f} s; budget {budget} B; "
              f"{where}")
    return {"models": models, "refs": refs, "prompts": prompts,
            "gen_prompt": gen_prompt, "gen_want": gen_want,
            "cast_bytes": cast_bytes, "weight_bytes": wb, "budget": budget,
            "handles": handles, "where": where}


def _host_sources(handle):
    """A live replica's models as sources for a new one: the model and its
    pinned host copies (the new replica makes its own)."""
    out = {}
    for name in handle.fleet.names():
        e = handle.fleet.get(name)
        out[name] = (e.model, e._host_params, e._host_state)
    return out


def cluster_reference(st, router):
    """A: gold and standard predicts of 16 and 128 tokens and beta's
    generates (buffered and streamed) through the router, each equal to
    what a replica gives alone; the free tenant's third request refused by
    the router's one bucket; routed against direct predict p50."""
    port = router.port
    wrong, lat = 0, []
    for name in CLUSTER_NAMES:
        for j in range(len(st["prompts"])):
            for tenant in ("gold", "standard"):
                if j == CLUSTER_PROMPTS and (name, tenant) != ("alpha",
                                                             "gold"):
                    continue   # one 128-token predict: 95 MB of JSON
                code, body, dt = _routed(
                    port, f"/v1/models/{name}/predict",
                    {"ndarray": st["prompts"][j].tolist()}, tenant)
                check(code == 200, f"[cluster] A: {name} predict {j} "
                      f"answered {code}: {body}")
                wrong += not _answer_ok(st["refs"], name, j, body)
                lat.append((st["prompts"][j].shape[1], dt))
    code, body, dt = _routed(port, "/v1/models/beta/generate?stream=false",
                             {"prompt": st["gen_prompt"].tolist(),
                              "max_new_tokens": FLEET_GEN_TOKENS,
                              "temperature": 0.0}, "standard")
    check(code == 200, f"[cluster] A: generate answered {code}: {body}")
    wrong += body["tokens"] != st["gen_want"]
    sse = _sse_tokens(port, "/v1/models/beta/generate",
                      {"prompt": st["gen_prompt"].tolist(),
                       "max_new_tokens": FLEET_GEN_TOKENS,
                       "temperature": 0.0}, "gold")
    wrong += sse != st["gen_want"]
    check(wrong == 0, f"[cluster] A: {wrong} wrong answers")
    # three at once: the router's one bucket (burst 2) admits two
    quota = []
    threads = [threading.Thread(target=lambda: quota.append(_routed(
        port, "/v1/models/alpha/predict",
        {"ndarray": st["prompts"][0].tolist()}, "free")[0]))
        for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    quota.sort()
    check(quota == [200, 200, 429],
          f"[cluster] A: the free tenant's answers {quota}")
    # the router's own cost: alpha's primary, routed and direct, in turns
    primary = router.candidates("alpha")[0]
    direct_port = int(st["handles"][primary].base_url.rsplit(":", 1)[1])
    routed_s, direct_s = [], []
    x = {"ndarray": st["prompts"][0].tolist()}
    for _ in range(CLUSTER_TIMING_N):
        code, body, dt = _routed(port, "/v1/models/alpha/predict", x,
                                 "standard")
        check(code == 200 and _answer_ok(st["refs"], "alpha", 0, body),
              "[cluster] A: a timed routed predict")
        routed_s.append(dt)
        code, body, dt = _routed(direct_port, "/v1/models/alpha/predict", x,
                                 "standard")
        check(code == 200 and _answer_ok(st["refs"], "alpha", 0, body),
              "[cluster] A: a timed direct predict")
        direct_s.append(dt)
    r50, d50 = (1e3 * statistics.median(v) for v in (routed_s, direct_s))
    by_t = {t: [1e3 * d for tt, d in lat if tt == t] for t, _ in lat}
    print(f"[cluster] A: {len(lat)} routed predicts (16 and 128 tokens), "
          f"a buffered and a streamed generate of {FLEET_GEN_TOKENS} "
          f"tokens: 0 wrong; routed ms by tokens "
          + ", ".join(f"{t}: {statistics.median(v):.1f} p50" for t, v in
                      sorted(by_t.items()))
          + f"; free tenant {quota}; alpha 16-token predict p50 routed "
          f"{r50:.1f} ms, direct to {primary} {d50:.1f} ms (router's own "
          f"{r50 - d50:.1f} ms); {st['where']}")
    return {"routed_p50_ms": r50, "direct_p50_ms": d50, "requests": len(lat)}


def _sse_tokens(port, path, body, tenant):
    """The tokens of one streamed generate (``data:`` events)."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-Tenant": tenant})
    toks = None
    with urllib.request.urlopen(req, timeout=300) as r:
        for line in r:
            if line.startswith(b"data: "):
                ev = json.loads(line[6:])
                check("error" not in ev, f"[cluster] SSE error event {ev}")
                if ev.get("done"):
                    toks = ev["tokens"]
    return toks


def cluster_hedge(st, router):
    """B: one dispatch delay (the serve.dispatch seam has no scope: armed
    for one firing while this request is the only traffic, it lands on
    the primary's dispatch) makes a gold predict's primary slow; the hedge
    to the other replica wins with a correct answer, both attempts are in
    one request trace, the loser's work completes and its replica's
    breaker stays closed."""
    from deeplearning4j_torch.chaos import faults
    from deeplearning4j_torch.obs import flight, reqtrace

    port = router.port
    cands = router.candidates("alpha")
    delay_s = router.hedge_ms / 1e3 + 3.0
    rec = flight.install(flight.FlightRecorder())
    reqtrace.install(reqtrace.RequestTracer(flight=rec))
    plane = faults.install(faults.FaultPlane(seed=0))
    try:
        plane.inject("serve.dispatch", delay_s=delay_s, times=1)
        code, body, dt = _routed(port, "/v1/models/alpha/predict",
                                 {"ndarray": st["prompts"][1].tolist()},
                                 "gold")
        check(code == 200 and _answer_ok(st["refs"], "alpha", 1, body),
              f"[cluster] B: the hedged predict answered {code}")
        check(dt < delay_s, f"[cluster] B: the hedged predict took "
              f"{dt:.2f} s, the delay {delay_s:.2f} s")
        time.sleep(delay_s - dt + 1.0)   # the loser's dispatch ends
        fired = plane.injected().get(("serve.dispatch", "delay"), 0)
    finally:
        faults.uninstall()
        reqtrace.uninstall()
        flight.uninstall()
    m = router.metrics
    launched = m.counter("cluster_hedges_total", {"outcome": "launched"}
                         ).value
    won = m.counter("cluster_hedges_total", {"outcome": "won"}).value
    check(fired == 1 and launched >= 1 and won >= 1,
          f"[cluster] B: delay fired {fired}, hedges launched {launched}, "
          f"won {won}")
    rec_ = next(r for r in reversed(rec.requests())
                if r["kind"] == "route:predict")
    att = sorted((a["args"]["replica"], a["args"]["hedge"])
                 for a in rec_["stages"] if a["name"] == "attempt")
    check(att == sorted([(cands[0], False), (cands[1], True)]),
          f"[cluster] B: attempts in the request trace {att}")
    loser = st["handles"][cands[0]].fleet
    brk = loser.status()["breakers"]["alpha"]
    check(brk.get("state") == "closed", f"[cluster] B: the loser's alpha "
          f"breaker {brk}")
    # no other request harmed: the loser answers alone, correctly
    lport = int(st["handles"][cands[0]].base_url.rsplit(":", 1)[1])
    code, body, _ = _routed(lport, "/v1/models/alpha/predict",
                            {"ndarray": st["prompts"][0].tolist()}, "gold")
    check(code == 200 and _answer_ok(st["refs"], "alpha", 0, body),
          "[cluster] B: the loser's next answer")
    print(f"[cluster] B: hedge_ms {router.hedge_ms:.0f}, delay "
          f"{delay_s:.2f} s on {cands[0]}: the hedge to {cands[1]} won in "
          f"{1e3 * dt:.1f} ms with a correct answer; attempts {att}; the "
          f"loser's breaker {brk.get('state')}; {st['where']}")
    return dt


def _mixed_load(port, st, stop, out, pause=0.0):
    """Client threads until ``stop``: gold and standard predicts on alpha
    and beta, standard generates on beta, each client waiting ``pause``
    seconds between its requests. Records (kind, code, body-ok)."""
    def predicts(tenant):
        j = 0
        while not stop.wait(pause):
            name = CLUSTER_NAMES[j % 2]
            try:
                code, body, _ = _routed(
                    port, f"/v1/models/{name}/predict",
                    {"ndarray": st["prompts"][0].tolist()}, tenant)
            except OSError as e:
                out.append(("predict", "transport", type(e).__name__))
                continue
            out.append(("predict", code,
                        _answer_ok(st["refs"], name, 0, body)
                        if code == 200 else body.get("cause")))
            j += 1

    def generates():
        while not stop.wait(pause):
            try:
                code, body, _ = _routed(
                    port, "/v1/models/beta/generate?stream=false",
                    {"prompt": st["gen_prompt"].tolist(),
                     "max_new_tokens": FLEET_GEN_TOKENS,
                     "temperature": 0.0}, "standard")
            except OSError as e:
                out.append(("generate", "transport", type(e).__name__))
                continue
            out.append(("generate", code,
                        body["tokens"] == st["gen_want"] if code == 200
                        else body.get("cause")))

    threads = [threading.Thread(target=predicts, args=(t,), daemon=True)
               for t in ("gold", "standard")]
    threads.append(threading.Thread(target=generates, daemon=True))
    for th in threads:
        th.start()
    return threads


def _typed_or_correct(outcomes, what):
    bad = [o for o in outcomes if not (
        (o[1] == 200 and o[2] is True)
        or (isinstance(o[1], int) and o[1] not in (200, 500)
            and isinstance(o[2], str)))]
    check(not bad, f"[cluster] {what}: {len(bad)} answers neither correct "
          f"nor typed: {bad[:5]}")


def _k1_check_on_card(st, what):
    """K1 against its plain version at the shapes the cluster gives it: a
    predict batch of 1, 2 or 4 rows (32 heads each) at the 16- and
    128-token buckets, D 64, bf16, causal. Its launches are off the path
    (``_off_path``)."""
    from deeplearning4j_torch.ops.flash_attention import (
        flash_attention_reference, flash_fwd_cuda)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(100)
    err = 0.0
    with _off_path(st):
        for b in CLUSTER_BUCKETS:
            for t in (CLUSTER_SHORT_T, CLUSTER_LONG_T):
                q, k, v = _qkv(gen, 32 * b, t, 64, torch.bfloat16)
                o, lse = flash_fwd_cuda(q, k, v, scale=0.125, causal=True)
                o_ref, lse_ref = flash_attention_reference(
                    q, k, v, scale=0.125, causal=True)
                err = max(err, _compare(o, lse, o_ref, lse_ref,
                                        f"{what}: K1 at BH {32 * b}, T {t}"))
    return err


@contextlib.contextmanager
def _off_path(st):
    """Kernel launches inside the block (comparisons with a plain version,
    the references' forwards) are read into ``st["offpath"]`` and left out
    of the path's counts; the wrappers' counters are never written. Only
    for blocks that run while no traffic does."""
    wrappers = _kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        yield
    finally:
        for k, w in wrappers.items():
            st["offpath"][k] += w.launches - before[k]


class _HostTrace:
    """What the process does over a window: every thread's Python stack
    sampled every INTERVAL_S (its role: a replica's engine, batcher or
    HTTP handler, the router, the clients, the main thread; its activity:
    JSON, waiting, or the innermost frame of the repo), the process's CPU
    seconds against the wall's (one interpreter lock lets about one
    thread run Python at a time), and with ``device=True`` the card's
    kernel time from torch.profiler's CUDA activity (busy: the union of
    the kernels' intervals)."""

    WAITS = {"wait", "acquire", "_wait_for_tstate_lock", "select", "poll",
             "accept", "recv_into", "readinto", "readline", "sleep", "get",
             "join", "_recv_bytes", "serve_forever"}

    INTERVAL_S = 0.05

    def __init__(self, st, router, device=False, begin_later=False):
        self.device = device
        self.begin_later = begin_later
        self.ports = {router.port: "router"}
        self.ports.update({int(h.base_url.rsplit(":", 1)[1]): rid
                           for rid, h in st["handles"].items()})
        self.idents = {}
        for rid, h in st["handles"].items():
            if not h.alive():
                continue
            for name in h.fleet.names():
                for cname, comp in h.fleet.get(name).components():
                    th = getattr(comp, "_thread", None)
                    if th is not None and th.ident is not None:
                        self.idents[th.ident] = f"{rid}/{cname}"
        self.counts = collections.Counter()
        self._th = None
        self.ticks = 0
        self.running = 0
        self._stop = threading.Event()

    def _role(self, th, frames):
        if th.ident in self.idents:
            return self.idents[th.ident]
        if th is threading.main_thread():
            return "main"
        for f in frames:
            # BaseHTTPRequestHandler.handle: its self is the handler, whose
            # server's port names the replica or the router
            if f.f_code.co_name != "handle" or not f.f_code.co_filename \
                    .endswith(os.path.join("http", "server.py")):
                continue
            srv = getattr(f.f_locals.get("self"), "server", None)
            addr = getattr(srv, "server_address", None)
            if addr and addr[1] in self.ports:
                return f"{self.ports[addr[1]]}/http"
        if th.name.startswith("cluster-"):
            return f"router/{th.name[8:]}"
        if th.name.startswith("sim-replay"):
            return "client"
        for f in frames:
            if f.f_code.co_name in ("predicts", "generates", "probe",
                                    "client"):
                return "client"
        return th.name.split("-")[0]

    @staticmethod
    def _where(frames):
        """The innermost frame of the repo's code (the port or this
        script) as 'file:function', else the innermost frame's."""
        for f in frames:
            fn = f.f_code.co_filename
            if "deeplearning4j_torch" + os.sep in fn:
                rel = fn.split("deeplearning4j_torch" + os.sep, 1)[1]
                return f"{rel}:{f.f_code.co_name}"
            if fn.endswith("chip_smoke.py"):
                return f"chip_smoke:{f.f_code.co_name}"
        inner = frames[0]
        return (f"{os.path.basename(inner.f_code.co_filename)}:"
                f"{inner.f_code.co_name}")

    def _activity(self, frames):
        for f in frames:
            fn = f.f_code.co_filename
            if fn.endswith(os.path.join("json", "encoder.py")):
                return "json encode"
            if fn.endswith(os.path.join("json", "decoder.py")):
                return "json decode"
        if frames[0].f_code.co_name in self.WAITS:
            return "wait " + self._where(frames)
        return self._where(frames)

    def _loop(self):
        me = threading.get_ident()
        while not self._stop.wait(self.INTERVAL_S):
            threads = {t.ident: t for t in threading.enumerate()}
            running = 0
            for ident, top in sys._current_frames().items():
                th = threads.get(ident)
                if ident == me or th is None:
                    continue
                frames = []
                f = top
                while f is not None:
                    frames.append(f)
                    f = f.f_back
                act = self._activity(frames)
                running += not act.startswith("wait ")
                self.counts[(self._role(th, frames), act)] += 1
            self.ticks += 1
            self.running += running

    def __enter__(self):
        """Starts torch.profiler (with ``device``) in a warm-up step whose
        events are dropped, then the window, unless ``begin_later``: then
        the window starts at :meth:`begin`, after the profiler's start-up
        (the first session in a process was seen to take tens of seconds
        to start under load)."""
        self._prof = None
        self.busy_ms = self.kernel_ms = None
        t0 = time.perf_counter()
        if self.device:
            from torch.profiler import ProfilerActivity, profile, schedule

            self._prof = profile(activities=[ProfilerActivity.CUDA],
                                 schedule=schedule(wait=0, warmup=1,
                                                   active=1, repeat=1))
            self._prof.__enter__()
        self.start_s = time.perf_counter() - t0
        if not self.begin_later:
            self.begin()
        return self

    def begin(self):
        """The window starts: sampling, the CPU clock and the profiler's
        recorded step."""
        if self._prof is not None:
            self._prof.step()
        self.t0, self.cpu0 = time.perf_counter(), time.process_time()
        self._th = threading.Thread(target=self._loop, daemon=True)
        self._th.start()

    def __exit__(self, *exc):
        if self._th is None:   # the window never began
            if self._prof is not None:
                self._prof.__exit__(*exc)
            return False
        self._stop.set()
        self._th.join()
        self.wall = time.perf_counter() - self.t0
        self.cpu = time.process_time() - self.cpu0
        if self._prof is not None:
            torch.cuda.synchronize()
            self._prof.step()
            self._prof.__exit__(None, None, None)
            spans = sorted((e.time_range.start, e.time_range.end)
                           for e in _on_card(self._prof))
            self.kernel_ms = sum(b - a for a, b in spans) / 1e3
            busy, end = 0.0, None
            for a, b in spans:
                if end is None or a > end:
                    busy += b - a
                    end = b
                elif b > end:
                    busy += b - end
                    end = b
            self.busy_ms = busy / 1e3
        return False

    def summary(self, top=10):
        n = max(self.ticks, 1)

        def rows(pick):
            return ", ".join(
                f"{role} {act} {c / n:.2f}" for (role, act), c in
                sorted(((k, c) for k, c in self.counts.items() if pick(k[1])),
                       key=lambda kc: -kc[1])[:top])

        dev = ("" if self.busy_ms is None else
               f"; torch.profiler started in {self.start_s:.2f} s before "
               f"the window; the card busy {self.busy_ms:.1f} ms "
               f"({self.busy_ms / 1e3 / self.wall:.3f} of the window), "
               f"kernels {self.kernel_ms:.1f} ms")
        return (f"{self.wall:.2f} s wall, process CPU {self.cpu:.2f} s "
                f"({self.cpu / self.wall:.2f} cores); {self.ticks} samples, "
                f"one every {1e3 * self.wall / n:.0f} ms (asked "
                f"{1e3 * self.INTERVAL_S:.0f}: the sampler waits for the "
                f"interpreter lock too); threads not in a wait "
                f"{self.running / n:.2f} a sample{dev}; "
                f"threads a sample, by role and activity, working: "
                f"{rows(lambda a: not a.startswith('wait '))}; waiting: "
                f"{rows(lambda a: a.startswith('wait '))}")


def _kill_drill(st, router, clock, victim, crash, tag):
    """Kill ``victim`` (beta's generate primary) under mixed load, with
    the router's heartbeat polling every CLUSTER_BEAT_S, and time the
    failover: from the kill to beta's first success after the victim's
    listener refused a connection (so it came from the survivor). ``crash=False`` is ReplicaHandle.kill alone, the
    reference's: the listener closes, then the fleet's shutdown drains
    what the replica had admitted, on this process's card and interpreter.
    ``crash=True`` is what a crashed process leaves: the listener closes
    and the replica's queued work is cancelled (its engines and batcher
    shut down without a drain, typed), then the same kill, with nothing
    left to drain. Answers correct or typed (no raw 500), membership marks
    the victim dead, placement re-plans; the window traced
    (``_HostTrace``, with the card's kernel time)."""
    import socket

    port = router.port
    survivor = next(r for r in router.candidates("beta") if r != victim)
    first, attempts, kill_s = {}, [], {}
    h = st["handles"][victim]
    vport = int(h.base_url.rsplit(":", 1)[1])

    def probe():
        while "ok" not in first:
            try:
                code, body, _ = _routed(
                    port, "/v1/models/beta/generate?stream=false",
                    {"prompt": st["gen_prompt"].tolist(),
                     "max_new_tokens": FLEET_GEN_TOKENS,
                     "temperature": 0.0}, "standard")
            except OSError as e:
                attempts.append(type(e).__name__)
                continue
            attempts.append(code if code == 200 else body.get("cause"))
            if code == 200 and body["tokens"] == st["gen_want"]:
                first["ok"] = time.perf_counter()

    def kill():
        t0 = time.perf_counter()
        if crash:
            h.server.stop(drain=False)
            for name in h.fleet.names():
                for _, comp in h.fleet.get(name).components():
                    comp.shutdown(drain=False)
            kill_s["cancel"] = time.perf_counter() - t0
        h.kill()
        kill_s["s"] = time.perf_counter() - t0

    def beats():
        # the router's heartbeat, parked for the drills, runs for the
        # window: a failed hop demotes a replica to suspect, and only a
        # beat makes a live one alive again
        while not beat_stop.wait(CLUSTER_BEAT_S):
            try:
                router.poll_once()
            except Exception as e:  # reported after the window
                beat_errors.append(repr(e))

    stop, out, beat_stop = threading.Event(), [], threading.Event()
    beat_errors = []
    beater = threading.Thread(target=beats, daemon=True)
    # the profiler starts before the load, the traced window at the kill
    with _HostTrace(st, router, device=True, begin_later=True) as trace:
        threads = _mixed_load(port, st, stop, out)
        beater.start()
        time.sleep(1.0)
        before = len(out)
        trace.begin()
        t_kill = time.perf_counter()
        killer = threading.Thread(target=kill, daemon=True)
        killer.start()
        while True:
            try:
                socket.create_connection(("127.0.0.1", vport),
                                         timeout=1.0).close()
            except OSError:
                break
            time.sleep(0.01)
        t_refused = time.perf_counter()
        pr = threading.Thread(target=probe, daemon=True)
        pr.start()
        pr.join(timeout=300)
        killer.join(timeout=300)
    beat_stop.set()
    beater.join(timeout=300)
    check(not beat_errors, f"[cluster] {tag}: heartbeat polls raised "
          f"{beat_errors[:3]}")
    check(not killer.is_alive(), f"[cluster] {tag}: the kill did not return")
    if "ok" not in first:  # where every thread waits, for the record
        import faulthandler

        faulthandler.dump_traceback(all_threads=True)
    check("ok" in first, f"[cluster] {tag}: beta never served again; the "
          f"probe's attempts {collections.Counter(map(str, attempts))}, "
          f"the load's outcomes after the kill "
          f"{collections.Counter((o[0], o[1], str(o[2])) for o in out[before:])}"
          f", membership {dict((r, router.membership.state(r)) for r in router.membership.ids())}")
    stop.set()
    for th in threads:
        th.join(timeout=300)
        check(not th.is_alive(), f"[cluster] {tag}: a client thread hung")
    _typed_or_correct(out, tag)
    clock.skew += CLUSTER_DEAD_S
    states = router.poll_once()
    check(states.get(victim) == "dead", f"[cluster] {tag}: membership "
          f"{states}")
    cands = router.candidates("beta")
    check(victim not in cands and survivor in cands,
          f"[cluster] {tag}: beta's candidates {cands}")
    ins = [r for r in st["handles"][survivor].fleet.get("beta").page_log
           if r["kind"] == "page_in"]
    codes = collections.Counter(o[1] for o in out[before:])
    failover = first["ok"] - t_kill
    how = ("crash (listener closed, queued work cancelled "
           f"in {kill_s['cancel']:.2f} s, then ReplicaHandle.kill)" if crash
           else "ReplicaHandle.kill (listener closed, admitted work drained)")
    print(f"[cluster] {tag}: killed {victim} (beta's primary) under load by "
          f"{how}: {len(out)} answers, after the kill {dict(codes)}; every "
          f"one correct or typed; failover {1e3 * failover:.1f} ms from the "
          f"kill to beta's first success on {survivor} (the listener "
          f"refused after {1e3 * (t_refused - t_kill):.1f} ms; the kill "
          f"returned after {kill_s['s']:.2f} s; the probe's attempts "
          f"{attempts}); {victim} dead, placement {router.candidates('alpha')}"
          f" / {cands}; beta page-ins on {survivor}: "
          + ", ".join(f"{1e3 * r['seconds']:.1f} ms" for r in ins)
          + f"; {st['where']}")
    print(f"[cluster] {tag} window (kill to failover and the kill's "
          f"return): {trace.summary()}; {st['where']}")
    return {"victim": victim, "survivor": survivor,
            "failover_ms": 1e3 * failover, "kill_s": kill_s["s"]}


def cluster_kill(st, router, clock, factory):
    """C: kill beta's generate primary twice under mixed load. C1 with
    ReplicaHandle.kill (the reference's: its fleet shutdown drains the
    admitted work); then a replacement replica joins and C2 kills beta's
    new primary as a crash does (queued work cancelled first). Each:
    answers correct or typed, the victim dead, placement re-planned, beta
    served again from a survivor after a page-in. Then the card still
    synchronizes and K1 still agrees with its plain version at the
    cluster's shapes."""
    c1 = _kill_drill(st, router, clock, router.candidates("beta")[0],
                     crash=False, tag="C1")
    t0 = time.perf_counter()
    h = factory("r3")
    router.add_replica("r3", h.base_url)
    router.poll_once()
    spawn_s = time.perf_counter() - t0
    print(f"[cluster] C: replacement r3 joined in {spawn_s:.2f} s, beta's "
          f"candidates {router.candidates('beta')}; {st['where']}")
    c2 = _kill_drill(st, router, clock, router.candidates("beta")[0],
                     crash=True, tag="C2")
    torch.cuda.synchronize()
    err = _k1_check_on_card(st, "[cluster] C")
    print(f"[cluster] C: failover with the drain {c1['failover_ms']:.1f} ms, "
          f"without it {c2['failover_ms']:.1f} ms; synchronize ok; K1 vs "
          f"plain at the cluster's shapes (BH 32, 64, 128 x T "
          f"{CLUSTER_SHORT_T}, {CLUSTER_LONG_T}, D 64, bf16, causal) max abs "
          f"err {err:.3g}; {st['where']}")
    return {"dead": sorted([c1["victim"], c2["victim"]]),
            "failover_ms": c1["failover_ms"],
            "failover_crash_ms": c2["failover_ms"]}


def _checked_target(*args, **kw):
    """A RouterTarget that keeps every answer, so that the replayed
    predicts are checked against the direct forward afterwards."""
    from deeplearning4j_torch.sim import RouterTarget

    class CheckedTarget(RouterTarget):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seen = []
            self._seen_lock = threading.Lock()

        def _post(self, path, body, tenant):
            status, payload = super()._post(path, body, tenant)
            with self._seen_lock:
                self.seen.append((path, body, status, payload))
            return status, payload

    return CheckedTarget(*args, **kw)


def _replay_spec(rate, seed=0):
    """smoke_spec's shape at the card's widths: lognormal prompts up to the
    model's 1024 tokens, Pareto outputs up to 64, vocab 32000; gold,
    standard and batch tenants; alpha predict-only, beta half generate;
    bursts of 2.5x the base rate, in real time."""
    from deeplearning4j_torch.sim import LengthDist, WorkloadSpec

    return WorkloadSpec(
        seed=seed, duration_s=CLUSTER_REPLAY_S, base_rate_rps=rate,
        diurnal_amplitude=0.6, diurnal_period_s=CLUSTER_REPLAY_S,
        diurnal_phase=-0.25, burst_rate_mult=2.5, burst_mean_on_s=6.0,
        burst_mean_off_s=10.0,
        prompt_len=LengthDist("lognormal", 96.0, 0.7, 1024),
        output_len=LengthDist("pareto", 8.0, 1.6, 64),
        vocab=CLUSTER_VOCAB, time_scale=1.0,
        tenants={"gold": {"weight": 0.5, "slo": "gold"},
                 "standard": {"weight": 0.35, "slo": "standard"},
                 "batch": {"weight": 0.15, "slo": "batch"}},
        models={"alpha": {"weight": 0.6, "generate_frac": 0.0},
                "beta": {"weight": 0.4, "generate_frac": 0.5}})


def _closed_loop_rate(router):
    """Completed requests a second that the live replicas sustain at the
    replay's mix, closed loop (each client sends its next event when its
    last answered), over a window of at least CLUSTER_CLOSED_S that runs
    on until CLUSTER_CLOSED_N successes (CLUSTER_CLOSED_MAX_S at most; 20
    at least, or the phase fails); the queue depths their beats reported,
    and the typed sheds."""
    from deeplearning4j_torch.sim import (TYPED_CAUSES, RouterTarget,
                                          generate_trace)

    target = RouterTarget("127.0.0.1", router.port,
                          input_len=CLUSTER_SHORT_T, vocab=CLUSTER_VOCAB,
                          timeout_s=300.0)
    events = list(generate_trace(_replay_spec(4.0, seed=1)))
    done, lock, stop = [], threading.Lock(), threading.Event()

    def client(i):
        k = i
        while not stop.is_set():
            ev = events[k % len(events)]
            o = (target.generate(ev) if ev.kind == "generate"
                 else target.predict(ev))
            with lock:
                done.append(o)
            k += CLUSTER_CLOSED_THREADS

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(CLUSTER_CLOSED_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    depths = []
    while True:
        time.sleep(1.0)
        router.poll_once()
        depths.append(sum(int(router.membership.payload(r).get(
            "queue_depth") or 0) for r in router.membership.ids()))
        el = time.perf_counter() - t0
        with lock:
            n_ok = sum(o.ok for o in done)
        if el >= CLUSTER_CLOSED_MAX_S or (el >= CLUSTER_CLOSED_S
                                          and n_ok >= CLUSTER_CLOSED_N):
            break
    with lock:
        n = len(done)
        t1 = time.perf_counter()
    stop.set()
    for th in threads:
        th.join(timeout=300)
    bad = [o for o in done if not o.ok and o.cause not in TYPED_CAUSES]
    check(not bad, f"[cluster] D: closed loop failures {bad[:3]}")
    ok = sum(o.ok for o in done[:n])
    check(ok >= 20, f"[cluster] D: the closed loop "
          f"completed {ok} requests in {t1 - t0:.1f} s")
    shed = collections.Counter(o.cause for o in done[:n] if not o.ok)
    return {"rate": ok / (t1 - t0), "ok": ok, "seconds": t1 - t0,
            "depths": depths, "shed": dict(shed)}


def _promcheck(body, what):
    """Hold a /metrics body to obs.promcheck: no finding."""
    from deeplearning4j_torch.obs.promcheck import check_text

    findings = check_text(body)
    check(findings == [], f"{what}: promcheck {findings[:5]}")
    return len(body)


def _plain_get(port, path):
    """(status, body text) of one GET to 127.0.0.1:``port``."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _telemetry_plane(router, clock):
    """The cluster telemetry plane on the drill's clock: a TimeSeriesStore,
    the default AlertEngine with a capturing notifier, and a
    FederatedScraper attached as ``router.telemetry``; driven by hand (no
    background thread)."""
    from deeplearning4j_torch.obs import (AlertEngine, FederatedScraper,
                                          TimeSeriesStore)

    class Capture:
        channel = "capture"

        def __init__(self):
            self.events = []

        def notify(self, event):
            self.events.append(event)

    store = TimeSeriesStore(clock=clock, metrics=router.metrics)
    cap = Capture()
    engine = AlertEngine(store, metrics=router.metrics, clock=clock,
                         notifiers=(cap,), renotify_s=3600.0)
    scraper = FederatedScraper(router, store, alerts=engine, clock=clock)
    check(router.telemetry is scraper, "[cluster] the scraper is not "
          "attached as router.telemetry")
    return scraper, engine, cap


def cluster_telemetry(st, router, clock, plane):
    """F (after C): the telemetry drill of the reference's
    scripts/smoke_cluster.py, on the skewable clock. The alive replicas
    partitioned at the ``cluster.transport`` seam: the scrape reports
    them ``error`` (soft-staled) and the dead ones ``stale``, never a
    crash; replica_dead fires; gold predicts shed typed (503) push the
    gold burn past 1: gold_burn_high pending, still pending 10 s later,
    firing past its 20 s sustain, on GET /v1/alerts, one notification,
    its history on GET /v1/tsdb; healed (the partition lifted, the burn
    window aged out, good gold traffic on every model), it resolves once.
    The router's and a replica's /metrics pass promcheck."""
    from deeplearning4j_torch.chaos import faults

    scraper, engine, cap = plane
    t0 = time.perf_counter()
    port = router.port
    router.poll_once()
    alive = sorted(r for r in router.membership.ids()
                   if router.membership.state(r) == "alive")
    dead = sorted(r for r in router.membership.ids()
                  if router.membership.state(r) == "dead")
    plane_f = faults.install(faults.FaultPlane(seed=0,
                                               metrics=router.metrics))
    try:
        for rid in alive:
            plane_f.inject_spec(f"cluster.transport:error:type=connection,"
                                f"scope={rid},times=-1")
        outcomes = scraper.scrape_once()
        check(outcomes["router"] == "ok"
              and all(outcomes[r] == "error" for r in alive)
              and all(outcomes[r] == "stale" for r in dead),
              f"[cluster] F: partitioned scrape {outcomes} (alive {alive}, "
              f"dead {dead})")
        check("replica_dead" in engine.active(), f"[cluster] F: active "
              f"{engine.active()}")
        shed = []
        for j in range(2):
            code, body, _ = _routed(port, "/v1/models/alpha/predict",
                                    {"ndarray": st["prompts"][j].tolist()},
                                    "gold")
            shed.append((code, body.get("cause")))
        check(all(c == (503, "upstream_unreachable") for c in shed),
              f"[cluster] F: gold predicts behind the partition {shed}")
        states = []
        for skew in (0.0, 10.0, 11.0):
            clock.skew += skew
            scraper.scrape_once()
            states.append(engine.snapshot()["rules"]["gold_burn_high"]
                          ["state"])
        check(states == ["pending", "pending", "firing"],
              f"[cluster] F: gold_burn_high {states} at +0, +10, +21 s")
        code, body = _plain_get(port, "/v1/alerts")
        view = json.loads(body)
        check(code == 200 and view["rules"]["gold_burn_high"]["state"]
              == "firing", f"[cluster] F: GET /v1/alerts {code}")
        engine.evaluate()  # still firing: deduplicated, not paged again
        fired = [e for e in cap.events if e["rule"] == "gold_burn_high"
                 and e["state"] == "firing"]
        check(len(fired) == 1, f"[cluster] F: {len(fired)} firing "
              f"notifications")
        code, body = _plain_get(
            port, "/v1/tsdb?name=fleet_slo_burn_rate&label.slo_class=gold"
                  "&label.window=1m")
        hist = json.loads(body)
        check(code == 200 and hist["series"]
              and all(sr["points"] for sr in hist["series"]),
              f"[cluster] F: GET /v1/tsdb {code} {body[:200]}")
        peak_burn = max(pt[1] for sr in hist["series"]
                        for pt in sr["points"])
        code, body = _plain_get(port, "/v1/tsdb")
        families = json.loads(body)
        check(code == 200 and "fleet_slo_burn_rate" in families["families"],
              f"[cluster] F: GET /v1/tsdb (families) {code}")
    finally:
        faults.uninstall()
    # heal: the partition lifted, the bad outcomes aged out of the 1 m
    # window, leases renewed, good gold traffic on every model refreshes
    # the gauges (a burn gauge moves only when its subject records an
    # outcome: C's gold sheds on beta can leave beta's gauge high)
    clock.skew += 61.0
    router.poll_once()
    for name in CLUSTER_NAMES:
        for j in range(5):
            code, body, _ = _routed(
                port, f"/v1/models/{name}/predict",
                {"ndarray": st["prompts"][j % 2].tolist()}, "gold")
            check(code == 200 and _answer_ok(st["refs"], name, j % 2, body),
                  f"[cluster] F: gold predict on {name} after the heal "
                  f"answered {code}")
    outcomes = scraper.scrape_once()
    view = json.loads(_plain_get(port, "/v1/alerts")[1])
    gb = [f for f in view["firings"] if f["rule"] == "gold_burn_high"]
    resolved = [e for e in cap.events if e["rule"] == "gold_burn_high"
                and e["state"] == "resolved"]
    check(all(outcomes[r] == "ok" for r in alive)
          and view["rules"]["gold_burn_high"]["state"] == "ok"
          and gb and gb[-1]["resolved_at_s"] is not None
          and len(resolved) == 1
          and resolved[0]["dedup_key"] == fired[0]["dedup_key"],
          f"[cluster] F: after the heal {outcomes}, gold_burn_high "
          f"{view['rules']['gold_burn_high']}, resolutions {len(resolved)}")
    code, body = _plain_get(port, "/metrics")
    sizes = {"router": _promcheck(body, "[cluster] F: the router's /metrics")}
    for rid in alive:
        rport = int(st["handles"][rid].base_url.rsplit(":", 1)[1])
        code, body = _plain_get(rport, "/metrics")
        check(code == 200, f"[cluster] F: {rid} /metrics {code}")
        sizes[rid] = _promcheck(body, f"[cluster] F: {rid}'s /metrics")
    stats = scraper.store.stats()
    print(f"[cluster] F: telemetry plane (FederatedScraper as "
          f"router.telemetry, TimeSeriesStore, AlertEngine with the default "
          f"rules, on the drill's clock): {alive} partitioned at "
          f"cluster.transport -> scraped error, {dead} stale, replica_dead "
          f"firing; gold predicts shed {shed}; gold_burn_high {states} at "
          f"+0/+10/+21 s (peak 1m burn {peak_burn:.2f}), one firing "
          f"notification; GET /v1/alerts and /v1/tsdb 200; healed: scrape "
          f"{outcomes}, gold_burn_high resolved once; store {stats}; "
          f"/metrics bytes {sizes} pass promcheck; "
          f"{time.perf_counter() - t0:.1f} s; {st['where']}")
    return {"states": states, "peak_burn": peak_burn}


class _ScrapedForecaster:
    """The autoscaler's forecaster for the replay: each controller tick's
    first call scrapes the cluster into the scraper's store, then every
    class is forecast from it by a ``BurnForecaster``."""

    def __init__(self, scraper, forecaster, clock):
        self.scraper, self.forecaster, self._clock = scraper, forecaster, clock
        self._last = None
        self.scrapes = 0

    def forecast_burn(self, slo_class):
        t = self._clock()
        if self._last is None or t - self._last >= 0.5:
            self._last = t
            self.scraper.scrape_once(now=t)
            self.scrapes += 1
        return self.forecaster.forecast_burn(slo_class)


def cluster_autoscale(st, router, clock, factory, dead):
    """D: the AutoscaleController adopts the replicas, the dead ones
    included: its first tick reaps the corpses and repairs the floor of
    two (``below_min``). Then the closed-loop rate two replicas sustain at
    the replay's mix; a WorkloadSpec at 0.6x that rate with 2.5x bursts,
    replayed open loop through RouterTarget by LiveReplayer while the
    controller ticks every second: it scales out on the burst (spawn,
    prewarm page-ins, first beat); once the traffic ends it scales in one
    replica through /v1/admin/drain with requests in flight. Every outcome
    typed or correct."""
    import random as _random

    from deeplearning4j_torch.autoscale import (AutoscaleController,
                                                AutoscalePolicy)
    from deeplearning4j_torch.sim import LiveReplayer, generate_trace
    from deeplearning4j_torch.sim.workload import _burst_windows

    # the policy's SLO burn thresholds (the router's per-class burn: a
    # request shed on its deadline counts against the budget, wherever it
    # waited) and queue watermarks of 2 and 0.5 a replica (the replicas'
    # own queues stay short while requests wait on this process's host
    # work, so the queue alone sees little of the load); ticks come about
    # a second apart
    policy = AutoscalePolicy(min_replicas=2, max_replicas=3,
                             sustain_out_s=1.0, sustain_in_s=3.0,
                             cooldown_out_s=10.0, cooldown_in_s=5.0,
                             queue_high=2.0, queue_low=0.5)
    # the replay's burn forecast: one season is the replayed day
    # (CLUSTER_REPLAY_S), the horizon 5 s, over a store of the replay's own
    # scrapes: F's burn spike, in the plane's store, forecast as a coming
    # breach and pre-spawned a replica 4 s into an idle replay. The router
    # keeps the plane as its telemetry.
    from deeplearning4j_torch.obs import (BurnForecaster, FederatedScraper,
                                          MetricsRegistry, TimeSeriesStore)

    plane = router.telemetry
    store = TimeSeriesStore(clock=clock)
    forecaster = _ScrapedForecaster(
        FederatedScraper(router, store, clock=clock,
                         metrics=MetricsRegistry()),
        BurnForecaster(store, season_s=CLUSTER_REPLAY_S, horizon_s=5.0,
                       metrics=router.metrics), clock)
    router.telemetry = plane
    ctl = AutoscaleController(router, factory, policy=policy, clock=clock,
                              beat_wait_s=10.0)
    for rid in router.membership.ids():
        ctl.adopt(rid, st["handles"][rid])
    d = ctl.tick()
    first = json.loads(ctl.decision_log[0])
    check((d.direction, d.reason) == ("out", "below_min")
          and sorted(first["retired"]) == dead and first["actuated"] == 1,
          f"[cluster] D: first tick {first}")
    closed = _closed_loop_rate(router)
    rate = closed["rate"]
    # the closed loop's outcomes leave the burn window before the replay
    clock.skew += 61.0
    router.poll_once()
    spec = _replay_spec(0.6 * rate)
    trace = generate_trace(spec)
    bursts = _burst_windows(_random.Random(spec.seed), spec)
    print(f"[cluster] D: tick 0 reaped {dead} and spawned "
          f"{ctl.snapshot()['managed']} (below_min); the closed loop "
          f"({CLUSTER_CLOSED_THREADS} clients, {closed['seconds']:.1f} s, "
          f"{closed['ok']} answered, shed {closed['shed']}) sustains "
          f"{rate:.3f} requests/s on two replicas; summed queue depths "
          f"{closed['depths']}; replaying {len(trace)} events at base "
          f"{0.6 * rate:.3f}/s, bursts x2.5 at "
          f"{[(round(a, 1), round(b, 1)) for a, b in bursts]} s, workload "
          f"{spec.fingerprint()}; {st['where']}")
    target = _checked_target("127.0.0.1", router.port,
                             input_len=CLUSTER_SHORT_T, vocab=CLUSTER_VOCAB,
                             timeout_s=300.0, autoscaler=ctl)
    t_replay = clock()
    ctl.forecaster = forecaster   # the replay's ticks forecast
    ctl.start(interval_s=1.0)
    try:
        report = LiveReplayer(trace, target, join_timeout_s=600.0).run()
    finally:
        ctl.stop()
        ctl.forecaster = None
    check(report["untyped_errors"] == 0 and report["requests"] == len(
        trace), f"[cluster] D: replay shed {report['shed']}, "
        f"{report['untyped_errors']} untyped")
    outs = [json.loads(ln) for ln in ctl.decision_log]
    # a confident forecast pre-spawns ("forecast"): a scale-out on the
    # load too
    outs = [o for o in outs if o["actuated"] and o["decision"]["direction"]
            == "out" and o["decision"]["reason"] in ("burn", "queue",
                                                     "forecast")]
    fc_trig = [json.loads(ln)["decision"] for ln in ctl.decision_log]
    fc_trig = [d for d in fc_trig if d["reason"] == "forecast"
               or d["evidence"].get("trigger") == "forecast"]
    fc_reqs = {tuple(sorted(sr["labels"].items())): sr["value"]
               for sr in router.metrics.snapshot().get(
                   "forecast_requests_total", {}).get("series", [])}
    check(outs and ctl.replica_stats()["max"] == 3,
          "[cluster] D: no scale-out under the replay; decisions:\n"
          + "\n".join(ctl.decision_log))
    t_out = outs[0]["decision"]["evidence"]["t"] - t_replay
    in_burst = any(a <= t_out < b for a, b in bursts)
    # offered rate (diurnal, and 2.5x inside a burst) where it scaled out
    offered = spec.rate_at(t_out) * (spec.burst_rate_mult if in_burst
                                     else 1.0)
    # scale-in: the traffic is over, the burn window aged out
    clock.skew += 61.0
    router.poll_once()
    stop, inflight = threading.Event(), []
    threads = _mixed_load(router.port, st, stop, inflight)
    t_in = None
    for _ in range(12):
        if ctl.replica_stats()["final"] <= 2:
            break
        clock.skew += 1.0
        t0 = time.perf_counter()
        d = ctl.tick()
        if d.direction == "in":
            t_in = time.perf_counter() - t0
    time.sleep(1.0)
    stop.set()
    for th in threads:
        th.join(timeout=300)
        check(not th.is_alive(), "[cluster] D: a client thread hung")
    _typed_or_correct(inflight, "D scale-in")
    check(ctl.replica_stats()["final"] == 2 and t_in is not None,
          "[cluster] D: no scale-in; decisions:\n"
          + "\n".join(ctl.decision_log))
    drains = router.metrics.counter("autoscale_drains_total",
                                    {"outcome": "ok"}).value
    check(drains >= 1, f"[cluster] D: {drains} drains answered 200")
    with _off_path(st):   # the references' forwards
        wrong = _replay_wrong(st, target.seen)
    check(wrong == 0, f"[cluster] D: {wrong} wrong replayed predicts")
    hist = router.metrics.histogram("autoscale_scale_seconds",
                                    {"direction": "out"})
    n_pred = sum(1 for s in target.seen if "predict" in s[0])
    print(f"[cluster] D: replay {report['requests']} requests, completed "
          f"{report['completed']}, shed {report['shed']}, untyped "
          f"{report['untyped_errors']}, latency p50 "
          f"{report['latency_ms']['p50']:.1f} ms p99 "
          f"{report['latency_ms']['p99']:.1f} ms, replicas "
          f"{report.get('replicas')}; first scale-out at {t_out:.1f} s of "
          f"the replay ({'in' if in_burst else 'outside'} a burst, on "
          f"{outs[0]['decision']['reason']}: burn "
          f"{outs[0]['decision']['evidence']['burn']}, summed queue "
          f"{outs[0]['decision']['evidence']['queue_depth']}; offered "
          f"{offered:.3f}/s there, against the closed-loop {rate:.3f}/s); "
          f"scale-out (spawn, prewarm, first beat) "
          f"{hist.sum / max(hist.count, 1):.2f} s mean of {hist.count}; "
          f"scale-in (drain, stop) {t_in:.2f} s with {len(inflight)} "
          f"answers in flight, all correct or typed; 0 wrong of {n_pred} "
          f"replayed predicts; {st['where']}")
    print(f"[cluster] D: BurnForecaster (season {CLUSTER_REPLAY_S:.0f} s, "
          f"horizon 5 s) over {forecaster.scrapes} scrapes of the replay: "
          f"forecasts by outcome {fc_reqs}; decisions that took the "
          f"forecast trigger: {len(fc_trig)} "
          f"{[(d['direction'], d['reason']) for d in fc_trig]}; "
          f"{st['where']}")
    print("[cluster] D: decision log:")
    for ln in ctl.decision_log:
        d = json.loads(ln)
        print(f"  tick {d['tick']}: {d['decision']['direction']} "
              f"{d['decision']['reason']} actuated {d['actuated']} current "
              f"{d['current']} actual {d['actual']} retired {d['retired']} "
              f"evidence {json.dumps(d['decision']['evidence'])}")
    return {"trace": trace, "report": report, "forecast_decisions":
            len(fc_trig)}


def _replay_wrong(st, seen):
    """Replayed predicts whose answer is not the direct forward of their
    16-token input at some bucket and row position."""
    wrong = 0
    cache = {}
    for path, body, status, payload in seen:
        if "predict" not in path or status != 200:
            continue
        name = path.split("/")[3]
        x = np.asarray(body["ndarray"], np.int32)[None]
        key = (name, x.tobytes())
        if key not in cache:
            cache[key] = _fleet_refs(st["models"][name], [x])[0]
        refs = cache[key]
        out = np.asarray(payload["output"], np.float32)[0]
        wrong += not any(np.array_equal(out, r) for b in CLUSTER_BUCKETS
                         for r in refs[(0, b)])
    return wrong


def cluster_tune(st, router, trace, aot_dir, factory_tuned,
                 eager_batches):
    """E: the card's cost profile from the [aot] store calibrates the
    CostModel; a seeded Tuner search over the replayed workload; the
    winner recorded; a store prebuilt for the winner's knobs while r1/r2
    serve; a strict replica booted with tuned_for= under load, its knobs
    the winner's and 0 compiles on covered signatures; the winner's
    autoscale group read by AutoscalePolicy.from_config. Returns the
    strict replica's predict batches (each a graph replay)."""
    from deeplearning4j_torch.aot import AotStore, get_tuned
    from deeplearning4j_torch.autoscale import AutoscalePolicy
    from deeplearning4j_torch.obs.costmodel import get_profile
    from deeplearning4j_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_torch.serve.continuous import gen_opts_from_config
    from deeplearning4j_torch.serve.engine import ENGINE_KNOBS
    from deeplearning4j_torch.sim import CostModel, Tuner, record_winner

    store = AotStore(os.path.join(aot_dir, "store"))
    m = MetricsRegistry()
    profile = get_profile(store, _aot_model_fp(), metrics=m)
    check(profile is not None and m.counter(
        "profile_store_hits_total").value == 1,
        "[cluster] E: no cost profile in the [aot] store")
    cm = CostModel.from_profile(profile)
    base = {"engine": {"batch_buckets": list(CLUSTER_BUCKETS),
                       "length_buckets": list(CLUSTER_TUNE_LENGTHS)},
            "gen": {"capacity": GEN_CAPACITY, "kv": "paged", "seed": 0}}
    t0 = time.perf_counter()
    res = Tuner(trace, cost_model=cm, base=base, seed=0).search(
        candidates=8, eta=3, min_events=32)
    tune_s = time.perf_counter() - t0
    check(res.winner_score >= res.default_score,
          "[cluster] E: the winner scored below the default")
    key = record_winner(store, trace, res)
    check(key is not None, "[cluster] E: record_winner failed")
    fp = trace.fingerprint()
    print(f"[cluster] E: cost model from the card's profile "
          f"{dict(zip(cm._fields, cm))}; "
          f"tuner over {len(trace)} events: {res.evaluated} evaluations in "
          f"{tune_s:.2f} s, rungs {res.rungs}, winner score "
          f"{res.winner_score:.6f} (default {res.default_score:.6f}): "
          f"engine {res.winner['engine']}, gen {res.winner['gen']}; "
          f"{st['where']}")
    # prebuild the winner's serving config in a process of its own (as a
    # deployment prebuilds), then boot the strict replica here, both while
    # r1/r2 serve
    winner = res.winner
    config = {**_aot_config(),
              "engine": {k: v for k, v in winner["engine"].items()
                         if k in ENGINE_KNOBS},
              "gen": dict(winner["gen"])}
    cfg_path = os.path.join(aot_dir, "tuned_config.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    stop, bg = threading.Event(), []
    threads = _mixed_load(router.port, st, stop, bg, pause=2.0)
    k1 = _kernel_wrappers()["K1"]
    k0, b0 = k1.launches, eager_batches()
    boot = _HostTrace(st, router)
    try:
        t0 = time.perf_counter()
        pb = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_torch.aot", "--store",
             os.path.join(aot_dir, "store"), "--device", CLUSTER_DEVICE,
             "prebuild", "--config", cfg_path],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=AOT_TIMEOUT_S)
        prebuild_s = time.perf_counter() - t0
        check(pb.returncode == 0, f"[cluster] E: prebuild exited "
              f"{pb.returncode}:\n{pb.stdout[-3000:]}\n{pb.stderr[-3000:]}")
        report = json.loads(pb.stdout)
        with boot:
            t0 = time.perf_counter()
            h = factory_tuned("tuned", store, fp)
            for name in h.fleet.names():
                h.fleet.ensure(name)
            h.fleet.get("beta").batcher()  # the batcher's graphs, under load
            torch.cuda.synchronize()
            boot_s = time.perf_counter() - t0
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=300)
    _typed_or_correct(bg, "E (traffic during the prebuild and strict boot)")
    # K1 over the boot: 12 a batch of the traffic on the eager replicas,
    # and the strict page-ins' graph builds, off the path (their replays
    # are counted): what the reading leaves over the eager batches, held
    # to an eager warm-up and a capture (12 launches each) of every engine
    # graph of both models
    n_graphs = (len(winner["engine"]["batch_buckets"])
                * len(winner["engine"]["length_buckets"])
                * len(h.fleet.names()))
    bg_batches = eager_batches() - b0
    builds = k1.launches - k0 - 12 * bg_batches
    st["offpath"]["K1"] += builds
    check(builds == 2 * 12 * n_graphs,
          f"[cluster] E: K1 launched {k1.launches - k0} times during the "
          f"prebuild and boot for {bg_batches} eager batches: {builds} left "
          f"for {n_graphs} engine graphs, {2 * 12 * n_graphs} expected")
    want_engine = {k: v for k, v in winner["engine"].items()
                   if k in ENGINE_KNOBS}
    got_gen = dict(h.fleet.get("beta").gen_opts)
    want_gen = gen_opts_from_config(winner)
    sched = (got_gen.pop("scheduler", None), want_gen.pop("scheduler", None))
    check(h.fleet.get("alpha").engine_opts == want_engine
          and got_gen == want_gen
          and (sched[0] is None) == (sched[1] is None)
          and (sched[0] is None or (
              (sched[0].decode_chunks, sched[0].idle_chunks)
              == (sched[1].decode_chunks, sched[1].idle_chunks))),
          f"[cluster] E: tuned knobs {h.fleet.get('alpha').engine_opts} / "
          f"{got_gen}, winner {want_engine} / {want_gen}")
    # traffic straight to the strict replica: graph replays only
    hport = int(h.base_url.rsplit(":", 1)[1])
    before = k1.launches
    for j in range(CLUSTER_PROMPTS):
        for name in CLUSTER_NAMES:
            code, body, _ = _routed(hport, f"/v1/models/{name}/predict",
                                    {"ndarray": st["prompts"][j].tolist()},
                                    "gold")
            check(code == 200 and _answer_ok(st["refs"], name, j, body),
                  f"[cluster] E: the tuned replica's {name} answer {code}")
    code, body, _ = _routed(hport, "/v1/models/beta/generate?stream=false",
                            {"prompt": st["gen_prompt"].tolist(),
                             "max_new_tokens": FLEET_GEN_TOKENS,
                             "temperature": 0.0}, "standard")
    check(code == 200, f"[cluster] E: the tuned replica's generate {code}")
    check(k1.launches == before, f"[cluster] E: the strict replica "
          f"launched K1 eagerly ({k1.launches - before})")
    # the winner's batcher knobs chunk the prefill differently: its tokens
    # are held to the reference's under the gap rule (the teacher's full
    # forward launches K1 and is not on the path)
    with _off_path(st):
        lp = _teacher_logp(st["models"]["beta"], np.concatenate(
            [st["gen_prompt"], np.asarray(st["gen_want"][:-1], np.int32)]))
    met = _same_tokens(body["tokens"], st["gen_want"], lp,
                       len(st["gen_prompt"]),
                       "[cluster] E: the tuned replica's tokens",
                       GEN_GAP_TOL_BF16)
    snap = h.fleet.metrics.snapshot()

    def total(name):
        return sum(s["value"] for s in snap.get(name, {}).get("series", []))

    compiles = total("serve_compile_misses_total")
    batches = int(total("serve_batches_total"))
    check(compiles == 0 and total("serve_aot_hits_total") > 0,
          f"[cluster] E: strict replica compiles {compiles}, hits "
          f"{total('serve_aot_hits_total')}")
    check(h.fleet.metrics.counter("sim_tuned_config_hits_total").value == 1,
          "[cluster] E: the tuned config was not resolved at boot")
    pol = AutoscalePolicy.from_config(get_tuned(store, fp))
    check(pol.forecast_confidence == winner["autoscale"][
        "forecast_confidence"], "[cluster] E: from_config")
    router.add_replica("tuned", h.base_url)
    router.poll_once()
    print(f"[cluster] E: prebuild of the winner's config "
          f"{prebuild_s:.2f} s ({report['total_signatures']} signatures) "
          f"and the strict tuned boot of replica 'tuned' (tuned_for={fp}) "
          f"{boot_s:.2f} s, both while the replicas served {len(bg)} "
          f"answers, all correct or typed; K1 graph builds {builds} = "
          f"{builds / n_graphs:.1f} a graph x {n_graphs} engine graphs (an "
          f"eager warm-up and a capture, 12 layers each); its knobs are the "
          f"winner's; 0 compiles, "
          f"{int(total('serve_aot_hits_total'))} store hits, {batches} "
          f"predict batches replayed, tokens equal before a near-tie "
          f"{met[0]} of {FLEET_GEN_TOKENS}; policy from_config "
          f"forecast_confidence {pol.forecast_confidence}; {st['where']}")
    host_s = [sum(getattr(h.fleet.get(n), a) for n in h.fleet.names())
              for a in ("host_alloc_s", "host_fill_s")]
    print(f"[cluster] E: the strict boot under load traced: "
          f"{boot.summary()}; of it the new replica's pinned host copies "
          f"({_pinned_bytes(h)} B): allocation {host_s[0]:.2f} s, filling "
          f"{host_s[1]:.2f} s; {st['where']}")
    return batches


def _aot_model_fp():
    """The fingerprint [aot]'s strict server files its cost profile under:
    the serving config it prebuilt, canonical JSON."""
    import hashlib

    return hashlib.sha256(json.dumps(_aot_config(), sort_keys=True).encode()
                          ).hexdigest()[:16]


def _cluster_mem():
    return torch.cuda.max_memory_reserved(), torch.cuda.get_device_properties(
        0).total_memory


def _meminfo():
    """/proc/meminfo's MemTotal and MemAvailable, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                out[k] = int(v.split()[0]) * 1024
    return out


def phase_cluster(aot_dir=None):
    """[cluster]: two full-width CausalLMs (alpha, beta) on two replicas
    behind one ClusterRouter in this process, on the card: the reference
    pass, a hedge, a crash-kill under load, autoscaling under a replayed
    workload and a tuned strict boot (the drills of
    scripts/smoke_cluster.py and smoke_autoscale.py at full width).
    ``aot_dir`` is [aot]'s store directory (its cost profile); without
    one [aot] runs first. Returns every kernel's launches over the phase:
    K1's eager launches plus 12 a strict replay."""
    import random as _random
    import shutil
    import tempfile

    from deeplearning4j_torch.cluster import ClusterRouter

    own_dir = aot_dir is None
    if own_dir:
        aot_dir = tempfile.mkdtemp()
        phase_aot(aot_dir)
    where = card()
    mem = _meminfo()
    print(f"[cluster] host memory: MemTotal {mem['MemTotal']} B, "
          f"MemAvailable {mem['MemAvailable']} B; {where}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = cluster_build(where)
    st["offpath"] = collections.Counter()
    clock = _SkewClock()
    router = ClusterRouter(port=0, heartbeat_s=3600.0,
                           hedge_ms=CLUSTER_HEDGE_MS,
                           suspect_after_s=CLUSTER_SUSPECT_S,
                           dead_after_s=CLUSTER_DEAD_S, clock=clock,
                           jitter_rng=_random.Random(0))
    for tenant, kw in CLUSTER_TENANTS.items():
        router.tenants.register(tenant, **kw)
    for rid, h in st["handles"].items():
        router.add_replica(rid, h.base_url)
    router.start()

    def factory(rid):
        src = next(h for h in st["handles"].values() if h.alive())
        h = _cluster_replica(rid, _host_sources(src), st["budget"])
        st["handles"][rid] = h
        return h

    def factory_tuned(rid, store, fp):
        src = next(h for h in st["handles"].values() if h.alive())
        h = _cluster_replica(rid, _host_sources(src), st["budget"],
                             aot_store=store, strict_aot=True, tuned_for=fp)
        st["handles"][rid] = h
        return h

    def eager_batches():
        """Predict batches of every replica but the strict one."""
        return sum(
            int(sum(s["value"] for s in h.fleet.metrics.snapshot().get(
                "serve_batches_total", {}).get("series", [])))
            for rid, h in st["handles"].items() if rid != "tuned")

    wrappers = _kernel_wrappers()
    try:
        router.poll_once()
        plan = {n: router.candidates(n) for n in CLUSTER_NAMES}
        print(f"[cluster] router on 127.0.0.1:{router.port}, placement "
              f"{plan}")
        plane = _telemetry_plane(router, clock)
        outcomes = plane[0].scrape_once()
        check(outcomes == {"router": "ok", **{r: "ok" for r in
                                              st["handles"]}}
              and not plane[1].active(), f"[cluster] the healthy scrape "
              f"{outcomes}, alerts firing {plane[1].active()}")
        print(f"[cluster] telemetry plane attached: healthy scrape "
              f"{outcomes}, no alert firing; {where}")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        a = cluster_reference(st, router)
        router.hedge_ms = max(CLUSTER_HEDGE_MS, 3.0 * a["routed_p50_ms"])
        t1 = time.perf_counter()
        cluster_hedge(st, router)
        t2 = time.perf_counter()
        kill = cluster_kill(st, router, clock, factory)
        t3 = time.perf_counter()
        cluster_telemetry(st, router, clock, plane)
        t3f = time.perf_counter()
        d = cluster_autoscale(st, router, clock, factory, kill["dead"])
        t4 = time.perf_counter()
        strict = cluster_tune(st, router, d["trace"], aot_dir,
                              factory_tuned, eager_batches)
        t5 = time.perf_counter()
        print(f"[cluster] seconds: A {t1 - t0:.1f}, B {t2 - t1:.1f}, C "
              f"{t3 - t2:.1f}, F {t3f - t3:.1f}, D {t4 - t3f:.1f}, E "
              f"{t5 - t4:.1f}; {where}")
        read = {k: w.launches for k, w in wrappers.items()}
        n_eager = eager_batches()
        peak, total = _cluster_mem()
    finally:
        router.stop()
        for h in st["handles"].values():
            h.kill()
        if own_dir:
            shutil.rmtree(aot_dir, ignore_errors=True)
    # on the path: what the counters read less the launches read off it
    # (comparisons, the references' forwards, the strict graphs' builds)
    eager = {k: read[k] - st["offpath"][k] for k in read}
    check(eager["K1"] == 12 * n_eager, f"[cluster] K1 launched "
          f"{eager['K1']} times eagerly on the path ({read['K1']} read, "
          f"{st['offpath']['K1']} off it) for {n_eager} batches")
    check(all(v == 0 for k, v in eager.items() if k != "K1"),
          f"[cluster] kernels other than K1 launched: {eager}")
    check(peak < CLUSTER_MEM_SHARE * total, f"[cluster] peak reserved "
          f"{peak} B of {total} B")
    # a strict replay launches K1 inside its graph, 12 times, uncounted by
    # the wrapper: counted as [aot] counts them
    counts = dict(eager, K1=eager["K1"] + 12 * strict)
    check(counts["K1"] > 0, "[cluster] K1 never launched")
    pinned = {rid: _pinned_bytes(h) for rid, h in st["handles"].items()}
    print(f"[cluster] K1 {counts['K1']} = {eager['K1']} read eagerly "
          f"({read['K1']} on the counter less {st['offpath']['K1']} off the "
          f"path) = 12 x {n_eager} eager batches, + 12 x {strict} strict "
          f"replays; every other kernel 0; peak "
          f"reserved {peak} B of the card's {total} B "
          f"({peak / total:.3f}); pinned host bytes a replica {pinned}; "
          f"{where}")
    return counts


REC_LAYERS = 2                # the depth cut: 12 -> 2 layers at width 2048
REC_B, REC_T = 4, 1024
REC_BATCHES = 2               # batches a segment (one epoch each)
REC_SEGMENTS = 3
REC_RB_BATCHES = 4            # the rollback run's epoch; batch 2 poisoned
REC_ZIP_SAMPLE = 64 * 2**20   # the checkpoint's bytes both writers time


def _rec_lm(seed=0):
    """CausalLM(flash=True) at width 2048 (32 heads, vocab 32000, T 1024,
    bf16 compute) with the depth cut to REC_LAYERS."""
    from deeplearning4j_torch.models import CausalLM

    m = CausalLM(seed=seed, input_shape=(REC_T,), num_layers=REC_LAYERS,
                 d_model=2048, num_heads=32, vocab=32000, flash=True,
                 device="cuda").build()
    m.config.compute_dtype = "bfloat16"
    m.init(seed=seed)
    return m


def _rec_iter(n_batches, poison=None):
    """Random token batches (seed 3) with an all-ones label mask; the
    ``poison``-th batch carries a NaN in its mask, so its loss is NaN."""
    from deeplearning4j_torch.data import ArrayIterator

    rng = np.random.RandomState(3)
    n = REC_B * n_batches
    x = rng.randint(0, 32000, (n, REC_T)).astype(np.int32)
    y = rng.randint(0, 32000, (n, REC_T)).astype(np.int32)
    lm = np.ones((n, REC_T), np.float32)
    if poison is not None:
        lm[poison * REC_B, 5] = np.nan
    return ArrayIterator(x, y, batch_size=REC_B, labels_mask=lm)


def recovery_resume(tmp, where):
    """Three one-epoch segments of FaultTolerantFit; a train.segment fault
    preempts the run after segment 2, before its checkpoint lands; a fresh
    Trainer resumes from segment 1's checkpoint and finishes, its params
    and updater state bit-equal to an uninterrupted run's. Returns the
    steps run and the checkpoint's write and read seconds and bytes."""
    from deeplearning4j_torch.chaos import faults
    from deeplearning4j_torch.chaos.recovery import FaultTolerantFit
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.train import (Trainer, load_model,
                                            load_opt_state, save_model)

    with _deterministic() as caught:
        base = Trainer(_rec_lm())
        t0 = time.perf_counter()
        base.fit(_rec_iter(REC_BATCHES), epochs=REC_SEGMENTS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        want = [t.detach().clone()
                for t in tree_leaves((base.params, base.opt_state))]
        n_params = base.model.param_count()
        del base
        _release()
        d = os.path.join(tmp, "ckpt")
        plane = faults.install(faults.FaultPlane(seed=0))
        try:
            plane.inject_spec(
                "train.segment:error:type=runtime,scope=2,times=1")
            first = FaultTolerantFit(Trainer(_rec_lm()), d)
            t0 = time.perf_counter()
            try:
                first.fit(_rec_iter(REC_BATCHES), epochs=REC_SEGMENTS)
                preempted = False
            except RuntimeError as e:
                preempted = "train.segment" in str(e)
            preempt_s = time.perf_counter() - t0
        finally:
            faults.uninstall()
        check(preempted and first.completed_epochs() == 1,
              f"[recovery] preemption: raised {preempted}, completed "
              f"{first.completed_epochs()}")
        del first
        _release()
        resumed = FaultTolerantFit(Trainer(_rec_lm()), d)
        t0 = time.perf_counter()
        tr = resumed.fit(_rec_iter(REC_BATCHES), epochs=REC_SEGMENTS)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        got = tree_leaves((tr.params, tr.opt_state))
        same = len(got) == len(want) and all(
            torch.equal(a.detach(), b) for a, b in zip(got, want))
        diff = _max_diff([a.detach() for a in got], want)
    check(resumed.completed_epochs() == REC_SEGMENTS, "[recovery] resume")
    check(same, f"[recovery] resumed params and updater state differ from "
          f"the uninterrupted run's by up to {diff}; nondeterministic ops "
          f"{_nondeterministic(caught)}")
    # the checkpoint itself, written and read once more, timed
    path = os.path.join(tmp, "timed.zip")
    t0 = time.perf_counter()
    save_model(path, tr.model, params=tr.params, state=tr.state,
               opt_state=tr.opt_state)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    _, params, _ = load_model(path, device=tr.device)
    opt = load_opt_state(path, tr.opt_state)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    check(all(torch.equal(a, b.detach()) for a, b in zip(
        tree_leaves((params, opt)), tree_leaves((tr.params, tr.opt_state)))),
        "[recovery] the reloaded checkpoint differs")
    writers = recovery_zip_writers(tr, tmp)
    del tr, resumed, params, opt, want, got
    _release()
    steps = REC_BATCHES * (REC_SEGMENTS + 2 + 2)
    print(f"[recovery] CausalLM(flash=True) at width 2048, depth cut 12 -> "
          f"{REC_LAYERS} layers ({n_params} params), B {REC_B} x T {REC_T}, "
          f"bf16, adamw: uninterrupted {REC_SEGMENTS} segments "
          f"{fit_s:.2f} s; preempted at the train.segment seam after "
          f"segment 2 ({preempt_s:.2f} s), resumed from segment 1's "
          f"checkpoint by a fresh Trainer ({resume_s:.2f} s): params and "
          f"updater state bit-equal to the uninterrupted run's; checkpoint "
          f"{nbytes} B written in {write_s:.2f} s "
          f"({nbytes / write_s / 1e9:.2f} GB/s), read in {read_s:.2f} s "
          f"({nbytes / read_s / 1e9:.2f} GB/s); {where}")
    print(f"[recovery] the checkpoint's write: its {writers['bytes']} B "
          f"copied to host memory in {writers['d2h_s']:.2f} s "
          f"({writers['bytes'] / writers['d2h_s'] / 1e9:.2f} GB/s); on its "
          f"first {writers['sample_bytes']} B, one run each: "
          + ", ".join(f"{k} {v[0]:.3f} s "
                      f"({writers['sample_bytes'] / v[0] / 1e6:.1f} MB/s, "
                      f"{v[1]} B)" for k, v in writers["sample"].items())
          + f"; {where}")
    return steps


def recovery_zip_writers(tr, tmp):
    """The checkpoint write's stages: the trained params and updater state
    copied to host memory (the whole tree, as ``save_model`` does); then
    on the first REC_ZIP_SAMPLE bytes of those arrays, three writers of
    one params.npz member: the reference's (``np.savez`` into memory, then
    a deflated member), the same stored, and the port's
    (``serialization._save_npz``: ``np.savez`` streamed into a stored
    member). Returns the bytes, the copy's seconds and each writer's
    (seconds, file bytes)."""
    import io
    import zipfile

    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.train.serialization import _save_npz

    t0 = time.perf_counter()
    host = [t.detach().cpu().numpy()
            for t in tree_leaves((tr.params, tr.opt_state))]
    d2h_s = time.perf_counter() - t0
    sample, left = {}, REC_ZIP_SAMPLE
    for i, a in enumerate(host):
        if left <= 0:
            break
        flat = a.reshape(-1)[:left // a.itemsize]
        sample[str(i)] = flat
        left -= flat.nbytes

    def through_memory(path, kind):
        with zipfile.ZipFile(path, "w", kind) as zf:
            buf = io.BytesIO()
            np.savez(buf, **sample)
            zf.writestr("params.npz", buf.getvalue())

    def streamed(path):
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            _save_npz(zf, "params.npz", sample)

    out = {}
    for name, fn in (
            ("the reference's (in memory, deflated)",
             lambda p: through_memory(p, zipfile.ZIP_DEFLATED)),
            ("in memory, stored",
             lambda p: through_memory(p, zipfile.ZIP_STORED)),
            ("the port's (streamed, stored)", streamed)):
        path = os.path.join(tmp, "writer.zip")
        t0 = time.perf_counter()
        fn(path)
        out[name] = (time.perf_counter() - t0, os.path.getsize(path))
        os.remove(path)
    return {"bytes": sum(a.nbytes for a in host), "d2h_s": d2h_s,
            "sample_bytes": sum(a.nbytes for a in sample.values()),
            "sample": out}


def recovery_rollback(where):
    """A poisoned batch (a NaN in its label mask) gives a NaN loss;
    DivergenceListener(action="rollback") restores the last validated
    snapshot, scales the learning rate by 0.5 and training goes on with
    finite losses. Returns the steps run."""
    from deeplearning4j_torch.chaos.recovery import DivergenceListener
    from deeplearning4j_torch.ops.updaters import tree_leaves
    from deeplearning4j_torch.train import CollectScoresListener, Trainer

    tr = Trainer(_rec_lm())
    lst = DivergenceListener(action="rollback", snapshot_every=2)
    rec = CollectScoresListener()
    t0 = time.perf_counter()
    tr.fit(_rec_iter(REC_RB_BATCHES, poison=2), listeners=[lst, rec])
    tr.fit(_rec_iter(REC_RB_BATCHES), listeners=[lst, rec])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = [s for _, s in rec.scores]
    bad = [i for i, s in enumerate(losses) if not np.isfinite(s)]
    check(bad == [2] and lst.rollbacks == 1 and lst.lr_scale == 0.5,
          f"[recovery] rollback: non-finite at {bad}, rollbacks "
          f"{lst.rollbacks}, lr scale {lst.lr_scale}")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(tr.params)),
          "[recovery] non-finite params after the rollback")
    check(len(tr.opt_state) == 2 and tr.opt_state[1] == (),
          "[recovery] the updater state is not the chained structure")
    print(f"[recovery] poisoned batch 2 (a NaN in its label mask): losses "
          + " ".join(f"{s:.4f}" for s in losses)
          + f"; rolled back to the last validated snapshot, lr x "
          f"{lst.lr_scale}, {len(losses) - 3} finite losses after it; "
          f"{fit_s:.2f} s for {len(losses)} steps with a host snapshot "
          f"every 2; {where}")
    del tr
    _release()
    return len(losses)


def phase_recovery():
    """[recovery]: FaultTolerantFit preempted and resumed, and a NaN rolled
    back, on a 2-layer cut of the full-width CausalLM. Returns every
    kernel's launches over the phase: K1, K2 and K3 once a layer and
    step, every other 0."""
    import shutil
    import tempfile

    where = card()
    wrappers = _kernel_wrappers()
    _release()
    for w in wrappers.values():
        w.launches = 0
    tmp = tempfile.mkdtemp()
    try:
        steps = recovery_resume(tmp, where) + recovery_rollback(where)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {k: w.launches for k, w in wrappers.items()}
    want = REC_LAYERS * steps
    check(counts["K1"] == counts["K2"] == counts["K3"] == want,
          f"[recovery] K1-K3 launched {counts['K1']}, {counts['K2']}, "
          f"{counts['K3']}: want {want} ({REC_LAYERS} a step, {steps} steps)")
    check(all(v == 0 for k, v in counts.items()
              if k not in ("K1", "K2", "K3")),
          f"[recovery] other kernels launched: {counts}")
    print(f"[recovery] launches {counts} over {steps} steps; {where}")
    return counts


# --- [elastic]: ElasticTrainer's drills on the full-width CausalLM ---
EL_B, EL_T = 12, 256          # 12 rows divide by every width of 2..4; T cut
                              # from 1024 so three widths' graphs fit
EL_DP, EL_DP_MIN = 4, 2       # the ladder: start at 4, floor 2
EL_KILL_AT, EL_STEPS = 3, 6   # fit to 3, kill w1, fit to 6
EL_KILL = "elastic.step:error:scope=w1,times=1"
EL_T3_STEPS = 2               # the dp-2 trainer's steps after its restore
EL_SMALL_LAYERS = 2           # the other drills: [recovery]'s depth cut
EL_ACT_BYTES = 21 * 2**30 / 4096   # activations a token, read off a
                                   # Trainer step at 4 x 1024 (bf16, 12
                                   # layers, d 2048): an upper bound


def _el_lm(layers, seed=0):
    """CausalLM(flash=True) at width 2048 (32 heads, vocab 32000, bf16
    compute, adamw) at T EL_T with ``layers`` layers."""
    from deeplearning4j_torch.models import CausalLM

    m = CausalLM(seed=seed, input_shape=(EL_T,), num_layers=layers,
                 d_model=2048, num_heads=32, vocab=32000, flash=True,
                 device="cuda").build()
    m.config.compute_dtype = "bfloat16"
    m.init(seed=seed)
    return m


def _el_batch(step):
    """Step ``step``'s global batch: random tokens and labels, one of two
    batches by the step's parity (a pure function of the step, the replay
    contract of ElasticTrainer.fit; two batches, so the loss falls)."""
    rng = np.random.RandomState(7000 + step % 2)
    x = rng.randint(0, 32000, (EL_B, EL_T)).astype(np.int32)
    y = rng.randint(0, 32000, (EL_B, EL_T)).astype(np.int32)
    return x, y


def _el_devices(n):
    return [torch.device("cuda", torch.cuda.current_device())] * n


class _ElTally:
    """What one ElasticTrainer launches, read around its own methods: each
    width's kernels launched by its eager warm-up step and recorded in its
    graph's capture (the wrappers count both calls: a capture records the
    launches its replays make), and each replay with its width and its
    synchronized time."""

    def __init__(self, t, wrappers):
        self.eager = collections.Counter()
        self.captured = {}
        self.replays = []        # (width, ms)
        step, run = t._step, t._run

        def counted_step(d, *args, **kw):
            before = {k: w.launches for k, w in wrappers.items()}
            out = step(d, *args, **kw)
            delta = {k: w.launches - before[k] for k, w in wrappers.items()}
            if torch.cuda.is_current_stream_capturing():
                self.captured[d] = delta
            else:
                self.eager.update(delta)
            return out

        def timed_run(x, y):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(x, y)
            torch.cuda.synchronize()
            self.replays.append((t.dp, 1e3 * (time.perf_counter() - t0)))

        t._step, t._run = counted_step, timed_run

    def launches(self):
        """Every kernel's launches: the warm-up steps' plus each graph's
        captured launches times its replays."""
        out = collections.Counter(self.eager)
        for d, _ in self.replays:
            out.update(self.captured[d])
        return out

    def check(self, layers, what):
        """Gated: each width's graph records ``layers`` launches of K1-K3
        for each of its replicas, and so does its warm-up step; the
        replays' launches are ``layers`` x the widths of the steps run; no
        other kernel runs."""
        for d, got in self.captured.items():
            check(all(got[k] == layers * d for k in ("K1", "K2", "K3")),
                  f"[elastic] dp {d}'s graph captured {got}: want {layers} "
                  f"x {d} of K1-K3")
        widths = sum(d for d, _ in self.replays)
        got = self.launches()
        check(all(got[k] - self.eager[k] == layers * widths
                  for k in ("K1", "K2", "K3")),
              f"[elastic] {what}: replays launched {got} less the warm-ups' "
              f"{dict(self.eager)}; want {layers} x {widths} (the widths of "
              f"{len(self.replays)} steps) of K1-K3")
        check(self.eager["K1"] == layers * sum(self.captured)
              and all(v == 0 for k, v in got.items()
                      if k not in ("K1", "K2", "K3")),
              f"[elastic] {what}: warm-up launches {dict(self.eager)}, all "
              f"{dict(got)}")

    def summary(self):
        """K1's launches as warm-up + captured x replays, for the log."""
        eager = self.eager["K1"]
        return f"K1 {eager} + {self.launches()['K1'] - eager} replayed"

    def step_ms(self):
        """Median replay ms by width."""
        by = collections.defaultdict(list)
        for d, ms in self.replays:
            by[d].append(ms)
        return {d: statistics.median(v) for d, v in sorted(by.items())}


def _el_fit(t, steps, losses):
    """``t.fit`` one step at a time up to ``steps``, each loss read."""
    while t.iteration < steps:
        t.fit(_el_batch, t.iteration + 1)
        losses.append(t.final_loss())


def _el_snapshot(t):
    """The trainer's params and whole updater state, on the host."""
    from deeplearning4j_torch.ops.updaters import tree_leaves

    return ([p.detach().cpu() for p in tree_leaves(t.params)],
            [o.cpu() for o in tree_leaves(t.opt_state)])


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _el_reckon(n_params):
    """Bytes each width's graph pool should take (one replica's
    activations, its gradients, the bf16 copy of the params, the updater's
    new state and updates for one replica's blocks) and the trainer's
    static bytes (params, summed gradients, three widths' updater
    buffers)."""
    p4 = 4 * n_params
    pools = {d: EL_ACT_BYTES * EL_B // d * EL_T + p4 + n_params * 2
             + 3 * p4 // d for d in range(EL_DP_MIN, EL_DP + 1)}
    static = 2 * p4 + 3 * 2 * p4
    return pools, static


def elastic_plain_step(where):
    """One plain ``Trainer.fit`` step at EL_B x EL_T on the full-width
    model (after two warm-up steps): the comparison for the elastic
    widths' step times."""
    from deeplearning4j_torch.data import ArrayIterator
    from deeplearning4j_torch.train import Trainer

    m = _el_lm(12)
    tr = Trainer(m)
    x, y = _el_batch(0)
    tr.fit(ArrayIterator(np.repeat(x, 2, 0), np.repeat(y, 2, 0),
                         batch_size=EL_B))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.fit(ArrayIterator(x, y, batch_size=EL_B))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    print(f"[elastic] plain Trainer.fit, 12 x CausalLM at {EL_B} x {EL_T}: "
          f"one step {ms:.1f} ms, peak {peak / 2**30:.2f} GiB; {where}")
    del m, tr
    _release()
    return ms


def elastic_kill_drill(tmp, where, wrappers):
    """The full-width kill drill (see the module docstring). Returns the
    launches of its three trainers."""
    from deeplearning4j_torch.chaos import faults
    from deeplearning4j_torch.elastic import ElasticTrainer, latest
    from deeplearning4j_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_torch.train import orbax_io

    wd = os.path.join(tmp, "kill")
    print(f"[elastic] disk free under the workdir: "
          f"{shutil.disk_usage(tmp).free} bytes")
    m = _el_lm(12)
    n_params = m.param_count()
    pools, static = _el_reckon(n_params)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[elastic] reckoned before capture: static "
          f"{static / 2**30:.2f} GiB, pools "
          + ", ".join(f"dp {d} {b / 2**30:.2f} GiB" for d, b in pools.items())
          + f"; {(static + sum(pools.values())) / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB")
    check(static + sum(pools.values()) < 0.9 * total,
          "[elastic] three widths' pools do not fit the card")
    reg = MetricsRegistry()
    torch.cuda.reset_peak_memory_stats()
    t = ElasticTrainer(m, workdir=wd, dp=EL_DP, dp_min=EL_DP_MIN,
                       devices=_el_devices(EL_DP), seed=0, metrics=reg)
    tally = _ElTally(t, wrappers)
    for w in wrappers.values():
        w.launches = 0
    t.warm(*_el_batch(0))
    check(t.trace_count() == 0, "[elastic] captures counted at warm()")
    losses = []
    _el_fit(t, EL_KILL_AT, losses)
    faults.install(faults.FaultPlane(seed=0).inject_spec(EL_KILL))
    try:
        _el_fit(t, EL_STEPS, losses)
    finally:
        faults.uninstall()
    peak = torch.cuda.max_memory_allocated()
    info = latest(wd)
    log = [{k: r[k] for k in ("step", "from", "to", "cause", "bytes_moved",
                              "bytes_naive")} for r in t.resizes]
    check(t.dp == 3 and len(t.resizes) == 1
          and log[0]["from"] == 4 and log[0]["to"] == 3
          and log[0]["cause"] == "worker_death"
          and 0 < log[0]["bytes_moved"] < log[0]["bytes_naive"],
          f"[elastic] resize log {log}")
    check(info.dp == 3 and info.cause == "post_resize_worker_death"
          and info.step == log[0]["step"], f"[elastic] pointer {info}")
    check(t.trace_count() == 0, f"[elastic] {t.trace_count()} captures "
          f"after warm()")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[elastic] losses {losses}")
    tally.check(12, "kill drill")
    ckpt = reg.histogram("elastic_checkpoint_seconds", {})
    ckpt_bytes = _dir_bytes(info.path)
    resize = t.resizes[0]
    final, want = t.final_loss(), _el_snapshot(t)
    print(f"[elastic] 12 x CausalLM ({n_params} params) at {EL_B} x {EL_T}, "
          f"ladder {EL_DP_MIN}..{EL_DP} on one card: losses "
          + " ".join(f"{l:.4f}" for l in losses)
          + f"; resize {log[0]} in {resize['seconds']:.2f} s (two "
          f"checkpoints); checkpoint {ckpt_bytes} bytes, written "
          f"{ckpt.count} times in {ckpt.sum:.2f} s "
          f"({ckpt.count * ckpt_bytes / ckpt.sum / 1e9:.3f} GB/s); "
          f"captures " + ", ".join(
              f"dp {d} {c['seconds']:.2f} s pool "
              f"{c['pool_bytes'] / 2**30:.2f} GiB"
              for d, c in sorted(t.captures.items()))
          + f"; step ms " + ", ".join(
              f"dp {d} {ms:.1f}" for d, ms in tally.step_ms().items())
          + f"; peak allocated {peak / 2**30:.2f} GiB; launches "
          f"{tally.summary()}; {where}")
    launches = tally.launches()
    del t, m, tally     # the tally's wrappers hold the trainer
    _release()

    t0 = time.perf_counter()
    t2 = ElasticTrainer.resume(wd, dp=3, seed=0, devices=_el_devices(EL_DP))
    resume_s = time.perf_counter() - t0
    check(t2.iteration == info.step and t2.dp == 3,
          f"[elastic] resumed at {t2.iteration}, dp {t2.dp}")
    tally2 = _ElTally(t2, wrappers)
    losses2 = []
    _el_fit(t2, EL_STEPS, losses2)
    check(t2.trace_count() == 0, "[elastic] the resumed trainer captured "
          "after warm()")
    got = _el_snapshot(t2)
    same = t2.final_loss() == final and all(
        torch.equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1]))
    check(same, "[elastic] the resumed trainer's params and updater state "
          "are not bit-equal to the uninterrupted run's")
    tally2.check(12, "resumed trainer")
    launches.update(tally2.launches())
    print(f"[elastic] resumed from {os.path.basename(info.path)} at dp 3 in "
          f"{resume_s:.2f} s (build, warm excluded, and read), "
          f"{len(losses2)} steps: params, updater state and last loss "
          f"{final:.6f} bit-equal to the uninterrupted run; step ms "
          + ", ".join(f"dp {d} {ms:.1f}"
                      for d, ms in tally2.step_ms().items())
          + f"; launches {tally2.summary()}")
    del t2, tally2, got, want
    _release()

    # a third trainer at dp 2: the read alone, timed, then dp 2's steps
    m3 = orbax_io.load_model_json(info.path)
    t3 = ElasticTrainer(m3, workdir=os.path.join(tmp, "dp2"), dp=2,
                        dp_min=EL_DP_MIN, dp_max=EL_DP,
                        devices=_el_devices(EL_DP), seed=0)
    tally3 = _ElTally(t3, wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    orbax_io.restore_trainer(info.path, t3)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    losses3 = []
    _el_fit(t3, t3.iteration + EL_T3_STEPS, losses3)
    check(all(np.isfinite(losses3)), f"[elastic] dp 2 losses {losses3}")
    tally3.check(12, "dp-2 trainer")
    launches.update(tally3.launches())
    print(f"[elastic] read {ckpt_bytes} bytes into a dp-2 trainer in "
          f"{read_s:.2f} s ({ckpt_bytes / read_s / 1e9:.3f} GB/s, the "
          f"file cache warm from the writes); step ms "
          + ", ".join(f"dp {d} {ms:.1f}"
                      for d, ms in tally3.step_ms().items())
          + f"; launches {tally3.summary()}")
    del t3, m3, tally3
    _release()
    shutil.rmtree(wd, ignore_errors=True)
    shutil.rmtree(os.path.join(tmp, "dp2"), ignore_errors=True)
    return launches


def elastic_small_drills(tmp, where, wrappers):
    """The other drills on the 2-layer cut: a death mid-resize resumed at
    the pre-resize width, quorum loss raised typed, and autoscale growth
    from a staged step time. Returns their launches."""
    from deeplearning4j_torch.chaos import faults
    from deeplearning4j_torch.elastic import (ElasticTrainer,
                                              QuorumLostError, latest)

    layers = EL_SMALL_LAYERS
    launches = collections.Counter()
    # a death on the elastic.resize seam
    wd = os.path.join(tmp, "mid")
    t = ElasticTrainer(_el_lm(layers), workdir=wd, dp=EL_DP,
                       dp_min=EL_DP_MIN, devices=_el_devices(EL_DP), seed=0)
    tally = _ElTally(t, wrappers)
    losses = []
    _el_fit(t, EL_KILL_AT, losses)
    plane = faults.FaultPlane(seed=0)
    plane.inject_spec("elastic.step:error:scope=w2,times=1")
    plane.inject_spec("elastic.resize:error:times=1")
    faults.install(plane)
    try:
        _el_fit(t, EL_STEPS, losses)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        faults.uninstall()
    info = latest(wd)
    check(raised is not None and "elastic.resize" in raised
          and info.cause == "pre_resize_worker_death" and info.dp == EL_DP
          and info.step == t.iteration,
          f"[elastic] mid-resize death: raised {raised}, pointer {info}")
    tally.check(layers, "mid-resize death")
    launches.update(tally.launches())
    del t, tally
    _release()
    t = ElasticTrainer.resume(wd, seed=0, devices=_el_devices(EL_DP))
    check(t.dp == EL_DP and t.iteration == info.step,
          f"[elastic] resumed at dp {t.dp}, step {t.iteration}")
    tally = _ElTally(t, wrappers)
    _el_fit(t, EL_STEPS, losses)
    check(all(np.isfinite(losses)), f"[elastic] losses {losses}")
    tally.check(layers, "resumed after the mid-resize death")
    launches.update(tally.launches())
    print(f"[elastic] {layers} x CausalLM: death on elastic.resize at step "
          f"{info.step} raised typed, pointer {info.cause} at dp {info.dp}, "
          f"resumed there to step {EL_STEPS}: losses "
          + " ".join(f"{l:.4f}" for l in losses))
    del t, tally
    _release()
    shutil.rmtree(wd, ignore_errors=True)

    # quorum loss: the ladder's floor is its only width
    wd = os.path.join(tmp, "quorum")
    t = ElasticTrainer(_el_lm(layers), workdir=wd, dp=EL_DP_MIN,
                       dp_min=EL_DP_MIN, devices=_el_devices(EL_DP), seed=0)
    tally = _ElTally(t, wrappers)
    _el_fit(t, 1, [])
    faults.install(faults.FaultPlane(seed=0).inject_spec(
        "elastic.step:error:scope=w0,times=1"))
    try:
        _el_fit(t, EL_STEPS, [])
        quorum = None
    except QuorumLostError as e:
        quorum = str(e)
    finally:
        faults.uninstall()
    check(quorum is not None and latest(wd) is None,
          f"[elastic] quorum loss raised {quorum}")
    tally.check(layers, "quorum loss")
    launches.update(tally.launches())
    print(f"[elastic] quorum loss at step {t.iteration}: {quorum}")
    del t, tally
    _release()
    shutil.rmtree(wd, ignore_errors=True)

    # autoscale growth: every step staged at 4x a 50 ms budget
    wd = os.path.join(tmp, "grow")
    t = ElasticTrainer(_el_lm(layers), workdir=wd, dp=EL_DP_MIN,
                       dp_min=EL_DP_MIN, dp_max=3, devices=_el_devices(EL_DP),
                       seed=0, step_time_budget_s=0.05)
    tally = _ElTally(t, wrappers)
    t.fit(_el_batch, 8, step_time_fn=lambda i: 0.2)
    log = [(r["step"], r["from"], r["to"], r["cause"]) for r in t.resizes]
    check(t.dp == 3 and {r["cause"] for r in t.resizes} == {"autoscale"}
          and t.trace_count() == 0 and np.isfinite(t.final_loss()),
          f"[elastic] autoscale growth: dp {t.dp}, log {log}")
    tally.check(layers, "autoscale growth")
    launches.update(tally.launches())
    print(f"[elastic] autoscale growth from a staged 4x step-time burn: "
          f"resizes {log}; step ms " + ", ".join(
              f"dp {d} {ms:.1f}" for d, ms in tally.step_ms().items())
          + f" ({layers} layers); {where}")
    del t, tally
    _release()
    shutil.rmtree(wd, ignore_errors=True)
    return launches


def phase_elastic():
    """[elastic]: ElasticTrainer's kill, reshard and resume drill at full
    width and depth, and the other drills on the 2-layer cut. Returns
    every kernel's launches over the phase (K1-K3 only)."""
    import tempfile

    where = card()
    t_phase = time.perf_counter()
    plain_ms = elastic_plain_step(where)
    wrappers = _kernel_wrappers()
    tmp = tempfile.mkdtemp()
    try:
        launches = elastic_kill_drill(tmp, where, wrappers)
        launches.update(elastic_small_drills(tmp, where, wrappers))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {k: launches.get(k, 0) for k in wrappers}
    check(all(counts[k] > 0 for k in ("K1", "K2", "K3")),
          f"[elastic] launches {counts}")
    print(f"[elastic] launches {counts} (warm-up steps plus captured x "
          f"replays); plain step {plain_ms:.1f} ms; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


# --- [moe_ep]: expert-parallel MoE on a world-1 NCCL expert mesh ---
# the reference's expert placement: an MoE layer's expert leaves over the
# expert axis on their leading dimension (tests/test_moe.py)
EXPERT_RULES = ((r"(.*/)?(w_up|b_up|w_down|b_down)", ("expert",)),)
MOE_EP_STEPS = 2


def _moe_lm(device="cuda"):
    """[train_api]'s MoE LM (MOE_BLOCKS MoETransformerBlocks, d MOE_D,
    MOE_E experts, top-2, flash), from seed 0."""
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.nn.model import NetConfig, Sequential

    blocks = [L.MoETransformerBlock(num_heads=MOE_H, num_experts=MOE_E,
                                    top_k=2, causal=True, flash=True)
              for _ in range(MOE_BLOCKS)]
    m = Sequential(NetConfig(seed=0, compute_dtype="bfloat16",
                             updater={"type": "adam", "learning_rate": 1e-3}),
                   [L.EmbeddingSequence(n_in=MOE_VOCAB, n_out=MOE_D), *blocks,
                    L.RnnOutput(n_out=MOE_VOCAB)], (MOE_T,), device=device)
    m.init(seed=0)
    return m


def phase_moe_ep(device="cuda"):
    """[moe_ep]: the MoE LM under a world-1 NCCL mesh {expert 1}, its
    expert leaves placed by EXPERT_RULES: the forward's output, the loss
    and every gradient bit-equal to the LM without a mesh; then
    MOE_EP_STEPS steps of ``Trainer(mesh=, rules=EXPERT_RULES)``, params
    bit-equal to ``Trainer``'s. K1-K3 counted on the mesh runs. Returns
    them."""
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
    from deeplearning4j_torch.parallel import (activation_sharding,
                                               distributed_init, make_mesh,
                                               place_params)
    from deeplearning4j_torch.train import Trainer

    where = card()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    check(distributed_init(f"file://{tmp}/store", 1, 0, device=device),
          "[moe_ep] no process group made")
    wrappers = _kernel_wrappers()
    try:
        mesh = make_mesh({"expert": 1})
        m = _moe_lm(device)
        rng = np.random.default_rng(3)
        xb = torch.from_numpy(rng.integers(0, MOE_VOCAB, (MOE_B, MOE_T))
                              .astype(np.int32)).to(device)
        yb = torch.from_numpy(rng.integers(0, MOE_VOCAB, (MOE_B, MOE_T))
                              .astype(np.int64)).to(device)

        def run(params):
            leaves = [p.detach().requires_grad_() for p in
                      tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            with torch.no_grad():
                out, _ = m.forward(p, m.state, xb, training=False)
            loss, _ = m.score(p, m.state, xb, yb, training=True)
            return out, loss.detach(), torch.autograd.grad(loss, leaves)

        out_a, loss_a, grads_a = run(m.params)
        placed = place_params(m.params, mesh, EXPERT_RULES)
        for w in wrappers.values():
            w.launches = 0
        with activation_sharding(mesh):
            out_b, loss_b, grads_b = run(placed)
        counts = {k: w.launches for k, w in wrappers.items()}
        same = (torch.equal(out_a, out_b) and torch.equal(loss_a, loss_b)
                and all(torch.equal(a, b) for a, b in zip(grads_a, grads_b)))
        check(same, "[moe_ep] the expert mesh's output, loss or gradients "
              "differ from the LM's without a mesh")
        check(counts["K1"] == 2 * MOE_BLOCKS
              and counts["K2"] == counts["K3"] == MOE_BLOCKS,
              f"[moe_ep] launches {counts}: want K1 {2 * MOE_BLOCKS} (the "
              f"forward and the loss's), K2 and K3 {MOE_BLOCKS}")
        del grads_a, grads_b, placed
        # Trainer(mesh=, rules=) against Trainer, from the same params
        from deeplearning4j_torch.data import ArrayIterator

        x_np, y_np = xb.cpu().numpy(), yb.cpu().numpy()

        def batches():
            return ArrayIterator(np.repeat(x_np, MOE_EP_STEPS, 0),
                                 np.repeat(y_np, MOE_EP_STEPS, 0),
                                 batch_size=MOE_B)

        plain = Trainer(_moe_lm(device))
        plain.fit(batches())
        before = {k: w.launches for k, w in wrappers.items()}
        ruled = Trainer(_moe_lm(device), mesh=mesh, rules=EXPERT_RULES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ruled.fit(batches())
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / MOE_EP_STEPS
        fit_counts = {k: w.launches - before[k] for k, w in wrappers.items()}
        check(all(torch.equal(a, b) for a, b in
                  zip(tree_leaves(plain.params), tree_leaves(ruled.params))),
              "[moe_ep] Trainer(mesh=, rules=)'s params differ from "
              "Trainer's")
        check(all(fit_counts[k] == MOE_BLOCKS * MOE_EP_STEPS
                  for k in ("K1", "K2", "K3")),
              f"[moe_ep] fit launches {fit_counts}")
        for k, v in fit_counts.items():
            counts[k] += v
        print(f"[moe_ep] MoE LM ({MOE_BLOCKS} blocks, d {MOE_D}, {MOE_E} "
              f"experts, T {MOE_T}, batch {MOE_B}, bf16) on a world-1 NCCL "
              f"mesh {{expert 1}}: output, loss {float(loss_b):.6f} and "
              f"every gradient bit-equal to the LM without a mesh; "
              f"{MOE_EP_STEPS} steps of Trainer(mesh=, rules=) bit-equal to "
              f"Trainer's, {step_ms:.1f} ms a step; launches {counts}; "
              f"phase {time.perf_counter() - t_phase:.1f} s; {where}")
        del m, plain, ruled
        _release()
        return counts
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# --- [embeddings] and [knn]: word, document and graph embeddings, and the
# nearest-neighbour server over the trained vectors ---
EMB_DEVICE = "cuda"
EMB_SEED = 0
EMB_VOCAB = 71_290          # text8's vocabulary at min_count 5
EMB_TOPICS = 100            # planted topics, word w's topic w % 100
EMB_MIN_COUNT = 5           # every word's floor in the corpus
EMB_SENT = 20               # tokens a sentence, one topic each
EMB_FURTHER = 1_000_000     # tokens beyond each word's 5 (cut from text8's 17M)
EMB_GLOBAL = 0.3            # share of a sentence's tokens from the global Zipf
EMB_HEAD = 200_000          # the HS and CBOW runs' prefix
EMB_GLOVE_HEAD = 300_000    # GloVe's prefix (host co-occurrence counting)
EMB_BITS_HEAD = 100_000     # the prefix of the twice-run determinism fit
EMB_PREC_WORDS = 200        # precision@10 queries ...
EMB_PREC_POOL = 2_000       # ... drawn from the most frequent words
EMB_PREC_GATE = 5.0 / EMB_TOPICS   # 5x chance
EMB_STEP_ATOL, EMB_STEP_RTOL = 1e-6, 1e-5   # a step, card vs CPU
# Mikolov et al. 2013 (the GoogleNews vectors; word2vec.c's sample 1e-3),
# the JAX package's batch
W2V_KW = dict(min_word_frequency=EMB_MIN_COUNT, layer_size=300,
              window_size=5, negative_sample=5, sampling=1e-3,
              learning_rate=0.025, min_learning_rate=1e-4, batch_size=2048,
              epochs=1, seed=EMB_SEED)
PV_DOCS, PV_LEN, PV_UNSEEN, PV_DM_DOCS = 10_000, 100, 100, 1_000
# 3 epochs: DL4J's and the JAX package's default of 1 left 33 of 100 unseen
# documents nearest a label of their topic in a CPU rehearsal, 3 left 100
PV_KW = dict(layer_size=300, window_size=5, negative_sample=5,
             learning_rate=0.025, batch_size=2048, epochs=3, seed=EMB_SEED)
# Pennington et al. 2014's 300d settings
GLOVE_KW = dict(min_word_frequency=EMB_MIN_COUNT, layer_size=300,
                window_size=10, x_max=100.0, alpha=0.75, learning_rate=0.05,
                batch_size=4096, epochs=2, seed=EMB_SEED)
GRAPH_V, GRAPH_E = 10_312, 333_983   # BlogCatalog's vertices and edges
# Perozzi et al. 2014 (DeepWalk) and Grover & Leskovec 2016 (node2vec on
# BlogCatalog): d 128, window 10, walks of 40; 1 walk a vertex, cut from 80
# and 10; word2vec's learning rate 0.025
DW_KW = dict(vector_size=128, window_size=10, learning_rate=0.025,
             batch_size=2048, seed=EMB_SEED)
DW_WALK = 40
N2V_KW = dict(vector_size=128, window_size=10, walk_length=40,
              walks_per_vertex=1, p=0.25, q=0.25, negative=5,
              learning_rate=0.025, batch_size=2048, seed=EMB_SEED)
KNN_K = 10
KNN_ROWS = EMB_PREC_WORDS   # /knn requests: the precision gate's words
KNN_NEW, KNN_NEW_ROWS = 50, 16   # /knnnew requests and vectors each
KNN_TIE = 1e-6              # scores this close (of max(1, |score|)) may swap
KNN_DIST_TOL = 1e-5         # distances against float64, of max(1, |d|)


def _emb_words(n):
    return np.array([f"w{r}" for r in range(n)], dtype=object)


def _emb_draws(rng, topics, n):
    """(len(topics), n) word ranks: each row's tokens drawn Zipf(1) within
    its topic's words, EMB_GLOBAL of them Zipf(1) over all words."""
    V, T = EMB_VOCAB, EMB_TOPICS
    pg = 1.0 / np.arange(1, V + 1)
    per = -(-V // T)
    pt = 1.0 / np.arange(1, per + 1)
    glob = rng.choice(V, size=(len(topics), n), p=pg / pg.sum())
    word = topics[:, None] + T * rng.choice(per, size=(len(topics), n),
                                            p=pt / pt.sum())
    word = np.where(word >= V, word - T, word)   # the short topics' last rank
    return np.where(rng.random((len(topics), n)) < EMB_GLOBAL, glob, word)


def emb_corpus(seed=EMB_SEED):
    """The synthetic corpus: every one of EMB_VOCAB words EMB_MIN_COUNT times
    in sentences of its own topic, then EMB_FURTHER tokens in EMB_SENT-token
    sentences of a random topic (``_emb_draws``); sentences shuffled. A
    word's topic is its rank modulo EMB_TOPICS (``_emb_topic``)."""
    rng = np.random.default_rng(seed)
    names = _emb_words(EMB_VOCAB)
    rows = []
    for t in range(EMB_TOPICS):
        toks = np.repeat(np.arange(t, EMB_VOCAB, EMB_TOPICS), EMB_MIN_COUNT)
        rng.shuffle(toks)
        rows += np.array_split(toks, -(-len(toks) // EMB_SENT))
    n = EMB_FURTHER // EMB_SENT
    rows += list(_emb_draws(rng, rng.integers(EMB_TOPICS, size=n), EMB_SENT))
    sents = [" ".join(names[r]) for r in rows]
    order = rng.permutation(len(sents))
    return [sents[i] for i in order]


def _emb_topic(word):
    return int(word[1:]) % EMB_TOPICS


def _emb_prefix(sents, tokens):
    """The corpus's first sentences holding ``tokens`` tokens."""
    return sents[:-(-tokens // EMB_SENT)]


class _StepRecorder:
    """Stands in for an update step: calls it, keeps each call's loss tensor
    and, on the card, its device time between two CUDA events; the last
    call's arguments (the live tables among them) stay for the card-vs-CPU
    check. Host times of the first call's start and the last call's end."""

    def __init__(self, fn, cuda):
        self.fn, self.cuda = fn, cuda
        self.losses, self.events, self.last = [], [], None
        self.t_first = self.t_last = None

    def __call__(self, *args):
        if self.t_first is None:
            self.t_first = time.perf_counter()
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        self.last = args
        out = self.fn(*args)
        if self.cuda:
            b.record()
            self.events.append((a, b))
        self.losses.append(out[-1])
        self.t_last = time.perf_counter()
        return out

    def read(self):
        """(losses, device ms a step or None, host ms a step of the loop)."""
        if self.cuda:
            torch.cuda.synchronize()
        losses = [float(x) for x in self.losses]
        dev = statistics.median(a.elapsed_time(b) for a, b in self.events) \
            if self.events else None
        n = max(len(losses), 1)
        return losses, dev, 1e3 * (self.t_last - self.t_first) / n


def _emb_run(tag, where, module, name, fit):
    """``fit()`` with ``module.name`` (an update step) recorded. Gates the
    per-step losses finite and falling (the mean of the last tenth below
    the first tenth's); prints steps, host ms a step of the loop, device ms
    a step and the set-up seconds before the first step. Returns the
    recorder, the losses and fit's result."""
    from unittest import mock

    rec = _StepRecorder(getattr(module, name), torch.device(EMB_DEVICE).type
                        == "cuda")
    t0 = time.perf_counter()
    with mock.patch.object(module, name, rec):
        result = fit()
    wall = time.perf_counter() - t0
    losses, dev, host = rec.read()
    tenth = max(len(losses) // 10, 1)
    first, last = np.mean(losses[:tenth]), np.mean(losses[-tenth:])
    check(len(losses) > 0 and np.all(np.isfinite(losses)),
          f"[embeddings] {tag}: losses {losses[:3]}...")
    check(last < first, f"[embeddings] {tag}: loss did not fall "
          f"({first:.5f} -> {last:.5f} over the first and last tenth)")
    dev_s = "not measured" if dev is None else f"{dev:.4f}"
    print(f"[embeddings] {tag} on {where}: {len(losses)} steps, host ms a "
          f"step {host:.4f} (the loop, its float(loss) reads included), "
          f"device ms a step {dev_s} (median, CUDA events); set-up "
          f"{rec.t_first - t0:.2f} s of {wall:.2f} s; loss first tenth "
          f"{first:.5f} -> last tenth {last:.5f}")
    return rec, losses, result


def _emb_step_vs_cpu(tag, fn, rec, n_tables):
    """One update from the trained tables (the live ones, copied first) and
    the fit's last batch, on the card and on the CPU; every output within
    EMB_STEP_ATOL + EMB_STEP_RTOL x |CPU|. Returns the max abs error."""
    args = rec.last
    tables = args[:n_tables]
    card = fn(*[t.clone() for t in tables], *args[n_tables:])
    cpu = fn(*[t.cpu() for t in tables],
             *[a.cpu() if isinstance(a, torch.Tensor) else a
               for a in args[n_tables:]])
    err = 0.0
    for got, want in zip(card, cpu):
        got = got.cpu()
        err = max(err, float((got - want).abs().max()))
        check(torch.allclose(got, want, atol=EMB_STEP_ATOL,
                             rtol=EMB_STEP_RTOL),
              f"[embeddings] {tag} step: card against CPU max abs err {err}")
    print(f"[embeddings] {tag} step, card against CPU from the trained "
          f"tables and the last batch: max abs err {err:.3e} (atol "
          f"{EMB_STEP_ATOL}, rtol {EMB_STEP_RTOL})")
    return err


def emb_word2vec(sents, where):
    """Skip-gram NS at the published settings over the whole corpus;
    precision@10 of ``words_nearest``; the HS and CBOW heads on a prefix;
    each head's step card against CPU."""
    from deeplearning4j_torch.nlp import Word2Vec
    from deeplearning4j_torch.nlp import sequencevectors as sv

    w2v = Word2Vec(device=EMB_DEVICE, **W2V_KW)
    rec, losses, ep = _emb_run("word2vec skip-gram NS", where, sv,
                               "_skipgram_ns_step", lambda: w2v.fit(sents))
    n_tok = sum(s.count(" ") + 1 for s in sents)
    check(len(w2v.vocab) == EMB_VOCAB, f"[embeddings] vocabulary "
          f"{len(w2v.vocab)}, want {EMB_VOCAB}")
    print(f"[embeddings] word2vec corpus {n_tok} tokens in {len(sents)} "
          f"sentences (cut from text8's 17M), vocabulary {len(w2v.vocab)} "
          f"at min count {EMB_MIN_COUNT}, D {W2V_KW['layer_size']}; "
          f"{len(losses)} steps of {W2V_KW['batch_size']} pairs (about "
          f"{len(losses) * W2V_KW['batch_size']} pairs); epoch loss "
          f"first {ep[0]:.5f}, last {ep[-1]:.5f}")
    errs = {"skipgram_ns": _emb_step_vs_cpu("skip-gram NS",
                                            sv._skipgram_ns_math, rec, 2)}
    rng = np.random.default_rng(EMB_SEED + 1)
    words = [w2v.vocab.word_for(int(i)) for i in
             rng.choice(EMB_PREC_POOL, EMB_PREC_WORDS, replace=False)]
    t0 = time.perf_counter()
    nearest = {w: w2v.words_nearest(w, KNN_K) for w in words}
    hits = [np.mean([_emb_topic(n) == _emb_topic(w) for n, _ in nearest[w]])
            for w in words]
    prec = float(np.mean(hits))
    check(prec >= EMB_PREC_GATE, f"[embeddings] topic precision@10 {prec} "
          f"below {EMB_PREC_GATE}")
    print(f"[embeddings] topic precision@{KNN_K} of words_nearest over "
          f"{EMB_PREC_WORDS} of the {EMB_PREC_POOL} most frequent words: "
          f"{prec:.4f} (chance {1 / EMB_TOPICS}, gate {EMB_PREC_GATE}); "
          f"{(time.perf_counter() - t0) / EMB_PREC_WORDS * 1e3:.1f} ms a "
          f"query on the host")
    head = _emb_prefix(sents, EMB_HEAD)
    for tag, kw, name, fn, n in (
            ("skipgram_hs", dict(negative_sample=0), "_skipgram_hs_step",
             sv._skipgram_hs_math, 2),
            ("cbow", dict(use_cbow=True), "_cbow_ns_step", sv._cbow_ns_math,
             2)):
        m = Word2Vec(device=EMB_DEVICE, **{**W2V_KW, **kw})
        rec, _, _ = _emb_run(f"word2vec {tag} ({EMB_HEAD}-token prefix)",
                             where, sv, name, lambda: m.fit(head))
        if tag == "skipgram_hs":
            depth = max(len(w.codes) for w in m.vocab.words)
            print(f"[embeddings] word2vec HS: vocabulary {len(m.vocab)}, "
                  f"Huffman depth {depth}")
        errs[tag] = _emb_step_vs_cpu(tag, fn, rec, n)
        del m
    return w2v, words, nearest, prec, errs


def emb_determinism(sents, where):
    """The same small skip-gram fit twice with the sort-based scatter-add
    and twice with ``index_add_`` (atomics on the card): whether each pair
    of runs is bit-equal, and each variant's device ms a step."""
    from unittest import mock

    from deeplearning4j_torch.nlp import Word2Vec
    from deeplearning4j_torch.nlp import sequencevectors as sv

    def atomics(table, idx, rows):
        table.index_add_(0, idx, rows)

    head = _emb_prefix(sents, EMB_BITS_HEAD)
    out = {}
    for tag, scatter in (("the sorted scatter-add", sv._scatter_add),
                         ("index_add_ (atomics on the card)", atomics)):
        runs, devs = [], []
        with mock.patch.object(sv, "_scatter_add", scatter):
            for _ in range(2):
                m = Word2Vec(device=EMB_DEVICE, **W2V_KW)
                rec = _StepRecorder(sv._skipgram_ns_step,
                                    m.device.type == "cuda")
                with mock.patch.object(sv, "_skipgram_ns_step", rec):
                    m.fit(head)
                runs.append((m.sv.syn0.cpu(), m.sv.syn1.cpu()))
                devs.append(rec.read()[1])
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        out[tag] = same
        print(f"[embeddings] two runs of one {EMB_BITS_HEAD}-token skip-gram "
              f"fit with {tag} on {where}: bit-equal {same}; device ms a "
              f"step {devs}")
    check(out["the sorted scatter-add"],
          "[embeddings] the sorted scatter-add is not deterministic")
    return out


def emb_paragraph_vectors(where):
    """PV-DBOW on PV_DOCS labelled documents, ``infer_vector`` on PV_UNSEEN
    unseen ones (the nearest label's document shares the topic for most),
    and PV-DM on PV_DM_DOCS."""
    from deeplearning4j_torch.nlp import LabelledDocument, ParagraphVectors
    from deeplearning4j_torch.nlp import sequencevectors as sv

    rng = np.random.default_rng(EMB_SEED + 2)
    names = _emb_words(EMB_VOCAB)
    topics = rng.integers(EMB_TOPICS, size=PV_DOCS + PV_UNSEEN)
    toks = _emb_draws(rng, topics, PV_LEN)
    docs = [LabelledDocument(" ".join(names[r]), [f"d{i}"])
            for i, r in enumerate(toks[:PV_DOCS])]
    pv = ParagraphVectors(device=EMB_DEVICE, **PV_KW)
    _emb_run(f"PV-DBOW ({PV_DOCS} documents of {PV_LEN})", where, sv,
             "_skipgram_ns_step", lambda: pv.fit(docs))
    rows = [pv.vocab.index_of(f"__label__d{i}") for i in range(PV_DOCS)]
    lab = pv.sv.vectors[rows]
    lab /= np.linalg.norm(lab, axis=1, keepdims=True) + 1e-12
    t0 = time.perf_counter()
    hits = 0
    for i in range(PV_DOCS, PV_DOCS + PV_UNSEEN):
        v = pv.infer_vector(" ".join(names[toks[i]]))
        best = int(np.argmax(lab @ (v / (np.linalg.norm(v) + 1e-12))))
        hits += int(topics[best] == topics[i])
    infer_ms = (time.perf_counter() - t0) / PV_UNSEEN * 1e3
    check(hits > PV_UNSEEN // 2, f"[embeddings] PV-DBOW: the nearest label "
          f"shares the topic of {hits} of {PV_UNSEEN} unseen documents")
    text = " ".join(names[toks[PV_DOCS]])
    got = pv.nearest_labels(text, 1)[0][0]
    v = pv.infer_vector(text)
    want = int(np.argmax(lab @ (v / (np.linalg.norm(v) + 1e-12))))
    check(got == f"d{want}", f"[embeddings] nearest_labels {got}, d{want} "
          f"by the label matrix")
    print(f"[embeddings] PV-DBOW infer_vector on {PV_UNSEEN} unseen "
          f"documents: the nearest of {PV_DOCS} labels shares the topic for "
          f"{hits} (chance {PV_UNSEEN / EMB_TOPICS:.0f}); {infer_ms:.1f} ms an "
          f"inference (20 steps) on {where}")
    dm = ParagraphVectors(device=EMB_DEVICE, dm=True, **PV_KW)
    _emb_run(f"PV-DM ({PV_DM_DOCS} documents)", where, sv, "_cbow_ns_step",
             lambda: dm.fit(docs[:PV_DM_DOCS]))
    return hits


def emb_glove(sents, where):
    """GloVe at the paper's 300d settings on a prefix; its step card
    against CPU."""
    from deeplearning4j_torch.nlp import Glove
    from deeplearning4j_torch.nlp import glove as gl

    head = _emb_prefix(sents, EMB_GLOVE_HEAD)
    g = Glove(device=EMB_DEVICE, **GLOVE_KW)
    rec, _, ep = _emb_run(f"GloVe ({EMB_GLOVE_HEAD}-token prefix)", where,
                          gl, "_glove_step", lambda: g.fit(head))
    check(ep[-1] < ep[0], f"[embeddings] GloVe epoch losses {ep}")
    nnz = len(rec.losses) // GLOVE_KW["epochs"] * GLOVE_KW["batch_size"]
    print(f"[embeddings] GloVe: vocabulary {len(g.vocab)}, about {nnz} "
          f"non-zeros (full batches), epoch losses {ep}")
    return _emb_step_vs_cpu("GloVe", gl._glove_step, rec, 8)


def emb_graph(seed=EMB_SEED):
    """A graph of BlogCatalog's size: GRAPH_V vertices, GRAPH_E undirected
    edges by preferential attachment (each new vertex joins 32 or 33
    distinct earlier ones, drawn in proportion to their degree)."""
    from deeplearning4j_torch.graph import Edge, Graph

    rng = np.random.default_rng(seed)
    n0 = 34
    m = GRAPH_E - n0 * (n0 - 1) // 2          # edges the later vertices add
    later = GRAPH_V - n0
    per = np.full(later, m // later)
    per[rng.permutation(later)[:m % later]] += 1
    ends = np.empty(2 * GRAPH_E, np.int64)    # every edge's two ends
    edges, k = [], 0
    for a in range(n0):
        for b in range(a + 1, n0):
            edges.append((a, b))
            ends[k:k + 2] = a, b
            k += 2
    for v, c in zip(range(n0, GRAPH_V), per):
        nbrs = set()
        while len(nbrs) < c:
            nbrs.update(ends[rng.integers(k, size=c - len(nbrs))].tolist())
        for u in sorted(nbrs):
            edges.append((u, v))
            ends[k:k + 2] = u, v
            k += 2
    return Graph(GRAPH_V, [Edge(a, b) for a, b in edges])


def emb_graphs(where):
    """DeepWalk (HS over the degree Huffman tree) and Node2Vec (p = q =
    0.25) on the BlogCatalog-sized graph."""
    from deeplearning4j_torch.graph import DeepWalk, Node2Vec
    from deeplearning4j_torch.nlp import sequencevectors as sv

    t0 = time.perf_counter()
    g = emb_graph()
    deg = g.degrees()
    check(g.num_vertices() == GRAPH_V and g.num_edges() == 2 * GRAPH_E,
          f"[embeddings] graph {g.num_vertices()} vertices, "
          f"{g.num_edges()} directed edges")
    print(f"[embeddings] graph: {GRAPH_V} vertices, {GRAPH_E} undirected "
          f"edges, degree min {deg.min()} median {int(np.median(deg))} max "
          f"{deg.max()}, built in {time.perf_counter() - t0:.2f} s")
    dw = DeepWalk(device=EMB_DEVICE, **DW_KW)
    rec, losses, _ = _emb_run(f"DeepWalk (1 walk of {DW_WALK} a vertex)",
                              where, sv, "_skipgram_hs_step",
                              lambda: dw.fit(g, DW_WALK))
    depth = max(len(w.codes) for w in dw.sv.vocab.words)
    print(f"[embeddings] DeepWalk: Huffman depth {depth}, about "
          f"{len(losses) * DW_KW['batch_size']} pairs")
    nv = Node2Vec(device=EMB_DEVICE, **N2V_KW)
    rec, losses, _ = _emb_run("Node2Vec (1 walk of 40 a vertex, p = q = "
                              "0.25)", where, sv, "_skipgram_ns_step",
                              lambda: nv.fit(g))
    print(f"[embeddings] Node2Vec: about {len(losses) * N2V_KW['batch_size']}"
          f" pairs")


def phase_embeddings():
    """[embeddings]: Word2Vec (skip-gram NS at full width over the corpus,
    HS and CBOW on a prefix), ParagraphVectors, GloVe, DeepWalk and Node2Vec
    on the card. Launch counts are zeroed before and read after: the path
    reaches no kernel. Returns the counts and what [knn] serves."""
    where = card()
    t0 = time.perf_counter()
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    sents = emb_corpus()
    print(f"[embeddings] corpus of {len(sents)} sentences made in "
          f"{time.perf_counter() - t0:.2f} s (seed {EMB_SEED})")
    w2v, words, nearest, prec, errs = emb_word2vec(sents, where)
    bits = emb_determinism(sents, where)
    pv_hits = emb_paragraph_vectors(where)
    errs["glove"] = emb_glove(sents, where)
    emb_graphs(where)
    counts = {k: w.launches for k, w in wrappers.items()}
    check(all(v == 0 for v in counts.values()),
          f"[embeddings] kernels launched: {counts}")
    print(f"[embeddings] kernel launches over the phase: {counts}")
    print(f"[embeddings] summary on {where}: precision@{KNN_K} {prec:.4f}, "
          f"PV-DBOW topic hits {pv_hits}/{PV_UNSEEN}, card-vs-CPU step max "
          f"abs err {errs}, two runs bit-equal {bits}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return counts, {"w2v": w2v, "words": words, "nearest": nearest}


def _unit_rows(M):
    return M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-12)


def _knn_ref(M, Q, distance, Mn=None):
    """float64 scores (Q, N) of every point for each query, larger better,
    and the distance each score reports (``Mn``: M's unit rows, when the
    caller has them)."""
    if distance == "cosinesimilarity":
        Mn = _unit_rows(M) if Mn is None else Mn
        Qn = _unit_rows(Q)
        s = Qn @ Mn.T
        return s, s
    if distance == "dot":
        s = Q @ M.T
        return s, s
    if distance == "euclidean":
        d = np.sqrt(np.maximum((Q * Q).sum(1)[:, None] - 2 * Q @ M.T
                               + (M * M).sum(1)[None], 0.0))
        return -d, d
    d = np.stack([np.abs(q[None] - M).sum(1) for q in Q])
    return -d, d


def _knn_agree(got_idx, got_d, score, dist, what, exclude=None):
    """One answer against the float64 brute force: at each position the
    index's score within KNN_TIE (of max(1, |score|)) of that position's
    best score, the indices distinct, the distance within KNN_DIST_TOL of
    the reference's (of max(1, |d|)). Returns (ties met, max distance
    error)."""
    s = score.copy()
    if exclude is not None:
        s[exclude] = -np.inf
    k = len(got_idx)
    part = np.argpartition(-s, k)[:k]
    order = part[np.argsort(-s[part], kind="stable")]
    check(len(set(got_idx)) == k and (exclude is None or exclude not in
                                      got_idx), f"{what}: indices {got_idx}")
    tie = KNN_TIE * np.maximum(1.0, np.abs(s[order]))
    ok = np.abs(s[got_idx] - s[order]) <= tie
    check(bool(ok.all()), f"{what}: indices {list(got_idx)} against "
          f"{list(order)}")
    err = np.abs(np.asarray(got_d) - dist[order])
    check(bool(np.all(err <= KNN_DIST_TOL * np.maximum(1.0, np.abs(
        dist[order])))), f"{what}: distances off by {err.max()}")
    return int((np.asarray(got_idx) != order).sum()), float(err.max())


def phase_knn(emb):
    """[knn]: the trained Word2Vec vectors written with
    ``write_word2vec_binary``, read back and served by
    ``NearestNeighborsServer`` on the card; KNN_ROWS /knn and KNN_NEW
    /knnnew requests through ``NearestNeighborsClient`` held against a
    float64 brute force and /knn against ``words_nearest``; one /knnnew
    batch under each other distance; ``BruteForceKNN`` card against CPU.
    Launch counts are zeroed before and read after. Returns the counts."""
    import tempfile

    from deeplearning4j_torch.knn import (BruteForceKNN,
                                          NearestNeighborsClient,
                                          NearestNeighborsServer)
    from deeplearning4j_torch.nlp import (read_word2vec_binary,
                                          write_word2vec_binary)

    where = card()
    t0 = time.perf_counter()
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    w2v = emb["w2v"]
    words, vecs = w2v.vocab_words(), w2v.vectors
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vectors.bin")
        t1 = time.perf_counter()
        write_word2vec_binary(path, words, vecs)
        t2 = time.perf_counter()
        words2, pts = read_word2vec_binary(path)
        t3 = time.perf_counter()
        size = os.path.getsize(path)
    check(words2 == words and np.array_equal(pts, vecs),
          "[knn] the vectors file did not read back")
    print(f"[knn] {len(words)} x {vecs.shape[1]} vectors: "
          f"write_word2vec_binary {t2 - t1:.2f} s, read {t3 - t2:.2f} s, "
          f"{size} bytes")
    M = pts.astype(np.float64)
    Mn = _unit_rows(M)
    rng = np.random.default_rng(EMB_SEED + 3)
    news = [(pts[rng.integers(len(pts), size=KNN_NEW_ROWS)]
             + 0.1 * pts.std() * rng.standard_normal(
                 (KNN_NEW_ROWS, pts.shape[1]))).astype(np.float32)
            for _ in range(KNN_NEW)]
    srv = NearestNeighborsServer(pts, distance="cosinesimilarity", port=0,
                                 default_k=KNN_K,
                                 device=EMB_DEVICE).start()
    swaps, err = 0, 0.0
    try:
        client = NearestNeighborsClient(port=srv.port, timeout=60)
        check(client.health() == {"status": "ok", "points": len(words)},
              "[knn] /health")
        knn_ms, knn_res = [], []
        for w in emb["words"]:
            r0 = time.perf_counter()
            knn_res.append(client.knn(w2v.vocab.index_of(w), KNN_K))
            knn_ms.append(1e3 * (time.perf_counter() - r0))
        new_ms, new_res = [], []
        for q in news:
            r0 = time.perf_counter()
            new_res.append(client._post("/knnnew", {"ndarray": q.tolist(),
                                                    "k": KNN_K})["results"])
            new_ms.append(1e3 * (time.perf_counter() - r0))
        time.sleep(0.05)   # the handler counts a request after replying
        _, body = _plain_get(srv.port, "/metrics")
        _promcheck(body, "[knn] /metrics")
    finally:
        srv.stop()
    rows = [w2v.vocab.index_of(w) for w in emb["words"]]
    score, dist = _knn_ref(M, M[rows], "cosinesimilarity", Mn)
    for i, (w, res) in enumerate(zip(emb["words"], knn_res)):
        idx = [r["index"] for r in res]
        d = [r["distance"] for r in res]
        sw, e = _knn_agree(idx, d, score[i], dist[i], f"[knn] /knn {w}",
                           exclude=rows[i])
        swaps, err = swaps + sw, max(err, e)
        near = emb["nearest"][w]
        ws = [n for n, _ in near]
        same = [a == words[b] or abs(s - r["distance"]) <= KNN_TIE
                for a, (_, s), b, r in zip(ws, near, idx, res)]
        check(all(same) and np.allclose([s for _, s in near], d, rtol=0,
                                        atol=KNN_DIST_TOL),
              f"[knn] /knn {w} against words_nearest: {ws} vs "
              f"{[words[b] for b in idx]}")
    s_all, d_all = _knn_ref(M, np.concatenate(news).astype(np.float64),
                            "cosinesimilarity", Mn)
    for j, row in enumerate(r for res in new_res for r in res):
        sw, e = _knn_agree([r["index"] for r in row],
                           [r["distance"] for r in row], s_all[j], d_all[j],
                           "[knn] /knnnew")
        swaps, err = swaps + sw, max(err, e)
    print(f"[knn] cosine server on {where}: {KNN_ROWS} /knn (p50 "
          f"{_pct(knn_ms, 50):.2f} ms, p99 {_pct(knn_ms, 99):.2f} ms) and "
          f"{KNN_NEW} /knnnew of {KNN_NEW_ROWS} vectors (p50 "
          f"{_pct(new_ms, 50):.2f} ms, p99 {_pct(new_ms, 99):.2f} ms) at k "
          f"{KNN_K} over 127.0.0.1 through NearestNeighborsClient; every "
          f"answer equal to a float64 brute force ({swaps} positions "
          f"swapped within {KNN_TIE}, max distance error {err:.2e}); /knn "
          f"equal to words_nearest for all {KNN_ROWS}; /metrics passes "
          f"promcheck")
    for distance in ("euclidean", "dot", "manhattan"):
        srv = NearestNeighborsServer(pts, distance=distance, port=0,
                                     device=EMB_DEVICE).start()
        try:
            r0 = time.perf_counter()
            res = NearestNeighborsClient(port=srv.port, timeout=120)._post(
                "/knnnew", {"ndarray": news[0].tolist(), "k": KNN_K}
            )["results"]
            ms = 1e3 * (time.perf_counter() - r0)
        finally:
            srv.stop()
        s_all, d_all = _knn_ref(M, news[0].astype(np.float64), distance)
        e = 0.0
        for j, row in enumerate(res):
            e = max(e, _knn_agree([r["index"] for r in row],
                                  [r["distance"] for r in row], s_all[j],
                                  d_all[j], f"[knn] /knnnew {distance}")[1])
        print(f"[knn] {distance} server: one /knnnew of {KNN_NEW_ROWS} in "
              f"{ms:.2f} ms, equal to a float64 brute force (max distance "
              f"error {e:.2e})")
    card_ix = BruteForceKNN(pts, distance="cosinesimilarity",
                            device=EMB_DEVICE)
    cpu_ix = BruteForceKNN(pts, distance="cosinesimilarity", device="cpu")
    q = np.concatenate(news[:4])
    (ci, cd), (pi, pd) = card_ix.search(q, KNN_K), cpu_ix.search(q, KNN_K)
    s_all, _ = _knn_ref(M, q.astype(np.float64), "cosinesimilarity", Mn)
    tie = np.abs(np.take_along_axis(s_all, ci, 1)
                 - np.take_along_axis(s_all, pi, 1)) <= KNN_TIE
    check(bool(np.all((ci == pi) | tie)) and np.allclose(cd, pd, rtol=0,
                                                         atol=KNN_DIST_TOL),
          "[knn] BruteForceKNN card against CPU")
    print(f"[knn] BruteForceKNN card against CPU on {len(q)} queries: "
          f"indices equal at {int((ci == pi).sum())} of {ci.size} positions "
          f"(the rest within {KNN_TIE}), distances within "
          f"{np.abs(cd - pd).max():.2e}")
    counts = {k: w.launches for k, w in wrappers.items()}
    check(all(v == 0 for v in counts.values()),
          f"[knn] kernels launched: {counts}")
    print(f"[knn] kernel launches over the phase: {counts}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def main() -> int:
    import shutil
    import tempfile

    if len(sys.argv) == 3 and sys.argv[1] == "--aot-serve":
        return aot_serve(sys.argv[2])
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
    tel_counts = phase_telemetry(trainer, x, y)
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
    transfer = phase_transfer()
    moe_counts = phase_train_api()
    fleet_counts = phase_fleet()
    # [aot]'s store outlives it: [cluster]'s tuner reads its cost profile
    aot_dir = tempfile.mkdtemp()
    try:
        aot_counts = phase_aot(aot_dir)
        cluster_counts = phase_cluster(aot_dir)
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    recovery_counts = phase_recovery()
    elastic_counts = phase_elastic()
    emb_counts, emb = phase_embeddings()
    knn_counts = phase_knn(emb)
    del emb
    # last: the phases that make a process group, one after the other
    par_counts = phase_parallel()
    tp_counts, _ = phase_tp_sp()
    moe_ep_counts = phase_moe_ep()
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
    for row, key in zip([k1] + bwd_rows + bn_rows,
                        ("K1", "K2", "K3", "K5", "K4a", "K4b")):
        # the ResNet-50 fine-tune's early-stopping run (every step's
        # launches); under a graph, the launches captured x the replays;
        # the MoE LM's fit
        row["launches_by_path"]["transfer"] = transfer["fine"]["counts"][key]
        row["launches_by_path"]["transfer_graph"] = (
            transfer["graph"]["captured"][key] * transfer["graph"]["replays"])
        row["launches_by_path"]["moe"] = moe_counts[key]
        # the fleet: every predict batch of alpha, beta and gamma (K1),
        # gamma's generations (no kernel)
        row["launches_by_path"]["fleet"] = fleet_counts[key]
        # strict prebuilt serving: K1's launches captured in each engine
        # graph times the replays; every other kernel's counter
        row["launches_by_path"]["aot"] = aot_counts[key]
        # the replica cluster: K1's eager launches on every replica plus 12
        # a replay of the strict tuned replica; the recovery fits (K1-K3)
        row["launches_by_path"]["cluster"] = cluster_counts[key]
        row["launches_by_path"]["recovery"] = recovery_counts[key]
        # the telemetered fit of the full-width CausalLM (4 steps)
        row["launches_by_path"]["telemetry"] = tel_counts[key]
        # data parallelism at world 1: Trainer and every wrapper mode's
        # fits, MultiHostTrainer's, ParallelInference's batches
        row["launches_by_path"]["parallel"] = par_counts[key]
        # tensor, sequence and pipeline parallelism at world 1: the rules
        # runs, MultiHostTrainer's evaluate, sharded_lm_step's step, the
        # ring's schedule over 4 blocks and the pipeline (the reference
        # calls they are held against excluded)
        row["launches_by_path"]["tp_sp"] = tp_counts[key]
        # elastic training: the kill drill's three full-width trainers and
        # the 2-layer drills (warm-up steps plus captured x replays); the
        # MoE LM on a world-1 expert mesh (its forward, gradient and fit)
        row["launches_by_path"]["elastic"] = elastic_counts[key]
        row["launches_by_path"]["moe_ep"] = moe_ep_counts[key]
        # the embedding trainers and the kNN server reach no kernel
        row["launches_by_path"]["embeddings"] = emb_counts[key]
        row["launches_by_path"]["knn"] = knn_counts[key]
    for row in bn_rows:
        row["yolo2_shapes"] = zoo["shapes"]
        row["transfer_shapes"] = transfer["shapes"]
    print(json.dumps({"kernels": [k1] + bwd_rows + bn_rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
