"""Continuous batching for autoregressive generation — counterpart of
``deeplearning4j_tpu/serve/continuous.py``.

``nn/generation.generate`` is whole-batch lockstep. Serving wants the
iteration-level schedule instead: a fixed number of decode *slots*, each
holding one in-flight sequence; every tick decodes ALL slots one token; a
sequence that finishes frees its slot at once and a queued prompt
prefills into it, joining the in-flight batch mid-stream.

Shapes stay static, as in the reference: the decode step has one shape
for the life of the server (per-slot position, temperature and top-k ride
as tensors over the slot axis), and prompts pad to a fixed set of
``prompt_buckets`` (chunked: ``prefill chunk buckets``), so
``compile_signatures`` holds at most ``|buckets| + 1`` shapes.

Two KV layouts (``kv=``; contract in ``nn/generation.py``):

``kv="paged"`` (default) — one shared block pool per attention layer
  (``serve/paged.py``); each slot owns a block-table row that maps logical
  block ``p // block_size`` to a physical block, uploaded with the tick's
  tokens and positions. Admission commits worst-case blocks up front, so a
  decode never runs out of memory mid-flight; blocks are allocated lazily
  as tokens materialize. Prefill is chunked: a long prompt advances
  ``prefill_chunk`` tokens per step, interleaved with decode ticks under a
  :class:`~.engine.PrefillScheduler`. With ``prefix_cache=True`` whole
  prompt blocks are cached under ``(params generation, rolling sha256)``
  and adopted by later prompts (refcount++, prefill only the suffix);
  :meth:`ContinuousBatcher.fork` clones a decoding slot by copying its
  table row; a slot about to write a block someone else still references
  copies that block first (copy-on-write, ``_copy_blocks``).

``kv="dense"`` — slot-major ``(slots, capacity, ...)`` caches; a prompt
  prefills into a fresh one-row cache that is then inserted into its slot.

Sampling draws from one ``torch.Generator`` a request, seeded from
``(seed, admission index)``; forks draw from a disjoint seed space. JAX's
keys have no bitwise counterpart in torch, so sampled tokens are the
port's own (reproducible for a seed); greedy tokens equal the reference's.
The worker thread enters ``torch.inference_mode()`` itself and names its
device explicitly; a tick makes one host sync (the S next tokens).

Request traces (``ctx=``: queue, prefill-chunk and decode stages,
exemplars on the prefill histogram), the completion hook
(:meth:`_GenRequest.set_on_done`, the fleet's SLO accounting) and the
``serve.decode_step`` fault seam are the reference's.

With ``aot_store=`` every device step runs through an
:class:`~..aot.AotFunction` under the reference's tags
(``gen_decode_paged``, ``gen_prefill_chunk``, ``gen_sample``; dense:
``gen_decode_dense``, ``gen_prefill_dense``, ``gen_slot_insert``): on the
card a CUDA graph per step shape and params generation, captured at
construction (``serve_cold_start_seconds{component="generate"}``) and for
each publish candidate before the flip, then replayed; each step's host
ints are copied into its graph's static buffer. Sampling's noise stays
out of every graph: the sample graph computes the greedy tokens and the
masked, scaled logits, and each sampled row's Gumbel noise is drawn
eagerly from its own generator, so tokens under graphs equal the eager
port's for the same seeds. ``strict_aot=True`` refuses, typed, a step the
store does not cover; since the warm runs at construction, that fails the
boot, never a request. Each prefill chunk and decode tick carries a
padding hint for ``obs/profile``.

Scope: embedding-front causal-attention stacks (the CausalLM family).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..aot.compile import graphable
from ..chaos import faults as _faults
from ..nn.generation import (cache_spec, cast_bytes, categorical,
                             decode_forward, init_caches)
from ..nn.layers import (EmbeddingSequence, MultiHeadAttention, Output,
                         PositionalEmbedding, RecurrentLayer,
                         TransformerEncoderBlock)
from ..obs import profile as _prof
from ..obs.metrics import MetricsRegistry
from .engine import PrefillScheduler
from .errors import (CapacityError, DeadlineExceededError, DrainTimeoutError,
                     ServeError, ServerClosingError, ShedError,
                     WorkerStallError)
from .paged import (BlockAllocator, PrefixCache, SlotPages, block_bytes,
                    blocks_needed, build_pools, prefix_hashes)
from .registry import ModelRegistry

# Constructor knobs a tuned config (aot/tuned.py) may set on the batcher.
# Unknown keys in a stored "gen" group are dropped, so configs written by a
# newer tuner never break an older binary at boot.
GEN_KNOBS = frozenset({"slots", "capacity", "kv", "block_size", "kv_blocks",
                       "prefill_chunk", "prompt_buckets", "queue_limit",
                       "seed", "prefix_cache", "prefix_cache_blocks"})


def gen_opts_from_config(config: Optional[dict]) -> dict:
    """The ``gen`` group of a tuned config as ContinuousBatcher kwargs.

    The scheduler's ``decode_chunks``/``idle_chunks`` are stored as plain
    values (the config is JSON) and folded into a ``PrefillScheduler``
    here; everything else passes through filtered by :data:`GEN_KNOBS`.
    """
    group = dict((config or {}).get("gen") or {})
    decode_chunks = group.pop("decode_chunks", None)
    idle_chunks = group.pop("idle_chunks", None)
    opts = {k: v for k, v in group.items() if k in GEN_KNOBS}
    if decode_chunks is not None or idle_chunks is not None:
        opts["scheduler"] = PrefillScheduler(
            decode_chunks=int(1 if decode_chunks is None else decode_chunks),
            idle_chunks=int(4 if idle_chunks is None else idle_chunks))
    return opts


def decode_refusal(model) -> Optional[str]:
    """Why ``model`` cannot be decoded by the batcher whatever its knobs
    (not an embedding-front token model, a recurrent layer, a non-causal
    attention layer), or None when it can: such a model is served
    predict-only."""
    layers = list(getattr(model, "layers", None) or ())
    if not layers or not isinstance(layers[0], EmbeddingSequence):
        return ("continuous batching requires an embedding-front token "
                "model (CausalLM family); one-hot char models stay on "
                "nn.generation.generate")
    for i, layer in enumerate(layers):
        if isinstance(layer, RecurrentLayer):
            return (f"layer {i} {type(layer).__name__}: recurrent carries "
                    f"cannot survive a right-padded prefill — use "
                    f"whole-batch nn.generation.generate for RNN models")
        if isinstance(layer, (TransformerEncoderBlock,
                              MultiHeadAttention)) and not layer.causal:
            return (f"layer {i} {type(layer).__name__}(causal=False) cannot "
                    f"be decoded autoregressively")
    return None


def _default_prompt_buckets(capacity: int) -> tuple:
    buckets, b = [], 8
    while b < capacity:
        buckets.append(b)
        b *= 2
    buckets.append(capacity)
    return tuple(sorted(set(buckets)))


class _GenRequest:
    """One queued/in-flight generation."""

    __slots__ = ("prompt", "max_new", "temperature", "top_k", "eos_id",
                 "deadline", "enq_t", "event", "result", "error", "out",
                 "slot", "ctx", "on_done", "cancelled", "_cv")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 top_k: Optional[int], eos_id: Optional[int],
                 deadline: Optional[float], ctx=None):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.eos_id = eos_id
        self.deadline = deadline
        self.enq_t = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[ServeError] = None
        self.out: List[int] = []
        self.slot: Optional[int] = None
        # request-trace context (obs/reqtrace); None whenever tracing is
        # uninstalled — every consumer guards on that
        self.ctx = ctx
        # completion hook (fleet SLO burn accounting); runs once, on the
        # thread that finished the request
        self.on_done = None
        # set by ContinuousBatcher.cancel(): the typed error the worker
        # finishes this request with at its next safe point
        self.cancelled: Optional[ServeError] = None
        self._cv = threading.Condition()

    # --- token-at-a-time surface (SSE streaming rides on this) ---
    def _push(self, tok: int) -> None:
        with self._cv:
            self.out.append(tok)
            self._cv.notify_all()

    def _finish(self, error: Optional[ServeError] = None) -> None:
        if self.event.is_set():
            # idempotent: a request shed by a crash-only restart (or forced
            # shutdown) must not be re-finished by a waking stale worker
            return
        if error is not None:
            self.error = error
        else:
            self.result = np.asarray(self.out, np.int32)
        if self.ctx is not None:
            # closes the decode stage; an error shed records its stage from
            # THIS thread (decode loop, watchdog, or shutdown caller), so
            # the thread that killed the request shows up in its flow
            self.ctx.finish_work(
                error=None if error is None else error.cause,
                tokens=len(self.out))
        self.event.set()
        with self._cv:
            self._cv.notify_all()
        cb = self.on_done
        if cb is not None:
            self.on_done = None
            try:
                cb(self)
            except Exception:  # an accounting hook must never kill the decode loop
                pass

    def set_on_done(self, cb) -> None:
        """Attach the completion hook race-free: a request that already
        finished (tiny prompt, instant EOS) fires ``cb`` immediately."""
        with self._cv:
            if not self.event.is_set():
                self.on_done = cb
                return
        cb(self)

    def stream(self) -> Iterator[int]:
        """Yield tokens as they are decoded; returns when the request
        completes. A terminal error raises AFTER every token decoded before
        it has been yielded."""
        i = 0
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: len(self.out) > i or self.event.is_set())
                n = len(self.out)
                done = self.event.is_set() and n <= i
            while i < n:
                yield self.out[i]
                i += 1
            if done:
                if self.error is not None:
                    raise self.error
                return

    def wait(self) -> np.ndarray:
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


class _PrefillJob:
    """One prompt mid-prefill: its slot, block pages, and chunk cursor."""

    __slots__ = ("req", "slot", "pages", "chunks", "idx", "worst", "last",
                 "shared", "hashes", "gens")

    def __init__(self, req: _GenRequest, slot: int, pages: SlotPages,
                 chunks: List[tuple], worst: int, shared: int = 0,
                 hashes: Optional[List[bytes]] = None):
        self.req = req
        self.slot = slot
        self.pages = pages
        self.chunks = chunks    # [(offset, true_len, padded_bucket), ...]
        self.idx = 0
        self.worst = worst      # committed worst-case blocks (non-shared)
        self.last = None        # logits at the last REAL token so far
        self.shared = shared    # prefix blocks adopted from the cache
        self.hashes = hashes or []  # rolling block-run hashes of the prompt
        self.gens: set = set()  # params generations its chunks ran under

    @property
    def deadline(self):
        return self.req.deadline

    @property
    def enq_t(self):
        return self.req.enq_t


class ContinuousBatcher:
    """Fixed-slot continuous-batching decode loop over a model registry.

    ``slots``: concurrent in-flight sequences (the decode batch size).
    ``capacity``: max context per request (``len(prompt) + max_new_tokens
    <= capacity``). With ``kv="paged"`` this is a logical bound backed by
    ``kv_blocks`` shared physical blocks of ``block_size`` tokens; a pool
    smaller than ``slots * capacity`` oversubscribes: requests queue while
    blocks are committed elsewhere and shed with a typed
    :class:`CapacityError` only when a request could never fit.
    ``prefill_chunk`` bounds the prompt tokens one prefill step processes
    (``None``: whole-prompt prefill). Each tick leases the registry's
    current snapshot, so a hot-swap takes effect at the next token (and,
    chunked, at the next chunk) boundary."""

    def __init__(self, model, registry: Optional[ModelRegistry] = None,
                 params=None, state=None, *, slots: int = 4,
                 capacity: int = 256, kv: str = "paged",
                 block_size: int = 16, kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefix_cache_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = 64,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 queue_limit: int = 64, seed: int = 0, metrics=None,
                 scheduler: Optional[PrefillScheduler] = None,
                 aot_store=None, strict_aot: bool = False,
                 model_name: Optional[str] = None):
        if kv not in ("paged", "dense"):
            raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
        self.model = model
        self.device = model.device
        self.model_name = model_name
        if registry is None:
            registry = ModelRegistry(
                params if params is not None else model.params,
                state if state is not None else model.state, metrics=metrics,
                model=model_name)
        self.registry = registry
        self.kv = kv
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.queue_limit = int(queue_limit)
        self.seed = int(seed)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.scheduler = scheduler if scheduler is not None \
            else PrefillScheduler()
        self.prompt_buckets = tuple(sorted(set(
            int(b) for b in (prompt_buckets
                             or _default_prompt_buckets(self.capacity))
            if b <= self.capacity))) or (self.capacity,)

        # --- model contract: embedding-front, causal, no recurrence ---
        refusal = decode_refusal(model)
        if refusal is not None:
            raise ValueError(refusal)
        for layer in model.layers:
            # a learned positional TABLE bounds context; rope models have no
            # such layer, so paged capacity may exceed the training length
            if isinstance(layer, PositionalEmbedding) \
                    and layer.max_len < self.capacity:
                raise ValueError(
                    f"PositionalEmbedding(max_len={layer.max_len}) is shorter "
                    f"than cache capacity {self.capacity}")
        out_layer = model.layers[-1]
        if not isinstance(out_layer, Output):
            raise ValueError("model must end in an Output layer")
        self.vocab = int(getattr(out_layer, "n_out", 0)
                         or model._shapes[-1][-1])
        S, C = self.slots, self.capacity
        self._lks = [lk for lk, _, _ in cache_spec(model)]

        if kv == "paged":
            self.block_size = int(block_size)
            self._maxb = blocks_needed(C, self.block_size)
            if kv_blocks is None:
                # dense-equivalent coverage + the reserved trash block
                kv_blocks = S * self._maxb + 1
            self.kv_blocks = int(kv_blocks)
            if prefill_chunk is not None and prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1 or None")
            self.prefill_chunk = (int(prefill_chunk)
                                  if prefill_chunk is not None else None)
            if self.prefill_chunk is not None:
                self._chunk_buckets = tuple(sorted(set(
                    [b for b in self.prompt_buckets
                     if b <= self.prefill_chunk] + [self.prefill_chunk])))
            else:
                self._chunk_buckets = self.prompt_buckets
            self._alloc = BlockAllocator(self.kv_blocks)
            self._prefix: Optional[PrefixCache] = None
            if prefix_cache:
                self._prefix = PrefixCache(self._alloc, self.block_size,
                                           prefix_cache_blocks)
                # cached-but-idle runs are reclaimed before anyone sheds
                self._alloc.set_reclaimer(self._prefix.reclaim)
            # distinct physical blocks slots hold via retain (adopted prefix
            # runs, fork rows) — these sit OUTSIDE every worst-case
            # commitment, so admission subtracts them from the pool
            self._shared_ledger: Dict[int, int] = {}
            self._cow_copies = 0
            self._forks = 0
            self._fork_salt = 0  # every attempt, successful or not
            self._px_hits = 0
            self._px_misses = 0
            self._pools = build_pools(model, self.kv_blocks, self.block_size,
                                      model.dtype)
            self._tables_np = np.zeros((S, self._maxb), np.int64)
            self._slot_pages: List[Optional[SlotPages]] = [None] * S
            self._slot_worst = np.zeros(S, np.int64)
            self._committed = 0
            self._block_bytes = block_bytes(model, self.block_size,
                                            model.dtype)
            self._decode = self._decode_paged
        else:
            self.block_size = None
            self.kv_blocks = None
            self.prefill_chunk = None
            self._committed = 0
            self._prefix = None
            self._caches = init_caches(model, S, C, model.dtype)
            self._decode = self._decode_dense

        self._cond = threading.Condition()
        self._queue: List[_GenRequest] = []
        self._jobs: List[_PrefillJob] = []
        self._slot_req: List[Optional[_GenRequest]] = [None] * S
        self._slot_job: List[Optional[_PrefillJob]] = [None] * S
        self._admitting: List[_GenRequest] = []  # dense: popped, not slotted
        self._closing = False
        # crash-only worker lifecycle (see ServeEngine): epoch stales a hung
        # worker, restart sheds its in-flight sequences with typed errors
        self._epoch = 0
        self._hb = time.monotonic()
        self._admitted = 0
        self._peak_active = 0
        self._peak_blocks = 0
        self._prefill_sigs = set()
        self._decode_sigs = set()
        # generation -> the compute-dtype copies of its params
        self._casts: Dict[int, dict] = {}
        self._aot_fns: Dict[str, object] = {}

        self._next_tok = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._temps = np.ones(S, np.float32)
        self._topks = np.full(S, self.vocab, np.int64)
        self._gens: List[Optional[torch.Generator]] = [None] * S

        m = self.metrics
        self._m_active = m.gauge("serve_gen_active_slots", self._lbl(),
                                 help="in-flight generation slots")
        self._m_qdepth = m.gauge("serve_gen_queue_depth", self._lbl(),
                                 help="generation requests waiting for a slot")
        self._m_admitted = m.counter("serve_gen_admitted_total", self._lbl(),
                                     help="generation requests prefilled")
        self._m_completed = m.counter("serve_gen_completed_total", self._lbl(),
                                      help="generation requests finished")
        self._m_tokens = m.counter("serve_gen_tokens_total", self._lbl(),
                                   help="tokens decoded across all slots")
        self._m_decode_s = m.histogram("serve_gen_decode_seconds", self._lbl(),
                                       help="one all-slots decode tick")
        self._m_prefill_s = m.histogram("serve_gen_prefill_seconds",
                                        self._lbl(),
                                        help="prompt prefill time "
                                             "(per chunk when chunked)")
        self._m_occupancy = m.histogram(
            "serve_gen_slot_occupancy", self._lbl(),
            buckets=tuple((i + 1) / S for i in range(S)),
            help="active slots / total slots per decode tick")
        self._m_compiles = m.counter(
            "serve_compile_misses_total", self._lbl({"component": "generate"}),
            help="new (bucket, shape) signatures served")
        if kv == "paged":
            m.gauge("serve_kv_blocks_total", self._lbl(),
                    help="allocatable KV blocks (excl. trash block)"
                    ).set(self._alloc.usable)
            self._m_kv_used = m.gauge("serve_kv_blocks_used", self._lbl(),
                                      help="KV blocks currently allocated")
            self._m_kv_util = m.gauge(
                "serve_kv_block_utilization", self._lbl(),
                help="allocated / allocatable KV blocks")
            self._m_kv_bytes = m.gauge(
                "serve_kv_live_bytes", self._lbl(),
                help="bytes of KV pool backing live tokens (all layers)")
            self._m_pf_depth = m.gauge(
                "serve_prefill_queue_depth", self._lbl(),
                help="prompts mid-prefill (chunked jobs in flight)")
            self._m_pf_chunks = m.counter(
                "serve_prefill_chunks_total", self._lbl(),
                help="prefill chunks executed")
            self._m_px_hits = m.counter(
                "serve_prefix_cache_hits_total", self._lbl(),
                help="admissions that adopted >= 1 cached prefix block")
            self._m_px_miss = m.counter(
                "serve_prefix_cache_misses_total", self._lbl(),
                help="admissions that found no cached prefix run")
            self._m_px_saved = m.counter(
                "serve_prefill_tokens_saved_total", self._lbl(),
                help="prompt tokens skipped by adopting cached prefix blocks")
            self._m_px_shared = m.gauge(
                "serve_prefix_blocks_shared", self._lbl(),
                help="distinct KV blocks slots hold via sharing "
                     "(adopted prefix runs + fork rows)")
            self._m_cow = m.counter(
                "serve_kv_cow_copies_total", self._lbl(),
                help="copy-on-write block copies (a still-shared block "
                     "was about to be written)")
            self._m_forks = m.counter(
                "serve_gen_forks_total", self._lbl(),
                help="slots forked by block-table row copy")
            self._update_kv_gauges()

        # --- prebuilt-executable store (optional): every device step runs
        # through an AotFunction, warmed here so the decode loop never
        # captures in the request path. strict_aot: a store miss raises a
        # typed AotTraceError instead of capturing, and since the warm runs
        # at construction, the first uncovered step fails the boot ---
        self.strict_aot = bool(strict_aot)
        if self.strict_aot and aot_store is None:
            raise ValueError("strict_aot=True requires an aot_store — "
                             "a storeless batcher can only capture")
        if aot_store is not None:
            from ..aot import AotFunction, arch_fingerprint, boot_kernels

            boot_kernels(aot_store, self.device, self.strict_aot)
            snap0 = self.registry.current()
            arch = arch_fingerprint(snap0.params, snap0.state)
            steps = {"gen_sample": self._sample_fn}
            if kv == "paged":
                steps["gen_decode_paged"] = self._decode_paged_fn
                steps["gen_prefill_chunk"] = self._prefill_paged_fn
            else:
                steps["gen_decode_dense"] = self._decode_dense_fn
                steps["gen_prefill_dense"] = self._prefill_dense_fn
                steps["gen_slot_insert"] = self._slot_insert_fn
            for tag, fn in steps.items():
                self._aot_fns[tag] = AotFunction(
                    fn, tag=tag, store=aot_store, metrics=m, arch=arch,
                    component="generate", compile_counter=self._m_compiles,
                    strict=self.strict_aot, device=self.device,
                    # a slot insert makes nothing lazily, and its warm-up
                    # would write a live slot during a publish
                    warmup=tag != "gen_slot_insert")
            t0 = time.perf_counter()
            self._warm_for(snap0)
            m.gauge("serve_cold_start_seconds",
                    self._lbl({"component": "generate"}),
                    help="wall time to materialize the serving executables"
                    ).set(time.perf_counter() - t0)
            # capture-before-flip: publish warms the candidate's full
            # decode/prefill/sample graph set
            self.registry.add_warmer(self._warm_for,
                                     abort=self._abort_for)

        self._spawn_worker()

    @classmethod
    def from_tuned(cls, model, aot_store, workload_fingerprint: str, *,
                   registry=None, params=None, state=None, metrics=None,
                   model_name=None, **overrides) -> "ContinuousBatcher":
        """Boot with knobs resolved from the store's tuned config for
        (current runtime fingerprint, ``workload_fingerprint``) — see
        ``aot/tuned.py``. Explicit ``overrides`` win; a miss boots the
        constructor defaults."""
        from ..aot.tuned import get_tuned

        config = get_tuned(aot_store, workload_fingerprint, metrics=metrics)
        opts = gen_opts_from_config(config)
        opts.update(overrides)
        return cls(model, registry=registry, params=params, state=state,
                   metrics=metrics, aot_store=aot_store,
                   model_name=model_name, **opts)

    def _spawn_worker(self) -> None:
        self._hb = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, args=(self._epoch,), daemon=True,
            name=f"serve-continuous-batcher-{self._epoch}")
        self._thread.start()

    # ------------------------------------------------------------ device work
    def _generator(self, space: str, n: int) -> torch.Generator:
        """A request's generator on the model's device, seeded from
        ``(seed, space, n)``: admissions and forks draw from disjoint
        spaces."""
        digest = hashlib.sha256(f"{self.seed}:{space}:{n}".encode()).digest()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        return gen

    def _casts_of(self, generation: int) -> dict:
        """The compute-dtype copies of one params generation's weights,
        memoized per generation (same bits as casting every call): a
        publish's warm fills the candidate's beside the current one's."""
        with self._cond:
            return self._casts.setdefault(generation, {})

    def _casts_for(self, snap) -> dict:
        """The worker's casts for ``snap``: older generations' are dropped
        (the worker leases in generation order; a graph keeps what it
        read)."""
        with self._cond:
            for g in [g for g in self._casts if g < snap.generation]:
                del self._casts[g]
        return self._casts_of(snap.generation)

    def cast_bytes(self) -> int:
        """Device bytes held by the compute casts of every generation."""
        with self._cond:
            return sum(cast_bytes(c) for c in self._casts.values())

    # --- the device steps: fn(weights, *inputs), run through _step (an
    # AotFunction with a store: CUDA graphs on the card) ---
    def _step(self, tag: str, fn, generation: int, weights, *inputs):
        aot = self._aot_fns.get(tag)
        if aot is None:
            return fn(weights, *inputs)
        return aot(generation, weights, *inputs)

    def _ints(self, *arrays) -> torch.Tensor:
        """Host int arrays as ONE int64 host tensor (a step copies it to
        the device, or into its graph's static buffer: one copy)."""
        return torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int64).ravel() for a in arrays]))

    def _paged_weights(self, snap) -> tuple:
        return (snap.params, snap.state, self._casts_for(snap), self._pools)

    @graphable
    def _sample_fn(self, weights, logits, packed):
        """The deterministic part of sampling over (S, V) f32 ``logits``:
        the greedy tokens, and ``logits / max(temperature, 1e-6)`` with
        everything below the row's k-th largest masked to -1e30
        (``packed``: the S values V - top_k, then the S temperatures as
        their f32 bit patterns)."""
        logits = logits.to(self.device)
        packed = packed.to(self.device, non_blocking=True)
        n = logits.shape[0]
        greedy = torch.argmax(logits, dim=-1)
        kidx = packed[:n]
        t = packed[n:].to(torch.int32).view(torch.float32)
        scaled = logits / t.clamp_min(1e-6)[:, None]
        kth = torch.sort(scaled, dim=-1).values.gather(1, kidx[:, None])
        masked = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, -1e30))
        return masked, greedy, t

    def _sample(self, generation: int, logits, greedy, temps: np.ndarray,
                topks: np.ndarray, gens: List[Optional[torch.Generator]]
                ) -> torch.Tensor:
        """Next token per row of (S, V) f32 ``logits``: greedy where the
        temperature is <= 0, else top-k (ties kept) Gumbel-max sampling of
        ``logits / max(temperature, 1e-6)`` with noise from the row's
        generator (rows without one are greedy). The noise is drawn
        eagerly, outside any graph, from each row's own generator."""
        if all(g is None for g in gens):
            return greedy
        V = logits.shape[-1]
        k = V - np.clip(topks, 1, V)
        # one copy: the temperatures ride as their f32 bit patterns
        packed = self._ints(k, np.asarray(temps, np.float32).view(np.int32))
        masked, greedy, t = self._step("gen_sample", self._sample_fn,
                                       generation, None, logits, packed)
        samp = categorical(masked, gens)
        return torch.where(t > 0.0, samp, greedy)

    def _sample_one(self, generation: int, last, temperature: float,
                    top_k: Optional[int], gen) -> int:
        """The first token of a request from its prompt's last logits (1,
        V): row 0 of an all-slots sample, the other rows greedy and
        discarded (one sample shape for the server's life)."""
        S = self.slots
        logits = torch.zeros((S, last.shape[-1]), dtype=torch.float32,
                             device=last.device)
        logits[0] = last[0]
        temps = np.zeros(S, np.float32)
        temps[0] = temperature
        topks = np.full(S, self.vocab, np.int64)
        topks[0] = top_k if top_k else self.vocab
        greedy = torch.argmax(logits, dim=-1)
        gens = [gen if temperature > 0 else None] + [None] * (S - 1)
        return int(self._sample(generation, logits, greedy, temps, topks,
                                gens)[0])

    @graphable
    def _decode_paged_fn(self, weights, ints):
        """One token for every slot against the shared pools (``ints``:
        tokens, positions, then the (S, maxb) block tables). Returns the
        (S, V) f32 logits and the greedy tokens."""
        params, state, casts, pools = weights
        S = self.slots
        ints = ints.to(self.device, non_blocking=True)
        tables_d = ints[2 * S:].view(S, self._maxb)
        caches = {lk: {"k_pool": pools[lk]["k"], "v_pool": pools[lk]["v"],
                       "tables": tables_d} for lk in self._lks}
        lg, _ = decode_forward(self.model, params, state, ints[:S, None],
                               caches, ints[S:2 * S], casts=casts)
        logits = lg[:, 0]
        return logits, torch.argmax(logits, dim=-1)

    @graphable
    def _decode_dense_fn(self, weights, ints):
        """One token for every slot against the slot-major caches
        (``ints``: tokens, then positions)."""
        params, state, casts, caches = weights
        S = self.slots
        ints = ints.to(self.device, non_blocking=True)
        lg, _ = decode_forward(self.model, params, state, ints[:S, None],
                               caches, ints[S:], casts=casts)
        logits = lg[:, 0]
        return logits, torch.argmax(logits, dim=-1)

    def _decode_paged(self, snap, toks, pos, tables, temps, topks,
                      gens) -> np.ndarray:
        """One token for every slot against the shared pools: inactive
        slots carry zeroed table rows, so their writes land in the trash
        block and their samples are discarded. Returns the S next tokens
        on the host (the tick's one sync)."""
        logits, greedy = self._step(
            "gen_decode_paged", self._decode_paged_fn, snap.generation,
            self._paged_weights(snap), self._ints(toks, pos, tables))
        return self._sample(snap.generation, logits, greedy, temps, topks,
                            gens).cpu().numpy()

    def _decode_dense(self, snap, toks, pos, tables, temps, topks,
                      gens) -> np.ndarray:
        """One token for every slot against the slot-major caches."""
        logits, greedy = self._step(
            "gen_decode_dense", self._decode_dense_fn, snap.generation,
            (snap.params, snap.state, self._casts_for(snap), self._caches),
            self._ints(toks, pos))
        return self._sample(snap.generation, logits, greedy, temps, topks,
                            gens).cpu().numpy()

    @graphable
    def _prefill_paged_fn(self, weights, ints):
        """One prompt chunk for one slot (``ints``: the (bucket,) ids
        right-padded, the slot's table row, then the chunk's offset); pad
        garbage past the row's blocks lands in the trash block. Returns
        the (1, bucket, V) logits."""
        params, state, casts, pools = weights
        ints = ints.to(self.device, non_blocking=True)
        b = ints.shape[0] - self._maxb - 1
        caches = {lk: {"k_pool": pools[lk]["k"], "v_pool": pools[lk]["v"],
                       "tables": ints[b:b + self._maxb].view(1, -1)}
                  for lk in self._lks}
        lg, _ = decode_forward(self.model, params, state, ints[None, :b],
                               caches, ints[-1:], casts=casts)
        return lg

    def _prefill_paged(self, snap, ids, table_row, off, true_len):
        """One prompt chunk for one slot; returns the logits at the last
        REAL token (1, V), a copy of its own."""
        lg = self._step("gen_prefill_chunk", self._prefill_paged_fn,
                        snap.generation, self._paged_weights(snap),
                        self._ints(ids, table_row, [off]))
        return lg[:, true_len - 1].clone()

    @graphable
    def _prefill_dense_fn(self, weights, ids):
        """Prefill ``ids`` (bucket,) into a fresh one-row cache; returns
        the (1, bucket, V) logits and the cache's K and V per layer."""
        params, state, casts = weights
        cache = init_caches(self.model, 1, self.capacity, self.model.dtype)
        lg, cache = decode_forward(self.model, params, state,
                                   ids.to(self.device)[None], cache, 0,
                                   casts=casts)
        return lg, tuple(t for lk in self._lks
                         for t in (cache[lk]["k"], cache[lk]["v"]))

    @graphable
    def _slot_insert_fn(self, caches, slot, *kv):
        """Copy a one-row cache (K and V per layer, ``_lks`` order) into
        slot ``slot`` ((1,) int64) of the slot-major caches."""
        slot = slot.to(self.device)
        for i, lk in enumerate(self._lks):
            caches[lk]["k"].index_copy_(0, slot, kv[2 * i])
            caches[lk]["v"].index_copy_(0, slot, kv[2 * i + 1])

    def _prefill_dense(self, snap, ids, true_len):
        """Prefill ``ids`` (bucket,) into a fresh one-row cache; returns
        (logits at the last REAL token (1, V), the cache's tensors)."""
        lg, kv = self._step("gen_prefill_dense", self._prefill_dense_fn,
                            snap.generation,
                            (snap.params, snap.state, self._casts_for(snap)),
                            torch.from_numpy(np.asarray(ids, np.int64)))
        return lg[:, true_len - 1].clone(), kv

    def step_probe(self, kind: str = "decode", size: int = 0, *,
                   sampled: int = 0, temperature: float = 1.0,
                   top_k: Optional[int] = None):
        """A callable that runs one step of the worker's device work by
        itself, to profile or time it (paged mode, with nothing in flight;
        with a store, a replay of the step's graph): ``"decode"`` is one
        all-slots tick whose first ``sampled`` rows sample at
        ``temperature`` and ``top_k`` (the rest greedy), and returns after
        the tick's host sync; ``"prefill"`` is one chunk of ``size``
        tokens for one row, returned without a sync. Every table row is
        zero, so each KV write lands in the trash block and no request's
        pages are touched."""
        if self.kv != "paged":
            raise ValueError("step_probe needs kv='paged'")
        snap = self.registry.current()
        S = self.slots
        if kind == "prefill":
            ids, row = np.zeros(size, np.int64), np.zeros(self._maxb, np.int64)

            def prefill():
                with torch.inference_mode():
                    return self._prefill_paged(snap, ids, row, 0, size)
            return prefill
        if kind != "decode":
            raise ValueError(f"unknown step kind {kind!r}")
        gens = [self._generator("probe", i) if i < sampled else None
                for i in range(S)]
        temps = np.where(np.arange(S) < sampled, temperature,
                         0.0).astype(np.float32)
        topks = np.full(S, top_k or self.vocab, np.int64)
        zeros = np.zeros(S, np.int64)
        tables = np.zeros((S, self._maxb), np.int64)

        def decode():
            with torch.inference_mode():
                return self._decode_paged(snap, zeros, zeros, tables, temps,
                                          topks, gens)
        return decode

    # ---------------------------------------------------------------- warming
    def _warm_for(self, snap) -> None:
        """Make the full static executable set for one params generation —
        the lifetime decode step, every prefill bucket, and the sampler —
        from the store (on the card: captured graphs). Runs at
        construction for the current generation and as a registry warmer
        for each publish candidate. Each warm-up input writes nowhere
        live: zero block tables land in the trash block, dense positions
        at the capacity are dropped."""
        S, V, gen = self.slots, self.vocab, snap.generation
        with torch.inference_mode():
            self._aot_fns["gen_sample"].warm(
                gen, None, torch.zeros((S, V), dtype=torch.float32),
                self._ints(np.zeros(S), np.zeros(S)))
            casts = self._casts_of(gen)
            if self.kv == "paged":
                w = (snap.params, snap.state, casts, self._pools)
                self._aot_fns["gen_decode_paged"].warm(
                    gen, w, self._ints(np.zeros(2 * S + S * self._maxb)))
                for b in self._chunk_buckets:
                    self._aot_fns["gen_prefill_chunk"].warm(
                        gen, w, self._ints(np.zeros(b + self._maxb + 1)))
            else:
                self._aot_fns["gen_decode_dense"].warm(
                    gen, (snap.params, snap.state, casts, self._caches),
                    self._ints(np.zeros(S), np.full(S, self.capacity)))
                for b in self.prompt_buckets:
                    self._aot_fns["gen_prefill_dense"].warm(
                        gen, (snap.params, snap.state, casts),
                        torch.zeros(b, dtype=torch.int64))
                one = init_caches(self.model, 1, self.capacity,
                                  self.model.dtype)
                self._aot_fns["gen_slot_insert"].warm(
                    gen, self._caches, torch.zeros(1, dtype=torch.int64),
                    *(t for lk in self._lks
                      for t in (one[lk]["k"], one[lk]["v"])))

    def _abort_for(self, snap) -> None:
        """Registry abort hook: a failed publish's graphs and compute
        casts go (the next publish reuses its generation number)."""
        for fn in self._aot_fns.values():
            fn.drop(snap.generation)
        with self._cond:
            self._casts.pop(snap.generation, None)

    def aot_functions(self) -> dict:
        """Tag -> :class:`~..aot.AotFunction` for every store-backed
        generation executable ({} without a store) — how a prebuild run
        gathers the concrete keys for the coverage record."""
        return dict(self._aot_fns)

    def _copy_blocks(self, pairs: List[tuple]) -> None:
        """Copy-on-write device work: duplicate each ``(src, dst)`` block
        in every layer's K/V pool."""
        idx = self._ints([p[0] for p in pairs], [p[1] for p in pairs]).to(
            self.device, non_blocking=True)
        src, dst = idx[:len(pairs)], idx[len(pairs):]
        for lk in self._lks:
            pool = self._pools[lk]
            pool["k"][dst] = pool["k"][src]
            pool["v"][dst] = pool["v"][src]

    # ------------------------------------------------------------------ admit
    def _lbl(self, labels: Optional[dict] = None) -> dict:
        out = dict(labels or {})
        if self.model_name is not None:
            out["model"] = self.model_name
        return out

    def _shed_counter(self, cause: str):
        return self.metrics.counter(
            "serve_shed_total", self._lbl({"cause": cause}),
            help="requests refused at admission, by cause")

    def queue_depth(self) -> int:
        """Generation requests waiting for a slot (Retry-After input)."""
        with self._cond:
            return len(self._queue)

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 1.0,
               top_k: Optional[int] = None, eos_id: Optional[int] = None,
               timeout_ms: Optional[float] = None, ctx=None) -> _GenRequest:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError("submit() takes one non-empty 1-D token prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.shape[0] + int(max_new_tokens) > self.capacity:
            raise CapacityError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds cache capacity {self.capacity}")
        if self.kv == "paged":
            worst = blocks_needed(prompt.shape[0] + int(max_new_tokens),
                                  self.block_size)
            if worst > self._alloc.usable:
                # queueing can't help: this request can NEVER fit
                self._shed_counter("over_capacity").inc()
                raise CapacityError(
                    f"request needs {worst} KV blocks but the pool only has "
                    f"{self._alloc.usable} — raise kv_blocks or lower "
                    f"max_new_tokens")
        deadline = (time.perf_counter() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        req = _GenRequest(prompt, max_new_tokens, temperature, top_k,
                          eos_id, deadline, ctx=ctx)
        with self._cond:
            if self._closing:
                self._shed_counter("shutting_down").inc()
                raise ServerClosingError("batcher is draining; not accepting "
                                         "new requests")
            if not self._thread.is_alive():
                # fail fast: a dead decode loop means this request would
                # queue forever; a watchdog (if running) restarts it
                self._shed_counter("worker_dead").inc()
                raise ServerClosingError(
                    "batcher worker thread is dead; request refused "
                    "(run a Watchdog for automatic crash-only restart)",
                    cause="worker_dead")
            if len(self._queue) >= self.queue_limit:
                self._shed_counter("queue_full").inc()
                raise ShedError(f"generation queue full "
                                f"({self.queue_limit}); shedding load")
            self._queue.append(req)
            self._m_qdepth.set(len(self._queue))
            self._cond.notify_all()
        return req

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 ctx=None) -> np.ndarray:
        """Blocking generate. ``prompt``: (T,) ids -> returns (N,) ids;
        (B, T) -> (B, N), rows eos-padded to the longest. Greedy chains
        match ``nn.generation.generate``."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            return self.submit(prompt, max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               eos_id=eos_id, timeout_ms=timeout_ms,
                               ctx=ctx).wait()
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            top_k=top_k, eos_id=eos_id,
                            timeout_ms=timeout_ms, ctx=ctx) for p in prompt]
        outs = [r.wait() for r in reqs]
        width = max(o.shape[0] for o in outs)
        pad = eos_id if eos_id is not None else 0
        full = np.full((len(outs), width), pad, np.int32)
        for i, o in enumerate(outs):
            full[i, :o.shape[0]] = o
        return full

    def stream(self, prompt, max_new_tokens: int, *,
               temperature: float = 1.0, top_k: Optional[int] = None,
               eos_id: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               ctx=None) -> Iterator[int]:
        """Submit and yield tokens one at a time as they are decoded."""
        return self.submit(np.asarray(prompt, np.int32), max_new_tokens,
                           temperature=temperature, top_k=top_k,
                           eos_id=eos_id, timeout_ms=timeout_ms,
                           ctx=ctx).stream()

    def cancel(self, req: _GenRequest, cause: str = "client_gone") -> bool:
        """Abandon one request whose consumer vanished (e.g. the SSE client
        dropped the socket). A queued request is removed and finished at
        once; an admitted one is flagged and retired by the worker at its
        next safe point (<= one decode tick), which releases its KV pages.
        Counts ``serve_shed_total{cause=...}``. Idempotent; returns False
        when the request already finished."""
        err = ShedError(f"request abandoned by its consumer ({cause})",
                        cause=cause)
        queued = False
        with self._cond:
            if req.event.is_set() or req.cancelled is not None:
                return False
            if req in self._queue:
                self._queue.remove(req)
                self._m_qdepth.set(len(self._queue))
                queued = True
            else:
                req.cancelled = err
                self._cond.notify_all()
        self._shed_counter(cause).inc()
        if queued:
            req._finish(err)
        return True

    def fork(self, req: _GenRequest, *, max_new_tokens: Optional[int] = None,
             temperature: Optional[float] = None,
             top_k: Optional[int] = None) -> _GenRequest:
        """Clone a decoding request into a free slot by duplicating its
        block-table row with refcount++ on every block: one row copy, never
        KV bytes. The child resumes from the parent's exact decode state
        and returns only tokens generated after the fork point; it draws
        from its own generator (a disjoint seed space), so sampled
        continuations diverge and greedy ones coincide. The partial tail
        block is copied on first write. ``kv="paged"`` only. Raises
        :class:`ShedError` when no free slot or block headroom exists,
        :class:`ServeError` when ``req`` is not decoding in a slot."""
        if self.kv != "paged":
            raise ServeError("fork() requires kv='paged' (block-table rows "
                             "are what make forking copy-free)")
        with self._cond:
            self._fork_salt += 1
            salt = self._fork_salt
        gen = self._generator("fork", salt)
        with self._cond:
            s = req.slot
            if s is None or self._slot_req[s] is not req \
                    or req.event.is_set():
                raise ServeError("fork() needs a request currently decoding "
                                 "in a slot (not queued, prefilling, or "
                                 "finished)")
            t = next((i for i in range(self.slots)
                      if self._slot_req[i] is None
                      and self._slot_job[i] is None), None)
            if t is None:
                self._shed_counter("fork_no_slot").inc()
                raise ShedError("fork(): no free decode slot")
            parent_pages = self._slot_pages[s]
            pos = int(self._pos[s])
            max_new = int(max_new_tokens if max_new_tokens is not None
                          else max(1, req.max_new - len(req.out)))
            if max_new < 1:
                raise ValueError("fork max_new_tokens must be >= 1")
            if pos + max_new > self.capacity:
                raise CapacityError(
                    f"fork at position {pos} + max_new_tokens {max_new} "
                    f"exceeds cache capacity {self.capacity}")
            # charge only what the child can ever privately allocate: its
            # growth blocks plus one CoW copy of the partial tail; whole
            # shared blocks stay shared forever and ride the ledger instead
            worst = blocks_needed(pos + max_new, self.block_size) \
                - pos // self.block_size
            blocks = list(parent_pages.blocks)
            fresh = sum(1 for b in blocks if b not in self._shared_ledger)
            if self._committed + worst + len(self._shared_ledger) + fresh \
                    > self._alloc.usable:
                self._shed_counter("fork_capacity").inc()
                raise ShedError(
                    f"fork(): insufficient KV block headroom (need {worst} "
                    f"committed + {fresh} shared)")
            child = _GenRequest(req.prompt, max_new,
                                float(temperature if temperature is not None
                                      else req.temperature),
                                top_k if top_k is not None else req.top_k,
                                req.eos_id, req.deadline)
            self._alloc.retain(blocks)
            pages = SlotPages(self._alloc, self.block_size)
            pages.adopt(blocks)
            self._ledger_add(blocks)
            self._committed += worst
            self._slot_pages[t] = pages
            self._slot_worst[t] = worst
            self._slot_req[t] = child
            child.slot = t
            self._tables_np[t] = self._tables_np[s]
            self._next_tok[t] = self._next_tok[s]
            self._pos[t] = pos
            self._temps[t] = child.temperature
            self._topks[t] = child.top_k if child.top_k else self.vocab
            self._gens[t] = gen
            self._forks += 1
            self._m_forks.inc()
            self._m_admitted.inc()
            active = sum(1 for r in self._slot_req if r is not None)
            self._peak_active = max(self._peak_active, active)
            self._m_active.set(active)
            self._update_kv_gauges()
            self._cond.notify_all()
        return child

    # ---------------------------------------------------------------- serving
    def _bucket(self, t: int) -> int:
        for b in self.prompt_buckets:
            if b >= t:
                return b
        raise CapacityError(f"prompt length {t} exceeds largest prompt "
                            f"bucket {self.prompt_buckets[-1]}")

    def _chunk_bucket(self, t: int) -> int:
        for b in self._chunk_buckets:
            if b >= t:
                return b
        return self._chunk_buckets[-1]

    def _plan_chunks(self, tp: int, start: int = 0) -> List[tuple]:
        """Split a prompt into (offset, true_len, padded_bucket) chunks.
        ``start`` (block-aligned, < tp) skips the prefix already covered by
        adopted cache blocks. Full chunks run at exactly ``prefill_chunk``;
        the tail pads to the smallest chunk bucket that covers it.
        ``prefill_chunk=None`` is one whole-prompt chunk."""
        if self.prefill_chunk is None:
            return [(start, tp - start, self._bucket(tp - start))]
        chunks, off = [], start
        while tp - off > self.prefill_chunk:
            chunks.append((off, self.prefill_chunk, self.prefill_chunk))
            off += self.prefill_chunk
        tail = tp - off
        chunks.append((off, tail, self._chunk_bucket(tail)))
        return chunks

    def _update_kv_gauges(self) -> None:
        used = self._alloc.used
        self._peak_blocks = max(self._peak_blocks, used)
        self._m_kv_used.set(used)
        self._m_kv_util.set(used / self._alloc.usable)
        self._m_kv_bytes.set(used * self._block_bytes)
        self._m_px_shared.set(len(self._shared_ledger))

    # --- shared-block ledger: blocks held via retain (adoption/forks) sit
    # outside every commitment, so admission must subtract them from the
    # pool; counted per (block, holding slot) and sized by distinct block ---
    def _ledger_add(self, blocks) -> None:
        for b in blocks:
            self._shared_ledger[b] = self._shared_ledger.get(b, 0) + 1

    def _ledger_drop(self, blocks) -> None:
        for b in blocks:
            c = self._shared_ledger.get(b, 0)
            if c <= 1:
                self._shared_ledger.pop(b, None)
            else:
                self._shared_ledger[b] = c - 1

    def _release_pages(self, pages: SlotPages) -> None:
        """Retire a slot's pages, dropping its shared refs from the ledger
        first (refcounts make the release itself uniform)."""
        if pages.shared:
            self._ledger_drop(pages.shared)
        pages.release()

    def _write_table_row(self, s: int, blocks: List[int]) -> None:
        row = np.zeros(self._maxb, np.int64)
        row[:len(blocks)] = blocks
        self._tables_np[s] = row

    def _admit_locked(self, generation: int = 0) -> List[tuple]:
        """Under ``self._cond``: hand free slots to queued requests. Dense
        mode returns (slot, req) pairs to prefill under the caller's lease;
        paged mode creates :class:`_PrefillJob` state machines (FIFO: a
        head request waiting on blocks holds the line). Paged admission
        charges only NON-shared blocks: the longest cached prefix run of
        ``generation`` is matched first, the gate subtracts the charge and
        every shared block outside any commitment, and only then are the
        cached blocks adopted and the suffix planned."""
        admits = []
        for s in range(self.slots):
            if not self._queue:
                break
            if self._slot_req[s] is not None or self._slot_job[s] is not None:
                continue
            if self.kv == "dense":
                admits.append((s, self._queue.pop(0)))
                continue
            req = self._queue[0]
            tp = req.prompt.shape[0]
            hashes: List[bytes] = []
            run: List[int] = []
            if self._prefix is not None:
                hashes = prefix_hashes(req.prompt, self.block_size)
                # never adopt the whole prompt: at least one real token
                # must prefill so the first sample has logits to read
                run = self._prefix.match(hashes, generation,
                                         (tp - 1) // self.block_size)
            shared = len(run)
            worst = blocks_needed(tp + req.max_new, self.block_size) - shared
            fresh = sum(1 for b in run if b not in self._shared_ledger)
            if self._committed + worst + len(self._shared_ledger) + fresh \
                    > self._alloc.usable:
                break  # wait for in-flight sequences to release blocks
            self._queue.pop(0)
            self._committed += worst
            pages = SlotPages(self._alloc, self.block_size)
            if shared:
                self._prefix.adopt(hashes, run)
                pages.adopt(run)
                self._ledger_add(run)
                self._px_hits += 1
                self._m_px_hits.inc()
                self._m_px_saved.inc(shared * self.block_size)
            elif self._prefix is not None:
                self._px_misses += 1
                self._m_px_miss.inc()
            job = _PrefillJob(
                req, s, pages,
                self._plan_chunks(tp, shared * self.block_size), worst,
                shared=shared, hashes=hashes)
            self._slot_job[s] = job
            self._jobs.append(job)
        if self.kv == "paged":
            self._m_pf_depth.set(len(self._jobs))
        return admits

    def _abort_job(self, job: _PrefillJob, err: ServeError) -> None:
        with self._cond:
            if job in self._jobs:
                self._jobs.remove(job)
            self._slot_job[job.slot] = None
            self._release_pages(job.pages)
            self._committed -= job.worst
            self._write_table_row(job.slot, [])
            self._update_kv_gauges()
            self._m_pf_depth.set(len(self._jobs))
        job.req._finish(err)

    def _note_prefill(self, bucket: int) -> None:
        with self._cond:
            sig = ("prefill", bucket)
            if sig not in self._prefill_sigs:
                self._prefill_sigs.add(sig)
                # with a store, AotFunction counts captures without record
                if not self._aot_fns:
                    self._m_compiles.inc()

    def _prefill_step(self, job: _PrefillJob, snap) -> None:
        """Advance one chunk of one prompt (paged mode)."""
        off, true_len, bucket = job.chunks[job.idx]
        with self._cond:
            if self._slot_job[job.slot] is not job:
                return  # aborted (forced shutdown) since this tick was planned
            job.pages.ensure(off + true_len)
            self._write_table_row(job.slot, job.pages.blocks)
            table_row = self._tables_np[job.slot].copy()
            self._update_kv_gauges()
        ids = np.zeros(bucket, np.int64)
        ids[:true_len] = job.req.prompt[off:off + true_len]
        if _prof.ACTIVE is not None:
            _prof.ACTIVE.hint("generate", true_len, bucket)
        t0 = time.perf_counter()
        job.last = self._prefill_paged(snap, ids, table_row, off, true_len)
        t1 = time.perf_counter()
        ctx = job.req.ctx
        if ctx is None:
            self._m_prefill_s.observe(t1 - t0)
        else:
            self._m_prefill_s.observe(t1 - t0, trace_id=ctx.trace_id)
            if job.idx == 0:  # first chunk closes the queue-wait stage
                # (its offset is nonzero when a cached prefix was adopted)
                ctx.add_stage("queue", int(job.req.enq_t * 1e9),
                              int(t0 * 1e9))
            ctx.add_stage("prefill_chunk", int(t0 * 1e9), int(t1 * 1e9),
                          offset=off, bucket=bucket)
        self._m_pf_chunks.inc()
        job.gens.add(snap.generation)
        job.idx += 1
        self._note_prefill(bucket)
        if job.idx == len(job.chunks):
            self._finish_prefill(job, snap.generation)

    def _start_decoding(self, s: int, req: _GenRequest, last, generation: int,
                        job: Optional[_PrefillJob] = None) -> None:
        """Sample the first token from the prompt's last logits with the
        request's generator, then flip slot ``s`` to decoding (retiring
        ``job``, the paged prefill, in the same critical section, so the
        slot never looks free in between)."""
        if req.ctx is not None:
            # decode starts with the token-0 sample, not the first tick — a
            # request wedged before any tick completes still shows the stage
            req.ctx.decode_begin()
        with self._cond:
            self._admitted += 1
            n = self._admitted
        gen = self._generator("admit", n)
        tok0 = self._sample_one(generation, last, req.temperature, req.top_k,
                                gen)
        with self._cond:
            if job is not None:
                if self._slot_job[s] is not job:
                    return  # shed by a restart or forced shutdown meanwhile
                if job in self._jobs:
                    self._jobs.remove(job)
                self._slot_job[s] = None
                self._slot_pages[s] = job.pages
                self._slot_worst[s] = job.worst
                self._m_pf_depth.set(len(self._jobs))
            req.slot = s
            self._slot_req[s] = req
            self._next_tok[s] = tok0
            self._pos[s] = req.prompt.shape[0]
            self._temps[s] = req.temperature
            self._topks[s] = req.top_k if req.top_k else self.vocab
            self._gens[s] = gen
            self._m_admitted.inc()
            active = sum(1 for r in self._slot_req if r is not None)
            self._peak_active = max(self._peak_active, active)
            self._m_active.set(active)
        req._push(tok0)
        # a 1-token request (or instant EOS) finishes without ever decoding
        self._maybe_finish(s)

    def _finish_prefill(self, job: _PrefillJob, generation: int) -> None:
        """Last chunk done: cache the prompt's full blocks, then sample the
        first token and flip the slot from prefilling to decoding."""
        req, s = job.req, job.slot
        gen_now = (self.registry.generation
                   if self._prefix is not None else None)
        with self._cond:
            if self._slot_job[s] is not job:
                return  # aborted (forced shutdown) mid-prefill
            if self._prefix is not None and job.hashes \
                    and job.gens == {gen_now}:
                # skipped if a publish flipped the params mid-prefill: that
                # KV mixes generations and must retire with its slot
                nfull = req.prompt.shape[0] // self.block_size
                self._prefix.insert(job.hashes[:nfull],
                                    job.pages.blocks[:nfull], gen_now)
        self._start_decoding(s, req, job.last, generation, job)

    def _admit_into_slot(self, s: int, req: _GenRequest, snap) -> None:
        """Dense admission: whole-prompt prefill under the caller's lease,
        the one-row cache inserted into slot ``s``."""
        tp = req.prompt.shape[0]
        bucket = self._bucket(tp)
        ids = np.zeros(bucket, np.int64)
        ids[:tp] = req.prompt
        if _prof.ACTIVE is not None:
            _prof.ACTIVE.hint("generate", tp, bucket)
        t0 = time.perf_counter()
        last, kv = self._prefill_dense(snap, ids, tp)
        t1 = time.perf_counter()
        if req.ctx is None:
            self._m_prefill_s.observe(t1 - t0)
        else:
            self._m_prefill_s.observe(t1 - t0, trace_id=req.ctx.trace_id)
            req.ctx.add_stage("queue", int(req.enq_t * 1e9), int(t0 * 1e9))
            req.ctx.add_stage("prefill_chunk", int(t0 * 1e9), int(t1 * 1e9),
                              offset=0, bucket=bucket)
        self._step("gen_slot_insert", self._slot_insert_fn, snap.generation,
                   self._caches, torch.tensor([s], dtype=torch.int64), *kv)
        self._note_prefill(bucket)
        self._start_decoding(s, req, last, snap.generation)

    def _maybe_finish(self, s: int) -> None:
        with self._cond:
            req = self._slot_req[s]
            if req is None:
                return
            done = (req.cancelled is not None
                    or len(req.out) >= req.max_new
                    or (req.eos_id is not None and req.out
                        and req.out[-1] == req.eos_id))
            if not done:
                return
            self._slot_req[s] = None
            self._gens[s] = None
            if self.kv == "paged" and self._slot_pages[s] is not None:
                # copy-free retirement: blocks drop one reference (cached/
                # shared ones survive in their other holders) and the table
                # row zeroes (points at trash)
                self._release_pages(self._slot_pages[s])
                self._slot_pages[s] = None
                self._committed -= int(self._slot_worst[s])
                self._slot_worst[s] = 0
                self._write_table_row(s, [])
                self._update_kv_gauges()
            self._m_completed.inc()
            self._m_active.set(sum(1 for r in self._slot_req if r is not None))
        req._finish(req.cancelled)

    def _tick(self, snap, epoch: int) -> None:
        """Decode one token for every slot; bookkeep the active ones."""
        # chaos seam, deliberately BEFORE any device work or pool mutation:
        # an injected error/hang here simulates a wedged or dying decode
        # step without leaving a half-written cache behind
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.hit("serve.decode_step")
        cow: List[tuple] = []
        tables = None
        with self._cond:
            if self._epoch != epoch:
                return  # staled by a crash-only restart
            active = [s for s in range(self.slots)
                      if self._slot_req[s] is not None]
            if not active:
                return
            if self.kv == "paged":
                # grow lazily to cover the token this tick writes; the
                # admission-time worst-case commitment guarantees success
                for s in active:
                    pages = self._slot_pages[s]
                    pages.ensure(int(self._pos[s]) + 1)
                    wb = int(self._pos[s]) // self.block_size
                    blk = pages.blocks[wb]
                    if self._alloc.refcount(blk) > 1:
                        # copy-on-write: a fork peer still references the
                        # block this tick writes (only ever the partial
                        # tail) — swap in a private copy first
                        new = self._alloc.alloc(1)[0]
                        if blk in pages.shared:
                            self._ledger_drop([blk])
                        pages.swap(wb, new)
                        cow.append((blk, new))
                        self._cow_copies += 1
                        self._m_cow.inc()
                    self._write_table_row(s, pages.blocks)
                self._update_kv_gauges()
                mask = np.zeros(self.slots, bool)
                mask[active] = True
                # inactive rows: zero tables (writes -> trash) + position 0
                tables = np.where(mask[:, None], self._tables_np, 0)
                pos = np.where(mask, self._pos, 0)
            else:
                pos = np.array(self._pos)
            toks = np.array(self._next_tok)
            temps = np.array(self._temps)
            topks = np.array(self._topks)
            gens = [self._gens[s] if s in active and temps[s] > 0 else None
                    for s in range(self.slots)]
        if _prof.ACTIVE is not None:
            _prof.ACTIVE.hint("generate", len(active), self.slots)
        t0 = time.perf_counter()
        if cow:
            # the pools are only ever touched by this worker thread
            self._copy_blocks(cow)
        nxt = self._decode(snap, toks, pos, tables, temps, topks, gens)
        t1 = time.perf_counter()
        self._m_decode_s.observe(t1 - t0)
        self._m_occupancy.observe(len(active) / self.slots)
        self._m_tokens.inc(len(active))
        pushes = []
        with self._cond:
            if self._epoch != epoch:
                return  # restart raced the device call; drop the bookkeeping
            sig = ("decode", self.slots)
            if sig not in self._decode_sigs:
                self._decode_sigs.add(sig)
                if not self._aot_fns:  # with a store, AotFunction counts
                    self._m_compiles.inc()
            t0_ns = t1_ns = -1  # ns conversion done lazily: traced reqs only
            for s in active:
                req = self._slot_req[s]
                if req is None:
                    continue
                if req.ctx is not None:
                    if t1_ns < 0:
                        t0_ns, t1_ns = int(t0 * 1e9), int(t1 * 1e9)
                    req.ctx.decode_tick(t0_ns, t1_ns)
                tok = int(nxt[s])
                self._next_tok[s] = tok
                self._pos[s] = self._pos[s] + 1
                pushes.append((req, tok))
        for req, tok in pushes:
            req._push(tok)
        for s in active:
            self._maybe_finish(s)

    def _loop(self, epoch: int) -> None:
        try:
            with torch.inference_mode():  # thread-local: entered here
                self._run_loop(epoch)
        except BaseException:
            # the decode loop is dying: a silent death would hang every
            # queued and in-flight caller — shed everything with a typed
            # error before the thread exits. submit() fails fast
            # afterwards; a watchdog restarts us.
            finish: List[_GenRequest] = []
            with self._cond:
                if self._epoch == epoch and not self._closing:
                    finish = self._shed_inflight_locked(include_queue=True)
            if finish:
                err = WorkerStallError(
                    "batcher worker died; generation shed, safe to retry")
                for req in finish:
                    self._shed_counter("worker_stall").inc()
                    req._finish(err)
            raise

    def _run_loop(self, epoch: int) -> None:
        while True:
            # registry generation, read OUTSIDE self._cond (the registry
            # has its own lock): keys prefix-cache adoption, so a publish
            # flushes stale runs at the next admission
            gen = (self.registry.generation
                   if self.kv == "paged" and self._prefix is not None else 0)
            with self._cond:
                if self._epoch != epoch:
                    return  # staled by a crash-only restart
                self._hb = time.monotonic()
                has_active = any(r is not None for r in self._slot_req)
                has_jobs = bool(self._jobs)
                if self._closing and not self._queue and not has_active \
                        and not has_jobs:
                    return
                if not self._queue and not has_active and not has_jobs:
                    self._cond.wait(0.05)
                    continue
                admits = self._admit_locked(gen)
                # dense admits are popped from the queue but not yet in a
                # slot: track them so a restart can still answer them
                self._admitting = [r for _, r in admits]
                self._m_qdepth.set(len(self._queue))
                jobs = list(self._jobs)
                decoding = any(r is not None for r in self._slot_req)
            now = time.perf_counter()
            if self.kv == "paged":
                for job in self.scheduler.plan(jobs, decoding):
                    if job.req.cancelled is not None:
                        # consumer vanished mid-prefill: abort here, where
                        # no device call holds the job's table row
                        self._abort_job(job, job.req.cancelled)
                        continue
                    if job.idx == 0 and job.req.deadline is not None \
                            and now > job.req.deadline:
                        self._abort_job(job, DeadlineExceededError(
                            "deadline exceeded waiting for a decode slot"))
                        continue
                    try:
                        # one lease per chunk: hot-swap drains at chunk
                        # granularity, not whole-prompt granularity
                        with self.registry.lease(tag="gen_prefill") as snap:
                            self._prefill_step(job, snap)
                    except ServeError as e:
                        self._abort_job(job, e)
                    except Exception as e:  # outlive any bad request
                        self._abort_job(job,
                                        ServeError(f"{type(e).__name__}: {e}"))
                with self.registry.lease(tag="gen_decode") as snap:
                    self._tick(snap, epoch)
            else:
                with self.registry.lease(tag="gen_decode") as snap:
                    for s, req in admits:
                        if req.event.is_set():
                            continue  # already shed by a racing restart
                        if req.cancelled is not None:
                            req._finish(req.cancelled)
                            continue
                        if req.deadline is not None and now > req.deadline:
                            req._finish(DeadlineExceededError(
                                "deadline exceeded waiting for a decode slot"))
                            continue
                        try:
                            self._admit_into_slot(s, req, snap)
                        except ServeError as e:
                            req._finish(e)
                        except Exception as e:  # outlive any bad request
                            req._finish(ServeError(f"{type(e).__name__}: {e}"))
                    with self._cond:
                        self._admitting = []
                    self._tick(snap, epoch)

    # ------------------------------------------------- watchdog + crash-only
    def heartbeat(self) -> float:
        """Monotonic timestamp of the decode loop's last liveness beat."""
        return self._hb

    def worker_alive(self) -> bool:
        return self._thread.is_alive()

    def closing(self) -> bool:
        """Whether ``shutdown`` has begun: a decode loop that stopped after it
        is no stall (the watchdog's optional fourth method)."""
        return self._closing

    def _shed_inflight_locked(self, include_queue: bool
                              ) -> List[_GenRequest]:
        """Under ``self._cond``: strip every in-flight sequence (slots,
        prefill jobs, dense mid-admission — plus the queue when asked) out
        of the batcher state, releasing KV pages, and return the orphaned
        requests for the caller to finish OUTSIDE the lock."""
        finish: List[_GenRequest] = list(self._admitting)
        self._admitting = []
        if include_queue:
            finish.extend(self._queue)
            self._queue.clear()
        for job in list(self._jobs):
            self._release_pages(job.pages)
            self._slot_job[job.slot] = None
            self._committed -= job.worst
            finish.append(job.req)
        self._jobs.clear()
        for s, req in enumerate(self._slot_req):
            if req is not None:
                finish.append(req)
                self._slot_req[s] = None
                self._gens[s] = None
            if self.kv == "paged" and self._slot_pages[s] is not None:
                self._release_pages(self._slot_pages[s])
                self._slot_pages[s] = None
                self._committed -= int(self._slot_worst[s])
                self._slot_worst[s] = 0
        if self.kv == "paged":
            self._tables_np[:] = 0
            self._update_kv_gauges()
            self._m_pf_depth.set(0)
        self._m_qdepth.set(len(self._queue))
        self._m_active.set(0)
        return finish

    def restart_worker(self, reason: str = "watchdog") -> bool:
        """Crash-only decode-loop restart: stale the current worker by
        epoch, shed its in-flight sequences (slots + prefill jobs) with
        typed :class:`~.errors.WorkerStallError`, reclaim its registry
        leases, and spawn a fresh worker. Queued requests survive and are
        served by the new worker. Returns False while shutting down."""
        with self._cond:
            if self._closing:
                return False
            old = self._thread
            self._epoch += 1
            finish = self._shed_inflight_locked(include_queue=False)
            self._spawn_worker()
            self._cond.notify_all()
        err = WorkerStallError(
            f"in-flight generation abandoned by batcher restart ({reason}); "
            f"safe to retry")
        for req in finish:
            self._shed_counter("worker_stall").inc()
            req._finish(err)
        self.registry.release_thread(old.ident if old is not None else None)
        return True

    # -------------------------------------------------------------- lifecycle
    @property
    def compile_signatures(self) -> set:
        """The ``("prefill", bucket)`` and ``("decode", slots)`` shapes
        run so far."""
        with self._cond:
            return self._prefill_sigs | self._decode_sigs

    @property
    def peak_active_slots(self) -> int:
        with self._cond:
            return self._peak_active

    @property
    def chunk_buckets(self) -> tuple:
        """The chunk lengths prefill runs at (its static shapes)."""
        return self._chunk_buckets

    def kv_block_stats(self) -> dict:
        """Allocator snapshot (paged mode): totals, usage, live bytes, and
        the sharing picture (prefix cache + shared blocks + CoW/forks)."""
        if self.kv != "paged":
            return {}
        with self._cond:
            used = self._alloc.used
            out = {"block_size": self.block_size,
                   "blocks_total": self._alloc.usable,
                   "blocks_used": used,
                   "blocks_peak": self._peak_blocks,
                   "blocks_committed": self._committed,
                   "live_bytes": used * self._block_bytes,
                   "blocks_shared": len(self._shared_ledger),
                   "cow_copies": self._cow_copies,
                   "forks": self._forks}
            if self._prefix is not None:
                px = self._prefix.stats()
                px["hits"] = self._px_hits
                px["misses"] = self._px_misses
                out["blocks_cached"] = px["entries"]
                out["prefix_cache"] = px
            return out

    def flush_prefix_cache(self) -> int:
        """Release every cached prefix run (admin/testing). Returns the
        number of entries dropped."""
        if self.kv != "paged" or self._prefix is None:
            return 0
        with self._cond:
            n = self._prefix.flush()
            self._update_kv_gauges()
            return n

    def release_device(self) -> None:
        """Drop every device tensor the batcher holds — the KV pools (or
        dense caches), the compute casts, the per-slot generators, the
        store-backed graphs and their pool — after :meth:`shutdown`; the
        fleet calls it when a model pages out. The batcher's decode step
        is a bound method of itself, so without this its memory would wait
        for the cycle collector."""
        with self._cond:
            if self._thread.is_alive():
                raise RuntimeError("release_device() needs a stopped worker")
            self._pools = None
            self._caches = None
            self._casts = {}
            self._gens = [None] * self.slots
            self._decode = None
        for fn in self._aot_fns.values():
            fn.release()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """``drain=True`` finishes every queued and in-flight generation
        first; ``drain=False`` errors them out immediately.

        Returns True on a clean worker exit. If the worker is still alive
        when ``timeout`` expires, it is abandoned crash-only style: all
        remaining work is answered with a typed
        :class:`~.errors.DrainTimeoutError`, its registry leases are
        reclaimed, and False is returned — shutdown never hangs."""
        finish = []
        with self._cond:
            self._closing = True
            if not drain:
                finish = self._shed_inflight_locked(include_queue=True)
            self._cond.notify_all()
        if finish:
            err = ServerClosingError("batcher shut down before dispatch")
            for req in finish:
                req._finish(err)
        self._thread.join(timeout)
        if not self._thread.is_alive():
            return True
        with self._cond:
            self._epoch += 1  # stale the wedged worker
            finish = self._shed_inflight_locked(include_queue=True)
            self._cond.notify_all()
        err = DrainTimeoutError(
            f"shutdown drain timed out after {timeout}s with generation "
            f"in flight")
        for req in finish:
            self._shed_counter("drain_timeout").inc()
            req._finish(err)
        self.registry.release_thread(self._thread.ident)
        return False
