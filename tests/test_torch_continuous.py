"""The port's continuous batcher and paged KV (deeplearning4j_torch/serve/
continuous.py, paged.py) — counterparts of tests/test_serve.py's
``TestContinuousBatcher``, ``TestBlockAllocator``, ``TestPrefillScheduler``,
``TestPagedKV`` and ``TestStreaming`` (the HTTP cases are in
test_torch_http.py) and of tests/test_prefix_cache.py, on the CPU at f32.
Greedy batcher tokens (paged and dense) are held against the JAX
package's ``generate`` on the same params, at f32 and under bf16 compute,
and ``prefix_hashes`` against the JAX package's bytes. Every wait is
bounded and every batcher shuts down in ``finally``.
"""

import concurrent.futures as cf
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn.generation import generate
from deeplearning4j_torch.nn.layers import Dense, Output
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.serve import (BlockAllocator, CapacityError,
                                        ContinuousBatcher,
                                        DeadlineExceededError,
                                        PrefillScheduler, ServeError,
                                        ServerClosingError, ShedError,
                                        WorkerStallError)
from deeplearning4j_torch.serve.paged import (TRASH_BLOCK, PrefixCache,
                                              block_bytes, blocks_needed,
                                              prefix_hashes)
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.nn import generation as jg
from deeplearning4j_tpu.serve import paged as jpaged

WAIT_S = 60  # every blocking wait in this file is bounded by this


@functools.lru_cache(maxsize=None)
def _models(cdt=None):
    """(JAX model, port model) on the same params, computing in ``cdt``
    (None: the params' f32)."""
    jm = JCausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                   num_heads=4, vocab=50).build()
    jm.init()
    tm = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                  num_heads=4, vocab=50, device="cpu").build()
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    jm.config.compute_dtype = tm.config.compute_dtype = cdt
    return jm, tm


@pytest.fixture(scope="module")
def lm():
    return _models()[1]


@functools.lru_cache(maxsize=None)
def _jax_greedy(prompt: tuple, n: int, cdt=None):
    return jg.generate(_models(cdt)[0], np.asarray([prompt], np.int32), n,
                       temperature=0.0)[0]


def _port_greedy(lm, prompt, n):
    return generate(lm, np.asarray(prompt, np.int32)[None], n,
                    temperature=0.0)[0]


def _wait(req):
    assert req.event.wait(WAIT_S), "request did not finish in time"
    return req.wait()


def _dense_model():
    m = Sequential(NetConfig(seed=0),
                   [Dense(n_out=6, activation="gelu"),
                    Output(n_out=3, loss="mcxent", activation="softmax")],
                   (4,), device="cpu")
    m.init()
    return m


class TestContinuousBatcher:
    @pytest.mark.parametrize("kv", ["paged", "dense"])
    def test_greedy_matches_jax_generate(self, lm, kv):
        opts = dict(block_size=4) if kv == "paged" else {}
        cb = ContinuousBatcher(lm, slots=2, capacity=16, kv=kv, seed=0,
                               **opts)
        try:
            rng = np.random.RandomState(0)
            for tp in (8, 5, 10):  # exact-bucket, padded, next bucket
                prompt = rng.randint(0, 50, (tp,)).astype(np.int32)
                got = _wait(cb.submit(prompt, 6, temperature=0.0))
                want = _jax_greedy(tuple(prompt.tolist()), 6)
                assert np.array_equal(got, want), (got, want)
        finally:
            cb.shutdown()

    @pytest.mark.parametrize("kv", ["paged", "dense"])
    def test_bf16_greedy_matches_jax_generate(self, kv):
        """The served precision: bf16 compute over f32 params, every
        request's tokens equal to JAX's bf16 ``generate``."""
        tm = _models("bfloat16")[1]
        opts = dict(block_size=4) if kv == "paged" else {}
        cb = ContinuousBatcher(tm, slots=2, capacity=16, kv=kv, seed=0,
                               **opts)
        try:
            rng = np.random.RandomState(2)
            prompts = [rng.randint(0, 50, (tp,)).astype(np.int32)
                       for tp in (8, 5, 10, 3)]
            reqs = [cb.submit(p, 6, temperature=0.0) for p in prompts]
            for p, r in zip(prompts, reqs):
                want = _jax_greedy(tuple(p.tolist()), 6, "bfloat16")
                got = _wait(r)
                assert np.array_equal(got, want), (got, want)
        finally:
            cb.shutdown()

    def test_slot_reuse_serves_more_requests_than_slots(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, queue_limit=16,
                               seed=0)
        try:
            rng = np.random.RandomState(1)
            prompts = [rng.randint(0, 50, (int(rng.randint(3, 9)),)
                                   ).astype(np.int32) for _ in range(5)]
            with cf.ThreadPoolExecutor(5) as ex:
                outs = list(ex.map(lambda p: _wait(
                    cb.submit(p, 5, temperature=0.0)), prompts))
            for p, o in zip(prompts, outs):
                assert np.array_equal(o, _port_greedy(lm, p, 5))
            assert cb.peak_active_slots <= 2  # never over-subscribed
            m = cb.metrics
            assert m.counter("serve_gen_admitted_total").value == 5
            assert m.counter("serve_gen_completed_total").value == 5
        finally:
            cb.shutdown()

    def test_eos_frees_slot_early(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, seed=0)
        try:
            prompt = np.random.RandomState(2).randint(
                0, 50, (6,)).astype(np.int32)
            free_run = _wait(cb.submit(prompt, 5, temperature=0.0))
            eos = int(free_run[0])
            stopped = _wait(cb.submit(prompt, 5, temperature=0.0,
                                      eos_id=eos))
            assert stopped.tolist() == [eos]  # stopped at the first token
        finally:
            cb.shutdown()

    def test_compile_count_bounded(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16,
                               prompt_buckets=(8, 16), seed=0)
        try:
            rng = np.random.RandomState(3)
            for tp in (3, 5, 8, 11, 13, 4):
                _wait(cb.submit(rng.randint(0, 50, (tp,)).astype(np.int32),
                                2, temperature=0.0))
            sigs = cb.compile_signatures
            # <= |prompt buckets| prefills + ONE decode shape
            assert len(sigs) <= 3, sigs
            assert ("decode", 2) in sigs
        finally:
            cb.shutdown()

    def test_capacity_and_contract_errors_are_typed(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, seed=0)
        try:
            with pytest.raises(CapacityError):
                cb.submit(np.zeros(14, np.int32), 8)  # 14 + 8 > 16
            with pytest.raises(NotImplementedError, match="item 15"):
                cb.submit(np.zeros(4, np.int32), 2, ctx=object())
        finally:
            cb.shutdown()
        with pytest.raises(ValueError, match="embedding-front"):
            ContinuousBatcher(_dense_model(), slots=1, capacity=8)
        with pytest.raises(NotImplementedError, match="item 13"):
            ContinuousBatcher(lm, slots=1, capacity=16, aot_store=object())

    def test_drain_completes_inflight_generations(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, queue_limit=16,
                               seed=0)
        rng = np.random.RandomState(4)
        try:
            reqs = [cb.submit(rng.randint(0, 50, (4,)).astype(np.int32), 4,
                              temperature=0.0) for _ in range(4)]
            cb.shutdown(drain=True, timeout=WAIT_S)
            for r in reqs:
                assert _wait(r).shape == (4,)
            with pytest.raises(ServerClosingError):
                cb.submit(np.zeros(4, np.int32), 2)
        finally:
            cb.shutdown(timeout=WAIT_S)

    def test_sampling_reproducible_for_a_seed_and_in_range(self, lm):
        prompt = np.arange(3, 9, dtype=np.int32)
        outs = []
        for seed in (5, 5, 6):
            cb = ContinuousBatcher(lm, slots=2, capacity=16, seed=seed)
            try:
                outs.append(_wait(cb.submit(prompt, 8, temperature=0.9,
                                            top_k=5)))
                outs.append(_wait(cb.submit(prompt, 8, temperature=0.9)))
            finally:
                cb.shutdown()
        assert np.array_equal(outs[0], outs[2])  # same seed, same order
        assert np.array_equal(outs[1], outs[3])
        assert not np.array_equal(outs[0], outs[1])  # requests differ
        for o in outs:
            assert o.shape == (8,) and o.min() >= 0 and o.max() < 50

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_decode_death_sheds_typed_then_restart_recovers(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, seed=0)
        try:
            prompt = np.arange(4, dtype=np.int32)
            ref = _wait(cb.submit(prompt, 4, temperature=0.0))
            orig = cb._decode
            fired = []

            def dying(*a):
                if not fired:
                    fired.append(1)
                    raise RuntimeError("injected decode failure")
                return orig(*a)

            cb._decode = dying
            with pytest.raises(WorkerStallError):
                _wait(cb.submit(prompt, 4, temperature=0.0))
            deadline = time.monotonic() + WAIT_S
            while cb.worker_alive() and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(ServerClosingError) as ei:
                cb.submit(prompt, 4)
            assert ei.value.cause == "worker_dead"
            assert cb.restart_worker(reason="test") is True
            np.testing.assert_array_equal(
                _wait(cb.submit(prompt, 4, temperature=0.0)), ref)
            # the batcher releases a request's lease after it delivers the
            # answer, as the reference does: wait for the release
            deadline = time.monotonic() + WAIT_S
            while cb.registry.inflight() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert cb.registry.inflight() == {}
        finally:
            cb.shutdown(timeout=WAIT_S)


class TestBlockAllocator:
    def test_randomized_alloc_free_invariants(self):
        rng = np.random.RandomState(0)
        a = BlockAllocator(33)  # 32 usable + trash
        held = {}
        for step in range(600):
            if held and rng.rand() < 0.45:
                key = list(held)[rng.randint(len(held))]
                a.free(held.pop(key))
            else:
                n = int(rng.randint(1, 6))
                if n <= a.available:
                    ids = a.alloc(n)
                    assert TRASH_BLOCK not in ids
                    out = {b for blocks in held.values() for b in blocks}
                    assert not set(ids) & out  # never double-handed
                    held[step] = ids
                else:
                    before = (a.used, a.available)
                    with pytest.raises(CapacityError):
                        a.alloc(n)
                    assert (a.used, a.available) == before  # atomic
            total = sum(len(v) for v in held.values())
            assert a.used == total
            assert a.available == a.usable - total  # conservation
        for ids in held.values():
            a.free(ids)
        assert a.available == a.usable == 32

    def test_lifo_reuse_and_trash_protection(self):
        a = BlockAllocator(6)
        ids = a.alloc(4)
        a.free(ids[:2])
        assert set(a.alloc(2)) == set(ids[:2])
        with pytest.raises(ValueError, match="double free"):
            a.free([ids[3], ids[3]])
        with pytest.raises(ValueError, match="trash"):
            a.free([0])

    def test_exhaustion_is_typed(self):
        a = BlockAllocator(4)  # 3 usable
        a.alloc(2)
        with pytest.raises(CapacityError):
            a.alloc(2)
        assert a.available == 1  # failed alloc took nothing

    def test_randomized_retain_release_never_leaks_or_double_frees(self):
        rng = np.random.RandomState(20)
        a = BlockAllocator(17)  # 16 usable
        mirror = {}  # block -> expected refcount
        for _ in range(400):
            op = rng.randint(3)
            if op == 0:
                n = int(rng.randint(1, 4))
                if n <= a.available:
                    for b in a.alloc(n):
                        assert b != TRASH_BLOCK and b not in mirror
                        mirror[b] = 1
            elif op == 1 and mirror:
                b = int(rng.choice(list(mirror)))
                a.retain([b])
                mirror[b] += 1
            elif op == 2 and mirror:
                b = int(rng.choice(list(mirror)))
                a.release([b])
                mirror[b] -= 1
                if mirror[b] == 0:
                    del mirror[b]
            assert a.used == len(mirror)
            assert a.available == a.usable - len(mirror)
            for b, c in mirror.items():
                assert a.refcount(b) == c
        for b, c in list(mirror.items()):
            a.release([b] * c)
        assert a.used == 0 and a.available == a.usable

    def test_retain_free_block_and_trash_are_hard_errors(self):
        a = BlockAllocator(4)
        (b,) = a.alloc(1)
        with pytest.raises(ValueError, match="trash"):
            a.retain([TRASH_BLOCK])
        with pytest.raises(ValueError, match="free block"):
            a.retain([b + 1])
        a.retain([b])
        a.release([b])
        a.release([b])
        with pytest.raises(ValueError, match="double free"):
            a.release([b])

    def test_release_at_zero_returns_block_to_lifo_free_list(self):
        a = BlockAllocator(5)
        ids = a.alloc(2)
        a.retain([ids[0]])
        a.release(ids)
        assert a.refcount(ids[0]) == 1 and a.refcount(ids[1]) == 0
        assert a.alloc(1) == [ids[1]]


class TestPrefillScheduler:
    def test_edf_order_and_budget(self):
        class J:
            def __init__(self, deadline, enq_t):
                self.deadline, self.enq_t = deadline, enq_t

        jobs = [J(None, 3.0), J(9.0, 2.0), J(1.0, 4.0), J(None, 1.0)]
        sched = PrefillScheduler(decode_chunks=2, idle_chunks=3)
        busy = sched.plan(jobs, decoding=True)
        assert [(j.deadline, j.enq_t) for j in busy] == [(1.0, 4.0),
                                                         (9.0, 2.0)]
        idle = sched.plan(jobs, decoding=False)
        assert len(idle) == 3 and idle[-1].enq_t == 1.0
        with pytest.raises(ValueError):
            PrefillScheduler(decode_chunks=0)


class TestPagedKV:
    def test_paged_greedy_identical_to_dense(self, lm):
        """Chunked and un-chunked paged decode give token-for-token the
        dense batcher's greedy chains across prompt buckets."""
        dense = ContinuousBatcher(lm, slots=2, capacity=16, kv="dense",
                                  prompt_buckets=(8, 16), seed=0)
        chunked = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                                    prefill_chunk=8, prompt_buckets=(8, 16),
                                    seed=0)
        whole = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                                  prefill_chunk=None, prompt_buckets=(8, 16),
                                  seed=0)
        try:
            rng = np.random.RandomState(7)
            for tp in (3, 5, 8, 10):
                prompt = rng.randint(0, 50, (tp,)).astype(np.int32)
                want = _wait(dense.submit(prompt, 6,
                                          temperature=0.0)).tolist()
                assert _wait(chunked.submit(
                    prompt, 6, temperature=0.0)).tolist() == want, tp
                if tp in (5, 8):
                    assert _wait(whole.submit(
                        prompt, 6, temperature=0.0)).tolist() == want, tp
        finally:
            dense.shutdown()
            chunked.shutdown()
            whole.shutdown()

    def test_one_decode_shape_bounded_prefill_chunks(self, lm):
        buckets = (8, 16)
        cb = ContinuousBatcher(lm, slots=3, capacity=16, block_size=4,
                               prefill_chunk=8, prompt_buckets=buckets,
                               queue_limit=16, seed=0)
        try:
            rng = np.random.RandomState(11)
            prompts = [rng.randint(0, 50, (tp,)).astype(np.int32)
                       for tp in (1, 3, 5, 8, 9, 10, 7, 2)]
            with cf.ThreadPoolExecutor(8) as ex:
                list(ex.map(lambda p: _wait(
                    cb.submit(p, 4, temperature=0.0)), prompts))
            assert cb._decode_sigs == {("decode", 3)}, cb._decode_sigs
            assert len(cb._prefill_sigs) <= len(buckets), cb._prefill_sigs
        finally:
            cb.shutdown()

    def test_overcommit_queues_and_completes(self, lm):
        # pool = 8 usable blocks x 4 tokens = 32 KV tokens, slots x
        # capacity = 64: 6 requests x 8 tokens queue and ALL complete
        cb = ContinuousBatcher(lm, slots=4, capacity=16, block_size=4,
                               kv_blocks=9, prefill_chunk=None,
                               queue_limit=32, seed=0)
        try:
            rng = np.random.RandomState(13)
            prompts = [rng.randint(0, 50, (4,)).astype(np.int32)
                       for _ in range(6)]
            with cf.ThreadPoolExecutor(6) as ex:
                outs = list(ex.map(lambda p: _wait(
                    cb.submit(p, 4, temperature=0.0)), prompts))
            for p, o in zip(prompts, outs):
                assert np.array_equal(o, _port_greedy(lm, p, 4))
            cb.flush_prefix_cache()
            stats = cb.kv_block_stats()
            assert stats["blocks_used"] == 0
            assert stats["blocks_committed"] == 0
        finally:
            cb.shutdown()

    def test_impossible_request_sheds_typed_capacity_error(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               kv_blocks=3, seed=0)
        try:
            with pytest.raises(CapacityError, match="KV blocks"):
                cb.submit(np.zeros(8, np.int32), 4)  # 12 tokens NEVER fit
            out = _wait(cb.submit(np.arange(1, 5, dtype=np.int32), 4,
                                  temperature=0.0))
            assert out.shape == (4,)
        finally:
            cb.shutdown()

    def test_live_kv_gauges_track_allocation(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               seed=0)
        try:
            orig = cb._decode

            def slow(*a):  # keep the request in flight while we sample
                time.sleep(0.005)
                return orig(*a)

            cb._decode = slow
            req = cb.submit(np.arange(1, 9, dtype=np.int32), 8,
                            temperature=0.0)
            peak, deadline = 0, time.time() + WAIT_S
            while time.time() < deadline:
                peak = max(peak, cb.kv_block_stats()["blocks_used"])
                if req.event.is_set():
                    break
                time.sleep(0.001)
            _wait(req)
            assert peak >= 2, peak
            cb.flush_prefix_cache()
            assert cb.kv_block_stats()["blocks_used"] == 0
            assert cb.kv_block_stats()["live_bytes"] == 0
            assert block_bytes(lm, 4, np.float32) == 2 * 2 * 4 * 4 * 8 * 4
            assert cb.metrics.gauge("serve_kv_blocks_total").value \
                == cb.kv_block_stats()["blocks_total"]
        finally:
            cb.shutdown()

    def test_blocks_peak_outlives_the_release(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                               seed=0)
        try:
            reqs = [cb.submit(np.arange(1, 9, dtype=np.int32) + i, 8,
                              temperature=0.0) for i in range(2)]
            for r in reqs:
                _wait(r)
            cb.flush_prefix_cache()
            stats = cb.kv_block_stats()
            assert stats["blocks_used"] == 0
            # 16 positions a row at block 4: at most 4 blocks each
            assert 4 <= stats["blocks_peak"] <= 8, stats
        finally:
            cb.shutdown()

    def test_step_probe_touches_only_the_trash_block(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                               prefill_chunk=4, seed=0)
        try:
            want = _port_greedy(lm, np.arange(1, 7, dtype=np.int32), 4)
            got = _wait(cb.submit(np.arange(1, 7, dtype=np.int32), 4,
                                  temperature=0.0))
            assert np.array_equal(got, want)
            before = {lk: p["k"].clone() for lk, p in cb._pools.items()}
            tick = cb.step_probe("decode", sampled=1, temperature=0.8,
                                 top_k=5)
            toks = tick()
            assert toks.shape == (2,) and 0 <= toks.min() <= toks.max() < 50
            for b in cb.chunk_buckets:
                lg = cb.step_probe("prefill", b)()
                assert lg.shape == (1, 50) and torch.isfinite(lg).all()
            for lk, p in cb._pools.items():
                assert torch.equal(p["k"][1:], before[lk][1:])
                assert not torch.equal(p["k"][0], before[lk][0])
            with pytest.raises(ValueError, match="kind"):
                cb.step_probe("train")
            # the batcher serves on, its cached prefix intact
            again = _wait(cb.submit(np.arange(1, 7, dtype=np.int32), 4,
                                    temperature=0.0))
            assert np.array_equal(again, want)
        finally:
            cb.shutdown()
        dense = ContinuousBatcher(lm, slots=1, capacity=16, kv="dense",
                                  seed=0)
        try:
            with pytest.raises(ValueError, match="paged"):
                dense.step_probe()
        finally:
            dense.shutdown()

    def test_rope_capacity_decoupled_from_positional_table(self, lm):
        with pytest.raises(ValueError, match="[Pp]ositional"):
            ContinuousBatcher(lm, slots=1, capacity=1024)
        rope = CausalLM(seed=0, input_shape=(16,), num_layers=1, d_model=32,
                        num_heads=4, vocab=50, pos="rope",
                        device="cpu").build()
        rope.init()
        cb = ContinuousBatcher(rope, slots=1, capacity=1024, block_size=16,
                               prompt_buckets=(16,), seed=0)
        try:
            out = _wait(cb.submit(np.arange(1, 7, dtype=np.int32), 4,
                                  temperature=0.0))
            assert np.array_equal(out, _port_greedy(rope, np.arange(1, 7),
                                                    4))
        finally:
            cb.shutdown()


class TestHistogramQuantiles:
    def test_quantiles_match_the_reference_histogram(self):
        from deeplearning4j_torch.obs.metrics import Histogram
        from deeplearning4j_tpu.obs.metrics import Histogram as JHistogram

        rng = np.random.RandomState(0)
        xs = np.concatenate([rng.lognormal(-5, 1, 300), [120.0]])
        h, jh = Histogram(), JHistogram()
        assert h.quantile(0.5) == 0.0 and h.mean == 0.0
        for x in xs:
            h.observe(x)
            jh.observe(x)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert h.quantile(q) == jh.quantile(q)
        assert h.mean == pytest.approx(xs.mean())
        assert h.quantile(1.0) == 120.0  # the overflow bucket's max
        with pytest.raises(ValueError):
            h.quantile(1.5)

    def test_decode_ticks_land_in_the_batchers_histogram(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               seed=0)
        try:
            _wait(cb.submit(np.arange(1, 6, dtype=np.int32), 5,
                            temperature=0.0))
            h = cb.metrics.histogram("serve_gen_decode_seconds")
            assert h.count == 4  # the first token comes from the prefill
            assert 0 < h.quantile(0.5) <= h.quantile(0.99)
        finally:
            cb.shutdown()


class TestStreaming:
    def test_stream_yields_tokens_matching_generate(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, seed=0)
        try:
            p = np.arange(2, 8, dtype=np.int32)
            want = _wait(cb.submit(p, 6, temperature=0.0)).tolist()
            assert list(cb.stream(p, 6, temperature=0.0)) == want
        finally:
            cb.shutdown()

    def test_stream_raises_typed_error_while_queued(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, queue_limit=8,
                               seed=0)
        try:
            blocker = cb.submit(np.arange(1, 9, dtype=np.int32), 8,
                                temperature=0.0)
            doomed = cb.submit(np.arange(1, 5, dtype=np.int32), 4,
                               temperature=0.0, timeout_ms=0.5)
            with pytest.raises(DeadlineExceededError):
                list(doomed.stream())
            assert _wait(blocker).shape == (8,)
        finally:
            cb.shutdown()

    def test_stream_completes_through_drain(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, seed=0)
        closer = threading.Thread(target=cb.shutdown,
                                  kwargs={"drain": True, "timeout": WAIT_S})
        try:
            p = np.arange(3, 9, dtype=np.int32)
            want = _wait(cb.submit(p, 8, temperature=0.0)).tolist()
            it = cb.stream(p, 8, temperature=0.0)
            got = [next(it)]   # the stream is live...
            closer.start()     # ...when the drain begins
            got.extend(it)     # the drain finishes it, not cuts it
            closer.join(WAIT_S)
            assert got == want
        finally:
            cb.shutdown(timeout=WAIT_S)

    def test_cancel_queued_and_admitted(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, queue_limit=8,
                               seed=0)
        try:
            orig = cb._decode

            def slow(*a):
                time.sleep(0.01)
                return orig(*a)

            cb._decode = slow
            first = cb.submit(np.arange(1, 5, dtype=np.int32), 10,
                              temperature=0.0)
            queued = cb.submit(np.arange(1, 5, dtype=np.int32), 4,
                               temperature=0.0)
            assert cb.cancel(queued) is True
            with pytest.raises(ShedError):
                _wait(queued)
            it = first.stream()
            next(it)  # admitted and decoding
            assert cb.cancel(first) is True
            assert cb.cancel(first) is False  # idempotent
            with pytest.raises(ShedError) as ei:
                list(it)
            assert ei.value.cause == "client_gone"
            assert cb.metrics.counter(
                "serve_shed_total", {"cause": "client_gone"}).value == 2
            cb.flush_prefix_cache()
            assert cb.kv_block_stats()["blocks_used"] == 0
        finally:
            cb.shutdown(timeout=WAIT_S)


class TestPrefixHashes:
    def test_hashes_commit_to_the_whole_run_and_match_jax(self):
        toks = np.arange(12, dtype=np.int32)
        h = prefix_hashes(toks, 4)
        assert h == jpaged.prefix_hashes(toks, 4)  # the same sha256 bytes
        assert len(h) == 3
        toks2 = toks.copy()
        toks2[0] += 1
        h2 = prefix_hashes(toks2, 4)
        assert all(x != y for x, y in zip(h, h2))
        toks3 = toks.copy()
        toks3[5] += 1
        h3 = prefix_hashes(toks3, 4)
        assert h3[0] == h[0] and h3[1] != h[1] and h3[2] != h[2]
        rng = np.random.RandomState(0)
        for n, bs in ((64, 16), (333, 16), (70, 7)):
            t = rng.randint(0, 32000, (n,))
            assert prefix_hashes(t, bs) == jpaged.prefix_hashes(t, bs)

    def test_partial_tail_never_hashed(self):
        assert len(prefix_hashes(np.arange(11, dtype=np.int32), 4)) == 2
        assert prefix_hashes(np.arange(3, dtype=np.int32), 4) == []


class TestPrefixCacheUnit:
    def test_generation_flip_invalidates_wholesale(self):
        a = BlockAllocator(8)
        pc = PrefixCache(a, 4)
        h = prefix_hashes(np.arange(8, dtype=np.int32), 4)
        blocks = a.alloc(2)
        pc.insert(h, blocks, generation=1)
        assert pc.match(h, 1, 2) == blocks
        assert pc.match(h, 2, 2) == []
        assert pc.flushes == 1 and len(pc) == 0
        a.release(blocks)
        assert a.used == 0

    def test_match_is_pure_and_adopt_takes_references(self):
        a = BlockAllocator(8)
        pc = PrefixCache(a, 4)
        h = prefix_hashes(np.arange(12, dtype=np.int32), 4)
        blocks = a.alloc(3)
        pc.insert(h, blocks, generation=1)
        run = pc.match(h, 1, 2)
        assert run == blocks[:2]
        assert all(a.refcount(b) == 2 for b in blocks)
        pc.adopt(h, run)
        assert [a.refcount(b) for b in blocks] == [3, 3, 2]
        h2 = prefix_hashes(np.r_[np.arange(4), 99, 5, 6, 7].astype(np.int32),
                           4)
        assert pc.match(h2, 1, 2) == blocks[:1]

    def test_lru_reclaim_frees_cache_only_entries_under_pressure(self):
        a = BlockAllocator(6)
        pc = PrefixCache(a, 4)
        a.set_reclaimer(pc.reclaim)
        h = prefix_hashes(np.arange(12, dtype=np.int32), 4)
        blocks = a.alloc(3)
        pc.insert(h, blocks, generation=1)
        a.release(blocks)
        assert a.available == 2
        ids = a.alloc(4)
        assert len(ids) == 4 and pc.evictions == 2 and len(pc) == 1

    def test_reclaim_skips_entries_adopted_by_live_slots(self):
        a = BlockAllocator(6)
        pc = PrefixCache(a, 4)
        a.set_reclaimer(pc.reclaim)
        h = prefix_hashes(np.arange(12, dtype=np.int32), 4)
        blocks = a.alloc(3)
        pc.insert(h, blocks, generation=1)
        pc.adopt(h, pc.match(h, 1, 2))
        a.release(blocks)
        with pytest.raises(CapacityError):
            a.alloc(4)
        assert pc.evictions == 1 and len(pc) == 2
        assert a.alloc(3) is not None

    def test_insert_respects_max_blocks_with_lru_eviction(self):
        a = BlockAllocator(8)
        pc = PrefixCache(a, 4, max_blocks=2)
        h = prefix_hashes(np.arange(12, dtype=np.int32), 4)
        blocks = a.alloc(3)
        assert pc.insert(h, blocks, generation=1) == 3
        assert len(pc) == 2 and pc.evictions == 1
        assert pc.match(h, 1, 3) == []

    def test_insert_keeps_existing_entry_for_duplicate_hash(self):
        a = BlockAllocator(8)
        pc = PrefixCache(a, 4)
        h = prefix_hashes(np.arange(4, dtype=np.int32), 4)
        b1, b2 = a.alloc(1), a.alloc(1)
        pc.insert(h, b1, generation=1)
        assert pc.insert(h, b2, generation=1) == 0
        assert pc.match(h, 1, 1) == b1
        assert a.refcount(b2[0]) == 1


class TestBatcherPrefixCache:
    def test_cached_prefix_hits_and_matches_jax(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                               prefill_chunk=4, seed=0)
        try:
            p = np.random.RandomState(3).randint(0, 50, (8,)).astype(np.int32)
            want = _jax_greedy(tuple(p.tolist()), 6)
            o1 = _wait(cb.submit(p, 6, temperature=0.0))
            o2 = _wait(cb.submit(p, 6, temperature=0.0))  # adopts the run
            assert np.array_equal(o1, want) and np.array_equal(o2, want)
            stats = cb.kv_block_stats()
            px = stats["prefix_cache"]
            assert px["hits"] == 1 and px["misses"] == 1
            assert stats["blocks_cached"] == 2
            assert cb.metrics.counter(
                "serve_prefill_tokens_saved_total").value == 4
            assert cb.flush_prefix_cache() == 2
            stats = cb.kv_block_stats()
            assert stats["blocks_used"] == 0 and stats["blocks_shared"] == 0
        finally:
            cb.shutdown()

    def test_admission_charges_only_unshared_blocks(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               prefill_chunk=4, seed=0)
        try:
            p = np.random.RandomState(5).randint(0, 50, (8,)).astype(np.int32)
            _wait(cb.submit(p, 8, temperature=0.0))  # populates the cache
            full = blocks_needed(8 + 8, 4)
            orig = cb._decode

            def slow(*a):
                time.sleep(0.002)
                return orig(*a)

            cb._decode = slow
            req = cb.submit(p, 8, temperature=0.0)
            seen, deadline = 0, time.monotonic() + WAIT_S
            while not req.event.is_set() and time.monotonic() < deadline:
                seen = max(seen, cb.kv_block_stats()["blocks_committed"])
                time.sleep(0)
            _wait(req)
            assert 0 < seen == full - 1
        finally:
            cb.shutdown()

    def test_generation_flip_flushes_batcher_cache(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               prefill_chunk=4, seed=0)
        try:
            p = np.random.RandomState(7).randint(0, 50, (8,)).astype(np.int32)
            want = _port_greedy(lm, p, 4)
            assert np.array_equal(_wait(cb.submit(p, 4, temperature=0.0)),
                                  want)
            snap = cb.registry.current()
            cb.registry.publish(snap.params, snap.state)
            assert np.array_equal(_wait(cb.submit(p, 4, temperature=0.0)),
                                  want)
            px = cb.kv_block_stats()["prefix_cache"]
            assert px["hits"] == 0 and px["misses"] == 2
            assert px["flushes"] == 1
            assert px["generation"] == cb.registry.generation
        finally:
            cb.shutdown()

    def test_prefix_cache_off_keeps_legacy_shape(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               prefix_cache=False, seed=0)
        try:
            p = np.arange(1, 9, dtype=np.int32)
            want = _port_greedy(lm, p, 4)
            for _ in range(2):
                assert np.array_equal(
                    _wait(cb.submit(p, 4, temperature=0.0)), want)
            stats = cb.kv_block_stats()
            assert "prefix_cache" not in stats
            assert stats["blocks_used"] == 0
            assert cb.flush_prefix_cache() == 0
        finally:
            cb.shutdown()


class TestFork:
    def test_fork_requires_paged_and_a_decoding_parent(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, kv="dense", seed=0)
        try:
            req = cb.submit(np.arange(1, 5, dtype=np.int32), 2,
                            temperature=0.0)
            with pytest.raises(ServeError, match="paged"):
                cb.fork(req)
            _wait(req)
        finally:
            cb.shutdown()
        cb = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                               seed=0)
        try:
            req = cb.submit(np.arange(1, 5, dtype=np.int32), 2,
                            temperature=0.0)
            _wait(req)
            with pytest.raises(ServeError, match="decoding"):
                cb.fork(req)  # already finished
        finally:
            cb.shutdown()

    def _fork_mid_decode(self, cb, req):
        child, deadline = None, time.monotonic() + WAIT_S
        while not req.event.is_set() and time.monotonic() < deadline:
            try:
                return cb.fork(req)
            except ServeError:
                time.sleep(0)  # still queued/prefilling — retry
        return child

    def test_fork_matches_parent_continuation_with_one_cow_copy(self, lm):
        cb = ContinuousBatcher(lm, slots=2, capacity=16, block_size=4,
                               kv_blocks=17, prefix_cache=False, seed=0)
        try:
            orig = cb._decode

            def slow(*a):  # the fork below lands mid-decode
                time.sleep(0.02)
                return orig(*a)

            cb._decode = slow
            p = np.random.RandomState(11).randint(0, 50, (6,)) \
                .astype(np.int32)
            req = cb.submit(p, 8, temperature=0.0)
            child = self._fork_mid_decode(cb, req)
            out = _wait(req)
            assert len(out) == 8
            assert child is not None, "parent finished before a fork landed"
            cout = _wait(child)
            assert 1 <= len(cout) <= 8
            assert np.array_equal(cout, out[-len(cout):])
            stats = cb.kv_block_stats()
            assert stats["forks"] == 1
            pos_at_fork = 6 + (8 - len(cout)) - 1
            assert stats["cow_copies"] == (1 if pos_at_fork % 4 else 0)
            assert cb.kv_block_stats()["blocks_used"] == 0
        finally:
            cb.shutdown()

    def test_fork_sheds_without_a_free_slot(self, lm):
        cb = ContinuousBatcher(lm, slots=1, capacity=16, block_size=4,
                               seed=0)
        try:
            orig = cb._decode

            def slow(*a):
                time.sleep(0.02)
                return orig(*a)

            cb._decode = slow
            req = cb.submit(np.arange(1, 7, dtype=np.int32), 8,
                            temperature=0.0)
            deadline = time.monotonic() + WAIT_S
            while req.slot is None and time.monotonic() < deadline:
                time.sleep(0.001)
            with pytest.raises(ShedError, match="no free"):
                cb.fork(req)
            _wait(req)
        finally:
            cb.shutdown()
