"""The port's serving path (deeplearning4j_torch/serve) — counterparts of
tests/test_serve.py's ``TestModelRegistry`` and the predict-path
``TestServeEngine`` cases, run on the CPU, plus the port's engine answer
held against the JAX package's engine on the same params and requests
(f32, tolerance 1e-5)."""

import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn.layers import Dense, Output
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.obs.metrics import MetricsRegistry
from deeplearning4j_torch.serve import (CapacityError, DeadlineExceededError,
                                        ModelRegistry, ServeEngine,
                                        ServerClosingError, ShedError,
                                        WorkerStallError)
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.serve import ServeEngine as JServeEngine


def _dense_model(n_in=4, n_out=3, seed=0):
    m = Sequential(NetConfig(seed=seed),
                   [Dense(n_out=6, activation="gelu"),
                    Output(n_out=n_out, loss="mcxent", activation="softmax")],
                   (n_in,), device="cpu")
    m.init()
    return m


def _slow_forward(model, delay_s):
    """Forward with a host-side stall: deterministic device-time inflation
    for the queue/deadline/shed tests."""

    def fwd(params, state, x):
        time.sleep(delay_s)
        y, _ = model.forward(params, state, torch.from_numpy(x))
        return y

    return fwd


def _scaled(params, k):
    return {n: {p: a * k for p, a in d.items()} for n, d in params.items()}


class TestModelRegistry:
    def test_generations_monotonic_and_rollback(self):
        m = _dense_model()
        reg = ModelRegistry(m.params, m.state, version="base")
        s2 = reg.publish(_scaled(m.params, 2.0), version="double")
        assert s2.generation == 2
        s3 = reg.rollback()
        assert s3.generation == 3  # rollback is a fresh generation...
        assert s3.version == "base"  # ...of the previous version
        assert torch.equal(reg.current().params["layer_0"]["w"],
                           m.params["layer_0"]["w"])
        assert [g for g, _ in reg.history()][-1] == 3

    def test_start_generation_and_close(self):
        from deeplearning4j_torch.serve import ServerClosingError
        from deeplearning4j_tpu.serve import ModelRegistry as JRegistry

        m = _dense_model()
        reg = ModelRegistry(m.params, m.state, start_generation=5)
        assert reg.generation == 5 and reg.publish(m.params).generation == 6
        assert JRegistry({"w": np.zeros(2, np.float32)},
                         start_generation=5).generation == 5
        reg.close()  # drops every snapshot: nothing pins the params
        assert reg.history() == [] and reg.drain(timeout=0) is True
        for call in (reg.current, reg.lease().__enter__,
                     lambda: reg.publish(m.params)):
            with pytest.raises(ServerClosingError):
                call()

    def test_publish_drain_waits_for_old_leases(self):
        m = _dense_model()
        reg = ModelRegistry(m.params, m.state)
        entered, release = threading.Event(), threading.Event()

        def worker():
            with reg.lease():
                entered.set()
                release.wait(5)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        assert entered.wait(5)
        reg.publish(_scaled(m.params, 1.5))  # non-draining
        assert reg.drain(timeout=0.2) is False  # old lease still out
        release.set()
        assert reg.drain(timeout=5) is True
        t.join(5)
        assert not t.is_alive()

    def test_history_bounded(self):
        m = _dense_model()
        reg = ModelRegistry(m.params, m.state, keep=3)
        for _ in range(6):
            reg.publish(m.params)
        assert len(reg.history()) == 3

    def test_publish_and_rollback_are_counted(self):
        m = _dense_model()
        metrics = MetricsRegistry()
        reg = ModelRegistry(m.params, m.state, metrics=metrics)
        reg.publish(_scaled(m.params, 3.0))
        reg.rollback()
        assert metrics.counter("serve_model_publishes_total").value == 2
        assert metrics.counter("serve_model_rollbacks_total").value == 1
        assert metrics.gauge("serve_model_generation").value == 3

    def test_release_thread_reclaims_leases(self):
        m = _dense_model()
        reg = ModelRegistry(m.params, m.state)
        held, done = threading.Event(), threading.Event()

        def hung():
            with reg.lease():
                held.set()
                done.wait(5)

        t = threading.Thread(target=hung, daemon=True)
        t.start()
        assert held.wait(5)
        reg.publish(m.params)
        assert reg.release_thread(t.ident) == 1
        assert reg.drain(timeout=1) is True
        done.set()
        t.join(5)
        assert reg.inflight() == {}  # the late finally does not double-free

    def test_publish_none_rejected(self):
        m = _dense_model()
        reg = ModelRegistry(m.params, m.state)
        with pytest.raises(ValueError):
            reg.publish(None)


class TestServeEngine:
    def test_predict_matches_direct(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(2, 4, 8))
        try:
            x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
            direct = m.output(x).numpy()
            np.testing.assert_allclose(eng.predict(x), direct,
                                       rtol=1e-5, atol=1e-6)
            one = eng.predict(x[0])  # single example grows a batch dim
            np.testing.assert_allclose(one[0], direct[0], rtol=1e-5, atol=1e-6)
        finally:
            eng.shutdown()

    def test_concurrent_requests_coalesce(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1, 2, 4, 8), max_wait_ms=60.0)
        try:
            x = np.random.RandomState(0).randn(8, 1, 4).astype(np.float32)
            with cf.ThreadPoolExecutor(8) as ex:
                handles = list(ex.map(lambda i: eng.submit(x[i]), range(8)))
            for h in handles:
                h.wait()
            seqs = [h.batch_seq for h in handles]
            batches = len(set(seqs))
            assert batches < len(handles), \
                f"no coalescing: {len(handles)} requests -> {batches} batches"
            assert max(seqs.count(s) for s in set(seqs)) >= 2
            assert eng.metrics.counter("serve_batches_total").value == batches
        finally:
            eng.shutdown()

    def test_signatures_bounded_under_randomized_traffic(self):
        m = _dense_model()  # Dense acts on the last axis: (B, T, 4) works
        batch_buckets, length_buckets = (2, 4), (8, 16)
        eng = ServeEngine(m, batch_buckets=batch_buckets,
                          length_buckets=length_buckets, max_wait_ms=1.0)
        try:
            rng = np.random.RandomState(7)
            xs = [rng.randn(int(rng.randint(1, 5)), int(rng.randint(1, 17)),
                            4).astype(np.float32) for _ in range(20)]
            with cf.ThreadPoolExecutor(4) as ex:
                outs = list(ex.map(eng.predict, xs))
            for x, y in zip(xs, outs):
                assert y.shape[:2] == x.shape[:2]  # un-padded back to true T
                np.testing.assert_allclose(y, m.output(x).numpy(),
                                           rtol=1e-4, atol=1e-5)
            sigs = eng.compile_signatures
            assert len(sigs) <= len(batch_buckets) * len(length_buckets)
            for bucket, shape, _ in sigs:
                assert bucket in batch_buckets and shape[0] in length_buckets
        finally:
            eng.shutdown()

    def test_over_length_is_typed_error(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(2,), length_buckets=(8,))
        try:
            with pytest.raises(CapacityError):
                eng.predict(np.zeros((1, 9, 4), np.float32))
        finally:
            eng.shutdown()

    def test_deadline_expiry_is_typed_error_not_hang(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1, 4), max_wait_ms=1.0,
                          forward=_slow_forward(m, 0.08))
        try:
            x = np.zeros((1, 4), np.float32)
            r1 = eng.submit(x)          # occupies the device ~80ms
            time.sleep(0.02)            # ensure r1's batch has dispatched
            r2 = eng.submit(x, timeout_ms=5.0)  # expires while queued
            t0 = time.perf_counter()
            with pytest.raises(DeadlineExceededError):
                r2.wait()
            assert time.perf_counter() - t0 < 5.0  # typed error, not a hang
            r1.wait()  # undeadlined request unaffected
            assert eng.metrics.counter(
                "serve_deadline_expired_total").value >= 1
        finally:
            eng.shutdown()

    def test_shed_past_queue_limit_zero_drops_below(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1, 2), max_wait_ms=1.0,
                          queue_limit=2, forward=_slow_forward(m, 0.05))
        try:
            x = np.zeros((1, 4), np.float32)
            handles, sheds = [], 0
            for _ in range(12):  # flood far past queue_limit
                try:
                    handles.append(eng.submit(x))
                except ShedError as e:
                    assert e.cause == "queue_full"
                    sheds += 1
            assert sheds > 0, "queue never shed past its limit"
            for h in handles:  # every admitted request completes
                assert h.wait().shape == (1, 3)
            assert eng.metrics.counter(
                "serve_shed_total", {"cause": "queue_full"}).value == sheds
            outs = [eng.predict(x) for _ in range(3)]
            assert all(o.shape == (1, 3) for o in outs)
        finally:
            eng.shutdown()

    def test_graceful_drain_completes_inflight(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1, 2), max_wait_ms=1.0,
                          queue_limit=64, forward=_slow_forward(m, 0.02))
        try:
            x = np.random.RandomState(1).randn(1, 4).astype(np.float32)
            handles = [eng.submit(x) for _ in range(6)]
        finally:
            eng.shutdown(drain=True)  # returns only after the queue drains
        for h in handles:
            assert h.wait().shape == (1, 3)  # no errors, no hangs
        with pytest.raises(ServerClosingError):
            eng.submit(x)
        assert eng.metrics.counter(
            "serve_shed_total", {"cause": "shutting_down"}).value == 1

    def test_shutdown_without_drain_errors_pending(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1,), max_wait_ms=1.0,
                          queue_limit=64, forward=_slow_forward(m, 0.05))
        handles = [eng.submit(np.zeros((1, 4), np.float32)) for _ in range(5)]
        eng.shutdown(drain=False)
        outcomes = []
        for h in handles:
            try:
                h.wait()
                outcomes.append("ok")
            except ServerClosingError:
                outcomes.append("closed")
        assert "closed" in outcomes

    def test_restart_worker_sheds_inflight_and_serves_on(self):
        m = _dense_model()
        gate = threading.Event()

        def stuck(params, state, x):
            gate.wait(5)
            return m.forward(params, state, torch.from_numpy(x))[0]

        eng = ServeEngine(m, batch_buckets=(1,), max_wait_ms=1.0,
                          forward=stuck)
        try:
            x = np.zeros((1, 4), np.float32)
            h = eng.submit(x)
            time.sleep(0.05)  # the batch is on the (stuck) device
            assert eng.restart_worker(reason="test")
            with pytest.raises(WorkerStallError):
                h.wait()
            gate.set()
            assert eng.predict(x).shape == (1, 3)
        finally:
            gate.set()
            eng.shutdown()

    def test_prometheus_text_has_engine_families(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(2,), metrics=MetricsRegistry())
        try:
            eng.predict(np.zeros((1, 4), np.float32))
        finally:
            eng.shutdown()
        text = eng.metrics.to_prometheus()
        for family in ("serve_batches_total", "serve_requests_total",
                       "serve_queue_seconds_bucket", "serve_device_seconds_sum",
                       "serve_model_generation"):
            assert family in text
        assert 'serve_compile_misses_total{component="engine"} 1' in text


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_engine_matches_reference_engine():
    """The same CausalLM params and requests through the JAX package's
    engine and the port's: padded to the same buckets, un-padded to the
    same lengths, equal answers."""
    kw = dict(seed=0, input_shape=(16,), num_layers=2, d_model=32,
              num_heads=4, vocab=50, flash=True)
    jm = JCausalLM(**kw).build()
    jm.init()
    tm = CausalLM(device="cpu", **kw).build()
    tm.params, tm.state = params_from_numpy(tm, _np_tree(jm.params)), {}
    rng = np.random.RandomState(4)
    reqs = [rng.randint(0, 50, (int(rng.randint(1, 3)),
                                int(rng.randint(3, 17)))).astype(np.int32)
            for _ in range(6)]
    opts = dict(batch_buckets=(1, 2, 4), length_buckets=(8, 16))
    jeng, teng = JServeEngine(jm, **opts), ServeEngine(tm, **opts)
    try:
        for x in reqs:
            want, got = jeng.predict(x), teng.predict(x)
            assert got.shape == want.shape == x.shape + (50,)
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
    finally:
        jeng.shutdown()
        teng.shutdown()


@pytest.mark.parametrize("mode", ["store", "strict"])
def test_store_backed_engine_matches_reference_engine(tmp_path, mode):
    """The same params and requests through the JAX package's engine
    (without a store: its serialized executables do not load here) and the
    port's engine with a store: eager at first boot, strict from the
    records a first boot wrote, with the same answers (f32, 1e-5 as above)
    and zero compiles on the strict boot."""
    from deeplearning4j_torch.aot import AotStore
    from deeplearning4j_torch.serve import AotTraceError

    kw = dict(seed=0, input_shape=(16,), num_layers=2, d_model=32,
              num_heads=4, vocab=50, flash=True)
    jm = JCausalLM(**kw).build()
    jm.init()
    tm = CausalLM(device="cpu", **kw).build()
    tm.params, tm.state = params_from_numpy(tm, _np_tree(jm.params)), {}
    opts = dict(batch_buckets=(1, 2, 4), length_buckets=(8, 16))
    store = AotStore(str(tmp_path))
    first = ServeEngine(tm, aot_store=store, **opts)
    first.warm(np.int32)
    first.shutdown()
    m = MetricsRegistry()
    teng = ServeEngine(tm, aot_store=store, strict_aot=mode == "strict",
                       metrics=m, **opts)
    jeng = JServeEngine(jm, **opts)
    rng = np.random.RandomState(4)
    reqs = [rng.randint(0, 50, (int(rng.randint(1, 5)),
                                int(rng.randint(3, 17)))).astype(np.int32)
            for _ in range(6)]
    try:
        assert teng.warm(np.int32) >= 0.0
        for x in reqs:
            want, got = jeng.predict(x), teng.predict(x)
            assert got.shape == want.shape == x.shape + (50,)
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
        fwd = teng.aot_functions()["engine_forward"]
        assert fwd.captures == 6 and fwd.call_captures == 0
        assert m.counter("serve_compile_misses_total",
                         {"component": "engine"}).value == 0
        # a signature no boot recorded: strict refuses it typed
        if mode == "strict":
            with pytest.raises(AotTraceError):
                teng.predict(np.zeros((1, 8), np.int64))
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_engine_publish_warms_before_the_flip(tmp_path):
    """A publish makes the candidate's executable for every signature
    held before the flip; the first batch on the new generation captures
    nothing and answers with the new params."""
    from deeplearning4j_torch.aot import AotStore

    m = _dense_model()
    eng = ServeEngine(m, batch_buckets=(1, 2), aot_store=AotStore(
        str(tmp_path)))
    try:
        x = np.ones((2, 4), np.float32)
        eng.predict(x)
        fwd = eng.aot_functions()["engine_forward"]
        # no warm: the first batch captured on its call
        assert fwd.captures == fwd.call_captures == 1
        seen = []
        eng.registry.add_warmer(
            lambda snap: seen.append((eng.registry.generation,
                                      fwd.generations())))
        new = _scaled(m.params, 0.5)
        snap = eng.registry.publish(new)
        assert seen == [(1, [1, 2])]  # warmed before the flip
        want, _ = m.forward(new, m.state, torch.from_numpy(x))
        np.testing.assert_allclose(eng.predict(x), want.numpy(), rtol=1e-6)
        assert fwd.generations() == [snap.generation]
        assert fwd.captures == 2 and fwd.call_captures == 1
    finally:
        eng.shutdown()
    assert fwd.generations() == []  # shutdown drops the graphs
