"""The port's HTTP front end (deeplearning4j_torch/serve/http.py) —
counterparts of tests/test_serve.py's ``TestModelServerHTTP`` and its
HTTP streaming cases, plus the health state machine and the watchdog
(tests/test_chaos.py's ``TestWatchdog``), on the CPU at f32. Predict
answers are held against the JAX model's output and greedy ``/generate``
tokens against the JAX package's ``generate`` on the same params. Every
wait is bounded and every server stops in ``finally``.
"""

import concurrent.futures as cf
import functools
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn.layers import Dense, Output
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.obs.metrics import MetricsRegistry
from deeplearning4j_torch.serve import (AotTraceError, ContinuousBatcher,
                                        Health, ModelServer, ServeEngine,
                                        Watchdog, WorkerStallError,
                                        retry_after_s)
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.nn import generation as jg

WAIT_S = 30


@functools.lru_cache(maxsize=None)
def _models():
    jm = JCausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                   num_heads=4, vocab=50).build()
    jm.init()
    tm = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                  num_heads=4, vocab=50, device="cpu").build()
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    return jm, tm


@pytest.fixture(scope="module")
def lm():
    return _models()[1]


def _dense_model():
    m = Sequential(NetConfig(seed=0),
                   [Dense(n_out=6, activation="gelu"),
                    Output(n_out=3, loss="mcxent", activation="softmax")],
                   (4,), device="cpu")
    m.init()
    return m


def _slow_forward(model, delay_s):
    def fwd(params, state, x):
        import torch

        time.sleep(delay_s)
        y, _ = model.forward(params, state, torch.from_numpy(x))
        return y

    return fwd


def _post(port, path, body, timeout=WAIT_S):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=WAIT_S).read())


class TestModelServerHTTP:
    def test_predict_generate_health_metrics(self, lm):
        jm = _models()[0]
        srv = ModelServer(lm, port=0, input_dtype=np.int32, gen_slots=2,
                          gen_capacity=16).start()
        try:
            rng = np.random.RandomState(0)
            ids = rng.randint(0, 50, (2, 8))
            out = _post(srv.port, "/predict", {"ndarray": ids.tolist()})
            want = np.asarray(jm.output(ids.astype(np.int32)))
            np.testing.assert_allclose(np.asarray(out["output"]), want,
                                       rtol=1e-4, atol=1e-5)
            assert out["generation"] == 1

            prompt = rng.randint(0, 50, (6,)).tolist()
            gen = _post(srv.port, "/generate?stream=false",
                        {"prompt": prompt, "max_new_tokens": 4,
                         "temperature": 0.0})
            want_t = jg.generate(jm, np.asarray([prompt], np.int32), 4,
                                 temperature=0.0)[0]
            assert gen["tokens"] == want_t.tolist()
            batch = _post(srv.port, "/generate",  # batch: always buffered
                          {"prompt": [prompt, prompt], "max_new_tokens": 4,
                           "temperature": 0.0})
            assert batch["tokens"] == [want_t.tolist()] * 2

            health = _get(srv.port, "/health")
            assert health["status"] == "ok" and health["generation"] == 1
            assert _get(srv.port, "/ready")["status"] == "ready"
            models = _get(srv.port, "/models")
            assert models["generation"] == 1
            assert models["kv"]["prefix_cache"]["misses"] >= 1
            time.sleep(0.05)  # request metrics land after the reply
            scrape = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics",
                timeout=WAIT_S).read().decode()
            for name in ("serve_queue_depth", "serve_batches_total",
                         "serve_batch_occupancy", "serve_queue_seconds",
                         "serve_device_seconds", "serve_gen_tokens_total",
                         "serve_compile_misses_total", "http_request_seconds",
                         "serve_kv_blocks_total", "serve_kv_blocks_used",
                         "serve_kv_block_utilization", "serve_kv_live_bytes",
                         "serve_prefill_chunks_total",
                         "serve_health_state"):
                assert name in scrape, f"{name} missing from /metrics"
            # no flight recorder installed: the request ring reads empty
            # and the recorder's snapshot is not there (the reference's
            # answers)
            assert _get(srv.port, "/v1/debug/requests") == {"requests": []}
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.port, "/v1/debug/flight")
            assert ei.value.code == 404
        finally:
            srv.stop()

    def test_not_ported_options_raise(self, lm):
        # the store options are ported: what still raises is what the
        # reference refuses too — strict or a manifest without a store
        with pytest.raises(ValueError, match="requires an aot_store"):
            ModelServer(lm, port=0, strict_aot=True)
        with pytest.raises(ValueError, match="requires an aot_store"):
            ModelServer(lm, port=0, aot_manifest={"sites": []})

    def test_bad_payload_400_overload_503(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1,), max_wait_ms=1.0,
                          queue_limit=1, forward=_slow_forward(m, 0.05))
        srv = ModelServer(m, port=0, engine=eng).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv.port, "/predict", {"x": 1})
            assert ei.value.code == 400
            retry_after = []

            def fire(_):
                try:
                    _post(srv.port, "/predict", {"ndarray": [[0.0] * 4]})
                    return 200
                except urllib.error.HTTPError as e:
                    if e.code == 503:
                        retry_after.append(e.headers.get("Retry-After"))
                    return (e.code, json.loads(e.read())["cause"])

            with cf.ThreadPoolExecutor(10) as ex:
                codes = list(ex.map(fire, range(10)))
            assert len(codes) == 10  # every request answered
            assert 200 in codes
            assert (503, "queue_full") in codes, codes
            assert retry_after and all(
                ra is not None and int(ra) >= 1 for ra in retry_after)
        finally:
            srv.stop()

    def test_graceful_drain_over_http(self):
        m = _dense_model()
        eng = ServeEngine(m, batch_buckets=(1, 2, 4), max_wait_ms=30.0,
                          queue_limit=64, forward=_slow_forward(m, 0.03))
        srv = ModelServer(m, port=0, engine=eng).start()
        results = []

        def fire(_):
            results.append(_post(srv.port, "/predict",
                                 {"ndarray": [[0.1] * 4]}))

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(4)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.05)      # let every request get admitted
            srv.stop(drain=True)  # flips readiness, drains, then closes
            for t in threads:
                t.join(WAIT_S)
            assert len(results) == 4
            for r in results:
                assert len(r["output"][0]) == 3
        finally:
            srv.stop()

    def test_ready_flips_503_while_draining_a_generation(self, lm):
        srv = ModelServer(lm, port=0, input_dtype=np.int32, gen_slots=1,
                          gen_capacity=16).start()
        try:
            b = srv.batcher()
            orig = b._decode

            def slow(*a):  # the drain outlasts several /ready probes
                time.sleep(0.05)
                return orig(*a)

            b._decode = slow
            req = b.submit(np.arange(1, 5, dtype=np.int32), 8,
                           temperature=0.0)
            next(req.stream())  # admitted and decoding
            stopper = threading.Thread(target=srv.stop)
            stopper.start()
            codes = set()
            deadline = time.monotonic() + WAIT_S
            while srv.ready() and time.monotonic() < deadline:
                time.sleep(0.001)  # stop() flips readiness first
            while stopper.is_alive() and time.monotonic() < deadline:
                try:
                    _get(srv.port, "/ready")
                    codes.add(200)
                except urllib.error.HTTPError as e:
                    codes.add(e.code)
                except OSError:
                    break  # the listener closed after the drain
                time.sleep(0.01)
            stopper.join(WAIT_S)
            assert 503 in codes and 200 not in codes, codes
            assert req.event.is_set()
            assert req.wait().shape == (8,)  # the admitted one finished
        finally:
            srv.stop()


class TestHTTPStreaming:
    def test_http_sse_streams_per_token(self, lm):
        srv = ModelServer(lm, port=0, input_dtype=np.int32, gen_slots=2,
                          gen_capacity=16).start()
        try:
            body = {"prompt": list(range(2, 8)), "max_new_tokens": 5,
                    "temperature": 0.0}
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            events = []
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                assert r.headers["Content-Type"] == "text/event-stream"
                for line in r:
                    if line.startswith(b"data: "):
                        events.append(json.loads(line[len(b"data: "):]))
            assert events[-1]["done"] is True
            toks = [e["token"] for e in events[:-1]]
            assert len(toks) == 5 and events[-1]["tokens"] == toks
            assert _post(srv.port, "/generate?stream=false",
                         body)["tokens"] == toks
        finally:
            srv.stop()

    def test_http_admission_error_is_typed_not_streamed(self, lm):
        srv = ModelServer(lm, port=0, input_dtype=np.int32, gen_slots=1,
                          gen_capacity=16).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv.port, "/generate",
                      {"prompt": list(range(1, 15)), "max_new_tokens": 8})
            assert ei.value.code == 400  # CapacityError, before any frame
            assert json.loads(ei.value.read())["cause"] == "over_capacity"
        finally:
            srv.stop()

    def test_client_disconnect_mid_sse_frees_slot(self, lm):
        srv = ModelServer(lm, port=0, input_dtype=np.int32, gen_slots=1,
                          gen_capacity=64).start()
        try:
            b = srv.batcher()
            orig = b._decode

            def slow(*a):  # hold the stream open while the client leaves
                time.sleep(0.01)
                return orig(*a)

            b._decode = slow
            body = json.dumps({"prompt": list(range(2, 8)),
                               "max_new_tokens": 40}).encode()
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=WAIT_S)
            s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            buf = b""
            while buf.count(b"data: ") < 2:  # the stream is live
                buf += s.recv(4096)
            # SO_LINGER(0): close sends RST, so the server's next flush
            # fails at once
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
            s.close()
            shed = srv.metrics.counter("serve_shed_total",
                                       {"cause": "client_gone"})
            slots = srv.metrics.gauge("serve_gen_active_slots")
            deadline = time.monotonic() + WAIT_S
            while ((shed.value < 1 or slots.value > 0)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert shed.value == 1, "disconnect was not counted as shed"
            assert slots.value == 0, "decode slot still held by a dead client"
            out = _post(srv.port, "/generate?stream=false",
                        {"prompt": [1, 2, 3], "max_new_tokens": 4,
                         "temperature": 0.0})
            assert len(out["tokens"]) == 4
            scrape = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics",
                timeout=WAIT_S).read().decode()
            assert "serve_http_errors_total" not in scrape
        finally:
            srv.stop()


def _counter_value(metrics, name, labels):
    return metrics.counter(name, labels).value


class _FakeWorker:
    """Duck-typed watchdog target with a controllable heartbeat."""

    def __init__(self, beat=0.0, alive=True, restart_ok=True):
        self.beat = beat
        self.alive = alive
        self.restart_ok = restart_ok
        self.restarts = []

    def heartbeat(self):
        return self.beat

    def worker_alive(self):
        return self.alive

    def restart_worker(self, reason):
        self.restarts.append(reason)
        return self.restart_ok


class TestHealth:
    def test_worst_cause_wins_and_clears(self):
        m = MetricsRegistry()
        h = Health(metrics=m, component="serve")
        gauge = m.gauge("serve_health_state", {"component": "serve"})
        assert h.state() == "ok" and gauge.value == 0
        h.degrade("breaker")
        assert h.state() == "degraded" and gauge.value == 1
        h.fail("watchdog:w")
        assert h.state() == "failed" and gauge.value == 2
        h.degrade("watchdog:w")  # a failed cause is not downgraded
        assert h.state() == "failed"
        assert h.snapshot() == {"status": "failed",
                                "causes": ["breaker", "watchdog:w"]}
        h.clear("watchdog:w")
        h.clear("breaker")
        assert h.ok() and gauge.value == 0

    def test_retry_after_scales_with_depth(self):
        import random

        rng = random.Random(0)
        assert retry_after_s(0, 10, rng) in (1,)
        full = [retry_after_s(10, 10, rng) for _ in range(20)]
        assert all(24 <= s <= 36 for s in full) and len(set(full)) > 1


class TestWatchdog:
    def _dog(self, comp, clock, metrics=None, health=None, max_restarts=3):
        return Watchdog(lambda: [("w", comp)], deadline_s=1.0, poll_s=0.01,
                        metrics=metrics, health=health,
                        max_restarts=max_restarts, clock=clock)

    def test_detects_missed_heartbeat_and_restarts(self):
        m = MetricsRegistry()
        h = Health(metrics=m)
        comp = _FakeWorker(beat=0.0)
        t = [0.5]
        dog = self._dog(comp, lambda: t[0], metrics=m, health=h)
        assert dog.check_once() == 0
        t[0] = 2.0
        assert dog.check_once() == 1
        assert len(comp.restarts) == 1 and "deadline" in comp.restarts[0]
        assert not h.ok() and h.state() == "degraded"
        assert _counter_value(m, "serve_watchdog_stalls_total",
                              {"component": "w"}) == 1
        assert _counter_value(m, "serve_watchdog_restarts_total",
                              {"component": "w"}) == 1
        comp.beat = 2.0
        assert dog.check_once() == 0
        assert h.ok()

    def test_a_component_shut_down_on_purpose_is_no_stall(self, lm):
        eng = ServeEngine(lm, batch_buckets=(1,), max_wait_ms=1.0)
        health = Health()
        dog = Watchdog(lambda: [("engine", eng)], deadline_s=5.0,
                       health=health)
        eng.shutdown(drain=True)
        assert not eng.worker_alive()
        assert dog.check_once() == 0
        assert health.ok()

    def test_a_duck_typed_component_closing_is_no_stall(self):
        class Closing(_FakeWorker):
            def closing(self):
                return True

        comp = Closing(beat=0.0, alive=False)
        health = Health()
        dog = self._dog(comp, lambda: 10.0, health=health)
        assert dog.check_once() == 0
        assert comp.restarts == [] and health.ok()

    def test_dead_thread_is_a_stall(self):
        comp = _FakeWorker(beat=0.0, alive=False)
        dog = self._dog(comp, lambda: 0.0)
        assert dog.check_once() == 1
        assert "dead" in comp.restarts[0]

    def test_gives_up_after_max_restarts(self):
        h = Health()
        comp = _FakeWorker(beat=0.0)
        dog = self._dog(comp, lambda: 10.0, health=h, max_restarts=2)
        for _ in range(2):
            dog.check_once()
        assert h.state() == "degraded" and len(comp.restarts) == 2
        dog.check_once()
        assert h.state() == "failed"
        assert len(comp.restarts) == 2

    def test_component_exceptions_do_not_kill_the_dog(self):
        class Exploding:
            def heartbeat(self):
                raise RuntimeError("mid-teardown")

            def worker_alive(self):
                return True

        dog = Watchdog(lambda: [("boom", Exploding())], deadline_s=1.0,
                       clock=lambda: 0.0)
        assert dog.check_once() == 0

    def test_background_loop_runs(self):
        comp = _FakeWorker(beat=0.0)
        dog = self._dog(comp, lambda: 100.0).start()
        try:
            deadline = time.monotonic() + WAIT_S
            while not comp.restarts and time.monotonic() < deadline:
                time.sleep(0.01)
            assert comp.restarts
        finally:
            dog.stop()

    def test_engine_and_batcher_heartbeats_are_live(self, lm):
        eng = ServeEngine(_dense_model(), batch_buckets=(1,))
        cb = ContinuousBatcher(lm, slots=1, capacity=16, seed=0)
        dog = Watchdog(lambda: [("engine", eng), ("batcher", cb)],
                       deadline_s=5.0)
        try:
            assert eng.worker_alive() and cb.worker_alive()
            assert eng.queue_depth() == 0 and cb.queue_depth() == 0
            before = (eng.heartbeat(), cb.heartbeat())
            time.sleep(0.15)  # idle workers beat every 50 ms
            assert eng.heartbeat() > before[0] and cb.heartbeat() > before[1]
            assert dog.check_once() == 0
        finally:
            eng.shutdown()
            cb.shutdown()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_watchdog_restarts_dead_batcher_worker(self, lm):
        metrics = MetricsRegistry()
        cb = ContinuousBatcher(lm, slots=1, capacity=16, seed=0,
                               metrics=metrics)
        health = Health(metrics=metrics)
        dog = Watchdog(lambda: [("batcher", cb)], deadline_s=5.0,
                       metrics=metrics, health=health)
        try:
            prompt = np.arange(4, dtype=np.int32)
            ref = cb.generate(prompt, 3, temperature=0.0)
            orig = cb._decode

            def dying(*a):
                cb._decode = orig
                raise RuntimeError("injected decode failure")

            cb._decode = dying
            with pytest.raises(WorkerStallError):
                cb.generate(prompt, 3, temperature=0.0)
            deadline = time.monotonic() + WAIT_S
            while cb.worker_alive() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert dog.check_once() == 1  # dead thread -> restart
            np.testing.assert_array_equal(
                cb.generate(prompt, 3, temperature=0.0), ref)
            assert dog.check_once() == 0
            assert health.ok()
            assert _counter_value(metrics, "serve_watchdog_restarts_total",
                                  {"component": "batcher"}) == 1
        finally:
            dog.stop()
            cb.shutdown(timeout=WAIT_S)


def _call(port, path, body=None, headers=None):
    """(status, JSON body, response headers) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _chaos_admin_script(server_cls, faults_mod, model):
    gated = server_cls(model, port=0, input_dtype=np.int32).start()
    srv = server_cls(model, port=0, input_dtype=np.int32,
                     chaos_admin=True).start()
    ids = [[1, 2, 3, 4]]
    out = []
    try:
        out.append(_call(gated.port, "/v1/debug/chaos")[:2])
        out.append(_call(gated.port, "/v1/debug/chaos",
                         {"specs": ["http.handler:error"]})[0])
        out.append(_call(srv.port, "/v1/debug/chaos")[:2])
        out.append(_call(srv.port, "/v1/debug/chaos",
                         {"specs": ["http.handler:error", "x:bogus"]})[:2])
        out.append(faults_mod.ACTIVE is None)  # nothing partially armed
        out.append(_call(srv.port, "/v1/debug/chaos",
                         {"specs": ["http.handler:error:times=1",
                                    "serve.dispatch:delay:delay_s=0"],
                          "seed": 3})[:2])
        out.append(_call(srv.port, "/predict", {"ndarray": ids})[:2])
        out.append(_call(srv.port, "/predict", {"ndarray": ids})[0])
        out.append(_call(srv.port, "/v1/debug/chaos")[:2])
        out.append(_call(srv.port, "/v1/debug/chaos",
                         {"uninstall": True})[:2])
        out.append(faults_mod.ACTIVE is None)
    finally:
        faults_mod.uninstall()
        srv.stop()
        gated.stop()
    return out


class TestDebugSurface:
    def test_chaos_admin_matches_jax(self):
        from deeplearning4j_torch.chaos import faults as tfaults
        from deeplearning4j_tpu.chaos import faults as jfaults
        from deeplearning4j_tpu.serve import ModelServer as JServer

        jm, tm = _models()
        want = _chaos_admin_script(JServer, jfaults, jm)
        got = _chaos_admin_script(ModelServer, tfaults, tm)
        assert got == want
        assert got[0] == (404, {"error": "unknown endpoint"})
        assert got[3][0] == 400 and got[6][0] == 500 and got[7] == 200

    def test_request_traces_and_flight_match_jax(self):
        from deeplearning4j_torch.obs import flight as tflight
        from deeplearning4j_torch.obs import reqtrace as treq
        from deeplearning4j_torch.obs import trace as ttrace
        from deeplearning4j_tpu.obs import flight as jflight
        from deeplearning4j_tpu.obs import reqtrace as jreq
        from deeplearning4j_tpu.obs import trace as jtrace
        from deeplearning4j_tpu.serve import ModelServer as JServer

        def run(server_cls, flight, reqtrace, trace, model):
            srv = server_cls(model, port=0, input_dtype=np.int32,
                             gen_slots=2, gen_capacity=16).start()
            out = [_call(srv.port, "/v1/debug/flight")[0]]
            rec = flight.install(flight.FlightRecorder())
            reqtrace.install(reqtrace.RequestTracer(tracer=trace.Tracer()))
            parent = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
            try:
                code, body, hdrs = _call(
                    srv.port, "/predict", {"ndarray": [[3, 1, 4, 1]]},
                    headers={"traceparent": parent,
                             "X-Request-Id": "req-fixed"})
                out.append((code, hdrs["X-Request-Id"],
                            hdrs["traceparent"].split("-")[1]))
                out.append(_call(srv.port, "/generate?stream=false",
                                 {"prompt": [5, 9, 2, 6],
                                  "max_new_tokens": 3,
                                  "temperature": 0.0})[:2])
                out.append(_call(srv.port, "/predict", {"nd": 1})[0])
                time.sleep(0.05)  # the flush stage lands after the reply
                reqs = _call(srv.port, "/v1/debug/requests")[1]["requests"]
                out.append([(r["kind"], r["status"], r["error"],
                             r["request_id"] if r["kind"] == "predict" and
                             r["status"] == "ok" else None,
                             [st["name"] for st in r["stages"]],
                             r["ticks"]) for r in reqs])
                snap = _call(srv.port, "/v1/debug/flight")[1]
                out.append(sorted(snap))
                out.append(len(snap["requests"]) == len(reqs))
            finally:
                reqtrace.uninstall()
                flight.uninstall()
                srv.stop()
            return out

        jm, tm = _models()
        want = run(JServer, jflight, jreq, jtrace, jm)
        got = run(ModelServer, tflight, treq, ttrace, tm)
        assert got == want
        assert got[0] == 404
        assert got[1] == (200, "req-fixed", "0af7651916cd43dd8448eb211c80319c")
        stages = got[4][0][4]
        assert stages == ["admit", "queue", "device", "flush"]


def _server_config(**gen):
    """The serving config of the strict-server tests: the knobs given to
    ModelServer below (the model is the module's; its seed and kwargs
    only name it)."""
    return {"model": "causallm", "seed": 0, "dtype": "int32",
            "model_kwargs": {"input_shape": [16], "num_layers": 2,
                             "d_model": 32, "num_heads": 4, "vocab": 50},
            "engine": {"batch_buckets": [1, 2], "length_buckets": [8, 16]},
            "gen": {"slots": 2, "capacity": 16, "kv": "paged",
                    "block_size": 16, "prefill_chunk": 8, "seed": 0,
                    **gen}}


def _strict_server(tm, store, manifest, **kw):
    return ModelServer(tm, port=0, batch_buckets=(1, 2),
                       length_buckets=(8, 16), input_dtype=np.int32,
                       gen_slots=2, gen_capacity=16, gen_prefill_chunk=8,
                       aot_store=store, strict_aot=True,
                       aot_manifest=manifest, **kw)


class TestStrictServer:
    def test_prebuilt_strict_boot_serves_and_refuses_typed(self, tmp_path):
        """Prebuild, then a strict ModelServer on the store: zero compiles,
        answers equal to the JAX package's (generate: greedy tokens;
        predict: 1e-5), an uncovered signature a typed 503 that captures
        nothing, and ``/v1/debug/profile`` live once a profiler is
        installed."""
        from deeplearning4j_torch.aot import AotStore, enumerate_config
        from deeplearning4j_torch.aot.__main__ import prebuild
        from deeplearning4j_torch.obs import profile
        from deeplearning4j_tpu.serve import ServeEngine as JServeEngine

        jm, tm = _models()
        store = AotStore(str(tmp_path))
        manifest = enumerate_config(_server_config())
        report = prebuild(store, manifest, model=tm)
        assert report["drift"] == [] and report["total_signatures"] == 7
        m = MetricsRegistry()
        srv = _strict_server(tm, store, manifest, metrics=m).start()
        jeng = JServeEngine(jm, batch_buckets=(1, 2), length_buckets=(8, 16))
        try:
            x = np.random.RandomState(3).randint(0, 50, (2, 11))
            got = np.asarray(_post(srv.port, "/predict",
                                   {"ndarray": x.tolist()})["output"])
            np.testing.assert_allclose(got, jeng.predict(x.astype(np.int32)),
                                       rtol=1e-5, atol=1e-5)
            prompt = [4, 8, 15, 16, 23]
            toks = _post(srv.port, "/generate?stream=false",
                         {"prompt": prompt, "max_new_tokens": 5,
                          "temperature": 0.0})["tokens"]
            want = jg.generate(jm, np.asarray([prompt], np.int32), 5,
                               temperature=0.0)[0]
            assert toks == np.asarray(want).tolist()
            status, body, _ = _call(srv.port, "/predict",
                                    {"ndarray": [[[1, 2]] * 4]})
            assert status == 503 and body["cause"] == "aot_trace"
            fns = {**srv.engine.aot_functions(),
                   **srv.batcher().aot_functions()}
            assert all(f.call_captures == 0 for f in fns.values())
            assert sum(v for v in _series(
                m, "serve_compile_misses_total").values()) == 0
            assert _get(srv.port, "/v1/debug/profile") == {"enabled": False}
            profile.install(profile.Profiler(sample_rate=1))
            try:
                _post(srv.port, "/predict", {"ndarray": x.tolist()})
                prof = _get(srv.port, "/v1/debug/profile")
            finally:
                profile.uninstall()
            assert prof["enabled"] and prof["padding"]["engine/2"][
                "waste_ratio"] == 0.0
            (ex,) = prof["executables"]
            assert ex["tag"] == "engine_forward" and ex["sampled"] == 1
        finally:
            srv.stop()
            jeng.shutdown()

    def test_manifest_gate_refuses_an_uncovered_store_like_jax(self,
                                                               tmp_path):
        from deeplearning4j_torch.aot import AotStore, enumerate_config
        from deeplearning4j_torch.aot.__main__ import prebuild
        from deeplearning4j_tpu.aot import AotStore as JAotStore
        from deeplearning4j_tpu.serve import AotTraceError as JAotTraceError
        from deeplearning4j_tpu.serve import ModelServer as JServer

        jm, tm = _models()
        manifest = enumerate_config(_server_config())
        with pytest.raises(AotTraceError, match="obligation"):
            _strict_server(tm, AotStore(str(tmp_path / "t")), manifest)
        with pytest.raises(JAotTraceError, match="obligation"):
            JServer(jm, port=0, aot_store=JAotStore(str(tmp_path / "j")),
                    strict_aot=True, aot_manifest=manifest)
        # a store prebuilt for other knobs covers another manifest
        store = AotStore(str(tmp_path / "other"))
        prebuild(store, enumerate_config(_server_config(slots=3)), model=tm)
        with pytest.raises(AotTraceError, match="no coverage record"):
            _strict_server(tm, store, manifest)

    def test_strict_without_a_manifest_fails_the_boot(self, tmp_path):
        """No manifest: the strict boot's own warm finds the empty store
        and refuses, before the server listens."""
        from deeplearning4j_torch.aot import AotStore

        with pytest.raises(AotTraceError):
            _strict_server(_models()[1], AotStore(str(tmp_path)), None)

    def test_strict_boot_fails_on_a_bad_generation_knob(self, tmp_path):
        """A token model's generation stack is built at a strict boot, so
        a knob it refuses fails the boot, not the first /generate."""
        from deeplearning4j_torch.aot import AotStore, enumerate_config
        from deeplearning4j_torch.aot.__main__ import prebuild

        tm = _models()[1]
        store = AotStore(str(tmp_path))
        prebuild(store, enumerate_config(_server_config()), model=tm)
        with pytest.raises(ValueError, match="kv must be"):
            _strict_server(tm, store, None, gen_kv="bogus")

    def test_strict_predict_only_model_boots_without_a_batcher(
            self, tmp_path):
        """A model the batcher cannot decode boots strict predict-only
        from a store its engine warmed."""
        from deeplearning4j_torch.aot import AotStore
        from deeplearning4j_torch.serve import ServeEngine

        m = _dense_model()
        store = AotStore(str(tmp_path))
        first = ServeEngine(m, batch_buckets=(1, 2), aot_store=store)
        first.warm(np.float32)
        first.shutdown()
        srv = ModelServer(m, port=0, batch_buckets=(1, 2),
                          aot_store=store, strict_aot=True).start()
        try:
            x = np.ones((2, 4), np.float32)
            got = _post(srv.port, "/predict", {"ndarray": x.tolist()})
            np.testing.assert_allclose(np.asarray(got["output"]),
                                       srv.engine.predict(x), rtol=0,
                                       atol=0)
            assert srv._batcher is None
        finally:
            srv.stop()


def _series(metrics, name):
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in metrics.snapshot().get(name, {}).get("series", [])}
