"""The port's chaos plane (deeplearning4j_torch/chaos/) against the JAX
package's: spec parsing, seeded firing order, the retry policy's delays,
and the fault seams the port wires — ``serve.dispatch`` in the engine,
``serve.decode_step`` in the continuous batcher and ``http.handler`` in
the HTTP front end — each raising the same typed error (and HTTP answer)
as the reference's for the same armed fault. Every plane installed in a
test is uninstalled in ``finally``.
"""

import functools
import json
import random
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_torch.chaos import faults as tfaults
from deeplearning4j_torch.chaos import retry as tretry
from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn.layers import Dense, Output
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.obs.metrics import MetricsRegistry
from deeplearning4j_torch.serve import (ContinuousBatcher, ModelServer,
                                        ServeEngine)
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu.chaos import faults as jfaults
from deeplearning4j_tpu.chaos import retry as jretry
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JMetrics

WAIT_S = 30


# ------------------------------------------------------------ spec parsing
@pytest.mark.parametrize("spec", [
    "aot.store_read:corrupt:times=1",
    "fleet.page_in_transfer:error:type=os,times=2",
    "fleet.page_in_transfer:error:type=timeout,after=3,prob=0.5",
    "serve.decode_step:hang:hang_s=5,after=1",
    "serve.decode_step:hang",
    "http.handler:delay:delay_s=0.01",
    "http.handler:delay",
    "serve.dispatch:error",
    "serve.dispatch:error:type=connection:times=-1",
    "cluster.transport:error:scope=replica-0,times=4",
])
def test_parse_spec_equal(spec):
    assert tfaults.parse_spec(spec) == jfaults.parse_spec(spec)


@pytest.mark.parametrize("bad", ["nocolon", "p:unknownmode",
                                 "p:error:type=nope", "p:error:bogus=1",
                                 "p:delay:delay_s=0.1,hang_s=2"])
def test_parse_spec_rejects_alike(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(bad)
    with pytest.raises(ValueError) as got:
        tfaults.parse_spec(bad)
    assert str(got.value) == str(want.value)


def test_points_equal():
    assert tfaults.POINTS == jfaults.POINTS


# ---------------------------------------------------------- firing order
def _fire_script(mod, metrics_cls):
    reg = metrics_cls()
    fp = mod.FaultPlane(seed=7, metrics=reg)
    fp.inject("serve.dispatch", error=RuntimeError, after=2, times=2)
    fp.inject_spec("fleet.page_in_transfer:error:type=os,times=-1,prob=0.5")
    fp.inject("aot.store_read", corrupt=True, times=3)
    fp.inject("cluster.transport", error=ConnectionError("cut"),
              scope="replica-1", times=1)
    fp.inject("http.handler", delay_s=0.0, times=2)
    trail = []
    for point, data, scope in (
            [("serve.dispatch", None, None)] * 5
            + [("fleet.page_in_transfer", None, None)] * 12
            + [("aot.store_read", b"weights-bytes", None)] * 4
            + [("cluster.transport", None, "replica-0"),
               ("cluster.transport", None, "replica-1"),
               ("cluster.transport", None, "replica-1")]
            + [("http.handler", None, None)] * 3):
        try:
            out = fp.hit(point, data=data, scope=scope)
            trail.append(("ok", out))
        except Exception as e:
            trail.append((type(e).__name__, str(e)))
    return {"trail": trail, "stats": fp.stats(),
            "injected": fp.injected(),
            "hits": {p: fp.hits(p) for p in mod.POINTS},
            "prom": reg.to_prometheus()}


def test_fault_plane_fires_alike():
    want = _fire_script(jfaults, JMetrics)
    got = _fire_script(tfaults, MetricsRegistry)
    assert got == want
    assert got["trail"][2][0] == "RuntimeError"
    # the first corrupting hit flips one seeded byte of the data
    kind, data = got["trail"][17]
    assert kind == "ok" and len(data) == 13 and data != b"weights-bytes"
    assert sum(a != b for a, b in zip(data, b"weights-bytes")) == 1


@pytest.mark.parametrize("kw", [{}, {"error": OSError, "corrupt": True},
                                {"error": OSError, "times": 0},
                                {"delay_s": 0.1, "times": -2}])
def test_inject_rejects_alike(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlane().inject("serve.dispatch", **kw)
    with pytest.raises(ValueError) as got:
        tfaults.FaultPlane().inject("serve.dispatch", **kw)
    assert str(got.value) == str(want.value)


def test_hang_is_released_by_uninstall():
    fp = tfaults.install(tfaults.FaultPlane())
    fp.inject("serve.decode_step", hang_s=30.0)
    t0 = time.monotonic()
    th = threading.Thread(target=fp.hit, args=("serve.decode_step",))
    th.start()
    time.sleep(0.05)
    assert tfaults.uninstall() is fp
    th.join(5)
    assert not th.is_alive() and time.monotonic() - t0 < 5
    assert tfaults.ACTIVE is None


def test_scenario_always_uninstalls():
    with pytest.raises(RuntimeError):
        with tfaults.scenario(tfaults.FaultPlane()) as fp:
            assert tfaults.ACTIVE is fp
            raise RuntimeError("x")
    assert tfaults.ACTIVE is None


# ------------------------------------------------------------- retry policy
@pytest.mark.parametrize("attempts,base,cap,seed", [
    (3, 0.05, 2.0, 0), (6, 0.1, 0.5, 11), (1, 0.05, 1.0, 3)])
def test_retry_delays_and_outcomes_equal(attempts, base, cap, seed):
    def run(mod, metrics_cls):
        reg = metrics_cls()
        slept = []
        pol = mod.RetryPolicy(attempts=attempts, base_s=base, cap_s=cap,
                              rng=random.Random(seed), sleep=slept.append,
                              metrics=reg)
        delays = [pol.backoff_s(i) for i in range(6)]
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        out = []
        for fn in (flaky, lambda: "clean"):
            try:
                out.append(pol.call(fn, op="fleet.page_in_transfer"))
            except OSError as e:
                out.append(f"raised {e}")
        try:
            pol.call(lambda: (_ for _ in ()).throw(KeyError("k")), op="x",
                     give_up=(KeyError,))
        except KeyError:
            out.append("gave up")
        return {"delays": delays, "slept": slept, "out": out,
                "prom": reg.to_prometheus()}

    assert run(tretry, MetricsRegistry) == run(jretry, JMetrics)


def test_retry_rejects_zero_attempts():
    with pytest.raises(ValueError):
        tretry.RetryPolicy(attempts=0)


# -------------------------------------------------------------- the seams
def _dense_pair():
    from deeplearning4j_tpu.nn.layers import Dense as JDense
    from deeplearning4j_tpu.nn.layers import Output as JOutput
    from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
    from deeplearning4j_tpu.nn.model import Sequential as JSequential

    jm = JSequential(JNetConfig(seed=0),
                     [JDense(n_out=6, activation="tanh"),
                      JOutput(n_out=3, loss="mcxent", activation="softmax")],
                     (4,))
    jm.init()
    tm = Sequential(NetConfig(seed=0),
                    [Dense(n_out=6, activation="tanh"),
                     Output(n_out=3, loss="mcxent", activation="softmax")],
                    (4,), device="cpu")
    tm.init()
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    return jm, tm


@functools.lru_cache(maxsize=None)
def _lm_pair():
    from deeplearning4j_tpu.models import CausalLM as JCausalLM

    jm = JCausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                   num_heads=4, vocab=50).build()
    jm.init()
    tm = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                  num_heads=4, vocab=50, device="cpu").build()
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    return jm, tm


def _typed(fn):
    try:
        fn()
    except Exception as e:
        return (type(e).__name__, getattr(e, "cause", None),
                getattr(e, "http_status", None))
    return None


def _engine_seam(serve_mod, faults_mod, model):
    eng = serve_mod.ServeEngine(model, batch_buckets=(1, 2), max_wait_ms=1.0)
    x = np.zeros((4,), np.float32)
    try:
        ref = np.asarray(eng.predict(x))
        fp = faults_mod.install(faults_mod.FaultPlane())
        fp.inject("serve.dispatch", error=RuntimeError, times=1)
        first = _typed(lambda: eng.predict(x))
        deadline = time.monotonic() + 5.0
        while eng.worker_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        dead = _typed(lambda: eng.submit(x[None]))
        faults_mod.uninstall()
        restarted = eng.restart_worker(reason="test")
        again = np.asarray(eng.predict(x))
        out = {"first": first, "dead": dead, "restarted": restarted,
               "hits": fp.hits("serve.dispatch"),
               "same": bool(np.array_equal(again, ref))}
    finally:
        faults_mod.uninstall()
        eng.shutdown(drain=True)
    # read after the drain: a worker may still hold its lease a moment
    # after answering
    out["inflight"] = eng.registry.inflight()
    return out, ref


def test_serve_dispatch_seam_alike():
    from deeplearning4j_tpu import serve as jserve

    from deeplearning4j_torch import serve as tserve

    jm, tm = _dense_pair()
    want, jref = _engine_seam(jserve, jfaults, jm)
    got, tref = _engine_seam(tserve, tfaults, tm)
    assert got == want
    assert got["first"] == ("WorkerStallError", "worker_stall", 503)
    assert got["dead"] == ("ServerClosingError", "worker_dead", 503)
    np.testing.assert_allclose(tref, jref, rtol=1e-5, atol=1e-6)


def _batcher_seam(cb_cls, faults_mod, lm):
    cb = cb_cls(lm, slots=2, capacity=16, seed=0)
    prompt = np.arange(4, dtype=np.int32)
    try:
        ref = cb.generate(prompt, 4, temperature=0.0)
        fp = faults_mod.install(faults_mod.FaultPlane())
        fp.inject("serve.decode_step", error=RuntimeError, times=1)
        first = _typed(lambda: cb.generate(prompt, 4, temperature=0.0))
        deadline = time.monotonic() + 5.0
        while cb.worker_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        dead = _typed(lambda: cb.submit(prompt, 4))
        faults_mod.uninstall()
        restarted = cb.restart_worker(reason="test")
        again = cb.generate(prompt, 4, temperature=0.0)
        out = {"first": first, "dead": dead, "restarted": restarted,
               "tokens": np.asarray(again).tolist(),
               "same": bool(np.array_equal(again, ref))}
    finally:
        faults_mod.uninstall()
        cb.shutdown(drain=True)
    # read after the drain: the decode loop holds its tick's lease a
    # moment after the request it finished was answered
    out["inflight"] = cb.registry.inflight()
    return out


def test_serve_decode_step_seam_alike():
    from deeplearning4j_tpu.serve import ContinuousBatcher as JBatcher

    jm, tm = _lm_pair()
    want = _batcher_seam(JBatcher, jfaults, jm)
    got = _batcher_seam(ContinuousBatcher, tfaults, tm)
    assert got == want
    assert got["first"] == ("WorkerStallError", "worker_stall", 503)
    assert got["same"] and got["restarted"]


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http_seam(server_cls, faults_mod, model):
    srv = server_cls(model, port=0, batch_buckets=(1, 2)).start()
    try:
        x = {"ndarray": [[0.5, -1.0, 2.0, 0.25]]}
        ok = _post(srv.port, "/predict", x)[0]
        faults_mod.install(faults_mod.FaultPlane()).inject(
            "http.handler", error=RuntimeError, times=1)
        faulted = _post(srv.port, "/predict", x)
        after = _post(srv.port, "/predict", x)[0]
        return {"ok": ok, "faulted": faulted, "after": after}
    finally:
        faults_mod.uninstall()
        srv.stop()


def test_http_handler_seam_alike():
    from deeplearning4j_tpu.serve import ModelServer as JServer

    jm, tm = _dense_pair()
    want = _http_seam(JServer, jfaults, jm)
    got = _http_seam(ModelServer, tfaults, tm)
    assert got == want
    assert got["faulted"] == (500, {"error": "RuntimeError: chaos: "
                                    "injected fault at 'http.handler'"})


def test_no_fault_plane_calls_when_disabled(monkeypatch):
    """With no plane installed the port's seams must not call into the
    fault plane at all — booby-trap every entry point."""
    def boom(*a, **k):
        raise AssertionError("fault plane touched while disabled")

    for name in ("hit", "inject", "inject_spec", "stats"):
        monkeypatch.setattr(tfaults.FaultPlane, name, boom)
    assert tfaults.ACTIVE is None
    _, tm = _dense_pair()
    eng = ServeEngine(tm, batch_buckets=(1,), max_wait_ms=1.0)
    try:
        assert eng.predict(np.zeros(4, np.float32)).shape == (1, 3)
    finally:
        eng.shutdown()
    cb = ContinuousBatcher(_lm_pair()[1], slots=1, capacity=16, seed=0)
    try:
        assert cb.generate(np.arange(4, dtype=np.int32), 3,
                           temperature=0.0).shape == (3,)
    finally:
        cb.shutdown()
