"""The port's fleet tier (deeplearning4j_torch/fleet/) against the JAX
package's: token buckets and tenant admission, circuit breakers and the
LRU weight pager under scripted clocks and stub entries (equal results),
then a :class:`FleetRegistry` of three small CausalLMs in a 2.2-model
weight budget on the CPU (predict answers within 1e-5 of the JAX fleet's
and bit-equal across page cycles, greedy tokens equal, generation numbers
equal across page cycles and publishes), and the routed HTTP front door
against JAX's ``FleetServer`` (status codes, bodies, ``Retry-After``).
The three models are the small CausalLM of the reference's fleet
benchmark (2 layers, d_model 32, 4 heads, vocab 50, T 16), params carried
across with ``params_from_numpy``. ``gpu``-marked tests need the card.
"""

import functools
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch import fleet as tfleet
from deeplearning4j_torch.chaos import faults as tfaults
from deeplearning4j_torch.chaos.retry import RetryPolicy as TRetry
from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.obs import flight as tflight
from deeplearning4j_torch.obs.metrics import MetricsRegistry
from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu import fleet as jfleet
from deeplearning4j_tpu.chaos import faults as jfaults
from deeplearning4j_tpu.chaos.retry import RetryPolicy as JRetry
from deeplearning4j_tpu.obs import flight as jflight
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JMetrics

WAIT_S = 30
NAMES = ("alpha", "beta", "gamma")
ENGINE_OPTS = {"batch_buckets": (1, 2, 4), "queue_limit": 64}
GEN_OPTS = {"slots": 2, "capacity": 32}
FLEET_ATOL = 1e-5


def _outcome(fn):
    """A call's value, or its error's type, message and typed fields."""
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e), getattr(e, "cause", None),
                getattr(e, "http_status", None),
                getattr(e, "retry_after_s", None))


# ----------------------------------------------------------------- tenants
def _bucket_script(mod):
    b = mod.TokenBucket(rate_per_s=4.0, burst=3.0)
    out = []
    for i in range(40):
        now = 0.07 * i
        out.append((b.take(now=now), round(b.wait_s(2.0, now=now), 12)))
    return out, b.tokens


def test_token_bucket_equal():
    assert _bucket_script(tfleet.tenants) == _bucket_script(jfleet.tenants)


@pytest.mark.parametrize("rate,burst", [(0, 1), (1, 0), (-1, 2)])
def test_token_bucket_rejects_alike(rate, burst):
    with pytest.raises(ValueError) as want:
        jfleet.TokenBucket(rate, burst)
    with pytest.raises(ValueError) as got:
        tfleet.TokenBucket(rate, burst)
    assert str(got.value) == str(want.value)


def _tenant_script(mod, metrics_cls):
    reg = metrics_cls()
    table = mod.TenantTable(metrics=reg, default_rate_per_s=3.0,
                            default_burst=2.0)
    table.register("gold", rate_per_s=500, slo="gold")
    table.register("free", rate_per_s=2.0, burst=2.0, slo="batch")
    table.register("std", rate_per_s=1.5)
    trail = []
    for i in range(30):
        now = 0.05 * i
        for tenant, model in (("gold", "alpha"), ("free", "alpha"),
                              ("std", None), ("new-tenant", "beta")):
            res = _outcome(lambda: table.admit(tenant, model=model, now=now))
            if res[0] == "ok":
                res = ("ok", tuple(res[1]))
            trail.append(res)
    try:
        table.register("x", rate_per_s=1, slo="platinum")
    except ValueError as e:
        trail.append(str(e))
    return {"trail": trail, "stats": table.stats(),
            "prom": reg.to_prometheus(),
            "classes": [tuple(c) for c in mod.DEFAULT_SLO_CLASSES]}


def test_tenant_admission_and_retry_after_equal():
    want = _tenant_script(jfleet.tenants, JMetrics)
    got = _tenant_script(tfleet.tenants, MetricsRegistry)
    assert got == want
    sheds = [t for t in got["trail"] if t[0] == "QuotaError"]
    assert sheds and all(t[3] == 429 and t[4] > 0 for t in sheds)
    assert got["stats"]["free"]["shed"] > 0


# ----------------------------------------------------------------- breaker
def _breaker_script(mod, flight_mod, metrics_cls, health_cls):
    t = [0.0]
    reg = metrics_cls()
    health = health_cls(metrics=reg, component="fleet")
    rec = flight_mod.install(flight_mod.FlightRecorder())
    try:
        br = mod.CircuitBreaker(failure_threshold=3, reset_s=5.0,
                                clock=lambda: t[0], metrics=reg,
                                model="beta", health=health)
        trail = []
        ops = (["fail"] * 2 + ["ok"] + ["fail"] * 3 + ["allow"] * 2
               + ["t=4.0", "allow", "t=5.5", "allow", "allow", "fail",
                  "allow", "t=10.6", "allow", "ignored", "allow", "ok",
                  "allow", "fail", "t=11", "allow"])
        for op in ops:
            if op.startswith("t="):
                t[0] = float(op[2:])
                continue
            if op == "allow":
                trail.append(("allow",) + _outcome(br.allow))
            elif op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            else:
                br.record_ignored()
            trail.append((op, br.state(), br.snapshot(), health.snapshot()))
    finally:
        flight_mod.uninstall()
    events = [(e["kind"], e["name"], e.get("detail"), e.get("data"))
              for e in rec.events()]
    return {"trail": trail, "events": events, "prom": reg.to_prometheus()}


def test_breaker_state_sequences_equal():
    from deeplearning4j_torch.serve import Health as THealth
    from deeplearning4j_tpu.serve import Health as JHealth

    want = _breaker_script(jfleet.breaker, jflight, JMetrics, JHealth)
    got = _breaker_script(tfleet.breaker, tflight, MetricsRegistry, THealth)
    assert got == want
    states = [s[1] for s in got["trail"] if s[0] != "allow"]
    assert {"open", "half_open", "closed"} <= set(states)
    opened = [e for e in got["events"] if e[:2] == ("breaker", "open")]
    assert opened and ("dump", "breaker_open", None, None) in got["events"]


# ------------------------------------------------------------------- pager
class _Stub:
    def __init__(self, name, nbytes, log, fail=0):
        self.name = name
        self.weight_bytes = nbytes
        self.log = log
        self.fail = fail

    def activate(self):
        if self.fail > 0:
            self.fail -= 1
            raise OSError(f"transfer of {self.name} torn")
        self.log.append(("in", self.name))

    def deactivate(self):
        self.log.append(("out", self.name))


def _pager_script(mod, retry_cls, faults_mod, metrics_cls):
    log = []
    reg = metrics_cls()
    pager = mod.WeightPager(
        budget_bytes=100, metrics=reg,
        retry=retry_cls(attempts=3, base_s=0.05, cap_s=1.0,
                        rng=random.Random(0), sleep=lambda s: None,
                        metrics=reg))
    a, b, c = (_Stub(n, 40, log) for n in "abc")
    big = _Stub("big", 101, log)
    flaky = _Stub("flaky", 30, log, fail=2)
    dead = _Stub("dead", 30, log, fail=10)
    trail = []
    for entry in (a, b, a, c, b, a, big, flaky, dead, c):
        trail.append(_outcome(lambda: pager.ensure(entry)))
        trail.append(("stats", pager.stats(), pager.resident()))
    fp = faults_mod.install(faults_mod.FaultPlane())
    try:
        fp.inject("fleet.page_in_transfer", error=OSError, times=1)
        trail.append(_outcome(lambda: pager.ensure(b)))
        trail.append(("stats", pager.stats(), fp.stats()))
    finally:
        faults_mod.uninstall()
    pager.drop(a)
    pager.drop(b)
    trail.append(("stats", pager.stats()))
    # page-in wall times differ run to run; everything else must not
    prom = [ln for ln in reg.to_prometheus().splitlines()
            if not ln.startswith("fleet_page_in_seconds")]
    return {"log": log, "trail": trail, "prom": prom}


def test_pager_lru_order_stats_and_errors_equal():
    want = _pager_script(jfleet.pager, JRetry, jfaults, JMetrics)
    got = _pager_script(tfleet.pager, TRetry, tfaults, MetricsRegistry)
    assert got == want
    kinds = [t[0] for t in got["trail"] if t[0] != "stats"]
    assert "CapacityError" in kinds and "PageInError" in kinds
    pie = next(t for t in got["trail"] if t[0] == "PageInError")
    assert pie[2:4] == ("page_in_failed", 503)
    # an exhausted page-in leaves no bytes charged for it
    assert "dead" not in got["trail"][17][2]


def test_pager_single_page_in_per_model():
    log = []
    pager = tfleet.WeightPager(budget_bytes=100)

    class Slow(_Stub):
        def activate(self):
            time.sleep(0.1)
            super().activate()

    e = Slow("m", 10, log)
    threads = [threading.Thread(target=pager.ensure, args=(e,))
               for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(WAIT_S)
    assert log == [("in", "m")] and pager.stats()["page_ins"] == 1


# ------------------------------------------------------ registry: small LMs
@functools.lru_cache(maxsize=None)
def _lms():
    from deeplearning4j_tpu.models import CausalLM as JCausalLM

    out = {}
    for name, seed in zip(NAMES, range(3)):
        jm = JCausalLM(seed=seed, input_shape=(16,), num_layers=2,
                       d_model=32, num_heads=4, vocab=50).build()
        jm.init()
        tm = CausalLM(seed=seed, input_shape=(16,), num_layers=2,
                      d_model=32, num_heads=4, vocab=50, device="cpu").build()
        tm.params = params_from_numpy(tm, jax.tree.map(np.asarray,
                                                       jm.params))
        tm.state = {}
        out[name] = (jm, tm)
    return out


def _weight_bytes():
    jm = _lms()["alpha"][0]
    return sum(int(np.asarray(x).nbytes)
               for x in jax.tree.leaves((jm.params, jm.state)))


def _fleet(side, **kw):
    budget = int(2.2 * _weight_bytes())
    if side == "jax":
        f = jfleet.FleetRegistry(hbm_budget_bytes=budget, **kw)
    else:
        f = tfleet.FleetRegistry(hbm_budget_bytes=budget, device="cpu", **kw)
    for name in NAMES:
        m = _lms()[name][0 if side == "jax" else 1]
        f.add(name, m, input_dtype=np.int32, engine_opts=ENGINE_OPTS,
              gen_opts=GEN_OPTS if name == "gamma" else None)
    return f


PROMPTS = np.random.RandomState(0).randint(0, 50, (4, 1, 16)).astype(
    np.int32)
GEN_PROMPT = np.random.RandomState(1).randint(0, 50, (6,)).astype(np.int32)


def _registry_script(f):
    """Predicts over a page-churning order, a generate, publishes cold and
    resident, more page cycles. Returns outputs, generations, tokens and
    the fleet's status/pager views."""
    # round robin over three models in a two-model budget: every request
    # pages its model in, and alpha and beta meet a prompt again in a
    # later residency
    order = ["alpha", "beta", "gamma"] * 2 + ["alpha", "beta"]
    preds = []
    for i, name in enumerate(order):
        r = f.predict(name, PROMPTS[i % 2], tenant="gold")
        preds.append((name, i % 2, r.generation, np.asarray(r.output)))
    toks = [np.asarray(f.generate("gamma", GEN_PROMPT, 6,
                                  temperature=0.0)).tolist()]
    port = isinstance(f, tfleet.FleetRegistry)
    cold = [n for n in NAMES if not f.get(n).resident][0]
    jm, tm = _lms()[cold]
    new = jax.tree.map(lambda a: np.asarray(a) * 0.5, jm.params)
    if port:
        new = params_from_numpy(tm, new)
    gens = {"cold": (cold, f.publish(cold, new, version="cold-v1"))}
    hot = [n for n in NAMES if f.get(n).resident][-1]
    hot_params = f.get(hot).engine().registry.current().params
    gens["hot"] = (hot, f.publish(hot, hot_params, version="hot-v1"))
    for i, name in enumerate(["alpha", "beta", "gamma", "alpha"]):
        r = f.predict(name, PROMPTS[i], tenant="gold")
        preds.append((name, i, r.generation, np.asarray(r.output)))
    toks.append(np.asarray(f.generate("gamma", GEN_PROMPT, 6,
                                      temperature=0.0)).tolist())
    st = f.status()
    models = {n: {k: v for k, v in m.items() if k != "kv"}
              for n, m in st["models"].items()}
    return {"preds": preds, "toks": toks, "gens": gens, "models": models,
            "pager": st["pager"], "tenants": st["tenants"],
            "breakers": st["breakers"], "health": st["health"],
            "slo": st["slo"]}


@pytest.fixture(scope="module")
def registry_runs():
    runs = {}
    for side in ("jax", "port"):
        f = _fleet(side)
        try:
            runs[side] = _registry_script(f)
        finally:
            f.shutdown()
    return runs


def test_fleet_predicts_match_jax(registry_runs):
    want, got = registry_runs["jax"], registry_runs["port"]
    assert len(got["preds"]) == len(want["preds"]) == 12
    for (n, j, g, y), (wn, wj, wg, wy) in zip(got["preds"], want["preds"]):
        assert (n, j, g) == (wn, wj, wg)
        assert y.shape == wy.shape == (1, 16, 50)
        np.testing.assert_allclose(y, wy, atol=FLEET_ATOL, rtol=0)


def test_fleet_answers_bit_equal_across_page_cycles(registry_runs):
    got = registry_runs["port"]
    seen, repeats = {}, 0
    for name, j, gen, y in got["preds"][:8]:
        key = (name, j)
        if key in seen:
            assert seen[key][0] != gen and np.array_equal(seen[key][1], y)
            repeats += 1
        seen[key] = (gen, y)
    assert repeats == 2
    # every model answered from more than one residency
    gens = {}
    for name, _, gen, _ in got["preds"][:8]:
        gens.setdefault(name, []).append(gen)
    assert all(len(set(v)) > 1 for v in gens.values()), gens
    # the same params answer the same prompt identically to a direct
    # forward
    for name, j, _, y in got["preds"][:8]:
        direct = _lms()[name][1].output(PROMPTS[j]).numpy()
        assert np.array_equal(direct, y), name


def test_fleet_generate_tokens_match_jax(registry_runs):
    from deeplearning4j_tpu.nn.generation import generate as jgenerate

    want, got = registry_runs["jax"], registry_runs["port"]
    assert got["toks"] == want["toks"]
    direct = jgenerate(_lms()["gamma"][0], GEN_PROMPT[None], 6,
                       temperature=0.0)[0].tolist()
    assert got["toks"][0] == direct


def test_fleet_generations_and_status_match_jax(registry_runs):
    want, got = registry_runs["jax"], registry_runs["port"]
    assert got["gens"] == want["gens"]
    assert got["models"] == want["models"]
    assert got["pager"] == want["pager"]
    assert got["tenants"] == want["tenants"]
    assert got["breakers"] == want["breakers"]
    assert got["health"] == want["health"]
    assert got["slo"] == want["slo"]
    assert got["pager"]["page_ins"] >= 8 and got["pager"]["page_outs"] >= 6


def test_fleet_weight_bytes_and_page_log():
    f = _fleet("port")
    try:
        wb = _weight_bytes()
        assert all(f.get(n).weight_bytes == wb for n in NAMES)
        for n in NAMES:
            f.predict(n, PROMPTS[0])
        log = list(f.get("alpha").page_log)
        assert [e["kind"] for e in log] == ["page_in", "page_out"]
        assert all(e["bytes"] == wb for e in log)
        assert log[0]["generation"] == 1 and log[1]["generation"] == 1
    finally:
        f.shutdown()


def _spy_store_host(entry):
    """Count the entry's copies of device weights back into its host copy."""
    calls = []
    real = entry._store_host

    def spy(params, state):
        calls.append(1)
        return real(params, state)

    entry._store_host = spy
    return calls


def test_page_out_without_a_publish_keeps_the_host_copy():
    """Nothing published while resident: the host copy already holds the
    paged-in generation's bytes, so the page-out copies nothing back."""
    f = _fleet("port")
    try:
        entry = f.get("alpha")
        stores = _spy_store_host(entry)
        want = f.predict("alpha", PROMPTS[0]).output
        host = [t.clone() for t in tree_leaves(entry._host_params)]
        f.pager.drop(entry)
        assert stores == [] and entry.page_log[-1]["copied"] is False
        assert all(torch.equal(a, b) for a, b in
                   zip(host, tree_leaves(entry._host_params)))
        r = f.predict("alpha", PROMPTS[0])
        assert r.generation == 2
        np.testing.assert_array_equal(r.output, want)
    finally:
        f.shutdown()


def test_page_out_copies_back_a_generation_published_while_resident():
    """A generation published while resident survives the page-out: the
    page-out copies it into the host copy, and the next page-in serves
    it under the following generation."""
    f = _fleet("port")
    try:
        entry = f.get("alpha")
        stores = _spy_store_host(entry)
        before = f.predict("alpha", PROMPTS[0]).output
        cur = entry.engine().registry.current().params
        half = tree_unflatten(cur, [t * 0.5 for t in tree_leaves(cur)])
        gen = f.publish("alpha", half, version="half")
        hot = f.predict("alpha", PROMPTS[0])
        assert hot.generation == gen
        assert not np.array_equal(hot.output, before)
        f.pager.drop(entry)
        assert stores == [1] and entry.page_log[-1]["copied"] is True
        assert entry.page_log[-1]["generation"] == gen
        assert all(torch.equal(h, w) for h, w in
                   zip(tree_leaves(entry._host_params), tree_leaves(half)))
        r = f.predict("alpha", PROMPTS[0])
        assert r.generation == gen + 1
        np.testing.assert_array_equal(r.output, hot.output)
        # and the residency after it, with nothing published, copies none
        f.pager.drop(entry)
        assert stores == [1] and entry.page_log[-1]["copied"] is False
    finally:
        f.shutdown()


def test_page_out_frees_weights_a_stale_engine_still_holds():
    """A caller that still holds the old engine (a request that lost the
    race with the page-out, or a watchdog poll) must not keep the paged-out
    weights alive: the registry drops its snapshots."""
    import weakref

    f = _fleet("port")
    try:
        f.predict("alpha", PROMPTS[0])
        entry = f.get("alpha")
        stale = entry.engine()
        leaf = weakref.ref(tree_leaves(stale.registry.current().params)[0])
        f.pager.drop(entry)
        assert leaf() is None  # freed at the drop, no collector needed
        with pytest.raises(tfleet.registry.ServerClosingError):
            stale.registry.current()
        # and the model pages back in under the next generation
        assert f.predict("alpha", PROMPTS[0]).generation == 2
    finally:
        f.shutdown()


def test_fleet_refuses_what_is_not_ported():
    # the store options are ported: strict without a store is refused as
    # the reference refuses it, and tuned_for without one is a counted miss
    with pytest.raises(ValueError, match="shared aot_store"):
        tfleet.FleetRegistry(device="cpu", strict_aot=True)
    f = tfleet.FleetRegistry(device="cpu", tuned_for="fp")
    assert f.tuned_config is None
    assert f.metrics.counter("sim_tuned_config_misses_total").value == 1
    tm = _lms()["alpha"][1]
    with pytest.raises(ValueError, match="lives on"):
        tfleet.FleetEntry("x", tm, tm.params, device="meta")
    with pytest.raises(tfleet.UnknownModelError):
        tfleet.FleetRegistry(device="cpu").get("nope")


def test_failed_page_in_releases_its_bytes_and_partial_copy():
    """A transfer that fails part-way is retried from scratch; an exhausted
    one raises PageInError, leaves the model cold and its bytes free."""
    f = _fleet("port")
    entry = f.get("alpha")
    calls = {"n": 0}
    real = entry._device_leaf

    def torn(h):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("torn mid-copy")
        return real(h)

    entry._device_leaf = torn
    f.pager._retry = TRetry(attempts=2, sleep=lambda s: None)
    try:
        r = f.predict("alpha", PROMPTS[0])  # retried, then served
        direct = _lms()["alpha"][1].output(PROMPTS[0]).numpy()
        assert np.array_equal(np.asarray(r.output), direct)
        assert calls["n"] > 3
        f.pager.drop(entry)
        calls["n"] = 0
        entry._device_leaf = lambda h: (_ for _ in ()).throw(
            OSError("always torn"))
        with pytest.raises(tfleet.PageInError) as ei:
            f.predict("alpha", PROMPTS[0])
        assert ei.value.cause == "page_in_failed"
        assert not entry.resident
        assert f.pager.stats()["resident_bytes"] == 0
    finally:
        f.shutdown()


def test_port_fleet_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.FleetRegistry()


# ----------------------------------------------------------- front door
def _http(port, path, body=None, tenant=None):
    headers = {"Content-Type": "application/json"}
    if tenant is not None:
        headers["X-Tenant"] = tenant
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read()), r.headers.get(
                "Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _server_script(side):
    t = [0.0]
    f = _fleet(side, breaker_failures=1, breaker_reset_s=5.0,
               breaker_clock=lambda: t[0])
    f.pager._retry = (JRetry if side == "jax" else TRetry)(
        attempts=2, sleep=lambda s: None)
    f.tenants.register("gold", rate_per_s=500, slo="gold")
    f.tenants.register("free", rate_per_s=0.001, burst=1.0, slo="batch")
    srv_cls = jfleet.FleetServer if side == "jax" else tfleet.FleetServer
    faults_mod = jfaults if side == "jax" else tfaults
    srv = srv_cls(f, port=0, replica_id="r0",
                  jitter_rng=random.Random(0)).start()
    out = []
    try:
        ids = PROMPTS[0].tolist()
        out.append(_http(srv.port, "/v1/models/alpha/predict",
                         {"ndarray": ids}, tenant="gold"))
        out.append(_http(srv.port, "/v1/models/gamma/generate",
                         {"prompt": GEN_PROMPT.tolist(), "max_new_tokens": 5,
                          "temperature": 0.0, "stream": False}))
        out.append(_http(srv.port, "/v1/models/alpha/predict",
                         {"ndarray": ids}, tenant="free"))
        out.append(_http(srv.port, "/v1/models/alpha/predict",
                         {"ndarray": ids}, tenant="free"))       # 429
        out.append(_http(srv.port, "/v1/models/nope/predict",
                         {"ndarray": ids}))                      # 404
        out.append(_http(srv.port, "/v1/models/alpha/explode", {}))
        out.append(_http(srv.port, "/v1/models/alpha/predict", {"x": 1}))
        # a page-in that keeps failing opens beta's breaker (503 twice)
        fp = faults_mod.install(faults_mod.FaultPlane())
        fp.inject("fleet.page_in_transfer", error=OSError, times=-1)
        out.append(_http(srv.port, "/v1/models/beta/predict",
                         {"ndarray": ids}))
        out.append(_http(srv.port, "/v1/models/beta/predict",
                         {"ndarray": ids}))
        faults_mod.uninstall()
        t[0] = 5.5  # half-open: the probe closes it
        out.append(_http(srv.port, "/v1/models/beta/predict",
                         {"ndarray": ids}))
        out.append(_http(srv.port, "/v1/models/beta"))
        out.append(_http(srv.port, "/v1/models"))
        out.append(_http(srv.port, "/v1/replica"))
        out.append(_http(srv.port, "/v1/admin/drain", {"model": "beta"}))
        out.append(_http(srv.port, "/v1/fleet"))
        out.append(_http(srv.port, "/health"))
        out.append(_http(srv.port, "/ready"))
        out.append(_http(srv.port, "/nowhere"))
    finally:
        faults_mod.uninstall()
        srv.stop()
    return out


def _masked(body):
    """JSON bodies without wall-clock-dependent fields."""
    if isinstance(body, dict):
        return {k: _masked(v) for k, v in body.items()
                if k not in ("output", "burn")}
    if isinstance(body, list):
        return [_masked(v) for v in body]
    return body


def test_fleet_server_answers_match_jax():
    want = _server_script("jax")
    got = _server_script("port")
    assert len(got) == len(want)
    for i, ((code, body, retry), (wcode, wbody, wretry)) in enumerate(
            zip(got, want)):
        assert code == wcode, (i, body, wbody)
        assert retry == wretry, (i, retry, wretry)
        assert _masked(body) == _masked(wbody), i
        if "output" in wbody:
            np.testing.assert_allclose(np.asarray(body["output"]),
                                       np.asarray(wbody["output"]),
                                       atol=FLEET_ATOL, rtol=0)
    codes = [c for c, _, _ in got]
    assert codes[:10] == [200, 200, 200, 429, 404, 404, 400, 503, 503, 200]
    assert all(r is not None and int(r) >= 1 for c, _, r in got
               if c in (429, 503))
    assert got[8][1]["cause"] == "breaker_open"
    assert got[13][1] == {"model": "beta", "resident": False}


def test_fleet_server_debug_endpoints():
    f = _fleet("port")
    f.tenants.register("gold", rate_per_s=500, slo="gold")
    rec = tflight.install(tflight.FlightRecorder())
    from deeplearning4j_torch.obs import reqtrace as treq
    from deeplearning4j_torch.obs.trace import Tracer

    treq.install(treq.RequestTracer(tracer=Tracer(), flight=rec))
    srv = tfleet.FleetServer(f, port=0, chaos_admin=True).start()
    try:
        code, body, _ = _http(srv.port, "/v1/models/alpha/predict",
                              {"ndarray": PROMPTS[0].tolist()},
                              tenant="gold")
        assert code == 200
        reqs = _http(srv.port, "/v1/debug/requests")[1]["requests"]
        stages = [s["name"] for s in reqs[-1]["stages"]]
        assert stages[:2] == ["admit", "page_in_wait"]
        assert {"queue", "device", "flush"} <= set(stages)
        assert reqs[-1]["tenant"] == "gold" and reqs[-1]["slo_class"] == \
            "gold"
        assert _http(srv.port, "/v1/debug/flight")[0] == 200
        # no profiler installed: the reference's answer
        assert _http(srv.port, "/v1/debug/profile")[:2] == (
            200, {"enabled": False})
        assert _http(srv.port, "/v1/debug/chaos")[1] == {
            "installed": False, "armed": []}
        code, body, _ = _http(srv.port, "/v1/debug/chaos",
                              {"specs": ["http.handler:error:times=1"]})
        assert code == 200 and body["armed"][0]["point"] == "http.handler"
        assert _http(srv.port, "/v1/models/alpha/predict",
                     {"ndarray": PROMPTS[0].tolist()})[0] == 500
        _http(srv.port, "/v1/debug/chaos", {"uninstall": True})
        time.sleep(0.05)  # request metrics land after the reply
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/metrics",
            headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            text = r.read().decode()
        assert text.endswith("# EOF\n") and "# {trace_id=" in text
        snap = _http(srv.port, "/v1/metrics")[1]
        assert "fleet_page_in_total" in snap
    finally:
        tfaults.uninstall()
        treq.uninstall()
        tflight.uninstall()
        srv.stop()


# --------------------------------------------------------- import hygiene
def test_port_alone_imports_no_jax():
    code = (
        "import sys\n"
        "import deeplearning4j_torch.fleet, deeplearning4j_torch.fleet.http\n"
        "import deeplearning4j_torch.obs.trace, deeplearning4j_torch.obs.flight\n"
        "import deeplearning4j_torch.obs.reqtrace, deeplearning4j_torch.obs.slo\n"
        "import deeplearning4j_torch.obs.metrics, deeplearning4j_torch.chaos\n"
        "import deeplearning4j_torch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'deeplearning4j_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------- on the card only
def _card_lms(n=3):
    ms = []
    for seed in range(n):
        m = CausalLM(seed=seed, input_shape=(64,), num_layers=2,
                     d_model=256, num_heads=4, vocab=1000).build()
        m.init(seed=seed)
        ms.append(m)
    return ms


@pytest.mark.gpu
def test_host_copies_are_pinned_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (m,) = _card_lms(1)
    f = tfleet.FleetRegistry()
    e = f.add("a", m, input_dtype=np.int32)
    leaves = tree_leaves(e._host_params)
    assert leaves and all(t.is_pinned() for t in leaves)
    f.shutdown()


@pytest.mark.gpu
def test_page_out_returns_device_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ms = _card_lms(2)
    f = tfleet.FleetRegistry()
    es = [f.add(n, m, input_dtype=np.int32) for n, m in zip("ab", ms)]
    for m in ms:
        m.params = None
    x = np.zeros((1, 64), np.int32)
    f.predict("a", x)
    before = torch.cuda.memory_allocated()
    f.pager.drop(es[0])
    assert before - torch.cuda.memory_allocated() >= es[0].weight_bytes
    f.shutdown()


@pytest.mark.gpu
def test_resident_model_answers_during_another_page_in():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ms = _card_lms(2)
    f = tfleet.FleetRegistry()
    for n, m in zip("ab", ms):
        f.add(n, m, input_dtype=np.int32)
    x = np.zeros((1, 64), np.int32)
    ref = f.predict("a", x).output
    done = threading.Event()
    answers = []

    def pager():
        f.pager.drop(f.get("b"))
        for _ in range(5):
            f.ensure("b")
            f.pager.drop(f.get("b"))
        done.set()

    th = threading.Thread(target=pager)
    th.start()
    while not done.is_set():
        answers.append(f.predict("a", x).output)
    th.join(WAIT_S)
    assert answers and all(np.array_equal(a, ref) for a in answers)
    f.shutdown()


@pytest.mark.gpu
def test_page_ins_of_every_model_reuse_one_pool():
    """Weights are allocated on one page-in stream for every model, so a
    paged-out model's freed blocks serve the next model's page-in:
    reserved memory stops growing after the first cycles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ms = _card_lms(3)
    wb = sum(t.numel() * t.element_size() for t in tree_leaves(ms[0].params))
    f = tfleet.FleetRegistry(hbm_budget_bytes=int(1.5 * wb))
    for n, m in zip("abc", ms):
        f.add(n, m, input_dtype=np.int32)
        m.params = None
    reserved = []
    for _ in range(4):
        for n in "abc":
            f.ensure(n)
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[-1] == reserved[1]
    f.shutdown()


# ------------------------------------------- the prebuilt-executable store
@pytest.fixture(scope="module")
def strict_run(registry_runs, tmp_path_factory):
    """The registry script on a port fleet sharing one store: a first
    fleet records every signature, a second one runs strict from it."""
    from deeplearning4j_torch.aot import AotStore

    store = AotStore(str(tmp_path_factory.mktemp("aot")))
    out = {}
    for strict in (False, True):
        m = MetricsRegistry()
        f = _fleet("port", aot_store=store, strict_aot=strict, metrics=m)
        try:
            out[strict] = (_registry_script(f), m, f.status())
        finally:
            f.shutdown()
    return out, store


def test_strict_fleet_matches_jax(registry_runs, strict_run):
    """Every page-in of a strict fleet makes its graphs from the store:
    predicts within FLEET_ATOL of the JAX fleet's (which runs without a
    store: its serialized executables do not load here), the same greedy
    tokens and generations, and zero compiles."""
    want = registry_runs["jax"]
    for strict in (False, True):
        got, m, status = strict_run[0][strict]
        for (n, j, g, y), (wn, wj, wg, wy) in zip(got["preds"],
                                                  want["preds"]):
            assert (n, j, g) == (wn, wj, wg)
            np.testing.assert_allclose(y, wy, atol=FLEET_ATOL, rtol=0)
        assert got["toks"] == want["toks"] and got["gens"] == want["gens"]
        assert "entries" in status["aot_store"]
        compiles = sum(s["value"] for s in m.snapshot()[
            "serve_compile_misses_total"]["series"])
        assert (compiles == 0) == strict
    m = strict_run[0][True][1]
    assert sum(s["value"] for s in m.snapshot()["serve_aot_hits_total"][
        "series"]) > 0
    # the first fleet's captures are stamped for the strict one
    from deeplearning4j_torch.aot import covered_keys, runtime_fingerprint

    covered, unreadable = covered_keys(strict_run[1],
                                       runtime_fingerprint("cpu"))
    assert covered and unreadable == 0


def test_strict_page_in_of_an_uncovered_signature_is_typed(strict_run):
    store = strict_run[1]
    f = tfleet.FleetRegistry(device="cpu", aot_store=store, strict_aot=True)
    try:
        f.pager._retry = TRetry(attempts=2, sleep=lambda s: None)
        f.add("alpha", _lms()["alpha"][1], input_dtype=np.int32,
              engine_opts={"batch_buckets": (3,)})  # never prebuilt
        with pytest.raises(tfleet.PageInError) as ei:
            f.predict("alpha", PROMPTS[0])
        assert ei.value.cause == "page_in_failed"
        assert "strict AOT" in str(ei.value.__cause__)
        assert not f.get("alpha").resident
        assert f.pager.stats()["resident_bytes"] == 0
    finally:
        f.shutdown()


def test_tuned_for_sets_every_models_knobs(tmp_path):
    from deeplearning4j_torch.aot import AotStore, put_tuned

    store = AotStore(str(tmp_path))
    put_tuned(store, "wl-1", {"engine": {"batch_buckets": [1, 8],
                                         "bogus": 3},
                              "gen": {"slots": 3, "capacity": 24}})
    f = tfleet.FleetRegistry(device="cpu", aot_store=store,
                             tuned_for="wl-1")
    try:
        assert f.tuned_config["gen"]["slots"] == 3
        e = f.add("alpha", _lms()["alpha"][1], input_dtype=np.int32,
                  engine_opts={"queue_limit": 5})
        assert e.engine_opts == {"batch_buckets": [1, 8], "queue_limit": 5}
        assert e.gen_opts == {"slots": 3, "capacity": 24}
        assert f.metrics.counter("sim_tuned_config_hits_total").value == 1
    finally:
        f.shutdown()
