"""The port's cluster tier (deeplearning4j_torch/cluster/) against the JAX
package's: membership state sequences on a fake clock, placement plans
and retry-budget spends equal; the router's failover, hedging and
idempotency answers (status, body, Retry-After, which replica saw which
attempt, the counters) equal to the reference router's over the same
scripted stub replicas, one case per scenario of ``tests/test_cluster.py``;
and the contract between the two packages: the port's router in front of
one reference replica and one port replica (the ``/v1/replica`` beat is the
shared schema), two 2-layer d 32 CausalLMs with params carried across,
routed predicts within ``test_torch_fleet.py``'s f32 tolerance of the JAX
cluster's and greedy tokens equal, through a crash-kill of the primary.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from deeplearning4j_torch import cluster as tcluster
from deeplearning4j_torch import fleet as tfleet
from deeplearning4j_torch.chaos import faults as tfaults
from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.obs import flight as tflight
from deeplearning4j_torch.obs import reqtrace as treq
from deeplearning4j_torch.obs.metrics import MetricsRegistry as TMetrics
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu import cluster as jcluster
from deeplearning4j_tpu import fleet as jfleet
from deeplearning4j_tpu.chaos import faults as jfaults
from deeplearning4j_tpu.obs import flight as jflight
from deeplearning4j_tpu.obs import reqtrace as jreq
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JMetrics

FLEET_ATOL = 1e-5
WAIT_S = 30

KITS = {
    "jax": SimpleNamespace(cluster=jcluster, faults=jfaults, flight=jflight,
                           reqtrace=jreq, Metrics=JMetrics),
    "port": SimpleNamespace(cluster=tcluster, faults=tfaults, flight=tflight,
                            reqtrace=treq, Metrics=TMetrics),
}


def _both(script):
    """The script's observations with each package."""
    return script(KITS["jax"]), script(KITS["port"])


# ------------------------------------------------------------- membership
def _membership_script(kit):
    t = [0.0]
    m = kit.Metrics()
    mem = kit.cluster.Membership(suspect_after_s=2.0, dead_after_s=6.0,
                                 clock=lambda: t[0], metrics=m)
    out = []
    for r in ("a", "b", "c"):
        mem.add(r, f"http://h/{r}")
    steps = [(0.5, "miss", "b"), (1.0, "report", "a"), (2.5, "sweep", None),
             (3.0, "report", "b"), (4.0, "miss", "b"), (6.5, "sweep", None),
             (7.0, "report", "c"), (8.0, "sweep", None),
             (8.5, "remove", "a"), (9.0, "sweep", None)]
    for now, op, rid in steps:
        t[0] = now
        if op == "miss":
            mem.miss(rid)
        elif op == "report":
            mem.report(rid, {"queue_depth": int(now), "models": {}})
        elif op == "remove":
            mem.remove(rid)
        out.append((op, rid, mem.sweep() if op == "sweep" else None,
                    mem.routable(), mem.snapshot()))
    for bad in (lambda: mem.add("b", "u"), lambda: mem.remove("zz"),
                lambda: kit.cluster.Membership(suspect_after_s=5.0,
                                               dead_after_s=5.0)):
        try:
            bad()
        except (KeyError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    out.append(m.to_prometheus())
    return out


def test_membership_state_sequences_equal():
    want, got = _both(_membership_script)
    assert got == want


# -------------------------------------------------------------- placement
PLACEMENT_CASES = {
    "worst_fit": ({"big": 80, "mid": 50, "small": 10},
                  {"r1": {"hbm_budget_bytes": 100, "queue_depth": 0},
                   "r2": {"hbm_budget_bytes": 100, "queue_depth": 0}}),
    "oversized": ({"huge": 1000},
                  {"r1": {"hbm_budget_bytes": 100, "queue_depth": 0},
                   "r2": {"hbm_budget_bytes": 50, "queue_depth": 0}}),
    "tail_by_queue": ({"m": 10},
                      {"r1": {"hbm_budget_bytes": 100, "queue_depth": 9},
                       "r2": {"hbm_budget_bytes": 100, "queue_depth": 0},
                       "r3": {"hbm_budget_bytes": 100, "queue_depth": 4}}),
    "unbounded": ({"a": 60, "b": 60, "c": 5},
                  {"r1": {"hbm_budget_bytes": None, "queue_depth": 1},
                   "r2": {"hbm_budget_bytes": 100, "queue_depth": 0}}),
    "survivor": ({"a": 60, "b": 60},
                 {"r1": {"hbm_budget_bytes": 100, "queue_depth": 0}}),
    "empty": ({"m": 1}, {}),
}


@pytest.mark.parametrize("case", sorted(PLACEMENT_CASES))
def test_placement_plans_equal(case):
    models, replicas = PLACEMENT_CASES[case]

    def script(kit):
        m = kit.Metrics()
        plan = kit.cluster.Placement(metrics=m).plan(models, replicas)
        return plan, {n: kit.cluster.Placement.primary(plan, n)
                      for n in models}, m.to_prometheus()

    want, got = _both(script)
    assert got == want


# ----------------------------------------------------------- retry budget
def _budget_script(kit):
    m = kit.Metrics()
    b = kit.cluster.RetryBudget(ratio=0.5, cap=2.0, metrics=m)
    out = [b.spend(), b.spend(), b.spend()]
    for _ in range(3):
        b.deposit()
        out.append((b.spend(), b.snapshot()))
    for _ in range(100):
        b.deposit()
    out.append(b.snapshot())
    for ratio, cap in ((0.0, 10.0), (0.1, 0.5)):
        try:
            kit.cluster.RetryBudget(ratio=ratio, cap=cap)
        except ValueError as e:
            out.append(str(e))
    out.append(m.to_prometheus())
    return out


def test_retry_budget_spends_equal():
    want, got = _both(_budget_script)
    assert got == want


# ------------------------------------------------------------ router rigs
def _stub_replica(rid, respond, weight_bytes=100, budget=1000):
    """A replica-shaped scripted server: the heartbeat a FleetServer gives,
    model POSTs answered by ``respond(verb) -> (status, payload,
    delay_s)``. Returns (server, base_url, hits)."""
    hits = []

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/replica":
                self._send(200, {
                    "replica": rid, "accepting": True, "ready": True,
                    "models": {"m": {"resident": False,
                                     "weight_bytes": weight_bytes}},
                    "hbm_budget_bytes": budget, "resident_bytes": 0,
                    "queue_depth": 0})
            else:
                self._send(404, {"error": "unknown"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            self.rfile.read(n)
            verb = self.path.split("?", 1)[0].rsplit("/", 1)[-1]
            hits.append(verb)
            status, payload, delay = respond(verb)
            if delay:
                time.sleep(delay)
            try:
                self._send(status, payload)
            except (BrokenPipeError, ConnectionResetError):
                pass                             # cancelled hedge loser

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, args=(0.05,),
                     daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", hits


def _ok(rid):
    return lambda verb: (200, {"output": [[1.0]], "served_by": rid,
                               "tokens": [1, 2]}, 0)


def _sick(verb):
    return 500, {"error": "boom", "cause": "internal"}, 0


class _Rig:
    """One package's router over scripted stubs rA (budget 2000: primary)
    and rB, heartbeats driven by hand."""

    def __init__(self, kit, respond_a, respond_b, **router_kw):
        self.kit = kit
        self.metrics = kit.Metrics()
        kw = dict(port=0, heartbeat_s=60.0, hedge_ms=None,
                  metrics=self.metrics, jitter_rng=random.Random(0))
        kw.update(router_kw)
        self.router = kit.cluster.ClusterRouter(**kw)
        self.stubs = {}
        for rid, respond, budget in (("rA", respond_a, 2000),
                                     ("rB", respond_b, 1000)):
            srv, url, hits = _stub_replica(rid, respond, budget=budget)
            self.stubs[rid] = (srv, hits)
            self.router.add_replica(rid, url)
        self.router.start()
        self.router.poll_once()

    def hits(self):
        return {rid: list(h) for rid, (_, h) in sorted(self.stubs.items())}

    def kill(self, rid):
        srv, _ = self.stubs[rid]
        srv.shutdown()
        srv.server_close()

    def post(self, path, body, tenant="t"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.router.port}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "X-Tenant": tenant})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, json.loads(r.read()), None
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers.get("Retry-After")

    def counters(self, *names):
        time.sleep(0.05)  # the router counts a request after its reply
        snap = self.metrics.snapshot()
        return {n: sorted((tuple(sorted(s["labels"].items())), s["value"])
                          for s in snap.get(n, {}).get("series", []))
                for n in names}

    def close(self):
        self.router.stop()
        for srv, _ in self.stubs.values():
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass


_COUNTERS = ("cluster_failover_total", "cluster_hedges_total",
             "cluster_retry_budget_spend_total", "cluster_requests_total",
             "serve_http_errors_total")
PREDICT = "/v1/models/m/predict"
GENERATE = "/v1/models/m/generate?stream=false"


def _connect_failure(kit):
    rig = _Rig(kit, _ok("rA"), _ok("rB"))
    try:
        out = [rig.router.candidates("m")]
        rig.kill("rA")
        out.append(rig.post(PREDICT, {"ndarray": []}))
        out.append(rig.router.membership.state("rA"))
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _status_5xx(kit):
    rig = _Rig(kit, _sick, _ok("rB"))
    try:
        out = [rig.post(PREDICT, {"ndarray": []}),
               rig.router.membership.state("rA")]
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _no_failover_4xx(kit):
    answers = {"rA": (404, {"error": "unknown model",
                            "cause": "unknown_model"}),
               "quota": (429, {"error": "over quota", "cause": "quota"})}
    state = {"mode": "rA"}
    rig = _Rig(kit, lambda verb: answers[state["mode"]] + (0,), _ok("rB"))
    try:
        out = []
        for mode in ("rA", "quota"):
            state["mode"] = mode
            out.append(rig.post(PREDICT, {"ndarray": []}))
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _generate_pre_admission(kit):
    state = {"cause": "queue_full", "code": 503}
    rig = _Rig(kit, lambda verb: (state["code"], {"error": "x",
                                                  "cause": state["cause"]},
                                  0), _ok("rB"))
    try:
        out = [rig.post(GENERATE, {"prompt": [1]})]
        state.update(cause="internal", code=500)
        out.append(rig.post(GENERATE, {"prompt": [1]}))
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _budget_caps_reroutes(kit):
    rig = _Rig(kit, _sick, _sick, retry_budget_cap=1.0,
               retry_budget_ratio=1e-6)
    try:
        out = [rig.post(PREDICT, {"ndarray": []}),
               rig.post(PREDICT, {"ndarray": []})]
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _tenant_bucket_global(kit):
    rig = _Rig(kit, _ok("rA"), _ok("rB"))
    rig.router.tenants.register("capped", rate_per_s=0.001, burst=2.0)
    try:
        out = [rig.post(PREDICT, {"ndarray": []}, tenant="capped")
               for _ in range(3)]
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _gold_hedge(kit):
    flight = kit.flight.FlightRecorder()
    kit.reqtrace.install(kit.reqtrace.RequestTracer(flight=flight))
    rig = _Rig(kit, lambda verb: (200, {"served_by": "rA"}, 0.8),
               _ok("rB"), hedge_ms=40.0)
    rig.router.tenants.register("vip", rate_per_s=100.0, slo="gold")
    try:
        t0 = time.monotonic()
        out = [rig.post(PREDICT, {"ndarray": []}, tenant="vip"),
               time.monotonic() - t0 < 0.7]
        # the router files the request's record after its reply: wait for it
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not any(
                r["kind"] == "route:predict" for r in flight.requests()):
            time.sleep(0.01)
        rec = next(r for r in flight.requests()
                   if r["kind"] == "route:predict")
        attempts = sorted((a["args"]["replica"], a["args"]["hedge"])
                          for a in rec["stages"] if a["name"] == "attempt")
        return out + [attempts, rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        rig.close()
        kit.reqtrace.uninstall()


def _standard_never_hedges(kit):
    rig = _Rig(kit, lambda verb: (200, {"served_by": "rA"}, 0.2),
               _ok("rB"), hedge_ms=40.0)
    try:
        return [rig.post(PREDICT, {"ndarray": []}), rig.hits(),
                rig.counters(*_COUNTERS)]
    finally:
        rig.close()


def _scoped_partition(kit):
    rig = _Rig(kit, _ok("rA"), _ok("rB"))
    plane = kit.faults.install(kit.faults.FaultPlane(seed=0))
    try:
        plane.inject_spec(
            "cluster.transport:error:type=connection,scope=rA,times=-1")
        out = [rig.post(PREDICT, {"ndarray": []}), rig.router.poll_once()]
        kit.faults.uninstall()
        rig.router.poll_once()
        out.append(rig.router.membership.state("rA"))
        return out + [rig.hits(), rig.counters(*_COUNTERS)]
    finally:
        kit.faults.uninstall()
        rig.close()


def _cluster_view(kit):
    rig = _Rig(kit, _ok("rA"), _ok("rB"))
    try:
        out = []
        for path in ("/v1/cluster", "/v1/tsdb", "/v1/alerts", "/ready",
                     "/nowhere"):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rig.router.port}{path}",
                        timeout=WAIT_S) as r:
                    body = json.loads(r.read())
                    out.append((r.status, body))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
        view = out[0][1]
        for rep in view["membership"].values():
            rep.pop("base_url")
            rep.pop("lease_age_s")
        return out
    finally:
        rig.close()


ROUTER_SCENARIOS = {
    "predict_connect_failure": _connect_failure,
    "predict_5xx": _status_5xx,
    "4xx_and_quota_never_fail_over": _no_failover_4xx,
    "generate_pre_admission_only": _generate_pre_admission,
    "retry_budget_caps_reroutes": _budget_caps_reroutes,
    "tenant_bucket_is_global": _tenant_bucket_global,
    "gold_hedge_first_response_wins": _gold_hedge,
    "standard_never_hedges": _standard_never_hedges,
    "scoped_transport_partition": _scoped_partition,
    "cluster_view_and_telemetry_404": _cluster_view,
}


@pytest.mark.parametrize("scenario", sorted(ROUTER_SCENARIOS))
def test_router_answers_equal(scenario):
    want, got = _both(ROUTER_SCENARIOS[scenario])
    assert got == want


def test_router_scenario_shapes():
    """The reference's own properties, read off the port's observations."""
    got = _connect_failure(KITS["port"])
    assert got[1][0] == 200 and got[1][1]["served_by"] == "rB"
    assert got[2] == "suspect"
    gen = _generate_pre_admission(KITS["port"])
    assert gen[0][0] == 200 and gen[1][0] == 500
    assert gen[2] == {"rA": ["generate", "generate"], "rB": ["generate"]}
    hedge = _gold_hedge(KITS["port"])
    assert hedge[0][1]["served_by"] == "rB" and hedge[1]
    assert hedge[2] == [("rA", False), ("rB", True)]
    view = _cluster_view(KITS["port"])
    assert [c for c, _ in view] == [200, 404, 404, 200, 404]
    assert view[1][1] == {"error": "telemetry plane not attached"}


# -------------------------------------------- mixed cluster: the contract
NAMES = ("alpha", "beta")
ENGINE_OPTS = {"batch_buckets": (1, 2, 4), "queue_limit": 64}
GEN_OPTS = {"slots": 2, "capacity": 32, "seed": 0}
PROMPTS = np.random.RandomState(0).randint(0, 50, (3, 1, 16)).astype(
    np.int32)
GEN_PROMPT = [3, 1, 4, 1, 5]


def _lms():
    from deeplearning4j_tpu.models import CausalLM as JCausalLM

    out = {}
    for seed, name in enumerate(NAMES):
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


def _replica(side, rid, lms):
    if side == "jax":
        f = jfleet.FleetRegistry()
    else:
        f = tfleet.FleetRegistry(device="cpu")
    for name in NAMES:
        f.add(name, lms[name][0 if side == "jax" else 1],
              input_dtype=np.int32, engine_opts=ENGINE_OPTS,
              gen_opts=GEN_OPTS if name == "beta" else None)
    kit = jcluster if side == "jax" else tcluster
    return kit.spawn_replica(rid, f)


def _post(port, path, body, tenant="std"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-Tenant": tenant})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _drill(router_kit, sides, lms):
    """Routed predicts and generates, a crash-kill of alpha's primary, then
    the same traffic again on the survivor. Returns the answers and the
    replica that was killed."""
    handles = {f"r{i}": _replica(side, f"r{i}", lms)
               for i, side in enumerate(sides)}
    # a clock that stands still: the kill is seen through the failed hop
    # (suspect), never through a lease that ran out while the drill ran
    router = router_kit.ClusterRouter(port=0, heartbeat_s=3600.0,
                                      hedge_ms=None, clock=lambda: 0.0,
                                      jitter_rng=random.Random(0))
    for rid, h in handles.items():
        router.add_replica(rid, h.base_url)
    router.start()
    out = []
    try:
        router.poll_once()

        def traffic():
            for name in NAMES:
                for j in range(len(PROMPTS)):
                    out.append(("predict", name, j) + _post(
                        router.port, f"/v1/models/{name}/predict",
                        {"ndarray": PROMPTS[j].tolist()}))
            out.append(("generate",) + _post(
                router.port, "/v1/models/beta/generate?stream=false",
                {"prompt": GEN_PROMPT, "max_new_tokens": 6,
                 "temperature": 0.0}))

        traffic()
        victim = router.candidates("alpha")[0]
        handles[victim].kill()
        traffic()
        router.poll_once()
        states = router.membership.sweep()
        return out, victim, states, handles
    finally:
        router.stop()
        for h in handles.values():
            h.kill()


def test_mixed_cluster_matches_the_jax_cluster():
    lms = _lms()
    want, _, _, _ = _drill(jcluster, ("jax", "jax"), lms)
    got, victim, states, handles = _drill(tcluster, ("jax", "port"), lms)
    assert states[victim] == "suspect"
    assert len(got) == len(want)
    served = set()
    for g, w in zip(got, want):
        assert g[:-2] == w[:-2]
        code, body = g[-2:]
        assert w[-2] == 200
        if code != 200:
            # the kill window: a typed refusal, never a raw 500
            assert code != 500 and "cause" in body, g
            continue
        if g[0] == "predict":
            served.add(g[1])
            np.testing.assert_allclose(np.asarray(body["output"]),
                                       np.asarray(w[-1]["output"]),
                                       atol=FLEET_ATOL, rtol=0)
        else:
            assert body["tokens"] == w[-1]["tokens"]
    assert served == set(NAMES)
    # both kinds of replica answered: the killed one before the kill, the
    # survivor after it
    kinds = {type(h.server).__module__.split(".")[0]
             for h in handles.values()}
    assert kinds == {"deeplearning4j_tpu", "deeplearning4j_torch"}


def test_replica_handle_kill_and_stop():
    lms = _lms()
    h = _replica("port", "r0", lms)
    assert h.alive() and h.base_url.startswith("http://127.0.0.1:")
    code, body = _post(int(h.base_url.rsplit(":", 1)[1]),
                       "/v1/models/alpha/predict",
                       {"ndarray": PROMPTS[0].tolist()})
    assert code == 200
    h.kill()
    assert not h.alive()
    with pytest.raises(OSError):
        _post(int(h.base_url.rsplit(":", 1)[1]), "/v1/models/alpha/predict",
              {"ndarray": PROMPTS[0].tolist()})
    h.kill()                                     # idempotent
    h2 = _replica("port", "r1", lms)
    h2.stop()
    assert not h2.alive()


def test_control_planes_import_no_jax():
    """The port's cluster, sim, autoscale and recovery modules load
    nothing of JAX, optax or the JAX package."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import deeplearning4j_torch.cluster, deeplearning4j_torch.sim\n"
            "import deeplearning4j_torch.autoscale\n"
            "import deeplearning4j_torch.chaos.recovery\n"
            "import deeplearning4j_torch.train.faults\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'deeplearning4j_tpu'))\n"
            "sys.exit(str(bad) if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
