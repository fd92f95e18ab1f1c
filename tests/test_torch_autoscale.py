"""The port's autoscaler (deeplearning4j_torch/autoscale/) against the JAX
package's: ``AutoscalePolicy`` decisions over scripted sample sequences
(sustain windows, cooldowns armed only on commit, hysteresis, clamps, the
below-min repair, the forecast hook) byte-equal as canonical JSON; the
controller's ``decision_log_bytes()`` with a fake router and factory equal
(spawn, chaos-failed spawn, reap of a dead replica, scale-in), also from
two fresh interpreters; and a real 2 -> 3 -> 2 cycle of tiny port replicas
behind the port's router on the CPU, scale-out on sustained gold burn and a
drain-first scale-in with generates in flight, every answer correct.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_torch import autoscale as tas
from deeplearning4j_torch.chaos import faults as tfaults
from deeplearning4j_torch.cluster import membership as tmem
from deeplearning4j_torch.obs import metrics as tmetrics
from deeplearning4j_torch.obs import slo as tslo
from deeplearning4j_tpu import autoscale as jas
from deeplearning4j_tpu.chaos import faults as jfaults
from deeplearning4j_tpu.cluster import membership as jmem
from deeplearning4j_tpu.obs import metrics as jmetrics
from deeplearning4j_tpu.obs import slo as jslo

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KITS = {
    "jax": SimpleNamespace(autoscale=jas, faults=jfaults, membership=jmem,
                           Metrics=jmetrics.MetricsRegistry,
                           SloBurn=jslo.SloBurn),
    "port": SimpleNamespace(autoscale=tas, faults=tfaults, membership=tmem,
                            Metrics=tmetrics.MetricsRegistry,
                            SloBurn=tslo.SloBurn),
}


def _both(script):
    return script(KITS["jax"]), script(KITS["port"])


# ------------------------------------------------------------------ policy
class _FakeSlo:
    def __init__(self):
        self.burn = {}

    def snapshot(self):
        return {m: {c: {"good": 0, "bad": 0, "target": 0.999,
                        "burn": {"1m": v, "10m": v}}
                    for c, v in d.items()}
                for m, d in self.burn.items()}


class _FakeMembership:
    def __init__(self):
        self.payloads = {"r0": {"queue_depth": 0, "kv_utilization": 0.0}}

    def ids(self):
        return sorted(self.payloads)

    def state(self, rid):
        return "alive"

    def payload(self, rid):
        return self.payloads[rid]


class _Forecast:
    def __init__(self, value, confidence, horizon_s=30.0):
        self.value, self.confidence, self.horizon_s = (value, confidence,
                                                       horizon_s)


# (t, current, gold burn, queue depth, forecast or None, commit?)
POLICY_SCRIPTS = {
    "spike_then_steady": [(0, 1, 8.0, 0, None, False),
                          (1, 1, 0.0, 0, None, False)],
    "sustained_burn_cooldown": [(0, 1, 5.0, 0, None, False),
                                (1, 1, 5.0, 0, None, False),
                                (2, 1, 5.0, 0, None, False),
                                (3, 1, 5.0, 0, None, True),
                                (4, 2, 5.0, 0, None, False),
                                (13.5, 2, 5.0, 0, None, False)],
    "queue_watermark": [(t, 1, 0.0, 20, None, False) for t in range(3)],
    "hysteresis_never_flaps": [(i, 2, 1.5 if i % 2 == 0 else 0.5, 0, None,
                                False) for i in range(30)],
    "deep_idle_scale_in": ([(t, 3, 0.8, 0, None, False) for t in range(6)]
                           + [(t, 3, 0.1, 0, None, t == 9)
                              for t in range(6, 14)]),
    "clamps": ([(t, 4, 5.0, 0, None, False) for t in range(3)]
               + [(t, 1, 0.0, 0, None, False) for t in range(3, 9)]),
    "below_min_repair": [(0, 1, 0.0, 0, None, True),
                         (0.5, 0, 0.0, 0, None, False)],
    "forecast_hook": [(0, 1, 0.2, 0, _Forecast(1.5, 0.9), False),
                      (1, 1, 0.2, 0, _Forecast(1.5, 0.2), False),
                      (2, 1, 0.2, 0, _Forecast(0.5, 0.9), True),
                      (3, 2, 0.2, 0, _Forecast(2.0, 0.9), False),
                      (4, 4, 0.2, 0, _Forecast(2.0, 0.9), False)],
}


def _policy_script(steps):
    def run(kit):
        t = [0.0]
        slo, mem = _FakeSlo(), _FakeMembership()
        signals = kit.autoscale.SignalReader(slo=slo, membership=mem,
                                             clock=lambda: t[0])
        policy = kit.autoscale.AutoscalePolicy(
            min_replicas=1, max_replicas=4, sustain_out_s=2.0,
            sustain_in_s=4.0, cooldown_out_s=10.0, cooldown_in_s=10.0,
            queue_high=8.0)
        out = []
        for now, current, gold, queue, fc, commit in steps:
            t[0] = float(now)
            slo.burn = {"m": {"gold": gold}}
            mem.payloads["r0"]["queue_depth"] = queue
            signals.sample()
            d = policy.decide(signals, current, t[0],
                              forecast=None if fc is None else {"gold": fc})
            if commit:
                policy.commit(d, t[0])
            out.append(d.to_json())
        out.append(json.dumps(policy.snapshot(), sort_keys=True))
        out.append([tuple(s) for s in signals.window()])
        return out
    return run


@pytest.mark.parametrize("script", sorted(POLICY_SCRIPTS))
def test_policy_decisions_equal(script):
    want, got = _both(_policy_script(POLICY_SCRIPTS[script]))
    assert got == want


def test_policy_config_and_errors_equal():
    def run(kit):
        P = kit.autoscale.AutoscalePolicy
        out = [json.dumps(P.from_config(
            {"autoscale": {"max_replicas": 7, "unknown": 1,
                           "forecast_confidence": 0.8},
             "engine": {"queue_limit": 8}}, min_replicas=2).snapshot(),
            sort_keys=True),
            json.dumps(P.from_config(None).snapshot(), sort_keys=True)]
        for kw in ({"min_replicas": 0}, {"min_replicas": 3,
                                         "max_replicas": 2},
                   {"hysteresis": 1.5}, {"queue_low": 5.0,
                                         "queue_high": 1.0},
                   {"step_out": 0}, {"cooldown_in_s": -1.0},
                   {"forecast_confidence": 2.0}, {"burn_out": {}}):
            try:
                P(**kw)
            except ValueError as e:
                out.append(str(e))
        sig = kit.autoscale.StepTimeSignalReader(budget_s=0.5,
                                                 clock=lambda: 3.0)
        out.append(tuple(sig.observe(0.75, alive=2)))
        out.append(kit.autoscale.ScaleDecision(
            "out", 1, "burn", {"b": 2.0, "a": 1}).to_json())
        return out

    want, got = _both(run)
    assert got == want


# ------------------------------------------------------ controller (fakes)
_CONTROLLER_DRIVER = r"""
import random, sys
mods = {"jax": "deeplearning4j_tpu", "port": "deeplearning4j_torch"}
root = mods[sys.argv[1]]
import importlib
auto = importlib.import_module(root + ".autoscale")
faults = importlib.import_module(root + ".chaos.faults")
Membership = importlib.import_module(root + ".cluster.membership").Membership
MetricsRegistry = importlib.import_module(root + ".obs.metrics").MetricsRegistry
SloBurn = importlib.import_module(root + ".obs.slo").SloBurn

t = [0.0]
clock = lambda: t[0]
metrics = MetricsRegistry()
mem = Membership(clock=clock, metrics=metrics)
slo = SloBurn(metrics, clock=clock)
reps = {}

class Rep:
    def __init__(s, rid):
        s.replica_id, s.base_url, s.fleet = rid, "http://127.0.0.1:9", None
        s.down = False
        s.queue_depth = 0
    def alive(s): return not s.down
    def stop(s): s.down = True
    def kill(s): s.down = True

class Router:
    def __init__(s):
        s.metrics, s.membership, s.slo = metrics, mem, slo
        s.autoscaler = None
    def add_replica(s, rid, url): mem.add(rid, url)
    def remove_replica(s, rid): mem.remove(rid)
    def poll_once(s):
        for rid in mem.ids():
            r = reps.get(rid)
            if r is not None and r.alive():
                mem.report(rid, {"queue_depth": r.queue_depth,
                                 "kv_utilization": 0.0, "models": {}})
            else:
                mem.miss(rid)
        return mem.sweep()

def factory(rid):
    reps[rid] = Rep(rid)
    return reps[rid]

router = Router()
policy = auto.AutoscalePolicy(min_replicas=1, max_replicas=3,
                              sustain_out_s=2.0, sustain_in_s=4.0,
                              cooldown_out_s=5.0, cooldown_in_s=5.0)
ctl = auto.AutoscaleController(router, factory, policy=policy, clock=clock,
                               sleep=lambda s: None)
factory("seed-0")
router.add_replica("seed-0", reps["seed-0"].base_url)
ctl.adopt("seed-0", reps["seed-0"])
plane = faults.install(faults.FaultPlane(seed=0))
plane.inject_spec("autoscale.spawn:error:type=runtime,times=1")
rng = random.Random(int(sys.argv[2]))
for i in range(48):
    # a minute skipped after tick 30: the hot records leave the 1m window
    t[0] = float(i) + (60.0 if i >= 30 else 0.0)
    hot = 5 <= i < 20
    for _ in range(20):
        slo.record("m", "gold", good=not (hot and rng.random() < 0.5))
    if i == 24 and "as-1" in reps:
        reps["as-1"].kill()
    ctl.tick()
faults.uninstall()
sys.stdout.buffer.write(ctl.decision_log_bytes())
sys.stdout.buffer.write(repr(ctl.replica_stats()).encode())
"""


def test_decision_log_bytes_equal():
    """The same trace, seed and fake clock through each package's
    controller (a chaos-failed spawn, scale-outs, a replica killed and
    reaped, scale-ins) give byte-identical decision logs, from fresh
    interpreters under different PYTHONHASHSEEDs."""
    outs = []
    for side, hashseed in (("jax", "0"), ("port", "4242"), ("port", "0")):
        env = dict(os.environ, PYTHONHASHSEED=hashseed, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", _CONTROLLER_DRIVER, side,
                            "7"], cwd=_REPO, env=env, capture_output=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr.decode()
        outs.append(r.stdout)
    assert outs[0] and outs[1] == outs[0] and outs[2] == outs[0]
    log = outs[0].decode().rsplit("\n", 1)[0]
    lines = [json.loads(ln) for ln in log.splitlines()]
    directions = [ln["decision"]["direction"] for ln in lines]
    assert "out" in directions and "in" in directions
    assert any(ln["retired"] for ln in lines)


# ------------------------------------------- a real cycle of port replicas
def _post(port, path, body, tenant=None):
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_real_cycle_two_three_two():
    """Two tiny CausalLM replicas under a floor of two: a transport
    partition of both makes gold burn, the controller spawns a third
    (a chaos-failed first attempt retried), which serves gold through the
    partition bit-equal to the reference answer; healed and idle, the
    controller drains one replica with generates in flight (every token
    equal, nothing dropped) and retires it: 2 -> 3 -> 2."""
    from deeplearning4j_torch.cluster import ClusterRouter, spawn_replica
    from deeplearning4j_torch.fleet import FleetRegistry
    from deeplearning4j_torch.models import CausalLM

    skew = [0.0]

    def clock():
        import time
        return time.monotonic() + skew[0]

    handles = {}

    def factory(rid):
        m = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                     num_heads=4, vocab=50, device="cpu").build()
        m.init(seed=0)
        f = FleetRegistry(device="cpu")
        f.add("g", m, input_dtype=np.int32,
              engine_opts={"batch_buckets": (1, 2)},
              gen_opts={"slots": 2, "capacity": 24, "seed": 0})
        handles[rid] = spawn_replica(rid, f)
        return handles[rid]

    router = ClusterRouter(port=0, heartbeat_s=3600.0, hedge_ms=None,
                           suspect_after_s=2.0, dead_after_s=45.0,
                           clock=clock)
    router.tenants.register("vip", rate_per_s=1000.0, slo="gold")
    router.tenants.register("std", rate_per_s=1000.0, slo="standard")
    ctl = tas.AutoscaleController(
        router, factory, clock=clock, beat_wait_s=2.0,
        policy=tas.AutoscalePolicy(min_replicas=2, max_replicas=3,
                                   sustain_out_s=1.5, sustain_in_s=2.0,
                                   cooldown_out_s=4.0, cooldown_in_s=4.0,
                                   queue_high=1e9, queue_low=10.0))
    for rid in ("r1", "r2"):
        router.add_replica(rid, factory(rid).base_url)
        ctl.adopt(rid, handles[rid])
    router.start()
    x = list(range(16))
    gen = {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 6,
           "temperature": 0.0, "stream": False}
    plane = None
    try:
        router.poll_once()
        code, ref = _post(router.port, "/v1/models/g/predict",
                          {"ndarray": x}, tenant="vip")
        assert code == 200
        code, ref_gen = _post(router.port,
                              "/v1/models/g/generate?stream=false", gen,
                              tenant="std")
        assert code == 200 and ref_gen["tokens"]
        plane = tfaults.install(tfaults.FaultPlane(seed=0))
        for rid in ("r1", "r2"):
            plane.inject_spec(f"cluster.transport:error:type=connection,"
                              f"scope={rid},times=-1")
        plane.inject_spec("autoscale.spawn:error:type=runtime,times=1")
        for _ in range(6):
            if ctl.replica_stats()["final"] >= 3:
                break
            for _ in range(3):
                code, body = _post(router.port, "/v1/models/g/predict",
                                   {"ndarray": x}, tenant="vip")
                assert code in (502, 503) and body["cause"] in (
                    "upstream_unreachable", "no_replica"), (code, body)
            skew[0] += 1.0
            ctl.tick()
        assert ctl.replica_stats()["final"] == 3
        # the failed attempt consumed no id: the retry is as-0
        assert sorted(handles) == ["as-0", "r1", "r2"]
        code, out = _post(router.port, "/v1/models/g/predict",
                          {"ndarray": x}, tenant="vip")
        assert code == 200 and out["output"] == ref["output"]
        tfaults.uninstall()
        skew[0] += 61.0
        router.poll_once()
        results, errors = [], []

        def fire():
            try:
                results.append(_post(router.port,
                                     "/v1/models/g/generate?stream=false",
                                     gen, tenant="std"))
            except Exception as e:  # any failure fails the test below
                errors.append(e)

        for _ in range(6):
            if ctl.replica_stats()["final"] <= 2:
                break
            threads = [threading.Thread(target=fire) for _ in range(3)]
            for th in threads:
                th.start()
            skew[0] += 1.0
            ctl.tick()
            for th in threads:
                th.join(timeout=60)
                assert not th.is_alive()
        stats = ctl.replica_stats()  # min counts the adoption of r1 alone
        assert (stats["max"], stats["final"]) == (3, 2)
        assert not errors and results
        assert all(c == 200 and b["tokens"] == ref_gen["tokens"]
                   for c, b in results)
        log = [json.loads(ln) for ln in
               ctl.decision_log_bytes().decode().splitlines()]
        reasons = [(ln["decision"]["direction"], ln["decision"]["reason"])
                   for ln in log]
        assert ("out", "burn") in reasons and ("in", "idle") in reasons
        assert router.metrics.counter("autoscale_spawn_failures_total"
                                      ).value == 1
        assert router.metrics.counter("autoscale_drains_total",
                                      {"outcome": "ok"}).value >= 1
    finally:
        if plane is not None:
            tfaults.uninstall()
        ctl.stop()
        router.stop()
        for h in handles.values():
            h.kill()
