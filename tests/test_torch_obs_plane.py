"""The port's cluster telemetry plane (deeplearning4j_torch/obs/{tsdb,
alerts,scrape,forecast,promcheck}.py) against the JAX package's.

Both sides are stdlib code, so each scenario runs through the two
packages on the same injected clock and the same snapshots, and its
observations must be equal: ``query``, ``latest``, ``stats``, alert
``snapshot``/``firings``/transitions, ``Forecast`` tuples and policy
decisions, the registries' exposition text, compared as canonical JSON
(byte for byte). One scenario per case of ``tests/test_telemetry.py``
(store, alert sustain, SLO forget, forecaster, the policy's forecast
branch, the sim scorer's alert penalty, tuned rule overlays, decision-log
ingest), the step-telemetry cases of ``tests/test_obs.py`` that need no
trainer, ``promcheck``'s findings on a corpus of good and broken
expositions (and its CLI), a federated scrape of two scripted replicas
through the router's transport (healthy, partitioned, healed), and the
router's ``/v1/tsdb`` and ``/v1/alerts`` answers over HTTP.
"""

import importlib
import json
import math
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from deeplearning4j_torch import autoscale as tautoscale
from deeplearning4j_torch import cluster as tcluster
from deeplearning4j_torch.obs import alerts as talerts
from deeplearning4j_torch.obs import forecast as tforecast
from deeplearning4j_torch.obs import metrics as tmetrics
from deeplearning4j_torch.obs import promcheck as tpromcheck
from deeplearning4j_torch.obs import scrape as tscrape
from deeplearning4j_torch.obs import slo as tslo
from deeplearning4j_torch.obs import step as tstep
from deeplearning4j_torch.obs import tsdb as ttsdb
from deeplearning4j_tpu import autoscale as jautoscale
from deeplearning4j_tpu import cluster as jcluster
from deeplearning4j_tpu.obs import alerts as jalerts
from deeplearning4j_tpu.obs import forecast as jforecast
from deeplearning4j_tpu.obs import metrics as jmetrics
from deeplearning4j_tpu.obs import promcheck as jpromcheck
from deeplearning4j_tpu.obs import scrape as jscrape
from deeplearning4j_tpu.obs import slo as jslo
from deeplearning4j_tpu.obs import step as jstep
from deeplearning4j_tpu.obs import tsdb as jtsdb


# the sim packages export a ``score`` function under the module's name
tscore = importlib.import_module("deeplearning4j_torch.sim.score")
jscore = importlib.import_module("deeplearning4j_tpu.sim.score")


def _kit(tsdb, alerts, forecast, metrics, slo, scrape, promcheck, autoscale,
         score, step, cluster):
    return SimpleNamespace(
        Store=tsdb.TimeSeriesStore, AlertEngine=alerts.AlertEngine,
        AlertRule=alerts.AlertRule, ABSENCE=alerts.ABSENCE,
        RATE_OF_CHANGE=alerts.RATE_OF_CHANGE,
        default_rules=alerts.default_rules,
        rules_from_config=alerts.rules_from_config,
        BurnForecaster=forecast.BurnForecaster, Forecast=forecast.Forecast,
        Registry=metrics.MetricsRegistry, SloBurn=slo.SloBurn,
        Scraper=scrape.FederatedScraper, check_text=promcheck.check_text,
        Policy=autoscale.AutoscalePolicy, Signals=autoscale.SignalReader,
        OUT=autoscale.OUT, HOLD=autoscale.HOLD, Outcome=score.Outcome,
        score=score.score, summarize=score.summarize,
        StepTelemetry=step.StepTelemetry, cluster=cluster)


JAX = _kit(jtsdb, jalerts, jforecast, jmetrics, jslo, jscrape, jpromcheck,
           jautoscale, jscore, jstep, jcluster)
PORT = _kit(ttsdb, talerts, tforecast, tmetrics, tslo, tscrape, tpromcheck,
            tautoscale, tscore, tstep, tcluster)


def _canon(obj):
    return json.dumps(obj, sort_keys=True, default=repr)


def _both(scenario):
    """The scenario's observations with each package, as canonical JSON;
    the port's must equal the reference's byte for byte."""
    want, got = _canon(scenario(JAX)), _canon(scenario(PORT))
    assert got == want
    return json.loads(got)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _gauge(name, value, labels=None):
    return {name: {"type": "gauge", "help": "",
                   "series": [{"labels": labels or {}, "value": value}]}}


def _counter(name, value, labels=None):
    return {name: {"type": "counter", "help": "",
                   "series": [{"labels": labels or {}, "value": value}]}}


# ================================================================== tsdb
def _kinds_materialize(k):
    store = k.Store(clock=_Clock())
    snap = {
        "g": {"type": "gauge", "series": [{"labels": {}, "value": 2.5}]},
        "c": {"type": "counter", "series": [{"labels": {}, "value": 10.0}]},
        "h": {"type": "histogram",
              "series": [{"labels": {}, "count": 4, "sum": 1.0,
                          "quantiles": {"p50": 0.1, "p95": 0.2,
                                        "p99": 0.3}}]},
    }
    return [store.ingest("s", snap, now=1000.0), store.latest("g"),
            store.query("h", track="p99"), store.query("h"),
            store.families(), store.stats()]


def _counter_rate(k):
    store = k.Store(clock=_Clock())
    for t, v in ((0.0, 0.0), (10.0, 100.0), (20.0, 5.0), (30.0, 45.0)):
        store.ingest("s", _counter("c", v), now=t)
    return [store.query("c", rate=True), store.query("c")]


def _retention(k):
    store = k.Store(clock=_Clock(), retention_points=4, retention_s=25.0)
    for i in range(10):
        store.ingest("s", _gauge("g", float(i)), now=float(i * 10))
    return [store.query("g"), store.stats()]


def _soft_stale(k):
    store = k.Store(clock=_Clock())
    store.ingest("s", _gauge("g", 1.0), now=0.0)
    store.mark_stale("s", now=1.0)
    out = [store.latest("g"), store.query("g"),
           store.query("g", include_stale=True)]
    store.ingest("s", _gauge("g", 2.0), now=2.0)
    return out + [store.latest("g"), store.sources()]


def _tombstone(k):
    reg = k.Registry()
    store = k.Store(clock=_Clock())
    reg.gauge("cluster_replica_state", {"replica": "r9"}).set(2.0)
    store.ingest("router", reg.snapshot(), now=0.0)
    out = [store.latest("cluster_replica_state")]
    out.append(reg.remove_series("cluster_replica_state", {"replica": "r9"}))
    reg.gauge("other", {}).set(1.0)
    store.ingest("router", reg.snapshot(), now=10.0)
    out += [store.latest("cluster_replica_state"),
            store.query("cluster_replica_state"), store.stats()]
    reg.gauge("cluster_replica_state", {"replica": "r9"}).set(2.0)
    store.ingest("router", reg.snapshot(), now=20.0)
    return out + [store.latest("cluster_replica_state"),
                  store.query("cluster_replica_state", include_stale=True)]


def _tombstone_alert(k):
    reg = k.Registry()
    clock = _Clock(0.0)
    store = k.Store(clock=clock)
    engine = k.AlertEngine(store, clock=clock, rules=(
        k.AlertRule("replica_dead", "cluster_replica_state", op=">",
                    value=1.5, for_s=0.0),))
    out = []
    reg.gauge("cluster_replica_state", {"replica": "r9"}).set(2.0)
    store.ingest("router", reg.snapshot(), now=0.0)
    out += [engine.evaluate(now=0.0), engine.active()]
    reg.remove_series("cluster_replica_state", {"replica": "r9"})
    reg.gauge("other", {}).set(1.0)
    store.ingest("router", reg.snapshot(), now=5.0)
    out += [engine.evaluate(now=5.0), engine.active()]
    reg.gauge("cluster_replica_state", {"replica": "r9"}).set(2.0)
    store.ingest("router", reg.snapshot(), now=10.0)
    return out + [engine.evaluate(now=10.0), engine.active(),
                  engine.snapshot(), engine.firings()]


def _extra_labels(k):
    store = k.Store(clock=_Clock())
    store.ingest("r1", _gauge("g", 1.0, {"replica": "own"}), now=0.0,
                 extra_labels={"replica": "r1", "zone": "a"})
    return store.latest("g")


def _query_ranges(k):
    """Label filters, t_min/t_max and the labels of a range query."""
    store = k.Store(clock=_Clock())
    for t in range(6):
        store.ingest("s", {"m": {"type": "gauge", "series": [
            {"labels": {"r": "a"}, "value": float(t)},
            {"labels": {"r": "b"}, "value": float(2 * t)}]}}, now=float(t))
    return [store.query("m", labels={"r": "b"}),
            store.query("m", t_min=2.0, t_max=4.0),
            store.latest("m", labels={"r": "a"}), store.query("nope")]


# ================================================================ alerts
HOT = dict(name="hot", metric="m", op=">", value=1.0, for_s=20.0)


def _sustain_rig(k, metrics=None):
    clock = _Clock(0.0)
    store = k.Store(clock=clock)
    engine = k.AlertEngine(store, clock=clock, metrics=metrics,
                           rules=(k.AlertRule(**HOT),))
    return store, engine


def _observe(store, engine, t, value):
    store.ingest("s", _gauge("m", value), now=t)
    return engine.evaluate(now=t)


def _short_spike(k):
    reg = k.Registry()
    store, engine = _sustain_rig(k, reg)
    out = [_observe(store, engine, 0.0, 5.0), engine.snapshot(),
           _observe(store, engine, 10.0, 5.0), engine.active(),
           _observe(store, engine, 15.0, 0.5), engine.snapshot(),
           engine.firings()]
    return out + [reg.to_prometheus()]


def _fires_after_sustain(k):
    store, engine = _sustain_rig(k)
    out = [_observe(store, engine, t, 5.0) for t in (0.0, 19.9, 20.0)]
    return out + [engine.active(), engine.firings(), engine.snapshot()]


def _resolve_needs_clear(k):
    store, engine = _sustain_rig(k)
    out = [_observe(store, engine, t, 5.0)
           for t in (0.0, 25.0, 100.0, 1000.0, 10000.0)]
    out += [engine.active(), _observe(store, engine, 10010.0, 0.2),
            engine.firings(), engine.snapshot()]
    return out


def _rate_and_absence(k):
    clock = _Clock(0.0)
    store = k.Store(clock=clock)
    engine = k.AlertEngine(store, clock=clock, rules=(
        k.AlertRule("failing", "fails_total", kind=k.RATE_OF_CHANGE, op=">",
                    value=0.0, window_s=60.0, for_s=0.0),
        k.AlertRule("gone", "heartbeat", kind=k.ABSENCE, for_s=0.0)))
    out = [engine.evaluate(now=0.0), engine.active()]
    store.ingest("s", {**_counter("fails_total", 0.0),
                       **_gauge("heartbeat", 1.0)}, now=0.0)
    out += [engine.evaluate(now=0.0), engine.active()]
    store.ingest("s", {**_counter("fails_total", 3.0),
                       **_gauge("heartbeat", 1.0)}, now=30.0)
    return out + [engine.evaluate(now=30.0), engine.active(),
                  engine.snapshot()]


def _default_rules_gold_burn(k):
    """The shipped ruleset on a gold burn: pending, firing after its 20 s
    sustain, resolved once healed, with the engine's metrics."""
    reg = k.Registry()
    clock = _Clock(0.0)
    store = k.Store(clock=clock, metrics=reg)
    engine = k.AlertEngine(store, clock=clock, metrics=reg)
    lab = {"slo_class": "gold", "window": "1m"}
    out = []
    for t, v in ((0.0, 0.2), (5.0, 3.0), (15.0, 3.0), (25.0, 3.0),
                 (40.0, 0.5), (50.0, 0.5)):
        store.ingest("router", _gauge("fleet_slo_burn_rate", v, lab), now=t)
        out.append(engine.evaluate(now=t))
    return out + [engine.snapshot(), engine.firings(), reg.to_prometheus(),
                  [list(r) for r in k.default_rules()]]


def _notifier(k):
    """A stdout notifier receives every transition, in order."""
    import io

    buf = io.StringIO()
    clock = _Clock(0.0)
    store = k.Store(clock=clock)
    from importlib import import_module

    mod = import_module(k.AlertEngine.__module__)
    engine = k.AlertEngine(store, clock=clock,
                           rules=(k.AlertRule(**dict(HOT, for_s=0.0)),),
                           notifiers=[mod.StdoutNotifier(stream=buf)])
    _observe(store, engine, 0.0, 5.0)
    _observe(store, engine, 1.0, 0.1)
    return buf.getvalue()


# ============================================================ slo.forget
def _slo_forget(k):
    reg = k.Registry()
    clock = _Clock(0.0)
    burn = k.SloBurn(reg, clock=clock, key_label="replica")
    burn.record("r2", "gold", good=False)
    store = k.Store(clock=clock)
    store.ingest("router", reg.snapshot(), now=0.0)
    out = [store.latest("fleet_slo_burn_rate",
                        labels={"replica": "r2", "window": "1m"})]
    burn.forget("r2")
    out += [sorted(reg.snapshot()), burn.snapshot()]
    store.ingest("router", reg.snapshot(), now=10.0)
    return out + [store.latest("fleet_slo_burn_rate"), store.stats()]


# ============================================================== forecast
def _seasonal_store(k, day_s=240.0, step_s=4.0, days=3):
    store = k.Store(clock=_Clock(0.0), retention_points=10000,
                    retention_s=1e9)
    t = 0.0
    while t < days * day_s:
        store.ingest("s", _gauge("m", 1.0 + 0.8 * math.sin(
            2.0 * math.pi * t / day_s)), now=t)
        t += step_s
    return store


def _seasonal_forecast(k):
    store = _seasonal_store(k)
    fc = k.BurnForecaster(store, season_s=240.0, horizon_s=60.0)
    return [list(fc.forecast("m")), list(fc.forecast("m", horizon_s=30.0))]


def _short_series(k):
    reg = k.Registry()
    store = k.Store(clock=_Clock())
    for t in (0.0, 1.0, 2.0):
        store.ingest("s", _gauge("m", 1.0), now=t)
    fc = k.BurnForecaster(store, season_s=60.0, metrics=reg).forecast("m")
    return [fc, reg.snapshot()]


def _forecast_burn(k):
    reg = k.Registry()
    store = k.Store(clock=_Clock(0.0), retention_points=10000)
    for i in range(180):
        t = i * 4.0
        store.ingest("r", _gauge("fleet_slo_burn_rate",
                                 1.0 + 0.8 * math.sin(2 * math.pi * t / 240),
                                 {"slo_class": "gold", "window": "1m"}),
                     now=t)
    fc = k.BurnForecaster(store, season_s=240.0, horizon_s=30.0,
                          metrics=reg).forecast_burn("gold")
    return [list(fc), reg.to_prometheus()]


# ======================================================= policy forecast
class _FakeSlo:
    def snapshot(self):
        return {}


class _FakeMembership:
    def ids(self):
        return []

    def state(self, rid):
        raise KeyError(rid)

    def payload(self, rid):
        raise KeyError(rid)


def _policy(k):
    return k.Policy(min_replicas=1, max_replicas=4, burn_out={"gold": 1.0},
                    forecast_confidence=0.6)


def _signals(k):
    return k.Signals(slo=_FakeSlo(), membership=_FakeMembership(),
                     clock=_Clock(100.0))


def _decision(d):
    return [d.direction, d.amount, d.reason, d.evidence]


def _confident_breach(k):
    d = _policy(k).decide(_signals(k), 1, 100.0,
                          forecast={"gold": k.Forecast(30.0, 1.4, 0.9)})
    return _decision(d)


def _unconfident(k):
    return [_decision(_policy(k).decide(_signals(k), 1, 100.0,
                                        forecast={"gold": fc}))
            for fc in (k.Forecast(30.0, 1.4, 0.3),
                       k.Forecast(30.0, 0.8, 0.95), None)]


def _clamp_and_cooldown(k):
    policy = _policy(k)
    breach = {"gold": k.Forecast(30.0, 1.4, 0.9)}
    out = [_decision(policy.decide(_signals(k), 4, 100.0, forecast=breach))]
    d = policy.decide(_signals(k), 1, 100.0, forecast=breach)
    policy.commit(d, 100.0)
    return out + [_decision(d), _decision(policy.decide(
        _signals(k), 2, 105.0, forecast=breach))]


def _none_forecast(k):
    return [_decision(_policy(k).decide(_signals(k), 1, 100.0,
                                        forecast=None)),
            _decision(_policy(k).decide(_signals(k), 1, 100.0))]


# ============================================================= sim score
def _sim_penalty(k):
    outcomes = [k.Outcome(True, None, "standard", "m", "predict", 0.01,
                          None, None, 0) for _ in range(20)]
    quiet = k.summarize("fp", outcomes, mode="virtual")
    paged = k.summarize("fp", outcomes, mode="virtual", extra={"alerts": [
        {"rule": "gold_burn_high", "fired_at_s": 1.0,
         "resolved_at_s": 2.0}] * 2})
    flood = k.summarize("fp", outcomes, mode="virtual",
                        extra={"alerts": [{"rule": "r"}] * 50})
    return [quiet, paged, flood, k.score(quiet)]


# ========================================================== tuned rules
def _rules_no_config(k):
    base = k.default_rules()
    return [k.rules_from_config(None) == base, k.rules_from_config({}) == base,
            k.rules_from_config({"engine": {"batch_buckets": [1]}}) == base]


def _rules_overrides(k):
    tuned = {"alerts": {"kv_pressure": {"value": 0.9, "for_s": 30},
                        "spawn_failures.window_s": 60,
                        "gold_burn_high.enable": 0}}
    return [list(r) for r in k.rules_from_config(tuned)]


def _rules_malformed(k):
    tuned = {"alerts": {"breaker_open": {"value": "garbage",
                                         "severity": "warn"},
                        "no_such_rule": {"value": 1.0}}}
    return [list(r) for r in k.rules_from_config(tuned)]


def _engine_config(k):
    clock = _Clock()
    store = k.Store(clock=clock)
    tuned = {"alerts": {"kv_pressure.value": 0.5}}
    only = (k.default_rules()[0],)
    return [[list(r) for r in k.AlertEngine(store, config=tuned,
                                            clock=clock).rules],
            k.AlertEngine(store, config=None, clock=clock).rules
            == k.default_rules(),
            k.AlertEngine(store, rules=only, config=tuned,
                          clock=clock).rules == only]


def _tuned_threshold(k):
    clock = _Clock()
    store = k.Store(clock=clock)
    store.ingest("r", _gauge("serve_kv_block_utilization", 0.8), now=clock.t)
    eng = k.AlertEngine(store, config={"alerts": {"kv_pressure": {
        "value": 0.5, "for_s": 0}}}, clock=clock)
    quiet = k.AlertEngine(store, clock=clock)
    return [eng.evaluate(), eng.active(), quiet.evaluate(), quiet.active()]


# ====================================================== decision ingest
class _DecisionMembership:
    def ids(self):
        return []

    def state(self, rid):
        raise KeyError(rid)


class _DecisionRouter:
    def __init__(self, k, autoscaler=None):
        self.metrics = k.Registry()
        self.membership = _DecisionMembership()
        self.telemetry = None
        self.autoscaler = autoscaler

    def _transport(self, *a):
        raise AssertionError("no replicas in this rig")


class _FakeAutoscaler:
    def __init__(self):
        self.decision_log = []

    def log(self, direction, reason, amount, actuated, t):
        self.decision_log.append(json.dumps(
            {"tick": len(self.decision_log), "current": 1, "actual": 1,
             "actuated": actuated, "retired": [],
             "decision": {"direction": direction, "amount": amount,
                          "reason": reason, "evidence": {"t": t}}},
            sort_keys=True, separators=(",", ":")))


def _decisions_rig(k, ctl):
    clock = _Clock()
    router = _DecisionRouter(k, ctl)
    s = k.Scraper(router, clock=clock, interval_s=999)
    assert router.telemetry is s
    return s, clock, router


def _decisions_instants(k):
    ctl = _FakeAutoscaler()
    ctl.log("out", "burn", 2, 2, t=950.0)
    ctl.log("hold", "in_band", 0, 0, t=960.0)
    ctl.log("in", "low_burn", 1, 1, t=970.0)
    s, _, router = _decisions_rig(k, ctl)
    return [s.scrape_once(), s.store.query("autoscale_decision"),
            router.metrics.to_prometheus()]


def _decisions_incremental(k):
    ctl = _FakeAutoscaler()
    ctl.log("out", "burn", 1, 1, t=950.0)
    s, clock, _ = _decisions_rig(k, ctl)
    out = [s.scrape_once(), s.scrape_once()]
    ctl.log("out", "queue", 1, 1, t=980.0)
    out.append(s.scrape_once())
    clock.t += 10
    out.append(s.scrape_once())
    return out + [s.store.query("autoscale_decision"),
                  s.store.latest("autoscale_decision")]


def _decisions_malformed(k):
    ctl = _FakeAutoscaler()
    ctl.decision_log.append("{not json")
    ctl.log("out", "burn", 1, 1, t=950.0)
    s, _, _ = _decisions_rig(k, ctl)
    return [s.scrape_once(), s.store.query("autoscale_decision")]


def _no_autoscaler(k):
    s, _, _ = _decisions_rig(k, None)
    return [s.scrape_once(), s.store.query("autoscale_decision")]


# ======================================= step telemetry without a trainer
def _compile_misses(k):
    tel = k.StepTelemetry(fence=False, memory_every=0)
    for sig in (("a", (16, 5)), ("a", (16, 5)), ("a", (7, 5))):
        tel.step(lambda: 1, sig=sig, batch_size=4)
    snap = tel.snapshot()
    return [snap["compile_cache_misses"], snap["steps"],
            sorted(tel.registry.snapshot()),
            [(e["name"], e["ph"]) for e in tel.tracer.events]]


def _wrap_iterator(k):
    tel = k.StepTelemetry()
    return [list(tel.wrap_iterator([1, 2, 3])),
            tel.registry.histogram("train_data_wait_seconds").count]


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _kinds_materialize, _counter_rate, _retention, _soft_stale, _tombstone,
    _tombstone_alert, _extra_labels, _query_ranges, _short_spike,
    _fires_after_sustain, _resolve_needs_clear, _rate_and_absence,
    _default_rules_gold_burn, _notifier, _slo_forget, _seasonal_forecast,
    _short_series, _forecast_burn, _confident_breach, _unconfident,
    _clamp_and_cooldown, _none_forecast, _sim_penalty, _rules_no_config,
    _rules_overrides, _rules_malformed, _engine_config, _tuned_threshold,
    _decisions_instants, _decisions_incremental, _decisions_malformed,
    _no_autoscaler, _compile_misses, _wrap_iterator)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name):
    _both(SCENARIOS[name])


def test_key_observations_hold():
    """What the reference's own tests assert, on the port's output."""
    out = _both(_counter_rate)
    assert out[0][0]["points"] == [[10.0, 10.0], [20.0, 0.0], [30.0, 4.0]]
    out = _both(_fires_after_sustain)
    assert out[3] == ["hot"] and out[4][0]["fired_at_s"] == 20.0
    out = _both(_default_rules_gold_burn)
    states = [t["to"] for step in out[:6] for t in step
              if t["rule"] == "gold_burn_high"]
    assert states == ["pending", "firing", "resolved"]
    fc = _both(_seasonal_forecast)[0]
    assert fc[2] > 0.8
    d = _both(_confident_breach)
    assert d[0] == "out" and d[2] == "forecast"


# ============================================================ promcheck
GOOD = [
    "# HELP a_total x\n# TYPE a_total counter\na_total 1\n",
    "# TYPE g gauge\ng{x=\"a\\\\b\",y=\"q\\\"\"} 1.5\n# EOF\n",
    "# TYPE h histogram\nh_bucket{le=\"0.1\"} 1\nh_bucket{le=\"+Inf\"} 2\n"
    "h_count 2\nh_sum 0.3\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 1 # {trace_id=\"a\"} 1\n"
    "h_count 1\nh_sum 1\n# EOF\n",
]
BAD = [
    "# TYPE h histogram\n"
    'h_bucket{le="+Inf"} 1 # {trace_id="a"} 1\nh_count 1\nh_sum 1\n',
    "# TYPE g gauge\ng 1 # {trace_id=\"a\"} 1\n# EOF\n",
    "# TYPE h histogram\n"
    'h_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\n'
    'h_bucket{le="+Inf"} 5\nh_count 5\nh_sum 1\n# EOF\n',
    "# TYPE h histogram\n"
    'h_bucket{le="0.1"} 5\nh_count 5\nh_sum 1\n# EOF\n',
    "# TYPE a counter\na_total 1\n# TYPE b counter\nb_total 1\n"
    "a_total 2\n# EOF\n",
    "# TYPE g gauge\ng 1\n# EOF\ng 2\n",
    "# TYPE g gauge\n\ng 1\n# EOF\n",
    '# TYPE g gauge\ng{x="a\\q"} 1\n# EOF\n',
    "# TYPE 9bad gauge\n9bad 1\n",
    "# TYPE g gauge\ng{1x=\"a\"} nope\n",
    "# TYPE g gauge\n# TYPE g gauge\ng 1\n",
]


@pytest.mark.parametrize("i", range(len(GOOD) + len(BAD)))
def test_promcheck_findings_equal_reference(i):
    text = (GOOD + BAD)[i]
    for om in (None, True, False):
        got = PORT.check_text(text, openmetrics=om)
        assert got == JAX.check_text(text, openmetrics=om)
    assert (PORT.check_text(text) == []) == (i < len(GOOD))


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_promcheck_cli(tmp_path, monkeypatch, capsys):
    """``python -m deeplearning4j_torch.obs.promcheck FILE...`` (run as
    ``__main__`` in this process): 1 and the findings on stderr when a
    file fails, 0 and OK when all pass, 2 with no file."""
    import runpy

    good, bad = tmp_path / "good.prom", tmp_path / "bad.prom"
    good.write_text(GOOD[0])
    bad.write_text(BAD[1])
    for argv, code in (([str(good), str(bad)], 1), ([str(good)], 0),
                       ([], 2)):
        monkeypatch.setattr(sys, "argv", ["promcheck"] + argv)
        with pytest.raises(SystemExit) as e:
            runpy.run_module("deeplearning4j_torch.obs.promcheck",
                             run_name="__main__", alter_sys=False)
        assert e.value.code == code, argv
        out, err = capsys.readouterr()
        if code == 1:
            assert f"{good}: OK" in out and f"{bad}: " in err


# ======================================= scrape and the router's endpoints
def _metrics_replica(rid, depth):
    """A replica-shaped server: its heartbeat and a ``/v1/metrics``
    snapshot with a queue gauge and a request counter."""
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
                self._send(200, {"replica": rid, "accepting": True,
                                 "ready": True, "models": {},
                                 "hbm_budget_bytes": 1000,
                                 "resident_bytes": 0, "queue_depth": 0})
            elif self.path == "/v1/metrics":
                self._send(200, {**_gauge("serve_queue_depth", depth),
                                 **_counter("serve_requests_total",
                                            10 * depth)})
            else:
                self._send(404, {"error": "unknown"})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, args=(0.05,),
                     daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _router_drill(k):
    """Two scripted replicas behind the package's router on a hand-driven
    clock: 404s before the plane is attached; a healthy scrape; rB
    partitioned at the transport (scraped as error, soft-staled, never a
    crash); a gold burn recorded on the router pending then firing after
    20 s; rB healed and good traffic after the 1 m window, resolved. Each step reads the
    router's ``/v1/tsdb`` and ``/v1/alerts``."""
    clock = _Clock(0.0)
    reg = k.Registry()
    router = k.cluster.ClusterRouter(port=0, heartbeat_s=3600.0,
                                     hedge_ms=None, metrics=reg,
                                     clock=clock)
    servers = []
    out = []
    try:
        for rid, depth in (("rA", 1.0), ("rB", 3.0)):
            srv, url = _metrics_replica(rid, depth)
            servers.append(srv)
            router.add_replica(rid, url)
        router.start()
        router.poll_once()
        port = router.port
        made = [0]

        def get(path):
            made[0] += 1
            return _get(port, path)

        def settle():
            """Wait until the router has counted every request made (it
            counts one after replying), so the snapshot a scrape ingests
            holds the same series in both packages' runs."""
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                series = reg.snapshot().get("http_requests_total", {}).get(
                    "series", [])
                if sum(s["value"] for s in series) >= made[0]:
                    return
                time.sleep(0.005)

        out.append((get("/v1/tsdb"), get("/v1/alerts")))
        store = k.Store(clock=clock, metrics=reg)
        engine = k.AlertEngine(store, clock=clock, metrics=reg)
        scraper = k.Scraper(router, store, alerts=engine, clock=clock)
        assert router.telemetry is scraper
        transport = router._transport
        cut = set()

        def partitioned(rid, *a, **kw):
            if rid in cut:
                raise OSError("partitioned")
            return transport(rid, *a, **kw)

        router._transport = partitioned
        reads = ("/v1/tsdb?name=serve_queue_depth&stale=1",
                 "/v1/tsdb?name=serve_requests_total&rate=1",
                 "/v1/tsdb?name=fleet_slo_burn_rate&label.slo_class=gold"
                 "&label.window=1m&t_min=0",
                 "/v1/alerts")
        for t, bad, good, partition in (
                (0.0, 0, 0, False), (5.0, 0, 0, True), (10.0, 40, 0, True),
                (20.0, 0, 0, True), (31.0, 0, 0, True), (45.0, 0, 0, False),
                (200.0, 0, 40, False)):
            clock.t = t
            cut.clear()
            if partition:
                cut.add("rB")
            for i in range(bad + good):
                router.slo.record("m", "gold", good=i >= bad)
            settle()
            out.append((t, scraper.scrape_once(now=t),
                        [get(p) for p in reads]))
        out.append(get("/v1/tsdb"))
        out.append(get("/v1/tsdb?name=x&t_min=abc"))
        out.append(sorted(n for n in reg.snapshot()
                          if n.startswith(("tsdb_", "alert"))))
        return out
    finally:
        router.stop()
        for srv in servers:
            srv.shutdown()
            srv.server_close()


@pytest.fixture(scope="module")
def router_drill():
    return _both(_router_drill)


def test_router_endpoints_answer_as_the_reference(router_drill):
    """404 before a plane is attached, then 200 on both endpoints."""
    (tsdb0, alerts0) = router_drill[0]
    assert tsdb0[0] == 404 and alerts0[0] == 404
    for t, outcomes, answers in router_drill[1:8]:
        assert [a[0] for a in answers] == [200] * 4, t
    assert router_drill[9][0] == 400


def test_router_drill_scrapes_and_alerts(router_drill):
    """Healthy scrape all ok; the partitioned replica scraped as error;
    gold_burn_high pending, firing at 20 s of sustain, resolved."""
    steps = router_drill[1:8]
    assert steps[0][1] == {"router": "ok", "rA": "ok", "rB": "ok"}
    assert steps[1][1]["rB"] == "error" and steps[1][1]["rA"] == "ok"
    states = {t: ans[3][1]["rules"]["gold_burn_high"]["state"]
              for t, _, ans in steps}
    assert states[10.0] == "pending" and states[20.0] == "pending"
    assert states[31.0] == "firing"
    assert states[200.0] == "ok"
    firings = steps[-1][2][3][1]["firings"]
    assert [f["rule"] for f in firings] == ["gold_burn_high"]
    assert firings[0]["resolved_at_s"] is not None
    burn = steps[-1][2][2][1]["series"]
    assert burn and len(burn[0]["points"]) >= 5
