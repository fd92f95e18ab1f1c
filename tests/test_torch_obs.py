"""The port's observability modules (deeplearning4j_torch/obs/) against the
JAX package's: the span tracer, the flight recorder, request-scoped tracing,
SLO burn accounting and the metrics registry's exemplars and OpenMetrics
text. Both sides are stdlib code, so each scripted run goes through the two
packages under the same injected clocks and id source and the results must
be equal — dicts equal, text byte for byte.
"""

import itertools
import json
import os
import threading
import time

import pytest

from deeplearning4j_torch.obs import flight as tflight
from deeplearning4j_torch.obs import metrics as tmetrics
from deeplearning4j_torch.obs import reqtrace as treqtrace
from deeplearning4j_torch.obs import slo as tslo
from deeplearning4j_torch.obs import trace as ttrace
from deeplearning4j_tpu.obs import flight as jflight
from deeplearning4j_tpu.obs import metrics as jmetrics
from deeplearning4j_tpu.obs import reqtrace as jreqtrace
from deeplearning4j_tpu.obs import slo as jslo
from deeplearning4j_tpu.obs import trace as jtrace

JAX = dict(trace=jtrace, flight=jflight, reqtrace=jreqtrace, slo=jslo,
           metrics=jmetrics)
PORT = dict(trace=ttrace, flight=tflight, reqtrace=treqtrace, slo=tslo,
            metrics=tmetrics)


class _Script:
    """Deterministic stand-ins for the clocks and the id source, restarted
    before each side's run so both see the same sequence."""

    def __init__(self, monkeypatch):
        self.reset()
        monkeypatch.setattr(time, "perf_counter_ns", self._ns)
        monkeypatch.setattr(time, "time", self._unix)
        monkeypatch.setattr(os, "urandom", self._bytes)

    def reset(self):
        self._ns_it = itertools.count(1_000_000, 250_000)
        self._unix_it = itertools.count(0)
        self._byte_it = itertools.count(1)

    def _ns(self):
        return next(self._ns_it)

    def _unix(self):
        return 1.7e9 + 0.125 * next(self._unix_it)

    def _bytes(self, n):
        return bytes((next(self._byte_it) % 256) for _ in range(n))


@pytest.fixture
def script(monkeypatch):
    return _Script(monkeypatch)


def _both(script, run):
    """``run(modules)`` under the script for the JAX package, then for the
    port; returns the two results."""
    script.reset()
    want = run(JAX)
    script.reset()
    got = run(PORT)
    return want, got


def _tids(events):
    """Thread ids by order of first appearance (two runs use two threads)."""
    seen = {}

    def norm(obj):
        if isinstance(obj, dict):
            return {k: (seen.setdefault(v, len(seen)) if k == "tid" else
                        norm(v)) for k, v in obj.items()}
        if isinstance(obj, list):
            return [norm(v) for v in obj]
        return obj

    return norm(events)


# ------------------------------------------------------------------ tracer
def _trace_script(mods, enabled=True, max_events=200_000):
    tr = mods["trace"].Tracer(enabled=enabled, max_events=max_events)
    with tr.span("step", epoch=0):
        with tr.span("forward"):
            tr.instant("compile", shape="(4, 16)")
        try:
            with tr.span("backward"):
                with tr.span("inner"):
                    raise ValueError("boom")
        except ValueError:
            pass
        with tr.span("update"):
            pass
    tr.async_event("request", "abc", 2_000_000, 9_000_000, tid=7,
                   kind="predict")

    def other():
        with tr.span("worker"):
            tr.instant("tick")

    th = threading.Thread(target=other, name="obs-worker")
    th.start()
    th.join()
    out = tr.to_chrome()
    for ev in out["traceEvents"]:
        ev.pop("pid")
    return _tids(out)


@pytest.mark.parametrize("enabled,max_events", [(True, 200_000), (True, 5),
                                                (False, 200_000)])
def test_tracer_events_equal(script, enabled, max_events):
    want, got = _both(script, lambda m: _trace_script(m, enabled, max_events))
    assert got == want
    if enabled and max_events > 10:
        names = [e["name"] for e in got["traceEvents"] if e["ph"] == "X"]
        assert names == ["forward", "inner", "backward", "update", "step",
                         "worker"]
        # an exception inside a nested span must not corrupt attribution
        upd = next(e for e in got["traceEvents"] if e["name"] == "update")
        assert upd["args"] == {"parent": "step"}


def test_null_span_is_shared_and_inert():
    assert ttrace.Tracer(enabled=False).span("x") is ttrace._NULL_SPAN
    with ttrace._NULL_SPAN as s:
        assert s is ttrace._NULL_SPAN


# ---------------------------------------------------------- flight recorder
def _flight_script(mods, out_dir):
    fr = mods["flight"].FlightRecorder(capacity=3, event_capacity=4,
                                       out_dir=out_dir, max_dumps=2)
    for i in range(5):
        fr.record_request({"request_id": f"r{i}", "status": "ok"})
    fr.record_event("health", "degraded", "watchdog:engine")
    fr.record_event("breaker", "open", model="a", failures=3)
    paths = [fr.dump("breaker_open"), fr.dump("health_failed"),
             fr.dump("watchdog_restart")]
    files = {}
    for p in paths:
        if p is not None:
            with open(p) as f:
                files[os.path.basename(p)] = json.load(f)
    snap = fr.snapshot()
    snap["dumps"] = [os.path.basename(p) for p in snap["dumps"]]
    return {"snap": snap, "files": files, "requests": fr.requests(),
            "events": fr.events()}


@pytest.mark.parametrize("to_disk", [False, True])
def test_flight_recorder_rings_and_dumps_equal(script, tmp_path, to_disk):
    dirs = iter([str(tmp_path / "jax"), str(tmp_path / "port")])

    def run(mods):
        return _flight_script(mods, next(dirs) if to_disk else None)

    want, got = _both(script, run)
    assert got == want
    assert [r["request_id"] for r in got["requests"]] == ["r2", "r3", "r4"]
    if to_disk:
        assert sorted(got["files"]) == ["flight_00.json", "flight_01.json"]
        assert got["files"]["flight_00.json"]["reason"] == "watchdog_restart"


def test_flight_install_uninstall():
    rec = tflight.FlightRecorder()
    try:
        assert tflight.install(rec) is rec and tflight.ACTIVE is rec
    finally:
        assert tflight.uninstall() is rec
    assert tflight.ACTIVE is None


# ------------------------------------------------------- request tracing
def _reqtrace_script(mods, traceparent):
    rt_mod = mods["reqtrace"]
    tracer = mods["trace"].Tracer()
    rec = mods["flight"].FlightRecorder()
    rt = rt_mod.RequestTracer(tracer=tracer, flight=rec, max_stages=6)
    rt_mod.install(rt)
    try:
        ctx = rt.begin("predict", traceparent=traceparent,
                       request_id=None, model="alpha", tenant="gold",
                       slo_class="gold")
        with ctx.stage("admit", model="alpha"):
            pass
        ctx.annotate(bucket=4)
        with rt_mod.span("fleet.page_in", model="alpha", victims=1):
            rt_mod.instant("fault:fleet.page_in_transfer", mode="error")

        def worker():
            t0 = time.perf_counter_ns()
            ctx.add_stage("queue", ctx.t0_ns, t0)
            ctx.add_stage("device", t0, time.perf_counter_ns(), bucket=4,
                          batch_seq=1)
            ctx.decode_begin()
            for _ in range(3):
                a = time.perf_counter_ns()
                ctx.decode_tick(a, time.perf_counter_ns())
            ctx.finish_work(tokens=3)

        th = threading.Thread(target=worker, name="engine")
        th.start()
        th.join()
        for i in range(4):  # past max_stages: counted, not appended
            ctx.add_stage(f"extra{i}", ctx.t0_ns, ctx.t0_ns)
        record = ctx.finish()
        again = ctx.finish(error="late")
        shed = rt.begin("generate", traceparent="garbage")
        shed.finish_work(error="worker_stall")
        shed.finish(error="worker_stall")
    finally:
        rt_mod.uninstall()
    events = tracer.to_chrome()["traceEvents"]
    for ev in events:
        ev.pop("pid")
    return _tids({"record": record, "again": again,
                  "traceparent": ctx.traceparent(), "parent": ctx.parent_id,
                  "requests": rec.requests(), "events": events})


@pytest.mark.parametrize("traceparent", [
    None, "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01"])
def test_request_trace_stitched_across_threads_equal(script, traceparent):
    want, got = _both(script, lambda m: _reqtrace_script(m, traceparent))
    assert got == want
    rec = got["record"]
    assert [s["name"] for s in rec["stages"]] == [
        "admit", "queue", "device", "decode", "extra0", "extra1"]
    assert rec["stages_dropped"] == 2 and rec["ticks"] == 3
    assert got["again"] is None  # finish is idempotent
    # the stages the worker ran carry its thread, not the ingress thread's
    assert rec["stages"][0]["tid"] != rec["stages"][1]["tid"]
    if traceparent and traceparent.startswith("00-0af"):
        assert rec["trace_id"] == "0af7651916cd43dd8448eb211c80319c"
        assert got["parent"] == "b7ad6b7169203331"


@pytest.mark.parametrize("header", [
    None, "", "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00 ",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-extra",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01"])
def test_parse_traceparent_equal(header):
    assert treqtrace.parse_traceparent(header) == \
        jreqtrace.parse_traceparent(header)


def test_ambient_helpers_are_noops_when_uninstalled():
    assert treqtrace.ACTIVE is None
    assert treqtrace.span("x") is ttrace._NULL_SPAN
    treqtrace.instant("x")  # no tracer: nothing happens


# ------------------------------------------------------------- SLO burn
def _slo_script(mods):
    t = [0.0]
    reg = mods["metrics"].MetricsRegistry()
    burn = mods["slo"].SloBurn(metrics=reg, windows=(60.0, 600.0),
                               clock=lambda: t[0])
    for i in range(40):
        t[0] = i * 7.5
        burn.record("alpha", "gold", good=(i % 9 != 0))
        burn.record("beta", "batch", good=(i % 3 != 0))
        burn.record("alpha", "standard", good=True)
    snaps = [burn.snapshot()]
    t[0] = 400.0
    snaps.append(burn.snapshot())
    burn.forget("beta")
    snaps.append(burn.snapshot())
    return {"snaps": snaps, "prom": reg.to_prometheus(),
            "om": reg.to_openmetrics()}


def test_slo_burn_rates_equal(script):
    want, got = _both(script, _slo_script)
    assert got == want
    gold = got["snaps"][0]["alpha"]["gold"]
    assert gold["bad"] == 5 and gold["burn"]["1m"] > 1.0
    assert "beta" not in got["snaps"][2]


@pytest.mark.parametrize("window", [30.0, 60.0, 90.0, 3600.0])
def test_slo_window_labels_equal(window):
    assert tslo._fmt_window(window) == jslo._fmt_window(window)


# --------------------------------------------------------------- metrics
def _metrics_script(mods, traced):
    reg = mods["metrics"].MetricsRegistry()
    c = reg.counter("serve_requests_total", {"model": "a"}, help="requests")
    c.inc()
    c.inc(2.5)
    reg.counter("serve_shed_total", {"cause": "quota", "tenant": 't"x\\'},
                help="sheds").inc()
    g = reg.gauge("fleet_resident_bytes", help="bytes")
    g.set(123456789)
    g.inc(1)
    g.dec(0.5)
    h = reg.histogram("serve_device_seconds", {"model": "a"}, help="dev")
    h2 = reg.histogram("occ", buckets=(0.25, 0.5, 1.0))
    for i, v in enumerate((1e-4, 3e-3, 0.04, 0.04, 2.0, 75.0, 0.3)):
        h.observe(v, trace_id=(f"{i:032x}" if traced and i % 2 == 0
                               else None))
        h2.observe(v / 100)
    reg.remove_series("occ_missing")
    return {"prom": reg.to_prometheus(), "om": reg.to_openmetrics(),
            "json": reg.to_json(),
            "quantiles": [h.quantile(q) for q in (0, 0.5, 0.95, 0.99, 1)]}


@pytest.mark.parametrize("traced", [False, True])
def test_openmetrics_and_exemplars_byte_equal(script, traced):
    want, got = _both(script, lambda m: _metrics_script(m, traced))
    assert got == want
    assert got["om"].endswith("# EOF\n")
    assert ("# {trace_id=" in got["om"]) == traced
    assert "# {trace_id=" not in got["prom"]
    # counters drop _total in OpenMetrics metadata only
    assert "# TYPE serve_requests counter" in got["om"]
    assert "serve_requests_total{model=\"a\"} 3.5" in got["om"]


def test_disabled_registry_is_inert_on_both():
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry(enabled=False)
        reg.counter("a_total").inc()
        reg.histogram("h").observe(1.0, trace_id="t")
        assert reg.to_prometheus() == "" and reg.snapshot() == {}
        assert reg.to_openmetrics() == "# EOF\n"
