"""The port's sim tier (deeplearning4j_torch/sim/) against the JAX
package's: ``generate_trace`` bytes and ``fingerprint()`` equal across the
packages and across two interpreters under different ``PYTHONHASHSEED``
values; ``VirtualReplayer`` ``report_json`` byte-equal (default, tuned and
profile-calibrated cost models, hop costs on, paging, prefix pools); the
``Tuner``'s seeded winner and rungs equal; ``record_winner`` landing in the
port's store where ``FleetRegistry(tuned_for=...)`` finds it; scoring and
open-loop live replay against a stub target equal.
"""

import hashlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_torch import sim as tsim
from deeplearning4j_torch.aot import AotStore as TStore
from deeplearning4j_torch.obs import costmodel as tcost
from deeplearning4j_torch.obs.metrics import MetricsRegistry as TMetrics
from deeplearning4j_tpu import sim as jsim
from deeplearning4j_tpu.aot import AotStore as JStore
from deeplearning4j_tpu.obs import costmodel as jcost

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KITS = {"jax": SimpleNamespace(sim=jsim, Store=JStore, cost=jcost),
        "port": SimpleNamespace(sim=tsim, Store=TStore, cost=tcost)}


def _spec(sim, case):
    """One of the workload shapes the reference's tests use."""
    if case == "smoke":
        return sim.smoke_spec(seed=3, duration_s=15.0, base_rate_rps=8.0)
    if case == "multi_day":
        d = sim.smoke_spec(seed=1, duration_s=30.0,
                           base_rate_rps=12.0).to_dict()
        d["days"] = 3
        return sim.WorkloadSpec.from_dict(d)
    if case == "prefix_pools":
        LD = sim.LengthDist
        return sim.WorkloadSpec(
            seed=2, duration_s=20.0, base_rate_rps=6.0,
            prompt_len=LD("fixed", 40.0, 0.0, 40),
            output_len=LD("fixed", 8.0, 0.0, 8),
            prefix_len=LD("fixed", 32.0, 0.0, 32),
            prefix_reuse=0.9, prefix_pool=2,
            models={"m": {"weight": 1.0, "generate_frac": 1.0}})
    if case == "overload":
        return sim.smoke_spec(seed=0, duration_s=60.0, base_rate_rps=80.0)
    if case == "card_mix":
        # the cluster phase's shape: 1024-token prompts, 64-token outputs,
        # vocab 32000
        LD = sim.LengthDist
        return sim.WorkloadSpec(
            seed=0, duration_s=40.0, base_rate_rps=3.0,
            diurnal_amplitude=0.6, burst_rate_mult=2.5,
            burst_mean_on_s=4.0, burst_mean_off_s=12.0,
            prompt_len=LD("lognormal", 200.0, 0.9, 1024),
            output_len=LD("pareto", 8.0, 1.6, 64), vocab=32000,
            tenants={"gold": {"weight": 0.5, "slo": "gold"},
                     "standard": {"weight": 0.35, "slo": "standard"},
                     "batch": {"weight": 0.15, "slo": "batch"}},
            models={"alpha": {"weight": 0.6, "generate_frac": 0.0},
                    "beta": {"weight": 0.4, "generate_frac": 0.5}})
    raise KeyError(case)


SPECS = ("smoke", "multi_day", "prefix_pools", "overload", "card_mix")


# ----------------------------------------------------------------- traces
@pytest.mark.parametrize("case", SPECS)
def test_trace_bytes_and_fingerprint_equal(case):
    want = jsim.generate_trace(_spec(jsim, case))
    got = tsim.generate_trace(_spec(tsim, case))
    assert got.to_bytes() == want.to_bytes()
    assert got.fingerprint() == want.fingerprint()
    assert got.content_hash() == want.content_hash()
    assert _spec(tsim, case).canonical() == _spec(jsim, case).canonical()
    ev = next(iter(got))
    assert tsim.prompt_tokens(ev, 50) == jsim.prompt_tokens(
        next(iter(want)), 50)


_DRIVER = (
    "import hashlib, json, sys\n"
    "from deeplearning4j_torch import sim\n"
    "spec = sim.WorkloadSpec.from_dict(json.loads(sys.argv[1]))\n"
    "t = sim.generate_trace(spec)\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'deeplearning4j_tpu', 'torch')]\n"
    "print(hashlib.sha256(t.to_bytes()).hexdigest(), t.fingerprint(), bad)\n")


@pytest.mark.parametrize("case", ("smoke", "prefix_pools"))
def test_trace_equal_across_interpreters(case):
    """Two fresh interpreters with different PYTHONHASHSEED values expand
    the spec (sent as its canonical JSON) to the reference's bytes, and
    load neither JAX nor torch: the workload layer is stdlib only."""
    spec = _spec(jsim, case)
    want = jsim.generate_trace(spec)
    line = (f"{hashlib.sha256(want.to_bytes()).hexdigest()} "
            f"{want.fingerprint()} []")
    for hashseed in ("0", "4242"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        r = subprocess.run([sys.executable, "-c", _DRIVER,
                            spec.canonical().decode()], cwd=_REPO,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == line


def test_trace_save_load_and_slice(tmp_path):
    t = tsim.generate_trace(_spec(tsim, "prefix_pools"))
    path = str(tmp_path / "trace.txt")
    t.save(path)
    j = jsim.Trace.load(path)                    # the shared line format
    assert j.to_bytes() == t.to_bytes()
    head = tsim.Trace.load(path).slice(7)
    assert len(head) == 7 and head.fingerprint() == t.fingerprint()


def test_spec_rejects_alike():
    for kw in ({"days": 0}, {"prefix_reuse": 0.5}):
        with pytest.raises(ValueError) as want:
            jsim.WorkloadSpec(**kw)
        with pytest.raises(ValueError) as got:
            tsim.WorkloadSpec(**kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------- virtual replay
def _profile(kit):
    return kit.cost.CostProfile.from_dict({
        "costs": {"predict_row_s": 3e-4, "predict_dispatch_s": 2e-3,
                  "prefill_tok_s": 9000.0, "decode_base_s": 6e-3,
                  "decode_slot_s": None, "page_in_s": 0.25}})


REPLAYS = {
    "default": (None, None),
    "tuned_knobs": ({"engine": {"max_wait_ms": 8.0, "queue_limit": 64},
                     "gen": {"slots": 8, "block_size": 8,
                             "prefill_chunk": 16, "decode_chunks": 2}},
                    None),
    "paging": ({"fleet": {"resident_models": 1}}, None),
    "hops_hedged": (None, {"hop_rtt_s": 0.01, "hop_loss_p": 0.2}),
    "hops_budget": ({"cluster": {"hedge_ms": 0.0,
                                 "retry_budget_per_s": 0.5}},
                    {"hop_rtt_s": 0.02, "hop_loss_p": 0.3}),
    "from_profile": (None, "profile"),
}


@pytest.mark.parametrize("case", SPECS)
@pytest.mark.parametrize("replay", sorted(REPLAYS))
def test_virtual_report_equal(case, replay):
    knobs, cm = REPLAYS[replay]

    def report(kit):
        sim = kit.sim
        if cm == "profile":
            model = sim.CostModel.from_profile(_profile(kit))
        else:
            model = sim.CostModel(**cm) if cm else None
        trace = sim.generate_trace(_spec(sim, case))
        return sim.report_json(sim.VirtualReplayer(
            trace, knobs=knobs, cost_model=model).run())

    want, got = report(KITS["jax"]), report(KITS["port"])
    assert got == want
    rep = json.loads(got)
    assert rep["untyped_errors"] == 0
    assert rep["completed"] + sum(rep["shed"].values()) == rep["requests"]


def test_cost_model_from_profile_equal():
    want = jsim.CostModel.from_profile(_profile(KITS["jax"]))
    got = tsim.CostModel.from_profile(_profile(KITS["port"]))
    assert tuple(got) == tuple(want)
    assert got.decode_slot_s == tsim.CostModel().decode_slot_s


# -------------------------------------------------------------------- tuner
@pytest.mark.parametrize("seed,case", [(0, "smoke"), (9, "card_mix")])
def test_tuner_winner_equal(seed, case):
    def search(kit):
        trace = kit.sim.generate_trace(_spec(kit.sim, case))
        base = ({"engine": {"batch_buckets": [1, 2, 4]},
                 "gen": {"capacity": 1024}} if case == "card_mix" else None)
        res = kit.sim.Tuner(trace, seed=seed, base=base).search(
            candidates=8, eta=3, min_events=64)
        return (json.dumps(res.winner, sort_keys=True), res.winner_score,
                res.default_score, res.evaluated, res.rungs,
                kit.sim.report_json(res.winner_report))

    want, got = search(KITS["jax"]), search(KITS["port"])
    assert got == want
    assert got[1] >= got[2]                      # never below the default


def test_tuner_from_store_and_record_winner(tmp_path):
    """A profile in the port's store calibrates the tuner (a counted hit,
    the same winner as the reference's from its own store), the winner
    lands in the port's store, and a tuned_for= boot finds it."""
    from deeplearning4j_torch.fleet import FleetRegistry

    out = {}
    for side in ("jax", "port"):
        kit = KITS[side]
        store = kit.Store(str(tmp_path / side))
        assert kit.cost.put_profile(store, "model-fp", _profile(kit))
        trace = kit.sim.generate_trace(_spec(kit.sim, "smoke"))
        metrics = (TMetrics() if side == "port" else None)
        tuner = kit.sim.Tuner.from_store(trace, store, "model-fp",
                                         metrics=metrics, seed=4)
        res = tuner.search(candidates=6, eta=3, min_events=64)
        key = kit.sim.record_winner(store, trace, res)
        out[side] = (tuple(tuner.cost_model), res.winner, key)
        if side == "port":
            assert metrics.counter("profile_store_hits_total").value == 1
            f = FleetRegistry(device="cpu", aot_store=store,
                              tuned_for=trace.fingerprint())
            try:
                assert f.tuned_config == res.winner
                assert f.metrics.counter(
                    "sim_tuned_config_hits_total").value == 1
            finally:
                f.shutdown()
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][2] is not None


# ------------------------------------------------------- scoring and live
def _outcomes(sim):
    O = sim.Outcome
    return [O(True, None, "gold", "a", "predict", 0.012, None, None, 0),
            O(True, None, "standard", "b", "generate", 0.5, 0.05, 0.01, 9),
            O(False, "queue_full", "gold", "a", "predict", None, None, None,
              0),
            O(False, "quota", "batch", "a", "predict", None, None, None, 0),
            O(False, "boom", "standard", "b", "generate", None, None, None,
              0),
            O(True, None, "batch", "b", "generate", 1.25, 0.2, 0.03, 33)]


def test_summarize_and_score_equal():
    def run(sim):
        rep = sim.summarize("fp", _outcomes(sim), mode="live",
                            knobs={"gen": {"slots": 2}},
                            kv_peak_utilization=0.5,
                            kv_mean_utilization=0.25,
                            extra={"alerts": [{"rule": "x"}]})
        return sim.report_json(rep), sim.score(rep)

    assert run(tsim) == run(jsim)
    assert tsim.TYPED_CAUSES == jsim.TYPED_CAUSES
    assert tsim.DEFAULT_KNOBS == jsim.DEFAULT_KNOBS
    assert tsim.DEFAULT_SPACE == jsim.DEFAULT_SPACE


class _StubTarget:
    """Scripted fates: predicts succeed, beta's generates shed typed, one
    event raises (an untyped bug), and the fleet size is stamped."""

    def __init__(self, sim, boom_seq):
        self.sim = sim
        self.boom_seq = boom_seq

    def kv_utilization(self):
        return (0.25, 0.125)

    def replica_stats(self):
        return {"min": 1, "max": 3, "final": 2}

    def predict(self, ev):
        if ev.seq == self.boom_seq:
            raise RuntimeError("scripted target bug")
        return self.sim.Outcome(True, None, ev.slo, ev.model, ev.kind,
                                0.002, None, None, 0)

    def generate(self, ev):
        if ev.model == "beta":
            return self.sim.Outcome(False, "queue_full", ev.slo, ev.model,
                                    ev.kind, None, None, None, 0)
        return self.sim.Outcome(True, None, ev.slo, ev.model, ev.kind,
                                0.01, 0.004, 0.002, ev.max_new_tokens)


def test_live_replay_equal():
    def run(sim):
        trace = sim.generate_trace(sim.smoke_spec(seed=0, duration_s=8.0))
        boom = next(ev.seq for ev in trace if ev.kind == "predict")
        rep = sim.LiveReplayer(trace, _StubTarget(sim, boom),
                               time_scale=0.01).run()
        assert rep["wall_s"] > 0
        rep.pop("wall_s")
        return sim.report_json(rep)

    got = run(tsim)
    assert got == run(jsim)
    rep = json.loads(got)
    assert rep["untyped_errors"] == 1 and rep["shed"]["internal"] == 1
    assert rep["replicas"] == {"min": 1, "max": 3, "final": 2}


def test_fleet_target_typed_outcomes():
    """FleetTarget over a port fleet on the CPU: predicts and greedy
    generates answer, an unknown model sheds typed."""
    from deeplearning4j_torch.fleet import FleetRegistry
    from deeplearning4j_torch.models import CausalLM

    m = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                 num_heads=4, vocab=50, device="cpu").build()
    m.init(seed=0)
    f = FleetRegistry(device="cpu")
    f.add("alpha", m, input_dtype=np.int32,
          engine_opts={"batch_buckets": (1, 2)},
          gen_opts={"slots": 2, "capacity": 32, "seed": 0})
    target = tsim.FleetTarget(f, input_len=16, vocab=50)
    ev = tsim.Event(0, 0, "t", "gold", "alpha", "predict", 5, 0, 7)
    try:
        assert target.predict(ev).ok
        gen = target.generate(ev._replace(kind="generate",
                                          max_new_tokens=4))
        assert gen.ok and gen.tokens == 4
        bad = target.predict(ev._replace(model="nope"))
        assert not bad.ok and bad.cause == "unknown_model"
    finally:
        f.shutdown()
