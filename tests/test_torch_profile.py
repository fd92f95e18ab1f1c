"""The port's dispatch profiler and cost model
(deeplearning4j_torch/obs/{profile,costmodel}.py) held against the JAX
package's: the same hints and dispatches on a fake clock give the same
snapshots (exact counts, extrapolations, padding waste, payload shape,
metric families), the same snapshots fold into the same cost profiles,
profiles persist through the port's store with the reference's
miss discipline, and with no profiler installed store-backed serving
never touches one (the reference's booby trap). Every comparison is
exact: both sides compute in Python floats on the same inputs."""

import numpy as np
import pytest
import torch

from deeplearning4j_torch.aot import AotStore
from deeplearning4j_torch.obs import costmodel as tcost
from deeplearning4j_torch.obs import profile as tprof
from deeplearning4j_torch.obs.metrics import MetricsRegistry
from deeplearning4j_tpu.obs import costmodel as jcost
from deeplearning4j_tpu.obs import profile as jprof
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JMetrics


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeAot:
    """Stands in for AotFunction at the profiler's dispatch seam."""

    def __init__(self, tag, component="engine", key="k0"):
        self.tag, self.component, self._key = tag, component, key

    def store_key(self, sig):
        return self._key


# (kind, args): hint(component, live, padded) or dispatch(tag, component,
# sig, seconds) — one script run through both packages' profilers
_SCRIPT = [
    ("hint", ("engine", 3, 4)),
    ("dispatch", ("engine_forward", "engine", ("(4, 256):int32",), 0.010)),
    ("dispatch", ("engine_forward", "engine", ("(4, 256):int32",), 0.012)),
    ("hint", ("generate", 5, 8)),
    ("dispatch", ("gen_decode_paged", "generate", ("(24,):int64",), 0.002)),
    ("hint", ("generate", 7, 8)),
    ("dispatch", ("gen_decode_paged", "generate", ("(24,):int64",), 0.003)),
    ("hint", ("generate", 40, 64)),
    ("dispatch", ("gen_prefill_chunk", "generate", ("(81,):int64",), 0.004)),
    ("hint", ("engine", 1, 1)),
    ("dispatch", ("engine_forward", "engine", ("(1, 1024):int32",), 0.020)),
    ("page_in", (0.5,)),
    ("hint", ("engine", 2, 4)),
    ("dispatch", ("engine_forward", "engine", ("(4, 256):int32",), 0.011)),
    ("page_in", (0.25,)),
]


def _run(mod, metrics_cls, sample_rate, hbm=(0,)):
    clk = _FakeClock()
    peaks = iter(list(hbm) * 100)
    m = metrics_cls()
    prof = mod.Profiler(sample_rate=sample_rate, clock=clk, metrics=m,
                        fence=lambda v: None, hbm_probe=lambda: next(peaks))
    fns = {}
    for kind, args in _SCRIPT:
        if kind == "hint":
            prof.hint(*args)
        elif kind == "page_in":
            prof.page_in(*args)
        else:
            tag, comp, sig, dt = args
            fn = fns.setdefault(tag, _FakeAot(tag, comp, f"key-{tag}"))

            def exe(*a, _dt=dt):
                clk.t += _dt
                return "out"

            assert prof.dispatch(fn, sig, exe, ()) == "out"
    return prof, m


class TestProfilerParity:
    @pytest.mark.parametrize("rate", [1, 2, 3, 16])
    def test_same_script_same_snapshot(self, rate):
        tp, _ = _run(tprof, MetricsRegistry, rate, hbm=(100, 700, 300))
        jp, _ = _run(jprof, JMetrics, rate, hbm=(100, 700, 300))
        for top in (None, 2):
            for pairs in (False, True):
                assert tp.snapshot(top=top, include_pairs=pairs) == \
                    jp.snapshot(top=top, include_pairs=pairs)

    @pytest.mark.parametrize("rate", [1, 4])
    def test_same_metric_families(self, rate):
        _, tm = _run(tprof, MetricsRegistry, rate, hbm=(64,))
        _, jm = _run(jprof, JMetrics, rate, hbm=(64,))
        assert tm.snapshot() == jm.snapshot()
        assert tm.to_prometheus() == jm.to_prometheus()

    def test_debug_payload_shape(self):
        assert tprof.ACTIVE is None and jprof.ACTIVE is None
        assert tprof.debug_payload() == jprof.debug_payload() == \
            {"enabled": False}
        tp, _ = _run(tprof, MetricsRegistry, 1)
        jp, _ = _run(jprof, JMetrics, 1)
        tprof.install(tp)
        jprof.install(jp)
        try:
            for top in (1, 20):
                assert tprof.debug_payload(top) == jprof.debug_payload(top)
        finally:
            tprof.uninstall()
            jprof.uninstall()

    def test_format_report_same_text(self):
        tp, _ = _run(tprof, MetricsRegistry, 2)
        jp, _ = _run(jprof, JMetrics, 2)
        doc = tp.snapshot()
        assert tprof.format_report(doc, top=3) == \
            jprof.format_report(jp.snapshot(), top=3)

    def test_extrapolation_exact_on_constant_cost(self):
        clk = _FakeClock()
        prof = tprof.Profiler(sample_rate=4, clock=clk,
                              fence=lambda v: None, hbm_probe=lambda: 0)

        def exe():
            clk.t += 0.01
            return 1

        for _ in range(40):
            prof.dispatch(_FakeAot("engine_forward"), ("s",), exe, ())
        (st,) = prof.snapshot()["executables"]
        assert st["dispatches"] == 40 and st["sampled"] == 10
        assert st["device_s_est"] == pytest.approx(0.4)

    def test_rejects_nonpositive_rate(self):
        with pytest.raises(ValueError):
            tprof.Profiler(sample_rate=0)

    def test_torch_fence_and_hbm_probe_on_cpu(self):
        # the CPU fence is a no-op over any output tree; no card: peak 0
        tprof._torch_fence((torch.zeros(2), {"a": torch.ones(1)}))
        tprof._torch_fence(None)
        assert tprof._torch_hbm_peak() == 0

    def test_cli_reports_a_snapshot(self, tmp_path, capsys):
        import json

        tp, _ = _run(tprof, MetricsRegistry, 1)
        path = tmp_path / "snap.json"
        path.write_text(json.dumps(tp.snapshot()))
        assert tprof.main([str(path), "--top", "2"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("top executables by estimated device time")
        assert "engine_forward" in out


# ------------------------------------------------------------ cost model
def _snapshots():
    tp, _ = _run(tprof, MetricsRegistry, 1)
    return tp.snapshot(include_pairs=True)


_HAND = {
    "sample_rate": 4,
    "executables": [
        {"component": "engine", "tag": "engine_forward",
         "signature": ["f32[2,8]"], "key": "a", "dispatches": 8,
         "sampled": 2, "device_s_sampled": 0.004,
         "pairs": [[1, 1.2e-3], [2, 1.4e-3], [4, 1.8e-3]]},
        {"component": "generate", "tag": "gen_prefill_chunk",
         "signature": ["i32[2,8]"], "key": "b", "dispatches": 4,
         "sampled": 4, "device_s_sampled": 0.008,
         "pairs": [[8, 0.002], [8, 0.002]]},
        {"component": "generate", "tag": "gen_decode_paged",
         "signature": ["i32[2,1]"], "key": "c", "dispatches": 6,
         "sampled": 3, "device_s_sampled": 0.006,
         "pairs": [[1, 3e-3], [2, 4e-3]]},
    ],
    "padding": {"engine/8": {"component": "engine", "bucket": 8,
                             "dispatches": 2, "live": 8, "padded": 16}},
    "hbm_peak_bytes": {"engine": 512},
    "page_in": {"count": 4, "total_s": 2.0},
}


class TestCostModelParity:
    @pytest.mark.parametrize("folds", [1, 2, 3])
    def test_same_fits(self, folds):
        import copy

        for snap in (_HAND, _snapshots()):
            t_acc, j_acc = tcost.ProfileAccumulator(), \
                jcost.ProfileAccumulator()
            for _ in range(folds):
                t_acc.fold(copy.deepcopy(snap))
                j_acc.fold(copy.deepcopy(snap))
            tp, jp = t_acc.profile(), j_acc.profile()
            assert tp.to_dict() == jp.to_dict()
            assert tp.to_json() == jp.to_json()
            for f in tcost._COST_FIELDS:
                assert tp.cost(f) == jp.cost(f)
            assert tp.waste_ratio() == jp.waste_ratio()
            assert tp.top_executables(2) == jp.top_executables(2)

    @pytest.mark.parametrize("pairs", [
        [], [(4.0, 0.002), (4.0, 0.004)],
        [(1.0, 1.2e-3), (2.0, 1.4e-3), (4.0, 1.8e-3)],
        [(1.0, 5e-3), (2.0, 4e-3), (3.0, 1e-3)]])
    def test_same_ols(self, pairs):
        assert tcost._fit(pairs) == jcost._fit(pairs)

    def test_hand_costs(self):
        prof = tcost.ProfileAccumulator().fold(_HAND).profile()
        assert prof.cost("predict_row_s") == pytest.approx(2e-4)
        assert prof.cost("predict_dispatch_s") == pytest.approx(1e-3)
        assert prof.cost("prefill_tok_s") == pytest.approx(16 / 0.004)
        assert prof.cost("decode_slot_s") == pytest.approx(1e-3)
        assert prof.cost("page_in_s") == pytest.approx(0.5)

    def test_from_dict_roundtrip_reads_reference_json(self):
        jp = jcost.ProfileAccumulator().fold(_HAND).profile()
        back = tcost.CostProfile.from_dict(jp.to_dict())
        assert back.to_json() == jp.to_json()


class TestProfileStore:
    def test_roundtrip_counted_hit(self, tmp_path):
        store = AotStore(str(tmp_path))
        prof = tcost.ProfileAccumulator().fold(_HAND).profile()
        key = tcost.put_profile(store, "arch0", prof)
        assert key is not None
        m = MetricsRegistry()
        got = tcost.get_profile(store, "arch0", metrics=m)
        assert got.to_json() == prof.to_json()
        assert m.counter("profile_store_hits_total").value == 1

    def test_misses_are_counted(self, tmp_path):
        store = AotStore(str(tmp_path))
        m = MetricsRegistry()
        assert tcost.get_profile(store, "absent", metrics=m) is None
        assert tcost.get_profile(None, "absent", metrics=m) is None
        prof = tcost.ProfileAccumulator().fold(_HAND).profile()
        key = tcost.put_profile(store, "arch1", prof)
        path = store._entry_path(key)
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        assert tcost.get_profile(store, "arch1", metrics=m) is None
        assert m.counter("profile_store_misses_total").value == 3
        assert store.stats()["quarantined"] == 1

    def test_runtime_skew_is_miss(self, tmp_path):
        store = AotStore(str(tmp_path))
        prof = tcost.ProfileAccumulator().fold(_HAND).profile()
        rt = {"torch": "1", "backend": "cpu"}
        tcost.put_profile(store, "arch", prof, runtime=rt)
        assert tcost.get_profile(store, "arch", runtime=rt) is not None
        assert tcost.get_profile(store, "arch",
                                 runtime={**rt, "torch": "2"}) is None


class TestZeroOverheadWhenDisabled:
    def test_no_profiler_calls_on_serving_hot_paths(self, monkeypatch,
                                                    tmp_path):
        """With no profiler installed, store-backed serving never touches
        a Profiler: every entry point is booby-trapped while real predict
        and generate traffic runs through the store-backed seam."""
        from deeplearning4j_torch.models import CausalLM
        from deeplearning4j_torch.nn.layers import Dense, Output
        from deeplearning4j_torch.nn.model import NetConfig, Sequential
        from deeplearning4j_torch.serve import ContinuousBatcher, ServeEngine

        def boom(*a, **k):
            raise AssertionError("profiler touched while disabled")

        for meth in ("hint", "dispatch", "page_in", "snapshot", "_observe"):
            monkeypatch.setattr(tprof.Profiler, meth, boom)
        assert tprof.ACTIVE is None
        store = AotStore(str(tmp_path))
        dense = Sequential(NetConfig(seed=0),
                           [Dense(n_out=6, activation="tanh"),
                            Output(n_out=3, loss="mcxent",
                                   activation="softmax")], (4,),
                           device="cpu")
        dense.init()
        eng = ServeEngine(dense, batch_buckets=(1, 2), max_wait_ms=1.0,
                          aot_store=store)
        try:
            assert eng.aot_functions()
            y = eng.predict(np.zeros((4,), np.float32))
            assert np.asarray(y).shape[-1] == 3
        finally:
            eng.shutdown(drain=True)
        lm = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                      num_heads=4, vocab=50, device="cpu").build()
        lm.init()
        cb = ContinuousBatcher(lm, slots=2, capacity=8, seed=0,
                               aot_store=store)
        try:
            toks = cb.generate(np.arange(4, dtype=np.int32), 4,
                               temperature=0.0)
            assert len(toks) == 4
        finally:
            cb.shutdown()

    def test_installed_profiler_sees_every_step(self, tmp_path):
        """The same traffic with a profiler installed: the engine's
        forward and the batcher's prefill, decode and sampler dispatches,
        each with its padding hint, keyed by the store key."""
        from deeplearning4j_torch.models import CausalLM
        from deeplearning4j_torch.serve import ContinuousBatcher, ServeEngine

        store = AotStore(str(tmp_path))
        lm = CausalLM(seed=0, input_shape=(16,), num_layers=2, d_model=32,
                      num_heads=4, vocab=50, device="cpu").build()
        lm.init()
        prof = tprof.install(tprof.Profiler(sample_rate=1,
                                            metrics=MetricsRegistry()))
        try:
            eng = ServeEngine(lm, batch_buckets=(1, 2), aot_store=store)
            cb = ContinuousBatcher(lm, slots=2, capacity=16, seed=0,
                                   prefill_chunk=8, aot_store=store)
            try:
                eng.predict(np.zeros((1, 16), np.int32))
                cb.generate(np.arange(1, 6, dtype=np.int32), 3,
                            temperature=0.8)
            finally:
                eng.shutdown()
                cb.shutdown()
            snap = prof.snapshot()
        finally:
            tprof.uninstall()
        tags = {e["tag"]: e for e in snap["executables"]}
        assert set(tags) == {"engine_forward", "gen_prefill_chunk",
                             "gen_decode_paged", "gen_sample"}
        assert all(e["key"] and e["sampled"] == e["dispatches"]
                   for e in tags.values())
        assert tags["engine_forward"]["waste_ratio"] == pytest.approx(0.0)
        assert snap["padding"]["engine/1"]["dispatches"] == 1
        assert snap["padding"]["generate/8"]["live"] == 5  # the prompt
        assert snap["padding"]["generate/2"]["live"] == 2  # 2 ticks x 1
