"""The port's prebuilt-executable store (deeplearning4j_torch/aot) held
against the JAX package's, on the CPU.

- store: the same operations on both packages' ``AotStore`` give the same
  index (sizes, metadata, recency order), stats, GC victims, quarantine
  and typed errors (timestamps come from one fake clock for both);
- keys: every shaping component re-keys; leaf signatures of host arrays
  read as the reference's;
- manifest: ``manifest_hash``, the bucket tables and each serving tag's
  signature product equal the reference's enumeration over the committed
  compile budget; a manifest written by either package loads in the
  other; coverage records fail in the reference's layers, but for the
  store entries a record must find, which are its kernel libraries (a
  graph has no entry); the records' keys decide a lookup;
- tuned configs: a round trip gives the same knobs and the same
  ``gen_opts_from_config`` kwargs as the reference's;
- ``AotFunction``: a second boot on the same store counts zero compiles,
  a strict miss raises ``AotTraceError`` and captures nothing, every
  store failure is a counted fallback under the reference's label set,
  graphs are kept per params generation;
- publish warmers run before the flip; a failing one leaves the registry
  as it was (the reference's ``PublishError``);
- the kernel libraries' round trip through the store, and the CLI
  (``prebuild`` of a small serving config on the CPU, ``verify
  --manifest``, drift).

On the CPU the executable is the eager function; the CUDA graphs
themselves run in chip_smoke.py's ``[aot]`` phase on the card.
"""

import copy
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_torch import aot as taot
from deeplearning4j_torch.aot import manifest as tman
from deeplearning4j_torch.aot import store as tstore
from deeplearning4j_torch.aot.compile import AotFunction, graphable
from deeplearning4j_torch.obs.metrics import MetricsRegistry
from deeplearning4j_torch.serve import (AotTraceError, ModelRegistry,
                                        PublishError)
from deeplearning4j_tpu.analysis import enumerate as jenum
from deeplearning4j_tpu.aot import manifest as jman
from deeplearning4j_tpu.aot import store as jstore
from deeplearning4j_tpu.aot import tuned as jtuned

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 60  # every join in this file is bounded by this
CONFIG = json.loads((REPO / "scripts" / "serve_config.json").read_text())


def _key(i=0):
    return hashlib.sha256(f"entry-{i}".encode()).hexdigest()


def _series(metrics, name):
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in metrics.snapshot().get(name, {}).get("series", [])}


def _fallbacks(metrics):
    return {dict(k)["cause"]: v for k, v in
            _series(metrics, "serve_aot_fallback_total").items()}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _both(monkeypatch, tmp_path, ops, **kw):
    """``ops(store, corrupt_error)`` run on a port store, then on a
    reference store, each from the same fake clock (both modules share
    the one ``time`` module); returns the two results."""
    out = []
    for mod, name in ((tstore, "t"), (jstore, "j")):
        monkeypatch.setattr(mod.time, "time", _Clock())
        out.append(ops(mod.AotStore(tmp_path / name, **kw),
                       mod.AotCorruptEntry))
    return out


def _index(store):
    return {k: dict(v) for k, v in store.entries().items()}


def _stats(store):
    st = store.stats()
    st.pop("root")
    return st


# ----------------------------------------------------------------- store
class TestStoreParity:
    def test_put_get_index_stats(self, monkeypatch, tmp_path):
        def ops(s, _):
            puts = [s.put(_key(i), f"blob-{i}".encode() * (i + 1),
                          meta={"tag": f"t{i}", "arch": "a"} if i % 2
                          else None) for i in range(4)]
            gets = [s.get(_key(i)) for i in (2, 0, 5)]
            return puts, gets, _index(s), _stats(s), s.keys()

        t, j = _both(monkeypatch, tmp_path, ops)
        assert t == j

    @pytest.mark.parametrize("bound", [0, 60, 120, 10 ** 6])
    def test_lru_gc_same_victims(self, monkeypatch, tmp_path, bound):
        def ops(s, _):
            for i in range(5):
                s.put(_key(i), bytes(10 + i))
            s.get(_key(0))  # recency: 0 becomes the newest
            return s.gc(max_bytes=bound), _index(s), _stats(s)

        t, j = _both(monkeypatch, tmp_path, ops)
        assert t == j

    def test_write_time_eviction(self, monkeypatch, tmp_path):
        def ops(s, _):
            for i in range(6):
                s.put(_key(i), bytes(30))
            return s.keys(), _index(s), _stats(s)

        t, j = _both(monkeypatch, tmp_path, ops, max_bytes=150)
        assert t == j and len(t[0]) < 6

    @pytest.mark.parametrize("where", [0, 12, 45, -1])
    def test_quarantine_and_typed_errors(self, monkeypatch, tmp_path, where):
        def ops(s, corrupt):
            s.put(_key(), b"payload" * 50)
            s.put(_key(1), b"fine")
            path = s._entry_path(_key())
            raw = bytearray(open(path, "rb").read())
            raw[where] ^= 0x5A
            open(path, "wb").write(bytes(raw))
            with pytest.raises(corrupt):
                s.get(_key())
            return s.get(_key()), _stats(s), _index(s), s.verify()

        t, j = _both(monkeypatch, tmp_path, ops)
        assert t == j and t[1]["quarantined"] == 1

    def test_index_rebuilt_and_malformed_keys(self, monkeypatch, tmp_path):
        def ops(s, _):
            for i in range(3):
                s.put(_key(i), f"b{i}".encode())
            Path(s._index_path).write_text("{not json")
            rebuilt = sorted(_index(s))
            for bad in ("", "XYZ", "../etc"):
                with pytest.raises(ValueError, match="malformed"):
                    s.put(bad, b"x")
            return rebuilt, s.rebuild_index()

        t, j = _both(monkeypatch, tmp_path, ops)
        assert t == j and t[1] == 3

    def test_injected_read_fault_is_typed(self, tmp_path):
        from deeplearning4j_torch.chaos import faults

        s = tstore.AotStore(tmp_path)
        s.put(_key(), b"payload")
        plane = faults.install(faults.FaultPlane(seed=0))
        try:
            plane.inject_spec("aot.store_read:error:type=os,times=1")
            with pytest.raises(tstore.AotStoreError):
                s.get(_key())
            assert s.get(_key()) == b"payload"
            plane.inject_spec("aot.store_read:corrupt:times=1")
            with pytest.raises(tstore.AotCorruptEntry):
                s.get(_key())
            assert s.get(_key()) is None  # quarantined
        finally:
            faults.uninstall()


# ------------------------------------------------------------------ keys
class TestKeys:
    RT = {"torch": "2", "cuda": "12", "backend": "cuda",
          "kernels": "abc", "device_kind": "NVIDIA H100 80GB HBM3",
          "capability": "9.0", "device_count": 1}

    def test_deterministic_and_component_sensitive(self):
        base = taot.cache_key("decode", "abc", ("(4,):int32",),
                              runtime=self.RT)
        assert base == taot.cache_key("decode", "abc", ("(4,):int32",),
                                      runtime=self.RT)
        for other in (("prefill", "abc", ("(4,):int32",)),
                      ("decode", "xyz", ("(4,):int32",)),
                      ("decode", "abc", ("(8,):int32",))):
            assert taot.cache_key(*other, runtime=self.RT) != base

    @pytest.mark.parametrize("field,value", [
        ("torch", "9"), ("cuda", "13"), ("backend", "cpu"),
        ("kernels", "def"), ("device_kind", "NVIDIA A100"),
        ("capability", "8.0"), ("device_count", 4)])
    def test_runtime_skew_rekeys(self, field, value):
        sig = ("(2, 4):float32",)
        assert taot.cache_key("fwd", "a", sig, runtime=self.RT) != \
            taot.cache_key("fwd", "a", sig, runtime={**self.RT,
                                                     field: value})

    def test_runtime_fingerprint_on_cpu(self):
        rt = taot.runtime_fingerprint("cpu")
        assert rt["backend"] == "cpu" and rt["torch"] == torch.__version__
        assert rt == taot.runtime_fingerprint(torch.device("cpu"))
        assert len(rt["kernels"]) == 16

    def test_arch_fingerprint_shapes_not_values(self):
        p1 = {"a": torch.zeros(3, 4), "b": {"c": torch.ones(5,
                                                          dtype=torch.int32)}}
        p2 = {"a": torch.full((3, 4), 7.0),
              "b": {"c": torch.arange(5, dtype=torch.int32)}}
        assert taot.arch_fingerprint(p1) == taot.arch_fingerprint(p2)
        assert taot.arch_fingerprint(p1) != taot.arch_fingerprint(
            {"a": torch.zeros(3, 5), "b": p1["b"]})
        assert taot.arch_fingerprint(p1) != taot.arch_fingerprint(
            {"a": torch.zeros(3, 4, dtype=torch.float64), "b": p1["b"]})
        assert taot.arch_fingerprint(p1, {"s": torch.zeros(2)}) != \
            taot.arch_fingerprint(p1)
        assert taot.arch_fingerprint({"x": p1["a"], "y": p1["a"]}) != \
            taot.arch_fingerprint({"x": p1["a"], "z": p1["a"]})

    def test_leaf_signatures_read_as_the_reference(self):
        from deeplearning4j_tpu.aot import call_signature as jsig

        args = (np.zeros((2, 3), np.float32), np.zeros(4, np.int32), 7)
        t, j = taot.call_signature(args), jsig(args)
        assert t[:-1] == j[:-1]  # the leaves; the structure string differs
        assert taot.call_signature((torch.zeros(2, 3),
                                    torch.zeros(4, dtype=torch.int32),
                                    9)) == t
        assert taot.call_signature((torch.zeros(2, 4),)) != \
            taot.call_signature((torch.zeros(2, 3),))


# -------------------------------------------------------------- manifest
def _reference_manifest(config):
    """The reference's enumeration over the committed compile budget's
    bounds (as its compile-surface pass reports them)."""
    budget = json.loads((REPO / "scripts" / "compile_budget.json")
                        .read_text())
    report = {"sites": [{"site": s, "bound": e["bound"], "path": None,
                         "line": None}
                        for s, e in budget["sites"].items()]}
    return jenum.enumerate_surface(report, budget, config)


def _configs():
    dense = copy.deepcopy(CONFIG)
    dense["gen"]["kv"] = "dense"
    lengths = copy.deepcopy(CONFIG)
    lengths["engine"]["length_buckets"] = [1024, 256]
    lengths["gen"] = {"capacity": 1024, "prefill_chunk": 64, "slots": 8}
    whole = copy.deepcopy(CONFIG)
    whole["gen"]["prefill_chunk"] = None
    return {"committed": CONFIG, "dense": dense, "lengths": lengths,
            "whole_prompt": whole,
            "predict_only": {**CONFIG, "predict_only": True},
            "defaults": {"model": "causallm"}}


class TestManifestParity:
    @pytest.mark.parametrize("name", sorted(_configs()))
    def test_tables_and_signature_products(self, name):
        config = _configs()[name]
        assert tman.resolve_tables(config) == jenum.resolve_tables(config)
        t = tman.enumerate_config(config)
        j = _reference_manifest(config)
        assert {s["tag"]: (s["cardinality"], s["signatures"])
                for s in t["sites"]} == \
            {s["tag"]: (s["cardinality"], s["signatures"])
             for s in j["sites"]}
        assert t["total_signatures"] == j["total_signatures"]
        assert t["hash"] == tman.manifest_hash(t) == jenum.manifest_hash(t)
        assert j["hash"] == tman.manifest_hash(j)

    @pytest.mark.parametrize("capacity", [8, 12, 16, 64, 100, 256, 1000])
    def test_bucket_helpers(self, capacity):
        assert tman.default_prompt_buckets(capacity) == \
            jenum.default_prompt_buckets(capacity)
        b = tman.default_prompt_buckets(capacity)
        for chunk in (None, 8, 64):
            assert tman.chunk_buckets(b, chunk) == \
                jenum.chunk_buckets(b, chunk)

    def test_batcher_tables_match_the_booted_batcher(self):
        from deeplearning4j_torch.models import CausalLM
        from deeplearning4j_torch.serve import ContinuousBatcher

        lm = CausalLM(seed=0, input_shape=(16,), num_layers=1, d_model=16,
                      num_heads=2, vocab=50, device="cpu").build()
        lm.init()
        cb = ContinuousBatcher(lm, slots=2, capacity=16, block_size=16,
                               prefill_chunk=8, seed=0)
        try:
            tables = tman.resolve_tables(CONFIG)
            assert tables["prompt_buckets"] == list(cb.prompt_buckets)
            assert tables["_chunk_buckets"] == list(cb.chunk_buckets)
        finally:
            cb.shutdown()

    def test_manifests_load_across_packages(self, tmp_path):
        t = tman.enumerate_config(CONFIG)
        j = _reference_manifest(CONFIG)
        tman.write_manifest(t, str(tmp_path / "t.json"))
        jenum.write_manifest(j, str(tmp_path / "j.json"))
        assert jman.load_manifest(str(tmp_path / "t.json")) == t
        assert tman.load_manifest(str(tmp_path / "j.json")) == j
        edited = json.loads((tmp_path / "t.json").read_text())
        edited["sites"][0]["cardinality"] += 1
        (tmp_path / "t.json").write_text(json.dumps(edited))
        for load in (tman.load_manifest, jman.load_manifest):
            with pytest.raises(ValueError, match="hash mismatch"):
                load(str(tmp_path / "t.json"))

    def test_coverage_layers_match_the_reference(self, tmp_path):
        manifest = {"hash": "deadbeefdeadbeef",
                    "sites": [{"site": "pkg.m:fn", "tag": "t",
                               "cardinality": 2, "signatures": []}],
                    "total_signatures": 2}
        rt = {"torch": "1", "backend": "cpu"}
        got = {}
        for name, mod, smod in (("t", tman, tstore), ("j", jman, jstore)):
            store = smod.AotStore(tmp_path / name)
            layers = [mod.missing_signatures(store, manifest, rt)]
            k1, k2 = _key(1), _key(2)
            store.put(k1, b"1")
            store.put(k2, b"2")
            mod.record_coverage(store, manifest, {"t": [k1, k2]}, runtime=rt)
            layers.append(mod.missing_signatures(store, manifest, rt))
            layers.append(mod.load_coverage(store, manifest, rt)
                          ["total_keys"])
            mod.record_coverage(store, manifest, {"t": [k1]}, runtime=rt)
            layers.append(mod.missing_signatures(store, manifest, rt))
            mod.record_coverage(store, manifest, {}, runtime=rt)
            layers.append(mod.missing_signatures(store, manifest, rt))
            layers.append(mod.missing_signatures(
                store, manifest, {**rt, "torch": "2"}))
            layers.append(Path(mod.coverage_path(store, manifest,
                                                 rt)).name)
            got[name] = layers
        t, j = got["t"], got["j"]
        # the "no record" lines name each package's prebuild command
        assert "no coverage record" in t[0][0] and "no coverage record" \
            in j[0][0] and "no coverage record" in t[5][0]
        assert t[1:5] + t[6:] == j[1:5] + j[6:]

    def test_covered_keys_and_kernel_entries(self, tmp_path):
        """The port's own layers: a graph has no store entry, so the keys
        a record names decide a lookup (every record of this runtime, the
        record of captures too; an unreadable one counted), and the
        entries a record must find in the store are its kernel
        libraries'."""
        manifest = {"hash": "deadbeefdeadbeef",
                    "sites": [{"site": "pkg.m:fn", "tag": "t",
                               "cardinality": 1, "signatures": []}],
                    "total_signatures": 1}
        rt = {"torch": "1", "backend": "cuda"}
        store = tstore.AotStore(tmp_path)
        assert tman.covered_keys(store, rt) == (frozenset(), 0)
        libs = {"flash_fwd": _key(1), "bn_bwd": _key(2)}
        for k in libs.values():
            store.put(k, b"ELF")
        tman.record_coverage(store, manifest, {"t": [_key(3)]}, runtime=rt,
                             extra={"kernels": libs})
        tman.stamp_captured(store, "u", _key(4), rt)
        tman.stamp_captured(store, "u", _key(5), rt)
        tman.stamp_captured(store, "u", _key(4), {**rt, "torch": "2"})
        assert tman.covered_keys(store, rt) == (
            frozenset({_key(3), _key(4), _key(5)}), 0)
        assert tman.covered_keys(store, {**rt, "torch": "2"}) == (
            frozenset({_key(4)}), 0)
        assert tman.missing_signatures(store, manifest, rt) == []
        Path(store._entry_path(libs["bn_bwd"])).unlink()
        assert tman.missing_signatures(store, manifest, rt) == [
            f"kernel library bn_bwd: store entry {libs['bn_bwd'][:16]}… "
            "is gone"]
        Path(tman.coverage_path(store, {"hash": tman.CAPTURED}, rt)
             ).write_text("{not json")
        assert tman.covered_keys(store, rt) == (frozenset({_key(3)}), 1)
        tman.stamp_captured(store, "u", _key(6), rt)  # starts over
        assert tman.covered_keys(store, rt) == (
            frozenset({_key(3), _key(6)}), 0)


# ----------------------------------------------------------------- tuned
class TestTunedParity:
    CFG = {"engine": {"batch_buckets": [1, 4], "max_wait_ms": 3.0,
                      "bogus": 1},
           "gen": {"slots": 8, "capacity": 512, "prefill_chunk": 32,
                   "decode_chunks": 2, "unknown": "x"},
           "autoscale": {"target": 0.7}}

    def test_roundtrip_same_knobs(self, tmp_path):
        from deeplearning4j_torch.serve.continuous import \
            gen_opts_from_config as tgen
        from deeplearning4j_torch.serve.engine import ENGINE_KNOBS as tk
        from deeplearning4j_tpu.serve.continuous import \
            gen_opts_from_config as jgen
        from deeplearning4j_tpu.serve.engine import ENGINE_KNOBS as jk

        assert tk == jk
        ts = tstore.AotStore(tmp_path / "t")
        js = jstore.AotStore(tmp_path / "j")
        mt, mj = MetricsRegistry(), MetricsRegistry()
        assert taot.put_tuned(ts, "wl", self.CFG) is not None
        assert jtuned.put_tuned(js, "wl", self.CFG) is not None
        tc = taot.get_tuned(ts, "wl", metrics=mt)
        jc = jtuned.get_tuned(js, "wl", metrics=mj)
        assert tc == jc == self.CFG
        assert ts.get(taot.tuned_key("wl")) == js.get(jtuned.tuned_key("wl"))
        for group in ("engine", "gen", "autoscale", "missing"):
            assert taot.tuned_group(tc, group) == jtuned.tuned_group(jc,
                                                                    group)
        t_opts, j_opts = tgen(tc), jgen(jc)
        ts_, js_ = t_opts.pop("scheduler"), j_opts.pop("scheduler")
        assert t_opts == j_opts
        assert (ts_.decode_chunks, ts_.idle_chunks) == \
            (js_.decode_chunks, js_.idle_chunks)
        assert tgen(None) == jgen(None) == {}
        for missing in ("other",):
            assert taot.get_tuned(ts, missing, metrics=mt) is None
        assert taot.get_tuned(None, "wl", metrics=mt) is None
        assert mt.counter("sim_tuned_config_hits_total").value == 1
        assert mt.counter("sim_tuned_config_misses_total").value == 2

    def test_corrupt_or_malformed_is_a_miss(self, tmp_path):
        ts = tstore.AotStore(tmp_path)
        ts.put(taot.tuned_key("a"), b"[1, 2]")
        ts.put(taot.tuned_key("b"), b"\xff\xfe")
        assert taot.get_tuned(ts, "a") is None
        assert taot.get_tuned(ts, "b") is None
        assert taot.tuned_group("nope", "gen") == {}

    def test_from_tuned_boots_the_stored_knobs(self, tmp_path):
        from deeplearning4j_torch.models import CausalLM
        from deeplearning4j_torch.serve import ContinuousBatcher, ServeEngine

        ts = tstore.AotStore(tmp_path)
        taot.put_tuned(ts, "wl", {"engine": {"batch_buckets": [2, 3]},
                                  "gen": {"slots": 3, "capacity": 16,
                                          "prefill_chunk": 8}})
        lm = CausalLM(seed=0, input_shape=(16,), num_layers=1, d_model=16,
                      num_heads=2, vocab=50, device="cpu").build()
        lm.init()
        eng = ServeEngine.from_tuned(lm, ts, "wl", queue_limit=7)
        cb = ContinuousBatcher.from_tuned(lm, ts, "wl", seed=0)
        try:
            assert eng.batch_buckets == (2, 3) and eng.queue_limit == 7
            assert cb.slots == 3 and cb.chunk_buckets == (8,)
            assert eng.aot_functions() and cb.aot_functions()
        finally:
            eng.shutdown()
            cb.shutdown()


# ----------------------------------------------------------- AotFunction
@graphable
def _affine(weights, x):
    return x @ weights["w"] + weights["b"]


_W = {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3),
      "b": torch.ones(3)}


def _fn(store, metrics=None, strict=False, counter=None):
    return AotFunction(_affine, tag="affine", store=store, metrics=metrics,
                       arch="arch0", component="engine", strict=strict,
                       compile_counter=counter)


class TestAotFunction:
    def test_second_boot_zero_compiles(self, tmp_path):
        store = tstore.AotStore(tmp_path)
        m1 = MetricsRegistry()
        c1 = m1.counter("serve_compile_misses_total")
        f1 = _fn(store, m1, counter=c1)
        x = torch.ones(2, 4)
        assert f1.warm(1, _W, x) is True
        assert torch.equal(f1(1, _W, x), _affine(_W, x))
        assert c1.value == 1 and f1.captures == 1 and f1.call_captures == 0
        keys = f1.warmed_keys()
        assert len(keys) == 1 and f1.store_key(taot.call_signature(
            (x,))) == keys[0]
        # a second process: a fresh wrapper on the same store
        m2 = MetricsRegistry()
        c2 = m2.counter("serve_compile_misses_total")
        f2 = _fn(store, m2, strict=True, counter=c2)
        f2.warm(1, _W, torch.zeros(2, 4))
        assert c2.value == 0
        assert _series(m2, "serve_aot_hits_total") == {
            (("component", "engine"),): 1.0}
        assert torch.equal(f2(1, _W, x), _affine(_W, x))
        assert f2.warmed_keys() == keys and f2.acquire_seconds >= 0.0

    def test_strict_miss_is_typed_and_captures_nothing(self, tmp_path):
        store = tstore.AotStore(tmp_path)
        m = MetricsRegistry()
        c = m.counter("serve_compile_misses_total")
        f = _fn(store, m, strict=True, counter=c)
        with pytest.raises(AotTraceError, match="strict AOT") as ei:
            f(1, _W, torch.ones(5, 4))
        assert ei.value.http_status == 503 and ei.value.cause == "aot_trace"
        assert c.value == 0 and f.captures == 0 and not f.executables
        assert store.stats()["entries"] == 0
        assert _series(m, "serve_aot_strict_misses_total") == {
            (("component", "engine"),): 1.0}

    @pytest.mark.parametrize("damage", [
        "garbage", "schema", "tags", "write"])
    def test_store_failures_fall_back_counted(self, tmp_path, monkeypatch,
                                              damage):
        """An unreadable record of captures is a counted fallback
        (``corrupt``) and the signature is captured again and stamped
        anew; a stamp that cannot be written counts ``store_write``."""
        store = tstore.AotStore(tmp_path)
        x = torch.ones(2, 4)
        _fn(store).warm(1, _W, x)
        (path,) = (tmp_path / "coverage").glob("*-captured.json")
        rec = json.loads(path.read_text())
        if damage == "write":
            from deeplearning4j_torch.aot import compile as tcomp

            path.unlink()

            def refuse(*a):
                raise OSError("read-only store")

            monkeypatch.setattr(tcomp, "stamp_captured", refuse)
        else:
            path.write_bytes({
                "garbage": b"\x80not json",
                "schema": json.dumps({**rec, "schema": 99}).encode(),
                "tags": json.dumps({**rec, "tags": ["t"]}).encode(),
            }[damage])
        m = MetricsRegistry()
        c = m.counter("serve_compile_misses_total")
        f2 = _fn(store, m, counter=c)
        assert torch.equal(f2(1, _W, x), _affine(_W, x))
        cause = "store_write" if damage == "write" else "corrupt"
        assert _fallbacks(m) == {cause: 1.0}
        assert c.value == 1  # captured again
        if damage == "write":
            assert not path.exists()
            with pytest.raises(AotTraceError):
                _fn(store, strict=True).warm(1, _W, x)
        else:  # stamped anew for next time
            assert _fn(store, strict=True).warm(1, _W, x)

    def test_strict_fallback_is_a_refusal(self, tmp_path):
        store = tstore.AotStore(tmp_path)
        _fn(store).warm(1, _W, torch.ones(2, 4))
        (path,) = (tmp_path / "coverage").glob("*-captured.json")
        path.write_bytes(b"\x80")
        m = MetricsRegistry()
        with pytest.raises(AotTraceError):
            _fn(store, m, strict=True)(1, _W, torch.ones(2, 4))
        assert _fallbacks(m) == {"corrupt": 1.0}

    def test_plain_callable_passes_through(self, tmp_path):
        f = AotFunction(lambda w, x: x * 2, tag="plain",
                        store=tstore.AotStore(tmp_path))
        assert f.store is None and f.warm(1, None, torch.ones(1)) is False
        assert torch.equal(f(1, None, torch.ones(2)), torch.full((2,), 2.0))
        with pytest.raises(ValueError, match="strict mode requires"):
            AotFunction(lambda w, x: x, tag="plain", strict=True,
                        store=tstore.AotStore(tmp_path))

    def test_graphs_per_generation(self, tmp_path):
        f = _fn(tstore.AotStore(tmp_path))
        x = torch.ones(1, 4)
        w2 = {"w": _W["w"] * 2, "b": _W["b"]}
        f.warm(1, _W, x)
        f.warm(2, w2, x)  # a publish candidate, before the flip
        assert f.generations() == [1, 2]
        assert torch.equal(f(1, _W, x), _affine(_W, x))
        assert f.generations() == [1, 2]
        # the first call on generation 2 retires generation 1
        assert torch.equal(f(2, w2, x), _affine(w2, x))
        assert f.generations() == [2] and f.call_captures == 0
        assert f.captures == 2 and len(f.warmed_keys()) == 1
        assert f.pool_bytes() == 0  # no graph on the CPU
        f.release()
        assert f.generations() == [] and f.executables == {}

    def test_concurrent_calls_and_warms_capture_each_signature_once(
            self, tmp_path):
        """More threads than cores calling and warming one wrapper over
        three signatures and two generations, with a short switch
        interval: each (signature, generation) is captured once, every
        answer is right, and the record of captures names each
        signature's key."""
        import sys
        import threading

        m = MetricsRegistry()
        c = m.counter("serve_compile_misses_total")
        f = _fn(tstore.AotStore(tmp_path), m, counter=c)
        ws = {1: _W, 2: {"w": _W["w"] * 3, "b": _W["b"]}}
        errors, old = [], sys.getswitchinterval()

        def work(i):
            try:
                for k in range(30):
                    gen, rows = 1 + (k % 2 if i % 3 else 0), 1 + (i + k) % 3
                    x = torch.full((rows, 4), float(i))
                    if k % 5 == 0:
                        f.warm(gen, ws[gen], x)
                        continue
                    got = f(gen, ws[gen], x).clone()
                    if not torch.equal(got, _affine(ws[gen], x)):
                        errors.append((i, k))
            except Exception as e:  # reported below
                errors.append(repr(e))

        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT_S)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads) and not errors
        # one store miss a signature: a lost update would capture (and
        # count) a signature twice; later generations hit its key
        assert c.value == 3 and len(f.warmed_keys()) == 3
        assert _series(m, "serve_aot_misses_total") == {
            (("component", "engine"),): 3.0}
        covered, unreadable = tman.covered_keys(
            tstore.AotStore(tmp_path), taot.runtime_fingerprint("cpu"))
        assert covered == set(f.warmed_keys()) and unreadable == 0

    def test_unwarmed_signature_counts_a_call_capture(self, tmp_path):
        store = tstore.AotStore(tmp_path)
        _fn(store).warm(1, _W, torch.ones(3, 4))
        f = _fn(store, strict=True)
        f(1, _W, torch.ones(3, 4))  # recorded: captured on the call
        assert f.call_captures == 1 and f.captures == 1


# ------------------------------------------------------ publish warming
class TestPublishWarming:
    def test_failed_publish_leaves_registry_intact(self):
        params = {"w": torch.ones(2, 2)}
        reg = ModelRegistry(params, {})
        warmed = []
        reg.add_warmer(lambda snap: warmed.append(
            (snap.generation, float(snap.params["w"].sum()))))
        reg.add_warmer(lambda snap: (_ for _ in ()).throw(
            RuntimeError("candidate cannot capture")))
        before = reg.history()
        with pytest.raises(PublishError, match="old generation keeps"):
            reg.publish({"w": torch.full((2, 2), 5.0)})
        assert reg.history() == before and reg.generation == 1
        assert not reg.inflight() and warmed == [(2, 20.0)]
        with reg.lease() as snap:
            assert float(snap.params["w"].sum()) == 4.0
        # the reference, the same publish
        from deeplearning4j_tpu.serve import ModelRegistry as JRegistry
        from deeplearning4j_tpu.serve import PublishError as JPublishError

        jreg = JRegistry({"w": np.ones((2, 2), np.float32)}, {})
        jreg.add_warmer(lambda p, s: (_ for _ in ()).throw(
            RuntimeError("candidate cannot compile")))
        with pytest.raises(JPublishError):
            jreg.publish({"w": np.zeros((2, 2), np.float32)})
        assert jreg.history() == [(1, "v0")] == before

    def test_warmers_run_before_flip(self):
        reg = ModelRegistry({"w": torch.ones(3)}, {})
        seen = []
        reg.add_warmer(lambda snap: seen.append(
            (reg.generation, snap.generation, snap.version)))
        snap = reg.publish({"w": torch.zeros(3)}, version="next")
        assert snap.generation == 2 and seen == [(1, 2, "next")]
        reg.rollback()
        assert seen[-1] == (2, 3, "v0")


# ------------------------------------------------------ kernel libraries
class TestKernelLibraries:
    RT = {"torch": "2", "cuda": "12", "backend": "cuda", "kernels": "k",
          "device_kind": "NVIDIA H100 80GB HBM3", "capability": "9.0",
          "device_count": 1}

    def test_roundtrip_through_the_store(self, tmp_path, monkeypatch):
        from deeplearning4j_torch.aot import compile as tcomp
        from deeplearning4j_torch.kernels import _build

        build = tmp_path / "build"
        build.mkdir()
        monkeypatch.setattr(_build, "BUILD_DIR", build)
        libs = {n: _build.library_path(n) for n in _build.KERNELS}
        for n, p in libs.items():
            p.write_bytes(f"ELF {n}".encode() * 10)
        store = tstore.AotStore(tmp_path / "store")
        saved = tcomp.save_kernels(store, self.RT)
        assert sorted(saved) == sorted(_build.KERNELS)
        for p in libs.values():
            p.unlink()
        installed, missing = tcomp.install_kernels(store, self.RT)
        assert sorted(installed) == sorted(_build.KERNELS) and not missing
        for n, p in libs.items():
            assert p.read_bytes() == f"ELF {n}".encode() * 10
        assert tcomp.install_kernels(store, self.RT) == ([], [])
        # another runtime finds nothing: a clean miss, listed
        for p in libs.values():
            p.unlink()
        other = {**self.RT, "device_kind": "NVIDIA A100"}
        assert tcomp.install_kernels(store, other) == (
            [], list(_build.KERNELS))
        # the CPU builds and installs nothing
        assert tcomp.save_kernels(store, {"backend": "cpu"}) == {}
        assert tcomp.install_kernels(store, {"backend": "cpu"}) == ([], [])
        tcomp.boot_kernels(store, "cpu", strict=True)  # no card: no-op


# -------------------------------------------------------------- the CLI
def _cli(*argv):
    from deeplearning4j_torch.aot.__main__ import main

    return main(list(argv))


_SMALL = {"model": "causallm", "seed": 0, "dtype": "int32",
          "model_kwargs": {"input_shape": [16], "num_layers": 1,
                           "d_model": 16, "num_heads": 2, "vocab": 50},
          "engine": {"batch_buckets": [1, 2]},
          "gen": {"slots": 2, "capacity": 16, "kv": "paged",
                  "block_size": 16, "prefill_chunk": 8, "seed": 0}}


class TestCli:
    def test_list_stats_verify_gc(self, tmp_path, capsys):
        store = tstore.AotStore(tmp_path)
        for i in range(3):
            store.put(_key(i), bytes(150), meta={"tag": f"t{i}", "arch": "a"})
        root = str(tmp_path)
        assert _cli("--store", root, "list") == 0
        assert "3 entries" in capsys.readouterr().out
        assert _cli("--store", root, "stats") == 0
        assert '"entries": 3' in capsys.readouterr().out
        assert _cli("--store", root, "verify") == 0
        assert _cli("--store", root, "rebuild-index") == 0
        capsys.readouterr()
        assert _cli("--store", root, "gc", "--max-bytes", "200") == 0
        assert "evicted 2" in capsys.readouterr().out
        with open(store._entry_path(store.keys()[0]), "r+b") as f:
            f.seek(41)
            f.write(b"\xff")
        assert _cli("--store", root, "verify") == 1

    def test_prebuild_then_strict_boot(self, tmp_path, capsys):
        cfg = tmp_path / "serve.json"
        cfg.write_text(json.dumps(_SMALL))
        root, man = str(tmp_path / "store"), str(tmp_path / "m.json")
        assert _cli("--store", root, "--device", "cpu", "prebuild",
                    "--config", str(cfg), "--manifest-out", man) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["sites"] == {"engine_forward": 2, "gen_sample": 1,
                                   "gen_decode_paged": 1,
                                   "gen_prefill_chunk": 1}
        assert report["drift"] == [] and report["kernels"] == []
        assert _cli("--store", root, "--device", "cpu", "verify",
                    "--manifest", man) == 0
        assert "fully covered (5 signature(s))" in capsys.readouterr().out
        # a strict server boots from it with zero compiles
        from deeplearning4j_torch.aot.__main__ import serving_model
        from deeplearning4j_torch.serve import ModelServer

        model = serving_model(_SMALL, "cpu")
        m = MetricsRegistry()
        srv = ModelServer(model, port=0, batch_buckets=(1, 2),
                          input_dtype=np.int32, gen_slots=2,
                          gen_capacity=16, gen_prefill_chunk=8,
                          metrics=m, aot_store=tstore.AotStore(root),
                          strict_aot=True, aot_manifest=man)
        try:
            assert sum(_series(m, "serve_compile_misses_total").values()) \
                == 0
            assert sum(_series(m, "serve_aot_hits_total").values()) == 5
        finally:
            srv.stop()
        # the coverage record gone: verify fails, and so does the strict
        # boot (the record of captures does not stand in for it)
        Path(tman.coverage_path(
            tstore.AotStore(root), tman.load_manifest(man),
            taot.runtime_fingerprint("cpu"))).unlink()
        assert _cli("--store", root, "--device", "cpu", "verify",
                    "--manifest", man) == 1
        assert "no coverage record" in capsys.readouterr().out
        with pytest.raises(AotTraceError, match="1 obligation"):
            ModelServer(model, port=0, batch_buckets=(1, 2),
                        aot_store=tstore.AotStore(root), strict_aot=True,
                        aot_manifest=man)

    def test_prebuild_drift_exits_1(self, tmp_path, capsys):
        manifest = tman.enumerate_config(_SMALL)
        manifest["sites"][0]["cardinality"] += 1  # the stacks disagree
        manifest["hash"] = tman.manifest_hash(manifest)
        man = tmp_path / "m.json"
        tman.write_manifest(manifest, str(man))
        assert _cli("--store", str(tmp_path / "s"), "--device", "cpu",
                    "prebuild", "--manifest", str(man)) == 1
        assert "surface drift" in capsys.readouterr().err
        # the stacks' captures are stamped; no coverage record is
        assert [p.name.endswith("-captured.json") for p in
                (tmp_path / "s" / "coverage").iterdir()] == [True]

    def test_prebuild_needs_a_config(self, tmp_path, capsys):
        assert _cli("--store", str(tmp_path), "prebuild") == 2
        assert "--config" in capsys.readouterr().err


def test_modules_import_neither_jax_nor_the_reference():
    import ast

    root = REPO / "deeplearning4j_torch"
    for path in list((root / "aot").glob("*.py")) + [
            root / "obs" / "profile.py", root / "obs" / "costmodel.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert not n.startswith(("jax", "deeplearning4j_tpu")), \
                    f"{path.name} imports {n}"
