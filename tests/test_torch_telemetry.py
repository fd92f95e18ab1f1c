"""Training-step telemetry of the port held against the JAX package's:
``obs.StepTelemetry`` under ``Trainer.fit(telemetry=)``,
``obs.TelemetryListener``, ``train.ProfilerListener`` and ``PhaseTimer``.

A small f32 MLP (two Dense layers on 20 features, a 10-way softmax
output) trains on numpy data from a fixed seed, its params carried from
the reference with ``params_from_numpy``. What must be equal: the losses with and
without telemetry, bit for bit (telemetry only times the step); the
metric families, their types, help strings and label sets, the step,
sample and compile-miss counts, the histograms' observation counts, the
snapshot's keys and the trace's event sequence, against the reference's
fit on the same data; the losses against the reference's at 1e-5
(f32 reordering). Timings differ by nature and are not compared. A fit
without telemetry must make no call into ``obs``, and telemetry must take
the single-step path under ``steps_per_execution``.
"""

import json
import os

import numpy as np
import pytest

from deeplearning4j_torch.data.iterators import ArrayIterator
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.obs import metrics as tmetrics
from deeplearning4j_torch.obs import trace as ttrace
from deeplearning4j_torch.obs.listener import TelemetryListener
from deeplearning4j_torch.obs.step import StepTelemetry
from deeplearning4j_torch.train import (CollectScoresListener, PhaseTimer,
                                        ProfilerListener, Trainer,
                                        params_from_numpy)
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.obs.listener import \
    TelemetryListener as JTelemetryListener
from deeplearning4j_tpu.obs.step import StepTelemetry as JStepTelemetry
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.profiler import PhaseTimer as JPhaseTimer
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

F32_TOL = 1e-5
UPDATER = {"type": "adam", "learning_rate": 1e-2}
N, B = 40, 8  # five batches an epoch


def _layers(L):
    return [L.Dense(n_out=32, activation="relu"),
            L.Dense(n_out=16, activation="tanh"),
            L.Output(n_out=10, activation="softmax", loss="mcxent")]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax_model(params):
    """The reference's net with its own copy of ``params`` (its trainer
    donates them)."""
    import jax

    jm = JSequential(JNetConfig(seed=0, updater=dict(UPDATER)), _layers(JL),
                     (20,))
    jm.params = jax.tree.map(lambda a: jax.numpy.array(a), params)
    jm.state = {}
    return jm


@pytest.fixture(scope="module")
def ref_model():
    """The reference's initial params, as numpy."""
    jm = JSequential(JNetConfig(seed=0, updater=dict(UPDATER)), _layers(JL),
                     (20,))
    jm.init()
    return _np_tree(jm.params)


def _port_model(ref):
    tm = Sequential(NetConfig(seed=0, updater=dict(UPDATER)), _layers(TL),
                    (20,), device="cpu")
    tm.params = params_from_numpy(tm, ref)
    tm.state = {}
    return tm


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 20)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _port_fit(ref, epochs=1, spe=1, **fit_kw):
    x, y = _data()
    tr = Trainer(_port_model(ref))
    c = CollectScoresListener()
    listeners = [c] + list(fit_kw.pop("listeners", ()))
    tr.fit(ArrayIterator(x, y, batch_size=B), epochs=epochs, prefetch=False,
           listeners=listeners, steps_per_execution=spe, **fit_kw)
    return tr, [l for _, l in c.scores]


def _norm_registry(snap):
    """Families with type, help, label sets, and the counts (histogram
    observations, counter values); gauge values and sums are timings or
    memory, which differ by nature."""
    out = {}
    for name, fam in snap.items():
        series = []
        for s in fam["series"]:
            row = {"labels": s["labels"]}
            if fam["type"] == "histogram":
                row["count"] = s["count"]
            elif fam["type"] == "counter":
                row["value"] = s["value"]
            series.append(row)
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "series": sorted(series, key=json.dumps)}
    return out


def _event_names(tracer):
    return [(e["name"], e["ph"], e.get("args", {}).get("kind"))
            for e in tracer.events if e["ph"] != "M"]


@pytest.fixture(scope="module")
def telemetered(ref_model):
    """Two epochs with telemetry in each package, and the port's
    losses without it."""
    x, y = _data()
    jtel = JStepTelemetry()
    jc = JCollectScoresListener()
    JTrainer(_jax_model(ref_model)).fit(
        JArrayIterator(x, y, batch_size=B), epochs=2, prefetch=False,
        listeners=[jc], telemetry=jtel)
    ttel = StepTelemetry()
    tr, losses = _port_fit(ref_model, epochs=2, telemetry=ttel)
    _, plain = _port_fit(ref_model, epochs=2)
    return dict(jtel=jtel, jlosses=[l for _, l in jc.scores], ttel=ttel,
                tlosses=losses, plain=plain, trainer=tr)


def test_losses_bit_equal_with_and_without_telemetry(telemetered):
    assert telemetered["tlosses"] == telemetered["plain"]
    assert len(telemetered["plain"]) == 2 * N // B


def test_telemetered_losses_match_reference(telemetered):
    np.testing.assert_allclose(telemetered["tlosses"], telemetered["jlosses"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_metric_families_and_counts_equal_reference(telemetered):
    want = _norm_registry(telemetered["jtel"].registry.snapshot())
    got = _norm_registry(telemetered["ttel"].registry.snapshot())
    assert got == want
    assert got["train_steps_total"]["series"][0]["value"] == 10
    assert got["compile_cache_misses_total"]["series"][0]["value"] == 1
    for fam in ("train_step_seconds", "train_dispatch_seconds",
                "train_device_compute_seconds", "train_data_wait_seconds"):
        assert got[fam]["series"][0]["count"] == 10, fam


def test_snapshot_keys_and_counts_equal_reference(telemetered):
    want, got = telemetered["jtel"].snapshot(), telemetered["ttel"].snapshot()
    assert sorted(got) == sorted(want)
    for k in ("steps", "compile_cache_misses"):
        assert got[k] == want[k], k
    assert got["steps_per_sec"] > 0 and got["p50_step_seconds"] > 0


def test_trace_events_equal_reference(telemetered):
    assert (_event_names(telemetered["ttel"].tracer)
            == _event_names(telemetered["jtel"].tracer))
    chrome = json.loads(telemetered["ttel"].export_trace())
    assert chrome["traceEvents"]


def test_prometheus_text_passes_promcheck(telemetered):
    from deeplearning4j_torch.obs.promcheck import check_text

    text = telemetered["ttel"].to_prometheus()
    assert "train_steps_total 10" in text
    assert check_text(text) == []


def test_memory_gauge_falls_back_to_host_rss(telemetered):
    snap = telemetered["ttel"].registry.snapshot()
    series = snap["device_memory_bytes"]["series"]
    assert [s["labels"] for s in series] == [{"device": "host",
                                              "kind": "rss"}]
    assert series[0]["value"] > 0


def test_telemetry_takes_the_single_step_path(ref_model, monkeypatch):
    """Under steps_per_execution > 1, telemetry turns the window off (each
    step timed alone) with the same losses; without telemetry the window
    runs."""
    windows = []
    orig = Trainer._exec_window

    def spy(self, *a, **kw):
        windows.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(Trainer, "_exec_window", spy)
    tel = StepTelemetry()
    tr, losses = _port_fit(ref_model, spe=2, telemetry=tel)
    assert windows == [] and tr.windows == 0
    assert tel.snapshot()["steps"] == N // B
    tr2, plain = _port_fit(ref_model, spe=2)
    assert len(windows) == tr2.windows == 2
    np.testing.assert_allclose(losses, plain, rtol=F32_TOL, atol=F32_TOL)


def test_fit_without_telemetry_makes_no_obs_call(ref_model, monkeypatch):
    """Every method of the registry, its metrics, the tracer and
    StepTelemetry is patched to count calls; a plain fit (and one with
    steps_per_execution) makes none."""
    calls = []
    for cls in (tmetrics.MetricsRegistry, tmetrics.Counter, tmetrics.Gauge,
                tmetrics.Histogram, ttrace.Tracer, StepTelemetry):
        for name, fn in list(vars(cls).items()):
            if callable(fn) and not isinstance(fn, type):
                def counted(*a, _fn=fn, _name=f"{cls.__name__}.{name}",
                            **kw):
                    calls.append(_name)
                    return _fn(*a, **kw)
                monkeypatch.setattr(cls, name, counted)
    _port_fit(ref_model)
    _port_fit(ref_model, spe=2)
    assert calls == []


def test_training_modules_import_no_obs():
    """The trainer's side never imports ``obs`` (telemetry is duck-typed),
    so a fit without telemetry cannot reach it: no import statement in
    ``deeplearning4j_torch/train/`` names it, lazy ones included."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    for path in sorted((root / "deeplearning4j_torch" / "train").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                assert "obs" not in mod.split("."), f"{path.name}: {mod}"
            elif isinstance(node, ast.Import):
                assert not any(".obs" in a.name for a in node.names), \
                    path.name


def test_telemetry_listener_is_adopted_and_publishes(ref_model):
    """fit adopts the listener's telemetry; the storage gets the
    reference's static record and one update every ``frequency``
    iterations, with the reference's keys."""
    class Storage:
        def __init__(self):
            self.static, self.updates = [], []

        def put_static_info(self, session, type_id, worker, record):
            self.static.append((session, type_id, worker, record))

        def put_update(self, session, type_id, worker, t, record):
            self.updates.append((session, type_id, worker, record))

    x, y = _data()
    got, want = Storage(), Storage()
    tl = TelemetryListener(got, session_id="s", frequency=2)
    _port_fit(ref_model, listeners=[tl])
    jl = JTelemetryListener(want, session_id="s", frequency=2)
    JTrainer(_jax_model(ref_model)).fit(JArrayIterator(x, y, batch_size=B),
                                        prefetch=False, listeners=[jl])
    assert tl.telemetry.snapshot()["steps"] == N // B
    assert len(got.static) == len(want.static) == 1
    (s, t, w, rec), (s2, t2, w2, rec2) = got.static[0], want.static[0]
    assert (s, t, w) == (s2, t2, w2)
    assert sorted(rec) == sorted(rec2)
    assert rec["metrics"] == rec2["metrics"]
    assert ([u[3]["iteration"] for u in got.updates]
            == [u[3]["iteration"] for u in want.updates] == [0, 2, 4])
    for u, v in zip(got.updates, want.updates):
        assert sorted(u[3]) == sorted(v[3])
        assert sorted(u[3]["telemetry"]) == sorted(v[3]["telemetry"])
        assert _norm_registry(u[3]["metrics"]).keys() == \
            _norm_registry(v[3]["metrics"]).keys()


def test_tbptt_batches_are_timed_as_tbptt():
    """A recurrent net under tBPTT: each batch is one ``kind=tbptt`` step,
    and the losses are those of the fit without telemetry."""
    def net():
        m = Sequential(NetConfig(seed=0, tbptt_length=4),
                       [TL.LSTM(n_out=6),
                        TL.RnnOutput(n_out=3, activation="softmax",
                                     loss="mcxent")], (10, 5), device="cpu")
        m.init(seed=1)
        return m

    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 10, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 10))]
    out = []
    for tel in (StepTelemetry(), None):
        c = CollectScoresListener()
        Trainer(net()).fit(ArrayIterator(x, y, batch_size=4), prefetch=False,
                           listeners=[c], telemetry=tel)
        out.append([l for _, l in c.scores])
        if tel is not None:
            kinds = {e["args"].get("kind") for e in tel.tracer.events
                     if e["name"] == "train_step"}
            assert kinds == {"tbptt"}
            assert tel.snapshot()["steps"] == 2
    assert out[0] == out[1]


def test_parallel_step_names_its_queue_item():
    with pytest.raises(NotImplementedError, match="item 14"):
        StepTelemetry().parallel_step(lambda: None)


def test_mesh_is_still_refused(ref_model):
    with pytest.raises(NotImplementedError, match="item 14"):
        Trainer(_port_model(ref_model), mesh=object())


# --------------------------------------------------------- ProfilerListener
def _trace_iterations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    return sorted(int(n.rsplit("_", 1)[1]) for n in names
                  if n.startswith("ProfilerListener.iteration_"))


@pytest.mark.parametrize("start,count,want", [(1, 2, [1, 2]), (0, 1, [0]),
                                              (3, 5, [3, 4])])
def test_profiler_listener_traces_exactly_its_window(ref_model, tmp_path,
                                                     start, count, want):
    """Five iterations; the trace holds exactly the window's iterations
    (a window running past the fit's end is closed at epoch end), and the
    losses are those of a fit without the listener."""
    pl = ProfilerListener(str(tmp_path), start_iteration=start,
                          num_iterations=count)
    _, losses = _port_fit(ref_model, listeners=[pl])
    _, plain = _port_fit(ref_model)
    assert losses == plain
    assert len(pl.paths) == 1 and os.path.exists(pl.paths[0])
    assert _trace_iterations(pl.paths[0]) == want
    assert not pl._active


def test_profiler_listener_outside_the_fit_writes_nothing(ref_model,
                                                          tmp_path):
    pl = ProfilerListener(str(tmp_path / "never"), start_iteration=50)
    _port_fit(ref_model, listeners=[pl])
    assert pl.paths == [] and not (tmp_path / "never").exists()


def test_phase_timer_matches_reference(monkeypatch):
    import itertools
    import time

    for cls in (PhaseTimer, JPhaseTimer):
        ticks = itertools.count(0.0, 0.25)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        pt = cls()
        for name in ("load", "step", "step", "save"):
            with pt.phase(name):
                pass
        if cls is PhaseTimer:
            got = (pt.summary(), pt.export_json())
        else:
            want = (pt.summary(), pt.export_json())
    assert got == want
    assert got[0]["step"] == {"total_s": 0.5, "count": 2, "mean_s": 0.25}
