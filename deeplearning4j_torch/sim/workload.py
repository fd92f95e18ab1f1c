"""Deterministic workload synthesis — seed-replayable open-loop traces; the
port's copy of ``deeplearning4j_tpu/sim/workload.py``.

A :class:`WorkloadSpec` describes offered load the way a capacity planner
would: a base request rate shaped by a time-compressed **diurnal** sinusoid,
**Markov-modulated bursts** (an on/off process multiplies the rate while
"on"), **heavy-tailed lengths** (lognormal prompts, Pareto output lengths —
the shapes measured in production LLM traces), and weighted tenant/model
mixes with per-tenant SLO classes. :func:`generate_trace` expands a spec
into a :class:`Trace` of absolute-time :class:`Event`\\ s via Lewis
thinning of a non-homogeneous Poisson process.

Everything is deterministic by construction:

- all randomness flows from ``random.Random(seed)`` (Mersenne Twister —
  identical across processes and platforms, unlike builtin ``hash()``
  which varies with ``PYTHONHASHSEED``);
- weighted choices iterate mixes in sorted key order, never dict order;
- event times are integer **microseconds**, so no float-formatting drift;
- each event carries its own sha256-derived seed so prompt *content* can
  be regenerated anywhere without replaying the arrival process;
- ``Trace.to_bytes()`` is a fixed line format, so byte-equality is the
  determinism test, and the **workload fingerprint** is a sha256 over the
  canonical spec JSON plus those bytes.

Stdlib only — no torch, no numpy — so traces can be synthesized and
fingerprinted in processes that never load an accelerator runtime.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

_TRACE_SCHEMA = "sim-trace-v1"

# Deadlines per SLO class (ms); mirrors fleet.tenants.DEFAULT_SLO_CLASSES
# without importing fleet/ (sim sits above it in the layering, but the
# workload layer stays stdlib-light so the virtual path never loads torch).
CLASS_DEADLINES_MS: Dict[str, Optional[float]] = {
    "gold": 1000.0, "standard": 5000.0, "batch": None}


class LengthDist(NamedTuple):
    """A token-length distribution: ``lognormal``, ``pareto`` or ``fixed``.

    ``p1``/``p2`` are (median, sigma) for lognormal, (scale, shape alpha)
    for Pareto, (value, unused) for fixed. Samples are clipped to
    ``[1, max_len]`` — heavy tails are the point, but the serving stack
    has a hard capacity, and clipping keeps the tail mass *at* the cap
    instead of silently discarding it.
    """

    kind: str
    p1: float
    p2: float
    max_len: int

    def sample(self, rng: random.Random) -> int:
        if self.kind == "lognormal":
            v = rng.lognormvariate(math.log(max(self.p1, 1e-9)), self.p2)
        elif self.kind == "pareto":
            v = self.p1 * rng.paretovariate(self.p2)
        elif self.kind == "fixed":
            v = self.p1
        else:
            raise ValueError(f"unknown length distribution kind {self.kind!r}")
        return max(1, min(int(self.max_len), int(round(v))))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "p1": self.p1, "p2": self.p2,
                "max_len": self.max_len}

    @classmethod
    def from_dict(cls, d: dict) -> "LengthDist":
        return cls(str(d["kind"]), float(d["p1"]), float(d["p2"]),
                   int(d["max_len"]))


class Event(NamedTuple):
    """One scheduled request. ``t_us`` is microseconds from trace start.

    ``prefix_len``/``prefix_seed`` describe a shared-prefix head: the
    first ``prefix_len`` prompt tokens are regenerated from
    ``prefix_seed`` (a per-tenant-pool seed shared by every event drawn
    from the same pool entry), the rest from the event's own ``seed``.
    ``prefix_len == 0`` (the default) is the legacy fully-private prompt
    and serializes to the legacy 9-field line, so traces without prefix
    pools stay byte-identical.
    """

    t_us: int
    seq: int
    tenant: str
    slo: str
    model: str
    kind: str           # "predict" | "generate"
    prompt_len: int
    max_new_tokens: int
    seed: int           # per-event content seed (sha256-derived)
    prefix_len: int = 0
    prefix_seed: int = 0

    @property
    def t_s(self) -> float:
        return self.t_us / 1e6

    def deadline_s(self) -> Optional[float]:
        """Absolute deadline in trace time, or None for the batch class."""
        ms = CLASS_DEADLINES_MS.get(self.slo)
        return None if ms is None else self.t_s + ms / 1e3

    def to_line(self) -> str:
        base = (f"{self.t_us} {self.seq} {self.tenant} {self.slo} "
                f"{self.model} {self.kind} {self.prompt_len} "
                f"{self.max_new_tokens} {self.seed}")
        if self.prefix_len > 0:
            return f"{base} {self.prefix_len} {self.prefix_seed}"
        return base

    @classmethod
    def from_line(cls, line: str) -> "Event":
        p = line.split()
        if len(p) not in (9, 11):
            raise ValueError(f"bad trace line: {line!r}")
        return cls(int(p[0]), int(p[1]), p[2], p[3], p[4], p[5],
                   int(p[6]), int(p[7]), int(p[8]),
                   int(p[9]) if len(p) == 11 else 0,
                   int(p[10]) if len(p) == 11 else 0)


class WorkloadSpec:
    """Declarative description of an offered-load scenario.

    ``tenants`` maps tenant name -> ``{"weight", "slo"}`` and ``models``
    maps model name -> ``{"weight", "generate_frac"}``; weights are
    relative. ``time_scale`` compresses wall time for *live* replay only —
    it is part of the spec (and fingerprint) because a compressed replay
    offers different instantaneous concurrency than a real-time one.

    ``days`` repeats the compressed diurnal curve: one "day" is
    ``duration_s`` long, the sinusoid repeats naturally (its default
    period IS the day), and each later day re-seeds the Markov burst
    process from a sha256-derived day seed — so a 3-day trace has three
    *different* burst patterns over the same diurnal shape, which is what
    makes multi-day autoscaler replays informative instead of three
    copies of day one. ``days=1`` (the default) is bit-identical to the
    legacy single-day expansion and is omitted from the canonical spec,
    so every existing fingerprint (and every tuned config keyed by one)
    survives unchanged.

    ``prefix_reuse``/``prefix_len``/``prefix_pool`` model shared-prefix
    traffic (system prompts, few-shot templates): each tenant owns
    ``prefix_pool`` prefix entries whose lengths are drawn from the
    ``prefix_len`` distribution and whose content seeds derive from the
    spec fingerprint — stable across processes, like per-event seeds.
    With probability ``prefix_reuse`` an event's prompt starts with one
    of its tenant's pool prefixes (uniformly chosen), which is exactly
    the traffic shape the serving prefix cache exists for. The default
    ``prefix_reuse=0`` draws nothing from the RNG stream and is omitted
    from the canonical spec, so legacy fingerprints AND trace bytes stay
    identical.
    """

    def __init__(self, *, seed: int = 0, duration_s: float = 60.0,
                 days: int = 1,
                 base_rate_rps: float = 4.0,
                 diurnal_amplitude: float = 0.5,
                 diurnal_period_s: Optional[float] = None,
                 diurnal_phase: float = -0.25,
                 burst_rate_mult: float = 1.0,
                 burst_mean_on_s: float = 0.0,
                 burst_mean_off_s: float = 0.0,
                 prompt_len: LengthDist = LengthDist("lognormal", 8.0, 0.7, 48),
                 output_len: LengthDist = LengthDist("pareto", 2.0, 1.6, 16),
                 prefix_len: Optional[LengthDist] = None,
                 prefix_reuse: float = 0.0,
                 prefix_pool: int = 4,
                 vocab: int = 50,
                 time_scale: float = 1.0,
                 tenants: Optional[Dict[str, dict]] = None,
                 models: Optional[Dict[str, dict]] = None):
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.days = int(days)
        if self.days < 1:
            raise ValueError("need days >= 1")
        self.base_rate_rps = float(base_rate_rps)
        self.diurnal_amplitude = min(1.0, max(0.0, float(diurnal_amplitude)))
        self.diurnal_period_s = float(
            duration_s if diurnal_period_s is None else diurnal_period_s)
        self.diurnal_phase = float(diurnal_phase)
        self.burst_rate_mult = max(1.0, float(burst_rate_mult))
        self.burst_mean_on_s = max(0.0, float(burst_mean_on_s))
        self.burst_mean_off_s = max(0.0, float(burst_mean_off_s))
        self.prompt_len = prompt_len
        self.output_len = output_len
        self.prefix_len = prefix_len
        self.prefix_reuse = min(1.0, max(0.0, float(prefix_reuse)))
        self.prefix_pool = max(1, int(prefix_pool))
        if self.prefix_reuse > 0.0 and self.prefix_len is None:
            raise ValueError("prefix_reuse > 0 needs a prefix_len "
                             "distribution")
        self.vocab = int(vocab)
        self.time_scale = float(time_scale)
        self.tenants = tenants or {"default": {"weight": 1.0,
                                               "slo": "standard"}}
        self.models = models or {"default": {"weight": 1.0,
                                             "generate_frac": 0.0}}

    @property
    def total_duration_s(self) -> float:
        """Full trace span: ``days`` diurnal days of ``duration_s`` each."""
        return self.duration_s * self.days

    def to_dict(self) -> dict:
        d = self._to_dict()
        if self.days != 1:
            # a single-day spec's canonical form predates `days`: omitting
            # the default keeps every legacy fingerprint byte-stable
            d["days"] = self.days
        if self.prefix_reuse > 0.0:
            # same discipline as `days`: prefix pools predate nothing a
            # legacy fingerprint covers, so the OFF default stays absent
            d["prefix_len"] = self.prefix_len.to_dict()
            d["prefix_reuse"] = self.prefix_reuse
            d["prefix_pool"] = self.prefix_pool
        return d

    def _to_dict(self) -> dict:
        return {
            "schema": _TRACE_SCHEMA,
            "seed": self.seed,
            "duration_s": self.duration_s,
            "base_rate_rps": self.base_rate_rps,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_s": self.diurnal_period_s,
            "diurnal_phase": self.diurnal_phase,
            "burst_rate_mult": self.burst_rate_mult,
            "burst_mean_on_s": self.burst_mean_on_s,
            "burst_mean_off_s": self.burst_mean_off_s,
            "prompt_len": self.prompt_len.to_dict(),
            "output_len": self.output_len.to_dict(),
            "vocab": self.vocab,
            "time_scale": self.time_scale,
            "tenants": self.tenants,
            "models": self.models,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        d = dict(d)
        d.pop("schema", None)
        d["prompt_len"] = LengthDist.from_dict(d["prompt_len"])
        d["output_len"] = LengthDist.from_dict(d["output_len"])
        if d.get("prefix_len") is not None:
            d["prefix_len"] = LengthDist.from_dict(d["prefix_len"])
        return cls(**d)

    def canonical(self) -> bytes:
        """Canonical JSON — sorted keys, no whitespace drift."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def fingerprint(self) -> str:
        """Stable spec-level fingerprint (the *workload fingerprint*).

        Hash of the canonical spec alone: the arrival process is a pure
        function of the spec, so hashing the expanded events again would
        add cost without adding information — and it lets callers key
        tuned configs before paying for trace expansion. ``Trace.
        fingerprint()`` additionally covers the event bytes as a
        self-check that expansion really was deterministic.
        """
        return hashlib.sha256(self.canonical()).hexdigest()[:16]

    def rate_at(self, t_s: float) -> float:
        """Un-modulated (no burst) offered rate at trace time ``t_s``."""
        theta = 2.0 * math.pi * (t_s / self.diurnal_period_s
                                 + self.diurnal_phase)
        r = self.base_rate_rps * (1.0
                                  + self.diurnal_amplitude * math.sin(theta))
        return max(r, 0.02 * self.base_rate_rps)


class Trace:
    """An expanded event stream plus the spec that produced it."""

    def __init__(self, spec: WorkloadSpec, events: List[Event]):
        self.spec = spec
        self.events = events

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def fingerprint(self) -> str:
        """Workload fingerprint (spec-derived; see WorkloadSpec)."""
        return self.spec.fingerprint()

    def content_hash(self) -> str:
        """sha256 over spec canonical + event bytes — expansion self-check."""
        h = hashlib.sha256(self.spec.canonical())
        h.update(b"\n")
        h.update(self._event_bytes())
        return h.hexdigest()[:16]

    def _event_bytes(self) -> bytes:
        return "\n".join(e.to_line() for e in self.events).encode("utf-8")

    def to_bytes(self) -> bytes:
        """Fixed serialization; byte-equality == trace equality."""
        header = (f"# {_TRACE_SCHEMA} fp={self.fingerprint()} "
                  f"events={len(self.events)}\n").encode("utf-8")
        spec_line = b"# spec " + self.spec.canonical() + b"\n"
        return header + spec_line + self._event_bytes() + b"\n"

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, "rb") as f:
            lines = f.read().decode("utf-8").splitlines()
        spec = None
        events: List[Event] = []
        for line in lines:
            if line.startswith("# spec "):
                spec = WorkloadSpec.from_dict(json.loads(line[len("# spec "):]))
            elif line.startswith("#") or not line.strip():
                continue
            else:
                events.append(Event.from_line(line))
        if spec is None:
            raise ValueError(f"no spec header in trace file {path}")
        return cls(spec, events)

    def slice(self, n_events: int) -> "Trace":
        """Prefix of the trace — the tuner's successive-halving rungs.

        The slice keeps the parent spec (and therefore the parent
        fingerprint): rung evaluations are *of* the parent workload,
        just truncated.
        """
        return Trace(self.spec, self.events[:max(0, int(n_events))])


def _event_seed(spec_fp: str, seq: int) -> int:
    """Per-event content seed, stable across processes."""
    digest = hashlib.sha256(f"{spec_fp}:{seq}".encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big")


def _weighted_pick(rng: random.Random, mix: Dict[str, dict]) -> str:
    """Weighted choice iterating keys in sorted order (never dict order)."""
    names = sorted(mix)
    total = sum(float(mix[n].get("weight", 1.0)) for n in names)
    x = rng.random() * total
    acc = 0.0
    for n in names:
        acc += float(mix[n].get("weight", 1.0))
        if x < acc:
            return n
    return names[-1]


def _burst_windows(rng: random.Random,
                   spec: WorkloadSpec) -> List[Tuple[float, float]]:
    """Markov on/off burst intervals: exponential off then on holding times."""
    if (spec.burst_rate_mult <= 1.0 or spec.burst_mean_on_s <= 0.0
            or spec.burst_mean_off_s <= 0.0):
        return []
    windows: List[Tuple[float, float]] = []
    t = 0.0
    while t < spec.duration_s:
        t += rng.expovariate(1.0 / spec.burst_mean_off_s)
        if t >= spec.duration_s:
            break
        end = t + rng.expovariate(1.0 / spec.burst_mean_on_s)
        windows.append((t, min(end, spec.duration_s)))
        t = end
    return windows


def _day_seed(seed: int, day: int) -> int:
    """Per-day burst-process seed, stable across processes (sha256, not
    ``hash()`` — the same discipline as per-event content seeds)."""
    digest = hashlib.sha256(f"{seed}:day:{day}".encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big")


def _prefix_entry(spec: WorkloadSpec, spec_fp: str, tenant: str,
                  pid: int) -> Tuple[int, int]:
    """One tenant-pool prefix entry: ``(length, content seed)``.

    Both are pure functions of ``(spec fingerprint, tenant, pool id)`` —
    the length is a single draw from the ``prefix_len`` distribution
    under a dedicated sha256-derived RNG, so every event adopting this
    entry sees the same prefix regardless of arrival order or process.
    """
    digest = hashlib.sha256(
        f"{spec_fp}:prefix:{tenant}:{pid}".encode("utf-8")).digest()
    seed = int.from_bytes(digest[:4], "big")
    length = spec.prefix_len.sample(random.Random(seed))
    return length, seed


def generate_trace(spec: WorkloadSpec) -> Trace:
    """Expand a spec into a trace via Lewis thinning.

    Candidate arrivals come from a homogeneous Poisson process at the
    rate envelope ``base * (1 + amplitude) * burst_mult``; each candidate
    survives with probability ``rate(t) / envelope``. The thinned stream
    is exactly the non-homogeneous process with intensity ``rate(t)``,
    and — because every candidate consumes the same number of RNG draws —
    the stream is bit-stable under any spec change that only *lowers*
    local intensity.

    Multi-day specs draw day 0's burst windows from the main RNG stream
    (so ``days=1`` stays bit-identical to the legacy expansion) and each
    later day's from its own sha256-derived seed, offset into that day.
    """
    rng = random.Random(spec.seed)
    windows = list(_burst_windows(rng, spec))
    for day in range(1, spec.days):
        day_rng = random.Random(_day_seed(spec.seed, day))
        offset = day * spec.duration_s
        windows.extend((a + offset, b + offset)
                       for a, b in _burst_windows(day_rng, spec))
    spec_fp = spec.fingerprint()

    def modulated_rate(t: float) -> float:
        r = spec.rate_at(t)
        for (a, b) in windows:
            if a <= t < b:
                return r * spec.burst_rate_mult
        return r

    envelope = (spec.base_rate_rps * (1.0 + spec.diurnal_amplitude)
                * spec.burst_rate_mult)
    events: List[Event] = []
    t = 0.0
    seq = 0
    while True:
        t += rng.expovariate(envelope)
        if t >= spec.total_duration_s:
            break
        keep = rng.random() * envelope <= modulated_rate(t)
        # Draw the per-event attributes unconditionally so thinning
        # decisions don't shift the RNG stream of later events.
        tenant = _weighted_pick(rng, spec.tenants)
        model = _weighted_pick(rng, spec.models)
        gen_frac = float(spec.models[model].get("generate_frac", 0.0))
        kind = "generate" if rng.random() < gen_frac else "predict"
        plen = spec.prompt_len.sample(rng)
        ntok = spec.output_len.sample(rng) if kind == "generate" else 0
        pfx_len, pfx_seed = 0, 0
        if spec.prefix_reuse > 0.0:
            # two extra draws per candidate, but ONLY when the feature is
            # on: the legacy (prefix_reuse=0) stream stays byte-identical
            reuse = rng.random() < spec.prefix_reuse
            pid = rng.randrange(spec.prefix_pool)
            if reuse:
                pool_len, pfx_seed = _prefix_entry(spec, spec_fp, tenant, pid)
                # at least one private token stays: a fully-shared prompt
                # has nothing for the server to prefill
                pfx_len = min(pool_len, plen - 1)
                if pfx_len <= 0:
                    pfx_len, pfx_seed = 0, 0
        if not keep:
            continue
        events.append(Event(
            t_us=int(round(t * 1e6)), seq=seq, tenant=tenant,
            slo=str(spec.tenants[tenant].get("slo", "standard")),
            model=model, kind=kind, prompt_len=plen, max_new_tokens=ntok,
            seed=_event_seed(spec_fp, seq),
            prefix_len=pfx_len, prefix_seed=pfx_seed))
        seq += 1
    return Trace(spec, events)


def prompt_tokens(event: Event, vocab: int) -> List[int]:
    """Regenerate the event's prompt content from its embedded seed(s).

    A shared-prefix event regenerates its head from the tenant-pool
    ``prefix_seed`` — every adopter of the same pool entry produces the
    SAME head tokens, so replaying the trace against a real server
    exercises the prefix cache exactly as the spec intended."""
    v = max(2, int(vocab))
    out: List[int] = []
    if event.prefix_len > 0:
        rp = random.Random(event.prefix_seed)
        out = [rp.randrange(v) for _ in range(event.prefix_len)]
    r = random.Random(event.seed)
    out.extend(r.randrange(v)
               for _ in range(event.prompt_len - event.prefix_len))
    return out


def smoke_spec(seed: int = 0, duration_s: float = 60.0,
               base_rate_rps: float = 6.0,
               time_scale: float = 0.1) -> WorkloadSpec:
    """The CI smoke workload: one compressed diurnal day over a 2-model,
    3-tenant fleet with a bursty gold tier and heavy-tailed lengths."""
    return WorkloadSpec(
        seed=seed, duration_s=duration_s, base_rate_rps=base_rate_rps,
        diurnal_amplitude=0.6, diurnal_period_s=duration_s,
        diurnal_phase=-0.25,
        burst_rate_mult=2.5, burst_mean_on_s=4.0, burst_mean_off_s=12.0,
        prompt_len=LengthDist("lognormal", 6.0, 0.7, 12),
        output_len=LengthDist("pareto", 2.0, 1.6, 4),
        vocab=50, time_scale=time_scale,
        tenants={
            "acme": {"weight": 0.5, "slo": "gold"},
            "globex": {"weight": 0.35, "slo": "standard"},
            "free": {"weight": 0.15, "slo": "batch"},
        },
        models={
            "alpha": {"weight": 0.6, "generate_frac": 0.0},
            "beta": {"weight": 0.4, "generate_frac": 0.5},
        })
