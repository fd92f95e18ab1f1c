"""Open-loop trace replay — virtual (deterministic) and live modes; the
port's copy of ``deeplearning4j_tpu/sim/replay.py``.

Both replayers consume the same :class:`~.workload.Trace` and emit the
same :func:`~.score.summarize` report, but they answer different
questions:

- :class:`VirtualReplayer` is a **discrete-event model** of the serving
  stack (batch-window predict queue, slot/KV-block generate path with
  chunked prefill, LRU weight paging). It is bit-deterministic — same
  trace + same knobs + same cost model ⇒ byte-identical report — and
  runs thousands of events per millisecond, which is what makes
  successive-halving autotuning (``sim/tune.py``) affordable. Its cost
  model is calibrated roughly to the CPU smoke stack; it predicts knob
  *orderings*, not absolute latencies.
- :class:`LiveReplayer` drives a real in-process
  :class:`~..fleet.registry.FleetRegistry` (via :class:`FleetTarget`)
  at trace-scheduled wall times, **never closed-loop**: an event fires
  at ``t0 + time_scale * event.t_s`` whether or not earlier requests
  have finished, so queue growth under overload is visible exactly as
  production would see it. Fates come back as the same typed causes the
  HTTP tier maps (``serve/errors.py``), so one scorer serves both modes.

The knob dictionary mirrors the real constructor surfaces: the
``engine`` group splats into :class:`~..serve.engine.ServeEngine`, the
``gen`` group into :class:`~..serve.continuous.ContinuousBatcher`
(``decode_chunks``/``idle_chunks`` fold into a ``PrefillScheduler``),
``fleet``/``cluster`` groups carry pager and router knobs. The same
nested dict is what the tuner persists into the AOT store.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from .score import Outcome, summarize
from .workload import Event, Trace, prompt_tokens

# Hand-picked defaults — the same values the serve/fleet constructors
# default to today. Candidate 0 of every tuner search.
DEFAULT_KNOBS: Dict[str, dict] = {
    "engine": {"batch_buckets": [1, 2, 4, 8, 16, 32],
               "queue_limit": 256, "max_wait_ms": 2.0},
    "gen": {"slots": 4, "capacity": 256, "block_size": 16, "kv_blocks": None,
            "prefill_chunk": 64, "queue_limit": 64,
            "decode_chunks": 1, "idle_chunks": 4,
            "prefix_cache": True, "prefix_cache_blocks": None},
    # resident_models: how many models fit the pager's HBM budget at once
    # (None = all of them — paging never evicts)
    "fleet": {"resident_models": None},
    # router-tier knobs, modeled by the virtual hop stage when the cost
    # model carries nonzero hop costs (hop_rtt_s / hop_loss_p) — with the
    # default all-zero hop costs the stage is skipped and reports stay
    # byte-identical to the pre-hop model (deeplearning4j_tpu/sim/README.md)
    "cluster": {"hedge_ms": 30.0, "retry_budget_per_s": 2.0},
    # predictive-autoscaler knobs: the confidence floor gates pre-spawn
    # (AutoscalePolicy.from_config), season/horizon shape the forecaster
    # (BurnForecaster.from_config) — one recorded winner configures both
    "autoscale": {"forecast_season_s": 86400.0, "forecast_horizon_s": 60.0,
                  "forecast_confidence": 0.5},
}


def merge_knobs(base: dict, override: Optional[dict]) -> dict:
    """Two-level merge: override group/key wins, base fills the rest."""
    out = {g: dict(v) for g, v in base.items()}
    for g, v in (override or {}).items():
        out.setdefault(g, {}).update(v or {})
    return out


def flatten_knobs(knobs: dict) -> Dict[str, object]:
    """``{"gen": {"slots": 4}}`` -> ``{"gen.slots": 4}`` (tuner space keys)."""
    flat: Dict[str, object] = {}
    for g in sorted(knobs):
        for k in sorted(knobs[g]):
            flat[f"{g}.{k}"] = knobs[g][k]
    return flat


def set_flat(knobs: dict, dotted: str, value) -> None:
    group, key = dotted.split(".", 1)
    knobs.setdefault(group, {})[key] = value


class CostModel(NamedTuple):
    """Virtual-time costs. Defaults are the reference's hand-set values:
    they rank configs, not absolute latencies; :meth:`from_profile`
    recalibrates them from a measured
    :class:`~deeplearning4j_torch.obs.costmodel.CostProfile`."""

    predict_row_s: float = 2e-4       # per padded batch row
    predict_dispatch_s: float = 1.5e-3  # per device dispatch
    prefill_tok_s: float = 4000.0     # prefill throughput, tokens/s
    chunk_dispatch_s: float = 1e-3    # per prefill chunk overhead
    decode_base_s: float = 4e-3       # decode step, empty batch
    decode_slot_s: float = 1e-3       # decode step marginal cost per slot
    page_in_s: float = 0.5            # weight page-in (host -> device + warm)
    # router-hop costs (zero = in-process deployment, hop stage skipped —
    # reports stay byte-identical to the hop-free model). Nonzero values
    # activate the ``cluster.*`` knobs: hedge_ms bounds lost-attempt
    # recovery, retry_budget_per_s bounds un-hedged retries.
    hop_rtt_s: float = 0.0            # router <-> replica round trip
    hop_loss_p: float = 0.0           # P(first attempt lost in transit)

    @classmethod
    def from_profile(cls, profile,
                     base: Optional["CostModel"] = None) -> "CostModel":
        """Calibrate from a measured cost profile: each field the profiler
        actually observed replaces the hand-set value; everything the run
        never exercised keeps ``base`` (default: the class defaults) — so
        calibration degrades per-field, never whole-model."""
        cm = base if base is not None else cls()
        repl = {}
        for field in cm._fields:
            v = profile.cost(field)
            if v is not None:
                repl[field] = v
        return cm._replace(**repl) if repl else cm


def _blocks_needed(tokens: int, block_size: int) -> int:
    return -(-max(1, tokens) // max(1, block_size))


def _unit_hash(seq: int) -> float:
    """Deterministic per-event uniform in [0, 1) — splitmix64 of the
    event's trace sequence number (NEVER Python's salted ``hash``), so
    the same trace loses the same attempts in every process."""
    z = (int(seq) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return ((z ^ (z >> 31)) & 0xFFFFFFFFFFFFFFFF) / 2.0 ** 64


def _shed(ev: Event, cause: str) -> Outcome:
    return Outcome(False, cause, ev.slo, ev.model, ev.kind,
                   None, None, None, 0)


class VirtualReplayer:
    """Deterministic discrete-event replay of a trace against one knob set.

    Per model, the predict path is a single batching server (window =
    first-arrival + ``max_wait_ms``, dispatch pads to the smallest bucket
    that fits) and the generate path is a slot + KV-block pool with
    chunked prefill contending against running decodes — the same shape,
    sheds, and knob tradeoffs as the live engine, in virtual time.
    """

    def __init__(self, trace: Trace, knobs: Optional[dict] = None,
                 cost_model: Optional[CostModel] = None):
        self.trace = trace
        self.knobs = merge_knobs(DEFAULT_KNOBS, knobs)
        self.cm = cost_model if cost_model is not None else CostModel()

    # ---------------------------------------------------------------- paging
    def _residency_adjusted(self) -> List[Tuple[float, Event]]:
        """Effective arrival times after LRU weight paging: a request to a
        cold model waits for the (serial) pager before it reaches a queue."""
        budget = self.knobs["fleet"].get("resident_models")
        models = {e.model for e in self.trace}
        if not budget or int(budget) >= len(models):
            return [(e.t_s, e) for e in self.trace]
        budget = int(budget)
        resident: "OrderedDict[str, float]" = OrderedDict()
        pager_free = 0.0
        out: List[Tuple[float, Event]] = []
        for ev in self.trace:
            t = ev.t_s
            if ev.model in resident:
                resident.move_to_end(ev.model)
                out.append((max(t, resident[ev.model]), ev))
                continue
            ready = max(t, pager_free) + self.cm.page_in_s
            pager_free = ready
            if len(resident) >= budget:
                resident.popitem(last=False)
            resident[ev.model] = ready
            out.append((ready, ev))
        return out

    # ------------------------------------------------------------ router hop
    def _router_adjusted(
            self, arrivals: List[Tuple[float, Event]],
            out: List[Outcome]) -> List[Tuple[float, Event]]:
        """The ``cluster.*`` knob model: each request pays half a hop RTT
        to reach its replica; a transit-lost first attempt (seeded by the
        event's sequence number) is recovered by the hedge after
        ``hedge_ms`` when one is armed, else by a retry one more RTT
        later IF the retry token bucket (refilled at
        ``retry_budget_per_s`` of virtual time, capped at one second of
        budget) still holds a token — a drained bucket sheds the request
        as ``upstream_unreachable``, exactly the router's storm-control
        tradeoff. Skipped entirely (and byte-identical) while both hop
        cost-model fields are zero."""
        cm = self.cm
        if cm.hop_rtt_s <= 0.0 and cm.hop_loss_p <= 0.0:
            return arrivals
        cl = self.knobs.get("cluster") or {}
        hedge_s = max(0.0, float(cl.get("hedge_ms") or 0.0)) / 1e3
        rate = max(0.0, float(cl.get("retry_budget_per_s") or 0.0))
        cap = max(1.0, rate)
        tokens, last_t = cap, 0.0
        kept: List[Tuple[float, Event]] = []
        for eff, ev in arrivals:
            delay = cm.hop_rtt_s / 2.0
            if cm.hop_loss_p > 0.0 and _unit_hash(ev.seq) < cm.hop_loss_p:
                if hedge_s > 0.0:
                    # the hedged duplicate (no budget spend) lands after
                    # the hedge timer plus its own half-hop
                    delay += hedge_s
                else:
                    tokens = min(cap, tokens + max(0.0, eff - last_t) * rate)
                    last_t = eff
                    if tokens >= 1.0:
                        tokens -= 1.0
                        delay += cm.hop_rtt_s  # full extra round trip
                    else:
                        out.append(_shed(ev, "upstream_unreachable"))
                        continue
            kept.append((eff + delay, ev))
        return kept

    # --------------------------------------------------------------- predict
    def _sim_predict(self, items: List[Tuple[float, Event]],
                     out: List[Outcome]) -> None:
        eng = self.knobs["engine"]
        cm = self.cm
        buckets = sorted(int(b) for b in eng["batch_buckets"])
        maxb = buckets[-1]
        qlimit = int(eng["queue_limit"])
        wait = float(eng["max_wait_ms"]) / 1e3
        pending: deque = deque()
        t_free = 0.0
        i, n = 0, len(items)
        while i < n or pending:
            if not pending:
                pending.append(items[i])
                i += 1
                continue
            first_t = pending[0][0]
            ready = max(t_free,
                        first_t if len(pending) >= maxb else first_t + wait)
            if i < n and items[i][0] <= ready:
                eff, ev = items[i]
                i += 1
                if len(pending) >= qlimit:
                    out.append(_shed(ev, "queue_full"))
                else:
                    pending.append((eff, ev))
                continue
            take = min(len(pending), maxb)
            batch = [pending.popleft() for _ in range(take)]
            live = []
            for eff, ev in batch:
                dl = ev.deadline_s()
                if dl is not None and ready > dl:
                    out.append(_shed(ev, "deadline"))
                else:
                    live.append(ev)
            if not live:
                continue
            bucket = next(b for b in buckets if b >= len(live))
            t_free = ready + cm.predict_dispatch_s + bucket * cm.predict_row_s
            for ev in live:
                dl = ev.deadline_s()
                if dl is not None and t_free > dl:
                    out.append(_shed(ev, "deadline"))
                else:
                    out.append(Outcome(True, None, ev.slo, ev.model,
                                       "predict", t_free - ev.t_s,
                                       None, None, 0))

    # -------------------------------------------------------------- generate
    def _sim_generate(self, items: List[Tuple[float, Event]],
                      out: List[Outcome],
                      util: List[float]) -> None:
        g = self.knobs["gen"]
        cm = self.cm
        slots = max(1, int(g["slots"]))
        capacity = max(1, int(g["capacity"]))
        bs = max(1, int(g["block_size"]))
        per_seq = _blocks_needed(capacity, bs)
        total_blocks = (int(g["kv_blocks"]) if g.get("kv_blocks")
                        else slots * per_seq + 1)
        chunk = max(1, int(g["prefill_chunk"] or capacity))
        dc = max(1, int(g.get("decode_chunks", 1)))
        qlimit = max(1, int(g["queue_limit"]))
        # prefix-cache model: whole blocks of a previously-seen shared
        # prefix (same tenant-pool seed) skip BOTH the prefill-chunk work
        # and the block charge. Insertion is modeled at admission (the
        # live cache inserts at prefill completion — a fidelity gap only
        # for near-simultaneous first arrivals of one pool entry), cached
        # blocks occupy pool capacity, and pressure reclaims LRU entries
        # before anything waits — the live reclaim-before-shed rule. With
        # no prefixed events in the trace (every legacy workload), the
        # cache never populates and reports stay byte-identical.
        px_on = bool(g.get("prefix_cache", True))
        px_cap = g.get("prefix_cache_blocks")
        px_cap = int(px_cap) if px_cap else None
        px: "OrderedDict[int, int]" = OrderedDict()  # seed -> whole blocks
        px_blocks = 0
        active: list = []          # heap of (done_t, seq, blocks)
        blocks_used = 0
        waiting: deque = deque()

        def release(upto: float) -> None:
            nonlocal blocks_used
            while active and active[0][0] <= upto:
                _, _, b = heapq.heappop(active)
                blocks_used -= b

        def px_insert(ev: Event) -> None:
            nonlocal px_blocks
            if not px_on or ev.prefix_len < bs:
                return
            nfull = ev.prefix_len // bs
            cur = px.get(ev.prefix_seed, 0)
            if nfull > cur:
                px[ev.prefix_seed] = nfull
                px_blocks += nfull - cur
            px.move_to_end(ev.prefix_seed)
            while px_cap is not None and px_blocks > px_cap and len(px) > 1:
                _, v = px.popitem(last=False)
                px_blocks -= v

        def try_start(now: float) -> None:
            nonlocal blocks_used, px_blocks
            while waiting:
                eff, ev = waiting[0]
                shared = 0
                if px_on and ev.prefix_len > 0 and ev.prefix_seed in px:
                    shared = min(px[ev.prefix_seed],
                                 (ev.prompt_len - 1) // bs)
                need = _blocks_needed(ev.prompt_len + ev.max_new_tokens,
                                      bs) - shared
                if len(active) >= slots:
                    return
                # capacity pressure reclaims idle cached runs before the
                # head request waits (the allocator's reclaimer hook)
                while blocks_used + px_blocks + need > total_blocks and px:
                    _, v = px.popitem(last=False)
                    px_blocks -= v
                    if shared:  # the adopted run may be what was evicted
                        shared = min(px.get(ev.prefix_seed, 0),
                                     (ev.prompt_len - 1) // bs)
                        need = _blocks_needed(
                            ev.prompt_len + ev.max_new_tokens, bs) - shared
                if blocks_used + px_blocks + need > total_blocks:
                    return
                waiting.popleft()
                start = max(now, eff)
                dl = ev.deadline_s()
                if dl is not None and start > dl:
                    out.append(_shed(ev, "deadline"))
                    continue
                if px_on and ev.prefix_len > 0:
                    px_insert(ev)
                nact = len(active) + 1
                decode_tick = cm.decode_base_s + cm.decode_slot_s * nact
                ptoks = ev.prompt_len - shared * bs
                nchunks = _blocks_needed(ptoks, chunk)
                prefill = (ptoks / cm.prefill_tok_s
                           + nchunks * cm.chunk_dispatch_s)
                if len(active) > 0:
                    # chunked prefill yields to running decodes every
                    # `decode_chunks` chunks — small chunks prefill slower
                    prefill += (nchunks / dc) * decode_tick
                # decode ticks stretch while *other* requests prefill:
                # large chunks stall decodes longer, queue pressure makes
                # overlap more likely
                pressure = min(1.0, len(waiting) / slots)
                stall = pressure * (chunk / cm.prefill_tok_s
                                    + cm.chunk_dispatch_s) / dc
                itl = decode_tick + stall
                ttft = (start - ev.t_s) + prefill + itl
                done = start + prefill + ev.max_new_tokens * itl
                heapq.heappush(active, (done, ev.seq, need))
                blocks_used += need
                util.append((blocks_used + px_blocks) / total_blocks)
                if dl is not None and done > dl:
                    out.append(Outcome(False, "deadline", ev.slo, ev.model,
                                       "generate", None, ttft, itl, 0))
                else:
                    out.append(Outcome(True, None, ev.slo, ev.model,
                                       "generate", done - ev.t_s, ttft, itl,
                                       ev.max_new_tokens))

        for eff, ev in items:
            release(eff)
            try_start(eff)  # completions freed slots: drain the queue first
            need = _blocks_needed(ev.prompt_len + ev.max_new_tokens, bs)
            if (ev.prompt_len + ev.max_new_tokens > capacity
                    or need > total_blocks):
                out.append(_shed(ev, "over_capacity"))
                continue
            if len(waiting) >= qlimit:
                out.append(_shed(ev, "queue_full"))
                continue
            waiting.append((eff, ev))
            try_start(eff)
        while waiting:
            if active:
                done_t = active[0][0]
                release(done_t)
                try_start(done_t)
                continue
            # idle engine, non-empty queue: start from the queued arrival
            try_start(waiting[0][0])
            if not active and waiting:
                # nothing startable even when idle — impossible given the
                # admission capacity check, but never spin
                _, ev = waiting.popleft()
                out.append(_shed(ev, "over_capacity"))

    # ------------------------------------------------------------------- run
    def run(self) -> dict:
        outcomes: List[Outcome] = []
        arrivals = self._router_adjusted(self._residency_adjusted(),
                                         outcomes)
        by_mk: Dict[Tuple[str, str], List[Tuple[float, Event]]] = {}
        for eff, ev in arrivals:
            by_mk.setdefault((ev.model, ev.kind), []).append((eff, ev))
        util: List[float] = []
        for key in sorted(by_mk):
            items = sorted(by_mk[key], key=lambda p: (p[0], p[1].seq))
            if key[1] == "generate":
                self._sim_generate(items, outcomes, util)
            else:
                self._sim_predict(items, outcomes)
        return summarize(
            self.trace.fingerprint(), outcomes, mode="virtual",
            knobs=self.knobs,
            kv_peak_utilization=max(util) if util else 0.0,
            kv_mean_utilization=(sum(util) / len(util)) if util else 0.0)


class FleetTarget:
    """Adapter: trace events -> in-process :class:`FleetRegistry` calls.

    Predict prompts are padded/cropped to the model's fixed input length;
    generate prompts keep their traced lengths (prompt buckets pad).
    Every failure maps to its typed ``ServeError.cause`` — an untyped
    exception is recorded as ``internal`` and fails the smoke's
    typed-errors-only gate.
    """

    def __init__(self, registry, *, input_len: int = 16, vocab: int = 50,
                 autoscaler=None, alerts=None):
        self.registry = registry
        self.input_len = int(input_len)
        self.vocab = int(vocab)
        #: Optional AutoscaleController-shaped hook: anything with a
        #: ``replica_stats() -> {min, max, final}`` surface. When set, the
        #: replay's report records how the fleet size moved — a single
        #: registry doesn't scale itself, but the hook lets one replayer
        #: code path serve both fixed and elastic targets.
        self.autoscaler = autoscaler
        #: Optional AlertEngine-shaped hook (``firings() -> [dict]``);
        #: when set, the replay's report records which alerts fired and
        #: when, so the tuner can penalize configs that page humans.
        self.alerts = alerts

    def replica_stats(self) -> Optional[Dict[str, int]]:
        """Fleet-size envelope from the attached autoscaler, if any."""
        if self.autoscaler is None:
            return None
        return self.autoscaler.replica_stats()

    def alert_firings(self) -> Optional[List[dict]]:
        """Alert firing log from the attached engine, if any."""
        if self.alerts is None:
            return None
        return self.alerts.firings()

    def kv_utilization(self) -> Tuple[float, float]:
        """(peak, mean) of serve_kv_block_utilization over resident models."""
        try:
            snap = self.registry.metrics.snapshot()
        except Exception:  # scrape is best-effort
            return (0.0, 0.0)
        fam = snap.get("serve_kv_block_utilization") or {}
        vals = [float(s.get("value", 0.0)) for s in fam.get("series", [])]
        if not vals:
            return (0.0, 0.0)
        return (max(vals), sum(vals) / len(vals))

    def _outcome(self, ev: Event, t0: float, err: Optional[BaseException],
                 ttft: Optional[float] = None,
                 itl: Optional[float] = None,
                 tokens: int = 0) -> Outcome:
        from ..serve.errors import ServeError

        if err is None:
            return Outcome(True, None, ev.slo, ev.model, ev.kind,
                           time.monotonic() - t0, ttft, itl, tokens)
        cause = err.cause if isinstance(err, ServeError) else "internal"
        return Outcome(False, cause, ev.slo, ev.model, ev.kind,
                       None, None, None, 0)

    def predict(self, ev: Event) -> Outcome:
        import numpy as np

        toks = prompt_tokens(ev, self.vocab)[:self.input_len]
        x = np.zeros((self.input_len,), dtype=np.int64)
        x[:len(toks)] = toks
        t0 = time.monotonic()
        try:
            self.registry.predict(ev.model, x, tenant=ev.tenant)
        except Exception as e:  # mapped to a typed cause below
            return self._outcome(ev, t0, e)
        return self._outcome(ev, t0, None)

    def generate(self, ev: Event) -> Outcome:
        import numpy as np

        prompt = np.asarray(prompt_tokens(ev, self.vocab), dtype=np.int32)
        t0 = time.monotonic()
        try:
            handle = self.registry.submit_generate(
                ev.model, prompt, ev.max_new_tokens, tenant=ev.tenant)
            ticks: List[float] = []
            for _ in handle.stream():
                ticks.append(time.monotonic())
            handle.wait()
        except Exception as e:  # mapped to a typed cause below
            return self._outcome(ev, t0, e)
        ttft = (ticks[0] - t0) if ticks else None
        itl = ((ticks[-1] - ticks[0]) / (len(ticks) - 1)
               if len(ticks) > 1 else None)
        return self._outcome(ev, t0, None, ttft=ttft, itl=itl,
                             tokens=len(ticks))


class RouterTarget:
    """Adapter: trace events -> HTTP through a ClusterRouter front door.

    The cluster analogue of :class:`FleetTarget`: the same trace drives
    the whole serving stack — router admission, placement, failover,
    and (with an ``autoscaler=`` attached) an *elastic* fleet — instead
    of one in-process registry. Failures come back as the typed causes
    in the router's JSON error bodies, so the scorer's typed-errors-only
    gate applies unchanged; a transport failure to the router itself
    records ``upstream_unreachable``. KV utilization is a replica-local
    gauge the router does not aggregate, so this target reports none.
    """

    def __init__(self, host: str, port: int, *, input_len: int = 16,
                 vocab: int = 50, timeout_s: float = 30.0, autoscaler=None,
                 alerts=None):
        self.host = str(host)
        self.port = int(port)
        self.input_len = int(input_len)
        self.vocab = int(vocab)
        self.timeout_s = float(timeout_s)
        self.autoscaler = autoscaler
        self.alerts = alerts

    def replica_stats(self) -> Optional[Dict[str, int]]:
        """Fleet-size envelope from the attached autoscaler, if any."""
        if self.autoscaler is None:
            return None
        return self.autoscaler.replica_stats()

    def alert_firings(self) -> Optional[List[dict]]:
        """Alert firing log from the attached engine, if any."""
        if self.alerts is None:
            return None
        return self.alerts.firings()

    def _post(self, path: str, body: dict,
              tenant: str) -> Tuple[int, dict]:
        import http.client
        import json as _json

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", path,
                         body=_json.dumps(body).encode("utf-8"),
                         headers={"Content-Type": "application/json",
                                  "X-Tenant": tenant})
            resp = conn.getresponse()
            status, data = resp.status, resp.read()
        finally:
            conn.close()
        try:
            payload = _json.loads(data) if data else {}
        except ValueError:
            payload = {}
        return status, payload if isinstance(payload, dict) else {}

    @staticmethod
    def _cause(payload: dict) -> str:
        cause = payload.get("cause")
        # an error body without a typed cause is an untyped failure and
        # must score as one — that is the gate working, not a bug here
        return str(cause) if cause else "internal"

    def predict(self, ev: Event) -> Outcome:
        toks = prompt_tokens(ev, self.vocab)[:self.input_len]
        row = toks + [0] * (self.input_len - len(toks))
        t0 = time.monotonic()
        try:
            status, payload = self._post(
                f"/v1/models/{ev.model}/predict", {"ndarray": row},
                ev.tenant)
        except OSError:
            return _shed(ev, "upstream_unreachable")
        if status >= 400:
            return _shed(ev, self._cause(payload))
        return Outcome(True, None, ev.slo, ev.model, "predict",
                       time.monotonic() - t0, None, None, 0)

    def generate(self, ev: Event) -> Outcome:
        t0 = time.monotonic()
        try:
            status, payload = self._post(
                f"/v1/models/{ev.model}/generate?stream=false",
                {"prompt": prompt_tokens(ev, self.vocab),
                 "max_new_tokens": ev.max_new_tokens, "temperature": 0.0},
                ev.tenant)
        except OSError:
            return _shed(ev, "upstream_unreachable")
        if status >= 400:
            return _shed(ev, self._cause(payload))
        tokens = payload.get("tokens") or []
        return Outcome(True, None, ev.slo, ev.model, "generate",
                       time.monotonic() - t0, None, None, len(tokens))


class LiveReplayer:
    """Open-loop replay against a live target at trace-scheduled times.

    Each event fires at ``t0 + time_scale * event.t_s`` on its own thread
    regardless of whether earlier requests completed — the defining
    property of open-loop load (a closed-loop client self-throttles under
    overload and hides exactly the queueing the simulator exists to
    expose). Wall-clock results are *not* deterministic; determinism
    claims live in the virtual mode. ``time_scale`` defaults to the
    spec's own compression factor.
    """

    def __init__(self, trace: Trace, target, *,
                 time_scale: Optional[float] = None,
                 join_timeout_s: float = 60.0):
        self.trace = trace
        self.target = target
        self.time_scale = (trace.spec.time_scale if time_scale is None
                           else float(time_scale))
        self.join_timeout_s = float(join_timeout_s)
        self._lock = threading.Lock()
        self._outcomes: Dict[int, Outcome] = {}

    def _fire(self, idx: int, ev: Event) -> None:
        try:
            out = (self.target.generate(ev) if ev.kind == "generate"
                   else self.target.predict(ev))
        except Exception:  # a target bug scores as untyped, never hangs the run
            out = _shed(ev, "internal")
        with self._lock:
            self._outcomes[idx] = out

    def run(self) -> dict:
        t0 = time.monotonic()
        threads: List[threading.Thread] = []
        for idx, ev in enumerate(self.trace):
            delay = t0 + ev.t_s * self.time_scale - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=self._fire, args=(idx, ev),
                                  daemon=True, name=f"sim-replay-{idx}")
            th.start()
            threads.append(th)
        deadline = time.monotonic() + self.join_timeout_s
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            outcomes = [self._outcomes.get(i, _shed(ev, "client_gone"))
                        for i, ev in enumerate(self.trace)]
        peak, mean = (self.target.kv_utilization()
                      if hasattr(self.target, "kv_utilization")
                      else (0.0, 0.0))
        extra = {"time_scale": self.time_scale,
                 "wall_s": time.monotonic() - t0}
        stats = (self.target.replica_stats()
                 if hasattr(self.target, "replica_stats") else None)
        if stats is not None:
            # integer fleet-size envelope: how elastic capacity moved over
            # the replay (6-dp float rounding rules untouched)
            extra["replicas"] = {"min": int(stats["min"]),
                                 "max": int(stats["max"]),
                                 "final": int(stats["final"])}
        firings = (self.target.alert_firings()
                   if hasattr(self.target, "alert_firings") else None)
        if firings is not None:
            # which alerts would have paged during this replay (rule,
            # fired_at_s, resolved_at_s) — scored as an operator-toil
            # penalty so the tuner prefers configs that stay quiet
            extra["alerts"] = firings
        return summarize(
            self.trace.fingerprint(), outcomes, mode="live",
            kv_peak_utilization=peak, kv_mean_utilization=mean,
            extra=extra)
