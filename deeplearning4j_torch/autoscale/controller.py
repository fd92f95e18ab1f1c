"""Autoscale actuation — spawn, warm, drain, retire through ``cluster/``;
the port's copy of ``deeplearning4j_tpu/autoscale/controller.py``.

:class:`AutoscaleController` closes the loop the rest of the stack left
open: ``obs/`` measures burn, ``cluster/`` routes around death, ``aot/``
makes a cold boot warm — this module is the thing that *changes the
fleet size* in response. One :meth:`tick` is one control turn:

1. drive a membership round (``poll_once``) so the signals are fresh;
2. reap managed replicas the failure detector declared dead — their
   membership record and state-gauge series are removed (no ghost
   scrapes) and the policy sees the smaller fleet, so a floor breach
   repairs itself on the very same tick;
3. sample the :class:`~.signals.SignalReader`, ask the
   :class:`~.policy.AutoscalePolicy` for a verdict;
4. actuate: **scale-out** provisions through the injected factory
   (behind the ``autoscale.spawn`` chaos seam — a fired fault is a
   failed provision the controller survives and retries), AOT-prewarms
   every registered model from the shared store (zero compiles),
   registers with the router, and waits for the first membership beat so
   placement re-plans over the newcomer before the tick ends.
   **Scale-in** picks the emptiest replica, removes it from membership
   FIRST (no new traffic), drains each resident model over the
   replica's own ``/v1/admin/drain`` (the pager's lease discipline: an
   in-flight batch finishes against its params), then stops the server;
5. commit the policy cooldown **only if actuation succeeded**, update
   the gauges, stamp a flight-recorder event, and append one canonical
   JSON line to the decision log — the byte-identity surface replayed
   by the determinism test.

Every decision is observable three ways: gauges
(``autoscale_replicas_desired`` / ``_actual``), counters
(``autoscale_decisions_total{direction,reason}``), and timings
(``autoscale_scale_seconds{direction}`` — scale-out includes the warm
page-in and the wait for the first beat, which is the number that tells
you whether elastic capacity arrives inside an SLO window or after it).
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional
from urllib.parse import urlsplit

from ..chaos import faults as _faults
from ..cluster.membership import ALIVE, DEAD
from ..obs import flight as _flight
from .policy import IN, OUT, AutoscalePolicy, ScaleDecision
from .signals import SignalReader

log = logging.getLogger(__name__)

_DECISIONS_HELP = "autoscale policy verdicts by direction and reason"
_SCALE_S_HELP = ("seconds to actuate one scale step (out: spawn + warm "
                 "page-in + first membership beat; in: drain + stop)")


class AutoscaleController:
    """Elastic fleet control over one :class:`~..cluster.router.ClusterRouter`.

    ``factory(replica_id)`` provisions one replica and returns a
    :class:`~..cluster.replica.ReplicaHandle`-shaped handle (``base_url``,
    ``fleet``, ``alive()``, ``stop()``, ``kill()``); the smoke's factory
    builds a FleetServer sharing the AOT store, a production one would
    call a scheduler. ``clock`` feeds the signal window and the decision
    log (inject a fake for bit-reproducible runs); actuation *durations*
    are measured on ``time.perf_counter`` because they describe real
    work, not simulated time, and never feed back into decisions.
    """

    def __init__(self, router, factory: Callable[[str], object], *,
                 policy: Optional[AutoscalePolicy] = None,
                 signals: Optional[SignalReader] = None,
                 clock: Optional[Callable[[], float]] = None,
                 id_prefix: str = "as-", beat_wait_s: float = 5.0,
                 sleep: Callable[[float], None] = time.sleep,
                 forecaster=None):
        self.router = router
        self.factory = factory
        self.metrics = router.metrics
        self._clock = clock if clock is not None else time.monotonic
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.signals = signals if signals is not None else SignalReader(
            slo=router.slo, membership=router.membership, clock=self._clock)
        #: Optional BurnForecaster-shaped hook (the reference's
        #: ``obs/forecast.py``; duck-typed here, item 15 of the roadmap)
        #: (``forecast_burn(slo_class) -> Forecast | None``); when set,
        #: every tick hands the policy a per-class burn forecast so it
        #: can pre-spawn ahead of a predicted ramp.
        self.forecaster = forecaster
        self.id_prefix = str(id_prefix)
        self.beat_wait_s = float(beat_wait_s)
        self._sleep = sleep
        self._lock = threading.Lock()       # managed set + tick serialization
        self._managed: Dict[str, object] = {}
        self._spawned = 0                   # monotonic id counter
        self._ticks = 0
        self._last: Optional[ScaleDecision] = None
        self.decision_log: List[str] = []
        self._min_seen: Optional[int] = None
        self._max_seen: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if hasattr(router, "autoscaler"):
            router.autoscaler = self        # surfaces on /v1/cluster

    # ------------------------------------------------------------- fleet view
    def adopt(self, replica_id: str, handle) -> None:
        """Take ownership of an already-running replica (the seed fleet a
        drill boots before handing control to the autoscaler)."""
        with self._lock:
            self._managed[replica_id] = handle
            self._note_size_locked()

    def _actual_locked(self) -> int:
        """Managed replicas the failure detector still counts."""
        n = 0
        for rid in self._managed:
            try:
                if self.router.membership.state(rid) != DEAD:
                    n += 1
            except KeyError:
                pass
        return n

    def _note_size_locked(self) -> None:
        n = self._actual_locked()
        if self._min_seen is None or n < self._min_seen:
            self._min_seen = n
        if self._max_seen is None or n > self._max_seen:
            self._max_seen = n

    def replica_stats(self) -> Dict[str, int]:
        """``{min, max, final}`` managed-fleet sizes over this controller's
        lifetime — the block the sim scorer stamps into its report."""
        with self._lock:
            final = self._actual_locked()
            return {"min": final if self._min_seen is None else self._min_seen,
                    "max": final if self._max_seen is None else self._max_seen,
                    "final": final}

    def snapshot(self) -> dict:
        """Autoscaler state for ``/v1/cluster``."""
        with self._lock:
            return {
                "managed": sorted(self._managed),
                "actual": self._actual_locked(),
                "ticks": self._ticks,
                "decisions": len(self.decision_log),
                "policy": self.policy.snapshot(),
                "last_decision": (json.loads(self._last.to_json())
                                  if self._last is not None else None),
            }

    def decision_log_bytes(self) -> bytes:
        """The full decision log, one canonical JSON line per tick — two
        processes fed the same trace, seed, and fake clock must produce
        byte-identical output here."""
        with self._lock:
            return ("\n".join(self.decision_log) + "\n").encode("utf-8") \
                if self.decision_log else b""

    # ------------------------------------------------------------------- tick
    def tick(self, poll: bool = True) -> ScaleDecision:
        """One control turn: poll, reap, sample, decide, actuate, record.

        Scale-in actuation is split around the lock: victims are picked,
        unmanaged, and unrouted under ``_lock`` (the decision stays
        atomic), but the per-model ``/v1/admin/drain`` round-trips and
        the handle stop run *outside* it — a drain can take its full
        30 s timeout, and holding the lock that long freezes every
        ``snapshot()``/``decision_log_bytes()`` reader (the /v1/cluster
        surface). Ticks themselves stay serial: the production loop is
        one thread, and the drills call ``tick()`` sequentially."""
        with self._lock:
            if poll:
                self.router.poll_once()
            retired = self._reap_dead_locked()
            s = self.signals.sample()
            now = s.t
            current = self._actual_locked()
            forecast = None
            if self.forecaster is not None:
                # pure in-memory store reads — safe under the tick lock
                forecast = {
                    cls: self.forecaster.forecast_burn(cls)
                    for cls in sorted(self.policy.burn_out)}
            decision = self.policy.decide(self.signals, current, now,
                                          forecast=forecast)
            self.metrics.counter(
                "autoscale_decisions_total",
                {"direction": decision.direction, "reason": decision.reason},
                help=_DECISIONS_HELP).inc()
            actuated = 0
            plan: List[dict] = []
            if decision.direction == OUT and decision.amount > 0:
                actuated = self._scale_out_locked(decision.amount)
            elif decision.direction == IN and decision.amount > 0:
                plan = self._plan_scale_in_locked(decision.amount)
        if plan:
            actuated = self._execute_scale_in(plan)
        with self._lock:
            if actuated:
                # cooldowns arm only on success: a failed spawn leaves the
                # policy free to retry on the very next tick
                self.policy.commit(decision, now)
            actual = self._actual_locked()
            desired = current + (actuated if decision.direction == OUT
                                 else -actuated)
            self.metrics.gauge(
                "autoscale_replicas_desired",
                help="fleet size the last committed decision asked for"
            ).set(desired)
            self.metrics.gauge(
                "autoscale_replicas_actual",
                help="managed replicas the failure detector counts"
            ).set(actual)
            self._note_size_locked()
            if _flight.ACTIVE is not None:
                _flight.ACTIVE.record_event(
                    "autoscale", decision.direction, detail=decision.reason,
                    amount=decision.amount, current=current, actual=actual)
            self.decision_log.append(json.dumps(
                {"tick": self._ticks, "current": current, "actual": actual,
                 "actuated": actuated, "retired": retired,
                 "decision": json.loads(decision.to_json())},
                sort_keys=True, separators=(",", ":")))
            self._ticks += 1
            self._last = decision
            return decision

    def _reap_dead_locked(self) -> List[str]:
        """Retire managed replicas the failure detector declared dead:
        membership record + state-gauge series go away (scrapes must not
        show ghosts), the handle's threads are reclaimed, and the policy
        sees the smaller fleet on this same tick (``below_min`` repair
        bypasses cooldown)."""
        gone: List[str] = []
        for rid in sorted(self._managed):
            try:
                state = self.router.membership.state(rid)
            except KeyError:
                state = DEAD  # not in membership at all: nothing routes to it
            if state != DEAD:
                continue
            handle = self._managed.pop(rid)
            try:
                self.router.remove_replica(rid)
            except KeyError:
                pass
            try:
                handle.kill()  # already dead; this only reclaims threads
            except Exception:  # reaping must not die of a messy corpse
                log.exception("post-mortem cleanup of %s", rid)
            self.metrics.counter(
                "autoscale_retired_total", {"cause": "dead"},
                help="managed replicas retired, by cause").inc()
            if _flight.ACTIVE is not None:
                _flight.ACTIVE.record_event("autoscale", "reaped",
                                            replica=rid)
            log.warning("reaped dead managed replica %s", rid)
            gone.append(rid)
        return gone

    # -------------------------------------------------------------- scale-out
    def _scale_out_locked(self, amount: int) -> int:
        done = 0
        for _ in range(int(amount)):
            rid = f"{self.id_prefix}{self._spawned}"
            t0 = time.perf_counter()
            try:
                if _faults.ACTIVE is not None:
                    _faults.ACTIVE.hit("autoscale.spawn", scope=rid)
                handle = self.factory(rid)
            except Exception:  # a failed provision is a retriable event
                log.exception("spawn of %s failed", rid)
                self.metrics.counter(
                    "autoscale_spawn_failures_total",
                    help="scale-out provisions that failed (retried on a "
                         "later tick)").inc()
                break
            self._spawned += 1
            self._managed[rid] = handle
            self._prewarm(handle)
            self.router.add_replica(rid, handle.base_url)
            if not self._await_first_beat(rid):
                log.warning("replica %s spawned but no beat within %.1fs; "
                            "membership will track it from here", rid,
                            self.beat_wait_s)
            self.metrics.histogram(
                "autoscale_scale_seconds", {"direction": "out"},
                help=_SCALE_S_HELP).observe(time.perf_counter() - t0)
            if _flight.ACTIVE is not None:
                _flight.ACTIVE.record_event("autoscale", "spawned",
                                            replica=rid)
            done += 1
        return done

    @staticmethod
    def _prewarm(handle) -> None:
        """AOT-warm page-in of every registered model: the shared store
        already holds the executables, so ``ensure`` costs a weight
        transfer, not a compile. Best-effort — a model that fails to warm
        pages in lazily on first traffic instead."""
        fleet = getattr(handle, "fleet", None)
        if fleet is None:
            return
        for name in fleet.names():
            try:
                fleet.ensure(name)
            except Exception:  # lazy page-in remains the fallback
                log.exception("prewarm of %s failed", name)

    def _await_first_beat(self, rid: str) -> bool:
        """Poll until the newcomer's first self-report lands ALIVE in
        membership (which also re-plans placement over it)."""
        attempts = max(1, int(self.beat_wait_s / 0.05))
        for attempt in range(attempts):
            try:
                self.router.poll_once()
                if (self.router.membership.state(rid) == ALIVE
                        and self.router.membership.payload(rid)):
                    return True
            except KeyError:
                pass
            if attempt + 1 < attempts:
                self._sleep(0.05)
        return False

    # --------------------------------------------------------------- scale-in
    def _plan_scale_in_locked(self, amount: int) -> List[dict]:
        """Pick victims and atomically unmanage + unroute them. Returns
        the drain work list :meth:`_execute_scale_in` runs lock-free."""
        plan: List[dict] = []
        for rid in self._pick_victims_locked(int(amount)):
            handle = self._managed.pop(rid)
            try:
                base_url = self.router.membership.base_url(rid)
                models = sorted(
                    self.router.membership.payload(rid).get("models") or {})
            except KeyError:
                base_url, models = None, []
            # order matters: stop routing FIRST, then drain — anything
            # admitted before removal finishes against leased params
            try:
                self.router.remove_replica(rid)
            except KeyError:
                pass
            plan.append({"rid": rid, "handle": handle,
                         "base_url": base_url, "models": models})
        return plan

    def _execute_scale_in(self, plan: List[dict]) -> int:
        """Drain and stop already-unrouted victims. Runs WITHOUT the
        controller lock: nothing here touches controller state, and the
        HTTP drains can legitimately take their full timeout."""
        done = 0
        for item in plan:
            rid, handle = item["rid"], item["handle"]
            t0 = time.perf_counter()
            for name in item["models"]:
                if item["base_url"] is None:
                    break
                try:
                    self._drain_model(item["base_url"], name)
                except OSError:
                    self._drain_counter("error").inc()
                    log.warning("drain of %s on %s failed; stop() drains "
                                "what remains", name, rid)
            try:
                handle.stop()  # graceful: lease-drains leftovers, closes
            except Exception:  # retirement must not wedge the tick
                log.exception("stop of %s failed", rid)
            self.metrics.histogram(
                "autoscale_scale_seconds", {"direction": "in"},
                help=_SCALE_S_HELP).observe(time.perf_counter() - t0)
            self.metrics.counter(
                "autoscale_retired_total", {"cause": "scale_in"},
                help="managed replicas retired, by cause").inc()
            if _flight.ACTIVE is not None:
                _flight.ACTIVE.record_event("autoscale", "retired",
                                            replica=rid)
            log.info("scaled in replica %s", rid)
            done += 1
        return done

    def _pick_victims_locked(self, amount: int) -> List[str]:
        """The emptiest managed replicas first (self-reported queue depth,
        replica id as the deterministic tiebreak)."""
        loads = []
        for rid in self._managed:
            try:
                if self.router.membership.state(rid) == DEAD:
                    continue
                depth = int(self.router.membership.payload(rid)
                            .get("queue_depth") or 0)
            except KeyError:
                continue
            loads.append((depth, rid))
        loads.sort()
        return [rid for _, rid in loads[:amount]]

    def _drain_model(self, base_url: str, name: str) -> None:
        """Ask the replica itself to drain one model — the same
        ``/v1/admin/drain`` lease discipline the router's demotion path
        uses, so no in-flight batch loses its params."""
        u = urlsplit(base_url)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30.0)
        try:
            conn.request("POST", "/v1/admin/drain",
                         body=json.dumps({"model": name}).encode("utf-8"),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            self._drain_counter("ok" if resp.status == 200 else "error").inc()
            if resp.status != 200:
                log.warning("drain of %s at %s answered %d", name, base_url,
                            resp.status)
        finally:
            conn.close()

    def _drain_counter(self, outcome: str):
        return self.metrics.counter(
            "autoscale_drains_total", {"outcome": outcome},
            help="scale-in /v1/admin/drain requests, by outcome")

    # -------------------------------------------------------------- lifecycle
    def start(self, interval_s: float = 1.0) -> "AutoscaleController":
        """Run :meth:`tick` on a background loop (the production mode; the
        drills call ``tick()`` directly for determinism)."""
        if self._thread is not None:
            raise RuntimeError("autoscale controller already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(float(interval_s),),
            name="autoscale-controller", daemon=True)
        self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception:  # the control loop must not die of one bad tick
                log.exception("autoscale tick failed")

    def stop(self) -> None:
        """Stop the background loop (managed replicas keep running — the
        autoscaler going away must never take capacity with it)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
