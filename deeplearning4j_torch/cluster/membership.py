"""Replica membership — heartbeat leases with an injectable clock; the
port's copy of ``deeplearning4j_tpu/cluster/membership.py``.

A replica set is only as good as its failure detector. This one is the
classic lease scheme: every successful heartbeat (the router polling a
replica's ``GET /v1/replica``) renews a lease; a replica whose lease age
crosses ``suspect_after_s`` is **suspect** (routed to only as a last
resort), past ``dead_after_s`` it is **dead** (never routed to, and its
models are re-placed). A transport-level failure observed by the router —
connection refused, reset, timeout — demotes the replica to suspect
*immediately* via :meth:`miss` rather than waiting out the lease, because
a refused connection is better evidence than a stale timer.

States only ever move along ``alive -> suspect -> dead`` by timeout and
jump back to ``alive`` on a successful beat; there is no half-dead
purgatory to reason about. Everything is driven by an injectable ``clock``
so tests (and the chaos drill) walk the state machine on a simulated
timeline — the same discipline as the circuit breaker.

Each beat carries the replica's self-report (resident models with their
``weight_bytes``, HBM budget, queue depth, readiness); membership is the
single source the placement planner reads, so "who is alive" and "what do
they hold" can never disagree about which snapshot they came from.

Exported metrics: ``cluster_replica_state{replica}`` (0 alive / 1 suspect
/ 2 dead), ``cluster_heartbeats_total{replica,outcome}`` and
``cluster_replica_transitions_total{replica,to}`` — replica ids are a
small fixed set per deployment, so the label stays bounded. A replica
retired via :meth:`Membership.remove` (autoscaler scale-in, dead-replica
cleanup) has its state gauge series *deleted* — only live instances are
scraped — while the transitions counter keeps a ``to="retired"`` record.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import flight as _flight

log = logging.getLogger(__name__)

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

_STATE_N = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


class ReplicaInfo:
    """One replica's membership record."""

    __slots__ = ("replica_id", "base_url", "state", "last_beat", "beats",
                 "payload")

    def __init__(self, replica_id: str, base_url: str, now: float):
        self.replica_id = replica_id
        self.base_url = base_url
        self.state = ALIVE
        self.last_beat = now      # registration grants the first lease
        self.beats = 0
        self.payload: dict = {}   # last self-report (models, budget, queue)


class Membership:
    """Thread-safe lease table over a fixed replica set."""

    def __init__(self, *, suspect_after_s: float = 2.0,
                 dead_after_s: float = 6.0,
                 clock: Callable[[], float] = time.monotonic, metrics=None):
        if suspect_after_s <= 0 or dead_after_s <= suspect_after_s:
            raise ValueError("need 0 < suspect_after_s < dead_after_s")
        self.suspect_after_s = float(suspect_after_s)
        self.dead_after_s = float(dead_after_s)
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaInfo] = {}

    # ------------------------------------------------------------- plumbing
    def _set_state_locked(self, info: ReplicaInfo, to: str) -> None:
        if info.state == to:
            return
        info.state = to
        # replica ids label time series safely: the set is bounded by
        # explicit add() registration, never grown by request traffic
        rid = info.replica_id
        if self._metrics is not None:
            self._metrics.gauge(
                "cluster_replica_state", {"replica": rid},
                help="replica membership state: 0=alive 1=suspect 2=dead"
            ).set(_STATE_N[to])
            self._metrics.counter(
                "cluster_replica_transitions_total",
                {"replica": rid, "to": to},
                help="replica membership state transitions").inc()
        if _flight.ACTIVE is not None:
            _flight.ACTIVE.record_event("membership", to,
                                        replica=info.replica_id)
        log.log(logging.WARNING if to != ALIVE else logging.INFO,
                "replica %s -> %s", info.replica_id, to)

    def _beat_counter(self, rid: str, outcome: str):
        if self._metrics is None:
            return None
        return self._metrics.counter(
            "cluster_heartbeats_total",
            {"replica": rid, "outcome": outcome},
            help="heartbeat polls by replica and outcome")

    # -------------------------------------------------------------- surface
    def add(self, replica_id: str, base_url: str) -> None:
        """Register a replica; registration grants its first lease (it has
        ``suspect_after_s`` to answer its first poll)."""
        now = self._clock()
        with self._lock:
            if replica_id in self._replicas:
                raise ValueError(f"replica {replica_id!r} already registered")
            info = ReplicaInfo(replica_id, base_url, now)
            self._replicas[replica_id] = info
            self._set_state_locked(info, ALIVE)
            rid = replica_id
            if self._metrics is not None:
                # emit the gauge even before the first transition
                self._metrics.gauge(
                    "cluster_replica_state", {"replica": rid},
                    help="replica membership state: 0=alive 1=suspect 2=dead"
                ).set(_STATE_N[ALIVE])

    def remove(self, replica_id: str) -> None:
        """Retire a replica: drop its record AND its
        ``cluster_replica_state`` gauge series, so scrapes never show a
        ghost instance (a retired replica is not *dead* — it is gone, and
        a state gauge for something gone is a lie). The transitions
        counter records the retirement instead: counters keep history,
        gauges describe the present. This is the autoscaler's scale-in
        path and the cleanup for replicas that died mid-sweep."""
        with self._lock:
            info = self._replicas.pop(replica_id, None)
        if info is None:
            raise KeyError(f"replica {replica_id!r} not registered")
        # bounded label set: ids only ever come from explicit add()
        rid = replica_id
        if self._metrics is not None:
            self._metrics.remove_series("cluster_replica_state",
                                        {"replica": rid})
            self._metrics.counter(
                "cluster_replica_transitions_total",
                {"replica": rid, "to": "retired"},
                help="replica membership state transitions").inc()
        if _flight.ACTIVE is not None:
            _flight.ACTIVE.record_event("membership", "retired",
                                        replica=replica_id)
        log.info("replica %s retired", replica_id)

    def report(self, replica_id: str, payload: Optional[dict] = None) -> None:
        """One successful heartbeat: renew the lease, store the
        self-report, and resurrect from suspect/dead."""
        now = self._clock()
        c = self._beat_counter(replica_id, "ok")
        with self._lock:
            info = self._replicas[replica_id]
            info.last_beat = now
            info.beats += 1
            if payload is not None:
                info.payload = payload
            self._set_state_locked(info, ALIVE)
        if c is not None:
            c.inc()

    def miss(self, replica_id: str) -> None:
        """A failed poll or proxy hop: immediate demotion to suspect (the
        lease clock then escalates to dead via :meth:`sweep`)."""
        c = self._beat_counter(replica_id, "miss")
        with self._lock:
            info = self._replicas.get(replica_id)
            if info is not None and info.state == ALIVE:
                self._set_state_locked(info, SUSPECT)
        if c is not None:
            c.inc()

    def sweep(self) -> Dict[str, str]:
        """Advance every replica's state by lease age; returns the full
        ``{replica: state}`` map after the sweep."""
        now = self._clock()
        with self._lock:
            out = {}
            for info in self._replicas.values():
                age = now - info.last_beat
                if age >= self.dead_after_s:
                    self._set_state_locked(info, DEAD)
                elif age >= self.suspect_after_s and info.state == ALIVE:
                    self._set_state_locked(info, SUSPECT)
                out[info.replica_id] = info.state
            return out

    def state(self, replica_id: str) -> str:
        with self._lock:
            return self._replicas[replica_id].state

    def base_url(self, replica_id: str) -> str:
        with self._lock:
            return self._replicas[replica_id].base_url

    def payload(self, replica_id: str) -> dict:
        with self._lock:
            return dict(self._replicas[replica_id].payload)

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def routable(self) -> List[str]:
        """Replicas worth sending traffic to: alive first (registration
        order), then suspect as a last resort; dead never."""
        with self._lock:
            infos = list(self._replicas.values())
        return ([i.replica_id for i in infos if i.state == ALIVE]
                + [i.replica_id for i in infos if i.state == SUSPECT])

    def snapshot(self) -> dict:
        """JSON-safe view for ``GET /v1/cluster``."""
        now = self._clock()
        with self._lock:
            return {
                i.replica_id: {
                    "state": i.state, "base_url": i.base_url,
                    "beats": i.beats,
                    "lease_age_s": round(now - i.last_beat, 3),
                    "report": dict(i.payload),
                } for i in self._replicas.values()}
