"""Federated scrape — the port's copy of
``deeplearning4j_tpu/obs/scrape.py``: every replica's metrics in one
queryable store.

A :class:`FederatedScraper` walks the router's membership table and
pulls each ALIVE replica's structured ``GET /v1/metrics`` snapshot (the
JSON exposition keeps histogram quantiles the text format cannot carry),
plus the router's own in-process registry, into a single
:class:`~.tsdb.TimeSeriesStore` under a ``replica`` label. Dead and
suspect members are *marked stale*, never treated as errors — a scrape
of a degraded cluster is still a successful scrape, it just says less —
and a transport failure to a nominally-ALIVE member soft-stales it the
same way (its series revive on the next answered pull).

Scrapes go through the router's ``_transport`` seam, so chaos-injected
partitions starve the telemetry plane exactly the way they starve
routing — the alert drills in ``chip_smoke.py``'s ``[cluster]`` depend on
that honesty.

No lock is ever held across HTTP: the scraper keeps no shared mutable
state of its own beyond the stop event, and the store takes its own
lock only around in-memory mutation.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from .tsdb import TimeSeriesStore

# Membership states duplicated from cluster.membership to keep obs/ a
# leaf layer (cluster/ imports obs/, never the reverse).
_ALIVE = "alive"


class FederatedScraper:
    """Periodic cluster-wide metrics pull into one TimeSeriesStore.

    ``router`` must expose ``membership`` (ids/state), ``metrics`` (its
    own registry) and ``_transport`` (the chaos-instrumented replica
    HTTP seam). The scraper self-registers as ``router.telemetry`` so
    the router's ``/v1/tsdb`` and ``/v1/alerts`` endpoints find it —
    the same idiom the autoscale controller uses for ``/v1/autoscale``.
    An attached :class:`~.alerts.AlertEngine` is evaluated after every
    scrape, so rules always judge the freshest samples.
    """

    def __init__(self, router, store: Optional[TimeSeriesStore] = None,
                 *, alerts=None, clock=time.monotonic,
                 interval_s: float = 5.0, timeout_s: float = 2.0,
                 metrics=None):
        self._router = router
        self._clock = clock
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._metrics = metrics if metrics is not None else router.metrics
        self.store = store if store is not None else TimeSeriesStore(
            clock=clock, metrics=self._metrics)
        self.alerts = alerts
        self._decisions_seen = 0   # consumed prefix of the decision log
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if hasattr(router, "telemetry"):
            router.telemetry = self

    # ------------------------------------------------------------ scrape
    def scrape_once(self, now: Optional[float] = None) -> Dict[str, str]:
        """One federation pass; returns per-source outcome.

        Outcomes: ``ok`` (snapshot ingested), ``stale`` (member dead or
        suspect — skipped by design), ``error`` (transport or decode
        failure — member soft-staled). Never raises for a sick member.
        """
        t = self._clock() if now is None else float(now)
        outcomes: Dict[str, str] = {}
        outcomes["router"] = self._pull_router(t)
        decisions = self._pull_decisions(t)
        if decisions is not None:
            outcomes["autoscale"] = decisions
        members = sorted(self._router.membership.ids())
        for rid in members:
            outcomes[rid] = self._pull_replica(rid, t)
        # a source that left membership entirely (reaped replica) stops
        # being pulled — soft-stale whatever it last reported so its
        # serve_* series don't impersonate a live member forever
        for source in self.store.sources():
            if source != "router" and source not in members:
                self.store.mark_stale(source, now=t)
        for source in sorted(outcomes):
            outcome = outcomes[source]
            self._metrics.counter(
                "tsdb_scrapes_total", {"source": source, "outcome": outcome},
                help="Federated scrape passes by source and outcome").inc()
        if self.alerts is not None:
            self.alerts.evaluate(now=t)
        return outcomes

    def _pull_router(self, t: float) -> str:
        try:
            snap = self._router.metrics.snapshot()
        except Exception:  # a broken registry must not kill the scrape loop
            self.store.mark_stale("router", now=t)
            return "error"
        self.store.ingest("router", snap, now=t,
                          extra_labels={"replica": "router"})
        return "ok"

    def _pull_replica(self, rid: str, t: float) -> str:
        try:
            state = self._router.membership.state(rid)
        except KeyError:
            # removed between ids() and here: its series were tombstoned
            # by the router registry's own presence diff
            return "stale"
        if state != _ALIVE:
            self.store.mark_stale(rid, now=t)
            return "stale"
        try:
            status, body, _ = self._router._transport(
                rid, "GET", "/v1/metrics", None, {}, self.timeout_s)
            if status != 200:
                raise OSError(f"scrape status {status}")
            snap = json.loads(body)
            if not isinstance(snap, dict):
                raise ValueError("snapshot is not an object")
        except (OSError, ValueError):
            # unreachable != removed: soft-stale, revives on next answer
            self.store.mark_stale(rid, now=t)
            return "error"
        self.store.ingest(rid, snap, now=t, extra_labels={"replica": rid})
        return "ok"

    def _pull_decisions(self, t: float) -> Optional[str]:
        """Ingest the autoscaler's canonical decision log as
        ``autoscale_decision{direction,reason}`` instants.

        The controller's ``decision_log`` is append-only canonical JSON
        lines; the scraper consumes the unseen suffix each pass and
        stamps every actuating (non-hold) decision at its own evidence
        time — so a dashboard overlays the decision exactly on the burn
        sample it reacted to, not at scrape time. Instants go through
        :meth:`~.tsdb.TimeSeriesStore.append_instant`, outside the
        presence-diff tombstoning a scrape snapshot implies. Returns
        None (no outcome row) when no autoscaler is attached, keeping
        the scrape label sets of autoscaler-less fleets unchanged.
        """
        ctl = getattr(self._router, "autoscaler", None)
        log = getattr(ctl, "decision_log", None)
        if log is None:
            return None
        # snapshot the length first: the controller appends under its
        # own lock and list appends are atomic, so the slice below is a
        # stable prefix even mid-tick
        end = len(log)
        lines = log[self._decisions_seen:end]
        self._decisions_seen = end
        for line in lines:
            try:
                rec = json.loads(line)
                decision = rec.get("decision") or {}
                direction = str(decision.get("direction", "hold"))
                if direction == "hold":
                    continue  # holds every tick would drown the overlay
                labels = {"direction": direction,
                          "reason": str(decision.get("reason", ""))}
                at = (decision.get("evidence") or {}).get("t", t)
                value = rec.get("actuated", decision.get("amount", 0))
                self.store.append_instant(
                    "autoscale_decision", labels, float(value or 0),
                    now=float(at), source="autoscale")
            except (ValueError, TypeError):
                continue  # one malformed line must not stall the stream
        return "ok"

    # -------------------------------------------------------- background
    def start(self) -> None:
        """Run the scrape loop on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-scraper", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # the loop outlives any single bad pass
                pass

    def stop(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5.0)
            self._thread = None
