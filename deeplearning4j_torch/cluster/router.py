"""Cluster router — one front door over N FleetServer replicas; the port's
copy of ``deeplearning4j_tpu/cluster/router.py`` (stdlib only: every device
concern stays inside the replicas).

The router owns the cluster-level concerns the replicas cannot see:

- **routing**: ``POST /v1/models/{name}/predict|generate`` is proxied to
  the model's placement candidates (:mod:`.placement`), alive replicas
  first (:mod:`.membership`);
- **failover**: a connection failure, or a 5xx answer (for idempotent
  predicts; for generates only the typed *pre-admission* refusals — see
  ``PRE_ADMISSION_CAUSES``), triggers at most ONE re-route to the next
  candidate. 4xx and quota answers never fail over: the request itself is
  wrong, and hammering a second replica with it helps nobody.
- **hedging**: a gold-class predict that has not answered within
  ``hedge_ms`` launches a second attempt on the next candidate;
  first response wins and the loser's connection is closed (the loser
  replica sees a vanished client and sheds the work as
  ``cause="client_gone"``). Only predicts hedge — a hedged generate would
  decode the same tokens twice.
- **retry budget**: every admitted request deposits ``ratio`` tokens
  (capped); every failover or hedge spends one. When the budget is dry,
  errors surface instead of re-routing — an outage can degrade answers
  but can never be amplified into a retry storm.
- **global tenant quotas**: the router's own :class:`TenantTable` debits
  one central bucket per tenant, so a quota holds across replicas instead
  of multiplying by the fleet size.
- **burn accounting**: one :class:`SloBurn` keyed by model (the number an
  SLO dashboard alerts on) and one keyed by replica (the number that says
  *which instance* is sick).

Every hop to a replica passes the ``cluster.transport`` chaos seam with
``scope=replica_id``, so the drill can partition exactly one replica. The
router forwards its request-trace ``traceparent`` on every attempt —
in-process replicas share the process-global tracer, so a hedged request's
two attempts stitch into one track in the Perfetto dump.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import re
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..chaos import faults as _faults
from ..fleet.tenants import QuotaError, TenantTable
from ..obs import reqtrace as _rt
from ..obs.metrics import MetricsRegistry
from ..obs.slo import SloBurn
from ..serve.errors import ServeError, ShedError
from ..serve.http import jitter_retry_after
from ..utils.httpd import JsonHTTPServerMixin, JsonRequestHandler
from .membership import ALIVE, DEAD, SUSPECT, Membership
from .placement import Placement

log = logging.getLogger(__name__)

_MODEL_ROUTE = re.compile(r"^/v1/models/([^/]+)/(predict|generate)$")


def _qfloat(q: Dict[str, list], key: str) -> Optional[float]:
    """First query-string value as float, or None when absent."""
    vals = q.get(key)
    return float(vals[0]) if vals else None


def _qflag(q: Dict[str, list], key: str) -> bool:
    vals = q.get(key)
    return bool(vals) and vals[0] in ("1", "true", "yes")



_BAD_REQUEST = (KeyError, ValueError, TypeError, AttributeError,
                json.JSONDecodeError)
_HTTP_ERRORS_HELP = "non-2xx HTTP answers by endpoint and status code"

#: Typed causes a replica answers BEFORE admitting non-idempotent work
#: into its batcher. Only these make a *generate* failover-safe: the
#: refused replica provably never started decoding, so a re-route cannot
#: run the same generation twice.
PRE_ADMISSION_CAUSES = frozenset(
    {"shutting_down", "queue_full", "worker_dead", "breaker_open"})


class NoReplicaError(ShedError):
    """No routable replica for this model — every candidate is dead or the
    membership table is empty (HTTP 503)."""

    cause = "no_replica"


class RetryBudget:
    """Global token bucket that caps re-routes, refilled by traffic volume.

    Each admitted request deposits ``ratio`` tokens (so at ratio 0.1 the
    cluster re-routes at most ~10% of its traffic), capped at ``cap`` so a
    quiet period cannot bank an unbounded burst. Each failover or hedge
    spends one whole token; ``spend()`` refusing is the backstop that
    keeps a fleet-wide outage from turning every request into N requests.
    """

    def __init__(self, ratio: float = 0.1, cap: float = 10.0, metrics=None):
        if ratio <= 0 or cap < 1:
            raise ValueError("need ratio > 0 and cap >= 1")
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = float(cap)  # start full: first failures can re-route
        self._lock = threading.Lock()
        self._metrics = metrics
        self._gauge = None if metrics is None else metrics.gauge(
            "cluster_retry_budget_tokens",
            help="retry-budget tokens available for failover/hedging")
        if self._gauge is not None:
            self._gauge.set(self._tokens)

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)
            tokens = self._tokens
        if self._gauge is not None:
            self._gauge.set(tokens)

    def spend(self) -> bool:
        with self._lock:
            ok = self._tokens >= 1.0
            if ok:
                self._tokens -= 1.0
            tokens = self._tokens
        if self._gauge is not None:
            self._gauge.set(tokens)
        if self._metrics is not None:
            self._metrics.counter(
                "cluster_retry_budget_spend_total",
                {"outcome": "granted" if ok else "denied"},
                help="retry-budget spend attempts by outcome").inc()
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3), "cap": self.cap,
                    "ratio": self.ratio}


class _Attempt:
    """One proxy hop's outcome (or in-flight connection, for hedging)."""

    __slots__ = ("replica", "status", "data", "headers", "exc", "conn")

    def __init__(self, replica: str):
        self.replica = replica
        self.status: Optional[int] = None
        self.data: Optional[bytes] = None
        self.headers: Dict[str, str] = {}
        self.exc: Optional[BaseException] = None
        self.conn = None


class ClusterRouter(JsonHTTPServerMixin):
    """Replica-set front door: membership + placement + failover/hedging."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 9030,
                 metrics: Optional[MetricsRegistry] = None,
                 tenants: Optional[TenantTable] = None,
                 suspect_after_s: float = 2.0, dead_after_s: float = 6.0,
                 heartbeat_s: float = 0.5, hedge_ms: Optional[float] = 250.0,
                 retry_budget_ratio: float = 0.1,
                 retry_budget_cap: float = 10.0,
                 http_timeout_s: float = 30.0, clock=time.monotonic,
                 jitter_rng=None):
        self.host = host
        self.port = port
        # injectable Retry-After jitter source (None = process-global RNG);
        # replays pass random.Random(seed) for bit-deterministic backoff
        self.jitter_rng = jitter_rng
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.membership = Membership(
            suspect_after_s=suspect_after_s, dead_after_s=dead_after_s,
            clock=clock, metrics=self.metrics)
        self.placement = Placement(metrics=self.metrics)
        # ROUTER-side tenant buckets: ONE bucket per tenant for the whole
        # cluster, so a tenant's rate cannot multiply by the replica count
        self.tenants = tenants if tenants is not None \
            else TenantTable(metrics=self.metrics)
        self.slo = SloBurn(self.metrics, clock=clock)
        self.replica_slo = SloBurn(self.metrics, clock=clock,
                                   key_label="replica")
        self.retry_budget = RetryBudget(retry_budget_ratio, retry_budget_cap,
                                        metrics=self.metrics)
        self.heartbeat_s = float(heartbeat_s)
        self.hedge_ms = hedge_ms
        self.http_timeout_s = float(http_timeout_s)
        self._plan: Dict[str, List[str]] = {}
        self._plan_sig: Optional[tuple] = None
        self._plan_lock = threading.Lock()
        self._lifecycle_lock = threading.Lock()
        self._accepting = True
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        #: The attached AutoscaleController, if any (it registers itself);
        #: surfaced on ``/v1/cluster`` so one GET shows fleet + policy state.
        self.autoscaler = None
        #: The attached FederatedScraper-shaped telemetry plane, if any;
        #: backs ``/v1/tsdb`` range queries and ``/v1/alerts`` (None:
        #: both answer 404, as the reference does without one).
        self.telemetry = None

    # ------------------------------------------------------------ membership
    def add_replica(self, replica_id: str, base_url: str) -> None:
        """Register one replica (``base_url`` like ``http://127.0.0.1:9021``)."""
        self.membership.add(replica_id, base_url)

    def remove_replica(self, replica_id: str) -> None:
        """Retire one replica: its membership record and state-gauge series
        go away (scrapes must not show ghost instances) and placement
        re-plans immediately over the survivors. Removal only stops NEW
        traffic — the caller owns draining the replica itself (the
        autoscale controller removes first, then drains, so anything
        already admitted finishes against leased params)."""
        self.membership.remove(replica_id)
        with self._plan_lock:
            self._plan_sig = None  # live set shrank: force a rebuild
        self._replan()

    def start(self, background: bool = True):
        out = super().start(background=background)
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name="cluster-heartbeat", daemon=True)
        self._hb_thread.start()
        return out

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_s):
            try:
                self.poll_once()
            except Exception:  # the failure detector must not die of a failure
                log.exception("heartbeat poll failed")

    def poll_once(self) -> Dict[str, str]:
        """One full heartbeat round: poll every replica's ``/v1/replica``,
        sweep lease ages, rebuild placement, drain demoted residents.
        Public so tests and the smoke can drive membership deterministically
        without racing the background thread."""
        for rid in self.membership.ids():
            try:
                status, data, _ = self._transport(
                    rid, "GET", "/v1/replica", None, {},
                    timeout=max(self.heartbeat_s, 1.0))
                if status == 200:
                    self.membership.report(rid, json.loads(data))
                else:
                    self.membership.miss(rid)
            except (OSError, ValueError):
                self.membership.miss(rid)
        states = self.membership.sweep()
        for rid, st in states.items():
            if st == DEAD:
                # a dead replica records no more outcomes, so its burn
                # gauges would freeze at their last value forever — retire
                # them so dashboards and alert rules see absence, not a
                # permanently stale spike
                self.replica_slo.forget(rid)
        self._replan()
        self._demote()
        return states

    def _replan(self) -> None:
        """Rebuild placement when the live set or the model catalog (names
        + weights) changed; queue-depth drift alone never triggers it."""
        live: Dict[str, dict] = {}
        models: Dict[str, int] = {}
        for rid in self.membership.ids():
            if self.membership.state(rid) == DEAD:
                continue
            p = self.membership.payload(rid)
            live[rid] = {"hbm_budget_bytes": p.get("hbm_budget_bytes"),
                         "queue_depth": int(p.get("queue_depth") or 0)}
            for name, info in (p.get("models") or {}).items():
                w = int(info.get("weight_bytes") or 0)
                models[name] = max(models.get(name, 0), w)
        sig = (tuple(sorted(live)), tuple(sorted(models.items())))
        with self._plan_lock:
            if sig == self._plan_sig:
                return
            self._plan = self.placement.plan(models, live)
            self._plan_sig = sig

    def _demote(self) -> None:
        """A model resident on a non-primary replica while its primary is
        alive and serving it is paying HBM twice: ask the straggler to
        drain it (``POST /v1/admin/drain``). Failover traffic re-pages it
        on demand if it is ever needed again."""
        with self._plan_lock:
            plan = {n: list(c) for n, c in self._plan.items()}
        for name, cands in plan.items():
            if not cands:
                continue
            primary = cands[0]
            if self.membership.state(primary) != ALIVE:
                continue
            p_models = self.membership.payload(primary).get("models") or {}
            if not (p_models.get(name) or {}).get("resident"):
                continue
            for rid in cands[1:]:
                if self.membership.state(rid) == DEAD:
                    continue
                r_models = self.membership.payload(rid).get("models") or {}
                if not (r_models.get(name) or {}).get("resident"):
                    continue
                try:
                    status, _, _ = self._transport(
                        rid, "POST", "/v1/admin/drain",
                        json.dumps({"model": name}).encode(),
                        {"Content-Type": "application/json"})
                except OSError:
                    self.membership.miss(rid)
                    continue
                if status == 200:
                    self.metrics.counter(
                        "cluster_demotions_total", {"replica": rid},
                        help="models drained off non-primary replicas").inc()

    def candidates(self, name: str) -> List[str]:
        """Routing order for one model: the placement candidates filtered
        to routable states (alive before suspect, dead never); falls back
        to every registered replica before the first plan exists."""
        with self._plan_lock:
            cands = list(self._plan.get(name, []))
        if not cands:
            cands = self.membership.ids()
        alive = [r for r in cands if self.membership.state(r) == ALIVE]
        suspect = [r for r in cands if self.membership.state(r) == SUSPECT]
        return alive + suspect

    # ------------------------------------------------------------- transport
    def _open(self, replica_id: str, method: str, path: str,
              body: Optional[bytes], headers: Dict[str, str],
              timeout: Optional[float] = None):
        """Open one hop: returns ``(conn, resp)`` with the response headers
        read but the body left unconsumed (streaming callers pump it). The
        chaos seam fires BEFORE the connection opens, scoped to the target
        replica, so an armed partition looks like a dead TCP peer."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.hit("cluster.transport", scope=replica_id)
        u = urlsplit(self.membership.base_url(replica_id))
        conn = http.client.HTTPConnection(
            u.hostname, u.port,
            timeout=timeout if timeout is not None else self.http_timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        return conn, resp

    def _transport(self, replica_id: str, method: str, path: str,
                   body: Optional[bytes], headers: Dict[str, str],
                   timeout: Optional[float] = None
                   ) -> Tuple[int, bytes, Dict[str, str]]:
        """One buffered hop; always closes the connection."""
        conn, resp = self._open(replica_id, method, path, body, headers,
                                timeout=timeout)
        try:
            return resp.status, resp.read(), dict(resp.getheaders())
        finally:
            conn.close()

    # ---------------------------------------------------------------- serving
    def ready(self) -> bool:
        with self._lifecycle_lock:
            accepting = self._accepting
        return accepting and bool(self.membership.routable())

    def accepting(self) -> bool:
        with self._lifecycle_lock:
            return self._accepting

    def _metric_route(self, path: str) -> str:
        m = _MODEL_ROUTE.match(path)
        if m:
            return f"/v1/models/{{name}}/{m.group(2)}"
        return path

    def _requests_total(self, outcome: str):
        return self.metrics.counter(
            "cluster_requests_total", {"outcome": outcome},
            help="routed requests by final outcome")

    def _failover_total(self, reason: str):
        return self.metrics.counter(
            "cluster_failover_total", {"reason": reason},
            help="re-routes to a failover candidate, by trigger")

    def _hedges_total(self, outcome: str):
        return self.metrics.counter(
            "cluster_hedges_total", {"outcome": outcome},
            help="hedged second attempts by outcome")

    def _attempt_buffered(self, rid: str, path: str, body: bytes,
                          headers: Dict[str, str], ctx, hedge: bool,
                          conns: Optional[dict] = None,
                          idx: int = 0) -> _Attempt:
        """One buffered proxy attempt, recorded as an ``attempt`` stage on
        the request trace (runs on hedge threads too — ``add_stage`` is
        thread-safe and stamps the calling thread's id). The live
        connection is published into ``conns[idx]`` before any blocking
        I/O so a racing winner can cancel this attempt by closing it."""
        att = _Attempt(rid)
        t0 = time.perf_counter_ns()
        try:
            if _faults.ACTIVE is not None:
                _faults.ACTIVE.hit("cluster.transport", scope=rid)
            u = urlsplit(self.membership.base_url(rid))
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=self.http_timeout_s)
            att.conn = conn
            if conns is not None:
                conns[idx] = conn
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            att.status = resp.status
            att.data = resp.read()
            att.headers = dict(resp.getheaders())
        except BaseException as e:  # a failed attempt is data, not a crash
            att.exc = e
        finally:
            if att.conn is not None:
                att.conn.close()
            if ctx is not None:
                ctx.add_stage(
                    "attempt", t0, time.perf_counter_ns(), replica=rid,
                    hedge=hedge,
                    status=att.status if att.status is not None
                    else f"error:{type(att.exc).__name__}")
        return att

    def _record_attempt(self, att: _Attempt, slo_class: str) -> None:
        """Per-replica burn: 2xx good, 5xx/transport bad, 4xx ignored."""
        if att.exc is not None or (att.status or 500) >= 500:
            self.replica_slo.record(att.replica, slo_class, good=False)
        elif att.status < 400:
            self.replica_slo.record(att.replica, slo_class, good=True)

    def _route_predict(self, handler, name: str, body: bytes,
                       headers: Dict[str, str], slo_class: str, ctx) -> str:
        """Proxy one predict with failover + gold-class hedging. Predicts
        are idempotent, so ANY 5xx or transport failure is failover-
        eligible; at most one extra attempt, gated on the retry budget.
        Returns the outcome tag for ``cluster_requests_total``."""
        cands = self.candidates(name)
        if not cands:
            raise NoReplicaError(f"no routable replica for model {name!r}")
        path = f"/v1/models/{name}/predict"
        hedge_s = (self.hedge_ms / 1e3
                   if self.hedge_ms is not None and slo_class == "gold"
                   and len(cands) > 1 else None)
        results: "queue.Queue[Tuple[int, _Attempt]]" = queue.Queue()
        conns: Dict[int, object] = {}

        def run(i: int, rid: str, hedge: bool) -> None:
            results.put((i, self._attempt_buffered(
                rid, path, body, headers, ctx, hedge, conns, i)))

        threading.Thread(target=run, args=(0, cands[0], False),
                         name="cluster-attempt", daemon=True).start()
        launched, pending, hedged = 1, 1, False
        failed: List[_Attempt] = []
        win_i, win = -1, None
        while pending:
            wait_s = (hedge_s if hedge_s is not None and launched == 1
                      else None)
            try:
                i, att = results.get(timeout=wait_s)
            except queue.Empty:
                # gold hedge: the primary is slow, race the next candidate
                if self.retry_budget.spend():
                    self._hedges_total("launched").inc()
                    hedged = True
                    threading.Thread(target=run, args=(1, cands[1], True),
                                     name="cluster-hedge",
                                     daemon=True).start()
                    launched += 1
                    pending += 1
                else:
                    hedge_s = None  # budget dry: just wait out the primary
                continue
            pending -= 1
            self._record_attempt(att, slo_class)
            if att.exc is None and (att.status or 500) < 500:
                win_i, win = i, att
                break  # first usable response wins
            if att.exc is not None:
                self.membership.miss(att.replica)
            failed.append(att)
            # failover: one re-route, budget-gated (a launched hedge IS the
            # re-route — it never stacks a third attempt)
            if launched == 1 and len(cands) > 1 and self.retry_budget.spend():
                self._failover_total(
                    "connect" if att.exc is not None else "status").inc()
                threading.Thread(target=run, args=(1, cands[1], False),
                                 name="cluster-failover",
                                 daemon=True).start()
                launched += 1
                pending += 1
        if win is not None:
            # loser cancellation: closing the in-flight connection makes
            # the slower replica see a vanished client (client_gone shed)
            for j, c in list(conns.items()):
                if j != win_i:
                    try:
                        # shutdown() wakes a recv() blocked in another
                        # thread; close() alone would leave it hanging
                        sock = getattr(c, "sock", None)
                        if sock is not None:
                            sock.shutdown(socket.SHUT_RDWR)
                        c.close()
                    except OSError:
                        pass
            # a closed socket unwinds the loser in microseconds; give it a
            # bounded beat so its attempt stage lands inside this request's
            # record (the Perfetto event is emitted either way)
            while pending:
                try:
                    results.get(timeout=0.2)
                    pending -= 1
                except queue.Empty:
                    break
            if hedged:
                self._hedges_total("won" if win_i == 1
                                   else "primary_won").inc()
            self._reply_upstream(handler, win)
            self.slo.record(name, slo_class, good=win.status < 400)
            if win_i == 0:
                return "ok"
            return "hedged_ok" if hedged else "failover_ok"
        # every attempt failed: surface the best evidence we have —
        # a typed upstream answer beats a synthesized transport error
        self.slo.record(name, slo_class, good=False)
        answered = [a for a in failed if a.exc is None]
        if answered:
            self._reply_upstream(handler, answered[-1], error=True)
        else:
            handler.route_err(503, {
                "error": f"no replica reachable for model {name!r}",
                "cause": "upstream_unreachable"},
                headers={"Retry-After": jitter_retry_after(
                    1.0, self.jitter_rng)})
        return "error"

    def _reply_upstream(self, handler, att: _Attempt,
                        error: bool = False) -> None:
        """Relay an upstream answer verbatim (status, JSON body, and the
        backpressure/tracing headers that matter to the client). A
        success's body goes out as the replica wrote it: parsing and
        re-encoding a predict's answer (about 12 MB of JSON at 16 tokens)
        held the interpreter lock that the in-process replicas share."""
        keep = {k: v for k, v in att.headers.items()
                if k.lower() in ("retry-after", "x-request-id")}
        if not error and att.status < 400 and att.data:
            handler.reply(att.status, att.data.decode("utf-8"),
                          headers=keep or None)
            return
        try:
            payload = json.loads(att.data) if att.data else {}
        except ValueError:
            payload = {"raw": att.data.decode("utf-8", "replace")}
        if error or att.status >= 400:
            handler.route_err(att.status, payload, headers=keep or None)
        else:
            handler.reply(att.status, payload, headers=keep or None)

    def _route_generate(self, handler, name: str, body: bytes,
                        headers: Dict[str, str], slo_class: str, ctx,
                        query: str = "") -> str:
        """Proxy one generate with *pre-admission-only* failover and no
        hedging: once a replica answers 200 the work is admitted and owned
        by that replica — an upstream death mid-stream surfaces as an
        in-band error event, never as a second generation."""
        cands = self.candidates(name)
        if not cands:
            raise NoReplicaError(f"no routable replica for model {name!r}")
        path = f"/v1/models/{name}/generate" + (f"?{query}" if query else "")
        last: Optional[_Attempt] = None
        for idx, rid in enumerate(cands[:2]):
            if idx > 0 and not self.retry_budget.spend():
                break
            att = _Attempt(rid)
            t0 = time.perf_counter_ns()
            try:
                conn, resp = self._open(rid, "POST", path, body, headers)
            except BaseException as e:
                if not isinstance(e, OSError):
                    raise
                att.exc = e
                if ctx is not None:
                    ctx.add_stage("attempt", t0, time.perf_counter_ns(),
                                  replica=rid, hedge=False,
                                  status=f"error:{type(e).__name__}")
                self._record_attempt(att, slo_class)
                self.membership.miss(rid)
                self._failover_total("connect").inc()
                last = att
                continue  # connect failure: provably pre-admission
            att.status = resp.status
            if resp.status != 200:
                att.data = resp.read()
                att.headers = dict(resp.getheaders())
                conn.close()
                if ctx is not None:
                    ctx.add_stage("attempt", t0, time.perf_counter_ns(),
                                  replica=rid, hedge=False,
                                  status=resp.status)
                self._record_attempt(att, slo_class)
                last = att
                try:
                    cause = json.loads(att.data).get("cause")
                except ValueError:
                    cause = None
                if cause in PRE_ADMISSION_CAUSES:
                    # typed refusal BEFORE admission: safe to re-route
                    self._failover_total("status").inc()
                    continue
                break  # admitted-then-failed, 4xx, or quota: surface it
            # 200: the stream is committed to THIS replica
            outcome = self._pump_sse(handler, conn, resp, ctx, t0, rid)
            self._record_attempt(att, slo_class)
            self.slo.record(name, slo_class,
                            good=outcome == "ok")
            return "ok" if outcome == "ok" else "error"
        self.slo.record(name, slo_class, good=False)
        if last is not None and last.exc is None:
            self._reply_upstream(handler, last, error=True)
        else:
            handler.route_err(503, {
                "error": f"no replica reachable for model {name!r}",
                "cause": "upstream_unreachable"},
                headers={"Retry-After": jitter_retry_after(
                    1.0, self.jitter_rng)})
        return "error"

    def _pump_sse(self, handler, conn, resp, ctx, t0_ns: int,
                  rid: str) -> str:
        """Relay an upstream SSE stream line-by-line. An upstream death
        mid-stream becomes an in-band error event (the client already got
        a 200); a CLIENT death closes the upstream connection, which the
        replica's own client-gone path turns into a freed decode slot."""
        handler.send_response(200)
        for k, v in resp.getheaders():
            if k.lower() in ("content-type", "cache-control",
                             "x-request-id", "traceparent"):
                handler.send_header(k, v)
        handler.send_header("Connection", "close")
        handler.end_headers()
        handler.close_connection = True
        outcome = "ok"
        try:
            try:
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    handler.wfile.write(line)
                    if line == b"\n":
                        handler.wfile.flush()
                handler.wfile.flush()
            except (http.client.HTTPException, OSError) as e:
                if isinstance(e, (BrokenPipeError, ConnectionResetError)):
                    raise  # client side died — outer handler accounts it
                # upstream died mid-stream: in-band typed error, NO failover
                # (the generation was admitted; re-running it is not safe)
                handler.wfile.write(
                    b"data: " + json.dumps(
                        {"error": "replica connection lost mid-stream",
                         "cause": "upstream_gone", "replica": rid}).encode()
                    + b"\n\n")
                handler.wfile.flush()
                outcome = "upstream_gone"
                self.membership.miss(rid)
        finally:
            conn.close()
            if ctx is not None:
                ctx.add_stage("attempt", t0_ns, time.perf_counter_ns(),
                              replica=rid, hedge=False,
                              status=200 if outcome == "ok" else outcome)
                if outcome != "ok":
                    ctx.finish(error=outcome)
        return outcome

    # -------------------------------------------------------------- handler
    def _handler(self):
        server = self

        class Handler(JsonRequestHandler):
            owner = server

            def _tenant(self) -> str:
                return self.headers.get("X-Tenant", "anonymous")

            def route_err(self, code, body, headers=None):
                server.metrics.counter(
                    "serve_http_errors_total",
                    {"endpoint":
                     server._metric_route(self.path.split("?", 1)[0]),
                     "code": str(code)},
                    help=_HTTP_ERRORS_HELP).inc()
                self.reply(code, body, headers=headers)

            def reply(self, code, payload, ctype="application/json",
                      headers=None):
                ctx = getattr(self, "_obs_ctx", None)
                if ctx is None:
                    super().reply(code, payload, ctype, headers)
                    return
                headers = dict(headers or {})
                headers.setdefault("X-Request-Id", ctx.request_id)
                headers.setdefault("traceparent", ctx.traceparent())
                with ctx.stage("flush", code=code):
                    super().reply(code, payload, ctype, headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/health":
                    self.reply(200, {"status": "ok",
                                     "replicas": server.membership.sweep()})
                elif path == "/ready":
                    if server.ready():
                        self.reply(200, {"status": "ready"})
                    else:
                        self.route_err(503, {"status": "not_ready"})
                elif path == "/v1/cluster":
                    with server._plan_lock:
                        plan = {n: list(c) for n, c in server._plan.items()}
                    view = {
                        "membership": server.membership.snapshot(),
                        "placement": plan,
                        "retry_budget": server.retry_budget.snapshot(),
                        "tenants": server.tenants.stats(),
                        "slo": server.slo.snapshot(),
                        "replica_slo": server.replica_slo.snapshot()}
                    if server.autoscaler is not None:
                        view["autoscale"] = server.autoscaler.snapshot()
                    self.reply(200, view)
                elif path == "/v1/tsdb":
                    if server.telemetry is None:
                        self.route_err(
                            404, {"error": "telemetry plane not attached"})
                        return
                    q = parse_qs(self.path.partition("?")[2])
                    name = (q.get("name") or [None])[0]
                    if not name:
                        self.reply(
                            200,
                            {"families": server.telemetry.store.families(),
                             "stats": server.telemetry.store.stats()})
                        return
                    try:
                        labels = {k[6:]: v[0] for k, v in q.items()
                                  if k.startswith("label.")}
                        series = server.telemetry.store.query(
                            name, labels=labels or None,
                            track=(q.get("track") or [None])[0],
                            t_min=_qfloat(q, "t_min"),
                            t_max=_qfloat(q, "t_max"),
                            rate=_qflag(q, "rate"),
                            include_stale=_qflag(q, "stale"))
                    except ValueError:
                        self.route_err(400, {"error": "bad range parameter"})
                        return
                    self.reply(200, {"name": name, "series": series})
                elif path == "/v1/alerts":
                    t = server.telemetry
                    if t is None or t.alerts is None:
                        self.route_err(
                            404, {"error": "alert engine not attached"})
                    else:
                        self.reply(200, t.alerts.snapshot())
                else:
                    self.route_err(404, {"error": "unknown endpoint"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                m = _MODEL_ROUTE.match(path)
                name = m.group(1) if m else None
                ctx = None
                if _rt.ACTIVE is not None:
                    ctx = _rt.ACTIVE.begin(
                        f"route:{m.group(2)}" if m else "route",
                        traceparent=self.headers.get("traceparent"),
                        request_id=self.headers.get("X-Request-Id"),
                        model=name, tenant=self._tenant())
                    self._obs_ctx = ctx
                    self._obs_trace_id = ctx.trace_id
                try:
                    if not server.accepting():
                        raise ServeError("router is draining",
                                         cause="shutting_down")
                    if m is None:
                        self.route_err(404, {"error": "unknown endpoint"})
                        if ctx is not None:
                            ctx.finish(error="bad_request")
                        return
                    n = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(n) if n else b""
                    tenant = self._tenant()
                    # global admission: ONE bucket per tenant clusterwide
                    if ctx is None:
                        slo = server.tenants.admit(tenant, model=name)
                    else:
                        with ctx.stage("admit", model=name):
                            slo = server.tenants.admit(tenant, model=name)
                        ctx.slo_class = slo.name
                    server.retry_budget.deposit()
                    fwd = {"Content-Type": "application/json",
                           "X-Tenant": tenant}
                    if ctx is not None:
                        fwd["traceparent"] = ctx.traceparent()
                        fwd["X-Request-Id"] = ctx.request_id
                    if m.group(2) == "predict":
                        outcome = server._route_predict(
                            self, name, body, fwd, slo.name, ctx)
                    else:
                        outcome = server._route_generate(
                            self, name, body, fwd, slo.name, ctx,
                            query=self.path.partition("?")[2])
                    server._requests_total(outcome).inc()
                except QuotaError as e:
                    self.route_err(
                        e.http_status,
                        {"error": str(e), "cause": e.cause,
                         "tenant": self._tenant()},
                        headers={"Retry-After":
                                 jitter_retry_after(e.retry_after_s,
                                                    server.jitter_rng)})
                    server._requests_total("quota").inc()
                    if ctx is not None:
                        ctx.finish(error=e.cause)
                except ServeError as e:
                    headers = None
                    if e.http_status == 503:
                        headers = {"Retry-After": jitter_retry_after(
                            getattr(e, "retry_after_s", None) or 1.0,
                            server.jitter_rng)}
                    self.route_err(e.http_status,
                                   {"error": str(e), "cause": e.cause},
                                   headers=headers)
                    server._requests_total("error").inc()
                    if ctx is not None:
                        ctx.finish(error=e.cause)
                except _BAD_REQUEST as e:
                    self.route_err(400, {"error": str(e)})
                    if ctx is not None:
                        ctx.finish(error="bad_request")
                except (BrokenPipeError, ConnectionResetError):
                    server.metrics.counter(
                        "serve_shed_total", {"cause": "client_gone"},
                        help="requests refused at admission, by cause").inc()
                    if ctx is not None:
                        ctx.finish(error="client_gone")
                except Exception as e:  # the front door answers every request
                    log.exception("unhandled error routing %s", self.path)
                    self.route_err(500,
                                   {"error": f"{type(e).__name__}: {e}"})
                    server._requests_total("error").inc()
                    if ctx is not None:
                        ctx.finish(error="internal")
                finally:
                    if ctx is not None:
                        ctx.finish()

        return Handler

    # ------------------------------------------------------------- lifecycle
    def stop(self, drain: bool = True):
        """Stop routing; the replicas themselves are not owned here."""
        with self._lifecycle_lock:
            self._accepting = False
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        super().stop()
