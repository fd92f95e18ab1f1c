"""Declarative alerting over the time-series store — the port's copy of
``deeplearning4j_tpu/obs/alerts.py``.

An :class:`AlertEngine` evaluates a declarative set of
:class:`AlertRule`\\ s — the shipped :func:`default_rules`, optionally
overlaid by a tuned config's ``alerts`` group via
:func:`rules_from_config` — against a :class:`~.tsdb.TimeSeriesStore`
on every ``evaluate`` call and runs each rule through the classic
state machine::

    ok -> pending -> firing -> (resolved) -> ok

``for_s`` is the sustain horizon: a rule whose condition is first seen
violated goes *pending* and only fires once the condition has held for
``for_s`` seconds of evaluation time — a spike shorter than the horizon
cancels back to ok and never pages. Resolution requires the *condition
to clear* (the rule re-reads the store's live last-values every pass);
old samples sliding out of a rate window never resolves a threshold
alert by themselves. Stale series are invisible to rules by
construction — :meth:`~.tsdb.TimeSeriesStore.latest` is live-only — so
a tombstoned ``cluster_replica_state`` cannot keep a replica-dead alert
firing after the replica was deliberately reaped.

Every transition emits a flight-recorder event (kind ``alert``), counts
``alert_transitions_total{rule,to}`` and updates ``alert_state{rule}``
(0 ok, 1 pending, 2 firing); the full state surfaces on the router's
``GET /v1/alerts``. :meth:`firings` returns the begin/end log the sim
replayer stamps into replay reports so the tuner can penalize configs
that page humans.

Rule kinds:

- ``threshold``: worst live last-value vs ``value`` under ``op``;
- ``rate_of_change``: worst per-second rate over ``window_s`` vs
  ``value`` (for counters — e.g. spawn failures per second);
- ``absence``: fires when NO live series matches (a scrape target that
  should exist but does not).

**Notifier fan-out.** The engine optionally delivers firing/resolved
events to a list of :class:`Notifier`\\ s (anything with a ``channel``
string and a ``notify(event)`` method — :class:`StdoutNotifier` and
:class:`WebhookNotifier` ship). Delivery is **deduplicated per
firing**: each distinct firing (rule + ``fired_at``) notifies exactly
once, later evaluation passes while the rule stays firing are
suppressed (counted as ``dedup``) until ``renotify_s`` elapses, at
which point one reminder goes out with the *same* dedup key. Each
delivery runs through a bounded :class:`~..chaos.retry.RetryPolicy`
(a flapping webhook gets capped backoff, never an unbounded loop) and
is counted on ``alert_notifications_total{rule,channel,outcome}``
with ``outcome`` ∈ ``sent`` / ``dedup`` / ``error``. Notification
decisions are made under the engine lock; the actual I/O happens
after release, so a slow webhook never blocks a concurrent scrape.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..chaos.retry import RetryPolicy
from . import flight as _flight

OK = "ok"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

THRESHOLD = "threshold"
RATE_OF_CHANGE = "rate_of_change"
ABSENCE = "absence"

_STATE_N = {OK: 0, PENDING: 1, FIRING: 2}


class AlertRule(NamedTuple):
    """One declarative rule over a single metric family."""

    name: str
    metric: str
    kind: str = THRESHOLD
    op: str = ">"                       # ">" | "<"
    value: float = 0.0
    for_s: float = 0.0                  # sustain horizon before firing
    labels: Optional[Dict[str, str]] = None   # subset match on series
    track: Optional[str] = None         # histogram track, e.g. "p99"
    window_s: float = 120.0             # rate_of_change lookback
    severity: str = "page"
    summary: str = ""


def default_rules() -> Tuple[AlertRule, ...]:
    """The shipped ruleset — the pages a serving fleet cannot not have."""
    return (
        AlertRule("gold_burn_high", "fleet_slo_burn_rate",
                  op=">", value=1.0, for_s=20.0,
                  labels={"slo_class": "gold", "window": "1m"},
                  severity="page",
                  summary="gold error budget burning faster than it refills"),
        AlertRule("breaker_open", "fleet_breaker_state",
                  op=">", value=1.5, for_s=0.0, severity="page",
                  summary="a model circuit breaker is open"),
        AlertRule("replica_dead", "cluster_replica_state",
                  op=">", value=1.5, for_s=0.0, severity="page",
                  summary="a replica's membership lease expired"),
        AlertRule("kv_pressure", "serve_kv_block_utilization",
                  op=">", value=0.95, for_s=10.0, severity="warn",
                  summary="KV block pool nearly exhausted"),
        AlertRule("spawn_failures", "autoscale_spawn_failures_total",
                  kind=RATE_OF_CHANGE, op=">", value=0.0, window_s=120.0,
                  for_s=0.0, severity="warn",
                  summary="autoscale replica provisions are failing"),
        AlertRule("compile_miss", "serve_compile_misses_total",
                  op=">", value=0.0, for_s=0.0, severity="page",
                  summary="a production replica traced at request time — "
                          "the AOT prebuild does not cover live traffic"),
    )


def rules_from_config(config: Optional[dict],
                      base: Optional[Tuple[AlertRule, ...]] = None
                      ) -> Tuple[AlertRule, ...]:
    """Overlay an ``alerts`` tuned-config group on the shipped ruleset.

    ``config`` is a resolved tuned config (the dict
    ``FleetRegistry(tuned_for=...)`` loads); its ``alerts`` group may
    override per-rule knobs — thresholds (``value``), sustain horizons
    (``for_s``), rate windows (``window_s``), ``op``, ``severity`` —
    or disable a rule entirely with ``enable: false``. Two spellings
    are accepted, nested and flat (the tuner's knob grids are flat)::

        {"alerts": {"kv_pressure": {"value": 0.9, "for_s": 30}}}
        {"alerts": {"kv_pressure.value": 0.9, "gold_burn_high.enable": 0}}

    With no ``alerts`` group (or no config at all) the ``base`` ruleset
    is returned *unchanged* — same tuple, byte-identical engine
    behavior — so fleets without a tuned config lose nothing. Unknown
    rule names and malformed values are ignored per-knob, never raised:
    a corrupt tuned config degrades to the shipped pages (the same
    contract as every other ``tuned_group`` consumer).
    """
    from ..aot.tuned import tuned_group

    rules = tuple(base) if base is not None else default_rules()
    group = tuned_group(config, "alerts")
    if not group:
        return rules
    per: Dict[str, dict] = {}
    for k, v in group.items():
        if not isinstance(k, str):
            continue
        if isinstance(v, dict):
            per.setdefault(k, {}).update(v)
        elif "." in k:
            rname, _, field = k.partition(".")
            per.setdefault(rname, {})[field] = v
    out: List[AlertRule] = []
    for rule in rules:
        o = per.get(rule.name)
        if not o:
            out.append(rule)
            continue
        if "enable" in o and not o["enable"]:
            continue
        fields: Dict[str, object] = {}
        for f in ("value", "for_s", "window_s"):
            if f in o:
                try:
                    fields[f] = float(o[f])
                except (TypeError, ValueError):
                    pass
        for f in ("op", "severity"):
            if f in o and isinstance(o[f], str) and o[f]:
                fields[f] = o[f]
        out.append(rule._replace(**fields) if fields else rule)
    return tuple(out)


class StdoutNotifier:
    """One JSON line per notification to ``stream`` (default stdout).

    The degenerate channel every deployment has: pipe the serving
    process's stdout into whatever log shipper exists and alerts are
    already *somewhere*. The stream is injectable so tests capture
    notifications without patching ``sys.stdout``.
    """

    channel = "stdout"

    def __init__(self, stream=None):
        self._stream = stream

    def notify(self, event: dict) -> None:
        out = self._stream if self._stream is not None else sys.stdout
        out.write(json.dumps(event, sort_keys=True) + "\n")
        if hasattr(out, "flush"):
            out.flush()


class WebhookNotifier:
    """POST each notification as JSON to ``url`` (Slack-webhook shaped).

    Uses stdlib ``urllib.request`` with a hard ``timeout_s`` so a dead
    endpoint costs one bounded connect attempt per retry, never a hang.
    Any transport error or non-2xx status raises — the engine's
    :class:`~..chaos.retry.RetryPolicy` decides how often to re-try and
    the failure is counted as ``outcome="error"`` when the budget is
    spent. ``opener`` is injectable for tests (anything callable as
    ``opener(request, timeout=...)`` returning a response with a
    ``status``/``getcode()``).
    """

    channel = "webhook"

    def __init__(self, url: str, *, timeout_s: float = 2.0, opener=None):
        self.url = str(url)
        self.timeout_s = float(timeout_s)
        self._opener = opener

    def notify(self, event: dict) -> None:
        import urllib.request

        body = json.dumps(event, sort_keys=True).encode("utf-8")
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        opener = (self._opener if self._opener is not None
                  else urllib.request.urlopen)
        resp = opener(req, timeout=self.timeout_s)
        status = getattr(resp, "status", None)
        if status is None and hasattr(resp, "getcode"):
            status = resp.getcode()
        if status is not None and not 200 <= int(status) < 300:
            raise OSError(f"webhook {self.url}: HTTP {status}")


class _RuleState:
    __slots__ = ("state", "pending_since", "fired_at", "last_value")

    def __init__(self):
        self.state = OK
        self.pending_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.last_value: Optional[float] = None


class _NotifyState:
    __slots__ = ("key", "last_at")

    def __init__(self):
        self.key: Optional[str] = None       # dedup key of current firing
        self.last_at: float = 0.0            # last delivery for that key


class AlertEngine:
    """Evaluate declarative rules against a store on an injectable clock.

    State mutation happens under one lock; flight events and metric
    updates for the collected transitions are emitted after the lock is
    released, so alert bookkeeping never blocks a concurrent scrape.
    """

    def __init__(self, store, *, rules: Optional[Tuple[AlertRule, ...]] = None,
                 config: Optional[dict] = None, metrics=None,
                 clock=time.monotonic, max_firings: int = 256,
                 notifiers: Sequence = (), renotify_s: float = 300.0,
                 retry: Optional[RetryPolicy] = None):
        self._store = store
        self._metrics = metrics
        self._clock = clock
        # explicit rules win; else the tuned config's `alerts` group
        # overlays the shipped set (no group -> byte-identical default)
        self.rules: Tuple[AlertRule, ...] = (
            tuple(rules) if rules is not None else rules_from_config(config))
        self._lock = threading.Lock()
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._firings: deque = deque(maxlen=max(1, int(max_firings)))
        self._notifiers: Tuple = tuple(notifiers)
        self._renotify_s = float(renotify_s)
        self._notify_states: Dict[str, _NotifyState] = {
            r.name: _NotifyState() for r in self.rules}
        self._retry = retry if retry is not None else RetryPolicy(
            attempts=3, base_s=0.05, cap_s=1.0, metrics=metrics)

    # ---------------------------------------------------------- condition
    def _worst(self, rule: AlertRule,
               now: float) -> Tuple[Optional[float], bool]:
        """(observed value, violated?) for one rule, live series only."""
        if rule.kind == RATE_OF_CHANGE:
            vals = [v for (_, v) in self._store.window_rate(
                rule.metric, labels=rule.labels, track=rule.track,
                window_s=rule.window_s, now=now)]
        else:
            vals = [v for (_, _, v) in self._store.latest(
                rule.metric, labels=rule.labels, track=rule.track)]
        if rule.kind == ABSENCE:
            return (float(len(vals)), not vals)
        if not vals:
            return (None, False)
        worst = min(vals) if rule.op == "<" else max(vals)
        violated = worst < rule.value if rule.op == "<" \
            else worst > rule.value
        return (worst, violated)

    # ----------------------------------------------------------- evaluate
    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One pass over every rule; returns the transitions it caused."""
        t = self._clock() if now is None else float(now)
        transitions: List[dict] = []
        gauges: List[Tuple[str, int]] = []
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                value, violated = self._worst(rule, t)
                st.last_value = value
                prev = st.state
                if violated:
                    if st.state == OK:
                        st.pending_since = t
                        if rule.for_s <= 0.0:
                            st.state = FIRING
                            st.fired_at = t
                        else:
                            st.state = PENDING
                    elif st.state == PENDING:
                        # explicit None check: 0.0 is a valid pending_since
                        # on a fake clock that starts at zero
                        since = t if st.pending_since is None \
                            else st.pending_since
                        if t - since >= rule.for_s:
                            st.state = FIRING
                            st.fired_at = t
                else:
                    # resolution requires the CONDITION to clear; nothing
                    # here consults window ages, so a sliding window alone
                    # can never resolve (or un-pend) an alert
                    if st.state in (PENDING, FIRING):
                        st.state = OK
                        st.pending_since = None
                if st.state != prev:
                    to = st.state
                    if prev == FIRING and st.state == OK:
                        to = RESOLVED
                        for rec in reversed(self._firings):
                            if (rec["rule"] == rule.name
                                    and rec["resolved_at_s"] is None):
                                rec["resolved_at_s"] = round(t, 6)
                                break
                    elif st.state == FIRING:
                        self._firings.append({
                            "rule": rule.name,
                            "severity": rule.severity,
                            "fired_at_s": round(t, 6),
                            "resolved_at_s": None,
                        })
                    transitions.append({
                        "rule": rule.name, "from": prev, "to": to,
                        "severity": rule.severity, "at_s": round(t, 6),
                        "value": (None if value is None
                                  else round(value, 6)),
                    })
                gauges.append((rule.name, _STATE_N[st.state]))
            notices, deduped = self._notify_decisions_locked(t)
        self._emit(transitions, gauges)
        self._deliver(notices, deduped)
        return transitions

    def _notify_decisions_locked(
            self, t: float) -> Tuple[List[dict], List[str]]:
        """Decide (under the lock) what to deliver after release.

        One notification per distinct firing — the dedup key is
        ``rule@fired_at`` — plus one reminder each time ``renotify_s``
        elapses while the rule keeps firing (same key, ``renotify``
        flag set), plus one resolution notice when the firing clears.
        Suppressed passes are returned so delivery can count them.
        """
        notices: List[dict] = []
        deduped: List[str] = []
        if not self._notifiers:
            return notices, deduped
        for rule in self.rules:
            st = self._states[rule.name]
            ns = self._notify_states[rule.name]
            if st.state == FIRING:
                key = f"{rule.name}@{round(st.fired_at or 0.0, 6)}"
                if ns.key != key:
                    ns.key = key
                    ns.last_at = t
                    notices.append(self._notice(rule, st, key, t,
                                                FIRING, renotify=False))
                elif (self._renotify_s > 0.0
                        and t - ns.last_at >= self._renotify_s):
                    ns.last_at = t
                    notices.append(self._notice(rule, st, key, t,
                                                FIRING, renotify=True))
                else:
                    deduped.append(rule.name)
            elif ns.key is not None:
                # the firing this key belonged to has cleared: send the
                # resolution notice once and forget the key
                notices.append(self._notice(rule, st, ns.key, t,
                                            RESOLVED, renotify=False))
                ns.key = None
        return notices, deduped

    @staticmethod
    def _notice(rule: AlertRule, st: _RuleState, key: str, t: float,
                state: str, *, renotify: bool) -> dict:
        return {
            "rule": rule.name, "state": state,
            "severity": rule.severity, "summary": rule.summary,
            "value": (None if st.last_value is None
                      else round(st.last_value, 6)),
            "at_s": round(t, 6), "dedup_key": key, "renotify": renotify,
        }

    def _deliver(self, notices: List[dict], deduped: List[str]) -> None:
        """Fan notifications out to every channel — outside the lock.

        A broken channel is an ``error`` outcome on the counter, never
        an exception out of ``evaluate``: alert *evaluation* must keep
        running when the pager is what's down.
        """
        if not self._notifiers:
            return
        for ev in notices:
            for n in self._notifiers:
                ch = str(getattr(n, "channel", type(n).__name__))
                try:
                    self._retry.call(
                        lambda n=n, ev=ev: n.notify(dict(ev)),
                        op="alert_notify")
                    outcome = "sent"
                except Exception:  # any channel failure degrades to a counted error, evaluation must survive a dead pager
                    outcome = "error"
                self._count_notification(ev["rule"], ch, outcome)
        for rule_name in deduped:
            for n in self._notifiers:
                ch = str(getattr(n, "channel", type(n).__name__))
                self._count_notification(rule_name, ch, "dedup")

    def _count_notification(self, rule: str, channel: str,
                            outcome: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(
                "alert_notifications_total",
                {"rule": rule, "channel": channel, "outcome": outcome},
                help="Alert notification deliveries by rule/channel/outcome"
                ).inc()

    def _emit(self, transitions: List[dict],
              gauges: List[Tuple[str, int]]) -> None:
        """Flight + metrics for one pass — outside the engine lock."""
        for tr in transitions:
            if _flight.ACTIVE is not None:
                _flight.ACTIVE.record_event(
                    "alert", tr["rule"], detail=tr["to"],
                    severity=tr["severity"], value=tr["value"])
            if self._metrics is not None:
                self._metrics.counter(
                    "alert_transitions_total",
                    {"rule": tr["rule"], "to": tr["to"]},
                    help="Alert state-machine transitions by rule").inc()
        if self._metrics is not None:
            for rule_name, n in gauges:
                self._metrics.gauge(
                    "alert_state", {"rule": rule_name},
                    help="Alert state per rule (0 ok, 1 pending, 2 firing)"
                    ).set(float(n))

    # ------------------------------------------------------------ surface
    def firings(self) -> List[dict]:
        """Chronological firing log (open firings have resolved_at None)."""
        with self._lock:
            return [dict(rec) for rec in self._firings]

    def active(self) -> List[str]:
        """Names of rules currently firing, sorted."""
        with self._lock:
            return sorted(name for name, st in self._states.items()
                          if st.state == FIRING)

    def snapshot(self) -> dict:
        """JSON-ready state for ``GET /v1/alerts``."""
        with self._lock:
            rules = {}
            for rule in self.rules:
                st = self._states[rule.name]
                rules[rule.name] = {
                    "state": st.state,
                    "severity": rule.severity,
                    "summary": rule.summary,
                    "metric": rule.metric,
                    "kind": rule.kind,
                    "value": (None if st.last_value is None
                              else round(st.last_value, 6)),
                    "threshold": round(float(rule.value), 6),
                    "for_s": round(float(rule.for_s), 6),
                    "pending_since_s": (
                        None if st.pending_since is None
                        else round(st.pending_since, 6)),
                    "fired_at_s": (None if st.fired_at is None
                                   else round(st.fired_at, 6)),
                }
            return {"rules": rules,
                    "firings": [dict(rec) for rec in self._firings]}
