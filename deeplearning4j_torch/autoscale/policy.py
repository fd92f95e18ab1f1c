"""Scale decisions — the pure half of the autoscaler; the port's copy of
``deeplearning4j_tpu/autoscale/policy.py``.

:class:`AutoscalePolicy` turns a :class:`~.signals.SignalReader` window
into a typed :class:`ScaleDecision`. It is deliberately free of side
effects on the fleet: no spawning, no draining, no clock reads — the
controller samples, asks, actuates, and only then :meth:`~AutoscalePolicy
.commit`\\ s the decision so a *failed* actuation never burns a cooldown.

Four mechanisms keep a noisy burn signal from oscillating the fleet:

- **sustain windows** — a trigger must hold for ``sustain_out_s`` (or
  ``sustain_in_s``) of consecutive samples; one spiky sample is a
  ``hold(spike)``, never a scale;
- **cooldowns** — after a committed scale-out (scale-in) no further
  scale-out (scale-in) for ``cooldown_out_s`` (``cooldown_in_s``); the
  fleet gets to *observe the effect* of a step before taking another;
- **hysteresis** — scale-in does not arm at "below the scale-out
  threshold" but at ``threshold * hysteresis`` (default well under
  half), so a signal hovering near the threshold sits in the dead band
  and holds instead of flapping out/in/out;
- **clamps** — ``min_replicas``/``max_replicas`` bound every step; the
  floor is a hard capacity constraint, so ``below_min`` repair (a dead
  replica under a min of two) bypasses cooldown.

Every decision — including every hold — carries the evidence that
produced it, JSON-safe and 6-dp rounded, and serializes canonically via
:meth:`ScaleDecision.to_json`: the byte-identity surface the determinism
test diffs across processes.
"""

from __future__ import annotations

import json
from typing import Dict, NamedTuple, Optional

from .signals import Sample

OUT = "out"
IN = "in"
HOLD = "hold"

#: Default scale-out burn thresholds per SLO class. Burn 1.0 = spending
#: error budget exactly as fast as the SLO allows; gold scales the moment
#: it burns at budget, looser classes tolerate proportionally more.
DEFAULT_BURN_OUT: Dict[str, float] = {"gold": 1.0, "standard": 2.0,
                                      "batch": 4.0}


def _r(x: float) -> float:
    """6-dp evidence rounding — same precision rule as sim scoring."""
    return round(float(x), 6)


class ScaleDecision(NamedTuple):
    """One policy verdict plus the inputs that produced it.

    ``reason`` is typed: a trigger (``burn``, ``queue``, ``forecast``,
    ``idle``, ``below_min``, ``above_max``) or a hold cause (``steady``,
    ``spike``, ``cooldown_out``, ``cooldown_in``, ``max_clamp``,
    ``min_clamp``).
    """

    direction: str   # "out" | "in" | "hold"
    amount: int      # replicas to add/remove (0 on hold)
    reason: str
    evidence: dict   # JSON-safe, 6-dp rounded policy inputs

    def to_json(self) -> str:
        """Canonical serialization — the decision log's byte-identity
        surface (sorted keys, no whitespace)."""
        return json.dumps({"direction": self.direction,
                           "amount": self.amount,
                           "reason": self.reason,
                           "evidence": self.evidence},
                          sort_keys=True, separators=(",", ":"))


class AutoscalePolicy:
    """Per-class burn thresholds + sustain + cooldown + hysteresis.

    ``queue_high``/``queue_low`` are per-alive-replica queue-depth
    watermarks: queueing is a saturation signal even before any SLO
    burns (and the only one for traffic with no burn tracking).
    """

    #: Constructor knobs resolvable from a tuned config's ``autoscale``
    #: group (see :func:`~..aot.tuned.tuned_group`).
    KNOBS = frozenset({
        "min_replicas", "max_replicas", "burn_out", "hysteresis",
        "queue_high", "queue_low", "sustain_out_s", "sustain_in_s",
        "cooldown_out_s", "cooldown_in_s", "step_out", "step_in",
        "forecast_confidence",
    })

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 burn_out: Optional[Dict[str, float]] = None,
                 hysteresis: float = 0.3,
                 queue_high: float = 16.0, queue_low: float = 1.0,
                 sustain_out_s: float = 2.0, sustain_in_s: float = 10.0,
                 cooldown_out_s: float = 30.0, cooldown_in_s: float = 60.0,
                 step_out: int = 1, step_in: int = 1,
                 forecast_confidence: float = 0.5):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if not 0.0 < float(hysteresis) < 1.0:
            raise ValueError("need 0 < hysteresis < 1 (scale-in arms at "
                             "burn <= threshold * hysteresis)")
        if float(queue_low) > float(queue_high):
            raise ValueError("need queue_low <= queue_high")
        if int(step_out) < 1 or int(step_in) < 1:
            raise ValueError("steps must be >= 1")
        for name, v in (("sustain_out_s", sustain_out_s),
                        ("sustain_in_s", sustain_in_s),
                        ("cooldown_out_s", cooldown_out_s),
                        ("cooldown_in_s", cooldown_in_s)):
            if float(v) < 0.0:
                raise ValueError(f"need {name} >= 0")
        if not 0.0 <= float(forecast_confidence) <= 1.0:
            raise ValueError("need 0 <= forecast_confidence <= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.burn_out = {str(k): float(v)
                         for k, v in (burn_out or DEFAULT_BURN_OUT).items()}
        if not self.burn_out:
            raise ValueError("burn_out must name at least one SLO class")
        self.hysteresis = float(hysteresis)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.sustain_out_s = float(sustain_out_s)
        self.sustain_in_s = float(sustain_in_s)
        self.cooldown_out_s = float(cooldown_out_s)
        self.cooldown_in_s = float(cooldown_in_s)
        self.step_out = int(step_out)
        self.step_in = int(step_in)
        self.forecast_confidence = float(forecast_confidence)
        self._last_out_t: Optional[float] = None
        self._last_in_t: Optional[float] = None

    @classmethod
    def from_config(cls, config: Optional[dict],
                    **overrides) -> "AutoscalePolicy":
        """Build from a tuned config's ``autoscale`` knob group (unknown
        keys ignored — forward compatibility with newer tuners), with
        explicit keyword overrides winning."""
        from ..aot.tuned import tuned_group
        opts = {k: v for k, v in tuned_group(config, "autoscale").items()
                if k in cls.KNOBS}
        opts.update(overrides)
        return cls(**opts)

    # -------------------------------------------------------- predicates
    def _hot(self, s: Sample) -> Optional[str]:
        """The scale-out trigger this sample shows (``burn`` before
        ``queue`` — the SLO is the contract, the queue a leading
        indicator), or None."""
        for cls in sorted(self.burn_out):
            if s.burn.get(cls, 0.0) >= self.burn_out[cls]:
                return "burn"
        if s.queue_depth / max(1, s.alive) >= self.queue_high:
            return "queue"
        return None

    def _idle(self, s: Sample) -> bool:
        """Below the hysteresis band: every tracked class burns well under
        its threshold AND per-replica queues are drained."""
        for cls, thr in self.burn_out.items():
            if s.burn.get(cls, 0.0) > thr * self.hysteresis:
                return False
        return s.queue_depth / max(1, s.alive) <= self.queue_low

    def _forecast_breach(self, forecast) -> Optional[str]:
        """First tracked class (sorted) whose forecast predicts burning at
        or past its scale-out threshold with enough confidence, or None.
        ``forecast`` maps class -> a Forecast-shaped object (``value``,
        ``confidence``, ``horizon_s``)."""
        if not forecast:
            return None
        for cls in sorted(self.burn_out):
            f = forecast.get(cls)
            if (f is not None
                    and f.confidence >= self.forecast_confidence
                    and f.value >= self.burn_out[cls]):
                return cls
        return None

    # ---------------------------------------------------------- decision
    def decide(self, signals, current: int, now: float,
               forecast=None) -> ScaleDecision:
        """One verdict from the signal window. Pure in the signals — no
        sampling, no clock reads, no state writes; cooldowns advance only
        via :meth:`commit` after the controller actually actuated.

        ``forecast`` (optional) maps SLO class -> a typed
        Forecast-shaped object (``value``, ``confidence``, ``horizon_s``) of
        that class's burn at the
        forecaster's horizon. A confident predicted breach pre-spawns
        *before* the ramp trips the live thresholds; the sustain /
        cooldown / clamp machinery is unchanged, and a ``None`` forecast
        reproduces the legacy decision stream byte for byte.
        """
        window = signals.window()
        last = window[-1] if window else None
        ev = {
            "t": _r(now),
            "current": int(current),
            "samples": len(window),
            "burn": {k: _r(v)
                     for k, v in (sorted(last.burn.items()) if last else [])},
            "queue_depth": int(last.queue_depth) if last else 0,
            "kv_pressure": _r(last.kv_pressure) if last else 0.0,
        }
        if forecast is not None:
            ev["forecast"] = {
                str(cls): {"horizon_s": _r(f.horizon_s),
                           "value": _r(f.value),
                           "confidence": _r(f.confidence)}
                for cls, f in sorted(forecast.items()) if f is not None}

        def verdict(direction: str, amount: int, reason: str,
                    **extra) -> ScaleDecision:
            ev.update(extra)
            return ScaleDecision(direction, int(amount), reason, ev)

        # capacity-bound repair outranks everything, including cooldowns:
        # min_replicas is a floor the fleet must hold even right after a
        # scale event (the dead-replica-under-load drill lands here)
        if current < self.min_replicas:
            return verdict(OUT, self.min_replicas - current, "below_min")
        if current > self.max_replicas:
            return verdict(IN, current - self.max_replicas, "above_max")

        hot_now = last is not None and self._hot(last) is not None
        if hot_now and signals.sustained(
                lambda s: self._hot(s) is not None, self.sustain_out_s, now):
            trigger = self._hot(last)
            if current >= self.max_replicas:
                return verdict(HOLD, 0, "max_clamp", trigger=trigger)
            if self._cooling(self._last_out_t, self.cooldown_out_s, now):
                return verdict(HOLD, 0, "cooldown_out", trigger=trigger)
            return verdict(OUT, min(self.step_out,
                                    self.max_replicas - current), trigger)
        if hot_now:
            return verdict(HOLD, 0, "spike")

        # predictive pre-spawn: not hot NOW, but a confident forecast says
        # a tracked class breaches its threshold within the horizon — act
        # while there is still spawn+warm latency to hide. Same clamps and
        # cooldown as a reactive scale-out; no sustain window (the horizon
        # plays that role, and the forecaster's confidence floor gates
        # noise the way sustain gates spikes).
        fc_cls = self._forecast_breach(forecast)
        if fc_cls is not None:
            if current >= self.max_replicas:
                return verdict(HOLD, 0, "max_clamp", trigger="forecast",
                               forecast_class=fc_cls)
            if self._cooling(self._last_out_t, self.cooldown_out_s, now):
                return verdict(HOLD, 0, "cooldown_out", trigger="forecast",
                               forecast_class=fc_cls)
            return verdict(OUT, min(self.step_out,
                                    self.max_replicas - current),
                           "forecast", forecast_class=fc_cls)

        if (last is not None and self._idle(last)
                and signals.sustained(self._idle, self.sustain_in_s, now)):
            if current <= self.min_replicas:
                return verdict(HOLD, 0, "min_clamp")
            if self._cooling(self._last_in_t, self.cooldown_in_s, now):
                return verdict(HOLD, 0, "cooldown_in")
            return verdict(IN, min(self.step_in,
                                   current - self.min_replicas), "idle")
        return verdict(HOLD, 0, "steady")

    @staticmethod
    def _cooling(last_t: Optional[float], cooldown_s: float,
                 now: float) -> bool:
        return last_t is not None and (now - last_t) < cooldown_s

    def commit(self, decision: ScaleDecision, now: float) -> None:
        """Arm the scaled direction's cooldown — called by the controller
        after a SUCCESSFUL actuation only, so a spawn that failed (chaos,
        resource exhaustion) leaves the policy free to retry next tick."""
        if decision.direction == OUT:
            self._last_out_t = float(now)
        elif decision.direction == IN:
            self._last_in_t = float(now)

    def snapshot(self) -> dict:
        """JSON-safe config + cooldown state for ``/v1/cluster``."""
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "burn_out": dict(sorted(self.burn_out.items())),
            "hysteresis": self.hysteresis,
            "queue_high": self.queue_high,
            "queue_low": self.queue_low,
            "sustain_s": {"out": self.sustain_out_s,
                          "in": self.sustain_in_s},
            "cooldown_s": {"out": self.cooldown_out_s,
                           "in": self.cooldown_in_s},
            "step": {"out": self.step_out, "in": self.step_in},
            "forecast_confidence": self.forecast_confidence,
            "last_scale_t": {"out": self._last_out_t,
                             "in": self._last_in_t},
        }
