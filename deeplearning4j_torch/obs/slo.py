"""SLO burn accounting — the port's copy of
``deeplearning4j_tpu/obs/slo.py``: good/bad request counters and windowed
burn-rate gauges per ``(model, slo_class)``.

Burn rate is the SRE-workbook definition: the fraction of requests that
were *bad* inside a trailing window, divided by the class's error budget
(``1 - availability target``). Burn 1.0 means the budget is being consumed
exactly at the sustainable rate; a gold class at target 99.9% with 1% of
requests failing burns at 10x. Two windows (fast/slow, default 60 s/600 s)
give the standard multi-window alert shape: the fast window catches a spike,
the slow window confirms it is not a blip.

Implementation is a per-key wheel of 1-second buckets (bounded by the
largest window), so recording is O(1) and computing a window is one walk
over <= max_window entries — no per-request allocation beyond the wheel
buckets themselves. Stdlib only; targets are keyed by *class name* so this
module needs no import from fleet/.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

# Availability targets per SLO class name; unknown classes get DEFAULT_TARGET.
DEFAULT_TARGETS: Dict[str, float] = {
    "gold": 0.999, "standard": 0.99, "batch": 0.9}
DEFAULT_TARGET = 0.99


class _Series:
    """One (model, slo_class): cumulative counts + a wheel of 1 s buckets."""

    __slots__ = ("good", "bad", "wheel")

    def __init__(self):
        self.good = 0
        self.bad = 0
        # wheel entries: [epoch_second, good, bad]
        self.wheel: deque = deque()


class SloBurn:
    """Thread-safe burn-rate tracker.

    ``metrics`` (a ``MetricsRegistry``) is optional; when present each
    :meth:`record` bumps ``fleet_slo_requests_total{model,slo_class,outcome}``
    and refreshes ``fleet_slo_burn_rate{model,slo_class,window}`` gauges.
    ``clock`` is injectable for tests (must return seconds, monotonic).

    ``key_label`` renames the first dimension in the exported metrics: the
    cluster router tracks a second burn per *replica* (same math, keyed by
    replica id) and exports it as ``...{replica=...}`` so a per-replica
    burn spike points at the sick instance, not just the sick model.
    """

    def __init__(self, metrics=None, windows: Sequence[float] = (60.0, 600.0),
                 targets: Optional[Dict[str, float]] = None,
                 clock=time.monotonic, key_label: str = "model"):
        self.metrics = metrics
        self.key_label = str(key_label)
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("SloBurn needs at least one window")
        self.targets = dict(DEFAULT_TARGETS if targets is None else targets)
        self._clock = clock
        self._series: Dict[Tuple[str, str], _Series] = {}
        self._lock = threading.Lock()

    def target(self, slo_class: str) -> float:
        return self.targets.get(slo_class, DEFAULT_TARGET)

    def record(self, model: str, slo_class: str, good: bool) -> None:
        """Count one classified request outcome."""
        now = int(self._clock())
        key = (model, slo_class)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series()
            if good:
                s.good += 1
            else:
                s.bad += 1
            w = s.wheel
            if w and w[-1][0] == now:
                w[-1][1 if good else 2] += 1
            else:
                w.append([now, int(good), int(not good)])
            horizon = now - self.windows[-1]
            while w and w[0][0] < horizon:
                w.popleft()
            burns = self._burns_locked(s, slo_class, now)
        m = self.metrics
        if m is not None:
            m.counter("fleet_slo_requests_total",
                      {self.key_label: model, "slo_class": slo_class,
                       "outcome": "good" if good else "bad"},
                      help="SLO-classified request outcomes").inc()
            for w_s, burn in burns.items():
                m.gauge("fleet_slo_burn_rate",
                        {self.key_label: model, "slo_class": slo_class,
                         "window": w_s},
                        help="windowed error-budget burn rate "
                             "(1.0 = budget consumed exactly on pace)"
                        ).set(burn)

    def _burns_locked(self, s: _Series, slo_class: str,
                      now: int) -> Dict[str, float]:
        budget = 1.0 - self.target(slo_class)
        out = {}
        for win in self.windows:
            horizon = now - win
            good = bad = 0
            for sec, g, b in s.wheel:
                if sec >= horizon:
                    good += g
                    bad += b
            total = good + bad
            frac = (bad / total) if total else 0.0
            out[_fmt_window(win)] = frac / budget if budget > 0 else 0.0
        return out

    def forget(self, key: str) -> None:
        """Drop every series for one key and retire its exported burn
        gauges.

        A subject that stops receiving traffic (a dead replica, a removed
        model) stops calling :meth:`record`, so its last exported burn
        value would freeze — a 1m-window spike frozen above threshold
        holds alert rules hostage long after the window slid past the bad
        events. Deleting the gauge turns that lie into honest absence,
        and a federated TSDB sees the deletion as a presence diff and
        tombstones the series (deliberately removed, never resurrected).
        The ``fleet_slo_requests_total`` counters stay: history is their
        point.
        """
        with self._lock:
            classes = [cls for (k, cls) in self._series if k == key]
            for cls in classes:
                del self._series[(key, cls)]
        m = self.metrics
        if m is None:
            return
        for cls in classes:
            for win in self.windows:
                m.remove_series("fleet_slo_burn_rate",
                                {self.key_label: key, "slo_class": cls,
                                 "window": _fmt_window(win)})

    def snapshot(self) -> dict:
        """JSON-safe ``{model: {slo_class: {good, bad, target, burn}}}`` for
        ``/v1/fleet``."""
        now = int(self._clock())
        out: dict = {}
        with self._lock:
            for (model, cls), s in sorted(self._series.items()):
                out.setdefault(model, {})[cls] = {
                    "good": s.good, "bad": s.bad,
                    "target": self.target(cls),
                    "burn": self._burns_locked(s, cls, now)}
        return out


def _fmt_window(seconds: float) -> str:
    s = int(seconds)
    return f"{s // 60}m" if s % 60 == 0 and s >= 60 else f"{s}s"
