"""Burn forecasting — the port's copy of
``deeplearning4j_tpu/obs/forecast.py``: Holt-Winters seasonal smoothing
over stored tracks.

A :class:`BurnForecaster` reads a metric's history out of the
:class:`~.tsdb.TimeSeriesStore` and extrapolates it ``horizon_s`` ahead
with additive **Holt-Winters** smoothing: level + trend + a repeating
seasonal profile of period ``season_s`` (the diurnal day — compressed in
sim replays, 24 h in production). Serving load is dominated by exactly
that shape, which is why the ROADMAP's "predictive scale-out from the
sim's diurnal fingerprints" starts here: the forecaster sees tomorrow's
ramp in yesterday's, and the autoscale policy can pre-spawn before the
burn threshold trips.

Honesty about uncertainty is part of the type: a :class:`Forecast`
carries ``confidence`` — the in-sample one-step prediction error scored
against the series' own variability (``1 / (1 + MAE/MAD)``: ~1 when the
fit explains the series, 0.5 when it does no better than the mean).
Series too short for a seasonal fit fall back to trend-only (Holt)
smoothing; series too short even for that yield ``None``, never a
made-up number. The policy gates pre-spawn on a confidence floor, so a
noisy fit cannot spend money.

Pure arithmetic over store queries — deterministic for a given store
state, no clock reads of its own beyond delegating to the store.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple


class Forecast(NamedTuple):
    """A typed prediction: value expected ``horizon_s`` from now."""

    horizon_s: float
    value: float
    confidence: float   # [0, 1] — in-sample fit quality, see module doc


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _confidence(errs: List[float], xs: List[float]) -> float:
    """1/(1 + MAE/MAD): 1 == perfect fit, 0.5 == no better than the mean."""
    if not errs:
        return 0.5
    mean = sum(xs) / len(xs)
    mad = sum(abs(x - mean) for x in xs) / len(xs)
    mae = sum(errs) / len(errs)
    if mad <= 1e-12:
        return 1.0 if mae <= 1e-12 else 0.0
    return max(0.0, min(1.0, 1.0 / (1.0 + mae / mad)))


def _holt(xs: List[float], k: int, alpha: float,
          beta: float) -> Tuple[float, float]:
    """Trend-only (Holt) smoothing: (k-step forecast, confidence)."""
    level = xs[0]
    trend = xs[1] - xs[0]
    errs: List[float] = []
    warmup = min(3, len(xs) - 1)
    for i in range(1, len(xs)):
        pred = level + trend
        if i > warmup:
            errs.append(abs(xs[i] - pred))
        new_level = alpha * xs[i] + (1.0 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1.0 - beta) * trend
        level = new_level
    return level + k * trend, _confidence(errs, xs)


def _holt_winters(xs: List[float], m: int, k: int, alpha: float,
                  beta: float, gamma: float) -> Tuple[float, float]:
    """Additive seasonal smoothing: (k-step forecast, confidence)."""
    level = sum(xs[:m]) / m
    level2 = sum(xs[m:2 * m]) / m
    trend = (level2 - level) / m
    season = [xs[i] - level for i in range(m)]
    errs: List[float] = []
    for i in range(m, len(xs)):
        pred = level + trend + season[i % m]
        if i >= 2 * m:
            errs.append(abs(xs[i] - pred))
        new_level = (alpha * (xs[i] - season[i % m])
                     + (1.0 - alpha) * (level + trend))
        trend = beta * (new_level - level) + (1.0 - beta) * trend
        season[i % m] = (gamma * (xs[i] - new_level)
                         + (1.0 - gamma) * season[i % m])
        level = new_level
    value = level + k * trend + season[(len(xs) - 1 + k) % m]
    return value, _confidence(errs, xs)


class BurnForecaster:
    """Forecast stored tracks; specialize to SLO burn for the autoscaler.

    ``season_s`` is the expected periodicity of the workload (one
    diurnal day); ``horizon_s`` how far ahead the default forecast
    looks — for pre-spawn it should cover spawn + warm + first-beat
    latency plus a policy tick or two.
    """

    #: ``autoscale.*`` tuned-group keys this class resolves (prefixed
    #: ``forecast_`` in the group; see :meth:`from_config`).
    KNOBS = frozenset({"forecast_season_s", "forecast_horizon_s"})

    def __init__(self, store, *, season_s: float, horizon_s: float = 60.0,
                 alpha: float = 0.5, beta: float = 0.1, gamma: float = 0.3,
                 metrics=None):
        self._store = store
        self.season_s = float(season_s)
        self.horizon_s = float(horizon_s)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self._metrics = metrics

    @classmethod
    def from_config(cls, store, config, **overrides) -> "BurnForecaster":
        """Build from a tuned config's ``autoscale`` knob group — the same
        group :meth:`AutoscalePolicy.from_config` reads its confidence
        floor from, so one recorded winner configures the whole predictive
        path. Group keys are prefixed (``forecast_season_s`` ->
        ``season_s``); unknown keys are ignored and explicit keyword
        overrides win."""
        from ..aot.tuned import tuned_group
        group = tuned_group(config, "autoscale")
        opts = {k[len("forecast_"):]: v for k, v in group.items()
                if k in cls.KNOBS}
        opts.update(overrides)
        opts.setdefault("season_s", 86400.0)  # one diurnal day
        return cls(store, **opts)

    # ------------------------------------------------------------ generic
    def forecast(self, name: str, labels: Optional[Dict[str, str]] = None,
                 track: Optional[str] = None,
                 horizon_s: Optional[float] = None) -> Optional[Forecast]:
        """Worst-case (max) forecast across matching live series."""
        h = self.horizon_s if horizon_s is None else float(horizon_s)
        best: Optional[Forecast] = None
        for series in self._store.query(name, labels=labels, track=track):
            fc = self._one(series["points"], h)
            if fc is not None and (best is None or fc.value > best.value):
                best = fc
        self._count("ok" if best is not None else "insufficient")
        return best

    def _one(self, points: List[List[float]],
             h: float) -> Optional[Forecast]:
        if len(points) < 5:
            return None
        ts = [p[0] for p in points]
        xs = [p[1] for p in points]
        dt = _median([ts[i] - ts[i - 1] for i in range(1, len(ts))])
        if dt <= 0.0:
            return None
        k = max(1, int(round(h / dt)))
        m = max(2, int(round(self.season_s / dt)))
        if len(xs) >= 2 * m + 2:
            value, conf = _holt_winters(xs, m, k, self.alpha, self.beta,
                                        self.gamma)
        else:
            value, conf = _holt(xs, k, self.alpha, self.beta)
        return Forecast(round(h, 6), round(value, 6), round(conf, 6))

    def _count(self, outcome: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(
                "forecast_requests_total", {"outcome": outcome},
                help="Forecast computations by outcome").inc()

    # ----------------------------------------------------------- specific
    def forecast_burn(self, slo_class: str,
                      window: str = "1m") -> Optional[Forecast]:
        """Forecast ``fleet_slo_burn_rate`` for one class; export gauges."""
        fc = self.forecast("fleet_slo_burn_rate",
                           labels={"slo_class": slo_class, "window": window})
        if fc is not None and self._metrics is not None:
            self._metrics.gauge(
                "forecast_burn", {"slo_class": slo_class},
                help="Forecast SLO burn rate at the forecast horizon"
                ).set(fc.value)
            self._metrics.gauge(
                "forecast_confidence", {"slo_class": slo_class},
                help="Confidence of the burn forecast (0-1)"
                ).set(fc.confidence)
        return fc
