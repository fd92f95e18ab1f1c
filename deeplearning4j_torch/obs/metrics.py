"""Metrics primitives — the part of ``deeplearning4j_tpu/obs/metrics.py``
that the serving engine and registry use: thread-safe counters, gauges and
streaming histograms behind one :class:`MetricsRegistry`, exported as
Prometheus text. Same names, label handling and bucket scheme as the
reference, so dashboards read both packages alike. Stdlib only.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Geometric-ish latency buckets (seconds): 100 us .. 60 s.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters are monotonic; inc() amount must be >= 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket streaming histogram (cumulative buckets, sum, count)
    with quantile estimation: linear interpolation inside the target
    bucket, the tracked min/max tightening the first and overflow bucket
    edges (Prometheus histogram_quantile makes the same estimate)."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_min", "_max",
                 "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: overflow (+Inf) bucket
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if not self._count:
                return 0.0
            target = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c and cum + c >= target:
                    lower = self._bounds[i - 1] if i > 0 else self._min
                    upper = (self._bounds[i] if i < len(self._bounds)
                             else self._max)
                    # no observation lies outside [min, max]
                    lower = max(lower, self._min)
                    upper = max(min(upper, self._max), lower)
                    return lower + (upper - lower) * ((target - cum) / c)
                cum += c
            return self._max

    def _cumulative(self) -> Tuple[List[Tuple[float, int]], float, int]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, buckets = 0, []
        for bound, c in zip(list(self._bounds) + [math.inf], counts):
            cum += c
            buckets.append((bound, cum))
        return buckets, s, total


class _Family:
    __slots__ = ("kind", "help", "series")

    def __init__(self, kind: str, help_: str):
        self.kind = kind
        self.help = help_
        self.series: Dict[Tuple[Tuple[str, str], ...], object] = {}


class MetricsRegistry:
    """Thread-safe instrument registry: ``counter``/``gauge``/``histogram``
    create or return the instrument for (name, labels); a name registered
    as one type cannot be reused as another."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get(self, kind: str, name: str, labels: Optional[Dict[str, str]],
             help_: str, factory):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = labels or {}
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind, help_)
            elif fam.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.kind}, not {kind}")
            inst = fam.series.get(key)
            if inst is None:
                inst = fam.series[key] = factory()
            return inst

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get("counter", name, labels, help, Counter)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get("gauge", name, labels, help, Gauge)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get("histogram", name, labels, help,
                         lambda: Histogram(buckets))

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            items = sorted((n, f, dict(f.series))
                           for n, f in self._families.items())
        lines: List[str] = []
        for name, fam, series in items:
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(series):
                inst = series[key]
                if isinstance(inst, Histogram):
                    buckets, s, total = inst._cumulative()
                    for bound, cum in buckets:
                        lbl = _label_str(key + (("le", _fmt_value(bound)),))
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    lines.append(f"{name}_sum{_label_str(key)} {_fmt_value(s)}")
                    lines.append(f"{name}_count{_label_str(key)} {total}")
                else:
                    lines.append(f"{name}{_label_str(key)} "
                                 f"{_fmt_value(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _label_str(key: Iterable[Tuple[str, str]]) -> str:
    parts = [f'{k}="{_escape_label_value(str(v))}"' for k, v in key]
    return "{" + ",".join(parts) + "}" if parts else ""
