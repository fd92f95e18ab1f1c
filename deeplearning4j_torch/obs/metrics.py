"""Metrics primitives — the port's copy of
``deeplearning4j_tpu/obs/metrics.py``: thread-safe counters, gauges, and
streaming histograms (with OpenMetrics exemplars) behind one
:class:`MetricsRegistry`, exportable as Prometheus text, OpenMetrics text
and JSON. Same names, label handling, bucket scheme and byte-for-byte
output as the reference, so dashboards read both packages alike.

Stdlib only: the registry is importable (and servable over ``/metrics``)
in any process. This module is pure bookkeeping.

Naming conventions (see ``obs/README.md``): snake_case, base-unit suffix
(``_seconds``, ``_bytes``), monotonic counters end in ``_total``. Histograms
keep fixed buckets (geometric, tuned for sub-millisecond..minute latencies)
plus streaming min/max, so p50/p95/p99 come from in-bucket linear
interpolation without storing samples.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Geometric-ish latency buckets (seconds): 100 us .. 60 s. Wide enough for a
# LeNet step (~1 ms) and a ResNet compile (~30 s) on the same axis.
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
    """Monotonic counter. ``inc`` only; negative increments are rejected."""

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
    """Point-in-time value; set/inc/dec."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket streaming histogram with quantile estimation.

    Bucket ``i`` counts observations in ``(bounds[i-1], bounds[i]]``; one
    overflow bucket catches everything above ``bounds[-1]``. Quantiles are
    estimated by linear interpolation inside the target bucket, with the
    tracked min/max tightening the first/overflow bucket edges — accuracy is
    bounded by bucket width, which is the standard streaming trade
    (Prometheus histogram_quantile makes the same one).
    """

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_min", "_max",
                 "_exemplars", "_lock")

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
        # bucket index -> (observed value, trace_id, unix seconds): the last
        # traced observation that landed in that bucket, exported as an
        # OpenMetrics exemplar so a p99 bucket links straight to a trace
        self._exemplars: Dict[int, Tuple[float, str, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if trace_id is not None:
                self._exemplars[i] = (v, trace_id, time.time())

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
                    # no observation lies outside [min, max]: clamping the
                    # bucket edges tightens the first/overflow buckets (and
                    # makes a single-sample bucket exact)
                    lower = max(lower, self._min)
                    upper = max(min(upper, self._max), lower)
                    return lower + (upper - lower) * ((target - cum) / c)
                cum += c
            return self._max

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def _snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            mn = self._min if self._count else None
            mx = self._max if self._count else None
            exemplars = dict(self._exemplars)
        cum, buckets = 0, []
        for bound, c in zip(list(self._bounds) + [math.inf], counts):
            cum += c
            buckets.append((bound, cum))
        return {"count": total, "sum": s, "min": mn, "max": mx,
                "buckets": buckets, "exemplars": exemplars}


class _NullCounter(Counter):
    def inc(self, amount: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    def set(self, value: float) -> None:
        pass

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass


class _NullHistogram(Histogram):
    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        pass


# shared no-op instruments: a disabled registry hands these out so callers
# keep the exact same call surface at near-zero cost (one attribute call)
_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class _Family:
    """One metric name: type + help + {labelset -> instrument}."""

    __slots__ = ("kind", "help", "series")

    def __init__(self, kind: str, help_: str):
        self.kind = kind
        self.help = help_
        self.series: Dict[Tuple[Tuple[str, str], ...], object] = {}


class MetricsRegistry:
    """Thread-safe instrument registry.

    ``counter``/``gauge``/``histogram`` create-or-return the instrument for
    (name, labels); re-registering a name as a different type raises. With
    ``enabled=False`` every accessor returns a shared no-op instrument and
    both exports are empty — the strict-no-op contract the training hot path
    relies on.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # --- instrument accessors ---
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
        if not self.enabled:
            return _NULL_COUNTER
        return self._get("counter", name, labels, help, Counter)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        return self._get("gauge", name, labels, help, Gauge)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        return self._get("histogram", name, labels, help,
                         lambda: Histogram(buckets))

    def remove_series(self, name: str,
                      labels: Optional[Dict[str, str]] = None) -> bool:
        """Delete one (name, labels) series — the retire path for gauges
        whose labelled subject (a replica, a worker) no longer exists, so
        scrapes stop showing ghosts. Counters should generally NOT be
        removed (their history is the point); gauges describe present
        state, and a gauge for something gone is a lie. Dropping the last
        series drops the family too — no orphan ``# TYPE`` metadata.
        Returns True iff a series was actually removed."""
        if not self.enabled:
            return False
        key = tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None or key not in fam.series:
                return False
            del fam.series[key]
            if not fam.series:
                del self._families[name]
            return True

    # --- export ---
    def _items(self) -> List[Tuple[str, _Family]]:
        with self._lock:
            return sorted(self._families.items())

    def snapshot(self) -> dict:
        """JSON-safe dict: {name: {type, help, series: [...]}}."""
        if not self.enabled:
            return {}
        out = {}
        for name, fam in self._items():
            series = []
            for key in sorted(fam.series):
                inst = fam.series[key]
                entry: dict = {"labels": dict(key)}
                if isinstance(inst, Histogram):
                    snap = inst._snapshot()
                    entry.update(snap)
                    entry["buckets"] = [["+Inf" if math.isinf(b) else b, c]
                                        for b, c in snap["buckets"]]
                    ex = snap.get("exemplars") or {}
                    if ex:
                        entry["exemplars"] = {str(i): list(e)
                                              for i, e in ex.items()}
                    else:
                        entry.pop("exemplars", None)
                    entry["quantiles"] = inst.percentiles()
                else:
                    entry["value"] = inst.value
                series.append(entry)
            out[name] = {"type": fam.kind, "help": fam.help, "series": series}
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name, fam in self._items():
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.series):
                inst = fam.series[key]
                if isinstance(inst, Histogram):
                    snap = inst._snapshot()
                    for bound, cum in snap["buckets"]:
                        lbl = _label_str(key + (("le", _fmt_value(bound)),))
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    lbl = _label_str(key)
                    lines.append(f"{name}_sum{lbl} {_fmt_value(snap['sum'])}")
                    lines.append(f"{name}_count{lbl} {snap['count']}")
                else:
                    lines.append(f"{name}{_label_str(key)} "
                                 f"{_fmt_value(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_openmetrics(self) -> str:
        """OpenMetrics text exposition (version 1.0.0).

        Same data as :meth:`to_prometheus` plus histogram *exemplars*
        (``# {trace_id="..."} value ts`` after a bucket sample) — exemplars
        are only legal in this format, which is why both exist. Counter
        families drop their ``_total`` suffix in metadata (the OpenMetrics
        family/sample-name split); the terminating ``# EOF`` is mandatory.
        """
        lines: List[str] = []
        for name, fam in self._items():
            fam_name = (name[:-len("_total")]
                        if fam.kind == "counter" and name.endswith("_total")
                        else name)
            lines.append(f"# TYPE {fam_name} {fam.kind}")
            if fam.help:
                lines.append(f"# HELP {fam_name} {fam.help}")
            for key in sorted(fam.series):
                inst = fam.series[key]
                if isinstance(inst, Histogram):
                    snap = inst._snapshot()
                    exemplars = snap["exemplars"]
                    for i, (bound, cum) in enumerate(snap["buckets"]):
                        lbl = _label_str(key + (("le", _fmt_value(bound)),))
                        line = f"{name}_bucket{lbl} {cum}"
                        ex = exemplars.get(i)
                        if ex is not None:
                            v, trace_id, ts = ex
                            line += (f' # {{trace_id="'
                                     f'{_escape_label_value(trace_id)}"}} '
                                     f"{_fmt_value(v)} {ts:.3f}")
                        lines.append(line)
                    lbl = _label_str(key)
                    lines.append(f"{name}_sum{lbl} {_fmt_value(snap['sum'])}")
                    lines.append(f"{name}_count{lbl} {snap['count']}")
                elif fam.kind == "counter":
                    lines.append(f"{fam_name}_total{_label_str(key)} "
                                 f"{_fmt_value(inst.value)}")
                else:
                    lines.append(f"{name}{_label_str(key)} "
                                 f"{_fmt_value(inst.value)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _label_str(key: Iterable[Tuple[str, str]]) -> str:
    parts = [f'{k}="{_escape_label_value(str(v))}"' for k, v in key]
    return "{" + ",".join(parts) + "}" if parts else ""


# Process-global default registry — the prometheus_client idiom: library code
# that wants a cheap always-on counter (e.g. streaming dropped frames) shares
# this one, while trainers/servers create their own scoped registries.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
