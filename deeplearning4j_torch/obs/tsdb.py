"""In-process time-series store — the port's copy of
``deeplearning4j_tpu/obs/tsdb.py``: bounded history over registry snapshots.

A :class:`TimeSeriesStore` turns the point-in-time ``MetricsRegistry.
snapshot()`` the stack already exports into *history*: each ``ingest``
appends one sample per series to a bounded ring, on an injectable clock,
so alerting and forecasting can ask "what has this gauge done over the
last ten minutes" without a Prometheus deployment. Stdlib only, like the
rest of obs/.

Materialization follows the metric kind:

- **gauges** keep raw last-values per sample;
- **counters** store the raw cumulative points and materialize
  per-second *rates* at query time (``rate=True``), clamping negative
  deltas to zero so process restarts read as a flat spot, not a cliff;
- **histograms** are decomposed into quantile *tracks* (``p50``/``p95``/
  ``p99`` plus the cumulative ``count``) — the JSON snapshot carries the
  streaming quantile estimates the text exposition cannot.

Downsampling keeps a full diurnal day (and more) in bounded memory:
every appended point also feeds per-tier **rollup** accumulators (default
raw -> 1m -> 10m). A tier's open bucket folds points as they arrive and
is finalized — appended to the tier's own bounded ring, counted on
``tsdb_rollup_points_total{tier}`` — when the first point of a *later*
bucket lands. Counters (and histogram ``count`` tracks) roll up as the
bucket's **last cumulative value**, so a ``rate=True`` query over a
rollup tier materializes exactly the count-weighted mean rate of each
bucket; gauges and quantile tracks roll up as the bucket **max**, so
spikes survive downsampling. Queries prefer raw points and fall back to
the finest tier whose retention still covers the requested ``t_min``
(override with ``tier=``).

Staleness has two deliberately different tiers:

- a source that stops answering (dead/suspect replica, failed scrape) is
  **soft-stale** via :meth:`mark_stale`: its series drop out of live
  queries but resurrect the moment the source answers again;
- a series that disappears from a snapshot the source *did* answer was
  removed on purpose (``MetricsRegistry.remove_series`` — e.g. a reaped
  replica's ``cluster_replica_state``) and is **tombstoned**: it never
  resurrects, even if a later snapshot re-reports the same key. Ghost
  gauges outliving their subject is exactly the lie remove_series
  exists to prevent, and the store must not un-tell it.

Every mutation happens under one internal lock; self-describing
``tsdb_*`` metrics are updated outside it so the store never blocks a
scrape of the registry that contains them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# Histogram quantile tracks materialized from snapshot entries, plus the
# cumulative count (rate-queryable like a counter).
_HIST_TRACKS = ("p50", "p95", "p99")


class _Tier:
    """One downsampling tier: bucket width + its own retention knobs."""

    __slots__ = ("name", "bucket_s", "points", "horizon_s")

    def __init__(self, name: str, bucket_s: float, points: int,
                 horizon_s: float):
        self.name = str(name)
        self.bucket_s = float(bucket_s)
        self.points = max(2, int(points))
        self.horizon_s = float(horizon_s)


# raw (1h at scrape cadence) -> 1m buckets for a day -> 10m for a week
_DEFAULT_ROLLUPS = (("1m", 60.0, 1440, 86400.0),
                    ("10m", 600.0, 1008, 604800.0))


class _Series:
    """One (name, labels, track) ring of (t, value) points."""

    __slots__ = ("kind", "labels", "track", "points", "stale_at",
                 "rollups", "open")

    def __init__(self, kind: str, labels: Dict[str, str], track: str,
                 maxlen: int):
        self.kind = kind
        self.labels = labels
        self.track = track
        self.points: deque = deque(maxlen=maxlen)
        self.stale_at: Optional[float] = None   # None == live
        self.rollups: Dict[str, deque] = {}     # tier name -> finalized ring
        # tier name -> open bucket [start, count, sum, max, last]
        self.open: Dict[str, list] = {}


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _match(labels: Dict[str, str], want: Optional[Dict[str, str]]) -> bool:
    """Subset match: every wanted (k, v) must be present in the series."""
    if not want:
        return True
    for k, v in want.items():
        if labels.get(k) != str(v):
            return False
    return True


class TimeSeriesStore:
    """Bounded multi-source time-series store over registry snapshots.

    ``retention_points`` caps every series ring; ``retention_s`` prunes
    points older than the horizon on ingest, so a slow-ticking series
    cannot pin arbitrarily old samples just because its ring never
    filled. ``clock`` is injectable — the smokes and tests drive the
    store on a fake clock and pass explicit ``now`` values for
    byte-stable histories.
    """

    def __init__(self, *, clock=time.monotonic, retention_points: int = 720,
                 retention_s: float = 3600.0, metrics=None,
                 rollups=_DEFAULT_ROLLUPS):
        self._clock = clock
        self.retention_points = max(2, int(retention_points))
        self.retention_s = float(retention_s)
        # downsampling tiers, finest first: (name, bucket_s,
        # retention_points, retention_s) tuples; () disables rollups
        self._rollups: Tuple[_Tier, ...] = tuple(
            _Tier(*spec) for spec in sorted(
                (rollups or ()), key=lambda s: float(s[1])))
        self._metrics = metrics
        self._lock = threading.Lock()
        # (name, label_key, track) -> _Series
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...], str],
                           _Series] = {}
        # source -> keys seen in that source's last answered snapshot
        self._by_source: Dict[str, frozenset] = {}
        self._tombstones: set = set()
        self._points_total: Dict[str, int] = {}

    # ------------------------------------------------------------ ingest
    def ingest(self, source: str, snapshot: Dict[str, dict],
               now: Optional[float] = None,
               extra_labels: Optional[Dict[str, str]] = None) -> int:
        """Append one sample per series of an answered snapshot.

        ``extra_labels`` are merged into every series' labels *without*
        overriding keys the snapshot already carries (the scraper's
        ``replica`` relabel must not clobber ``cluster_replica_state``'s
        own ``replica`` label). Series present in the source's previous
        answered snapshot but absent from this one are tombstoned.
        Returns the number of points appended.
        """
        t = self._clock() if now is None else float(now)
        added = 0
        rolled: Dict[str, int] = {}
        with self._lock:
            prev = self._by_source.get(source, frozenset())
            seen = set()
            for name, fam in snapshot.items():
                kind = str(fam.get("type", "gauge"))
                for entry in fam.get("series", ()):
                    labels = dict(entry.get("labels") or {})
                    for k, v in (extra_labels or {}).items():
                        labels.setdefault(k, v)
                    if kind == "histogram":
                        tracks = [(q, (entry.get("quantiles") or {}).get(q))
                                  for q in _HIST_TRACKS]
                        tracks.append(("count", entry.get("count")))
                    else:
                        tracks = [("", entry.get("value"))]
                    lkey = _label_key(labels)
                    for track, val in tracks:
                        if val is None:
                            continue
                        key = (name, lkey, track)
                        seen.add(key)
                        if key in self._tombstones:
                            continue
                        rec = self._series.get(key)
                        if rec is None:
                            rec = self._series[key] = _Series(
                                kind, labels, track, self.retention_points)
                        rec.stale_at = None
                        self._append_locked(rec, t, float(val), rolled)
                        added += 1
            # an answered snapshot is authoritative for its source: keys it
            # used to report and no longer does were removed on purpose
            for key in prev - seen:
                self._tombstones.add(key)
                rec = self._series.get(key)
                if rec is not None and rec.stale_at is None:
                    rec.stale_at = t
            self._by_source[source] = frozenset(seen)
            self._points_total[source] = (
                self._points_total.get(source, 0) + added)
            live, stale = self._counts_locked()
        self._export(source, added, live, stale, rolled)
        return added

    def append_instant(self, name: str, labels: Dict[str, str],
                       value: float, now: Optional[float] = None,
                       source: str = "instant") -> None:
        """Append one point to an event-style series, outside the
        presence-diff contract.

        Snapshot ingest treats a source's answered snapshot as
        authoritative: series it stops reporting are tombstoned
        forever. Instants (the autoscaler's decision stream) are the
        opposite shape — stamped once at event time by a dedicated
        reader, absent from every scrape snapshot — so they must never
        enter a source's seen-set, never be tombstone candidates, and
        may carry timestamps older than the newest scrape (the reader
        catches up on the log). Ring and horizon retention still apply.
        """
        t = self._clock() if now is None else float(now)
        labels = {str(k): str(v) for k, v in (labels or {}).items()}
        key = (name, _label_key(labels), "")
        rolled: Dict[str, int] = {}
        with self._lock:
            rec = self._series.get(key)
            if rec is None:
                rec = self._series[key] = _Series(
                    "instant", labels, "", self.retention_points)
            rec.stale_at = None
            self._append_locked(rec, t, float(value), rolled)
            self._points_total[source] = (
                self._points_total.get(source, 0) + 1)
            live, stale = self._counts_locked()
        self._export(source, 1, live, stale, rolled)

    def mark_stale(self, source: str, now: Optional[float] = None) -> int:
        """Soft-stale every series of an unreachable source.

        Unlike tombstoning this is reversible: the next answered ingest
        for the source revives its series. Returns how many went stale.
        """
        t = self._clock() if now is None else float(now)
        n = 0
        with self._lock:
            for key in self._by_source.get(source, frozenset()):
                rec = self._series.get(key)
                if rec is not None and rec.stale_at is None:
                    rec.stale_at = t
                    n += 1
            live, stale = self._counts_locked()
        self._export(source, 0, live, stale)
        return n

    def _counts_locked(self) -> Tuple[int, int]:
        stale = sum(1 for s in self._series.values()
                    if s.stale_at is not None)
        return len(self._series) - stale, stale

    # ----------------------------------------------------------- rollups
    def _append_locked(self, rec: _Series, t: float, v: float,
                       rolled: Dict[str, int]) -> None:
        """Append one point and feed every rollup tier's open bucket;
        finalized-bucket counts accumulate into ``rolled`` (emitted on
        ``tsdb_rollup_points_total{tier}`` outside the lock)."""
        rec.points.append((t, v))
        horizon = t - self.retention_s
        while rec.points and rec.points[0][0] < horizon:
            rec.points.popleft()
        for tier in self._rollups:
            start = t - (t % tier.bucket_s)
            ob = rec.open.get(tier.name)
            if ob is None:
                rec.open[tier.name] = [start, 1, v, v, v]
                continue
            if start > ob[0]:
                self._finalize_locked(rec, tier, ob, horizon_from=t)
                rolled[tier.name] = rolled.get(tier.name, 0) + 1
                rec.open[tier.name] = [start, 1, v, v, v]
            else:
                # same bucket — or a late out-of-order instant: fold in
                ob[1] += 1
                ob[2] += v
                ob[3] = max(ob[3], v)
                ob[4] = v

    def _finalize_locked(self, rec: _Series, tier: _Tier, ob: list,
                         horizon_from: float) -> None:
        """Close one bucket into the tier's ring. Counters (and histogram
        ``count`` tracks) keep the last cumulative value — a rate query
        over the rollup yields the bucket's count-weighted mean rate;
        everything else keeps the max so spikes survive downsampling."""
        counter_like = rec.kind == "counter" or rec.track == "count"
        val = ob[4] if counter_like else ob[3]
        ring = rec.rollups.get(tier.name)
        if ring is None:
            ring = rec.rollups[tier.name] = deque(maxlen=tier.points)
        ring.append((ob[0] + tier.bucket_s, val))
        horizon = horizon_from - tier.horizon_s
        while ring and ring[0][0] < horizon:
            ring.popleft()

    def _export(self, source: str, added: int, live: int, stale: int,
                rolled: Optional[Dict[str, int]] = None) -> None:
        """Self-metrics — called outside the store lock by design."""
        m = self._metrics
        if m is None:
            return
        if added:
            m.counter("tsdb_points_total", {"source": source},
                      help="Samples appended to the time-series store"
                      ).inc(added)
        for tier_name in sorted(rolled or ()):
            m.counter("tsdb_rollup_points_total", {"tier": tier_name},
                      help="Finalized downsampled points, by rollup tier"
                      ).inc(rolled[tier_name])
        m.gauge("tsdb_series", help="Live (non-stale) stored series"
                ).set(float(live))
        m.gauge("tsdb_stale_series",
                help="Stored series currently marked stale or tombstoned"
                ).set(float(stale))

    # ------------------------------------------------------------- query
    @staticmethod
    def _rate_points(points: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for i in range(1, len(points)):
            t0, v0 = points[i - 1]
            t1, v1 = points[i]
            dt = t1 - t0
            if dt <= 0.0:
                continue
            # counter reset (process restart) reads as zero, not a cliff
            out.append((t1, max(0.0, v1 - v0) / dt))
        return out

    def _tier_points_locked(self, rec: _Series, t_min: Optional[float],
                            tier: Optional[str]
                            ) -> Tuple[List[Tuple[float, float]], str]:
        """(points, tier name) for one series honoring tier precedence:
        an explicit ``tier`` wins; otherwise raw points serve the query
        unless they no longer reach back to ``t_min``, in which case the
        finest rollup tier that does (or the deepest-reaching one when
        none fully covers) takes over."""
        if tier is not None and tier != "raw":
            return list(rec.rollups.get(tier) or ()), tier
        raw = list(rec.points)
        if tier == "raw" or t_min is None:
            return raw, "raw"
        if raw and raw[0][0] <= t_min:
            return raw, "raw"
        best: Tuple[List[Tuple[float, float]], str] = (raw, "raw")
        best_reach = raw[0][0] if raw else float("inf")
        for tr in self._rollups:  # finest first
            ring = rec.rollups.get(tr.name)
            if not ring:
                continue
            if ring[0][0] <= t_min:
                return list(ring), tr.name
            if ring[0][0] < best_reach:
                best, best_reach = (list(ring), tr.name), ring[0][0]
        return best

    def query(self, name: str, labels: Optional[Dict[str, str]] = None,
              track: Optional[str] = None, t_min: Optional[float] = None,
              t_max: Optional[float] = None, rate: bool = False,
              include_stale: bool = False,
              tier: Optional[str] = None) -> List[dict]:
        """JSON-ready range query: list of matching series with points.

        ``labels`` is a subset match; ``track`` of None matches every
        track. ``rate=True`` materializes per-second deltas (meaningful
        for counters and histogram ``count`` tracks). ``tier`` pins one
        resolution ("raw", "1m", "10m"); None applies precedence — raw
        while it covers ``t_min``, else the finest covering rollup. The
        answering tier rides in each series' ``tier`` field. Floats are
        rounded to 6 dp so serialized query results are byte-stable.
        """
        out: List[dict] = []
        with self._lock:
            for key in sorted(self._series):
                if key[0] != name:
                    continue
                rec = self._series[key]
                if rec.stale_at is not None and not include_stale:
                    continue
                if not _match(rec.labels, labels):
                    continue
                if track is not None and rec.track != track:
                    continue
                pts, served_by = self._tier_points_locked(rec, t_min, tier)
                if rate:
                    pts = self._rate_points(pts)
                pts = [(t, v) for (t, v) in pts
                       if (t_min is None or t >= t_min)
                       and (t_max is None or t <= t_max)]
                out.append({
                    "labels": dict(rec.labels),
                    "kind": rec.kind,
                    "track": rec.track,
                    "tier": served_by,
                    "stale": rec.stale_at is not None,
                    "points": [[round(t, 6), round(v, 6)]
                               for (t, v) in pts],
                })
        return out

    def latest(self, name: str, labels: Optional[Dict[str, str]] = None,
               track: Optional[str] = None
               ) -> List[Tuple[Dict[str, str], float, float]]:
        """(labels, t, value) of the last point of each matching LIVE
        series — the alert engine's instantaneous read."""
        out: List[Tuple[Dict[str, str], float, float]] = []
        with self._lock:
            for key in sorted(self._series):
                if key[0] != name:
                    continue
                rec = self._series[key]
                if rec.stale_at is not None or not rec.points:
                    continue
                if not _match(rec.labels, labels):
                    continue
                if track is not None and rec.track != track:
                    continue
                t, v = rec.points[-1]
                out.append((dict(rec.labels), t, v))
        return out

    def window_rate(self, name: str,
                    labels: Optional[Dict[str, str]] = None,
                    track: Optional[str] = None, window_s: float = 60.0,
                    now: Optional[float] = None
                    ) -> List[Tuple[Dict[str, str], float]]:
        """(labels, per-second rate) over the trailing window per live
        series — the alert engine's rate-of-change read."""
        t1 = self._clock() if now is None else float(now)
        t0 = t1 - float(window_s)
        out: List[Tuple[Dict[str, str], float]] = []
        with self._lock:
            for key in sorted(self._series):
                if key[0] != name:
                    continue
                rec = self._series[key]
                if rec.stale_at is not None or not _match(rec.labels,
                                                          labels):
                    continue
                if track is not None and rec.track != track:
                    continue
                pts = [(t, v) for (t, v) in rec.points if t0 <= t <= t1]
                if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
                    out.append((dict(rec.labels), 0.0))
                    continue
                delta = max(0.0, pts[-1][1] - pts[0][1])
                out.append((dict(rec.labels),
                            delta / (pts[-1][0] - pts[0][0])))
        return out

    def sources(self) -> List[str]:
        """Sorted sources that have ever answered an ingest."""
        with self._lock:
            return sorted(self._by_source)

    def families(self) -> List[str]:
        """Sorted names with at least one live series."""
        with self._lock:
            return sorted({k[0] for k, rec in self._series.items()
                           if rec.stale_at is None})

    def stats(self) -> Dict[str, int]:
        """Store shape for tests and debug surfaces."""
        with self._lock:
            live, stale = self._counts_locked()
            return {
                "series": live,
                "stale": stale,
                "tombstoned": len(self._tombstones),
                "points": sum(len(s.points) for s in self._series.values()),
                "rollup_points": sum(
                    len(ring) for s in self._series.values()
                    for ring in s.rollups.values()),
                "sources": len(self._by_source),
            }
