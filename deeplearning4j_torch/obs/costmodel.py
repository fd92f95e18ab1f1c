"""Measured cost profiles — the port's copy of
``deeplearning4j_tpu/obs/costmodel.py``: fold profiler samples into a
persisted :class:`CostProfile`.

The profiler (:mod:`~deeplearning4j_torch.obs.profile`) accumulates raw
per-executable device-time samples; :class:`ProfileAccumulator` folds one
or more snapshots into a :class:`CostProfile` artifact — per-executable
µs/dispatch, a per-token decode cost, prefill cost per chunk bucket, the
page-in transfer cost — by fitting ``device_s = intercept + slope *
live_units`` over the retained (live, seconds) sample pairs of each
executable class:

- ``engine_forward``  -> ``predict_dispatch_s`` + ``predict_row_s``/row
- ``gen_prefill_*``   -> ``chunk_dispatch_s`` + tokens/``prefill_tok_s``
- ``gen_decode_*``    -> ``decode_base_s`` + ``decode_slot_s``/slot
- pager page-ins      -> ``page_in_s``

A field the run never exercised stays ``None`` (calibration degrades per
field, never whole-model).

Persistence mirrors ``aot/tuned.py``: canonical JSON in the store under
``cache_key("cost_profile", "profile", (model_fp,), runtime=...)``, keyed
by the **runtime fingerprint** (a CPU box's microseconds must be a clean
miss on the card) and the **model fingerprint**
(``aot.arch_fingerprint``). Corrupt or unparseable entries degrade to a
counted miss (``profile_store_hits_total`` / ``_misses_total``).

Stdlib-only.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

_TAG = "cost_profile"
_HITS = "profile_store_hits_total"
_MISSES = "profile_store_misses_total"
_HELP_HITS = "Measured cost profiles resolved from the AOT store."
_HELP_MISSES = ("Cost-profile lookups that missed (no entry for this "
                "runtime+model, or corrupt).")

# cost fields a profile may measure; None = not observed, keep defaults
_COST_FIELDS = ("predict_row_s", "predict_dispatch_s", "prefill_tok_s",
                "chunk_dispatch_s", "decode_base_s", "decode_slot_s",
                "page_in_s")


class CostProfile(NamedTuple):
    """One measured serving cost profile (JSON-stable artifact)."""

    executables: Tuple[dict, ...] = ()
    padding: Dict[str, dict] = {}
    hbm_peak_bytes: Dict[str, int] = {}
    costs: Dict[str, Optional[float]] = {}
    sample_rate: int = 0

    def cost(self, field: str) -> Optional[float]:
        """One measured cost field, or None when the run never saw it."""
        v = self.costs.get(field)
        return float(v) if isinstance(v, (int, float)) and v > 0 else None

    def waste_ratio(self) -> Optional[float]:
        """Overall padding waste: 1 − Σlive/Σpadded across all buckets."""
        live = sum(p.get("live", 0) for p in self.padding.values())
        padded = sum(p.get("padded", 0) for p in self.padding.values())
        return 1.0 - live / padded if padded else None

    def top_executables(self, n: int = 3) -> List[dict]:
        ex = sorted(self.executables,
                    key=lambda d: d.get("device_s_est", 0.0), reverse=True)
        return [dict(d) for d in ex[:n]]

    def to_dict(self) -> dict:
        return {"schema": 1, "executables": [dict(e) for e in
                                             self.executables],
                "padding": dict(self.padding),
                "hbm_peak_bytes": dict(self.hbm_peak_bytes),
                "costs": dict(self.costs),
                "sample_rate": self.sample_rate}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, doc: dict) -> "CostProfile":
        if not isinstance(doc, dict):
            raise ValueError("cost profile must be a JSON object")
        costs = doc.get("costs") or {}
        return cls(
            executables=tuple(dict(e) for e in doc.get("executables") or ()
                              if isinstance(e, dict)),
            padding={str(k): dict(v) for k, v
                     in (doc.get("padding") or {}).items()
                     if isinstance(v, dict)},
            hbm_peak_bytes={str(k): int(v) for k, v
                            in (doc.get("hbm_peak_bytes") or {}).items()},
            costs={k: (float(costs[k]) if costs.get(k) is not None
                       else None) for k in _COST_FIELDS},
            sample_rate=int(doc.get("sample_rate") or 0))


def _fit(pairs: List[Tuple[float, float]]
         ) -> Tuple[Optional[float], Optional[float]]:
    """Ordinary least squares ``y = intercept + slope * x`` over sampled
    (live units, device seconds) pairs. Returns (intercept, slope); with
    fewer than two distinct x values the slope is unfittable -> (mean_y,
    None). Negative fits clamp to the physically meaningful floor."""
    if not pairs:
        return None, None
    n = len(pairs)
    mean_y = sum(y for _, y in pairs) / n
    xs = {x for x, _ in pairs}
    if len(xs) < 2:
        return mean_y, None
    mean_x = sum(x for x, _ in pairs) / n
    sxx = sum((x - mean_x) ** 2 for x, _ in pairs)
    sxy = sum((x - mean_x) * (y - mean_y) for x, y in pairs)
    slope = sxy / sxx
    intercept = mean_y - slope * mean_x
    if slope <= 0.0:
        return mean_y, None
    return max(intercept, 0.0), slope


class ProfileAccumulator:
    """Folds profiler snapshots (``Profiler.snapshot(include_pairs=True)``)
    into one :class:`CostProfile`."""

    def __init__(self):
        self._execs: Dict[Tuple[str, str, str], dict] = {}
        self._padding: Dict[str, dict] = {}
        self._hbm: Dict[str, int] = {}
        self._page_n = 0
        self._page_s = 0.0
        self._sample_rate = 0

    def fold(self, snapshot: dict) -> "ProfileAccumulator":
        """Merge one snapshot; repeated folds sum counts and extend the
        regression pairs."""
        self._sample_rate = max(self._sample_rate,
                                int(snapshot.get("sample_rate") or 0))
        for e in snapshot.get("executables") or ():
            k = (e.get("component", ""), e.get("tag", ""),
                 "|".join(e.get("signature") or ()))
            cur = self._execs.get(k)
            if cur is None:
                cur = self._execs[k] = {
                    "component": e.get("component", ""),
                    "tag": e.get("tag", ""),
                    "signature": list(e.get("signature") or ()),
                    "key": e.get("key", ""), "dispatches": 0, "sampled": 0,
                    "device_s_sampled": 0.0, "pairs": []}
            cur["dispatches"] += int(e.get("dispatches") or 0)
            cur["sampled"] += int(e.get("sampled") or 0)
            cur["device_s_sampled"] += float(e.get("device_s_sampled")
                                             or 0.0)
            cur["pairs"].extend([float(x), float(y)] for x, y in
                                (e.get("pairs") or ()))
        for k, p in (snapshot.get("padding") or {}).items():
            cur = self._padding.get(k)
            if cur is None:
                cur = self._padding[k] = {
                    "component": p.get("component", ""),
                    "bucket": p.get("bucket", 0),
                    "dispatches": 0, "live": 0, "padded": 0}
            cur["dispatches"] += int(p.get("dispatches") or 0)
            cur["live"] += int(p.get("live") or 0)
            cur["padded"] += int(p.get("padded") or 0)
        for c, b in (snapshot.get("hbm_peak_bytes") or {}).items():
            self._hbm[c] = max(self._hbm.get(c, 0), int(b))
        page = snapshot.get("page_in") or {}
        self._page_n += int(page.get("count") or 0)
        self._page_s += float(page.get("total_s") or 0.0)
        return self

    def profile(self) -> CostProfile:
        """Derive the calibrated costs and freeze the artifact."""
        predict_pairs: List[Tuple[float, float]] = []
        prefill_pairs: List[Tuple[float, float]] = []
        decode_pairs: List[Tuple[float, float]] = []
        execs = []
        for cur in self._execs.values():
            pairs = [(x, y) for x, y in cur["pairs"]]
            tag = cur["tag"]
            if tag == "engine_forward":
                predict_pairs.extend(pairs)
            elif "prefill" in tag:
                prefill_pairs.extend(pairs)
            elif "decode" in tag:
                decode_pairs.extend(pairs)
            d = {k: v for k, v in cur.items() if k != "pairs"}
            sampled = d["sampled"]
            d["device_s_est"] = (d["device_s_sampled"]
                                 * d["dispatches"] / sampled
                                 if sampled else 0.0)
            d["us_per_dispatch"] = (d["device_s_sampled"] / sampled * 1e6
                                    if sampled else 0.0)
            execs.append(d)
        for k, p in self._padding.items():
            p["waste_ratio"] = (1.0 - p["live"] / p["padded"]
                                if p["padded"] else 0.0)

        predict_base, predict_row = _fit(predict_pairs)
        chunk_base, prefill_slope = _fit(prefill_pairs)
        decode_base, decode_slot = _fit(decode_pairs)
        # amortized fallback when one bucket dominates: all tokens over
        # all device time still beats a hand-set throughput guess
        prefill_tok_s = None
        if prefill_slope is not None and prefill_slope > 0:
            prefill_tok_s = 1.0 / prefill_slope
        elif prefill_pairs:
            toks = sum(x for x, _ in prefill_pairs)
            secs = sum(y for _, y in prefill_pairs)
            if toks > 0 and secs > 0:
                prefill_tok_s, chunk_base = toks / secs, None
        costs: Dict[str, Optional[float]] = {
            "predict_row_s": predict_row,
            "predict_dispatch_s": predict_base,
            "prefill_tok_s": prefill_tok_s,
            "chunk_dispatch_s": chunk_base,
            "decode_base_s": decode_base,
            "decode_slot_s": decode_slot,
            "page_in_s": (self._page_s / self._page_n
                          if self._page_n else None),
        }
        execs.sort(key=lambda d: d["device_s_est"], reverse=True)
        return CostProfile(
            executables=tuple(execs),
            padding={k: dict(v) for k, v in sorted(self._padding.items())},
            hbm_peak_bytes=dict(self._hbm), costs=costs,
            sample_rate=self._sample_rate)


# ----------------------------------------------------- AOT-store persistence
def profile_key(model_fp: str, runtime: Optional[dict] = None) -> str:
    """Store key for one (runtime fingerprint, model fingerprint) pair."""
    from ..aot.keys import cache_key

    return cache_key(_TAG, "profile", (str(model_fp),), runtime=runtime)


def put_profile(store, model_fp: str, profile: CostProfile, *,
                runtime: Optional[dict] = None,
                extra_meta: Optional[dict] = None) -> Optional[str]:
    """Persist a profile; returns the key, or None if the store refused
    (store puts never raise — same degraded-mode contract as executables
    and tuned configs)."""
    key = profile_key(model_fp, runtime=runtime)
    blob = profile.to_json().encode("utf-8")
    meta = {"kind": _TAG, "model_fingerprint": str(model_fp)}
    if extra_meta:
        meta.update(extra_meta)
    return key if store.put(key, blob, meta=meta) else None


def get_profile(store, model_fp: str, *, runtime: Optional[dict] = None,
                metrics=None) -> Optional[CostProfile]:
    """Resolve a measured profile, or None. Counts hit/miss on
    ``metrics``; every failure (absent store, I/O error, quarantined
    entry, bad JSON) degrades to a counted miss."""
    from ..aot.store import AotStoreError

    def _count(name: str, help_: str) -> None:
        if metrics is not None:
            metrics.counter(name, help=help_).inc()

    if store is None:
        _count(_MISSES, _HELP_MISSES)
        return None
    key = profile_key(model_fp, runtime=runtime)
    try:
        blob = store.get(key)
    except AotStoreError:
        blob = None  # corrupt entry: store already quarantined it
    if blob is None:
        _count(_MISSES, _HELP_MISSES)
        return None
    try:
        profile = CostProfile.from_dict(json.loads(blob.decode("utf-8")))
    except (ValueError, UnicodeDecodeError, TypeError):
        _count(_MISSES, _HELP_MISSES)
        return None
    _count(_HITS, _HELP_HITS)
    return profile
