"""Tuned serving configs in the store — the port's copy of
``deeplearning4j_tpu/aot/tuned.py`` (same key, canonical JSON and
counters).

The autotuner produces a winning knob dict per workload; this module
persists it next to the kernel libraries so a booting replica resolves
both from the same place with the same key discipline. The key is
:func:`~.keys.cache_key` over

- ``tag="sim_tuned_config"`` (never collides with executable entries),
- the **runtime fingerprint** (a config tuned on a CPU box must be a
  clean miss on the card: the knobs encode throughput assumptions), and
- the **workload fingerprint** as the call signature.

Values are canonical JSON; corrupt or unparseable entries degrade to a
miss. Resolution is counted on ``sim_tuned_config_hits_total`` /
``_misses_total``.
"""

from __future__ import annotations

import json
from typing import Optional

from .keys import cache_key
from .store import AotStoreError

_TAG = "sim_tuned_config"
_HITS = "sim_tuned_config_hits_total"
_MISSES = "sim_tuned_config_misses_total"
_HELP_HITS = "Tuned serving configs resolved from the AOT store at boot."
_HELP_MISSES = ("Tuned-config lookups that missed (no entry for this "
                "runtime+workload, or corrupt).")


def tuned_group(config: Optional[dict], group: str) -> dict:
    """One group of a resolved tuned config as a plain dict (empty on a
    miss or malformed entry) — the accessor every consumer shares (the
    fleet's ``engine``/``gen`` knob groups, the autoscale policy's
    ``autoscale`` group), so a corrupt or partial config degrades to
    defaults at each call site instead of raising."""
    if not isinstance(config, dict):
        return {}
    g = config.get(group)
    return dict(g) if isinstance(g, dict) else {}


def tuned_key(workload_fp: str, runtime: Optional[dict] = None) -> str:
    """Store key for one (runtime fingerprint, workload fingerprint) pair."""
    return cache_key(_TAG, "config", (str(workload_fp),), runtime=runtime)


def put_tuned(store, workload_fp: str, config: dict, *,
              runtime: Optional[dict] = None,
              extra_meta: Optional[dict] = None) -> Optional[str]:
    """Persist a knob dict; returns the key, or None if the store refused
    (store puts never raise — same degraded-mode contract as executables)."""
    key = tuned_key(workload_fp, runtime=runtime)
    blob = json.dumps(config, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    meta = {"kind": _TAG, "workload_fingerprint": str(workload_fp)}
    if extra_meta:
        meta.update(extra_meta)
    return key if store.put(key, blob, meta=meta) else None


def get_tuned(store, workload_fp: str, *, runtime: Optional[dict] = None,
              metrics=None) -> Optional[dict]:
    """Resolve a tuned knob dict, or None. Counts hit/miss on ``metrics``."""
    def _count(name: str, help_: str) -> None:
        if metrics is not None:
            metrics.counter(name, help=help_).inc()

    if store is None:
        _count(_MISSES, _HELP_MISSES)
        return None
    key = tuned_key(workload_fp, runtime=runtime)
    try:
        blob = store.get(key)
    except AotStoreError:
        blob = None  # corrupt entry: store already quarantined it
    if blob is None:
        _count(_MISSES, _HELP_MISSES)
        return None
    try:
        config = json.loads(blob.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        config = None
    if not isinstance(config, dict):
        _count(_MISSES, _HELP_MISSES)
        return None
    _count(_HITS, _HELP_HITS)
    return config
