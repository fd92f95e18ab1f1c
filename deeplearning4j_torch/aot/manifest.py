"""Prebuild manifests and store coverage records — counterpart of
``deeplearning4j_tpu/aot/manifest.py``, with the manifest format kept, so
a manifest written by either package loads in the other.

A manifest is the explicit list of (site, bucket-signature) pairs a
replica's boot demands. The reference derives it from its static
compile-surface pass; the port expands one serving config directly
(:func:`enumerate_config`: every serving site of the port with its bound
over the config's bucket tables, the reference's
``analysis/enumerate.py`` expansion copied as a function of the config
alone). This module also owns the deployment half of the contract:

- ``aot prebuild`` warms the manifest product into the store and stamps a
  **coverage record**: the concrete store keys it warmed, keyed on
  ``(runtime fingerprint, manifest hash)``. Keys fold in torch, CUDA, the
  card, the kernel sources and the model architecture, so a record
  stamped on one runtime is simply absent on another.
- ``aot verify --manifest`` (and a strict ``ModelServer`` boot) loads the
  record for the current runtime and lists every obligation it misses,
  and every kernel library it names that the store no longer holds.
- A graph has nothing to persist, so the coverage records are also what
  a serving executable's lookup reads (:func:`covered_keys`): a key some
  record of this runtime names is a hit. A capture outside a prebuild
  stamps its key into the runtime's record of captures
  (:func:`stamp_captured`), so the next boot hits it, as the reference's
  live compile saves its executable.

Records live under ``<store-root>/coverage/``: the store's entry scanner
only descends into two-character fan-out directories, so coverage records
are never mistaken for entries and never GC'd by the LRU.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from .keys import runtime_fingerprint
from .store import AotStore

MANIFEST_VERSION = 1

#: The port's serving sites: (site id, store tag, gate, bound). The gate
#: names which boot builds the executable: ``engine`` (always), ``gen``
#: (any batcher), ``paged`` / ``dense`` (that KV mode's batcher). The
#: bounds are the reference's budgeted ones (scripts/compile_budget.json).
SITES: Tuple[Tuple[str, str, str, str], ...] = (
    ("deeplearning4j_torch.serve.engine:forward", "engine_forward",
     "engine", "|batch_buckets|*|length_buckets|"),
    ("deeplearning4j_torch.serve.continuous:_sample_fn", "gen_sample",
     "gen", "1"),
    ("deeplearning4j_torch.serve.continuous:_decode_paged_fn",
     "gen_decode_paged", "paged", "1"),
    ("deeplearning4j_torch.serve.continuous:_prefill_paged_fn",
     "gen_prefill_chunk", "paged", "|_chunk_buckets|"),
    ("deeplearning4j_torch.serve.continuous:_decode_dense_fn",
     "gen_decode_dense", "dense", "1"),
    ("deeplearning4j_torch.serve.continuous:_prefill_dense_fn",
     "gen_prefill_dense", "dense", "|prompt_buckets|"),
    ("deeplearning4j_torch.serve.continuous:_slot_insert_fn",
     "gen_slot_insert", "dense", "1"),
)

_DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
_DEFAULT_CAPACITY = 256
_DEFAULT_PREFILL_CHUNK = 64


def manifest_hash(manifest: dict) -> str:
    """Stable 16-hex digest over the manifest's canonical JSON (the
    ``hash`` field itself excluded): one half of the coverage-record key
    ``(runtime fingerprint, manifest hash)``."""
    body = {k: v for k, v in manifest.items() if k != "hash"}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def default_prompt_buckets(capacity: int) -> Tuple[int, ...]:
    """Powers of two from 8 up to (and including) the KV capacity: the
    batcher's default prompt buckets."""
    buckets, b = [], 8
    while b < capacity:
        buckets.append(b)
        b *= 2
    buckets.append(capacity)
    return tuple(sorted(set(buckets)))


def chunk_buckets(prompt_buckets: Tuple[int, ...],
                  prefill_chunk: Optional[int]) -> Tuple[int, ...]:
    """The prompt buckets a single prefill chunk can cover, plus the chunk
    width itself; ``prefill_chunk=None`` means whole-prompt prefill over
    the prompt buckets."""
    if prefill_chunk is None:
        return tuple(prompt_buckets)
    return tuple(sorted(set(
        [b for b in prompt_buckets if b <= prefill_chunk]
        + [int(prefill_chunk)])))


def resolve_tables(config: dict) -> Dict[str, list]:
    """The concrete bucket tables one serving config boots with.

    ``config`` carries the knobs a replica passes to ``ServeEngine`` /
    ``ContinuousBatcher`` (``engine`` and ``gen`` groups, the tuned-config
    schema's key names). ``length_buckets`` unset resolves to the one-entry
    table ``[None]`` (the model's native input shape)."""
    engine = dict(config.get("engine") or {})
    gen = dict(config.get("gen") or {})
    batch = [int(b) for b in sorted(set(
        engine.get("batch_buckets") or _DEFAULT_BATCH_BUCKETS))]
    length = engine.get("length_buckets")
    length = ([int(b) for b in sorted(set(length))] if length
              else [None])
    capacity = int(gen.get("capacity") or _DEFAULT_CAPACITY)
    prompt = gen.get("prompt_buckets") or default_prompt_buckets(capacity)
    # the constructor's normalization: ints, deduped, capped at capacity
    prompt = tuple(sorted(set(
        int(b) for b in prompt if int(b) <= capacity))) or (capacity,)
    kv = str(gen.get("kv") or "paged")
    prefill_chunk = gen.get("prefill_chunk", _DEFAULT_PREFILL_CHUNK)
    if kv == "paged":
        chunks = chunk_buckets(
            prompt, int(prefill_chunk) if prefill_chunk is not None
            else None)
    else:
        chunks = prompt
    return {"batch_buckets": batch, "length_buckets": length,
            "prompt_buckets": list(prompt), "_chunk_buckets": list(chunks)}


def _gate_open(gate: str, kv: str, predict_only: bool) -> Optional[str]:
    """None when this boot builds the executable, else the skip reason."""
    if gate == "engine":
        return None
    if predict_only:
        return "predict-only config: no generation stack is built"
    if gate == "gen":
        return None
    if gate != kv:
        return (f"kv={kv!r} boot never builds this executable "
                f"({gate}-path only)")
    return None


def enumerate_config(config: dict) -> dict:
    """Expand one serving ``config`` into a prebuild manifest: every site
    of :data:`SITES` either enumerated (its bound's bucket tables
    resolved, signatures = the cross product) or excluded with a reason
    (wrong KV mode, predict-only)."""
    tables = resolve_tables(config)
    gen = dict(config.get("gen") or {})
    kv = str(gen.get("kv") or "paged")
    predict_only = bool(config.get("predict_only"))
    sites_out: List[dict] = []
    excluded: List[dict] = []
    for site, tag, gate, bound in sorted(SITES):
        reason = _gate_open(gate, kv, predict_only)
        if reason is not None:
            excluded.append({"site": site, "bound": bound,
                             "reason": reason})
            continue
        axes = [(name, list(tables[name]))
                for name in sorted(set(re.findall(r"\|(\w+)\|", bound)))]
        signatures = [dict(zip([n for n, _ in axes], combo))
                      for combo in itertools.product(
                          *[vals for _, vals in axes])]
        sites_out.append({
            "site": site, "tag": tag, "path": None, "line": None,
            "bound": bound, "cardinality": len(signatures),
            "signatures": signatures,
        })
    manifest = {
        "version": MANIFEST_VERSION,
        "tool": "deeplearning4j_torch.aot",
        "config": config,
        "tables": tables,
        "sites": sites_out,
        "excluded": excluded,
        "total_signatures": sum(s["cardinality"] for s in sites_out),
    }
    manifest["hash"] = manifest_hash(manifest)
    return manifest


def write_manifest(manifest: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2)
        fh.write("\n")


COVERAGE_SCHEMA = 1


def load_manifest(path: str) -> dict:
    """Read a prebuild manifest and verify its self-hash — a hand-edited
    manifest must fail loudly, not ship a partial surface."""
    with open(path, "r", encoding="utf-8") as fh:
        manifest = json.load(fh)
    if not isinstance(manifest, dict) or "sites" not in manifest:
        raise ValueError(f"{path}: not a prebuild manifest")
    want = manifest.get("hash")
    got = manifest_hash(manifest)
    if want != got:
        raise ValueError(f"{path}: manifest hash mismatch "
                         f"(stamped {want}, computed {got}) — regenerate "
                         "it from its serving config")
    return manifest


def runtime_hash(runtime: Optional[dict] = None) -> str:
    """16-hex digest of one runtime fingerprint — the file-name-safe half
    of the coverage key."""
    rt = runtime if runtime is not None else runtime_fingerprint()
    canon = "|".join(f"{k}={rt[k]}" for k in sorted(rt))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def coverage_path(store: AotStore, manifest: dict,
                  runtime: Optional[dict] = None) -> str:
    return os.path.join(
        store.root, "coverage",
        f"{runtime_hash(runtime)}-{manifest['hash']}.json")


def record_coverage(store: AotStore, manifest: dict, tags: dict, *,
                    runtime: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """Stamp a coverage record after a prebuild: ``tags`` maps each AOT
    tag to the list of store keys warmed for it. Written atomically
    (write-then-rename, same discipline as store entries); returns the
    record path."""
    rt = runtime if runtime is not None else runtime_fingerprint()
    path = coverage_path(store, manifest, rt)
    record = {
        "schema": COVERAGE_SCHEMA,
        "manifest_hash": manifest["hash"],
        "runtime": rt,
        "runtime_hash": runtime_hash(rt),
        "created": time.time(),
        "tags": {tag: sorted(keys) for tag, keys in sorted(tags.items())},
        "total_keys": sum(len(keys) for keys in tags.values()),
        **(extra or {}),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_coverage(store: AotStore, manifest: dict,
                  runtime: Optional[dict] = None) -> Optional[dict]:
    """The coverage record for (current runtime, this manifest), or None
    when no prebuild ever stamped one — which verify/boot treats exactly
    like an empty store: nothing is covered."""
    try:
        return _read_record(coverage_path(store, manifest, runtime))
    except (OSError, ValueError):
        return None


def missing_signatures(store: AotStore, manifest: dict,
                       runtime: Optional[dict] = None) -> List[str]:
    """Every manifest obligation the store cannot currently serve, as
    human/CI-readable ``tag key…`` lines. Three failure layers, checked
    in order: no coverage record for this (runtime, manifest) pair at
    all; a manifest site whose tag the record never warmed, or warmed
    short; a kernel library the record names whose store entry has since
    been evicted, deleted, or quarantined (the reference checks each
    recorded executable's entry there: a captured graph has none)."""
    record = load_coverage(store, manifest, runtime)
    if record is None:
        return [f"(no coverage record for runtime "
                f"{runtime_hash(runtime)} × manifest {manifest['hash']} "
                "— run `aot prebuild` on this runtime)"]
    out: List[str] = []
    recorded = record.get("tags", {})
    for site in manifest.get("sites", []):
        tag = site["tag"]
        keys = recorded.get(tag)
        if not keys:
            out.append(f"{tag}: never prebuilt "
                       f"({site['cardinality']} signature(s) of "
                       f"{site['site']})")
            continue
        if len(keys) < site["cardinality"]:
            out.append(f"{tag}: prebuild warmed {len(keys)} of "
                       f"{site['cardinality']} signature(s)")
    # a captured graph has no store entry; the kernel libraries the
    # prebuild put into the store do
    on_disk = set(store.keys())
    for name, key in sorted((record.get("kernels") or {}).items()):
        if key not in on_disk:
            out.append(f"kernel library {name}: store entry {key[:16]}… "
                       "is gone")
    return out


CAPTURED = "captured"   # the record of captures made outside a prebuild
_STAMP_LOCK = threading.Lock()


def _read_record(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        record = json.load(fh)
    if not isinstance(record, dict) \
            or record.get("schema") != COVERAGE_SCHEMA \
            or not isinstance(record.get("tags"), dict):
        raise ValueError(f"{path}: not a coverage record")
    return record


def covered_keys(store: AotStore, runtime: Optional[dict] = None
                 ) -> Tuple[frozenset, int]:
    """Every store key that a coverage record of this runtime names (a
    prebuild's, or the record of captures), and the number of this
    runtime's records that could not be read."""
    rh = runtime_hash(runtime)
    root = os.path.join(store.root, "coverage")
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return frozenset(), 0
    keys, unreadable = set(), 0
    for name in names:
        if not (name.startswith(f"{rh}-") and name.endswith(".json")):
            continue
        try:
            for tag_keys in _read_record(os.path.join(root, name))[
                    "tags"].values():
                keys.update(str(k) for k in tag_keys)
        except (OSError, ValueError, TypeError):
            unreadable += 1
    return frozenset(keys), unreadable


def stamp_captured(store: AotStore, tag: str, key: str,
                   runtime: Optional[dict] = None) -> None:
    """Add one key captured outside a prebuild to this runtime's record of
    captures (``coverage/<runtime hash>-captured.json``, written as
    :func:`record_coverage` writes; an unreadable one starts over).
    Raises OSError when the record cannot be written."""
    rt = runtime if runtime is not None else runtime_fingerprint()
    captured = {"hash": CAPTURED}
    with _STAMP_LOCK:
        try:
            tags = _read_record(coverage_path(store, captured, rt))["tags"]
        except (OSError, ValueError):
            tags = {}
        tags[tag] = sorted(set(tags.get(tag, [])) | {key})
        record_coverage(store, captured, tags, runtime=rt)
