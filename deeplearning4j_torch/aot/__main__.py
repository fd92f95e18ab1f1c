"""CLI for the port's prebuilt-executable store — counterpart of
``python -m deeplearning4j_tpu.aot``.

::

    python -m deeplearning4j_torch.aot --store DIR list
    python -m deeplearning4j_torch.aot --store DIR stats
    python -m deeplearning4j_torch.aot --store DIR verify \\
        [--manifest prebuild_manifest.json]
    python -m deeplearning4j_torch.aot --store DIR gc [--max-bytes N]
    python -m deeplearning4j_torch.aot --store DIR rebuild-index
    python -m deeplearning4j_torch.aot --store DIR prebuild \\
        --config serve_config.json [--manifest-out prebuild_manifest.json]
    python -m deeplearning4j_torch.aot --store DIR prebuild \\
        --manifest prebuild_manifest.json

``prebuild`` expands a serving config (the JSON the reference's
``scripts/serve_config.json`` holds: ``model``, ``model_kwargs``, ``seed``,
``dtype``, ``engine`` and ``gen`` groups; the port also reads
``compute_dtype``) into its manifest (``manifest.enumerate_config``), or
takes a manifest that carries its config, and boots the real serving
stacks (``ServeEngine`` + ``ContinuousBatcher``) against the store with
warm-at-construction on. On the card that builds every kernel library
(nvcc) and puts it into the store, and captures every serving graph once
to prove it captures; then it cross-checks the warmed key count of every manifest site against its
cardinality (exit 1 on drift: the booted stacks and the manifest disagree)
and stamps the coverage record keyed on (runtime fingerprint, manifest
hash): the keys a strict replica's graphs look up, and the kernel
libraries it installs, both verified at boot. ``--device cpu`` prebuilds
for the CPU. Run it on the card kind the fleet serves on: the keys make a
prebuild for another card a harmless miss.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .manifest import (enumerate_config, load_manifest, missing_signatures,
                       record_coverage, write_manifest)
from .store import AotStore


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _cmd_list(store: AotStore, _args) -> int:
    entries = store.entries()
    if not entries:
        print("(empty store)")
        return 0
    for key in sorted(entries, key=lambda k: -entries[k].get("used", 0.0)):
        e = entries[key]
        meta = e.get("meta") or {}
        print(f"{key[:16]}  {_fmt_bytes(e['size']):>10}  "
              f"tag={meta.get('tag', '?')}  arch={meta.get('arch', '?')}")
    print(f"-- {len(entries)} entries, "
          f"{_fmt_bytes(sum(e['size'] for e in entries.values()))}")
    return 0


def _cmd_stats(store: AotStore, _args) -> int:
    print(json.dumps(store.stats(), indent=1))
    return 0


def _cmd_verify(store: AotStore, args) -> int:
    out = store.verify()
    print(f"ok={len(out['ok'])} quarantined={len(out['quarantined'])}")
    for key in out["quarantined"]:
        print(f"quarantined: {key}")
    rc = 1 if out["quarantined"] else 0
    if getattr(args, "manifest", None):
        from .keys import runtime_fingerprint

        manifest = load_manifest(args.manifest)
        missing = missing_signatures(store, manifest,
                                     runtime_fingerprint(args.device))
        for line in missing:
            print(f"missing: {line}")
        if missing:
            print(f"manifest {manifest['hash']}: "
                  f"{len(missing)} obligation(s) unmet")
            rc = 1
        else:
            print(f"manifest {manifest['hash']}: fully covered "
                  f"({manifest.get('total_signatures')} signature(s))")
    return rc


def _cmd_gc(store: AotStore, args) -> int:
    evicted = store.gc(max_bytes=args.max_bytes)
    print(f"evicted {len(evicted)} entries")
    return 0


def _cmd_rebuild_index(store: AotStore, _args) -> int:
    print(f"indexed {store.rebuild_index()} entries")
    return 0


def serving_model(config: dict, device=None):
    """The model a serving config names, built on ``device`` (the card
    when None) with random weights from the config's seed."""
    from ..models import model_by_name

    seed = int(config.get("seed", 0))
    model = model_by_name(config["model"], seed=seed, device=device,
                          **(config.get("model_kwargs") or {})).build()
    if config.get("compute_dtype"):
        model.config.compute_dtype = config["compute_dtype"]
    model.init(seed=seed)
    return model


def prebuild(store: AotStore, manifest: dict, *, device=None,
             model=None) -> dict:
    """Warm the manifest's serving config into ``store`` and stamp its
    coverage record. Returns a report; ``report["drift"]`` lists every
    site whose warmed key count differs from its cardinality (no record
    is stamped then). ``model`` skips building the config's model."""
    import numpy as np

    from ..device import resolve_device
    from ..obs.metrics import MetricsRegistry
    from ..serve import ContinuousBatcher, ServeEngine
    from ..serve.continuous import gen_opts_from_config
    from ..serve.engine import ENGINE_KNOBS
    from .compile import save_kernels
    from .keys import runtime_fingerprint

    config = manifest.get("config") or {}
    device = resolve_device(device if model is None else model.device)
    rt = runtime_fingerprint(device)
    t0 = time.perf_counter()
    kernels = {}
    if device.type == "cuda":
        from ..kernels import _build

        _build.build_all()
        kernels = save_kernels(store, rt)
    if model is None:
        model = serving_model(config, device)
    metrics = MetricsRegistry()
    engine_opts = {k: v for k, v in (config.get("engine") or {}).items()
                   if k in ENGINE_KNOBS}
    fns: dict = {}
    eng = ServeEngine(model, aot_store=store, metrics=metrics,
                      **engine_opts)
    try:
        eng.warm(np.dtype(config.get("dtype") or "int32"))
        fns.update(eng.aot_functions())
    finally:
        eng.shutdown()
    if not config.get("predict_only"):
        cb = ContinuousBatcher(model, aot_store=store, metrics=metrics,
                               **gen_opts_from_config(config))
        fns.update(cb.aot_functions())
        cb.shutdown()  # warm-at-construction already captured all
        cb.release_device()
    elapsed = time.perf_counter() - t0
    metrics.gauge("aot_prebuild_seconds",
                  help="wall time of the last prebuild warm pass"
                  ).set(elapsed)
    tags = {tag: fn.warmed_keys() for tag, fn in fns.items()}
    drift = []
    for site in manifest.get("sites", []):
        tag = site["tag"]
        got = len(tags.get(tag, []))
        metrics.counter("aot_prebuild_signatures_total", {"tag": tag},
                        help="signatures warmed and recorded by prebuild"
                        ).inc(got)
        if got != site["cardinality"]:
            metrics.counter(
                "aot_prebuild_drift_total",
                help="manifest sites whose warmed executable count "
                     "diverged from the enumerated cardinality").inc()
            drift.append(
                f"{tag}: warmed {got} executable(s) but the manifest "
                f"enumerates {site['cardinality']} for {site['site']}")
    report = {
        "manifest": manifest["hash"],
        "model": config.get("model"),
        "sites": {tag: len(keys) for tag, keys in sorted(tags.items())},
        "total_signatures": sum(len(k) for k in tags.values()),
        "kernels": sorted(kernels),
        "prebuild_seconds": elapsed,
        "drift": drift,
    }
    if not drift:
        report["coverage_record"] = record_coverage(
            store, manifest, tags, runtime=rt,
            extra={"model": config.get("model"),
                   "prebuild_seconds": elapsed,
                   "kernels": kernels})
    report["store"] = store.stats()
    return report


def _cmd_prebuild(store: AotStore, args) -> int:
    if args.manifest:
        manifest = load_manifest(args.manifest)
    elif args.config:
        with open(args.config, "r", encoding="utf-8") as fh:
            manifest = enumerate_config(json.load(fh))
    else:
        print("prebuild: --config (or --manifest) is required",
              file=sys.stderr)
        return 2
    if not (manifest.get("config") or {}).get("model"):
        print("prebuild: the manifest carries no serving config",
              file=sys.stderr)
        return 1
    if args.manifest_out:
        write_manifest(manifest, args.manifest_out)
    report = prebuild(store, manifest, device=args.device)
    for line in report["drift"]:
        print(f"surface drift: {line}", file=sys.stderr)
    print(json.dumps(report, indent=1))
    if report["drift"]:
        print("prebuild: the booted stacks and the manifest disagree — "
              "regenerate the manifest from the serving config",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_torch.aot",
        description="prebuilt-executable store maintenance")
    p.add_argument("--store", default=os.environ.get("DL4J_TORCH_AOT_STORE"),
                   help="store root directory (or $DL4J_TORCH_AOT_STORE)")
    p.add_argument("--device", default=None,
                   help="serving device (default: the CUDA card)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list entries, most recently used first")
    sub.add_parser("stats", help="entry/byte/quarantine totals as JSON")
    vf = sub.add_parser("verify",
                        help="integrity-check (and quarantine) entries")
    vf.add_argument("--manifest", default=None,
                    help="also gate on a prebuild manifest: exit 1 listing "
                         "every signature the store cannot serve")
    sub.add_parser("rebuild-index", help="regenerate the index from disk")
    gc = sub.add_parser("gc", help="LRU-evict down to the size bound")
    gc.add_argument("--max-bytes", type=int, default=None)
    pb = sub.add_parser("prebuild",
                        help="warm and record a serving config's graphs")
    pb.add_argument("--config", default=None,
                    help="serving config JSON to expand into a manifest")
    pb.add_argument("--manifest", default=None,
                    help="a prebuild manifest carrying its serving config")
    pb.add_argument("--manifest-out", default=None,
                    help="write the expanded manifest here")
    args = p.parse_args(argv)
    if not args.store:
        p.error("--store (or $DL4J_TORCH_AOT_STORE) is required")
    store = AotStore(args.store)
    return {"list": _cmd_list, "stats": _cmd_stats, "verify": _cmd_verify,
            "gc": _cmd_gc, "rebuild-index": _cmd_rebuild_index,
            "prebuild": _cmd_prebuild}[args.cmd](store, args)


if __name__ == "__main__":
    sys.exit(main())
