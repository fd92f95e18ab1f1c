"""Sampled continuous profiler for the store-backed dispatch seam — the
port's copy of ``deeplearning4j_tpu/obs/profile.py``.

The serving tier funnels every device step through one seam —
:meth:`~deeplearning4j_torch.aot.compile.AotFunction.__call__` — which
makes executable-level cost attribution a one-hook problem. This module is
that hook: a process-global :class:`Profiler` (installed like
``obs.reqtrace``/``chaos.faults``) that accumulates, per executable keyed
by **(component, tag, bucket signature, store key)**:

- **device-time histograms** — host-fenced (``torch.cuda.synchronize`` on
  the card) so the asynchronous replay finishes inside the timed window,
  sampled 1-in-N with exact-count extrapolation: every dispatch bumps the
  exact counter, only every Nth pays the fence, and the total device time
  estimate is ``sampled_sum * dispatches / sampled``;
- **padding-waste accounting** — the dispatch sites annotate each call
  with (live units, padded capacity) via :meth:`Profiler.hint`, exactly
  (not sampled), surfaced as ``serve_padding_waste_ratio{component,
  bucket}`` = 1 − live/padded;
- **device-memory high-water marks per component** —
  ``torch.cuda.max_memory_allocated`` probed on sampled dispatches (0 on
  the CPU).

The zero-overhead contract is the reference's: with no profiler installed
(``ACTIVE is None``) the hot decode tick pays one module attribute load
and a ``None`` check — no allocation, no call.

Stdlib-only at import time: torch is imported lazily and only on the
sampled path.

CLI: ``python -m deeplearning4j_torch.obs.profile cost_profile.json``
prints the top-N executables by estimated device time with waste ratios
and per-token costs — see :mod:`~deeplearning4j_torch.obs.costmodel`.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

ACTIVE: Optional["Profiler"] = None

# bound on retained (live units, device seconds) sample pairs per
# executable — the cost-model regressions need variance, not history
_MAX_PAIRS = 512


def install(profiler: "Profiler") -> "Profiler":
    """Make ``profiler`` the process-global dispatch hook."""
    global ACTIVE
    ACTIVE = profiler
    return profiler


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None


def _torch_fence(value: Any) -> None:
    """Block until the dispatched work behind ``value`` (a tensor, or a
    tuple/dict of them) is done: a synchronize of its card, nothing on
    the CPU."""
    import torch

    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
            return
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)


def _torch_hbm_peak() -> int:
    """Peak device-memory bytes from the caching allocator, 0 without a
    card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return 0
        return int(torch.cuda.max_memory_allocated())
    except Exception:  # any backend without allocator stats reads as 0
        return 0


class _ExecStats:
    """Accumulated cost of ONE compiled executable."""

    __slots__ = ("component", "tag", "sig", "key", "dispatches", "sampled",
                 "device_s", "live", "padded", "hinted", "pairs")

    def __init__(self, component: str, tag: str, sig: Tuple[str, ...],
                 key: str):
        self.component = component
        self.tag = tag
        self.sig = sig
        self.key = key
        self.dispatches = 0      # exact: every dispatch
        self.sampled = 0         # fenced + timed dispatches
        self.device_s = 0.0      # sum of sampled device seconds
        self.hinted = 0          # dispatches that carried a padding hint
        self.live = 0            # sum of hinted live units
        self.padded = 0          # sum of hinted padded capacities
        self.pairs: List[Tuple[int, float]] = []  # sampled (live, dt)

    def device_s_est(self) -> float:
        """Exact-count extrapolation of total device seconds."""
        if self.sampled == 0:
            return 0.0
        return self.device_s * (self.dispatches / self.sampled)

    def to_dict(self, include_pairs: bool = False) -> dict:
        d: Dict[str, Any] = {
            "component": self.component, "tag": self.tag,
            "signature": list(self.sig), "key": self.key,
            "dispatches": self.dispatches, "sampled": self.sampled,
            "device_s_sampled": self.device_s,
            "device_s_est": self.device_s_est(),
            "us_per_dispatch": (self.device_s / self.sampled * 1e6
                                if self.sampled else 0.0),
        }
        if self.hinted:
            d["live_per_dispatch"] = self.live / self.hinted
            d["padded_per_dispatch"] = self.padded / self.hinted
            d["waste_ratio"] = (1.0 - self.live / self.padded
                                if self.padded else 0.0)
        if include_pairs:
            d["pairs"] = [[lv, dt] for lv, dt in self.pairs]
        return d


class _PadStats:
    """Exact padding accounting for one (component, bucket)."""

    __slots__ = ("dispatches", "live", "padded")

    def __init__(self):
        self.dispatches = 0
        self.live = 0
        self.padded = 0

    def waste(self) -> float:
        return 1.0 - self.live / self.padded if self.padded else 0.0


class Profiler:
    """Sampled executable-level cost accumulator.

    ``sample_rate`` = N means 1-in-N dispatches per executable are fenced
    and timed (the first dispatch of every executable is always sampled,
    so a short run still attributes every executable). ``clock``,
    ``fence`` and ``hbm_probe`` are injectable for deterministic tests;
    the defaults use ``time.perf_counter`` and torch. ``metrics`` (a
    :class:`~.metrics.MetricsRegistry`) gets the ``profile_*`` families
    and ``serve_padding_waste_ratio`` so the federated scraper carries
    attribution into the TSDB.
    """

    def __init__(self, *, sample_rate: int = 16, metrics=None,
                 clock=time.perf_counter, fence=_torch_fence,
                 hbm_probe=_torch_hbm_peak):
        if sample_rate < 1:
            raise ValueError("sample_rate must be >= 1")
        self.sample_rate = int(sample_rate)
        self.metrics = metrics
        self._clock = clock
        self._fence = fence
        self._hbm_probe = hbm_probe
        self._lock = threading.Lock()
        self._stats: Dict[Tuple[str, str, Tuple[str, ...]], _ExecStats] = {}
        self._pad: Dict[Tuple[str, int], _PadStats] = {}
        self._hbm: Dict[str, int] = {}
        self._page_in_n = 0
        self._page_in_s = 0.0
        self._tl = threading.local()
        # instrument caches: one instrument per label set, resolved once
        self._g_waste: Dict[Tuple[str, int], Any] = {}
        self._h_device: Dict[Tuple[str, str], Any] = {}
        self._g_disp: Dict[Tuple[str, str], Any] = {}
        self._g_dev_est: Dict[Tuple[str, str], Any] = {}
        self._g_hbm: Dict[str, Any] = {}

    # ------------------------------------------------------------ hot hooks
    def hint(self, component: str, live: int, padded: int) -> None:
        """Annotate the NEXT dispatch on this thread with its live-unit /
        padded-capacity pair (rows/bucket, tokens/bucket, slots/slots).
        Also folds the pair into the exact per-(component, bucket) padding
        accounting — every dispatch, not sampled."""
        self._tl.hint = (int(live), int(padded))
        pk = (component, int(padded))
        with self._lock:
            ps = self._pad.get(pk)
            if ps is None:
                ps = self._pad[pk] = _PadStats()
            ps.dispatches += 1
            ps.live += int(live)
            ps.padded += int(padded)
            waste = ps.waste()
        m = self.metrics
        if m is not None:
            g = self._g_waste.get(pk)
            if g is None:
                labels = {"component": component, "bucket": str(padded)}
                g = m.gauge("serve_padding_waste_ratio", labels,
                            help="1 - live/padded units per dispatch, "
                                 "averaged over the profiled window")
                self._g_waste[pk] = g
            g.set(waste)

    def dispatch(self, fn, sig: Tuple[str, ...], exe, args):
        """Run ``exe(*args)`` for :class:`AotFunction` ``fn``, accounting
        the dispatch and — 1-in-N — fencing and timing it."""
        hint = getattr(self._tl, "hint", None)
        if hint is not None:
            self._tl.hint = None
        component = getattr(fn, "component", "serve")
        ek = (component, fn.tag, sig)
        with self._lock:
            st = self._stats.get(ek)
        if st is None:
            # resolve the store key outside our lock (it takes the
            # AotFunction's), then insert with a double-check
            key = fn.store_key(sig)
            with self._lock:
                st = self._stats.get(ek)
                if st is None:
                    st = _ExecStats(component, fn.tag, sig, key)
                    self._stats[ek] = st
        with self._lock:
            st.dispatches += 1
            if hint is not None:
                st.hinted += 1
                st.live += hint[0]
                st.padded += hint[1]
            sample = (self.sample_rate == 1
                      or st.dispatches % self.sample_rate == 1)
        if not sample:
            return exe(*args)
        t0 = self._clock()
        out = exe(*args)
        self._fence(out)
        dt = self._clock() - t0
        hbm = self._hbm_probe() if self._hbm_probe is not None else 0
        with self._lock:
            st.sampled += 1
            st.device_s += dt
            if hint is not None:
                if len(st.pairs) < _MAX_PAIRS:
                    st.pairs.append((hint[0], dt))
                else:  # deterministic ring replacement, no RNG
                    st.pairs[st.sampled % _MAX_PAIRS] = (hint[0], dt)
            if hbm > self._hbm.get(component, 0):
                self._hbm[component] = hbm
            dispatches = st.dispatches
            dev_est = st.device_s_est()
        self._observe(component, fn.tag, dt, dispatches, dev_est, hbm)
        return out

    def page_in(self, seconds: float) -> None:
        """One weight page-in transfer (``fleet/pager.py`` seam)."""
        with self._lock:
            self._page_in_n += 1
            self._page_in_s += float(seconds)

    # -------------------------------------------------------------- metrics
    def _observe(self, component: str, tag: str, dt: float,
                 dispatches: int, dev_est: float, hbm: int) -> None:
        """Emit the sampled dispatch onto the registry — outside the
        profiler lock (the registry has its own)."""
        m = self.metrics
        if m is None:
            return
        mk = (component, tag)
        h = self._h_device.get(mk)
        if h is None:
            labels = {"component": component, "tag": tag}
            h = m.histogram("profile_dispatch_device_seconds", labels,
                            help="sampled host-fenced device time per "
                                 "dispatch, by executable family")
            self._h_device[mk] = h
            self._g_disp[mk] = m.gauge(
                "profile_dispatches", labels,
                help="exact dispatch count per executable family")
            self._g_dev_est[mk] = m.gauge(
                "profile_device_seconds_est", labels,
                help="extrapolated total device seconds "
                     "(sampled_sum * dispatches / sampled)")
        h.observe(dt)
        self._g_disp[mk].set(dispatches)
        self._g_dev_est[mk].set(dev_est)
        if hbm > 0:
            g = self._g_hbm.get(component)
            if g is None:
                labels = {"component": component}
                g = m.gauge("profile_hbm_peak_bytes", labels,
                            help="backend allocator peak bytes observed "
                                 "on sampled dispatches")
                self._g_hbm[component] = g
            g.set(hbm)

    # ------------------------------------------------------------- snapshot
    def snapshot(self, top: Optional[int] = None,
                 include_pairs: bool = False) -> dict:
        """JSON-ready state: executables sorted by estimated total device
        time (descending, optionally top-N), exact padding accounting,
        HBM peaks, page-in transfer stats."""
        with self._lock:
            execs = [st.to_dict(include_pairs=include_pairs)
                     for st in self._stats.values()]
            pad = {f"{c}/{b}": {"component": c, "bucket": b,
                                "dispatches": ps.dispatches,
                                "live": ps.live, "padded": ps.padded,
                                "waste_ratio": ps.waste()}
                   for (c, b), ps in sorted(self._pad.items())}
            hbm = dict(self._hbm)
            page_n, page_s = self._page_in_n, self._page_in_s
        execs.sort(key=lambda d: d["device_s_est"], reverse=True)
        if top is not None:
            execs = execs[:int(top)]
        return {"enabled": True, "sample_rate": self.sample_rate,
                "executables": execs, "padding": pad,
                "hbm_peak_bytes": hbm,
                "page_in": {"count": page_n, "total_s": page_s,
                            "mean_s": page_s / page_n if page_n else 0.0}}


def debug_payload(top: int = 20) -> dict:
    """Body for ``GET /v1/debug/profile``: the active profiler's top-N
    snapshot, or ``{"enabled": false}`` when none is installed."""
    prof = ACTIVE
    if prof is None:
        return {"enabled": False}
    return prof.snapshot(top=top)


# -------------------------------------------------------------------- CLI
def format_report(doc: dict, top: int = 10) -> str:
    """Fixed-width report from a profiler snapshot or a CostProfile
    artifact (``obs/costmodel.py``) — both carry an ``executables`` list."""
    execs = list(doc.get("executables") or [])
    execs.sort(key=lambda d: d.get("device_s_est", 0.0), reverse=True)
    lines = ["top executables by estimated device time",
             f"{'component':<10} {'tag':<20} {'dispatches':>10} "
             f"{'us/dispatch':>12} {'device_s_est':>13} {'waste':>6}"]
    for d in execs[:top]:
        waste = d.get("waste_ratio")
        lines.append(
            f"{d.get('component', '?'):<10} {d.get('tag', '?'):<20} "
            f"{d.get('dispatches', 0):>10} "
            f"{d.get('us_per_dispatch', 0.0):>12.1f} "
            f"{d.get('device_s_est', 0.0):>13.6f} "
            f"{'-' if waste is None else format(waste, '.2f'):>6}")
    costs = doc.get("costs")
    if costs:
        lines.append("derived cost model (measured; '-' = not observed):")
        for k in sorted(costs):
            v = costs[k]
            lines.append(f"  {k:<20} "
                         f"{'-' if v is None else format(v, '.6g')}")
    pad = doc.get("padding")
    if pad:
        lines.append("padding waste by (component, bucket):")
        for k in sorted(pad):
            p = pad[k]
            lines.append(f"  {k:<16} dispatches={p['dispatches']:<8} "
                         f"waste={p['waste_ratio']:.3f}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_torch.obs.profile",
        description="Report a captured cost profile / profiler snapshot.")
    ap.add_argument("path", help="cost_profile.json or a "
                                 "/v1/debug/profile snapshot")
    ap.add_argument("--top", type=int, default=10,
                    help="executables to show (default 10)")
    args = ap.parse_args(argv)
    with open(args.path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    print(format_report(doc, top=args.top))
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI shim
    raise SystemExit(main())
