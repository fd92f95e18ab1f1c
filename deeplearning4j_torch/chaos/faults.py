"""Deterministic fault injection — the seeded chaos plane; the port's copy
of ``deeplearning4j_tpu/chaos/faults.py``, with the same injection-point
names, spec strings and firing order.

The serving stack has real failure surface: daemon dispatcher/decode loops
whose death used to be silent, store and page-in I/O that can fail or
corrupt, HTTP handlers that must answer every request. None of it can be
trusted until it can be *exercised*, deterministically, in CI — the
TensorFlow lesson (PAPERS.md arXiv 1605.08695) that fault tolerance of
long-running workers is a system property you test, not hope for.

One process-global :class:`FaultPlane` holds a seeded scenario of armed
faults against **named injection points** — host-side seams the serving
tiers expose, always *before* any device work, so a fired fault never
leaves a half-written buffer behind. The port wires four of the
reference's points (the others, :data:`POINTS`, belong to tiers the port
has not taken yet; ``hit()`` accepts any name):

- ``fleet.page_in_transfer`` — the pager's host-to-device transfer step
- ``serve.decode_step``     — top of the continuous batcher's decode tick
- ``serve.dispatch``        — top of the engine's batch dispatch
- ``http.handler``          — front-door POST handlers (serve and fleet)

Multi-instance seams (one router talking to N in-process replicas) can be
targeted individually: a site passes ``scope="replica-0"`` to :meth:`hit`
and a spec armed with ``scope=replica-0`` fires only there, so the cluster
smoke can partition exactly one replica while the other keeps serving.

A fired fault **raises** a configured exception, **corrupts** one byte of
the data flowing through the seam, **delays**, or **hangs** (bounded, and
released early by :func:`uninstall` so a test suite can never wedge).
Firing is deterministic: each armed spec skips its first ``after``
qualifying hits then fires ``times`` times, in injection order; ``prob``
adds seeded randomness for soak-style runs (CI scenarios keep it at 1.0).

The OFF state is the contract: ``ACTIVE`` is ``None`` until
:func:`install`, and every injection site guards with a plain
``if faults.ACTIVE is not None`` — one module-attribute load on the hot
path, **zero fault-plane calls** when disabled (spy-asserted in
``tests/test_torch_chaos.py``), zero behavior change.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: The injection points the serving stack exposes. ``hit()`` accepts any
#: name (subsystems may add seams), but these are the wired-in ones.
POINTS = (
    "aot.store_read",
    "fleet.page_in_transfer",
    "serve.decode_step",
    "serve.dispatch",
    "http.handler",
    "cluster.transport",
    "autoscale.spawn",
    "elastic.step",
    "elastic.resize",
    "train.segment",
)

#: The installed plane, or None (the zero-overhead default). Injection
#: sites read this attribute and call nothing when it is None.
ACTIVE: Optional["FaultPlane"] = None

_MODES = ("error", "corrupt", "delay", "hang")

# spec-string error types (parse_spec); a Python API caller passes any
# exception type/instance directly
_ERROR_TYPES = {
    "runtime": RuntimeError,
    "os": OSError,
    "timeout": TimeoutError,
    "connection": ConnectionError,
}


class _Spec:
    """One armed fault: where, what, and how many times."""

    __slots__ = ("point", "mode", "error", "delay_s", "hang_s", "skip",
                 "remaining", "prob", "fired", "scope")

    def __init__(self, point: str, mode: str, *, error=None, delay_s=0.0,
                 hang_s=0.0, after: int = 0, times: int = 1,
                 prob: float = 1.0, scope: Optional[str] = None):
        self.point = point
        self.mode = mode
        self.scope = scope
        self.error = error
        self.delay_s = float(delay_s)
        self.hang_s = float(hang_s)
        self.skip = int(after)
        self.remaining = int(times)   # -1 = unbounded
        self.prob = float(prob)
        self.fired = 0


def parse_spec(text: str) -> Tuple[str, dict]:
    """``"point:mode[:k=v,...]"`` -> ``(point, inject-kwargs)``.

    Examples: ``aot.store_read:corrupt:times=1``,
    ``fleet.page_in_transfer:error:type=os,times=2``,
    ``serve.decode_step:hang:hang_s=5``.
    """
    parts = text.split(":")
    if len(parts) < 2:
        raise ValueError(f"fault spec {text!r} needs point:mode")
    point, mode = parts[0], parts[1]
    if mode not in _MODES:
        raise ValueError(f"unknown fault mode {mode!r}; one of {_MODES}")
    opts: Dict[str, str] = {}
    for chunk in parts[2:]:
        for item in chunk.split(","):
            if not item:
                continue
            k, _, v = item.partition("=")
            opts[k] = v
    kw: Dict[str, object] = {
        "times": int(opts.pop("times", 1)),
        "after": int(opts.pop("after", 0)),
        "prob": float(opts.pop("prob", 1.0)),
    }
    if "scope" in opts:
        kw["scope"] = opts.pop("scope")
    if mode == "error":
        name = opts.pop("type", "runtime")
        if name not in _ERROR_TYPES:
            raise ValueError(f"unknown error type {name!r}; one of "
                             f"{sorted(_ERROR_TYPES)}")
        kw["error"] = _ERROR_TYPES[name]
    elif mode == "corrupt":
        kw["corrupt"] = True
    elif mode == "delay":
        kw["delay_s"] = float(opts.pop("delay_s", 0.05))
    else:  # hang
        kw["hang_s"] = float(opts.pop("hang_s", 30.0))
    if opts:
        raise ValueError(f"unknown fault options {sorted(opts)} in {text!r}")
    return point, kw


class FaultPlane:
    """Seeded, deterministic fault scenario.

    Arm faults with :meth:`inject` (or :meth:`inject_spec` from a CLI
    string), :func:`install` the plane, run traffic, read
    :meth:`injected` / :meth:`hits` to assert the scenario actually
    exercised what it claimed to.
    """

    def __init__(self, seed: int = 0, metrics=None):
        self._rng = random.Random(int(seed))
        self._metrics = metrics
        self._lock = threading.Lock()
        self._specs: List[_Spec] = []
        self._hit_counts: Dict[str, int] = {}
        self._injected: Dict[Tuple[str, str], int] = {}
        self._unhang = threading.Event()

    # ------------------------------------------------------------------ arm
    def inject(self, point: str, *, error=None, corrupt: bool = False,
               delay_s: Optional[float] = None,
               hang_s: Optional[float] = None, times: int = 1,
               after: int = 0, prob: float = 1.0,
               scope: Optional[str] = None) -> "FaultPlane":
        """Arm one fault at ``point``. Exactly one of ``error`` (exception
        type or instance to raise), ``corrupt`` (flip one seeded byte of
        the data at the seam), ``delay_s``, or ``hang_s`` (bounded hang,
        released early by :meth:`release`). The fault skips its first
        ``after`` qualifying hits, then fires ``times`` times
        (``times=-1``: every hit); ``prob`` gates each firing on the
        plane's seeded RNG. ``scope`` narrows the fault to hits that pass
        the same scope (e.g. one replica id); ``None`` matches every hit.
        Returns self for chaining."""
        chosen = [m for m, on in (("error", error is not None),
                                  ("corrupt", corrupt),
                                  ("delay", delay_s is not None),
                                  ("hang", hang_s is not None)) if on]
        if len(chosen) != 1:
            raise ValueError("arm exactly one of error=, corrupt=True, "
                             f"delay_s=, hang_s= (got {chosen or 'none'})")
        if times == 0 or times < -1:
            raise ValueError("times must be positive or -1 (unbounded)")
        spec = _Spec(point, chosen[0], error=error, delay_s=delay_s or 0.0,
                     hang_s=hang_s or 0.0, after=after, times=times,
                     prob=prob, scope=scope)
        with self._lock:
            self._specs.append(spec)
        return self

    def inject_spec(self, text: str) -> "FaultPlane":
        """Arm from a ``point:mode[:k=v,...]`` string (CLI surface)."""
        point, kw = parse_spec(text)
        return self.inject(point, **kw)

    # ------------------------------------------------------------------ fire
    def hit(self, point: str, data: Optional[bytes] = None,
            scope: Optional[str] = None):
        """One hit on an injection point. Fires the first armed, matching
        spec (raise / delay / hang / corrupt-and-return); passes ``data``
        through untouched otherwise. Sites that move bytes pass them in
        and use the return value; control-flow sites ignore it. A site at
        a multi-instance seam passes its instance id as ``scope``;
        scoped specs only fire on a matching scope."""
        spec = None
        idx = 0
        with self._lock:
            self._hit_counts[point] = self._hit_counts.get(point, 0) + 1
            for s in self._specs:
                if s.point != point or s.remaining == 0:
                    continue
                if s.scope is not None and s.scope != scope:
                    continue
                if s.skip > 0:
                    s.skip -= 1
                    continue
                if s.prob < 1.0 and self._rng.random() >= s.prob:
                    continue
                if s.remaining > 0:
                    s.remaining -= 1
                s.fired += 1
                spec = s
                break
            if spec is not None:
                key = (point, spec.mode)
                self._injected[key] = self._injected.get(key, 0) + 1
                if spec.mode == "corrupt" and data:
                    idx = self._rng.randrange(len(data))
        if spec is None:
            return data
        if self._metrics is not None:
            self._metrics.counter(
                "chaos_faults_injected_total",
                {"point": point, "mode": spec.mode},
                help="faults fired by the installed chaos plane").inc()
        # a fired fault is forensic gold: stamp it into the flight recorder
        # ring and onto the Perfetto timeline (import deferred so the chaos
        # plane stays importable stand-alone)
        from ..obs import flight as _flight
        from ..obs import reqtrace as _rt
        if _flight.ACTIVE is not None:
            _flight.ACTIVE.record_event("fault", point, spec.mode)
        _rt.instant(f"fault:{point}", mode=spec.mode)
        if spec.mode == "error":
            exc = spec.error
            if isinstance(exc, type):
                exc = exc(f"chaos: injected fault at {point!r}")
            raise exc
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return data
        if spec.mode == "hang":
            # bounded, and released early by uninstall()/release(): a chaos
            # hang may stall a worker, never the whole test suite
            self._unhang.wait(spec.hang_s)
            return data
        if data is None:
            return None
        buf = bytearray(data)
        if buf:
            buf[idx] ^= 0xFF
        return bytes(buf)

    # ------------------------------------------------------------ inspection
    def hits(self, point: str) -> int:
        """Total hits observed at ``point`` (fired or not)."""
        with self._lock:
            return self._hit_counts.get(point, 0)

    def injected(self) -> Dict[Tuple[str, str], int]:
        """(point, mode) -> faults actually fired."""
        with self._lock:
            return dict(self._injected)

    def release(self) -> None:
        """Wake every site currently parked in a ``hang`` fault."""
        self._unhang.set()

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": dict(self._hit_counts),
                "injected": {f"{p}:{m}": n
                             for (p, m), n in sorted(self._injected.items())},
                "armed": [{"point": s.point, "mode": s.mode,
                           "remaining": s.remaining, "fired": s.fired,
                           "scope": s.scope}
                          for s in self._specs],
            }


# ---------------------------------------------------------------- lifecycle
def install(plane: FaultPlane) -> FaultPlane:
    """Make ``plane`` the process-global fault plane."""
    global ACTIVE
    ACTIVE = plane
    return plane


def uninstall() -> Optional[FaultPlane]:
    """Disable fault injection and release any hung sites."""
    global ACTIVE
    plane, ACTIVE = ACTIVE, None
    if plane is not None:
        plane.release()
    return plane


@contextmanager
def scenario(plane: FaultPlane):
    """``with scenario(plane): ...`` — install for the block, always
    uninstall (and un-hang) on the way out."""
    install(plane)
    try:
        yield plane
    finally:
        uninstall()
