"""Watchdog: missed-heartbeat detection + crash-only worker restart —
counterpart of ``deeplearning4j_tpu/serve/watchdog.py`` (the flight
recorder's dumps wait for ROADMAP.md, Queue 1, item 15).

The engine's dispatcher and the continuous batcher's decode loop are
single daemon threads; one wedged device call (or an uncaught exception)
would otherwise silently stop serving. The watchdog polls every watched component's heartbeat; a component whose
worker thread is dead, or whose heartbeat is older than ``deadline_s``,
is *stalled*: the watchdog counts ``serve_watchdog_stalls_total
{component}``, marks health ``degraded`` (readiness off, liveness
intact), and invokes the component's crash-only ``restart_worker()`` —
which stales the old thread by epoch, answers its orphaned in-flight work
with typed :class:`~.errors.WorkerStallError`, reclaims its registry
leases, and spawns a fresh worker against the unchanged lease state.
After ``max_restarts`` *consecutive* stalls of the same component the
watchdog stops thrashing and marks health ``failed`` — that pages a
human / tells the orchestrator to replace the process.

Watched components duck-type three methods::

    heartbeat() -> float        # monotonic timestamp of last liveness beat
    worker_alive() -> bool      # is the worker thread running at all
    restart_worker(reason) -> bool   # crash-only restart; False if closing

The component set is a *callable* returning ``(name, component)`` pairs,
re-evaluated every poll (the batcher is built lazily). Clock is injectable for tests. Off by default: servers
only start a watchdog when ``watchdog_s`` is passed.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

log = logging.getLogger(__name__)

_STALLS_HELP = "worker stalls detected (missed heartbeat or dead thread)"
_RESTARTS_HELP = "crash-only worker restarts performed by the watchdog"


class Watchdog:
    """Heartbeat monitor + crash-only restarter for worker threads."""

    def __init__(self, components: Callable[[], Iterable[Tuple[str, object]]],
                 *, deadline_s: float = 5.0, poll_s: Optional[float] = None,
                 metrics=None, health=None, max_restarts: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self._components = components
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(self.deadline_s / 4.0, 0.01)
        self._metrics = metrics
        self._health = health
        self._max_restarts = int(max_restarts)
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-watchdog")
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------------ monitoring
    def check_once(self) -> int:
        """One poll over all components; returns stalls detected. Public so
        tests (and a paused debugger) can drive the watchdog synchronously."""
        try:
            comps = list(self._components())
        except Exception:  # a racing shutdown must not kill the watchdog
            log.exception("watchdog: component enumeration failed")
            return 0
        now = self._clock()
        stalls = 0
        for name, comp in comps:
            try:
                alive = comp.worker_alive()
                beat = comp.heartbeat()
            except Exception:  # component mid-teardown
                continue
            stalled = (not alive) or (now - beat > self.deadline_s)
            if not stalled:
                self._mark_healthy(name)
                continue
            stalls += 1
            self._on_stall(name, comp, alive, now - beat)
        return stalls

    def _mark_healthy(self, name: str) -> None:
        with self._lock:
            recovering = self._consecutive.pop(name, 0)
        if recovering and self._health is not None:
            self._health.clear(f"watchdog:{name}")

    def _on_stall(self, name: str, comp, alive: bool, age_s: float) -> None:
        with self._lock:
            n = self._consecutive.get(name, 0) + 1
            self._consecutive[name] = n
        if self._metrics is not None:
            self._metrics.counter("serve_watchdog_stalls_total",
                                  {"component": name},
                                  help=_STALLS_HELP).inc()
        why = "worker thread dead" if not alive else \
            f"heartbeat {age_s:.2f}s > deadline {self.deadline_s:.2f}s"
        if n > self._max_restarts:
            # restarts are not converging: stop thrashing, page a human
            if self._health is not None:
                self._health.fail(f"watchdog:{name}")
            log.error("watchdog: %s stalled (%s) after %d restarts — "
                      "marking failed", name, why, n - 1)
            return
        if self._health is not None:
            self._health.degrade(f"watchdog:{name}")
        log.warning("watchdog: %s stalled (%s) — crash-only restart %d/%d",
                    name, why, n, self._max_restarts)
        try:
            restarted = bool(comp.restart_worker(reason=why))
        except Exception:  # restart failing must not kill the watchdog
            log.exception("watchdog: restart of %s raised", name)
            restarted = False
        if restarted and self._metrics is not None:
            self._metrics.counter("serve_watchdog_restarts_total",
                                  {"component": name},
                                  help=_RESTARTS_HELP).inc()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check_once()
