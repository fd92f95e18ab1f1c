"""Health state machine: ``ok`` / ``degraded`` / ``failed`` with causes —
counterpart of ``deeplearning4j_tpu/serve/health.py``.

A boolean ``/health`` cannot distinguish "serving normally" from "serving
but a breaker is open and a worker is mid-restart" from "dead" — and a
load balancer needs exactly that distinction to route around a replica
without killing it. :class:`Health` keeps a thread-safe set of *causes*,
each at severity ``degraded`` or ``failed``; the overall state is the
worst live cause. Components report with :meth:`degrade` / :meth:`fail`
and retract with :meth:`clear` when they recover — self-healing is the
normal path, so causes are designed to come and go.

Mapping at the HTTP front doors (serve/http.py, fleet/http.py):

- ``/health`` is *liveness*: 200 unless state is ``failed`` (only then
  should an orchestrator restart the process).
- ``/ready`` is *readiness*: 200 only when the server is accepting AND
  state is ``ok`` — breaker-open or watchdog restart-in-progress flips
  readiness off so the balancer drains new traffic while in-flight
  recovery proceeds.

Exported as ``serve_health_state`` (0 = ok, 1 = degraded, 2 = failed).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..obs import flight as _flight

OK = "ok"
DEGRADED = "degraded"
FAILED = "failed"

_LEVEL = {OK: 0, DEGRADED: 1, FAILED: 2}


class Health:
    """Thread-safe cause-tracking health state."""

    def __init__(self, metrics=None, component: Optional[str] = None):
        self._lock = threading.Lock()
        self._causes: Dict[str, str] = {}   # cause -> DEGRADED | FAILED
        self._gauge = None
        if metrics is not None:
            labels = {"component": component} if component else None
            self._gauge = metrics.gauge(
                "serve_health_state", labels,
                help="health state machine: 0=ok 1=degraded 2=failed")
            self._gauge.set(0)

    def _set(self, cause: str, level: str) -> None:
        with self._lock:
            prev = self._worst_locked()
            self._causes[cause] = level
            worst = self._worst_locked()
        if self._gauge is not None:
            self._gauge.set(_LEVEL[worst])
        self._record(prev, worst, cause)

    def _record(self, prev: str, worst: str, cause: str) -> None:
        """Every transition goes into the flight recorder; the recorder
        dumps itself the moment the process goes ``failed`` — the black box
        is written while the evidence is still in memory."""
        rec = _flight.ACTIVE
        if rec is None or worst == prev:
            return
        rec.record_event("health", worst, cause)
        if worst == FAILED:
            rec.dump("health_failed")

    def degrade(self, cause: str) -> None:
        """Report a recoverable problem (readiness off, liveness intact).
        A cause already at ``failed`` is not downgraded."""
        with self._lock:
            if self._causes.get(cause) == FAILED:
                return
        self._set(cause, DEGRADED)

    def fail(self, cause: str) -> None:
        """Report an unrecoverable problem: liveness flips to 503 and the
        orchestrator should replace the process."""
        self._set(cause, FAILED)

    def clear(self, cause: str) -> None:
        """Retract a cause (the component recovered)."""
        with self._lock:
            prev = self._worst_locked()
            self._causes.pop(cause, None)
            worst = self._worst_locked()
        if self._gauge is not None:
            self._gauge.set(_LEVEL[worst])
        self._record(prev, worst, cause)

    def _worst_locked(self) -> str:
        if not self._causes:
            return OK
        return max(self._causes.values(), key=_LEVEL.__getitem__)

    def state(self) -> str:
        with self._lock:
            return self._worst_locked()

    def ok(self) -> bool:
        return self.state() == OK

    def causes(self) -> List[str]:
        with self._lock:
            return sorted(self._causes)

    def snapshot(self) -> dict:
        """``{"status": "ok"|"degraded"|"failed", "causes": [...]}`` —
        the wire shape both front doors serve on ``/health``."""
        with self._lock:
            return {"status": self._worst_locked(),
                    "causes": sorted(self._causes)}
