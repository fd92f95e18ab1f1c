"""Per-model circuit breaker: stop queueing doomed work — the port's copy
of ``deeplearning4j_tpu/fleet/breaker.py``.

When a model's serving path is failing deterministically — its page-in
transfers die, its engine 500s every batch — admitting more traffic just
burns queue slots, device time, and client timeouts on requests that
cannot succeed. The classic three-state breaker cuts that off:

- **closed** (normal): requests flow; *server-side* failures count.
- **open**: after ``failure_threshold`` consecutive failures, requests
  are refused instantly with a typed :class:`CircuitOpenError` (HTTP 503
  + ``Retry-After`` = time until the next probe). No page-in, no queue.
- **half-open**: after ``reset_s``, exactly ONE probe request is let
  through. Success closes the breaker; failure re-opens it for another
  ``reset_s``.

Only failures that indicate the *model's serving path* is broken count
(internal errors, worker stalls, exhausted page-in retries): client
errors, quota sheds, and queue-full backpressure do not — tripping a
breaker on overload would amplify the overload into an outage (that
discipline lives in :meth:`~.registry.FleetRegistry._breaker_counts`).

The clock is injectable, so open→half-open→closed is testable on a
simulated timeline (a satellite requirement of this PR). State is
exported as ``fleet_breaker_state{model}`` (0 closed / 1 half-open /
2 open) and transitions as ``fleet_breaker_transitions_total{model,to}``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..obs import flight as _flight
from ..serve.errors import ShedError

log = logging.getLogger(__name__)

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

_STATE_N = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(ShedError):
    """Request refused because the model's circuit breaker is open: recent
    requests failed consecutively and the serving path is presumed broken.
    ``retry_after_s`` says when the next half-open probe is due — retrying
    sooner is guaranteed to be refused again (HTTP 503)."""

    cause = "breaker_open"

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe."""

    def __init__(self, *, failure_threshold: int = 5, reset_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic, metrics=None,
                 model: Optional[str] = None, health=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_s <= 0:
            raise ValueError("reset_s must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.reset_s = float(reset_s)
        self._clock = clock
        self._metrics = metrics
        self.model = model
        self._health = health
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._gauge = None
        if metrics is not None:
            self._gauge = metrics.gauge(
                "fleet_breaker_state",
                {"model": model} if model is not None else None,
                help="circuit breaker state: 0=closed 1=half_open 2=open")
            self._gauge.set(0)

    # --------------------------------------------------------------- plumbing
    def _transition_locked(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        if self._gauge is not None:
            self._gauge.set(_STATE_N[to])
        if self._metrics is not None:
            labels = {"to": to}
            if self.model is not None:
                labels["model"] = self.model
            self._metrics.counter(
                "fleet_breaker_transitions_total", labels,
                help="circuit breaker state transitions").inc()
        if _flight.ACTIVE is not None:
            _flight.ACTIVE.record_event("breaker", to,
                                        model=self.model or "<model>",
                                        failures=self._failures)
        cause = f"breaker_open:{self.model or 'model'}"
        if self._health is not None:
            # open AND half-open keep readiness off: the model is not
            # healthy until a probe has actually succeeded
            if to == CLOSED:
                self._health.clear(cause)
            else:
                self._health.degrade(cause)
        log.log(logging.WARNING if to != CLOSED else logging.INFO,
                "breaker %s -> %s", self.model or "<model>", to)

    def state(self) -> str:
        with self._lock:
            return self._state

    # ---------------------------------------------------------------- surface
    def allow(self) -> None:
        """Gate one request. Raises :class:`CircuitOpenError` when open (or
        when half-open with the probe slot already taken); lets exactly one
        probe through per half-open window."""
        with self._lock:
            if self._state == OPEN:
                remaining = self._opened_at + self.reset_s - self._clock()
                if remaining > 0:
                    raise CircuitOpenError(
                        f"model {self.model or '<model>'!s} breaker is open "
                        f"({self._failures} consecutive failures); next "
                        f"probe in {remaining:.1f}s",
                        retry_after_s=remaining)
                self._transition_locked(HALF_OPEN)
                self._probing = False
            if self._state == HALF_OPEN:
                if self._probing:
                    raise CircuitOpenError(
                        f"model {self.model or '<model>'!s} breaker is "
                        f"half-open with a probe in flight",
                        retry_after_s=self.reset_s)
                self._probing = True  # this caller is the probe

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition_locked(CLOSED)

    def record_ignored(self) -> None:
        """A gated request finished with a client-side outcome (quota,
        bad request, client deadline): release the half-open probe slot
        without counting for or against the breaker."""
        with self._lock:
            self._probing = False

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                # failed probe: straight back to open, fresh window
                self._opened_at = self._clock()
                self._transition_locked(OPEN)
                opened = True
            else:
                self._failures += 1
                if self._state == CLOSED \
                        and self._failures >= self.failure_threshold:
                    self._opened_at = self._clock()
                    self._transition_locked(OPEN)
                    opened = True
        if opened and _flight.ACTIVE is not None:
            # the dump (file I/O) happens outside the gating lock
            _flight.ACTIVE.dump("breaker_open")

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "threshold": self.failure_threshold,
                    "reset_s": self.reset_s}
