"""Typed serving failures — counterpart of
``deeplearning4j_tpu/serve/errors.py``, with the same classes, ``cause``
tags and HTTP statuses.

Every way a request can fail without a result is a distinct exception type
carrying a stable machine-readable ``cause`` tag (the label on the
``serve_shed_total{cause=...}`` counter) and the HTTP status a front end
maps it to. Clients branch on type/cause, never on message text, and
overload never shows as a hang: admission control raises
:class:`ShedError` at once, expiry raises :class:`DeadlineExceededError`
at dispatch time.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for typed serving failures."""

    cause: str = "internal"
    http_status: int = 500

    def __init__(self, message: str, cause: str = None):
        super().__init__(message)
        if cause is not None:
            self.cause = cause


class ShedError(ServeError):
    """Request refused at admission — bounded queue full (load shedding).

    Overload is answered instantly and cheaply: the client should back off
    and retry (HTTP 503).
    """

    cause = "queue_full"
    http_status = 503


class ServerClosingError(ShedError):
    """Request refused because the server is draining for shutdown."""

    cause = "shutting_down"


class WorkerStallError(ServeError):
    """In-flight work shed because the worker thread that owned it died or
    stalled past its heartbeat deadline. The watchdog (or the dying worker
    itself) answers every orphaned request with this instead of leaving
    its caller to hang; a crash-only restart takes over, so the request is
    safely retryable (HTTP 503)."""

    cause = "worker_stall"
    http_status = 503


class DrainTimeoutError(ServeError):
    """``shutdown(drain=True)`` hit its timeout with work still in flight
    (e.g. a wedged device call). The work is abandoned and answered with
    this typed error rather than hanging the shutdown — retry against
    another replica (HTTP 503)."""

    cause = "drain_timeout"
    http_status = 503


class DeadlineExceededError(ServeError):
    """The request's deadline passed before device work could start."""

    cause = "deadline"
    http_status = 504


class CapacityError(ServeError):
    """The request can never fit — e.g. prompt + max_new_tokens exceeds the
    generation KV-cache capacity, or a sequence is longer than the largest
    length bucket. Retrying will not help (HTTP 400)."""

    cause = "over_capacity"
    http_status = 400


class AotTraceError(ServeError):
    """Strict prebuilt-executable serving hit a signature its store does
    not cover. A strict replica is deployed on the contract that every
    serving graph was prebuilt (``python -m deeplearning4j_torch.aot
    prebuild``); capturing at request time would mean the deployed store
    diverged from the serving config, so the miss is answered as a typed
    503, counted on ``serve_aot_strict_misses_total``, and at boot time it
    fails readiness outright. Never a silent capture (HTTP 503)."""

    cause = "aot_trace"
    http_status = 503


class PublishError(ServeError):
    """A model publish aborted BEFORE the generation flip — e.g.
    precompiling/warming the candidate against the live bucket signatures
    failed. The previous generation keeps serving; registry history, lease
    accounting and the generation counter are untouched, so the caller can
    fix the candidate and re-publish."""

    cause = "publish_failed"
    http_status = 500
