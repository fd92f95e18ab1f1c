"""Inference serving of the port: the predict path and generation.

- :mod:`~.registry` — versioned params with atomic hot-swap and drain
- :mod:`~.engine` — deadline queue, admission control, shape-bucketed
  micro-batching on the card; the chunked-prefill scheduler
- :mod:`~.continuous` — continuous-batching generation over dense or
  paged KV caches (:mod:`~.paged`: block allocator, prefix cache)
- :mod:`~.http` — the HTTP front end (``/predict``, streamed
  ``/generate``, health, readiness, metrics)
- :mod:`~.health`, :mod:`~.watchdog` — health state machine and
  crash-only worker restarts
- :mod:`~.errors` — the typed failure surface
"""

from .continuous import ContinuousBatcher
from .engine import PrefillScheduler, ServeEngine
from .errors import (AotTraceError, CapacityError, DeadlineExceededError,
                     DrainTimeoutError, PublishError, ServeError,
                     ServerClosingError, ShedError, WorkerStallError)
from .health import Health
from .http import (ModelServer, jitter_retry_after, retry_after_s,
                   seed_retry_jitter)
from .paged import BlockAllocator, PrefixCache, SlotPages
from .registry import ModelRegistry, ModelSnapshot
from .watchdog import Watchdog

__all__ = ["AotTraceError", "BlockAllocator", "CapacityError",
           "ContinuousBatcher", "DeadlineExceededError", "DrainTimeoutError",
           "Health", "ModelRegistry", "ModelServer", "ModelSnapshot",
           "PrefillScheduler", "PrefixCache", "PublishError", "ServeEngine",
           "ServeError", "ServerClosingError", "ShedError", "SlotPages",
           "Watchdog", "WorkerStallError", "jitter_retry_after",
           "retry_after_s", "seed_retry_jitter"]
