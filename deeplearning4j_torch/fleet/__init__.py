"""Multi-model, multi-tenant fleet serving — counterpart of
``deeplearning4j_tpu/fleet/``: many models multiplexed over fixed device
memory.

Layering over :mod:`~..serve`:

- :mod:`~.tenants` — per-tenant token-bucket quotas + SLO deadline
  classes; typed :class:`QuotaError` sheds (HTTP 429)
- :mod:`~.pager`  — LRU paging of model weights host↔HBM under a byte
  budget, with the hot-swap lease-drain discipline on eviction and
  bounded-retry page-in transfers (typed :class:`PageInError` on
  exhaustion)
- :mod:`~.breaker` — per-model circuit breakers: consecutive server-side
  failures open the circuit and requests shed instantly with
  :class:`CircuitOpenError` (503 + ``Retry-After``) until a half-open
  probe succeeds
- :mod:`~.registry` — :class:`FleetRegistry` of named models, each its
  own ModelRegistry/ServeEngine/ContinuousBatcher when resident, with
  pinned host copies and page-ins on a copy stream; owns the fleet's
  :class:`~..serve.health.Health` state machine and (optional)
  :class:`~..serve.watchdog.Watchdog`
- :mod:`~.http` — the routed front door
  (``/v1/models/{name}/predict|generate``, ``X-Tenant``, ``/v1/fleet``)

Fault injection for all of the above lives in :mod:`~..chaos`.
"""

from .breaker import CircuitBreaker, CircuitOpenError
from .http import FleetServer
from .pager import PageInError, WeightPager
from .registry import FleetEntry, FleetRegistry, FleetResult, \
    UnknownModelError
from .tenants import (DEFAULT_SLO_CLASSES, QuotaError, SLOClass, TenantTable,
                      TokenBucket)

__all__ = ["CircuitBreaker", "CircuitOpenError", "DEFAULT_SLO_CLASSES",
           "FleetEntry", "FleetRegistry", "FleetResult", "FleetServer",
           "PageInError", "QuotaError", "SLOClass", "TenantTable",
           "TokenBucket", "UnknownModelError", "WeightPager"]
