"""Per-tenant admission: token-bucket quotas and SLO deadline classes —
the port's copy of ``deeplearning4j_tpu/fleet/tenants.py``.

The fleet front door multiplexes many tenants over one process, so
admission has to answer two questions *before* any device work is
scheduled: "is this tenant within its rate?" (token bucket) and "how long
is this request allowed to take?" (SLO class). Both answers are cheap —
a float refill and a dict lookup — because an over-quota tenant must be
shed in microseconds, not after a page-in.

- :class:`TokenBucket` — the classic leaky-bucket dual: capacity ``burst``
  tokens, refilled at ``rate_per_s``. ``take`` either debits and admits or
  refuses without blocking. The clock is injectable (``now=``) so the
  no-tenant-exceeds-its-rate property is testable with a simulated clock.
- :class:`SLOClass` — a named deadline tier. The deadline feeds straight
  into the existing engine/batcher deadline machinery
  (``timeout_ms`` -> EDF prefill ordering, dispatch-time expiry), so
  "gold traffic preempts batch traffic" is the *same* mechanism that
  already orders chunked prefills — tenants just pick the tier.
- :class:`TenantTable` — registration + admission. Unknown tenants get a
  default policy (so the front door never 500s on a new ``X-Tenant``),
  and every refusal is a typed :class:`QuotaError` counted on
  ``serve_shed_total{cause="quota",tenant=...}``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence

from ..serve.errors import ShedError


class QuotaError(ShedError):
    """Tenant exceeded its token-bucket rate.

    A quota shed is the tenant's fault, not the server's — HTTP 429, not
    503 — and it carries ``retry_after_s``, the bucket's own estimate of
    when the next token lands, which the front door surfaces as a
    ``Retry-After`` header."""

    cause = "quota"
    http_status = 429

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class SLOClass(NamedTuple):
    """One deadline tier. ``deadline_ms=None`` means no deadline (bulk
    work that should never expire, only yield to deadline-carrying
    traffic under the EDF prefill scheduler)."""

    name: str
    deadline_ms: Optional[float]


DEFAULT_SLO_CLASSES = (
    SLOClass("gold", 1000.0),
    SLOClass("standard", 5000.0),
    SLOClass("batch", None),
)


class TokenBucket:
    """Thread-safe token bucket.

    ``burst`` tokens max, refilled continuously at ``rate_per_s``. The
    timestamp of the first ``take`` anchors the clock, so buckets created
    long before traffic don't start with a phantom backlog of refills
    beyond the burst cap (the cap bounds that anyway; this just keeps the
    math exact for injected clocks that start at 0).
    """

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("rate_per_s and burst must be > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t: Optional[float] = None
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if self._t is None:
            self._t = now
        elapsed = max(now - self._t, 0.0)
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._t = now

    def take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        """Debit ``n`` tokens if available; never blocks."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._refill(now)
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def wait_s(self, n: float = 1.0, now: Optional[float] = None) -> float:
        """Seconds until ``n`` tokens will be available (0 if they already
        are) — the honest Retry-After for a quota shed."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._refill(now)
            deficit = n - self._tokens
            return max(deficit, 0.0) / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class TenantPolicy(NamedTuple):
    rate_per_s: float
    burst: float
    slo: SLOClass


class TenantTable:
    """Tenant registration + per-request admission for the fleet.

    ``admit`` is the single choke point: it debits the tenant's bucket,
    counts the request, and returns the tenant's :class:`SLOClass` (whose
    deadline the caller forwards as ``timeout_ms``). Refusal raises
    :class:`QuotaError` and bumps
    ``serve_shed_total{cause="quota",tenant=...}`` (plus ``model=`` when
    the caller names one), so one scrape shows exactly who is being
    throttled and on what.
    """

    def __init__(self, metrics=None, *,
                 slo_classes: Sequence[SLOClass] = DEFAULT_SLO_CLASSES,
                 default_rate_per_s: float = 100.0,
                 default_burst: float = 50.0,
                 default_slo: str = "standard"):
        self._classes: Dict[str, SLOClass] = {c.name: c for c in slo_classes}
        if default_slo not in self._classes:
            raise ValueError(f"default_slo {default_slo!r} is not one of "
                             f"{sorted(self._classes)}")
        self._default = TenantPolicy(float(default_rate_per_s),
                                     float(default_burst),
                                     self._classes[default_slo])
        self._metrics = metrics
        self._lock = threading.Lock()
        self._policies: Dict[str, TenantPolicy] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._admitted: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}

    def slo_class(self, name: str) -> SLOClass:
        return self._classes[name]

    def register(self, tenant: str, *, rate_per_s: float,
                 burst: Optional[float] = None,
                 slo: str = "standard") -> None:
        """(Re-)register a tenant's policy. ``burst`` defaults to one
        second's worth of rate (min 1 token)."""
        if slo not in self._classes:
            raise ValueError(f"unknown SLO class {slo!r}; have "
                             f"{sorted(self._classes)}")
        if burst is None:
            burst = max(rate_per_s, 1.0)
        with self._lock:
            self._policies[tenant] = TenantPolicy(
                float(rate_per_s), float(burst), self._classes[slo])
            self._buckets[tenant] = TokenBucket(rate_per_s, burst)

    def _bucket_for(self, tenant: str) -> tuple:
        with self._lock:
            pol = self._policies.get(tenant, self._default)
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    pol.rate_per_s, pol.burst)
            return pol, bucket

    def admit(self, tenant: str, model: Optional[str] = None,
              cost: float = 1.0, now: Optional[float] = None) -> SLOClass:
        """Debit ``cost`` tokens for one request; return the tenant's SLO
        class, or raise :class:`QuotaError` with the bucket's refill time
        as ``retry_after_s``."""
        pol, bucket = self._bucket_for(tenant)
        if not bucket.take(cost, now=now):
            with self._lock:
                self._shed[tenant] = self._shed.get(tenant, 0) + 1
            if self._metrics is not None:
                labels = {"cause": "quota", "tenant": tenant}
                if model is not None:
                    labels["model"] = model
                self._metrics.counter(
                    "serve_shed_total", labels,
                    help="requests refused at admission, by cause").inc()
            raise QuotaError(
                f"tenant {tenant!r} over quota "
                f"({pol.rate_per_s:g} req/s, burst {pol.burst:g})",
                retry_after_s=bucket.wait_s(cost, now=now))
        with self._lock:
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
        if self._metrics is not None:
            self._metrics.counter(
                "fleet_tenant_requests_total", {"tenant": tenant},
                help="requests admitted past tenant quota, by tenant").inc()
        return pol.slo

    def stats(self) -> dict:
        """Per-tenant policy + admission counters (the /v1/fleet view)."""
        with self._lock:
            tenants = set(self._policies) | set(self._buckets) \
                | set(self._admitted) | set(self._shed)
            out = {}
            for t in sorted(tenants):
                pol = self._policies.get(t, self._default)
                out[t] = {"rate_per_s": pol.rate_per_s, "burst": pol.burst,
                          "slo": pol.slo.name,
                          "deadline_ms": pol.slo.deadline_ms,
                          "admitted": self._admitted.get(t, 0),
                          "shed": self._shed.get(t, 0)}
            return out
