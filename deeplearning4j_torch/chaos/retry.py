"""Bounded retry with exponential backoff and full jitter — the port's
copy of ``deeplearning4j_tpu/chaos/retry.py``.

The I/O edge the serving stack cannot afford to treat as infallible —
weight page-in transfers — gets a shared, injectable
retry discipline instead of ad-hoc loops: capped exponential backoff with
*full* jitter (uniform over ``[0, min(cap, base * 2**attempt)]``, the
AWS-architecture result that decorrelates thundering retries better than
equal jitter), a bounded attempt budget, and a ``give_up`` list for errors
where retrying is wrong (a corrupt store entry stays corrupt).

Every outcome is counted as ``fleet_retry_total{op,outcome}`` with
``outcome`` ∈ ``retry`` (one failed attempt, will back off),
``recovered`` (succeeded after ≥1 retry), ``exhausted`` (attempt budget
spent, error re-raised) — so a dashboard can tell transient flakiness
from a dying device. Clock and RNG are injectable for deterministic
tests. Stdlib only.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

_HELP = "bounded-retry outcomes by operation (retry/recovered/exhausted)"


class RetryPolicy:
    """Bounded retry: ``attempts`` total tries, full-jitter backoff.

    ``rng`` and ``sleep`` are injectable so tests can pin the jitter and
    run in zero wall-clock time. A policy is stateless across ``call``s
    and safe to share between threads (``random.Random`` is internally
    locked; the default module RNG is never used).
    """

    def __init__(self, attempts: int = 3, base_s: float = 0.05,
                 cap_s: float = 2.0, *, rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 metrics=None):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = int(attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self._metrics = metrics

    def backoff_s(self, retry_index: int) -> float:
        """Full-jitter delay before retry ``retry_index`` (0-based):
        uniform over ``[0, min(cap_s, base_s * 2**retry_index)]``."""
        ceiling = min(self.cap_s, self.base_s * (2.0 ** retry_index))
        return self._rng.uniform(0.0, ceiling)

    def _count(self, metrics, op: str, outcome: str) -> None:
        m = metrics if metrics is not None else self._metrics
        if m is not None:
            m.counter("fleet_retry_total", {"op": op, "outcome": outcome},
                      help=_HELP).inc()

    def call(self, fn: Callable[[], object], *, op: str,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             give_up: Tuple[Type[BaseException], ...] = (),
             metrics=None):
        """Run ``fn`` with up to ``attempts`` tries.

        Errors in ``give_up`` propagate immediately (they win over
        ``retry_on``); errors in ``retry_on`` are retried after a
        full-jitter backoff until the attempt budget is spent, then
        re-raised. Anything else propagates on the first occurrence.
        """
        retries = 0
        while True:
            try:
                out = fn()
            except give_up:
                raise
            except retry_on:
                if retries + 1 >= self.attempts:
                    self._count(metrics, op, "exhausted")
                    raise
                self._count(metrics, op, "retry")
                self._sleep(self.backoff_s(retries))
                retries += 1
                continue
            if retries:
                self._count(metrics, op, "recovered")
            return out
