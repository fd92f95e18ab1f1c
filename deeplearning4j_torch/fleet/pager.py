"""LRU weight paging: host ↔ HBM under a byte budget — counterpart of
``deeplearning4j_tpu/fleet/pager.py``, with the same guarantees, errors,
metrics and ``fleet.page_in_transfer`` seam.

A fleet holds N models whose summed weights exceed device memory; the
pager decides which subset is *resident*. It is deliberately dumb about
models — an entry is anything exposing ``name``, ``weight_bytes``,
``activate()`` (host copy -> device, engines up) and ``deactivate()``
(drain leases, pull weights to host, drop device refs) — which keeps the
eviction policy testable with stub entries and keeps every device copy in
:mod:`~.registry`.

Correctness properties the locking enforces:

- **Lease-drain eviction.** A victim's ``deactivate()`` runs the same
  drain discipline as hot-swap (``ServeEngine.shutdown(drain=True)``):
  every in-flight batch leased against the victim's registry retires
  *before* its device params are dropped. No batch ever loses its params
  mid-forward; eviction blocks on live leases by construction.
- **Single page-in per model.** Concurrent requests for a cold model
  dedupe on a loading set: one thread pages in, the rest wait on the
  condition variable.
- **Traffic to resident models never stalls on a page-in.** Victim
  selection happens under the pager lock (fast), but the expensive part —
  drain + device transfer — runs *outside* it (and the transfer itself
  runs on a copy stream of its own, :mod:`~.registry`). Residents are
  reserved by moving victims out of the resident map first, so their
  budget bytes are committed to the incoming model before anything slow
  happens.
- **Impossible requests are typed.** A single model larger than the whole
  budget sheds with :class:`~..serve.errors.CapacityError` — queueing
  can't help.

Budget accounting covers model *weights* only; KV pools and activations
are owned by each model's batcher/engine and sized at activation.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional

from ..chaos import faults as _faults
from ..chaos.retry import RetryPolicy
from ..obs import profile as _prof
from ..obs import reqtrace as _rt
from ..serve.errors import CapacityError, ServeError


class PageInError(ServeError):
    """Paging a model's weights onto the device failed even after bounded
    retries. The model is not resident; the reservation was rolled back, so
    a later request will retry the transfer from scratch (HTTP 503)."""

    cause = "page_in_failed"
    http_status = 503


class WeightPager:
    """LRU resident-set manager over duck-typed fleet entries."""

    def __init__(self, budget_bytes: Optional[int] = None, metrics=None,
                 retry: Optional[RetryPolicy] = None):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive (or None for "
                             "unbounded)")
        self.budget_bytes = int(budget_bytes) if budget_bytes else None
        self._metrics = metrics
        # host->HBM transfers are retried with backoff: a transient DMA /
        # allocator hiccup shouldn't shed the request when the next attempt
        # would land (injectable for tests; chaos smoke relies on this)
        self._retry = retry if retry is not None else RetryPolicy(
            attempts=3, base_s=0.05, cap_s=1.0, metrics=metrics)
        self._cond = threading.Condition()
        self._resident: "OrderedDict[str, object]" = OrderedDict()
        self._used = 0
        # bytes actually reserved per resident model — charged at page-in
        # and released at page-out, so a publish that resizes weights while
        # resident can never skew the budget arithmetic
        self._charged: dict = {}
        self._loading: set = set()
        self._page_ins = 0
        self._page_outs = 0
        if metrics is not None:
            metrics.gauge("fleet_hbm_budget_bytes",
                          help="weight-paging HBM budget (0 = unbounded)"
                          ).set(self.budget_bytes or 0)
            self._g_resident = metrics.gauge(
                "fleet_resident_bytes",
                help="bytes of model weights currently resident")
            self._g_models = metrics.gauge(
                "fleet_models_resident", help="models currently resident")
            self._h_page_in = metrics.histogram(
                "fleet_page_in_seconds",
                help="wall time to page one model in (drain victims + "
                     "device transfer + executable warm)")
        else:
            self._g_resident = self._g_models = self._h_page_in = None

    # ------------------------------------------------------------- accounting
    def _gauges(self) -> None:
        if self._g_resident is not None:
            self._g_resident.set(self._used)
            self._g_models.set(len(self._resident))

    def _count(self, name: str, model: str, help_: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(name, {"model": model}, help=help_).inc()

    # --------------------------------------------------------------- ensure
    def ensure(self, entry) -> None:
        """Make ``entry`` resident, evicting LRU entries as needed.

        Fast path (already resident): one lock, an LRU touch. Miss path:
        claim victims + bytes under the lock, then drain/deactivate the
        victims and activate the entry outside it.
        """
        need = int(entry.weight_bytes)
        if self.budget_bytes is not None and need > self.budget_bytes:
            raise CapacityError(
                f"model {entry.name!r} needs {need} bytes but the fleet "
                f"HBM budget is {self.budget_bytes} — it can never fit")
        victims: List[object] = []
        with self._cond:
            while True:
                if entry.name in self._resident:
                    self._resident.move_to_end(entry.name)  # LRU touch
                    return
                if entry.name in self._loading:
                    # another thread is paging this model in; wait for it
                    self._cond.wait()
                    continue
                if self.budget_bytes is not None:
                    while self._resident \
                            and self._used + need > self.budget_bytes:
                        name, v = self._resident.popitem(last=False)  # LRU
                        self._used -= self._charged.pop(name)
                        victims.append(v)
                    if self._used + need > self.budget_bytes:
                        # the remaining bytes are reservations held by other
                        # in-flight page-ins; put any victims back and wait
                        # for a load to land, then re-evaluate
                        for v in victims:
                            self._resident[v.name] = v
                            charge = int(v.weight_bytes)
                            self._charged[v.name] = charge
                            self._used += charge
                        victims.clear()
                        self._cond.wait(0.05)
                        continue
                self._loading.add(entry.name)
                self._charged[entry.name] = need
                self._used += need  # reserve before the slow work
                self._gauges()
                break
        ok = False
        try:
            t0 = time.perf_counter()
            with _rt.span("fleet.page_in", model=entry.name,
                          victims=len(victims)):
                for v in victims:
                    # lease-drain: completes every in-flight batch on the
                    # victim before its device params drop
                    v.deactivate()
                    self._page_outs += 1
                    self._count("fleet_page_out_total", v.name,
                                "model weight page-outs (HBM -> host)")
                def _transfer():
                    if _faults.ACTIVE is not None:
                        _faults.ACTIVE.hit("fleet.page_in_transfer")
                    entry.activate()

                try:
                    self._retry.call(_transfer, op="fleet.page_in_transfer",
                                     give_up=(CapacityError,))
                except CapacityError:
                    raise
                except Exception as e:
                    raise PageInError(
                        f"paging {entry.name!r} in failed after retries: "
                        f"{e}") from e
            ok = True
            self._page_ins += 1
            self._count("fleet_page_in_total", entry.name,
                        "model weight page-ins (host -> HBM)")
            dt = time.perf_counter() - t0
            if self._h_page_in is not None:
                self._h_page_in.observe(dt)
            if _prof.ACTIVE is not None:
                # measured transfer cost feeds CostProfile.page_in_s
                _prof.ACTIVE.page_in(dt)
        finally:
            with self._cond:
                self._loading.discard(entry.name)
                if ok:
                    self._resident[entry.name] = entry
                else:
                    # activation failed: release the reservation
                    self._used -= self._charged.pop(entry.name, need)
                self._gauges()
                self._cond.notify_all()

    def drop(self, entry) -> None:
        """Deactivate and forget one entry (fleet removal)."""
        with self._cond:
            while entry.name in self._loading:
                self._cond.wait()
            was = self._resident.pop(entry.name, None)
            if was is not None:
                self._used -= self._charged.pop(entry.name)
                self._gauges()
        if was is not None:
            was.deactivate()
            self._page_outs += 1
            self._count("fleet_page_out_total", entry.name,
                        "model weight page-outs (HBM -> host)")
        with self._cond:
            self._cond.notify_all()

    # ---------------------------------------------------------------- stats
    def resident(self) -> List[str]:
        """Resident model names, LRU-first."""
        with self._cond:
            return list(self._resident)

    def stats(self) -> dict:
        with self._cond:
            return {"budget_bytes": self.budget_bytes,
                    "resident_bytes": self._used,
                    "resident": list(self._resident),
                    "loading": sorted(self._loading),
                    "page_ins": self._page_ins,
                    "page_outs": self._page_outs}
