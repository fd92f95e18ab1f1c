"""Request-scoped tracing — the port's copy of
``deeplearning4j_tpu/obs/reqtrace.py``: one causal track per request
across threads.

A request's life crosses the HTTP handler thread, the engine/batcher worker,
dozens of decode ticks, and (on a bad day) the watchdog. Thread-local span
stacks (``obs/trace.py``) cannot express that, so this module adds a
:class:`RequestContext` that *rides on the queued work item*: each stage —
admit, queue wait, page-in wait, every prefill chunk, decode residency,
stream flush — is recorded from whichever thread ran it, emitted as a
Perfetto async event keyed by the request's ``trace_id`` (all events sharing
the id stitch into one track), and accumulated into a compact
``RequestRecord`` dict that lands in the flight recorder ring on finish.

Propagation is W3C Trace Context: ``traceparent`` is parsed on ingress and
emitted on responses (plus an ``X-Request-Id`` echo), so an upstream
router's trace id flows through and a p99 exemplar in ``/metrics`` links
straight back to the caller's trace.

Like ``chaos/`` and ``obs/flight.py``, activation is a process-global
:data:`ACTIVE` with ``install``/``uninstall``. Disabled means *strict
zero-allocation no-ops* on the hot paths: work items carry ``ctx=None`` and
every site guards ``if ... is not None`` — one attribute load per decode
tick, no objects, no calls (spy-asserted in tests).

Stdlib only.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import flight as _flight
from .trace import Tracer, _NULL_SPAN

ACTIVE: Optional["RequestTracer"] = None

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header, or
    ``None`` if absent/malformed (malformed propagation must never fail a
    request — we just start a fresh trace)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m or m.group(1) == "ff":
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class RequestContext:
    """Per-request trace state; created only when tracing is installed.

    Stage methods are called from whichever thread runs the stage; list
    appends are GIL-atomic and :meth:`finish` snapshots under a lock, so no
    per-stage locking is needed. ``decode_tick`` is the decode-loop fast
    path: integer math on slots only, no allocation.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "request_id", "kind", "model",
        "tenant", "slo_class", "t0_ns", "t0_unix", "meta", "stages",
        "error", "ticks", "_ingress_tid", "_decode_t0", "_decode_last",
        "_decode_ns", "_decode_tid", "_stages_dropped", "_rt", "_lock",
        "_done")

    def __init__(self, rt: "RequestTracer", kind: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], request_id: str,
                 model: Optional[str], tenant: Optional[str],
                 slo_class: Optional[str]):
        self._rt = rt
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.request_id = request_id
        self.model = model
        self.tenant = tenant
        self.slo_class = slo_class
        self.t0_ns = time.perf_counter_ns()
        self.t0_unix = time.time()
        self.meta: Dict[str, object] = {}
        self.stages: List[dict] = []
        self.error: Optional[str] = None
        self.ticks = 0
        self._ingress_tid = threading.get_ident()
        self._decode_t0 = 0
        self._decode_last = 0
        self._decode_ns = 0
        self._decode_tid = 0
        self._stages_dropped = 0
        self._lock = threading.Lock()
        self._done = False

    # --- propagation ---
    def traceparent(self) -> str:
        """Outgoing ``traceparent`` (our span id becomes the parent)."""
        return format_traceparent(self.trace_id, self.span_id)

    def annotate(self, **kv) -> None:
        self.meta.update(kv)

    # --- stages ---
    def add_stage(self, name: str, t0_ns: int, end_ns: int,
                  tid: Optional[int] = None, **args) -> None:
        """Record one completed stage; emits the matching async trace event.

        ``tid`` names the thread that ran the stage when the recording
        thread differs (e.g. the watchdog closing the decode stage on
        behalf of a hung worker).
        """
        if len(self.stages) >= self._rt.max_stages:
            self._stages_dropped += 1
            return
        if tid is None:
            tid = threading.get_ident()
        st = {"name": name, "t_ms": (t0_ns - self.t0_ns) / 1e6,
              "dur_ms": (end_ns - t0_ns) / 1e6, "tid": tid}
        if args:
            st["args"] = args
        self.stages.append(st)
        tr = self._rt.tracer
        if tr is not None:
            tr.async_event(name, self.trace_id, t0_ns, end_ns, tid=tid,
                           **args)

    def stage(self, name: str, **args):
        """``with ctx.stage("flush"): ...`` — times a stage on this thread."""
        return _StageTimer(self, name, args)

    # --- decode fast path ---
    def decode_begin(self) -> None:
        """First decode-side work (token-0 sample at prefill finish)."""
        if self._decode_t0 == 0:
            self._decode_t0 = time.perf_counter_ns()
            self._decode_tid = threading.get_ident()

    def decode_tick(self, t0_ns: int, end_ns: int) -> None:
        """One decode tick this request was resident for; integer math only."""
        if self._decode_t0 == 0:
            self._decode_t0 = t0_ns
            self._decode_tid = threading.get_ident()
        self._decode_last = end_ns
        self._decode_ns += end_ns - t0_ns
        self.ticks += 1

    # --- completion ---
    def finish_work(self, error: Optional[str] = None, **annots) -> None:
        """Called by the component that completed or shed the request (the
        decode loop, the engine worker, or the watchdog on their behalf):
        closes the decode stage and, on error, records the shed from the
        calling thread so it shows up in the stitched flow."""
        if annots:
            self.meta.update(annots)
        if self._decode_t0:
            end = self._decode_last or time.perf_counter_ns()
            self.add_stage("decode", self._decode_t0, end,
                           tid=self._decode_tid, ticks=self.ticks)
            self._decode_t0 = 0
        if error is not None:
            self.error = error
            now = time.perf_counter_ns()
            self.add_stage("shed", now, now, cause=error)

    def finish(self, error: Optional[str] = None) -> Optional[dict]:
        """Final seal (idempotent): builds the ``RequestRecord``, pushes it
        to the flight recorder, and emits the umbrella async event."""
        with self._lock:
            if self._done:
                return None
            self._done = True
        if error is not None:
            self.error = error
        if self._decode_t0:  # component never closed decode (direct API use)
            self.finish_work()
        end_ns = time.perf_counter_ns()
        record = {
            "request_id": self.request_id, "trace_id": self.trace_id,
            "kind": self.kind, "model": self.model, "tenant": self.tenant,
            "slo_class": self.slo_class,
            "status": "ok" if self.error is None else "error",
            "error": self.error, "t_unix": self.t0_unix,
            "duration_ms": (end_ns - self.t0_ns) / 1e6,
            "ticks": self.ticks, "decode_ms": self._decode_ns / 1e6,
            "stages": list(self.stages),
        }
        if self.meta:
            record["meta"] = dict(self.meta)
        if self._stages_dropped:
            record["stages_dropped"] = self._stages_dropped
        tr = self._rt.tracer
        if tr is not None:
            tr.async_event("request", self.trace_id, self.t0_ns, end_ns,
                           tid=self._ingress_tid, kind=self.kind,
                           model=self.model or "",
                           status=record["status"],
                           request_id=self.request_id)
        fl = self._rt.flight
        if fl is not None:
            fl.record_request(record)
        return record


class _StageTimer:
    __slots__ = ("ctx", "name", "args", "_t0")

    def __init__(self, ctx: RequestContext, name: str, args: dict):
        self.ctx = ctx
        self.name = name
        self.args = args
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ctx.add_stage(self.name, self._t0, time.perf_counter_ns(),
                           **self.args)
        return False


class RequestTracer:
    """Factory/sink bundle for request tracing.

    ``tracer`` (an ``obs.Tracer``) receives the Perfetto events, ``flight``
    (an ``obs.flight.FlightRecorder``) the finished ``RequestRecord``s;
    either may be ``None``. ``max_stages`` bounds per-request memory for
    pathological streams (overflow is counted, not appended).
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 flight: Optional["_flight.FlightRecorder"] = None,
                 max_stages: int = 256):
        self.tracer = tracer
        self.flight = flight if flight is not None else _flight.ACTIVE
        self.max_stages = max_stages

    def begin(self, kind: str, traceparent: Optional[str] = None,
              request_id: Optional[str] = None, model: Optional[str] = None,
              tenant: Optional[str] = None,
              slo_class: Optional[str] = None) -> RequestContext:
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id = parsed
        else:
            trace_id, parent_id = _new_id(16), None
        span_id = _new_id(8)
        return RequestContext(
            self, kind, trace_id, span_id, parent_id,
            request_id or f"req-{span_id}", model, tenant, slo_class)


def install(rt: RequestTracer) -> RequestTracer:
    """Make ``rt`` the process-global request tracer."""
    global ACTIVE
    ACTIVE = rt
    return rt


def uninstall() -> Optional[RequestTracer]:
    global ACTIVE
    rt, ACTIVE = ACTIVE, None
    return rt


# --- ambient helpers for code with no request in hand (page-in
# transfers): thread-local spans / instants on the installed tracer, no-ops
# when tracing is off ---

def span(name: str, **args):
    rt = ACTIVE
    if rt is None or rt.tracer is None:
        return _NULL_SPAN
    return rt.tracer.span(name, **args)


def instant(name: str, **args) -> None:
    rt = ACTIVE
    if rt is not None and rt.tracer is not None:
        rt.tracer.instant(name, **args)
