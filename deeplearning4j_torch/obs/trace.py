"""Span tracer — the port's copy of ``deeplearning4j_tpu/obs/trace.py``:
nested wall-clock spans exportable as Chrome-trace JSON (loadable in
Perfetto / chrome://tracing).

Stdlib only. Spans use the monotonic ``time.perf_counter_ns`` clock (never
``time.time`` — NTP steps would produce negative durations) and per-thread
span stacks, so concurrent threads (AsyncIterator prefetch, server handler
pools) each get a correctly nested track keyed by ``tid``.

The trace format is the Chrome trace-event JSON flavor Perfetto ingests
natively: complete events (``ph: "X"``) with microsecond ``ts``/``dur``,
instant events (``ph: "i"``), and thread-name metadata (``ph: "M"``). See
``obs/README.md`` for how to open the output.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager for a disabled tracer (stateless, so one
    instance is safely reentrant across threads)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; created by :meth:`Tracer.span`, records on ``__exit__``."""

    __slots__ = ("tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0
        self._depth = 0

    def __enter__(self):
        tr = self.tracer
        self._t0 = time.perf_counter_ns()
        stack = tr._stack()
        self._depth = len(stack)
        if stack:
            self.args = dict(self.args, parent=stack[-1])
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self.tracer
        stack = tr._stack()
        # Unwind to the depth recorded at __enter__: an exception thrown
        # between our __enter__ and a nested span's __exit__ leaves orphan
        # entries above us, so "pop only if stack[-1] == self.name" would
        # skip the pop and corrupt parent attribution for every later span
        # on this thread.
        if len(stack) > self._depth:
            del stack[self._depth:]
        tr._add({"name": self.name, "ph": "X", "cat": "obs",
                 "ts": (self._t0 - tr._epoch_ns) / 1e3,
                 "dur": (end - self._t0) / 1e3,
                 "pid": tr._pid, "tid": threading.get_ident(),
                 **({"args": self.args} if self.args else {})})
        return False


class Tracer:
    """Collects spans; exports ``{"traceEvents": [...]}`` Chrome-trace JSON.

    ``enabled=False`` makes :meth:`span`/:meth:`instant` strict no-ops (one
    shared null context manager, no allocation). ``max_events`` bounds host
    memory for long runs — past it, events are counted as dropped instead of
    appended, and the drop count rides along in the export's ``otherData``.
    """

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.dropped = 0
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._named_tids: set = set()

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _add(self, event: dict) -> None:
        tid = event.get("tid")
        with self._lock:
            # Name the track only when the event comes from its own thread:
            # async events may carry a foreign tid (a stage closed on behalf
            # of the thread that ran it) and must not steal its label.
            if (tid is not None and tid not in self._named_tids
                    and tid == threading.get_ident()):
                self._named_tids.add(tid)
                self._events.append(
                    {"name": "thread_name", "ph": "M", "pid": self._pid,
                     "tid": tid,
                     "args": {"name": threading.current_thread().name}})
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # --- public API ---
    def span(self, name: str, **args):
        """Context manager timing a nested span: ``with tracer.span("x"):``"""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (compile events, epoch boundaries)."""
        if not self.enabled:
            return
        self._add({"name": name, "ph": "i", "s": "t", "cat": "obs",
                   "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
                   "pid": self._pid, "tid": threading.get_ident(),
                   **({"args": args} if args else {})})

    def async_event(self, name: str, id_: str, t0_ns: int, end_ns: int,
                    tid: Optional[int] = None, cat: str = "request",
                    **args) -> None:
        """Async begin/end pair (``ph: "b"/"e"``) keyed by ``id``.

        Perfetto stitches every async event sharing ``(cat, id)`` into one
        track regardless of which thread emitted it — this is how a request
        whose stages run on the HTTP handler, the batcher worker, and the
        watchdog becomes a single flow. Timestamps are explicit (the same
        ``perf_counter_ns`` clock as spans) so a stage can be recorded after
        the fact; ``tid`` may name the thread that actually *ran* the stage
        when the recording thread differs.
        """
        if not self.enabled:
            return
        tid = threading.get_ident() if tid is None else tid
        base = {"cat": cat, "id": id_, "pid": self._pid, "tid": tid}
        self._add({**base, "name": name, "ph": "b",
                   "ts": (t0_ns - self._epoch_ns) / 1e3,
                   **({"args": args} if args else {})})
        self._add({**base, "name": name, "ph": "e",
                   "ts": (end_ns - self._epoch_ns) / 1e3})

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable as-is)."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.to_chrome())
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._named_tids.clear()
            self.dropped = 0
