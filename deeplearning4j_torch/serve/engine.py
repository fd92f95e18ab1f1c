"""Serving engine — counterpart of ``ServeEngine`` in
``deeplearning4j_tpu/serve/engine.py``: a deadline-aware queue, admission
control and shape-bucketed micro-batching.

Requests coalesce into the smallest *batch* bucket that fits, and
(optionally) their time axis is padded to a *length* bucket, so arbitrary
traffic runs a bounded set of shapes: at most ``|batch_buckets| x
|length_buckets|``. Past ``queue_limit`` rows the engine sheds at once with
a typed :class:`~.errors.ShedError`; an expired deadline is answered with
:class:`~.errors.DeadlineExceededError` at dispatch, before any device
work; one registry lease per device batch means a hot-swap never splits a
batch across params generations; every path pads, the shutdown drain
included. Same constructor knobs, metric names and errors as the
reference.

The default forward runs ``model.forward`` on the model's device under
``torch.inference_mode()``, entered inside the dispatcher thread (the mode
is thread-local). ``queue_depth`` (the Retry-After input) and the
watchdog's ``heartbeat`` / ``worker_alive`` are the reference's. Not
ported yet: the prebuilt-executable store (``aot_store``, ``strict_aot``,
``from_tuned``, ``warm``; ROADMAP.md, Queue 1, item 13) and the fault
injection, profiler and request-trace hooks (item 15).

:class:`PrefillScheduler` (the continuous batcher's chunked-prefill
policy) lives here, as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..obs.metrics import MetricsRegistry
from .errors import (CapacityError, DeadlineExceededError, DrainTimeoutError,
                     ServeError, ServerClosingError, ShedError,
                     WorkerStallError)
from .registry import ModelRegistry

# batch-occupancy is a ratio in (0, 1]; latency-style buckets would waste
# the whole axis
_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def _to_numpy(y) -> np.ndarray:
    """A forward's result on the host (a bf16 tensor widens to f32)."""
    if isinstance(y, torch.Tensor):
        y = y.detach()
        if y.dtype == torch.bfloat16:
            y = y.float()
        return y.cpu().numpy()
    return np.asarray(y)


class _Request:
    """One admitted unit of work: ``rows`` examples sharing a shape key."""

    __slots__ = ("x", "rows", "true_len", "padded_len", "shape_key", "enq_t",
                 "deadline", "event", "result", "error", "generation",
                 "batch_seq")

    def __init__(self, x: np.ndarray, true_len: Optional[int],
                 padded_len: Optional[int], deadline: Optional[float]):
        self.x = x
        self.rows = x.shape[0]
        self.true_len = true_len        # pre-padding time length (or None)
        self.padded_len = padded_len    # length bucket applied (or None)
        self.shape_key = (x.shape[1:], str(x.dtype))
        self.enq_t = time.perf_counter()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[ServeError] = None
        self.generation: Optional[int] = None   # set by the batch that ran it
        self.batch_seq: Optional[int] = None

    def wait(self) -> np.ndarray:
        """Block for the outcome; raises the typed error on failure."""
        if self.deadline is not None:
            # the dispatcher resolves expiry itself; the extra slack only
            # guards against a wedged dispatcher turning into a silent hang
            if not self.event.wait(max(self.deadline - time.perf_counter(), 0)
                                   + 5.0):
                raise DeadlineExceededError("request timed out in queue")
        else:
            self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


class PrefillScheduler:
    """Decides how prompt-prefill chunks interleave with decode ticks in the
    continuous batcher (chunked prefill, ``serve/continuous.py``).

    Each engine tick runs at most ``decode_chunks`` prefill chunks while
    decodes are active (in-flight tokens keep flowing), and up to
    ``idle_chunks`` when no decode is running. Among runnable jobs,
    earliest-deadline-first, then FIFO. A job that adopted a cached prefix
    enters with only its suffix chunks, so it takes a smaller slice of the
    budget with no special casing here.
    """

    def __init__(self, decode_chunks: int = 1, idle_chunks: int = 4):
        if decode_chunks < 1 or idle_chunks < 1:
            raise ValueError("chunk budgets must be >= 1")
        self.decode_chunks = int(decode_chunks)
        self.idle_chunks = int(idle_chunks)

    def plan(self, jobs: Sequence[Any], decoding: bool) -> List[Any]:
        """Pick and order the prefill jobs to advance one chunk this tick.
        ``jobs`` expose ``.deadline`` (optional) and ``.enq_t``."""
        if not jobs:
            return []
        budget = self.decode_chunks if decoding else self.idle_chunks
        order = sorted(jobs, key=lambda j: (
            j.deadline if j.deadline is not None else float("inf"), j.enq_t))
        return order[:budget]


class ServeEngine:
    """Micro-batching inference engine over a :class:`ModelRegistry`.

    ``batch_buckets``: padded batch sizes; coalesced work pads to the
    smallest bucket that fits. ``length_buckets`` (optional) pads the
    example time axis to a fixed set of lengths — sound for causal and
    token-local stacks, where right-padding cannot change earlier
    positions; results are sliced back to the true length when the output
    keeps a time axis.

    ``forward``: override the device function ``(params, state, x) -> y``
    (``x`` a numpy batch; ``y`` a tensor or array). By default
    ``model.forward`` runs on the model's device.
    """

    def __init__(self, model, registry: Optional[ModelRegistry] = None,
                 params=None, state=None, *,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 length_buckets: Optional[Sequence[int]] = None,
                 queue_limit: int = 256, max_wait_ms: float = 2.0,
                 default_timeout_ms: Optional[float] = None,
                 admission: str = "shed", metrics=None, forward=None,
                 model_name: Optional[str] = None):
        if admission not in ("shed", "block"):
            raise ValueError(f"admission must be 'shed' or 'block', "
                             f"got {admission!r}")
        self.model = model
        self.model_name = model_name
        if registry is None:
            registry = ModelRegistry(
                params if params is not None else model.params,
                state if state is not None else model.state, metrics=metrics,
                model=model_name)
        self.registry = registry
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError("batch_buckets must be positive ints")
        self.length_buckets = (tuple(sorted(set(int(b) for b in length_buckets)))
                               if length_buckets else None)
        self.queue_limit = int(queue_limit)
        self.max_wait_ms = float(max_wait_ms)
        self.default_timeout_ms = default_timeout_ms
        self.admission = admission
        self.metrics = metrics if metrics is not None else MetricsRegistry()

        if forward is None:
            dev = model.device

            def forward(params, state, x):
                with torch.inference_mode():
                    y = model.forward(params, state,
                                      torch.from_numpy(x).to(dev),
                                      training=False)[0]
                    return _to_numpy(y)

        self._fwd = forward

        self._cond = threading.Condition()
        self._pending: List[_Request] = []
        self._depth_rows = 0
        self._closing = False
        self._sigs = set()          # (bucket, shape_key) ever run
        self._batch_count = 0
        # crash-only worker lifecycle: the dispatcher runs under an epoch;
        # restart_worker() bumps it, sheds the abandoned in-flight batch with
        # typed errors, and spawns a fresh thread — a stale thread notices
        # its epoch and exits without touching shared state
        self._epoch = 0
        self._hb = time.monotonic()
        self._inflight: List[_Request] = []

        m = self.metrics
        self._m_depth = m.gauge("serve_queue_depth", self._lbl(),
                                help="rows waiting for a device batch")
        self._m_queue_s = m.histogram("serve_queue_seconds", self._lbl(),
                                      help="admission -> batch dispatch wait")
        self._m_device_s = m.histogram("serve_device_seconds", self._lbl(),
                                       help="device forward wall time per batch")
        self._m_occupancy = m.histogram(
            "serve_batch_occupancy", self._lbl(), buckets=_OCCUPANCY_BUCKETS,
            help="real rows / padded bucket size per device batch")
        self._m_batches = m.counter("serve_batches_total", self._lbl(),
                                    help="device batches executed")
        self._m_requests = m.counter("serve_requests_total", self._lbl(),
                                     help="requests admitted")
        self._m_compiles = m.counter(
            "serve_compile_misses_total", self._lbl({"component": "engine"}),
            help="new (bucket, shape) signatures served")
        self._m_deadline = m.counter("serve_deadline_expired_total",
                                     self._lbl(),
                                     help="requests expired before dispatch")
        self._spawn_worker()

    def _spawn_worker(self) -> None:
        self._hb = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, args=(self._epoch,), daemon=True,
            name=f"serve-engine-dispatch-{self._epoch}")
        self._thread.start()

    # ------------------------------------------------------------------ admit
    def _lbl(self, labels: Optional[dict] = None) -> dict:
        out = dict(labels or {})
        if self.model_name is not None:
            out["model"] = self.model_name
        return out

    def _shed_counter(self, cause: str):
        return self.metrics.counter(
            "serve_shed_total", self._lbl({"cause": cause}),
            help="requests refused at admission, by cause")

    def queue_depth(self) -> int:
        """Rows currently waiting for a device batch (Retry-After input)."""
        with self._cond:
            return self._depth_rows

    def _bucket_length(self, t: int) -> int:
        for b in self.length_buckets:
            if b >= t:
                return b
        raise CapacityError(
            f"sequence length {t} exceeds largest length bucket "
            f"{self.length_buckets[-1]}")

    def submit(self, x, timeout_ms: Optional[float] = None) -> _Request:
        """Admit one request (rows must fit the largest batch bucket — use
        :meth:`predict` for arbitrary sizes). Returns a waitable handle."""
        x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] == 0:
            raise ValueError("request must contain at least one row")
        if x.shape[0] > self.batch_buckets[-1]:
            raise ValueError(
                f"request rows {x.shape[0]} exceed largest batch bucket "
                f"{self.batch_buckets[-1]}; predict() splits automatically")
        true_len = padded = None
        if self.length_buckets is not None and x.ndim >= 2:
            true_len = x.shape[1]
            padded = self._bucket_length(true_len)
            if padded > true_len:
                pad = np.zeros((x.shape[0], padded - true_len) + x.shape[2:],
                               x.dtype)
                x = np.concatenate([x, pad], axis=1)
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        deadline = (time.perf_counter() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        req = _Request(x, true_len, padded, deadline)
        with self._cond:
            if self._closing:
                self._shed_counter("shutting_down").inc()
                raise ServerClosingError("server is draining; not accepting "
                                         "new requests")
            if not self._thread.is_alive():
                self._shed_counter("worker_dead").inc()
                raise ServerClosingError(
                    "dispatch worker thread is dead; request refused",
                    cause="worker_dead")
            if self.admission == "block":
                self._cond.wait_for(
                    lambda: self._closing
                    or self._depth_rows + req.rows <= self.queue_limit)
                if self._closing:
                    self._shed_counter("shutting_down").inc()
                    raise ServerClosingError("server is draining; not "
                                             "accepting new requests")
            elif self._depth_rows + req.rows > self.queue_limit:
                self._shed_counter("queue_full").inc()
                raise ShedError(
                    f"queue full ({self._depth_rows} rows >= "
                    f"{self.queue_limit}); shedding load")
            self._pending.append(req)
            self._depth_rows += req.rows
            self._m_depth.set(self._depth_rows)
            self._m_requests.inc()
            self._cond.notify_all()
        return req

    def predict(self, x, timeout_ms: Optional[float] = None) -> np.ndarray:
        """Blocking inference. ``x``: one example or a row batch of any
        size — oversized batches are split across bucket-sized requests.
        Raises typed :class:`~.errors.ServeError`s."""
        x = np.asarray(x)
        if x.ndim == len(self.model.input_shape):  # single example
            x = x[None]
        cap = self.batch_buckets[-1]
        if x.shape[0] <= cap:
            return self.submit(x, timeout_ms=timeout_ms).wait()
        reqs = [self.submit(x[i:i + cap], timeout_ms=timeout_ms)
                for i in range(0, x.shape[0], cap)]
        return np.concatenate([r.wait() for r in reqs])

    # --------------------------------------------------------------- dispatch
    def _next_batch(self, epoch: int) -> Optional[List[_Request]]:
        """Pop a coalescible set of pending requests (same shape key, rows
        within the largest bucket), waiting up to ``max_wait_ms`` to fill.
        Returns None when closing with nothing left, or when a crash-only
        restart staled this worker's epoch."""
        with self._cond:
            while not self._pending:
                if self._closing or self._epoch != epoch:
                    return None
                self._hb = time.monotonic()
                self._cond.wait(0.05)
            if self._epoch != epoch:
                return None
            self._hb = time.monotonic()
            first = self._pending.pop(0)
            self._inflight.append(first)
            batch, rows = [first], first.rows
            cap = self.batch_buckets[-1]
            t_end = time.perf_counter() + self.max_wait_ms / 1e3
            while rows < cap:
                took = False
                for i, r in enumerate(self._pending):
                    if r.shape_key == first.shape_key and rows + r.rows <= cap:
                        self._pending.pop(i)
                        self._inflight.append(r)
                        batch.append(r)
                        rows += r.rows
                        took = True
                        break
                if rows >= cap or self._closing:
                    break
                now = time.perf_counter()
                if now >= t_end:
                    break
                if not took:
                    self._cond.wait(min(t_end - now, 1e-3))
            self._depth_rows -= rows
            self._m_depth.set(self._depth_rows)
            self._cond.notify_all()  # wake admission="block" submitters
            if self._epoch != epoch:
                return None
        return batch

    def _run_batch(self, batch: List[_Request], epoch: int) -> None:
        try:
            self._hb = time.monotonic()
            now = time.perf_counter()
            live: List[_Request] = []
            for r in batch:
                if r.event.is_set():    # already answered (restart raced)
                    continue
                if r.deadline is not None and now > r.deadline:
                    r.error = DeadlineExceededError(
                        f"deadline exceeded after "
                        f"{(now - r.enq_t) * 1e3:.1f}ms in queue")
                    self._m_deadline.inc()
                    r.event.set()
                else:
                    live.append(r)
            if not live:
                return
            rows = sum(r.rows for r in live)
            bucket = next((b for b in self.batch_buckets if b >= rows),
                          self.batch_buckets[-1])
            x = np.concatenate([r.x for r in live])
            if x.shape[0] < bucket:  # ALWAYS pad to the bucket — drain path too
                pad = np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad])
            sig = (bucket,) + live[0].shape_key
            with self._cond:
                if self._epoch != epoch:
                    return  # staled mid-flight; restart answered the batch
                if sig not in self._sigs:
                    self._sigs.add(sig)
                    self._m_compiles.inc()
                self._batch_count += 1
                seq = self._batch_count
            with self.registry.lease(tag="engine_batch") as snap:  # ONE generation per batch
                t0 = time.perf_counter()
                try:
                    y = _to_numpy(self._fwd(snap.params, snap.state, x))
                except Exception as e:  # the dispatcher must outlive any bad batch
                    err = (e if isinstance(e, ServeError) else
                           ServeError(f"{type(e).__name__}: {e}",
                                      cause="internal"))
                    for r in live:
                        if not r.event.is_set():
                            r.error = err
                            r.event.set()
                    return
                t1 = time.perf_counter()
                self._m_device_s.observe(t1 - t0)
            self._m_batches.inc()
            self._m_occupancy.observe(rows / bucket)
            off = 0
            for r in live:
                out = y[off:off + r.rows]
                off += r.rows
                if r.event.is_set():  # answered by a restart while we ran
                    continue
                if (r.true_len is not None and r.padded_len is not None
                        and out.ndim >= 2 and out.shape[1] == r.padded_len):
                    out = out[:, :r.true_len]  # un-pad outputs that kept time
                r.result = out
                r.generation = snap.generation
                r.batch_seq = seq
                self._m_queue_s.observe(t0 - r.enq_t)
                r.event.set()
        finally:
            # retire the batch from in-flight tracking; anything still
            # unanswered here was abandoned by an exception escaping the
            # dispatch path — answer it typed before the exception kills
            # this worker, so no caller hangs
            unanswered: List[_Request] = []
            with self._cond:
                for r in batch:
                    try:
                        self._inflight.remove(r)
                    except ValueError:
                        pass
                    if not r.event.is_set():
                        unanswered.append(r)
            if unanswered:
                err = WorkerStallError(
                    "dispatch worker crashed before answering; request "
                    "shed, safe to retry")
                for r in unanswered:
                    self._shed_counter("worker_stall").inc()
                    r.error = err
                    r.event.set()

    def _loop(self, epoch: int) -> None:
        try:
            while True:
                batch = self._next_batch(epoch)
                if batch is None:
                    return
                self._run_batch(batch, epoch)
        except BaseException:
            # backstop: a dying worker answers whatever it still owned
            self._shed_inflight(epoch, WorkerStallError(
                "dispatch worker died; request shed, safe to retry"))
            raise

    def _shed_inflight(self, epoch: Optional[int], err: ServeError) -> None:
        with self._cond:
            if epoch is not None and self._epoch != epoch:
                return
            stalled, self._inflight = self._inflight, []
        for r in stalled:
            if not r.event.is_set():
                self._shed_counter(err.cause).inc()
                r.error = err
                r.event.set()

    # ------------------------------------------------- watchdog + crash-only
    def heartbeat(self) -> float:
        """Monotonic timestamp of the dispatcher's last liveness beat."""
        return self._hb

    def worker_alive(self) -> bool:
        return self._thread.is_alive()

    def restart_worker(self, reason: str = "watchdog") -> bool:
        """Crash-only dispatcher restart: stale the current worker by epoch,
        answer its abandoned in-flight batch with typed
        :class:`~.errors.WorkerStallError`, reclaim its registry leases, and
        spawn a fresh worker. Pending (not yet popped) requests survive and
        are served by the new worker. Returns False while shutting down."""
        with self._cond:
            if self._closing:
                return False
            old = self._thread
            self._epoch += 1
            stalled, self._inflight = self._inflight, []
            self._spawn_worker()
            self._cond.notify_all()
        err = WorkerStallError(
            f"in-flight batch abandoned by dispatcher restart ({reason}); "
            f"safe to retry")
        for r in stalled:
            if not r.event.is_set():
                self._shed_counter("worker_stall").inc()
                r.error = err
                r.event.set()
        # a hung thread can never run its lease finally; reclaim so
        # hot-swap drain cannot deadlock
        self.registry.release_thread(old.ident if old is not None else None)
        return True

    # -------------------------------------------------------------- lifecycle
    @property
    def compile_signatures(self) -> set:
        """Distinct (bucket, example-shape, dtype) signatures ever run."""
        with self._cond:
            return set(self._sigs)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Stop the engine. ``drain=True`` (default) completes everything
        already admitted, through the same padded-bucket path as steady
        state; new admissions shed with ``cause="shutting_down"``
        meanwhile. ``drain=False`` errors pending requests out at once.

        Returns True on a clean worker exit. If the worker is still alive
        when ``timeout`` expires (a wedged device call), it is abandoned:
        remaining work is answered with typed
        :class:`~.errors.DrainTimeoutError`, its leases are reclaimed, and
        False is returned."""
        with self._cond:
            self._closing = True
            if not drain:
                err = ServerClosingError("server shut down before dispatch")
                for r in self._pending:
                    r.error = err
                    r.event.set()
                self._pending.clear()
                self._depth_rows = 0
                self._m_depth.set(0)
            self._cond.notify_all()
        self._thread.join(timeout)
        if not self._thread.is_alive():
            return True
        with self._cond:
            self._epoch += 1  # stale the wedged worker
            stalled = self._inflight + self._pending
            self._inflight, self._pending = [], []
            self._depth_rows = 0
            self._m_depth.set(0)
            self._cond.notify_all()
        err = DrainTimeoutError(
            f"shutdown drain timed out after {timeout}s with work in flight")
        for r in stalled:
            if not r.event.is_set():
                self._shed_counter("drain_timeout").inc()
                r.error = err
                r.event.set()
        self.registry.release_thread(self._thread.ident)
        return False
