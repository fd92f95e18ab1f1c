"""Training-step instrumentation — counterpart of
``deeplearning4j_tpu/obs/step.py``, the instrument behind
``Trainer.fit(telemetry=...)``.

What it separates:

- **data-wait** — host time blocked on the iterator (``wrap_iterator``);
  with AsyncIterator prefetch this is the true input-pipeline stall, not the
  raw ETL cost.
- **dispatch** — time for the eager step call to *return*: the host's
  autograd and kernel-launch work, which runs ahead of the card.
- **device-compute** — dispatch-return → a CUDA event recorded on the
  step output's stream after the call, synchronized. Fencing every step
  serializes the host with the card, so enabling telemetry trades the
  deferred-readback pipelining for visibility — that is the deal, and it
  is why the default (``telemetry=None``) path makes zero obs calls. On a
  CPU tensor the step is complete when the call returns: device time is 0.

Compile-cache misses are counted at the trainer's batch-signature
altitude, with the reference's metric name: a (structure, shape, dtype)
signature never seen before — the first call and every shape change,
where a captured or compiled step would have to be built anew. Device
memory is gauged from ``torch.cuda.memory_stats`` and ``mem_get_info`` of
each CUDA device (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``
under ``device="cuda:<i>"``), with the reference's host-RSS fallback
where there is no card.

``parallel_step`` is ``ParallelWrapper.fit``'s: one rank sees one
device, so with the fence on each rank times its own step (CUDA events
on the card, ``perf_counter`` on the CPU) and one all-gather of that
scalar over the default process group publishes
``parallel_replica_step_seconds{replica=r}`` for every rank ``r`` (give
every rank its own ``StepTelemetry``: the all-gather is a collective).
With the fence off it adds no collective and sets no replica gauge.

Everything here is host-side, and torch is imported only inside the
calls that need it, so the module loads without touching CUDA.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Set

from .metrics import MetricsRegistry
from .trace import Tracer

def _host_rss_bytes() -> float:
    """Process resident set size; 0.0 where unavailable (non-POSIX)."""
    try:
        import resource
    except ImportError:
        return 0.0
    # ru_maxrss is KiB on Linux (bytes on macOS; close enough for a gauge)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024.0


def _first_cuda_tensor(out):
    """The first CUDA tensor in a step's output (a tensor, or tuples,
    lists and dicts of them), or None."""
    import torch

    if isinstance(out, torch.Tensor):
        return out if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for o in items:
        t = _first_cuda_tensor(o)
        if t is not None:
            return t
    return None


def _fence(out) -> None:
    """Wait until the work queued for ``out`` is done: a CUDA event
    recorded on the current stream of its device, synchronized. Nothing
    to wait for on the CPU."""
    t = _first_cuda_tensor(out)
    if t is None:
        return
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()


def _all_ranks(value: float, out) -> list:
    """``value`` of every rank of the default process group (one
    all-gather of a scalar, on the step output's device), or ``[value]``
    without a group."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return [value]
    t = _first_cuda_tensor(out)
    dev = t.device if t is not None else torch.device("cpu")
    mine = torch.tensor([value], dtype=torch.float64, device=dev)
    every = torch.empty(dist.get_world_size(), dtype=torch.float64,
                        device=dev)
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(every, mine)
    return every.tolist()


class StepTelemetry:
    """One instrument object per fit: registry + tracer + step phase timing.

    Pass to ``Trainer.fit(telemetry=StepTelemetry())`` (or attach a
    :class:`~deeplearning4j_torch.obs.listener.TelemetryListener`, which
    fit adopts). ``fence=False`` skips the per-step event wait —
    dispatch/compute are no longer separable, but the deferred-readback
    pipelining is preserved.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, fence: bool = True,
                 memory_every: int = 10):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.fence = fence
        self.memory_every = max(int(memory_every), 0)
        self._sigs: Dict[str, Set[Any]] = {}
        self._t0: Optional[float] = None
        self._steps = 0
        reg = self.registry
        self._step_hist = reg.histogram(
            "train_step_seconds",
            help="end-to-end train step wall time (dispatch + device compute)")
        self._dispatch_hist = reg.histogram(
            "train_dispatch_seconds",
            help="time for the jitted step call to return (enqueue, or "
                 "trace+compile on a cache miss)")
        self._device_hist = reg.histogram(
            "train_device_compute_seconds",
            help="dispatch return -> block_until_ready on the step outputs")
        self._data_hist = reg.histogram(
            "train_data_wait_seconds",
            help="host time blocked on the (possibly prefetching) iterator")
        self._compile_counter = reg.counter(
            "compile_cache_misses_total",
            help="first-call/shape-change step signatures (each one is an "
                 "XLA trace+compile)")
        self._steps_counter = reg.counter(
            "train_steps_total", help="train steps dispatched")
        self._samples_counter = reg.counter(
            "train_samples_total", help="training examples consumed")

    # --- fit-loop hooks ---
    def wrap_iterator(self, it: Iterable) -> Iterator:
        """Yield batches from ``it``, timing each ``next()`` as data-wait."""
        def gen():
            src = iter(it)
            while True:
                t0 = time.perf_counter()
                with self.tracer.span("data_wait"):
                    try:
                        ds = next(src)
                    except StopIteration:
                        return
                self._data_hist.observe(time.perf_counter() - t0)
                yield ds
        return gen()

    def step(self, thunk: Callable[[], Any], sig: Any = None,
             batch_size: int = 0, kind: str = "train"):
        """Run one dispatched train step through the phase clocks.

        ``thunk`` dispatches the step and returns its device outputs;
        ``sig`` is the batch signature for compile-miss detection.
        """
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if sig is not None:
            seen = self._sigs.setdefault(kind, set())
            if sig not in seen:
                seen.add(sig)
                self._compile_counter.inc()
                self.tracer.instant("compile_cache_miss", kind=kind)
        t0 = time.perf_counter()
        with self.tracer.span("train_step", kind=kind):
            with self.tracer.span("dispatch"):
                out = thunk()
            t1 = time.perf_counter()
            if self.fence:
                with self.tracer.span("device_compute"):
                    _fence(out)
        t2 = time.perf_counter()
        self._step_hist.observe(t2 - t0)
        self._dispatch_hist.observe(t1 - t0)
        if self.fence:
            self._device_hist.observe(t2 - t1)
        self._steps += 1
        self._steps_counter.inc()
        if batch_size:
            self._samples_counter.inc(batch_size)
        if self.memory_every and self._steps % self.memory_every == 1:
            self.record_memory()
        return out

    def parallel_step(self, thunk: Callable[[], Any], batch_size: int = 0):
        """A ``ParallelWrapper`` step: aggregate throughput
        (``parallel_samples_per_second``, ``parallel_step_seconds``) and,
        with the fence on, every rank's own step time as
        ``parallel_replica_step_seconds{replica=r}`` (the max-min spread
        is the skew; the slowest rank gates the step)."""
        import torch

        reg = self.registry
        if self._t0 is None:
            self._t0 = time.perf_counter()
        start = None
        if self.fence and torch.cuda.is_available() \
                and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        with self.tracer.span("parallel_step"):
            with self.tracer.span("dispatch"):
                out = thunk()
            if self.fence:
                with self.tracer.span("device_compute"):
                    _fence(out)
                    mine = time.perf_counter() - t0
                    if start is not None and _first_cuda_tensor(out) \
                            is not None:
                        end = torch.cuda.Event(enable_timing=True)
                        end.record()
                        end.synchronize()
                        mine = start.elapsed_time(end) / 1e3
                    for r, t in enumerate(_all_ranks(mine, out)):
                        reg.gauge("parallel_replica_step_seconds",
                                  {"replica": str(r)},
                                  help="each rank's own step time (skew "
                                       "gauge)").set(t)
        dt = time.perf_counter() - t0
        reg.histogram("parallel_step_seconds",
                      help="end-to-end multi-device step wall time"
                      ).observe(dt)
        if batch_size and dt > 0:
            reg.gauge("parallel_samples_per_second",
                      help="aggregate training throughput over all replicas"
                      ).set(batch_size / dt)
        self._steps += 1
        self._steps_counter.inc()
        if batch_size:
            self._samples_counter.inc(batch_size)
        if self.memory_every and self._steps % self.memory_every == 1:
            self.record_memory()
        return out

    def record_memory(self) -> None:
        """Device memory gauges of every CUDA device, host-RSS fallback
        where there is none."""
        import torch

        g = self.registry.gauge
        saw_device_stats = False
        # a process that never touched CUDA has nothing on a card to gauge
        # (and reading stats would initialize CUDA for nothing)
        n = torch.cuda.device_count() if torch.cuda.is_initialized() else 0
        for i in range(n):
            stats = torch.cuda.memory_stats(i)
            _, total = torch.cuda.mem_get_info(i)
            saw_device_stats = True
            values = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": total,
            }
            for key, v in values.items():
                g("device_memory_bytes", {"device": f"cuda:{i}", "kind": key},
                  help="per-device allocator stats (host RSS fallback "
                       "where the backend has none)").set(float(v))
        if not saw_device_stats:
            rss = _host_rss_bytes()
            if rss:
                g("device_memory_bytes", {"device": "host", "kind": "rss"},
                  help="per-device allocator stats (host RSS fallback "
                       "where the backend has none)").set(rss)

    # --- export ---
    def snapshot(self) -> dict:
        """Summary dict: steps/sec, step-time quantiles, compile count."""
        elapsed = (time.perf_counter() - self._t0) if self._t0 else 0.0
        steps = self._steps
        pct = self._step_hist.percentiles()
        return {
            "steps": steps,
            "steps_per_sec": steps / elapsed if elapsed > 0 else 0.0,
            "samples_per_sec": (self._samples_counter.value / elapsed
                                if elapsed > 0 else 0.0),
            "mean_step_seconds": self._step_hist.mean,
            "p50_step_seconds": pct["p50"],
            "p95_step_seconds": pct["p95"],
            "p99_step_seconds": pct["p99"],
            "compile_cache_misses": int(self._compile_counter.value),
        }

    def export_trace(self, path: Optional[str] = None) -> str:
        return self.tracer.export(path)

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()
