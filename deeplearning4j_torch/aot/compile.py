"""Store-backed serving executables: :class:`AotFunction` — counterpart
of ``deeplearning4j_tpu/aot/compile.py``, with a CUDA graph in place of a
serialized XLA executable.

A graph cannot be written to disk, so the executable of one (tag, call
signature, params generation) is a ``torch.cuda.CUDAGraph`` captured at
warm time over static input buffers, its outputs static too; every graph
of one wrapper shares one memory pool. A call copies its inputs into the
static buffers, replays, and returns the static outputs (valid until the
next call: callers copy what they keep). On the CPU the executable is the
eager function, recorded as warmed for its signature, so strict mode, the
counters and the typed errors behave as on the card.

A graph has nothing to write to disk, so what decides a signature is the
store's coverage records (``manifest.covered_keys``): the keys that a
prebuild warmed, and those captured outside one. Each signature resolves
in order:

1. the in-memory map of this generation's graphs (one dict lookup),
2. a key some coverage record of this runtime names: a hit, captured (at
   warm time, before the server answers, or as a counted capture on a
   call),
3. no record names it: strict mode raises a typed
   :class:`~..serve.errors.AotTraceError` (``serve_aot_strict_misses_total``)
   and captures nothing; otherwise the graph is captured, counted on
   ``compile_counter``, and its key stamped into the record of captures
   for the next boot.

A coverage record of this runtime that cannot be read degrades (3)'s
miss to ``serve_aot_fallback_total{cause="corrupt"}``, and a stamp that
cannot be written counts ``cause="store_write"``, the reference's labels.
The graph bakes in the addresses of the weights it read, so graphs are
kept per params generation: a publish warms the candidate's before the
flip, a failed publish drops them (:meth:`AotFunction.drop`), and a
generation's graphs are dropped at the first call on a newer one.

:func:`save_kernels` and :func:`install_kernels` move the kernel
libraries that ``kernels/_build.py`` builds with nvcc through the store,
keyed by the runtime fingerprint, so a boot from a prebuilt store runs no
nvcc.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..obs import profile as _prof
from ..obs import reqtrace as _rt
from .keys import cache_key, call_signature, runtime_fingerprint
from .manifest import covered_keys, stamp_captured
from .store import AotStore, AotStoreError

_KERNEL_TAG = "kernel_library"

# one capture at a time in the process: every capture runs on the one
# capture stream
_CAPTURE_LOCK = threading.Lock()


def graphable(fn: Callable) -> Callable:
    """Mark ``fn(weights, *inputs)`` as capturable: it reads its weights
    and inputs only through tensors, makes no host sync and no host to
    device copy of a Python value, and returns a tensor or a tuple of
    tensors. Unmarked functions pass through an :class:`AotFunction` with
    the store off, as the reference's non-jitted forwards do."""
    fn.aot_graphable = True
    return fn


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return []


class _Eager:
    """The CPU's executable: the function itself over one generation's
    weights."""

    __slots__ = ("fn", "weights")

    def __init__(self, fn, weights):
        self.fn, self.weights = fn, weights

    def __call__(self, *inputs):
        return self.fn(self.weights, *inputs)

    def release(self) -> None:
        self.weights = None


class _Graph:
    """One captured graph: its static inputs and outputs, and the weights
    whose addresses it baked in (held, so they outlive the graph)."""

    __slots__ = ("graph", "inputs", "outputs", "weights")

    def __init__(self, graph, inputs, outputs, weights):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.weights = outputs, weights

    def __call__(self, *inputs):
        with torch.inference_mode():
            for dst, src in zip(self.inputs, inputs):
                if dst is not None:
                    dst.copy_(src, non_blocking=True)
            self.graph.replay()
        return self.outputs

    def release(self) -> None:
        self.graph = self.inputs = self.outputs = self.weights = None


def _capture(fn, weights, inputs, device, pool, warmup: bool) -> _Graph:
    """Capture ``fn(weights, *inputs)`` on the card over static copies of
    ``inputs``, after one eager run (what a library or a wrapper makes
    lazily is then made outside the capture). The eager run goes on the
    caller's stream, in order with the replays there; it executes, so
    callers give inputs whose writes land nowhere live. The capture runs
    on PyTorch's one process-wide capture stream, which nothing else
    runs on: every graph reads that stream's library workspaces, and
    replays on one stream never overlap."""
    with _CAPTURE_LOCK, torch.inference_mode():
        static = [None if x is None else
                  torch.empty(x.shape, dtype=x.dtype, device=device)
                  for x in inputs]
        for dst, src in zip(static, inputs):
            if dst is not None:
                dst.copy_(src)
        if warmup:
            fn(weights, *static)
        torch.cuda.current_stream(device).synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn(weights, *static)
    return _Graph(graph, static, out, weights)


class AotFunction:
    """Store-backed serving step ``fn(weights, *inputs)``.

    Calls take the params generation first: ``f(generation, weights,
    *inputs)``; ``weights`` is whatever ``fn`` reads besides its inputs
    (params, state, compute casts, KV pools), baked into the graph.
    ``inputs`` are tensors (host or device: a call copies them into the
    static buffers) or None. ``device`` is where graphs run (a CPU device
    keeps the eager executable). ``warmup=False`` skips the eager run
    before a capture, for functions that make nothing lazily.

    ``fn`` must be marked :func:`graphable`; anything else passes through
    untouched with the store off. ``compile_counter`` counts captures
    outside a store hit (a strict wrapper raises instead), so a warm boot
    reads zero compiles on the serving counters. ``captures`` counts every
    graph made, ``call_captures`` those made by a call rather than a
    warm, and ``replays`` the calls served from a graph.
    """

    def __init__(self, fn: Callable, *, tag: str,
                 store: Optional[AotStore] = None, metrics=None,
                 arch: str = "", component: str = "serve",
                 compile_counter=None, strict: bool = False, device=None,
                 warmup: bool = True):
        self._fn = fn
        self.tag = tag
        self.store = store if getattr(fn, "aot_graphable", False) else None
        self.arch = arch
        self.component = component
        self.strict = bool(strict) and self.store is not None
        if strict and self.store is None:
            raise ValueError(
                f"AotFunction(tag={tag!r}): strict mode requires a store "
                "and a graphable function")
        self.device = torch.device(device if device is not None else "cpu")
        self._graphs = self.device.type == "cuda"
        self._warmup = bool(warmup)
        self._pool = None
        self._compile_counter = compile_counter
        self._runtime = None
        self._covered: frozenset = frozenset()
        self._exes: Dict[Tuple[Tuple[str, ...], int], Any] = {}
        self._keys: Dict[Tuple[str, ...], str] = {}
        self._lock = threading.RLock()
        self._acquire_seconds = 0.0
        self._called = -1   # newest generation a call has run
        self.captures = 0
        self.call_captures = 0
        self.replays = 0
        from ..obs.metrics import MetricsRegistry

        live = metrics is not None and self.store is not None
        m = metrics if live else MetricsRegistry(enabled=False)
        labels = {"component": component}
        self._m_hits = m.counter(
            "serve_aot_hits_total", labels,
            help="executables loaded from the persistent AOT store")
        self._m_misses = m.counter(
            "serve_aot_misses_total", labels,
            help="AOT store lookups that found no entry")
        self._m_fallback = lambda cause: m.counter(
            "serve_aot_fallback_total", {**labels, "cause": cause},
            help="store entries abandoned for live tracing, by cause")
        self._m_strict = m.counter(
            "serve_aot_strict_misses_total", labels,
            help="signatures refused (typed 503) by strict AOT mode")

    # ------------------------------------------------------------------ calls
    def __call__(self, generation: int, weights, *inputs):
        if self.store is None:
            return self._fn(weights, *inputs)
        sig = call_signature(inputs)
        with self._lock:
            exe = self._exes.get((sig, generation))
            if exe is None:
                exe = self._acquire(sig, generation, weights, inputs,
                                    on_call=True)
            if generation > self._called:
                # the first call on a newer generation retires the older
                # ones (the one worker calling in generation order has
                # moved on: their last in-flight call is done)
                self._called = generation
                self._drop_older(generation)
            if self._graphs:
                self.replays += 1
            # continuous-profiler seam (obs/profile): one attribute load
            # and a None check when profiling is off
            prof = _prof.ACTIVE
            if prof is None:
                return exe(*inputs)
            return prof.dispatch(self, sig, exe, inputs)

    def warm(self, generation: int, weights, *inputs) -> bool:
        """Make the executable of this signature for ``generation`` (store
        hit or a counted capture) before any call needs it. The inputs
        are examples of the signature; on the card the warm-up run before
        the capture executes on them. Returns True when store-backed."""
        if self.store is None:
            return False
        sig = call_signature(inputs)
        with self._lock:
            if (sig, generation) not in self._exes:
                self._acquire(sig, generation, weights, inputs,
                              on_call=False)
        return True

    @property
    def executables(self) -> dict:
        """Signature -> executable of the newest generation held."""
        with self._lock:
            newest = max((g for _, g in self._exes), default=None)
            return {s: e for (s, g), e in self._exes.items() if g == newest}

    def generations(self) -> List[int]:
        """Params generations whose executables are held."""
        with self._lock:
            return sorted({g for _, g in self._exes})

    def store_key(self, sig: Tuple[str, ...]) -> str:
        """The store key of one acquired signature ("" before acquire)."""
        with self._lock:
            return self._keys.get(sig, "")

    def warmed_keys(self) -> list:
        """Sorted store keys of every signature this wrapper acquired: the
        coverage a prebuild stamps into the store's coverage record."""
        with self._lock:
            return sorted(set(self._keys.values()))

    @property
    def acquire_seconds(self) -> float:
        """Cumulative wall time spent loading records and capturing."""
        with self._lock:
            return self._acquire_seconds

    def pool_bytes(self) -> int:
        """Bytes the graphs' static inputs and outputs hold (the part of
        the pool that stays allocated between replays); 0 on the CPU."""
        with self._lock:
            seen, total = set(), 0
            for exe in self._exes.values():
                if not isinstance(exe, _Graph):
                    continue
                for t in _tensors([exe.inputs, exe.outputs]):
                    ptr = t.untyped_storage().data_ptr()
                    if ptr not in seen:
                        seen.add(ptr)
                        total += t.untyped_storage().nbytes()
            return total

    def release(self) -> None:
        """Drop every executable and the memory pool: the weights they
        held are free once nothing else holds them."""
        with self._lock:
            for exe in self._exes.values():
                exe.release()
            self._exes.clear()
            self._pool = None

    def drop(self, generation: int) -> None:
        """Release every executable of one generation: a publish whose
        warm failed drops its candidate's, whose generation number the
        next publish reuses."""
        with self._lock:
            for k in [k for k in self._exes if k[1] == generation]:
                self._exes.pop(k).release()

    def _drop_older(self, generation: int) -> None:
        """Under the lock: release every executable of a generation older
        than ``generation``."""
        for k in [k for k in self._exes if k[1] < generation]:
            self._exes.pop(k).release()

    # ---------------------------------------------------------------- acquire
    def _key(self, sig: Tuple[str, ...]) -> str:
        if self._runtime is None:
            self._runtime = runtime_fingerprint(self.device)
        return cache_key(self.tag, self.arch, sig, runtime=self._runtime)

    def _make(self, weights, inputs):
        if not self._graphs:
            return _Eager(self._fn, weights)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return _capture(self._fn, weights, inputs, self.device, self._pool,
                        self._warmup)

    def _acquire(self, sig, generation, weights, inputs, on_call: bool):
        """Under the lock: coverage lookup -> capture (a strict miss raises
        before anything is captured)."""
        t0 = time.perf_counter()
        key = self._keys.get(sig) or self._key(sig)
        with _rt.span("aot.acquire", tag=self.tag):
            # this process already resolved the signature, or a coverage
            # record names its key
            hit = sig in self._keys or self._lookup(key)
            if not hit and self.strict:
                from ..serve.errors import AotTraceError

                self._m_strict.inc()
                raise AotTraceError(
                    f"strict AOT: no coverage record names tag={self.tag!r} "
                    f"key={key[:16]}… — prebuild the store for this "
                    "serving config (python -m deeplearning4j_torch.aot "
                    "prebuild)")
            with _rt.span("aot.capture", tag=self.tag):
                exe = self._make(weights, inputs)
            if not hit:
                if self._compile_counter is not None:
                    self._compile_counter.inc()
                try:
                    stamp_captured(self.store, self.tag, key, self._runtime)
                except OSError:
                    self._m_fallback("store_write").inc()
        self._exes[(sig, generation)] = exe
        self._keys[sig] = key
        self.captures += 1
        if on_call:
            self.call_captures += 1
        self._acquire_seconds += time.perf_counter() - t0
        return exe

    def _lookup(self, key: str) -> bool:
        """Whether a coverage record of this runtime names ``key``; the
        records are reread on a miss (a prebuild or another wrapper may
        have stamped it since). Counts the hit, the miss, or a miss with
        an unreadable record as a fallback."""
        if key not in self._covered:
            self._covered, unreadable = covered_keys(self.store,
                                                     self._runtime)
            if key not in self._covered:
                if unreadable:
                    self._m_fallback("corrupt").inc()
                else:
                    self._m_misses.inc()
                return False
        self._m_hits.inc()
        return True


# ------------------------------------------------------- kernel libraries
def _kernel_key(name: str, runtime: dict) -> str:
    from ..kernels import _build

    return cache_key(_KERNEL_TAG, name, (_build.library_path(name).name,),
                     runtime=runtime)


def save_kernels(store: AotStore, runtime: Optional[dict] = None
                 ) -> Dict[str, str]:
    """Put every kernel library present in the build directory into the
    store; returns kernel name -> store key. Nothing on the CPU (no
    kernel is built there)."""
    from ..kernels import _build

    rt = runtime if runtime is not None else runtime_fingerprint()
    if rt.get("backend") != "cuda":
        return {}
    out = {}
    for name in _build.KERNELS:
        lib = _build.library_path(name)
        if not lib.exists():
            continue
        key = _kernel_key(name, rt)
        if store.put(key, lib.read_bytes(),
                     meta={"tag": _KERNEL_TAG, "arch": name,
                           "file": lib.name}):
            out[name] = key
    return out


def install_kernels(store: AotStore, runtime: Optional[dict] = None
                    ) -> Tuple[List[str], List[str]]:
    """Write each kernel library the store holds for this runtime into the
    build directory (atomically; a current library is left as it is), so
    the kernels load without nvcc. Returns (installed, missing) kernel
    names; both empty on the CPU."""
    from ..kernels import _build

    rt = runtime if runtime is not None else runtime_fingerprint()
    if rt.get("backend") != "cuda":
        return [], []
    installed, missing = [], []
    for name in _build.KERNELS:
        lib = _build.library_path(name)
        if lib.exists():
            continue
        try:
            blob = store.get(_kernel_key(name, rt))
        except AotStoreError:
            blob = None
        if blob is None:
            missing.append(name)
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, lib)
        installed.append(name)
    return installed, missing


def boot_kernels(store: AotStore, device, strict: bool) -> None:
    """What a store-backed stack runs at construction on the card: install
    the store's kernel libraries; strict, a library the store lacks (and
    the build directory too) refuses the boot instead of running nvcc."""
    if torch.device(device).type != "cuda":
        return
    _, missing = install_kernels(store, runtime_fingerprint(device))
    if missing and strict:
        from ..serve.errors import AotTraceError

        raise AotTraceError(
            f"strict AOT: the store holds no built library for kernels "
            f"{missing} on this runtime — prebuild it on this card")
