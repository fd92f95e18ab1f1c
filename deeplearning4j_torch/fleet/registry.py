"""FleetRegistry — N named models multiplexed through one process;
counterpart of ``deeplearning4j_tpu/fleet/registry.py``.

Each :class:`FleetEntry` owns the full single-model serving stack when
resident — a :class:`~..serve.registry.ModelRegistry` (generations +
leases + hot-swap), a :class:`~..serve.engine.ServeEngine` (predict), and
a lazily-built :class:`~..serve.continuous.ContinuousBatcher` (generate)
— and shrinks to a host-side weight copy when paged out. The ground truth
for a cold model is host RAM.

On the card the two transfers are explicit:

- **Host copies are pinned.** An entry keeps its params and state as
  ``pin_memory()`` tensors, allocated once and again only when a publish
  changes a shape (plain CPU tensors on a CPU fleet).
- **Page-in** (:meth:`FleetEntry.activate`) allocates every device tensor
  on the device's one page-in stream, shared by every entry, and copies
  into it with ``non_blocking=True``. The caching allocator reuses a freed
  block only for an allocation on the stream it was made on: on a stream
  of each entry's own, a paged-out model's blocks would stay cached for
  that entry alone, and the card would hold cached weights of every model
  whatever the budget says. Each tensor is marked as used by the device's
  default stream, which every engine and batcher worker computes on
  (``record_stream``), so the caching allocator hands its block out again
  only after that use. The page-in thread then waits on an event recorded
  after the copies — on the host, not on the default stream: a stream
  wait there would hold every resident model's kernels behind the copy,
  and the page-in thread is blocked in ``pager.ensure`` anyway. The engine
  starts once the event has fired, so its first forward reads complete
  weights, while resident models keep computing through the whole copy
  (the reference's rule, ``pager.py``: traffic to resident models never
  stalls on a page-in). A failure part-way through the copy drops every
  device tensor made so far before the error leaves ``activate``.
- **Page-out** (:meth:`FleetEntry.deactivate`) drains the engine and the
  batcher; when a generation was published while resident, it copies the
  *current* snapshot into the pinned host copy, so that generation
  survives (otherwise the host copy already holds those bytes, and
  nothing crosses the link: a page-out sits on the critical path of the
  miss that evicts it); then it drops every device reference: the
  registry with its rollback history, the batcher's KV pools,
  prefix-cache blocks and per-generation compute casts, the engine.
  ``page_log`` records, per page-in and page-out, its time and bytes and,
  on the card, ``torch.cuda.memory_allocated`` around it.

Generation numbers survive paging: deactivation records
``last generation + 1`` and the next activation's ModelRegistry starts
there (``start_generation``), so "which params answered this request" is
a total order per model across any number of page-out/page-in cycles.

Request flow (:meth:`FleetRegistry.predict` / :meth:`~.generate`):
breaker gate, tenant admission (:class:`~.tenants.TenantTable` — an
over-quota tenant is shed before any paging work), ``pager.ensure``
(resident: one lock; cold: LRU eviction + activation), then the entry's
engine. A request that loses the race with a concurrent eviction gets the
engine's typed ``ServerClosingError`` and retries through the pager —
bounded, because each retry pages the model back in.

Budget accounting is the reference's: ``weight_bytes`` counts params and
state only; KV pools, activations and the batcher's compute casts stay
outside the budget.

With a shared ``aot_store=`` every activation makes the entry's serving
graphs before the entry takes traffic (the engine's warm, the batcher's
warm-at-construction); with ``strict_aot=True`` an uncovered signature
fails the page-in typed (:class:`~.pager.PageInError` after the pager's
retries), never a request. A page-out drops the graphs and their pool
with the weights (``ServeEngine.shutdown``,
``ContinuousBatcher.release_device``). ``tuned_for=`` (a workload
fingerprint) resolves the tuned config's engine and gen knob groups from
the store as every ``add()``'s defaults.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs.metrics import MetricsRegistry
from ..obs.slo import SloBurn
from ..ops.updaters import tree_leaves, tree_unflatten
from ..serve.continuous import ContinuousBatcher
from ..serve.engine import ServeEngine, example_shape
from ..serve.errors import ServeError, ServerClosingError
from ..serve.health import Health
from ..serve.registry import ModelRegistry
from ..serve.watchdog import Watchdog
from .breaker import CircuitBreaker
from .pager import WeightPager
from .tenants import TenantTable

_EVICTION_RETRIES = 4

# one stream a device for each direction of the weight copies, shared by
# every entry of every fleet in the process (see the module docstring)
_COPY_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}
_COPY_STREAMS_LOCK = threading.Lock()


def _copy_stream(device: torch.device, direction: str) -> "torch.cuda.Stream":
    """The process's ``"in"`` (host -> device) or ``"out"`` stream of
    ``device``. Page-ins allocate on the ``"in"`` stream, so every freed
    weight block stays in one pool that each later page-in reuses."""
    with _COPY_STREAMS_LOCK:
        key = (device, direction)
        if key not in _COPY_STREAMS:
            _COPY_STREAMS[key] = torch.cuda.Stream(device)
        return _COPY_STREAMS[key]


# ServeError causes that count against a model's circuit breaker: server-side
# breakage only. Quota/capacity/queue-full sheds and client deadlines are
# load signals, not path failures — tripping a breaker on them would turn an
# overload into an outage.
_BREAKER_CAUSES = frozenset({"internal", "page_in_failed", "worker_stall",
                             "worker_dead", "drain_timeout"})

# ServeError causes that do not consume error budget: the *client* (or its
# quota) failed, not our serving path. Everything else after admission —
# deadline misses included — is a bad event for the tenant's SLO class.
# "client_gone" is the client dropping its own socket mid-stream.
_SLO_EXCLUDED = frozenset({"quota", "over_capacity", "bad_request",
                           "client_gone"})


class UnknownModelError(ServeError):
    """No model with that name in the fleet (HTTP 404)."""

    cause = "unknown_model"
    http_status = 404


class FleetResult(NamedTuple):
    """One predict answer: the output rows and (when the request rode a
    single engine batch) the params generation that produced them."""

    output: np.ndarray
    generation: Optional[int]


def _tree_map(fn: Callable, tree):
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


def _tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree))


def _indexed(device) -> torch.device:
    """``device`` with its CUDA index filled in (``cuda`` -> ``cuda:0``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _same_layout(a, b) -> bool:
    """Same tree structure, shapes and dtypes (host buffers reusable)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(_same_layout(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_layout(x, y) for x, y in zip(a, b)))
    return a.shape == b.shape and a.dtype == b.dtype


class FleetEntry:
    """One named model: pinned host weight copy + (when resident) serving
    stack on ``device``."""

    def __init__(self, name: str, model, params, state=None, *,
                 version: str = "v0", input_dtype=np.float32, metrics=None,
                 aot_store=None, strict_aot: bool = False,
                 engine_opts: Optional[dict] = None,
                 gen_opts: Optional[dict] = None,
                 device: DeviceLike = None):
        if params is None:
            raise ValueError(f"model {name!r} has no params: call init() "
                             f"or pass params=")
        self.name = name
        self.model = model
        self.device = _indexed(device if device is not None
                               else model.device)
        if _indexed(model.device) != self.device:
            raise ValueError(f"model {name!r} lives on {model.device}, the "
                             f"fleet on {self.device}")
        self.input_dtype = input_dtype
        self.metrics = metrics
        self.aot_store = aot_store
        # strict page-ins: activation makes its graphs from the prebuilt
        # store or fails typed — never a capture without a record
        self.strict_aot = bool(strict_aot)
        if self.strict_aot and aot_store is None:
            raise ValueError(f"model {name!r}: strict_aot=True requires "
                             "a shared aot_store")
        self.engine_opts = dict(engine_opts or {})
        self.gen_opts = dict(gen_opts or {})
        self.version = version
        self._cuda = self.device.type == "cuda"
        # RLock held across the WHOLE of activate()/deactivate(): the pager
        # may start re-activating a victim (new traffic arrived) while its
        # drain is still completing — the lock serializes the lifecycles so
        # the new stack always starts from the drained host copy
        self._lock = threading.RLock()
        #: seconds spent allocating the host copy (pinned on the card) and
        #: filling it
        self.host_alloc_s = self.host_fill_s = 0.0
        self._host_params = self._to_host(params)
        self._host_state = self._to_host(state if state is not None else {})
        self.weight_bytes = _tree_bytes(self._host_params, self._host_state)
        self._next_generation = 1
        # the generation whose bytes the host copy holds while resident:
        # a page-out copies back only when the current one differs
        self._host_generation = 1
        self._registry: Optional[ModelRegistry] = None
        self._engine: Optional[ServeEngine] = None
        self._batcher: Optional[ContinuousBatcher] = None
        self._had_batcher = False
        #: one record per page-in and page-out: kind ("page_in"/
        #: "page_out"), seconds of the transfer, bytes, and on the card
        #: memory_allocated before/after; a page-in also its start
        #: (perf_counter) and the seconds the host took to issue its
        #: copies; a page-out also whether it copied the weights back, its
        #: seconds in all (drain, copy, drop) and the allocator's
        #: freed-bytes counter across the drop
        self.page_log: deque = deque(maxlen=256)

    # ------------------------------------------------------------ host side
    def _host_leaf(self, t) -> torch.Tensor:
        t = torch.as_tensor(t)
        t0 = time.perf_counter()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._cuda)
        t1 = time.perf_counter()
        h.copy_(t)
        self.host_alloc_s += t1 - t0
        self.host_fill_s += time.perf_counter() - t1
        return h

    def _to_host(self, tree):
        return _tree_map(self._host_leaf, tree)

    def _store_host(self, params, state) -> None:
        """Copy ``params``/``state`` into the host buffers, allocating new
        ones only where the layout changed (a publish with new shapes)."""
        for attr, tree in (("_host_params", params), ("_host_state", state)):
            host = getattr(self, attr)
            if not _same_layout(host, tree):
                setattr(self, attr, self._to_host(tree))
                continue
            if self._cuda:
                stream = _copy_stream(self.device, "out")
                # a publish wrote the tensors on the default stream; a
                # page-in's copies landed before activate() returned
                stream.wait_stream(torch.cuda.default_stream(self.device))
                with torch.cuda.stream(stream):
                    for h, d in zip(tree_leaves(host), tree_leaves(tree)):
                        h.copy_(d, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()
            else:
                for h, d in zip(tree_leaves(host), tree_leaves(tree)):
                    h.copy_(d)

    # ---------------------------------------------------------- device side
    def _device_leaf(self, h: torch.Tensor) -> torch.Tensor:
        """One host leaf on the device. On the card: allocated on the
        page-in stream (the caller's current stream), filled without
        blocking, and marked as read by the default stream."""
        if not self._cuda:
            return h.to(self.device, copy=True)
        d = torch.empty(h.shape, dtype=h.dtype, device=self.device)
        d.copy_(h, non_blocking=True)
        d.record_stream(torch.cuda.default_stream(self.device))
        return d

    def _to_device(self):
        """The host copy on the device, every copy landed, and the seconds
        the host took to issue the copies. A failure part way through
        drops what was made so far before it propagates."""
        t0 = time.perf_counter()
        if not self._cuda:
            return (_tree_map(self._device_leaf, self._host_params),
                    _tree_map(self._device_leaf, self._host_state),
                    time.perf_counter() - t0)
        stream = _copy_stream(self.device, "in")
        made: list = []

        def leaf(h):
            d = self._device_leaf(h)
            made.append(d)
            return d

        try:
            with torch.cuda.stream(stream):
                params = _tree_map(leaf, self._host_params)
                state = _tree_map(leaf, self._host_state)
                done = torch.cuda.Event()
                done.record(stream)
            issued = time.perf_counter() - t0
            # the page-in thread waits here, on the host: no stream of the
            # device waits on the copy, so resident models' kernels never
            # queue behind it
            done.synchronize()
        except BaseException as e:
            # the copies in flight read pinned host memory we keep; the
            # allocator recycles each block after its recorded uses. The
            # traceback's finished frames still name the partial tensors:
            # clear them, or the error would keep them on the device
            made.clear()
            traceback.clear_frames(e.__traceback__)
            raise
        return params, state, issued

    # ------------------------------------------------------------- lifecycle
    @property
    def resident(self) -> bool:
        with self._lock:
            return self._engine is not None

    def _alloc(self) -> int:
        return torch.cuda.memory_allocated(self.device) if self._cuda else 0

    def activate(self) -> None:
        """Host copy -> device, registry/engine up. Called by the pager
        with residency bytes already reserved."""
        with self._lock:
            if self._engine is not None:
                return
            t0 = time.perf_counter()
            a0 = self._alloc()
            params, state, issued = self._to_device()
            dt = time.perf_counter() - t0
            self._host_generation = self._next_generation
            try:
                self._registry = ModelRegistry(
                    params, state, version=self.version,
                    metrics=self.metrics, model=self.name,
                    start_generation=self._next_generation)
                del params, state
                self._engine = ServeEngine(
                    self.model, registry=self._registry,
                    metrics=self.metrics, model_name=self.name,
                    aot_store=self.aot_store, strict_aot=self.strict_aot,
                    **self.engine_opts)
                if self.aot_store is not None:
                    # every signature's graph before the entry takes
                    # traffic (strict: an uncovered one fails the page-in)
                    self._engine.warm(self.input_dtype)
                if self._had_batcher:
                    # the model served generate traffic last residency;
                    # rebuild eagerly so paged-in decode is ready before
                    # the next request
                    self._build_batcher_locked()
            except BaseException:
                params = state = None
                self._drop_locked()
                raise
            self.page_log.append({
                "kind": "page_in", "seconds": dt, "start": t0,
                "issue_seconds": issued,
                "bytes": int(self.weight_bytes),
                "generation": self._next_generation,
                "allocated_before": a0, "allocated_after": self._alloc()})

    def _drop_locked(self) -> None:
        """Stop and forget the serving stack and every device tensor it
        holds, whoever still holds the stack's objects: a client thread
        whose request lost the race with this page-out keeps the old
        engine until it retries, the watchdog keeps a poll's components
        until the poll ends. So the registry drops its snapshots (the
        weights and the rollback history) and the batcher its KV pools and
        casts explicitly."""
        if self._engine is not None:
            self._engine.shutdown(drain=False)
        if self._batcher is not None:
            self._batcher.shutdown(drain=False)
            self._batcher.release_device()
        if self._registry is not None:
            self._registry.close()
        self._registry = None
        self._engine = None
        self._batcher = None

    # Deliberate: the entry RLock is held across the whole drain (see the
    # __init__ comment) so a re-activation can never interleave with a
    # half-finished eviction.
    def deactivate(self) -> None:
        """Lease-drain, pull current weights to host, drop device refs.

        ``shutdown(drain=True)`` completes every admitted batch/generation
        against the old device params before they are released, so no
        in-flight work ever loses its params. The *current* registry
        snapshot (including any generations published while resident) is
        what survives as the host copy; when it is still the generation
        paged in, the host copy already holds its bytes and is kept."""
        with self._lock:
            if self._engine is None:
                return
            t_all = time.perf_counter()
            self._engine.shutdown(drain=True)
            if self._batcher is not None:
                self._batcher.shutdown(drain=True)
            t0 = time.perf_counter()
            snap = self._registry.current()
            copied = snap.generation != self._host_generation
            if copied:
                self._store_host(snap.params, snap.state)
                self.weight_bytes = _tree_bytes(self._host_params,
                                                self._host_state)
            dt = time.perf_counter() - t0
            self.version = snap.version
            self._next_generation = snap.generation + 1
            del snap
            a0 = self._alloc()
            f0 = (torch.cuda.memory_stats(self.device).get(
                "allocated_bytes.all.freed", 0) if self._cuda else 0)
            self._drop_locked()
            a1 = self._alloc()
            freed = (torch.cuda.memory_stats(self.device).get(
                "allocated_bytes.all.freed", 0) - f0 if self._cuda else 0)
            self.page_log.append({
                "kind": "page_out", "seconds": dt, "copied": copied,
                "total_seconds": time.perf_counter() - t_all,
                "bytes": int(self.weight_bytes),
                "generation": self._next_generation - 1,
                "allocated_before": a0, "allocated_after": a1,
                "freed": freed,
                "reserved": (torch.cuda.memory_reserved(self.device)
                             if self._cuda else 0)})

    # --------------------------------------------------------------- serving
    # "Not resident" is an internal eviction-race signal — the fleet
    # facade's _EVICTION_RETRIES loop swallows it and pages the model back
    # in; only an exhausted retry escapes.
    def engine(self) -> ServeEngine:
        with self._lock:
            if self._engine is None:
                raise ServerClosingError(
                    f"model {self.name!r} is not resident")
            return self._engine

    def _build_batcher_locked(self) -> None:
        self._batcher = ContinuousBatcher(
            self.model, registry=self._registry, metrics=self.metrics,
            aot_store=self.aot_store, strict_aot=self.strict_aot,
            model_name=self.name, **self.gen_opts)
        self._had_batcher = True

    def batcher(self) -> ContinuousBatcher:
        with self._lock:
            if self._engine is None:
                raise ServerClosingError(
                    f"model {self.name!r} is not resident")
            if self._batcher is None:
                self._build_batcher_locked()
            return self._batcher

    # Deliberate: publish-with-drain waits out in-flight leases while the
    # entry RLock serializes it against eviction/re-activation — same
    # lifecycle contract as deactivate().
    def publish(self, params, state=None, version: Optional[str] = None,
                drain: bool = True) -> int:
        """Hot-swap this model's weights; returns the new generation.
        Resident: the full registry publish (atomic flip, lease drain) of
        a device copy of ``params``. Cold: the host copy and generation
        counter advance so the next activation serves the new weights
        under the right generation number."""
        with self._lock:
            if self._registry is not None:
                def dev(t):
                    return torch.as_tensor(t).detach().to(self.device,
                                                          copy=True)

                snap = self._registry.publish(
                    _tree_map(dev, params),
                    state=(_tree_map(dev, state)
                           if state is not None else None),
                    version=version, drain=drain)
                self.version = snap.version
                return snap.generation
            self._store_host(params, state if state is not None
                             else self._host_state)
            self.weight_bytes = _tree_bytes(self._host_params,
                                            self._host_state)
            gen = self._next_generation
            self.version = version if version is not None else f"v{gen - 1}"
            self._next_generation = gen + 1
            return gen

    def queue_depth(self) -> int:
        """Requests waiting in this entry's resident stack (0 when cold)."""
        with self._lock:
            if self._engine is None:
                return 0
            depth = self._engine.queue_depth()
            if self._batcher is not None:
                depth += self._batcher.queue_depth()
            return depth

    def kv_utilization(self) -> float:
        """Fraction of this entry's KV blocks in use — 0.0 when cold,
        predict-only, or the batcher runs the dense (non-paged) path."""
        with self._lock:
            if self._batcher is None:
                return 0.0
            stats = self._batcher.kv_block_stats()
        total = int(stats.get("blocks_total") or 0)
        return (int(stats.get("blocks_used") or 0) / total) if total else 0.0

    def components(self) -> list:
        """Watchdog view: ``(name, worker-owning component)`` pairs for the
        currently-resident serving stack (empty when paged out)."""
        with self._lock:
            if self._engine is None:
                return []
            comps = [(f"{self.name}.engine", self._engine)]
            if self._batcher is not None:
                comps.append((f"{self.name}.batcher", self._batcher))
            return comps

    def info(self) -> dict:
        with self._lock:
            resident = self._engine is not None
            out = {
                "resident": resident,
                "version": self.version,
                "generation": (self._registry.generation if resident
                               else self._next_generation - 1),
                "weight_bytes": int(self.weight_bytes),
                "generate_ready": self._batcher is not None,
            }
            batcher = self._batcher
        if batcher is not None and batcher.kv == "paged":
            # sharing picture per tenant-facing model: block usage,
            # prefix-cache hit rates, CoW/fork counts
            out["kv"] = batcher.kv_block_stats()
        return out


class FleetRegistry:
    """Named models + tenant admission + weight paging, one front door.

    ``hbm_budget_bytes`` caps summed resident weights (None = unbounded).
    ``device`` is where resident models live: the CUDA card unless given
    (``device="cpu"`` for a CPU fleet); every model added must live there.
    Per-model engine/batcher knobs ride in ``add(engine_opts=...,
    gen_opts=...)``.
    """

    def __init__(self, *, hbm_budget_bytes: Optional[int] = None,
                 metrics=None, aot_store=None, strict_aot: bool = False,
                 tenants: Optional[TenantTable] = None,
                 breaker_failures: Optional[int] = 5,
                 breaker_reset_s: float = 10.0, breaker_clock=None,
                 watchdog_s: Optional[float] = None,
                 tuned_for: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = _indexed(resolve_device(device))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.aot_store = aot_store
        # strict_aot applies fleet-wide: every entry's activation (and
        # every page-in after an eviction) must be served by the prebuilt
        # store or fail typed
        self.strict_aot = bool(strict_aot)
        if self.strict_aot and aot_store is None:
            raise ValueError("strict_aot=True requires a shared aot_store")
        # tuned_for: a workload fingerprint. The boot resolves the tuned
        # knob set for (this runtime, that workload) from the store, and
        # every add() starts from those knobs; a miss (counted on
        # sim_tuned_config_misses_total) means the defaults
        self.tuned_config: Optional[dict] = None
        if tuned_for is not None:
            from ..aot.tuned import get_tuned

            self.tuned_config = get_tuned(aot_store, tuned_for,
                                          metrics=self.metrics)
        self.tenants = tenants if tenants is not None \
            else TenantTable(metrics=self.metrics)
        self.pager = WeightPager(hbm_budget_bytes, metrics=self.metrics)
        self._lock = threading.Lock()
        self._entries: Dict[str, FleetEntry] = {}
        self.health = Health(metrics=self.metrics, component="fleet")
        # per (model, slo_class) error-budget burn; works with tracing off
        self.slo = SloBurn(metrics=self.metrics)
        # per-model circuit breakers; breaker_failures=None disables them
        self._breaker_failures = breaker_failures
        self._breaker_reset_s = float(breaker_reset_s)
        self._breaker_clock = breaker_clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._watchdog: Optional[Watchdog] = None
        if watchdog_s is not None:
            self._watchdog = Watchdog(
                self._watch_components, deadline_s=watchdog_s,
                metrics=self.metrics, health=self.health).start()

    def _watch_components(self) -> list:
        with self._lock:
            entries = list(self._entries.values())
        comps: list = []
        for entry in entries:
            comps.extend(entry.components())
        return comps

    def _breaker(self, name: str) -> Optional[CircuitBreaker]:
        with self._lock:
            return self._breakers.get(name)

    # ------------------------------------------------------------ membership
    def add(self, name: str, model, params=None, state=None, *,
            version: str = "v0", input_dtype=np.float32,
            engine_opts: Optional[dict] = None,
            gen_opts: Optional[dict] = None,
            eager: bool = False) -> FleetEntry:
        """Register a model under ``name``. Weights default to the model's
        own initialized params (copied to the host: the model's device
        tensors may be dropped afterwards). ``eager=True`` pages it in
        immediately; otherwise the first request does. With a resolved
        tuned config (``tuned_for=``), its engine/gen groups become the
        per-model defaults; explicit ``engine_opts``/``gen_opts`` keys
        still win."""
        if self.tuned_config is not None:
            from ..aot.tuned import tuned_group
            from ..serve.continuous import gen_opts_from_config
            from ..serve.engine import ENGINE_KNOBS

            tuned_engine = {
                k: v
                for k, v in tuned_group(self.tuned_config, "engine").items()
                if k in ENGINE_KNOBS}
            engine_opts = {**tuned_engine, **(engine_opts or {})}
            gen_opts = {**gen_opts_from_config(self.tuned_config),
                        **(gen_opts or {})}
        entry = FleetEntry(
            name, model,
            params if params is not None else model.params,
            state if state is not None else model.state,
            version=version, input_dtype=input_dtype, metrics=self.metrics,
            aot_store=self.aot_store, strict_aot=self.strict_aot,
            engine_opts=engine_opts, gen_opts=gen_opts, device=self.device)
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered — "
                                 f"publish() hot-swaps weights in place")
            self._entries[name] = entry
            if self._breaker_failures is not None:
                kwargs = {}
                if self._breaker_clock is not None:
                    kwargs["clock"] = self._breaker_clock
                self._breakers[name] = CircuitBreaker(
                    failure_threshold=self._breaker_failures,
                    reset_s=self._breaker_reset_s, metrics=self.metrics,
                    model=name, health=self.health, **kwargs)
        if eager:
            self.pager.ensure(entry)
        return entry

    def remove(self, name: str) -> None:
        with self._lock:
            entry = self._entries.pop(name, None)
            self._breakers.pop(name, None)
        if entry is None:
            raise UnknownModelError(f"no model named {name!r}")
        # a removed model's open breaker must not keep readiness off
        self.health.clear(f"breaker_open:{name}")
        self.pager.drop(entry)

    def get(self, name: str) -> FleetEntry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise UnknownModelError(f"no model named {name!r}")
        return entry

    def names(self) -> list:
        with self._lock:
            return sorted(self._entries)

    def queue_depth(self) -> int:
        """Fleet-wide queued work (sum over resident models) — the load
        signal a replica self-reports on each heartbeat."""
        with self._lock:
            entries = list(self._entries.values())
        return sum(e.queue_depth() for e in entries)

    def kv_pressure(self) -> float:
        """Worst KV-block utilization across resident models — the memory
        half of the load signal a replica self-reports."""
        with self._lock:
            entries = list(self._entries.values())
        return max((e.kv_utilization() for e in entries), default=0.0)

    def ensure(self, name: str) -> FleetEntry:
        """Page a model in without serving a request (prewarm)."""
        entry = self.get(name)
        self.pager.ensure(entry)
        return entry

    # --------------------------------------------------------------- serving
    def _admit(self, tenant: str, name: str,
               timeout_ms: Optional[float]) -> tuple:
        """Tenant admission; returns ``(deadline_ms, slo_class_name)``."""
        slo = self.tenants.admit(tenant, model=name)
        return (timeout_ms if timeout_ms is not None else slo.deadline_ms,
                slo.name)

    def _slo_record(self, name: str, slo_class: Optional[str],
                    exc: Optional[BaseException]) -> None:
        """One admitted request's outcome into the burn accounting.
        ``slo_class`` is None when admission itself refused (quota) —
        nothing to account."""
        if slo_class is None:
            return
        if isinstance(exc, ServeError) and exc.cause in _SLO_EXCLUDED:
            return
        self.slo.record(name, slo_class, good=exc is None)

    @staticmethod
    def _breaker_counts(exc: BaseException) -> bool:
        """Does this failure count against the model's breaker? Server-side
        breakage only — see ``_BREAKER_CAUSES``."""
        if isinstance(exc, ServeError):
            return exc.cause in _BREAKER_CAUSES
        return True

    def _observed(self, br: Optional[CircuitBreaker], fn):
        """Run one gated serving attempt, feeding its outcome back into the
        model's breaker. ``br.allow()`` already passed for this request."""
        if br is None:
            return fn()
        try:
            out = fn()
        except BaseException as e:
            if self._breaker_counts(e):
                br.record_failure()
            else:
                br.record_ignored()
            raise
        br.record_success()
        return out

    def predict(self, name: str, x, *, tenant: str = "anonymous",
                timeout_ms: Optional[float] = None, ctx=None) -> FleetResult:
        """Breaker gate -> tenant admission -> page-in -> engine predict.
        ``timeout_ms`` defaults to the tenant's SLO deadline."""
        entry = self.get(name)
        br = self._breaker(name)
        if br is not None:
            br.allow()  # open breaker refuses before quota/paging work
        slo_cls: list = [None]

        def _serve() -> FleetResult:
            nonlocal timeout_ms
            if ctx is None:
                timeout_ms, slo_cls[0] = self._admit(tenant, name,
                                                     timeout_ms)
            else:
                with ctx.stage("admit", model=name):
                    timeout_ms, slo_cls[0] = self._admit(tenant, name,
                                                         timeout_ms)
                ctx.tenant = tenant
                ctx.slo_class = slo_cls[0]
            x_ = np.asarray(x, entry.input_dtype)
            last: Optional[ServeError] = None
            for _ in range(_EVICTION_RETRIES):
                if ctx is None:
                    self.pager.ensure(entry)
                else:
                    with ctx.stage("page_in_wait", model=name):
                        self.pager.ensure(entry)
                try:
                    eng = entry.engine()
                    if x_.ndim > len(example_shape(entry.model)) \
                            and x_.shape[0] <= eng.batch_buckets[-1]:
                        handle = eng.submit(x_, timeout_ms=timeout_ms,
                                            ctx=ctx)
                        return FleetResult(handle.wait(), handle.generation)
                    return FleetResult(
                        eng.predict(x_, timeout_ms=timeout_ms, ctx=ctx),
                        None)
                except ServerClosingError as e:
                    last = e  # lost the race with an eviction: page back in
            raise last

        try:
            out = self._observed(br, _serve)
        except BaseException as e:
            self._slo_record(name, slo_cls[0], e)
            raise
        self._slo_record(name, slo_cls[0], None)
        return out

    def submit_generate(self, name: str, prompt, max_new_tokens: int, *,
                        tenant: str = "anonymous", temperature: float = 1.0,
                        top_k: Optional[int] = None,
                        eos_id: Optional[int] = None,
                        timeout_ms: Optional[float] = None, ctx=None):
        """Admit one generation; returns the batcher's streamable handle.
        The breaker observes the *submission* path (paging + admission into
        the batcher) — a handle that later times out does not count."""
        entry = self.get(name)
        br = self._breaker(name)
        if br is not None:
            br.allow()
        slo_cls: list = [None]

        def _serve():
            nonlocal timeout_ms
            if ctx is None:
                timeout_ms, slo_cls[0] = self._admit(tenant, name,
                                                     timeout_ms)
            else:
                with ctx.stage("admit", model=name):
                    timeout_ms, slo_cls[0] = self._admit(tenant, name,
                                                         timeout_ms)
                ctx.tenant = tenant
                ctx.slo_class = slo_cls[0]
            prompt_ = np.asarray(prompt, np.int32)
            last: Optional[ServeError] = None
            for _ in range(_EVICTION_RETRIES):
                if ctx is None:
                    self.pager.ensure(entry)
                else:
                    with ctx.stage("page_in_wait", model=name):
                        self.pager.ensure(entry)
                try:
                    return entry.batcher().submit(
                        prompt_, max_new_tokens, temperature=temperature,
                        top_k=top_k, eos_id=eos_id, timeout_ms=timeout_ms,
                        ctx=ctx)
                except ServerClosingError as e:
                    last = e
            raise last

        try:
            handle = self._observed(br, _serve)
        except BaseException as e:
            # the submission path itself failed after admission: account it
            self._slo_record(name, slo_cls[0], e)
            raise
        # SLO outcome is decided when the batcher finishes the request —
        # possibly much later, on the decode/watchdog thread
        cls = slo_cls[0]
        handle.set_on_done(lambda r: self._slo_record(name, cls, r.error))
        return handle

    def cancel_generate(self, name: str, handle,
                        cause: str = "client_gone") -> bool:
        """Abandon one streamed generation whose consumer vanished — frees
        its decode slot and KV pages via the batcher's cancel path. Returns
        False when the request already finished (including via a racing
        page-out, which drains in-flight work)."""
        try:
            batcher = self.get(name).batcher()
        except ServeError:
            return False
        return batcher.cancel(handle, cause=cause)

    def generate(self, name: str, prompt, max_new_tokens: int, *,
                 tenant: str = "anonymous", temperature: float = 1.0,
                 top_k: Optional[int] = None, eos_id: Optional[int] = None,
                 timeout_ms: Optional[float] = None, ctx=None) -> np.ndarray:
        """Blocking generate; batch prompts fan out row-per-request like
        :meth:`ContinuousBatcher.generate`."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            return self.submit_generate(
                name, prompt, max_new_tokens, tenant=tenant,
                temperature=temperature, top_k=top_k, eos_id=eos_id,
                timeout_ms=timeout_ms, ctx=ctx).wait()
        handles = [self.submit_generate(
            name, p, max_new_tokens, tenant=tenant, temperature=temperature,
            top_k=top_k, eos_id=eos_id, timeout_ms=timeout_ms)
            for p in prompt]
        outs = [h.wait() for h in handles]
        width = max(o.shape[0] for o in outs)
        pad = eos_id if eos_id is not None else 0
        full = np.full((len(outs), width), pad, np.int32)
        for i, o in enumerate(outs):
            full[i, :o.shape[0]] = o
        return full

    # ----------------------------------------------------------------- admin
    def publish(self, name: str, params, state=None,
                version: Optional[str] = None, drain: bool = True) -> int:
        return self.get(name).publish(params, state=state, version=version,
                                      drain=drain)

    def status(self) -> dict:
        with self._lock:
            entries = dict(self._entries)
            breakers = dict(self._breakers)
        body: Dict[str, Any] = {
            "models": {n: e.info() for n, e in sorted(entries.items())},
            "pager": self.pager.stats(),
            "tenants": self.tenants.stats(),
            "health": self.health.snapshot(),
            "breakers": {n: b.snapshot() for n, b in sorted(breakers.items())},
            "slo": self.slo.snapshot(),
        }
        if self.aot_store is not None:
            body["aot_store"] = self.aot_store.stats()
        return body

    def shutdown(self) -> None:
        """Drain and deactivate every resident model."""
        if self._watchdog is not None:
            # stop the watchdog FIRST: a drain must not be mistaken for a
            # stall and "restarted" mid-teardown
            self._watchdog.stop()
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            self.pager.drop(entry)
