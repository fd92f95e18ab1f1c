"""Versioned model registry with atomic hot-swap and in-flight draining —
counterpart of ``deeplearning4j_tpu/serve/registry.py``.

Publication is a *generation*: an immutable :class:`ModelSnapshot` swapped
atomically, with lease accounting so a swap can wait until every batch
dispatched against an older generation has retired. The serving engine
takes one lease per device batch, so no batch ever mixes two params
generations. Published params are never written in place by the port, so
an in-flight batch holding generation N is untouched by publishing N+1.
(The reference's donated-buffer check has no counterpart here: PyTorch
does not donate a caller's tensors.) Publication is two-phase, as in the
reference: the registered warmers run against the candidate before the
flip (:meth:`ModelRegistry.add_warmer`), and a warmer that raises aborts
the publish with a typed :class:`~.errors.PublishError`; each warmer's
abort hook then drops what the warmers made for the candidate, whose
generation number the next publish takes again.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from .errors import PublishError, ServerClosingError


class ModelSnapshot(NamedTuple):
    """One immutable published version. ``generation`` is monotonic across
    publish AND rollback (a rollback re-publishes old params under a new
    generation, so "which params ran this batch" is always a total order)."""

    generation: int
    version: str
    params: Any
    state: Any


class ModelRegistry:
    """Thread-safe versioned params/state store.

    - :meth:`current` / :meth:`lease` — readers. A lease pins the snapshot
      for the duration of one unit of device work and is counted per
      generation.
    - :meth:`publish` / :meth:`rollback` — writers. Atomic swap; with
      ``drain=True`` the call additionally blocks until all leases on
      *older* generations are returned (in-flight work finished).

    ``keep`` bounds the rollback history (oldest snapshots are dropped).
    """

    def __init__(self, params, state=None, version: str = "v0",
                 keep: int = 8, metrics=None, model: Optional[str] = None,
                 start_generation: int = 1):
        if params is None:
            raise ValueError("registry needs initialized params")
        self._cond = threading.Condition()
        self._inflight: Dict[int, int] = {}
        # thread ident -> lease tokens it holds; lets release_thread()
        # reclaim leases pinned by a hung/dead worker so hot-swap drain
        # cannot deadlock on a thread that will never run its finally
        self._thread_leases: Dict[int, List[dict]] = {}
        self._history: List[ModelSnapshot] = []
        self._publish_lock = threading.Lock()  # serializes publish/rollback
        # (warmer, abort hook or None), in registration order
        self._warmers: List[Tuple[Callable[[ModelSnapshot], None],
                                  Optional[Callable[[ModelSnapshot],
                                                    None]]]] = []
        self._metrics = metrics
        # name the model on every registry metric when given, so one scrape
        # disaggregates per model; None emits unlabelled series
        self.model = model
        # a paged-out model resumes from where its last residency ended
        # (the fleet passes start_generation) so "which params ran this
        # batch" stays a total order across page-out/page-in cycles
        start = max(int(start_generation), 1)
        snap = ModelSnapshot(start, version,
                             params, state if state is not None else {})
        self._keep = max(int(keep), 1)
        with self._cond:
            self._history.append(snap)
        self._gauge_generation(snap.generation)

    def _head_locked(self) -> ModelSnapshot:
        if not self._history:
            raise ServerClosingError("model registry is closed")
        return self._history[-1]

    # --- readers ---
    def current(self) -> ModelSnapshot:
        with self._cond:
            return self._head_locked()

    @property
    def generation(self) -> int:
        return self.current().generation

    @contextmanager
    def lease(self, tag: Optional[str] = None):
        """Pin the current snapshot for one unit of device work.

        ``tag`` names the caller for accounting (``serve_lease_total{tag}``):
        the engine leases per device batch, the continuous batcher per
        decode tick (``gen_decode``) and per prefill *chunk*
        (``gen_prefill``) — so a drain during a long chunked prefill waits
        only for the current chunk, not the whole prompt."""
        ident = threading.get_ident()
        with self._cond:
            snap = self._head_locked()
            self._inflight[snap.generation] = \
                self._inflight.get(snap.generation, 0) + 1
            token = {"gen": snap.generation, "released": False}
            self._thread_leases.setdefault(ident, []).append(token)
        if tag is not None and self._metrics is not None:
            self._metrics.counter("serve_lease_total",
                                  self._labels({"tag": tag}),
                                  help="registry leases taken, by caller tag"
                                  ).inc()
        try:
            yield snap
        finally:
            with self._cond:
                self._release_token_locked(ident, token)

    def _release_token_locked(self, ident: int, token: dict) -> None:
        # idempotent: a lease reclaimed by release_thread() must not be
        # double-decremented when the stalled thread eventually wakes and
        # runs its own finally
        if token["released"]:
            return
        token["released"] = True
        toks = self._thread_leases.get(ident)
        if toks is not None:
            try:
                toks.remove(token)
            except ValueError:
                pass
            if not toks:
                self._thread_leases.pop(ident, None)
        gen = token["gen"]
        n = self._inflight.get(gen, 0) - 1
        if n <= 0:
            self._inflight.pop(gen, None)
        else:
            self._inflight[gen] = n
        self._cond.notify_all()

    def release_thread(self, ident: Optional[int]) -> int:
        """Reclaim every lease held by an abandoned worker thread.

        A hung/dead dispatcher can never run its lease ``finally``; until
        its leases are returned, :meth:`drain` (and therefore hot-swap
        publish) would wait forever. The watchdog's crash-only restart and
        forced shutdown call this with the old thread's ident AFTER the
        thread has been staled, so the registry's lease state is correct
        for the replacement worker. Returns the number reclaimed."""
        if ident is None:
            return 0
        released = 0
        with self._cond:
            for token in list(self._thread_leases.get(ident, ())):
                self._release_token_locked(ident, token)
                released += 1
        if released and self._metrics is not None:
            self._metrics.counter(
                "serve_lease_reclaimed_total", self._labels(),
                help="leases reclaimed from dead/hung worker threads"
                ).inc(released)
        return released

    def inflight(self) -> Dict[int, int]:
        """Outstanding lease counts by generation (diagnostic)."""
        with self._cond:
            return dict(self._inflight)

    # --- writers ---
    def add_warmer(self, fn: Callable[[ModelSnapshot], None],
                   abort: Optional[Callable[[ModelSnapshot], None]] = None
                   ) -> None:
        """Register a pre-flip hook ``fn(candidate)``.

        Every warmer runs inside :meth:`publish` BEFORE the generation
        flips, against the candidate :class:`ModelSnapshot` (its
        generation, version, params and state: the port's serving graphs
        are kept per generation, where the reference's hooks take
        ``(params, state)``). The serving tiers register hooks that
        capture the candidate's graphs, so the first batch on a new
        generation never captures. A warmer that raises aborts the publish
        with a typed :class:`~.errors.PublishError` and the old generation
        keeps serving untouched: every registered ``abort(candidate)``
        then runs (the warmers that succeeded and the one that raised
        alike), so that nothing made for the failed candidate outlives
        it. The next publish reuses the candidate's generation number,
        so a graph left behind would replay the failed candidate's
        weights. The port's addition, for graphs that bake in weights:
        the reference's executables take the params as arguments."""
        with self._cond:
            self._warmers.append((fn, abort))

    def publish(self, params, state=None, version: Optional[str] = None,
                drain: bool = False, timeout: Optional[float] = None
                ) -> ModelSnapshot:
        """Atomically publish a new generation; optionally wait for work
        dispatched against older generations to retire.

        Publication is two-phase: (1) every registered warmer runs against
        the candidate, (2) the atomic history append. Phase 1 failing
        raises :class:`~.errors.PublishError` with registry state
        untouched."""
        if params is None:
            raise ValueError("cannot publish params=None")
        with self._publish_lock:
            with self._cond:
                # the publish lock pins history[-1]: no concurrent publish
                # can move it while the warmers run
                prev = self._head_locked()
                gen = prev.generation + 1
                snap = ModelSnapshot(
                    gen, version if version is not None else f"v{gen - 1}",
                    params, state if state is not None else prev.state)
                warmers = list(self._warmers)
            try:
                for warm, _ in warmers:
                    warm(snap)
            except Exception as e:  # ANY warm failure must leave the old generation serving
                self._count("serve_model_publish_failures_total",
                            "publishes aborted before the flip")
                for _, abort in warmers:
                    if abort is not None:
                        abort(snap)
                raise PublishError(
                    f"candidate generation failed precompile/warm — old "
                    f"generation keeps serving ({type(e).__name__}: {e})"
                    ) from e
            with self._cond:
                self._head_locked()
                self._history.append(snap)
                del self._history[:-self._keep]
        self._gauge_generation(snap.generation)
        self._count("serve_model_publishes_total",
                    "model generations published (hot-swap)")
        if drain:
            self.drain(timeout=timeout)
        return snap

    def rollback(self, drain: bool = False,
                 timeout: Optional[float] = None) -> ModelSnapshot:
        """Re-publish the previous version under a fresh generation."""
        with self._cond:
            if len(self._history) < 2:
                raise ValueError("nothing to roll back to")
            prev = self._history[-2]
        self._count("serve_model_rollbacks_total", "model rollbacks")
        return self.publish(prev.params, state=prev.state,
                            version=prev.version, drain=drain, timeout=timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no lease is held on a non-current generation.

        Returns False on timeout. New leases (current generation) are not
        blocked — drain is about retiring the *old* generation, not pausing
        the server.
        """
        with self._cond:
            def stale():
                if not self._history:  # closed: nothing left to retire
                    return []
                cur = self._history[-1].generation
                return [g for g in self._inflight if g != cur]

            return self._cond.wait_for(lambda: not stale(), timeout=timeout)

    def close(self) -> None:
        """Drop every snapshot, so that nothing reached through this
        registry (a stale engine or batcher, a caller still holding one)
        keeps params alive: a fleet page-out calls it once the engine and
        batcher leasing from it have drained. Readers and writers then
        raise :class:`~.errors.ServerClosingError`. The port's own
        addition: the reference frees device arrays by reference count
        alone."""
        with self._cond:
            self._history.clear()
            self._cond.notify_all()

    def history(self) -> List[Tuple[int, str]]:
        with self._cond:
            return [(s.generation, s.version) for s in self._history]

    # --- metrics plumbing (no-op when the registry has no MetricsRegistry) ---
    def _labels(self, labels: Optional[Dict[str, str]] = None
                ) -> Dict[str, str]:
        out = dict(labels or {})
        if self.model is not None:
            out["model"] = self.model
        return out

    def _gauge_generation(self, gen: int) -> None:
        if self._metrics is not None:
            self._metrics.gauge("serve_model_generation", self._labels(),
                                help="currently published model generation"
                                ).set(gen)

    def _count(self, name: str, help_: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(name, self._labels(), help=help_).inc()
