"""HTTP front end — counterpart of ``deeplearning4j_tpu/serve/http.py``:
predict and generate endpoints over the serving engine and the continuous
batcher.

Built on ``utils/httpd.py``, so ``GET /metrics`` (Prometheus) and
per-endpoint request-latency histograms come through the shared
``owner.metrics`` duck-typing. Overload answers are typed (503 shed, 504
deadline, 400 bad request), never a hang; ``/health`` (liveness) and
``/ready`` (readiness) are split; ``stop()`` flips readiness, lets every
admitted request finish, then closes the listener.

Endpoints:

- ``POST /predict``  ``{"ndarray": [[...]], "timeout_ms": 250}``
  -> ``{"output": [[...]], "generation": 3}``
- ``POST /generate`` ``{"prompt": [1,2,3], "max_new_tokens": 16,
  "temperature": 0.8, "top_k": 40, "eos_id": 2}`` — streams by default: a
  Server-Sent-Events body flushed per decoded token (``data: {"token":
  5}`` events, then ``data: {"done": true, "tokens": [...]}``).
  ``?stream=false`` (or ``"stream": false``) gives the buffered answer
  ``{"tokens": [...]}``; batch prompts are always buffered. Admission
  errors arrive before the stream starts as typed status codes; an error
  after streaming began is delivered in-band as a final ``data:
  {"error": ..., "cause": ..., "tokens": [...]}`` event; a client that
  drops the socket has its request cancelled.
- ``GET /health`` · ``GET /ready`` (503 while draining) · ``GET /models``
  · ``GET /metrics`` (OpenMetrics with exemplars on request)
- ``GET /v1/debug/requests`` (the flight recorder's request ring) ·
  ``GET /v1/debug/flight`` (its whole snapshot; 404 without a recorder) ·
  ``GET /v1/debug/profile`` (the dispatch profiler's top executables,
  ``{"enabled": false}`` without one) ·
  ``/v1/debug/chaos`` (GET echo / POST install-or-uninstall fault specs)
  when constructed with ``chaos_admin=True`` — 404 otherwise.

With a request tracer installed (``obs.reqtrace.install``) each POST
begins a trace (joining the caller's ``traceparent``), passes it down as
``ctx=`` and echoes ``X-Request-Id`` and ``traceparent``; POST handlers
carry the ``http.handler`` fault seam.

With ``aot_store=`` the engine's graphs are made at boot (``warm``) and a
strict server (``strict_aot=True``) also builds its generation stack at
boot, so an uncovered signature fails the boot with
:class:`~.errors.AotTraceError`, never a request; ``aot_manifest=`` (a
path or a loaded manifest) refuses to boot unless the store's coverage
record for this runtime covers every signature of the manifest.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..chaos import faults as _faults
from ..obs import flight as _flight
from ..obs import profile as _profile
from ..obs import reqtrace as _rt
from ..obs.metrics import MetricsRegistry
from ..utils.httpd import JsonHTTPServerMixin, JsonRequestHandler
from .continuous import ContinuousBatcher, decode_refusal
from .engine import ServeEngine, example_shape
from .errors import ServeError
from .health import Health
from .registry import ModelRegistry
from .watchdog import Watchdog

log = logging.getLogger(__name__)

_HTTP_ERRORS_HELP = "non-2xx HTTP answers by endpoint and status code"

_BAD_REQUEST = (KeyError, ValueError, TypeError, AttributeError,
                json.JSONDecodeError)

#: Module RNG behind Retry-After jitter, the fallback when a server was
#: built without its own ``jitter_rng``.
_JITTER_RNG = random.Random()


def seed_retry_jitter(seed: int) -> None:
    """Reseed the module-level fallback jitter RNG (process-global); pass
    ``jitter_rng=`` to a server for per-server determinism instead."""
    _JITTER_RNG.seed(int(seed))


def jitter_retry_after(seconds: float, rng=None) -> int:
    """±20% jitter on a Retry-After hint, floored at 1 s, so clients shed
    in the same instant do not all come back on the same second."""
    r = (rng if rng is not None else _JITTER_RNG).random()
    return int(max(1, round(float(seconds) * (0.8 + 0.4 * r))))


def retry_after_s(depth: int, limit: int, rng=None) -> int:
    """Back-off hint for a 503 shed, from queue depth: an idle queue says
    "retry in ~1s", a full one scales up to ~30s."""
    frac = depth / max(int(limit), 1)
    return jitter_retry_after(max(1.0, min(30.0, 1 + 29 * frac)), rng)


def chaos_status() -> dict:
    """JSON echo of the process-global fault plane (GET /v1/debug/chaos)."""
    plane = _faults.ACTIVE
    if plane is None:
        return {"installed": False, "armed": []}
    st = plane.stats()
    return {"installed": True, "armed": st["armed"],
            "injected": st["injected"]}


def chaos_apply(req: dict) -> dict:
    """Apply one ``POST /v1/debug/chaos`` body to the process-global fault
    plane: ``{"uninstall": true}`` removes it (releasing any hung sites);
    ``{"specs": ["point:mode[:k=v,...]", ...], "seed": 0}`` installs a
    plane if none is active and arms each spec on it. A malformed spec
    raises ``ValueError`` (-> HTTP 400) with nothing partially armed."""
    if req.get("uninstall"):
        _faults.uninstall()
        return chaos_status()
    specs = req.get("specs") or []
    if not isinstance(specs, list):
        raise ValueError("'specs' must be a list of fault-spec strings")
    # validate the whole batch before arming any of it
    for s in specs:
        _faults.parse_spec(str(s))
    plane = _faults.ACTIVE
    if plane is None:
        plane = _faults.install(_faults.FaultPlane(
            seed=int(req.get("seed", 0))))
    for s in specs:
        plane.inject_spec(str(s))
    return chaos_status()


class ModelServer(JsonHTTPServerMixin):
    """Serve one model (registry) over HTTP.

    The generation stack (:class:`ContinuousBatcher`) is built lazily on the
    first ``/generate``, so predict-only deployments of non-token models
    never pay for it.
    """

    _ROUTES = frozenset((
        "/predict", "/generate", "/health", "/ready", "/models", "/metrics",
        "/v1/debug/requests", "/v1/debug/flight", "/v1/debug/chaos",
        "/v1/debug/profile"))

    @classmethod
    def _metric_route(cls, path: str) -> str:
        """Collapse unknown paths to one label value (bounded cardinality)."""
        return path if path in cls._ROUTES else "other"

    def __init__(self, model, params=None, state=None, *,
                 host: str = "127.0.0.1", port: int = 9010,
                 registry: Optional[ModelRegistry] = None,
                 engine: Optional[ServeEngine] = None,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 length_buckets: Optional[Sequence[int]] = None,
                 queue_limit: int = 256, max_wait_ms: float = 2.0,
                 default_timeout_ms: Optional[float] = None,
                 input_dtype=np.float32, gen_slots: int = 4,
                 gen_capacity: int = 256, gen_queue_limit: int = 64,
                 gen_kv: str = "paged", gen_block_size: int = 16,
                 gen_kv_blocks: Optional[int] = None,
                 gen_prefix_cache: bool = True,
                 gen_prefix_cache_blocks: Optional[int] = None,
                 gen_prefill_chunk: Optional[int] = 64,
                 seed: int = 0, metrics: Optional[MetricsRegistry] = None,
                 aot_store=None, strict_aot: bool = False,
                 aot_manifest=None, watchdog_s: Optional[float] = None,
                 chaos_admin: bool = False, jitter_rng=None):
        self.model = model
        self.jitter_rng = jitter_rng
        # debug-only surface: /v1/debug/chaos answers 404 unless opted in,
        # so a production front door never exposes fault injection
        self.chaos_admin = bool(chaos_admin)
        self.host = host
        self.port = port
        self.input_dtype = input_dtype
        self.aot_store = aot_store
        self.strict_aot = bool(strict_aot)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if self.strict_aot and aot_store is None:
            raise ValueError("strict_aot=True requires an aot_store")
        if aot_manifest is not None:
            # boot-time coverage gate: the store must hold a prebuild
            # coverage record for (this runtime, this manifest) with every
            # key still present, BEFORE any stack is built
            from ..aot import load_manifest, missing_signatures
            from ..aot.keys import runtime_fingerprint
            from .errors import AotTraceError

            if aot_store is None:
                raise ValueError("aot_manifest requires an aot_store")
            manifest = (aot_manifest if isinstance(aot_manifest, dict)
                        else load_manifest(aot_manifest))
            missing = missing_signatures(aot_store, manifest,
                                         runtime_fingerprint(model.device))
            if missing:
                head = "; ".join(missing[:4])
                raise AotTraceError(
                    f"AOT store does not cover prebuild manifest "
                    f"{manifest.get('hash')}: {len(missing)} obligation(s) "
                    f"unmet — {head}")
        if registry is None:
            registry = (engine.registry if engine is not None else
                        ModelRegistry(
                            params if params is not None else model.params,
                            state if state is not None else model.state,
                            metrics=self.metrics))
        self.registry = registry
        self.engine = engine if engine is not None else ServeEngine(
            model, registry=registry, batch_buckets=batch_buckets,
            length_buckets=length_buckets, queue_limit=queue_limit,
            max_wait_ms=max_wait_ms, default_timeout_ms=default_timeout_ms,
            metrics=self.metrics, aot_store=aot_store,
            strict_aot=self.strict_aot)
        if engine is None and aot_store is not None:
            # make the predict graphs now (store hit, or captured once and
            # recorded): the first request never waits on a capture.
            # Strict: an uncovered signature raises AotTraceError HERE
            self.engine.warm(input_dtype)
        self._gen_opts = dict(slots=gen_slots, capacity=gen_capacity,
                              queue_limit=gen_queue_limit, kv=gen_kv,
                              block_size=gen_block_size,
                              kv_blocks=gen_kv_blocks,
                              prefix_cache=gen_prefix_cache,
                              prefix_cache_blocks=gen_prefix_cache_blocks,
                              prefill_chunk=gen_prefill_chunk, seed=seed,
                              aot_store=aot_store,
                              strict_aot=self.strict_aot)
        if gen_kv == "dense":
            # the dense batcher takes no paging knobs
            for k in ("block_size", "kv_blocks", "prefill_chunk",
                      "prefix_cache", "prefix_cache_blocks"):
                self._gen_opts.pop(k)
        self._batcher: Optional[ContinuousBatcher] = None
        self._lifecycle_lock = threading.Lock()
        self._accepting = True
        if self.strict_aot:
            # strict boots verify the WHOLE surface up front: build the
            # generation stack now so its warm-at-construction raises
            # AotTraceError at boot on any uncovered signature (and a bad
            # generation knob its ValueError); a model the batcher cannot
            # decode is a predict-only deployment
            if decode_refusal(model) is None:
                self.batcher()
        # components (watchdog) degrade/clear causes as they heal
        self.health = Health(metrics=self.metrics, component="serve")
        # opt-in: a heartbeat deadline must be chosen against the
        # deployment's worst legitimate device-batch time
        self._watchdog: Optional[Watchdog] = None
        if watchdog_s is not None:
            self._watchdog = Watchdog(
                self._watch_components, deadline_s=watchdog_s,
                metrics=self.metrics, health=self.health).start()

    def _watch_components(self):
        out = [("engine", self.engine)]
        with self._lifecycle_lock:
            if self._batcher is not None:
                out.append(("batcher", self._batcher))
        return out

    # --- lazy generation stack ---
    def batcher(self) -> ContinuousBatcher:
        with self._lifecycle_lock:
            if self._batcher is None:
                self._batcher = ContinuousBatcher(
                    self.model, registry=self.registry, metrics=self.metrics,
                    **self._gen_opts)
            return self._batcher

    # --- hot-swap convenience (in-process admin surface) ---
    def publish(self, params, state=None, version: Optional[str] = None,
                drain: bool = True):
        """Publish new weights; by default waits for in-flight batches on
        the old generation to retire."""
        return self.registry.publish(params, state=state, version=version,
                                     drain=drain)

    def rollback(self, drain: bool = True):
        return self.registry.rollback(drain=drain)

    def ready(self) -> bool:
        with self._lifecycle_lock:
            accepting = self._accepting
        # readiness flips off while a worker restart is in progress — the
        # balancer routes around us while we heal
        return accepting and self.health.ok()

    def _retry_after(self) -> int:
        """Retry-After seconds for shed answers, scaled by how backed up
        the predict queue and (if built) the generation queue are."""
        depth, limit = self.engine.queue_depth(), self.engine.queue_limit
        with self._lifecycle_lock:
            batcher = self._batcher
        if batcher is not None:
            depth += batcher.queue_depth()
            limit += batcher.queue_limit
        return retry_after_s(depth, limit, self.jitter_rng)

    # --- handler ---
    def _handler(self):
        server = self

        class Handler(JsonRequestHandler):
            owner = server

            def _err(self, code, body, headers=None):
                route = server._metric_route(urlsplit(self.path).path)
                server.metrics.counter(
                    "serve_http_errors_total",
                    {"endpoint": route, "code": str(code)},
                    help=_HTTP_ERRORS_HELP).inc()
                self.reply(code, body, headers=headers)

            def reply(self, code, payload, ctype="application/json",
                      headers=None):
                # traced requests echo their identity on every answer and
                # time the buffered write-out as the "flush" stage
                ctx = getattr(self, "_obs_ctx", None)
                if ctx is None:
                    super().reply(code, payload, ctype, headers)
                    return
                headers = dict(headers or {})
                headers.setdefault("X-Request-Id", ctx.request_id)
                headers.setdefault("traceparent", ctx.traceparent())
                with ctx.stage("flush", code=code):
                    super().reply(code, payload, ctype, headers)

            def do_GET(self):
                if self.path == "/health":
                    # liveness: 200 while ok OR degraded; 503 only when
                    # failed (the orchestrator should replace the process)
                    snap = server.health.snapshot()
                    snap["model"] = type(server.model).__name__
                    snap["generation"] = server.registry.generation
                    if snap["status"] != "failed":
                        self.reply(200, snap)
                    else:
                        self._err(503, snap)
                elif self.path == "/ready":
                    if server.ready():
                        self.reply(200, {"status": "ready"})
                    else:
                        self._err(503, {"status": "not_ready",
                                        "health": server.health.snapshot()})
                elif self.path == "/models":
                    cur = server.registry.current()
                    body = {
                        "generation": cur.generation, "version": cur.version,
                        "history": [{"generation": g, "version": v}
                                    for g, v in server.registry.history()]}
                    # KV sharing picture (paged batcher, once built)
                    with server._lifecycle_lock:
                        b = server._batcher
                    if b is not None and b.kv == "paged":
                        body["kv"] = b.kv_block_stats()
                    self.reply(200, body)
                elif self.path == "/v1/debug/requests":
                    recs = (_flight.ACTIVE.requests()
                            if _flight.ACTIVE is not None else [])
                    self.reply(200, {"requests": recs})
                elif self.path == "/v1/debug/flight":
                    if _flight.ACTIVE is None:
                        self._err(404,
                                  {"error": "flight recorder not installed"})
                    else:
                        self.reply(200, _flight.ACTIVE.snapshot())
                elif self.path == "/v1/debug/profile":
                    # the dispatch profiler's top executables;
                    # {"enabled": false} when none is installed
                    self.reply(200, _profile.debug_payload())
                elif self.path == "/v1/debug/chaos" and server.chaos_admin:
                    self.reply(200, chaos_status())
                else:
                    self._err(404, {"error": "unknown endpoint"})

            def do_POST(self):
                split = urlsplit(self.path)
                ctx = None
                if _rt.ACTIVE is not None:
                    # ingress: join the caller's W3C trace (or start one),
                    # echo X-Request-Id; a malformed traceparent yields a
                    # fresh trace, never a failed request
                    ctx = _rt.ACTIVE.begin(
                        split.path.lstrip("/") or "post",
                        traceparent=self.headers.get("traceparent"),
                        request_id=self.headers.get("X-Request-Id"),
                        model=type(server.model).__name__)
                    self._obs_ctx = ctx
                    self._obs_trace_id = ctx.trace_id
                try:
                    if split.path == "/v1/debug/chaos" and server.chaos_admin:
                        # admin surface stays usable even with a fault
                        # armed at http.handler — it is how you disarm one
                        self.reply(200, chaos_apply(self.read_json()))
                        return
                    if _faults.ACTIVE is not None:
                        _faults.ACTIVE.hit("http.handler")
                    req = self.read_json()
                    if split.path == "/predict":
                        self._predict(req)
                    elif split.path == "/generate":
                        self._generate(req, parse_qs(split.query))
                    else:
                        self._err(404, {"error": "unknown endpoint"})
                        if ctx is not None:
                            ctx.finish(error="bad_request")
                except ServeError as e:
                    headers = None
                    if e.http_status == 503:
                        retry = getattr(e, "retry_after_s", None)
                        headers = {"Retry-After":
                                   jitter_retry_after(retry,
                                                      server.jitter_rng)
                                   if retry is not None
                                   else server._retry_after()}
                    self._err(e.http_status,
                              {"error": str(e), "cause": e.cause},
                              headers=headers)
                    if ctx is not None:
                        ctx.finish(error=e.cause)
                except _BAD_REQUEST as e:
                    self._err(400, {"error": str(e)})
                    if ctx is not None:
                        ctx.finish(error="bad_request")
                except (BrokenPipeError, ConnectionResetError):
                    # the client hung up while we were answering: shed
                    # load, not a server error
                    server.metrics.counter(
                        "serve_shed_total", {"cause": "client_gone"},
                        help="requests refused at admission, by cause").inc()
                    if ctx is not None:
                        ctx.finish(error="client_gone")
                except Exception as e:  # the server must answer every request
                    # unexpected == a bug: keep the full traceback (the
                    # client sees the summary) and count the 5xx
                    log.exception("unhandled error serving %s", self.path)
                    self._err(500, {"error": f"{type(e).__name__}: {e}"})
                    if ctx is not None:
                        ctx.finish(error="internal")
                finally:
                    if ctx is not None:
                        ctx.finish()  # idempotent: no-op after an error path

            def _predict(self, req):
                ctx = getattr(self, "_obs_ctx", None)
                x = np.asarray(req["ndarray"], server.input_dtype)
                handle = None
                if x.ndim > len(example_shape(server.model)) \
                        and x.shape[0] <= server.engine.batch_buckets[-1]:
                    if ctx is None:
                        handle = server.engine.submit(
                            x, timeout_ms=req.get("timeout_ms"))
                    else:
                        with ctx.stage("admit"):
                            handle = server.engine.submit(
                                x, timeout_ms=req.get("timeout_ms"), ctx=ctx)
                    y = handle.wait()
                else:
                    y = server.engine.predict(
                        x, timeout_ms=req.get("timeout_ms"), ctx=ctx)
                body = {"output": np.asarray(y).tolist()}
                if handle is not None and handle.generation is not None:
                    body["generation"] = handle.generation
                self.reply(200, body)

            def _sse(self, payload):
                self.wfile.write(
                    b"data: " + json.dumps(payload).encode() + b"\n\n")
                self.wfile.flush()  # one event per decoded token

            def _generate(self, req, query):
                ctx = getattr(self, "_obs_ctx", None)
                prompt = np.asarray(req["prompt"], np.int32)
                kwargs = dict(
                    temperature=float(req.get("temperature", 1.0)),
                    top_k=req.get("top_k"), eos_id=req.get("eos_id"),
                    timeout_ms=req.get("timeout_ms"))
                mnt = int(req.get("max_new_tokens", 16))
                stream = (query.get("stream", ["true"])[0].lower()
                          not in ("false", "0", "no"))
                if req.get("stream") is False:
                    stream = False
                if prompt.ndim != 1:  # batch prompts are always buffered
                    stream = False
                if not stream:
                    toks = server.batcher().generate(prompt, mnt, ctx=ctx,
                                                     **kwargs)
                    self.reply(200, {"tokens": np.asarray(toks).tolist()})
                    return
                # submit BEFORE the stream starts: admission failures
                # surface as typed status codes via do_POST; after the
                # headers, errors go in-band
                if ctx is None:
                    handle = server.batcher().submit(prompt, mnt, **kwargs)
                else:
                    with ctx.stage("admit"):
                        handle = server.batcher().submit(prompt, mnt,
                                                         ctx=ctx, **kwargs)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                if ctx is not None:
                    self.send_header("X-Request-Id", ctx.request_id)
                    self.send_header("traceparent", ctx.traceparent())
                self.end_headers()
                self.close_connection = True
                t0f = time.perf_counter_ns() if ctx is not None else 0
                out = []
                err_cause = None
                try:
                    for tok in handle.stream():
                        out.append(int(tok))
                        self._sse({"token": int(tok)})
                    self._sse({"done": True, "tokens": out})
                except ServeError as e:
                    # mid-stream failure: partial output + the typed cause
                    try:
                        self._sse({"error": str(e), "cause": e.cause,
                                   "tokens": out})
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # nobody left to tell
                    err_cause = e.cause
                except (BrokenPipeError, ConnectionResetError):
                    # the client dropped the socket mid-stream: free the
                    # decode slot and KV pages now (counted as
                    # cause="client_gone"), never a 5xx
                    server.batcher().cancel(handle)
                    err_cause = "client_gone"
                if ctx is not None:
                    # the streaming window: first header flush to last event
                    ctx.add_stage("flush", t0f, time.perf_counter_ns(),
                                  tokens=len(out))
                    if err_cause is not None:
                        ctx.finish(error=err_cause)

        return Handler

    # --- lifecycle ---
    def stop(self, drain: bool = True):
        """Graceful by default: readiness flips first (load balancers stop
        routing), admitted work completes, then the listener closes."""
        with self._lifecycle_lock:
            self._accepting = False
            batcher = self._batcher
        if self._watchdog is not None:
            self._watchdog.stop()
        self.engine.shutdown(drain=drain)
        if batcher is not None:
            batcher.shutdown(drain=drain)
        super().stop()
