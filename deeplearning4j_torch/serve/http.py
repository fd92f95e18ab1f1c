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
  · ``GET /metrics``

Not ported yet: the ``/v1/debug/*`` surface (answers 404), the chaos
admin plane (``chaos_admin=True``; ROADMAP.md, Queue 1, items 12 and 15),
request traces (item 15) and the prebuilt-executable store (``aot_*``;
item 13).
"""

from __future__ import annotations

import json
import logging
import random
import threading
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..obs.metrics import MetricsRegistry
from ..utils.httpd import JsonHTTPServerMixin, JsonRequestHandler
from .continuous import ContinuousBatcher
from .engine import ServeEngine
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


class ModelServer(JsonHTTPServerMixin):
    """Serve one model (registry) over HTTP.

    The generation stack (:class:`ContinuousBatcher`) is built lazily on the
    first ``/generate``, so predict-only deployments of non-token models
    never pay for it.
    """

    _ROUTES = frozenset(("/predict", "/generate", "/health", "/ready",
                         "/models", "/metrics"))

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
        if aot_store is not None or strict_aot or aot_manifest is not None:
            raise NotImplementedError(
                "the prebuilt-executable store is not ported yet "
                "(ROADMAP.md, Queue 1, item 13)")
        if chaos_admin:
            raise NotImplementedError(
                "the chaos admin plane is not ported yet (ROADMAP.md, "
                "Queue 1, items 12 and 15)")
        self.model = model
        self.jitter_rng = jitter_rng
        self.host = host
        self.port = port
        self.input_dtype = input_dtype
        self.metrics = metrics if metrics is not None else MetricsRegistry()
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
            metrics=self.metrics)
        self._gen_opts = dict(slots=gen_slots, capacity=gen_capacity,
                              queue_limit=gen_queue_limit, kv=gen_kv,
                              block_size=gen_block_size,
                              kv_blocks=gen_kv_blocks,
                              prefix_cache=gen_prefix_cache,
                              prefix_cache_blocks=gen_prefix_cache_blocks,
                              prefill_chunk=gen_prefill_chunk, seed=seed)
        if gen_kv == "dense":
            # the dense batcher takes no paging knobs
            for k in ("block_size", "kv_blocks", "prefill_chunk",
                      "prefix_cache", "prefix_cache_blocks"):
                self._gen_opts.pop(k)
        self._batcher: Optional[ContinuousBatcher] = None
        self._lifecycle_lock = threading.Lock()
        self._accepting = True
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
                else:
                    self._err(404, {"error": "unknown endpoint"})

            def do_POST(self):
                split = urlsplit(self.path)
                try:
                    req = self.read_json()
                    if split.path == "/predict":
                        self._predict(req)
                    elif split.path == "/generate":
                        self._generate(req, parse_qs(split.query))
                    else:
                        self._err(404, {"error": "unknown endpoint"})
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
                except _BAD_REQUEST as e:
                    self._err(400, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    # the client hung up while we were answering: shed
                    # load, not a server error
                    server.metrics.counter(
                        "serve_shed_total", {"cause": "client_gone"},
                        help="requests refused at admission, by cause").inc()
                except Exception as e:  # the server must answer every request
                    # unexpected == a bug: keep the full traceback (the
                    # client sees the summary) and count the 5xx
                    log.exception("unhandled error serving %s", self.path)
                    self._err(500, {"error": f"{type(e).__name__}: {e}"})

            def _predict(self, req):
                x = np.asarray(req["ndarray"], server.input_dtype)
                handle = None
                if x.ndim > len(server.model.input_shape) \
                        and x.shape[0] <= server.engine.batch_buckets[-1]:
                    handle = server.engine.submit(
                        x, timeout_ms=req.get("timeout_ms"))
                    y = handle.wait()
                else:
                    y = server.engine.predict(
                        x, timeout_ms=req.get("timeout_ms"))
                body = {"output": np.asarray(y).tolist()}
                if handle is not None and handle.generation is not None:
                    body["generation"] = handle.generation
                self.reply(200, body)

            def _sse(self, payload):
                self.wfile.write(
                    b"data: " + json.dumps(payload).encode() + b"\n\n")
                self.wfile.flush()  # one event per decoded token

            def _generate(self, req, query):
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
                    toks = server.batcher().generate(prompt, mnt, **kwargs)
                    self.reply(200, {"tokens": np.asarray(toks).tolist()})
                    return
                # submit BEFORE the stream starts: admission failures
                # surface as typed status codes via do_POST; after the
                # headers, errors go in-band
                handle = server.batcher().submit(prompt, mnt, **kwargs)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                out = []
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
                except (BrokenPipeError, ConnectionResetError):
                    # the client dropped the socket mid-stream: free the
                    # decode slot and KV pages now (counted as
                    # cause="client_gone"), never a 5xx
                    server.batcher().cancel(handle)

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
