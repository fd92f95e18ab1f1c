"""Fleet HTTP front door — routed, tenant-aware serving over a
:class:`~.registry.FleetRegistry`; counterpart of
``deeplearning4j_tpu/fleet/http.py``.

One listener multiplexes every model in the fleet:

- ``POST /v1/models/{name}/predict``  — body as ``ModelServer /predict``;
  answers ``{"output": ..., "generation": N, "model": name}``.
- ``POST /v1/models/{name}/generate`` — body as ``ModelServer /generate``;
  **streams SSE by default** for 1-D prompts, ``?stream=false`` (or batch
  prompts) buffers.
- ``GET /v1/models`` (names + residency) · ``GET /v1/models/{name}``
  (one entry) · ``GET /v1/fleet`` (models + pager + tenants + health +
  breakers + SLO burn) · ``GET /health`` · ``GET /ready`` · ``GET
  /metrics`` (OpenMetrics with exemplars on request) · ``GET /v1/metrics``
  (the registry's JSON snapshot, exemplars included).
- ``GET /v1/debug/requests`` · ``GET /v1/debug/flight`` (404 without a
  flight recorder) · ``GET /v1/debug/profile`` (the dispatch profiler's
  top executables; ``{"enabled": false}`` without one).
- ``GET /v1/replica`` — the cluster heartbeat self-report (identity,
  residency, HBM budget, queue depth); ``POST /v1/admin/drain``
  ``{"model": name}`` pages a model out on router demotion.
- ``/v1/debug/chaos`` (GET echo / POST install-or-uninstall fault specs)
  when constructed with ``chaos_admin=True`` — 404 otherwise.

The tenant rides the ``X-Tenant`` header (default ``"anonymous"``, which
gets the table's default policy — the front door never 500s on a new
tenant). Typed failures map to their HTTP status; back-pressure answers
carry ``Retry-After``: a 429 quota shed uses the tenant bucket's own
refill estimate, a 503 queue shed scales with the target model's queue
depth (:func:`~..serve.http.retry_after_s`).

``/metrics`` label cardinality stays bounded: ``_metric_route`` collapses
``/v1/models/<anything>/predict`` to ``/v1/models/{name}/predict`` for
the shared per-endpoint latency histograms (model disaggregation lives on
the ``model=`` label of the serving metrics, not the endpoint label).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from typing import Optional

import numpy as np

from ..chaos import faults as _faults
from ..obs import flight as _flight
from ..obs import profile as _profile
from ..obs import reqtrace as _rt
from ..serve.errors import ServeError
from ..serve.http import (chaos_apply, chaos_status, jitter_retry_after,
                          retry_after_s)
from ..utils.httpd import JsonHTTPServerMixin, JsonRequestHandler
from .registry import FleetRegistry
from .tenants import QuotaError

log = logging.getLogger(__name__)

_BAD_REQUEST = (KeyError, ValueError, TypeError, AttributeError,
                json.JSONDecodeError)
_MODEL_ROUTE = re.compile(r"^/v1/models/([^/]+)(?:/(predict|generate))?$")
_HTTP_ERRORS_HELP = "non-2xx HTTP answers by endpoint and status code"


class FleetServer(JsonHTTPServerMixin):
    """Serve a whole :class:`FleetRegistry` over one HTTP listener."""

    def __init__(self, fleet: FleetRegistry, *, host: str = "127.0.0.1",
                 port: int = 9020, replica_id: Optional[str] = None,
                 chaos_admin: bool = False, jitter_rng=None):
        self.fleet = fleet
        # injectable Retry-After jitter source (None = process-global RNG);
        # replays pass random.Random(seed) for bit-deterministic backoff
        self.jitter_rng = jitter_rng
        self.host = host
        self.port = port
        # cluster identity: who this process is in a replica set. The id
        # rides on every /v1/replica heartbeat answer so the router's
        # membership table and placement speak one namespace.
        self.replica_id = replica_id
        # debug-only surface: /v1/debug/chaos answers 404 unless opted in,
        # so a production front door never exposes fault injection
        self.chaos_admin = bool(chaos_admin)
        self.metrics = fleet.metrics  # httpd scaffolding serves /metrics
        self._lifecycle_lock = threading.Lock()
        self._accepting = True

    def accepting(self) -> bool:
        with self._lifecycle_lock:
            return self._accepting

    def ready(self) -> bool:
        # readiness (load-balancer rotation) flips on ANY degradation —
        # breaker open, watchdog restart in progress — but a degraded
        # server still ANSWERS requests: accepting() gates the handlers
        return self.accepting() and self.fleet.health.ok()

    def beat(self) -> dict:
        """One cluster-heartbeat self-report: identity, readiness, model
        residency, HBM budget, and queued load. The router's membership
        table polls this (``GET /v1/replica``) and feeds placement."""
        pager = self.fleet.pager.stats()
        return {
            "replica": self.replica_id,
            "accepting": self.accepting(),
            "ready": self.ready(),
            "models": {n: self.fleet.get(n).info()
                       for n in self.fleet.names()},
            "hbm_budget_bytes": pager.get("budget_bytes"),
            "resident_bytes": pager.get("resident_bytes"),
            "queue_depth": self.fleet.queue_depth(),
            "kv_utilization": self.fleet.kv_pressure(),
        }

    def _metric_route(self, path: str) -> str:
        m = _MODEL_ROUTE.match(path)
        if m:
            verb = f"/{m.group(2)}" if m.group(2) else ""
            return f"/v1/models/{{name}}{verb}"
        return path

    def _retry_after(self, name: Optional[str]) -> int:
        """503 back-off derived from the shedding model's queue depth; a
        non-resident or unknown model reads as an idle queue (1s)."""
        depth = limit = 0
        try:
            entry = self.fleet.get(name) if name else None
        except ServeError:
            entry = None
        if entry is not None:
            try:
                eng = entry.engine()
                depth, limit = eng.queue_depth(), eng.queue_limit
            except ServeError:
                pass
        return retry_after_s(depth, limit, self.jitter_rng)

    # ------------------------------------------------------------- handler
    def _handler(self):
        server = self

        class Handler(JsonRequestHandler):
            owner = server

            def _tenant(self) -> str:
                return self.headers.get("X-Tenant", "anonymous")

            def _err(self, code, body, headers=None):
                """Non-2xx answer, counted per (endpoint, code) with the
                model name collapsed out of the endpoint label."""
                endpoint = server._metric_route(self.path.split("?", 1)[0])
                server.metrics.counter(
                    "serve_http_errors_total",
                    {"endpoint": endpoint, "code": str(code)},
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
                path = self.path.split("?", 1)[0]
                if path == "/health":
                    # liveness + worst-case state machine: failed (watchdog
                    # gave up restarting) answers 503 so an orchestrator
                    # replaces the process; degraded stays 200 — still alive
                    snap = server.fleet.health.snapshot()
                    snap["models"] = server.fleet.names()
                    code = 200 if snap["status"] != "failed" else 503
                    if code == 200:
                        self.reply(code, snap)
                    else:
                        self._err(code, snap)
                elif path == "/ready":
                    if server.ready():
                        self.reply(200, {"status": "ready"})
                    else:
                        self._err(503, {
                            "status": "not_ready",
                            "health": server.fleet.health.snapshot()})
                elif path == "/v1/replica":
                    self.reply(200, server.beat())
                elif path == "/v1/metrics":
                    # structured registry snapshot for the federated
                    # scraper — JSON keeps the histogram quantile tracks
                    # the Prometheus text exposition cannot carry
                    self.reply(200, server.metrics.snapshot())
                elif path == "/v1/debug/chaos" and server.chaos_admin:
                    self.reply(200, chaos_status())
                elif path == "/v1/fleet":
                    self.reply(200, server.fleet.status())
                elif path == "/v1/models":
                    status = server.fleet.status()
                    self.reply(200, {"models": status["models"]})
                elif path == "/v1/debug/requests":
                    recs = (_flight.ACTIVE.requests()
                            if _flight.ACTIVE is not None else [])
                    self.reply(200, {"requests": recs})
                elif path == "/v1/debug/flight":
                    if _flight.ACTIVE is None:
                        self._err(404,
                                  {"error": "flight recorder not installed"})
                    else:
                        self.reply(200, _flight.ACTIVE.snapshot())
                elif path == "/v1/debug/profile":
                    # {"enabled": false} when no profiler is installed
                    self.reply(200, _profile.debug_payload())
                else:
                    m = _MODEL_ROUTE.match(path)
                    if m and m.group(2) is None:
                        try:
                            entry = server.fleet.get(m.group(1))
                            self.reply(200, {"model": entry.name,
                                             **entry.info()})
                        except ServeError as e:
                            self._err(e.http_status,
                                      {"error": str(e), "cause": e.cause})
                    else:
                        self._err(404, {"error": "unknown endpoint"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                m = _MODEL_ROUTE.match(path)
                name = m.group(1) if m else None
                ctx = None
                if _rt.ACTIVE is not None:
                    # ingress: join the caller's W3C trace (or start one),
                    # echo X-Request-Id; a malformed traceparent yields a
                    # fresh trace, never a failed request
                    ctx = _rt.ACTIVE.begin(
                        m.group(2) if m and m.group(2) else "post",
                        traceparent=self.headers.get("traceparent"),
                        request_id=self.headers.get("X-Request-Id"),
                        model=name, tenant=self._tenant())
                    self._obs_ctx = ctx
                    self._obs_trace_id = ctx.trace_id
                try:
                    if path == "/v1/debug/chaos" and server.chaos_admin:
                        # admin surface stays usable even with a fault
                        # armed at http.handler — it is how you disarm one
                        self.reply(200, chaos_apply(self.read_json()))
                        return
                    if path == "/v1/admin/drain":
                        # demotion from the router: page the model out
                        # (lease-drained) so its weights stop holding HBM
                        # on a replica the placement no longer targets
                        req = self.read_json()
                        entry = server.fleet.get(req["model"])
                        server.fleet.pager.drop(entry)
                        self.reply(200, {"model": entry.name,
                                         "resident": entry.resident})
                        return
                    if _faults.ACTIVE is not None:
                        _faults.ACTIVE.hit("http.handler")
                    if not server.accepting():
                        raise ServeError("fleet is draining",
                                         cause="shutting_down")
                    if m is None or m.group(2) is None:
                        self._err(404, {"error": "unknown endpoint"})
                        if ctx is not None:
                            ctx.finish(error="bad_request")
                        return
                    req = self.read_json()
                    if m.group(2) == "predict":
                        self._predict(name, req)
                    else:
                        self._generate(name, req, query)
                except QuotaError as e:
                    self._err(e.http_status,
                              {"error": str(e), "cause": e.cause,
                               "tenant": self._tenant()},
                              headers={"Retry-After":
                                       jitter_retry_after(
                                           e.retry_after_s,
                                           server.jitter_rng)})
                    if ctx is not None:
                        ctx.finish(error=e.cause)
                except ServeError as e:
                    headers = None
                    if e.http_status == 503:
                        # breaker/page-in errors know their own back-off
                        # (jittered so refused clients don't re-arrive in
                        # one synchronized wave); queue sheds fall back to
                        # the depth-derived estimate
                        retry = getattr(e, "retry_after_s", None)
                        headers = {"Retry-After":
                                   jitter_retry_after(retry,
                                                      server.jitter_rng)
                                   if retry is not None
                                   else server._retry_after(name)}
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
                    # the client hung up while we were answering: nothing
                    # left to write to, and a vanished reader is shed load,
                    # not a server error
                    server.metrics.counter(
                        "serve_shed_total", {"cause": "client_gone"},
                        help="requests refused at admission, by cause").inc()
                    if ctx is not None:
                        ctx.finish(error="client_gone")
                except Exception as e:  # front door answers every request
                    log.exception("unhandled error serving %s", self.path)
                    self._err(500, {"error": f"{type(e).__name__}: {e}"})
                    if ctx is not None:
                        ctx.finish(error="internal")
                finally:
                    if ctx is not None:
                        ctx.finish()  # idempotent: no-op after an error path

            def _predict(self, name, req):
                res = server.fleet.predict(
                    name, req["ndarray"], tenant=self._tenant(),
                    timeout_ms=req.get("timeout_ms"),
                    ctx=getattr(self, "_obs_ctx", None))
                body = {"output": np.asarray(res.output).tolist(),
                        "model": name}
                if res.generation is not None:
                    body["generation"] = res.generation
                self.reply(200, body)

            def _sse(self, payload):
                self.wfile.write(
                    b"data: " + json.dumps(payload).encode() + b"\n\n")
                self.wfile.flush()

            def _generate(self, name, req, query):
                ctx = getattr(self, "_obs_ctx", None)
                prompt = np.asarray(req["prompt"], np.int32)
                kwargs = dict(
                    tenant=self._tenant(),
                    temperature=float(req.get("temperature", 1.0)),
                    top_k=req.get("top_k"), eos_id=req.get("eos_id"),
                    timeout_ms=req.get("timeout_ms"))
                mnt = int(req.get("max_new_tokens", 16))
                stream = "stream=false" not in query \
                    and "stream=0" not in query \
                    and req.get("stream") is not False
                if prompt.ndim != 1:  # batch prompts are always buffered
                    stream = False
                if not stream:
                    toks = server.fleet.generate(name, prompt, mnt, ctx=ctx,
                                                 **kwargs)
                    self.reply(200, {"tokens": np.asarray(toks).tolist(),
                                     "model": name})
                    return
                # admission errors surface as typed statuses BEFORE the
                # stream opens; later failures are delivered in-band
                handle = server.fleet.submit_generate(name, prompt, mnt,
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
                    self._sse({"done": True, "tokens": out, "model": name})
                except ServeError as e:
                    try:
                        self._sse({"error": str(e), "cause": e.cause,
                                   "tokens": out})
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # nobody left to tell
                    err_cause = e.cause
                except (BrokenPipeError, ConnectionResetError):
                    # client dropped the socket mid-stream: free the decode
                    # slot and KV pages NOW (the cancel path counts the shed
                    # as cause="client_gone") instead of decoding to nobody
                    server.fleet.cancel_generate(name, handle)
                    err_cause = "client_gone"
                if ctx is not None:
                    # the streaming window: first header flush to last event
                    ctx.add_stage("flush", t0f, time.perf_counter_ns(),
                                  tokens=len(out))
                    if err_cause is not None:
                        ctx.finish(error=err_cause)

        return Handler

    # ----------------------------------------------------------- lifecycle
    def stop(self, drain: bool = True):
        """Flip readiness, drain every resident model, close the listener."""
        with self._lifecycle_lock:
            self._accepting = False
        if drain:
            self.fleet.shutdown()
        super().stop()
