"""JSON-over-http.server scaffolding — the port's own copy of
``deeplearning4j_tpu/utils/httpd.py``.

One place for the handler factory plumbing: reply encoding, port-0
resolution, background-thread serve loop, and shutdown ordering — plus
request telemetry: any server object exposing a ``metrics`` registry
(``obs.metrics.MetricsRegistry``) gets per-endpoint request-latency
histograms and a ``GET /metrics`` Prometheus scrape for free, with no
changes to its handler code. The coupling is duck-typed. A client that
asks for ``application/openmetrics-text`` gets OpenMetrics, with the
traced requests' ids as latency exemplars.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlsplit

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CTYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _instrumented(fn, verb: str):
    """Wrap a do_GET/do_POST with request telemetry against ``owner.metrics``.

    GET /metrics is answered here (Prometheus text format) so every server
    built on this scaffolding scrapes identically. Label cardinality is the
    owner's problem: servers with parameterized paths provide
    ``_metric_route(path)`` to collapse them (e.g. ``/train/{sid}/overview``)
    — otherwise the raw path is the endpoint label.
    """

    @functools.wraps(fn)
    def wrapper(self):
        reg = getattr(self.owner, "metrics", None)
        if reg is None:
            return fn(self)
        path = urlsplit(self.path).path
        if verb == "GET" and path == "/metrics":
            # content negotiation: OpenMetrics (exemplar-capable) on request,
            # classic 0.0.4 text otherwise — exemplars are illegal in 0.0.4
            if "application/openmetrics-text" in self.headers.get("Accept", ""):
                self.reply(200, reg.to_openmetrics(), OPENMETRICS_CTYPE)
            else:
                self.reply(200, reg.to_prometheus(), PROMETHEUS_CTYPE)
            return None
        route = getattr(self.owner, "_metric_route", None)
        endpoint = route(path) if route is not None else path
        labels = {"method": verb, "endpoint": endpoint}
        t0 = time.perf_counter()
        try:
            return fn(self)
        finally:
            # handlers that trace requests leave their trace_id on the
            # handler instance; it becomes the latency exemplar
            reg.histogram("http_request_seconds", labels,
                          help="HTTP request handling latency by endpoint"
                          ).observe(time.perf_counter() - t0,
                                    trace_id=getattr(self, "_obs_trace_id",
                                                     None))
            reg.counter("http_requests_total", labels,
                        help="HTTP requests served by endpoint").inc()

    return wrapper


class JsonRequestHandler(BaseHTTPRequestHandler):
    """Quiet handler with JSON helpers; subclasses implement do_GET/do_POST
    and reach their server object via ``self.owner``."""

    owner = None  # set by the subclass closure

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for method in ("do_GET", "do_POST"):
            fn = cls.__dict__.get(method)
            if fn is not None and not getattr(fn, "_obs_wrapped", False):
                wrapped = _instrumented(fn, method[3:])
                wrapped._obs_wrapped = True
                setattr(cls, method, wrapped)

    def log_message(self, *a):
        pass

    def reply(self, code: int, payload, ctype: str = "application/json",
              headers: Optional[dict] = None):
        body = payload.encode() if isinstance(payload, str) \
            else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def read_json(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")


class JsonHTTPServerMixin:
    """start()/stop() lifecycle of a JSON server. Subclasses set ``self.host``/``self.port`` and implement ``_handler()``
    returning a JsonRequestHandler subclass."""

    _httpd: Optional[ThreadingHTTPServer] = None
    _thread: Optional[threading.Thread] = None

    def start(self, background: bool = True):
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]  # resolves port=0
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
