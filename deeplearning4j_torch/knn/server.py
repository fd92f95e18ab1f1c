"""k-NN REST server — the port's ``NearestNeighborsServer``
(``nearestneighbor/server/NearestNeighborsServer.java``), a stdlib
``http.server`` over a ``BruteForceKNN`` on the card.

Endpoints (JSON), as the JAX package's server answers them:
- POST /knn     {"ndarray": <row index int>, "k": int}   — neighbors of an
  indexed point (self excluded)
- POST /knnnew  {"ndarray": [[...floats...]], "k": int}  — neighbors of new
  vectors
- GET  /health
- GET  /metrics — Prometheus scrape (request latency histograms)

A bad request answers 400; an unexpected fault 500, and the server keeps
serving. ``client.py`` holds the matching client.
"""

from __future__ import annotations

import json

import numpy as np

from ..device import DeviceLike
from ..obs.metrics import MetricsRegistry
from ..utils.httpd import JsonHTTPServerMixin, JsonRequestHandler
from .brute import BruteForceKNN


class NearestNeighborsServer(JsonHTTPServerMixin):
    def __init__(self, points, distance: str = "euclidean", port: int = 9000,
                 default_k: int = 5, host: str = "127.0.0.1",
                 metrics: MetricsRegistry = None, device: DeviceLike = None):
        self.index = BruteForceKNN(points, distance=distance, device=device)
        self.port = port
        self.host = host  # bind 0.0.0.0 to serve other hosts
        self.default_k = default_k
        # per-endpoint latency + GET /metrics, provided by the httpd layer
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def _handler(self):
        server = self

        class Handler(JsonRequestHandler):
            owner = server

            def do_GET(self):
                if self.path == "/health":
                    self.reply(200, {"status": "ok",
                                     "points": int(server.index.points.shape[0])})
                else:
                    self.reply(404, {"error": "unknown endpoint"})

            def do_POST(self):
                try:
                    req = self.read_json()
                    k = int(req.get("k", server.default_k))
                    if self.path == "/knn":
                        row = int(req["ndarray"])
                        idx, d = server.index.search_excluding_self(row, k)
                        self.reply(200, {"results": [
                            {"index": int(i), "distance": float(x)}
                            for i, x in zip(idx, d)]})
                    elif self.path == "/knnnew":
                        arr = np.asarray(req["ndarray"], np.float32)
                        if arr.ndim == 1:
                            arr = arr[None]
                        idx, d = server.index.search(arr, k)
                        self.reply(200, {"results": [[
                            {"index": int(i), "distance": float(x)}
                            for i, x in zip(row_i, row_d)]
                            for row_i, row_d in zip(idx, d)]})
                    else:
                        self.reply(404, {"error": "unknown endpoint"})
                except (KeyError, ValueError, IndexError, TypeError,
                        AttributeError, json.JSONDecodeError) as e:
                    self.reply(400, {"error": str(e)})
                except Exception as e:  # unexpected: surface as 500, keep serving
                    self.reply(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler
