"""k-NN REST client — ``nearestneighbor/client/NearestNeighborsClient.java``."""

from __future__ import annotations

import json
import urllib.request
from typing import List, Sequence


class NearestNeighborsClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 9000,
                 timeout: float = 10.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def knn(self, index: int, k: int) -> List[dict]:
        return self._post("/knn", {"ndarray": index, "k": k})["results"]

    def knn_new(self, vector: Sequence[float], k: int) -> List[dict]:
        res = self._post("/knnnew", {"ndarray": list(vector), "k": k})["results"]
        return res[0] if res and isinstance(res[0], list) else res

    def health(self) -> dict:
        with urllib.request.urlopen(self.base + "/health", timeout=self.timeout) as r:
            return json.loads(r.read())
