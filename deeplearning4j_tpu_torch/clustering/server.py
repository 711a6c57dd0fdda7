"""Nearest-neighbors REST server — the port of
``deeplearning4j_tpu/clustering/server.py``, a copy of its host code.

Reference: ``deeplearning4j-nearestneighbors-parent/
deeplearning4j-nearestneighbor-server`` (``NearestNeighborsServer`` —
POST /knn with a point + k against a VPTree-indexed corpus).  Same
stdlib-HTTP design as ``remote/server.py``.

Endpoints:
- ``POST /knn``    {"point": [...], "k": n}   -> {"results": [{"index",
  "distance"}]} nearest first
- ``POST /knnnew`` {"ndarray": [[...], ...], "k": n} -> {"results":
  [per-row result lists]} (the reference's batch endpoint)
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.trees import VPTree

__all__ = ["NearestNeighborsServer", "NearestNeighborsClient"]


class NearestNeighborsServer:
    def __init__(self, points, k: int = 5, port: int = 0,
                 similarityFunction: str = "euclidean"):
        self.points = np.asarray(points, np.float64)
        self.defaultK = int(k)
        self.port = port
        self.tree = VPTree(self.points, similarityFunction)
        self._httpd: Optional[ThreadingHTTPServer] = None

    def _knn(self, point: np.ndarray, k: int):
        idx, dists = self.tree.search(point, k)
        return [{"index": int(i), "distance": float(d)}
                for i, d in zip(idx, dists)]

    def start(self) -> "NearestNeighborsServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    k = int(payload.get("k", server.defaultK))
                    if self.path == "/knnnew":
                        pts = np.asarray(payload["ndarray"], np.float64)
                        body = {"results": [server._knn(p, k)
                                            for p in np.atleast_2d(pts)]}
                    else:
                        body = {"results": server._knn(
                            np.asarray(payload["point"], np.float64), k)}
                    code = 200
                except KeyError as e:
                    body, code = {"error": f"missing field {e}"}, 400
                except Exception as e:  # noqa: BLE001 — surfaced as 500
                    body = {"error": f"{type(e).__name__}: {e}"}
                    code = 500
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class NearestNeighborsClient:
    """Reference: nearestneighbor-client ``NearestNeighborsClient``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.base = f"http://{host}:{port}"

    def knn(self, point, k: int = 5):
        import urllib.request
        req = urllib.request.Request(
            self.base + "/knn",
            json.dumps({"point": np.asarray(point).tolist(),
                        "k": k}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())["results"]

    def knnNew(self, arr, k: int = 5):
        import urllib.request
        req = urllib.request.Request(
            self.base + "/knnnew",
            json.dumps({"ndarray": np.asarray(arr).tolist(),
                        "k": k}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())["results"]
