"""Arbiter UI — hyperparameter-search dashboard; the port of
``deeplearning4j_tpu/arbiter/ui.py`` on the port's ``ui/server.py``
helpers and ``ui/stats.py`` storages.

Reference: the arbiter UI module (``arbiter-ui`` — best-score curve +
candidate table rendered in the DL4J UI server; SURVEY.md §2.7).  Here
the runner streams every scored candidate into the SAME StatsStorage the
training UI uses (one session per search), and a stdlib HTTP board
renders best-score-so-far plus the ranked candidate table.
"""
from __future__ import annotations

import html as _html
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_tpu_torch.ui.server import (_json_safe,
                                               _svg_score_chart)
from deeplearning4j_tpu_torch.ui.stats import StatsStorage

__all__ = ["ArbiterUIServer", "StatsStorageCandidateListener"]


class StatsStorageCandidateListener:
    """Attach to LocalOptimizationRunner via ``runner.addListener``: every
    scored candidate is recorded as an update in the storage session."""

    def __init__(self, storage: StatsStorage, sessionId: str = "arbiter"):
        self.storage = storage
        self.sessionId = sessionId

    def candidateScored(self, result) -> None:
        self.storage.putUpdate(self.sessionId, {
            "index": result.index,
            "score": float(result.score),
            "parameters": {k: (v if isinstance(v, (int, float, str, bool))
                               else str(v))
                           for k, v in result.parameters.items()},
        })


class ArbiterUIServer:
    """GET / renders the board; GET /data returns the raw JSON."""

    def __init__(self, storage: StatsStorage, port: int = 0,
                 sessionId: str = "arbiter", minimize: bool = True):
        self.storage = storage
        self.port = port
        self.sessionId = sessionId
        self.minimize = minimize
        self._httpd: Optional[ThreadingHTTPServer] = None

    def _rows(self):
        return self.storage.getUpdates(self.sessionId)

    def _html(self) -> str:
        rows = self._rows()
        # diverged candidates (NaN scores) must not blank the board
        # monitoring exists to show — same contract as ui/server.py
        best = None
        curve = []
        for r in rows:
            s = r["score"]
            if not math.isfinite(s):
                continue
            if best is None or (s < best if self.minimize else s > best):
                best = s
            curve.append(best)
        finite = [r for r in rows if math.isfinite(r["score"])]
        ranked = sorted(finite, key=lambda r: r["score"],
                        reverse=not self.minimize)[:50]
        # storage-sourced values render HTML-escaped (stored-XSS guard,
        # like UIServer)
        trs = "".join(
            f"<tr><td>{int(r['index'])}</td><td>{r['score']:.6g}</td>"
            f"<td><code>{_html.escape(json.dumps(r['parameters']))}"
            "</code></td></tr>"
            for r in ranked)
        return (
            "<html><head><title>Arbiter</title></head><body>"
            f"<h2>Arbiter — {len(rows)} candidates "
            f"({len(rows) - len(finite)} diverged), best "
            f"{best if best is not None else '—'}</h2>"
            + _svg_score_chart(curve, 640, 200) +
            "<table border='1' cellpadding='4'><tr><th>#</th><th>score"
            f"</th><th>parameters</th></tr>{trs}</table></body></html>")

    def start(self) -> "ArbiterUIServer":
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/data"):
                    body = json.dumps(_json_safe(srv._rows())).encode()
                    ctype = "application/json"
                else:
                    body = srv._html().encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

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
