"""Training dashboard web server — the port of
``deeplearning4j_tpu/ui/server.py``.

Reference: deeplearning4j-vertx ``VertxUIServer`` / ``UIServer.getInstance``
— overview page with the score chart at :9000.

Stdlib ``http.server`` on a daemon thread; the overview renders the score
curve and each tensor's histogram as inline SVG (no JS deps), plus a JSON
API (``/train/sessions``, ``/train/<session>/data``) for programmatic
access, the remote receiver (``POST /train/post``) and the observability
routes (``/metrics``, ``/metrics/federated``, ``/healthz``) shared with
``remote/server.py``.
"""
from __future__ import annotations

import html
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from deeplearning4j_tpu_torch.ui.stats import StatsStorage


def _json_safe(obj):
    """NaN/Inf → null: Python's json emits bare NaN tokens (invalid JSON)
    that break strict parsers exactly when a run diverges."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _svg_histogram(counts, lo: float, hi: float, w: int = 220,
                   h: int = 48) -> str:
    """Inline bar-chart for a fixed-bin histogram (sanitized: counts are
    coerced to non-negative floats; anything else renders empty)."""
    try:
        vals = [max(0.0, float(c)) for c in counts]
    except (TypeError, ValueError):
        return ""
    if not vals or max(vals) <= 0:
        return ""
    top = max(vals)
    bw = w / len(vals)
    bars = "".join(
        f'<rect x="{i * bw:.1f}" y="{h - v / top * h:.1f}" '
        f'width="{max(bw - 1, 1):.1f}" height="{v / top * h:.1f}" '
        'fill="#4878a8"/>' for i, v in enumerate(vals))
    return (f'<svg width="{w}" height="{h + 14}" '
            'style="vertical-align:middle">'
            f'{bars}<text x="0" y="{h + 12}" font-size="10">{lo:.3g}</text>'
            f'<text x="{w - 40}" y="{h + 12}" font-size="10">{hi:.3g}'
            '</text></svg>')


def _svg_score_chart(scores: List[float], w: int = 640, h: int = 240) -> str:
    scores = [s for s in scores if math.isfinite(s)]  # a NaN score (diverged
    # run) must not blank the chart monitoring exists to show
    if not scores:
        return "<p>no data yet</p>"
    lo, hi = min(scores), max(scores)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{i * (w - 20) / max(len(scores) - 1, 1) + 10:.1f},"
        f"{h - 20 - (s - lo) / span * (h - 40):.1f}"
        for i, s in enumerate(scores))
    return (f'<svg width="{w}" height="{h}" style="background:#fafafa;'
            f'border:1px solid #ccc">'
            f'<polyline fill="none" stroke="#1f77b4" stroke-width="1.5" '
            f'points="{pts}"/>'
            f'<text x="10" y="14" font-size="11">max {hi:.5f}</text>'
            f'<text x="10" y="{h - 6}" font-size="11">min {lo:.5f}</text>'
            f'</svg>')


class UIServer:
    """Reference: UIServer.getInstance().attach(statsStorage)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000):
        self.port = port
        self._storages: List[StatsStorage] = []
        # eager: handler threads race a lazy check-then-create
        from deeplearning4j_tpu_torch.ui.stats import InMemoryStatsStorage
        self._remote = InMemoryStatsStorage()
        self._storages.append(self._remote)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def getInstance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port)
        return cls._instance

    def attach(self, storage: StatsStorage) -> None:
        self._storages.append(storage)
        if self._httpd is None:
            self._start()

    def _remote_storage(self):
        return self._remote

    def _sessions(self):
        out = {}
        for st in self._storages:
            for sid in st.listSessionIDs():
                out[sid] = st
        return out

    def _start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body, ctype: str = "text/html",
                      status: int = 200):
                data = body if isinstance(body, bytes) else \
                    body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                # remote stats push (reference: RemoteUIStatsStorageRouter
                # -> remote-mode UIServer): {"session": ..., "update": {...}}
                if self.path != "/train/post":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n))
                    server._remote_storage().putUpdate(payload["session"],
                                                       payload["update"])
                    self._send(json.dumps({"ok": True}), "application/json")
                except Exception as e:
                    data = json.dumps({"error": str(e)}).encode()
                    self.send_response(400)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)

            def do_GET(self):
                # observability surface (/metrics, /metrics/federated,
                # /healthz) — shared routing with remote.JsonModelServer
                from deeplearning4j_tpu_torch.telemetry.http import \
                    observability_route
                route = observability_route(self.path)
                if route is not None:
                    status, data, ctype = route
                    self._send(data, ctype, status)
                    return
                sessions = server._sessions()
                if self.path == "/train/sessions":
                    self._send(json.dumps(list(sessions)),
                               "application/json")
                    return
                if self.path.startswith("/train/") and \
                        self.path.endswith("/data"):
                    sid = self.path.split("/")[2]
                    st = sessions.get(sid)
                    self._send(json.dumps(
                        _json_safe(st.getUpdates(sid) if st else []),
                        allow_nan=False), "application/json")
                    return
                def _num(v, default=float("nan")):
                    try:
                        return float(v)
                    except (TypeError, ValueError):
                        return default

                if self.path == "/train/system":
                    # system/hardware tab (reference: the UI's System tab)
                    parts = ["<html><head><title>System</title></head>"
                             "<body><h2>System / hardware</h2>"]
                    for sid, st in sessions.items():
                        ups = st.getUpdates(sid)
                        mems = [u.get("memory") for u in ups
                                if isinstance(u.get("memory"), dict)]
                        if not mems:
                            continue
                        last = mems[-1]
                        parts.append(
                            f"<h3>{html.escape(str(sid))}</h3>"
                            f"<p>{html.escape(str(last.get('deviceCount', '?')))}x "
                            f"{html.escape(str(last.get('platform', '?')))}; "
                            f"device {_num(last.get('deviceBytesInUse', 0), 0) / 1e9:.2f}"
                            f"/{_num(last.get('deviceBytesLimit', 0), 0) / 1e9:.2f} GB; "
                            f"host rss {_num(last.get('hostRssBytes', 0), 0) / 1e9:.2f} GB"
                            "</p>")
                        dev = [m for m in (_num(u.get("deviceBytesInUse"))
                                           for u in mems)
                               if not math.isnan(m)]
                        if dev:
                            parts.append("<h4>device memory over time</h4>"
                                         + _svg_score_chart(dev))
                        rss = [m for m in (_num(u.get("hostRssBytes"))
                                           for u in mems)
                               if not math.isnan(m)]
                        if rss:
                            parts.append("<h4>host RSS over time</h4>"
                                         + _svg_score_chart(rss))
                    parts.append("</body></html>")
                    self._send("".join(parts))
                    return

                # overview page
                parts = ["<html><head><title>DL4J-TPU Training UI</title>"
                         "</head><body><h2>Training overview</h2>"
                         "<p><a href=\"/train/system\">system/hardware "
                         "tab</a></p>"]

                for sid, st in sessions.items():
                    ups = st.getUpdates(sid)
                    # escape/coerce: session ids and update values arrive via
                    # the unauthenticated /train/post — raw rendering would
                    # be stored XSS, and a non-numeric score would 500 the
                    # whole overview (stored DoS)
                    scores = [s for s in (_num(u["score"]) for u in ups
                                          if "score" in u)
                              if not math.isnan(s)]
                    last = ups[-1] if ups else {}
                    parts.append(
                        f"<h3>{html.escape(str(sid))}</h3>"
                        f"<p>iterations: {len(ups)}; last score: "
                        f"{_num(last.get('score', float('nan'))):.5f}; "
                        f"it/s: {_num(last.get('iterationsPerSecond', 0), 0.0):.2f}"
                        "</p>" + _svg_score_chart(scores))
                    mem = last.get("memory") or {}
                    if isinstance(mem, dict) and mem:
                        bits = []
                        if "deviceBytesInUse" in mem:
                            bits.append(
                                f"device {_num(mem['deviceBytesInUse'], 0) / 1e9:.2f}"
                                f"/{_num(mem.get('deviceBytesLimit', 0), 0) / 1e9:.2f} GB")
                        if "hostRssBytes" in mem:
                            bits.append(
                                f"host rss {_num(mem['hostRssBytes'], 0) / 1e9:.2f} GB")
                        bits.append(f"{html.escape(str(mem.get('deviceCount', '?')))}x "
                                    f"{html.escape(str(mem.get('platform', '?')))}")
                        parts.append("<p>memory/hw: " + "; ".join(bits)
                                     + "</p>")
                    for section, title in (("paramStats", "parameters"),
                                           ("updateStats", "updates"),
                                           ("activationStats",
                                            "activations")):
                        stats = last.get(section) or {}
                        if not isinstance(stats, dict) or not stats:
                            continue
                        parts.append(f"<h4>{title} (last iteration)</h4>")
                        for name, s in sorted(stats.items()):
                            if not isinstance(s, dict):
                                continue
                            hist = s.get("hist")
                            parts.append(
                                f"<div><tt>{html.escape(str(name))}</tt> "
                                f"norm {_num(s.get('norm'), 0):.4g}, "
                                f"mean {_num(s.get('mean'), 0):.4g}, "
                                f"stdev {_num(s.get('stdev'), 0):.4g} "
                                + (_svg_histogram(hist,
                                                  _num(s.get('min'), 0),
                                                  _num(s.get('max'), 0))
                                   if isinstance(hist, list) else "")
                                + "</div>")
                parts.append("</body></html>")
                self._send("".join(parts))

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            # shutdown() stops serve_forever, but returning before the
            # thread exits lets a stop()/start() cycle race the old
            # acceptor
            self._thread.join(timeout=5.0)
            self._thread = None
        UIServer._instance = None
