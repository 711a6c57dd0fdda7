"""JSON-over-HTTP inference server + client — the port of
``deeplearning4j_tpu/remote/server.py``.

Reference: deeplearning4j-remote ``JsonModelServer`` (serve an MLN/CG/
SameDiff model on a port; POST JSON features → JSON predictions) and the
``JsonRemoteInference`` client.  ``reply_safely`` and ``stream_ndjson``
are the shared HTTP writers of the serving tier's fronts.

``parallelInference=True`` serves through ``parallel/inference.py``'s
``ParallelInference`` (concurrent requests coalesce into batched calls of
the model, ``batchLimit`` rows at most).  :class:`SameDiffJsonModelServer` feeds a SameDiff graph's placeholder
(the reference's is an alias of ``JsonModelServer``, which calls
``sd.output(features)``, which fails on a SameDiff graph, so it answers 400
to every request; ROADMAP C13).
"""
from __future__ import annotations

import concurrent.futures
import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch


def _host(out) -> np.ndarray:
    """A model output as a host array: the response payload."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


# torch reports an input of the wrong shape as a RuntimeError with one of
# these phrases, where JAX raises TypeError / ValueError: the HTTP fronts
# answer both 400, the caller's payload, as the reference's fronts do
_SHAPE_PHRASES = ("cannot be multiplied", "must match the size of tensor",
                  "size mismatch", "is invalid for input of size",
                  "to have", "but got")


def is_shape_error(e: BaseException) -> bool:
    """Whether ``e`` is torch's report of an input of the wrong shape."""
    return isinstance(e, RuntimeError) and \
        any(p in str(e) for p in _SHAPE_PHRASES)


def reply_safely(handler, code: int, body: bytes, ctype: str,
                 headers: Optional[Dict[str, str]] = None) -> None:
    """Write one HTTP response, surviving a client that hung up mid-reply.

    Shared by every HTTP front in the remote package (``JsonModelServer``
    here, ``serving.InferenceServer``): a BrokenPipeError out of
    ``wfile.write`` used to propagate and take the handler thread down
    mid-response — the disconnecting client's problem must stay its own.
    """
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        handler.close_connection = True


# Producers yield this sentinel (instead of a JSON-able object) to ask
# stream_ndjson for a keep-alive comment line: a decode gap is in
# progress, write SOMETHING so an idle proxy doesn't reap the stream.
KEEPALIVE = object()

# The keep-alive line itself.  NDJSON has no comment syntax; by the SSE
# convention a line starting with ':' is a comment, and every client of
# this endpoint (JsonRemoteInference, tests, curl | jq with a grep -v)
# skips non-'{' lines.  It is a full chunked-encoding frame so proxies
# see forward progress on the wire.
_KEEPALIVE_LINE = b": keep-alive\n"


def stream_ndjson(handler, items, final: Optional[dict] = None,
                  headers: Optional[Dict[str, str]] = None) -> None:
    """Chunked NDJSON streaming response: one JSON object per line,
    flushed as it is produced — the serving tier's token streaming
    (``InferenceServer`` with ``{"stream": true}``), where each decode
    step's token reaches the client before the next step runs.

    Requires the handler to speak HTTP/1.1 (chunked transfer encoding).
    An exception out of ``items`` mid-stream cannot become an HTTP
    status any more (headers are gone) — it is delivered as a final
    ``{"error": ...}`` line instead.  A client hanging up mid-stream
    stops the iteration without killing the handler thread (and without
    consuming the rest of the generator, so the producer can cancel the
    work — same contract as :func:`reply_safely`).

    When ``items`` yields the :data:`KEEPALIVE` sentinel, a comment line
    is written instead of JSON (idle-stream heartbeat during decode
    gaps).  A client that hangs up during a keep-alive write cancels the
    sequence exactly like a hangup during a token write — the write
    raises, the generator is closed, the producer reaps the slot.
    """
    try:
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()

        def frame(data: bytes) -> None:
            handler.wfile.write(
                f"{len(data):x}\r\n".encode("ascii") + data + b"\r\n")
            handler.wfile.flush()

        def chunk(obj) -> None:
            frame(json.dumps(obj).encode("utf-8") + b"\n")

        try:
            for obj in items:
                if obj is KEEPALIVE:
                    frame(_KEEPALIVE_LINE)
                else:
                    chunk(obj)
        except (BrokenPipeError, ConnectionResetError):
            # the CLIENT hung up (token or keep-alive write alike):
            # don't write an error line into a dead socket — let the
            # outer handler close the producer so it can cancel
            raise
        except Exception as e:
            chunk({"error": f"{type(e).__name__}: {e}"})
        else:
            if final is not None:
                chunk(final)
        handler.wfile.write(b"0\r\n\r\n")
    except (BrokenPipeError, ConnectionResetError):
        handler.close_connection = True
        close = getattr(items, "close", None)
        if close is not None:
            close()                 # tell the producer to cancel


class JsonModelServer:
    """POST /v1/serving -> {"output": [...]} (reference endpoint shape);
    a multi-output ComputationGraph answers {"outputs": {name: [...]}}.
    Status split: 400 = the caller's payload, 500 = ours, 504 = a blown
    ``requestTimeout``.  ``parallelInference=True`` batches concurrent
    requests through ``ParallelInference`` (single-output models only);
    ``batchLimit`` is its knob."""

    def __init__(self, model, port: int = 0, outputNames=None,
                 parallelInference: bool = False, batchLimit: int = 32,
                 requestTimeout: Optional[float] = None):
        self.model = model
        self.port = port
        # restrict ComputationGraph responses to these named outputs
        self.outputNames = list(outputNames) if outputNames else None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._parallelInference = bool(parallelInference)
        self._batchLimit = int(batchLimit)
        self._pi = None
        # per-request wall-clock budget (seconds); a blown budget answers
        # 504 instead of hanging the client's connection.  The stuck model
        # call keeps running on its pool thread — HTTP can't cancel device
        # work, it can only stop waiting for it.
        self.requestTimeout = requestTimeout
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        if parallelInference:
            # validate eagerly (construction-time error), build lazily in
            # start() so a failed construction leaves no worker thread
            conf = getattr(model, "conf", None)
            n_outs = len(getattr(conf, "outputs", None) or [1])
            if n_outs > 1:
                raise ValueError(
                    "parallelInference serving supports single-output "
                    "models (batch splitting of multi-output graphs is "
                    "ambiguous)")

    def _run(self, x: np.ndarray) -> dict:
        if self._pi is not None:
            return {"output": _host(self._pi.output(x)).tolist()}
        out = self.model.output(x)
        if isinstance(out, list):
            names = list(getattr(self.model.conf, "outputs", None) or
                         range(len(out)))
            sel = {str(n): _host(o).tolist()
                   for n, o in zip(names, out)}
            if self.outputNames is not None:
                missing = [n for n in self.outputNames if n not in sel]
                if missing:
                    raise KeyError(f"unknown output(s) {missing}; "
                                   f"model outputs: {list(sel)}")
                sel = {n: sel[n] for n in self.outputNames}
            return {"outputs": sel}
        return {"output": _host(out).tolist()}

    def _run_with_timeout(self, x: np.ndarray) -> dict:
        # the pool is created in start() (single-threaded), never lazily
        # here: concurrent first requests would race the None check and
        # leak an executor
        if self._pool is None:
            return self._run(x)
        fut = self._pool.submit(self._run, x)
        try:
            return fut.result(timeout=self.requestTimeout)
        except concurrent.futures.TimeoutError:
            # reap queued-but-unstarted work (a running model call can't
            # be interrupted, but zombies waiting behind it can)
            fut.cancel()
            raise

    def start(self) -> "JsonModelServer":
        if self.requestTimeout and self._pool is None:
            # rebuilt per start so stop()/start() cycles serve again
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="json-model-server")
        if self._parallelInference and self._pi is None:
            # (re)built per start so stop()/start() cycles serve again
            from deeplearning4j_tpu_torch.parallel.inference import \
                ParallelInference
            self._pi = ParallelInference.Builder(self.model) \
                .batchLimit(self._batchLimit).build()
        # fail fast on static misconfiguration — a bad outputNames list is
        # not a per-request 500, it's a server-construction error
        if self.outputNames is not None:
            known = getattr(self.model.conf, "outputs", None)
            if known is not None:
                missing = [n for n in self.outputNames if n not in known]
                if missing:
                    raise ValueError(f"unknown output(s) {missing}; model "
                                     f"outputs: {list(known)}")
        model = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                reply_safely(self, code, body, ctype)

            def do_GET(self):
                # observability surface (/metrics, /metrics/federated,
                # /healthz) — shared routing with ui.UIServer
                from deeplearning4j_tpu_torch.telemetry.http import \
                    observability_route
                route = observability_route(self.path)
                if route is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self._reply(*route)

            def do_POST(self):
                # payload faults are the CLIENT's (400); model-execution
                # faults are OURS (500); a blown time budget is 504 —
                # retry/alerting logic keys on this split, and the client
                # below only retries the 5xx class
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    x = np.asarray(payload["features"], dtype=np.float32)
                except Exception as e:
                    body, code = {"error": f"{type(e).__name__}: {e}"}, 400
                else:
                    try:
                        body, code = model._run_with_timeout(x), 200
                    except concurrent.futures.TimeoutError:
                        body = {"error": "TimeoutError: request exceeded "
                                f"{model.requestTimeout}s budget"}
                        code = 504
                    except (ValueError, TypeError) as e:
                        # shape/rank mismatch with the model's input —
                        # the caller's payload, not our bug
                        body = {"error": f"{type(e).__name__}: {e}"}
                        code = 400
                    except Exception as e:
                        body = {"error": f"{type(e).__name__}: {e}"}
                        code = 400 if is_shape_error(e) else 500
                from deeplearning4j_tpu_torch.telemetry import \
                    get_registry
                get_registry().counter(
                    "dl4j_tpu_remote_requests_total",
                    "Inference requests served, by HTTP status",
                    labelnames=("code",)).inc(code=str(code))
                self._reply(code, json.dumps(body).encode("utf-8"),
                            "application/json")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            # stop() must not return while the acceptor thread still
            # runs: a stop()/start() cycle would race the old loop
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._pi is not None:
            self._pi.shutdown()
            self._pi = None      # rebuilt on the next start()


class SameDiffJsonModelServer(JsonModelServer):
    """``JsonModelServer`` for a SameDiff graph with one placeholder: each
    request's features feed it and the reply holds ``outputNames``
    (default: the graph's loss variables, ``SameDiff.output``'s own
    default) — ``{"output": [...]}`` for one, ``{"outputs": {name: [...]}}``
    for several, the reference server's two reply shapes.

    Departs from the reference on purpose (ROADMAP C13): there this name
    is an alias of ``JsonModelServer``, whose ``model.output(features)``
    cannot feed a SameDiff graph (every request answers 400)."""

    def __init__(self, sd, port: int = 0, outputNames=None,
                 requestTimeout: Optional[float] = None):
        super().__init__(sd, port=port, requestTimeout=requestTimeout)
        phs = [v.name() for v in sd.variables()
               if v.variableType == "PLACEHOLDER"]
        if len(phs) != 1:
            raise ValueError(f"the graph has placeholders {phs}: the server "
                             "feeds a graph with exactly one")
        self.inputName = phs[0]
        self.sdOutputs = list(outputNames) if outputNames else None

    def _run(self, x: np.ndarray) -> dict:
        res = self.model.output({self.inputName: x},
                                *(self.sdOutputs or ()))
        if len(res) == 1:
            return {"output": _host(next(iter(res.values()))).tolist()}
        return {"outputs": {n: _host(v).tolist() for n, v in res.items()}}


class JsonRemoteInference:
    """Client (reference: JsonRemoteInference.java).

    Transient faults — connection errors and 5xx responses — are retried
    ``retries`` times with exponential backoff + jitter (jitter decorrelates
    a thundering herd of clients re-hitting a recovering server at the same
    instant).  4xx responses are the CALLER's fault and raise immediately:
    re-sending a malformed payload can never succeed.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 endpoint: str = "/v1/serving", timeout: float = 30.0,
                 retries: int = 3, backoff: float = 0.05,
                 maxBackoff: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        self.url = f"http://{host}:{port}{endpoint}"
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.backoff = float(backoff)
        self.maxBackoff = float(maxBackoff)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def _sleep(self, attempt: int) -> None:
        delay = min(self.backoff * (2 ** attempt), self.maxBackoff)
        time.sleep(delay * (1.0 + self.jitter * self._rng.random()))

    def predict(self, features):
        """Single-output models return an ndarray; multi-output graphs a
        {name: ndarray} dict (mirroring the server's response shape)."""
        data = json.dumps({"features": np.asarray(features).tolist()}
                          ).encode("utf-8")
        # propagate the caller's trace context (W3C traceparent) so the
        # server's timeline joins the distributed trace instead of
        # minting a fresh id per hop
        from deeplearning4j_tpu_torch.telemetry import current_context
        ctx = current_context()
        reqHeaders = {"Content-Type": "application/json"}
        if ctx is not None:
            reqHeaders["traceparent"] = ctx.to_traceparent()
        last_err: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.url, data=data, headers=dict(reqHeaders))
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    body = json.loads(resp.read())
                break
            except urllib.error.HTTPError as e:
                try:
                    msg = json.loads(e.read()).get("error", str(e))
                except Exception:
                    msg = str(e)
                err = RuntimeError(f"HTTP {e.code}: {msg}")
                if e.code < 500:
                    raise err from None     # caller's payload; no retry
                last_err = err
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last_err = e                # server down/unreachable: retry
            if attempt < self.retries:
                self._sleep(attempt)
        else:
            raise RuntimeError(
                f"request failed after {self.retries + 1} attempts: "
                f"{last_err}") from last_err
        if "error" in body:
            raise RuntimeError(body["error"])
        if "output" in body:
            return np.asarray(body["output"])
        return {n: np.asarray(v) for n, v in body["outputs"].items()}
