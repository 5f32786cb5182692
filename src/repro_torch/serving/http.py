"""OpenAI-compatible HTTP front-end over the port's async request API.
Port of ``repro.serving.http``.

Two pieces, both stdlib-only (no web framework):

* ``EngineDriver`` — runs the ServingEngine on ONE dedicated thread and
  is the engine's only entry point from then on.  HTTP handler threads
  never touch engine state: they post closures via ``call(fn)`` (executed
  on the engine thread between ticks, result/exception marshalled back)
  and consume ``RequestHandle``s, which are thread-safe by design.  The
  split matches the engine's concurrency contract: all scheduling state
  is single-threaded; only the handle surface (deltas/result/cancel) and
  the tenant queue's ``push`` are cross-thread.  On the card it is also
  the only thread that touches CUDA: a graph captures in the "global"
  error mode, which a CUDA call from another thread would break, so the
  handlers run no device op, and ``driver.call(engine.warmup)`` captures
  the graphs before the server takes traffic.

* ``ApiHandler`` / ``make_server`` — the wire protocol:

  ===========================  =============================================
  route                        behaviour
  ===========================  =============================================
  POST /v1/completions         OpenAI completions; ``"stream": true`` sends
                               SSE chunks (one per superstep harvest that
                               committed tokens), ``data: [DONE]`` terminator
  GET  /v1/models              the one served model
  GET  /metrics                Prometheus text (engine-thread snapshot)
  GET  /healthz                liveness + queue/lane gauges
  ===========================  =============================================

  Prompts are token-id lists (this repo serves a synthetic vocab; there
  is no tokenizer): ``"prompt": [3, 17, 99]`` or ``"3 17 99"``.  Chunk
  ``text`` is the space-joined ids (``"12 7 "``) so SSE concatenation
  round-trips to the exact stream; ``token_ids`` carries the raw ints.
  ``"user"`` maps to the engine's tenant, ``"priority"`` to within-tenant
  priority.  A full admission queue (engine ``max_queue``) surfaces as
  HTTP 429; a client disconnect mid-stream cancels the request at the
  next superstep boundary (``handle.cancel()``).

Responses are HTTP/1.0 close-delimited (no chunked framing needed for
SSE).  The server uses non-daemon handler threads so ``server_close()``
joins in-flight streams — the graceful-shutdown path in
``launch/api_server.py`` relies on that ordering.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.handles import QueueFull, RequestHandle


class _Future:
    """Minimal one-shot result slot for cross-thread calls."""

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def set_result(self, r):
        self._result = r
        self._ev.set()

    def set_exception(self, e: BaseException):
        self._exc = e
        self._ev.set()

    def get(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("engine call timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


class EngineDriver:
    """Single-threaded engine executor with a cross-thread call inbox.

    The loop: drain posted closures, then step the engine while it is
    busy; when idle (or paused) park on an event with a short timeout so
    a fresh submission starts decoding within ``poll_s``.  ``stop``
    optionally drains in-flight work first — the graceful-shutdown
    contract.  If the engine thread dies, every queued call and every
    live handle is failed loudly instead of hanging its waiters.
    """

    def __init__(self, engine: ServingEngine, poll_s: float = 0.02):
        self.engine = engine
        self.poll_s = poll_s
        self._uids = itertools.count(1)
        self._inbox: list = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopping = False
        self._paused = False
        self.crashed: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop,
                                        name="engine-driver", daemon=True)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "EngineDriver":
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 300.0) -> None:
        """Stop the engine thread; ``drain=True`` first finishes every
        admitted/queued request (cancelled ones retire at their next
        boundary).  Un-drained pending handles are aborted."""
        if drain and self._thread.is_alive():
            self._paused = False
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    if not self.call(lambda: self.engine.busy, timeout=30.0):
                        break
                except (RuntimeError, TimeoutError):
                    break
                time.sleep(0.01)
        self._stopping = True
        self._wake.set()
        self._thread.join(timeout=30.0)
        with self._lock:                    # fail calls posted too late
            batch, self._inbox = self._inbox, []
        for _, fut in batch:
            fut.set_exception(RuntimeError("engine driver stopped"))
        if not drain or self.crashed is not None:
            self.engine.abort_pending("engine driver stopped")

    def pause(self) -> None:
        """Freeze stepping (calls still execute) — lets tests fill the
        admission queue deterministically to exercise QueueFull/429."""
        self._paused = True
        self._wake.set()

    def resume(self) -> None:
        self._paused = False
        self._wake.set()

    # -- cross-thread surface -------------------------------------------

    def call(self, fn: Callable, timeout: float = 120.0):
        """Run ``fn()`` on the engine thread; return its result (or raise
        its exception) here."""
        if self.crashed is not None:
            raise RuntimeError(f"engine thread crashed: {self.crashed!r}")
        if not self._thread.is_alive():
            raise RuntimeError("engine driver is not running")
        fut = _Future()
        with self._lock:
            self._inbox.append((fn, fut))
        self._wake.set()
        return fut.get(timeout)

    def next_uid(self) -> int:
        return next(self._uids)

    def submit(self, req: Request, timeout: float = 120.0) -> RequestHandle:
        return self.call(lambda: self.engine.submit_request(req), timeout)

    # -- engine thread --------------------------------------------------

    def _drain_inbox(self) -> None:
        with self._lock:
            batch, self._inbox = self._inbox, []
        for fn, fut in batch:
            try:
                fut.set_result(fn())
            except BaseException as e:          # marshalled to the caller
                fut.set_exception(e)

    def _loop(self) -> None:
        try:
            while not self._stopping:
                self._drain_inbox()
                if self._paused or not self.engine.busy:
                    self._wake.wait(self.poll_s)
                    self._wake.clear()
                    continue
                self.engine.step()
            self._drain_inbox()                  # stop(): late busy-probes
        except BaseException as e:
            self.crashed = e
            with self._lock:
                batch, self._inbox = self._inbox, []
            for _, fut in batch:
                fut.set_exception(
                    RuntimeError(f"engine thread crashed: {e!r}"))
            self.engine.abort_pending(f"engine thread crashed: {e!r}")


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def _parse_prompt(raw) -> np.ndarray:
    if isinstance(raw, str):
        raw = [int(t) for t in raw.split()]
    if not isinstance(raw, list) or not raw or \
            not all(isinstance(t, int) and not isinstance(t, bool)
                    for t in raw):
        raise ValueError("prompt must be a non-empty list of token ids "
                         "(or a whitespace-separated id string)")
    return np.asarray(raw, np.int32)


def _chunk_payload(rid: str, model: str, tokens,
                   finish_reason: Optional[str]) -> dict:
    return {
        "id": rid, "object": "text_completion", "model": model,
        "choices": [{
            "index": 0,
            "text": "".join(f"{int(t)} " for t in tokens),
            "token_ids": [int(t) for t in tokens],
            "finish_reason": finish_reason,
        }],
    }


class ApiHandler(BaseHTTPRequestHandler):
    # HTTP/1.0: bodies are close-delimited, so SSE needs no chunked framing
    protocol_version = "HTTP/1.0"
    server_version = "dvi-serving"

    def log_message(self, fmt, *args):          # route access logs away
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # -- helpers --------------------------------------------------------

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str, kind: str = "invalid_request_error"):
        self._json(code, {"error": {"message": msg, "type": kind}})

    # -- routes ---------------------------------------------------------

    def do_GET(self):
        driver: EngineDriver = self.server.driver
        if self.path == "/healthz":
            if driver.crashed is not None:
                self._json(503, {"status": "crashed",
                                 "error": repr(driver.crashed)})
                return
            self._json(200, {"status": "ok",
                             "model": self.server.model_id})
        elif self.path == "/metrics":
            try:
                text = driver.call(
                    lambda: driver.engine.render_prometheus())
            except (RuntimeError, TimeoutError) as e:
                self._error(503, f"metrics unavailable: {e}", "server_error")
                return
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [{
                "id": self.server.model_id, "object": "model",
                "owned_by": "dvi"}]})
        else:
            self._error(404, f"no route {self.path!r}")

    def do_POST(self):
        if self.path != "/v1/completions":
            self._error(404, f"no route {self.path!r}")
            return
        driver: EngineDriver = self.server.driver
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = _parse_prompt(body.get("prompt"))
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, str(e))
            return
        max_new = int(body.get("max_tokens", self.server.default_max_new))
        stream = bool(body.get("stream", False))
        uid = driver.next_uid()
        req = Request(uid=uid, prompt=prompt, max_new=max_new,
                      tenant=str(body.get("user", "default")),
                      priority=int(body.get("priority", 0)))
        try:
            handle = driver.submit(req)
        except QueueFull as e:
            self._error(429, str(e), "rate_limit_exceeded")
            return
        except (RuntimeError, TimeoutError) as e:
            self._error(503, str(e), "server_error")
            return
        rid = f"cmpl-{uid}"
        model = self.server.model_id
        if stream:
            self._stream(rid, model, handle)
        else:
            self._complete_blocking(rid, model, handle)

    def _finish_reason(self, handle: RequestHandle, tokens) -> str:
        if handle.outcome == "cancelled":
            return "cancelled"
        eos = self.server.driver.engine.eos_id
        return "stop" if len(tokens) and int(tokens[-1]) == eos else "length"

    def _complete_blocking(self, rid, model, handle: RequestHandle):
        try:
            comp = handle.result(timeout=self.server.request_timeout_s)
        except (TimeoutError, RuntimeError) as e:
            handle.cancel()
            self._error(503, str(e), "server_error")
            return
        toks = handle.tokens()
        payload = _chunk_payload(rid, model, toks,
                                 self._finish_reason(handle, toks))
        payload["usage"] = {
            "prompt_tokens": int(len(comp.tokens) - len(comp.gen_tokens))
            if comp is not None else 0,
            "completion_tokens": len(toks),
            "total_tokens": int(len(comp.tokens)) if comp is not None
            else len(toks)}
        payload["timings"] = handle.timings()
        self._json(200, payload)

    def _stream(self, rid, model, handle: RequestHandle):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def send(obj) -> None:
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        sent = []
        try:
            for chunk in handle.deltas(
                    timeout=self.server.request_timeout_s):
                sent.extend(chunk)
                send(_chunk_payload(rid, model, chunk, None))
            send(_chunk_payload(rid, model, [],
                                self._finish_reason(handle, sent)))
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # client went away: stop generating at the next boundary
            handle.cancel()
        except (TimeoutError, RuntimeError) as e:
            handle.cancel()
            try:
                send({"error": {"message": str(e), "type": "server_error"}})
            except OSError:
                pass


class ApiServer(ThreadingHTTPServer):
    """ThreadingHTTPServer wired to an EngineDriver.  Handler threads are
    NON-daemon so ``server_close()`` joins in-flight request streams —
    shutdown order (api_server.py): ``shutdown()`` stops accepting,
    ``server_close()`` drains handlers (engine still stepping), then
    ``driver.stop(drain=True)``."""
    daemon_threads = False
    allow_reuse_address = True

    def __init__(self, addr, driver: EngineDriver, model_id: str,
                 default_max_new: int = 64, request_timeout_s: float = 300.0,
                 verbose: bool = False):
        super().__init__(addr, ApiHandler)
        self.driver = driver
        self.model_id = model_id
        self.default_max_new = default_max_new
        self.request_timeout_s = request_timeout_s
        self.verbose = verbose


def make_server(host: str, port: int, engine: ServingEngine, model_id: str,
                default_max_new: int = 64,
                request_timeout_s: float = 300.0) -> ApiServer:
    """Start the engine driver and bind the API server (caller runs
    ``serve_forever``)."""
    driver = EngineDriver(engine).start()
    return ApiServer((host, port), driver, model_id,
                     default_max_new=default_max_new,
                     request_timeout_s=request_timeout_s)
