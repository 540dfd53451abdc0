"""HTTP ingress for Serve.

Parity with ``python/ray/serve/_private/http_proxy.py``: an actor running
an HTTP server that maps route prefixes to deployments (table pushed from
the controller via long-poll) and forwards request bodies through a
``DeploymentHandle``. The reference uses uvicorn/ASGI; here the server
is the stdlib threading HTTP server hardened with the proxy-level
behaviors the ASGI stack provides:

- **Ingress concurrency limiting**: at most ``max_concurrent_requests``
  requests execute at once; excess requests are rejected immediately
  with 503 + Retry-After (the proxy's half of the reference's
  ``max_ongoing_requests`` backpressure) instead of stacking threads.
- **Streaming responses**: list/tuple results stream as
  chunked-transfer pieces when the client asks
  (``X-Serve-Stream: 1``) — element-wise flush, so large outputs don't
  buffer into one JSON blob. (Replica execution itself completes
  before streaming starts: the task protocol replies once; this is
  response streaming, not incremental generation.)
- **Utility endpoints**: ``/-/healthz`` and ``/-/routes`` (same paths
  as the reference proxy's health/routes endpoints).
- **Draining**: during shutdown new requests get 503 while in-flight
  ones finish.

Request convention: POST body is JSON (or raw bytes if not JSON) passed
as the single argument; the JSON-serialized return value is the
response.
"""

from __future__ import annotations
import logging

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ray_tpu_torch import observability
from ray_tpu_torch._private.config import _config
from ray_tpu_torch.exceptions import ServeOverloadedError
from ray_tpu_torch.observability import perf
from ray_tpu_torch.serve._private.long_poll import LongPollClient
from ray_tpu_torch.serve.controller import ROUTE_TABLE_KEY
from ray_tpu_torch.serve.handle import DeploymentHandle

logger = logging.getLogger("ray_tpu")


class HTTPProxy:
    def __init__(self, controller_handle, host: str = "127.0.0.1",
                 port: int = 0, max_concurrent_requests: int = 200,
                 request_timeout_s: float = 60.0):
        self._controller = controller_handle
        self._routes: Dict[str, str] = {}
        self._handles: Dict[str, DeploymentHandle] = {}
        self._lock = threading.Lock()
        self._inflight = threading.Semaphore(max_concurrent_requests)
        self._draining = False
        self._timeout_s = request_timeout_s
        import ray_tpu_torch as ray_tpu
        self._routes = ray_tpu.get(
            controller_handle.get_route_table.remote())
        self._poller = LongPollClient(
            controller_handle, {ROUTE_TABLE_KEY: self._update_routes})

        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # chunked streaming needs 1.1

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload: dict,
                      retry_after_s: float = 1.0):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if code == 503:
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(round(retry_after_s)))))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, items):
                self._headers_sent = True
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for item in items:
                    piece = (json.dumps(item) + "\n").encode()
                    self.wfile.write(
                        f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")

            def _dispatch(self, body: Optional[bytes]):
                t_arrival = time.monotonic() if perf.ENABLED else 0.0
                path = self.path.split("?")[0].rstrip("/") or "/"
                if path == "/-/healthz":
                    self._json(503 if proxy._draining else 200,
                               {"status": "draining"
                                if proxy._draining else "ok"})
                    return
                if path == "/-/routes":
                    with proxy._lock:
                        self._json(200, dict(proxy._routes))
                    return
                if proxy._draining:
                    self._json(503, {"error": "proxy draining"})
                    return
                if not proxy._inflight.acquire(blocking=False):
                    # Backpressure at ingress: reject NOW rather than
                    # stacking unbounded handler threads on a saturated
                    # cluster (max_ongoing_requests role).
                    self._json(503, {"error": "too many in-flight "
                                              "requests"})
                    return
                try:
                    # Serve request = trace entry point: the span below
                    # mints a trace_id (no enclosing context in a proxy
                    # thread), and the replica task submitted by
                    # handle.remote() inherits it via TaskSpec.
                    with observability.span("serve.request", cat="serve",
                                            route=path):
                        name = proxy._match(path)
                        if name is None:
                            self._json(404, {"error": "no route"})
                            return
                        arg = None
                        if body:
                            try:
                                arg = json.loads(body)
                            except json.JSONDecodeError:
                                arg = body
                        if isinstance(arg, (bytes, bytearray)):
                            arg = proxy._maybe_put_ingress(arg)
                        handle = proxy._get_handle(name)
                        # Perf breakdown: queue_wait (semaphore + routing
                        # + body handling, the pre-dispatch share) vs
                        # execute (replica round-trip) vs serialize
                        # (response encode + write).
                        t_exec = time.monotonic() if t_arrival else 0.0
                        if t_arrival:
                            perf.observe("serve.queue_wait",
                                         (t_exec - t_arrival) * 1e3)
                        result = handle.remote(arg).result(
                            timeout=proxy._timeout_s)
                        t_ser = time.monotonic() if t_arrival else 0.0
                        if t_arrival:
                            perf.observe("serve.execute",
                                         (t_ser - t_exec) * 1e3)
                        try:
                            if (isinstance(result, (list, tuple))
                                    and self.headers.get("X-Serve-Stream")):
                                self._stream(result)
                                return
                            self._send_value(result)
                        finally:
                            if t_arrival:
                                now = time.monotonic()
                                perf.observe("serve.serialize",
                                             (now - t_ser) * 1e3)
                except Exception as e:  # noqa: BLE001 - surface to caller
                    if getattr(self, "_headers_sent", False):
                        # Mid-stream failure: a second status line would
                        # corrupt the half-sent chunked body AND poison
                        # the keep-alive connection — just sever it.
                        self.close_connection = True
                        try:
                            self.wfile.flush()
                        except OSError:
                            pass
                    elif isinstance(e, ServeOverloadedError):
                        # Serve shed the request (router: every replica
                        # over budget; replica: queue-deadline ageout).
                        self._json(503, {"error": str(e)},
                                   retry_after_s=e.retry_after_s)
                    elif isinstance(e, TimeoutError):
                        # Includes the router's bounded pick (no replica
                        # freed a slot within serve_queue_deadline_ms):
                        # overload presents as a fast 503, never a hang.
                        self._json(503, {"error": str(e)})
                    else:
                        self._json(500, {"error": str(e)})
                finally:
                    proxy._inflight.release()
                    if t_arrival:
                        perf.observe("serve.request",
                                     (time.monotonic() - t_arrival) * 1e3)

            def _send_value(self, result):
                body = json.dumps(result).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._dispatch(None)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                self._dispatch(self.rfile.read(length) if length else None)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serve-http-proxy")
        self._thread.start()

    def _update_routes(self, table: Dict[str, str]) -> None:
        with self._lock:
            self._routes = dict(table)
            keep, dropped = {}, []
            for name, handle in self._handles.items():
                if name in table.values():
                    keep[name] = handle
                else:
                    dropped.append(handle)
            self._handles = keep
        # Shut down routers of dropped handles outside the lock so their
        # long-poll threads don't leak controller listener slots.
        for handle in dropped:
            try:
                handle.shutdown()
            except Exception as e:
                logger.debug("handle shutdown failed: %s", e)

    def _maybe_put_ingress(self, body):
        """Large raw (non-JSON) request bodies go into the object plane
        and ride to the replica as a ref: the bulk bytes then move over
        the shared striped transport pool (proactive push / striped
        fetch) instead of being pickled into the task args — the serve
        half of ROADMAP item 5's TCP-throughput chase.  The replica sees
        the original bytes (task args auto-resolve refs)."""
        threshold = int(_config.get("serve_ingress_put_threshold_bytes"))
        if threshold <= 0 or len(body) < threshold:
            return body
        import ray_tpu_torch as ray_tpu
        t0 = time.monotonic() if perf.ENABLED else 0.0
        try:
            ref = ray_tpu.put(bytes(body))
        except Exception as e:  # noqa: BLE001 — inline args still correct
            logger.debug("serve ingress put failed (%s); "
                         "falling back to inline body", e)
            return body
        if t0:
            perf.observe("serve.ingress_put",
                         (time.monotonic() - t0) * 1e3)
        return ref

    def _match(self, path: str) -> Optional[str]:
        with self._lock:
            # Longest-prefix match, '/' as catch-all.
            best = None
            for prefix, name in self._routes.items():
                p = prefix.rstrip("/") or "/"
                if path == p or path.startswith(p + "/") or p == "/":
                    if best is None or len(p) > len(best[0]):
                        best = (p, name)
            return best[1] if best else None

    def _get_handle(self, name: str) -> DeploymentHandle:
        with self._lock:
            if name not in self._handles:
                self._handles[name] = DeploymentHandle(name, self._controller)
            return self._handles[name]

    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._draining = True
        self._poller.stop()
        self._server.shutdown()
        self._server.server_close()
