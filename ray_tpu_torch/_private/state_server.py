"""JSON state endpoint served from the driver process.

The headless analogue of the reference's dashboard head + state
aggregator (``dashboard/head.py:63``, ``dashboard/state_aggregator.py``):
one HTTP server in the device-owner process exposing cluster state as
JSON plus Prometheus ``/metrics``. The CLI (``ray_tpu_torch.scripts.cli``)
discovers the port through a session file, like the reference's session
directory.

Endpoints:
  /api/status    — node/actor/task counts + resources
  /api/tasks     /api/actors    /api/nodes    /api/objects    /api/pgs
  /api/events    — structured event ring
  /api/timeline  — chrome-tracing JSON of task/actor spans
  /metrics       — Prometheus text exposition
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

#: the port's session dir: ``discover_port`` reads only the port's file,
#: never the JAX package's ``/tmp/ray_tpu``
SESSION_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
PORT_FILE = os.path.join(SESSION_DIR, "state_server_port")

_server_lock = threading.Lock()
_server = None  # raylint: guarded-by(_server_lock)


def start_state_server(port: int = 0) -> int:
    """Start the server on a daemon thread; returns the bound port and
    writes it to the session port file."""
    global _server
    import http.server

    from ray_tpu_torch.experimental.state import api as state_api
    from ray_tpu_torch.util import metrics as metrics_mod

    class Handler(http.server.BaseHTTPRequestHandler):
        def _json(self, payload, code=200):
            body = json.dumps(payload, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/metrics":
                    body = metrics_mod.generate_prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/api/status":
                    self._json(cluster_status())
                elif self.path == "/api/tasks":
                    self._json(state_api.list_tasks())
                elif self.path == "/api/actors":
                    self._json(state_api.list_actors())
                elif self.path == "/api/nodes":
                    self._json(state_api.list_nodes())
                elif self.path == "/api/objects":
                    self._json(state_api.list_objects())
                elif self.path == "/api/pgs":
                    self._json(state_api.list_placement_groups())
                elif self.path == "/api/events":
                    self._json(state_api.list_events())
                elif self.path == "/api/timeline":
                    from ray_tpu_torch._private.profiling import dump_timeline
                    self._json(dump_timeline())
                else:
                    self._json({"error": "unknown endpoint"}, code=404)
            except Exception as e:  # pragma: no cover - defensive
                self._json({"error": repr(e)}, code=500)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    with _server_lock:
        _server = srv
    bound = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="state-server").start()
    os.makedirs(SESSION_DIR, exist_ok=True)
    with open(PORT_FILE, "w") as f:
        f.write(str(bound))
    return bound


def stop_state_server():
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()  # release the listening socket now, not at GC
        try:
            os.unlink(PORT_FILE)
        except OSError:
            pass


def discover_port() -> Optional[int]:
    try:
        with open(PORT_FILE) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def cluster_status() -> dict:
    """The ``ray status`` payload: nodes, resource totals, task/actor
    summaries (reference: ``scripts.py:1461`` status command)."""
    from ray_tpu_torch._private import worker as _worker
    from ray_tpu_torch.experimental.state import api as state_api
    rt = _worker.try_global_runtime()
    if rt is None:
        return {"initialized": False}
    return {
        "initialized": True,
        "nodes": state_api.list_nodes(),
        "task_summary": state_api.summarize_tasks(),
        "actor_summary": state_api.summarize_actors(),
        "cluster_resources": _worker.cluster_resources(),
        "available_resources": _worker.available_resources(),
    }
