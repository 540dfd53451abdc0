"""DeploymentHandle: the Python-side entry point for calling a deployment.

Parity with ``python/ray/serve/handle.py``: ``handle.remote(...)`` routes a
request through the router (round-robin + max_concurrent_queries) and
returns a response object whose ``.result()`` blocks for the value.
``handle.method_name.remote(...)`` calls a specific method.

Port of ``ray_tpu/serve/handle.py``. Changes: the handle builds its
router under a lock (the JAX package's can build one per racing thread);
each call mints a request id that the replica's batcher adopts, and, with
``profiling_enabled``, records a ``serve.request`` span (args
``request_id``, ``deployment``) from ``remote`` to the ``result`` that got
the value, on the wall clock (``time.time_ns``) a device trace uses.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ray_tpu_torch import observability
from ray_tpu_torch._private.profiling import get_profiler
from ray_tpu_torch.serve._private.router import Router, _TrackedRef


class DeploymentResponse:
    def __init__(self, tracked: _TrackedRef, deployment: str = ""):
        self._tracked = tracked
        self._deployment = deployment
        self._t0_ns = tracked.t0_ns  # the span is open until a value comes

    @property
    def request_id(self) -> str:
        return self._tracked.request_id

    def result(self, timeout: Optional[float] = None) -> Any:
        value = self._tracked.result(timeout)
        if self._t0_ns:
            t0_ns, self._t0_ns = self._t0_ns, 0
            get_profiler().record_ns(
                "serve.request", "serve", observability.process_label(),
                t0_ns, time.time_ns(),
                {"request_id": self._tracked.request_id,
                 "deployment": self._deployment})
        return value

    def ref(self):
        return self._tracked.ref()


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._remote(self._method_name, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller_handle):
        self.deployment_name = deployment_name
        self._controller = controller_handle
        self._router: Optional[Router] = None
        self._router_lock = threading.Lock()

    def _get_router(self) -> Router:
        # One router per handle, also when its first requests come from
        # several threads at once: routers built side by side would each
        # count only their own in-flight requests (and each park a long
        # poll on the controller).
        with self._router_lock:
            if self._router is None:
                self._router = Router(self._controller, self.deployment_name)
            return self._router

    def _remote(self, method_name: str, args, kwargs) -> DeploymentResponse:
        t0_ns = time.time_ns()
        tracked = self._get_router().assign_request(
            method_name, args, kwargs, request_id=observability.mint_id(),
            t0_ns=t0_ns)
        return DeploymentResponse(tracked, self.deployment_name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._remote("__call__", args, kwargs)

    def options(self, method_name: str = "__call__") -> _MethodCaller:
        return _MethodCaller(self, method_name)

    def shutdown(self) -> None:
        """Stop the handle's router (its long-poll thread)."""
        with self._router_lock:
            if self._router is not None:
                self._router.shutdown()
                self._router = None

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_") or name in ("deployment_name",):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def __reduce__(self):
        # Handles are recreated (fresh router) on deserialization.
        return (DeploymentHandle, (self.deployment_name, self._controller))
