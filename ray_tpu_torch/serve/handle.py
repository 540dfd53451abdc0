"""DeploymentHandle: the Python-side entry point for calling a deployment.

Parity with ``python/ray/serve/handle.py``: ``handle.remote(...)`` routes a
request through the router (round-robin + max_concurrent_queries) and
returns a response object whose ``.result()`` blocks for the value.
``handle.method_name.remote(...)`` calls a specific method.

Port of ``ray_tpu/serve/handle.py``. One change: the handle builds its
router under a lock (the JAX package's can build one per racing thread).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch.serve._private.router import Router, _TrackedRef


class DeploymentResponse:
    def __init__(self, tracked: _TrackedRef):
        self._tracked = tracked

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._tracked.result(timeout)

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
        tracked = self._get_router().assign_request(method_name, args, kwargs)
        return DeploymentResponse(tracked)

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
