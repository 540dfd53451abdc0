"""Node provider plugin API + the in-process fake provider.

Parity with ``python/ray/autoscaler/node_provider.py`` (the abstract
cloud-provider interface every deployment implements) and
``fake_multi_node/node_provider.py:237`` (nodes simulated in-process,
used by ``test_autoscaler_fake_multinode.py``). A real GPU provider
(``gpu_provider.GPUNodeProvider``) calls the Compute Engine API to obtain
GPU VMs; the interface is deliberately identical so that swap is
config-only.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Minimal lifecycle interface (create/terminate/list)."""

    def __init__(self, provider_config: Optional[dict] = None):
        self.provider_config = provider_config or {}

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def node_resources(self, provider_node_id: str) -> Dict[str, float]:
        raise NotImplementedError

    def node_type(self, provider_node_id: str) -> str:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Launches nodes into a live in-process ``Runtime``.

    ``node_types`` maps type name -> resource dict, e.g.
    ``{"a3-highgpu-8g": {"CPU": 208, "GPU": 8}}``.
    """

    def __init__(self, runtime, node_types: Dict[str, Dict[str, float]]):
        super().__init__()
        self._runtime = runtime
        self._node_types = dict(node_types)
        self._lock = threading.Lock()
        self._nodes: Dict[str, Any] = {}   # provider id -> runtime Node
        self._types: Dict[str, str] = {}

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return [pid for pid, node in self._nodes.items() if node.alive]

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        from ray_tpu_torch._private.resources import ResourceSet
        if node_type not in self._node_types:
            raise ValueError(f"unknown node type {node_type!r}")
        created = []
        for _ in range(count):
            node = self._runtime.add_node(
                ResourceSet(dict(self._node_types[node_type])),
                labels={"autoscaler-node-type": node_type})
            pid = f"fake-{node_type}-{uuid.uuid4().hex[:6]}"
            with self._lock:
                self._nodes[pid] = node
                self._types[pid] = node_type
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(provider_node_id, None)
            self._types.pop(provider_node_id, None)
        if node is not None:
            self._runtime.remove_node(node.node_id)

    def node_resources(self, provider_node_id: str) -> Dict[str, float]:
        with self._lock:
            t = self._types.get(provider_node_id)
        return dict(self._node_types.get(t, {}))

    def node_type(self, provider_node_id: str) -> str:
        with self._lock:
            return self._types[provider_node_id]

    def runtime_node_id(self, provider_node_id: str):
        with self._lock:
            return self._nodes[provider_node_id].node_id
