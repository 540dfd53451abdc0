"""In-process multi-node cluster for tests.

Parity with ``python/ray/cluster_utils.py:99`` (``Cluster.add_node`` :165):
spin up N virtual nodes under one runtime so multi-node scheduling, placement
groups, spilling, and failure handling run in CI without real hosts — the
same role the reference's Cluster plays for multi-raylet tests.

The JAX package's ``ProcessCluster`` (real state-service and host-daemon
processes) needs the multi-process runtime, which is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.resources import CPU, GPU, ResourceSet


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None):
        self._worker = _worker.init(_create_default_node=False,
                                    ignore_reinit_error=False)
        self._nodes = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def runtime(self):
        return self._worker.runtime

    def add_node(self, num_cpus: Optional[float] = None,
                 num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 **kwargs):
        amounts: Dict[str, float] = {
            CPU: num_cpus if num_cpus is not None else float(os.cpu_count() or 1)}
        if num_gpus:
            amounts[GPU] = num_gpus
        if resources:
            amounts.update(resources)
        node = self.runtime.add_node(ResourceSet(amounts))
        self._nodes.append(node)
        return node

    def remove_node(self, node):
        self.runtime.remove_node(node.node_id)

    def shutdown(self):
        _worker.shutdown()
