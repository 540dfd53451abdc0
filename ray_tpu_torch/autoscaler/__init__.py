"""Autoscaling: demand-driven node launch/terminate.

Parity with ``python/ray/autoscaler/`` (``StandardAutoscaler``
``_private/autoscaler.py:147``, ``LoadMetrics``, the pluggable
``NodeProvider`` API ``node_provider.py``, and the in-process
``FakeMultiNodeProvider`` ``_private/fake_multi_node/node_provider.py:237``
used by CI). Each ``update()`` reads the runtime's unmet demand, launches
nodes for it and terminates nodes idle past the timeout; ``start()`` runs
it on a monitor thread. The GPU deployment target is GPU VMs: the
``GPUNodeProvider`` models node types like ``a3-highgpu-8g``
(``{"CPU": 208, "GPU": 8}``); the fake provider adds/removes nodes of the
in-process runtime for tests, and ``ProcessCluster.node_provider`` spawns
daemon processes, one owning a card where its type asks for a GPU.
"""

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 LoadMetrics,
                                                 StandardAutoscaler)
from ray_tpu_torch.autoscaler.gpu_provider import GPUNodeProvider
from ray_tpu_torch.autoscaler.hazard import HazardEstimator
from ray_tpu_torch.autoscaler.node_provider import (FakeNodeProvider,
                                                    NodeProvider)

__all__ = ["StandardAutoscaler", "AutoscalerConfig", "LoadMetrics",
           "NodeProvider", "FakeNodeProvider", "HazardEstimator",
           "GPUNodeProvider"]
