"""Runtime context for the current driver/task/actor.

Parity with ``python/ray/runtime_context.py``. Addition (the JAX
package's ``get_tpu_devices()``): ``get_gpu_devices()`` returns the
``torch.device``s granted to this task/actor — the analogue of the
reference's CUDA_VISIBLE_DEVICES assignment (``_raylet.pyx:563``), but as
device handles usable in ``tensor.to(device)``.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch._private.runtime import task_context


class RuntimeContext:
    @property
    def job_id(self):
        from ray_tpu_torch._private import worker as _worker
        return task_context.job_id or _worker.global_worker().runtime.job_id

    @property
    def node_id(self):
        from ray_tpu_torch._private import worker as _worker
        nid = task_context.node_id
        if nid is None:
            rt = _worker.global_worker().runtime
            nid = rt.head_node.node_id
        return nid

    @property
    def task_id(self):
        return task_context.task_id

    @property
    def actor_id(self):
        return task_context.actor_id

    @property
    def was_current_actor_reconstructed(self) -> bool:
        from ray_tpu_torch._private import worker as _worker
        aid = task_context.actor_id
        if aid is None:
            return False
        state = _worker.global_worker().runtime.actors.get(aid)
        return state is not None and state.restart_count > 0

    def get_gpu_devices(self) -> List:
        """``torch.device``s granted to the current task/actor (empty for
        CPU tasks and fractional grants)."""
        return list(task_context.devices or [])

    def get_placement_group(self):
        return task_context.placement_group

    def get_assigned_resources(self):
        return {}


_context = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return _context
