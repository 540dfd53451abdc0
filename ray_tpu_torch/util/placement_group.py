"""Placement groups.

Parity with ``python/ray/util/placement_group.py`` (``placement_group()``
:127, ``PlacementGroup`` :33, ``remove_placement_group`` :228,
``placement_group_table`` :267). Strategies PACK/SPREAD/STRICT_PACK/
STRICT_SPREAD map to the bundle policies in
``ray_tpu/_private/scheduler.py`` (reference:
``src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h:73-97``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.resources import ResourceSet

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID):
        self.id = pg_id

    def ready(self):
        """Returns an ObjectRef resolving to this PG once scheduled."""
        from ray_tpu_torch.remote_function import remote
        from ray_tpu_torch._private import worker as _worker
        rt = _worker.global_worker().runtime
        state = rt.placement_groups[self.id]

        @remote
        def _await_ready():
            state.ready.wait()
            if state.state != "CREATED":
                from ray_tpu_torch.exceptions import PlacementGroupSchedulingError
                raise PlacementGroupSchedulingError(
                    f"placement group is {state.state}")
            return True
        return _await_ready.options(num_cpus=0).remote()

    def wait(self, timeout_seconds: float = 30) -> bool:
        from ray_tpu_torch._private import worker as _worker
        rt = _worker.global_worker().runtime
        state = rt.placement_groups.get(self.id)
        if state is None:
            return False
        if not state.ready.wait(timeout_seconds):
            return False
        return state.state == "CREATED"

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        from ray_tpu_torch._private import worker as _worker
        rt = _worker.global_worker().runtime
        state = rt.placement_groups[self.id]
        return [b.to_dict() for b in state.bundles]

    def __reduce__(self):
        return (PlacementGroup, (self.id,))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or all(v == 0 for v in b.values()):
            raise ValueError("bundles must request positive resources")
    from ray_tpu_torch._private import worker as _worker
    rt = _worker.global_worker().runtime
    state = rt.create_placement_group(
        [ResourceSet(b) for b in bundles], strategy, name)
    return PlacementGroup(state.pg_id)


def remove_placement_group(pg: PlacementGroup):
    from ray_tpu_torch._private import worker as _worker
    _worker.global_worker().runtime.remove_placement_group(pg.id)


def placement_group_table() -> Dict[str, dict]:
    from ray_tpu_torch._private import worker as _worker
    rt = _worker.global_worker().runtime
    out = {}
    for pg_id, state in rt.placement_groups.items():
        out[pg_id.hex()] = {
            "placement_group_id": pg_id.hex(),
            "name": state.name,
            "strategy": state.strategy,
            "state": state.state,
            "bundles": {i: b.to_dict() for i, b in enumerate(state.bundles)},
            "bundle_nodes": ([n.hex() for n in state.bundle_nodes]
                             if state.bundle_nodes else None),
        }
    return out


def get_current_placement_group() -> Optional[PlacementGroup]:
    from ray_tpu_torch._private.runtime import task_context
    pg = task_context.placement_group
    return pg
