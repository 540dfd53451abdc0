from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.placement_group import (  # noqa: F401
    placement_group, placement_group_table, remove_placement_group)

__all__ = ["ActorPool", "placement_group", "placement_group_table",
           "remove_placement_group"]
