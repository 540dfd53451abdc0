from ray_tpu_torch.experimental.state.api import (list_actors, list_nodes,
                                                  list_objects,
                                                  list_placement_groups,
                                                  list_tasks,
                                                  summarize_actors,
                                                  summarize_tasks)

__all__ = [
    "list_tasks", "list_actors", "list_objects", "list_nodes",
    "list_placement_groups", "summarize_tasks", "summarize_actors",
]
