from ray_tpu_torch.collective.collective import (
    allgather, allreduce, barrier, broadcast, create_collective_group,
    destroy_collective_group, get_collective_group_size, get_rank,
    init_collective_group, is_group_initialized, recv, reduce, reducescatter,
    send, synchronize)
from ray_tpu_torch.collective.types import Backend, CollectiveConfig, ReduceOp

__all__ = [
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "is_group_initialized", "get_rank",
    "get_collective_group_size", "allreduce", "allgather", "reducescatter",
    "broadcast", "reduce", "send", "recv", "barrier", "synchronize",
    "Backend", "CollectiveConfig", "ReduceOp",
]
