"""Parallelism on ``torch.distributed``: the port of ``ray_tpu/parallel``.

Mesh axes (``mesh``), logical-axis sharding rules as DTensor placements
(``sharding``), per-rank bodies and their differentiable collectives
(``spmd``), ring attention (``sequence``), the GPipe schedule
(``pipeline``) and switch MoE (``expert``).
"""

from ray_tpu_torch.parallel.expert import moe_apply
from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, Mesh, MeshConfig,
                                         build_mesh, single_axis_mesh)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from ray_tpu_torch.parallel.sequence import ring_attention
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                             batch_sharding, replicated,
                                             shard_pytree)
from ray_tpu_torch.parallel.spmd import run_spmd

__all__ = [
    "MeshConfig", "build_mesh", "single_axis_mesh", "AXIS_ORDER",
    "ShardingRules", "DEFAULT_RULES", "shard_pytree", "batch_sharding",
    "replicated", "pipeline_apply", "stack_stage_params", "ring_attention",
    "moe_apply", "Mesh", "run_spmd",
]
