"""R29 fixture: the static collective-cost manifest.

Positive case: ``_leak`` psums over a mesh axis no AXIS_ORDER or
DeviceMesh(...) in the tree declares, so the op can never be planned in
comms_manifest.json and would always report as unplanned runtime drift.
Clean twins: ``_ring`` reduces over a declared axis and ``sync`` runs
explicit collective-API ops with a literal group, both of which land in
the manifest.
"""

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ray_tpu_torch import collective
from ray_tpu_torch.parallel.spmd import psum


def _ring(x, mesh):
    return psum(x, mesh, "tensor")


def _leak(x, mesh):
    return psum(x, mesh, "ghost_axis")


def build(x):
    mesh = init_device_mesh("cuda", (2, 2),
                            mesh_dim_names=("data", "tensor"))
    dist.all_reduce(x, group=mesh.group("tensor"))
    dist.all_reduce(x)
    ok = _ring(x, mesh)
    leak = _leak(x, mesh)
    return ok, leak


def sync(t):
    out = collective.allreduce(t, group_name="fixture")
    collective.barrier(group_name="fixture")
    return out
