"""Device-mesh planning: the axes every parallelism strategy hangs off.

Port of ``ray_tpu/parallel/mesh.py``. ``AXIS_ORDER`` and ``MeshConfig`` are
copied unchanged. The mesh is a ``torch.distributed`` ``DeviceMesh`` over
the ranks of the initialized world (one rank per card on ``cuda`` with
NCCL, one process per rank on ``cpu`` with gloo), with one named dimension
per axis in ``AXIS_ORDER``, so every axis has its own process group.
``Mesh`` wraps it with the reference's read-only view (``mesh.shape[axis]``,
``mesh.axis_names``), so call sites read like the reference's.

There is no fallback: ``build_mesh`` on ``cuda`` raises when the world has
more ranks than the process sees cards, and on either device when
``torch.distributed`` is not initialized (``parallel.spmd.run_spmd`` starts
the ranks).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch import DeviceLike, resolve_device

# Canonical axis order, outermost (slowest-varying) first.
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


@dataclass
class MeshConfig:
    """Sizes for each parallelism axis; -1 = absorb remaining devices.

    data   — pure data parallelism (gradient psum)
    fsdp   — data parallelism with parameter sharding (ZeRO-3 style)
    tensor — tensor/model parallelism (Megatron-style, innermost)
    seq    — sequence/context parallelism (ring attention)
    pipe   — pipeline stages (outermost)
    expert — expert parallelism (MoE all_to_all)
    """

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        sizes = {name: getattr(self, name) for name in AXIS_ORDER}
        wild = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {n_devices}")
        out = MeshConfig(**sizes)
        return out

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, name) for name in AXIS_ORDER)

    def nontrivial_axes(self) -> List[str]:
        return [n for n in AXIS_ORDER if getattr(self, n) > 1]


class Mesh:
    """A ``DeviceMesh`` seen as the reference's ``jax.sharding.Mesh``:
    ``shape`` maps each axis name to its size, in mesh order."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.mesh.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def dim(self, axis: str) -> int:
        """Index of ``axis`` among the mesh dimensions."""
        return self.axis_names.index(axis)

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis``."""
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def build_mesh(config: MeshConfig, device: DeviceLike = None,
               ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build the named mesh over ``ranks`` (default: every rank of the
    world), laid out row-major in ``AXIS_ORDER``. Every rank of the world
    must call it, also one outside ``ranks``: each process group is created
    collectively. A bare ``cuda`` device means the ranks share this
    machine's cards, one each; a card with its index (``cuda:0``) is this
    rank's own, as in a daemon that owns one card."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialized torch.distributed world "
            "(start the ranks with ray_tpu_torch.parallel.run_spmd)")
    world = dist.get_world_size()
    if (device.type == "cuda" and device.index is None
            and torch.cuda.device_count() < world):
        raise RuntimeError(
            f"a mesh over {world} ranks on cuda needs {world} cards, this "
            f"process sees {torch.cuda.device_count()}")
    ranks = list(range(world)) if ranks is None else list(ranks)
    cfg = config.resolved(len(ranks))
    layout = torch.tensor(ranks, dtype=torch.int).reshape(cfg.axis_sizes())
    return Mesh(DeviceMesh(device.type, layout, mesh_dim_names=AXIS_ORDER))


def single_axis_mesh(axis: str = "data", device: DeviceLike = None) -> Mesh:
    sizes = {a: 1 for a in AXIS_ORDER}
    sizes[axis] = -1
    return build_mesh(MeshConfig(**sizes), device)
