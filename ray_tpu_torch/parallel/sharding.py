"""Logical-axis sharding rules, as DTensor placements.

Port of ``ray_tpu/parallel/sharding.py``. Parameters and activations are
described by *logical* axis names ("embed", "heads", "batch", ...); a
``ShardingRules`` table maps each to a mesh axis (or replication).
``DEFAULT_RULES``, ``ShardingRules.spec`` (with ``strict=`` and its
one-shot warning), ``with_overrides`` and ``_axes_mismatch_path`` are
copied unchanged; ``spec`` returns a plain tuple, one entry per tensor dim,
the counterpart of a ``PartitionSpec``.

A ``PartitionSpec`` is per tensor dim, while DTensor placements are per
mesh dim, so ``ShardingRules.sharding`` translates: tensor dim ``d``
sharded over mesh axes ``(a, b)`` gives ``Shard(d)`` on the mesh dims of
``a`` and ``b`` (the batch's ``("data", "fsdp")`` is the common case; the
axes must follow mesh order, as ``AXIS_ORDER`` has them), and every mesh
dim no tensor dim names is ``Replicate()``. Leaves are placed with
``distribute_tensor``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

logger = logging.getLogger("ray_tpu_torch")

MeshAxes = Union[None, str, Tuple[str, ...]]
Placements = Tuple[Placement, ...]

# Logical-axis names already warned about this process — a typo surfaces
# once, loudly, instead of flooding every step.
_warned_axes: set = set()


DEFAULT_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": ("data", "fsdp"),      # per-example axis: all data-parallel axes
    "seq": "seq",                   # sequence/context parallelism
    "act_embed": None,              # activation feature dim stays replicated
    "act_heads": "tensor",
    # parameters
    "embed": "fsdp",                # ZeRO-3: shard params along embed over fsdp
    "vocab": "tensor",
    "heads": "tensor",              # attention heads over tensor axis
    "kv": None,
    "mlp": "tensor",                # ffn hidden over tensor axis
    # mixture of experts
    "expert": "expert",
    # pipeline
    "stage": "pipe",
}


@dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, MeshAxes] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **overrides: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(merged)

    def spec(self, logical_axes: Tuple[Optional[str], ...],
             strict: bool = False) -> Tuple[MeshAxes, ...]:
        """Partition spec (one entry per tensor dim) for a tensor described
        by logical axis names.

        An axis name missing from the table replicates that dimension.
        With ``strict=True`` an *unknown* name (as opposed to one mapped
        to ``None`` on purpose) raises instead — a one-character typo
        would otherwise silently replicate a tensor; the default path
        logs a one-shot warning per unknown name.
        """
        parts = []
        used = set()
        for ax in logical_axes:
            if ax is None:
                parts.append(None)
                continue
            if ax not in self.rules:
                if strict:
                    raise ValueError(
                        f"unknown logical axis {ax!r}: not in this "
                        f"ShardingRules table (known: "
                        f"{', '.join(sorted(self.rules))}); without "
                        "strict=True this dimension would silently "
                        "replicate")
                if ax not in _warned_axes:
                    _warned_axes.add(ax)
                    logger.warning(
                        "ShardingRules: unknown logical axis %r replicates "
                        "its dimension (known: %s); pass strict=True to "
                        "raise on typos", ax,
                        ", ".join(sorted(self.rules)))
                parts.append(None)
                continue
            mesh_axes = self.rules.get(ax)
            if mesh_axes is None:
                parts.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            fresh = tuple(a for a in mesh_axes if a not in used)
            used.update(fresh)
            if not fresh:
                parts.append(None)
            elif len(fresh) == 1:
                parts.append(fresh[0])
            else:
                parts.append(fresh)
        return tuple(parts)

    def cleaned_spec(self, mesh, logical_axes: Tuple[Optional[str], ...],
                     strict: bool = False) -> Tuple[MeshAxes, ...]:
        """``spec`` on *mesh*, dropping mesh axes sized 1 there.

        With ``strict=True``, unknown logical names raise (see ``spec``)
        and so does a rule naming a mesh axis this mesh does not have —
        geometry drift between the rules table and the mesh.  Size-1
        axes are still dropped silently in both modes: a collapsed axis
        is legitimate single-way parallelism, not a typo.
        """
        spec = self.spec(logical_axes, strict=strict)
        # Drop axes not present in (or sized 1 on) this mesh.
        cleaned = []
        for part in spec:
            if part is None:
                cleaned.append(None)
            elif isinstance(part, tuple):
                missing = [a for a in part if a not in mesh.axis_names]
                if missing and strict:
                    raise ValueError(
                        f"rules name mesh axes {missing} absent from this "
                        f"mesh (axes: {', '.join(mesh.axis_names)})")
                keep = tuple(a for a in part if a in mesh.axis_names
                             and mesh.shape[a] > 1)
                cleaned.append(keep if keep else None)
            else:
                if part not in mesh.axis_names and strict:
                    raise ValueError(
                        f"rules name mesh axis {part!r} absent from this "
                        f"mesh (axes: {', '.join(mesh.axis_names)})")
                cleaned.append(part if part in mesh.axis_names
                               and mesh.shape[part] > 1 else None)
        return tuple(cleaned)

    def sharding(self, mesh, logical_axes: Tuple[Optional[str], ...],
                 strict: bool = False) -> Placements:
        """DTensor placements (one per mesh dim) on *mesh*: the
        counterpart of the reference's ``NamedSharding``."""
        return spec_to_placements(
            mesh, self.cleaned_spec(mesh, logical_axes, strict=strict))


def spec_to_placements(mesh, spec: Sequence[MeshAxes]) -> Placements:
    """Translate a per-tensor-dim spec into per-mesh-dim placements: each
    mesh axis a tensor dim names gets ``Shard(dim)``, the rest
    ``Replicate()``. A dim over several mesh axes must name them in mesh
    order: DTensor splits a dim over mesh dims outermost first."""
    placements = [Replicate() for _ in mesh.axis_names]
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"tensor dim {dim} is sharded over {axes}, out of mesh "
                f"order {mesh.axis_names}; DTensor cannot express that")
        for i in order:
            placements[i] = Shard(dim)
    return tuple(placements)


def _axes_mismatch_path(tree: Any, axes: Any,
                        path: str = "") -> Optional[str]:
    """First path where ``axes`` stops mirroring ``tree``, else None.

    Containers (dict/list/tuple) of ``tree`` must be matched by the same
    container shape in ``axes``; at a ``tree`` leaf any axes value is
    acceptable (tuples of names, a single name, or None).
    """
    if isinstance(tree, dict):
        if not isinstance(axes, dict):
            return (f"{path or '<root>'}: tree has a dict, axes_tree has "
                    f"{type(axes).__name__}")
        if set(tree) != set(axes):
            missing = sorted(set(tree) - set(axes))
            extra = sorted(set(axes) - set(tree))
            detail = []
            if missing:
                detail.append(f"missing keys {missing}")
            if extra:
                detail.append(f"extra keys {extra}")
            return f"{path or '<root>'}: {', '.join(detail)}"
        for k in sorted(tree):
            sub = _axes_mismatch_path(tree[k], axes[k], f"{path}[{k!r}]")
            if sub is not None:
                return sub
        return None
    if isinstance(tree, (list, tuple)):
        if not isinstance(axes, type(tree)) or len(axes) != len(tree):
            return (f"{path or '<root>'}: tree has {type(tree).__name__} "
                    f"of {len(tree)}, axes_tree has "
                    f"{type(axes).__name__} of "
                    f"{len(axes) if isinstance(axes, (list, tuple)) else 1}")
        for i, (t, a) in enumerate(zip(tree, axes)):
            sub = _axes_mismatch_path(t, a, f"{path}[{i}]")
            if sub is not None:
                return sub
    return None


def _map_with_axes(fn, tree, axes):
    """``fn(leaf, axes)`` over the dict/list/tuple containers of ``tree``
    (``axes`` already checked by ``_axes_mismatch_path``)."""
    if isinstance(tree, dict):
        return {k: _map_with_axes(fn, tree[k], axes[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_axes(fn, t, a)
                          for t, a in zip(tree, axes))
    return fn(tree, axes)


def shard_pytree(tree: Any, axes_tree: Any, mesh,
                 rules: Optional[ShardingRules] = None,
                 strict: bool = False) -> Any:
    """Place every leaf as a DTensor with the placements derived from its
    logical axes (``distribute_tensor``: rank 0's values are scattered).

    ``axes_tree`` mirrors ``tree`` with tuples of logical axis names; a
    mis-shaped ``axes_tree`` raises naming the first mismatched path.
    ``strict`` is forwarded to :meth:`ShardingRules.sharding`.
    """
    rules = rules or ShardingRules()
    where = _axes_mismatch_path(tree, axes_tree)
    if where is not None:
        raise ValueError(f"axes_tree does not mirror tree at {where}")

    def _place(leaf, axes):
        return distribute_tensor(leaf, mesh.device_mesh,
                                 rules.sharding(mesh, axes, strict=strict))

    return _map_with_axes(_place, tree, axes_tree)


def batch_sharding(mesh, rules: Optional[ShardingRules] = None,
                   ndim: int = 2) -> Placements:
    """Placements for a [batch, ...] input array."""
    rules = rules or ShardingRules()
    return rules.sharding(mesh, ("batch",) + (None,) * (ndim - 1))


def replicated(mesh) -> Placements:
    return tuple(Replicate() for _ in mesh.axis_names)


def local_slice(tensor: torch.Tensor, mesh, placements: Placements
                ) -> torch.Tensor:
    """This rank's block of ``tensor`` (the same on every rank) under
    ``placements``: each ``Shard(d)``, outermost mesh dim first, keeps this
    rank's equal part of dim ``d``. The split must be even."""
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.shape[mesh.axis_names[i]]
            if tensor.shape[p.dim] % n:
                raise ValueError(
                    f"dim {p.dim} of size {tensor.shape[p.dim]} does not "
                    f"split evenly over {n} ranks of {mesh.axis_names[i]!r}")
            tensor = tensor.chunk(n, dim=p.dim)[
                mesh.axis_index(mesh.axis_names[i])]
    return tensor


def place_local(tensor: torch.Tensor, mesh, placements: Placements
                ) -> DTensor:
    """``DTensor.from_local`` of this rank's ``local_slice`` of ``tensor``,
    which every rank holds whole (a host batch)."""
    return DTensor.from_local(local_slice(tensor, mesh, placements),
                              mesh.device_mesh, placements, run_check=False,
                              shape=tensor.shape, stride=tensor.stride())
