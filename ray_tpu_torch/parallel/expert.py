"""Expert parallelism: switch-style MoE with ``all_to_all`` dispatch.

Port of ``ray_tpu/parallel/expert.py``. Experts shard over the ``expert``
mesh axis; tokens route to their expert's rank via one ``all_to_all`` and
come back by another. Top-1 (switch) routing with a capacity limit;
dropped tokens pass through the residual path.

``moe_apply`` takes DTensors (``x`` and the router replicated, expert
params sharded over ``axis`` on their leading dim) and returns a
replicated DTensor; given plain tensors it is the per-rank body itself,
with this rank's experts' params.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch.parallel.spmd import (all_to_all, from_local, to_local,
                                         tree_map)


def _moe_local(x_loc, rw, params, expert_fn, mesh, axis, n_exp_total,
               capacity_factor):
    """The per-rank dispatch (the reference's ``per_device``)."""
    n_shards = mesh.shape[axis]
    exp_per_shard = n_exp_total // n_shards
    tokens, d = x_loc.shape
    capacity = max(1, int(capacity_factor * tokens / n_exp_total))
    gates = torch.softmax(x_loc @ rw, dim=-1)                 # [T, E]
    expert_idx = torch.argmax(gates, dim=-1)                  # [T], first max
    gate_val = gates.gather(-1, expert_idx[:, None])[:, 0]    # [T]
    # Position of each token within its expert's capacity buffer.
    onehot = torch.nn.functional.one_hot(expert_idx, n_exp_total)
    pos_in_expert = (torch.cumsum(onehot, dim=0) - 1) * onehot  # [T, E]
    pos = torch.sum(pos_in_expert, dim=-1)                    # [T]
    keep = pos < capacity
    slot = torch.clamp(pos, 0, capacity - 1)
    # Scatter tokens into [E, capacity, d] dispatch buffer.
    disp = torch.zeros((n_exp_total, capacity, d), dtype=x_loc.dtype,
                       device=x_loc.device).index_put(
        (expert_idx, slot), torch.where(keep[:, None], x_loc, 0.0),
        accumulate=True)
    # Exchange: [E, cap, d] -> experts grouped by owning shard.
    disp = disp.reshape(n_shards, exp_per_shard, capacity, d)
    recv = all_to_all(disp, mesh, axis)
    # recv: [n_shards, exp_per_shard, capacity, d] — all shards' tokens
    # destined for MY experts. Flatten senders into the capacity dim.
    recv = recv.transpose(0, 1).reshape(exp_per_shard, n_shards * capacity,
                                        d)
    out = torch.func.vmap(expert_fn)(params, recv)
    # Undo: [exp_per_shard, n_shards, capacity, d] -> all_to_all back.
    out = out.reshape(exp_per_shard, n_shards, capacity, d).transpose(0, 1)
    back = all_to_all(out, mesh, axis).reshape(n_exp_total, capacity, d)
    # Gather each token's expert output; dropped tokens get zeros.
    y = torch.where(keep[:, None], back[expert_idx, slot], 0.0)
    return x_loc + gate_val[:, None] * y  # residual + gated expert out


def moe_apply(x: torch.Tensor, router_weights: torch.Tensor,
              expert_params: Any, expert_fn: Callable, mesh,
              axis: str = "expert",
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: [tokens, d_model] (replicated over ``axis``); router_weights:
    [d_model, n_experts]; expert_params leaves have leading dim n_experts
    (sharded over ``axis``). Returns [tokens, d_model]."""
    n_exp_total = router_weights.shape[-1]
    n_shards = mesh.shape[axis]
    if n_exp_total % n_shards != 0:
        raise ValueError(f"{n_exp_total} experts not divisible over "
                         f"{n_shards} expert shards")
    dtensor = isinstance(x, DTensor)
    out = _moe_local(to_local(x), to_local(router_weights),
                     tree_map(to_local, expert_params), expert_fn, mesh,
                     axis, n_exp_total, capacity_factor)
    if not dtensor:
        return out
    return from_local(out, mesh, [Replicate() for _ in mesh.axis_names])
