"""Pipeline parallelism: the GPipe schedule over the ``pipe`` mesh axis.

Port of ``ray_tpu/parallel/pipeline.py``. Stages live on the ``pipe`` axis.
The whole S-stage × M-microbatch schedule runs on every rank: at each of
the M + S - 1 steps every stage applies ``stage_fn`` to its input (stage 0
injects microbatch t, the others take what just arrived), bubbles
included, then activations rotate one hop along the pipe ring via
``ppermute``. The last stage records microbatch t - S + 1, and a ``psum``
over the axis replicates the outputs to every stage. Bubbles are the
standard (S-1)/(M+S-1) fraction.

Every stage computes on every step, as the reference does, so every rank
builds the same autograd graph and issues its backward collectives in the
same order; the per-stage choices are ``torch.where`` on the stage index.

``pipeline_apply`` takes DTensors (stage params sharded over ``axis`` on
their leading dim, the batch optionally over ``data_axis``) and returns a
DTensor placed like the batch; given plain tensors it is the per-rank body
itself: the params are this stage's ``[1, ...]`` slice and ``x`` this
rank's batch block.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.spmd import (from_local, ppermute, psum, to_local,
                                         tree_map)


def _pipeline_local(stage_fn: Callable, params: Any, x: torch.Tensor, mesh,
                    axis: str, num_microbatches: int) -> torch.Tensor:
    """The per-rank GPipe schedule (the reference's ``per_device``)."""
    n_stages = mesh.shape[axis]
    params = tree_map(lambda p: p[0], params)   # this stage's slice
    stage = mesh.axis_index(axis)
    local_batch = x.shape[0]
    if local_batch % num_microbatches != 0:
        raise ValueError(
            f"per-device batch {local_batch} not divisible by "
            f"num_microbatches {num_microbatches}")
    mb_size = local_batch // num_microbatches
    mbs = x.reshape((num_microbatches, mb_size) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    total_steps = num_microbatches + n_stages - 1
    carry = torch.zeros_like(mbs[0])
    outs = []
    for t in range(total_steps):
        # Stage 0 injects microbatch t; other stages consume the
        # activation that just arrived from the previous stage.
        inject = mbs[min(t, num_microbatches - 1)]
        y = stage_fn(params, torch.where(first, inject, carry))
        # Last stage records its result for microbatch (t - S + 1).
        if t >= n_stages - 1:
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        # Rotate activations one hop forward along the pipe ring (the
        # last step's rotation would go unused).
        if t + 1 < total_steps:
            carry = ppermute(y, mesh, axis, perm)
    # Replicate final outputs from the last stage onto every stage.
    out = psum(torch.stack(outs), mesh, axis)
    return out.reshape((local_batch,) + tuple(x.shape[1:]))


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, num_microbatches: int, axis: str = "pipe",
                   data_axis: Optional[str] = "data") -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over mesh axis ``axis``.

    stage_fn(params_for_one_stage, activation[mb, ...]) -> activation
    stage_params: tree whose leaves have leading dim = n_stages (sharded
        over ``axis``).
    x: [batch, ...] input (batch optionally sharded over ``data_axis``;
        that is the DTensor's placement, read from it).
    Returns [batch, ...] output with the same placement as the input batch.
    """
    n_stages = mesh.shape[axis]
    if n_stages == 1:
        return stage_fn(tree_map(lambda p: p[0], stage_params), x)
    placements = x.placements if isinstance(x, DTensor) else None
    out = _pipeline_local(stage_fn, tree_map(to_local, stage_params),
                          to_local(x), mesh, axis, num_microbatches)
    return out if placements is None else from_local(out, mesh, placements)


def stack_stage_params(params_per_stage: list) -> Any:
    """Stack per-stage trees into leading-stage-dim tensors for sharding."""
    return tree_map(lambda *xs: torch.stack(xs), *params_per_stage)
