"""Per-rank (SPMD) programming on ``torch.distributed``: the counterpart of
``shard_map`` and ``jax.lax.{ppermute, psum, all_to_all}``
(``jax.lax.axis_index`` is ``Mesh.axis_index``).

The reference's ``shard_map`` bodies (ring attention, the pipeline, MoE
dispatch) become per-rank functions over local tensors. Their collectives
differentiate as the reference's do under ``shard_map``:
- ``ppermute``'s backward sends the cotangent along the inverse
  permutation;
- ``psum``'s backward is a ``psum`` of the cotangent;
- ``all_to_all``'s backward is the reverse exchange.

At the boundary (``to_local`` / ``from_local``) a DTensor is taken apart
and put back as ``shard_map`` does with its ``in_specs`` and ``out_specs``:
the cotangent of an input that the body sees whole on a mesh dim (it is
``Replicate`` there) is summed over that dim, and the cotangent of an
output that is ``Replicate`` on a mesh dim is divided by the dim's size, so
that each rank carries its share of it. A body that reduces with ``psum``
then gives each parameter exactly its gradient.

Collectives are issued in program order on every rank, and autograd issues
the backward ones in graph order. Every rank must therefore build the same
graph: a per-rank branch is a ``torch.where`` on a rank-dependent
predicate, never a Python ``if`` (gloo does not raise on a mismatch, it
hangs; ``run_spmd`` bounds every run by a timeout).
"""

from __future__ import annotations

import math
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from ray_tpu_torch import DeviceLike, resolve_device


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict/list/tuple trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _global_rank(mesh, axis: str, index: int) -> int:
    return dist.get_global_rank(mesh.group(axis), index)


def _permute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from each source to its destination along ``axis``; a
    rank that no pair sends to gets zeros (as ``jax.lax.ppermute``)."""
    me = mesh.axis_index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  _global_rank(mesh, axis, dst)))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  _global_rank(mesh, axis, src)))
    if ops:
        # One batch pairs every send with its receive, so a ring of
        # blocking sends cannot deadlock.
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = tuple((dst, src) for src, dst in perm)
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.mesh, ctx.axis, ctx.inverse), None, None, \
            None


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute`` over the ranks of ``axis``: ``perm`` holds
    ``(source, destination)`` coordinates along the axis."""
    return _PPermute.apply(x, mesh, axis, tuple(perm))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _PSum.apply(grad, ctx.group), None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum`` over ``axis``; its backward is a ``psum`` too."""
    if mesh.shape[axis] == 1:
        return x
    return _PSum.apply(x, mesh.group(axis))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # The exchange is its own inverse: block j came from rank j.
        return _AllToAll.apply(grad, ctx.group), None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: ``x[i]`` goes to coordinate ``i`` of ``axis``, and the
    result's ``[j]`` is what coordinate ``j`` sent. ``x.shape[0]`` must be
    the axis size."""
    if x.shape[0] != mesh.shape[axis]:
        raise ValueError(f"all_to_all over {axis!r} of size "
                         f"{mesh.shape[axis]} needs a leading dim of that "
                         f"size, got {tuple(x.shape)}")
    if mesh.shape[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh.group(axis))


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over ``axis`` (no
    gradient: the step gathers token ids with it)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.factor, None


def to_local(x: Any) -> Any:
    """A DTensor's local block, for a per-rank body (``shard_map``'s
    ``in_specs``): on a mesh dim where ``x`` is ``Replicate`` its
    cotangent is summed over the dim. A plain tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    return x.to_local(grad_placements=partial_grads(x.placements,
                                                    x.device_mesh))


def partial_grads(placements, device_mesh):
    """Gradient placements for a per-rank view with ``placements``: the
    ``Replicate`` dims of size > 1 become ``Partial`` (summed when the
    gradient is reduced back); size-1 dims need no collective."""
    return [Partial() if isinstance(p, Replicate) and device_mesh.size(i) > 1
            else p for i, p in enumerate(placements)]


def from_local(x: torch.Tensor, mesh, placements) -> DTensor:
    """A per-rank result as a DTensor (``shard_map``'s ``out_specs``): on
    a mesh dim where ``placements`` is ``Replicate`` the cotangent is
    divided by the dim's size."""
    n_rep = math.prod(mesh.shape[a] for a, p in
                      zip(mesh.axis_names, placements)
                      if isinstance(p, Replicate))
    if n_rep > 1 and x.requires_grad:
        x = _ScaleGrad.apply(x, 1.0 / n_rep)
    return DTensor.from_local(x, mesh.device_mesh, tuple(placements),
                              run_check=False)


# ----------------------------------------------------------------- ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(inbox, rank, n, device_type, port, results):
    """One rank: join the world, run ``fn(*args)``, report, leave."""
    try:
        # The work comes through a queue, not the process's arguments: a
        # spawned child unpickles those before the parent can start the
        # next one, so large arguments would serialize the start-up.
        fn, args = inbox.get()
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=rank, world_size=n,
            **({"device_id": torch.device("cuda", rank)}
               if device_type == "cuda" else {}))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:   # reported to the parent, which raises it
        results.put(("error", rank, traceback.format_exc()))


def run_spmd(fn: Callable, n: int, device: DeviceLike = None,
             timeout_s: float = 300.0, args: Tuple = ()) -> Any:
    """Run ``fn(*args)`` on ``n`` new ranks and return rank 0's result.

    Each rank is a process started with ``spawn`` (so ``fn`` and ``args``
    must pickle), with one thread, in a world of ``n`` over
    ``tcp://localhost``: gloo on ``cpu``, NCCL on ``cuda`` (rank ``r`` on
    card ``r``; raises if there are fewer than ``n`` cards). If a rank
    fails, or the run outlasts ``timeout_s``, every rank is killed and
    this raises (``RuntimeError`` with the rank's traceback, or
    ``TimeoutError``).
    """
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on cuda need {n} cards, this process "
                           f"sees {torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    inboxes = [ctx.Queue() for _ in range(n)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(inboxes[r], r, n, device.type, port, results))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    out, reported = None, set()
    try:
        for p in procs:
            p.start()
        for inbox in inboxes:
            inbox.put((fn, args))
        while len(reported) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_spmd: {n} ranks did not finish in {timeout_s} s "
                    f"(ranks done: {sorted(reported)})")
            try:
                kind, rank, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in reported
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_spmd: rank {dead[0]} exited "
                                       f"with {procs[dead[0]].exitcode}")
                continue
            if kind == "error":
                raise RuntimeError(f"run_spmd: rank {rank} failed:\n"
                                   f"{payload}")
            reported.add(rank)
            if rank == 0:
                out = payload
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5 if len(reported) == n else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
        for q in inboxes + [results]:
            q.close()
            q.cancel_join_thread()
    return out


__all__ = ["all_gather", "all_to_all", "from_local", "ppermute",
           "psum", "run_spmd", "to_local", "tree_map"]
