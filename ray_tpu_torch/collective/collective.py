"""Collective communication API.

Port of ``ray_tpu/collective/collective.py`` (parity with
``python/ray/util/collective/collective.py``): the same group API
(``init_collective_group`` :120, ``create_collective_group`` :151-212,
``allreduce`` :258, ``barrier`` :298, ``reduce`` :311, ``broadcast`` :373,
``allgather`` :423, ``reducescatter`` :472, ``send/recv`` :531,594,
``destroy_collective_group`` :216) with backends ``nccl`` (CUDA tensors,
``torch.cuda.nccl``) and ``cpu`` (numpy). Group state lives in a
process-global registry — the host-granular analogue of the reference's
per-process ``GroupManager`` + named-``Info``-actor rendezvous
(``collective.py:40-112``).

Only the in-process half is ported: every rank of a group is a thread of
this process. The JAX package's process-spanning group
(``xla_process_group.py``, on the multi-process runtime) waits for ROADMAP
Queue 1's process half of ``collective/``.

The comms ledger records each op's duration on the host clock. For CUDA
tensors that is the time to enqueue the op unless the caller synchronizes
(``synchronize``); no op synchronizes by itself.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.collective.collective_group.cpu_group import (
    CPUGroup, CPUGroupShared)
from ray_tpu_torch.collective.collective_group.nccl_group import (
    NCCLGroup, NCCLGroupShared)
from ray_tpu_torch.collective.types import Backend, CollectiveConfig, ReduceOp

_registry_lock = threading.Lock()
_shared_groups: Dict[str, Any] = {}        # group_name -> Shared state  # raylint: guarded-by(_registry_lock)
_local_groups = threading.local()          # per-caller rank-bound groups


def _spans_processes() -> bool:
    """True when this caller is one rank of a PROCESS-spanning group. This
    package has only the in-process runtime (no ``DistributedRuntime``
    yet), so every group's ranks are threads of this process."""
    return False


class GroupManager:
    """Per-caller map of group_name -> rank-bound group object."""

    @staticmethod
    def _groups() -> Dict[str, Any]:
        if not hasattr(_local_groups, "groups"):
            _local_groups.groups = {}
        return _local_groups.groups

    @staticmethod
    def _resolve_config(config: Optional[CollectiveConfig]) -> CollectiveConfig:
        """Explicit config wins; otherwise the process-wide knobs decide
        (``collective_compression`` / ``quant_block_bytes`` /
        ``collective_ranks_per_host``), so a whole deployment can flip to
        q8 wire — or the autopilot's collective policy can flip it from
        ledgered busbw — without touching call sites."""
        if config is not None:
            return config
        from ray_tpu_torch._private.config import _config
        return CollectiveConfig(
            compression=str(_config.get("collective_compression")),
            quant_block_bytes=int(_config.get("quant_block_bytes")),
            ranks_per_host=int(_config.get("collective_ranks_per_host")))

    @classmethod
    def create_group(cls, backend: str, world_size: int, rank: int,
                     group_name: str, devices: Optional[List] = None,
                     config: Optional[CollectiveConfig] = None):
        backend = Backend(backend)
        config = cls._resolve_config(config)
        if backend == Backend.NCCL and devices is None and _spans_processes():
            # The JAX package's rank-per-process group (XLAProcessGroup,
            # the reference's NCCL-group path, nccl_collective_group.py:127)
            # runs on the multi-process runtime.
            raise NotImplementedError(
                "process-spanning collective groups are not ported yet "
                "(ROADMAP Queue 1: the process half of collective/, "
                "xla_process_group.py and tensor_plane.py)")
        with _registry_lock:
            shared = _shared_groups.get(group_name)
            if shared is None:
                if backend == Backend.NCCL:
                    shared = NCCLGroupShared(world_size, devices,
                                             label=group_name)
                else:
                    shared = CPUGroupShared(world_size, devices,
                                            label=group_name)
                shared.join_count = 0
                _shared_groups[group_name] = shared
            else:
                if shared.world_size != world_size:
                    raise ValueError(
                        f"group {group_name!r} exists with world_size="
                        f"{shared.world_size}, requested {world_size}")
                existing_backend = (Backend.NCCL
                                    if isinstance(shared, NCCLGroupShared)
                                    else Backend.CPU)
                if existing_backend != backend:
                    raise ValueError(
                        f"group {group_name!r} exists with backend "
                        f"{existing_backend!r}, requested {backend!r}")
            shared.join_count += 1
        group_cls = (NCCLGroup if isinstance(shared, NCCLGroupShared)
                     else CPUGroup)
        g = group_cls(world_size, rank, group_name, shared, config=config)
        cls._groups()[group_name] = g
        return g

    @classmethod
    def get_group(cls, group_name: str):
        return cls._groups().get(group_name)

    @classmethod
    def destroy_group(cls, group_name: str):
        """Detach this caller; shared state is freed when the last rank
        leaves (a single rank's destroy must not split the group)."""
        g = cls._groups().pop(group_name, None)
        if g is None:
            return
        g.destroy()
        with _registry_lock:
            shared = _shared_groups.get(group_name)
            if shared is g._shared:
                shared.join_count -= 1
                if shared.join_count <= 0:
                    _shared_groups.pop(group_name, None)


def is_group_initialized(group_name: str = "default") -> bool:
    return GroupManager.get_group(group_name) is not None


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default",
                          devices: Optional[List] = None,
                          config: Optional[CollectiveConfig] = None):
    """Join a collective group from inside an actor/task (collective.py:120)."""
    if world_size <= 0 or not (0 <= rank < world_size):
        raise ValueError(f"invalid world_size={world_size} rank={rank}")
    if is_group_initialized(group_name):
        raise RuntimeError(f"group {group_name!r} already initialized here")
    return GroupManager.create_group(backend, world_size, rank, group_name,
                                     devices, config)


def create_collective_group(actors: List, world_size: int,
                            ranks: List[int], backend: str = "nccl",
                            group_name: str = "default",
                            devices: Optional[List] = None,
                            config: Optional[CollectiveConfig] = None):
    """Driver-side declarative setup (collective.py:151-212): instructs each
    actor to join the group with its assigned rank."""
    from ray_tpu_torch._private import worker as _worker
    if len(actors) != world_size or sorted(ranks) != list(range(world_size)):
        raise ValueError("actors/ranks must cover 0..world_size-1")
    refs = [actor.__ray_collective_init__.remote(world_size, rank, backend,
                                                 group_name, devices, config)
            for actor, rank in zip(actors, ranks)]
    return _worker.get(refs)


def destroy_collective_group(group_name: str = "default"):
    GroupManager.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    g = GroupManager.get_group(group_name)
    return g.rank if g is not None else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = GroupManager.get_group(group_name)
    return g.world_size if g is not None else -1


def _group(group_name: str):
    g = GroupManager.get_group(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "actor/task; call init_collective_group first")
    return g


def _op_group(args: tuple, kwargs: dict) -> str:
    """Recover ``group_name`` from any collective signature: it is the
    only string positional (tensors, ranks and ReduceOps never are)."""
    return (kwargs.get("group_name")
            or next((a for a in args if isinstance(a, str)), "default"))


# numpy/torch dtype __str__ costs more than the whole ledger write; the
# distinct dtypes crossing the collective API are a handful, so memoize.
_dtype_strs: Dict[Any, str] = {}


def _dtype_str(dtype) -> str:
    try:
        s = _dtype_strs.get(dtype)
    except TypeError:               # unhashable dtype-like: stringify raw
        return str(dtype)
    if s is None:
        s = _dtype_strs[dtype] = str(dtype)
    return s


def _collective_wait(fn):
    """The single seam every collective op passes through.

    Attributes the blocking time to the goodput ledger's
    ``collective_wait`` category (first-trace compile inside the op
    opens a nested ``compile`` interval, which pauses this one — the
    exclusivity rule keeps the two from double-counting), records the
    completed op into the comms ledger (bytes / dtype / duration →
    algbw/busbw), and exposes the ``collective.op`` chaos injection
    point so a fault schedule can delay one rank into the rendezvous —
    the drill the comms plane's skew attribution must catch.
    """
    op_name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import time as _time
        from ray_tpu_torch import chaos
        from ray_tpu_torch.observability import comms, goodput, perf
        if chaos.ENABLED:
            group = _op_group(args, kwargs)
            chaos.inject("collective.op", group=group, op=op_name,
                         rank=str(get_rank(group)))
        if not comms.ENABLED:
            if not goodput.ENABLED:
                return fn(*args, **kwargs)
            with goodput.interval("collective_wait"):
                return fn(*args, **kwargs)
        group = _op_group(args, kwargs)
        t0 = _time.monotonic()
        if goodput.ENABLED:
            with goodput.interval("collective_wait"):
                result = fn(*args, **kwargs)
        else:
            result = fn(*args, **kwargs)
        dur = _time.monotonic() - t0
        # bytes/dtype come from the tensor argument when there is one
        # (never for barrier; recv reports its received tensor).
        obj = args[0] if args else None
        nbytes = getattr(obj, "nbytes", None)
        if nbytes is None:
            nbytes = getattr(result, "nbytes", 0) or 0
        dtype = getattr(obj, "dtype", None) or getattr(result, "dtype", "")
        # Compressed ops leave the bytes that actually crossed the wire
        # on the group object (payload + scales); None means wire ==
        # logical and the ledger keeps a 1.0 compression ratio.
        g = GroupManager.get_group(group)
        wire = getattr(g, "_last_wire", None) if g is not None else None
        comms.record_op(group, op_name, int(nbytes), _dtype_str(dtype), dur,
                        world_size=get_collective_group_size(group),
                        wire_bytes=wire)
        if perf.ENABLED:
            perf.observe("collective.op", dur * 1e3)
        return result
    return wrapper


@_collective_wait
def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _group(group_name).allreduce(tensor, op)


@_collective_wait
def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    return _group(group_name).reduce(tensor, dst_rank, op)


@_collective_wait
def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name).broadcast(tensor, src_rank)


@_collective_wait
def allgather(tensor, group_name: str = "default"):
    return _group(group_name).allgather(tensor)


@_collective_wait
def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    return _group(group_name).reducescatter(tensor, op)


@_collective_wait
def send(tensor, dst_rank: int, group_name: str = "default"):
    return _group(group_name).send(tensor, dst_rank)


@_collective_wait
def recv(src_rank: int, group_name: str = "default"):
    return _group(group_name).recv(src_rank)


@_collective_wait
def barrier(group_name: str = "default"):
    return _group(group_name).barrier()


def synchronize(group_name: str = "default"):
    """Block until pending device work completes: ``torch.cuda.synchronize``,
    which is what the reference does (``collective.py:655``). A process
    that never used CUDA has nothing pending."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
