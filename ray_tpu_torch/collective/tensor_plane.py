"""Multi-host tensor plane: state-KV-brokered ``torch.distributed`` rendezvous.

Port of ``ray_tpu/collective/tensor_plane.py``. This is the piece that makes
collectives span daemon *processes* (and hosts). The reference bootstraps
its NCCL communicators by parking an ``NCCLUniqueID`` in a named store actor
that every rank reads
(``python/ray/util/collective/collective_group/nccl_collective_group.py:54-95``)
and its torch trainers run ``dist.init_process_group`` with a rank-0
address (``python/ray/train/torch/config.py:54-96``). Here every process
calls ``torch.distributed.init_process_group`` on rank 0's ``TCPStore``
address, and from then on the default process group is the plane's world:
collectives ride NCCL between cards (gloo between CPU processes), not this
control plane.

What the state-service KV brokers here, keyed by (group, epoch):
- the coordinator address (rank 0 probes a free port and publishes it),
- the world size (so mismatched joins fail loudly),
- a liveness epoch: after a failure the group re-forms under epoch+1, and
  stale processes destroy their old process group before rejoining.

The backend is ``nccl`` when this process owns a card and ``gloo`` when it
does not. One rank is one process and one device: the JAX package's
``num_cpu_devices`` (``RAY_TPU_TP_CPU_DEVICES``, set by
``ProcessCluster(tp_cpu_devices=)``) gives each process that many virtual
XLA devices; here it only asks for ``gloo``, and the plane records
``local_devices=1`` and ``global_devices=world``.

A dead rank does not abort its peers as JAX's coordination service does: a
peer blocked in a collective waits for the process group's timeout, which
is the plane's ``timeout_s`` (gloo's default is 30 minutes). On cards,
``TORCH_NCCL_ASYNC_ERROR_HANDLING`` makes NCCL tear the communicator down
when that timeout fires.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from datetime import timedelta
from typing import Optional

logger = logging.getLogger("ray_tpu")

KV_NS = b"tplane"

_lock = threading.Lock()
_active_plane: Optional[dict] = None  # {"group", "epoch", "world", "rank"}

_epoch_gauge = None


def _mark(event: str, group: str, epoch: int, **args) -> None:
    """Epoch lifecycle breadcrumb: a trace instant (when tracing is on)
    plus the ``tplane_epoch`` gauge, so a doctor correlating collective
    stalls can see exactly when a plane formed, re-formed, or went away
    (epoch -1).  Re-forms used to vanish silently."""
    global _epoch_gauge
    try:
        import ray_tpu_torch.observability as _obs
        _obs.instant(f"tplane:{event}", cat="comms", group=group,
                     epoch=epoch, **args)
        if _epoch_gauge is None:
            from ray_tpu_torch.observability.metric_names import (
                TPLANE_EPOCH_GAUGE)
            from ray_tpu_torch.util import metrics
            # raylint: allow(data-race) idempotent lazy gauge init; the metrics registry dedups by name
            _epoch_gauge = metrics.Gauge(
                TPLANE_EPOCH_GAUGE,
                "active tensor-plane epoch per group (-1 once shut down)",
                ("group",))
        # Bounded cardinality: tag is the collective group name, a small
        # application-chosen set, never a per-task or per-object id.
        _epoch_gauge.set(float(epoch), tags={"group": group})
    except Exception:
        logger.debug("tplane lifecycle mark failed", exc_info=True)


def _runtime_and_kv(runtime=None):
    """The distributed runtime + its state-service KV."""
    if runtime is None:
        from ray_tpu_torch._private import worker as _worker
        runtime = _worker.try_global_runtime()
    state = getattr(runtime, "state", None)
    if state is None:
        raise RuntimeError(
            "tensor plane needs a cluster (ray_tpu_torch.init(address=...) "
            "or a host daemon); no state service in this process")
    return runtime, state


def _free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _backend_and_device(num_cpu_devices: Optional[int]):
    """``("nccl", this rank's card)`` when the process owns a card and no
    CPU plane was asked for, else ``("gloo", cpu)``. The card is the
    caller's first granted one, else the current one."""
    import torch
    if num_cpu_devices is None:
        env_n = os.environ.get("RAY_TPU_TP_CPU_DEVICES")
        if env_n:
            num_cpu_devices = int(env_n)
    if num_cpu_devices is None and torch.cuda.is_available():
        from ray_tpu_torch._private.runtime import task_context
        cards = [d for d in (task_context.devices or [])
                 if torch.device(d).type == "cuda"]
        device = (torch.device(cards[0]) if cards else
                  torch.device("cuda", torch.cuda.current_device()))
        return "nccl", device
    return "gloo", torch.device("cpu")


def current_plane() -> Optional[dict]:
    with _lock:
        return dict(_active_plane) if _active_plane else None


def _leave_world() -> None:
    import torch.distributed as dist
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        logger.debug("destroy_process_group failed", exc_info=True)


def init_tensor_plane(group_name: str, world_size: int, rank: int,
                      *, epoch: int = 0, num_cpu_devices: Optional[int] = None,
                      timeout_s: float = 60.0, runtime=None) -> dict:
    """Join the process-spanning tensor plane for ``group_name``/``epoch``.

    Must be called at most once per (group, epoch) per process; one process
    is one rank (the device-owner stance: a CUDA context and a rank of the
    default process group are per process, and NCCL refuses two ranks on
    one card). Re-joining under a newer epoch destroys the previous
    process group first — that is how a group re-forms after a member
    died. ``timeout_s`` bounds the rendezvous and every collective of the
    world (module note).
    """
    import torch.distributed as dist

    runtime, state = _runtime_and_kv(runtime)
    key = f"{group_name}/{epoch}".encode()

    with _lock:
        global _active_plane
        if _active_plane is not None:
            if (_active_plane["group"] == group_name
                    and _active_plane["epoch"] == epoch):
                if _active_plane["rank"] != rank:
                    raise RuntimeError(
                        f"process already joined {group_name}@{epoch} as "
                        f"rank {_active_plane['rank']}, not {rank}")
                return dict(_active_plane)
            # Older (or different) plane: leave it before rejoining.
            _mark("reform", group_name, epoch,
                  old_group=_active_plane["group"],
                  old_epoch=_active_plane["epoch"])
            _leave_world()
            _active_plane = None

    backend, device = _backend_and_device(num_cpu_devices)
    if backend == "nccl":
        import torch
        # A collective that outlives the timeout (a dead peer) tears the
        # communicator down and raises instead of hanging the process.
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        # The rank's card is the process's current one: a DeviceMesh over
        # the world picks its communicators' device from it.
        torch.cuda.set_device(device)

    if rank == 0:
        # Advertise the host peers can actually reach: the address this
        # daemon registered with the cluster (loopback only on
        # single-machine clusters).
        addr = getattr(runtime, "address", "") or "127.0.0.1:0"
        host = addr.rsplit(":", 1)[0] or "127.0.0.1"
        coord = f"{host}:{_free_port(host)}"
        state.kv_put(key, f"{coord}|{world_size}".encode(),
                     overwrite=True, namespace=KV_NS)
    else:
        deadline = time.monotonic() + timeout_s
        coord = None
        while time.monotonic() < deadline:
            raw = state.kv_get(key, namespace=KV_NS)
            if raw:
                coord_s, world_s = raw.decode().split("|")
                if int(world_s) != world_size:
                    raise ValueError(
                        f"group {group_name}@{epoch} exists with world_size "
                        f"{world_s}, joined with {world_size}")
                coord = coord_s
                break
            time.sleep(0.02)
        if coord is None:
            raise TimeoutError(
                f"rank {rank}: no coordinator for {group_name}@{epoch} "
                f"within {timeout_s}s")

    if dist.is_initialized():
        # A world this plane does not own (e.g. a trainer's world of one):
        # one process has one default process group.
        raise RuntimeError(
            f"cannot join {group_name}@{epoch}: this process already has a "
            f"torch.distributed world that is not a tensor plane")
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=world_size,
            rank=rank, timeout=timedelta(seconds=timeout_s),
            **({"device_id": device} if backend == "nccl" else {}))
    except Exception as e:
        # Rank 0's store binds the probed port after the probe closed it:
        # another process may have taken it in between.
        raise RuntimeError(
            f"rank {rank} could not join {group_name}@{epoch} at {coord} "
            f"({backend}): {type(e).__name__}: {e}") from e
    plane = {"group": group_name, "epoch": epoch, "world": world_size,
             "rank": rank, "coordinator": coord, "backend": backend,
             "device": str(device), "local_devices": 1,
             "global_devices": world_size}
    with _lock:
        _active_plane = plane
    _mark("join", group_name, epoch, rank=rank, world=world_size,
          devices=plane["global_devices"])
    logger.info("tensor plane %s@%d up: rank %d/%d over %s",
                group_name, epoch, rank, world_size, backend)
    return dict(plane)


def shutdown_tensor_plane():
    with _lock:
        global _active_plane
        if _active_plane is None:
            return
        gone = _active_plane
        _leave_world()
        _active_plane = None
    _mark("shutdown", gone["group"], -1, last_epoch=gone["epoch"])
