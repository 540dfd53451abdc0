"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``.

``ray_tpu_torch/X`` is the counterpart of ``ray_tpu/X``: the same paths and
public names, written in PyTorch idiom, with every Pallas kernel of the JAX
package replaced by a CUDA kernel written by hand for Hopper (``sm_90a``).
The package never imports ``jax`` or ``ray_tpu``.

The package root exports the in-process runtime (``init`` → ``@remote`` →
``get``: tasks, actors, the object store, placement groups), with GPUs as
its accelerator resource: ``init(num_gpus=...)`` and
``get_runtime_context().get_gpu_devices()`` take the place of the JAX
package's ``num_tpus`` and ``get_tpu_devices()``. A ``torch.Tensor`` is a
device object, stored by reference and refused at ``get`` once written in
place. ``init(address=...)`` joins a multi-process cluster
(``cluster_utils.ProcessCluster``: a state-service process and host-daemon
processes that own their cards); a tensor crosses processes as its host
bytes and lands on the receiver's default device.

On top of it: ``models.transformer`` runs its attention through the CUDA
flash-attention kernels in ``ops``, ``air.TorchPredictor`` holds the weights
on the card, ``serve`` runs deployments in replica actors behind handles and
an HTTP proxy (``serve.batch`` pads requests to static buckets), ``train``
steps the model, ``data`` feeds it datasets (``iter_device_batches``,
``air.BatchPredictor``, ``TorchTrainer(datasets=)``), and ``parallel``
shards the step over ``torch.distributed``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises rather than falling back.
"""

from __future__ import annotations

import os as _os
from typing import Optional, Union

if _os.environ.get("RAY_TPU_LOCKWATCH"):
    # Must install before any submodule import so module-level locks are
    # wrapped too; see ray_tpu_torch/devtools/lockwatch.py.
    from ray_tpu_torch.devtools import lockwatch as _lockwatch
    _lockwatch.install()

import torch  # noqa: E402

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``.

    Raises ``RuntimeError`` when a CUDA device is asked for and this
    process has none: the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


from ray_tpu_torch._private.config import _config  # noqa: E402,F401
from ray_tpu_torch._private.worker import (  # noqa: E402
    available_resources, cancel, cluster_resources, drain_node, get,
    get_actor, init, is_initialized, kill, nodes, put,
    register_named_actor_class, register_named_function,
    set_profiling_enabled, set_tracing_enabled, shutdown, timeline, wait)
from ray_tpu_torch.actor import ActorClass, ActorHandle, ActorMethod  # noqa: E402
from ray_tpu_torch.exceptions import (ActorDiedError,  # noqa: E402
                                      GetTimeoutError, ObjectLostError,
                                      RayTpuError, TaskCancelledError,
                                      TaskError)
from ray_tpu_torch.object_ref import ObjectRef  # noqa: E402
from ray_tpu_torch.remote_function import RemoteFunction, remote  # noqa: E402
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: E402

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "available_resources", "cluster_resources",
    "drain_node",
    "register_named_actor_class",
    "register_named_function", "set_profiling_enabled",
    "set_tracing_enabled",
    "nodes", "timeline", "ObjectRef", "ActorClass", "ActorHandle",
    "ActorMethod",
    "RemoteFunction", "get_runtime_context",
    "RayTpuError", "TaskError", "ActorDiedError", "ObjectLostError",
    "GetTimeoutError", "TaskCancelledError",
    "resolve_device", "DeviceLike",
]
