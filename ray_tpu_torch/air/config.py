"""AIR-style configs.

Port of ``ray_tpu/air/config.py``, which keeps parity with
``python/ray/air/config.py`` (``ScalingConfig``, ``RunConfig``,
``FailureConfig``). ``ScalingConfig.use_gpu`` (Ray's own name) takes the
place of the JAX package's ``use_tpu``: each worker then asks for one
``GPU``. ``topology`` stays a custom resource label.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None  # custom resource label, e.g. "h100-4"

    def worker_resources(self) -> Dict[str, float]:
        r = dict(self.resources_per_worker or {})
        r.setdefault("CPU", 1)
        if self.use_gpu:
            r.setdefault("GPU", 1)
        if self.topology:
            r.setdefault(self.topology, 1)
        return r


@dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = unlimited restarts


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    # int: save every Nth reported checkpoint (0/1 = every one).
    # "auto": risk-tuned cadence — the session solves the Young–Daly
    # interval from the fleet preemption hazard and measured step /
    # checkpoint costs (ray_tpu_torch.checkpoint.cadence), re-tuning as the
    # hazard estimate moves.
    checkpoint_frequency: Union[int, str] = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    # tune.SyncConfig: mirror the experiment dir to durable storage
    sync_config: Optional[Any] = None


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Any]
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None
