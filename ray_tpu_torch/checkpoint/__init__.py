"""ray_tpu_torch.checkpoint — async sharded checkpointing with crash-atomic
commit, content-hash dedup, and reshard-on-restore.

Port of ``ray_tpu/checkpoint``: the engine writes the JAX package's
on-disk format (see engine.py for the save/commit pipeline and what
differs for tensor leaves), and the cadence solver is copied.
"""

from ray_tpu_torch.checkpoint.cadence import (CadenceController,
                                              solve_interval_steps)
from ray_tpu_torch.checkpoint.engine import (CheckpointEngine, CheckpointRef,
                                             EngineStats, SaveHandle, load)
from ray_tpu_torch.checkpoint.manifest import (CheckpointCorruption,
                                               CheckpointError,
                                               CheckpointNotFound, Manifest,
                                               ShardIndex,
                                               atomic_write_bytes,
                                               list_manifest_names,
                                               read_manifest, resolve_latest)

__all__ = [
    "CadenceController", "solve_interval_steps",
    "CheckpointEngine", "CheckpointRef", "EngineStats", "SaveHandle", "load",
    "CheckpointError", "CheckpointCorruption", "CheckpointNotFound",
    "Manifest", "ShardIndex", "atomic_write_bytes", "list_manifest_names",
    "read_manifest", "resolve_latest",
]
