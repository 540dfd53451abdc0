"""ray_tpu_torch.checkpoint — the on-disk manifest format of the JAX
package's checkpoint engine (``ray_tpu/checkpoint``).

Only ``manifest.py`` is ported so far: the runtime's timeline dump and
flight recorder use its ``atomic_write_bytes``. The async sharded engine and
the checkpoint cadence come with ROADMAP Queue 1's ``train/`` and
``checkpoint/`` item.
"""

from ray_tpu_torch.checkpoint.manifest import (CheckpointCorruption,
                                               CheckpointError,
                                               CheckpointNotFound, Manifest,
                                               ShardIndex,
                                               atomic_write_bytes,
                                               list_manifest_names,
                                               read_manifest, resolve_latest)

__all__ = [
    "CheckpointError", "CheckpointCorruption", "CheckpointNotFound",
    "Manifest", "ShardIndex", "atomic_write_bytes", "list_manifest_names",
    "read_manifest", "resolve_latest",
]
