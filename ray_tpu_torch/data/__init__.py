"""ray_tpu_torch.data — distributed datasets over the object store.

Port of ``ray_tpu/data``, with parity with ``python/ray/data/``:
block-based Datasets with lazy fused execution, task/actor-pool compute,
two-phase shuffle/sort/groupby, file IO, windowed pipelines.
``iter_device_batches`` (the JAX package's ``iter_jax_batches``) feeds
batches to a CUDA device, or as DTensors onto a mesh.
"""

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.random_access import RandomAccessDataset  # noqa: F401
from ray_tpu_torch.data.dataset import (ActorPoolStrategy, DataIterator,
                                        Dataset, GroupedData,
                                        TaskPoolStrategy)
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
from ray_tpu_torch.data.read_api import (from_arrow, from_items, from_numpy,
                                         from_pandas, range, range_table,
                                         read_binary_files, read_csv,
                                         read_json, read_numpy, read_parquet,
                                         read_text, read_tfrecords)

__all__ = [
    "Dataset", "DataIterator", "RandomAccessDataset", "DatasetPipeline",
    "GroupedData", "BlockAccessor",
    "ActorPoolStrategy", "TaskPoolStrategy",
    "from_items", "from_pandas", "from_arrow", "from_numpy",
    "range", "range_table", "read_csv", "read_parquet", "read_json",
    "read_numpy", "read_text", "read_binary_files", "read_tfrecords",
]
