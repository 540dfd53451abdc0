"""DatasetPipeline: windowed / repeated streaming over datasets.

Parity with ``python/ray/data/dataset_pipeline.py`` +
``_internal/pipeline_executor.py``: a pipeline is a sequence of windows
(each a Dataset); per-window transforms are deferred and applied as windows
stream through, so stage N of window W overlaps stage N+1 of window W-1
(execution of the next window's transforms is kicked off eagerly as soon as
the previous window is consumed).

Port of ``ray_tpu/data/dataset_pipeline.py``; ``iter_jax_batches`` is
``iter_device_batches`` here.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, List, Optional

from ray_tpu_torch.data.dataset import Dataset


_NO_REPEAT = 1  # a pipeline without .repeat() runs exactly one epoch


class DatasetPipeline:
    def __init__(self, windows: List[Dataset], repeat: Optional[int] = _NO_REPEAT,
                 transforms: Optional[List[Callable[[Dataset], Dataset]]] = None):
        self._windows = windows
        # number of epochs; None = repeat forever (reference repeat(None))
        self._repeat = repeat
        self._transforms: List[Callable[[Dataset], Dataset]] = list(
            transforms or [])

    # -- transforms (deferred per window) ------------------------------------
    def _with_transform(self, t: Callable[[Dataset], Dataset]) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, self._repeat,
                               self._transforms + [t])

    def map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.map(fn, **kw))

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.map_batches(fn, **kw))

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.filter(fn, **kw))

    def flat_map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.flat_map(fn, **kw))

    def random_shuffle_each_window(self, *, seed=None) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.random_shuffle(seed=seed))

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, times, self._transforms)

    def rewindow(self, *, blocks_per_window: int) -> "DatasetPipeline":
        # _iter_transformed already expands epochs: do not re-apply repeat
        refs: List = []
        for w in self._iter_transformed():
            refs.extend(w._execute())
        windows = [Dataset(refs[i:i + blocks_per_window])
                   for i in range(0, len(refs), blocks_per_window)]
        return DatasetPipeline(windows)

    # -- execution -----------------------------------------------------------
    def _epochs(self) -> Iterator[int]:
        if self._repeat is None:  # repeat forever
            yield from itertools.count()
        else:
            yield from range(self._repeat)

    def _iter_transformed(self) -> Iterator[Dataset]:
        """Yield transformed windows, prefetching the next window's
        execution while the current one is consumed."""
        for _ in self._epochs():
            pending: Optional[Dataset] = None
            for w in self._windows:
                ds = w
                for t in self._transforms:
                    ds = t(ds)
                if pending is not None:
                    yield pending
                ds._execute()  # kick off this window's tasks (prefetch)
                pending = ds
            if pending is not None:
                yield pending

    def iter_datasets(self) -> Iterator[Dataset]:
        return self._iter_transformed()

    def iter_rows(self) -> Iterator[Any]:
        for ds in self._iter_transformed():
            yield from ds.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for ds in self._iter_transformed():
            yield from ds.iter_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        for ds in self._iter_transformed():
            yield from ds.iter_torch_batches(**kw)

    def iter_device_batches(self, **kw) -> Iterator[Any]:
        for ds in self._iter_transformed():
            yield from ds.iter_device_batches(**kw)

    def iter_epochs(self) -> Iterator["DatasetPipeline"]:
        for _ in self._epochs():
            yield DatasetPipeline(self._windows, _NO_REPEAT, self._transforms)

    def split(self, n: int) -> List["DatasetPipeline"]:
        """Split each window across n consumers (reference: pipeline.split
        for per-worker shards). Epochs are already expanded here, so the
        shard pipelines must not re-apply repeat."""
        out: List[List[Dataset]] = [[] for _ in range(n)]
        for w in self._iter_transformed():
            shards = w.split(n)
            for i, s in enumerate(shards):
                out[i].append(s)
        return [DatasetPipeline(ws) for ws in out]

    def count(self) -> int:
        return sum(ds.count() for ds in self._iter_transformed())

    def take(self, n: int = 20) -> List[Any]:
        return list(itertools.islice(self.iter_rows(), n))

    def schema(self):
        for ds in self._iter_transformed():
            return ds.schema()
        return None

    def stats(self) -> str:
        return (f"DatasetPipeline(windows={len(self._windows)}, "
                f"repeat={self._repeat}, "
                f"transforms={len(self._transforms)})")

    __repr__ = stats
