"""Random access over a sorted dataset.

Parity with the reference's ``RandomAccessDataset``
(``python/ray/data/random_access_dataset.py``): sort by a key column,
partition the sorted blocks across worker ACTORS, keep the partition
boundaries on the driver, and serve point lookups / multigets by routing
each key to the actor owning its range (binary search on both levels).
The serving-side feature-lookup primitive (e.g. embedding rows) that a
plain ``Dataset`` — optimized for scans — cannot provide.

Port of ``ray_tpu/data/random_access.py``: its workers are the port's
actors.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.dataset import Dataset


@ray_tpu_torch.remote
class _RangeWorker:
    """Holds one sorted partition; answers point lookups."""

    def __init__(self, block, key: str):
        import pandas as pd
        if isinstance(block, list) and not block:
            block = pd.DataFrame({key: []})  # typeless empty partition
        if not isinstance(block, pd.DataFrame):
            raise TypeError(
                "RandomAccessDataset requires column (DataFrame) blocks")
        self._df = block.sort_values(key).reset_index(drop=True)
        self._keys = self._df[key].to_numpy()
        self._key = key

    def get(self, key_value):
        i = int(np.searchsorted(self._keys, key_value))
        if i < len(self._keys) and self._keys[i] == key_value:
            return self._df.iloc[i].to_dict()
        return None

    def multiget(self, key_values: List[Any]) -> List[Optional[dict]]:
        return [self.get(k) for k in key_values]

    def stats(self) -> Dict[str, Any]:
        return {"rows": len(self._df),
                "lo": self._keys[0] if len(self._keys) else None,
                "hi": self._keys[-1] if len(self._keys) else None}


class RandomAccessDataset:
    """O(log n) point lookups over ``ds`` keyed by column ``key``.

    ``num_workers`` actors each own one contiguous key range of the
    sorted data; the driver routes by bisect over the range boundaries.
    """

    def __init__(self, ds: Dataset, key: str, *, num_workers: int = 4):
        self._key = key
        sorted_ds = ds.sort(key).repartition(num_workers)
        refs = sorted_ds.get_internal_block_refs()
        self._workers = [_RangeWorker.remote(r, key) for r in refs]
        stats = ray_tpu_torch.get([w.stats.remote() for w in self._workers])
        keep = [(s, w) for s, w in zip(stats, self._workers)
                if s["rows"] > 0]
        self._workers = [w for _, w in keep]
        # routing table: lower bound of each worker's key range
        self._bounds = [s["lo"] for s, _ in keep]
        self._stats = [s for s, _ in keep]

    def _route(self, key_value) -> int:
        i = bisect.bisect_right(self._bounds, key_value) - 1
        return max(0, i)

    def get_async(self, key_value):
        """ObjectRef of the row dict (or None when absent)."""
        if not self._workers:   # empty source dataset
            return ray_tpu_torch.put(None)
        return self._workers[self._route(key_value)].get.remote(key_value)

    def get(self, key_value, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self.get_async(key_value), timeout=timeout)

    def multiget(self, key_values: List[Any],
                 timeout: Optional[float] = None) -> List[Optional[dict]]:
        """Batched lookup: keys are grouped per owning worker (ONE actor
        call per worker), results re-assembled in input order.
        ``timeout`` bounds the WHOLE call, not each worker."""
        if not self._workers:
            return [None] * len(key_values)
        per_worker: Dict[int, List[int]] = {}
        for pos, k in enumerate(key_values):
            per_worker.setdefault(self._route(k), []).append(pos)
        order = list(per_worker)
        vals_by_worker = ray_tpu_torch.get(
            [self._workers[w].multiget.remote(
                [key_values[p] for p in per_worker[w]]) for w in order],
            timeout=timeout)
        out: List[Optional[dict]] = [None] * len(key_values)
        for w, vals in zip(order, vals_by_worker):
            for p, v in zip(per_worker[w], vals):
                out[p] = v
        return out

    def stats(self) -> List[Dict[str, Any]]:
        return list(self._stats)
