"""Blocks: the unit of distributed data.

Parity with ``python/ray/data/block.py`` + ``_internal/arrow_block.py`` /
``pandas_block.py`` / ``simple_block.py``: a block is either a plain Python
list ("simple" blocks) or a ``pandas.DataFrame`` ("tabular" blocks; Arrow
tables are accepted at the boundary and held as pandas internally).
``BlockAccessor.for_block`` dispatches format-specific operations.

Port of ``ray_tpu/data/block.py``, unchanged: a ``numpy`` batch of a
column with more than one dimension is still an object array of per-row
arrays (``Dataset.iter_device_batches`` stacks it).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


def _is_tabular(block: Any) -> bool:
    import pandas as pd
    return isinstance(block, pd.DataFrame)


def normalize_block(block: Any):
    """Accept arrow Table / dict-of-arrays / DataFrame / list."""
    import pandas as pd
    try:
        import pyarrow as pa
        if isinstance(block, pa.Table):
            return block.to_pandas()
    except ImportError:
        pass
    if isinstance(block, pd.DataFrame):
        return block
    if isinstance(block, dict):
        # Multi-dim columns (e.g. one-hot, images) become object columns
        # of per-row arrays — pandas requires 1-D column arrays.
        cols = {}
        for k, v in block.items():
            arr = np.asarray(v)
            cols[k] = list(arr) if arr.ndim > 1 else arr
        return pd.DataFrame(cols)
    if isinstance(block, np.ndarray):
        block = list(block)
    else:
        block = list(block)
    # Dict rows become tabular at block creation (the reference stores
    # them as arrow blocks), so "numpy" batches are dicts of column
    # arrays rather than object arrays of dicts.
    if block and isinstance(block[0], dict):
        return pd.DataFrame(block)
    return block


class BlockAccessor:
    def __init__(self, block: Any):
        self._block = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        if _is_tabular(block):
            return PandasBlockAccessor(block)
        return SimpleBlockAccessor(block)

    def num_rows(self) -> int:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        raise NotImplementedError

    def slice(self, start: int, end: int):
        raise NotImplementedError

    def to_pandas(self):
        raise NotImplementedError

    def to_arrow(self):
        import pyarrow as pa
        return pa.Table.from_pandas(self.to_pandas())

    def to_numpy(self, column: Optional[str] = None):
        raise NotImplementedError

    def to_batch(self, batch_format: str):
        if batch_format in ("pandas", "default"):
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        if batch_format == "numpy":
            return self.to_numpy()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def sample_keys(self, n: int, key: Any) -> List[Any]:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    @staticmethod
    def combine(blocks: List[Any]):
        # Empty LIST partitions (e.g. a sort/shuffle range that received
        # no rows) are typeless and must not decide — or break — the
        # concat (pd.concat rejects a bare list mixed with frames).
        # Empty DataFrames are different: they CARRY the schema and must
        # be kept so an all-empty tabular combine preserves its columns.
        typed = [b for b in blocks if not (isinstance(b, list) and not b)]
        if not typed:
            return []
        if _is_tabular(typed[0]):
            import pandas as pd
            return pd.concat(typed, ignore_index=True)
        out: List[Any] = []
        for b in typed:
            out.extend(b)
        return out


class SimpleBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def iter_rows(self):
        return iter(self._block)

    def slice(self, start, end):
        return self._block[start:end]

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({"value": self._block})

    def to_numpy(self, column=None):
        return np.asarray(self._block)

    def sample_keys(self, n, key):
        rows = self._block
        if not rows:
            return []
        idx = random.sample(range(len(rows)), min(n, len(rows)))
        if key is None:
            return [rows[i] for i in idx]
        if callable(key):
            return [key(rows[i]) for i in idx]
        return [rows[i][key] for i in idx]

    def size_bytes(self) -> int:
        import sys
        return sum(sys.getsizeof(r) for r in self._block[:100]) * max(
            1, len(self._block) // max(1, min(100, len(self._block))))


class PandasBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def iter_rows(self):
        for _, row in self._block.iterrows():
            yield dict(row)

    def slice(self, start, end):
        return self._block.iloc[start:end].reset_index(drop=True)

    def to_pandas(self):
        return self._block

    def to_numpy(self, column=None):
        if column is not None:
            return self._block[column].to_numpy()
        # tabular "numpy" batches are dicts of column arrays (ref block.py)
        return {c: self._block[c].to_numpy() for c in self._block.columns}

    def sample_keys(self, n, key):
        df = self._block
        if df.empty:
            return []
        s = df.sample(n=min(n, len(df)))
        if callable(key):
            return [key(dict(r)) for _, r in s.iterrows()]
        return list(s[key])

    def size_bytes(self) -> int:
        return int(self._block.memory_usage(deep=False).sum())
