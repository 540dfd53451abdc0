"""Dataset creation APIs.

Parity with ``python/ray/data/read_api.py`` (range/from_items/from_pandas/
from_numpy/from_arrow, read_{csv,parquet,json,numpy,text,binary_files}).
Reads are parallelized: one read task per file / per range shard.

Port of ``ray_tpu/data/read_api.py``, over the port's runtime.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import normalize_block
from ray_tpu_torch.data.dataset import Dataset


def _put_blocks(blocks: List[Any]) -> Dataset:
    return Dataset([ray_tpu_torch.put(normalize_block(b)) for b in blocks])


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    import builtins
    n = max(1, min(parallelism, len(items) or 1))
    per = math.ceil(len(items) / n) if items else 0
    blocks = ([items[i * per:(i + 1) * per] for i in builtins.range(n)]
              if items else [[]])
    return _put_blocks([b for b in blocks if b] or [[]])


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    import builtins
    per = math.ceil(n / parallelism) if n else 0
    blocks = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi:
            break
        blocks.append(list(builtins.range(lo, hi)))
    return _put_blocks(blocks or [[]])


def range_table(n: int, *, parallelism: int = 8) -> Dataset:
    import pandas as pd
    import builtins
    per = math.ceil(n / parallelism) if n else 0
    blocks = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi:
            break
        blocks.append(pd.DataFrame({"value": list(builtins.range(lo, hi))}))
    return _put_blocks(blocks or [[]])


def from_pandas(dfs: Union[Any, List[Any]]) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return _put_blocks(dfs)


def from_arrow(tables: Union[Any, List[Any]]) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return _put_blocks(tables)


def from_numpy(arrays: Union[np.ndarray, List[np.ndarray]]) -> Dataset:
    import pandas as pd
    if not isinstance(arrays, list):
        arrays = [arrays]
    return _put_blocks([pd.DataFrame({"value": list(a)}) for a in arrays])


def _expand_paths(paths: Union[str, List[str]], suffixes=None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for f in sorted(os.listdir(p)):
                fp = os.path.join(p, f)
                if os.path.isfile(fp) and (
                        suffixes is None or
                        any(f.endswith(s) for s in suffixes)):
                    out.append(fp)
        else:
            out.append(p)
    return out


def _read_files(paths, reader, suffixes) -> Dataset:
    files = _expand_paths(paths, suffixes)

    @ray_tpu_torch.remote
    def _read(fp):
        return normalize_block(reader(fp))

    return Dataset([_read.remote(fp) for fp in files])


def read_parquet(paths: Union[str, List[str]], **kw) -> Dataset:
    import pandas as pd
    return _read_files(paths, lambda fp: pd.read_parquet(fp, **kw),
                       [".parquet"])


def read_csv(paths: Union[str, List[str]], **kw) -> Dataset:
    import pandas as pd
    return _read_files(paths, lambda fp: pd.read_csv(fp, **kw), [".csv"])


def read_json(paths: Union[str, List[str]], **kw) -> Dataset:
    import pandas as pd
    kw.setdefault("orient", "records")
    kw.setdefault("lines", True)
    return _read_files(paths, lambda fp: pd.read_json(fp, **kw),
                       [".json", ".jsonl"])


def read_numpy(paths: Union[str, List[str]], **kw) -> Dataset:
    import pandas as pd
    return _read_files(
        paths, lambda fp: pd.DataFrame({"value": list(np.load(fp, **kw))}),
        [".npy"])


def read_text(paths: Union[str, List[str]], *, encoding="utf-8") -> Dataset:
    def _reader(fp):
        with open(fp, encoding=encoding) as f:
            return [line.rstrip("\n") for line in f]
    return _read_files(paths, _reader, None)


def read_binary_files(paths: Union[str, List[str]]) -> Dataset:
    def _reader(fp):
        with open(fp, "rb") as f:
            return [f.read()]
    return _read_files(paths, _reader, None)


def read_tfrecords(paths: Union[str, List[str]]) -> Dataset:
    """TFRecord files of tf.train.Example protos -> tabular rows
    (reference ``read_api.py read_tfrecords``; dependency-free codec in
    ``data/tfrecords.py``)."""
    import pandas as pd

    from ray_tpu_torch.data.tfrecords import decode_example, read_tfrecord_file

    def _reader(fp):
        rows = [decode_example(rec) for rec in read_tfrecord_file(fp)]
        return pd.DataFrame(rows)

    return _read_files(paths, _reader, [".tfrecord", ".tfrecords"])
