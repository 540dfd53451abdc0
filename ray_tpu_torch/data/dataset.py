"""Distributed Dataset: blocks in the object store + a lazy, fusing plan.

Parity with ``python/ray/data/dataset.py`` and ``_internal/plan.py:69,283``
(lazy ExecutionPlan with stage fusion), ``compute.py:56,146`` (task vs actor
pool compute), ``_internal/{shuffle,sort,push_based_shuffle}.py``.

Design: a Dataset is a list of block ``ObjectRef``s plus a list of pending
stages. One-to-one stages (map/map_batches/filter/flat_map/...) are FUSED
into a single task per block at execution time; all-to-all stages
(repartition/random_shuffle/sort/groupby) run as two-phase map+reduce task
graphs.

Port of ``ray_tpu/data/dataset.py``. Its ``iter_jax_batches`` becomes
``iter_device_batches``: numpy batches as tensors on a device (``cuda`` by
default), each host batch pinned and copied on the consumer's current
stream, and with ``sharding=(mesh, placements)`` placed as this rank's
``DTensor`` of the global batch (``parallel.sharding.place_local``), as
``jax.device_put`` with a ``NamedSharding`` places it in the JAX package.
A column whose cells are numeric arrays of one shape reaches a tensor
stacked (``_stack_column``); the JAX package raises on it.
"""

from __future__ import annotations

import functools
import itertools
import math
import random
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, normalize_block

# --------------------------------------------------------------------------- #
# compute strategies
# --------------------------------------------------------------------------- #


class TaskPoolStrategy:
    """One task per block (reference ``compute.py:56``)."""


class ActorPoolStrategy:
    """Fixed/autoscaling actor pool applying the fused stage
    (reference ``compute.py:146``)."""

    def __init__(self, min_size: int = 1, max_size: Optional[int] = None):
        self.min_size = min_size
        self.max_size = max_size or min_size


@ray_tpu_torch.remote
def _exec_fused_task(fns: Tuple[Callable, ...], block):
    for fn in fns:
        block = fn(block)
    return block


@ray_tpu_torch.remote
class _PoolWorker:
    def exec(self, fns, block):
        for fn in fns:
            block = fn(block)
        return block


# --------------------------------------------------------------------------- #
# stages
# --------------------------------------------------------------------------- #


class _OneToOne:
    def __init__(self, name: str, fn: Callable[[Any], Any],
                 compute: Optional[Any] = None):
        self.name = name
        self.fn = fn
        self.compute = compute or TaskPoolStrategy()


class _AllToAll:
    def __init__(self, name: str, fn: Callable[[List], List]):
        self.name = name
        self.fn = fn  # List[ObjectRef] -> List[ObjectRef]


def _execute_one_to_one(refs: List, fused: List[_OneToOne]) -> List:
    fns = tuple(s.fn for s in fused)
    compute = next((s.compute for s in fused
                    if isinstance(s.compute, ActorPoolStrategy)), None)
    if compute is None:
        return [_exec_fused_task.remote(fns, r) for r in refs]
    pool = [_PoolWorker.remote() for _ in range(compute.min_size)]
    out = [pool[i % len(pool)].exec.remote(fns, r)
           for i, r in enumerate(refs)]
    # release pool actors once results land (results are owned refs)
    ray_tpu_torch.wait(out, num_returns=len(out), timeout=None)
    for w in pool:
        ray_tpu_torch.kill(w)
    return out


# --------------------------------------------------------------------------- #
# Dataset
# --------------------------------------------------------------------------- #


class Dataset:
    def __init__(self, block_refs: List, stages: Optional[List] = None):
        self._block_refs = list(block_refs)
        self._stages: List = list(stages or [])
        self._cached: Optional[List] = None

    # -- plan ----------------------------------------------------------------
    def _with_stage(self, stage) -> "Dataset":
        return Dataset(self._block_refs, self._stages + [stage])

    def _execute(self) -> List:
        """Materialize: fuse runs of one-to-one stages, run all-to-alls."""
        if self._cached is not None:
            return self._cached
        refs = self._block_refs
        pending: List[_OneToOne] = []
        for stage in self._stages:
            if isinstance(stage, _OneToOne):
                pending.append(stage)
            else:
                if pending:
                    refs = _execute_one_to_one(refs, pending)
                    pending = []
                refs = stage.fn(refs)
        if pending:
            refs = _execute_one_to_one(refs, pending)
        self._cached = refs
        return refs

    def materialize(self) -> "Dataset":
        return Dataset(self._execute())

    def get_internal_block_refs(self) -> List:
        return self._execute()

    def _blocks(self) -> List:
        return [ray_tpu_torch.get(r) for r in self._execute()]

    # -- one-to-one transforms ----------------------------------------------
    def map(self, fn: Callable[[Any], Any], *, compute=None) -> "Dataset":
        def _map_block(block):
            acc = BlockAccessor.for_block(block)
            if acc.num_rows() == 0:
                return block
            rows = [fn(r) for r in acc.iter_rows()]
            return _rows_to_block(rows)
        return self._with_stage(_OneToOne("map", _map_block, compute))

    def flat_map(self, fn: Callable[[Any], List[Any]], *,
                 compute=None) -> "Dataset":
        def _fm_block(block):
            acc = BlockAccessor.for_block(block)
            rows: List[Any] = []
            for r in acc.iter_rows():
                rows.extend(fn(r))
            return _rows_to_block(rows)
        return self._with_stage(_OneToOne("flat_map", _fm_block, compute))

    def filter(self, fn: Callable[[Any], bool], *, compute=None) -> "Dataset":
        def _filter_block(block):
            import pandas as pd
            if isinstance(block, pd.DataFrame):
                mask = [bool(fn(r)) for r in
                        BlockAccessor.for_block(block).iter_rows()]
                return block[mask].reset_index(drop=True)
            return [r for r in block if fn(r)]
        return self._with_stage(_OneToOne("filter", _filter_block, compute))

    def map_batches(self, fn: Callable[[Any], Any], *,
                    batch_size: Optional[int] = None,
                    batch_format: str = "default",
                    compute=None, **_ignored) -> "Dataset":
        def _mb_block(block):
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if n == 0:
                return block
            size = batch_size or n
            outs = []
            for start in range(0, n, size):
                piece = acc.slice(start, min(start + size, n))
                batch = BlockAccessor.for_block(piece).to_batch(
                    "pandas" if batch_format == "default" else batch_format)
                out = fn(batch)
                outs.append(normalize_block(out))
            return BlockAccessor.combine(outs)
        return self._with_stage(_OneToOne("map_batches", _mb_block, compute))

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        def _add(df):
            df = df.copy()
            df[name] = fn(df)
            return df
        return self.map_batches(_add, batch_format="pandas")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(lambda df: df.drop(columns=cols),
                                batch_format="pandas")

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(lambda df: df[cols], batch_format="pandas")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(lambda df: df.rename(columns=mapping),
                                batch_format="pandas")

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        def _sample(block):
            rng = random.Random(seed)
            import pandas as pd
            if isinstance(block, pd.DataFrame):
                return block.sample(frac=fraction,
                                    random_state=seed).reset_index(drop=True)
            return [r for r in block if rng.random() < fraction]
        return self._with_stage(_OneToOne("random_sample", _sample))

    # -- all-to-all transforms ----------------------------------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        def _repart(refs: List) -> List:
            blocks = [ray_tpu_torch.get(r) for r in refs]
            merged = BlockAccessor.combine(blocks)
            acc = BlockAccessor.for_block(merged)
            n = acc.num_rows()
            per = math.ceil(n / num_blocks) if num_blocks else n
            out = []
            for i in range(num_blocks):
                out.append(ray_tpu_torch.put(acc.slice(
                    min(i * per, n), min((i + 1) * per, n))))
            return out
        return self._with_stage(_AllToAll("repartition", _repart))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Two-phase push-based shuffle (reference
        ``_internal/push_based_shuffle.py``): map tasks scatter each block
        into N partitions; reduce tasks combine + locally shuffle."""
        def _shuffle(refs: List) -> List:
            n_out = max(1, len(refs))

            @ray_tpu_torch.remote
            def _scatter(block, idx):
                rng = random.Random(None if seed is None else seed + idx)
                acc = BlockAccessor.for_block(block)
                rows = list(acc.iter_rows())
                assign = [rng.randrange(n_out) for _ in rows]
                parts: List[List[Any]] = [[] for _ in range(n_out)]
                for row, a in zip(rows, assign):
                    parts[a].append(row)
                return [_rows_to_block(p) for p in parts]

            @ray_tpu_torch.remote
            def _reduce(parts, idx):
                merged = BlockAccessor.combine(list(parts))
                acc = BlockAccessor.for_block(merged)
                rows = list(acc.iter_rows())
                rng = random.Random(None if seed is None else seed * 7 + idx)
                rng.shuffle(rows)
                return _rows_to_block(rows)

            scattered = [_scatter.remote(r, i) for i, r in enumerate(refs)]
            mats = ray_tpu_torch.get(scattered)  # each: list of n_out blocks
            return [_reduce.remote([m[j] for m in mats], j)
                    for j in range(n_out)]
        return self._with_stage(_AllToAll("random_shuffle", _shuffle))

    def sort(self, key: Optional[Union[str, Callable]] = None,
             descending: bool = False) -> "Dataset":
        """Sample-based range partition + per-partition sort
        (reference ``_internal/sort.py``)."""
        def _sort(refs: List) -> List:
            if not refs:
                return refs
            n_out = len(refs)
            keyf = _key_fn(key)
            samples: List[Any] = []
            for r in refs:
                acc = BlockAccessor.for_block(ray_tpu_torch.get(r))
                samples.extend(acc.sample_keys(10, key))
            samples.sort()
            bounds = [samples[int(len(samples) * (i + 1) / n_out)]
                      for i in range(n_out - 1)] if samples else []

            @ray_tpu_torch.remote
            def _part(block):
                acc = BlockAccessor.for_block(block)
                parts: List[List[Any]] = [[] for _ in range(n_out)]
                import bisect
                for row in acc.iter_rows():
                    parts[bisect.bisect_left(bounds, keyf(row))].append(row)
                return [_rows_to_block(p) for p in parts]

            @ray_tpu_torch.remote
            def _sort_part(parts):
                merged = BlockAccessor.combine(list(parts))
                rows = sorted(BlockAccessor.for_block(merged).iter_rows(),
                              key=keyf, reverse=descending)
                return _rows_to_block(rows)

            mats = ray_tpu_torch.get([_part.remote(r) for r in refs])
            out = [_sort_part.remote([m[j] for m in mats])
                   for j in range(n_out)]
            return out[::-1] if descending else out
        return self._with_stage(_AllToAll("sort", _sort))

    def groupby(self, key: Union[str, Callable]) -> "GroupedData":
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        def _zip(refs: List) -> List:
            other_refs = other._execute()
            counts = [BlockAccessor.for_block(ray_tpu_torch.get(r)).num_rows()
                      for r in refs]
            other_rows: List[Any] = []
            for r in other_refs:
                other_rows.extend(
                    BlockAccessor.for_block(ray_tpu_torch.get(r)).iter_rows())
            if sum(counts) != len(other_rows):
                raise ValueError(
                    f"zip requires equal row counts: {sum(counts)} vs "
                    f"{len(other_rows)} (reference dataset.py zip semantics)")
            out, pos = [], 0
            for r, c in zip(refs, counts):
                mine = list(BlockAccessor.for_block(ray_tpu_torch.get(r)).iter_rows())
                theirs = other_rows[pos:pos + c]
                pos += c
                rows = [_merge_rows(a, b) for a, b in zip(mine, theirs)]
                out.append(ray_tpu_torch.put(_rows_to_block(rows)))
            return out
        return self._with_stage(_AllToAll("zip", _zip))

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._execute())
        for o in others:
            refs.extend(o._execute())
        return Dataset(refs)

    def limit(self, n: int) -> "Dataset":
        def _limit(refs: List) -> List:
            out, left = [], n
            for r in refs:
                if left <= 0:
                    break
                block = ray_tpu_torch.get(r)
                acc = BlockAccessor.for_block(block)
                take = min(left, acc.num_rows())
                out.append(ray_tpu_torch.put(acc.slice(0, take)))
                left -= take
            return out
        return self._with_stage(_AllToAll("limit", _limit))

    # -- consumption ---------------------------------------------------------
    def count(self) -> int:
        return sum(BlockAccessor.for_block(b).num_rows()
                   for b in self._blocks())

    def num_blocks(self) -> int:
        return len(self._execute())

    def size_bytes(self) -> int:
        return sum(BlockAccessor.for_block(b).size_bytes()
                   for b in self._blocks())

    def schema(self):
        # lazy: fetch blocks only until the first non-empty one
        for r in self._execute():
            b = ray_tpu_torch.get(r)
            acc = BlockAccessor.for_block(b)
            if acc.num_rows() > 0:
                import pandas as pd
                if isinstance(b, pd.DataFrame):
                    return {c: str(t) for c, t in b.dtypes.items()}
                return type(next(iter(acc.iter_rows())))
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.keys()) if isinstance(s, dict) else None

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for r in self._execute():
            for row in BlockAccessor.for_block(ray_tpu_torch.get(r)).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for b in self._blocks():
            out.extend(BlockAccessor.for_block(b).iter_rows())
        return out

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Any]:
        for r in self._execute():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(r)).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "default",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: int = 0
                     ) -> Iterator[Any]:
        """``prefetch_batches > 0`` prepares that many batches ahead on a
        background thread (reference ``iter_batches(prefetch_batches=)``):
        host-side batch assembly overlaps the consumer's device step — the
        input-pipeline overlap that keeps a device step from waiting on
        pandas.  At the default ``0`` the ``data_prefetch_batches`` knob
        decides, so the autopilot's prefetch policy can deepen the
        pipeline cluster-wide from the ledger's ``data_wait`` share
        without touching call sites; pass a negative depth to force the
        synchronous path regardless of the knob."""
        fmt = "pandas" if batch_format == "default" else batch_format
        if prefetch_batches == 0:
            from ray_tpu_torch._private.config import _config
            prefetch_batches = int(_config.get("data_prefetch_batches"))

        def gen():
            rows_iter = self.iter_rows()
            if local_shuffle_buffer_size:
                rows_iter = _shuffling_iterator(
                    rows_iter, local_shuffle_buffer_size,
                    local_shuffle_seed)
            while True:
                chunk = list(itertools.islice(rows_iter, batch_size or 256))
                if not chunk:
                    return
                if drop_last and batch_size and len(chunk) < batch_size:
                    return
                block = _rows_to_block(chunk)
                yield BlockAccessor.for_block(block).to_batch(fmt)

        if prefetch_batches > 0:
            return _prefetching_iterator(gen(), prefetch_batches)
        return gen()

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False, **kw) -> Iterator[Any]:
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last, **kw):
            if isinstance(batch, dict):
                yield {k: torch.as_tensor(_stack_column(v))
                       for k, v in batch.items()}
            else:
                yield torch.as_tensor(_stack_column(batch))

    def iter_device_batches(self, *, batch_size: Optional[int] = 256,
                            drop_last: bool = False, device=None,
                            sharding=None, prefetch_batches: int = 0,
                            **kw) -> Iterator[Any]:
        """Numpy batches as tensors on ``device`` (``None``: ``cuda``,
        through ``resolve_device``, so it raises without a card), the
        counterpart of the JAX package's ``iter_jax_batches``.

        ``sharding``: a ``(Mesh, placements)`` pair, e.g. ``(mesh,
        batch_sharding(mesh))``; each batch is then this rank's
        ``DTensor`` of it (``place_local``: a local slice, no collective).

        On a CUDA device each host batch is pinned and copied with
        ``non_blocking=True`` on the consumer's current stream, so the copy
        is ordered before the step that reads it. With prefetching (the
        argument, or the ``data_prefetch_batches`` knob at 0) the batch
        assembly and the pinning run ahead on the prefetch thread; the copy
        never does. A pinned buffer is freed to the caching host allocator,
        which holds it until its copy has completed."""
        from ray_tpu_torch import resolve_device
        device = resolve_device(device)
        mesh, placements = sharding if sharding is not None else (None, None)
        if mesh is not None and mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"batches on {device}")
        if prefetch_batches == 0:
            from ray_tpu_torch._private.config import _config
            prefetch_batches = int(_config.get("data_prefetch_batches"))
        pin = device.type == "cuda"

        def host_batches():
            for batch in self.iter_batches(batch_size=batch_size,
                                           batch_format="numpy",
                                           drop_last=drop_last,
                                           prefetch_batches=-1, **kw):
                yield _map_batch(lambda v: _host_tensor(v, pin), batch)

        def place(t):
            t = t.to(device, non_blocking=pin)
            if mesh is None:
                return t
            from ray_tpu_torch.parallel.sharding import place_local
            return place_local(t, mesh, placements)

        it = host_batches()
        if prefetch_batches > 0:
            it = _prefetching_iterator(it, prefetch_batches)
        return (_map_batch(place, batch) for batch in it)

    # -- aggregates ----------------------------------------------------------
    def _column_values(self, on: Optional[str]) -> np.ndarray:
        vals: List[np.ndarray] = []
        for b in self._blocks():
            acc = BlockAccessor.for_block(b)
            if acc.num_rows() == 0:
                continue
            v = acc.to_numpy(on) if on else acc.to_numpy()
            if isinstance(v, dict):
                if len(v) != 1:
                    raise ValueError(
                        "aggregate on multi-column dataset requires on=")
                v = next(iter(v.values()))
            vals.append(np.asarray(v, dtype=np.float64))
        if not vals:
            return np.array([])
        return np.concatenate(vals)

    def sum(self, on: Optional[str] = None):
        v = self._column_values(on)
        return float(v.sum()) if v.size else None

    def min(self, on: Optional[str] = None):
        v = self._column_values(on)
        return float(v.min()) if v.size else None

    def max(self, on: Optional[str] = None):
        v = self._column_values(on)
        return float(v.max()) if v.size else None

    def mean(self, on: Optional[str] = None):
        v = self._column_values(on)
        return float(v.mean()) if v.size else None

    def std(self, on: Optional[str] = None, ddof: int = 1):
        v = self._column_values(on)
        return float(v.std(ddof=ddof)) if v.size else None

    # -- splits --------------------------------------------------------------
    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        refs = self._execute()
        if equal:
            # row counts differ by at most 1 across shards: a worker group
            # running per-batch collectives over its shards must not have
            # one member running extra rounds (a silent distributed hang)
            total = self.count()
            sizes = [total // n + (1 if i < total % n else 0)
                     for i in range(n)]
            cuts = []
            acc = 0
            for s in sizes[:-1]:
                acc += s
                cuts.append(acc)
            return self.split_at_indices(cuts)
        out: List[List] = [[] for _ in range(n)]
        for i, r in enumerate(refs):
            out[i % n].append(r)
        return [Dataset(refs) for refs in out]

    def streaming_split(self, n: int, *, equal: bool = False
                        ) -> List["DataIterator"]:
        """``n`` iterators that partition this dataset for concurrent
        consumers (reference ``Dataset.streaming_split`` feeding Train
        workers). Blocks are assigned round-robin up front (this engine's
        plans are materialized-block based, not a streaming executor);
        ``equal=True`` rebalances by rows instead."""
        return [DataIterator(shard) for shard in self.split(n, equal=equal)]

    def iterator(self) -> "DataIterator":
        """A single-consumer ``DataIterator`` over the whole dataset
        (reference ``Dataset.iterator``)."""
        return DataIterator(self)

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        """Blocks are assigned to output shards by cumulative row count and
        sliced IN PLACE (remote per-block tasks) where a cut falls inside
        a block — the driver never materializes rows, so splitting scales
        to datasets larger than driver memory."""
        refs = self._execute()

        @ray_tpu_torch.remote
        def _block_rows(block) -> int:
            return BlockAccessor.for_block(block).num_rows()

        @ray_tpu_torch.remote
        def _block_slice(block, a: int, b: int):
            return BlockAccessor.for_block(block).slice(a, b)

        counts = ray_tpu_torch.get([_block_rows.remote(r) for r in refs])
        total = sum(counts)
        bounds = [0] + sorted(int(i) for i in indices) + [total]
        out: List[List] = []
        block_i, offset = 0, 0  # offset: rows of block_i already consumed
        for a, b in zip(bounds[:-1], bounds[1:]):
            want = b - a
            shard_refs: List = []
            while want > 0 and block_i < len(refs):
                avail = counts[block_i] - offset
                if avail <= 0:
                    block_i += 1
                    offset = 0
                    continue
                take = min(want, avail)
                if offset == 0 and take == counts[block_i]:
                    shard_refs.append(refs[block_i])  # whole block, no copy
                else:
                    shard_refs.append(_block_slice.remote(
                        refs[block_i], offset, offset + take))
                offset += take
                want -= take
                if offset >= counts[block_i]:
                    block_i += 1
                    offset = 0
            out.append(Dataset(shard_refs
                               or [ray_tpu_torch.put(_rows_to_block([]))]))
        return out

    def train_test_split(self, test_size: float,
                         *, shuffle: bool = False,
                         seed: Optional[int] = None) -> Tuple["Dataset", "Dataset"]:
        ds = self.random_shuffle(seed=seed) if shuffle else self
        total = ds.count()
        n_test = int(total * test_size)
        train, test = ds.split_at_indices([total - n_test])
        return train, test

    # -- output --------------------------------------------------------------
    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd
        dfs = [BlockAccessor.for_block(b).to_pandas()
               for b in self._blocks()]
        df = (pd.concat(dfs, ignore_index=True) if dfs
              else pd.DataFrame())
        return df.head(limit) if limit else df

    def to_arrow_refs(self) -> List:
        @ray_tpu_torch.remote
        def _to_arrow(block):
            return BlockAccessor.for_block(block).to_arrow()
        return [_to_arrow.remote(r) for r in self._execute()]

    def write_parquet(self, path: str):
        self._write(path, "parquet")

    def write_csv(self, path: str):
        self._write(path, "csv")

    def write_json(self, path: str):
        self._write(path, "json")

    def write_tfrecords(self, path: str):
        """One TFRecord file per block; rows serialize as
        tf.train.Example (``data/tfrecords.py`` codec)."""
        self._write(path, "tfrecord")

    def write_numpy(self, path: str, column: Optional[str] = None):
        import os
        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def _w(block, i):
            acc = BlockAccessor.for_block(block)
            np.save(os.path.join(path, f"block_{i:06d}.npy"),
                    acc.to_numpy(column))
            return None
        ray_tpu_torch.get([_w.remote(r, i) for i, r in enumerate(self._execute())])

    def _write(self, path: str, fmt: str):
        import os
        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def _w(block, i):
            df = BlockAccessor.for_block(block).to_pandas()
            fp = os.path.join(path, f"block_{i:06d}.{fmt}")
            if fmt == "parquet":
                df.to_parquet(fp)
            elif fmt == "csv":
                df.to_csv(fp, index=False)
            elif fmt == "tfrecord":
                from ray_tpu_torch.data.tfrecords import (encode_example,
                                                    write_tfrecord_file)
                # to_dict("records") preserves per-COLUMN dtypes;
                # iterrows would coerce rows to one dtype and silently
                # turn int64 ids into lossy float32 FloatLists
                write_tfrecord_file(
                    fp, (encode_example(row)
                         for row in df.to_dict(orient="records")))
            else:
                df.to_json(fp, orient="records", lines=True)
            return None
        ray_tpu_torch.get([_w.remote(r, i) for i, r in enumerate(self._execute())])

    # -- pipeline ------------------------------------------------------------
    def window(self, *, blocks_per_window: int = 10):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        refs = self._execute()
        windows = [refs[i:i + blocks_per_window]
                   for i in range(0, len(refs), blocks_per_window)]
        return DatasetPipeline([Dataset(w) for w in windows])

    def repeat(self, times: Optional[int] = None):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline([self], repeat=times)

    def __repr__(self):
        try:
            n = len(self._cached) if self._cached else len(self._block_refs)
        except Exception:  # raylint: allow(swallow) repr must never raise
            n = "?"
        stages = "+".join(s.name for s in self._stages) or "read"
        return f"Dataset(blocks={n}, plan={stages})"

    def stats(self) -> str:
        return repr(self)


# --------------------------------------------------------------------------- #
# grouped data
# --------------------------------------------------------------------------- #


class GroupedData:
    """Reference ``python/ray/data/grouped_dataset.py``: hash-partition by
    key then per-partition aggregate."""

    def __init__(self, ds: Dataset, key: Union[str, Callable]):
        self._ds = ds
        self._key = key

    def _agg(self, named_aggs: List[Tuple[str, Optional[str], str]]) -> Dataset:
        """named_aggs: list of (agg_fn, on_column, out_name)."""
        key = self._key
        keyf = _key_fn(key)
        ds = self._ds

        def _group(refs: List) -> List:
            n_out = max(1, len(refs))

            @ray_tpu_torch.remote
            def _part(block):
                acc = BlockAccessor.for_block(block)
                parts: List[List[Any]] = [[] for _ in range(n_out)]
                for row in acc.iter_rows():
                    parts[hash(keyf(row)) % n_out].append(row)
                return [_rows_to_block(p) for p in parts]

            @ray_tpu_torch.remote
            def _aggregate(parts):
                import pandas as pd
                merged = BlockAccessor.combine(list(parts))
                df = BlockAccessor.for_block(merged).to_pandas()
                if df.empty:
                    return df
                if callable(key):
                    df = df.copy()
                    df["__key__"] = [key(dict(r)) for _, r in df.iterrows()]
                    gkey = "__key__"
                else:
                    gkey = key
                g = df.groupby(gkey, sort=True)
                out: Dict[str, Any] = {}
                for fn, on, name in named_aggs:
                    if fn == "count":
                        out[name] = g.size()
                    else:
                        col = on or next(
                            c for c in df.columns if c != gkey)
                        out[name] = getattr(g[col], fn)()
                res = pd.DataFrame(out).reset_index()
                return res

            mats = ray_tpu_torch.get([_part.remote(r) for r in refs])
            return [_aggregate.remote([m[j] for m in mats])
                    for j in range(n_out)]

        return ds._with_stage(_AllToAll("groupby", _group))

    def count(self) -> Dataset:
        return self._agg([("count", None, "count()")])

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self._agg([("sum", on, f"sum({on})")])

    def min(self, on: Optional[str] = None) -> Dataset:
        return self._agg([("min", on, f"min({on})")])

    def max(self, on: Optional[str] = None) -> Dataset:
        return self._agg([("max", on, f"max({on})")])

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self._agg([("mean", on, f"mean({on})")])

    def std(self, on: Optional[str] = None) -> Dataset:
        return self._agg([("std", on, f"std({on})")])

    def aggregate(self, *aggs) -> Dataset:
        """aggs: (fn_name, on, out_name) triples."""
        return self._agg(list(aggs))

    def map_groups(self, fn: Callable) -> Dataset:
        key = self._key
        keyf = _key_fn(key)
        ds = self._ds

        def _group(refs: List) -> List:
            n_out = max(1, len(refs))

            @ray_tpu_torch.remote
            def _part(block):
                acc = BlockAccessor.for_block(block)
                parts: List[List[Any]] = [[] for _ in range(n_out)]
                for row in acc.iter_rows():
                    parts[hash(keyf(row)) % n_out].append(row)
                return [_rows_to_block(p) for p in parts]

            @ray_tpu_torch.remote
            def _apply(parts):
                merged = BlockAccessor.combine(list(parts))
                acc = BlockAccessor.for_block(merged)
                groups: Dict[Any, List[Any]] = {}
                for row in acc.iter_rows():
                    groups.setdefault(keyf(row), []).append(row)
                rows: List[Any] = []
                for k in sorted(groups, key=repr):
                    out = fn(_rows_to_block(groups[k]))
                    rows.extend(BlockAccessor.for_block(
                        normalize_block(out)).iter_rows())
                return _rows_to_block(rows)

            mats = ray_tpu_torch.get([_part.remote(r) for r in refs])
            return [_apply.remote([m[j] for m in mats])
                    for j in range(n_out)]

        return ds._with_stage(_AllToAll("map_groups", _group))


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _data_wait_iter(it: Iterator) -> Iterator[Any]:
    """Attribute each batch pull to the goodput ledger's ``data_wait``
    category — the input-pipeline stall a train worker sees when the
    producer (pandas assembly / prefetch thread) falls behind the step."""
    from ray_tpu_torch.observability import goodput
    while True:
        if goodput.ENABLED:
            with goodput.interval("data_wait"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
        else:
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


class DataIterator:
    """Consumer-facing iteration handle over one dataset shard
    (reference ``ray.data.DataIterator``, what ``streaming_split``
    hands each Train worker).  Batch pulls are goodput-attributed as
    ``data_wait`` — this is the handle train workers consume from, so
    pipeline stalls land in the job ledger."""

    def __init__(self, ds: "Dataset"):
        self._ds = ds

    def iter_batches(self, **kw) -> Iterator[Any]:
        return _data_wait_iter(self._ds.iter_batches(**kw))

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        return _data_wait_iter(self._ds.iter_torch_batches(**kw))

    def iter_device_batches(self, **kw) -> Iterator[Any]:
        return _data_wait_iter(self._ds.iter_device_batches(**kw))

    def iter_rows(self) -> Iterator[Any]:
        return self._ds.iter_rows()

    def materialize(self) -> "Dataset":
        return self._ds.materialize()

    def count(self) -> int:
        return self._ds.count()

    def __repr__(self):
        return f"DataIterator({self._ds!r})"


def _prefetching_iterator(it: Iterator, n: int) -> Iterator:
    """Run ``it`` on a daemon thread, buffering up to ``n`` items ahead.

    Producer exceptions re-raise at the consumer's next pull. A consumer
    that ABANDONS the iterator early (break / close / GC) releases the
    producer: the generator's finally sets a stop flag and drains one
    slot, so the thread never stays parked on a full queue holding the
    buffered blocks alive."""
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, n))
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def fill():
        try:
            for item in it:
                if not _put((None, item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _put((e, None))
            return
        _put((None, _END))

    threading.Thread(target=fill, daemon=True,
                     name="data-prefetch").start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is _END:
                return
            yield item
    finally:
        stop.set()
        try:
            q.get_nowait()  # free a blocked producer immediately
        except _queue.Empty:
            pass


def _stack_column(v):
    """A batch column as an array a tensor can hold: an object column whose
    cells are numeric arrays of one shape (what ``normalize_block`` makes
    of a column with more than one dimension) is stacked into one
    ``[rows, ...]`` array; anything else comes back as it was."""
    v = np.asarray(v)
    if v.dtype != object or v.ndim != 1 or v.size == 0:
        return v
    first = v[0]
    if not all(isinstance(c, np.ndarray) and c.dtype.kind in "biuf"
               and c.shape == first.shape for c in v):
        return v
    return np.stack(list(v))


def _host_tensor(v, pin: bool):
    import torch
    t = torch.as_tensor(_stack_column(v))
    return t.pin_memory() if pin else t


def _map_batch(fn: Callable[[Any], Any], batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def _rows_to_block(rows: List[Any]):
    import pandas as pd
    if rows and isinstance(rows[0], dict):
        return pd.DataFrame(rows)
    return list(rows)


def _key_fn(key) -> Callable[[Any], Any]:
    if key is None:
        return lambda r: r
    if callable(key):
        return key
    return lambda r: r[key]


def _merge_rows(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        merged = dict(a)
        for k, v in b.items():
            merged[k if k not in merged else f"{k}_1"] = v
        return merged
    return (a, b)


def _shuffling_iterator(it: Iterator, buffer_size: int,
                        seed: Optional[int]) -> Iterator:
    rng = random.Random(seed)
    buf: List[Any] = []
    for item in it:
        buf.append(item)
        if len(buf) >= buffer_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf
