"""Async sharded checkpoint engine.

Port of ``ray_tpu/checkpoint/engine.py``. The on-disk format is the JAX
package's, byte for byte: a tree saved by either package's engine restores
in the other, and the same values get the same chunk ids. What differs is
the leaf type and what the hash cache may trust:

- a ``torch.Tensor`` leaf is an array leaf. Its host copy is
  ``.detach().cpu()``, with bf16 viewed as ``ml_dtypes.bfloat16`` (what
  the JAX package's ``np.asarray`` of a bf16 array gives), so a bf16 leaf
  gets the JAX engine's chunk id and manifest entry. A CUDA tensor's copy
  finishes before ``save`` returns: training steps update parameters in
  place, so a copy left running would race the next step. A CPU tensor is
  read where it lies, as a writeable numpy leaf is: do not write it until
  its save completes;
- a tensor is mutable, so the hash cache trusts it only under a key that
  includes its version counter (``_version``): a tensor written in place
  after a save is hashed again;
- ``load`` and ``CheckpointRef.load`` return numpy, as the JAX package's
  do.

Save path (per rank)::

    caller thread                     writer thread (daemon, bounded queue)
    -------------                     -----------------------------------
    flatten pytree                    hash each array (sha256 of
    device->host (np.asarray)    -->    dtype|shape|bytes) = chunk id
    enqueue job, return handle        dedup: chunk file exists -> skip
                                      else gather-write RTF5 frame + rename
                                      write shard index into pending/
                                      rank 0 only: wait for all ranks'
                                        shard indexes, then COMMIT

``save()`` returns as soon as the device->host copy is done; disk I/O
overlaps the next training step. The bounded queue (``checkpoint_queue_depth``)
applies backpressure instead of buffering unbounded host copies.

Two raw-speed mechanisms sit on the write path:

- **hash/write worker pool** (``checkpoint_io_workers``): sha256 and the
  chunk-file write of independent leaves overlap instead of running
  leaf-after-leaf on the writer thread (cold save is hash-bound on one
  core, I/O-bound on spinning storage — either way the overlap wins).
  ``<=1`` degrades to the serial path. Chaos choke points keep firing on
  the writer thread in submission order, so fault schedules stay
  deterministic regardless of worker interleaving.
- **content-hash cache**: leaves whose buffers provably haven't changed —
  tensors at the version counter they were saved at, and numpy arrays
  frozen with ``writeable=False`` — memoize their chunk id by identity, so a
  warm save of an unchanged tree skips the device->host copy, the hash,
  AND the write, and commits in about a millisecond. Writeable numpy
  buffers are never cached: they re-hash every save by design.

Commit protocol (rank 0): verify every referenced chunk exists -> write
manifest (tmp+fsync+rename) -> advance LATEST -> best-effort register in the
state service -> prune to ``num_to_keep`` + GC. A crash at any point leaves
the previous or the new checkpoint fully readable (see manifest.py).

Restore reshards when the world size changed: replicated saves hand any
shard to any rank; axis-sharded saves are reassembled into global arrays
from the per-shard offsets recorded at commit, then re-split
``lo = r*dim//W, hi = (r+1)*dim//W`` along the shard axis for the new world.
Which leaves are axis-split is DECLARED at save time (``shard_paths``
fnmatch patterns against the "/"-joined leaf path) and stamped into each
shard index — never inferred from data, so per-rank-distinct but logically
replicated leaves (RNG keys, rank-local counters) of matching shapes can't
be misread as one split array. Undeclared leaves restore replicated
(rank 0's copy when the world changes).

Chaos choke points: ``checkpoint.write`` (per chunk, labels path/rank),
``checkpoint.commit`` (labels stage=manifest|latest, step), and
``checkpoint.restore`` (labels manifest, rank).
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
import pickle
import queue
import re
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import chaos, observability
from ray_tpu_torch.observability import goodput, perf
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.framing import FramedPayload, dumps_framed, loads_framed
from ray_tpu_torch._private.host import to_numpy
from ray_tpu_torch.checkpoint import manifest as mf
from ray_tpu_torch.checkpoint.manifest import (ArrayEntry, CheckpointCorruption,
                                         CheckpointError, CheckpointNotFound,
                                         Manifest, ShardIndex)

logger = logging.getLogger("ray_tpu")


class _Slot:
    """Marks where an array leaf was lifted out of the skeleton pytree."""

    __slots__ = ("slot",)

    def __init__(self, slot: int):
        self.slot = slot

    def __reduce__(self):
        return (_Slot, (self.slot,))


# A skeleton names its slot marker as the JAX package's engine does, so
# either package's engine reads the other's checkpoints and the same tree
# gets the same skeleton bytes and chunk id. The name is a constant of the
# on-disk format: nothing of that package is imported.
_SLOT_GLOBAL = ("ray_tpu.checkpoint.engine", "_Slot")


class _SkeletonPickler(pickle._Pickler):
    """The standard pickler, writing ``_Slot`` under ``_SLOT_GLOBAL``."""

    def save_global(self, obj, name=None):
        if obj is not _Slot:
            return super().save_global(obj, name)
        self.save(_SLOT_GLOBAL[0])
        self.save(_SLOT_GLOBAL[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _SkeletonUnpickler(pickle.Unpickler):
    """Reads ``_SLOT_GLOBAL`` (and this module's own name for it) as
    ``_Slot``."""

    def find_class(self, module, name):
        if name == "_Slot" and module in (_SLOT_GLOBAL[0], __name__):
            return _Slot
        return super().find_class(module, name)


def _dumps_skeleton(skeleton: Any) -> bytes:
    try:
        return bytes(dumps_framed(skeleton, pickler=_SkeletonPickler))
    except (pickle.PicklingError, AttributeError, TypeError):
        # what only cloudpickle can pickle (a lambda, a local class):
        # readable by this package's engine alone
        return bytes(dumps_framed(skeleton))


def _loads_skeleton(data) -> Any:
    return loads_framed(data, unpickler=_SkeletonUnpickler)[0]


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _host_array(x: Any) -> np.ndarray:
    """The contiguous host array of an array leaf (the device->host copy
    for a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        return np.ascontiguousarray(to_numpy(x))
    return np.ascontiguousarray(np.asarray(x))


def _version(x: Any) -> Optional[int]:
    """A tensor's version counter (None for inference tensors, which have
    none and are never cached)."""
    if not isinstance(x, torch.Tensor) or x.is_inference():
        return None
    return x._version


def _extract_arrays(value: Any, path: Tuple[str, ...],
                    out: List[Any],
                    make_leaf: Optional[Callable[[str, Any], Any]] = None
                    ) -> Any:
    """Replace array leaves with _Slot markers; collect (path, host array)
    — or whatever ``make_leaf(path, leaf)`` produces (the engine passes a
    hash-cache-aware builder). ``_host_array`` is the device->host transfer
    for CUDA tensor leaves."""
    if isinstance(value, dict):
        return {k: _extract_arrays(v, path + (str(k),), out, make_leaf)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        seq = [_extract_arrays(v, path + (str(i),), out, make_leaf)
               for i, v in enumerate(value)]
        return tuple(seq) if isinstance(value, tuple) else seq
    if _is_array(value):
        slot = len(out)
        if make_leaf is not None:
            out.append(make_leaf("/".join(path), value))
        else:
            out.append(("/".join(path), _host_array(value)))
        return _Slot(slot)
    return value


def _inject_arrays(value: Any, slots: Dict[int, np.ndarray]) -> Any:
    if isinstance(value, dict):
        return {k: _inject_arrays(v, slots) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        seq = [_inject_arrays(v, slots) for v in value]
        return tuple(seq) if isinstance(value, tuple) else seq
    if isinstance(value, _Slot):
        return slots[value.slot]
    return value


def _hash_array(arr: np.ndarray) -> str:
    try:
        raw = memoryview(arr).cast("B")
    except (TypeError, ValueError):
        raw = arr.tobytes()
    return mf.hash_bytes(arr.dtype.str, json.dumps(list(arr.shape)), raw)


# -- chunk serving (restore-side striped remote fetch) ------------------------
#
# A restoring rank whose root is NOT the saver's shared filesystem pulls
# missing chunks from a peer over the FETCH_OBJECT bulk lane
# (arena_key="ckpt:<sha256>" — see distributed._handle_fetch_ckpt_chunk).
# Every engine registers its root here; chunks are content-addressed and
# immutable, so serving any registered root that holds the id is correct.

_serve_lock = threading.Lock()
_SERVE_ROOTS: "set[str]" = set()
_CHUNK_ID_RE = re.compile(r"[0-9a-f]{64}\Z")


def register_serve_root(root: str) -> None:
    with _serve_lock:
        _SERVE_ROOTS.add(os.path.abspath(root))


def read_served_chunk(chunk_id: str) -> Optional[bytes]:
    """Bytes of a locally-held chunk, or None. The id is validated as a
    bare content hash before touching the filesystem — the wire value
    can never become a path traversal."""
    if not _CHUNK_ID_RE.fullmatch(chunk_id):
        return None
    with _serve_lock:
        roots = list(_SERVE_ROOTS)
    for root in roots:
        path = os.path.join(root, mf.chunk_relpath(chunk_id))
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            continue
    return None


# -- warm-save content-hash cache ---------------------------------------------

def _cacheable(x: Any) -> bool:
    """Leaves whose bytes the cache can prove unchanged: tensors with a
    version counter (an entry holds only for the version it was saved
    at, so a tensor written in place is hashed again) and numpy arrays
    explicitly frozen with ``writeable=False``. The flag is re-checked at
    every lookup, so thawing a frozen array drops it from the cache; a
    writeable buffer is never trusted in the first place."""
    if isinstance(x, np.ndarray):
        return not x.flags.writeable
    return _version(x) is not None


class _HashCache:
    """Chunk-id memo keyed on leaf identity (id + liveness + version).

    A warm save of an unchanged tree must not pay the device->host copy,
    the sha256, or the chunk write again — for a buffer that provably
    has not changed the content hash is a function of its identity (and,
    for a tensor, of its version counter). Each entry carries a weakref:
    a freed buffer (whose id() the allocator may hand to a new object)
    evicts its own entry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, tuple] = {}  # raylint: guarded-by(self._lock)

    def lookup(self, x: Any) -> Optional[tuple]:
        """(chunk_id, nbytes, dtype_str, shape) or None."""
        if not _cacheable(x):
            return None
        with self._lock:
            ent = self._entries.get(id(x))
        if ent is None or ent[0]() is not x or ent[5] != _version(x):
            return None
        return ent[1:5]

    def remember(self, x: Any, chunk_id: str, nbytes: int,
                 dtype: str, shape: List[int],
                 version: Optional[int] = None) -> None:
        """``version``: the tensor's counter when its bytes were copied
        (at ``save``), not now — a write since then must miss."""
        if not _cacheable(x):
            return
        key = id(x)

        def _evict(_ref, _key=key, _self_ref=weakref.ref(self)):
            cache = _self_ref()
            if cache is not None:
                with cache._lock:
                    cache._entries.pop(_key, None)

        try:
            ref = weakref.ref(x, _evict)
        except TypeError:
            return  # leaf type doesn't support weakrefs: never cached
        with self._lock:
            self._entries[key] = (ref, chunk_id, nbytes, dtype, list(shape),
                                  version)


@dataclass
class _LeafTask:
    """One array leaf's unit of save work: either ``arr`` holds the host
    copy to hash+write, or ``chunk_id`` names the already-known chunk (a
    hash-cache hit — no host copy was ever made)."""

    path: str
    nbytes: int
    dtype: str
    shape: List[int]
    arr: Optional[np.ndarray] = None
    chunk_id: Optional[str] = None
    origin: Any = None   # original leaf, for the cache's remember()
    version: Optional[int] = None  # origin's version counter at the copy


@dataclass
class EngineStats:
    saves: int = 0
    commits: int = 0
    chunks_written: int = 0
    chunk_bytes_written: int = 0
    chunks_deduped: int = 0
    bytes_deduped: int = 0
    chunks_gced: int = 0


class SaveHandle:
    """Completion token for one rank's async save. ``result()`` returns the
    committed manifest filename on rank 0, None on other ranks."""

    def __init__(self, step: int, rank: int):
        self.step = step
        self.rank = rank
        self._done = threading.Event()
        self._manifest_name: Optional[str] = None
        self._error: Optional[BaseException] = None

    def _finish(self, manifest_name: Optional[str],
                error: Optional[BaseException]) -> None:
        # raylint: allow(data-race) written before _done.set(); result() reads only after a successful wait
        self._manifest_name = manifest_name
        self._error = error  # raylint: allow(data-race) written before _done.set(); result() reads only after a successful wait
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[str]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"checkpoint save (step={self.step} rank={self.rank}) "
                f"still in flight after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._manifest_name


@dataclass
class _SaveJob:
    handle: SaveHandle
    skeleton_frame: bytes
    leaves: List[_LeafTask]
    step: int
    rank: int
    world_size: int
    shard_axis: Optional[int]
    shard_paths: Optional[Tuple[str, ...]]
    mesh: Optional[Dict[str, Any]]
    meta: Dict[str, Any]
    save_key: str
    # (trace_id, span_id) captured at save(): the writer thread adopts it
    # so hash/write/gather/commit child spans join the caller's trace
    trace: Tuple[str, str] = ("", "")


class CheckpointEngine:
    """Content-addressed checkpoint store rooted at a directory shared by
    every rank (local disk, NFS, or the spill dir)."""

    def __init__(self, root: str, *, num_to_keep: Optional[int] = None,
                 namespace: str = "default",
                 state_client: Optional[Any] = None):
        self.root = os.path.abspath(root)
        self.num_to_keep = num_to_keep
        self.namespace = namespace
        self._state_client = state_client
        mf.init_root(self.root)
        register_serve_root(self.root)
        self._queue: "queue.Queue[Optional[_SaveJob]]" = queue.Queue(
            maxsize=max(1, int(_config.checkpoint_queue_depth)))
        self._writer: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        self._inflight: List[SaveHandle] = []  # raylint: guarded-by(self._writer_lock)
        self._inflight_chunks: set = set()   # GC must not reap these
        self._closed = False
        self.stats = EngineStats()  # raylint: guarded-by(self._stats_lock)
        self._stats_lock = threading.Lock()  # io-pool workers share stats
        self._hash_cache = _HashCache()
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- save -----------------------------------------------------------------

    def save(self, tree: Any, *, step: int, rank: int = 0,
             world_size: int = 1, shard_axis: Optional[int] = None,
             shard_paths: Optional[Any] = None,
             mesh: Optional[Dict[str, Any]] = None,
             meta: Optional[Dict[str, Any]] = None,
             save_key: Optional[str] = None,
             wait: bool = False,
             timeout_s: Optional[float] = None) -> SaveHandle:
        """Snapshot ``tree`` (this rank's shard of it). Returns once the
        device->host copy is enqueued; ``wait=True`` blocks through commit,
        raising ``TimeoutError`` if the commit outlives ``timeout_s``.

        ``shard_paths`` is required with ``shard_axis``: an iterable of
        fnmatch patterns over "/"-joined leaf paths naming exactly which
        leaves are split along the axis (``["params/*", "opt/mu/*"]``).
        Everything unmatched is treated as replicated — the engine never
        infers placement from shard contents.
        """
        if self._closed:
            raise CheckpointError("engine is closed")
        if (shard_axis is None) != (shard_paths is None):
            raise CheckpointError(
                "shard_axis and shard_paths must be passed together: the "
                "caller declares which leaves are axis-split (fnmatch "
                "patterns over '/'-joined paths); placement is never "
                "inferred from data")
        leaves: List[_LeafTask] = []
        skeleton = _extract_arrays(tree, (), leaves, self._make_leaf)
        handle = SaveHandle(step, rank)
        trace: Tuple[str, str] = ("", "")
        if observability.ENABLED:
            # checkpoint save is a trace entry point: join the caller's
            # trace when one is active, mint a fresh one otherwise
            trace = observability.current() or (observability.mint_id(), "")
        job = _SaveJob(
            handle=handle,
            skeleton_frame=_dumps_skeleton(skeleton),
            leaves=leaves, step=step, rank=rank, world_size=world_size,
            shard_axis=shard_axis,
            shard_paths=(None if shard_paths is None
                         else tuple(str(p) for p in shard_paths)),
            mesh=mesh, meta=dict(meta or {}),
            save_key=save_key or f"step-{step:08d}",
            trace=trace)
        self._ensure_writer()
        with self._writer_lock:
            self._inflight.append(handle)
        # Bounded-queue backpressure: when the writer falls behind, this
        # put blocks the training thread — goodput's ``ckpt_stall``.
        try:
            self._queue.put_nowait(job)  # raylint: allow(data-race) queue.Queue is internally synchronized
        except queue.Full:
            if goodput.ENABLED:
                with goodput.interval("ckpt_stall"):
                    self._queue.put(job)  # raylint: allow(data-race) queue.Queue is internally synchronized
            else:
                self._queue.put(job)  # raylint: allow(data-race) queue.Queue is internally synchronized
        if wait:
            if goodput.ENABLED:  # synchronous save: commit wait is a stall
                with goodput.interval("ckpt_stall"):
                    handle.result(timeout_s)
            else:
                handle.result(timeout_s)
        return handle

    def _make_leaf(self, path: str, value: Any) -> _LeafTask:
        """Caller-thread leaf builder: a hash-cache hit (plus a stat
        proving the chunk is still on disk — GC may have reaped it) skips
        the device->host copy entirely; everything else pays the copy now
        so the training step can proceed while the writer hashes."""
        hit = self._hash_cache.lookup(value)
        if hit is not None:
            chunk_id, nbytes, dtype, shape = hit
            if os.path.exists(os.path.join(self.root,
                                           mf.chunk_relpath(chunk_id))):
                return _LeafTask(path=path, nbytes=nbytes, dtype=dtype,
                                 shape=list(shape), chunk_id=chunk_id)
        version = _version(value)
        arr = _host_array(value)
        return _LeafTask(path=path, nbytes=arr.nbytes, dtype=arr.dtype.str,
                         shape=list(arr.shape), arr=arr, origin=value,
                         version=version)

    def _io_pool(self) -> Optional[ThreadPoolExecutor]:
        """Shared hash/write worker pool; None = serial path
        (``checkpoint_io_workers <= 1``)."""
        n = int(_config.checkpoint_io_workers)
        if n <= 1:
            return None
        with self._writer_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="ckpt-io")
            return self._pool

    def _ensure_writer(self) -> None:
        with self._writer_lock:
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=self._writer_loop,
                    name="ckpt-writer", daemon=True)
                self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                name = self._process(job)
                job.handle._finish(name, None)
            except BaseException as e:
                logger.warning("checkpoint: save step=%d rank=%d failed: %s",
                               job.step, job.rank, e)
                job.handle._finish(None, e)
            finally:
                self._queue.task_done()
                with self._writer_lock:
                    try:
                        self._inflight.remove(job.handle)
                    except ValueError:
                        logger.debug("checkpoint: handle already reaped "
                                     "(flush raced the writer)")

    # -- the write path (writer thread) ---------------------------------------

    def _write_chunk(self, chunk_id: str, pieces: List, nbytes: int) -> None:
        if not perf.ENABLED:
            return self._write_chunk_impl(chunk_id, pieces, nbytes)
        t0 = time.monotonic()
        try:
            return self._write_chunk_impl(chunk_id, pieces, nbytes)
        finally:
            perf.observe("ckpt.write", (time.monotonic() - t0) * 1e3)

    def _write_chunk_impl(self, chunk_id: str, pieces: List,
                          nbytes: int) -> None:
        final = os.path.join(self.root, mf.chunk_relpath(chunk_id))
        if os.path.exists(final):
            with self._stats_lock:
                self.stats.chunks_deduped += 1
                self.stats.bytes_deduped += nbytes
            return
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                for p in pieces:
                    f.write(p)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._stats_lock:
            self.stats.chunks_written += 1
            self.stats.chunk_bytes_written += nbytes

    def _process(self, job: _SaveJob) -> Optional[str]:
        # Writer thread: adopt the context captured at save() so the
        # stage spans below land in the submitting trace.
        token = (observability.set_current(*job.trace)
                 if observability.ENABLED and job.trace[0] else None)
        t0 = time.monotonic() if perf.ENABLED else 0.0
        try:
            with observability.span("checkpoint.save", cat="checkpoint",
                                    step=str(job.step), rank=str(job.rank)):
                return self._process_stages(job)
        finally:
            if t0:
                perf.observe("ckpt.save", (time.monotonic() - t0) * 1e3)
            if token is not None:
                observability.reset(token)

    def _leaf_chunk(self, leaf: _LeafTask, dropped: bool,
                    protected: List[str]) -> str:
        """Hash + write one leaf (io-pool worker or inline on the writer
        thread). Returns the chunk id."""
        if leaf.chunk_id is not None:
            # hash-cache hit: the chunk was stat-proven present at save()
            # time — account the dedup without touching the bytes (no
            # host copy, no hash, no write)
            protected.append(leaf.chunk_id)
            self._inflight_chunks.add(leaf.chunk_id)  # raylint: allow(data-race) GIL-atomic set add; worst case protects a chunk from cleanup twice
            with self._stats_lock:
                self.stats.chunks_deduped += 1
                self.stats.bytes_deduped += leaf.nbytes
            return leaf.chunk_id
        t0 = time.monotonic() if perf.ENABLED else 0.0
        with observability.span("checkpoint.hash", cat="checkpoint",
                                path=leaf.path):
            chunk_id = _hash_array(leaf.arr)
        if t0:
            perf.observe("ckpt.hash", (time.monotonic() - t0) * 1e3)
        protected.append(chunk_id)
        self._inflight_chunks.add(chunk_id)  # raylint: allow(data-race) GIL-atomic set add; worst case protects a chunk from cleanup twice
        if leaf.origin is not None:
            self._hash_cache.remember(leaf.origin, chunk_id, leaf.nbytes,
                                      leaf.dtype, leaf.shape, leaf.version)
        if not dropped:
            payload = FramedPayload(leaf.arr)
            with observability.span("checkpoint.write",
                                    cat="checkpoint", path=leaf.path):
                self._write_chunk(chunk_id, payload.pieces, leaf.nbytes)
        return chunk_id

    def _process_stages(self, job: _SaveJob) -> Optional[str]:
        with self._stats_lock:
            self.stats.saves += 1
        protected: List[str] = []
        try:
            pool = self._io_pool()
            # Chaos choke points fire here, on the writer thread in leaf
            # submission order — a schedule's nth checkpoint.write firing
            # hits the same leaf with or without the worker pool.
            results: List[Any] = []
            for leaf in job.leaves:
                dropped = False
                if chaos.ENABLED:
                    dropped = chaos.inject(
                        "checkpoint.write", path=leaf.path,
                        rank=str(job.rank)) == "drop"
                if pool is None:
                    results.append(self._leaf_chunk(leaf, dropped, protected))
                else:
                    results.append(pool.submit(
                        self._leaf_chunk, leaf, dropped, protected))
            if pool is not None:
                chunk_ids, errors = [], []
                for fut in results:
                    try:
                        chunk_ids.append(fut.result())
                    except BaseException as e:  # noqa: BLE001
                        errors.append(e)
                        chunk_ids.append(None)
                if errors:
                    raise errors[0]
            else:
                chunk_ids = results
            entries = [
                ArrayEntry(
                    path=leaf.path, slot=slot, chunk=cid, nbytes=leaf.nbytes,
                    dtype=leaf.dtype, shape=list(leaf.shape),
                    sharded=(job.shard_paths is not None and any(
                        fnmatch.fnmatchcase(leaf.path, pat)
                        for pat in job.shard_paths)))
                # a dropped (lost) write still indexes the chunk: the
                # committer's presence check then fails the save loudly
                # instead of publishing a manifest missing the array
                for slot, (leaf, cid) in enumerate(zip(job.leaves,
                                                       chunk_ids))]
            skel_id = mf.hash_bytes("skeleton", job.skeleton_frame)
            protected.append(skel_id)
            self._inflight_chunks.add(skel_id)  # raylint: allow(data-race) GIL-atomic set add; worst case protects a chunk from cleanup twice
            if chaos.ENABLED:
                chaos.inject("checkpoint.write", path="<skeleton>",
                             rank=str(job.rank))
            with observability.span("checkpoint.write", cat="checkpoint",
                                    path="<skeleton>"):
                self._write_chunk(skel_id, [job.skeleton_frame],
                                  len(job.skeleton_frame))
            shard = ShardIndex(rank=job.rank, skeleton=skel_id,
                               skeleton_nbytes=len(job.skeleton_frame),
                               arrays=entries)
            pend_dir = os.path.join(self.root, mf.PENDING_DIR, job.save_key)
            os.makedirs(pend_dir, exist_ok=True)
            # fsync=False: the pending index only matters to a commit in
            # THIS boot — a crash abandons the save either way, and the
            # manifest/LATEST writes that make it durable still fsync
            mf.atomic_write_bytes(
                os.path.join(pend_dir, f"shard-{job.rank}.json"),
                json.dumps({"step": job.step, "world_size": job.world_size,
                            "shard": shard.to_json()}).encode(),
                fsync=False)
            if job.rank != 0:
                return None
            return self._commit(job, pend_dir)
        finally:
            # raylint: allow(data-race) GIL-atomic set op; a racing saver re-adds its chunk before the next GC scan
            self._inflight_chunks.difference_update(
                [c for c in protected if c])

    def _commit(self, job: _SaveJob, pend_dir: str) -> str:
        with observability.span("checkpoint.gather", cat="checkpoint",
                                step=str(job.step),
                                world_size=str(job.world_size)):
            shards = self._gather_shards(job, pend_dir)
        if job.shard_axis is not None:
            _finalize_sharding(shards, job.shard_axis)
        m = Manifest(id=mf.new_manifest_id(), step=job.step,
                     world_size=job.world_size, shards=shards,
                     shard_axis=job.shard_axis, mesh=job.mesh, meta=job.meta)
        if not mf.chunks_present(self.root, m):
            raise CheckpointError(
                f"step {job.step}: chunk(s) missing at commit time "
                "(lost or dropped write) — refusing to publish a torn "
                "manifest")
        t0 = time.monotonic() if perf.ENABLED else 0.0
        with observability.span("checkpoint.commit", cat="checkpoint",
                                step=str(job.step)):
            if chaos.ENABLED:
                chaos.inject("checkpoint.commit", stage="manifest",
                             step=str(job.step))
            name = mf.write_manifest(self.root, m)
            if chaos.ENABLED:
                chaos.inject("checkpoint.commit", stage="latest",
                             step=str(job.step))
            mf.set_latest(self.root, name)
        if t0:
            perf.observe("ckpt.commit", (time.monotonic() - t0) * 1e3)
        with self._stats_lock:
            self.stats.commits += 1
        self._register(name)
        self._cleanup_pending(pend_dir)
        if self.num_to_keep is not None:
            self._prune(self.num_to_keep)
        return name

    def _gather_shards(self, job: _SaveJob, pend_dir: str) -> List[ShardIndex]:
        """Rank 0 waits for every rank's shard index in pending/."""
        deadline = time.monotonic() + float(_config.checkpoint_shard_wait_s)
        want = {r: os.path.join(pend_dir, f"shard-{r}.json")
                for r in range(job.world_size)}
        shards: Dict[int, ShardIndex] = {}
        while True:
            for r, path in list(want.items()):
                try:
                    with open(path, encoding="utf-8") as f:
                        d = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue
                if d.get("step") != job.step:
                    continue  # stale file from a crashed earlier attempt
                shards[r] = ShardIndex.from_json(d["shard"])
                del want[r]
            if not want:
                return [shards[r] for r in sorted(shards)]
            if time.monotonic() >= deadline:
                raise CheckpointError(
                    f"step {job.step}: ranks {sorted(want)} never delivered "
                    f"shard indexes within "
                    f"{_config.checkpoint_shard_wait_s}s — save abandoned "
                    "(previous checkpoint remains the restore point)")
            time.sleep(0.005)  # raylint: allow(bare-retry) local-FS poll under the explicit checkpoint_shard_wait_s deadline above

    def _register(self, name: str) -> None:
        client = self._state_client
        if client is None:
            return
        try:
            client.kv_put(f"ckpt/{self.namespace}/latest".encode(),
                          name.encode())
        except Exception as e:
            # registration is advisory (LATEST on disk is authoritative);
            # a dead state service must not fail a durable commit
            logger.debug("checkpoint: state-service register failed: %s", e)

    def _cleanup_pending(self, pend_dir: str) -> None:
        try:
            for fn in os.listdir(pend_dir):
                os.unlink(os.path.join(pend_dir, fn))
            os.rmdir(pend_dir)
        except OSError as e:
            logger.debug("checkpoint: pending cleanup left residue: %s", e)

    # -- retention / GC -------------------------------------------------------

    def _prune(self, keep: int) -> None:
        # Retention keeps the most recently COMMITTED manifests (file
        # mtime), not the highest step numbers: a step counter that
        # restarted after a crash writes fresh low-step manifests which
        # must out-live stale pre-crash high-step ones.
        names = mf.list_manifest_names_by_commit_time(self.root)
        for name in names[:-keep] if keep > 0 else names:
            try:
                os.unlink(os.path.join(self.root, mf.MANIFESTS_DIR, name))
            except OSError as e:
                logger.debug("checkpoint: prune of %s failed: %s", name, e)
        self.gc()

    def gc(self) -> int:
        """Reap chunk files no committed manifest references (crashed saves
        leave orphans by design).

        Every rank runs its own engine on the same shared root, so "live"
        must be judged cross-process, not from this instance alone: chunks
        named by any ``pending/`` shard index belong to a save some
        committer may still publish, and any file younger than
        ``checkpoint_gc_grace_s`` is left alone — a peer's freshly written
        chunk may precede its shard index, and unlinking a peer's tmp file
        would fail its imminent ``os.replace``.
        """
        referenced = set(self._inflight_chunks)
        for name in mf.list_manifest_names(self.root):
            try:
                referenced.update(mf.read_manifest(self.root, name)
                                  .chunk_ids())
            except CheckpointError:
                logger.warning("checkpoint: gc skipping unreadable manifest "
                               "%s (its chunks stay protected-by-absence)",
                               name)
                return 0  # cannot prove anything is orphaned
        grace = max(0.0, float(_config.checkpoint_gc_grace_s))
        # stale pending indexes (older than the committer's shard-wait
        # deadline plus grace) can never join a commit — ignore them so a
        # crashed attempt's residue doesn't pin chunks forever
        referenced.update(mf.pending_chunk_ids(
            self.root,
            max_age_s=float(_config.checkpoint_shard_wait_s) + grace))
        now = time.time()
        reaped = 0
        chunks_dir = os.path.join(self.root, mf.CHUNKS_DIR)
        for sub in os.listdir(chunks_dir):
            subdir = os.path.join(chunks_dir, sub)
            if not os.path.isdir(subdir):
                continue
            for fn in os.listdir(subdir):
                if fn.split(".tmp-")[0] in referenced and ".tmp-" not in fn:
                    continue
                path = os.path.join(subdir, fn)
                try:
                    if grace and now - os.path.getmtime(path) < grace:
                        continue
                    os.unlink(path)
                    reaped += 1
                except OSError as e:
                    logger.debug("checkpoint: gc skipped %s: %s", fn, e)
        with self._stats_lock:
            self.stats.chunks_gced += reaped
        return reaped

    # -- restore --------------------------------------------------------------

    def latest(self) -> Optional[str]:
        return mf.resolve_latest(self.root)

    def restore(self, manifest_name: Optional[str] = None, *, rank: int = 0,
                world_size: int = 1,
                fetch_from: Optional["ChunkFetcher"] = None) -> Any:
        return load(self.root, manifest_name, rank=rank,
                    world_size=world_size, fetch_from=fetch_from)

    # -- lifecycle ------------------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait for every in-flight save. True when all completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._writer_lock:
                pending = list(self._inflight)
            if not pending:
                return True
            for h in pending:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if not h.wait(left):
                    return False

    def close(self, timeout: Optional[float] = None) -> None:
        if self._closed:
            return
        self.flush(timeout)
        self._closed = True
        with self._writer_lock:
            writer = self._writer
            pool = self._pool
        if writer is not None and writer.is_alive():
            self._queue.put(None)  # raylint: allow(data-race) queue.Queue is internally synchronized
            writer.join(timeout=5.0)
        if pool is not None:
            pool.shutdown(wait=True)


# -- engine-less read path ----------------------------------------------------

#: ``fetch_from`` contract: ``(chunk_id) -> Optional[bytes]`` — the
#: distributed runtime's striped remote chunk fetch, or any callable that
#: can produce a missing chunk's bytes. None return = not found there
#: either.
ChunkFetcher = Callable[[str], Optional[bytes]]


def _read_chunk(root: str, chunk_id: str,
                fetch_from: Optional[ChunkFetcher] = None) -> bytes:
    path = os.path.join(root, mf.chunk_relpath(chunk_id))
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        if fetch_from is None:
            raise CheckpointCorruption(
                f"chunk {chunk_id[:12]}… missing at {root}")
    try:
        data = fetch_from(chunk_id)
    except Exception as e:
        raise CheckpointCorruption(
            f"chunk {chunk_id[:12]}… missing at {root} and the remote "
            f"fetch failed: {e}")
    if data is None:
        raise CheckpointCorruption(
            f"chunk {chunk_id[:12]}… missing at {root} and at the remote "
            "peer")
    # Write-through: later entries (and later restores) find the chunk
    # locally. Content-addressed + hash-verified on load, so no fsync —
    # a torn write is caught and refetched, never trusted.
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mf.atomic_write_bytes(path, data, fsync=False)
    except OSError as e:
        logger.debug("checkpoint: chunk write-through failed: %s", e)
    return data


def _load_array(root: str, e: ArrayEntry, verify: bool,
                fetch_from: Optional[ChunkFetcher] = None) -> np.ndarray:
    value, _ = loads_framed(_read_chunk(root, e.chunk, fetch_from))
    arr = np.asarray(value)
    if verify:
        got = _hash_array(np.ascontiguousarray(arr))
        if got != e.chunk:
            raise CheckpointCorruption(
                f"chunk for {e.path!r} failed hash verification "
                f"(manifest {e.chunk[:12]}…, disk {got[:12]}…)")
    return arr


def _load_slots(root: str, entries: List[ArrayEntry], verify: bool,
                fetch_from: Optional[ChunkFetcher]) -> Dict[int, np.ndarray]:
    """Concurrent chunk reads (``checkpoint_io_workers``): restore is
    read+hash per leaf, which overlaps the same way the save path does."""
    workers = min(int(_config.checkpoint_io_workers), len(entries))
    if workers <= 1:
        return {e.slot: _load_array(root, e, verify, fetch_from)
                for e in entries}
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="ckpt-read") as ex:
        futs = [(e.slot, ex.submit(_load_array, root, e, verify, fetch_from))
                for e in entries]
        return {slot: f.result() for slot, f in futs}


def _load_shard(root: str, shard: ShardIndex, verify: bool,
                fetch_from: Optional[ChunkFetcher] = None) -> Any:
    skeleton = _loads_skeleton(_read_chunk(root, shard.skeleton, fetch_from))
    slots = _load_slots(root, shard.arrays, verify, fetch_from)
    return _inject_arrays(skeleton, slots)


def _finalize_sharding(shards: List[ShardIndex], axis: int) -> None:
    """Stamp global_shape/offset onto the leaves the ranks DECLARED split
    along ``axis`` (``save(shard_paths=...)`` → ``ArrayEntry.sharded``).
    Undeclared leaves — scalars, replicated params, per-rank-distinct RNG
    keys — restore replicated; a declared leaf whose shards don't actually
    assemble (missing on a rank, inconsistent flags, axis out of range,
    mismatched non-axis dims) fails the commit loudly rather than
    publishing a manifest that reshards into garbage."""
    by_path: Dict[str, List[ArrayEntry]] = {}
    for s in shards:
        for e in s.arrays:
            by_path.setdefault(e.path, []).append(e)
    nranks = len(shards)
    for path, entries in by_path.items():
        marked = sum(1 for e in entries if e.sharded)
        if marked == 0:
            continue
        if marked != len(entries) or len(entries) != nranks:
            raise CheckpointError(
                f"leaf {path!r} is declared axis-split on {marked} of "
                f"{len(entries)} entries across {nranks} ranks — every "
                "rank must save it with a matching shard_paths pattern")
        shapes = [e.shape for e in entries]
        if any(len(sh) <= axis for sh in shapes):
            raise CheckpointError(
                f"leaf {path!r} is declared split along axis {axis} but "
                f"has shape(s) {shapes} without that axis")
        base = shapes[0][:axis] + shapes[0][axis + 1:]
        if any(sh[:axis] + sh[axis + 1:] != base for sh in shapes[1:]):
            raise CheckpointError(
                f"leaf {path!r} is declared split along axis {axis} but "
                f"non-axis dims differ across ranks: {shapes}")
        total = sum(sh[axis] for sh in shapes)
        off = 0
        for e in entries:   # shards arrive rank-sorted from the committer
            g = list(e.shape)
            g[axis] = total
            o = [0] * len(g)
            o[axis] = off
            e.global_shape, e.offset = g, o
            off += e.shape[axis]


def _load_resharded(root: str, m: Manifest, rank: int, world_size: int,
                    verify: bool,
                    fetch_from: Optional[ChunkFetcher] = None) -> Any:
    """World size changed on an axis-sharded save: rebuild each global
    array from recorded offsets, then take this rank's equal split. One
    worker per leaf (each assembles its shard parts serially into the
    global buffer) keeps reads+hashing concurrent without two workers
    racing on one destination array."""
    axis = m.shard_axis
    assert axis is not None
    skeleton = _loads_skeleton(_read_chunk(root, m.shards[0].skeleton,
                                           fetch_from))

    def _load_leaf(e0: ArrayEntry) -> np.ndarray:
        if e0.global_shape is None:
            return _load_array(root, e0, verify, fetch_from)
        glob = np.empty(tuple(e0.global_shape), dtype=np.dtype(e0.dtype))
        for s in m.shards:
            e = next(x for x in s.arrays if x.path == e0.path)
            part = _load_array(root, e, verify, fetch_from)
            sel = [slice(None)] * glob.ndim
            sel[axis] = slice(e.offset[axis], e.offset[axis] + e.shape[axis])
            glob[tuple(sel)] = part.reshape(tuple(e.shape))
        dim = glob.shape[axis]
        lo, hi = rank * dim // world_size, (rank + 1) * dim // world_size
        sel = [slice(None)] * glob.ndim
        sel[axis] = slice(lo, hi)
        return glob[tuple(sel)]

    entries = m.shards[0].arrays
    workers = min(int(_config.checkpoint_io_workers), len(entries))
    if workers <= 1:
        slots = {e0.slot: _load_leaf(e0) for e0 in entries}
    else:
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="ckpt-read") as ex:
            futs = [(e0.slot, ex.submit(_load_leaf, e0)) for e0 in entries]
            slots = {slot: f.result() for slot, f in futs}
    return _inject_arrays(skeleton, slots)


def load(root: str, manifest_name: Optional[str] = None, *, rank: int = 0,
         world_size: int = 1,
         fetch_from: Optional[ChunkFetcher] = None) -> Any:
    """Restore one rank's view of a committed checkpoint (thread-free read
    path; the engine's ``restore`` delegates here). ``fetch_from`` pulls
    chunks missing under ``root`` from a remote peer (the distributed
    runtime's striped transport fetch) and caches them write-through."""
    root = os.path.abspath(root)
    if manifest_name is None:
        manifest_name = mf.resolve_latest(root)
        if manifest_name is None:
            raise CheckpointNotFound(f"no committed checkpoint under {root}")
    m = mf.read_manifest(root, manifest_name)
    if chaos.ENABLED:
        chaos.inject("checkpoint.restore", manifest=manifest_name,
                     rank=str(rank))
    verify = bool(_config.checkpoint_hash_verify)
    if m.shard_axis is None:
        # replicated: every shard is a full tree; any one serves any rank
        return _load_shard(root, m.shards[rank % len(m.shards)], verify,
                           fetch_from)
    if world_size == m.world_size:
        by_rank = {s.rank: s for s in m.shards}
        return _load_shard(root, by_rank[rank], verify, fetch_from)
    return _load_resharded(root, m, rank, world_size, verify, fetch_from)


@dataclass
class CheckpointRef:
    """Picklable pointer to a committed checkpoint — what trials, results
    and serve configs carry instead of directory copies or value blobs."""

    root: str
    manifest_name: Optional[str] = None   # None = latest at load time

    def load(self, rank: int = 0, world_size: int = 1,
             fetch_from: Optional[ChunkFetcher] = None) -> Any:
        return load(self.root, self.manifest_name, rank=rank,
                    world_size=world_size, fetch_from=fetch_from)

    def exists(self) -> bool:
        try:
            name = self.manifest_name or mf.resolve_latest(self.root)
            return name is not None and mf.chunks_present(
                self.root, mf.read_manifest(self.root, name))
        except CheckpointError:
            return False
