"""Per-node object store: immutable objects, ref counting, disk spilling.

Capability parity with the reference's plasma store + local object manager
(``src/ray/object_manager/plasma/store.h``,
``src/ray/raylet/local_object_manager.h:99`` SpillObjects), redesigned for a
host-granular GPU runtime:

- **Device objects** (every ``torch.Tensor``, whatever its device) are stored
  *by reference*: the value stays resident in device memory and the store
  holds only a descriptor, so ``get(put(x)) is x`` with no copy. Device
  objects are never spilled by the byte-budget policy (device memory
  pressure is the training loop's to handle, not the store's). A
  ``jax.Array`` is immutable and carries its own pending-work dependency; a
  CUDA tensor has neither, so the store keeps both by hand:

  - *immutability*: ``put`` records the tensor's version counter
    (``_version``) and ``get`` refuses an object whose counter has moved (an
    in-place write by the putter or by an earlier getter). Writes through
    ``x.data`` or a DLPack alias do not move the counter and are not caught,
    and an inference-mode tensor has no counter to check;
  - *readiness*: ``put`` records a CUDA event on the putter's current stream,
    and ``get`` makes the getter's current stream wait on it (device side, no
    host synchronisation);
  - *lifetime*: ``get`` also calls ``record_stream`` for the getter's
    stream, so the caching allocator does not hand the tensor's memory to
    a new allocation on the allocating stream while the getter's queued
    work still reads it.

  A container that holds tensors (a dict of parameters) is a host object,
  pickled like any other, so its CUDA tensors round-trip through host memory.
- **Host objects** are serialized (immutability) unless they are numpy arrays,
  which are stored as read-only zero-copy views (plasma's zero-copy numpy,
  without the shm arena since workers share the owner process).
- Spilling: when host bytes exceed the configured budget, least-recently-used
  unpinned host objects are pickled to ``object_spilling_dir`` and restored on
  demand (reference behavior: ``local_object_manager.h``).
"""

from __future__ import annotations
import logging

import copy
import io
import os
import pickle
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle
import torch

from ray_tpu_torch import chaos
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.framing import loads_framed
from ray_tpu_torch._private.ids import ObjectID

# raylint: hot-path  (payload plane: R8 flags hidden payload copies)
logger = logging.getLogger("ray_tpu")


def _release_native_pin(native, oids: dict, key: bytes):
    """Finalizer for zero-copy framed reads: drop the read pin; if the
    entry was free()d while views kept it pinned, reap the arena slot now
    (Delete refuses pinned objects, so free() could not)."""
    try:
        native.release(key)
        if key not in oids:
            native.delete(key)
    except Exception as e:  # raylint: allow(swallow) interpreter/arena teardown: the pin died with the mapping
        logger.debug("native pin release failed: %s", e)


def _is_numpy(value: Any) -> bool:
    try:
        import numpy as np
        return isinstance(value, np.ndarray)
    except Exception:  # raylint: allow(swallow) capability probe: numpy optional
        return False


KIND_DEVICE = "device"
KIND_NUMPY = "numpy"
KIND_PICKLED = "pickled"
KIND_ERROR = "error"
KIND_SPILLED = "spilled"


@dataclass
class _Entry:
    kind: str
    data: Any = None
    size_bytes: int = 0
    spill_path: Optional[str] = None
    pin_count: int = 0
    native: bool = False  # payload lives in the C++ arena, data is None
    framed: bool = False  # payload is an RTF5 frame (remote recv landing)
    last_access: float = field(default_factory=time.monotonic)
    sealed: threading.Event = field(default_factory=threading.Event)
    # Device objects: the tensor's version counter at put (None where it
    # has none) and the event that marks its value ready (CUDA only).
    version: Optional[int] = None
    ready: Optional[torch.cuda.Event] = None


def _device_entry(value: torch.Tensor) -> _Entry:
    version = None if value.is_inference() else value._version
    ready = None
    if value.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(value.device))
    return _Entry(kind=KIND_DEVICE, data=value, size_bytes=0,
                  version=version, ready=ready)


def _checked_device_value(object_id: ObjectID, entry: _Entry):
    """The stored tensor, once it is known unmodified and ready for the
    caller's current stream."""
    value = entry.data
    if entry.version is not None and value._version != entry.version:
        raise exc.RayTpuError(
            f"{object_id} was modified in place after put (tensor version "
            f"{entry.version} -> {value._version}); objects are immutable "
            "once sealed: clone before writing")
    if entry.ready is not None:
        stream = torch.cuda.current_stream(value.device)
        stream.wait_event(entry.ready)
        # The caching allocator returns a freed block to the stream that
        # allocated it; mark the getter's use so the block is not reused
        # while this stream's queued work still reads it.
        value.record_stream(stream)
    return value


def _raisable(error: BaseException) -> BaseException:
    """A copy of a stored error, for ``get`` to raise. Raising attaches the
    caller's frames to the exception's traceback, and a caller's frame holds
    the ObjectRef whose entry holds the error: raising the stored object
    itself would close a cycle through the store that pins the error, and
    every frame its cause's traceback holds (a failed task's tensors
    included), for the life of the process."""
    try:
        return copy.copy(error)
    except Exception:  # raylint: allow(swallow) an error that cannot be copied is raised as stored
        return error


class ObjectLostError(Exception):
    """Raised when an object was freed/lost and cannot be recovered locally."""


class ObjectStore:
    """One per node. Thread-safe."""

    def __init__(self, node_id=None, capacity_bytes: Optional[int] = None):
        self._node_id = node_id
        self._lock = threading.RLock()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._host_bytes = 0
        self._capacity = capacity_bytes or _config.get("object_store_memory_bytes")
        self._spill_dir = _config.get("object_spilling_dir")
        self._num_spilled = 0
        self._num_restored = 0
        # Large pickled payloads live in the C++ mmap arena
        # (``_native/object_store.cc``, the plasma equivalent); the Python
        # dict keeps only descriptors. Heap fallback if g++ is missing.
        self._native = None
        self._native_oids: Dict[bytes, ObjectID] = {}
        # Unsealed remote-receive destinations: oid -> (arena_key|None,
        # size, heap_buf|None). Invisible to readers until sealed.
        self._recv_bufs: Dict[ObjectID, tuple] = {}
        if _config.get("use_native_object_store"):
            try:
                from ray_tpu_torch._native import NativeObjectStore
                if NativeObjectStore.available():
                    self._native = NativeObjectStore(self._capacity)
            except Exception as e:
                logger.warning("native object store unavailable: %s", e)
                self._native = None

    @staticmethod
    def _native_key(object_id: ObjectID) -> bytes:
        import hashlib
        return hashlib.blake2b(object_id.binary(), digest_size=16).digest()

    # -- put ------------------------------------------------------------------

    def put(self, object_id: ObjectID, value: Any) -> None:
        """Seal ``value`` under ``object_id``. Values are immutable once sealed."""
        entry = self._build_entry(value)
        with self._lock:
            existing = self._entries.get(object_id)
            if existing is not None and existing.sealed.is_set():
                return  # idempotent re-put (e.g. task retry recomputed the value)
            if existing is not None:
                entry.sealed = existing.sealed
            self._entries[object_id] = entry
            if entry.kind in (KIND_NUMPY, KIND_PICKLED):
                self._host_bytes += entry.size_bytes
            if (entry.kind == KIND_PICKLED and self._native is not None
                    and entry.size_bytes
                    >= _config.get("native_store_min_object_bytes")):
                self._place_native_locked(object_id, entry)
            entry.sealed.set()
            self._maybe_spill_locked()

    def _place_native_locked(self, object_id: ObjectID, entry: _Entry):
        """Move the pickled payload into the C++ arena, evicting LRU arena
        objects to disk if needed (plasma create + spill backpressure)."""
        key = self._native_key(object_id)
        data = entry.data
        for _ in range(2):
            try:
                if self._native.put(key, data):
                    self._native_oids[key] = object_id
                    entry.data = None
                    entry.native = True
                return
            except MemoryError:
                if not self._evict_native_locked(len(data)):
                    return  # arena can't fit it; keep on heap

    def _evict_native_locked(self, nbytes: int) -> bool:
        """Spill LRU arena objects to disk to free >= nbytes.

        Python-level pins (in-flight task arguments) must stay resident —
        the arena's own pin count only tracks open reads, so filter here.
        No ``min_spilling_size`` filter: this is hard backpressure, where
        freeing anything beats failing the create.
        """
        # Over-ask so pinned candidates can be skipped and still free
        # enough.
        candidates = self._native.evict_candidates(nbytes * 2)
        os.makedirs(self._spill_dir, exist_ok=True)
        oids = self._native_oids
        spilled_any = False
        freed = 0
        for key in candidates:
            if freed >= nbytes and spilled_any:
                break
            oid = oids.get(key)
            e = self._entries.get(oid) if oid is not None else None
            if e is not None and e.pin_count > 0:
                continue  # in use by a dispatched task
            data = self._native.get_bytes(key)
            if e is not None and data is not None:
                path = os.path.join(self._spill_dir, oid.hex())
                with open(path, "wb") as f:
                    f.write(data)
                e.spill_path = path
                e.kind = KIND_SPILLED
                e.native = False
                self._host_bytes -= e.size_bytes
                self._num_spilled += 1
            self._native.delete(key)
            oids.pop(key, None)
            freed += len(data) if data is not None else 0
            spilled_any = True
        return spilled_any

    def put_error(self, object_id: ObjectID, error: BaseException) -> None:
        with self._lock:
            existing = self._entries.get(object_id)
            entry = _Entry(kind=KIND_ERROR, data=error)
            if existing is not None:
                entry.sealed = existing.sealed
                # Replacing a sealed value: release its payload (arena
                # bytes would otherwise leak for the process lifetime).
                if existing.native:
                    key = self._native_key(object_id)
                    self._native.delete(key)
                    self._native_oids.pop(key, None)
                if existing.kind in (KIND_NUMPY, KIND_PICKLED):
                    self._host_bytes -= existing.size_bytes
                if existing.spill_path and os.path.exists(existing.spill_path):
                    os.unlink(existing.spill_path)
            self._entries[object_id] = entry
            entry.sealed.set()

    def create_placeholder(self, object_id: ObjectID) -> None:
        """Register an unsealed entry so getters can block until the value lands."""
        with self._lock:
            if object_id not in self._entries:
                self._entries[object_id] = _Entry(kind=KIND_PICKLED)

    # -- remote receive landing (zero-copy data plane) ------------------------

    def create_recv_buffer(self, object_id: ObjectID,
                           size: int) -> Optional[memoryview]:
        """Writable destination for a remote framed (RTF5) payload: the
        network layer recv_into's chunks DIRECTLY into the object's final
        resting place — an unsealed native arena slot when the arena can
        hold it, else a heap bytearray — so a pull/push lands with zero
        reassembly copies and no re-serialization on ``put``.

        Invisible to readers until :meth:`seal_recv_buffer`; a failed
        transfer calls :meth:`abort_recv_buffer` and leaves no trace.
        Returns None when the object is already sealed locally OR another
        transfer holds a recv buffer for it (aborting under that writer's
        live view would dangle it into reusable arena space)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and entry.sealed.is_set():
                return None
            if object_id in self._recv_bufs:
                return None
            if (self._native is not None
                    and size >= _config.get("native_store_min_object_bytes")):
                key = self._native_key(object_id)
                for _ in range(2):
                    try:
                        view = self._native.create(key, size)
                        if view is None:
                            # stale sealed slot from an aborted ancestor:
                            # replace it (content may differ per attempt)
                            self._native.delete(key)
                            view = self._native.create(key, size)
                        if view is not None:
                            self._recv_bufs[object_id] = (key, size, None)
                            return view
                        break
                    except MemoryError:
                        if not self._evict_native_locked(size):
                            break
            buf = bytearray(size)
            self._recv_bufs[object_id] = (None, size, buf)
            return memoryview(buf)

    def seal_recv_buffer(self, object_id: ObjectID) -> None:
        """Publish a fully-received framed payload as a sealed entry.
        ``get()`` decodes it lazily — zero-copy views straight out of the
        arena pages (or the heap buffer) with no intermediate pickle."""
        with self._lock:
            rec = self._recv_bufs.pop(object_id, None)
            if rec is None:
                return
            key, size, heap = rec
            existing = self._entries.get(object_id)
            if existing is not None and existing.sealed.is_set():
                if key is not None:  # raced a local put: ours is redundant
                    self._native.seal(key)
                    self._native.delete(key)
                return
            entry = _Entry(kind=KIND_PICKLED, size_bytes=size, framed=True)
            if key is not None:
                self._native.seal(key)
                self._native_oids[key] = object_id
                entry.native = True
            else:
                entry.data = heap
            if existing is not None:
                entry.sealed = existing.sealed
            self._entries[object_id] = entry
            self._host_bytes += size
            entry.sealed.set()
            self._maybe_spill_locked()

    def abort_recv_buffer(self, object_id: ObjectID) -> None:
        """Discard a half-landed transfer (sender died / fetch failed).
        The slot was never sealed, so no reader ever observed it."""
        with self._lock:
            self._abort_recv_locked(object_id)

    def _abort_recv_locked(self, object_id: ObjectID) -> None:
        rec = self._recv_bufs.pop(object_id, None)
        if rec is None or rec[0] is None:
            return
        key = rec[0]
        try:
            # Delete refuses unsealed slots (create-pin); seal first.
            self._native.seal(key)
            self._native.delete(key)
        except Exception as e:  # raylint: allow(swallow) abort is best-effort; an orphan slot is LRU-evictable once sealed
            logger.debug("recv-buffer abort failed: %s", e)

    def _build_entry(self, value: Any) -> _Entry:
        if isinstance(value, torch.Tensor):
            # Store the descriptor; the bytes stay where the tensor lives.
            return _device_entry(value)
        if isinstance(value, BaseException):
            return _Entry(kind=KIND_ERROR, data=value)
        if _is_numpy(value):
            view = value.view()
            view.flags.writeable = False
            return _Entry(kind=KIND_NUMPY, data=view, size_bytes=view.nbytes)
        buf = io.BytesIO()
        cloudpickle.dump(value, buf, protocol=pickle.HIGHEST_PROTOCOL)
        data = buf.getvalue()
        return _Entry(kind=KIND_PICKLED, data=data, size_bytes=len(data))

    # -- get ------------------------------------------------------------------

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed.is_set()

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        """Blocking fetch. Raises the stored exception for error objects."""
        if chaos.ENABLED and chaos.inject(
                "object.store.get", object=object_id.hex()[:8]) == "drop":
            # simulate local loss (eviction race): callers fall back to
            # remote fetch / lineage reconstruction
            raise ObjectLostError(f"{object_id} dropped by chaos schedule")
        with self._lock:
            entry = self._entries.get(object_id)
        if entry is None:
            raise ObjectLostError(f"{object_id} is not known to this store")
        if not entry.sealed.wait(timeout):
            raise TimeoutError(f"timed out waiting for {object_id}")
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                raise ObjectLostError(f"{object_id} was freed")
            entry.last_access = time.monotonic()
            if entry.kind == KIND_SPILLED:
                self._restore_locked(object_id, entry)
            if entry.kind == KIND_ERROR:
                raise _raisable(entry.data)
            if entry.kind == KIND_PICKLED:
                if entry.native:
                    key = self._native_key(object_id)
                    view = self._native.get(key)
                    if view is None:
                        raise ObjectLostError(f"{object_id} lost from arena")
                    if entry.framed:
                        # Framed (RTF5) payload: arrays decode as views into
                        # the arena pages — keep the slot pinned until the
                        # last such view dies.
                        value, zero_copy = loads_framed(view)
                        if zero_copy:
                            try:
                                weakref.finalize(view.obj, _release_native_pin,
                                                 self._native, self._native_oids,
                                                 key)
                            except TypeError:
                                pass  # unfinalizable backing: stay pinned
                        else:
                            view.release()
                            self._native.release(key)
                        return value
                    # Plain pickle: loads copies what it keeps.
                    try:
                        return cloudpickle.loads(view)
                    finally:
                        view.release()
                        self._native.release(key)
                if entry.framed:
                    value, _ = loads_framed(entry.data)
                    return value
                return cloudpickle.loads(entry.data)
            if entry.kind == KIND_DEVICE:
                return _checked_device_value(object_id, entry)
            return entry.data  # read-only numpy view

    def peek_error(self, object_id: ObjectID) -> Optional[BaseException]:
        """Return the stored exception if this sealed entry is an error object,
        without deserializing value entries (cheap pre-dispatch check)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None and e.sealed.is_set() and e.kind == KIND_ERROR:
                return e.data
            return None

    def wait_ready(self, object_id: ObjectID, timeout: Optional[float]) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
        if entry is None:
            return False
        return entry.sealed.wait(timeout)

    # -- ref counting / free --------------------------------------------------

    def pin(self, object_id: ObjectID):
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None:
                e.pin_count += 1

    def unpin(self, object_id: ObjectID):
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None and e.pin_count > 0:
                e.pin_count -= 1

    def free(self, object_id: ObjectID):
        with self._lock:
            e = self._entries.pop(object_id, None)
            if e is None:
                return
            if e.kind in (KIND_NUMPY, KIND_PICKLED):
                self._host_bytes -= e.size_bytes
            if e.native:
                key = self._native_key(object_id)
                self._native.delete(key)
                self._native_oids.pop(key, None)
            if e.spill_path and os.path.exists(e.spill_path):
                os.unlink(e.spill_path)

    # -- spilling -------------------------------------------------------------

    def _maybe_spill_locked(self):
        if not _config.get("object_spilling_enabled"):
            return
        threshold = self._capacity * _config.get("object_spilling_threshold")
        if self._host_bytes <= threshold:
            return
        candidates: List[Tuple[float, ObjectID, _Entry]] = [
            (e.last_access, oid, e)
            for oid, e in self._entries.items()
            if e.kind == KIND_PICKLED and e.pin_count == 0 and e.sealed.is_set()
            and e.size_bytes >= _config.get("min_spilling_size_bytes")
        ]
        candidates.sort(key=lambda t: t[0])
        os.makedirs(self._spill_dir, exist_ok=True)
        for _, oid, e in candidates:
            if self._host_bytes <= threshold:
                break
            if e.native:
                key = self._native_key(oid)
                data = self._native.get_bytes(key)
                self._native.delete(key)
                self._native_oids.pop(key, None)
                e.native = False
            else:
                data = e.data
            path = os.path.join(self._spill_dir, oid.hex())
            with open(path, "wb") as f:
                f.write(data)
            self._host_bytes -= e.size_bytes
            e.spill_path = path
            e.data = None
            e.kind = KIND_SPILLED
            self._num_spilled += 1

    def _restore_locked(self, object_id: ObjectID, entry: _Entry):
        with open(entry.spill_path, "rb") as f:
            entry.data = f.read()
        os.unlink(entry.spill_path)
        entry.spill_path = None
        entry.kind = KIND_PICKLED
        self._host_bytes += entry.size_bytes
        self._num_restored += 1
        # Pinned for the reader: an object larger than the spill threshold
        # would otherwise be spilled again at once, and ``get`` would hand
        # back its emptied payload (None).
        entry.pin_count += 1
        try:
            self._maybe_spill_locked()
        finally:
            entry.pin_count -= 1

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "num_objects": len(self._entries),
                "host_bytes": self._host_bytes,
                "capacity_bytes": self._capacity,
                "num_spilled": self._num_spilled,
                "num_restored": self._num_restored,
                "native_arena": self._native is not None,
            }
            if self._native is not None:
                used, cap, count = self._native.stats()
                out["native_used_bytes"] = used
                out["native_num_objects"] = count
            return out

    def object_ids(self) -> List[ObjectID]:
        with self._lock:
            return list(self._entries.keys())
