"""ctypes binding for the C++ shared-memory object store.

The Python face of ``object_store.cc`` (plasma client role, reference
``src/ray/object_manager/plasma/client.h``): put/get of immutable byte
payloads in the mmap arena, zero-copy reads via memoryview, LRU eviction
candidates for the spilling path.

``NativeObjectStore`` owns an arena in-process; ``NativeStoreClient``
joins another process's served arena over its Unix socket (fd-passing) —
both expose the same op surface through ``_ArenaOps``, parameterized only
by the C symbol family (``nps_*`` vs ``npc_*``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

from ray_tpu_torch._native.build import load_native_library

_PTR = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _bind_ops(lib: ctypes.CDLL, prefix: str) -> dict:
    """Bind the shared op family ``<prefix>_{create_object,seal,...}``
    once per library (argtypes are idempotent to re-set)."""
    ops = {}
    f = ops["create"] = getattr(lib, f"{prefix}_create_object")
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                  ctypes.POINTER(_PTR)]
    f = ops["seal"] = getattr(lib, f"{prefix}_seal")
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    f = ops["get"] = getattr(lib, f"{prefix}_get")
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(_PTR),
                  _U64P, ctypes.c_int]
    for name in ("unpin", "delete", "contains"):
        f = ops[name] = getattr(lib, f"{prefix}_{name}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    f = ops["stats"] = getattr(lib, f"{prefix}_stats")
    f.argtypes = [ctypes.c_void_p, _U64P, _U64P, _U64P]
    return ops


class _ArenaOps:
    """Shared op surface over a store handle (owner or client).

    Every op checks the handle first: pin-release finalizers (zero-copy
    reads) can fire at interpreter teardown AFTER the client detached —
    calling into C with a dead handle would segfault."""

    _lib: ctypes.CDLL
    _handle: int
    _ops: dict
    capacity: int

    def _h(self):
        h = getattr(self, "_handle", None)
        if not h:
            raise RuntimeError("arena handle closed")
        return h

    @staticmethod
    def _key(object_id: bytes) -> bytes:
        if len(object_id) > 16:
            raise ValueError("object id must be <= 16 bytes")
        return object_id.ljust(16, b"\0")

    def create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Reserve ``size`` bytes; returns a writable view into the arena
        (write payload parts directly — zero intermediate copy), or None
        if the id already exists. ``seal`` when done. Raises MemoryError
        when the arena is full."""
        key = self._key(object_id)
        out = _PTR()
        rc = self._ops["create"](self._h(), key, size,
                                 ctypes.byref(out))
        if rc == -1:
            return None
        if rc == -2:
            raise MemoryError(
                f"arena full ({self.capacity} bytes); evict first")
        if rc != 0:
            raise RuntimeError(f"arena create failed rc={rc}")
        if size == 0:
            return memoryview(b"")
        array = (ctypes.c_uint8 * size).from_address(
            ctypes.addressof(out.contents))
        return memoryview(array).cast("B")

    def seal(self, object_id: bytes) -> None:
        self._ops["seal"](self._h(), self._key(object_id))

    def put(self, object_id: bytes, data: bytes) -> bool:
        """Create+write+seal. False if the id exists; raises MemoryError
        when the arena is full (caller evicts/spills then retries)."""
        view = self.create(object_id, len(data))
        if view is None:
            return False
        if data:
            view[:] = data
        self.seal(object_id)
        return True

    def put_pieces(self, object_id: bytes, pieces,
                   total: int) -> bool:
        """Create + scatter-write + seal: land an already-fragmented
        payload (pickle-5 out-of-band buffers plus framing) in the arena
        WITHOUT assembling it contiguously first — the only copy is the
        one into the arena pages. ``pieces`` must cover exactly
        ``total`` bytes in order. False if the id exists; raises
        MemoryError when the arena is full (caller evicts then retries)."""
        view = self.create(object_id, total)
        if view is None:
            return False
        pos = 0
        for p in pieces:
            mv = memoryview(p).cast("B")
            n = len(mv)
            if n:
                view[pos:pos + n] = mv
            pos += n
        self.seal(object_id)
        return True

    def get(self, object_id: bytes) -> Optional[memoryview]:
        """Zero-copy read. The object is pinned until ``release``."""
        key = self._key(object_id)
        ptr = _PTR()
        size = ctypes.c_uint64()
        rc = self._ops["get"](self._h(), key, ctypes.byref(ptr),
                              ctypes.byref(size), 1)
        if rc != 0:
            return None
        if size.value == 0:
            self._ops["unpin"](self._h(), key)
            return memoryview(b"")
        array = (ctypes.c_uint8 * size.value).from_address(
            ctypes.addressof(ptr.contents))
        return memoryview(array).cast("B")

    def get_bytes(self, object_id: bytes) -> Optional[bytes]:
        """Copying read that immediately unpins."""
        view = self.get(object_id)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            self.release(object_id)

    def release(self, object_id: bytes) -> None:
        try:
            self._ops["unpin"](self._h(), self._key(object_id))
        except RuntimeError:
            pass  # closed/detached: the pin died with the connection

    def delete(self, object_id: bytes) -> bool:
        return self._ops["delete"](self._h(),
                                   self._key(object_id)) == 0

    def contains(self, object_id: bytes) -> bool:
        return self._ops["contains"](self._h(),
                                     self._key(object_id)) == 1

    def stats(self) -> Tuple[int, int, int]:
        """-> (used_bytes, capacity_bytes, num_objects)."""
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        count = ctypes.c_uint64()
        self._ops["stats"](self._h(), ctypes.byref(used),
                           ctypes.byref(cap), ctypes.byref(count))
        return used.value, cap.value or self.capacity, count.value


class NativeObjectStore(_ArenaOps):
    """Arena owner; raises ``RuntimeError`` if the native library cannot
    be built (callers should gate on ``available()``)."""

    @staticmethod
    def available() -> bool:
        return load_native_library("object_store") is not None

    def __init__(self, capacity_bytes: int):
        lib = load_native_library("object_store")
        if lib is None:
            raise RuntimeError("native object store unavailable")
        self._lib = lib
        self._ops = _bind_ops(lib, "nps")
        lib.nps_create.restype = ctypes.c_void_p
        lib.nps_create.argtypes = [ctypes.c_uint64]
        lib.nps_destroy.argtypes = [ctypes.c_void_p]
        lib.nps_serve.restype = ctypes.c_int
        lib.nps_serve.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.nps_evict_candidates.restype = ctypes.c_uint64
        lib.nps_evict_candidates.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64]
        self._handle = lib.nps_create(capacity_bytes)
        if not self._handle:
            raise RuntimeError("failed to create native store arena")
        self.capacity = capacity_bytes

    def evict_candidates(self, nbytes: int,
                         max_candidates: int = 1024) -> List[bytes]:
        """LRU (sealed, unpinned) ids whose eviction frees >= nbytes."""
        buf = ctypes.create_string_buffer(16 * max_candidates)
        n = self._lib.nps_evict_candidates(self._handle, nbytes, buf,
                                           max_candidates)
        return [buf.raw[i * 16:(i + 1) * 16] for i in range(n)]

    def serve(self, path: str) -> bool:
        """Serve this arena over a Unix domain socket: same-host peer
        processes connect with ``NativeStoreClient`` and map the SAME
        memfd pages (fd passed via SCM_RIGHTS) — a shared-memory read, not
        a TCP round-trip. Idempotent per store; refuses a store whose
        mapping fell back to private (nothing to share)."""
        return self._lib.nps_serve(self._handle, path.encode()) == 0

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.nps_destroy(handle)
            self._handle = None


class NativeStoreClient(_ArenaOps):
    """Same-host client of a served arena: identical surface to
    ``NativeObjectStore`` but reads/writes the OWNER's pages through the
    passed memfd (plasma client role, ``plasma/client.cc``)."""

    def __init__(self, socket_path: str):
        lib = load_native_library("object_store")
        if lib is None:
            raise RuntimeError("native object store unavailable")
        self._lib = lib
        self._ops = _bind_ops(lib, "npc")
        lib.npc_connect.restype = ctypes.c_void_p
        lib.npc_connect.argtypes = [ctypes.c_char_p]
        lib.npc_close.argtypes = [ctypes.c_void_p]
        lib.npc_capacity.restype = ctypes.c_uint64
        lib.npc_capacity.argtypes = [ctypes.c_void_p]
        lib.npc_detach.argtypes = [ctypes.c_void_p]
        self._handle = lib.npc_connect(socket_path.encode())
        if not self._handle:
            raise RuntimeError(f"cannot connect to arena at {socket_path}")
        self.capacity = lib.npc_capacity(self._handle)

    def close(self, unmap: bool = True) -> None:
        """``unmap=False`` keeps the arena mapping alive: zero-copy values
        already handed out reference those pages, and unmapping under them
        would turn a later read into a SIGSEGV. Use it on runtime shutdown;
        plain close() only when no decoded values can be outstanding."""
        handle = getattr(self, "_handle", None)
        if handle:
            if unmap:
                self._lib.npc_close(handle)
            else:
                self._lib.npc_detach(handle)
            self._handle = None

    def __del__(self):
        # GC cannot know whether decoded views are still alive — never
        # unmap implicitly
        self.close(unmap=False)
