"""Distributed futures.

Parity with the reference's ``ObjectRef`` (``python/ray/includes/object_ref.pxi``,
owner info in ``src/ray/core_worker/reference_count.h:61``): a handle to an
immutable value that may not exist yet. Refs are awaitable, hashable, and
participate in reference counting — when the last local ref drops, the value
may be freed unless lineage pinning keeps it for reconstruction.
"""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner", "__weakref__")

    def __init__(self, object_id: ObjectID, owner=None):
        self._id = object_id
        self._owner = owner
        if owner is not None:
            owner.reference_counter.add_local_ref(object_id)

    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def task_id(self):
        return self._id.task_id()

    def future(self):
        """Return a concurrent.futures.Future resolved with the value."""
        import concurrent.futures

        from ray_tpu_torch._private import worker as _worker
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(_worker.get(self))
            except BaseException as e:  # noqa: BLE001 - propagate task errors
                fut.set_exception(e)

        _worker.global_worker().runtime.offload(_resolve)
        return fut

    def __await__(self):
        import asyncio
        return asyncio.wrap_future(self.future()).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()[:16]})"

    def __reduce__(self):
        # Borrowing protocol (reference_count.h:61): the owning runtime
        # decides the reduction. In-process it pins until the deserializer
        # re-binds; the distributed runtime instead emits a marker carrying
        # owner/sender addresses so the deserializer can register a borrow
        # with the owner (see DistributedRuntime.reduce_ref).
        if self._owner is not None:
            return self._owner.reduce_ref(self._id)
        return (_deserialize_ref, (self._id.binary(),))

    def __del__(self):
        owner = getattr(self, "_owner", None)
        if owner is not None:
            try:
                owner.reference_counter.remove_local_ref(self._id)
            except Exception:  # raylint: allow(swallow) interpreter teardown: owner runtime may be gone
                pass


def _deserialize_ref(id_bytes: bytes) -> "ObjectRef":
    from ray_tpu_torch._private import worker as _worker
    oid = ObjectID(id_bytes)
    runtime = _worker.try_global_runtime()
    if runtime is not None:
        return ObjectRef(oid, owner=runtime)
    return ObjectRef(oid, owner=None)


def _deserialize_borrowed_ref(id_bytes: bytes) -> "ObjectRef":
    from ray_tpu_torch._private import worker as _worker
    oid = ObjectID(id_bytes)
    runtime = _worker.try_global_runtime()
    if runtime is not None:
        ref = ObjectRef(oid, owner=runtime)  # takes a local ref first
        runtime.reference_counter.unpin_for_task(oid)  # then release the pin
        return ref
    return ObjectRef(oid, owner=None)
