"""Distributed-future reference counting with lineage pinning.

Parity with the reference's ``ReferenceCounter``
(``src/ray/core_worker/reference_count.h:61``): tracks local refs and
task-argument pins per object; when counts hit zero the object is freed from
the store, but the *task spec* that produced it is retained by the lineage
table while any downstream object still depends on it, enabling
reconstruction (``object_recovery_manager.h:90``). The runtime here is
host-granular, so "local refs" covers all workers in the owner process;
borrower bookkeeping reduces to refs held by serialized handles.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch._private.ids import ObjectID


class ReferenceCounter:
    def __init__(self, on_zero: Optional[Callable[[ObjectID], None]] = None):
        self._lock = threading.Lock()
        self._local_refs: Dict[ObjectID, int] = {}  # raylint: guarded-by(self._lock)
        self._pins: Dict[ObjectID, int] = {}  # in-flight task arg pins  # raylint: guarded-by(self._lock)
        # Cross-process borrows: oid -> {borrower address -> count}. The
        # owner holds the value while any borrower process retains a
        # deserialized handle (reference_count.h:61 borrower bookkeeping).
        self._borrows: Dict[ObjectID, Dict[str, int]] = {}  # raylint: guarded-by(self._lock)
        self._on_zero = on_zero  # raylint: allow(data-race) set during __init__ before the counter is shared

    def set_on_zero(self, cb: Callable[[ObjectID], None]):
        with self._lock:
            self._on_zero = cb

    def add_local_ref(self, oid: ObjectID):
        with self._lock:
            self._local_refs[oid] = self._local_refs.get(oid, 0) + 1

    def _zero_locked(self, oid: ObjectID) -> bool:
        """All three holds — local refs, task pins, remote borrows — gone."""
        return (self._local_refs.get(oid, 0) == 0
                and self._pins.get(oid, 0) == 0
                and not self._borrows.get(oid))

    def remove_local_ref(self, oid: ObjectID):
        cb = None
        with self._lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
            else:
                self._local_refs.pop(oid, None)
                if self._zero_locked(oid):
                    cb = self._on_zero
        if cb is not None:
            cb(oid)

    def pin_for_task(self, oid: ObjectID):
        with self._lock:
            self._pins[oid] = self._pins.get(oid, 0) + 1

    def unpin_for_task(self, oid: ObjectID):
        cb = None
        with self._lock:
            n = self._pins.get(oid, 0) - 1
            if n > 0:
                self._pins[oid] = n
            else:
                self._pins.pop(oid, None)
                if self._zero_locked(oid):
                    cb = self._on_zero
        if cb is not None:
            cb(oid)

    def add_borrow(self, oid: ObjectID, borrower: str):
        """Record that ``borrower`` (a process address) holds the object.
        Idempotent per borrower: the borrower's own reference counter tracks
        how many handles it holds and sends exactly one REMOVE_BORROW when
        its count hits zero, so the owner only needs presence — counting
        each ADD_BORROW would leak when N deserializations pair with one
        removal (reference_count.h:61 tracks borrower worker identity the
        same way)."""
        with self._lock:
            self._borrows.setdefault(oid, {})[borrower] = 1

    def remove_borrow(self, oid: ObjectID, borrower: str):
        cb = None
        with self._lock:
            per = self._borrows.get(oid)
            if per is not None:
                per.pop(borrower, None)
                if not per:
                    self._borrows.pop(oid, None)
            if self._zero_locked(oid):
                cb = self._on_zero
        if cb is not None:
            cb(oid)

    def remove_borrower(self, borrower: str):
        """A borrower process died: drop every borrow it held."""
        zeroed = []
        with self._lock:
            for oid in list(self._borrows):
                per = self._borrows[oid]
                if per.pop(borrower, None) is not None and not per:
                    self._borrows.pop(oid, None)
                    if self._zero_locked(oid):
                        zeroed.append(oid)
        if self._on_zero is not None:
            for oid in zeroed:
                self._on_zero(oid)

    def has_refs(self, oid: ObjectID) -> bool:
        with self._lock:
            return (self._local_refs.get(oid, 0) > 0
                    or self._pins.get(oid, 0) > 0
                    or bool(self._borrows.get(oid)))

    def count(self, oid: ObjectID) -> int:
        with self._lock:
            return (self._local_refs.get(oid, 0) + self._pins.get(oid, 0)
                    + sum(self._borrows.get(oid, {}).values()))

    def live_objects(self) -> Set[ObjectID]:
        with self._lock:
            return set(self._local_refs) | set(self._pins) | set(self._borrows)
