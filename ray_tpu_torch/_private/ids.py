"""Unique identifiers for jobs, tasks, actors, objects, and nodes.

Capability parity with the reference's ID scheme (``src/ray/common/id.h``):
IDs are fixed-width random byte strings with embedded lineage — an ObjectID
embeds the TaskID that produced it plus a return/put index, and a TaskID
embeds the JobID and (for actor tasks) the ActorID. Unlike the reference we
keep these pure-Python: the control plane here is host-granular (one device
owner process per host) so ID manipulation is never on the hot device path.
"""

from __future__ import annotations

import os
import threading

_UNIQUE_LEN = 16  # bytes of entropy for top-level ids


class BaseID:
    """Immutable, hashable fixed-width id."""

    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes):
            raise TypeError(f"id must be bytes, got {type(id_bytes)}")
        self._bytes = id_bytes
        self._hash = hash((type(self).__name__, id_bytes))

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.size()))

    @classmethod
    def size(cls) -> int:
        return _UNIQUE_LEN

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.size())

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.size()

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __reduce__(self):
        # Rebuild through __init__ so _hash is recomputed in the receiving
        # process: Python string hashing is randomized PER PROCESS, and a
        # verbatim-copied _hash (the __slots__ default pickling) makes
        # unpickled ids miss dict lookups against locally-built keys.
        return (type(self), (self._bytes,))

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"


class JobID(BaseID):
    @classmethod
    def size(cls) -> int:
        return 4


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class ActorID(BaseID):
    """JobID (4) + unique (12)."""

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(cls.size() - JobID.size()))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.size()])


class TaskID(BaseID):
    """JobID (4) + actor id tail or zeros (4) + unique (8)."""

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.binary() + b"\x00" * 4 + os.urandom(8))

    @classmethod
    def for_actor_task(cls, job_id: JobID, actor_id: ActorID) -> "TaskID":
        return cls(job_id.binary() + actor_id.binary()[-4:] + os.urandom(8))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.size()])


class ObjectID(BaseID):
    """TaskID (16) + little-endian index (4).

    Index 0..2^31 are task returns; >=2^31 are ``put`` objects, mirroring the
    reference's return/put index split in ``id.h``.
    """

    PUT_INDEX_BASE = 1 << 31

    @classmethod
    def size(cls) -> int:
        return TaskID.size() + 4

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls.for_return(task_id, cls.PUT_INDEX_BASE + put_index)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.size()])

    def index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.size():], "little")

    def is_put(self) -> bool:
        return self.index() >= self.PUT_INDEX_BASE

    def is_return(self) -> bool:
        return not self.is_put()


ObjectRefID = ObjectID  # alias


class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
