"""Checkpoint manifest format + crash-atomic commit primitives.

A checkpoint on disk is a content-addressed chunk store plus a small JSON
*manifest* naming the chunks. Layout under an engine root::

    chunks/<aa>/<sha256>          immutable content-addressed chunk files
    manifests/ck-<step>-<uid>.json   one manifest per committed checkpoint
    pending/<save-key>/shard-<rank>.json   per-rank shard indexes awaiting
                                           the committer (removed on commit)
    LATEST                        name of the newest committed manifest

Durability contract (the reason restore can never see a torn checkpoint):

1. chunk files land under a temp name and are ``os.replace``d into their
   hash name — a chunk either has its final name and is complete, or it
   does not exist;
2. the manifest is written tmp + fsync + ``os.replace`` — same property;
3. ``LATEST`` is updated (tmp + replace) only *after* the manifest rename.

A crash between (2) and (3) leaves ``LATEST`` on the predecessor while the
new manifest is already fully readable; a crash anywhere earlier leaves at
worst orphaned chunks/tmp files, which refcount GC reaps. Restore resolves
``LATEST`` first and falls back to scanning ``manifests/`` for the newest
manifest whose chunks all exist.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FORMAT = "rtck/1"

CHUNKS_DIR = "chunks"
MANIFESTS_DIR = "manifests"
PENDING_DIR = "pending"
LATEST_FILE = "LATEST"


class CheckpointError(RuntimeError):
    """Base error for the checkpoint engine."""


class CheckpointCorruption(CheckpointError):
    """A chunk failed hash verification or a manifest references missing
    chunks — the checkpoint must not be trusted."""


class CheckpointNotFound(CheckpointError):
    """No committed manifest exists (yet) at the given root."""


# -- atomic file primitives ---------------------------------------------------

def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = True) -> None:
    """tmp-in-same-dir + fsync + rename: ``path`` is either absent/old or
    complete — never partial. ``fsync=False`` keeps the rename atomicity
    (no torn file visible to readers) but skips the durability barrier —
    for files that only matter within this boot (pending shard indexes,
    write-through chunk caches)."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def chunk_relpath(chunk_id: str) -> str:
    return os.path.join(CHUNKS_DIR, chunk_id[:2], chunk_id)


def hash_bytes(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, str):
            p = p.encode()
        h.update(p)
    return h.hexdigest()


# -- manifest schema ----------------------------------------------------------

@dataclass
class ArrayEntry:
    """One array leaf of one shard: a content-addressed chunk plus enough
    metadata to verify it and to place it inside the global array when the
    save was sharded."""

    path: str                 # "/"-joined key path inside the pytree
    slot: int                 # position in the shard's array-slot ordering
    chunk: str                # sha256 content hash (= data identity)
    nbytes: int
    dtype: str
    shape: List[int]
    # Declared by the caller at save time (save(shard_paths=...)); the
    # committer trusts this flag — placement is never inferred from data.
    sharded: bool = False
    global_shape: Optional[List[int]] = None   # set when sharded
    offset: Optional[List[int]] = None         # per-dim start inside global

    def to_json(self) -> Dict[str, Any]:
        d = {"path": self.path, "slot": self.slot, "chunk": self.chunk,
             "nbytes": self.nbytes, "dtype": self.dtype,
             "shape": list(self.shape)}
        if self.sharded:
            d["sharded"] = True
        if self.global_shape is not None:
            d["global_shape"] = list(self.global_shape)
            d["offset"] = list(self.offset or [0] * len(self.global_shape))
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ArrayEntry":
        return cls(path=d["path"], slot=d["slot"], chunk=d["chunk"],
                   nbytes=d["nbytes"], dtype=d["dtype"],
                   shape=list(d["shape"]),
                   sharded=bool(d.get("sharded", False)),
                   global_shape=d.get("global_shape"),
                   offset=d.get("offset"))


@dataclass
class ShardIndex:
    """What one rank wrote: the skeleton chunk (treedef + non-array leaves,
    array leaves replaced by slot markers) and one entry per array leaf."""

    rank: int
    skeleton: str             # chunk id of the pickled skeleton
    skeleton_nbytes: int
    arrays: List[ArrayEntry] = field(default_factory=list)

    def chunk_ids(self) -> List[str]:
        return [self.skeleton] + [a.chunk for a in self.arrays]

    def to_json(self) -> Dict[str, Any]:
        return {"rank": self.rank, "skeleton": self.skeleton,
                "skeleton_nbytes": self.skeleton_nbytes,
                "arrays": [a.to_json() for a in self.arrays]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ShardIndex":
        return cls(rank=d["rank"], skeleton=d["skeleton"],
                   skeleton_nbytes=d["skeleton_nbytes"],
                   arrays=[ArrayEntry.from_json(a) for a in d["arrays"]])


@dataclass
class Manifest:
    """The commit unit: a save is durable iff its manifest file exists."""

    id: str
    step: int
    world_size: int
    shards: List[ShardIndex]
    shard_axis: Optional[int] = None      # None = each shard is a full tree
    mesh: Optional[Dict[str, Any]] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    created: float = 0.0
    format: str = FORMAT

    @property
    def filename(self) -> str:
        return f"ck-{self.step:08d}-{self.id}.json"

    def chunk_ids(self) -> List[str]:
        out: List[str] = []
        for s in self.shards:
            out.extend(s.chunk_ids())
        return out

    def total_bytes(self) -> int:
        return sum(s.skeleton_nbytes + sum(a.nbytes for a in s.arrays)
                   for s in self.shards)

    def to_json(self) -> Dict[str, Any]:
        return {"format": self.format, "id": self.id, "step": self.step,
                "created": self.created, "world_size": self.world_size,
                "shard_axis": self.shard_axis, "mesh": self.mesh,
                "meta": self.meta,
                "shards": [s.to_json() for s in self.shards]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Manifest":
        if d.get("format") != FORMAT:
            raise CheckpointCorruption(
                f"unknown manifest format {d.get('format')!r} "
                f"(engine speaks {FORMAT})")
        return cls(id=d["id"], step=d["step"], world_size=d["world_size"],
                   shards=[ShardIndex.from_json(s) for s in d["shards"]],
                   shard_axis=d.get("shard_axis"), mesh=d.get("mesh"),
                   meta=d.get("meta") or {}, created=d.get("created", 0.0))


def new_manifest_id() -> str:
    return uuid.uuid4().hex[:8]


# -- root-level operations ----------------------------------------------------

def init_root(root: str) -> None:
    for sub in (CHUNKS_DIR, MANIFESTS_DIR, PENDING_DIR):
        os.makedirs(os.path.join(root, sub), exist_ok=True)


def write_manifest(root: str, m: Manifest) -> str:
    """Atomically publish ``m`` (step 2 of the commit protocol). Returns
    the manifest filename. The caller advances LATEST separately."""
    if not m.created:
        m.created = time.time()
    path = os.path.join(root, MANIFESTS_DIR, m.filename)
    atomic_write_bytes(path, json.dumps(m.to_json(), indent=1).encode())
    return m.filename


def set_latest(root: str, manifest_name: str) -> None:
    atomic_write_bytes(os.path.join(root, LATEST_FILE),
                       manifest_name.encode())


def read_manifest(root: str, manifest_name: str) -> Manifest:
    path = os.path.join(root, MANIFESTS_DIR, manifest_name)
    try:
        with open(path, encoding="utf-8") as f:
            return Manifest.from_json(json.load(f))
    except FileNotFoundError:
        raise CheckpointNotFound(f"no manifest {manifest_name!r} at {root}")
    except (json.JSONDecodeError, KeyError) as e:
        raise CheckpointCorruption(f"manifest {manifest_name!r} unreadable: "
                                   f"{e}") from e


def list_manifest_names(root: str) -> List[str]:
    d = os.path.join(root, MANIFESTS_DIR)
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    return sorted(n for n in names
                  if n.startswith("ck-") and n.endswith(".json"))


def list_manifest_names_by_commit_time(root: str) -> List[str]:
    """Manifest names oldest-commit-first (file mtime, name tie-break).

    Retention and the LATEST fallback scan order by *commit recency*, not
    by the step embedded in the filename: a caller whose step counter
    restarted (a new engine attempt after a crash) must never have its
    fresh commits out-sorted — and reaped — by stale higher-step
    manifests from before the crash.
    """
    def mtime(name: str) -> float:
        try:
            return os.path.getmtime(os.path.join(root, MANIFESTS_DIR, name))
        except OSError:
            return 0.0
    return sorted(list_manifest_names(root), key=lambda n: (mtime(n), n))


def pending_chunk_ids(root: str,
                      max_age_s: Optional[float] = None) -> set:
    """Chunk ids referenced by any rank's pending/ shard index — an
    in-flight save that some committer may still publish. GC must treat
    these as live even though no committed manifest names them yet.
    Indexes older than ``max_age_s`` are ignored: the committer's
    shard-wait deadline has long expired, so they can never join a commit
    (crashed attempts must not protect their residue forever)."""
    out: set = set()
    pend = os.path.join(root, PENDING_DIR)
    try:
        keys = os.listdir(pend)
    except OSError:
        return out
    now = time.time()
    for key in keys:
        d = os.path.join(pend, key)
        try:
            files = os.listdir(d)
        except OSError:
            continue
        for fn in files:
            if not (fn.startswith("shard-") and fn.endswith(".json")):
                continue
            path = os.path.join(d, fn)
            try:
                if max_age_s is not None \
                        and now - os.path.getmtime(path) > max_age_s:
                    continue
                with open(path, encoding="utf-8") as f:
                    out.update(ShardIndex.from_json(
                        json.load(f)["shard"]).chunk_ids())
            except (OSError, json.JSONDecodeError, KeyError, TypeError):
                continue  # torn/stale index protects nothing
    return out


def chunks_present(root: str, m: Manifest) -> bool:
    return all(os.path.exists(os.path.join(root, chunk_relpath(c)))
               for c in m.chunk_ids())


def resolve_latest(root: str) -> Optional[str]:
    """Name of the newest *complete* committed manifest, or None.

    Trusts ``LATEST`` when it points at a manifest whose chunks all exist
    (the normal case); otherwise scans ``manifests/`` newest-commit-first
    and returns the first fully-present one — this is what makes a crash
    between manifest rename and LATEST update harmless.
    """
    try:
        with open(os.path.join(root, LATEST_FILE), encoding="utf-8") as f:
            name = f.read().strip()
    except OSError:
        name = ""
    if name:
        try:
            if chunks_present(root, read_manifest(root, name)):
                return name
        except CheckpointError:
            pass
    for name in reversed(list_manifest_names_by_commit_time(root)):
        try:
            if chunks_present(root, read_manifest(root, name)):
                return name
        except CheckpointError:
            continue
    return None
