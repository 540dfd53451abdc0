"""Checkpoint: dict / directory / manifest / object-ref interconvertible.

Port of ``ray_tpu/air/checkpoint.py``. The dict form shares its array leaves
(``torch.Tensor`` or ``np.ndarray``) and copies only the containers. The
directory form writes the array subtrees with ``torch.save`` beside a
pickle of everything else. The manifest form points at a committed
``ray_tpu_torch.checkpoint`` engine manifest and loads lazily, as numpy.
The object-ref forms go through the runtime's object store.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None,
                 manifest: Optional[Any] = None):
        if sum(x is not None for x in (data, directory, manifest)) != 1:
            raise ValueError(
                "provide exactly one of data=, directory= or manifest=")
        self._data = data
        self._directory = directory
        # A ray_tpu_torch.checkpoint.CheckpointRef: the checkpoint lives in
        # a content-addressed engine store; this object is a light,
        # picklable pointer and loads lazily (elastic restore reshards at
        # load time).
        self._manifest = manifest

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=path)

    @classmethod
    def from_manifest(cls, root: str,
                      manifest_name: Optional[str] = None) -> "Checkpoint":
        """Checkpoint backed by a committed engine manifest. With no
        ``manifest_name`` the newest complete commit is pinned now, so the
        reference stays stable under later saves."""
        from ray_tpu_torch.checkpoint import (CheckpointNotFound,
                                              CheckpointRef, resolve_latest)
        name = manifest_name or resolve_latest(root)
        if name is None:
            raise CheckpointNotFound(f"no committed checkpoint under {root}")
        return cls(manifest=CheckpointRef(root, name))

    @classmethod
    def from_object_ref(cls, ref) -> "Checkpoint":
        from ray_tpu_torch._private import worker as _worker
        return cls.from_dict(_worker.get(ref))

    # -- conversions ----------------------------------------------------------

    @property
    def manifest_ref(self):
        """The engine CheckpointRef backing this checkpoint, or None."""
        return self._manifest

    def to_dict(self) -> Dict[str, Any]:
        if self._manifest is not None:
            from ray_tpu_torch.train import session as _session
            s = _session._get_session()
            if s is not None:
                # inside a train worker: restore THIS rank's (resharded)
                # slice of the saved world
                return self._manifest.load(rank=s.world_rank,
                                           world_size=s.world_size)
            return self._manifest.load()
        if self._data is not None:
            # Copy the dict *containers* recursively so caller mutation of
            # any nesting level cannot corrupt the stored checkpoint. Leaves
            # are shared, not copied: callers must not write into them.
            return _copy_containers(self._data)
        return self._load_directory(self._directory)

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._directory is not None and path is None:
            return self._directory
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        data = self.to_dict()
        arrays = {}
        plain = {}
        for k, v in data.items():
            if _is_array_tree(v):
                arrays[k] = v
            else:
                plain[k] = v
        if arrays:
            torch.save(arrays, os.path.join(path, "arrays.pt"))
        with open(os.path.join(path, "data.pkl"), "wb") as f:
            pickle.dump(plain, f)
        return path

    def to_object_ref(self):
        from ray_tpu_torch._private import worker as _worker
        return _worker.put(self.to_dict())

    @staticmethod
    def _load_directory(path: str) -> Dict[str, Any]:
        # Both files are this class's own output (see to_directory).
        data: Dict[str, Any] = {}
        pkl = os.path.join(path, "data.pkl")
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                data.update(pickle.load(f))
        arrays_path = os.path.join(path, "arrays.pt")
        if os.path.exists(arrays_path):
            data.update(torch.load(arrays_path, map_location="cpu",
                                   weights_only=False))
        return data


def _copy_containers(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _copy_containers(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_containers(x) for x in v]
    return v


def _leaves(v: Any):
    if isinstance(v, dict):
        for x in v.values():
            yield from _leaves(x)
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _leaves(x)
    else:
        yield v


def _is_array_tree(v: Any) -> bool:
    """True if v is an array or a dict/list tree whose leaves are all arrays."""
    leaves = list(_leaves(v))
    if not leaves:
        return False
    return all(isinstance(l, (torch.Tensor, np.ndarray)) for l in leaves)
