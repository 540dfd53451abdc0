"""Durable workflow storage.

Parity with ``python/ray/workflow/workflow_storage.py``: every task result
is persisted before the workflow advances, so a crashed run resumes from
the last completed task instead of recomputing.  Layout (filesystem; the
base directory can live on NFS/GCS-fuse for multi-host durability)::

    <base>/<workflow_id>/
        dag.pkl            # pickled DAG for resume
        status.json        # RUNNING | SUCCESS | FAILED | CANCELED
        tasks/<task_id>.pkl    # one durable result per task

Writes are atomic (tmp file + rename) so a crash mid-write never leaves a
corrupt result that resume would trust.

Results and the DAG are pickled as values that leave the process
(``_private/framing.dumps``): a tensor is kept as its dtype, shape and host
bytes, and reads back onto the reader's ``cuda:0``, or onto the CPU in a
process without a card, as a ``jax.Array`` reads back onto the reader's
default device. A plain cloudpickle of a CUDA tensor would name its device,
and a reader without a card could not load it.
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import framing

_DEFAULT_BASE = os.path.expanduser("~/.ray_tpu/workflows")


def _atomic_write(path: str, data: bytes) -> None:
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class WorkflowStorage:
    def __init__(self, workflow_id: str, base_dir: Optional[str] = None):
        self.workflow_id = workflow_id
        self.base = os.path.join(base_dir or _DEFAULT_BASE, workflow_id)
        self.tasks_dir = os.path.join(self.base, "tasks")

    # -- dag ---------------------------------------------------------------

    def save_dag(self, dag) -> None:
        _atomic_write(os.path.join(self.base, "dag.pkl"), framing.dumps(dag))

    def load_dag(self):
        with open(os.path.join(self.base, "dag.pkl"), "rb") as f:
            return pickle.load(f)

    # -- task results ------------------------------------------------------

    def _task_path(self, task_id: str) -> str:
        # continuation task ids are namespaced with "/" — they become
        # nested directories under tasks_dir
        return os.path.join(self.tasks_dir, f"{task_id}.pkl")

    def save_task_result(self, task_id: str, result: Any) -> None:
        path = self._task_path(task_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, framing.dumps(result))

    def has_task_result(self, task_id: str) -> bool:
        return os.path.exists(self._task_path(task_id))

    def load_task_result(self, task_id: str) -> Any:
        with open(self._task_path(task_id), "rb") as f:
            return pickle.load(f)

    def list_task_results(self) -> List[str]:
        if not os.path.isdir(self.tasks_dir):
            return []
        return [f[:-4] for f in os.listdir(self.tasks_dir)
                if f.endswith(".pkl")]

    # -- status ------------------------------------------------------------

    def save_status(self, status: str, error: Optional[str] = None,
                    root_task_id: Optional[str] = None) -> None:
        _atomic_write(
            os.path.join(self.base, "status.json"),
            json.dumps({"status": status, "error": error,
                        "root_task_id": root_task_id,
                        "updated_at": time.time()}).encode())

    def load_status(self) -> Dict[str, Any]:
        try:
            with open(os.path.join(self.base, "status.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"status": "NOT_FOUND", "error": None}

    def exists(self) -> bool:
        return os.path.isdir(self.base)

    @staticmethod
    def list_workflows(base_dir: Optional[str] = None) -> List[str]:
        base = base_dir or _DEFAULT_BASE
        if not os.path.isdir(base):
            return []
        return sorted(
            d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d)))

    def delete(self) -> None:
        import shutil
        shutil.rmtree(self.base, ignore_errors=True)
