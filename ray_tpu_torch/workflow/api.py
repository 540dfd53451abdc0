"""Public workflow API.

Parity with ``python/ray/workflow/api.py``: ``workflow.run(dag,
workflow_id=...)`` executes a DAG durably; ``workflow.resume`` restarts a
crashed/failed run from its last persisted task; listing/status/output
accessors; ``wait_for_event`` integrates external events as durable tasks
(reference ``event_listener.py``).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.workflow.executor import (WorkflowExecutionError,
                                             WorkflowExecutor)
from ray_tpu_torch.workflow.storage import WorkflowStorage

_base_dir: Optional[str] = None
_async_runs: Dict[str, threading.Thread] = {}


def init(storage_base_dir: Optional[str] = None) -> None:
    """Configure workflow storage (default: ~/.ray_tpu/workflows)."""
    global _base_dir
    _base_dir = storage_base_dir  # raylint: allow(data-race) configured once at workflow init before any run launches
    if not ray_tpu.is_initialized():
        ray_tpu.init()


def run(dag, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a DAG durably; returns its result."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    if not ray_tpu.is_initialized():
        ray_tpu.init()
    storage = WorkflowStorage(workflow_id, _base_dir)
    status = storage.load_status()["status"]
    if status == "SUCCESS":
        # Idempotent re-run: return the stored output.
        return get_output(workflow_id)
    storage.save_dag(dag)
    return WorkflowExecutor(workflow_id, storage).execute(dag)


def run_async(dag, *, workflow_id: Optional[str] = None) -> str:
    """Start a durable run in the background; returns the workflow id."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"

    def target():
        # Storage is the authoritative result (status + per-task values);
        # nothing is cached in process globals, so finished runs leave no
        # unbounded state behind. The run itself persists SUCCESS/FAILED.
        try:
            run(dag, workflow_id=workflow_id)
        except BaseException:  # raylint: allow(swallow) executor already persisted FAILED in storage
            pass  # recorded in storage as FAILED by the executor
        finally:
            _async_runs.pop(workflow_id, None)  # raylint: allow(data-race) GIL-atomic dict op on the run registry

    t = threading.Thread(target=target, daemon=True,
                         name=f"workflow-{workflow_id}")
    _async_runs[workflow_id] = t  # raylint: allow(data-race) GIL-atomic dict op on the run registry
    t.start()
    return workflow_id


def resume(workflow_id: str) -> Any:
    """Resume a workflow from persisted state: completed tasks replay from
    storage, the rest re-execute."""
    storage = WorkflowStorage(workflow_id, _base_dir)
    if not storage.exists():
        raise ValueError(f"No workflow with id {workflow_id!r}")
    if not ray_tpu.is_initialized():
        ray_tpu.init()
    dag = storage.load_dag()
    return WorkflowExecutor(workflow_id, storage).execute(dag)


def get_status(workflow_id: str) -> str:
    return WorkflowStorage(workflow_id, _base_dir).load_status()["status"]


def get_output(workflow_id: str, *, wait: bool = False,
               timeout: Optional[float] = None) -> Any:
    """Return the root task's stored result (optionally waiting for an
    async run to finish)."""
    storage = WorkflowStorage(workflow_id, _base_dir)
    if wait:
        # Join before the existence check: an async run may not have
        # created its storage directory yet. Storage stays authoritative
        # afterwards (a deleted workflow must raise, not return a stale
        # in-memory value).
        t = _async_runs.get(workflow_id)
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"Workflow {workflow_id!r} still running after "
                    f"{timeout}s")
    if not storage.exists():
        raise ValueError(f"No workflow with id {workflow_id!r}")
    info = storage.load_status()
    status = info["status"]
    if status == "FAILED":
        raise WorkflowExecutionError(
            workflow_id, RuntimeError(info["error"]))
    if status != "SUCCESS":
        raise RuntimeError(
            f"Workflow {workflow_id!r} has status {status}; output not "
            f"available")
    root_id = info.get("root_task_id")
    if root_id is None:
        # Legacy runs without a recorded root: highest structural index
        # (numeric prefix, not lexicographic).
        task_ids = storage.list_task_results()
        if not task_ids:
            return None
        root_id = max(task_ids, key=lambda t: int(t.split("_", 1)[0]))
    return storage.load_task_result(root_id)


def list_all() -> List[Dict[str, str]]:
    out = []
    for wid in WorkflowStorage.list_workflows(_base_dir):
        out.append({"workflow_id": wid,
                    "status": get_status(wid)})
    return out


def delete(workflow_id: str) -> None:
    WorkflowStorage(workflow_id, _base_dir).delete()


class Continuation:
    """Marker a step returns to hand execution to a sub-DAG (reference
    ``workflow.continuation``): the sub-DAG's result replaces the step's
    result, enabling recursive/dynamic workflows."""

    def __init__(self, dag):
        self.dag = dag


def continuation(dag) -> Continuation:
    """Wrap a ``.bind()`` DAG so returning it from a workflow step
    CONTINUES the workflow with that DAG instead of finishing with the
    node object itself."""
    return Continuation(dag)


def wait_for_event(poll_fn, *, poll_interval_s: float = 0.5,
                   timeout_s: Optional[float] = None):
    """Durable event task (reference ``event_listener.py``): returns a DAG
    node that polls ``poll_fn`` until it returns a non-None payload; the
    payload is checkpointed like any task result, so resumed workflows do
    not wait for the event again."""

    @ray_tpu.remote
    def _event_task():
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            payload = poll_fn()
            if payload is not None:
                return payload
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("event did not arrive in time")
            time.sleep(poll_interval_s)

    return _event_task.bind()
