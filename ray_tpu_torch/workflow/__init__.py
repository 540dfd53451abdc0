"""ray_tpu_torch.workflow — durable DAG execution (reference:
python/ray/workflow/)."""

from ray_tpu_torch.workflow.api import (Continuation,  # noqa: F401
                                        continuation, delete, get_output,
                                        get_status, init, list_all, resume,
                                        run, run_async, wait_for_event)
from ray_tpu_torch.workflow.executor import (  # noqa: F401
    WorkflowExecutionError)
from ray_tpu_torch.workflow.storage import WorkflowStorage  # noqa: F401

__all__ = ["init", "run", "run_async", "resume", "get_status", "get_output",
           "list_all", "delete", "wait_for_event", "continuation", "Continuation", "WorkflowStorage",
           "WorkflowExecutionError"]
