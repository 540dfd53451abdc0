"""Task specifications — the unit the scheduler and lineage table operate on.

Parity with ``TaskSpecification`` (``src/ray/common/task/task_spec.h``) and
the option registry (``python/ray/_private/ray_option_utils.py``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.resources import ResourceSet


@dataclass
class SchedulingStrategy:
    """Base; concrete strategies live in ray_tpu.util.scheduling_strategies."""


@dataclass
class TaskOptions:
    num_returns: int = 1
    resources: ResourceSet = field(default_factory=ResourceSet)
    max_retries: int = 3
    retry_exceptions: Any = False  # False | True | list of exception types
    scheduling_strategy: Any = "DEFAULT"
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    name: Optional[str] = None
    runtime_env: Optional[Dict[str, Any]] = None
    concurrency_group: Optional[str] = None
    _generator: bool = False


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    function: Callable
    function_name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    options: TaskOptions
    return_ids: Tuple[ObjectID, ...] = ()
    actor_id: Optional[ActorID] = None
    method_name: Optional[str] = None
    attempt: int = 0
    # Cross-task trace propagation (reference
    # ``python/ray/util/tracing/tracing_helper.py:160-175``): the trace
    # id rides every hop of a task tree; parent_span_id links this
    # task's span to the span that submitted it.
    trace_id: str = ""
    parent_span_id: str = ""
    # Perf plane: wall-clock submit stamp (time.time(), set when
    # perf.ENABLED, and on the actor call of a serve request, where it is
    # the handle call's time: ``runtime.call_context``) so the executing
    # side can split scheduling wait from execution in the task.e2e /
    # task.sched histograms and time a request's route.  Wall clock
    # because submit and execute may be different processes; when the spec
    # crosses a process boundary the stamp is rebased through the
    # state-service timebase (clocksync) so the execute-site delta is
    # skew-corrected, and residual negatives clamp to the execution time.
    perf_submit_s: float = 0.0

    def is_actor_task(self) -> bool:
        return self.actor_id is not None

    def retries_left(self) -> int:
        return self.options.max_retries - self.attempt

    def should_retry(self, error: BaseException) -> bool:
        if self.retries_left() <= 0:
            return False
        re = self.options.retry_exceptions
        # System-level failures (worker/node death) always honor max_retries;
        # application exceptions only when retry_exceptions allows them
        # (reference: _raylet.pyx:1581-1601).
        from ray_tpu_torch.exceptions import NodeDiedError, WorkerCrashedError
        if isinstance(error, (WorkerCrashedError, NodeDiedError)):
            return True
        if re is True:
            return True
        if re is False or re is None:
            return False
        return isinstance(error, tuple(re))
