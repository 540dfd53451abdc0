"""``@ray_tpu.remote`` task wrapper.

Parity with ``python/ray/remote_function.py`` (``RemoteFunction._remote``
:231, ``.options()`` :214-228) and the decorator in ``worker.py:2747``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.resources import resources_from_options
from ray_tpu_torch._private.task_spec import TaskOptions, TaskSpec
from ray_tpu_torch.object_ref import ObjectRef


class RemoteFunction:
    def __init__(self, function: Callable, options: Optional[Dict[str, Any]] = None):
        self._function = function
        self._default_options = options or {}
        functools.update_wrapper(self, function)

    def options(self, **updates) -> "RemoteFunction":
        merged = dict(self._default_options)
        merged.update(updates)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function.__name__} cannot be called "
            "directly; use .remote()")

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node (reference: remote_function.py:219-226)."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def _remote(self, args, kwargs, opts: Dict[str, Any]):
        from ray_tpu_torch._private import worker as _worker
        w = _worker.global_worker()
        task_opts = _build_task_options(opts)
        spec = TaskSpec(
            task_id=TaskID.for_task(w.runtime.job_id),
            job_id=w.runtime.job_id,
            function=self._function,
            function_name=opts.get("name") or self._function.__qualname__,
            args=tuple(args),
            kwargs=dict(kwargs),
            options=task_opts,
        )
        return_ids = w.runtime.submit_task(spec)
        refs = [ObjectRef(rid, owner=w.runtime) for rid in return_ids]
        if task_opts.num_returns == 1:
            return refs[0]
        if task_opts.num_returns == 0:
            return None
        return refs


def _build_task_options(opts: Dict[str, Any]) -> TaskOptions:
    resources = resources_from_options(
        num_cpus=opts.get("num_cpus"),
        num_tpus=opts.get("num_tpus"),
        num_gpus=opts.get("num_gpus"),
        memory=opts.get("memory"),
        resources=opts.get("resources"),
        default_cpus=1.0,
    )
    pg = opts.get("placement_group")
    scheduling_strategy = opts.get("scheduling_strategy", "DEFAULT")
    return TaskOptions(
        num_returns=opts.get("num_returns", 1),
        resources=resources,
        max_retries=opts.get("max_retries", 3),
        retry_exceptions=opts.get("retry_exceptions", False),
        scheduling_strategy=scheduling_strategy,
        placement_group=pg,
        placement_group_bundle_index=opts.get(
            "placement_group_bundle_index", -1),
        name=opts.get("name"),
        runtime_env=opts.get("runtime_env"),
    )


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_tpus=...)`` decorator for
    functions and classes (reference ``worker.py:2747``)."""
    from ray_tpu_torch.actor import ActorClass

    def _make(target, options):
        if isinstance(target, type):
            return ActorClass(target, options)
        if callable(target):
            return RemoteFunction(target, options)
        raise TypeError(f"@remote target must be function or class, got {target}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return _make(args[0], {})
    if args:
        raise TypeError("@remote options must be keyword arguments")

    def decorator(target):
        return _make(target, dict(kwargs))

    return decorator
