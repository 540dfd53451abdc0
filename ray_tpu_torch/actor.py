"""Actors: stateful remote workers.

Parity with ``python/ray/actor.py`` (``ActorClass`` :377, ``_remote`` :657,
``ActorHandle``, ``ActorMethod``; named/detached actors; ``max_restarts`` /
``max_task_retries``). As in the JAX package, actors holding device state run
as mailbox-ordered threads inside the runtime's process, so a CUDA tensor
held by an actor stays resident in device memory across method calls (no
host round-trip) — the design goal the reference could never offer for
accelerator state (its actors are separate processes).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.ids import ActorID, TaskID
from ray_tpu_torch._private.resources import ResourceSet, resources_from_options
from ray_tpu_torch._private.task_spec import TaskOptions, TaskSpec
from ray_tpu_torch.object_ref import ObjectRef


@dataclass
class ActorOptions(TaskOptions):
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    lifetime: Optional[str] = None  # None | "detached"
    namespace: Optional[str] = None
    get_if_exists: bool = False


def _build_actor_options(opts: Dict[str, Any]) -> ActorOptions:
    resources = resources_from_options(
        num_cpus=opts.get("num_cpus"),
        num_tpus=opts.get("num_tpus"),
        num_gpus=opts.get("num_gpus"),
        memory=opts.get("memory"),
        resources=opts.get("resources"),
        default_cpus=opts.get("num_cpus") if opts.get("num_cpus") is not None else 1.0,
    )
    return ActorOptions(
        resources=resources,
        max_retries=0,
        scheduling_strategy=opts.get("scheduling_strategy", "DEFAULT"),
        placement_group=opts.get("placement_group"),
        placement_group_bundle_index=opts.get("placement_group_bundle_index", -1),
        name=opts.get("name"),
        runtime_env=opts.get("runtime_env"),
        max_restarts=opts.get("max_restarts", 0),
        max_task_retries=opts.get("max_task_retries", 0),
        max_concurrency=opts.get("max_concurrency", 1),
        lifetime=opts.get("lifetime"),
        namespace=opts.get("namespace"),
        get_if_exists=opts.get("get_if_exists", False),
    )


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, **updates) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name,
                        updates.get("num_returns", self._num_returns))
        return m

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs, num_returns=self._num_returns)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name} cannot be called directly; "
            "use .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, cls_name: str):
        self._actor_id = actor_id
        self._cls_name = cls_name

    @classmethod
    def _from_state(cls, state) -> "ActorHandle":
        return cls(state.actor_id, state.cls.__name__)

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_") and not name.startswith("__ray"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _submit_method(self, method_name: str, args, kwargs,
                       num_returns: int = 1):
        from ray_tpu_torch._private import worker as _worker
        w = _worker.global_worker()
        runtime = w.runtime
        state = runtime.actors.get(self._actor_id)
        opts = TaskOptions(
            num_returns=num_returns,
            resources=ResourceSet(),
            max_retries=(state.options.max_task_retries if state else 0),
        )
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(runtime.job_id, self._actor_id),
            job_id=runtime.job_id,
            function=None,  # looked up on the instance
            function_name=f"{self._cls_name}.{method_name}",
            args=tuple(args),
            kwargs=dict(kwargs),
            options=opts,
            actor_id=self._actor_id,
            method_name=method_name,
        )
        return_ids = runtime.submit_actor_task(self._actor_id, spec)
        refs = [ObjectRef(rid, owner=runtime) for rid in return_ids]
        if num_returns == 1:
            return refs[0]
        return refs

    def ready(self):
        """Returns a ref that resolves when the actor finished __init__."""
        return self._submit_method("__ray_ready__", (), {})

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._cls_name))

    def __repr__(self):
        return f"ActorHandle({self._cls_name}, {self._actor_id.hex()[:8]})"


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = _inject_builtin_methods(cls)
        self._default_options = options or {}
        functools.update_wrapper(self, cls, updated=[])

    def options(self, **updates) -> "ActorClass":
        merged = dict(self._default_options)
        merged.update(updates)
        return ActorClass.__new__(ActorClass).__init_shim__(self._cls, merged)

    def __init_shim__(self, cls, options):
        self._cls = cls
        self._default_options = options
        return self

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated "
            "directly; use .remote()")

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self, args, kwargs)

    def _remote(self, args, kwargs, opts: Dict[str, Any]) -> ActorHandle:
        from ray_tpu_torch._private import worker as _worker
        from ray_tpu_torch._private.runtime import ActorState
        w = _worker.global_worker()
        options = _build_actor_options(opts)
        namespace = options.namespace or w.namespace
        if options.name and options.get_if_exists:
            try:
                state = w.runtime.get_named_actor(options.name, namespace)
                return ActorHandle._from_state(state)
            except ValueError:
                pass
        actor_id = ActorID.of(w.runtime.job_id)
        state = ActorState(actor_id, self._cls, tuple(args), dict(kwargs),
                           options, options.name, namespace)
        w.runtime.create_actor(state)
        return ActorHandle(actor_id, self._cls.__name__)


def _inject_builtin_methods(cls: type) -> type:
    if not hasattr(cls, "__ray_ready__"):
        cls.__ray_ready__ = lambda self: True
    if not hasattr(cls, "__ray_collective_init__"):
        def _collective_init(self, world_size, rank, backend, group_name,
                             devices=None, config=None):
            from ray_tpu_torch.collective import init_collective_group
            init_collective_group(world_size, rank, backend, group_name,
                                  devices, config)
            return rank
        cls.__ray_collective_init__ = _collective_init
    if not hasattr(cls, "__ray_terminate__"):
        def _terminate(self):
            from ray_tpu_torch._private import worker as _worker
            from ray_tpu_torch._private.runtime import task_context
            rt = _worker.global_worker().runtime
            aid = task_context.actor_id
            if aid is not None:
                rt.offload(lambda: rt.kill_actor(aid, no_restart=True))
            return None
        cls.__ray_terminate__ = _terminate
    return cls
