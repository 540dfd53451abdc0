"""Global worker: the public ``init/get/put/wait/kill/cancel`` surface.

Parity with ``python/ray/_private/worker.py`` (``ray.init`` :1003, ``ray.get``
:2162, ``ray.put`` :2276, ``ray.wait`` :2331, ``ray.shutdown`` :1529).

``init(address=...)`` joins a multi-process cluster (``distributed.py``);
``init(include_dashboard=True)`` starts the dashboard head over that
cluster's state service (``dashboard/head.py``), or, without ``address=``,
the driver's JSON state server (``_private/state_server.py``).
"""

from __future__ import annotations
import logging

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.ids import JobID, TaskID
from ray_tpu_torch._private.resources import (CPU, GPU, ResourceSet)
from ray_tpu_torch._private.runtime import Runtime, task_context
from ray_tpu_torch.object_ref import ObjectRef

logger = logging.getLogger("ray_tpu")

_global_lock = threading.Lock()
_global = None  # type: Optional["Worker"]
# Subsystems with background threads that outlive the runtime unless torn
# down with it (serve controller loop etc.) register a hook; shutdown()
# drains them first so no stray thread auto-reinitializes the worker
# between an explicit shutdown() and the next init().
_shutdown_hooks: list = []
# sentinel: no init(auth_token=...) has modified the env this session
_UNSET = object()
_displaced_auth_token = _UNSET


def register_shutdown_hook(fn) -> None:
    with _global_lock:
        if fn not in _shutdown_hooks:
            _shutdown_hooks.append(fn)


class Worker:
    def __init__(self, runtime: Runtime, namespace: str):
        self.runtime = runtime
        self.namespace = namespace
        self.driver_task_id = TaskID.for_task(runtime.job_id)


def _detect_num_gpus() -> int:
    """GPU autodetection from PyTorch — replaces the reference's
    nvidia-smi/GPUtil probing (``resource_spec.py:273-310``). Creates no
    CUDA context."""
    return torch.cuda.device_count()


def init(num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: Optional[str] = None,
         ignore_reinit_error: bool = False,
         include_dashboard: bool = False,
         dashboard_port: int = 0,
         address: Optional[str] = None,
         auth_token: Optional[str] = None,
         _system_config: Optional[dict] = None,
         _create_default_node: bool = True,
         **kwargs) -> "Worker":
    """Start the in-process runtime: one node with ``num_cpus`` CPUs and
    ``num_gpus`` GPUs (by default every CUDA device PyTorch sees; no ``GPU``
    key where there is none).

    ``address="host:port"`` connects this process as a driver to an
    existing cluster's state service (the reference's
    ``ray.init(address=...)`` path, ``worker.py:1003``): tasks and actors
    are then scheduled across the cluster's host daemons. The driver's own
    node contributes no resources unless ``num_cpus``/``num_gpus`` are
    passed explicitly.

    ``include_dashboard=True`` serves the dashboard on ``dashboard_port``
    (0 picks a free one; the bound port is ``Worker.dashboard_port``): with
    ``address=`` the dashboard head over the cluster's state service, which
    also hosts the autopilot when ``autopilot_enabled`` is on; without it
    the in-process runtime's JSON state server.
    """
    global _global
    with _global_lock:
        if _global is not None:
            if ignore_reinit_error:
                return _global
            raise RuntimeError("ray_tpu.init() called twice; pass "
                               "ignore_reinit_error=True to ignore")
        _config.apply_system_config(_system_config)
        # Always-on flight recorder (process-scoped: it records THIS
        # process, so it survives shutdown()/init() cycles and is sealed
        # by exit hooks or — after a hard kill — by a surviving sweeper).
        from ray_tpu_torch.observability import recorder as _flight
        try:
            _flight.install("driver")
        except Exception as e:
            logger.warning("flight recorder unavailable: %s", e)
        # Perf plane: the driver samples its own stacks too, so /api/profile
        # covers the submitting side of every workload.
        from ray_tpu_torch.observability import perf as _perf
        from ray_tpu_torch.observability import sampler as _stack_sampler
        if _perf.ENABLED:
            _stack_sampler.start()
        if auth_token:
            # Process-wide: every RPC connection (state client, daemon
            # peers) opens with this shared secret (rpc.default_auth_token).
            # Remember what we displaced so shutdown() can restore it —
            # a later init(address=other_cluster) must not inherit this
            # cluster's token.
            global _displaced_auth_token
            _displaced_auth_token = os.environ.get("RAY_TPU_AUTH_TOKEN")  # raylint: guarded-by(_global_lock)
            os.environ["RAY_TPU_AUTH_TOKEN"] = auth_token
        if address is not None:
            from ray_tpu_torch._private.distributed import DistributedRuntime
            amounts: Dict[str, float] = {}
            if num_cpus:
                amounts[CPU] = num_cpus
            if num_gpus:
                amounts[GPU] = num_gpus
            if resources:
                amounts.update(resources)
            runtime = DistributedRuntime(
                state_addr=address, resources=ResourceSet(amounts),
                is_driver=True, namespace=namespace or "default")
            worker = Worker(runtime, namespace or "default")
            if include_dashboard:
                from ray_tpu_torch.dashboard import start_dashboard
                try:
                    head = start_dashboard(address, port=dashboard_port)
                except BaseException:
                    # a failed dashboard must not leave a live runtime
                    # behind a half-initialized worker (retrying init()
                    # would then raise "called twice")
                    runtime.shutdown()
                    raise
                worker.dashboard_head = head
                worker.dashboard_port = head.port
            _global = worker  # raylint: allow(data-race) installed under _global_lock; unlocked peeks like is_initialized are GIL-atomic snapshots
            return _global
        runtime = Runtime()
        if _create_default_node:
            amounts: Dict[str, float] = {
                CPU: num_cpus if num_cpus is not None else float(os.cpu_count() or 1),
            }
            n_gpus = num_gpus if num_gpus is not None else _detect_num_gpus()
            if n_gpus:
                amounts[GPU] = n_gpus
            if resources:
                amounts.update(resources)
            runtime.add_node(ResourceSet(amounts))
        _global = Worker(runtime, namespace or "default")  # raylint: allow(data-race) installed under _global_lock; unlocked peeks like is_initialized are GIL-atomic snapshots
        if include_dashboard:
            from ray_tpu_torch._private.state_server import start_state_server
            # raylint: allow(data-race) dashboard_port set under _global_lock during init
            _global.dashboard_port = start_state_server(dashboard_port)
        return _global


def shutdown():
    global _global
    from ray_tpu_torch.observability import sampler as _stack_sampler
    _stack_sampler.stop()
    with _global_lock:
        hooks, _shutdown_hooks[:] = list(_shutdown_hooks), []
    for hook in hooks:
        try:
            hook()
        except Exception as e:
            logger.warning("shutdown hook failed: %s", e)
    with _global_lock:
        if _global is not None:
            head = getattr(_global, "dashboard_head", None)
            if head is not None:
                try:
                    head.stop()
                except Exception as e:
                    logger.debug("dashboard head stop failed: %s", e)
            elif getattr(_global, "dashboard_port", None) is not None:
                from ray_tpu_torch._private.state_server import stop_state_server
                stop_state_server()
            _global.runtime.shutdown()
            _global = None  # raylint: allow(data-race) cleared under _global_lock at shutdown; unlocked peeks are GIL-atomic snapshots
        global _displaced_auth_token
        if _displaced_auth_token is not _UNSET:
            if _displaced_auth_token is None:
                os.environ.pop("RAY_TPU_AUTH_TOKEN", None)
            else:
                os.environ["RAY_TPU_AUTH_TOKEN"] = _displaced_auth_token
            _displaced_auth_token = _UNSET


def is_initialized() -> bool:
    return _global is not None


def global_worker() -> Worker:
    if _global is None:
        init()
    return _global  # type: ignore[return-value]


def try_global_runtime() -> Optional[Runtime]:
    return _global.runtime if _global is not None else None


def current_task_id() -> TaskID:
    tid = task_context.task_id
    if tid is not None:
        return tid
    return global_worker().driver_task_id


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    w = global_worker()
    oid = w.runtime.put_object(value)
    return ObjectRef(oid, owner=w.runtime)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    w = global_worker()
    if isinstance(refs, ObjectRef):
        return w.runtime.get_object(refs.id(), timeout=timeout)
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects ObjectRef or list, got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list items must be ObjectRef, got {type(r)}")
    # Batch resolution: one shared deadline; distributed runtimes overlap
    # the refs that need the wire (remote fetches, in-flight pushed tasks)
    # instead of paying one serialized round trip per ref.
    return w.runtime.get_objects([r.id() for r in refs], timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """Parity with ``ray.wait`` (worker.py:2331): returns (ready, not_ready)
    preserving input order, blocking until ``num_returns`` ready or timeout."""
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    w = global_worker()
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        ready = [r for r in refs if w.runtime.object_ready(r.id())]
        if len(ready) >= num_returns or (
                deadline is not None and time.monotonic() >= deadline):
            # Return at most num_returns ready refs (ray.wait contract).
            ready_set = set(ready[:num_returns])
            ready_list = [r for r in refs if r in ready_set]
            not_ready = [r for r in refs if r not in ready_set]
            return ready_list, not_ready
        # Wake as soon as any still-pending ref seals locally (checked
        # under the seal condvar so nothing is lost); the 10ms cap covers
        # completions that seal in another process.
        pending = [r.id() for r in refs if r not in set(ready)]
        w.runtime._wait_for_seal(
            lambda: any(w.runtime._sealed_locally(o) for o in pending), 0.01)


def kill(actor, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle; use cancel() for tasks")
    global_worker().runtime.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    if not isinstance(ref, ObjectRef):
        raise TypeError("cancel() expects an ObjectRef")
    global_worker().runtime.cancel_task(ref.task_id(), force=force)


def get_actor(name: str, namespace: Optional[str] = None):
    from ray_tpu_torch.actor import ActorHandle
    w = global_worker()
    state = w.runtime.get_named_actor(name, namespace or w.namespace)
    return ActorHandle._from_state(state)


def available_resources() -> Dict[str, float]:
    w = global_worker()
    total: Dict[str, float] = {}
    for ns in w.runtime.node_states():
        if not ns.alive:
            continue
        for k, v in ns.resources.available.to_dict().items():
            total[k] = total.get(k, 0.0) + v
    return total


def cluster_resources() -> Dict[str, float]:
    w = global_worker()
    total: Dict[str, float] = {}
    for ns in w.runtime.node_states():
        if not ns.alive:
            continue
        for k, v in ns.resources.total.to_dict().items():
            total[k] = total.get(k, 0.0) + v
    return total


def nodes() -> List[dict]:
    w = global_worker()
    return [{
        "NodeID": ns.node_id.hex(),
        "Alive": ns.alive,
        "State": ("DRAINING" if getattr(ns, "draining", False)
                  else "ALIVE" if ns.alive else "DEAD"),
        "Resources": ns.resources.total.to_dict(),
        "Available": ns.resources.available.to_dict(),
    } for ns in w.runtime.node_states()]


def drain_node(node_id: str, reason: str = "",
               deadline_s: float = 0.0) -> None:
    """Gracefully drain a cluster node: flip it to DRAINING at the state
    service so the scheduler stops placing work there, then let the
    node's own drain orchestrator migrate its workload (in-flight tasks
    finish, actors checkpoint and restart elsewhere, sole-copy objects
    re-replicate) before it decommissions.

    ``node_id`` is the hex id reported by :func:`nodes`. ``deadline_s``
    is the migration budget; 0 uses the ``drain_deadline_s`` config.
    """
    w = global_worker()
    state = getattr(w.runtime, "state", None)
    if state is None:
        raise RuntimeError(
            "drain_node requires a distributed runtime "
            "(ray_tpu.init(address=...)); the in-process runtime has no "
            "node lifecycle")
    state.drain_node(bytes.fromhex(node_id), reason, deadline_s)


def timeline(filename: Optional[str] = None):
    """Chrome-tracing dump of task/actor spans (reference: ``ray timeline``
    CLI ``scripts.py:1755`` → ``GlobalState.chrome_tracing_dump``
    ``state.py:419``). On a cluster, spans from EVERY daemon process are
    merged (cross-process trace propagation)."""
    rt = try_global_runtime()
    cluster_fetch = getattr(rt, "cluster_timeline", None)
    if cluster_fetch is not None:
        import json as _json
        trace = cluster_fetch()
        if filename is None:
            return trace
        from ray_tpu_torch.checkpoint.manifest import atomic_write_bytes
        atomic_write_bytes(filename, _json.dumps(trace).encode())
        return filename
    from ray_tpu_torch._private.profiling import dump_timeline
    return dump_timeline(filename)


def set_profiling_enabled(enabled: bool) -> None:
    """Switch span recording on/off — cluster-wide when connected (the
    daemons' buffers feed ``timeline()``)."""
    rt = try_global_runtime()
    cluster_set = getattr(rt, "set_cluster_profiling", None)
    if cluster_set is not None:
        cluster_set(enabled)
        return
    _config.set("profiling_enabled", bool(enabled))


def set_tracing_enabled(enabled: bool) -> None:
    """Switch end-to-end trace-context propagation on/off — cluster-wide
    when connected (daemons adopt it via the timeline control RPC)."""
    from ray_tpu_torch import observability
    rt = try_global_runtime()
    cluster_set = getattr(rt, "set_cluster_tracing", None)
    if cluster_set is not None:
        cluster_set(enabled)
        return
    if enabled:
        observability.enable()
    else:
        observability.disable()


def register_named_function(name: str, fn=None):
    """Publish a function for cross-language callers (the C++ worker API
    submits by name with JSON args). Usable as a decorator::

        @ray_tpu.register_named_function("add")
        def add(a, b): return a + b
    """
    if fn is None:
        def deco(f):
            register_named_function(name, f)
            return f
        return deco
    runtime = global_worker().runtime
    reg = getattr(runtime, "register_named_function", None)
    if reg is None:
        raise RuntimeError("named functions need a cluster runtime "
                           "(init(address=...) or a daemon)")
    reg(name, fn)
    return fn


def register_named_actor_class(name: str, cls=None):
    """Publish an actor class for cross-language callers — the typed C++
    ``Actor("name").Remote(args...)`` surface (reference
    ``cpp/include/ray/api/actor_creator.h:1`` role, shaped for this
    runtime's contract: Python defines the class, any language drives
    it). Usable as a decorator::

        @ray_tpu.register_named_actor_class("Counter")
        class Counter: ...

    Under the hood three named functions carry the actor protocol over
    JSON: ``__actor_new__::<name>`` creates a NAMED actor from the
    registered class (the daemon executing the creation owns it; the
    name makes it reachable from every process), and the generic
    ``__actor_call__`` / ``__actor_kill__`` route method calls and
    termination through ``get_actor`` — the ordinary, fully-tested
    Python actor path."""
    if cls is None:
        def deco(c):
            register_named_actor_class(name, c)
            return c
        return deco

    import ray_tpu_torch as ray_tpu

    def _new(actor_name, *args):
        remote_cls = ray_tpu.remote(cls)
        remote_cls.options(name=actor_name).remote(*args)
        return actor_name

    def _call(actor_name, method, *args):
        h = ray_tpu.get_actor(actor_name)
        return ray_tpu.get(getattr(h, method).remote(*args))

    def _kill(actor_name):
        ray_tpu.kill(ray_tpu.get_actor(actor_name))
        return True

    register_named_function(f"__actor_new__::{name}", _new)
    register_named_function("__actor_call__", _call)
    register_named_function("__actor_kill__", _kill)
    return cls
