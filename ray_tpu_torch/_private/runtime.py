"""The host-granular distributed runtime.

This is the redesign of the reference's L2 "kernel"
(GCS ``src/ray/gcs/gcs_server/gcs_server.h:70`` + raylet
``src/ray/raylet/node_manager.h`` + core_worker
``src/ray/core_worker/core_worker.h:63``) that the JAX package built around
one device-owner process per host, ported to GPUs. Instead of
process-per-worker with a shared-memory arena between processes, the unit of
distribution is the *host runtime*: tasks and actors execute as
concurrency-scheduled threads inside one process that holds one CUDA context
(PyTorch releases the GIL while it launches and waits on kernels, so threads
scale), and device values stay resident as ``torch.Tensor`` descriptors in
the object store. A ``num_gpus`` grant names ``torch.device``s; threads of
one process cannot each get their own ``CUDA_VISIBLE_DEVICES``, which is
process-wide.

What maps where:

- ``Runtime``   = GCS: node/actor/job/PG tables, internal KV, named actors,
                  object directory, heartbeat-style failure propagation.
- ``Node``      = raylet + plasma: resource accounting, admission (leases),
                  a worker pool (thread executor), a local object store.
- ``TaskManager`` = core_worker's TaskManager + ObjectRecoveryManager:
                  retries (``task_manager.h:152``) and lineage-based object
                  reconstruction (``object_recovery_manager.h:90``).
- ``ActorState``  = GcsActorManager entry + the actor's scheduling queue
                  (ordered mailbox; ``transport/actor_scheduling_queue.cc``),
                  with restart-up-to-``max_restarts``
                  (``gcs_actor_manager.h:66,433``).

Multi-host: one ``Runtime`` peer per host daemon behind a state service
(``distributed.DistributedRuntime``, ``init(address=...)``). In-process,
``cluster_utils.Cluster`` instantiates many ``Node``s under one ``Runtime``
for multi-node tests, like the reference's
``python/ray/cluster_utils.py:99``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch import chaos, observability
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.observability import perf
from ray_tpu_torch.observability import recorder as _flight
from ray_tpu_torch._private.backoff import BackoffPolicy
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID,
                                  PlacementGroupID, TaskID)
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch._private.reference_counter import ReferenceCounter
from ray_tpu_torch._private.resources import (CPU, GPU, NodeResources, ResourceSet)
from ray_tpu_torch._private.scheduler import (HybridPolicy, Infeasible, NodeState,
                                        SpreadPolicy, schedule_bundles)
from ray_tpu_torch._private.task_spec import TaskSpec

logger = logging.getLogger("ray_tpu")

_MAX_NODE_THREADS = 256


class _TaskContext(threading.local):
    def __init__(self):
        self.node_id: Optional[NodeID] = None
        self.task_id: Optional[TaskID] = None
        self.actor_id: Optional[ActorID] = None
        self.job_id: Optional[JobID] = None
        self.devices: Optional[list] = None
        self.placement_group: Any = None
        self.put_counter: int = 0
        self.cancel_flag: Optional[threading.Event] = None
        self.trace_id: str = ""   # current trace (propagates to children)
        self.span_id: str = ""    # current span (children's parent)


task_context = _TaskContext()

# Trace context for ASYNC actor methods: coroutines interleave on one
# loop thread, so a thread-local would be clobbered at every await —
# a ContextVar is copied per asyncio task instead. _attach_trace prefers
# it; sync paths (dedicated threads) keep using task_context.
import contextvars  # noqa: E402

_trace_var: "contextvars.ContextVar" = contextvars.ContextVar(
    "ray_tpu_trace", default=None)  # (trace_id, span_id) | None


def _obs_context_provider():
    """Expose the executing task's trace context to the observability
    layer, so a span opened anywhere inside a task body (object fetch,
    checkpoint write, user span) parents under the task's span without
    importing runtime state from observability (that import would be a
    cycle)."""
    async_ctx = _trace_var.get()
    if async_ctx:
        return async_ctx
    ctx = task_context
    if ctx.trace_id:
        return (ctx.trace_id, ctx.span_id or "")
    return None


observability.register_context_provider(_obs_context_provider)


class Node:
    """One (possibly virtual) host: resources + object store + worker pool."""

    def __init__(self, runtime: "Runtime", resources: ResourceSet,
                 node_id: Optional[NodeID] = None, labels: Optional[dict] = None):
        self.runtime = runtime
        self.node_id = node_id or NodeID.from_random()
        self.resources = NodeResources(resources)
        self.store = ObjectStore(self.node_id)
        self.labels = labels or {}
        self.alive = True
        self.draining = False  # lifecycle: still alive, shun new placement
        # Autoscaler hazard hint: likely to drain soon, last-choice
        # placement (see scheduler.NodeState.pending_drain).
        self.pending_drain = False
        self._pool = ThreadPoolExecutor(
            max_workers=_MAX_NODE_THREADS,
            thread_name_prefix=f"node-{self.node_id.hex()[:6]}")
        # Bundle carve-outs: (pg_id, bundle_index) -> NodeResources
        self.bundles: Dict[Tuple[PlacementGroupID, int], NodeResources] = {}

    def submit(self, fn: Callable, *args) -> None:
        self._pool.submit(fn, *args)

    def state(self) -> NodeState:
        return NodeState(self.node_id, self.resources, self.alive,
                         draining=self.draining,
                         pending_drain=self.pending_drain)

    def kill(self):
        """Simulate host failure: objects lost, resources gone (chaos tests)."""
        self.alive = False

    def shutdown(self):
        self.alive = False
        self._pool.shutdown(wait=False, cancel_futures=True)


def _live_instance(state: "ActorState"):
    """The actor's instance, or ``ActorDiedError`` for a call that was
    dequeued before the actor was killed (death drops the instance)."""
    instance = state.instance
    if instance is None:
        raise exc.ActorDiedError(str(state.death_cause or "actor is dead"))
    return instance


class ActorState:
    RESTARTING = "RESTARTING"
    ALIVE = "ALIVE"
    DEAD = "DEAD"
    PENDING = "PENDING"

    def __init__(self, actor_id: ActorID, cls, args, kwargs, options,
                 name: Optional[str], namespace: str):
        self.actor_id = actor_id
        self.cls = cls
        self.args = args
        self.kwargs = kwargs
        self.options = options
        self.name = name
        self.namespace = namespace
        self.node_id: Optional[NodeID] = None
        self.instance: Any = None
        self.status = self.PENDING
        self.restart_count = 0
        self.mailbox: "queue.Queue" = queue.Queue()
        self.seq = 0
        self.lock = threading.RLock()
        self.ready = threading.Event()
        self.death_cause: Optional[BaseException] = None
        self.threads: List[threading.Thread] = []
        self.is_async = False
        self.loop = None  # asyncio loop for async actors
        self.devices: Optional[list] = None


class PlacementGroupState:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[ResourceSet],
                 strategy: str, name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.bundle_nodes: Optional[List[NodeID]] = None
        self.ready = threading.Event()
        self.state = "PENDING"


class KVStore:
    """Internal KV with namespaces (GcsKvManager parity,
    ``python/ray/_private/gcs_utils.py:264-341``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[bytes, Dict[bytes, bytes]] = {}

    @staticmethod
    def _ns(namespace: Optional[bytes]) -> bytes:
        return namespace or b""

    def put(self, key: bytes, value: bytes, overwrite: bool = True,
            namespace: Optional[bytes] = None) -> bool:
        with self._lock:
            ns = self._data.setdefault(self._ns(namespace), {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def get(self, key: bytes, namespace: Optional[bytes] = None) -> Optional[bytes]:
        with self._lock:
            return self._data.get(self._ns(namespace), {}).get(key)

    def delete(self, key: bytes, namespace: Optional[bytes] = None) -> bool:
        with self._lock:
            return self._data.get(self._ns(namespace), {}).pop(key, None) is not None

    def keys(self, prefix: bytes = b"", namespace: Optional[bytes] = None) -> List[bytes]:
        with self._lock:
            return [k for k in self._data.get(self._ns(namespace), {})
                    if k.startswith(prefix)]


class Runtime:
    """Cluster state service + task manager for this driver process."""

    def __init__(self, job_id: Optional[JobID] = None):
        self.job_id = job_id or JobID.from_random()
        self.nodes: Dict[NodeID, Node] = {}
        self._node_order: List[NodeID] = []  # raylint: guarded-by(self.lock)
        self.kv = KVStore()
        from ray_tpu_torch._private.ids import _Counter
        self._put_counter = _Counter()
        self.reference_counter = ReferenceCounter(self._on_ref_zero)
        self.lock = threading.RLock()
        self.head_node: Optional[Node] = None

        # object directory: ObjectID -> NodeID (owner store)
        self.object_locations: Dict[ObjectID, NodeID] = {}  # raylint: guarded-by(self.lock)
        # Seal notifications: get()/wait() block here instead of polling;
        # every seal_return/seal_error wakes the waiters (the reference's
        # plasma object-ready notification path).
        self._seal_cv = threading.Condition()
        # lineage: ObjectID -> TaskSpec that produces it
        self.lineage: Dict[ObjectID, TaskSpec] = {}  # raylint: guarded-by(self.lock)
        self.task_states: Dict[TaskID, str] = {}  # raylint: guarded-by(self.lock)
        self.cancel_flags: Dict[TaskID, threading.Event] = {}  # raylint: guarded-by(self.lock)

        self.actors: Dict[ActorID, ActorState] = {}  # raylint: guarded-by(self.lock)
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # raylint: guarded-by(self.lock)
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupState] = {}  # raylint: guarded-by(self.lock)

        self.hybrid_policy = HybridPolicy()
        self.spread_policy = SpreadPolicy()

        # Shared retry pacing (see _private/backoff.py): task retries and
        # actor restarts take a jittered exponential delay from these
        # instead of a fixed task_retry_delay_ms sleep.
        self._retry_backoff = BackoffPolicy(
            base_s=_config.get("task_retry_delay_ms") / 1e3,
            max_s=_config.get("task_retry_max_delay_ms") / 1e3,
            deadline_s=0)

        # Pending queue of tasks waiting for resources / dependencies.
        self._pending: List[dict] = []  # raylint: guarded-by(self._pending_cv)
        # items the dispatcher is CURRENTLY iterating (it swaps _pending
        # to a local list per pass); admission depth checks must count
        # both, or the cap is porous exactly when the backlog is deepest
        self._dispatch_pass_n = 0
        self._pending_cv = threading.Condition()
        self._dispatch_mutex = threading.Lock()  # single-dispatcher guard
        self._inline_dispatch = bool(_config.get("inline_dispatch"))
        self._dispatch_dirty = False  # kick arrived while loop was busy
        # Per-task completion hooks, fired once when a task reaches a final
        # state (FINISHED/FAILED/CANCELLED, not retries). The host daemon
        # uses these to turn local completions into RPC replies; a task can
        # carry several hooks when a caller re-pushed an attempt it already
        # admitted (duplicate pushes attach instead of re-executing).
        self.completion_hooks: Dict[TaskID, List[Callable[[TaskSpec], None]]] = {}  # raylint: guarded-by(self.lock)
        # Infeasible requests get this long for the cluster view to change
        # (a node joining) before the error is sealed. 0 = fail fast; the
        # distributed runtime raises it because its view is refreshed
        # asynchronously and may trail reality by a refresh interval.
        self._infeasible_grace_s = 0.0
        self.autoscaling_enabled = False  # set by StandardAutoscaler
        self._events: List[dict] = []  # structured event log
        self._event_file = None
        self._event_file_lock = threading.Lock()
        self._shutdown = False
        self._util_pool = ThreadPoolExecutor(max_workers=32,
                                             thread_name_prefix="rt-util")
        try:
            self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                name="rt-dispatcher",
                                                daemon=True)
            self._dispatcher.start()
        except Exception:
            # thread-limit failures must not strand the utility pool
            self._util_pool.shutdown(wait=False)
            raise

    # ------------------------------------------------------------------ nodes

    def add_node(self, resources: ResourceSet, labels: Optional[dict] = None) -> Node:
        node = Node(self, resources, labels=labels)
        with self.lock:
            self.nodes[node.node_id] = node  # raylint: allow(data-race) _sealed_locally deliberately probes nodes lock-free inside wait predicates; nodes are add-only
            self._node_order.append(node.node_id)
            if self.head_node is None:
                self.head_node = node  # raylint: allow(data-race) set once when the first node joins, before any task can be submitted
        self._kick()
        return node

    def remove_node(self, node_id: NodeID):
        """Node death: lose its objects, fail its actors, trigger recovery."""
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None:
                return
            node.kill()
            dead_actors = [a for a in self.actors.values()
                           if a.node_id == node_id and a.status != ActorState.DEAD]
            lost_objects = [oid for oid, nid in self.object_locations.items()
                            if nid == node_id]
        for a in dead_actors:
            self._handle_actor_failure(a, exc.NodeDiedError(
                f"node {node_id.hex()[:8]} died"))
        for oid in lost_objects:
            with self.lock:
                self.object_locations.pop(oid, None)
        self.emit_event("NODE_DEAD", node_id=node_id.hex())
        self._kick()

    def node_states(self) -> List[NodeState]:
        with self.lock:
            return [self.nodes[nid].state() for nid in self._node_order]

    def set_pending_drain(self, node_id_hex: str, flag: bool) -> None:
        """Autoscaler hazard hint: mark a node last-choice for placement
        (it stays fully schedulable — see NodeState.pending_drain)."""
        from ray_tpu_torch._private.ids import NodeID
        with self.lock:
            node = self.nodes.get(NodeID(bytes.fromhex(node_id_hex)))
        if node is not None and node.pending_drain != flag:
            node.pending_drain = flag
            self._kick()

    # ---------------------------------------------------------------- objects

    def put_object(self, value: Any, owner_node: Optional[Node] = None) -> ObjectID:
        node = owner_node or self._current_or_head_node()
        from ray_tpu_torch._private.worker import current_task_id
        tid = current_task_id()
        # Runtime-global counter: driver threads share the driver TaskID, so a
        # per-task counter would collide across threads.
        oid = ObjectID.for_put(tid, self._put_counter.next())
        node.store.put(oid, value)
        with self.lock:
            self.object_locations[oid] = node.node_id
        return oid

    def seal_return(self, oid: ObjectID, value: Any, node: Node):
        node.store.put(oid, value)
        with self.lock:
            self.object_locations[oid] = node.node_id
        self._notify_sealed()

    def seal_error(self, oid: ObjectID, error: BaseException, node: Node):
        node.store.put_error(oid, error)
        with self.lock:
            self.object_locations[oid] = node.node_id
        self._notify_sealed()

    def _notify_sealed(self):
        with self._seal_cv:
            self._seal_cv.notify_all()

    def _wait_for_seal(self, ready_pred, max_wait_s: float):
        """Block until ``ready_pred()`` or ``max_wait_s`` elapsed; wakes on
        seal notifications. The predicate is evaluated under the condvar
        (sealers notify under it too) so a seal landing between the
        caller's check and the wait is never lost, and unrelated seals
        don't end the wait early (the loop re-waits until the deadline).
        Predicates must be CHEAP and must NOT take self.lock (they run
        with the seal lock held; seal paths hold self.lock while
        notifying) — check stores directly."""
        deadline = time.monotonic() + max_wait_s
        with self._seal_cv:
            while not ready_pred():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._seal_cv.wait(remaining)

    def _sealed_locally(self, oid: ObjectID) -> bool:
        """Lock-free-ish readiness probe safe inside _wait_for_seal
        predicates: store containment only, no runtime lock, no RPCs."""
        for node in list(self.nodes.values()):
            if node.alive and node.store.contains(oid):
                return True
        return False

    def get_object(self, oid: ObjectID, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            read_failed = False  # located copy was unreadable this pass
            node = self._locate(oid)
            if node is not None:
                try:
                    remaining = None if deadline is None else max(
                        0.0, deadline - time.monotonic())
                    return node.store.get(oid, timeout=remaining)
                except exc.RayTpuError:
                    raise
                except TimeoutError:
                    raise exc.GetTimeoutError(f"get({oid}) timed out")
                except Exception as e:
                    from ray_tpu_torch._private.object_store import ObjectLostError
                    if not isinstance(e, ObjectLostError):
                        raise
                    read_failed = True
            # No live copy. Producing task may still be in flight (just wait),
            # or it finished and the copy was lost (reconstruct from lineage).
            with self.lock:
                spec = self.lineage.get(oid)
                state = (self.task_states.get(spec.task_id)
                         if spec is not None else None)
            if spec is None:
                raise exc.ObjectLostError(
                    f"object {oid} is lost and has no lineage to reconstruct")
            if state in ("FINISHED", "FAILED", None):
                if not read_failed and self._locate(oid) is not None:
                    continue  # sealed between the locate above and here
                # The value (or error) existed and was lost with its node.
                if not self._try_reconstruct(oid):
                    raise exc.ObjectLostError(
                        f"object {oid} is lost and could not be reconstructed")
            if deadline is not None and time.monotonic() > deadline:
                raise exc.GetTimeoutError(f"get({oid}) timed out")
            self._wait_for_seal(lambda: self._sealed_locally(oid), 0.05)

    # Overlapping blocking gets only pays off when resolution can involve
    # the wire (remote fetches / pushed-task waits); the in-process runtime
    # resolves everything off local seal events, where extra waiter threads
    # are pure condvar-wakeup overhead.
    _concurrent_get = False

    def get_objects(self, oids: Sequence[ObjectID],
                    timeout: Optional[float] = None) -> list:
        """Batch get preserving input order under ONE shared deadline.
        Locally-sealed ids take the plain sequential read; on runtimes
        flagged ``_concurrent_get`` the rest resolve concurrently, so N
        remote pulls (striped fetches, distinct owners) overlap instead of
        serializing N round trips. Errors surface in input order, exactly
        as the sequential loop would raise them."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def _remaining():
            return (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))

        values: Dict[ObjectID, Any] = {}
        errors: Dict[ObjectID, BaseException] = {}
        if self._concurrent_get:
            slow = [o for o in dict.fromkeys(oids)
                    if not self._sealed_locally(o)]
            if len(slow) > 1:
                with ThreadPoolExecutor(
                        max_workers=min(8, len(slow)),
                        thread_name_prefix="obj-get") as pool:
                    futs = [(o, pool.submit(self.get_object, o, _remaining()))
                            for o in slow]
                    for o, f in futs:
                        try:
                            # each worker runs get_object(_remaining()):
                            # the shared deadline is enforced inside the
                            # call, so this result() is bounded by it
                            # raylint: allow(deadline-drop) bounded in callee
                            values[o] = f.result()
                        except BaseException as e:  # noqa: BLE001 — replayed
                            errors[o] = e           # in input order below
        out = []
        for o in oids:
            if o in errors:
                raise errors[o]
            if o not in values:
                values[o] = self.get_object(o, timeout=_remaining())
            out.append(values[o])
        return out

    def object_ready(self, oid: ObjectID) -> bool:
        node = self._locate(oid)
        return node is not None and node.store.contains(oid)

    def _locate(self, oid: ObjectID) -> Optional[Node]:
        with self.lock:
            nid = self.object_locations.get(oid)
            if nid is None:
                return None
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                return None
            return node

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Lineage reconstruction (ObjectRecoveryManager::RecoverObject)."""
        with self.lock:
            spec = self.lineage.get(oid)
            if spec is None:
                return False
            state = self.task_states.get(spec.task_id)
            if state == "RESUBMITTED":
                return True
            if spec.retries_left() <= 0 and state != "PENDING":
                return False
            self.task_states[spec.task_id] = "RESUBMITTED"
            spec.attempt += 1
        self.emit_event("OBJECT_RECONSTRUCT", object_id=oid.hex(),
                        task=spec.function_name)
        # Elastic recovery: a hard node-affinity to a dead node would make the
        # lineage permanently unrecoverable; degrade to soft affinity.
        from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
        strat = spec.options.scheduling_strategy
        if isinstance(strat, NodeAffinitySchedulingStrategy) and not strat.soft:
            with self.lock:
                target_alive = any(
                    n.node_id.hex() == strat.node_id and n.alive
                    for n in (self.nodes[nid] for nid in self._node_order))
            if not target_alive:
                spec.options.scheduling_strategy = NodeAffinitySchedulingStrategy(
                    node_id=strat.node_id, soft=True)
        if spec.is_actor_task():
            self.submit_actor_task(spec.actor_id, spec)
        else:
            self.submit_task(spec)
        return True

    def _on_ref_zero(self, oid: ObjectID):
        node = self._locate(oid)
        if node is not None:
            node.store.free(oid)
        with self.lock:
            self.object_locations.pop(oid, None)
            self.lineage.pop(oid, None)

    # ------------------------------------------------------------------ tasks

    def _attach_trace(self, spec: TaskSpec):
        """Propagate the submitting span's trace context into the spec
        (tracing_helper.py:160-175 role): children inherit the trace id
        with the current span as parent; a root submission mints a fresh
        trace id when profiling is on (tracing is free when it's off)."""
        if spec.trace_id:
            return  # retries keep their original identity
        async_ctx = _trace_var.get()
        ctx = task_context
        if async_ctx:
            spec.trace_id, spec.parent_span_id = async_ctx
        elif ctx.trace_id:
            spec.trace_id = ctx.trace_id
            spec.parent_span_id = ctx.span_id
        else:
            obs_ctx = (observability.current()
                       if observability.ENABLED else None)
            if obs_ctx:  # explicit span (serve request, user span(...))
                spec.trace_id, spec.parent_span_id = obs_ctx
            elif _prof().enabled:
                spec.trace_id = os.urandom(8).hex()

    def submit_task(self, spec: TaskSpec) -> List[ObjectID]:
        self._attach_trace(spec)
        if perf.ENABLED and not spec.perf_submit_s:
            spec.perf_submit_s = time.time()
        if not spec.return_ids:
            spec.return_ids = tuple(
                ObjectID.for_return(spec.task_id, i)
                for i in range(spec.options.num_returns))
        with self.lock:
            for rid in spec.return_ids:
                self.lineage[rid] = spec
            self.task_states[spec.task_id] = "PENDING"
            cancel = self.cancel_flags.setdefault(spec.task_id, threading.Event())  # raylint: guarded-by(self.lock)
        # Pin argument objects for the duration of the task.
        refs = _ref_ids_in(spec.args, spec.kwargs)
        for oid in refs:
            self.reference_counter.pin_for_task(oid)
        item = {"spec": spec, "cancel": cancel}
        # Inline fast path: a ref-free task whose dispatch decision is
        # immediate skips the queue + dispatcher-thread hop (two context
        # switches per task — the dominant per-task cost at high rates on
        # busy hosts). The dispatch mutex preserves the single-dispatcher
        # invariant (allocation math is not self-synchronized); tasks
        # with ref deps keep the queue path so dependency probes never
        # run on the submitter's thread.
        if not refs and self._inline_dispatch and self._dispatch_now(item):
            return list(spec.return_ids)
        with self._pending_cv:
            self._pending.append(item)
            self._pending_cv.notify_all()
        return list(spec.return_ids)

    def _dispatch_now(self, item: dict) -> bool:
        # A free mutex is NOT enough: a non-empty backlog means older
        # tasks are parked awaiting capacity, and inlining a newcomer
        # would let it jump the queue (and under a sustained stream,
        # starve the backlog).
        with self._pending_cv:
            if self._pending or self._dispatch_pass_n:
                return False
        if not self._dispatch_mutex.acquire(blocking=False):
            return False  # dispatcher mid-pass: just queue
        try:
            action = self._try_dispatch(item)
            self._flush_dispatch_batches()  # inline path has no pass end
        except Exception:  # raylint: allow(swallow) Infeasible & friends: the queue path re-runs the policy
            return False   # error handling — re-run it there
        finally:
            self._dispatch_mutex.release()
        return action == "done"

    def cancel_task(self, task_id: TaskID, force: bool = False):
        with self.lock:
            flag = self.cancel_flags.get(task_id)
            state = self.task_states.get(task_id)
        if flag is not None:
            flag.set()
        self._kick()

    # The dispatcher: dependency resolution + scheduling + admission.
    def _dispatch_loop(self):
        while not self._shutdown:
            with self._pending_cv:
                if not self._pending:
                    self._pending_cv.wait(timeout=0.05)
                pending, self._pending = self._pending, []
                self._dispatch_pass_n = len(pending)  # raylint: guarded-by(self._pending_cv)
            still_waiting = []
            for item in pending:
                try:
                    with self._dispatch_mutex:
                        action = self._try_dispatch(item)
                except Infeasible as e:
                    if self.autoscaling_enabled:
                        # The cluster can grow: keep infeasible tasks
                        # queued as autoscaler demand (reference: pending
                        # infeasible tasks feed resource_demand_scheduler).
                        still_waiting.append(item)
                        continue
                    if self._infeasible_grace_s > 0:
                        since = item.setdefault("infeasible_since",
                                                time.monotonic())
                        if time.monotonic() - since < self._infeasible_grace_s:
                            still_waiting.append(item)
                            continue
                    spec = item["spec"]
                    err_cls = (exc.PlacementGroupSchedulingError
                               if spec.options.placement_group is not None
                               else exc.RayTpuError)
                    for rid in spec.return_ids:
                        self.seal_error(rid, err_cls(str(e)), self.head_node)
                    self._unpin_args(spec)
                    with self.lock:
                        self.task_states[spec.task_id] = "FAILED"
                    self._fire_completion(spec)
                    continue
                except Exception as e:  # defensive: never kill the dispatcher
                    spec = item["spec"]
                    logger.exception("dispatch error for %s", spec.function_name)
                    for rid in spec.return_ids:
                        self.seal_error(rid, exc.RayTpuError(
                            f"scheduling failed: {e}"), self.head_node)
                    self._unpin_args(spec)
                    with self.lock:
                        self.task_states[spec.task_id] = "FAILED"
                    self._fire_completion(spec)
                    continue
                if action == "wait":
                    still_waiting.append(item)
            # An idle dispatcher must not keep the pass's last task spec,
            # and with it the task's arguments, until the next submit.
            item = pending = None
            # Batched remote pushes accumulate during the pass; ship them
            # as one frame per daemon (no-op for the in-process runtime).
            try:
                self._flush_dispatch_batches()
            except Exception:  # defensive: never kill the dispatcher
                logger.exception("dispatch batch flush failed")
            if still_waiting:
                with self._pending_cv:
                    self._pending.extend(still_waiting)
                    self._dispatch_pass_n = 0
                    # Event-driven backoff: a seal/submit kick wakes the
                    # loop immediately instead of paying a fixed sleep per
                    # dependency-chain hop; the dirty flag covers kicks
                    # that raced with this pass (lost-wakeup).
                    if not self._dispatch_dirty:
                        self._pending_cv.wait(timeout=0.02)
                    self._dispatch_dirty = False
            else:
                with self._pending_cv:
                    self._dispatch_pass_n = 0

    def _flush_dispatch_batches(self):
        """Hook: distributed runtimes flush per-daemon push batches."""

    def _kick(self):
        with self._pending_cv:
            self._dispatch_dirty = True
            self._pending_cv.notify_all()

    def _deps_ready(self, spec: TaskSpec) -> bool:
        for oid in _ref_ids_in(spec.args, spec.kwargs):
            if not self.object_ready(oid):
                node = self._locate(oid)
                if node is None:
                    # Reconstruct ONLY if the producing task already ran
                    # (value existed and was lost with its node). While the
                    # producer is merely pending/running, resubmitting it
                    # here would duplicate it on every dispatcher pass — a
                    # task storm that grows combinatorially on dependency
                    # chains.
                    with self.lock:
                        known = oid in self.object_locations
                        dep_spec = self.lineage.get(oid)
                        state = (self.task_states.get(dep_spec.task_id)
                                 if dep_spec is not None else None)
                    if (not known and dep_spec is not None
                            and state in ("FINISHED", "FAILED")):
                        self._try_reconstruct(oid)
                return False
        return True

    def _try_dispatch(self, item: dict) -> str:
        spec: TaskSpec = item["spec"]
        cancel: threading.Event = item["cancel"]
        if cancel.is_set():
            for rid in spec.return_ids:
                self.seal_error(rid, exc.TaskCancelledError(spec.task_id),
                                self.head_node)
            self._unpin_args(spec)
            with self.lock:
                self.task_states[spec.task_id] = "CANCELLED"
            self._fire_completion(spec)
            return "done"
        if not self._deps_ready(spec):
            return "wait"
        # Check a dep didn't resolve to an error (error propagation).
        err = self._first_dep_error(spec)
        if err is not None:
            for rid in spec.return_ids:
                self.seal_error(rid, err, self.head_node)
            self._unpin_args(spec)
            with self.lock:
                self.task_states[spec.task_id] = "FAILED"
            self._fire_completion(spec)
            return "done"
        node_id = self._select_node(spec)
        if node_id is None:
            return "wait"
        node = self.nodes[node_id]
        request = self._effective_request(spec)
        alloc_target = self._allocation_target(spec, node)
        if not alloc_target.can_fit(request):
            return "wait"
        alloc_target.allocate(request)
        with self.lock:
            self.task_states[spec.task_id] = "RUNNING"
        node.submit(self._execute_task, spec, node, request, alloc_target, cancel)
        return "done"

    def _first_dep_error(self, spec: TaskSpec) -> Optional[BaseException]:
        for oid in _ref_ids_in(spec.args, spec.kwargs):
            node = self._locate(oid)
            if node is None:
                continue
            err = node.store.peek_error(oid)
            if isinstance(err, (exc.TaskError, exc.TaskCancelledError,
                                exc.ActorDiedError)):
                return err
        return None

    def _effective_request(self, spec: TaskSpec) -> ResourceSet:
        return spec.options.resources

    def _allocation_target(self, spec: TaskSpec, node: Node):
        pg = spec.options.placement_group
        if pg is not None:
            # NOTE: resolved via node.bundles only — an executing daemon
            # holds the reserved bundles but NOT the creator's
            # placement_groups table, and release paths must work there.
            idx = spec.options.placement_group_bundle_index
            if idx < 0:
                # Any bundle on this node with room.
                for (pgid, i), br in node.bundles.items():
                    if pgid == pg.id and br.can_fit(spec.options.resources):
                        return br
                # fall through: first bundle on node
                for (pgid, i), br in node.bundles.items():
                    if pgid == pg.id:
                        return br
                raise Infeasible("no bundle of placement group on chosen node")
            return node.bundles[(pg.id, idx)]
        return node.resources

    def _select_node(self, spec: TaskSpec) -> Optional[NodeID]:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)
        strategy = spec.options.scheduling_strategy
        request = spec.options.resources
        states = self.node_states()
        pg = spec.options.placement_group
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            spec.options.placement_group = pg
            spec.options.placement_group_bundle_index = (
                strategy.placement_group_bundle_index)
        if pg is not None:
            with self.lock:
                pg_state = self.placement_groups[pg.id]
            if not pg_state.ready.is_set():
                return None
            idx = spec.options.placement_group_bundle_index
            candidates = (pg_state.bundle_nodes if idx < 0
                          else [pg_state.bundle_nodes[idx]])
            for nid in candidates:
                node = self.nodes[nid]
                if not node.alive:
                    continue
                for (pgid, i), br in node.bundles.items():
                    if pgid == pg.id and br.can_fit(request):
                        return nid
            return None
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            from ray_tpu_torch._private.scheduler import NodeAffinityPolicy
            return NodeAffinityPolicy().select(states, request,
                                               strategy.node_id, strategy.soft)
        if strategy == "SPREAD":
            chosen = self.spread_policy.select(states, request)
        else:
            preferred = task_context.node_id
            chosen = self.hybrid_policy.select(states, request, preferred)
        if chosen is None and not any(
                n.alive and n.resources.could_ever_fit(request)
                for n in states):
            raise Infeasible(
                f"request {request} cannot be satisfied by any node "
                f"(cluster totals: "
                f"{[n.resources.total.to_dict() for n in states]})")
        return chosen

    def _assign_devices(self, request: ResourceSet, node: Node) -> Optional[list]:
        """Map a GPU resource grant to ``torch.device``s (the in-process
        analogue of CUDA_VISIBLE_DEVICES assignment, ``_raylet.pyx:563``).
        As in the JAX package, a grant of n gets the node's *first* n
        devices, whichever other tasks hold them, and a fractional grant
        gets none."""
        n = int(request.get(GPU))
        if n <= 0:
            return None
        return [torch.device("cuda", i)
                for i in range(min(n, torch.cuda.device_count()))]

    def _execute_task(self, spec: TaskSpec, node: Node, request: ResourceSet,
                      alloc_target, cancel: threading.Event):
        ctx = task_context
        prev = (ctx.node_id, ctx.task_id, ctx.job_id, ctx.put_counter,
                ctx.devices, ctx.cancel_flag, ctx.placement_group,
                ctx.trace_id, ctx.span_id)
        ctx.node_id = node.node_id
        ctx.task_id = spec.task_id
        ctx.job_id = spec.job_id
        ctx.put_counter = 0
        ctx.devices = self._assign_devices(request, node)
        ctx.cancel_flag = cancel
        ctx.placement_group = spec.options.placement_group
        # Trace context for this span: children submitted by the task
        # body inherit (trace_id, span_id) via _attach_trace.
        ctx.trace_id = spec.trace_id
        span_id = os.urandom(8).hex() if spec.trace_id else ""
        ctx.span_id = span_id
        if _flight.ENABLED:
            # flight recorder: a hard-killed process's bundle names what
            # was RUNNING (and which trace it belonged to) when it died
            _flight.task_started(spec.task_id.hex(), spec.function_name,
                                 trace_id=spec.trace_id, span_id=span_id)
        t0 = time.monotonic()
        try:
            if cancel.is_set():
                raise exc.TaskCancelledError(spec.task_id)
            if chaos.ENABLED:
                # delay stalls the worker; error fails the task (retryable
                # per retry_exceptions); exit kills this PROCESS mid-task —
                # the injected host-loss scenario resubmission must survive
                chaos.inject("task.execute", task=spec.task_id.hex()[:8],
                             name=spec.function_name)
            args = _resolve_refs(spec.args, self)
            kwargs = _resolve_refs(spec.kwargs, self)
            env = _materialize_env(spec)
            if env is not None:
                with env.applied():
                    result = spec.function(*args, **kwargs)
            else:
                result = spec.function(*args, **kwargs)
            if cancel.is_set():
                raise exc.TaskCancelledError(spec.task_id)
            self._seal_results(spec, node, result)
            with self.lock:
                self.task_states[spec.task_id] = "FINISHED"
        except BaseException as e:  # noqa: BLE001
            self._handle_task_failure(spec, node, e)
        finally:
            if _flight.ENABLED:
                _flight.task_finished(spec.task_id.hex())
            alloc_target.release(request)
            self._unpin_args(spec)
            dur = time.monotonic() - t0
            if perf.ENABLED:
                perf.observe("task.execute", dur * 1e3)
                if spec.perf_submit_s:
                    # Cross-host stamps are rebased onto this clock via
                    # clocksync (heartbeat-beacon offset), so the delta is
                    # already skew-corrected; residual error is bounded by
                    # the heartbeat RTTs. Clamp instead of discard: a
                    # stamp that still lands inside the execution window
                    # means ~zero scheduling wait, not a bogus sample.
                    e2e = max(time.time() - spec.perf_submit_s, dur)
                    perf.observe("task.e2e", e2e * 1e3)
                    perf.observe("task.sched", (e2e - dur) * 1e3)
            self.emit_event("TASK_DONE", task=spec.function_name,
                            ms=round(dur * 1e3, 3))
            span_args = {"task_id": spec.task_id.hex()}
            if spec.trace_id:
                span_args.update(trace_id=spec.trace_id, span_id=span_id,
                                 parent_span_id=spec.parent_span_id)
            _prof().record(spec.function_name, "task",
                           pid=f"node:{node.node_id.hex()[:8]}",
                           start_s=time.time() - dur, dur_s=dur,
                           args=span_args)
            (ctx.node_id, ctx.task_id, ctx.job_id, ctx.put_counter,
             ctx.devices, ctx.cancel_flag, ctx.placement_group,
             ctx.trace_id, ctx.span_id) = prev
            self._fire_completion(spec)
            self._kick()

    def _seal_results(self, spec: TaskSpec, node: Node, result: Any):
        n = spec.options.num_returns
        if n == 1:
            self.seal_return(spec.return_ids[0], result, node)
        elif n == 0:
            pass
        else:
            values = tuple(result)
            if len(values) != n:
                raise ValueError(
                    f"task {spec.function_name} declared num_returns={n} "
                    f"but returned {len(values)} values")
            for rid, v in zip(spec.return_ids, values):
                self.seal_return(rid, v, node)

    def _handle_task_failure(self, spec: TaskSpec, node: Node, e: BaseException):
        if isinstance(e, exc.TaskCancelledError):
            for rid in spec.return_ids:
                self.seal_error(rid, e, node)
            with self.lock:
                self.task_states[spec.task_id] = "CANCELLED"
            return
        if spec.should_retry(e):
            spec.attempt += 1
            # jittered exponential via the shared policy: simultaneous
            # failures (a died dependency, an OOM kill) don't retry in
            # lockstep
            delay = self._retry_backoff.delay_for(spec.attempt - 1)
            self.emit_event("TASK_RETRY", task=spec.function_name,
                            attempt=spec.attempt)
            timer = threading.Timer(delay, lambda: self.submit_task(spec))
            timer.daemon = True
            timer.start()
            return
        wrapped = e if isinstance(e, exc.RayTpuError) else exc.TaskError(
            spec.function_name, e)
        for rid in spec.return_ids:
            self.seal_error(rid, wrapped, node)
        with self.lock:
            self.task_states[spec.task_id] = "FAILED"

    def _unpin_args(self, spec: TaskSpec):
        for oid in _ref_ids_in(spec.args, spec.kwargs):
            self.reference_counter.unpin_for_task(oid)

    def _fire_completion(self, spec: TaskSpec):
        """Invoke the task's completion hooks iff it reached a final state."""
        with self.lock:
            state = self.task_states.get(spec.task_id)
            if state not in ("FINISHED", "FAILED", "CANCELLED"):
                return
            hooks = self.completion_hooks.pop(spec.task_id, None) or []  # raylint: guarded-by(self.lock)
        for hook in hooks:
            try:
                hook(spec)
            except Exception:
                logger.exception("completion hook failed for %s",
                                 spec.function_name)

    def reduce_ref(self, oid: ObjectID):
        """Pickle-reduction for an ObjectRef owned by this runtime.
        In-process semantics: pin until the deserializer re-binds
        (see ObjectRef.__reduce__); the distributed runtime overrides this
        with the cross-process borrowing protocol."""
        from ray_tpu_torch.object_ref import _deserialize_borrowed_ref
        self.reference_counter.pin_for_task(oid)
        return (_deserialize_borrowed_ref, (oid.binary(),))

    def _current_or_head_node(self) -> Node:
        nid = task_context.node_id
        with self.lock:
            if nid is not None and nid in self.nodes and self.nodes[nid].alive:
                return self.nodes[nid]
            assert self.head_node is not None, "runtime has no nodes"
            return self.head_node

    # ----------------------------------------------------------------- actors

    def create_actor(self, state: ActorState) -> None:
        with self.lock:
            self.actors[state.actor_id] = state
            if state.name:
                key = (state.namespace, state.name)
                if key in self.named_actors:
                    raise ValueError(
                        f"actor name {state.name!r} already taken in "
                        f"namespace {state.namespace!r}")
                self.named_actors[key] = state.actor_id
        self._util_pool.submit(self._place_and_start_actor, state)

    def _restore_drained_actor(self, state: ActorState):
        """Hook for the distributed runtime: return a live instance to
        resume a restarting actor from a drained node's snapshot, or None
        to construct it normally. The in-process runtime has no drain
        lifecycle, so there is never a snapshot to resume from."""
        return None

    def _place_and_start_actor(self, state: ActorState, restart: bool = False):
        deadline = time.monotonic() + _config.get("worker_lease_timeout_s")
        pause = BackoffPolicy(base_s=0.005, max_s=0.05, deadline_s=0,
                              jitter=False)
        attempt = 0
        request = state.options.resources
        spec_like = TaskSpec(
            task_id=TaskID.for_actor_task(self.job_id, state.actor_id),
            job_id=self.job_id, function=lambda: None,
            function_name=f"{state.cls.__name__}.__init__", args=state.args,
            kwargs=state.kwargs, options=state.options)
        while True:
            try:
                node_id = self._select_node(spec_like)
            except Infeasible as e:
                self._mark_actor_dead(state, exc.ActorDiedError(str(e)))
                return
            if node_id is not None:
                node = self.nodes[node_id]
                target = self._allocation_target(spec_like, node)
                if target.can_fit(request):
                    target.allocate(request)
                    break
            if time.monotonic() > deadline:
                self._mark_actor_dead(state, exc.ActorDiedError(
                    f"could not place actor {state.cls.__name__} "
                    f"(resources {request})"))
                return
            time.sleep(pause.delay_for(attempt))
            attempt += 1
        state.node_id = node_id
        state.devices = self._assign_devices(request, node)
        self._start_actor_on_node(state, node, request)

    def _start_actor_on_node(self, state: ActorState, node: Node,
                             request: ResourceSet):
        import inspect
        methods = [m for _, m in inspect.getmembers(
            state.cls, predicate=inspect.isfunction)]
        state.is_async = any(inspect.iscoroutinefunction(m) for m in methods)
        max_c = getattr(state.options, "max_concurrency", None) or 1
        if state.is_async and max_c == 1:
            max_c = 1000  # reference default for async actors

        def _init_and_loop():
            ctx = task_context
            ctx.node_id = node.node_id
            ctx.actor_id = state.actor_id
            ctx.job_id = self.job_id
            ctx.devices = state.devices
            ctx.placement_group = state.options.placement_group
            try:
                restored = self._restore_drained_actor(state)
                if restored is not None:
                    # Previous host drained gracefully: resume from its
                    # snapshot instead of re-running __init__.
                    state.instance = restored
                else:
                    args = _resolve_refs(state.args, self)
                    kwargs = _resolve_refs(state.kwargs, self)
                    env = _materialize_env_for_actor(state)
                    if env is not None:
                        with env.applied():
                            state.instance = state.cls(*args, **kwargs)
                    else:
                        state.instance = state.cls(*args, **kwargs)
                state.status = ActorState.ALIVE
                state.ready.set()
                self.emit_event("ACTOR_ALIVE", actor=state.cls.__name__)
            except BaseException as e:  # noqa: BLE001
                self._mark_actor_dead(state, exc.ActorDiedError(
                    f"actor {state.cls.__name__} __init__ failed: "
                    f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
                return
            if state.is_async:
                self._run_async_actor_loop(state, max_c)
            else:
                self._run_actor_loop(state, node)

        if state.is_async or max_c == 1:
            t = threading.Thread(target=_init_and_loop, daemon=True,
                                 name=f"actor-{state.cls.__name__}")
            state.threads = [t]
            t.start()
        else:
            # Threaded actor (max_concurrency>1): one mailbox, N consumers —
            # execution order is relaxed like the reference's
            # out_of_order_actor_scheduling_queue.cc.
            def _consumer_entry(first: bool):
                if first:
                    _init_and_loop()
                else:
                    state.ready.wait()
                    if state.status == ActorState.ALIVE:
                        ctx = task_context
                        ctx.node_id = node.node_id
                        ctx.actor_id = state.actor_id
                        ctx.job_id = self.job_id
                        ctx.devices = state.devices
                        self._run_actor_loop(state, node)
            state.threads = []
            for i in range(max_c):
                t = threading.Thread(target=_consumer_entry, args=(i == 0,),
                                     daemon=True,
                                     name=f"actor-{state.cls.__name__}-{i}")
                state.threads.append(t)
                t.start()

    def _run_actor_loop(self, state: ActorState, node: Node):
        while True:
            item = state.mailbox.get()
            if item is None or state.status == ActorState.DEAD:
                return
            spec, cancel = item
            ctx = task_context
            ctx.task_id = spec.task_id
            ctx.cancel_flag = cancel
            ctx.put_counter = 0
            ctx.trace_id = spec.trace_id
            span_id = os.urandom(8).hex() if spec.trace_id else ""
            ctx.span_id = span_id
            t0 = time.monotonic()
            try:
                if cancel.is_set():
                    raise exc.TaskCancelledError(spec.task_id)
                args = _resolve_refs(spec.args, self)
                kwargs = _resolve_refs(spec.kwargs, self)
                method = getattr(_live_instance(state), spec.method_name)
                env = _materialize_env(spec, state)
                if env is not None:
                    with env.applied():
                        result = method(*args, **kwargs)
                else:
                    result = method(*args, **kwargs)
                self._seal_results(spec, node, result)
                with self.lock:
                    self.task_states[spec.task_id] = "FINISHED"
            except BaseException as e:  # noqa: BLE001
                # Runtime errors (incl. TaskCancelledError and serve's
                # overload/shed signals) re-raise RAW at get(), same as
                # the plain-task and async-actor paths — callers
                # discriminate on the type; user errors get the TaskError
                # wrapper naming the method.
                wrapped = (e if isinstance(e, exc.RayTpuError)
                           else exc.TaskError(
                               f"{state.cls.__name__}.{spec.method_name}", e))
                for rid in spec.return_ids:
                    self.seal_error(rid, wrapped, node)
                with self.lock:
                    self.task_states[spec.task_id] = "FAILED"
            finally:
                self._unpin_args(spec)
                dur = time.monotonic() - t0
                span_args = {"actor_id": state.actor_id.hex()}
                if spec.trace_id:
                    span_args.update(trace_id=spec.trace_id,
                                     span_id=span_id,
                                     parent_span_id=spec.parent_span_id)
                _prof().record(
                    f"{state.cls.__name__}.{spec.method_name}",
                    "actor_task", pid=f"node:{node.node_id.hex()[:8]}",
                    start_s=time.time() - dur, dur_s=dur,
                    args=span_args)
                self._fire_completion(spec)
                self._kick()
                # Drop this call's references before waiting for the next:
                # an idle consumer must not keep the last call's arguments
                # or result (a serve deploy's weights) alive.
                item = spec = args = kwargs = method = result = None
                wrapped = None

    def _run_async_actor_loop(self, state: ActorState, max_concurrency: int):
        import asyncio
        loop = asyncio.new_event_loop()
        state.loop = loop
        node = self.nodes[state.node_id]
        sem = asyncio.Semaphore(max_concurrency)

        async def _run_one(spec: TaskSpec, cancel):
            async with sem:
                span_id = os.urandom(8).hex() if spec.trace_id else ""
                token = (_trace_var.set((spec.trace_id, span_id))
                         if spec.trace_id else None)
                t0 = time.monotonic()
                try:
                    if cancel.is_set():
                        raise exc.TaskCancelledError(spec.task_id)
                    args = _resolve_refs(spec.args, self)
                    kwargs = _resolve_refs(spec.kwargs, self)
                    method = getattr(_live_instance(state), spec.method_name)
                    env = _materialize_env(spec, state)
                    if env is not None:
                        with env.applied():
                            result = method(*args, **kwargs)
                    else:
                        result = method(*args, **kwargs)
                    if asyncio.iscoroutine(result):
                        result = await result
                    self._seal_results(spec, node, result)
                    with self.lock:
                        self.task_states[spec.task_id] = "FINISHED"
                except BaseException as e:  # noqa: BLE001
                    wrapped = e if isinstance(e, exc.RayTpuError) else exc.TaskError(
                        f"{state.cls.__name__}.{spec.method_name}", e)
                    for rid in spec.return_ids:
                        self.seal_error(rid, wrapped, node)
                    with self.lock:
                        self.task_states[spec.task_id] = "FAILED"
                finally:
                    if token is not None:
                        _trace_var.reset(token)
                    self._unpin_args(spec)
                    dur = time.monotonic() - t0
                    span_args = {"actor_id": state.actor_id.hex()}
                    if spec.trace_id:
                        span_args.update(
                            trace_id=spec.trace_id, span_id=span_id,
                            parent_span_id=spec.parent_span_id)
                    _prof().record(
                        f"{state.cls.__name__}.{spec.method_name}",
                        "actor_task",
                        pid=f"node:{node.node_id.hex()[:8]}",
                        start_s=time.time() - dur, dur_s=dur,
                        args=span_args)
                    self._fire_completion(spec)
                    self._kick()

        async def _pump():
            while state.status != ActorState.DEAD:
                item = await loop.run_in_executor(None, state.mailbox.get)
                if item is None:
                    break
                spec, cancel = item
                loop.create_task(_run_one(spec, cancel))

        try:
            loop.run_until_complete(_pump())
        finally:
            loop.close()

    def submit_actor_task(self, actor_id: ActorID, spec: TaskSpec) -> List[ObjectID]:
        self._attach_trace(spec)
        with self.lock:
            state = self.actors.get(actor_id)
        if not spec.return_ids:
            spec.return_ids = tuple(ObjectID.for_return(spec.task_id, i)
                                    for i in range(spec.options.num_returns))
        cancel = threading.Event()
        with self.lock:
            self.cancel_flags[spec.task_id] = cancel
            for rid in spec.return_ids:
                self.lineage[rid] = spec
            self.task_states[spec.task_id] = "PENDING"
        if state is None or state.status == ActorState.DEAD:
            cause = state.death_cause if state else None
            err = exc.ActorDiedError(f"actor {actor_id} is dead: {cause}")
            for rid in spec.return_ids:
                self.seal_error(rid, err, self._current_or_head_node())
            with self.lock:
                self.task_states[spec.task_id] = "FAILED"
            self._fire_completion(spec)
            return list(spec.return_ids)
        for oid in _ref_ids_in(spec.args, spec.kwargs):
            self.reference_counter.pin_for_task(oid)
        state.mailbox.put((spec, cancel))
        return list(spec.return_ids)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        with self.lock:
            state = self.actors.get(actor_id)
        if state is None:
            return
        max_restarts = getattr(state.options, "max_restarts", 0)
        out_of_restarts = (max_restarts != -1
                           and state.restart_count >= max_restarts)
        if no_restart or out_of_restarts:
            self._mark_actor_dead(state, exc.ActorDiedError(
                "actor was killed via ray_tpu.kill"))
        else:
            self._handle_actor_failure(state, exc.ActorDiedError("killed"))

    def _mark_actor_dead(self, state: ActorState, cause: BaseException):
        with state.lock:
            if state.status == ActorState.DEAD:
                return
            state.status = ActorState.DEAD
            state.death_cause = cause
            state.ready.set()
        # Fail everything still queued.
        drained = []
        try:
            while True:
                item = state.mailbox.get_nowait()
                if item is not None:
                    drained.append(item)
        except queue.Empty:
            pass
        node = self._current_or_head_node()
        for spec, _cancel in drained:
            for rid in spec.return_ids:
                self.seal_error(rid, exc.ActorDiedError(str(cause)), node)
            self._unpin_args(spec)
            with self.lock:
                self.task_states[spec.task_id] = "FAILED"
            self._fire_completion(spec)
        # Wake every consumer so all the actor's threads exit, and drop the
        # instance and its init arguments: a dead actor must not keep its
        # device memory (a serve replica's weights) alive.
        for _ in range(len(state.threads) or 1):
            state.mailbox.put(None)
        state.instance = None
        state.args, state.kwargs = (), {}
        self._release_actor_allocation(state)
        with self.lock:
            if state.name and self.named_actors.get(
                    (state.namespace, state.name)) == state.actor_id:
                del self.named_actors[(state.namespace, state.name)]
        self.emit_event("ACTOR_DEAD", actor=state.cls.__name__, cause=str(cause))

    def _release_actor_allocation(self, state: ActorState):
        """Release the dead/restarting incarnation's resource grant (once)."""
        with state.lock:
            node_id, state.node_id = state.node_id, None
        if node_id is None:
            return
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        try:
            target = self._allocation_target(
                TaskSpec(task_id=TaskID.for_task(self.job_id),
                         job_id=self.job_id, function=lambda: None,
                         function_name="", args=(), kwargs={},
                         options=state.options), node)
            target.release(state.options.resources)
        except Exception as e:
            logger.debug("resource release after actor death failed: %s", e)

    def _handle_actor_failure(self, state: ActorState, cause: BaseException):
        """Restart up to max_restarts (GcsActorManager::ReconstructActor)."""
        max_restarts = getattr(state.options, "max_restarts", 0)
        if max_restarts != -1 and state.restart_count >= max_restarts:
            self._mark_actor_dead(state, cause)
            return
        self._release_actor_allocation(state)
        with state.lock:
            state.restart_count += 1
            state.status = ActorState.RESTARTING
            state.ready.clear()
            state.instance = None
            # Hand queued work to the restarted incarnation and poison the old
            # mailbox so consumers on the failed node stop (the reference
            # replays in-flight actor tasks under max_task_retries).
            old_mailbox = state.mailbox
            state.mailbox = queue.Queue()
            try:
                while True:
                    item = old_mailbox.get_nowait()
                    if item is not None:
                        state.mailbox.put(item)
            except queue.Empty:
                pass
            old_mailbox.put(None)
        self.emit_event("ACTOR_RESTART", actor=state.cls.__name__,
                        attempt=state.restart_count)
        # escalate the restart delay with the restart count (shared policy:
        # jittered exponential from actor_restart_delay_ms)
        delay = BackoffPolicy(
            base_s=_config.get("actor_restart_delay_ms") / 1e3,
            max_s=_config.get("task_retry_max_delay_ms") / 1e3,
            deadline_s=0).delay_for(max(0, state.restart_count - 1))
        timer = threading.Timer(
            delay, lambda: self._util_pool.submit(
                self._place_and_start_actor, state, True))
        timer.daemon = True
        timer.start()

    def get_named_actor(self, name: str, namespace: str = "default"):
        with self.lock:
            actor_id = self.named_actors.get((namespace, name))
            if actor_id is None:
                raise ValueError(f"no actor named {name!r} in namespace "
                                 f"{namespace!r}")
            return self.actors[actor_id]

    # ------------------------------------------------------------ placement

    def create_placement_group(self, bundles: List[ResourceSet], strategy: str,
                               name: str = "") -> PlacementGroupState:
        pg = PlacementGroupState(PlacementGroupID.from_random(), bundles,
                                 strategy, name)
        with self.lock:
            self.placement_groups[pg.pg_id] = pg
        self._util_pool.submit(self._place_pg, pg)
        return pg

    def _place_pg(self, pg: PlacementGroupState):
        deadline = time.monotonic() + _config.get("worker_lease_timeout_s")
        while time.monotonic() < deadline:
            with self.lock:
                states = [self.nodes[nid].state() for nid in self._node_order]
                assignment = schedule_bundles(states, pg.bundles, pg.strategy)
                if assignment is not None:
                    for i, nid in enumerate(assignment):
                        node = self.nodes[nid]
                        node.resources.allocate(pg.bundles[i])
                        node.bundles[(pg.pg_id, i)] = NodeResources(pg.bundles[i])
                    pg.bundle_nodes = assignment
                    pg.state = "CREATED"
                    pg.ready.set()
                    self._kick()
                    return
            time.sleep(0.01)
        pg.state = "INFEASIBLE"
        pg.ready.set()  # wake waiters; they must check pg.state

    def remove_placement_group(self, pg_id: PlacementGroupID):
        with self.lock:
            pg = self.placement_groups.pop(pg_id, None)
            if pg is None or pg.bundle_nodes is None:
                return
            for i, nid in enumerate(pg.bundle_nodes):
                node = self.nodes.get(nid)
                if node is None:
                    continue
                node.bundles.pop((pg_id, i), None)
                if node.alive:
                    node.resources.release(pg.bundles[i])
        self._kick()

    # ------------------------------------------------------------------ misc

    def offload(self, fn: Callable):
        self._util_pool.submit(fn)

    def emit_event(self, kind: str, **fields):
        """Structured event (the RAY_EVENT/EventManager role,
        ``src/ray/util/event.h:42,102``): in-memory ring for the state
        API, JSONL on disk when ``event_log_enabled``."""
        ev = {"ts": time.time(), "kind": kind, **fields}
        self._events.append(ev)  # raylint: allow(data-race) GIL-atomic append to best-effort event ring
        if len(self._events) > 100000:
            del self._events[:50000]  # raylint: allow(data-race) best-effort trim; worst case drops old ring entries
        if _config.get("event_log_enabled"):
            self._persist_event(ev)

    def _persist_event(self, ev: dict):
        import json
        with self._event_file_lock:
            if self._event_file is None:
                d = _config.get("event_log_dir")
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"events_{self.job_id.hex()[:8]}.jsonl")
                self._event_file = open(path, "a", buffering=1)  # raylint: guarded-by(self._event_file_lock)
            try:
                self._event_file.write(json.dumps(ev, default=str) + "\n")
            except Exception as e:
                logger.debug("event log write failed: %s", e)

    def events(self) -> List[dict]:
        return list(self._events)

    def pending_resource_demands(self) -> List[Dict[str, float]]:
        """Resource requests of queued (not yet dispatched) tasks — the
        autoscaler's demand signal (reference: LoadMetrics fed from GCS
        resource reports, ``autoscaler/_private/load_metrics.py``)."""
        with self._pending_cv:
            pending = list(self._pending)
        out = []
        for item in pending:
            spec = item["spec"]
            out.append(self._effective_request(spec).to_dict())
        return out

    def shutdown(self):
        self._shutdown = True
        self._kick()
        with self.lock:
            actor_snapshot = list(self.actors.values())
        for state in actor_snapshot:
            if state.status != ActorState.DEAD:
                self._mark_actor_dead(state, exc.ActorDiedError("shutdown"))
        for node in self.nodes.values():
            node.shutdown()
        self._util_pool.shutdown(wait=False, cancel_futures=True)
        with self._event_file_lock:
            if self._event_file is not None:
                try:
                    self._event_file.close()
                except Exception as e:
                    logger.debug("event log close failed: %s", e)
                self._event_file = None


# -- helpers -----------------------------------------------------------------


def _prof():
    from ray_tpu_torch._private.profiling import get_profiler
    return get_profiler()


def _materialize_env(spec: TaskSpec, actor_state=None):
    """Task-level runtime_env, else the actor's creation-time env."""
    env = spec.options.runtime_env
    if env is None and actor_state is not None:
        env = actor_state.options.runtime_env
    if not env:
        return None
    from ray_tpu_torch._private.runtime_env import get_manager
    return get_manager().get_or_create(env)


def _materialize_env_for_actor(state):
    if not state.options.runtime_env:
        return None
    from ray_tpu_torch._private.runtime_env import get_manager
    return get_manager().get_or_create(state.options.runtime_env)


def _ref_ids_in(args, kwargs) -> List[ObjectID]:
    from ray_tpu_torch.object_ref import ObjectRef
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, ObjectRef):
            out.append(a.id())
    return out


def _resolve_refs(obj, runtime: Runtime):
    """Replace top-level ObjectRefs in args with their values (reference
    semantics: refs in args are resolved, nested refs are passed through)."""
    from ray_tpu_torch.object_ref import ObjectRef
    if isinstance(obj, ObjectRef):
        return runtime.get_object(obj.id())
    if isinstance(obj, tuple):
        return tuple(_resolve_refs(a, runtime) if isinstance(a, ObjectRef)
                     else a for a in obj)
    if isinstance(obj, list):
        return [_resolve_refs(a, runtime) if isinstance(a, ObjectRef)
                else a for a in obj]
    if isinstance(obj, dict):
        return {k: (_resolve_refs(v, runtime) if isinstance(v, ObjectRef)
                    else v) for k, v in obj.items()}
    return obj
