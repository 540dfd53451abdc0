"""Replica actor: hosts one copy of a deployment's user callable.

Parity with ``python/ray/serve/_private/replica.py``: runs the user class
(or function), counts ongoing requests for autoscaling/backpressure,
supports ``reconfigure(user_config)`` in place, health checks, and
graceful drain before shutdown.

Port of ``ray_tpu/serve/_private/replica.py``. A replica is where the
model's weights live on the card: the user class typically holds a
``TorchPredictor`` whose parameters were moved to the device once.
Replicas stay alive across requests so that this state (and any CUDA graph
or compiled forward the user built) stays warm; a rolling update replaces
replicas one at a time so the app never serves from cold replicas only.
A replica started with ``ray_actor_options={"num_gpus": 1}`` finds its
card in ``get_runtime_context().get_gpu_devices()``.

Continuous batching: with ``max_batch_size > 1`` the replica becomes an
adaptive micro-batcher.  Incoming ``__call__`` requests are admitted into
an in-replica queue (each caller's actor thread parks on its slot, so
``max_concurrent_queries`` still bounds admission); a dedicated flusher
thread coalesces queued requests into pad-to-bucket batches — reusing the
``pad_batch_to`` bucket rule from ``serve/batching.py`` so the forward
sees only ``len(buckets)`` static batch shapes — and invokes the user
callable once per batch with a LIST of requests.  Batch size adapts to
observed queue depth, capped so the
EWMA-predicted batch time stays inside the replica's latency budget
(``target_latency_ms`` falling back to the ``serve_target_latency_ms``
knob).  Requests that age past ``serve_queue_deadline_ms`` in the queue
are shed with :class:`ServeOverloadedError` instead of executing — the
proxy maps that to 503 + Retry-After.  A failed batch isolates per item:
singleton batches get their own error raw; larger batches re-run members
alone once (``serve_batch_retry_singletons``) or receive a batch-level
:class:`BatchExecutionError` naming the batch size and request ids.

Every request — batched or direct — feeds two replica-local
:class:`~ray_tpu_torch.observability.perf.PerfHistogram` instances
(``queue_wait`` and ``execute``).  Their raw bucket counts ride
``get_metrics()`` to the controller, which diffs them per tick, federates
across replicas with ``perf.merge_counts``, and publishes per-replica
execute p95 to routers / feeds the EWMA-smoothed SLO autoscaler.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any, List, Optional

from ray_tpu_torch import chaos
from ray_tpu_torch._private.config import _config
from ray_tpu_torch.exceptions import BatchExecutionError, ServeOverloadedError
from ray_tpu_torch.observability import perf
from ray_tpu_torch.serve.batching import next_request_id, pad_items
from ray_tpu_torch.serve.config import check_checkpoint

# EWMA weight for the per-item execution-time estimate that sizes batches
# and the queue_est_ms backpressure signal (local smoothing; the
# autoscaler's cross-tick smoothing uses serve_autoscale_ewma_alpha).
_ITEM_EWMA_ALPHA = 0.3


def _load_checkpoint(checkpoint: Any) -> Any:
    """Resolve a deployment checkpoint to what the replica's ``__init__``
    receives. A CheckpointRef or its dict form (DeploymentConfig rides
    through dataclasses.asdict on deploy) raises until the checkpoint
    engine is ported; any other value passes through."""
    check_checkpoint(checkpoint)
    return checkpoint


def _resolve_arg_refs(args):
    """Resolve ObjectRef request arguments to their values.  The proxy
    puts large raw ingress bodies into the object plane and ships a ref
    (the bytes ride the striped transport pool); ``handle_request``'s
    own args tuple is nested inside the actor-call args, so the
    runtime's top-level ref resolution does not reach it — resolve here,
    on the replica's host, where the fetch is local-or-striped."""
    from ray_tpu_torch.object_ref import ObjectRef
    if not any(isinstance(a, ObjectRef) for a in args):
        return args
    import ray_tpu_torch as ray_tpu
    return tuple(ray_tpu.get(a) if isinstance(a, ObjectRef) else a
                 for a in args)


class _BatchSlot:
    """One queued request parked in the replica batcher."""

    __slots__ = ("item", "event", "value", "error", "request_id",
                 "t_enqueue")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.request_id = next_request_id()
        self.t_enqueue = time.monotonic()


class _ReplicaBatcher:
    """Adaptive micro-batcher owned by one replica (see module docstring
    for the state machine: admit → linger → shed-expired → pad-to-bucket
    execute → per-item deliver)."""

    def __init__(self, replica: "Replica", cfg: dict):
        self._replica = replica
        # the batch shape is retune()-able live (autopilot serve policy),
        # so the flush loop reads it under the same lock as the queue
        # raylint: guarded-by(self._lock)
        self._max = max(1, int(cfg.get("max_batch_size", 1)))
        # raylint: guarded-by(self._lock)
        self._wait_s = float(cfg.get("batch_wait_timeout_s", 0.005))
        pad = cfg.get("pad_batch_to")
        # raylint: guarded-by(self._lock)
        self._buckets = tuple(sorted(int(b) for b in pad)) if pad else None
        self._lock = threading.Lock()
        self._queue: List[_BatchSlot] = []  # raylint: guarded-by(self._lock)
        self._wakeup = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def retune(self, cfg: dict) -> None:
        """Live-update the batch shape (autopilot serve policy): the
        next flush cycle reads the new linger/cap; requests already
        parked keep their slots — nothing is dropped on a retune."""
        with self._lock:
            if "max_batch_size" in cfg:
                self._max = max(1, int(cfg["max_batch_size"]))
            if "batch_wait_timeout_s" in cfg:
                self._wait_s = max(0.0, float(cfg["batch_wait_timeout_s"]))
            if "pad_batch_to" in cfg:
                pad = cfg["pad_batch_to"]
                self._buckets = (tuple(sorted(int(b) for b in pad))
                                 if pad else None)
        self._wakeup.set()

    def submit(self, item) -> Any:
        slot = _BatchSlot(item)
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name=f"serve-replica-batch-{self._replica.replica_tag}")
                self._thread.start()
            self._queue.append(slot)
        self._wakeup.set()
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.value

    def shutdown(self) -> None:
        self._stop = True
        self._wakeup.set()

    def _effective_max(self) -> int:
        """Latency-guarded batch-size cap: never form a batch whose
        EWMA-predicted execution time (items × per-item estimate) would
        blow the replica's latency budget."""
        with self._lock:
            want = self._max
        budget = self._replica._batch_budget_ms()
        with self._replica._lock:
            ewma = self._replica._ewma_item_ms
        if budget > 0 and ewma > 0:
            want = min(want, max(1, int(budget / ewma)))
        return max(1, want)

    def _flush_loop(self) -> None:
        while True:
            self._wakeup.wait()
            if self._stop:
                return
            cap = self._effective_max()
            # Linger window anchored on the OLDEST queued request: fire
            # when the batch fills (to the adaptive cap) or the oldest
            # request has waited batch_wait_timeout_s.
            while True:
                with self._lock:
                    depth = len(self._queue)
                    oldest = (self._queue[0].t_enqueue
                              if self._queue else None)
                    wait_s = self._wait_s
                if oldest is None:
                    break
                if (depth >= cap
                        or time.monotonic() - oldest >= wait_s):
                    break
                time.sleep(min(0.0005, max(wait_s / 10.0, 1e-4)))
            deadline_ms = float(_config.get("serve_queue_deadline_ms"))
            expired: List[_BatchSlot] = []
            with self._lock:
                if not self._queue:
                    self._wakeup.clear()
                    continue
                if deadline_ms > 0:
                    now = time.monotonic()
                    live: List[_BatchSlot] = []
                    for s in self._queue:
                        if (now - s.t_enqueue) * 1e3 > deadline_ms:
                            expired.append(s)
                        else:
                            live.append(s)
                    self._queue = live
                batch = self._queue[:cap]
                self._queue = self._queue[cap:]
                if not self._queue:
                    self._wakeup.clear()
            for s in expired:
                wait_ms = (time.monotonic() - s.t_enqueue) * 1e3
                self._replica._observe_queue_wait(wait_ms)
                s.error = ServeOverloadedError(
                    f"request {s.request_id} aged {wait_ms:.0f}ms in the "
                    f"replica {self._replica.replica_tag} queue "
                    f"(serve_queue_deadline_ms={deadline_ms:.0f})",
                    retry_after_s=max(deadline_ms / 1e3, 0.1))
                s.event.set()
            if batch:
                self._run_batch(batch)

    def _call(self, items: List[Any]) -> List[Any]:
        n = len(items)
        with self._lock:
            buckets = self._buckets
        padded = pad_items(list(items), buckets)
        results = list(self._replica._invoke_batch(padded))[:n]
        if len(results) != n:
            raise ValueError(
                f"batched deployment returned {len(results)} results "
                f"for {n} inputs")
        return results

    def _run_batch(self, batch: List[_BatchSlot]) -> None:
        r = self._replica
        t_start = time.monotonic()
        for s in batch:
            r._observe_queue_wait((t_start - s.t_enqueue) * 1e3)
        n = len(batch)
        try:
            if chaos.ENABLED:
                chaos.inject("serve.replica.execute",
                             deployment=r.deployment_name,
                             replica=r.replica_tag)
            results = self._call([s.item for s in batch])
            r._observe_execute((time.monotonic() - t_start) * 1e3, n)
            for s, v in zip(batch, results):
                s.value = v
                s.event.set()
            return
        except BaseException as e:
            error = e
        r._observe_execute((time.monotonic() - t_start) * 1e3, n)
        # Per-item error isolation (same policy as serve/batching.py):
        # a singleton's error is unambiguously its own; larger batches
        # re-run members alone once so a poisoned request fails alone,
        # or — with retry off — get a batch-level tag naming size and
        # request ids.
        if n == 1:
            batch[0].error = error
            batch[0].event.set()
            return
        if _config.get("serve_batch_retry_singletons"):
            for s in batch:
                t1 = time.monotonic()
                try:
                    s.value = self._call([s.item])[0]
                except BaseException as single_err:
                    s.error = single_err
                r._observe_execute((time.monotonic() - t1) * 1e3, 1)
                s.event.set()
            return
        tagged = BatchExecutionError(
            getattr(r._callable, "__name__", r.deployment_name),
            n, [s.request_id for s in batch], error)
        for s in batch:
            s.error = tagged
            s.event.set()


class Replica:
    def __init__(self, deployment_name: str, replica_tag: str,
                 func_or_class, init_args, init_kwargs,
                 user_config: Optional[Any] = None,
                 checkpoint: Optional[Any] = None,
                 batch_config: Optional[dict] = None):
        self.deployment_name = deployment_name
        self.replica_tag = replica_tag
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._draining = False
        self._is_function = inspect.isfunction(func_or_class)
        if checkpoint is not None:
            if self._is_function:
                # Only class replicas have an __init__ to receive the
                # restored tree; silently dropping the checkpoint would
                # serve uninitialized weights.
                raise ValueError(
                    f"deployment {deployment_name!r}: checkpoint= requires "
                    "a class deployment (the restored pytree is injected "
                    "as the checkpoint= init kwarg); a function replica "
                    "has nowhere to receive it")
            init_kwargs = dict(init_kwargs or {})
            init_kwargs["checkpoint"] = _load_checkpoint(checkpoint)
        if self._is_function:
            self._callable = func_or_class
        else:
            self._callable = func_or_class(*init_args, **(init_kwargs or {}))
        # Replica-local latency sensors (always on — they are the
        # router/autoscaler inputs, not optional observability).
        self._hist_queue_wait = perf.PerfHistogram("queue_wait")
        self._hist_execute = perf.PerfHistogram("execute")
        self._ewma_item_ms = 0.0  # raylint: guarded-by(self._lock)
        self._batch_cfg = dict(batch_config) if batch_config else None
        self._batcher = self._build_batcher()
        if user_config is not None:
            self.reconfigure(user_config)

    def _build_batcher(self) -> Optional[_ReplicaBatcher]:
        cfg = self._batch_cfg
        if cfg and int(cfg.get("max_batch_size", 1)) > 1:
            return _ReplicaBatcher(self, cfg)
        return None

    def _batch_budget_ms(self) -> float:
        cfg = self._batch_cfg or {}
        target = float(cfg.get("target_latency_ms") or 0.0)
        if target > 0:
            return target
        return float(_config.get("serve_target_latency_ms"))

    def _invoke_batch(self, items: List[Any]):
        # Function deployments and class __call__ share the contract:
        # take a LIST of requests, return a list of equal length.  An
        # async callable is run to completion here — the flusher thread
        # has no event loop of its own, and the result must be a list.
        result = self._callable(items)
        if inspect.iscoroutine(result):
            result = asyncio.run(result)
        return result

    def _observe_queue_wait(self, ms: float) -> None:
        self._hist_queue_wait.observe(ms)
        if perf.ENABLED:
            perf.observe("serve.queue_wait", ms)

    def _observe_execute(self, ms: float, n: int) -> None:
        """Record one batch execution covering ``n`` requests: each
        member experienced the whole batch's wall time, so the execute
        histogram gets ``n`` samples of ``ms``; the per-item EWMA gets
        ``ms / n`` (the amortized cost that sizes future batches)."""
        per_item = ms / max(n, 1)
        with self._lock:
            prev = self._ewma_item_ms
            self._ewma_item_ms = (per_item if prev == 0.0 else
                                  prev + _ITEM_EWMA_ALPHA * (per_item - prev))
        for _ in range(n):
            self._hist_execute.observe(ms)

    def reconfigure(self, user_config: Any) -> None:
        if not self._is_function:
            reconfigure = getattr(self._callable, "reconfigure", None)
            if reconfigure is not None:
                reconfigure(user_config)

    def set_batch_config(self, cfg: dict) -> None:
        """Merge a batch-config delta into the live batcher (the
        controller's ``retune_deployment_batch`` fan-out target)."""
        merged = dict(self._batch_cfg or {})
        merged.update(cfg or {})
        self._batch_cfg = merged
        batcher = self._batcher
        if batcher is not None:
            batcher.retune(merged)
        elif int(merged.get("max_batch_size", 1)) > 1:
            self._batcher = self._build_batcher()

    def handle_request(self, method_name: str, args, kwargs) -> Any:
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    f"Replica {self.replica_tag} is draining")
            self._ongoing += 1
            self._total += 1
        try:
            args = _resolve_arg_refs(args)
            batcher = self._batcher
            if (batcher is not None and method_name == "__call__"
                    and len(args) == 1 and not kwargs):
                # The caller's actor thread parks on its slot; queue wait
                # and execute are recorded by the flusher per batch.
                return batcher.submit(args[0])
            t0 = time.monotonic()
            try:
                if chaos.ENABLED:
                    chaos.inject("serve.replica.execute",
                                 deployment=self.deployment_name,
                                 replica=self.replica_tag)
                if self._is_function:
                    return self._callable(*args, **kwargs)
                if method_name == "__call__":
                    return self._callable(*args, **kwargs)
                return getattr(self._callable, method_name)(*args, **kwargs)
            finally:
                ms = (time.monotonic() - t0) * 1e3
                self._observe_queue_wait(0.0)
                self._observe_execute(ms, 1)
                if perf.ENABLED:
                    perf.observe("serve.replica_exec", ms)
        finally:
            with self._lock:
                self._ongoing -= 1

    def get_metrics(self) -> dict:
        qw_counts, qw_sum = self._hist_queue_wait.merged()
        ex_counts, ex_sum = self._hist_execute.merged()
        batcher = self._batcher
        depth = batcher.depth() if batcher is not None else 0
        with self._lock:
            ongoing = self._ongoing
            total = self._total
            ewma_ms = self._ewma_item_ms
        # Estimated time-to-drain of work already admitted here: the
        # router's shed signal and a tiebreaker for scoring.
        pending = depth if batcher is not None else ongoing
        ewma = ewma_ms
        return {"replica_tag": self.replica_tag,
                "num_ongoing_requests": ongoing,
                "num_total_requests": total,
                "queue_depth": depth,
                "queue_est_ms": pending * ewma,
                "ewma_item_ms": ewma,
                "perf": {
                    "bounds": list(perf.bucket_bounds()),
                    "queue_wait": {"counts": qw_counts, "sum_ms": qw_sum},
                    "execute": {"counts": ex_counts, "sum_ms": ex_sum},
                }}

    def check_health(self) -> bool:
        checker = None if self._is_function else getattr(
            self._callable, "check_health", None)
        if checker is not None:
            checker()
        return True

    def prepare_for_shutdown(self, timeout_s: float = 20.0) -> bool:
        """Stop accepting requests and wait for in-flight ones to drain."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout_s
        drained = False
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    drained = True
                    break
            time.sleep(0.01)
        if self._batcher is not None:
            self._batcher.shutdown()
        return drained

    # A node drain snapshots hosted actors with cloudpickle. The lock, the
    # batcher (thread/event) and the histogram shards (thread-locals) are
    # not picklable and the drain-time flags must not survive migration —
    # a replica restored on a healthy node serves again immediately with
    # fresh sensors and a fresh batcher rebuilt from _batch_cfg.
    def __getstate__(self):
        with self._lock:
            st = self.__dict__.copy()
        st.pop("_lock", None)
        st.pop("_batcher", None)
        st.pop("_hist_queue_wait", None)
        st.pop("_hist_execute", None)
        st["_draining"] = False
        st["_ongoing"] = 0
        st["_ewma_item_ms"] = 0.0
        return st

    def __setstate__(self, st):
        self.__dict__.update(st)
        self._lock = threading.Lock()
        self._hist_queue_wait = perf.PerfHistogram("queue_wait")
        self._hist_execute = perf.PerfHistogram("execute")
        self._batcher = self._build_batcher()
