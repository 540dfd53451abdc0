"""Adaptive request batching for deployments.

Parity with ``python/ray/serve/batching.py`` (``@serve.batch``): concurrent
calls to the wrapped method are grouped into one invocation receiving a
list of inputs and returning a list of outputs; each caller gets its own
element back.  A batch flushes when it reaches ``max_batch_size`` or when
the oldest request has waited ``batch_wait_timeout_s``.

Port of ``ray_tpu/serve/batching.py``, unchanged but for its imports.
``pad_batch_to`` — a sorted tuple of bucket sizes. When set, the invoked
batch list is padded (by repeating the last element) up to the next bucket
so the wrapped forward sees only a few static batch shapes (what a CUDA
graph or a compiled forward needs to avoid recapturing per batch size);
padded outputs are dropped before delivery.
"""

from __future__ import annotations

import functools
import itertools
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ray_tpu_torch.exceptions import BatchExecutionError

_request_counter = itertools.count()


def next_request_id() -> int:
    """Process-unique id stamped on each batched request so batch-level
    failures (``BatchExecutionError``) can name their members.  The
    replica-side micro-batcher names its requests by the ids their
    handles minted instead."""
    return next(_request_counter)


def next_bucket(n: int, buckets: Optional[Tuple[int, ...]]) -> int:
    """Smallest bucket >= n (the largest bucket when n overflows them);
    n itself when no buckets are configured."""
    if not buckets:
        return n
    return next((b for b in buckets if b >= n), buckets[-1])


def pad_items(items: List[Any], buckets: Optional[Tuple[int, ...]]
              ) -> List[Any]:
    """Pad ``items`` (repeating the last element) up to the next bucket so
    a jitted forward only ever sees ``len(buckets)`` static batch shapes.
    Shared by the ``@serve.batch`` decorator and the replica-side
    micro-batcher — one owner of the pad-to-bucket rule."""
    target = next_bucket(len(items), buckets)
    if target > len(items):
        return items + [items[-1]] * (target - len(items))
    return items


class _Slot:
    __slots__ = ("item", "event", "value", "error", "request_id")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.request_id = next_request_id()


class _BatchQueue:
    """A dedicated daemon flusher thread drains the queue, so a caller's
    latency is bounded by its own batch — under sustained traffic no caller
    is ever conscripted into flushing others' batches."""

    def __init__(self, fn: Callable[[Any, List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float,
                 pad_batch_to: Optional[Tuple[int, ...]]):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._buckets = tuple(sorted(pad_batch_to)) if pad_batch_to else None
        self._lock = threading.Lock()
        self._pending: List[_Slot] = []  # raylint: guarded-by(self._lock)
        self._instance = None
        self._wakeup = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def submit(self, instance, item) -> Any:
        slot = _Slot(item)
        with self._lock:
            self._instance = instance  # raylint: guarded-by(self._lock)
            self._pending.append(slot)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name=f"serve-batch-{self._fn.__name__}")
                self._thread.start()
        self._wakeup.set()
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.value

    def _flush_loop(self) -> None:
        import time
        while True:
            self._wakeup.wait()
            # Batch window: from the first pending request, wait until the
            # batch fills or batch_wait_timeout_s elapses.
            deadline = time.monotonic() + self._timeout
            while True:
                with self._lock:
                    n = len(self._pending)
                if n >= self._max or time.monotonic() >= deadline:
                    break
                time.sleep(min(0.001, max(self._timeout / 10, 1e-4)))
            with self._lock:
                batch, self._pending = (self._pending[:self._max],
                                        self._pending[self._max:])
                instance = self._instance
                if not self._pending:
                    self._wakeup.clear()
            if batch:
                self._execute(instance, batch)

    def _call(self, instance, items: List[Any]) -> List[Any]:
        n = len(items)
        items = pad_items(items, self._buckets)
        if instance is not None:
            results = self._fn(instance, items)
        else:
            results = self._fn(items)
        results = list(results)[:n]
        if len(results) != n:
            raise ValueError(
                f"batched function returned {len(results)} results "
                f"for {n} inputs")
        return results

    def _execute(self, instance, batch: List[_Slot]) -> None:
        try:
            results = self._call(instance, [s.item for s in batch])
            for slot, value in zip(batch, results):
                slot.value = value
                slot.event.set()
            return
        except BaseException as e:
            error = e
        # Batch-level failure.  A singleton batch gets its own error raw —
        # there is no ambiguity about whose request poisoned it.  For
        # multi-item batches, optionally re-run each member alone once so
        # poisoned requests fail alone and innocent batchmates still get
        # answers; otherwise stamp a batch-level tag carrying the batch
        # size and request ids so callers can tell "my request was bad"
        # from "I was collateral".
        if len(batch) == 1:
            batch[0].error = error
            batch[0].event.set()
            return
        from ray_tpu_torch._private.config import _config
        if _config.get("serve_batch_retry_singletons"):
            for slot in batch:
                try:
                    slot.value = self._call(instance, [slot.item])[0]
                except BaseException as single_err:
                    slot.error = single_err
                slot.event.set()
            return
        tagged = BatchExecutionError(
            self._fn.__name__, len(batch),
            [s.request_id for s in batch], error)
        for slot in batch:
            slot.error = tagged
            slot.event.set()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01,
          pad_batch_to: Optional[Sequence[int]] = None):
    """Decorator converting ``f(self, item)`` call sites into batched
    ``f(self, [items])`` execution.  The wrapped function must accept a
    list and return a list of equal length."""

    def wrap(fn: Callable):
        queue_attr = f"__batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if kwargs:
                raise ValueError("@serve.batch methods take one positional "
                                 "request argument")
            if len(args) == 2:  # bound method: (self, item)
                instance, item = args
                holder = instance
            elif len(args) == 1:  # plain function: (item,)
                instance, item = None, args[0]
                holder = wrapper
            else:
                raise ValueError("@serve.batch methods take exactly one "
                                 "request argument")
            queue = getattr(holder, queue_attr, None)
            if queue is None:
                queue = _BatchQueue(
                    fn, max_batch_size, batch_wait_timeout_s,
                    tuple(pad_batch_to) if pad_batch_to else None)
                setattr(holder, queue_attr, queue)
            return queue.submit(instance, item)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
