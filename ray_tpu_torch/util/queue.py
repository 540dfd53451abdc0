"""Distributed FIFO queue backed by an actor.

Capability parity with ``python/ray/util/queue.py`` in the reference: a
bounded/unbounded queue usable from any task or actor, with blocking and
non-blocking put/get and batch variants.

Design note: the backing actor's methods are all **non-blocking** — they
try the operation and return immediately.  Blocking semantics are
implemented caller-side by polling with backoff.  (The reference keeps
blocked waiters free by using an asyncio actor; in this runtime actor
methods occupy mailbox threads, so blocking inside the actor could exhaust
``max_concurrency`` and deadlock — caller-side waiting removes that class
of failure entirely.)
"""

from __future__ import annotations
import logging

import collections
import threading
import time
# Re-export the stdlib exceptions (as the reference does) so existing
# ``except queue.Empty`` handlers keep matching.
from queue import Empty, Full
from typing import Any, List, Optional

import ray_tpu_torch as ray_tpu

logger = logging.getLogger("ray_tpu")

_POLL_S = 0.005


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._items = collections.deque()
        self._lock = threading.Lock()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return 0 < self.maxsize <= len(self._items)

    def try_put(self, item: Any) -> bool:
        with self._lock:
            if 0 < self.maxsize <= len(self._items):
                return False
            self._items.append(item)
            return True

    def try_put_batch(self, items: List[Any]) -> bool:
        with self._lock:
            if 0 < self.maxsize < len(self._items) + len(items):
                return False
            self._items.extend(items)
            return True

    def try_get(self) -> tuple:
        """Returns (ok, item)."""
        with self._lock:
            if not self._items:
                return False, None
            return True, self._items.popleft()

    def try_get_batch(self, num_items: int) -> tuple:
        with self._lock:
            if len(self._items) < num_items:
                return False, None
            return True, [self._items.popleft() for _ in range(num_items)]


class Queue:
    """A FIFO queue shared across tasks and actors.

    Args:
        maxsize: maximum number of items (0 = unbounded).
        actor_options: options forwarded to the backing actor (e.g. a
            ``name=`` to make the queue retrievable by name).
    """

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)
        self.maxsize = maxsize
        self.actor = ray_tpu.remote(_QueueActor).options(**opts).remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu.get(self.actor.full.remote())

    def _poll(self, op, timeout: Optional[float]) -> Any:
        """Run ``op`` until it reports success or the deadline passes.

        ``op`` returns (ok, value); timeout=0 means a single attempt.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, value = op()
            if ok:
                return True, value
            if deadline is not None and time.monotonic() >= deadline:
                return False, None
            time.sleep(_POLL_S)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            timeout = 0.0
        elif timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        # First attempt ships the item; while the queue stays full, poll
        # the cheap ``full()`` probe instead of re-serializing the payload
        # every tick, and only re-send once capacity appears.
        if ray_tpu.get(self.actor.try_put.remote(item)):
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is not None and time.monotonic() >= deadline:
                raise Full()
            self._poll(
                lambda: (not ray_tpu.get(self.actor.full.remote()), None),
                None if deadline is None
                else max(0.0, deadline - time.monotonic()))
            if ray_tpu.get(self.actor.try_put.remote(item)):
                return

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu.get(self.actor.try_put_batch.remote(list(items))):
            raise Full(f"Putting {len(items)} items would exceed maxsize "
                       f"{self.maxsize}")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            timeout = 0.0
        elif timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        ok, item = self._poll(
            lambda: ray_tpu.get(self.actor.try_get.remote()), timeout)
        if not ok:
            raise Empty()
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu.get(self.actor.try_get_batch.remote(num_items))
        if not ok:
            raise Empty(f"Cannot get {num_items} items from the queue")
        return items

    def shutdown(self, force: bool = False) -> None:
        """Kill the backing actor.

        With ``force=False`` an empty method call is synchronously drained
        first, so operations already in the actor's mailbox complete before
        the kill; ``force=True`` kills immediately.
        """
        if self.actor is not None:
            if not force:
                try:
                    ray_tpu.get(self.actor.qsize.remote())
                except Exception as e:
                    logger.debug("queue drain probe failed: %s", e)
            ray_tpu.kill(self.actor)
        self.actor = None
