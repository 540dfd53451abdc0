"""Long-poll pub/sub between the controller and routers/proxies.

Parity with ``python/ray/serve/_private/long_poll.py`` (``LongPollHost``
``:63``, ``LongPollClient`` ``:179``): listeners ask the host for "changes
since snapshot_id N" and block server-side until something changes, so
config propagation is push-shaped without a persistent connection per key.

The host lives inside the controller actor; its ``listen_for_change`` call
blocks on a condition variable (the controller runs with max_concurrency,
so blocked listeners don't stall control-loop method calls).
"""

from __future__ import annotations
import logging

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.backoff import BackoffPolicy


class LongPollHost:
    def __init__(self):
        self._snapshot_ids: Dict[str, int] = {}  # raylint: guarded-by(self._cond)
        self._objects: Dict[str, Any] = {}  # raylint: guarded-by(self._cond)
        self._cond = threading.Condition()

    def notify_changed(self, key: str, obj: Any) -> None:
        with self._cond:
            self._objects[key] = obj
            self._snapshot_ids[key] = self._snapshot_ids.get(key, 0) + 1
            self._cond.notify_all()

    def notify_if_changed(self, key: str, obj: Any) -> bool:
        """``notify_changed`` that dedups: skip the snapshot bump (and the
        listener wakeups) when ``obj`` equals the currently published
        value.  The control loop publishes per-replica latency stats every
        tick; without this every idle tick would fan a no-op update out to
        every router.  Returns True when a notification was published."""
        with self._cond:
            if key in self._objects and self._objects[key] == obj:
                return False
            self._objects[key] = obj
            self._snapshot_ids[key] = self._snapshot_ids.get(key, 0) + 1
            self._cond.notify_all()
            return True

    def listen_for_change(
            self, keys_to_snapshot_ids: Dict[str, int],
            timeout_s: float = 30.0) -> Dict[str, Tuple[int, Any]]:
        """Block until any watched key moves past the caller's snapshot id.

        Returns {key: (new_snapshot_id, object)} for changed keys only;
        empty dict on timeout.
        """
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                updates = {
                    key: (self._snapshot_ids[key], self._objects[key])
                    for key, since in keys_to_snapshot_ids.items()
                    if self._snapshot_ids.get(key, 0) > since
                }
                if updates:
                    return updates
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._cond.wait(remaining)


import weakref

logger = logging.getLogger("ray_tpu")

_live_clients: "weakref.WeakSet" = weakref.WeakSet()


def stop_all_clients(join_timeout_s: float = 3.0) -> None:
    """Stop every live long-poll loop in this process AND join the threads:
    serve shutdown calls this so no poller can slip one more .remote()
    past the runtime teardown and auto-reinitialize the worker."""
    clients = list(_live_clients)
    for client in clients:
        client.stop()
    deadline = time.monotonic() + join_timeout_s
    for client in clients:
        t = getattr(client, "_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout=max(0.0, deadline - time.monotonic()))


class LongPollClient:
    """Background thread long-polling the controller for watched keys."""

    def __init__(self, controller_handle,
                 key_listeners: Dict[str, Callable[[Any], None]]):
        import ray_tpu_torch as ray_tpu
        self._ray = ray_tpu
        self._controller = controller_handle
        self._listeners = dict(key_listeners)
        self._snapshot_ids = {k: 0 for k in self._listeners}
        self._stopped = threading.Event()
        _live_clients.add(self)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-long-poll")
        self._thread.start()

    def _loop(self) -> None:
        poll_backoff = BackoffPolicy(base_s=0.2, max_s=5.0, deadline_s=0)
        errors = 0
        while not self._stopped.is_set():
            try:
                ref = self._controller.listen_for_change.remote(
                    dict(self._snapshot_ids))
                updates = self._ray.get(ref, timeout=60)
            except Exception as e:
                logger.debug("long poll failed; retrying: %s", e)
                if self._stopped.is_set():
                    return
                errors += 1
                self._stopped.wait(poll_backoff.delay_for(errors - 1))
                continue
            errors = 0
            for key, (snapshot_id, obj) in updates.items():
                self._snapshot_ids[key] = snapshot_id
                try:
                    self._listeners[key](obj)
                except Exception as e:
                    logger.warning("long-poll listener raised: %s", e)

    def stop(self) -> None:
        self._stopped.set()
