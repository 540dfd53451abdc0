"""Request router: picks a replica for each request.

Latency-aware power-of-two-choices (reference router semantics plus the
"join the shorter of two random queues" result): each pick samples two
candidate replicas and takes the one with the lower score

    (in_flight + 1) * max(execute_p95_ms, 0.1)

where ``execute_p95_ms`` is the replica's recently observed (windowed)
execute p95, published by the controller in the long-poll membership
payload.  A replica serving slow — overloaded, chaos-delayed, on a sick
host — scores itself out of rotation without any router-to-router
coordination, while two-choice sampling keeps the herd from stampeding
the single best replica.

Overload control, layered:

- ``max_concurrent_queries`` per replica still bounds admission; requests
  beyond it queue in the router (bounded by ``serve_queue_deadline_ms``
  now, so a shed is a fast 503 upstream, never a hang).
- A per-replica :class:`CircuitBreaker` (via ``BreakerBoard``) opens after
  consecutive delivery failures; open replicas leave the candidate set.
- When EVERY replica's published queue estimate exceeds the deployment's
  latency budget (or its breaker is open), the router sheds immediately
  with :class:`ServeOverloadedError` — the proxy maps it to 503 with
  Retry-After instead of letting the queue grow without bound.
"""

from __future__ import annotations
import logging

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch as ray_tpu
from ray_tpu_torch._private.backoff import OPEN, BreakerBoard
from ray_tpu_torch._private.config import _config
from ray_tpu_torch.exceptions import ServeOverloadedError
from ray_tpu_torch.serve._private.long_poll import LongPollClient
from ray_tpu_torch.serve.controller import _replica_key

logger = logging.getLogger("ray_tpu")

# Floor for the p95 factor in the score: a replica with no observations
# yet (or a genuinely sub-0.1ms one) must not multiply to zero, or
# in-flight load would stop mattering for it entirely.
_P95_FLOOR_MS = 0.1


class Router:
    def __init__(self, controller_handle, deployment_name: str):
        self._deployment_name = deployment_name
        self._controller = controller_handle
        self._lock = threading.Condition()
        self._replicas: List[Any] = []
        self._tags: List[str] = []
        self._max_concurrent = 100
        self._in_flight: Dict[str, int] = {}  # replica tag -> count
        self._p95_ms: Dict[str, float] = {}
        self._queue_est_ms: Dict[str, float] = {}
        self._target_latency_ms = 0.0
        # Per-replica fail-fast: consecutive delivery failures open the
        # breaker and take the replica out of the candidate set until the
        # reset window elapses (then the next pick is the half-open probe).
        self._breakers = BreakerBoard()
        # Seed synchronously so the first request doesn't race the poller.
        info = ray_tpu.get(
            controller_handle.get_replica_handles.remote(deployment_name))
        self._apply(info)
        self._poller = LongPollClient(
            controller_handle,
            {_replica_key(deployment_name): self._apply})

    def _apply(self, info: dict) -> None:
        with self._lock:
            self._replicas = list(info["handles"])
            tags = info.get("tags")
            self._tags = (list(tags) if tags
                          else [repr(r) for r in self._replicas])
            self._max_concurrent = info["max_concurrent_queries"]
            self._target_latency_ms = float(
                info.get("target_latency_ms", 0.0))
            self._p95_ms = dict(info.get("p95_ms") or {})
            self._queue_est_ms = dict(info.get("queue_est_ms") or {})
            # Drop in-flight counters and breakers for replicas no longer
            # in membership so state doesn't grow without bound under
            # churn.
            current = set(self._tags)
            for stale in [t for t in self._in_flight if t not in current]:
                del self._in_flight[stale]
                self._breakers.drop(stale)
            self._lock.notify_all()

    # -- scoring -----------------------------------------------------------

    def _score(self, tag: str) -> float:
        in_flight = self._in_flight.get(tag, 0)
        p95 = max(self._p95_ms.get(tag, 0.0), _P95_FLOOR_MS)
        return (in_flight + 1) * p95

    def _overloaded(self, tag: str, budget_ms: float) -> bool:
        if self._breakers.get(tag).state == OPEN:
            return True
        return budget_ms > 0 and self._queue_est_ms.get(tag, 0.0) > budget_ms

    def _pick(self, timeout: Optional[float]) -> Tuple[Any, str]:
        if timeout is None:
            # "Never hangs": an unbounded pick turns total overload into a
            # stuck caller.  Reuse the queue-deadline budget as the
            # router-side bound (<= 0 keeps the legacy wait-forever).
            deadline_ms = float(_config.get("serve_queue_deadline_ms"))
            timeout = deadline_ms / 1e3 if deadline_ms > 0 else None
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                n = len(self._replicas)
                if n:
                    budget = self._target_latency_ms
                    if all(self._overloaded(t, budget) for t in self._tags):
                        raise ServeOverloadedError(
                            f"all {n} replicas of "
                            f"{self._deployment_name!r} exceed their "
                            f"latency budget ({budget:.0f}ms); shedding",
                            retry_after_s=max(budget / 1e3, 0.1))
                    candidates = [
                        i for i, t in enumerate(self._tags)
                        if self._in_flight.get(t, 0) < self._max_concurrent
                        and self._breakers.get(t).state != OPEN]
                    if candidates:
                        # Power of two choices: sample two, keep the
                        # better-scored one.
                        if len(candidates) > 2:
                            candidates = random.sample(candidates, 2)
                        best = min(candidates,
                                   key=lambda i: self._score(self._tags[i]))
                        tag = self._tags[best]
                        self._in_flight[tag] = \
                            self._in_flight.get(tag, 0) + 1
                        return self._replicas[best], tag
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"No replica of {self._deployment_name!r} available "
                        f"within timeout")
                self._lock.wait(remaining if remaining is not None else 1.0)

    def _release(self, tag: str) -> None:
        with self._lock:
            self._in_flight[tag] = max(0, self._in_flight.get(tag, 0) - 1)
            self._lock.notify_all()

    def assign_request(self, method_name: str, args, kwargs,
                       timeout: Optional[float] = None):
        """Submit to a replica; returns the ObjectRef of the result.

        The replica slot is released when the result is consumed via
        ``resolve`` (or eagerly on submit failure).
        """
        replica, tag = self._pick(timeout)
        try:
            ref = replica.handle_request.remote(method_name, args, kwargs)
        except Exception:
            self._release(tag)
            raise
        return _TrackedRef(ref, self, replica, tag,
                           (method_name, args, kwargs))

    def _refresh_membership(self) -> None:
        """Pull current replicas from the controller (used on retry, when
        the long-poll update may not have landed yet)."""
        try:
            info = ray_tpu.get(self._controller.get_replica_handles.remote(
                self._deployment_name), timeout=10)
            self._apply(info)
        except Exception as e:
            logger.debug("membership refresh failed: %s", e)

    def shutdown(self) -> None:
        self._poller.stop()


class _TrackedRef:
    """An in-flight request: resolves to the result, releasing its slot.

    If the chosen replica dies before completing (e.g. it was retired by a
    rolling update or crashed), the request is transparently re-assigned to
    another replica, like the reference router's dead-replica retry.
    Delivery outcomes feed the router's per-replica circuit breaker: only
    replica-death/retirement counts as a failure — a user exception is a
    healthy replica faithfully reporting bad input.
    """

    _MAX_RETRIES = 3

    def __init__(self, ref, router: Router, replica, tag: str, request):
        self._ref = ref
        self._router = router
        self._replica = replica
        self._tag = tag
        self._request = request
        self._released = False
        self._retries = 0

    def _settle(self) -> None:
        if not self._released:
            self._released = True
            self._router._release(self._tag)

    def result(self, timeout: Optional[float] = None):
        import ray_tpu_torch.exceptions as exc
        while True:
            try:
                value = ray_tpu.get(self._ref, timeout=timeout)
            except ray_tpu.GetTimeoutError:
                # Still executing on the replica — keep its concurrency
                # slot so backpressure stays correct; a later result()
                # call settles it.
                raise
            except Exception as e:
                # Replica death / retirement is retryable on another
                # replica: the request never completed. (User exceptions
                # arrive wrapped in TaskError and are not retried, except
                # the replica's own "draining" rejection.)
                retryable = isinstance(
                    e, (exc.ActorDiedError, exc.ObjectLostError)) or \
                    "is draining" in str(e)
                self._settle()
                if retryable:
                    self._router._breakers.record_failure(self._tag)
                if not retryable or self._retries >= self._MAX_RETRIES:
                    raise
                self._retries += 1
                self._router._refresh_membership()
                replaced = self._router.assign_request(
                    *self._request, timeout=30)
                self._ref = replaced._ref
                self._replica = replaced._replica
                self._tag = replaced._tag
                self._released = False
                continue
            self._settle()
            self._router._breakers.record_success(self._tag)
            return value

    def ref(self):
        """Expose the raw ObjectRef (releases the slot immediately —
        callers managing refs directly opt out of backpressure)."""
        if not self._released:
            self._released = True
            self._router._release(self._tag)
        return self._ref
