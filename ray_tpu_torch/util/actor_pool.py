"""Actor pool utility.

Capability parity with the reference's ``python/ray/util/actor_pool.py``
(``ActorPool``): a fixed set of actors shared by a stream of tasks, with
ordered and unordered result retrieval.  The implementation here is written
against ray_tpu futures (``ray_tpu.wait`` drives completion) rather than a
translation of the reference code.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, TypeVar

import ray_tpu_torch as ray_tpu

V = TypeVar("V")


class ActorPool:
    """Pool of actor handles load-balancing a stream of submitted tasks.

    Example:
        >>> pool = ActorPool([Worker.remote() for _ in range(4)])
        >>> results = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle_actors: List[Any] = list(actors)
        if not self._idle_actors:
            raise ValueError("ActorPool requires at least one actor")
        # future -> actor that produced it
        self._future_to_actor = {}
        # ordered bookkeeping: index -> future (+ reverse), next index to
        # submit/return
        self._index_to_future = {}
        self._future_to_index = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[tuple] = []

    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        """Schedule ``fn(actor, value)`` on the next idle actor.

        If no actor is idle the submit is queued and dispatched when one
        frees up (inside ``get_next``/``get_next_unordered``).
        """
        if self._idle_actors:
            actor = self._idle_actors.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._future_to_index[future] = self._next_task_index
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def get_next(self, timeout: float | None = None) -> Any:
        """Return results in submission order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        future = self._index_to_future[self._next_return_index]
        if timeout is not None:
            ready, _ = ray_tpu.wait([future], timeout=timeout)
            if not ready:
                raise TimeoutError("Timed out waiting for result")
        # Return the actor to the pool before ray_tpu.get so a task that
        # raises doesn't leak the actor as busy and wedge pending submits.
        del self._index_to_future[self._next_return_index]
        del self._future_to_index[future]
        self._next_return_index += 1
        self._return_actor(self._future_to_actor.pop(future))
        return ray_tpu.get(future)

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Return whichever queued result completes first."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        ready, _ = ray_tpu.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        future = ready[0]
        # Drop it from the ordered index too.
        idx = self._future_to_index.pop(future, None)
        if idx is not None:
            del self._index_to_future[idx]
        self._return_actor(self._future_to_actor.pop(future))
        return ray_tpu.get(future)

    def _return_actor(self, actor) -> None:
        self._idle_actors.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    def map(self, fn: Callable[[Any, V], Any],
            values: Iterable[V]) -> Iterator[Any]:
        """Apply ``fn`` over ``values``, yielding results in order."""
        for value in values:
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any],
                      values: Iterable[V]) -> Iterator[Any]:
        """Apply ``fn`` over ``values``, yielding results as they finish."""
        for value in values:
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        busy = set(self._future_to_actor.values())
        if actor in self._idle_actors or actor in busy:
            raise ValueError("Actor already belongs to this pool")
        self._return_actor(actor)

    def pop_idle(self) -> Any | None:
        """Remove and return an idle actor, or None if none are idle."""
        if self.has_free():
            return self._idle_actors.pop()
        return None
