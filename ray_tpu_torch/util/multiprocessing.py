"""``multiprocessing.Pool`` API on top of ray_tpu tasks.

Capability parity with ``python/ray/util/multiprocessing/pool.py``: a
drop-in ``Pool`` whose workers are cluster tasks instead of forked
processes, so the same code scales beyond one host.  Ordering, chunking,
``AsyncResult`` and the imap iterators follow the stdlib contract.

``processes`` bounds in-flight chunks for the synchronous paths
(``map``/``starmap``/``imap``/``imap_unordered``); the ``*_async`` variants
submit eagerly (they must return a handle immediately) and note so in
their docstrings.
"""

from __future__ import annotations
import logging

import itertools
import threading
# The stdlib contract raises multiprocessing.TimeoutError (a ProcessError
# subclass), so ported ``except multiprocessing.TimeoutError`` keeps working.
from multiprocessing import TimeoutError
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch as ray_tpu

logger = logging.getLogger("ray_tpu")

__all__ = ["Pool", "AsyncResult", "TimeoutError"]


def _chunk(iterable: Iterable, size: int) -> Iterator[list]:
    it = iter(iterable)
    while True:
        block = list(itertools.islice(it, size))
        if not block:
            return
        yield block


def _run_chunk(fn, chunk, star, kwds):
    if star:
        return [fn(*args, **kwds) for args in chunk]
    return [fn(args, **kwds) for args in chunk]


class AsyncResult:
    """Handle for an in-flight map/apply; mirrors stdlib ``AsyncResult``.

    When a callback/error_callback is given, a daemon thread fires it as
    soon as the result completes (stdlib semantics), not lazily at
    ``get()`` time.
    """

    def __init__(self, refs: List[Any], single: bool = False,
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._refs = refs
        self._single = single
        self._callback = callback  # raylint: guarded-by(self._lock)
        self._error_callback = error_callback  # raylint: guarded-by(self._lock)
        self._result = None
        self._done = False
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        if callback is not None or error_callback is not None:
            threading.Thread(
                target=self._collect, args=(None,), daemon=True).start()

    def _collect(self, timeout: Optional[float]) -> None:
        try:
            chunks = ray_tpu.get(self._refs, timeout=timeout)
        except ray_tpu.GetTimeoutError:
            raise TimeoutError("Result not ready within timeout")
        except Exception as e:  # task raised
            with self._lock:
                if self._done:
                    return
                self._error = e  # raylint: allow(data-race) published under self._lock before _done flips; get() reads only after observing _done
                self._done = True
                cb, self._error_callback = self._error_callback, None
            if cb is not None:
                cb(e)
            return
        flat = [item for chunk in chunks for item in chunk]
        with self._lock:
            if self._done:
                return
            self._result = flat[0] if self._single else flat  # raylint: allow(data-race) published under self._lock before _done flips; get() reads only after observing _done
            self._done = True
            cb, self._callback = self._callback, None
        if cb is not None:
            cb(self._result)

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._done:
            self._collect(timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu.wait(
            self._refs, num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("Result is not ready")
        if not self._done:
            self._collect(None)
        return self._error is None


class Pool:
    """Task-backed process pool."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_remote_args: Optional[dict] = None):
        if not ray_tpu.is_initialized():
            ray_tpu.init()
        if processes is None:
            processes = max(1, int(ray_tpu.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be at least 1")
        self._processes = processes
        self._closed = False
        self._terminated = False
        self._outstanding: List[Any] = []  # refs cancellable by terminate()
        remote_args = dict(ray_remote_args or {})
        self._task = ray_tpu.remote(**remote_args)(_run_chunk) \
            if remote_args else ray_tpu.remote(_run_chunk)
        # Pool semantics run the initializer once per worker; with dynamic
        # tasks there is no persistent worker, so run it locally once for
        # side effects the caller expects (e.g. seeding globals).
        if initializer is not None:
            initializer(*initargs)

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunksize(self, n_items: int, chunksize: Optional[int]) -> int:
        if chunksize is not None:
            return max(1, chunksize)
        return max(1, n_items // (self._processes * 4) or 1)

    def _spawn(self, fn, chunk, star, kwds=None):
        ref = self._task.remote(fn, chunk, star, kwds or {})
        if len(self._outstanding) >= 4096:  # prune finished refs
            _, pending = ray_tpu.wait(
                self._outstanding, num_returns=len(self._outstanding),
                timeout=0)
            self._outstanding = pending
        self._outstanding.append(ref)
        return ref

    def _submit_all(self, fn, iterable, star, chunksize,
                    kwds=None) -> List[Any]:
        items = list(iterable)
        size = self._chunksize(len(items), chunksize)
        return [self._spawn(fn, chunk, star, kwds)
                for chunk in _chunk(items, size)]

    def _iter_chunks_bounded(self, fn, iterable, star, chunksize,
                             ordered: bool, lazy: bool = False) -> Iterator[Any]:
        """Yield chunk results keeping ≤ ``processes`` chunks in flight.

        ``lazy=True`` (imap) consumes the input iterable incrementally —
        infinite/streaming iterables work; chunksize then defaults to the
        stdlib's 1 instead of a len-derived heuristic.
        """
        if lazy:
            size = max(1, chunksize or 1)
            chunks = _chunk(iterable, size)
        else:
            items = list(iterable)
            size = self._chunksize(len(items), chunksize)
            chunks = _chunk(items, size)
        in_flight: List[Any] = []
        for chunk in itertools.islice(chunks, self._processes):
            in_flight.append(self._spawn(fn, chunk, star))
        while in_flight:
            if self._terminated:
                return
            if ordered:
                ref, in_flight = in_flight[0], in_flight[1:]
            else:
                ready, in_flight = ray_tpu.wait(in_flight, num_returns=1)
                ref = ready[0]
            nxt = next(chunks, None)
            if nxt is not None:
                in_flight.append(self._spawn(fn, nxt, star))
            yield from ray_tpu.get(ref)

    def apply(self, func: Callable, args: tuple = (), kwds: dict = None) -> Any:
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: dict = None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_running()
        refs = [self._spawn(func, [args], True, kwds or {})]
        return AsyncResult(refs, single=True, callback=callback,
                           error_callback=error_callback)

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        self._check_running()
        return list(self._iter_chunks_bounded(
            func, iterable, False, chunksize, ordered=True))

    def map_async(self, func: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None, callback=None,
                  error_callback=None) -> AsyncResult:
        """Eager: submits every chunk immediately (cannot bound in-flight
        work and still return a handle without a pump thread)."""
        self._check_running()
        refs = self._submit_all(func, iterable, False, chunksize)
        return AsyncResult(refs, callback=callback,
                           error_callback=error_callback)

    def starmap(self, func: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_running()
        return list(self._iter_chunks_bounded(
            func, iterable, True, chunksize, ordered=True))

    def starmap_async(self, func: Callable, iterable: Iterable,
                      chunksize: Optional[int] = None, callback=None,
                      error_callback=None) -> AsyncResult:
        """Eager, like map_async."""
        self._check_running()
        refs = self._submit_all(func, iterable, True, chunksize)
        return AsyncResult(refs, callback=callback,
                           error_callback=error_callback)

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: Optional[int] = None) -> Iterator[Any]:
        self._check_running()
        return self._iter_chunks_bounded(
            func, iterable, False, chunksize, ordered=True, lazy=True)

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None) -> Iterator[Any]:
        self._check_running()
        return self._iter_chunks_bounded(
            func, iterable, False, chunksize, ordered=False, lazy=True)

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        """Close the pool and best-effort cancel outstanding chunk tasks."""
        self._closed = True
        self._terminated = True
        for ref in self._outstanding:
            try:
                ray_tpu.cancel(ref)
            except Exception as e:
                logger.debug("cancel of outstanding chunk failed: %s", e)
        self._outstanding.clear()

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
