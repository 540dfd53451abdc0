"""Shared striped transport: the single owner of bulk-bytes data sockets.

Every path that moves bulk payload bytes between peers — object fetch
(``FETCH_OBJECT``), proactive/drain object push (``PUSH_OBJECT``), and
checkpoint chunk fetch on restore — stripes over ONE per-peer pool of raw
data connections (:class:`_DataStreamPool`, defined here and only here).
The reference separates object-manager data connections from the raylet
control channel for the same reason: a multi-GB transfer must not
head-of-line-block the multiplexed control socket, and one socket's
reader thread must not serialize a transfer that could ride N streams.

Auto-tuning: instead of fixed defaults, a one-shot loopback bandwidth
probe (:func:`ensure_probed`) measures send throughput at several chunk
sizes and derives

- ``fetch_chunk_bytes``   — the chunk size with the best measured rate,
- ``SO_SNDBUF/SO_RCVBUF`` — two in-flight chunks per stream, and
- streams per peer        — enough to overlap send/recv work without
  oversubscribing the host's cores.

Explicit config knobs always win; the probe only fills the ``0``/"auto"
holes. The probe result is exported to the bench as
``transport_probe_gbps`` (see :func:`probe_report`).

Failover: :class:`StripedTransfer` owns the retry loop shared by all
consumers — chunks queued on a stream that dies mid-transfer are retried
on the surviving/replenished streams under the standard backoff policy,
and the ``transport.stream`` chaos point fires per chunk submission so a
deterministic schedule can kill any stripe of any consumer.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

from ray_tpu_torch import chaos
from ray_tpu_torch.observability import comms, perf
from ray_tpu_torch._private.backoff import BackoffPolicy
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.rpc import (RpcClient, RpcConnectionError,
                                  RpcRemoteError)

# raylint: hot-path  (bulk-transfer module: R8 flags hidden payload copies)

logger = logging.getLogger("ray_tpu")

#: Fallback chunk size when the knob is 0/auto and the probe is disabled.
DEFAULT_CHUNK = 8 * 1024 * 1024

#: Chunk sizes the probe races against each other.
_PROBE_CANDIDATES = (1 << 20, 4 << 20, 8 << 20, 16 << 20)

_tuned_lock = threading.Lock()
_tuned: Dict[str, float] = {}   # chunk_bytes, sock_buf, streams, probe_gbps


# -- auto-tune probe ----------------------------------------------------------

def _probe_one(nbytes: int, chunk: int) -> float:
    """Throughput (bytes/s) of a loopback send of ``nbytes`` in ``chunk``
    pieces — the syscall/copy cost profile of one data stream."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        drained = threading.Event()

        def _drain():
            conn, _ = srv.accept()
            buf = bytearray(min(chunk, 1 << 20))
            view = memoryview(buf)
            with conn:
                while conn.recv_into(view):
                    pass
            drained.set()

        th = threading.Thread(target=_drain, name="transport-probe",
                              daemon=True)
        th.start()
        cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            cli.connect(srv.getsockname())
            cli.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            payload = memoryview(bytearray(chunk))
            sent = 0
            t0 = time.perf_counter()
            while sent < nbytes:
                n = min(chunk, nbytes - sent)
                cli.sendall(payload[:n])
                sent += n
        finally:
            cli.close()
        drained.wait(timeout=10.0)
        el = time.perf_counter() - t0
        return nbytes / el if el > 0 else 0.0
    finally:
        srv.close()


def ensure_probed() -> None:
    """Run the startup bandwidth probe once per process (thread-safe).

    Disabled (``transport_probe_bytes=0``) or failed probes leave the
    static fallbacks in place — auto-tuning is an optimization, never a
    prerequisite for moving bytes."""
    with _tuned_lock:
        if _tuned:
            return
        # marks the attempt below: the probe runs once
        _tuned["probe_gbps"] = 0.0  # raylint: allow(data-race) unlocked readers see a GIL-atomic dict snapshot; a miss falls back to static defaults
        nbytes = int(_config.get("transport_probe_bytes"))
        if nbytes <= 0:
            return
        try:
            best_chunk, best_rate = 0, 0.0
            for chunk in _PROBE_CANDIDATES:
                if chunk > nbytes:
                    continue  # larger than the whole probe: measures nothing
                rate = _probe_one(nbytes, chunk)
                if rate > best_rate:
                    best_chunk, best_rate = chunk, rate
            if not best_chunk:
                return
            ncpu = os.cpu_count() or 4
            # raylint: allow(data-race) unlocked readers see a GIL-atomic dict snapshot; a miss falls back to static defaults
            _tuned.update(
                chunk_bytes=best_chunk,
                sock_buf=min(max(2 * best_chunk, 1 << 20), 64 << 20),
                streams=4 if ncpu >= 4 else 2,
                probe_gbps=best_rate / 1e9)
            logger.debug(
                "transport probe: %.2f GB/s, chunk=%d MiB, streams=%d",
                best_rate / 1e9, best_chunk >> 20, int(_tuned["streams"]))
        except OSError as e:
            logger.warning("transport bandwidth probe failed (%s); "
                           "using static defaults", e)


def probe_report() -> Dict[str, float]:
    """Tuned values for the bench/doctor (runs the probe if needed)."""
    ensure_probed()
    with _tuned_lock:
        return dict(_tuned)


def _reset_probe_for_tests() -> None:
    with _tuned_lock:
        _tuned.clear()  # raylint: allow(data-race) test-only reset; unlocked readers fall back to static defaults


# -- knob resolution (explicit value wins; probe fills the "auto" holes) ------

def fetch_chunk_bytes() -> int:
    """Bulk-transfer chunk size: the single source of truth for every
    consumer (object fetch/push, checkpoint fetch, drain migration)."""
    n = int(_config.get("fetch_chunk_bytes"))
    if n > 0:
        return n
    ensure_probed()
    return int(_tuned.get("chunk_bytes") or DEFAULT_CHUNK)


def data_sock_buf() -> int:
    """SO_SNDBUF/SO_RCVBUF for bulk-transfer sockets: explicit knob, else
    the probe's pick, else sized to one fetch chunk so a whole chunk can
    be in flight per stream (the kernel silently caps at
    net.core.[rw]mem_max)."""
    n = int(_config.get("data_socket_buffer_bytes"))
    if n > 0:
        return n
    ensure_probed()
    tuned = int(_tuned.get("sock_buf") or 0)
    if tuned:
        return tuned
    return min(max(fetch_chunk_bytes(), 1 << 20), 64 << 20)


def streams_per_peer() -> int:
    """Data streams per peer: >0 explicit, 0 pool disabled, <0 auto."""
    n = int(_config.get("data_streams_per_peer"))
    if n >= 0:
        return n
    ensure_probed()
    return int(_tuned.get("streams") or 4)


# -- the pool -----------------------------------------------------------------

class _DataStreamPool:
    """Per-peer pool of raw data connections (``data_streams_per_peer``).

    Chunked bulk transfers stripe across these instead of serializing
    behind the multiplexed control socket's single reader/writer — the
    reference separates object-manager data connections from the raylet
    control channel for the same reason. Streams are plain authenticated
    ``RpcClient``s (same FETCH_OBJECT/PUSH_OBJECT protocol), created
    lazily per peer and replaced on failure; with the pool disabled
    (size 0) callers fall back to the control connection."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams: Dict[str, List[RpcClient]] = {}  # raylint: guarded-by(self._lock)

    def clients(self, address: str) -> List[RpcClient]:
        n = streams_per_peer()
        if n <= 0:
            return []
        extra: List[RpcClient] = []
        with self._lock:
            pool = [c for c in self._streams.get(address, ())
                    if not c.closed]
            # the knob is live (the autopilot retunes it from the link
            # matrix): a shrink closes the surplus lanes instead of
            # pinning the old width for the peer's lifetime
            if len(pool) > n:
                extra, pool = pool[n:], pool[:n]
            while len(pool) < n:
                try:
                    pool.append(RpcClient(
                        address, sock_buf_bytes=data_sock_buf()))
                except (OSError, RpcConnectionError):
                    break  # peer unreachable: callers use what exists
            self._streams[address] = pool
        for c in extra:  # close outside the lock: close() can block
            c.close()
        return list(pool)

    def drop(self, address: str) -> None:
        with self._lock:
            pool = self._streams.pop(address, [])
        for c in pool:
            c.close()

    def close_all(self) -> None:
        with self._lock:
            pools = list(self._streams.values())
            self._streams.clear()
        for pool in pools:
            for c in pool:
                c.close()


# -- shared striped submission with failover ----------------------------------

class StripedTransfer:
    """One striped bulk transfer to/from ``addr`` over a shared pool.

    The caller supplies ``submit(client, offset, done_cb)`` which issues
    one async chunk request on ``client`` and arranges for
    ``done_cb(error_or_none)`` to run when that chunk settles; this class
    owns everything else: round-robin striping, the ``transport.stream``
    chaos point, completion accounting, and the failover loop — failed
    chunks are retried on the surviving/replenished streams under the
    standard backoff policy. Errors of a type in ``fatal`` abort the
    transfer immediately (the peer authoritatively lost the data; no
    retry can help). ``self.streams`` always holds the streams of the
    most recent round so callers can quiesce their readers on abort.
    """

    def __init__(self, pool: _DataStreamPool, addr: str, *,
                 consumer: str, fallback_client: Optional[RpcClient] = None,
                 streams: Optional[List[RpcClient]] = None,
                 timeout: float = 120.0):
        self.pool = pool
        self.addr = addr
        self.consumer = consumer
        self.fallback = fallback_client
        self.timeout = timeout
        self.streams: List[RpcClient] = list(streams) if streams else []

    def _refill(self) -> None:
        self.streams = [c for c in self.pool.clients(self.addr)
                        if not c.closed]
        if not self.streams:
            if self.fallback is None:
                raise RpcConnectionError(
                    f"data streams to {self.addr} lost mid-transfer")
            self.streams = [self.fallback]

    def run(self, offsets: Iterable[int],
            submit: Callable[[RpcClient, int, Callable], None],
            fatal: tuple = (RpcRemoteError,)) -> None:
        if not perf.ENABLED:
            return self._run(offsets, submit, fatal)
        t0 = time.monotonic()
        try:
            return self._run(offsets, submit, fatal)
        finally:
            perf.observe("transport.striped_run",
                         (time.monotonic() - t0) * 1e3)

    def _run(self, offsets: Iterable[int],
             submit: Callable[[RpcClient, int, Callable], None],
             fatal: tuple = (RpcRemoteError,)) -> None:
        pending = list(offsets)
        if not pending:
            return
        if not self.streams:
            self._refill()
        backoff = BackoffPolicy(
            deadline_s=_config.get("backoff_deadline_s")).start()
        while True:
            state = {"errors": {}, "left": len(pending)}
            state_lock = threading.Lock()  # NOT any runtime lock: cbs run
            done = threading.Event()       # on stream reader threads

            def _settle(off, error):
                with state_lock:
                    if error is not None:
                        state["errors"][off] = error
                    state["left"] -= 1
                    if state["left"] == 0:
                        done.set()

            def _done_cb(off):
                if not (perf.ENABLED or comms.ENABLED):
                    return lambda error: _settle(off, error)
                t0 = time.monotonic()  # created immediately before submit

                def _cb(error, _t0=t0, _off=off):
                    dur = time.monotonic() - _t0
                    if perf.ENABLED:
                        perf.observe("transport.chunk", dur * 1e3)
                    if comms.ENABLED and error is None:
                        # Link matrix: successful chunks only (failed
                        # ones show up as retries below).  Chunk size is
                        # the configured stripe size — an estimate for
                        # the final partial chunk of a transfer.
                        comms.link_observe(self.addr, self.consumer,
                                           nbytes=fetch_chunk_bytes(),
                                           seconds=dur, chunks=1)
                    _settle(_off, error)
                return _cb

            for i, off in enumerate(pending):
                if chaos.ENABLED:
                    try:
                        act = chaos.inject(
                            "transport.stream", peer=self.addr,
                            consumer=self.consumer, offset=str(off))
                    except chaos.ChaosConnectionReset as e:
                        _settle(off, RpcConnectionError(str(e)))
                        continue
                    if act == "drop":
                        _settle(off, RpcConnectionError(
                            "chaos: stripe dropped"))
                        continue
                try:
                    submit(self.streams[i % len(self.streams)], off,
                           _done_cb(off))
                except Exception as e:  # noqa: BLE001 — dead stream at send
                    _settle(off, e)
            if not done.wait(timeout=self.timeout):
                raise TimeoutError(
                    f"striped {self.consumer} transfer with {self.addr} "
                    f"timed out after {self.timeout}s")
            errors = state["errors"]
            if not errors:
                return
            for err in errors.values():
                if isinstance(err, fatal):
                    raise err
            # Transport failures: retry just the failed chunks on the
            # surviving streams (clients() replaces dead ones).
            pending = sorted(errors)
            if comms.ENABLED:
                # One failover per retry round (streams get replaced),
                # plus the chunks it re-sends — the link-health signal
                # the doctor's link-matrix outlier rule keys on.
                comms.link_observe(self.addr, self.consumer,
                                   retries=len(pending), failovers=1)
            if not backoff.sleep():
                err = next(iter(errors.values()))
                if isinstance(err, (RpcConnectionError, TimeoutError)):
                    raise err
                raise RpcConnectionError(str(err))
            self._refill()
