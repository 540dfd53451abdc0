"""Task/actor span recording and chrome-tracing export.

Parity with the reference's timeline pipeline: per-worker profile events
(``src/ray/core_worker/profiling.h:30``) aggregated by
``GlobalState.chrome_tracing_dump`` (``python/ray/_private/state.py:419``)
behind the ``ray timeline`` CLI (``scripts.py:1755``). Spans are recorded
in-process (the host-granular runtime has no cross-process hop) and
dumped in the chrome://tracing "X" (complete-event) format.

For device-side detail, ``start_device_trace``/``stop_device_trace`` wrap
``torch.profiler`` (CUDA kernels where a card is present, host operators
always) so a chrome trace of the device lands next to the host spans.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from ray_tpu_torch._private.config import _config


class Profiler:
    """Bounded in-memory span ring. Thread-safe, cheap when disabled.

    Eviction is drop-oldest (a true ring): when the buffer is full the
    oldest span falls off and ``dropped`` is bumped, so the tail of the
    timeline — the part an operator is usually debugging — is never lost
    to a bulk eviction. ``chrome_trace``/``dump`` copy under the lock, so
    they are safe while other threads keep recording.
    """

    def __init__(self, max_spans: Optional[int] = None):
        self._lock = threading.Lock()
        if max_spans is None:
            max_spans = int(_config.get("trace_ring_size"))
        self._max = max_spans
        self._spans: Deque[dict] = collections.deque(maxlen=max_spans)
        self._dropped = 0
        # Monotonic append counter — survives clear() so incremental
        # readers (the flight recorder's spool thread) never double-read.
        self._seq = 0

    @property
    def enabled(self) -> bool:
        return bool(_config.get("profiling_enabled"))

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring since the last clear()."""
        return self._dropped

    def record(self, name: str, cat: str, pid: str, start_s: float,
               dur_s: float, args: Optional[Dict[str, Any]] = None):
        if not self.enabled:
            return
        self._complete(name, cat, pid, start_s * 1e6, dur_s * 1e6, args)

    def record_ns(self, name: str, cat: str, pid: str, t0_ns: int,
                  t1_ns: int, args: Optional[Dict[str, Any]] = None):
        """``record`` from two ``time.time_ns()`` stamps, each read at its
        edge: the span then lines up with a ``torch.profiler`` trace of
        the device, whose timestamps are on the same clock."""
        if not self.enabled:
            return
        self._complete(name, cat, pid, t0_ns / 1e3, (t1_ns - t0_ns) / 1e3,
                       args)

    def _complete(self, name, cat, pid, ts_us, dur_us, args):
        span = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "pid": pid,
            "tid": threading.current_thread().name,
            "ts": ts_us,
            "dur": dur_us,
        }
        if args:
            span["args"] = args
        self._append(span)

    def instant(self, name: str, cat: str, pid: str,
                args: Optional[Dict[str, Any]] = None,
                ts_s: Optional[float] = None):
        """Record a chrome instant event ("i" phase) — a point in time
        (chaos injection, breaker flip) rather than a duration."""
        if not self.enabled:
            return
        event = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "p",  # process-scoped instant marker
            "pid": pid,
            "tid": threading.current_thread().name,
            "ts": (time.time() if ts_s is None else ts_s) * 1e6,
        }
        if args:
            event["args"] = args
        self._append(event)

    def _append(self, span: dict):
        with self._lock:
            dropped = len(self._spans) == self._max
            if dropped:
                self._dropped += 1
            self._spans.append(span)
            self._seq += 1
        if dropped:  # metric bump outside the ring lock (own lock inside)
            _spans_dropped_metric()

    def chrome_trace(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def events_since(self, cursor: int) -> "tuple[int, List[dict]]":
        """Incremental read: events appended after ``cursor`` (a value
        previously returned by this method; start from 0). Returns
        ``(new_cursor, events)``. Events that fell off the ring between
        reads are lost — the spool cadence bounds that window."""
        with self._lock:
            new = self._seq - cursor
            if new <= 0:
                return self._seq, []
            if new > len(self._spans):
                new = len(self._spans)
            tail = list(self._spans)[-new:] if new else []
            return self._seq, tail

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._dropped = 0


_dropped_counter = None


def _spans_dropped_metric():
    # Lazy: metrics imports config; keep profiling importable standalone.
    global _dropped_counter
    if _dropped_counter is None:
        from ray_tpu_torch.util.metrics import Counter
        _dropped_counter = Counter(
            "profiler_spans_dropped",
            "Spans evicted from the bounded span ring")
    _dropped_counter.inc()


_profiler = Profiler()


def get_profiler() -> Profiler:
    return _profiler


def dump_timeline(filename: Optional[str] = None) -> Any:
    """Chrome-tracing dump of recorded spans (``ray timeline``,
    ``state.py:419``). Returns the event list, or writes it to
    ``filename`` and returns the path. Safe while recording continues:
    the span list is snapshotted under the ring lock before writing."""
    trace = _profiler.chrome_trace()
    if filename is None:
        return trace
    # Atomic: a crash mid-dump must not leave a torn half-JSON file where
    # an operator expects a readable timeline (tmp + fsync + rename).
    from ray_tpu_torch.checkpoint.manifest import atomic_write_bytes
    atomic_write_bytes(filename, json.dumps(trace).encode())
    return filename


# -- device-side tracing ----------------------------------------------------

_device_trace = None  # (torch.profiler.profile, log_dir) while tracing


def start_device_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` trace: CUDA activity where a card is
    present, CPU operators always."""
    global _device_trace
    import torch
    if _device_trace is not None:
        raise RuntimeError("a device trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _device_trace = (prof, log_dir)


def stop_device_trace() -> Optional[str]:
    """Stop the trace and export it as a chrome trace into its
    ``log_dir``; returns the directory."""
    global _device_trace
    if _device_trace is None:
        raise RuntimeError("no device trace is running")
    (prof, log_dir), _device_trace = _device_trace, None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    return log_dir


class profile_span:
    """Context manager for user code spans (reference:
    ``ray.profiling.profile`` events, ``_raylet.pyx:1613``).

    Records under the REAL process identity (``observability.process_label``
    — daemons relabel to ``node:<hex8>``), and when tracing is on the span
    routes through :class:`observability.span` so user phases parent into
    the active distributed trace instead of floating beside it."""

    def __init__(self, name: str, cat: str = "user",
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._span = None

    def __enter__(self):
        # Lazy import: observability imports this module at load time.
        from ray_tpu_torch import observability
        if observability.ENABLED:
            # raylint: allow(span-leak) delegated CM: our __exit__ closes it
            self._span = observability.span(
                self.name, cat=self.cat, **(self.args or {}))
            self._span.__enter__()
        else:
            self._t0 = time.time()
        return self

    def __exit__(self, *exc_info):
        if self._span is not None:
            span, self._span = self._span, None
            return span.__exit__(*exc_info)
        from ray_tpu_torch import observability
        _profiler.record(self.name, self.cat,
                         pid=observability.process_label(),
                         start_s=self._t0, dur_s=time.time() - self._t0,
                         args=self.args)
