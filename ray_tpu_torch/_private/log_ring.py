"""In-process log ring buffer.

The per-daemon half of the dashboard's log viewer (reference:
``dashboard/modules/log/log_agent.py:1`` tails worker log FILES; this
runtime's workers are threads of one daemon process, so the daemon keeps
its own recent log lines in memory and serves them over the NODE_DEBUG
RPC — no log-directory contract needed).

Each stored line carries the trace id that was active when it was
emitted (empty when tracing is off), so a NODE_DEBUG tail can be
filtered down to the log lines of ONE distributed trace.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import List, Optional

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def _active_trace_id() -> str:
    # Lazy import: log_ring installs very early; observability's one-bool
    # fast path keeps this near-free when tracing is off.
    try:
        from ray_tpu_torch import observability
        return observability.current_trace_id()
    except Exception:  # raylint: allow(swallow) cannot log from inside the log handler
        return ""


class RingLogHandler(logging.Handler):
    """Keeps the last ``capacity`` formatted log lines as
    ``(line, trace_id)`` pairs."""

    def __init__(self, capacity: int = 2000):
        super().__init__()
        self.setFormatter(logging.Formatter(_FMT))
        self._lock2 = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        # Monotonic append counter for incremental readers (the flight
        # recorder spools only lines it has not shipped yet).
        self._seq = 0

    def emit(self, record: logging.LogRecord):
        try:
            line = self.format(record)
            tid = _active_trace_id()
            if tid:
                line = f"{line} trace_id={tid}"
        except Exception:  # noqa: BLE001  # raylint: allow(swallow) cannot log from inside the log handler
            return
        with self._lock2:
            self._ring.append((line, tid))
            self._seq += 1

    def tail_since(self, cursor: int) -> "tuple[int, List[str]]":
        """Incremental tail: lines appended after ``cursor`` (previously
        returned by this method; start at 0). Lines that fell off the ring
        between reads are lost; returns ``(new_cursor, lines)``."""
        with self._lock2:
            new = self._seq - cursor
            if new <= 0:
                return self._seq, []
            if new > len(self._ring):
                new = len(self._ring)
            items = list(self._ring)[-new:] if new else []
            return self._seq, [it[0] for it in items]

    def tail(self, n: int, trace_id: str = "") -> List[str]:
        with self._lock2:
            items = list(self._ring)
        if trace_id:
            items = [it for it in items if it[1] == trace_id]
        lines = [it[0] for it in items]
        return lines[-n:] if n > 0 else []


_handler: Optional[RingLogHandler] = None
_install_lock = threading.Lock()


def install(capacity: int = 2000) -> RingLogHandler:
    """Attach the ring to the root logger (idempotent)."""
    global _handler
    with _install_lock:
        if _handler is None:
            _handler = RingLogHandler(capacity)  # raylint: allow(data-race) emit-path readers take a GIL-atomic snapshot; install is idempotent under _install_lock
            logging.getLogger().addHandler(_handler)
        return _handler


def tail(n: int, trace_id: str = "") -> List[str]:
    return _handler.tail(n, trace_id=trace_id) if _handler is not None else []


def tail_since(cursor: int) -> "tuple[int, List[str]]":
    if _handler is None:
        return cursor, []
    return _handler.tail_since(cursor)
