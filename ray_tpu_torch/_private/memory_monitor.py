"""Host-memory OOM guard.

Parity with ``src/ray/common/memory_monitor.h:32`` (the raylet's
periodic usage monitor that triggers worker-killing above a usage
threshold), redesigned for the thread-worker daemon: there are no child
worker processes to kill, so the guard acts at ADMISSION — a daemon
whose host is above the memory-usage threshold spills pushed tasks back
to the caller, which re-routes them to a node that still has headroom
(and if none has, the caller's retry grace surfaces the pressure as a
scheduling error instead of the host OOM-killing the device owner).

Sampling reads ``/proc/meminfo`` (cgroup v2 limits honored when
``memory.max``/``memory.current`` are present — daemons routinely run
inside containers whose limit is far below the host's) plus this
process's RSS. Everything is configurable:

- ``memory_usage_threshold`` (default 0.95, fraction of usable memory)
- ``memory_monitor_refresh_ms`` (default 250; <= 0 disables the monitor)
"""

from __future__ import annotations
import logging

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.config import _config

logger = logging.getLogger("ray_tpu")


def _read_meminfo_kb() -> Dict[str, int]:
    out: Dict[str, int] = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                if k in ("MemTotal", "MemAvailable"):
                    out[k] = int(v.split()[0])
    except OSError:
        pass
    return out


def _read_cgroup_limit_bytes() -> Optional[int]:
    """cgroup v2 memory.max ("max" = unlimited), else None."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        return None if raw == "max" else int(raw)
    except (OSError, ValueError):
        return None


def _read_cgroup_current_bytes() -> Optional[int]:
    """Working-set usage: memory.current MINUS inactive_file. Raw
    memory.current counts reclaimable page cache, which would latch the
    guard permanently on any file-streaming workload; the reference
    monitor subtracts inactive_file for exactly this reason
    (``memory_monitor.cc`` GetCGroupMemoryUsedBytes)."""
    try:
        with open("/sys/fs/cgroup/memory.current") as f:
            current = int(f.read().strip())
    except (OSError, ValueError):
        return None
    inactive_file = 0
    try:
        with open("/sys/fs/cgroup/memory.stat") as f:
            for line in f:
                if line.startswith("inactive_file "):
                    inactive_file = int(line.split()[1])
                    break
    except (OSError, ValueError):
        pass
    return max(0, current - inactive_file)


def _read_self_rss_kb() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


class MemoryMonitor:
    """Periodic host/cgroup memory sampler with an over-threshold latch.

    ``usage_reader`` is injectable for tests: a callable returning
    ``(used_bytes, total_bytes)``.
    """

    def __init__(self, threshold: Optional[float] = None,
                 refresh_ms: Optional[float] = None,
                 usage_reader: Optional[Callable[[], tuple]] = None):
        self.threshold = (threshold if threshold is not None
                          else float(_config.get("memory_usage_threshold")))
        self.refresh_ms = (refresh_ms if refresh_ms is not None
                           else float(_config.get(
                               "memory_monitor_refresh_ms")))
        self._usage_reader = usage_reader or self._system_usage
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._used = 0  # raylint: guarded-by(self._lock)
        self._total = 0  # raylint: guarded-by(self._lock)
        self._over = False  # raylint: guarded-by(self._lock)
        self._sampled_at = 0.0
        if self.enabled:
            self._sample()  # first decision must not wait a full period

    @property
    def enabled(self) -> bool:
        return self.refresh_ms > 0

    @staticmethod
    def _system_usage() -> tuple:
        """(used_bytes, total_bytes) from the tighter of host meminfo
        and the cgroup limit."""
        info = _read_meminfo_kb()
        total = info.get("MemTotal", 0) * 1024
        avail = info.get("MemAvailable", 0) * 1024
        used = max(0, total - avail)
        climit = _read_cgroup_limit_bytes()
        if climit and (total == 0 or climit < total):
            ccur = _read_cgroup_current_bytes()
            if ccur is not None:
                return ccur, climit
        return used, total

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.refresh_ms / 1000.0):
            try:
                self._sample()
            except Exception as e:  # noqa: BLE001 - monitor must never die
                logger.debug("memory sample failed: %s", e)

    def _sample(self):
        used, total = self._usage_reader()
        with self._lock:
            self._used, self._total = used, total  # raylint: guarded-by(self._lock)
            self._over = bool(total) and (used / total) >= self.threshold
            self._sampled_at = time.monotonic()  # raylint: guarded-by(self._lock)

    # -- queries ---------------------------------------------------------
    def is_over_threshold(self) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            return self._over

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "threshold": self.threshold,
                "used_mb": round(self._used / (1 << 20), 1),
                "total_mb": round(self._total / (1 << 20), 1),
                "used_frac": (round(self._used / self._total, 4)
                              if self._total else 0.0),
                "rss_mb": round(_read_self_rss_kb() / 1024.0, 1),
                "over_threshold": self._over,
            }


_config.define("memory_usage_threshold", float, 0.95,
               "fraction of usable host/cgroup memory above which a "
               "daemon sheds new task admissions (OOM guard)")
_config.define("memory_monitor_refresh_ms", int, 250,
               "memory monitor sampling period; <= 0 disables it")
