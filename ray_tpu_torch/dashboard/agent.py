"""Per-node reporter agent.

Parity with ``dashboard/agent.py:51`` + ``dashboard/modules/reporter``
(the psutil sampler): a daemon thread inside each host daemon samples
process + host stats from ``/proc`` (no psutil dependency) and publishes
them into the state service KV under namespace ``node_stats``, keyed by
node id. The dashboard head aggregates the blobs; entries carry a
timestamp so the head can mark stale reporters.
"""

from __future__ import annotations
import logging

import json
import os
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("ray_tpu")

_NS = b"node_stats"


def _read_proc_self_cpu_ticks() -> int:
    """utime+stime of this process, in clock ticks."""
    with open("/proc/self/stat") as f:
        parts = f.read().split()
    return int(parts[13]) + int(parts[14])


def _read_rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _read_meminfo() -> Dict[str, float]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                if k in ("MemTotal", "MemAvailable"):
                    out[k] = int(v.split()[0]) / 1024.0  # MiB
    except OSError:
        pass
    return out


class NodeReporterAgent:
    """Samples this daemon's process + host stats and publishes to the
    state-service KV. One per host daemon; started by ``host_daemon`` and
    stopped with the runtime."""

    def __init__(self, runtime, interval_s: float = 2.0):
        self.runtime = runtime
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_ticks = _read_proc_self_cpu_ticks()
        self._last_ts = time.monotonic()
        self._clk = os.sysconf("SC_CLK_TCK")

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-reporter")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def sample(self) -> Dict[str, Any]:
        now = time.monotonic()
        ticks = _read_proc_self_cpu_ticks()
        dt = max(1e-6, now - self._last_ts)
        cpu_pct = 100.0 * (ticks - self._last_ticks) / self._clk / dt
        self._last_ticks, self._last_ts = ticks, now
        stats: Dict[str, Any] = {
            "ts": time.time(),
            "pid": os.getpid(),
            "cpu_percent": round(cpu_pct, 1),
            "rss_mb": round(_read_rss_mb(), 1),
            "load_avg": list(os.getloadavg()),
            "mem": _read_meminfo(),
        }
        rt = self.runtime
        try:
            store = rt.local_node.store
            stats["object_store"] = {
                "num_objects": len(getattr(store, "_entries", {})),
            }
        except Exception as e:
            logger.debug("object-store stats failed: %s", e)
        arena = getattr(rt, "host_arena", None)
        if arena is not None:
            try:
                used, cap, count = arena.stats()
                stats["arena"] = {"used_mb": round(used / 1048576, 1),
                                  "capacity_mb": round(cap / 1048576, 1),
                                  "objects": count,
                                  "owner": rt._arena_is_owner}
            except Exception as e:
                logger.debug("arena stats failed: %s", e)
        try:
            avail = rt.local_node.resources.available.to_dict()
            total = rt.local_node.resources.total.to_dict()
            stats["resources"] = {"available": avail, "total": total}
        except Exception as e:
            logger.debug("resource stats failed: %s", e)
        monitor = getattr(rt, "memory_monitor", None)
        if monitor is not None:
            try:
                stats["memory_monitor"] = monitor.snapshot()
            except Exception as e:
                logger.debug("memory-monitor stats failed: %s", e)
        try:
            from ray_tpu_torch.observability import recorder as _flight
            rec = _flight.get_recorder()
            if rec is not None:
                report = _flight.disk_report()
                stats["flight_recorder"] = {
                    "dir": rec.dir,
                    "recordings": len(report["recordings"]),
                    "sealed_bundles": len(report["bundles"]),
                }
        except Exception as e:
            logger.debug("flight-recorder stats failed: %s", e)
        return stats

    def publish_once(self):
        stats = self.sample()
        self.runtime.state.kv_put(
            self.runtime.local_node.node_id.binary(),
            json.dumps(stats).encode(), namespace=_NS)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.publish_once()
            except Exception as e:
                logger.debug("stats publish failed: %s", e)
                if self._stop.is_set():
                    return


def collect_node_stats(state_client) -> Dict[str, Dict[str, Any]]:
    """Head-side aggregation: node_id hex -> latest reporter blob."""
    out: Dict[str, Dict[str, Any]] = {}
    try:
        for key in state_client.kv_keys(namespace=_NS):
            blob = state_client.kv_get(key, namespace=_NS)
            if blob:
                try:
                    out[key.hex()] = json.loads(blob)
                except ValueError:
                    pass
    except Exception as e:
        logger.debug("cluster stats read failed: %s", e)
    return out
