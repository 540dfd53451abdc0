"""Cross-host clock-offset estimation against the state-service clock.

Every daemon (and the driver) already heartbeats the state service, and the
ack carries ``server_time_ms`` — the service wall clock at reply
time. Pairing that beacon with the local send/recv stamps gives an
NTP-style sample: assuming the network path is roughly symmetric, the
server's stamp corresponds to the request's *midpoint*, so

    offset = (t_send + t_recv) / 2 - server_time

estimates this process's wall-clock lead over the service clock. Samples
taken under congestion are the noisy ones, so the estimator keeps a short
window and trusts the **lowest-RTT** sample in it (the classic NTP clock
filter): a fast round trip bounds the asymmetry error by rtt/2.

The offset makes cross-host latency spans meaningful: ``task.e2e`` compares
a submit stamp from one host against an execute stamp on another. The
submitter rebases its stamp to the service timebase (``to_server_s``) when
the spec crosses a process boundary and the executor rebases it back to
its own clock (``to_local_s``); with both hosts synced to the same beacon
the residual error is bounded by the two heartbeat RTTs instead of by raw
NTP drift between hosts. The current estimate is exported as the
``clock_skew_ms`` gauge so doctor/top can spot a host whose clock walks.

Fast path mirrors perf/goodput: ``ENABLED`` is a module bool read from the
``clock_sync_enabled`` config knob; everything is a no-op (offset 0.0)
when off or before the first sample.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ray_tpu_torch._private.config import _config

ENABLED = bool(_config.get("clock_sync_enabled"))

# NTP clock-filter window: enough beats (~8-16s at the default heartbeat
# interval) to ride out one congested burst, small enough to track a
# stepped clock within a few beats.
_WINDOW = 16

_lock = threading.Lock()
_samples: deque = deque(maxlen=_WINDOW)  # (rtt_s, offset_s)  # raylint: guarded-by(_lock)
_offset_s = 0.0
_synced = False
_gauge = None


def _skew_gauge():
    global _gauge
    if _gauge is None:
        from ray_tpu_torch.util import metrics as _metrics
        # raylint: allow(data-race) idempotent lazy gauge init; the metrics registry dedups by name
        _gauge = _metrics.Gauge(
            "clock_skew_ms",
            "estimated local wall-clock lead over the state-service clock "
            "(NTP-style, lowest-RTT heartbeat sample wins)")
    return _gauge


def observe(t_send_s: float, t_recv_s: float, server_time_s: float):
    """Feed one heartbeat exchange: local send/recv stamps (time.time())
    and the service's ``server_time_ms / 1e3`` beacon. ``server_time_s``
    <= 0 means the service predates the field — ignored."""
    global _offset_s, _synced
    if not ENABLED or server_time_s <= 0.0:
        return
    rtt = t_recv_s - t_send_s
    if rtt < 0.0:  # local clock stepped mid-exchange; sample is garbage
        return
    offset = (t_send_s + t_recv_s) / 2.0 - server_time_s
    with _lock:
        _samples.append((rtt, offset))
        # Lowest-RTT sample in the window is the least asymmetric one.
        _offset_s = min(_samples)[1]  # raylint: guarded-by(_lock)
        _synced = True
        est_ms = _offset_s * 1e3
    _skew_gauge().set(est_ms)


def offset_s() -> float:
    """Estimated local-clock lead over the service clock (0.0 until the
    first beacon lands)."""
    with _lock:
        return _offset_s


def synced() -> bool:
    with _lock:
        return _synced


def to_server_s(local_s: float) -> float:
    """Rebase a local time.time() stamp onto the service timebase."""
    return local_s - offset_s()


def to_local_s(server_s: float) -> float:
    """Rebase a service-timebase stamp onto this process's clock."""
    return server_s + offset_s()


def reset():
    """Forget all samples (tests / fork)."""
    global _offset_s, _synced
    with _lock:
        _samples.clear()
        _offset_s = 0.0
        _synced = False
