"""Seeded, deterministic fault injection for ray_tpu (see engine.py for the
spec grammar and determinism contract).

Call-site pattern — every injection point in the runtime is guarded by one
module-level bool so the disabled path costs a single attribute check::

    from ray_tpu_torch import chaos
    ...
    if chaos.ENABLED:
        if chaos.inject("rpc.client.send", peer=self.address) == "drop":
            return   # silently discard the frame

Activation:

- ``RAY_TPU_CHAOS=<seed>:<spec>`` in the environment (picked up at import,
  inherited by spawned daemons/workers so cluster-wide schedules work), or
- programmatically: ``chaos.configure(seed, spec)`` / ``chaos.install(
  schedule)`` / ``chaos.clear()``.

Injection-point catalog (the ``ARCHITECTURE.md`` "Failure model" section is
the authoritative doc):

====================  =====================================================
point                 labels / where
====================  =====================================================
rpc.client.connect    peer — RpcClient dial, before the TCP connect
rpc.client.send       peer, method — before a request/push frame is written
rpc.client.recv       peer — after a reply/push frame is read off the wire
rpc.server.recv       peer — server side, after a request frame is read
rpc.server.send       peer, method — before a reply frame is written
state.call            method — StateClient._call, before the RPC
state.reconnect       peer — StateClient._reconnect, before re-dialing
state.heartbeat       node — daemon heartbeat loop, before each beat
node.preempt          node — host daemon preemption watcher, per poll; a
                      "drop" return is the eviction notice (deterministic
                      stand-in for the metadata-server probe). For fleet
                      churn drills, :func:`preempt_storm_spec` builds the
                      periodic-trigger storm form
                      ``node.preempt@{M}%{M}=drop`` from a preemptions/
                      hour rate and the watcher poll period
object.push           peer, object — distributed pusher, per chunk
object.fetch          peer, object — distributed fetch, per source attempt
transport.stream      peer, consumer (object.fetch|drain.migrate|
                      ckpt.restore), offset — shared striped transport,
                      per chunk submission; "drop"/reset fails one stripe
                      so failover retries it on the surviving streams
object.store.get      object — local ObjectStore.get
task.execute          task, name — worker, before user code runs
checkpoint.write      path, rank — engine writer, before each chunk write
checkpoint.commit     stage (manifest|latest), step — rank-0 committer,
                      before the manifest rename / LATEST update
checkpoint.restore    manifest, rank — before chunks are read back
serve.replica.execute deployment, replica — serve replica, before the user
                      callable runs (both the direct path and the
                      micro-batcher's per-batch execution); "delay" makes
                      one replica serve slow — the latency-aware router
                      routes around it and the SLO autoscaler sees its
                      p95 — and "error" fails its requests
collective.op         group, op, rank — collective API entry
                      (ray_tpu.collective.*), before the op is issued; a
                      rank-filtered "delay" makes that rank arrive late
                      at the rendezvous, which the comms plane's
                      arrival-skew attribution must name
collective.quant      group, op, rank — compression tier
                      (collective/quantization.py), before one rank
                      block-quantizes its payload; "error" makes a
                      quantized op fail loudly (the rendezvous propagates
                      it to every rank) and a rank-filtered "delay"
                      stretches exactly the compression step, which the
                      ``collective.quantize`` perf histogram must show
autopilot.apply       knob — actuator layer (autopilot/actuators.py),
                      after the bounds clamp and before the knob write
                      lands; "error" must leave the previous value
                      intact and journal a ``failed`` decision
drill.reader          (no labels) — autopilot A/B drill synthetic input
                      pipeline; a "drop" return starves the reader for
                      one step (fixed schedule, both arms)
drill.collective      rank — autopilot A/B drill synthetic collective;
                      a rank-filtered "drop" return adds arrival skew
====================  =====================================================
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ray_tpu_torch.chaos.engine import (ChaosConnectionReset, ChaosError,
                                  FaultRule, FaultSchedule, parse_env,
                                  parse_spec, register_exit_hook)

__all__ = [
    "ENABLED", "ChaosError", "ChaosConnectionReset", "FaultRule",
    "FaultSchedule", "parse_spec", "parse_env", "configure", "install",
    "clear", "inject", "schedule", "set_observer", "trace_lines", "trace_text",
    "register_exit_hook", "preempt_storm_spec",
]

logger = logging.getLogger("ray_tpu")

#: Fast-path guard — False means every injection point is a no-op attribute
#: check. Only mutated via install()/clear().
ENABLED = False

_schedule: Optional[FaultSchedule] = None

#: Optional fault observer installed by ray_tpu.observability.enable():
#: called as fn(point, labels, action) after every fault that fires (the
#: action name, or the exception class name for raising actions). Kept as
#: a registration hook — chaos stays importable with zero non-stdlib deps.
_observer = None


def set_observer(fn) -> None:
    global _observer
    _observer = fn  # raylint: allow(data-race) observer installed once during chaos setup before faults fire


def install(sched: FaultSchedule) -> FaultSchedule:
    """Install ``sched`` as the process-wide schedule and enable injection."""
    global ENABLED, _schedule
    _schedule = sched  # raylint: allow(data-race) schedule installed once during chaos setup; inject() reads a GIL-atomic snapshot
    ENABLED = True
    return sched


def configure(seed: int, spec: str) -> FaultSchedule:
    """Compile ``spec`` with ``seed`` and install it."""
    return install(parse_spec(seed, spec))


def clear():
    """Disable injection and drop the schedule."""
    global ENABLED, _schedule
    ENABLED = False
    _schedule = None  # raylint: allow(data-race) uninstall is test teardown; inject() reads a GIL-atomic snapshot and tolerates None


def schedule() -> Optional[FaultSchedule]:
    return _schedule


def inject(point: str, **labels) -> Optional[str]:
    """Consult the schedule at a named injection point.

    Returns ``"drop"`` (caller discards the event), ``"delay"`` (the sleep
    already happened), or ``None`` (no fault). Raises
    :class:`ChaosConnectionReset` / :class:`ChaosError`, or exits the
    process, per the matched rule's action.
    """
    sched = _schedule
    if sched is None:
        return None
    obs = _observer
    if obs is None:
        return sched.fire(point, labels)
    try:
        action = sched.fire(point, labels)
    except BaseException as e:
        obs(point, labels, type(e).__name__)
        raise
    if action is not None:
        obs(point, labels, action)
    return action


def preempt_storm_spec(preempts_per_hour: float, poll_ms: float,
                       node: Optional[str] = None) -> str:
    """Spec fragment for a deterministic preemption storm.

    Converts a fleet churn rate (``preempts_per_hour``, per node matching
    the filter) and the preemption watcher's poll period into the periodic
    trigger form ``node.preempt[@M%M]=drop``: every M-th poll of the
    watcher returns an eviction notice, so the inter-preemption gap is
    ``M * poll_ms`` — the closest deterministic stand-in for a Poisson
    churn process that still replays bit-identically from the seed.
    Combine with other fragments via ``,`` and activate through
    ``RAY_TPU_CHAOS=<seed>:<spec>`` (daemons inherit the env).
    """
    if preempts_per_hour <= 0.0 or poll_ms <= 0.0:
        raise ValueError("preempt_storm_spec needs positive rate and poll")
    polls_per_hour = 3600_000.0 / poll_ms
    every = max(1, round(polls_per_hour / preempts_per_hour))
    key = f"[node={node}]" if node else ""
    return f"node.preempt{key}@{every}%{every}=drop"


def trace_lines():
    """Trace lines of the installed schedule ([] when none)."""
    sched = _schedule
    return sched.trace_lines() if sched is not None else []


def trace_text() -> str:
    sched = _schedule
    return sched.trace_text() if sched is not None else ""


def _init_from_env():
    value = os.environ.get("RAY_TPU_CHAOS")
    if not value:
        return
    try:
        install(parse_env(value))
    except ValueError:
        # A typo in the spec must not silently run the workload fault-free:
        # fail loudly at import.
        raise
    logger.warning("chaos: fault injection ENABLED from RAY_TPU_CHAOS=%s",
                   value)


_init_from_env()
