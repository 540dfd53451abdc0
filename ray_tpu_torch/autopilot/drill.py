"""The autopilot A/B acceptance drill.

A deterministic, virtual-time miniature of the cluster: a 24-step train
loop degraded by a *fixed seeded chaos schedule* — a delayed data
reader, one slow collective rank — plus a misconfigured serve linger
window, rendered through the real telemetry merge math
(``goodput.merge_payloads``, ``comms.merge_payloads``, the perf
histogram shapes) into the exact snapshot the controller's policies
consume.  The drill then runs the *same* workload twice: once with the
autopilot ticking (private actuator registry + in-memory journal, never
the process ``_config``) and once without, and compares the merged
``goodput_pct``.  The autopilot arm must win strictly — that delta is
the ``autopilot_goodput_gain_pct`` row bench_micro gates in ``--check``
and ``run_sanitizers.sh`` drills in CI.

Everything is virtual: chaos ``drop`` actions are pure *triggers* (the
engine sleeps for ``delay``, never for ``drop``) whose magnitudes are
the model constants below, and the journal/controller clock is the
drill's own step clock — so the drill is instant, seeded, and
byte-stable across runs.  No real sockets, threads, or devices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch import chaos
from ray_tpu_torch.autopilot import actuators as _actuators
from ray_tpu_torch.autopilot.controller import Autopilot
from ray_tpu_torch.autopilot.journal import Journal
from ray_tpu_torch.observability import comms as _comms
from ray_tpu_torch.observability import goodput as _goodput

#: the fixed seeded schedule — tests golden-assert this exact string so
#: the acceptance run everyone reasons about is the one that executes
DRILL_SEED = 1303
DRILL_CHAOS_SPEC = ("drill.reader@1+=drop;"
                    "drill.collective[rank=1]@1+=drop")

#: virtual workload shape
STEPS = 24               # train steps per arm
TICK_EVERY = 2           # controller tick cadence, in steps
COMPUTE_S = 1.0          # useful compute per step
READER_WAIT_S = 0.4      # host batch assembly stall at prefetch depth 0
TRANSFER_BYTES = 256 * 1024 * 1024   # object traffic per step
STREAM_GBPS = 1.25       # per-stream transport rate (model)
COLLECTIVE_BYTES = 1 * 1024 ** 3     # logical allreduce payload per step
LINK_GBPS = 1.2          # collective wire rate — well under the busbw floor
WORLD_SIZE = 8
SKEW_S = 0.3             # the chaos-delayed rank's rendezvous lateness
CKPT_COST_S = 0.5        # checkpoint overhead charged per save
RESTART_COST_S = 0.0
MISCONFIGURED_CKPT_STEPS = 4     # operator left cadence far too dense
MISCONFIGURED_LINGER_MS = 50.0   # operator left serve linger at the cap
HAZARD_PER_HOUR = 6.0    # fleet hazard feed for the migrated cadence loop

#: compression scheme -> wire-bytes ratio (measured block-quant
#: framing: int8 payload + per-block fp32 scales)
WIRE_RATIO = {"none": 1.0, "q8": 0.27, "fp8": 0.145}
HIERARCHY_WIRE_FACTOR = 0.6   # per-host partials keep most bytes on-host
HIERARCHY_SKEW_FACTOR = 0.5   # the late rank only stalls its host group

#: the drill's own knob store — initial (misconfigured / default) values
DRILL_KNOBS = {
    "data_streams_per_peer": 1,
    "fetch_chunk_bytes": 4 * 1024 * 1024,
    "collective_compression": "none",
    "collective_ranks_per_host": 0,
    "data_prefetch_batches": 0,
    "checkpoint_cadence_autopilot_steps": 0,
}
LINGER_KNOB = "serve.drill.linger_ms"


class _Clock:
    """The drill's virtual step clock: the journal, the flap window and
    the decision TTLs all read it, so drill time is the only time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _step_costs(store: Dict[str, Any]) -> Dict[str, float]:
    """One virtual step under the current knobs.  Chaos actions are the
    triggers; the knob values set the magnitudes."""
    prefetch = int(store["data_prefetch_batches"])
    streams = int(store["data_streams_per_peer"])
    scheme = str(store["collective_compression"])
    rph = int(store["collective_ranks_per_host"])

    data_wait = 0.0
    if chaos.inject("drill.reader") == "drop":
        data_wait += READER_WAIT_S / (1.0 + prefetch)
    data_wait += TRANSFER_BYTES / (max(1, streams) * STREAM_GBPS * 1e9)

    wire = COLLECTIVE_BYTES * WIRE_RATIO[scheme]
    if rph > 1:
        wire *= HIERARCHY_WIRE_FACTOR
    collective_wait = wire / (LINK_GBPS * 1e9)
    if chaos.inject("drill.collective", rank="1") == "drop":
        skew = SKEW_S
        if rph > 1:
            skew *= HIERARCHY_SKEW_FACTOR
        collective_wait += skew

    interval = int(store["checkpoint_cadence_autopilot_steps"]) \
        or MISCONFIGURED_CKPT_STEPS
    ckpt_stall = CKPT_COST_S / max(1, interval)

    return {"compute": COMPUTE_S, "data_wait": data_wait,
            "collective_wait": collective_wait, "ckpt_stall": ckpt_stall}


def _window_snapshot(window: List[Dict[str, float]],
                     store: Dict[str, Any]) -> Dict[str, Any]:
    """Render a tick window of step costs into the controller's snapshot
    shape — through the real plane merge math, so the drill exercises
    the same payload contracts the dashboard head serves."""
    cats = {k: 0.0 for k in
            ("compute", "data_wait", "collective_wait", "ckpt_stall")}
    for step in window:
        for k, v in step.items():
            cats[k] += v
    wall = sum(cats.values())
    jobs = _goodput.merge_payloads([
        {"jobs": {"drill": {"wall_s": wall, "cats": cats}}}])

    streams = int(store["data_streams_per_peer"])
    chunk = int(store["fetch_chunk_bytes"])
    xfer_bytes = TRANSFER_BYTES * len(window)
    raw_comms = {
        "groups": {"drill": {
            "world_size": WORLD_SIZE, "seq": len(window), "mismatches": 0,
            "ops": {"allreduce": {
                "count": len(window),
                "bytes": COLLECTIVE_BYTES * len(window),
                "wire_bytes": int(COLLECTIVE_BYTES * len(window)
                                  * WIRE_RATIO[str(
                                      store["collective_compression"])]),
                "seconds": sum(s["collective_wait"] for s in window),
            }},
            "ranks": {},
        }},
        "links": {"drill-a|drill-b": {
            "bytes": xfer_bytes,
            "seconds": xfer_bytes / (max(1, streams) * STREAM_GBPS * 1e9),
            "chunks": max(1, xfer_bytes // max(1, chunk)),
            "retries": 0, "failovers": 0,
        }},
        "recent": [],
    }

    # sparse traffic: requests sit out the full linger window, and the
    # tail picks up scheduling jitter on top of it
    linger = float(store[LINGER_KNOB])
    perf = {"cluster": {"serve.queue_wait": {
        "count": 16.0 * len(window), "mean_ms": linger * 0.8,
        "p50_ms": linger * 0.8, "p95_ms": linger * 1.2,
        "p99_ms": linger * 1.4,
    }, "serve.execute": {
        "count": 16.0 * len(window), "mean_ms": 2.0,
        "p50_ms": 2.0, "p95_ms": 3.0, "p99_ms": 4.0,
    }}}

    return {
        "perf": perf,
        "goodput": {"jobs": jobs},
        "comms": _comms.merge_payloads([raw_comms]),
        "hazard_rate_per_hour": HAZARD_PER_HOUR,
        "cadence_inputs": {"step_cost_s": COMPUTE_S,
                           "ckpt_cost_s": CKPT_COST_S,
                           "restart_cost_s": RESTART_COST_S},
    }


def _dict_actuator(name: str, store: Dict[str, Any], *, kind: str,
                   lo: Optional[float] = None,
                   hi: Optional[float] = None) -> _actuators.Actuator:
    def _get(k=name, s=store):
        return s[k]

    def _set(v, k=name, s=store):
        s[k] = v
    return _actuators.Actuator(name=name, get=_get, set=_set, kind=kind,
                               lo=lo, hi=hi)


def run_arm(autopilot_on: bool) -> Dict[str, Any]:
    """One drill arm under a freshly installed copy of the fixed chaos
    schedule.  Returns the merged goodput, the final knob values, the
    serve queue p95 trajectory and (ON arm) the decision journal."""
    prev_schedule = chaos.schedule()
    chaos.configure(DRILL_SEED, DRILL_CHAOS_SPEC)
    try:
        store: Dict[str, Any] = dict(DRILL_KNOBS)
        store[LINGER_KNOB] = MISCONFIGURED_LINGER_MS
        clock = _Clock()
        reg = _actuators.ActuatorRegistry()
        _actuators.register_config_actuators(reg=reg, store=store)
        reg.register(_dict_actuator(LINGER_KNOB, store, kind="float",
                                    lo=1.0, hi=1000.0))
        journal = Journal(clock=clock)
        pilot = Autopilot(lambda: {}, journal=journal, reg=reg,
                          clock=clock)

        totals = {k: 0.0 for k in
                  ("compute", "data_wait", "collective_wait", "ckpt_stall")}
        window: List[Dict[str, float]] = []
        queue_p95: List[float] = []
        for step in range(1, STEPS + 1):
            costs = _step_costs(store)
            clock.t += sum(costs.values())
            for k, v in costs.items():
                totals[k] += v
            window.append(costs)
            if step % TICK_EVERY == 0:
                snapshot = _window_snapshot(window, store)
                queue_p95.append(float(store[LINGER_KNOB]) * 1.2)
                if autopilot_on:
                    pilot.tick(snapshot)
                window = []

        wall = sum(totals.values())
        merged = _goodput.merge_payloads([
            {"jobs": {"drill": {"wall_s": wall, "cats": totals}}}])
        return {
            "goodput_pct": float(merged["drill"]["goodput_pct"]),
            "wall_s": wall,
            "cats": totals,
            "knobs": dict(store),
            "queue_p95_ms": queue_p95,
            "journal": journal.tail(len(journal.records())),
            "ticks": pilot.ticks,
        }
    finally:
        if prev_schedule is not None:
            chaos.install(prev_schedule)
        else:
            chaos.clear()


def run_ab() -> Dict[str, Any]:
    """The acceptance drill: same workload, same chaos schedule, with
    and without the autopilot.  ``gain_pct`` must be strictly positive
    — bench_micro gates it and run_sanitizers drills it."""
    off = run_arm(autopilot_on=False)
    on = run_arm(autopilot_on=True)
    return {
        "off": off,
        "on": on,
        "gain_pct": on["goodput_pct"] - off["goodput_pct"],
    }
