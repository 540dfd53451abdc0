"""Autopilot policies: telemetry in, knob proposals out.

Every policy is a pure function from the controller's snapshot (the
``/api/perf`` + ``/api/goodput`` + ``/api/comms`` payload shapes, plus
optional cadence inputs) and the current knob values to a list of
*proposals*.  A proposal is a plain dict::

    {"knob": name, "value": proposed, "reason": str,
     "evidence": {...},             # telemetry excerpt, journaled as-is
     "slo": {"kind": ..., ...}}     # what the post-change watch guards

Policies never actuate — the controller routes surviving proposals
through the guardrailed ``actuators.apply()`` path, arms the SLO watch,
and journals the outcome.  Keeping them pure keeps every tuning rule
unit-testable against fixed payloads and keeps the A/B drill honest:
the drill replays these exact functions, not a parallel model.

Policy catalog (the tentpole's four loops + the migrated cadence loop):

- :func:`serve_batch_policy` — shrink a misconfigured serve linger when
  the observed ``serve.queue_wait`` p95 blows the latency budget.
- :func:`transport_policy` — ``fetch_chunk_bytes`` down on failing
  links, ``data_streams_per_peer`` up on healthy saturated links: the
  lifelong successor to the one-shot loopback startup probe.
- :func:`collective_policy` — wire compression (none/q8/fp8) and the
  two-level hierarchy from ledgered busbw, gated by the operator's
  relative-error budget (EQuARX's measured-busbw scheme choice).
- :func:`prefetch_policy` — prefetch depth from the goodput ledger's
  ``data_wait`` attribution.
- :func:`cadence_policy` — the hazard->cadence loop, migrated:
  Young-Daly solve from the published fleet hazard rate, actuated as
  the ``checkpoint_cadence_autopilot_steps`` override and journaled
  with its evidence like every other decision.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import _config

#: compression scheme -> measured block-quantization relative error
#: (accuracy-delta gate measurements; the policy only selects a
#: scheme whose error fits the operator's budget)
SCHEME_REL_ERR = {"none": 0.0, "q8": 1.5e-3, "fp8": 1.2e-2}

Proposal = Dict[str, Any]
Getter = Callable[[str], Any]

_GOODPUT_SLO = {"kind": "goodput_pct"}


def _perf_hist(snapshot: Dict[str, Any], name: str) -> Dict[str, float]:
    return ((snapshot.get("perf") or {}).get("cluster") or {}).get(
        name) or {}


def serve_batch_policy(snapshot: Dict[str, Any], get: Getter,
                       linger_knobs: List[str]) -> List[Proposal]:
    """Serve linger from observed arrival shape: when requests wait in
    the batch queue far longer than they take to execute — the
    signature of a linger window tuned for traffic that is not there —
    halve the linger toward the measured execute time.  One-sided by
    design: growth would trade latency for packing on speculation; the
    decision TTL lets an expired shrink be re-examined instead."""
    queue = _perf_hist(snapshot, "serve.queue_wait")
    execute = _perf_hist(snapshot, "serve.execute")
    q95 = float(queue.get("p95_ms") or 0.0)
    budget_ms = float(_config.get("serve_target_latency_ms"))
    if not queue.get("count") or q95 <= 0.5 * budget_ms:
        return []
    evidence = {"queue_wait_p95_ms": q95,
                "execute_p50_ms": float(execute.get("p50_ms") or 0.0),
                "requests": float(queue.get("count") or 0.0),
                "target_latency_ms": budget_ms}
    out: List[Proposal] = []
    for knob in linger_knobs:
        cur = float(get(knob))
        if cur <= 1.0:
            continue  # already at the floor; nothing left to shrink
        out.append({"knob": knob, "value": max(1.0, cur / 2.0),
                    "reason": f"queue_wait p95 {q95:.1f}ms > 50% of the "
                              f"{budget_ms:.0f}ms latency budget",
                    "evidence": evidence,
                    "slo": {"kind": "perf_p95",
                            "hist": "serve.queue_wait"}})
    return out


def transport_policy(snapshot: Dict[str, Any],
                     get: Getter) -> List[Proposal]:
    """Per-peer link matrix -> stream/chunk tuning.  Failovers mean a
    stream died mid-chunk and its bytes were re-shipped elsewhere:
    smaller chunks bound the blast radius, so halve
    ``fetch_chunk_bytes``.  A clean matrix that still runs more chunks
    than streams can interleave earns one more stream per peer."""
    links = (snapshot.get("comms") or {}).get("links") or {}
    rated = [rec for rec in links.values() if isinstance(rec, dict)]
    if not rated:
        return []
    failovers = sum(int(r.get("failovers") or 0) for r in rated)
    retries = sum(int(r.get("retries") or 0) for r in rated)
    chunks = sum(int(r.get("chunks") or 0) for r in rated)
    secs = sum(float(r.get("seconds") or 0.0) for r in rated)
    gbps = (sum(int(r.get("bytes") or 0) for r in rated) / secs / 1e9
            if secs > 0 else 0.0)
    evidence = {"links": len(rated), "failovers": failovers,
                "retries": retries, "chunks": chunks,
                "aggregate_gbps": round(gbps, 3)}
    out: List[Proposal] = []
    if failovers > 0:
        cur = int(get("fetch_chunk_bytes"))
        if cur > 0:
            out.append({"knob": "fetch_chunk_bytes", "value": cur // 2,
                        "reason": f"{failovers} failover(s) in the link "
                                  "matrix: shrink the re-ship unit",
                        "evidence": evidence, "slo": _GOODPUT_SLO})
    elif retries == 0 and chunks > 0:
        streams = int(get("data_streams_per_peer"))
        # more chunks in flight than streams can interleave: one more
        # lane per peer until the matrix shows stress or the cap
        if streams >= 1 and chunks >= 4 * streams * max(1, len(rated)):
            out.append({"knob": "data_streams_per_peer",
                        "value": streams + 1,
                        "reason": f"{chunks} clean chunks over "
                                  f"{streams} stream(s)/peer: add a lane",
                        "evidence": evidence, "slo": _GOODPUT_SLO})
    return out


def collective_policy(snapshot: Dict[str, Any],
                      get: Getter) -> List[Proposal]:
    """Ledgered busbw + the rel-err budget -> wire scheme/hierarchy.
    A reduction op whose measured busbw sits under the configured floor
    is link-bound: first quantize the wire (q8, then fp8 if the budget
    allows), then decompose hierarchically so only per-host partials
    cross the slow seam."""
    groups = (snapshot.get("comms") or {}).get("groups") or {}
    floor = float(_config.get("autopilot_busbw_floor_gbps"))
    budget = float(_config.get("autopilot_rel_err_budget"))
    worst: Optional[Dict[str, Any]] = None
    for gname, g in sorted(groups.items()):
        for op in ("allreduce", "reducescatter"):
            rec = (g.get("ops") or {}).get(op)
            if not rec or not rec.get("count"):
                continue
            busbw = float(rec.get("busbw_gbps") or 0.0)
            if busbw >= floor:
                continue
            if worst is None or busbw < worst["busbw_gbps"]:
                worst = {"group": gname, "op": op, "busbw_gbps": busbw,
                         "world_size": int(g.get("world_size") or 0),
                         "bytes": int(rec.get("bytes") or 0),
                         "compression_ratio":
                             float(rec.get("compression_ratio") or 1.0)}
    if worst is None:
        return []
    evidence = dict(worst, busbw_floor_gbps=floor, rel_err_budget=budget)
    out: List[Proposal] = []
    scheme = str(get("collective_compression"))
    next_scheme = None
    if scheme == "none" and SCHEME_REL_ERR["q8"] <= budget:
        next_scheme = "q8"
    elif scheme == "q8" and SCHEME_REL_ERR["fp8"] <= budget and \
            worst["busbw_gbps"] < floor / 2.0:
        next_scheme = "fp8"
    if next_scheme is not None:
        out.append({"knob": "collective_compression", "value": next_scheme,
                    "reason": f"{worst['group']}.{worst['op']} busbw "
                              f"{worst['busbw_gbps']:.2f} < "
                              f"{floor:.1f} GB/s and "
                              f"{SCHEME_REL_ERR[next_scheme]:.0e} rel "
                              f"err fits the {budget:.0e} budget",
                    "evidence": evidence, "slo": _GOODPUT_SLO})
    elif scheme != "none":
        # wire already quantized and still slow: cross the seam with
        # per-host partials only
        rph = int(get("collective_ranks_per_host"))
        world = worst["world_size"]
        if rph == 0 and world >= 4 and world % 2 == 0:
            out.append({"knob": "collective_ranks_per_host", "value": 2,
                        "reason": f"{worst['group']}.{worst['op']} still "
                                  f"{worst['busbw_gbps']:.2f} GB/s under "
                                  "a quantized wire: go hierarchical",
                        "evidence": evidence, "slo": _GOODPUT_SLO})
    return out


def prefetch_policy(snapshot: Dict[str, Any],
                    get: Getter) -> List[Proposal]:
    """Prefetch depth from the ledger's ``data_wait`` attribution: a
    step loop that measurably waits on host-side batch assembly gets
    deeper prefetch; a loop that never waits gives depth back (idle
    prefetch threads hold block memory for nothing)."""
    jobs = (snapshot.get("goodput") or {}).get("jobs") or {}
    wall = sum(float(r.get("wall_s") or 0.0) for r in jobs.values())
    data_wait = sum(float((r.get("cats") or {}).get("data_wait") or 0.0)
                    for r in jobs.values())
    if wall <= 0.0:
        return []
    share = data_wait / wall
    cur = int(get("data_prefetch_batches"))
    evidence = {"data_wait_s": round(data_wait, 3),
                "wall_s": round(wall, 3),
                "data_wait_share": round(share, 4)}
    if share > 0.10:
        return [{"knob": "data_prefetch_batches", "value": cur + 2,
                 "reason": f"data_wait is {share:.0%} of wall",
                 "evidence": evidence, "slo": _GOODPUT_SLO}]
    if share < 0.01 and cur > 0:
        return [{"knob": "data_prefetch_batches", "value": cur - 1,
                 "reason": f"data_wait is {share:.1%} of wall: give a "
                           "prefetch slot back",
                 "evidence": evidence, "slo": _GOODPUT_SLO}]
    return []


def cadence_policy(snapshot: Dict[str, Any],
                   get: Getter) -> List[Proposal]:
    """The migrated hazard->cadence loop.  Same Young-Daly solver
    (:func:`ray_tpu_torch.checkpoint.cadence.solve_interval_steps`), but the
    decision now flows through the actuator layer: solved from the
    fleet hazard rate the autoscaler publishes plus the measured
    step/checkpoint costs, journaled with that evidence, actuated as
    the ``checkpoint_cadence_autopilot_steps`` override every
    ``CadenceController`` consults before its own local solve."""
    from ray_tpu_torch.checkpoint.cadence import solve_interval_steps
    hazard = snapshot.get("hazard_rate_per_hour")
    inputs = snapshot.get("cadence_inputs") or {}
    step_s = float(inputs.get("step_cost_s") or 0.0)
    ckpt_s = float(inputs.get("ckpt_cost_s") or 0.0)
    if hazard is None or step_s <= 0.0:
        return []  # no hazard feed or no step clock: keep local control
    hazard = float(hazard)
    interval = solve_interval_steps(
        hazard, step_s, ckpt_s,
        restart_cost_s=float(inputs.get("restart_cost_s") or 0.0))
    cur = int(get("checkpoint_cadence_autopilot_steps"))
    if interval == cur:
        return []
    return [{"knob": "checkpoint_cadence_autopilot_steps",
             "value": interval,
             "reason": f"Young-Daly at {hazard:.2f} preemptions/h",
             "evidence": {"hazard_rate_per_hour": hazard,
                          "step_cost_s": step_s, "ckpt_cost_s": ckpt_s,
                          "restart_cost_s":
                              float(inputs.get("restart_cost_s") or 0.0),
                          "solved_interval_steps": interval},
             "slo": _GOODPUT_SLO}]


def propose(snapshot: Dict[str, Any], get: Getter,
            actuator_names: List[str]) -> List[Proposal]:
    """Run every policy whose actuators are registered; proposals for
    unregistered knobs are dropped here, not at apply time."""
    names = set(actuator_names)
    linger = sorted(n for n in names
                    if n.startswith("serve.") and n.endswith(".linger_ms"))
    proposals: List[Proposal] = []
    proposals += serve_batch_policy(snapshot, get, linger)
    proposals += transport_policy(snapshot, get)
    proposals += collective_policy(snapshot, get)
    proposals += prefetch_policy(snapshot, get)
    proposals += cadence_policy(snapshot, get)
    return [p for p in proposals if p["knob"] in names]
