"""Cluster health doctor: collect crash forensics, diagnose, explain.

``python -m ray_tpu_torch.doctor`` is the post-mortem / triage entry point on
top of the always-on flight recorder (:mod:`ray_tpu_torch.observability.
recorder`) and the dashboard's forensics federation:

1. **collect** — seal orphaned recordings on this machine (processes that
   died without running their hooks), inventory the local flight dir, and
   — when ``--address`` points at a live state service — pull every alive
   daemon's thread stacks, in-flight tasks, bundle inventory, metric
   snapshots and merged timeline through the same NODE_DEBUG fan-out the
   dashboard head serves.
2. **diagnose** — correlate: sealed bundles become crash reports carrying
   the in-flight trace_id, last spans/log/chaos lines and breaker/
   heartbeat state at death; ``heartbeat_consecutive_misses > 0`` plus
   live stacks flags a hang; cross-process task-span outliers flag
   stragglers; hosts the head could not reach are called out.
3. **render** — human-readable diagnosis, or ``--json`` for machines.

The doctor holds no state and never needs the cluster to be healthy: with
no ``--address`` it still reads (and seals) whatever the dead processes
left on disk.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

__all__ = ["collect", "diagnose", "explain_knob", "render_explain",
           "render_text", "main"]


def collect(flight_dir: Optional[str] = None,
            address: Optional[str] = None,
            seal: bool = True) -> dict:
    """Gather everything diagnosable. Local disk always; cluster-wide
    live state only when ``address`` (state-service host:port) is given.
    Collection never raises for a sick cluster — per-source errors land
    in ``errors`` and diagnosis runs on what was reachable."""
    from ray_tpu_torch.observability import recorder as _flight
    out: Dict[str, Any] = {"ts": time.time(), "errors": []}
    sealed_now: List[str] = []
    if seal:
        try:
            sealed_now = _flight.seal_orphans(root=flight_dir,
                                              sealed_by="doctor")
        except Exception as e:  # noqa: BLE001
            out["errors"].append(f"seal_orphans: {e!r}")
    out["sealed_now"] = sealed_now
    try:
        out["local"] = _flight.disk_report(root=flight_dir)
    except Exception as e:  # noqa: BLE001
        out["errors"].append(f"disk_report: {e!r}")
        out["local"] = {"root": flight_dir or "", "recordings": [],
                        "bundles": []}
    out["cluster"] = None
    if address:
        from ray_tpu_torch.dashboard.head import DashboardHead
        head = DashboardHead(address)  # API methods only; never start()ed
        try:
            cluster: Dict[str, Any] = {}
            for key, fetch in (
                    ("nodes", head._cluster),
                    ("forensics", head._forensics),
                    ("timeline", head._timeline)):
                try:
                    cluster[key] = fetch()
                except Exception as e:  # noqa: BLE001
                    out["errors"].append(f"{key}: {e!r}")
                    cluster[key] = None
            try:
                snaps, missing = head._metric_snapshots()
                cluster["metrics"] = {"snapshots": snaps,
                                      "missing_hosts": missing}
            except Exception as e:  # noqa: BLE001
                out["errors"].append(f"metrics: {e!r}")
                cluster["metrics"] = None
            try:
                cluster["drain"] = _drain_progress(head.state)
            except Exception as e:  # noqa: BLE001
                out["errors"].append(f"drain: {e!r}")
                cluster["drain"] = None
            try:
                cluster["preempt"] = _preempt_signals(head.state)
            except Exception as e:  # noqa: BLE001
                out["errors"].append(f"preempt: {e!r}")
                cluster["preempt"] = None
            try:
                cluster["autopilot"] = _autopilot_journal(head.state)
            except Exception as e:  # noqa: BLE001
                out["errors"].append(f"autopilot: {e!r}")
                cluster["autopilot"] = None
            out["cluster"] = cluster
        finally:
            head.stop()
    return out


def _drain_progress(state) -> Dict[str, dict]:
    """Per-node migration progress published by drain orchestrators into
    the state-service KV (namespace ``drain``, key ``progress:<node_id>``):
    phase, tasks still pending, actors checkpointed, objects migrated."""
    progress: Dict[str, dict] = {}
    for key in state.kv_keys(prefix=b"progress:", namespace=b"drain"):
        val = state.kv_get(key, namespace=b"drain")
        if not val:
            continue
        try:
            progress[key[len(b"progress:"):].hex()] = json.loads(val)
        except (ValueError, UnicodeDecodeError):
            continue
    return progress


def _preempt_signals(state) -> Dict[str, Any]:
    """Preemption-plane health from the state KV (``preempt`` namespace,
    autoscaler/hazard.py layout): per-node consecutive probe failures
    published by each host daemon's watcher, and the hazard estimator's
    last published fleet rate."""
    from ray_tpu_torch.autoscaler import hazard as _hazard
    probes: Dict[str, int] = {}
    for key in state.kv_keys(prefix=_hazard.PROBE_PREFIX,
                             namespace=_hazard.NAMESPACE):
        val = state.kv_get(key, namespace=_hazard.NAMESPACE)
        if not val:
            continue
        try:
            probes[key[len(_hazard.PROBE_PREFIX):].decode()] = int(
                json.loads(val).get("failures") or 0)
        except (ValueError, UnicodeDecodeError):
            continue
    return {"probe_failures": probes,
            "fleet_rate_per_hour": _hazard.read_fleet_rate(state)}


def _autopilot_journal(state) -> Dict[str, Any]:
    """The autopilot's decision journal replayed from the state KV
    (``autopilot`` namespace, journal.py layout): every knob change the
    controller made, with the evidence snapshot, guardrail bounds and
    old->new values it journaled at decision time.  This is what
    ``--explain <knob>`` renders."""
    from ray_tpu_torch._private.config import _config
    from ray_tpu_torch.autopilot import journal as _journal
    records = _journal.read_from_state(state)
    window_s = float(_config.get("autopilot_flap_window_s"))
    return {
        "decisions": records,
        "flapping": _journal.flap_counts(records, window_s),
        "flap_window_s": window_s,
    }


def _node_states(collected: dict) -> Dict[str, str]:
    """node_id(hex) -> lifecycle state, from the live cluster view
    (empty when collection ran disk-only)."""
    states: Dict[str, str] = {}
    cluster = collected.get("cluster") or {}
    for n in ((cluster.get("nodes") or {}).get("nodes") or []):
        nid = n.get("node_id", "")
        states[nid] = (n.get("state")
                       or ("ALIVE" if n.get("alive") else "DEAD"))
    return states


def _all_bundles(collected: dict) -> List[dict]:
    """Every sealed bundle the collection saw, deduped: the local disk
    report plus each daemon's NODE_DEBUG ``include_bundles`` payload
    (which on a single test machine usually point at the same dirs)."""
    seen = set()
    bundles: List[dict] = []

    def add(b: dict):
        key = (b.get("dir") or "", b.get("pid"), b.get("sealed_ts"))
        if key in seen:
            return
        seen.add(key)
        bundles.append(b)

    for b in (collected.get("local") or {}).get("bundles") or []:
        add(b)
    cluster = collected.get("cluster") or {}
    forensics = cluster.get("forensics") or {}
    for payload in (forensics.get("nodes") or {}).values():
        for b in ((payload.get("forensics") or {}).get("bundles") or []):
            add(b)
    return bundles


def _crash_reports(bundles: List[dict]) -> List[dict]:
    reports = []
    for b in bundles:
        if b.get("clean"):
            continue
        inflight = b.get("inflight") or {}
        chaos_tail = b.get("chaos") or []
        state = b.get("state") or {}
        reports.append({
            "role": b.get("role", "?"),
            "label": b.get("label", ""),
            "pid": b.get("pid"),
            "dir": b.get("dir", ""),
            "exit_reason": b.get("exit_reason", "?"),
            "sealed_by": b.get("sealed_by", "?"),
            "sealed_ts": b.get("sealed_ts"),
            "trace_ids": b.get("trace_ids") or [],
            "inflight_tasks": [
                {"task_id": tid, "name": t.get("name", "?"),
                 "trace_id": t.get("trace_id", "")}
                for tid, t in sorted(inflight.items())],
            "chaos_spec": b.get("chaos_spec", ""),
            "chaos_points_fired": chaos_tail[-8:],
            "heartbeat_misses": state.get("heartbeat_misses"),
            "last_logs": (b.get("logs") or [])[-5:],
            "last_spans": [s.get("name") for s in
                           (b.get("spans") or [])[-5:]],
            "exception": (b.get("exception") or {}).get("type", ""),
            "faulthandler": bool(b.get("faulthandler")),
        })
    reports.sort(key=lambda r: r.get("sealed_ts") or 0)
    return reports


def _hang_reports(collected: dict) -> List[dict]:
    """Heartbeat-miss-triggered hang detection: any node whose
    ``heartbeat_consecutive_misses`` gauge is nonzero is sampled — its
    live thread stacks (already in the forensics fan-out) say where it
    is stuck. A DRAINING node missing heartbeats is NOT a hang — it is
    mid-migration and about to decommission — so those entries are
    tagged ``expected`` and excluded from the issue count."""
    cluster = collected.get("cluster") or {}
    metrics = cluster.get("metrics") or {}
    snaps = metrics.get("snapshots") or {}
    forensics = cluster.get("forensics") or {}
    nodes = forensics.get("nodes") or {}
    states = _node_states(collected)
    hangs = []
    for src, families in snaps.items():
        for fam in families or []:
            if fam.get("name") != "heartbeat_consecutive_misses":
                continue
            for _name, tags, value in fam.get("samples") or []:
                if not value or value <= 0:
                    continue
                node_tag = dict(tags).get("node", src)
                stacks = {}
                inflight = {}
                for nid, payload in nodes.items():
                    if nid.startswith(node_tag) or \
                            node_tag.startswith(nid[:8]):
                        stacks = payload.get("stacks") or {}
                        inflight = payload.get("inflight") or {}
                        break
                node_state = ""
                for nid, st in states.items():
                    if nid.startswith(node_tag) or \
                            node_tag.startswith(nid[:8]):
                        node_state = st
                        break
                hangs.append({"node": node_tag, "source": src,
                              "consecutive_misses": value,
                              "expected": node_state == "DRAINING",
                              "node_state": node_state,
                              "inflight_tasks": sorted(
                                  t.get("name", "?")
                                  for t in inflight.values()),
                              "stacks": stacks})
    return hangs


def _straggler_reports(collected: dict,
                       factor: float = 3.0) -> List[dict]:
    """Cross-process step-time outliers: group completed task spans by
    name across ``pid`` rows of the merged timeline; a process whose
    mean duration exceeds ``factor`` × the cluster median (≥3 samples,
    ≥2 processes) is a straggler."""
    cluster = collected.get("cluster") or {}
    timeline = cluster.get("timeline") or {}
    events = timeline.get("traceEvents") or []
    by_name: Dict[str, Dict[str, List[float]]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "task":
            continue
        dur = ev.get("dur")
        if not dur:
            continue
        by_name.setdefault(ev.get("name", "?"), {}) \
            .setdefault(str(ev.get("pid", "?")), []).append(float(dur))
    out = []
    for name, per_pid in by_name.items():
        durs = [d for ds in per_pid.values() for d in ds]
        if len(durs) < 3 or len(per_pid) < 2:
            continue
        median = statistics.median(durs)
        if median <= 0:
            continue
        for pid, ds in per_pid.items():
            mean = sum(ds) / len(ds)
            if mean > factor * median:
                out.append({"task": name, "process": pid,
                            "mean_us": round(mean, 1),
                            "cluster_median_us": round(median, 1),
                            "slowdown": round(mean / median, 1),
                            "samples": len(ds)})
    out.sort(key=lambda r: -r["slowdown"])
    return out


def _perf_reports(collected: dict,
                  baseline: Optional[dict] = None) -> dict:
    """Perf-plane section: cluster-merged latency quantiles per
    histogram, recovered from the raw bucket counts riding the metric
    snapshots already collected — no extra wire round trip.

    ``baseline`` (the ``--perf-baseline`` JSON: ``{hist_name:
    {"p99_ms": budget, ..., "tolerance": 1.5}}``) turns the section
    into an SLO regression gate: any current quantile above
    ``budget * tolerance`` is a drift finding (counted as an issue)."""
    from ray_tpu_torch.observability import perf as perf_mod
    cluster = collected.get("cluster") or {}
    snaps = (cluster.get("metrics") or {}).get("snapshots") or {}
    agg: Dict[str, dict] = {}
    for families in snaps.values():
        for name, p in perf_mod.extract_perf(families or []).items():
            a = agg.setdefault(name, {"counts": [], "sum_ms": 0.0,
                                      "bounds": p.get("bounds")})
            a["counts"] = perf_mod.merge_counts(
                [a["counts"], [int(c) for c in p["counts"]]])
            a["sum_ms"] += float(p.get("sum_ms", 0.0))
    summaries = {name: perf_mod.summarize(a["counts"], a["sum_ms"],
                                          a["bounds"])
                 for name, a in sorted(agg.items())}
    drift = []
    for name, budgets in (baseline or {}).items():
        current = summaries.get(name)
        if current is None:
            continue
        tolerance = float(budgets.get("tolerance", 1.5))
        for key, base in budgets.items():
            if key == "tolerance" or key not in current:
                continue
            got = current[key]
            if got > float(base) * tolerance:
                drift.append({"hist": name, "metric": key,
                              "got_ms": round(got, 3),
                              "baseline_ms": float(base),
                              "tolerance": tolerance})
    return {"cluster": summaries, "drift": drift}


def _goodput_reports(collected: dict,
                     baseline: Optional[dict] = None) -> dict:
    """Goodput-ledger section: per-job wall-clock attribution merged
    across every node's ``"goodput"`` payload riding the already-
    collected metric snapshots.

    ``baseline`` (the ``--goodput-baseline`` JSON: ``{job: {"goodput_pct":
    floor, "restart_downtime_s": ceiling, "tolerance": 1.0}}``) turns the
    section into an efficiency-SLO gate: ``*_pct`` budgets are floors
    (goodput below ``floor * tolerance`` is a drift finding), ``*_s``
    budgets are ceilings on that category's merged seconds (above
    ``ceiling * tolerance`` drifts).  Both count as issues."""
    from ray_tpu_torch.observability import goodput as goodput_mod
    cluster = collected.get("cluster") or {}
    snaps = (cluster.get("metrics") or {}).get("snapshots") or {}
    payloads = []
    for families in snaps.values():
        p = goodput_mod.extract_goodput(families or [])
        if p:
            payloads.append(p)
    jobs = goodput_mod.merge_payloads(payloads)
    drift = []
    for job, budgets in (baseline or {}).items():
        rec = jobs.get(job)
        if rec is None:
            continue
        tolerance = float(budgets.get("tolerance", 1.0))
        for key, base in budgets.items():
            if key == "tolerance":
                continue
            if key.endswith("_pct"):
                got = float(rec.get("goodput_pct", 0.0))
                if got < float(base) * tolerance:
                    drift.append({"job": job, "metric": key,
                                  "got_pct": round(got, 2),
                                  "baseline_pct": float(base),
                                  "tolerance": tolerance})
            elif key.endswith("_s"):
                cat = key[:-2]
                got = float((rec.get("cats") or {}).get(cat, 0.0))
                if got > float(base) * tolerance:
                    drift.append({"job": job, "metric": key,
                                  "got_s": round(got, 3),
                                  "baseline_s": float(base),
                                  "tolerance": tolerance})
    return {"jobs": jobs, "drift": drift}


def _manifest_drift(groups: dict, manifest: Optional[dict],
                    tolerance: float = 1.0) -> List[dict]:
    """Cross-check the runtime collective ledger against the static plan
    raylint's R29 emits (``comms_manifest.json``).

    Every ledgered group/op with a nonzero count must appear in the
    manifest's ``groups`` table, either under its own group name or under
    the ``"*"`` wildcard (statically-unresolvable group names) —
    otherwise it is an *unplanned* collective and reports as drift.  For
    planned ops, a ``wire_ratio_max`` ceiling in the manifest entry gates
    the ledgered wire/logical ratio, and the predicted per-link bytes
    (ledger wire bytes x the shared busbw formula for the group's world
    size) ride along informationally on the entry.  Reused by
    ``_comms_reports`` (the ``__manifest__`` baseline key), the devtools
    tests, and run_sanitizers.sh's manifest-vs-ledger gate."""
    from ray_tpu_torch.observability import comms as comms_mod
    drift: List[dict] = []
    plan = (manifest or {}).get("groups") or {}
    wildcard = plan.get("*") or {}
    for gname, rec in sorted((groups or {}).items()):
        planned = dict(wildcard)
        planned.update(plan.get(gname) or {})
        world = int(rec.get("world_size") or 0)
        for op, o in sorted((rec.get("ops") or {}).items()):
            count = int(o.get("count") or 0)
            if count <= 0:
                continue
            ent = planned.get(op)
            if ent is None:
                drift.append({"group": gname,
                              "metric": f"{op}_unplanned",
                              "got": count, "baseline": 0.0,
                              "tolerance": tolerance})
                continue
            nbytes = float(o.get("bytes") or 0.0)
            wire = float(o.get("wire_bytes", nbytes) or nbytes)
            factor_fn = comms_mod._BUSBW.get(op, lambda n: 1.0)
            ent["predicted_link_bytes"] = round(wire * factor_fn(world), 1)
            ratio_max = ent.get("wire_ratio_max")
            if ratio_max is not None and nbytes:
                got = wire / nbytes
                if got > float(ratio_max) * tolerance:
                    drift.append({"group": gname,
                                  "metric": f"{op}_wire_ratio",
                                  "got_ratio": round(got, 4),
                                  "baseline_ratio": float(ratio_max),
                                  "tolerance": tolerance})
    return drift


def _comms_reports(collected: dict, baseline: Optional[dict] = None,
                   factor: float = 3.0) -> dict:
    """Comms-plane section: every node's ``"comms"`` payload (collective
    op ledger, per-rank arrival-skew histograms, link matrix) merged
    exactly, then attributed — ``skew_flags`` names a laggard rank whose
    p95 arrival skew is >= ``factor`` x the median of its peers,
    ``link_flags`` names a peer link with failovers or an outlier GB/s.

    ``baseline`` (the ``--comms-baseline`` JSON: ``{group: {"<op>_gbps":
    floor, "skew_p95_ms": ceiling, "mismatches": ceiling,
    "tolerance": 1.0}}``) turns the section into a bandwidth/skew SLO
    gate: ``*_gbps`` budgets are floors on the merged algorithm
    bandwidth (the ``allreduce_f32_gbps``-style gate the quantized-
    collective roadmap item compares against), ``skew_p95_ms`` and
    ``mismatches`` are ceilings, and ``"<op>_wire_ratio"`` budgets are
    ceilings on the merged wire/logical compression ratio — a quantized
    group drifting back toward 1.0 means compression silently stopped
    paying for itself.  Unknown groups in the baseline are ignored (a
    gate for a group that never ran is not a drift).  Flags and drift
    all count as issues.

    The special baseline key ``"__manifest__"`` (a path to raylint's
    ``comms_manifest.json`` or the inlined manifest dict) additionally
    cross-checks every ledgered group/op against the static collective
    plan via :func:`_manifest_drift`: ops the static analysis never
    planned report as ``<op>_unplanned`` drift."""
    from ray_tpu_torch.observability import comms as comms_mod
    cluster = collected.get("cluster") or {}
    snaps = (cluster.get("metrics") or {}).get("snapshots") or {}
    payloads = []
    for families in snaps.values():
        p = comms_mod.extract_comms(families or [])
        if p:
            payloads.append(p)
    merged = comms_mod.merge_payloads(payloads)
    groups, bounds = merged["groups"], merged["bounds"]
    skew = comms_mod.skew_flags(groups, factor=factor, bounds=bounds)
    links = comms_mod.link_flags(merged["links"], factor=factor)
    report = comms_mod.skew_report(groups, bounds=bounds)
    drift = []
    base = dict(baseline or {})
    manifest = base.pop("__manifest__", None)
    if isinstance(manifest, str):
        try:
            with open(manifest, encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            # a configured gate that cannot be read must fail loudly,
            # not silently pass
            drift.append({"group": "__manifest__",
                          "metric": "manifest_unreadable",
                          "got": 1, "baseline": 0.0, "tolerance": 1.0,
                          "error": str(e)})
            manifest = None
    if isinstance(manifest, dict):
        drift.extend(_manifest_drift(
            groups, manifest,
            tolerance=float(manifest.get("tolerance", 1.0))))
    for group, budgets in base.items():
        rec = groups.get(group)
        if rec is None:
            continue
        tolerance = float(budgets.get("tolerance", 1.0))
        for key, base in budgets.items():
            if key == "tolerance":
                continue
            if key.endswith("_gbps"):
                op = key[:-5]
                got = float(((rec.get("ops") or {}).get(op) or {})
                            .get("algbw_gbps", 0.0))
                if got < float(base) * tolerance:
                    drift.append({"group": group, "metric": key,
                                  "got_gbps": round(got, 3),
                                  "baseline_gbps": float(base),
                                  "tolerance": tolerance})
            elif key.endswith("_wire_ratio"):
                op = key[:-len("_wire_ratio")]
                o = ((rec.get("ops") or {}).get(op) or {})
                nbytes = float(o.get("bytes") or 0.0)
                wire = float(o.get("wire_bytes", nbytes) or nbytes)
                got = (wire / nbytes) if nbytes else 1.0
                if got > float(base) * tolerance:
                    drift.append({"group": group, "metric": key,
                                  "got_ratio": round(got, 4),
                                  "baseline_ratio": float(base),
                                  "tolerance": tolerance})
            elif key == "skew_p95_ms":
                ranks = report.get(group) or {}
                got = max((s["p95_ms"] for s in ranks.values()),
                          default=0.0)
                if got > float(base) * tolerance:
                    drift.append({"group": group, "metric": key,
                                  "got_ms": round(got, 3),
                                  "baseline_ms": float(base),
                                  "tolerance": tolerance})
            elif key == "mismatches":
                got = int(rec.get("mismatches") or 0)
                if got > float(base) * tolerance:
                    drift.append({"group": group, "metric": key,
                                  "got": got, "baseline": float(base),
                                  "tolerance": tolerance})
    return {"groups": groups, "links": merged["links"], "skew": report,
            "skew_flags": skew, "link_flags": links, "drift": drift}


def diagnose(collected: dict, straggler_factor: float = 3.0,
             perf_baseline: Optional[dict] = None,
             goodput_baseline: Optional[dict] = None,
             comms_baseline: Optional[dict] = None) -> dict:
    """Turn a :func:`collect` result into findings. Machine-readable;
    :func:`render_text` prints the same structure for humans."""
    crashes = _crash_reports(_all_bundles(collected))
    all_hangs = _hang_reports(collected)
    hangs = [h for h in all_hangs if not h.get("expected")]
    expected_hangs = [h for h in all_hangs if h.get("expected")]
    stragglers = _straggler_reports(collected, factor=straggler_factor)
    cluster = collected.get("cluster") or {}
    states = _node_states(collected)
    draining_ids = {nid for nid, st in states.items() if st == "DRAINING"}
    missing: List[dict] = []
    for key in ("forensics", "timeline"):
        for h in ((cluster.get(key) or {}).get("missing_hosts") or []):
            if all(m["node_id"] != h["node_id"] for m in missing):
                missing.append(h)
    for h in ((cluster.get("metrics") or {}).get("missing_hosts") or []):
        if all(m["node_id"] != h["node_id"] for m in missing):
            missing.append(h)
    # A DRAINING node that already quiesced its RPC server is expectedly
    # unreachable — mid-decommission, not an outage.
    missing = [m for m in missing
               if m.get("node_id", "") not in draining_ids]
    all_dead = [n for n in ((cluster.get("nodes") or {}).get("nodes")
                            or []) if not n.get("alive")]
    # "drained: <reason>" is the orchestrator's clean-decommission stamp —
    # the workloads were migrated, so the departure is not an issue.
    dead_nodes = [n for n in all_dead
                  if not (n.get("death_reason") or "").startswith("drained")]
    drained_nodes = [n for n in all_dead
                     if (n.get("death_reason") or "").startswith("drained")]
    progress = cluster.get("drain") or {}
    draining = []
    for n in ((cluster.get("nodes") or {}).get("nodes") or []):
        if n.get("state") != "DRAINING":
            continue
        nid = n.get("node_id", "")
        draining.append({"node_id": nid,
                         "drain_reason": n.get("drain_reason", ""),
                         "progress": progress.get(nid),
                         "heartbeat_misses": [
                             h["consecutive_misses"]
                             for h in expected_hangs
                             if nid.startswith(h["node"])
                             or h["node"].startswith(nid[:8])]})
    # A daemon whose preemption probe keeps failing is flying blind: the
    # real eviction notice may never be seen, so the node would die with
    # no drain at all.
    from ray_tpu_torch._private.config import _config
    preempt = cluster.get("preempt") or {}
    probe_threshold = _config.get("preempt_probe_failure_threshold")
    probe_flags = [
        {"node_id": nid, "consecutive_failures": n}
        for nid, n in sorted((preempt.get("probe_failures") or {}).items())
        if n >= probe_threshold]
    local = collected.get("local") or {}
    perf_section = _perf_reports(collected, baseline=perf_baseline)
    goodput_section = _goodput_reports(collected,
                                       baseline=goodput_baseline)
    comms_section = _comms_reports(collected, baseline=comms_baseline,
                                   factor=straggler_factor)
    # A flapping knob means the autopilot and the telemetry disagree
    # every few ticks — the controller froze it, and the operator should
    # know which policy is oscillating.
    autopilot_raw = cluster.get("autopilot") or {}
    decisions = autopilot_raw.get("decisions") or []
    flap_flags = [{"knob": k, "actuations": n}
                  for k, n in sorted(
                      (autopilot_raw.get("flapping") or {}).items())]
    reverts = [d for d in decisions if d.get("action") == "reverted"]
    autopilot_section = {
        "decisions": decisions,
        "reverts": reverts,
        "flap_flags": flap_flags,
        "flap_window_s": autopilot_raw.get("flap_window_s"),
    }
    n_issues = (len(crashes) + len(hangs) + len(stragglers) +
                len(missing) + len(dead_nodes) + len(probe_flags) +
                len(flap_flags) +
                len(perf_section["drift"]) +
                len(goodput_section["drift"]) +
                len(comms_section["skew_flags"]) +
                len(comms_section["link_flags"]) +
                len(comms_section["drift"]))
    return {
        "ts": collected.get("ts"),
        "healthy": n_issues == 0,
        "num_issues": n_issues,
        "perf": perf_section,
        "goodput": goodput_section,
        "comms": comms_section,
        "autopilot": autopilot_section,
        "crashes": crashes,
        "hangs": hangs,
        "stragglers": stragglers,
        "unreachable_hosts": missing,
        "preempt": preempt,
        "probe_flags": probe_flags,
        "draining_nodes": draining,
        "drained_nodes": [{"node_id": n.get("node_id", ""),
                           "death_reason": n.get("death_reason", "")}
                          for n in drained_nodes],
        "dead_nodes": [{"node_id": n.get("node_id", ""),
                        "death_reason": n.get("death_reason", "")}
                       for n in dead_nodes],
        "sealed_now": collected.get("sealed_now") or [],
        "flight_dir": local.get("root", ""),
        "recordings": len(local.get("recordings") or []),
        "bundles": len(local.get("bundles") or []),
        "collection_errors": collected.get("errors") or [],
    }


def render_text(report: dict) -> str:
    """Human-readable diagnosis of a :func:`diagnose` report."""
    lines = []
    lines.append("ray_tpu_torch doctor")
    lines.append(f"  flight dir: {report.get('flight_dir') or '(default)'}"
                 f"  recordings: {report.get('recordings', 0)}"
                 f"  sealed bundles: {report.get('bundles', 0)}")
    if report.get("sealed_now"):
        lines.append(f"  sealed {len(report['sealed_now'])} orphaned "
                     "recording(s) this run:")
        for p in report["sealed_now"]:
            lines.append(f"    {p}")
    crashes = report.get("crashes") or []
    if crashes:
        lines.append("")
        lines.append(f"CRASHES ({len(crashes)})")
        for c in crashes:
            who = c["label"] or c["role"]
            lines.append(f"  [{who} pid={c['pid']}] {c['exit_reason']}")
            lines.append(f"    sealed by: {c['sealed_by']}")
            if c.get("exception"):
                lines.append(f"    exception: {c['exception']}")
            for t in c["inflight_tasks"]:
                lines.append(
                    f"    in-flight: {t['name']} "
                    f"(task {t['task_id'][:8]}"
                    + (f", trace {t['trace_id']}" if t["trace_id"]
                       else "") + ")")
            if c["trace_ids"]:
                lines.append("    trace ids: " + ", ".join(c["trace_ids"]))
            if c["chaos_spec"]:
                lines.append(f"    chaos spec: {c['chaos_spec']}")
            for cl in c["chaos_points_fired"][-3:]:
                lines.append(f"    chaos fired: {cl}")
            if c.get("heartbeat_misses"):
                lines.append("    control plane already degraded: "
                             f"{c['heartbeat_misses']} consecutive "
                             "heartbeat misses at death")
            for log_line in c["last_logs"][-3:]:
                lines.append(f"    log: {log_line}")
    hangs = report.get("hangs") or []
    if hangs:
        lines.append("")
        lines.append(f"HANGS ({len(hangs)})")
        for h in hangs:
            lines.append(f"  node {h['node']}: "
                         f"{h['consecutive_misses']:.0f} consecutive "
                         "heartbeat misses")
            for name in h["inflight_tasks"]:
                lines.append(f"    in-flight: {name}")
            for tname in sorted(h.get("stacks") or {}):
                lines.append(f"    stack sampled: thread {tname}")
    probe_flags = report.get("probe_flags") or []
    if probe_flags:
        lines.append("")
        lines.append(f"BLIND PREEMPTION WATCHERS ({len(probe_flags)})")
        for p in probe_flags:
            lines.append(
                f"  node {p['node_id'][:8]}: "
                f"{p['consecutive_failures']} consecutive preempt-probe "
                "failures — an eviction notice may never be seen")
    draining = report.get("draining_nodes") or []
    if draining:
        lines.append("")
        lines.append(f"DRAINING ({len(draining)}) — migration in "
                     "progress, not an issue")
        for d in draining:
            lines.append(f"  node {d['node_id'][:8]}: "
                         f"{d.get('drain_reason') or '(no reason)'}")
            prog = d.get("progress") or {}
            if prog:
                lines.append(
                    f"    phase: {prog.get('phase', '?')}  "
                    f"tasks pending: {prog.get('tasks_pending', '?')}  "
                    f"actors checkpointed: "
                    f"{prog.get('actors_checkpointed', '?')}  "
                    f"objects migrated: "
                    f"{prog.get('objects_migrated', '?')}")
            for misses in d.get("heartbeat_misses") or []:
                lines.append(f"    {misses:.0f} heartbeat miss(es): "
                             "draining (expected)")
    drained = report.get("drained_nodes") or []
    if drained:
        lines.append("")
        lines.append(f"DRAINED NODES ({len(drained)}) — clean "
                     "decommission, workloads migrated")
        for n in drained:
            lines.append(f"  {n['node_id'][:8]}: {n['death_reason']}")
    stragglers = report.get("stragglers") or []
    if stragglers:
        lines.append("")
        lines.append(f"STRAGGLERS ({len(stragglers)})")
        for s in stragglers:
            lines.append(
                f"  {s['process']}: task {s['task']} mean "
                f"{s['mean_us']}us = {s['slowdown']}x the cluster "
                f"median ({s['cluster_median_us']}us, "
                f"{s['samples']} samples)")
    perf_section = report.get("perf") or {}
    quantiles = perf_section.get("cluster") or {}
    if quantiles:
        lines.append("")
        lines.append(f"PERF ({len(quantiles)} histogram(s), "
                     "cluster-merged)")
        for name, s in quantiles.items():
            lines.append(
                f"  {name}: n={s['count']:.0f} p50={s['p50_ms']:.2f}ms "
                f"p95={s['p95_ms']:.2f}ms p99={s['p99_ms']:.2f}ms")
    drift = perf_section.get("drift") or []
    if drift:
        lines.append("")
        lines.append(f"PERF DRIFT ({len(drift)}) — quantiles beyond "
                     "recorded baseline")
        for d in drift:
            lines.append(
                f"  {d['hist']}.{d['metric']}: {d['got_ms']}ms > "
                f"{d['baseline_ms']}ms x{d['tolerance']}")
    goodput_section = report.get("goodput") or {}
    gjobs = goodput_section.get("jobs") or {}
    if gjobs:
        lines.append("")
        lines.append(f"GOODPUT ({len(gjobs)} job(s), cluster-merged)")
        for job, rec in sorted(gjobs.items()):
            cats = rec.get("cats") or {}
            busy = ", ".join(
                f"{c}={cats[c]:.1f}s" for c in sorted(cats)
                if cats.get(c, 0.0) > 0.0)
            lines.append(
                f"  {job}: goodput {rec.get('goodput_pct', 0.0):.1f}% of "
                f"{rec.get('wall_s', 0.0):.1f} node-seconds "
                f"(compiles={rec.get('compile_count', 0)}, "
                f"recompiles={rec.get('recompile_count', 0)})")
            if busy:
                lines.append(f"    {busy}")
    gdrift = goodput_section.get("drift") or []
    if gdrift:
        lines.append("")
        lines.append(f"GOODPUT DRIFT ({len(gdrift)}) — efficiency "
                     "beyond recorded budget")
        for d in gdrift:
            if "got_pct" in d:
                lines.append(
                    f"  {d['job']}.{d['metric']}: {d['got_pct']}% < "
                    f"{d['baseline_pct']}% x{d['tolerance']}")
            else:
                lines.append(
                    f"  {d['job']}.{d['metric']}: {d['got_s']}s > "
                    f"{d['baseline_s']}s x{d['tolerance']}")
    comms_section = report.get("comms") or {}
    cgroups = comms_section.get("groups") or {}
    if cgroups:
        lines.append("")
        lines.append(f"COMMS ({len(cgroups)} group(s), cluster-merged)")
        for gname, rec in sorted(cgroups.items()):
            for op, o in sorted((rec.get("ops") or {}).items()):
                lines.append(
                    f"  {gname}.{op}: n={o.get('count', 0)} "
                    f"{o.get('bytes', 0) / 1e6:.1f}MB "
                    f"algbw={o.get('algbw_gbps', 0.0):.2f}GB/s "
                    f"busbw={o.get('busbw_gbps', 0.0):.2f}GB/s")
            if rec.get("mismatches"):
                lines.append(f"  {gname}: {rec['mismatches']} collective "
                             "fingerprint mismatch(es) — divergent ranks")
        for fl in comms_section.get("skew_flags") or []:
            lines.append(
                f"  LAGGARD {fl['group']} rank {fl['rank']}: arrival-skew "
                f"p95 {fl['p95_ms']:.1f}ms vs peer median "
                f"{fl['median_ms']:.1f}ms ({fl['samples']} samples)")
        for fl in comms_section.get("link_flags") or []:
            lines.append(
                f"  LINK {fl['peer']} ({fl['consumer']}): {fl['why']}")
    cdrift = comms_section.get("drift") or []
    if cdrift:
        lines.append("")
        lines.append(f"COMMS DRIFT ({len(cdrift)}) — bandwidth/skew/plan "
                     "beyond recorded budget")
        for d in cdrift:
            if "got_gbps" in d:
                lines.append(
                    f"  {d['group']}.{d['metric']}: {d['got_gbps']}GB/s < "
                    f"{d['baseline_gbps']}GB/s x{d['tolerance']}")
            elif "got_ms" in d:
                lines.append(
                    f"  {d['group']}.{d['metric']}: {d['got_ms']}ms > "
                    f"{d['baseline_ms']}ms x{d['tolerance']}")
            elif "got_ratio" in d:
                lines.append(
                    f"  {d['group']}.{d['metric']}: {d['got_ratio']} > "
                    f"{d['baseline_ratio']} x{d['tolerance']}")
            elif d["metric"].endswith("_unplanned"):
                lines.append(
                    f"  {d['group']}.{d['metric']}: {d['got']} op(s) "
                    "ledgered but absent from comms_manifest.json — "
                    "unplanned collective")
            else:
                lines.append(
                    f"  {d['group']}.{d['metric']}: {d['got']} > "
                    f"{d['baseline']} x{d['tolerance']}")
    ap = report.get("autopilot") or {}
    decisions = ap.get("decisions") or []
    if decisions or ap.get("flap_flags"):
        lines.append("")
        lines.append(f"AUTOPILOT ({len(decisions)} journaled "
                     "decision(s))")
        for d in decisions[-10:]:
            lines.append(
                f"  {d.get('action', '?'):8s} "
                f"{d.get('knob', '?')}: {d.get('old')} -> {d.get('new')}"
                + (f"  ({d.get('reason')})" if d.get("reason") else ""))
        reverts = ap.get("reverts") or []
        if reverts:
            lines.append(f"  {len(reverts)} change(s) auto-reverted on "
                         "SLO regression (see --explain <knob>)")
        for fl in ap.get("flap_flags") or []:
            lines.append(
                f"  FLAPPING {fl['knob']}: {fl['actuations']} actuations "
                f"inside {ap.get('flap_window_s', 0):.0f}s — frozen by "
                "the controller; policy and telemetry disagree")
    missing = report.get("unreachable_hosts") or []
    if missing:
        lines.append("")
        lines.append(f"UNREACHABLE HOSTS ({len(missing)})")
        for m in missing:
            lines.append(f"  {m['node_id'][:8]} @ {m['address']}: "
                         f"{m['error']}")
    dead = report.get("dead_nodes") or []
    if dead:
        lines.append("")
        lines.append(f"DEAD NODES ({len(dead)})")
        for n in dead:
            lines.append(f"  {n['node_id'][:8]}: "
                         f"{n['death_reason'] or '(no reason recorded)'}")
    errs = report.get("collection_errors") or []
    if errs:
        lines.append("")
        lines.append(f"COLLECTION ERRORS ({len(errs)})")
        for e in errs:
            lines.append(f"  {e}")
    lines.append("")
    if report.get("healthy"):
        lines.append("verdict: healthy — no crashes, hangs, stragglers "
                     "or unreachable hosts")
    else:
        lines.append(f"verdict: {report.get('num_issues')} issue(s) found")
    return "\n".join(lines) + "\n"


def explain_knob(report: dict, knob: str) -> dict:
    """Why does ``knob`` have its value?  Replays the autopilot journal
    for one knob: every decision with its evidence snapshot, the
    guardrail bounds in force, which changes were clamped or reverted,
    and whether the knob is currently flap-frozen."""
    ap = report.get("autopilot") or {}
    decisions = [d for d in (ap.get("decisions") or [])
                 if d.get("knob") == knob]
    flapping = next((fl for fl in (ap.get("flap_flags") or [])
                     if fl.get("knob") == knob), None)
    return {
        "knob": knob,
        "decisions": decisions,
        "reverts": [d for d in decisions
                    if d.get("action") == "reverted"],
        "current": decisions[-1].get("new") if decisions else None,
        "flapping": flapping,
        "flap_window_s": ap.get("flap_window_s"),
    }


def render_explain(explain: dict) -> str:
    """Human-readable decision history for one knob."""
    knob = explain.get("knob", "?")
    decisions = explain.get("decisions") or []
    lines = [f"ray_tpu_torch doctor --explain {knob}"]
    if not decisions:
        lines.append("  no journaled decisions — the autopilot never "
                     "touched this knob (or the journal expired)")
        return "\n".join(lines) + "\n"
    lines.append(f"  current value: {explain.get('current')}  "
                 f"({len(decisions)} decision(s), "
                 f"{len(explain.get('reverts') or [])} revert(s))")
    if explain.get("flapping"):
        fl = explain["flapping"]
        lines.append(
            f"  FLAPPING: {fl['actuations']} actuations inside "
            f"{explain.get('flap_window_s', 0):.0f}s — frozen by the "
            "controller; the policy and the telemetry disagree")
    for d in decisions:
        ts = d.get("ts")
        stamp = (time.strftime("%H:%M:%S", time.localtime(float(ts)))
                 if ts else "?")
        lines.append(f"  [{stamp}] {d.get('action', '?')}: "
                     f"{d.get('old')} -> {d.get('new')}")
        if d.get("reason"):
            lines.append(f"    why: {d['reason']}")
        if d.get("bounds"):
            lines.append(f"    guardrail bounds: {d['bounds']}")
        ev = d.get("evidence") or {}
        if ev:
            body = ", ".join(f"{k}={ev[k]}" for k in sorted(ev))
            lines.append(f"    evidence: {body}")
        if d.get("ttl_s"):
            lines.append(f"    claim TTL: {float(d['ttl_s']):.0f}s")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.doctor",
        description="Collect crash bundles + live cluster state and "
                    "diagnose crashes, hangs and stragglers.")
    parser.add_argument("--flight-dir", default=None,
                        help="flight recorder root (default: the "
                             "flight_recorder_dir config knob)")
    parser.add_argument("--address", default=None,
                        help="state service host:port for live "
                             "cluster-wide collection (omit for "
                             "disk-only post-mortem)")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report")
    parser.add_argument("--no-seal", action="store_true",
                        help="do not posthumously seal orphaned "
                             "recordings, only read")
    parser.add_argument("--out", default=None,
                        help="also write the JSON report to this file "
                             "(atomic)")
    parser.add_argument("--straggler-factor", type=float, default=3.0,
                        help="flag a process whose mean task time "
                             "exceeds this multiple of the cluster "
                             "median (default 3.0)")
    parser.add_argument("--perf-baseline", default=None,
                        help="JSON file of per-histogram quantile "
                             "budgets ({name: {p99_ms: X, tolerance: "
                             "1.5}}); quantiles beyond budget*tolerance "
                             "count as issues")
    parser.add_argument("--goodput-baseline", default=None,
                        help="JSON file of per-job goodput budgets "
                             "({job: {goodput_pct: floor, "
                             "restart_downtime_s: ceiling, tolerance: "
                             "1.0}}); budget violations count as issues")
    parser.add_argument("--explain", default=None, metavar="KNOB",
                        help="render the autopilot's decision journal "
                             "for one knob: evidence, guardrail bounds, "
                             "reverts and flap state (with --json the "
                             "explanation is embedded under 'explain')")
    parser.add_argument("--comms-baseline", default=None,
                        help="JSON file of per-group comms budgets "
                             "({group: {allreduce_gbps: floor, "
                             "skew_p95_ms: ceiling, mismatches: ceiling, "
                             "tolerance: 1.0}}); the special key "
                             "'__manifest__' (path to raylint's "
                             "comms_manifest.json, or the inlined "
                             "manifest) cross-checks the ledger against "
                             "the static collective plan — ledgered ops "
                             "absent from the plan report as unplanned "
                             "drift; budget violations count as issues")
    args = parser.parse_args(argv)
    perf_baseline = None
    if args.perf_baseline:
        with open(args.perf_baseline) as f:
            perf_baseline = json.load(f)
    goodput_baseline = None
    if args.goodput_baseline:
        with open(args.goodput_baseline) as f:
            goodput_baseline = json.load(f)
    comms_baseline = None
    if args.comms_baseline:
        with open(args.comms_baseline) as f:
            comms_baseline = json.load(f)
    try:
        collected = collect(flight_dir=args.flight_dir,
                            address=args.address,
                            seal=not args.no_seal)
        report = diagnose(collected,
                          straggler_factor=args.straggler_factor,
                          perf_baseline=perf_baseline,
                          goodput_baseline=goodput_baseline,
                          comms_baseline=comms_baseline)
    except Exception as e:  # noqa: BLE001
        print(f"doctor: collection failed: {e!r}", file=sys.stderr)
        return 2
    explain = None
    if args.explain:
        explain = explain_knob(report, args.explain)
        report["explain"] = explain
    if args.out:
        from ray_tpu_torch.checkpoint.manifest import atomic_write_bytes
        atomic_write_bytes(args.out,
                           json.dumps(report, indent=2).encode())
    if args.json:
        print(json.dumps(report, indent=2))
    elif explain is not None:
        print(render_explain(explain), end="")
    else:
        print(render_text(report), end="")
    return 0
