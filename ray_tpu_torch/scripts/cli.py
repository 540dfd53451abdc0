"""The ``ray_tpu_torch`` command line interface.

Parity with the reference's click CLI (``python/ray/scripts/scripts.py``:
``status`` :1461, ``memory`` :1820, ``timeline`` :1755, ``list`` via the
state CLI ``experimental/state/state_cli.py``). Attaches to a running
driver's state server through the session port file; ``start`` boots a
standalone head runtime that idles serving state (for smoke tests — the
normal entry point is ``ray_tpu_torch.init`` inside the driver).

Usage:
  python -m ray_tpu_torch.scripts.cli status
  python -m ray_tpu_torch.scripts.cli list tasks|actors|nodes|objects|pgs
  python -m ray_tpu_torch.scripts.cli summary
  python -m ray_tpu_torch.scripts.cli memory
  python -m ray_tpu_torch.scripts.cli timeline -o /tmp/trace.json
  python -m ray_tpu_torch.scripts.cli events
  python -m ray_tpu_torch.scripts.cli doctor --json
  python -m ray_tpu_torch.scripts.cli top --address HOST:PORT [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def _fetch(port: int, path: str):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read().decode())


def _port(args) -> int:
    if args.port:
        return args.port
    from ray_tpu_torch._private.state_server import discover_port
    port = discover_port()
    if port is None:
        print("No running ray_tpu_torch driver found (no state server port "
              "file). Start one with ray_tpu_torch.init().", file=sys.stderr)
        sys.exit(1)
    return port


def cmd_status(args):
    status = _fetch(_port(args), "/api/status")
    if not status.get("initialized"):
        print("ray_tpu_torch: not initialized")
        return
    nodes = status["nodes"]
    alive = sum(1 for n in nodes if n["state"] == "ALIVE")
    print(f"Nodes: {alive} alive / {len(nodes)} total")
    print("Resources:")
    avail = status["available_resources"]
    for k, v in sorted(status["cluster_resources"].items()):
        print(f"  {avail.get(k, 0.0):.1f}/{v:.1f} {k}")
    ts = status["task_summary"]
    print(f"Tasks: {ts['total']} total {ts['by_state']}")
    asum = status["actor_summary"]
    print(f"Actors: {asum['total']} total {asum['by_state']}")


def cmd_list(args):
    rows = _fetch(_port(args), f"/api/{args.what}")
    print(json.dumps(rows, indent=2, default=str))


def cmd_summary(args):
    status = _fetch(_port(args), "/api/status")
    print(json.dumps({"tasks": status.get("task_summary"),
                      "actors": status.get("actor_summary")}, indent=2))


def cmd_memory(args):
    objects = _fetch(_port(args), "/api/objects")
    print(f"{len(objects)} objects tracked")
    for o in objects[:args.limit]:
        print(f"  {o['object_id'][:16]} node={o['node_id'][:8]} "
              f"refs={o.get('ref_count')} in_store={o.get('in_store')}")


def cmd_timeline(args):
    trace = _fetch(_port(args), "/api/timeline")
    out = args.output or "ray-tpu-torch-timeline.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"Wrote {len(trace)} events to {out} "
          f"(open in chrome://tracing or Perfetto)")


def cmd_events(args):
    for ev in _fetch(_port(args), "/api/events")[-args.limit:]:
        print(json.dumps(ev, default=str))


def cmd_doctor(args):
    from ray_tpu_torch.doctor import main as doctor_main
    argv = []
    if args.flight_dir:
        argv += ["--flight-dir", args.flight_dir]
    if args.address:
        argv += ["--address", args.address]
    if args.json:
        argv += ["--json"]
    if args.no_seal:
        argv += ["--no-seal"]
    if args.output:
        argv += ["--out", args.output]
    if args.perf_baseline:
        argv += ["--perf-baseline", args.perf_baseline]
    if args.goodput_baseline:
        argv += ["--goodput-baseline", args.goodput_baseline]
    if args.comms_baseline:
        argv += ["--comms-baseline", args.comms_baseline]
    sys.exit(doctor_main(argv))


def cmd_drain(args):
    from ray_tpu_torch._private.state_client import StateClient
    client = StateClient(args.address)
    try:
        client.drain_node(bytes.fromhex(args.node_id),
                          reason=args.reason, deadline_s=args.deadline_s)
    finally:
        client.close()
    print(f"node {args.node_id[:16]} -> DRAINING "
          f"(reason={args.reason!r}, deadline_s={args.deadline_s or 'default'})")


def _top_rows(payload, subsystems=None):
    """Flatten an ``/api/perf`` payload into render rows:
    ``(node, name, summary, straggler)``.  A node is flagged a straggler
    on a histogram when its p95 is >= 3x the cluster median of the other
    nodes' p95 for that histogram (the doctor's outlier rule), with the
    same guards: at least 3 samples on the node and at least 2 reporting
    nodes."""
    import statistics
    nodes = payload.get("nodes", {})
    rows = []
    for name in sorted({n for per in nodes.values() for n in per}):
        subsystem = name.split(".", 1)[0]
        if subsystems and subsystem not in subsystems:
            continue
        p95s = [per[name]["p95_ms"] for per in nodes.values()
                if name in per]
        median = statistics.median(p95s) if p95s else 0.0
        for node in sorted(nodes):
            summ = nodes[node].get(name)
            if summ is None:
                # Partial federation: this node never recorded the
                # family (fresh node, subsystem not exercised there).
                # Emit a placeholder row — rendered as "—" — instead of
                # silently omitting the node from a filtered view.
                rows.append((node, name, None, False))
                continue
            straggler = (len(p95s) >= 2 and summ["count"] >= 3
                         and median > 0
                         and summ["p95_ms"] >= 3.0 * median)
            rows.append((node, name, summ, straggler))
    return rows


def _render_top(payload, subsystems=None) -> str:
    lines = ["%-14s %-22s %9s %9s %9s %9s %9s" % (
        "NODE", "HISTOGRAM", "COUNT", "MEAN_MS", "P50_MS", "P95_MS",
        "P99_MS")]
    for node, name, s, straggler in _top_rows(payload, subsystems):
        if s is None:  # family absent on this node: placeholder row
            lines.append("%-14s %-22s %9s %9s %9s %9s %9s" % (
                node, name, "—", "—", "—", "—", "—"))
            continue
        lines.append("%-14s %-22s %9d %9.2f %9.2f %9.2f %9.2f%s" % (
            node, name, int(s["count"]), s["mean_ms"], s["p50_ms"],
            s["p95_ms"], s["p99_ms"],
            "  <-- STRAGGLER (>=3x cluster median p95)"
            if straggler else ""))
    missing = payload.get("missing_hosts") or []
    if missing:
        lines.append(f"({len(missing)} unreachable host(s) omitted)")
    return "\n".join(lines)


def _render_goodput(payload) -> str:
    """Render an ``/api/goodput`` payload: per-job cluster totals first
    (the SLO view), then the per-node ledgers (the skew-triage view)."""
    cats = payload.get("categories") or []
    short = [c[:8] for c in cats]
    lines = ["%-14s %-10s %8s %8s " % ("NODE", "JOB", "WALL_S", "GOODPUT%")
             + " ".join("%8s" % s for s in short)]

    def fmt(label, job, rec):
        c = rec.get("cats") or {}
        return ("%-14s %-10s %8.1f %7.1f%% " % (
            label, job[:10], float(rec.get("wall_s", 0.0)),
            float(rec.get("goodput_pct", 0.0)))
            + " ".join("%8.2f" % float(c.get(k, 0.0)) for k in cats))

    for job, rec in sorted((payload.get("jobs") or {}).items()):
        lines.append(fmt("CLUSTER", job, rec))
    for node, jobs in sorted((payload.get("nodes") or {}).items()):
        for job, rec in sorted(jobs.items()):
            lines.append(fmt(node, job, rec))
    if len(lines) == 1:
        lines.append("(no goodput ledgers reported yet)")
    missing = payload.get("missing_hosts") or []
    if missing:
        lines.append(f"({len(missing)} unreachable host(s) omitted)")
    return "\n".join(lines)


def _render_comms(payload) -> str:
    """Render an ``/api/comms`` payload: the per-group op ledger (count,
    bytes, algbw/busbw over *wire* bytes, and the wire/logical
    compression ratio — 1.00 for uncompressed groups, ~0.27 for q8),
    the per-rank arrival-skew table with laggards marked, then the peer
    link matrix with outliers marked."""
    from ray_tpu_torch.observability import comms as comms_mod
    lines = ["%-14s %-14s %7s %10s %10s %10s %6s" % (
        "GROUP", "OP", "COUNT", "MB", "ALGBW_GB/S", "BUSBW_GB/S", "RATIO")]
    groups = payload.get("groups") or {}
    for gname, rec in sorted(groups.items()):
        for op, o in sorted((rec.get("ops") or {}).items()):
            nbytes = float(o.get("bytes", 0))
            wire = float(o.get("wire_bytes", nbytes) or nbytes)
            ratio = o.get("compression_ratio")
            if ratio is None:
                ratio = (wire / nbytes) if nbytes else 1.0
            lines.append("%-14s %-14s %7d %10.1f %10.2f %10.2f %6.2f" % (
                gname, op, int(o.get("count", 0)), nbytes / 1e6,
                float(o.get("algbw_gbps", 0.0)),
                float(o.get("busbw_gbps", 0.0)), float(ratio)))
        if rec.get("mismatches"):
            lines.append(f"  {gname}: {rec['mismatches']} fingerprint "
                         "mismatch(es) — divergent collective submissions")
    if len(lines) == 1:
        lines.append("(no collective ops recorded yet)")
    skew = comms_mod.skew_report(groups, bounds=payload.get("bounds"))
    flagged = {(f["group"], f["rank"])
               for f in payload.get("skew_flags") or []}
    if skew:
        lines.append("")
        lines.append("%-14s %-6s %9s %9s %9s" % (
            "GROUP", "RANK", "ARRIVALS", "SKEW_P50", "SKEW_P95"))
        for gname, ranks in sorted(skew.items()):
            for rank, s in sorted(ranks.items(), key=lambda kv: kv[0]):
                lines.append("%-14s %-6s %9d %8.2fms %8.2fms%s" % (
                    gname, rank, int(s["count"]), s["p50_ms"], s["p95_ms"],
                    "  <-- LAGGARD (>=3x peer median p95)"
                    if (gname, rank) in flagged else ""))
    links = payload.get("links") or {}
    if links:
        flagged_links = {f["link"] for f in payload.get("link_flags") or []}
        lines.append("")
        lines.append("%-22s %-14s %8s %8s %8s %9s" % (
            "PEER", "CONSUMER", "GB/S", "CHUNKS", "RETRIES", "FAILOVERS"))
        for key, rec in sorted(links.items()):
            peer, _, consumer = key.partition("|")
            lines.append("%-22s %-14s %8.2f %8d %8d %9d%s" % (
                peer, consumer, float(rec.get("gbps", 0.0)),
                int(rec.get("chunks", 0)), int(rec.get("retries", 0)),
                int(rec.get("failovers", 0)),
                "  <-- DEGRADED" if key in flagged_links else ""))
    missing = payload.get("missing_hosts") or []
    if missing:
        lines.append(f"({len(missing)} unreachable host(s) omitted)")
    return "\n".join(lines)


def cmd_top(args):
    """Live per-node/per-subsystem latency table off the perf plane
    (``--goodput``: the per-job wall-clock attribution ledger;
    ``--comms``: the collective telemetry + link matrix instead)."""
    import time
    from ray_tpu_torch._private.config import _config
    from ray_tpu_torch.dashboard.head import DashboardHead
    subsystems = set(args.subsystem) if args.subsystem else None
    head = DashboardHead(args.address)
    try:
        if args.comms:
            if args.json:
                print(json.dumps(head._comms(), indent=2))
                return
            interval = args.interval or \
                float(_config.get("perf_top_interval_s"))
            while True:
                payload = head._comms()
                print("\x1b[2J\x1b[H", end="")
                print(f"ray_tpu_torch top --comms — cluster {args.address} "
                      f"(refresh {interval:.1f}s, Ctrl-C to quit)")
                print(_render_comms(payload))
                time.sleep(interval)
        if args.goodput:
            if args.json:
                print(json.dumps(head._goodput(), indent=2))
                return
            interval = args.interval or \
                float(_config.get("perf_top_interval_s"))
            while True:
                payload = head._goodput()
                print("\x1b[2J\x1b[H", end="")
                print(f"ray_tpu_torch top --goodput — cluster {args.address} "
                      f"(refresh {interval:.1f}s, Ctrl-C to quit)")
                print(_render_goodput(payload))
                time.sleep(interval)
        if args.json:
            payload = head._perf()
            payload["stragglers"] = [
                {"node": node, "name": name}
                for node, name, _s, flag in _top_rows(payload, subsystems)
                if flag]
            if subsystems:
                for per in list(payload["nodes"].values()) + \
                        [payload["cluster"]]:
                    for name in [n for n in per
                                 if n.split(".", 1)[0] not in subsystems]:
                        del per[name]
            print(json.dumps(payload, indent=2))
            return
        interval = args.interval or float(_config.get("perf_top_interval_s"))
        while True:
            payload = head._perf()
            print("\x1b[2J\x1b[H", end="")
            print(f"ray_tpu_torch top — cluster {args.address} "
                  f"(refresh {interval:.1f}s, Ctrl-C to quit)")
            print(_render_top(payload, subsystems))
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        head.stop()


def cmd_dashboard(args):
    import time
    from ray_tpu_torch.dashboard import start_dashboard
    head = start_dashboard(args.address, port=args.dashboard_port,
                           host=args.host)
    print(f"dashboard at http://{args.host}:{head.port}/ "
          f"(cluster {args.address}); Ctrl-C to stop")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        head.stop()


def main(argv=None):
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    p.add_argument("--port", type=int, default=None,
                   help="state server port (default: session file)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status").set_defaults(fn=cmd_status)
    lp = sub.add_parser("list")
    lp.add_argument("what",
                    choices=["tasks", "actors", "nodes", "objects", "pgs"])
    lp.set_defaults(fn=cmd_list)
    sub.add_parser("summary").set_defaults(fn=cmd_summary)
    mp = sub.add_parser("memory")
    mp.add_argument("--limit", type=int, default=50)
    mp.set_defaults(fn=cmd_memory)
    tp = sub.add_parser("timeline")
    tp.add_argument("-o", "--output", default=None)
    tp.set_defaults(fn=cmd_timeline)
    ep = sub.add_parser("events")
    ep.add_argument("--limit", type=int, default=100)
    ep.set_defaults(fn=cmd_events)
    hp = sub.add_parser("doctor",
                        help="crash forensics + cluster health diagnosis")
    hp.add_argument("--flight-dir", default=None)
    hp.add_argument("--address", default=None,
                    help="state service host:port for live collection")
    hp.add_argument("--json", action="store_true")
    hp.add_argument("--no-seal", action="store_true")
    hp.add_argument("-o", "--output", default=None)
    hp.add_argument("--perf-baseline", default=None,
                    help="JSON quantile budgets; drift counts as issues")
    hp.add_argument("--goodput-baseline", default=None,
                    help="JSON goodput budgets (per-job goodput_pct "
                         "floors); drift counts as issues")
    hp.add_argument("--comms-baseline", default=None,
                    help="JSON comms budgets (per-group <op>_gbps floors, "
                         "skew_p95_ms/mismatches ceilings); drift counts "
                         "as issues")
    hp.set_defaults(fn=cmd_doctor)
    gp = sub.add_parser("drain",
                        help="gracefully drain a node (workload migration)")
    gp.add_argument("node_id", help="node id (hex, as shown by `list nodes`)")
    gp.add_argument("--address", required=True,
                    help="host:port of the cluster state service")
    gp.add_argument("--reason", default="operator")
    gp.add_argument("--deadline-s", type=float, default=0.0,
                    help="drain budget in seconds (0 = drain_deadline_s)")
    gp.set_defaults(fn=cmd_drain)
    op = sub.add_parser(
        "top", help="live per-node latency quantiles from the perf plane")
    op.add_argument("--address", required=True,
                    help="host:port of the cluster state service")
    op.add_argument("--json", action="store_true",
                    help="print one /api/perf snapshot as JSON and exit")
    op.add_argument("--interval", type=float, default=0.0,
                    help="refresh seconds (0 = perf_top_interval_s config)")
    op.add_argument("--subsystem", action="append", default=None,
                    help="filter to a subsystem prefix (rpc, task, fetch, "
                         "ckpt, serve, train, ...); repeatable")
    op.add_argument("--goodput", action="store_true",
                    help="show the per-job goodput ledger (/api/goodput) "
                         "instead of latency quantiles")
    op.add_argument("--comms", action="store_true",
                    help="show collective telemetry, rank arrival skew "
                         "and the peer link matrix (/api/comms) instead "
                         "of latency quantiles")
    op.set_defaults(fn=cmd_top)
    dp = sub.add_parser("dashboard",
                        help="serve the cluster dashboard UI")
    dp.add_argument("--address", required=True,
                    help="host:port of the cluster state service")
    dp.add_argument("--dashboard-port", type=int, default=8265)
    dp.add_argument("--host", default="127.0.0.1")
    dp.set_defaults(fn=cmd_dashboard)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
