"""Dashboard head: HTTP UI + JSON API over the state service.

Parity with ``dashboard/head.py:63`` / ``state_aggregator.py``: a single
HTTP server that renders cluster state. Everything is read live from the
state service (tables + the ``node_stats`` reporter KV), so the head
can run in the driver, on the head node, or standalone against any
cluster address — it holds no state of its own.

Endpoints:
  /                 — self-contained HTML UI (polls the JSON API)
  /api/cluster      — nodes + reporter stats + resource totals
  /api/actors       — actor table
  /api/actor?id=X   — one actor's full record (drill-down)
  /api/pgs          — placement groups
  /api/jobs         — job table
  /api/stats        — state-service counters
  /api/node_debug?node=X&lines=N&tasks=1&trace=T
                    — per-daemon log tail + local task rows, fetched
                      live from the daemon over NODE_DEBUG (the log
                      viewer / task drill-down the reference serves via
                      dashboard/modules/log/log_agent.py); ``trace=T``
                      filters the log tail to one trace id
  /api/timeline     — merged chrome://tracing timeline: every alive
                      daemon's span ring (GET_TIMELINE fan-out) plus the
                      head's own, distinct pids per host. Partial
                      failures degrade, not error: hosts that could not
                      be reached are listed in ``missing_hosts``
  /api/trace?id=X   — one distributed trace's spans + instant events,
                      filtered out of the merged timeline
  /api/metrics      — per-host metric snapshots (NODE_DEBUG
                      include_metrics fan-out), JSON keyed by node,
                      with unreachable hosts in ``missing_hosts``
  /metrics          — the same federation rendered as one cluster-wide
                      Prometheus exposition, each sample labeled with
                      its source node; unreachable hosts surface as
                      ``federation_missing_hosts`` samples
  /api/perf         — perf-plane latency quantiles: per-node and
                      cluster-merged count/mean/p50/p95/p99 for every
                      perf histogram (rpc/task/fetch/ckpt/serve/...),
                      exact merge of the raw bucket counts riding the
                      metric federation
  /api/goodput      — goodput ledger federation: per-node per-job
                      wall-clock attribution (compute/compile/data_wait/
                      collective_wait/ckpt_stall/restart_downtime/idle)
                      merged into per-job category totals +
                      ``goodput_pct``, degrading with ``missing_hosts``
  /api/comms        — comms-plane federation: per-node collective
                      ledgers (per-group op bytes/duration/algbw/busbw,
                      per-rank arrival-skew histograms, fingerprint
                      mismatches, the StripedTransfer link matrix)
                      merged exactly, plus derived laggard-rank skew
                      flags and link outliers
  /api/profile?host=X&seconds=N
                    — federated sampling-profiler output (collapsed
                      stacks + pprof-shaped JSON). seconds=0 returns
                      cumulative profiles; seconds>0 diffs two
                      snapshots that far apart (the window's samples)
  /api/forensics    — cluster-wide crash forensics: every alive
                      daemon's live thread stacks, in-flight tasks and
                      on-disk flight recordings / sealed crash bundles
                      (NODE_DEBUG include_stacks+include_bundles
                      fan-out) plus the head's own — the wire the
                      health doctor (``python -m ray_tpu_torch.doctor``)
                      collects through
"""

from __future__ import annotations
import logging

import json
import threading
import time
import urllib.parse
from typing import Optional

from ray_tpu_torch.dashboard.agent import collect_node_stats

logger = logging.getLogger("ray_tpu")

_PAGE = """<!DOCTYPE html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:system-ui,sans-serif;margin:24px;background:#fafafa;color:#222}
h1{font-size:20px} h2{font-size:15px;margin-top:28px;color:#444}
table{border-collapse:collapse;width:100%;background:#fff;box-shadow:0 1px 2px #0002}
th,td{padding:6px 10px;border-bottom:1px solid #eee;text-align:left;font-size:13px}
th{background:#f0f0f3;font-weight:600}
.dead{color:#b00} .alive{color:#080}
#updated{color:#888;font-size:12px}
</style></head><body>
<h1>ray_tpu_torch cluster <span id=updated></span></h1>
<h2>Nodes</h2><table id=nodes></table>
<h2>Actors</h2><table id=actors></table>
<h2>Placement groups</h2><table id=pgs></table>
<h2>Jobs</h2><table id=jobs></table>
<h2>Node drill-down</h2>
<div>
  <select id=nodesel></select>
  <button onclick="drill()">fetch logs + tasks</button>
</div>
<h2 style="font-size:13px">Tasks on node</h2><table id=ntasks></table>
<h2 style="font-size:13px">Recent logs</h2>
<pre id=nlogs style="background:#111;color:#ddd;padding:10px;max-height:320px;overflow:auto;font-size:12px"></pre>
<script>
// all dynamic values are escaped: actor/class/label names are
// user-controlled and must not inject HTML into the viewer's page
function esc(v){return String(v).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function row(cells, tag){tag=tag||'td';return '<tr>'+cells.map(c=>'<'+tag+'>'+c+'</'+tag+'>').join('')+'</tr>'}
function rowe(cells, tag){return row(cells.map(esc), tag)}
async function refresh(){
  const c = await (await fetch('/api/cluster')).json();
  let h = row(['node','address','state','CPU','GPU','cpu%','rss MB','host mem','arena','objects'],'th');
  const sel = document.getElementById('nodesel');
  const cur = sel.value; sel.innerHTML='';
  for (const n of c.nodes){
    const s = n.stats||{}; const a = s.arena||{}; const mm = s.memory_monitor||{};
    const mem = mm.total_mb ? (mm.used_frac*100).toFixed(0)+'%'+(mm.over_threshold?' OOM-GUARD':'') :
      (s.mem&&s.mem.MemTotal ? (100*(1-s.mem.MemAvailable/s.mem.MemTotal)).toFixed(0)+'%' : '-');
    h += row([esc(n.node_id.slice(0,8)), esc(n.address),
      '<span class="'+(n.alive?'alive':'dead')+'">'+(n.alive?'ALIVE':'DEAD')+'</span>',
      esc((n.available.CPU??0)+'/'+(n.total.CPU??0)),
      esc((n.available.GPU??'-')+'/'+(n.total.GPU??'-')),
      esc(s.cpu_percent??'-'), esc(s.rss_mb??'-'), esc(mem),
      esc(a.capacity_mb? a.used_mb+'/'+a.capacity_mb+' MB'+(a.owner?' (owner)':'') : '-'),
      esc((s.object_store||{}).num_objects??'-')]);
    if (n.alive){
      const o = document.createElement('option');
      o.value = n.node_id; o.textContent = n.node_id.slice(0,8)+' @ '+n.address;
      sel.appendChild(o);
    }
  }
  if (cur) sel.value = cur;
  document.getElementById('nodes').innerHTML = h;
  const actors = await (await fetch('/api/actors')).json();
  let ah = row(['actor','class','state','node','restarts',''],'th');
  for (const x of actors) ah += row([esc(x.actor_id.slice(0,8)), esc(x.class_name),
    esc(x.state), esc((x.node_id||'').slice(0,8)), esc(x.num_restarts??0),
    '<a href="/api/actor?id='+encodeURIComponent(x.actor_id)+'" target=_blank>detail</a>']);
  document.getElementById('actors').innerHTML = ah;
  const pgs = await (await fetch('/api/pgs')).json();
  let ph = row(['pg','strategy','state','bundles'],'th');
  for (const p of pgs) ph += rowe([p.pg_id.slice(0,8), p.strategy, p.state, p.num_bundles]);
  document.getElementById('pgs').innerHTML = ph;
  const jobs = await (await fetch('/api/jobs')).json();
  let jh = row(['job','driver','state'],'th');
  for (const j of jobs) jh += rowe([j.job_id, j.driver_address, j.state]);
  document.getElementById('jobs').innerHTML = jh;
  document.getElementById('updated').textContent = 'updated '+new Date().toLocaleTimeString();
}
async function drill(){
  const nid = document.getElementById('nodesel').value;
  if (!nid) return;
  const d = await (await fetch('/api/node_debug?node='+encodeURIComponent(nid)+'&lines=200&tasks=1')).json();
  if (d.error){ document.getElementById('nlogs').textContent = d.error; return; }
  let th = row(['task','name','state'],'th');
  for (const t of (d.tasks||[])) th += rowe([t.task_id.slice(0,8), t.name, t.state]);
  document.getElementById('ntasks').innerHTML = th;
  document.getElementById('nlogs').textContent = (d.logs||[]).join('\\n') || '(no recent log lines)';
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class DashboardHead:
    """Serves the UI + API against one cluster's state service."""

    def __init__(self, state_addr: str, port: int = 0,
                 host: str = "127.0.0.1"):
        from ray_tpu_torch._private.rpc import ConnectionPool
        from ray_tpu_torch._private.state_client import StateClient
        self.state = StateClient(state_addr)
        self.pool = ConnectionPool()  # daemon connections for drill-down
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._host, self._want_port = host, port
        self.port: Optional[int] = None
        #: the cluster's closed-loop controller (ray_tpu_torch/autopilot/),
        #: hosted here next to the plane merges it consumes; started by
        #: start() when autopilot_enabled — after the serve thread is
        #: already up, so the handoff needs a real guard
        self._autopilot_lock = threading.Lock()
        # raylint: guarded-by(self._autopilot_lock)
        self.autopilot = None

    # -- API payloads ----------------------------------------------------
    def _cluster(self) -> dict:
        stats = collect_node_stats(self.state)
        nodes = []
        for n in self.state.list_nodes():
            nid = n.node_id.hex()
            nodes.append({
                "node_id": nid,
                "address": n.address,
                "alive": n.alive,
                "state": (n.state or ("ALIVE" if n.alive else "DEAD")),
                "drain_reason": n.drain_reason,
                "is_head": n.is_head,
                "total": dict(n.total.amounts),
                "available": dict(n.available.amounts),
                "labels": dict(n.labels),
                "death_reason": n.death_reason,
                "stats": stats.get(nid),
            })
        return {"ts": time.time(), "nodes": nodes}

    def _actors(self) -> list:
        return [{
            "actor_id": a.actor_id.hex(),
            "class_name": a.class_name,
            "state": a.state,
            "node_id": a.node_id.hex() if a.node_id else "",
            "name": a.name,
            "num_restarts": a.restart_count,
        } for a in self.state.list_actors()]

    def _pgs(self) -> list:
        return [{
            "pg_id": p.pg_id.hex(),
            "strategy": p.strategy,
            "state": p.state,
            "num_bundles": len(p.bundles),
        } for p in self.state.list_pgs()]

    def _jobs(self) -> list:
        return [{
            "job_id": j.job_id.hex(),
            "driver_address": j.driver_address,
            "state": j.state,
        } for j in self.state.list_jobs()]

    def _actor_detail(self, actor_id_hex: str) -> dict:
        for a in self.state.list_actors():
            if a.actor_id.hex() == actor_id_hex:
                return {
                    "actor_id": a.actor_id.hex(),
                    "class_name": a.class_name,
                    "state": a.state,
                    "node_id": a.node_id.hex() if a.node_id else "",
                    "address": a.address,
                    "name": a.name,
                    "namespace": a.namespace,
                    "num_restarts": a.restart_count,
                    "death_cause": getattr(a, "death_cause", ""),
                }
        return {"error": f"actor {actor_id_hex} not found"}

    def _node_debug(self, node_id_hex: str, lines: int,
                    include_tasks: bool, trace_filter: str = "") -> dict:
        from ray_tpu_torch.protocol import pb
        addr = next((n.address for n in self.state.list_nodes()
                     if n.node_id.hex() == node_id_hex and n.alive), None)
        if addr is None:
            return {"error": f"node {node_id_hex} not alive"}
        client = self.pool.get(addr)
        rep = pb.NodeDebugReply()
        rep.ParseFromString(client.call(
            pb.NODE_DEBUG, pb.NodeDebugRequest(
                log_lines=lines,
                include_tasks=include_tasks,
                trace_filter=trace_filter).SerializeToString(),
            timeout=15).body)
        out = json.loads(bytes(rep.payload_json).decode())
        out["node_id"] = node_id_hex
        out["address"] = addr
        return out

    # -- tracing / metrics federation ------------------------------------
    def _alive_addrs(self) -> list:
        return [(n.node_id.hex(), n.address)
                for n in self.state.list_nodes() if n.alive and n.address]

    def _timeline(self) -> dict:
        """One merged chrome://tracing event list: the head's own span
        ring plus every alive daemon's, pulled over GET_TIMELINE. Hosts
        keep distinct ``pid`` labels so the merged view separates them.
        A daemon that is registered alive but unreachable (dying, net
        partition) degrades into ``missing_hosts`` instead of failing
        the whole merge."""
        from ray_tpu_torch.protocol import pb
        from ray_tpu_torch._private.profiling import get_profiler
        events = list(get_profiler().chrome_trace())
        missing = []
        for nid, addr in self._alive_addrs():
            try:
                rep = pb.TimelineReply()
                rep.ParseFromString(self.pool.get(addr).call(
                    pb.GET_TIMELINE,
                    pb.TimelineRequest().SerializeToString(),
                    timeout=30).body)
                events.extend(json.loads(bytes(rep.spans_json).decode()))
            except Exception as e:
                logger.debug("dashboard: timeline fetch from %s failed: %s",
                             addr, e)
                missing.append({"node_id": nid, "address": addr,
                                "error": str(e)})
        return {"traceEvents": events, "missing_hosts": missing}

    def _trace(self, trace_id: str) -> dict:
        from ray_tpu_torch import observability
        if not trace_id:
            return {"error": "missing ?id=<trace_id>"}
        merged = self._timeline()
        events = observability.spans_for_trace(
            trace_id, merged["traceEvents"])
        events.sort(key=lambda e: e.get("ts", 0))
        return {"trace_id": trace_id, "num_events": len(events),
                "events": events,
                "missing_hosts": merged["missing_hosts"]}

    def _metric_snapshots(self) -> "tuple[dict, list]":
        """({node_label: metrics.snapshot()}, missing_hosts) across the
        cluster — the head's own registry plus each alive daemon's via
        NODE_DEBUG. Unreachable daemons land in ``missing_hosts``."""
        from ray_tpu_torch.protocol import pb
        from ray_tpu_torch.util import metrics as _metrics
        snaps = {"head": _metrics.snapshot()}
        missing = []
        for nid, addr in self._alive_addrs():
            try:
                rep = pb.NodeDebugReply()
                rep.ParseFromString(self.pool.get(addr).call(
                    pb.NODE_DEBUG, pb.NodeDebugRequest(
                        log_lines=0, include_tasks=False,
                        include_metrics=True).SerializeToString(),
                    timeout=15).body)
                payload = json.loads(bytes(rep.payload_json).decode())
                snaps[f"node:{nid[:8]}"] = payload.get("metrics") or []
            except Exception as e:
                logger.debug("dashboard: metrics fetch from %s failed: %s",
                             addr, e)
                missing.append({"node_id": nid, "address": addr,
                                "error": str(e)})
        return snaps, missing

    # -- perf plane ------------------------------------------------------
    def _perf(self) -> dict:
        """Cluster latency quantiles: per-node and cluster-merged
        count/mean/p50/p95/p99 per perf histogram, computed from the raw
        bucket counts that ride the federated metric snapshots (the
        ``"perf"`` payload in each ``raytpu_perf_*`` family). The merge
        is exact — same bucket layout everywhere, counts just add."""
        from ray_tpu_torch.observability import perf as perf_mod
        snaps, missing = self._metric_snapshots()
        nodes = {}
        agg: dict = {}
        for node, fams in snaps.items():
            per = {}
            for name, p in perf_mod.extract_perf(fams).items():
                counts = [int(c) for c in p["counts"]]
                sum_ms = float(p.get("sum_ms", 0.0))
                bounds = p.get("bounds")
                per[name] = perf_mod.summarize(counts, sum_ms, bounds)
                a = agg.setdefault(name, {"counts": [], "sum_ms": 0.0,
                                          "bounds": bounds})
                a["counts"] = perf_mod.merge_counts([a["counts"], counts])
                a["sum_ms"] += sum_ms
            if per:
                nodes[node] = per
        cluster = {name: perf_mod.summarize(a["counts"], a["sum_ms"],
                                            a["bounds"])
                   for name, a in agg.items()}
        return {"ts": time.time(), "nodes": nodes, "cluster": cluster,
                "missing_hosts": missing}

    # -- goodput ledger --------------------------------------------------
    def _goodput(self) -> dict:
        """Cluster goodput: each node's per-job wall-clock attribution
        ledger (the ``"goodput"`` payload riding the federated metric
        snapshots) merged into per-job category totals + ``goodput_pct``
        (recomputed from merged seconds, never averaged from per-node
        percentages). Per-node ledgers stay visible for skew triage;
        unreachable daemons degrade into ``missing_hosts``."""
        from ray_tpu_torch.observability import goodput as goodput_mod
        snaps, missing = self._metric_snapshots()
        nodes = {}
        for node, fams in snaps.items():
            payload = goodput_mod.extract_goodput(fams)
            if payload and payload.get("jobs"):
                nodes[node] = payload["jobs"]
        jobs = goodput_mod.merge_payloads(
            {"jobs": per} for per in nodes.values())
        return {"ts": time.time(),
                "categories": list(goodput_mod.CATEGORIES),
                "jobs": jobs, "nodes": nodes, "missing_hosts": missing}

    # -- comms ledger ----------------------------------------------------
    def _comms(self) -> dict:
        """Cluster comms plane: each node's collective ledger (the
        ``"comms"`` payload riding the federated metric snapshots)
        merged exactly — bytes/seconds/bucket-counts add, bandwidths
        recomputed from the sums — plus the derived attribution the CLI
        and doctor consume: laggard-rank skew flags and link-matrix
        outliers. Per-node ledgers stay visible; unreachable daemons
        degrade into ``missing_hosts``."""
        from ray_tpu_torch.observability import comms as comms_mod
        snaps, missing = self._metric_snapshots()
        nodes = {}
        for node, fams in snaps.items():
            payload = comms_mod.extract_comms(fams)
            if payload:
                nodes[node] = payload
        merged = comms_mod.merge_payloads(nodes.values())
        return {"ts": time.time(),
                "groups": merged["groups"], "links": merged["links"],
                "recent": merged["recent"], "bounds": merged["bounds"],
                "skew_flags": comms_mod.skew_flags(
                    merged["groups"], bounds=merged["bounds"]),
                "link_flags": comms_mod.link_flags(merged["links"]),
                "nodes": nodes, "missing_hosts": missing}

    # -- autopilot -------------------------------------------------------
    def _autopilot_snapshot(self) -> dict:
        """The controller's tick input: the same three plane merges the
        dashboard already serves, taken in one sweep."""
        return {"perf": self._perf(), "goodput": self._goodput(),
                "comms": self._comms()}

    def _start_autopilot(self) -> None:
        from ray_tpu_torch._private.config import _config
        if not _config.get("autopilot_enabled"):
            return
        from ray_tpu_torch.autopilot import actuators as _actuators
        from ray_tpu_torch.autopilot.controller import Autopilot
        from ray_tpu_torch.autopilot.journal import Journal

        def _hazard():
            from ray_tpu_torch.autoscaler import hazard as _hz
            return _hz.read_fleet_rate(self.state)

        with self._autopilot_lock:
            if self.autopilot is not None:
                return
            _actuators.register_config_actuators()
            self.autopilot = Autopilot(
                self._autopilot_snapshot,
                journal=Journal(state=self.state),
                hazard_fn=_hazard)
            self.autopilot.start()
        logger.info("autopilot: controller started in dashboard head")

    def _autopilot_payload(self) -> dict:
        with self._autopilot_lock:
            ap = self.autopilot
        if ap is None:
            from ray_tpu_torch.autopilot import journal as _journal
            # controller not hosted here: serve the journal from the KV
            # so a read-only head can still explain the knobs
            try:
                tail = _journal.read_from_state(self.state)[-50:]
            except Exception as e:  # noqa: BLE001 — state KV may be gone
                logger.debug("autopilot journal read failed: %s", e)
                tail = []
            return {"ts": time.time(), "enabled": False, "journal": tail}
        status = ap.status()
        status.update({"ts": time.time(), "enabled": True})
        return status

    def _profile_snapshots(self, host: str = "") -> "tuple[dict, list]":
        """({host_label: cumulative profile}, missing) — the head's own
        sampler plus each alive daemon's (NODE_DEBUG include_stacks
        carries ``payload["profile"]``). ``host`` filters by label
        prefix ("head", "node:ab12cd34", or a node-id prefix)."""
        from ray_tpu_torch.protocol import pb
        from ray_tpu_torch.observability import sampler as _sampler
        out = {}
        missing = []

        def _want(label):
            return (not host or label.startswith(host)
                    or label.startswith(f"node:{host}"))

        if _want("head"):
            prof = _sampler.profile_snapshot()
            if prof is not None:
                out["head"] = prof
        for nid, addr in self._alive_addrs():
            label = f"node:{nid[:8]}"
            if not _want(label):
                continue
            try:
                rep = pb.NodeDebugReply()
                rep.ParseFromString(self.pool.get(addr).call(
                    pb.NODE_DEBUG, pb.NodeDebugRequest(
                        log_lines=0, include_tasks=False,
                        include_stacks=True).SerializeToString(),
                    timeout=15).body)
                payload = json.loads(bytes(rep.payload_json).decode())
                prof = payload.get("profile")
                if prof:
                    out[label] = prof
            except Exception as e:
                logger.debug("dashboard: profile fetch from %s failed: %s",
                             addr, e)
                missing.append({"node_id": nid, "address": addr,
                                "error": str(e)})
        return out, missing

    def _profile(self, host: str = "", seconds: float = 0.0) -> dict:
        """Federated sampling profile. ``seconds=0`` returns cumulative
        profiles (since each sampler started); ``seconds>0`` takes two
        cumulative snapshots that far apart and returns the window's
        difference — no wire support needed beyond the cumulative
        fetch. Response carries collapsed-stack text (flamegraph.pl
        input) and pprof-shaped JSON of the cross-host merge."""
        from ray_tpu_torch.observability import sampler as _sampler
        first, missing = self._profile_snapshots(host)
        hosts = first
        if seconds > 0:
            time.sleep(min(float(seconds), 60.0))
            second, missing = self._profile_snapshots(host)
            hosts = {label: _sampler.diff_profiles(p, first.get(label, {}))
                     for label, p in second.items()}
        merged = _sampler.merge_profiles(list(hosts.values()))
        return {"ts": time.time(), "seconds": seconds, "hosts": hosts,
                "merged": merged,
                "collapsed": _sampler.collapsed(merged),
                "pprof": _sampler.pprof_json(merged),
                "missing_hosts": missing}

    def _forensics(self) -> dict:
        """Cluster-wide crash forensics, the doctor's collection wire:
        per-node live thread stacks, in-flight task registry, and the
        on-disk flight-recorder report (recordings + sealed bundles),
        plus the head process's own. Dead/unreachable nodes degrade
        into ``missing_hosts`` — their story lives in the bundles the
        surviving daemons sealed for them."""
        from ray_tpu_torch.protocol import pb
        from ray_tpu_torch.observability import recorder as _flight
        nodes = {}
        missing = []
        for nid, addr in self._alive_addrs():
            try:
                rep = pb.NodeDebugReply()
                rep.ParseFromString(self.pool.get(addr).call(
                    pb.NODE_DEBUG, pb.NodeDebugRequest(
                        log_lines=0, include_tasks=True,
                        include_stacks=True,
                        include_bundles=True).SerializeToString(),
                    timeout=15).body)
                payload = json.loads(bytes(rep.payload_json).decode())
                payload["address"] = addr
                nodes[nid] = payload
            except Exception as e:
                logger.debug("dashboard: forensics fetch from %s failed: %s",
                             addr, e)
                missing.append({"node_id": nid, "address": addr,
                                "error": str(e)})
        return {
            "ts": time.time(),
            "head": {
                "stacks": _flight.thread_stacks(),
                "inflight": _flight.inflight_snapshot(),
                "forensics": _flight.disk_report(),
            },
            "nodes": nodes,
            "missing_hosts": missing,
        }

    # -- server ----------------------------------------------------------
    def start(self) -> int:
        import http.server
        head = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, payload, code: int = 200):
                self._send(json.dumps(payload, default=str).encode(),
                           "application/json", code)

            def do_GET(self):
                try:
                    parsed = urllib.parse.urlparse(self.path)
                    q = urllib.parse.parse_qs(parsed.query)
                    route = parsed.path
                    if route in ("/", "/index.html"):
                        self._send(_PAGE.encode(), "text/html")
                    elif route == "/api/cluster":
                        self._json(head._cluster())
                    elif route == "/api/actors":
                        self._json(head._actors())
                    elif route == "/api/actor":
                        self._json(head._actor_detail(
                            q.get("id", [""])[0]))
                    elif route == "/api/pgs":
                        self._json(head._pgs())
                    elif route == "/api/jobs":
                        self._json(head._jobs())
                    elif route == "/api/stats":
                        self._json(head.state.stats())
                    elif route == "/api/node_debug":
                        self._json(head._node_debug(
                            q.get("node", [""])[0],
                            int(q.get("lines", ["200"])[0]),
                            q.get("tasks", ["1"])[0] not in ("0", ""),
                            q.get("trace", [""])[0]))
                    elif route == "/api/timeline":
                        self._json(head._timeline())
                    elif route == "/api/trace":
                        self._json(head._trace(q.get("id", [""])[0]))
                    elif route == "/api/metrics":
                        snaps, missing = head._metric_snapshots()
                        self._json({"snapshots": snaps,
                                    "missing_hosts": missing})
                    elif route == "/api/perf":
                        self._json(head._perf())
                    elif route == "/api/goodput":
                        self._json(head._goodput())
                    elif route == "/api/comms":
                        self._json(head._comms())
                    elif route == "/api/autopilot":
                        self._json(head._autopilot_payload())
                    elif route == "/api/profile":
                        self._json(head._profile(
                            q.get("host", [""])[0],
                            float(q.get("seconds", ["0"])[0])))
                    elif route == "/api/forensics":
                        self._json(head._forensics())
                    elif route == "/metrics":
                        from ray_tpu_torch.util.metrics import render_federated
                        snaps, missing = head._metric_snapshots()
                        self._send(
                            render_federated(snaps, missing_hosts=missing)
                            .encode(), "text/plain; version=0.0.4")
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

            def log_message(self, *a):
                pass

        # raylint: allow(data-race) start() runs once from the owning process before the serve thread exists
        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), Handler)
        self.port = self._httpd.server_address[1]  # raylint: allow(data-race) start() runs once from the owning process before the serve thread exists
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dashboard-head")
        self._thread.start()
        self._start_autopilot()
        return self.port

    def stop(self):
        with self._autopilot_lock:
            ap, self.autopilot = self.autopilot, None
        if ap is not None:
            try:
                ap.stop()
            except Exception as e:  # noqa: BLE001
                logger.debug("autopilot stop failed: %s", e)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None  # raylint: allow(data-race) stop() runs after shutdown() has joined the serve loop; no reader remains
        try:
            self.pool.close_all()
        except Exception as e:
            logger.debug("connection pool close failed: %s", e)
        try:
            self.state.close()
        except Exception as e:
            logger.debug("state client close failed: %s", e)


def start_dashboard(state_addr: str, port: int = 0,
                    host: str = "127.0.0.1") -> DashboardHead:
    head = DashboardHead(state_addr, port=port, host=host)
    head.start()
    return head
