"""The autoscaling control loop.

Parity with ``StandardAutoscaler.update``
(``autoscaler/_private/autoscaler.py:147,336``): read demand from
``LoadMetrics``, bin-pack unmet demand onto the cheapest feasible node
types (``resource_demand_scheduler.py``'s role), launch within
``max_workers``, terminate nodes idle past ``idle_timeout_s``. Driven
either manually (tests call ``update()``) or by ``start()``'s monitor
thread (the head-side ``Monitor`` process, ``monitor.py:125``).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger("ray_tpu")


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, Dict[str, float]] = field(default_factory=dict)
    max_workers: int = 10
    min_workers: int = 0
    max_workers_per_type: Dict[str, int] = field(default_factory=dict)
    idle_timeout_s: float = 60.0
    update_interval_s: float = 5.0
    upscaling_speed: float = 1.0  # max new nodes = max(1, speed * current)


class LoadMetrics:
    """Demand + utilization snapshot from the runtime (reference:
    ``load_metrics.py`` fed by GCS resource-usage reports)."""

    def __init__(self, runtime):
        self._runtime = runtime

    def pending_demands(self) -> List[Dict[str, float]]:
        return self._runtime.pending_resource_demands()

    def node_utilization(self) -> Dict[str, dict]:
        """node hex id -> {"total": .., "available": .., "idle": bool}.

        DRAINING/DRAINED nodes are excluded along with dead ones: a
        draining node that has quiesced *looks* idle, but terminating it
        mid-drain would turn a graceful migration into a node death; and
        its capacity is about to leave, so bin-packing unmet demand onto
        it would mask a needed scale-up."""
        out = {}
        for ns in self._runtime.node_states():
            if not ns.alive or ns.draining:
                continue
            total = ns.resources.total.to_dict()
            avail = ns.resources.available.to_dict()
            idle = all(avail.get(k, 0.0) >= v for k, v in total.items())
            out[ns.node_id.hex()] = {
                "total": total, "available": avail, "idle": idle}
        return out

    def lifecycle(self) -> Dict[str, dict]:
        """node hex id -> {"alive": .., "draining": ..} for every node the
        runtime knows (the gang-replacement scan needs the nodes
        ``node_utilization`` deliberately hides)."""
        return {ns.node_id.hex(): {"alive": ns.alive,
                                   "draining": ns.draining}
                for ns in self._runtime.node_states()}


def _fits(demand: Dict[str, float], capacity: Dict[str, float]) -> bool:
    return all(capacity.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


class StandardAutoscaler:
    def __init__(self, config: AutoscalerConfig, provider: NodeProvider,
                 runtime=None, hazard=None):
        if runtime is None:
            from ray_tpu_torch._private import worker as _worker
            runtime = _worker.global_worker().runtime
        self.config = config
        self.provider = provider
        self.load_metrics = LoadMetrics(runtime)
        self._runtime = runtime
        # Infeasible tasks must queue (as demand) rather than fail fast.
        runtime.autoscaling_enabled = True
        self._idle_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_launches = 0
        self.num_terminations = 0
        # Elastic preemptible fleet: the hazard estimator feeds proactive
        # drains and pending-drain placement hints; gang replacement
        # refills every drain. A distributed runtime's state client backs
        # the estimator with the cluster-wide KV journal; the in-process
        # runtime gets a local (record()-fed) estimator.
        if hazard is None:
            from ray_tpu_torch.autoscaler.hazard import HazardEstimator
            hazard = HazardEstimator(getattr(runtime, "state", None))
        self.hazard = hazard
        self._replaced: set = set()      # provider ids already refilled
        self.num_replacements = 0
        self.num_proactive_drains = 0

    # -- one reconciliation pass (autoscaler.py:336 update) ---------------

    def update(self) -> Dict[str, int]:
        drained = self._hazard_pass()
        replaced = self._gang_replace()
        launched = self._scale_up()
        terminated = self._scale_down()
        return {"launched": launched, "terminated": terminated,
                "proactively_drained": drained, "replaced": replaced}

    # -- preemption hazard: predict, hint, proactively drain ---------------

    def _provider_runtime_ids(self) -> Dict[str, str]:
        """provider id -> runtime node hex, for nodes already registered."""
        out = {}
        for pid in self.provider.non_terminated_nodes():
            try:
                out[pid] = self.provider.runtime_node_id(pid).hex()
            except (AttributeError, KeyError) as e:
                logger.debug("autoscaler: node %s has no runtime id yet "
                             "(%s); skipping hazard scan", pid, e)
        return out

    def _hazard_pass(self) -> int:
        """Refresh the estimator, hint high-hazard nodes as last-choice
        placements, and proactively drain the highest-hazard node once
        its score crosses ``hazard_drain_threshold`` — ahead of the real
        notice, so the drain runs with the full ``drain_deadline_s``
        budget instead of ``preempt_lead_s``."""
        from ray_tpu_torch._private.config import _config
        self.hazard.refresh()
        self.hazard.publish_fleet_rate()
        lifecycle = self.load_metrics.lifecycle()
        place_thresh = _config.get("hazard_placement_threshold")
        drain_thresh = _config.get("hazard_drain_threshold")
        hint = getattr(self._runtime, "set_pending_drain", None)
        # At most one proactive drain in flight: the hazard rate is a
        # per-TYPE signal, so without this guard every node of a hot type
        # would cross the threshold and the fleet would cascade-drain
        # itself one pass at a time.
        draining_now = any(st["alive"] and st["draining"]
                           for st in lifecycle.values())
        worst: Optional[tuple] = None   # (score, pid, rid)
        for pid, rid in self._provider_runtime_ids().items():
            state = lifecycle.get(rid)
            if state is None or not state["alive"] or state["draining"]:
                continue
            score = self.hazard.node_hazard(self.provider.node_type(pid),
                                            rid)
            if hint is not None:
                hint(rid, score >= place_thresh)
            if score >= drain_thresh and (worst is None
                                          or score > worst[0]):
                worst = (score, pid, rid)
        if (worst is None or draining_now
                or not _config.get("hazard_proactive_drains")):
            return 0
        score, pid, rid = worst
        logger.warning("autoscaler: proactive drain of %s (hazard %.2f "
                       ">= %.2f)", rid[:8], score, drain_thresh)
        if not self._drain_runtime_node(rid, reason=(
                f"preemption hazard {score:.2f} (proactive)")):
            return 0
        self.num_proactive_drains += 1  # raylint: allow(data-race) single autoscaler update loop is the only writer; counter is monitoring-only
        return 1

    def _drain_runtime_node(self, rid_hex: str, reason: str) -> bool:
        """Start a graceful drain with the full drain budget: through the
        state service on a distributed runtime, or by flipping the node's
        lifecycle flag on the in-process runtime (which has no drain
        orchestrator — the node just stops taking new placements)."""
        from ray_tpu_torch._private.config import _config
        state = getattr(self._runtime, "state", None)
        if state is not None:
            try:
                state.drain_node(bytes.fromhex(rid_hex), reason,
                                 deadline_s=_config.get("drain_deadline_s"))
                return True
            except Exception as e:  # noqa: BLE001
                logger.warning("autoscaler: proactive drain of %s failed: "
                               "%s", rid_hex[:8], e)
                return False
        from ray_tpu_torch._private.ids import NodeID
        node = getattr(self._runtime, "nodes", {}).get(
            NodeID(bytes.fromhex(rid_hex)))
        if node is None:
            return False
        node.draining = True
        self._runtime._kick()
        return True

    # -- gang replacement: every drain is refilled same-type ---------------

    def _gang_replace(self) -> int:
        """Launch a same-type replacement for every provider node that is
        draining (or died out from under us) — immediately, not when the
        drained node's capacity shortfall shows up as unmet demand, so
        the replacement daemon gang-joins while the drain is still
        migrating and the job reshards onto a full-size world."""
        lifecycle = self.load_metrics.lifecycle()
        ids = self._provider_runtime_ids()
        stable = sum(1 for pid, rid in ids.items()
                     if (st := lifecycle.get(rid)) is not None
                     and st["alive"] and not st["draining"])
        replaced = 0
        for pid, rid in ids.items():
            st = lifecycle.get(rid)
            if st is None or (st["alive"] and not st["draining"]):
                continue
            if pid in self._replaced:
                continue
            if stable + replaced >= self.config.max_workers:
                logger.warning("autoscaler: not replacing draining node "
                               "%s (at max_workers=%d)", rid[:8],
                               self.config.max_workers)
                break
            ntype = self.provider.node_type(pid)
            self.provider.create_node(ntype, 1)
            self._replaced.add(pid)  # raylint: allow(data-race) only touched inside update() — the single monitor loop, or a test driving update() directly with no monitor running
            replaced += 1
            logger.info("autoscaler: gang replacement for %s (%s)",
                        rid[:8], ntype)
        self.num_replacements += replaced  # raylint: allow(data-race) single autoscaler update loop is the only writer; counter is monitoring-only
        return replaced

    def _unmet_demands(self) -> List[Dict[str, float]]:
        """Demands that no live node could satisfy even when empty."""
        demands = self.load_metrics.pending_demands()
        if not demands:
            return []
        node_totals = [u["total"] for u in
                       self.load_metrics.node_utilization().values()]
        return [d for d in demands
                if not any(_fits(d, t) for t in node_totals)]

    def _scale_up(self) -> int:
        unmet = self._unmet_demands()
        current = self.provider.non_terminated_nodes()
        budget = self.config.max_workers - len(current)
        if budget <= 0 and len(current) >= self.config.min_workers:
            if not unmet:
                return 0
        min_needed = max(0, self.config.min_workers - len(current))
        # min_workers is a hard floor — not throttled by upscaling_speed.
        launch_cap = max(1, min_needed,
                         int(self.config.upscaling_speed
                             * max(1, len(current))))
        to_launch: Dict[str, int] = {}
        # Ensure min_workers of the first declared type.
        if len(current) < self.config.min_workers and self.config.node_types:
            first = next(iter(self.config.node_types))
            to_launch[first] = self.config.min_workers - len(current)
        # Bin-pack each unmet demand onto the smallest feasible type
        # (types are assumed declared small->large, reference sorts by
        # resources; we sort by total resource sum).
        types_sorted = sorted(
            self.config.node_types.items(),
            key=lambda kv: sum(kv[1].values()))
        for demand in unmet:
            for tname, tres in types_sorted:
                if _fits(demand, tres):
                    cap = self.config.max_workers_per_type.get(
                        tname, self.config.max_workers)
                    already = sum(
                        1 for pid in current
                        if self.provider.node_type(pid) == tname)
                    if already + to_launch.get(tname, 0) < cap:
                        to_launch[tname] = to_launch.get(tname, 0) + 1
                    break
        launched = 0
        for tname, count in to_launch.items():
            count = min(count,
                        self.config.max_workers - len(current) - launched,
                        launch_cap - launched)
            if count <= 0:
                continue
            self.provider.create_node(tname, count)
            launched += count
        self.num_launches += launched  # raylint: allow(data-race) single autoscaler update loop is the only writer; counter is monitoring-only
        return launched

    def _scale_down(self) -> int:
        util = self.load_metrics.node_utilization()
        now = time.monotonic()
        current = self.provider.non_terminated_nodes()
        terminated = 0
        for pid in current:
            if len(current) - terminated <= self.config.min_workers:
                break
            try:
                rid = self.provider.runtime_node_id(pid).hex()
            except (AttributeError, KeyError) as e:
                logger.debug("autoscaler: node %s has no runtime id yet "
                             "(%s); skipping idle check", pid, e)
                continue
            info = util.get(rid)
            if info is None or not info["idle"]:
                self._idle_since.pop(pid, None)  # raylint: allow(data-race) single autoscaler update loop is the only mutator of idle tracking
                continue
            first_idle = self._idle_since.setdefault(pid, now)  # raylint: allow(data-race) single autoscaler update loop is the only mutator of idle tracking
            if now - first_idle >= self.config.idle_timeout_s:
                self.provider.terminate_node(pid)
                self._idle_since.pop(pid, None)  # raylint: allow(data-race) single autoscaler update loop is the only mutator of idle tracking
                terminated += 1
        self.num_terminations += terminated  # raylint: allow(data-race) single autoscaler update loop is the only writer; counter is monitoring-only
        return terminated

    # -- monitor thread (reference: Monitor process, monitor.py:125) ------

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler-monitor")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.config.update_interval_s):
            try:
                self.update()
            except Exception:  # pragma: no cover — monitor must survive
                import logging
                logging.getLogger("ray_tpu").exception("autoscaler update")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Restore fail-fast for infeasible tasks: nothing will grow the
        # cluster anymore, so queued-forever would hang callers.
        self._runtime.autoscaling_enabled = False  # raylint: allow(data-race) monitor thread already joined above; no concurrent reader remains
        self._runtime._kick()
