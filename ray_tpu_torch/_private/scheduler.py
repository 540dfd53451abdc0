"""Cluster scheduling policies.

Parity with the reference's pluggable policy library
(``src/ray/raylet/scheduling/policy/``):

- ``HybridPolicy`` — the default: pack onto the first (local-preferred) nodes
  until a utilization threshold, then spread; randomized top-k pick
  (``hybrid_scheduling_policy.h:48``).
- ``SpreadPolicy`` — round-robin over feasible nodes
  (``spread_scheduling_policy.h:27``).
- ``NodeAffinityPolicy`` — hard/soft pinning to one node
  (``node_affinity_scheduling_policy.h:29``).
- Bundle policies for placement groups: PACK / SPREAD / STRICT_PACK /
  STRICT_SPREAD (``bundle_scheduling_policy.h:73-97``).

All policies are pure functions over a snapshot of node states so they are
shared by the cluster scheduler and the placement-group manager, like the
reference shares them between raylet and GCS.
"""

from __future__ import annotations
import logging

import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.resources import NodeResources, ResourceSet

logger = logging.getLogger("ray_tpu")

_native_sched = None
_native_checked = False


def _native():
    """The C++ policy kernels (``_native/scheduling.cc``), or None."""
    global _native_sched, _native_checked
    if not _native_checked:
        _native_checked = True  # raylint: allow(data-race) idempotent lazy probe; a racing double-load yields equivalent handles
        if _config.get("use_native_scheduler"):
            try:
                from ray_tpu_torch._native.build import load_native_library
                _native_sched = load_native_library("scheduling")  # raylint: allow(data-race) idempotent lazy probe; a racing double-load yields equivalent handles
                if _native_sched is not None:
                    import ctypes
                    dp = ctypes.POINTER(ctypes.c_double)
                    up = ctypes.POINTER(ctypes.c_uint8)
                    i64 = ctypes.c_int64
                    _native_sched.sched_hybrid_select.restype = i64
                    _native_sched.sched_hybrid_select.argtypes = [
                        dp, dp, up, dp, i64, i64, i64,
                        ctypes.c_double, ctypes.c_double, i64]
                    _native_sched.sched_spread_select.restype = i64
                    _native_sched.sched_spread_select.argtypes = [
                        dp, up, dp, i64, i64, i64]
            except Exception as e:
                logger.warning("native scheduling lib unavailable: %s", e)
                _native_sched = None  # raylint: allow(data-race) idempotent lazy probe; a racing double-load yields equivalent handles
    return _native_sched


def _flatten(nodes: Sequence["NodeState"], request: ResourceSet):
    """Dense (available, total, alive, request) arrays over the union of
    resource keys, for the native kernels."""
    import ctypes
    keys = list(request.to_dict().keys())
    seen = set(keys)
    for n in nodes:
        for k in n.resources.total.to_dict():
            if k not in seen:
                seen.add(k)
                keys.append(k)
    n_nodes, n_res = len(nodes), max(1, len(keys))
    avail = (ctypes.c_double * (n_nodes * n_res))()
    total = (ctypes.c_double * (n_nodes * n_res))()
    alive = (ctypes.c_uint8 * n_nodes)()
    req = (ctypes.c_double * n_res)()
    req_d = request.to_dict()
    for j, k in enumerate(keys):
        req[j] = req_d.get(k, 0.0)
    for i, n in enumerate(nodes):
        # Schedulability, not liveness: the native kernels need no notion
        # of DRAINING — a draining node simply reads as ineligible.
        alive[i] = 1 if n.schedulable else 0
        a = n.resources.available.to_dict()
        t = n.resources.total.to_dict()
        for j, k in enumerate(keys):
            avail[i * n_res + j] = a.get(k, 0.0)
            total[i * n_res + j] = t.get(k, 0.0)
    return avail, total, alive, req, n_nodes, n_res


class NodeState:
    """Scheduler-visible view of one node."""

    def __init__(self, node_id: NodeID, resources: NodeResources, alive: bool = True,
                 draining: bool = False, pending_drain: bool = False):
        self.node_id = node_id
        self.resources = resources
        self.alive = alive
        self.draining = draining
        # Hazard hint from the autoscaler's preemption estimator: the
        # node is still fully schedulable, but a drain is likely soon, so
        # policies place on it only when no stable node fits.
        self.pending_drain = pending_drain

    @property
    def schedulable(self) -> bool:
        """Eligible for NEW placement. A DRAINING node is still alive (its
        in-flight work runs to the drain deadline) but must not receive
        anything new, so every policy filters on this, not ``alive``."""
        return self.alive and not self.draining


def _stable_first(nodes: Sequence["NodeState"]) -> Optional[List["NodeState"]]:
    """The subset of ``nodes`` without a pending-drain hazard hint, or
    None when the hint splits nothing (all stable / all hazardous).

    Every placement policy tries the stable subset first and falls back
    to the full set: new work should land on capacity that is expected
    to survive, but a fully-hazardous fleet must still schedule."""
    stable = [n for n in nodes if not n.pending_drain]
    if not stable or len(stable) == len(nodes):
        return None
    return stable


class Infeasible(Exception):
    """No node in the cluster could ever satisfy the request."""


class HybridPolicy:
    """Pack-then-spread with top-k randomization."""

    def __init__(self, spread_threshold: Optional[float] = None,
                 top_k_fraction: Optional[float] = None, seed: Optional[int] = None):
        self.spread_threshold = spread_threshold
        self.top_k_fraction = top_k_fraction
        self._rng = random.Random(seed)

    def select(self, nodes: Sequence[NodeState], request: ResourceSet,
               preferred: Optional[NodeID] = None) -> Optional[NodeID]:
        stable = _stable_first(nodes)
        if stable is not None:
            nid = self._select(stable, request, preferred)
            if nid is not None:
                return nid
        return self._select(nodes, request, preferred)

    def _select(self, nodes: Sequence[NodeState], request: ResourceSet,
                preferred: Optional[NodeID] = None) -> Optional[NodeID]:
        threshold = (self.spread_threshold if self.spread_threshold is not None
                     else _config.get("scheduler_spread_threshold"))
        top_k_frac = (self.top_k_fraction if self.top_k_fraction is not None
                      else _config.get("scheduler_top_k_fraction"))
        lib = _native()
        if lib is not None:
            avail, total, alive, req, n_nodes, n_res = _flatten(nodes,
                                                                request)
            preferred_idx = -1
            if preferred is not None:
                for i, n in enumerate(nodes):
                    if n.node_id == preferred:
                        preferred_idx = i
                        break
            idx = lib.sched_hybrid_select(
                avail, total, alive, req, n_nodes, n_res, preferred_idx,
                threshold, top_k_frac, self._rng.getrandbits(62))
            return nodes[idx].node_id if idx >= 0 else None
        scored: List[Tuple[float, int, NodeID]] = []
        for i, n in enumerate(nodes):
            if not n.schedulable or not n.resources.can_fit(request):
                continue
            util = n.resources.utilization()
            # Below threshold: score 0 (pack anywhere cheap); above: score by
            # utilization so lighter nodes win (spread).
            score = 0.0 if util < threshold else util
            is_preferred = 0 if (preferred is not None and n.node_id == preferred) else 1
            scored.append((score, is_preferred, i, n.node_id))
        if not scored:
            return None
        scored.sort(key=lambda t: (t[0], t[1], t[2]))
        k = max(1, int(len(scored) * top_k_frac))
        return self._rng.choice(scored[:k])[3]


class SpreadPolicy:
    def __init__(self):
        self._next = 0  # raylint: guarded-by(self._lock)
        self._lock = threading.Lock()

    def select(self, nodes: Sequence[NodeState], request: ResourceSet,
               preferred: Optional[NodeID] = None) -> Optional[NodeID]:
        stable = _stable_first(nodes)
        if stable is not None:
            nid = self._select(stable, request, preferred)
            if nid is not None:
                return nid
        return self._select(nodes, request, preferred)

    def _select(self, nodes: Sequence[NodeState], request: ResourceSet,
                preferred: Optional[NodeID] = None) -> Optional[NodeID]:
        lib = _native()
        if lib is not None:
            avail, _total, alive, req, n_nodes, n_res = _flatten(nodes,
                                                                 request)
            with self._lock:
                cursor = self._next
                self._next += 1  # raylint: guarded-by(self._lock)
            idx = lib.sched_spread_select(avail, alive, req, n_nodes,
                                          n_res, cursor)
            return nodes[idx].node_id if idx >= 0 else None
        feasible = [n for n in nodes
                    if n.schedulable and n.resources.can_fit(request)]
        if not feasible:
            return None
        with self._lock:
            choice = feasible[self._next % len(feasible)]
            self._next += 1
        return choice.node_id


class NodeAffinityPolicy:
    def select(self, nodes: Sequence[NodeState], request: ResourceSet,
               node_id_hex: str = "", soft: bool = False) -> Optional[NodeID]:
        target = None
        for n in nodes:
            if n.node_id.hex() == node_id_hex:
                target = n
                break
        if target is not None and target.schedulable:
            if target.resources.can_fit(request):
                return target.node_id
            if target.resources.could_ever_fit(request):
                return None  # node is busy: wait, don't fail (reference
                # semantics fail hard affinity only when the node is gone)
        if not soft:
            raise Infeasible(f"node {node_id_hex} unavailable for hard affinity")
        return HybridPolicy().select(nodes, request)


# -- bundle (placement group) policies ---------------------------------------


def _bin_pack(nodes: List[NodeState], bundles: Sequence[ResourceSet],
              distinct: bool, minimize_nodes: bool) -> Optional[List[NodeID]]:
    """Greedy bundle placement over a copy of node availability."""
    avail: Dict[NodeID, ResourceSet] = {
        n.node_id: n.resources.available for n in nodes if n.schedulable}
    pending: Dict[NodeID, bool] = {
        n.node_id: n.pending_drain for n in nodes if n.schedulable}
    used_nodes: List[NodeID] = []
    placement: List[NodeID] = []
    order = sorted(range(len(bundles)),
                   key=lambda i: -sum(bundles[i].to_dict().values()))
    slots: List[Optional[NodeID]] = [None] * len(bundles)
    for i in order:
        b = bundles[i]
        candidates = []
        for nid, a in avail.items():
            if distinct and nid in used_nodes:
                continue
            if b.is_subset_of(a):
                candidates.append(nid)
        if not candidates:
            return None
        if minimize_nodes:
            # Pending-drain nodes last, then prefer nodes already holding
            # a bundle (PACK).
            candidates.sort(key=lambda nid: (pending[nid],
                                             nid not in used_nodes))
        else:
            # SPREAD: pending-drain nodes last, then prefer nodes not yet
            # holding a bundle.
            candidates.sort(key=lambda nid: (pending[nid],
                                             nid in used_nodes))
        chosen = candidates[0]
        avail[chosen] = avail[chosen].subtract(b)
        if chosen not in used_nodes:
            used_nodes.append(chosen)
        slots[i] = chosen
    return slots  # type: ignore[return-value]


def schedule_bundles(nodes: List[NodeState], bundles: Sequence[ResourceSet],
                     strategy: str) -> Optional[List[NodeID]]:
    """Return one NodeID per bundle, or None if unplaceable now."""
    if strategy == "STRICT_PACK":
        total = ResourceSet()
        for b in bundles:
            total = total.add(b)
        # Stable nodes first: a strict-pack group on a pending-drain node
        # would migrate wholesale at the predicted preemption.
        for n in sorted(nodes, key=lambda n: n.pending_drain):
            if n.schedulable and n.resources.can_fit(total):
                return [n.node_id] * len(bundles)
        return None
    if strategy == "STRICT_SPREAD":
        return _bin_pack(nodes, bundles, distinct=True, minimize_nodes=False)
    if strategy == "PACK":
        return _bin_pack(nodes, bundles, distinct=False, minimize_nodes=True)
    if strategy == "SPREAD":
        return _bin_pack(nodes, bundles, distinct=False, minimize_nodes=False)
    raise ValueError(f"unknown placement strategy {strategy}")
