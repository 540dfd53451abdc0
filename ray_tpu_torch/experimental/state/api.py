"""Cluster state introspection.

Parity with ``python/ray/experimental/state/api.py`` (+ the server-side
``dashboard/state_aggregator.py``): list/summarize tasks, actors,
objects, nodes, and placement groups. The host-granular runtime holds
these tables in-process, so the aggregator hop disappears — readers
snapshot the Runtime's tables directly.
"""

from __future__ import annotations

from collections import Counter as _Counter
from typing import Any, Dict, List, Optional


def _runtime():
    from ray_tpu_torch._private import worker as _worker
    rt = _worker.try_global_runtime()
    if rt is None:
        raise RuntimeError("ray_tpu is not initialized")
    return rt


def _filtered(rows: List[dict], filters, limit: int) -> List[dict]:
    if filters:
        for key, op, value in filters:
            if op == "=":
                rows = [r for r in rows if str(r.get(key)) == str(value)]
            elif op == "!=":
                rows = [r for r in rows if str(r.get(key)) != str(value)]
            else:
                raise ValueError(f"unsupported filter op {op!r}")
    return rows[:limit]


def list_tasks(filters=None, limit: int = 10_000) -> List[dict]:
    rt = _runtime()
    with rt.lock:  # one block: a torn snapshot renders names as "?"
        states = dict(rt.task_states)
        name_by_task = {spec.task_id.hex(): spec.function_name
                        for spec in rt.lineage.values()}
    rows = [{"task_id": task_id.hex(), "state": state,
             "name": name_by_task.get(task_id.hex(), "?")}
            for task_id, state in states.items()]
    return _filtered(rows, filters, limit)


def list_actors(filters=None, limit: int = 10_000) -> List[dict]:
    rt = _runtime()
    with rt.lock:
        actors = list(rt.actors.values())
    rows = [{
        "actor_id": a.actor_id.hex(),
        "class_name": a.cls.__name__,
        "state": a.status,
        "name": a.name or "",
        "node_id": a.node_id.hex() if a.node_id else None,
        "restarts": a.restart_count,
    } for a in actors]
    return _filtered(rows, filters, limit)


def list_objects(filters=None, limit: int = 10_000) -> List[dict]:
    rt = _runtime()
    with rt.lock:
        locations = dict(rt.object_locations)
    rows = []
    for oid, nid in locations.items():
        node = rt.nodes.get(nid)
        entry = {
            "object_id": oid.hex(),
            "node_id": nid.hex(),
            "ref_count": rt.reference_counter.count(oid),
        }
        if node is not None:
            entry["in_store"] = node.store.contains(oid)
        rows.append(entry)
    return _filtered(rows, filters, limit)


def list_nodes(filters=None, limit: int = 10_000) -> List[dict]:
    rt = _runtime()
    rows = [{
        "node_id": ns.node_id.hex(),
        "state": "ALIVE" if ns.alive else "DEAD",
        "resources_total": ns.resources.total.to_dict(),
        "resources_available": ns.resources.available.to_dict(),
    } for ns in rt.node_states()]
    return _filtered(rows, filters, limit)


def list_placement_groups(filters=None, limit: int = 10_000) -> List[dict]:
    rt = _runtime()
    with rt.lock:
        pgs = list(rt.placement_groups.values())
    rows = [{
        "placement_group_id": pg.pg_id.hex(),
        "state": pg.state,
        "strategy": pg.strategy,
        "bundles": [b.to_dict() for b in pg.bundles],
    } for pg in pgs]
    return _filtered(rows, filters, limit)


def summarize_tasks() -> Dict[str, Any]:
    rows = list_tasks()
    by_state = _Counter(r["state"] for r in rows)
    by_name = _Counter(r.get("name", "?") for r in rows)
    return {"total": len(rows), "by_state": dict(by_state),
            "by_func_name": dict(by_name.most_common(20))}


def summarize_actors() -> Dict[str, Any]:
    rows = list_actors()
    return {"total": len(rows),
            "by_state": dict(_Counter(r["state"] for r in rows)),
            "by_class": dict(_Counter(r["class_name"] for r in rows))}


def list_events(limit: int = 10_000) -> List[dict]:
    return _runtime().events()[-limit:]
