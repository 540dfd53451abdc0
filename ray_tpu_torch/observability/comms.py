"""Communication observability plane: the comms ledger.

The task plane can already explain itself (tracing, perf histograms,
goodput attribution); the communication fabric could not — a slow rank
or a degraded peer link surfaced only as undifferentiated
``collective_wait`` goodput.  This module is the per-process comms
ledger behind ``/api/comms``, ``ray-tpu top --comms`` and the doctor's
COMMS section:

- **Op ledger** — every collective op through the public API records
  (group, seq, op, bytes, wire_bytes, dtype, duration) and derives
  algorithm / bus bandwidth NCCL-tests-style (busbw = algbw x 2(n-1)/n
  for allreduce, (n-1)/n for allgather/reducescatter, 1 otherwise).
  ``bytes`` is the logical tensor size; ``wire_bytes`` is what crossed
  the link (quantized payload + scales for compressed groups), and
  algbw/busbw rate the wire while ``logical_gbps`` /
  ``compression_ratio`` keep the application-side view honest.

- **Arrival-skew attribution** — every rank stamps its arrival at the
  rendezvous; the last arrival converts the stamps into per-rank
  "how late after the first arrival" observations.  Those land in
  fixed-layout bucket histograms (``perf.bucket_bounds()``), so the
  cluster merge is exact count addition and ``skew_flags`` can name
  the laggard rank: p95 skew >= ``factor`` x the median of the other
  ranks (and >= 1 ms, below which skew is not actionable).

- **Collective-fingerprint check** — ranks publish (op, shape, dtype)
  per (group, seq); a mismatch raises :class:`CollectiveDivergenceError`
  carrying *both* fingerprints instead of letting the group hang.
  This is the runtime mirror of lint rule R12 (same-op-order check).

- **Link matrix** — ``StripedTransfer`` feeds per peer x consumer
  observed bytes/seconds/chunks plus retry and failover counts;
  GB/s is derived at snapshot time, never stored.

Everything federates exactly like goodput: ``families()`` exports one
gauge family plus the raw payload under a ``"comms"`` key that rides
``/api/metrics`` untouched; the head extracts per-node payloads and
``merge_payloads`` adds seconds/bytes/counts and *recomputes* derived
bandwidths — merged values are exact, never averaged.

Off by knob (``comms_enabled``) the plane is a module-bool check per
op, the same fast-path contract as chaos/tracing/perf/goodput.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.config import _config
from ray_tpu_torch.observability import perf
from ray_tpu_torch.observability.metric_names import COMMS_FAMILY

ENABLED: bool = bool(_config.get("comms_enabled"))


def enable() -> None:
    global ENABLED
    _config.set("comms_enabled", True)
    ENABLED = True


def disable() -> None:
    global ENABLED
    _config.set("comms_enabled", False)
    ENABLED = False


# -- divergence --------------------------------------------------------------


class CollectiveDivergenceError(RuntimeError):
    """Two ranks brought different collectives to the same rendezvous.

    Without the check the group either hangs (cross-process) or computes
    with whichever op description arrived last (threaded rendezvous).
    The error names both ranks and carries both fingerprints so the
    divergence is debuggable from either side.
    """

    def __init__(self, group: str, seq: int,
                 rank_a: int, fp_a: Tuple, rank_b: int, fp_b: Tuple):
        self.group = group
        self.seq = seq
        self.rank_a, self.fingerprint_a = rank_a, fp_a
        self.rank_b, self.fingerprint_b = rank_b, fp_b
        super().__init__(
            f"collective divergence in group {group!r} seq {seq}: "
            f"rank {rank_a} submitted {fp_a!r} but rank {rank_b} "
            f"submitted {fp_b!r} (runtime mirror of lint R12: every rank "
            f"must issue the same collective in the same order)")


def fingerprint(op: Any, shape: Sequence[int], dtype: Any,
                scheme: Any = "none", block: int = 0) -> Tuple:
    """(op, shape, dtype, scheme, block) identity of one rank's collective
    submission. ``scheme``/``block`` are the compression identity
    (``CollectiveConfig``): a rank quantizing q8 payloads into a
    rendezvous where another rank submits f32 is a divergence exactly
    like an op or shape mismatch — the reduction would silently mix
    payload types — so both schemes are named in the raised error."""
    return (str(op), tuple(int(s) for s in shape), str(dtype),
            str(scheme), int(block))


def check_fingerprints(fps: Dict[int, Tuple], group: str = "default",
                       seq: int = 0) -> None:
    """Raise :class:`CollectiveDivergenceError` unless all ranks agree."""
    if not ENABLED or len(fps) < 2:
        return
    it = iter(sorted(fps.items()))
    rank_a, fp_a = next(it)
    for rank_b, fp_b in it:
        if tuple(fp_b) != tuple(fp_a):
            _count_mismatch(group)
            raise CollectiveDivergenceError(group, seq, rank_a, tuple(fp_a),
                                            rank_b, tuple(fp_b))


# -- ledger state ------------------------------------------------------------

# busbw = algbw x factor(world); factors from nccl-tests' performance doc.
_BUSBW = {
    "allreduce": lambda n: 2.0 * (n - 1) / n if n else 1.0,
    "allgather": lambda n: (n - 1) / n if n else 1.0,
    "reducescatter": lambda n: (n - 1) / n if n else 1.0,
}

_RECENT_CAP = 64

_lock = threading.Lock()
_groups: Dict[str, Dict[str, Any]] = {}
_links: Dict[Tuple[str, str], Dict[str, float]] = {}
_recent: List[List[Any]] = []


def _group(name: str) -> Dict[str, Any]:
    g = _groups.get(name)
    if g is None:
        g = _groups[name] = {
            "world_size": 0,
            "seq": 0,
            "mismatches": 0,
            "ops": {},    # op -> {count, bytes, seconds}
            "ranks": {},  # str(rank) -> {arrivals, counts, sum_ms}
        }
    return g


def _count_mismatch(group: str) -> None:
    with _lock:
        _group(group)["mismatches"] += 1


def record_op(group: str, op: str, nbytes: int, dtype: str,
              seconds: float, world_size: int = 0,
              seq: Optional[int] = None,
              wire_bytes: Optional[int] = None) -> None:
    """One completed collective into the op ledger (bandwidths are
    derived at snapshot time from the summed bytes/seconds).

    ``nbytes`` is the *logical* tensor size; ``wire_bytes`` is what
    actually crossed the link when the op shipped compressed payloads
    (quantized blocks + scales). None means wire == logical. Keeping
    both is what makes the ledger honest for compressed collectives:
    algbw/busbw derive from wire bytes (real link usage), while the
    logical rate and the wire/logical compression ratio are derived
    alongside so ``top --comms`` can show all three."""
    if not ENABLED:
        return
    with _lock:
        g = _group(group)
        if world_size:
            g["world_size"] = int(world_size)
        if seq is None:
            seq = g["seq"]
        g["seq"] = max(g["seq"], int(seq) + 1)
        rec = g["ops"].get(op)
        if rec is None:
            rec = g["ops"][op] = {"count": 0, "bytes": 0, "wire_bytes": 0,
                                  "seconds": 0.0}
        rec["count"] += 1
        rec["bytes"] += int(nbytes)
        rec["wire_bytes"] += int(nbytes if wire_bytes is None
                                 else wire_bytes)
        rec["seconds"] += float(seconds)
        _recent.append([group, int(seq), op, int(nbytes), str(dtype),
                        float(seconds) * 1e3])
        del _recent[:-_RECENT_CAP]


def record_arrivals(group: str, skew_by_rank: Dict[int, float],
                    world_size: int = 0) -> None:
    """Per-rank arrival skew (seconds after the first arrival) for one
    rendezvous, folded into fixed-layout lateness histograms."""
    if not ENABLED:
        return
    bounds = perf.bucket_bounds()
    with _lock:
        g = _group(group)
        if world_size:
            g["world_size"] = int(world_size)
        for rank, skew_s in skew_by_rank.items():
            r = g["ranks"].get(str(rank))
            if r is None:
                r = g["ranks"][str(rank)] = {
                    "arrivals": 0, "counts": [0] * len(bounds),
                    "sum_ms": 0.0}
            ms = max(0.0, float(skew_s)) * 1e3
            r["arrivals"] += 1
            r["counts"][bisect_left(bounds, ms)] += 1
            r["sum_ms"] += ms


def link_observe(peer: str, consumer: str, *, nbytes: int = 0,
                 seconds: float = 0.0, chunks: int = 0,
                 retries: int = 0, failovers: int = 0) -> None:
    """Fold one striped-transfer observation into the peer x consumer
    link matrix (GB/s derived at snapshot, never stored)."""
    if not ENABLED:
        return
    key = (str(peer), str(consumer))
    with _lock:
        rec = _links.get(key)
        if rec is None:
            rec = _links[key] = {"bytes": 0, "seconds": 0.0, "chunks": 0,
                                 "retries": 0, "failovers": 0}
        rec["bytes"] += int(nbytes)
        rec["seconds"] += float(seconds)
        rec["chunks"] += int(chunks)
        rec["retries"] += int(retries)
        rec["failovers"] += int(failovers)


# -- snapshot / merge --------------------------------------------------------


def _derive_ops(ops: Dict[str, Dict[str, Any]],
                world: int) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for op, rec in ops.items():
        secs = float(rec.get("seconds", 0.0))
        nbytes = int(rec.get("bytes", 0))
        # pre-compression records carry no wire column: wire == logical
        wire = int(rec.get("wire_bytes", nbytes) or nbytes)
        algbw = (wire / secs / 1e9) if secs > 0 else 0.0
        factor = _BUSBW.get(op, lambda n: 1.0)(world)
        out[op] = {"count": int(rec.get("count", 0)), "bytes": nbytes,
                   "wire_bytes": wire, "seconds": secs,
                   # algbw/busbw rate the LINK (wire bytes); logical_gbps
                   # rates the application-visible tensor throughput —
                   # for compressed ops it exceeds algbw by 1/ratio
                   "algbw_gbps": algbw, "busbw_gbps": algbw * factor,
                   "logical_gbps": (nbytes / secs / 1e9) if secs > 0
                   else 0.0,
                   "compression_ratio": (wire / nbytes) if nbytes else 1.0}
    return out


def _derive_links(links: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for key, rec in links.items():
        secs = float(rec.get("seconds", 0.0))
        nbytes = int(rec.get("bytes", 0))
        d = dict(rec)
        d["gbps"] = (nbytes / secs / 1e9) if secs > 0 else 0.0
        out[key] = d
    return out


def snapshot() -> Dict[str, Any]:
    """JSON-safe copy of this process's ledger: groups (ops + per-rank
    lateness histograms + histogram bounds), link matrix, recent ops."""
    with _lock:
        groups: Dict[str, Any] = {}
        for name, g in _groups.items():
            groups[name] = {
                "world_size": g["world_size"],
                "seq": g["seq"],
                "mismatches": g["mismatches"],
                "ops": _derive_ops(g["ops"], g["world_size"]),
                "ranks": {r: dict(rec, counts=list(rec["counts"]))
                          for r, rec in g["ranks"].items()},
            }
        payload: Dict[str, Any] = {
            "groups": groups,
            "links": {f"{p}|{c}": dict(rec)
                      for (p, c), rec in _links.items()},
            "recent": [list(r) for r in _recent],
        }
    payload["bounds"] = list(perf.bucket_bounds()[:-1])  # drop the inf cap
    return payload


def reset() -> None:
    with _lock:
        _groups.clear()
        _links.clear()
        del _recent[:]


def merge_payloads(payloads: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Exact cluster merge of per-node ``snapshot()`` payloads: bytes,
    seconds, counts and bucket counts add; bandwidths are recomputed
    from the sums (never averaged).  Malformed payloads are skipped —
    a degraded node must not poison the fleet view."""
    groups: Dict[str, Dict[str, Any]] = {}
    links: Dict[str, Dict[str, float]] = {}
    recent: List[List[Any]] = []
    bounds: Optional[List[float]] = None
    for p in payloads:
        if not isinstance(p, dict):
            continue
        if bounds is None and isinstance(p.get("bounds"), list):
            bounds = list(p["bounds"])
        for name, g in (p.get("groups") or {}).items():
            if not isinstance(g, dict):
                continue
            m = groups.setdefault(name, {"world_size": 0, "seq": 0,
                                         "mismatches": 0, "ops": {},
                                         "ranks": {}})
            m["world_size"] = max(m["world_size"],
                                  int(g.get("world_size") or 0))
            m["seq"] = max(m["seq"], int(g.get("seq") or 0))
            m["mismatches"] += int(g.get("mismatches") or 0)
            for op, rec in (g.get("ops") or {}).items():
                if not isinstance(rec, dict):
                    continue
                t = m["ops"].setdefault(op, {"count": 0, "bytes": 0,
                                             "wire_bytes": 0,
                                             "seconds": 0.0})
                t["count"] += int(rec.get("count") or 0)
                t["bytes"] += int(rec.get("bytes") or 0)
                # nodes predating the wire column report wire == logical
                t["wire_bytes"] += int(rec.get("wire_bytes")
                                       or rec.get("bytes") or 0)
                t["seconds"] += float(rec.get("seconds") or 0.0)
            for rank, rec in (g.get("ranks") or {}).items():
                if not isinstance(rec, dict):
                    continue
                t = m["ranks"].get(rank)
                if t is None:
                    t = m["ranks"][rank] = {"arrivals": 0, "counts": [],
                                            "sum_ms": 0.0}
                t["arrivals"] += int(rec.get("arrivals") or 0)
                t["counts"] = perf.merge_counts(
                    [t["counts"], rec.get("counts") or []])
                t["sum_ms"] += float(rec.get("sum_ms") or 0.0)
        for key, rec in (p.get("links") or {}).items():
            if not isinstance(rec, dict):
                continue
            t = links.setdefault(key, {"bytes": 0, "seconds": 0.0,
                                       "chunks": 0, "retries": 0,
                                       "failovers": 0})
            for k in t:
                t[k] += type(t[k])(rec.get(k) or 0)
        if isinstance(p.get("recent"), list):
            recent.extend(r for r in p["recent"] if isinstance(r, list))
    for g in groups.values():
        g["ops"] = _derive_ops(g["ops"], g["world_size"])
    return {"groups": groups, "links": _derive_links(links),
            "recent": recent[-_RECENT_CAP:], "bounds": bounds}


# -- attribution -------------------------------------------------------------


def skew_report(groups: Dict[str, Any],
                bounds: Optional[Sequence[float]] = None) -> Dict[str, Any]:
    """Per-group, per-rank arrival-skew summaries (count/mean/p50/p95/p99
    ms) from the merged lateness histograms."""
    if bounds is not None:
        bounds = tuple(bounds) + (float("inf"),)
    out: Dict[str, Any] = {}
    for name, g in (groups or {}).items():
        ranks = {}
        for rank, rec in (g.get("ranks") or {}).items():
            ranks[rank] = perf.summarize(rec.get("counts") or [],
                                         float(rec.get("sum_ms") or 0.0),
                                         bounds)
        if ranks:
            out[name] = ranks
    return out


def skew_flags(groups: Dict[str, Any], factor: float = 3.0,
               min_ms: float = 1.0, min_samples: int = 3,
               bounds: Optional[Sequence[float]] = None
               ) -> List[Dict[str, Any]]:
    """Name laggard ranks: p95 arrival skew >= ``factor`` x the median of
    the *other* ranks' p95 (robust at world-size 2, where a global
    median would be half-poisoned by the laggard itself) and >= ``min_ms``
    (sub-millisecond skew is noise, not a straggler)."""
    import statistics
    flags: List[Dict[str, Any]] = []
    for name, ranks in skew_report(groups, bounds).items():
        if len(ranks) < 2:
            continue
        for rank, summ in sorted(ranks.items()):
            if summ["count"] < min_samples:
                continue
            others = [s["p95_ms"] for r, s in ranks.items() if r != rank]
            med = statistics.median(others)
            p95 = summ["p95_ms"]
            if p95 >= min_ms and p95 >= factor * max(med, 1e-6):
                flags.append({"group": name, "rank": rank,
                              "p95_ms": p95, "median_ms": med,
                              "samples": int(summ["count"])})
    return flags


def link_flags(links: Dict[str, Any], factor: float = 3.0,
               min_chunks: int = 3) -> List[Dict[str, Any]]:
    """Name degraded links: any failover, or observed GB/s below
    1/``factor`` of the median of the other links (>= 2 comparable
    links with >= ``min_chunks`` chunks each, so a lone cold link is
    not an outlier of itself)."""
    import statistics
    flags: List[Dict[str, Any]] = []
    rated = {k: rec for k, rec in (links or {}).items()
             if isinstance(rec, dict)
             and int(rec.get("chunks") or 0) >= min_chunks}
    for key, rec in sorted((links or {}).items()):
        if not isinstance(rec, dict):
            continue
        reasons = []
        if int(rec.get("failovers") or 0) > 0:
            reasons.append(f"{rec['failovers']} failover(s)")
        others = [float(r.get("gbps") or 0.0)
                  for k, r in rated.items() if k != key]
        if (key in rated and len(others) >= 1 and len(rated) >= 2):
            med = statistics.median(others)
            gbps = float(rec.get("gbps") or 0.0)
            if med > 0 and gbps < med / factor:
                reasons.append(
                    f"{gbps:.2f} GB/s vs link median {med:.2f}")
        if reasons:
            peer, _, consumer = key.partition("|")
            flags.append({"link": key, "peer": peer, "consumer": consumer,
                          "gbps": float(rec.get("gbps") or 0.0),
                          "retries": int(rec.get("retries") or 0),
                          "failovers": int(rec.get("failovers") or 0),
                          "why": "; ".join(reasons)})
    return flags


# -- federation --------------------------------------------------------------


def families() -> List[Dict[str, Any]]:
    """Export for the metrics endpoint: one gauge family (per-group,
    per-op bytes moved) plus the raw ledger under the ``"comms"`` key,
    which rides the JSON federation untouched for exact cluster merge
    (the goodput pattern)."""
    snap = snapshot()
    if not snap["groups"] and not snap["links"]:
        return []
    samples = []
    for gname, g in snap["groups"].items():
        for op, rec in g["ops"].items():
            # Tag cardinality is bounded: group names and op names are
            # small fixed sets chosen by the application, not ids.
            samples.append([COMMS_FAMILY,
                            [["group", gname], ["op", op]],
                            float(rec["bytes"])])
    return [{
        "name": COMMS_FAMILY,
        "type": "gauge",
        "help": "bytes moved per collective group x op (comms ledger)",
        "samples": samples,
        "comms": snap,
    }]


def extract_comms(families_list: Any) -> Optional[Dict[str, Any]]:
    """Recover the raw comms payload from a node's /api/metrics families."""
    if not isinstance(families_list, list):
        return None
    for fam in families_list:
        if isinstance(fam, dict) and fam.get("name") == COMMS_FAMILY:
            payload = fam.get("comms")
            if isinstance(payload, dict):
                return payload
    return None


def _register() -> None:
    from ray_tpu_torch.util import metrics
    metrics.register_sample_source(families)


_register()
