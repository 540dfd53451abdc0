"""Continuous performance plane: streaming log-scale latency histograms.

Every hot path — RPC call/connect, task submit→execute, object fetch/push
(per-chunk and per-stripe), checkpoint save/hash/write/commit, serve
dispatch, drain migration — feeds a fixed-bucket HDR-style histogram
here.  Design constraints, in order:

- **Hot-path cost.** A module-level ``ENABLED`` bool is the only thing
  instrumented code touches when the plane is off (the chaos/tracing
  pattern, guarded by ``bench_micro.py``'s ``perf_overhead_pct`` row).
  When on, one ``observe()`` is a bisect over ~64 precomputed bounds
  plus two writes into a shard this thread exclusively owns.
- **Lock-free recording.** Each histogram keeps one shard per writer
  thread (created once under a lock, then owned single-writer).  Readers
  merge shards without stopping writers; a merge may miss an in-flight
  increment, never corrupt one.
- **Mergeable everywhere.** Bucket bounds are fixed at geometric steps
  from 1µs to 60s (``perf_hist_buckets`` bounds, ratio ≈ 1.33 at the
  default 64 → ≤ ~16% relative quantile error), so counts add across
  threads, processes and hosts; the dashboard head federates raw counts
  and computes cluster quantiles from the sum.
- **Exported two ways.** Through :func:`families` each histogram becomes
  a Prometheus ``histogram`` family (cumulative ``_bucket`` + ``_sum`` +
  ``_count``) registered as a :func:`ray_tpu.util.metrics
  .register_sample_source` extra source; each family also carries a raw
  ``"perf"`` payload (bounds + per-bucket counts) that rides the
  existing ``/api/metrics`` JSON federation untouched, so consumers
  (head, ``ray-tpu top``, doctor, ``bench_micro.py --check``) never
  parse ``le`` tags back out of sample rows.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.config import _config

# Fast-path switch: instrumented code checks this module bool and
# nothing else when the plane is off (same pattern as chaos.ENABLED).
ENABLED: bool = bool(_config.get("perf_enabled"))

# Histogram domain: 1µs .. 60s, in milliseconds.  Bucket 0 catches
# everything at/below _MIN_MS, the last bucket is the +inf overflow.
_MIN_MS = 1e-3
_MAX_MS = 60_000.0


def enable() -> None:
    """Turn the plane on (also flips the config knob so child runtimes
    agree)."""
    global ENABLED
    _config.set("perf_enabled", True)
    ENABLED = True


def disable() -> None:
    global ENABLED
    _config.set("perf_enabled", False)
    ENABLED = False


# Dedicated lock: bucket_bounds() runs inside PerfHistogram.__init__,
# which get() constructs while holding _hists_lock — reusing that lock
# here would self-deadlock.
_bounds_lock = threading.Lock()
_bounds_cache: Optional[Tuple[float, ...]] = None  # raylint: guarded-by(_bounds_lock)
# Bumped by reset() so an in-flight bucket_bounds() compute that started
# before the reset cannot publish its now-stale layout over the fresh one.
_bounds_gen = 0  # raylint: guarded-by(_bounds_lock)


def bucket_bounds() -> Tuple[float, ...]:
    """Upper bounds (ms) of every bucket; the last is ``inf``.  Computed
    once from ``perf_hist_buckets`` so every histogram in the process —
    and, config being uniform, the cluster — shares one bucket layout."""
    global _bounds_cache
    b = _bounds_cache  # raylint: allow(guarded-by) double-checked fast path: immutable tuple publish, losers recompute
    while b is None:
        with _bounds_lock:
            gen = _bounds_gen
        n = max(8, int(_config.get("perf_hist_buckets")))
        # n-1 finite bounds spanning [_MIN_MS, _MAX_MS] geometrically.
        ratio = (_MAX_MS / _MIN_MS) ** (1.0 / (n - 2))
        b = tuple(_MIN_MS * ratio ** i for i in range(n - 1)) + (math.inf,)
        with _bounds_lock:
            if _bounds_cache is not None:
                b = _bounds_cache     # another thread won the publish
            elif gen == _bounds_gen:
                _bounds_cache = b
            else:
                b = None              # reset() raced the compute: retry
    return b


def bucket_ratio() -> float:
    b = bucket_bounds()
    return b[1] / b[0]


class _Shard:
    """Single-writer bucket counts for one thread.  No lock: only the
    owning thread mutates, readers tolerate a stale element."""

    __slots__ = ("counts", "sum_ms")

    def __init__(self, n: int):
        self.counts = [0] * n
        self.sum_ms = 0.0


class PerfHistogram:
    """One named latency distribution with per-thread shards."""

    __slots__ = ("name", "_bounds", "_local", "_shards", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._bounds = bucket_bounds()
        self._local = threading.local()
        self._shards: List[_Shard] = []
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = _Shard(len(self._bounds))
            with self._lock:
                self._shards.append(shard)
            self._local.shard = shard
        # bisect_left: first bound >= ms, so a value exactly on a bucket
        # boundary lands in that bucket (Prometheus `le` semantics).
        idx = bisect_left(self._bounds, ms)
        if idx >= len(shard.counts):  # nan or beyond +inf comparison quirks
            idx = len(shard.counts) - 1
        shard.counts[idx] += 1
        shard.sum_ms += ms

    # -- read side (any thread) ------------------------------------------

    def merged(self) -> Tuple[List[int], float]:
        """(bucket counts, sum_ms) summed across shards."""
        with self._lock:
            shards = list(self._shards)
        counts = [0] * len(self._bounds)
        total_ms = 0.0
        for s in shards:
            for i, c in enumerate(s.counts):
                counts[i] += c
            total_ms += s.sum_ms
        return counts, total_ms

    def count(self) -> int:
        return sum(self.merged()[0])


_hists: Dict[str, PerfHistogram] = {}  # raylint: guarded-by(_hists_lock)
_hists_lock = threading.Lock()


def get(name: str) -> PerfHistogram:
    h = _hists.get(name)  # raylint: allow(guarded-by) double-checked fast path: re-checked under the lock below
    if h is None:
        with _hists_lock:
            h = _hists.get(name)
            if h is None:
                h = PerfHistogram(name)
                _hists[name] = h
    return h


def observe(name: str, ms: float) -> None:
    """Record one latency (milliseconds) into histogram ``name``.  No-op
    when the plane is off — but prefer gating the *timing capture* on
    ``perf.ENABLED`` at the call site so the clock reads are free too."""
    if not ENABLED:
        return
    get(name).observe(ms)


def reset() -> None:
    """Drop every histogram and the cached bounds (tests re-enter with a
    different ``perf_hist_buckets``)."""
    global _bounds_cache, _bounds_gen
    with _hists_lock:
        _hists.clear()
    with _bounds_lock:
        _bounds_cache = None
        _bounds_gen += 1


# -- quantiles ---------------------------------------------------------------


def quantile(counts: Sequence[int], q: float,
             bounds: Optional[Sequence[float]] = None) -> float:
    """Estimate the q-quantile (ms) from bucket counts.  The returned
    value is the geometric midpoint of the selected bucket, so the
    relative error is bounded by sqrt(bucket ratio) - 1 (~16% at the
    default 64 buckets)."""
    if bounds is None:
        bounds = bucket_bounds()
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank and c:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            if hi == math.inf:  # overflow bucket: best effort, report max
                return float(bounds[-2])
            if lo <= 0.0:
                return float(hi)
            return float(math.sqrt(lo * hi))
    return float(bounds[-2])


def summarize(counts: Sequence[int], sum_ms: float,
              bounds: Optional[Sequence[float]] = None) -> Dict[str, float]:
    total = sum(counts)
    return {
        "count": float(total),
        "mean_ms": (sum_ms / total) if total else 0.0,
        "p50_ms": quantile(counts, 0.50, bounds),
        "p95_ms": quantile(counts, 0.95, bounds),
        "p99_ms": quantile(counts, 0.99, bounds),
    }


def merge_counts(parts: Iterable[Sequence[int]]) -> List[int]:
    """Element-wise sum of same-layout bucket counts (cross-process or
    cross-host federation)."""
    out: List[int] = []
    for counts in parts:
        if not out:
            out = list(counts)
        else:
            for i, c in enumerate(counts):
                out[i] += c
    return out


# -- export ------------------------------------------------------------------


def snapshot() -> Dict[str, object]:
    """This process's raw histogram state — the unit that federates."""
    with _hists_lock:
        hists = list(_hists.values())
    out: Dict[str, Dict[str, object]] = {}
    for h in hists:
        counts, sum_ms = h.merged()
        if sum(counts) == 0:
            continue
        out[h.name] = {"counts": counts, "sum_ms": sum_ms}
    return {"bounds": list(bucket_bounds()), "hists": out}


def _prom_name(name: str) -> str:
    return "raytpu_perf_" + name.replace(".", "_").replace("-", "_") + "_ms"


def families() -> List[Dict[str, object]]:
    """Metrics-snapshot family dicts, one Prometheus histogram per
    PerfHistogram.  Registered as an extra sample source with
    :mod:`ray_tpu.util.metrics`; the non-standard ``"perf"`` key carries
    the raw counts through JSON federation (``render_federated`` only
    reads name/help/type/samples, so it rides along untouched)."""
    snap = snapshot()
    bounds = snap["bounds"]
    fams: List[Dict[str, object]] = []
    for name, h in sorted(snap["hists"].items()):  # type: ignore[union-attr]
        counts = h["counts"]
        sum_ms = h["sum_ms"]
        pname = _prom_name(name)
        samples = []
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            le = "+Inf" if bounds[i] == math.inf else repr(bounds[i])
            samples.append([pname + "_bucket", [["le", le]], float(cum)])
        samples.append([pname + "_sum", [], float(sum_ms)])
        samples.append([pname + "_count", [], float(cum)])
        fams.append({
            "name": pname,
            "type": "histogram",
            "help": f"perf plane latency for {name} (ms)",
            "samples": samples,
            "perf": {"hist": name, "bounds": list(bounds),
                     "counts": list(counts), "sum_ms": float(sum_ms)},
        })
    return fams


def extract_perf(families_list: Iterable[Dict[str, object]]
                 ) -> Dict[str, Dict[str, object]]:
    """Pull the raw ``"perf"`` payloads back out of a (possibly
    federated/JSON-round-tripped) metrics snapshot: name -> {bounds,
    counts, sum_ms}."""
    out: Dict[str, Dict[str, object]] = {}
    for fam in families_list:
        p = fam.get("perf") if isinstance(fam, dict) else None
        if isinstance(p, dict) and "hist" in p and "counts" in p:
            out[str(p["hist"])] = p
    return out


def _register() -> None:
    from ray_tpu_torch.util import metrics
    metrics.register_sample_source(families)


_register()
