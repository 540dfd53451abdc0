"""Goodput & efficiency ledger: per-job wall-clock attribution.

The perf plane (:mod:`ray_tpu_torch.observability.perf`) answers "how long do
operations take"; this module answers "where does a job's wall-clock
*go*" — the quantity that decides whether preemptible-fleet economics
work (ROADMAP item 2's ``fleet_goodput_pct``).  Every interval of a
job's life in this process is classified into exactly one of the
exclusive categories in :data:`ray_tpu_torch.observability.metric_names
.LEDGER_CATEGORIES`:

``compute``
    Steady-state device/step work.  Mostly attributed implicitly: the
    train session calls :func:`step_mark` once per step, and whatever
    wall time since the previous mark no explicit interval claimed is
    compute.
``compile``
    First-trace (and re-trace) time of jitted entry points, detected by
    :func:`instrument_jit` per abstract argument signature — the runtime
    mirror of lint rule R21 (a second distinct signature for the same
    function is a *recompile* and counted as such).
``data_wait`` / ``collective_wait`` / ``ckpt_stall``
    Explicit :class:`interval` / :func:`account` sites: input pipeline
    stalls, collective/barrier wait in :mod:`ray_tpu_torch.collective`, and
    blocking time on the checkpoint engine's bounded queue.
``restart_downtime``
    Drain / preemption / elastic-restart gaps stamped by
    ``_private/distributed.py`` and the trainer: the time between a
    node's actors checkpointing for eviction and their restore on a
    survivor (wall-clock stamps ride the drain KV record, so the gap is
    measured across processes).
``idle``
    Derived, never accounted directly: wall since the ledger started
    minus everything attributed, clamped at zero.  This makes the
    categories sum to wall-clock by construction.

**Exclusivity** is enforced two ways: nested :class:`interval`\\ s pause
the enclosing interval (inner time is attributed once, to the inner
category), and :func:`account` feeds a per-job "attributed since last
step mark" counter that :func:`step_mark` subtracts before crediting
compute.

Cost model mirrors chaos/tracing/perf: a module-level ``ENABLED`` bool
is all the hot paths touch when the ledger is off (guarded by
``bench_micro.py``'s ``goodput_overhead_pct`` row).  Export rides the
perf plane's channel: :func:`families` emits one Prometheus gauge
family whose non-standard ``"goodput"`` payload carries the raw ledgers
through the JSON ``/api/metrics`` federation; the dashboard head merges
per-node payloads into per-job totals at ``/api/goodput`` with
:func:`merge_payloads`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private.config import _config
from ray_tpu_torch.observability.metric_names import LEDGER_CATEGORIES

# Fast-path switch: instrumented code checks this module bool and
# nothing else when the ledger is off (same pattern as chaos.ENABLED).
ENABLED: bool = bool(_config.get("goodput_enabled"))

CATEGORIES: Tuple[str, ...] = LEDGER_CATEGORIES
_ACCOUNTABLE = frozenset(c for c in CATEGORIES if c != "idle")

DEFAULT_JOB = "default"


def enable() -> None:
    """Turn the ledger on (also flips the config knob so child runtimes
    agree)."""
    global ENABLED
    _config.set("goodput_enabled", True)
    ENABLED = True


def disable() -> None:
    global ENABLED
    _config.set("goodput_enabled", False)
    ENABLED = False


class _Ledger:
    """Accumulated seconds per category for one job in this process.
    Mutated only under the module lock — accounting events are per-step
    / per-wait, not per-operation, so a lock (unlike perf's per-thread
    shards) costs nothing measurable."""

    __slots__ = ("job", "t0", "acc", "attributed", "mark_s",
                 "compile_count", "recompile_count", "signatures")

    def __init__(self, job: str):
        self.job = job
        self.t0 = time.monotonic()
        self.acc: Dict[str, float] = {c: 0.0 for c in _ACCOUNTABLE}
        self.attributed = 0.0       # accounted since the last step mark
        self.mark_s = self.t0
        self.compile_count = 0
        self.recompile_count = 0
        self.signatures: set = set()  # (label, abstract arg signature)


_ledgers: Dict[str, _Ledger] = {}
_lock = threading.Lock()
_job = DEFAULT_JOB


def set_job(job: str) -> None:
    """Set this process's default job label (the train session sets it
    from its run name so multi-job clusters get separate ledgers)."""
    global _job
    _job = job or DEFAULT_JOB


def current_job() -> str:
    return _job


def _ledger(job: Optional[str]) -> _Ledger:
    j = job or _job
    led = _ledgers.get(j)
    if led is None:
        with _lock:
            led = _ledgers.get(j)
            if led is None:
                led = _Ledger(j)
                _ledgers[j] = led
    return led


def account(category: str, seconds: float,
            job: Optional[str] = None) -> None:
    """Attribute ``seconds`` of wall-clock to ``category``.  No-op when
    the ledger is off; prefer gating the clock reads on
    ``goodput.ENABLED`` at the call site so they are free too."""
    if not ENABLED:
        return
    if category not in _ACCOUNTABLE:
        raise ValueError(
            f"unknown ledger category {category!r} (idle is derived); "
            f"declare categories in observability/metric_names.py")
    if seconds <= 0.0:
        return
    led = _ledger(job)
    with _lock:
        led.acc[category] += seconds
        led.attributed += seconds


def step_mark(job: Optional[str] = None) -> float:
    """Close out one training step: wall time since the previous mark
    that no explicit interval/account claimed is credited to
    ``compute``.  Returns the compute seconds attributed."""
    if not ENABLED:
        return 0.0
    led = _ledger(job)
    now = time.monotonic()
    with _lock:
        unattributed = (now - led.mark_s) - led.attributed
        led.mark_s = now
        led.attributed = 0.0
        if unattributed > 0.0:
            led.acc["compute"] += unattributed
            return unattributed
    return 0.0


class interval:
    """Attribute the enclosed wall time to ``category``.

    Context-manager only (the span discipline of R14 applies): the time
    is accounted on every exit path.  Nested intervals are *exclusive*:
    entering an inner interval pauses the enclosing one — the outer
    category accrues only its own time, the inner second is attributed
    once.  Near-free when ``ENABLED`` is off.
    """

    __slots__ = ("category", "job", "_t0", "_open")

    _stack = threading.local()

    def __init__(self, category: str, job: Optional[str] = None):
        if category not in _ACCOUNTABLE:
            raise ValueError(f"unknown ledger category {category!r}")
        self.category = category
        self.job = job
        self._t0 = None
        self._open = False

    def __enter__(self) -> "interval":
        if not ENABLED:
            return self
        _ledger(self.job)  # anchor the wall clock before time accrues
        stack = getattr(interval._stack, "v", None)
        if stack is None:
            stack = interval._stack.v = []
        now = time.monotonic()
        if stack:
            outer = stack[-1]
            if outer._t0 is not None:
                account(outer.category, now - outer._t0, outer.job)
                outer._t0 = None  # paused until this interval closes
        self._t0 = now
        self._open = True
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._open:  # ENABLED was off at __enter__
            return
        now = time.monotonic()
        stack = getattr(interval._stack, "v", None)
        if stack and stack[-1] is self:
            stack.pop()
        if self._t0 is not None:
            account(self.category, now - self._t0, self.job)
            self._t0 = None
        self._open = False
        if stack:
            stack[-1]._t0 = now  # outer resumes accruing


# -- jit compile detection ---------------------------------------------------


def _abstract_one(x: Any) -> Any:
    """Shape/dtype abstraction of one argument — what jax retraces on.
    Values of python scalars don't retrigger tracing, so only their type
    participates; arrays/pytrees reduce to dtype+shape structure."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None:
        return ("arr", str(dtype), tuple(shape))
    if isinstance(x, dict):
        return ("dict", tuple(sorted(
            (str(k), _abstract_one(v)) for k, v in x.items())))
    if isinstance(x, (tuple, list)):
        return ("seq", tuple(_abstract_one(v) for v in x))
    return ("py", type(x).__name__)


def abstract_signature(args: tuple, kwargs: dict) -> Tuple:
    return (_abstract_one(list(args)), _abstract_one(kwargs))


def instrument_jit(fn: Callable, name: Optional[str] = None,
                   job: Optional[str] = None) -> Callable:
    """Wrap a step callable with first-call compile detection.

    The first call per abstract argument signature (shapes/dtypes —
    what XLA keys its executable cache on in the JAX package) is
    attributed to the ``compile`` category and counted. PyTorch runs
    eagerly, so in this package that first call carries the one-time
    costs of a new signature: the lazy ``nvcc`` build of the CUDA
    kernels it launches and the caching allocator's warm-up; a *second* distinct signature for
    the same function is a recompile (the runtime mirror of lint rule
    R21's static shape-stability check) and additionally bumps
    ``recompile_count``.  Steady-state calls pass straight through —
    their time is the step-level ``compute`` accounting's job, so
    nothing is double-counted.
    """
    label = name or getattr(fn, "__name__", "jit") or "jit"

    def wrapper(*args: Any, **kwargs: Any):
        if not ENABLED:
            return fn(*args, **kwargs)
        sig = (label, abstract_signature(args, kwargs))
        led = _ledger(job)
        if sig in led.signatures:
            return fn(*args, **kwargs)
        t0 = time.monotonic()
        with interval("compile", job):
            out = fn(*args, **kwargs)
        dur_ms = (time.monotonic() - t0) * 1e3
        with _lock:
            recompile = any(s[0] == label for s in led.signatures)
            led.signatures.add(sig)
            led.compile_count += 1
            if recompile:
                led.recompile_count += 1
        from ray_tpu_torch.observability import perf
        if perf.ENABLED:
            perf.observe("jit.compile", dur_ms)
        return out

    wrapper.__name__ = getattr(fn, "__name__", "jit")
    wrapper.__wrapped__ = fn  # type: ignore[attr-defined]
    return wrapper


# -- read side ---------------------------------------------------------------


def goodput_pct(cats: Dict[str, float]) -> float:
    """Percent of wall-clock spent in ``compute`` (wall = the category
    sum, idle included)."""
    wall = sum(float(v) for v in cats.values())
    if wall <= 0.0:
        return 0.0
    return 100.0 * float(cats.get("compute", 0.0)) / wall


def snapshot() -> Dict[str, object]:
    """This process's ledgers — the unit that federates.  ``idle`` is
    derived here (wall since start minus everything attributed), so the
    categories sum to ``wall_s`` exactly."""
    now = time.monotonic()
    with _lock:
        jobs: Dict[str, Dict[str, object]] = {}
        for j, led in _ledgers.items():
            attributed = sum(led.acc.values())
            wall = max(now - led.t0, attributed)
            cats = dict(led.acc)
            cats["idle"] = wall - attributed
            jobs[j] = {
                "wall_s": wall,
                "cats": cats,
                "goodput_pct": goodput_pct(cats),
                "compile_count": led.compile_count,
                "recompile_count": led.recompile_count,
            }
    return {"jobs": jobs}


def reset() -> None:
    """Drop every ledger (tests re-enter with a clean slate)."""
    with _lock:
        _ledgers.clear()


def merge_payloads(payloads: Iterable[Dict[str, object]]
                   ) -> Dict[str, Dict[str, object]]:
    """Cross-node federation math: per-job category seconds and wall
    (node-seconds) add; ``goodput_pct`` is recomputed from the merged
    categories, never averaged from per-node percentages."""
    jobs: Dict[str, Dict[str, object]] = {}
    for payload in payloads:
        if not isinstance(payload, dict):
            continue
        for job, rec in (payload.get("jobs") or {}).items():
            if not isinstance(rec, dict):
                continue
            agg = jobs.get(job)
            if agg is None:
                agg = jobs[job] = {
                    "wall_s": 0.0,
                    "cats": {c: 0.0 for c in CATEGORIES},
                    "compile_count": 0,
                    "recompile_count": 0,
                    "nodes": 0,
                }
            agg["wall_s"] += float(rec.get("wall_s", 0.0))
            for c, v in (rec.get("cats") or {}).items():
                agg["cats"][c] = agg["cats"].get(c, 0.0) + float(v)
            agg["compile_count"] += int(rec.get("compile_count", 0))
            agg["recompile_count"] += int(rec.get("recompile_count", 0))
            agg["nodes"] += 1
    for agg in jobs.values():
        agg["goodput_pct"] = goodput_pct(agg["cats"])
    return jobs


# -- export ------------------------------------------------------------------


def families() -> List[Dict[str, object]]:
    """Metrics-snapshot family dicts: one gauge per (job, category),
    plus the raw ``"goodput"`` payload riding the JSON federation the
    same way perf's ``"perf"`` key does."""
    snap = snapshot()
    jobs = snap["jobs"]
    if not jobs:
        return []
    samples = []
    for job, rec in sorted(jobs.items()):  # type: ignore[union-attr]
        for cat in CATEGORIES:
            samples.append(["raytpu_goodput_seconds",
                            [["job", job], ["category", cat]],
                            float(rec["cats"].get(cat, 0.0))])
    return [{
        "name": "raytpu_goodput_seconds",
        "type": "gauge",
        "help": "goodput ledger wall-clock attribution per job/category (s)",
        "samples": samples,
        "goodput": snap,
    }]


def extract_goodput(families_list: Iterable[Dict[str, object]]
                    ) -> Optional[Dict[str, object]]:
    """Pull the raw ``"goodput"`` payload back out of a (possibly
    federated/JSON-round-tripped) metrics snapshot, or None."""
    for fam in families_list:
        p = fam.get("goodput") if isinstance(fam, dict) else None
        if isinstance(p, dict) and "jobs" in p:
            return p
    return None


def _register() -> None:
    from ray_tpu_torch.util import metrics
    metrics.register_sample_source(families)


_register()
