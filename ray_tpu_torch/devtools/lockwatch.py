"""Runtime lock-order watchdog.

The runtime's threads-as-workers stance means deadlock safety rests on
every pair of locks being taken in one consistent order across all
threads.  This module checks that *empirically*: when installed it wraps
``threading.Lock``/``threading.RLock`` creation (for callers inside the
ray_tpu_torch package and its test suite) in a proxy that records, per thread,
which locks are held when another is acquired.  Those observations form a
directed graph over lock *creation sites*; a cycle in the graph is a
potential deadlock even if no run has hit it yet.  It also flags holds
longer than a threshold — long holds under the device-owner daemon stall
every worker thread behind them.

Activation::

    RAY_TPU_LOCKWATCH=1 python -m pytest tests/ ...          # any workload
    RAY_TPU_LOCKWATCH_OUT=/tmp/lockwatch.json ...            # JSON report
    RAY_TPU_LOCKWATCH_HOLD_S=0.5 ...                         # hold threshold
    RAY_TPU_LOCKWATCH_ALL=1 ...                              # wrap every caller

``ray_tpu_torch/__init__`` installs the watchdog before importing any submodule
when ``RAY_TPU_LOCKWATCH`` is set, so module-level locks are wrapped too.
At process exit a one-line summary goes to stderr (details when cycles
were seen) and, if ``RAY_TPU_LOCKWATCH_OUT`` is set, the full report is
written there as JSON.  Its lines start ``LOCKWATCH[ray_tpu_torch]``:
a process that imports the JAX package as well (the port's tests do)
runs that package's watchdog beside this one, under the same variables,
and each summary names its package.  Either watchdog may install first:
this one creates its locks from the raw primitives and finds a lock's
creator past any other watchdog's factory frame, so the two never wrap
each other's proxies or misattribute a site.

Two cycle granularities:

- **cross-site**: lock site A was held while acquiring site B somewhere,
  and B while acquiring A somewhere else — the classic ABBA.
- **same-site**: two *instances* created at the same line were each held
  while acquiring the other.  Site-level analysis cannot order these, so
  the proxy tracks instance pairs; a consistent hierarchy (always parent
  before child) stays clean, an inversion is reported.

Unit-test surface: :func:`wrap` wraps a single lock with an explicit
name, no installation required.
"""

from __future__ import annotations

import _thread
import atexit
import functools
import itertools
import json
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["install", "uninstall", "installed", "wrap", "Lock", "RLock",
           "report", "cycles", "reset", "format_cycle", "format_guard",
           "guard", "guard_class", "level"]


def format_cycle(kind: str, sites) -> str:
    """Canonical one-line rendering of a lock-order cycle.

    Shared by the runtime exit report and raylint R11's static findings:
    both identify a cycle by its sorted participant sites, so
    ``CYCLE (site-order): A -> B`` from either tool names the same
    inversion and one allow/fix covers both."""
    return f"CYCLE ({kind}): " + " -> ".join(sites)


def format_guard(field: str, lock: str) -> str:
    """Canonical one-line rendering of a guarded-by violation.

    Shared by raylint R25's static findings and the level-2 runtime
    watchdog (``RAY_TPU_LOCKWATCH=2``): both name the field and its
    declared lock as ``Cls.attr``, so a static finding and a runtime
    report for the same field correlate by string equality on this
    prefix."""
    return f"guarded-by({lock}) violated: {field} accessed " \
           f"without {lock} held"


def level() -> int:
    """Numeric watchdog level from ``RAY_TPU_LOCKWATCH``: 0 = off,
    1 = lock-order graph, 2 = graph + guarded-field assertions (any
    non-integer truthy value reads as 1 for backward compatibility)."""
    raw = os.environ.get("RAY_TPU_LOCKWATCH", "")
    if not raw:
        return 0
    try:
        return int(raw)
    except ValueError:
        return 1

# raw primitives so the watchdog never traces itself
_graph_lock = _thread.allocate_lock()
_tls = threading.local()
_uid_counter = itertools.count(1)

_edges: Dict[Tuple[str, str], int] = {}            # (site_a, site_b) -> count  # raylint: guarded-by(_graph_lock)
_edge_threads: Dict[Tuple[str, str], str] = {}     # example thread name  # raylint: guarded-by(_graph_lock)
_same_site_pairs: Set[Tuple[int, int]] = set()     # (uid_held, uid_acquired)  # raylint: guarded-by(_graph_lock)
_same_site_of: Dict[Tuple[int, int], str] = {}     # pair -> site  # raylint: guarded-by(_graph_lock)
_long_holds: List[dict] = []  # raylint: guarded-by(_graph_lock)
_wrapped_count = 0
_guard_violations: List[dict] = []                 # level-2 findings
_guard_seen: Set[Tuple[str, str]] = set()          # (field, site) dedup
_guard_counter = itertools.count()                 # sampling clock

_orig_lock = None
_orig_rlock = None

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.basename(_PKG_ROOT)
_TAG = f"LOCKWATCH[{_PKG}]"

# The primitives every proxy wraps: never a factory another watchdog
# installed over ``threading.Lock``/``RLock``.
_raw_lock = _thread.allocate_lock
_raw_rlock = getattr(_thread, "RLock", None) or \
    threading._PyRLock  # type: ignore[attr-defined]


def _hold_threshold() -> float:
    try:
        return float(os.environ.get("RAY_TPU_LOCKWATCH_HOLD_S", "1.0"))
    except ValueError:
        return 1.0


def _held_stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _note_acquire(proxy: "_LockProxy") -> None:
    held = _held_stack()
    for entry in held:
        if entry[0] is proxy:       # RLock re-entry: no new ordering info
            entry[2] += 1
            return
    if held:
        with _graph_lock:
            for other, _, _ in held:
                if other._site != proxy._site:
                    key = (other._site, proxy._site)
                    _edges[key] = _edges.get(key, 0) + 1
                    _edge_threads.setdefault(
                        key, threading.current_thread().name)
                else:
                    pair = (other._uid, proxy._uid)
                    _same_site_pairs.add(pair)
                    _same_site_of[pair] = proxy._site
    held.append([proxy, time.monotonic(), 1])


def _note_release(proxy: "_LockProxy", full: bool = False) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is proxy:
            held[i][2] -= 1
            if full or held[i][2] <= 0:
                dt = time.monotonic() - held[i][1]
                del held[i]
                if dt > _hold_threshold():
                    with _graph_lock:
                        _long_holds.append({
                            "site": proxy._site,
                            "seconds": round(dt, 3),
                            "thread": threading.current_thread().name,
                        })
            return
    # release of a lock this thread never acquired (hand-off patterns on
    # primitive locks): nothing to unwind


class _LockProxy:
    """Wraps a primitive lock; mirrors its API, records ordering."""

    __slots__ = ("_inner", "_site", "_uid", "__weakref__")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site
        self._uid = next(_uid_counter)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self) -> None:
        _note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockwatch {type(self._inner).__name__} {self._site}>"


class _RLockProxy(_LockProxy):
    """RLock flavour: also speaks ``Condition``'s private protocol so a
    ``threading.Condition`` built on a wrapped RLock keeps working (and
    keeps the held-stack honest across ``wait()``)."""

    __slots__ = ()

    def _release_save(self):
        _note_release(self, full=True)     # wait() drops all recursion levels
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _note_acquire(self)

    def _is_owned(self):
        return self._inner._is_owned()


def wrap(lock=None, name: Optional[str] = None):
    """Wrap one lock explicitly (tests, ad-hoc probes).

    ``lock`` defaults to a fresh primitive lock; ``name`` defaults to the
    caller's ``file:line`` site.
    """
    global _wrapped_count
    if lock is None:
        lock = _raw_lock()
    site = name or _caller_site(2)
    with _graph_lock:
        _wrapped_count += 1
    if hasattr(lock, "_is_owned") or "RLock" in type(lock).__name__:
        return _RLockProxy(lock, site)
    return _LockProxy(lock, site)


def _frame_site(frame) -> str:
    path = frame.f_code.co_filename
    rel = os.path.basename(os.path.dirname(path)) + "/" + os.path.basename(path)
    return f"{rel}:{frame.f_lineno}"


def _caller_site(depth: int) -> str:
    return _frame_site(sys._getframe(depth))


def _is_watchdog_frame(frame) -> bool:
    """A frame inside some package's ``devtools/lockwatch.py`` factory."""
    path = frame.f_code.co_filename.replace(os.sep, "/")
    return path.endswith("/devtools/lockwatch.py")


def _creator_frame():
    """The frame that asked for a lock: the factory's caller, past any
    other watchdog's factory that forwarded the call here."""
    frame = sys._getframe(2)
    while frame.f_back is not None and _is_watchdog_frame(frame):
        frame = frame.f_back
    return frame


def _should_wrap(filename: str) -> bool:
    if os.environ.get("RAY_TPU_LOCKWATCH_ALL"):
        return True
    norm = filename.replace(os.sep, "/")
    return filename.startswith(_PKG_ROOT + os.sep) or "/tests/" in norm


def Lock():
    """Factory installed over ``threading.Lock``."""
    global _wrapped_count
    inner = _raw_lock()
    frame = _creator_frame()
    if not _should_wrap(frame.f_code.co_filename):
        return inner
    with _graph_lock:
        _wrapped_count += 1
    return _LockProxy(inner, _frame_site(frame))


def RLock():
    """Factory installed over ``threading.RLock``."""
    global _wrapped_count
    inner = _raw_rlock()
    frame = _creator_frame()
    if not _should_wrap(frame.f_code.co_filename):
        return inner
    with _graph_lock:
        _wrapped_count += 1
    return _RLockProxy(inner, _frame_site(frame))


def installed() -> bool:
    return _orig_lock is not None


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` with recording factories.

    Locks created by callers outside the ray_tpu_torch package and its tests
    are returned unwrapped (stdlib and third-party internals keep their
    raw primitives) unless ``RAY_TPU_LOCKWATCH_ALL`` is set.
    """
    global _orig_lock, _orig_rlock
    if installed():
        return
    _orig_lock = threading.Lock
    _orig_rlock = threading.RLock
    threading.Lock = Lock
    threading.RLock = RLock
    atexit.register(_exit_report)


def uninstall() -> None:
    global _orig_lock, _orig_rlock
    if not installed():
        return
    threading.Lock = _orig_lock
    threading.RLock = _orig_rlock
    _orig_lock = _orig_rlock = None
    atexit.unregister(_exit_report)


# -- RPC boundary pseudo-sites ---------------------------------------------
#
# Runtime counterpart to raylint R19's lock-held-across-RPC arm.  A
# synchronous RPC wait and a handler execution are modeled as pseudo-lock
# sites named ``rpc:<METHOD>``: a wrapped lock held across a blocking
# ``call()`` records the order edge ``lock-site -> rpc:M``, and a lock
# the M handler takes while running records ``rpc:M -> lock-site`` — two
# peers doing both close a ``CYCLE (site-order)`` over exactly the sites
# R19 names statically, so one fix/allow covers both reports.

def rpc_client_wait(site: str) -> None:
    """This thread is about to block on a synchronous RPC (*site* is
    ``rpc:<METHOD>``); order every currently-held wrapped lock before it."""
    held = _held_stack()
    if not held:
        return
    with _graph_lock:
        for other, _, _ in held:
            if other._site != site:
                key = (other._site, site)
                _edges[key] = _edges.get(key, 0) + 1
                _edge_threads.setdefault(
                    key, threading.current_thread().name)


def rpc_handler_enter(site: str) -> "_LockProxy":
    """A handler for *site* (``rpc:<METHOD>``) starts on this thread:
    push a pseudo-lock so locks it acquires order after the method.
    Returns a token for :func:`rpc_handler_exit`."""
    proxy = _LockProxy(_raw_lock(), site)
    _note_acquire(proxy)
    return proxy


def rpc_handler_exit(token: "_LockProxy") -> None:
    _note_release(token, full=True)


# -- guarded-field watchdog (level 2) ----------------------------------------
#
# Runtime mirror of raylint R25: at RAY_TPU_LOCKWATCH=2 the
# :func:`guard` class decorator turns every field declared with a
# ``# raylint: guarded-by(...)`` comment into a checking descriptor that
# samples get/set and asserts the declared lock is held by the accessing
# thread.  Violations print at exit in :func:`format_guard`'s one-line
# format — the same string R25 embeds in its static findings — so a live
# report and a static finding for the same field correlate directly.
# Below level 2 the decorator is an exact no-op (zero import-time and
# zero per-access cost).

_GUARD_DECL_RE = re.compile(
    r"self\.(\w+)\s*(?::[^=#\n]+)?=[^#\n]*#\s*raylint:\s*"
    r"guarded-by\(([^)]+)\)")


def _guard_sample() -> int:
    """Check 1 in N guarded accesses (``RAY_TPU_LOCKWATCH_SAMPLE``,
    default 1 = every access)."""
    try:
        return max(1, int(os.environ.get("RAY_TPU_LOCKWATCH_SAMPLE", "1")))
    except ValueError:
        return 1


def _lock_held_here(lock) -> Optional[bool]:
    """Best-effort: does the *current thread* hold *lock*?  None when the
    primitive cannot answer.  A raw (unwrapped) Lock cannot attribute its
    owner, so ``locked()`` under-reports violations rather than inventing
    one while another thread legitimately holds it."""
    if isinstance(lock, _RLockProxy):
        return bool(lock._is_owned())
    if isinstance(lock, _LockProxy):
        return any(entry[0] is lock for entry in _held_stack())
    if hasattr(lock, "_is_owned"):
        try:
            return bool(lock._is_owned())
        except Exception:  # raylint: allow(swallow) foreign lock type; unknown ownership reported as None
            return None
    if hasattr(lock, "locked"):
        try:
            return bool(lock.locked())
        except Exception:  # raylint: allow(swallow) foreign lock type; unknown ownership reported as None
            return None
    return None


class _GuardedField:
    """Data descriptor over one declared field: get/set store through the
    instance ``__dict__`` and (sampled) assert the declared lock is held.
    Checks are armed only after ``__init__`` completes — construction
    writes touch an instance no other thread can see yet, matching the
    static rule's fresh-instance exemption."""

    __slots__ = ("_attr", "_field", "_lock_attr", "_lock_global",
                 "_lock_disp", "_module")

    def __init__(self, cls_name: str, module: str, attr: str,
                 lock_text: str):
        self._attr = attr
        self._field = f"{cls_name}.{attr}"
        self._module = module
        lock_text = lock_text.strip()
        if lock_text.startswith("self."):
            self._lock_attr: Optional[str] = lock_text[5:]
            self._lock_global: Optional[str] = None
            self._lock_disp = f"{cls_name}.{self._lock_attr}"
        else:
            self._lock_attr = None
            self._lock_global = lock_text.rsplit(".", 1)[-1]
            self._lock_disp = lock_text

    def _resolve_lock(self, obj):
        if self._lock_attr is not None:
            return obj.__dict__.get(self._lock_attr)
        mod = sys.modules.get(self._module)
        return getattr(mod, self._lock_global, None) \
            if mod is not None else None

    def _check(self, obj) -> None:
        if not obj.__dict__.get("_lockwatch_guard_ready"):
            return
        if next(_guard_counter) % _guard_sample():
            return
        lock = self._resolve_lock(obj)
        if lock is None:
            return
        if _lock_held_here(lock) is not False:
            return
        site = _caller_site(3)
        dedup = (self._field, site)
        with _graph_lock:
            if dedup in _guard_seen:
                return
            _guard_seen.add(dedup)
            _guard_violations.append({
                "field": self._field, "lock": self._lock_disp,
                "site": site,
                "thread": threading.current_thread().name})

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj)
        try:
            return obj.__dict__[self._attr]
        except KeyError:
            raise AttributeError(self._attr) from None

    def __set__(self, obj, value) -> None:
        self._check(obj)
        obj.__dict__[self._attr] = value

    def __delete__(self, obj) -> None:
        obj.__dict__.pop(self._attr, None)


def guard_class(cls):
    """Instrument *cls* unconditionally (unit-test surface — the
    level-gated entry point is :func:`guard`): every field its source
    declares with ``# raylint: guarded-by(...)`` becomes a checking
    :class:`_GuardedField`, and ``__init__`` is wrapped to arm the checks
    once construction finishes."""
    import inspect
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return cls
    decls: Dict[str, str] = {}
    for line in src.splitlines():
        m = _GUARD_DECL_RE.search(line)
        if m:
            decls.setdefault(m.group(1), m.group(2))
    if not decls:
        return cls
    for attr, lock_text in decls.items():
        setattr(cls, attr, _GuardedField(cls.__name__, cls.__module__,
                                         attr, lock_text))
    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def _armed_init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        self.__dict__["_lockwatch_guard_ready"] = True

    cls.__init__ = _armed_init
    return cls


def guard(cls):
    """Class decorator: at ``RAY_TPU_LOCKWATCH=2`` instrument the class's
    guarded-by-declared fields (see :func:`guard_class`); below level 2,
    return the class untouched."""
    if level() < 2:
        return cls
    return guard_class(cls)


def guard_violations() -> List[dict]:
    with _graph_lock:
        return list(_guard_violations)


def reset() -> None:
    """Clear all recorded observations (keeps installation state)."""
    global _wrapped_count
    with _graph_lock:
        _edges.clear()
        _edge_threads.clear()
        _same_site_pairs.clear()
        _same_site_of.clear()
        _long_holds.clear()
        _guard_violations.clear()
        _guard_seen.clear()
        _wrapped_count = 0


def _sccs(nodes: List[str], succ: Dict[str, List[str]]) -> List[List[str]]:
    """Iterative Tarjan strongly-connected components."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = itertools.count()

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ.get(root, ())))]
        index[root] = low[root] = next(counter)
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = next(counter)
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(succ.get(nxt, ()))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def cycles() -> List[dict]:
    """Cycles in the observed lock-order graph (potential deadlocks)."""
    with _graph_lock:
        edge_keys = list(_edges)
        same_pairs = set(_same_site_pairs)
        same_of = dict(_same_site_of)
    succ: Dict[str, List[str]] = {}
    nodes: Set[str] = set()
    for a, b in edge_keys:
        succ.setdefault(a, []).append(b)
        nodes.update((a, b))
    found: List[dict] = []
    for comp in _sccs(sorted(nodes), succ):
        if len(comp) > 1:
            found.append({"kind": "site-order", "sites": sorted(comp)})
    reported: Set[Tuple[int, int]] = set()
    for a, b in same_pairs:
        if (b, a) in same_pairs and (b, a) not in reported:
            reported.add((a, b))
            found.append({"kind": "same-site-inversion",
                          "sites": [same_of[(a, b)]]})
    return found


def report() -> dict:
    with _graph_lock:
        edges = [{"from": a, "to": b, "count": n,
                  "thread": _edge_threads.get((a, b), "")}
                 for (a, b), n in sorted(_edges.items())]
        holds = list(_long_holds)
        wrapped = _wrapped_count
        guards = [dict(v) for v in _guard_violations]
    return {"wrapped_locks": wrapped, "edges": edges, "cycles": cycles(),
            "long_holds": holds, "guard_violations": guards}


def _exit_report() -> None:
    rep = report()
    n_cycles = len(rep["cycles"])
    n_guard = len(rep["guard_violations"])
    print(f"{_TAG}: {rep['wrapped_locks']} locks wrapped, "
          f"{len(rep['edges'])} order edges, {n_cycles} cycles, "
          f"{len(rep['long_holds'])} long holds, "
          f"{n_guard} guard violations", file=sys.stderr)
    for v in rep["guard_violations"]:
        print(f"{_TAG} R25 " + format_guard(v["field"], v["lock"])
              + f" at {v['site']} [{v['thread']}]", file=sys.stderr)
    if n_cycles:
        for cyc in rep["cycles"]:
            print(f"{_TAG} " + format_cycle(cyc["kind"], cyc["sites"]),
                  file=sys.stderr)
        for e in rep["edges"]:
            print(f"{_TAG} edge: {e['from']} -> {e['to']} "
                  f"x{e['count']} [{e['thread']}]", file=sys.stderr)
    out = os.environ.get("RAY_TPU_LOCKWATCH_OUT")
    if out:
        try:
            with open(out, "w", encoding="utf-8") as f:
                json.dump(rep, f, indent=2)
        except OSError as e:
            print(f"{_TAG}: cannot write {out}: {e}", file=sys.stderr)
