"""Read the program's own spans out of its span ring, inside the traced
window.

The port records request-scoped serving spans (``serve.request``,
``serve.route``, ``serve.queue``, ``serve.batch``, ``serve.forward``) into
the span ring of the process it serves from
(``ray_tpu_torch._private.profiling``), each edge a ``time.time_ns()``
stamp read at that edge: the wall clock the device trace's timestamps are
on (``core/trace.py``). A run's record carries no program spans, so the
metric readers hand these functions the ring of this process, after the
run (``events``: its ``chrome_trace()``; ``dropped``: the spans it let
fall), and they keep the spans that lie inside ``[w0, w1]`` of
``record["trace"]``. Nothing here imports the program.

Every reader returns None where it has nothing to read: no trace, a ring
that dropped spans inside the window, or a program that records no such
span.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from perfbench.core import trace

Span = Tuple[int, int, dict]  # (start ns, end ns, args)


def _ns(us: float) -> int:
    return int(round(us * 1e3))


def window_spans(record: dict, name: str, events: Sequence[dict],
                 dropped: int) -> Optional[List[Span]]:
    """The ``name`` spans of the ring that lie inside the traced window,
    as ``(start_ns, end_ns, args)``; None without a trace, or where the
    ring dropped spans that may have lain inside it."""
    tr = record.get("trace")
    if not tr or "w0" not in tr:
        return None
    w0, w1 = tr["w0"], tr["w1"]
    if dropped and events:
        # The ring drops its oldest spans first, in the order they were
        # recorded (at their end): the window is whole only if the oldest
        # span kept ended before it began.
        first = events[0]
        if _ns(first["ts"] + first.get("dur", 0.0)) > w0:
            return None
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("name") != name:
            continue
        s = _ns(e["ts"])
        end = s + _ns(e["dur"])
        if w0 <= s and end <= w1:
            out.append((s, end, e.get("args") or {}))
    return out


def requests(record: dict, events: Sequence[dict],
             dropped: int) -> Optional[List[Span]]:
    """The window's answered requests: ``serve.request`` spans that carry
    the handle's ``request_id``."""
    got = window_spans(record, "serve.request", events, dropped)
    if got is None:
        return None
    return [sp for sp in got if sp[2].get("request_id")]


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = ns = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        ns += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return ns


def idle_queued_pct(record: dict, events: Sequence[dict],
                    dropped: int) -> Optional[float]:
    """The share of the window in which the device ran no operation while
    at least one request was open: the part of the device's idle time
    that the program, not the arrivals, leaves."""
    reqs = requests(record, events, dropped)
    if not reqs:
        return None
    tr = record["trace"]
    window = tr["w1"] - tr["w0"]
    if window <= 0:
        return None
    open_ = trace.union([("request", s, e) for s, e, _ in reqs])
    busy = trace.union(tr["ops"])
    open_ns = sum(e - s for s, e in open_)
    return 100.0 * (open_ns - _overlap_ns(open_, busy)) / window


def tail_queue_pct(record: dict, events: Sequence[dict],
                   dropped: int) -> Optional[float]:
    """Over the window's requests at or above the 95th percentile of the
    requests' spans: their time in the replica's queue (``serve.queue``,
    joined by ``request_id``) over their time from handle to answer."""
    reqs = requests(record, events, dropped)
    queues = window_spans(record, "serve.queue", events, dropped)
    if not reqs or queues is None:
        return None
    cut = np.percentile([e - s for s, e, _ in reqs], 95)
    tail = {a["request_id"]: e - s for s, e, a in reqs if e - s >= cut}
    total = sum(tail.values())
    if total <= 0:
        return None
    queued = sum(e - s for s, e, a in queues
                 if a.get("request_id") in tail)
    return 100.0 * queued / total
