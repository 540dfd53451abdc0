"""Read the device out of a ``torch.profiler`` trace.

The profiler traces every operation the card runs in the process (CUPTI),
whatever thread launched it. Its timestamps are on the host's wall clock,
so a driver marks its own host spans (a step, a batch's forward) with
``time.time_ns()`` and they line up with the device's operations.

A trace here is reduced to:
- ``ops``: ``(name, start_ns, end_ns)`` of every kernel, copy and set the
  device ran inside the traced window;
- ``busy_s``: the union of those intervals; ``window_s``: the window;
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: the ten longest stretches with nothing on the device, each
  named by the innermost host span around its middle.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Iterable, List, Optional, Sequence, Tuple

Op = Tuple[str, int, int]
Span = Tuple[str, int, int]


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def device_ops(prof, w0: int, w1: int) -> List[Op]:
    """Every device operation of a stopped profiler that starts inside
    ``[w0, w1]`` (ns), clipped to it, by start. The device projections of
    ``record_function`` ranges are not operations and are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s = e.start_ns()
        if w0 <= s <= w1:
            out.append((e.name(), s, min(s + e.duration_ns(), w1)))
    out.sort(key=lambda o: o[1])
    return out


def union(ops: Iterable[Op]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(ops: Sequence[Op]) -> int:
    return sum(e - s for s, e in union(ops))


def short_name(name: str) -> str:
    """A kernel's name without its arguments: the identifier of a mangled
    symbol, or a demangled name cut at its parameter list."""
    m = re.match(r"_Z(\d+)", name)
    if m:
        return name[m.end():m.end() + int(m.group(1))]
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0][:120]


def top_ops(ops: Sequence[Op], n: int = 10) -> List[list]:
    total = defaultdict(int)
    for name, s, e in ops:
        total[short_name(name)] += e - s
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in ranked]


def idle_gaps(ops: Sequence[Op], w0: int, w1: int, spans: Sequence[Span],
              n: int = 10) -> List[list]:
    """The ``n`` longest stretches of ``[w0, w1]`` with nothing on the
    device, each named by the host span that started last among those
    around the stretch's middle."""
    gaps, t = [], w0
    for s, e in union(ops):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) // 2
        around = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = max(around, key=lambda sp: sp[1])[0] if around else "no span"
        out.append([name, (e - s) * 1e-9])
    return out


def matching_seconds(ops: Sequence[Op], patterns,
                     spans: Optional[Sequence[Tuple[int, int]]] = None
                     ) -> float:
    """Device seconds of the operations whose name a pattern finds, that
    start inside one of ``spans`` (all of them without)."""
    ns = 0
    for name, s, e in ops:
        if not any(p.search(name) for p in patterns):
            continue
        if spans is None or any(a <= s <= b for a, b in spans):
            ns += e - s
    return ns * 1e-9


def summarize(prof, w0: int, w1: int, spans: Sequence[Span]) -> dict:
    ops = device_ops(prof, w0, w1)
    return {"ops": ops, "w0": w0, "w1": w1,
            "window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns(ops) * 1e-9,
            "device_ops": top_ops(ops),
            "idle_gaps": idle_gaps(ops, w0, w1, spans)}
