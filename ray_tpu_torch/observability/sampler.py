"""Low-overhead periodic stack sampler (pure-Python, per process).

A daemon thread wakes at ``perf_sampler_hz`` and walks
``sys._current_frames()``, folding each thread's stack into a
``file:func;file:func;...`` string (root first) and bumping its count.
Cost per tick is a few frame-pointer chases per live thread — at the
default ~19 Hz that is well under the 2% overhead budget enforced by
``bench_micro.py``'s ``sampler_overhead_pct`` row.

Trace tagging: when :data:`TAGGING` is on, ``observability.span`` pushes
the active trace id into a per-thread stack here on enter and pops on
exit; a sample that lands while a thread is inside a span is attributed
to that trace.  The hooks are two dict operations and only run when a
sampler wants them, so tracing's own overhead budget is unaffected.

Profiles are cumulative since :func:`start` (or the last
:func:`reset`).  Windowed profiles — ``/api/profile?seconds=N`` — are
computed by the dashboard head as the difference of two cumulative
snapshots, which keeps this module free of timers and the wire protocol
free of new fields.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import _config

# Flipped by start()/stop(); observability.span consults it before
# touching the trace-stack map so span cost stays flat when no sampler
# is running.
TAGGING: bool = False

# tid -> stack of active trace ids for that thread.  Mutated only by the
# owning thread (span enter/exit), read by the sampler thread; every
# operation is a single dict/list op under the GIL.
_trace_stacks: Dict[int, List[str]] = {}


def note_span_enter(trace_id: str) -> None:
    _trace_stacks.setdefault(threading.get_ident(), []).append(trace_id)  # raylint: allow(data-race) single dict/list op under the GIL (see module note); the sampler reads a best-effort snapshot


def note_span_exit() -> None:
    tid = threading.get_ident()
    stack = _trace_stacks.get(tid)
    if stack:
        stack.pop()
        if not stack:
            _trace_stacks.pop(tid, None)  # raylint: allow(data-race) single dict op under the GIL (see module note); the sampler reads a best-effort snapshot


_MAX_DEPTH = 64


class StackSampler:
    """One sampling thread; counts keyed (folded stack, trace id)."""

    def __init__(self, hz: float):
        self.hz = float(hz)
        self._counts: Dict[Tuple[str, str], int] = {}  # raylint: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_s = 0.0
        self._ticks = 0  # raylint: guarded-by(self._lock)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "StackSampler":
        if self._thread is not None:
            return self
        self._started_s = time.time()
        self._thread = threading.Thread(
            target=self._run, name="perf-sampler", daemon=True)
        self._thread.start()
        global TAGGING
        TAGGING = True
        return self

    def stop(self) -> None:
        global TAGGING
        TAGGING = False
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- sampling loop ---------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / max(self.hz, 0.1)
        me = threading.get_ident()
        while not self._stop.wait(interval):
            self._sample_once(me)

    def _sample_once(self, skip_tid: int) -> None:
        frames = sys._current_frames()
        rows: List[Tuple[str, str]] = []
        for tid, frame in frames.items():
            if tid == skip_tid:
                continue
            parts: List[str] = []
            f = frame
            depth = 0
            while f is not None and depth < _MAX_DEPTH:
                code = f.f_code
                parts.append(
                    f"{os.path.basename(code.co_filename)}:{code.co_name}")
                f = f.f_back
                depth += 1
            parts.reverse()
            stack = _trace_stacks.get(tid)
            trace = stack[-1] if stack else ""
            rows.append((";".join(parts), trace))
        del frames
        with self._lock:
            self._ticks += 1
            for key in rows:
                self._counts[key] = self._counts.get(key, 0) + 1

    # -- read side -------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            samples = [{"stack": k[0], "trace": k[1], "count": c}
                       for k, c in sorted(self._counts.items())]
            ticks = self._ticks
        return {
            "hz": self.hz,
            "ticks": ticks,
            "since_s": self._started_s,
            "duration_s": (time.time() - self._started_s
                           if self._started_s else 0.0),
            "samples": samples,
        }

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._ticks = 0
            self._started_s = time.time()


# -- profile post-processing (also used head-side on federated dicts) --------


def diff_profiles(newer: Dict[str, object],
                  older: Dict[str, object]) -> Dict[str, object]:
    """``newer - older`` per (stack, trace) key: the samples that landed
    in the window between two cumulative snapshots."""
    base: Dict[Tuple[str, str], int] = {
        (str(s["stack"]), str(s.get("trace", ""))): int(s["count"])
        for s in older.get("samples", [])}  # type: ignore[union-attr]
    out = []
    for s in newer.get("samples", []):  # type: ignore[union-attr]
        key = (str(s["stack"]), str(s.get("trace", "")))
        delta = int(s["count"]) - base.get(key, 0)
        if delta > 0:
            out.append({"stack": key[0], "trace": key[1], "count": delta})
    return {
        "hz": newer.get("hz"),
        "ticks": int(newer.get("ticks", 0)) - int(older.get("ticks", 0)),
        "duration_s": (float(newer.get("duration_s", 0.0))
                       - float(older.get("duration_s", 0.0))),
        "samples": out,
    }


def merge_profiles(parts: List[Dict[str, object]]) -> Dict[str, object]:
    """Sum same-keyed samples across processes/hosts."""
    counts: Dict[Tuple[str, str], int] = {}
    ticks = 0
    for p in parts:
        ticks += int(p.get("ticks", 0))
        for s in p.get("samples", []):  # type: ignore[union-attr]
            key = (str(s["stack"]), str(s.get("trace", "")))
            counts[key] = counts.get(key, 0) + int(s["count"])
    return {"ticks": ticks,
            "samples": [{"stack": k[0], "trace": k[1], "count": c}
                        for k, c in sorted(counts.items())]}


def collapsed(profile: Dict[str, object]) -> str:
    """Brendan-Gregg collapsed-stack text (``stack count`` per line),
    trace tags folded together — feed straight to flamegraph.pl."""
    agg: Dict[str, int] = {}
    for s in profile.get("samples", []):  # type: ignore[union-attr]
        agg[str(s["stack"])] = agg.get(str(s["stack"]), 0) + int(s["count"])
    return "\n".join(f"{stack} {c}" for stack, c in sorted(agg.items()))


def pprof_json(profile: Dict[str, object]) -> Dict[str, object]:
    """pprof-shaped JSON: sample_type header + location-list samples."""
    samples = []
    for s in profile.get("samples", []):  # type: ignore[union-attr]
        row: Dict[str, object] = {
            "location": str(s["stack"]).split(";"),
            "value": [int(s["count"])],
        }
        if s.get("trace"):
            row["trace_id"] = s["trace"]
        samples.append(row)
    return {"sample_type": [{"type": "samples", "unit": "count"}],
            "period": (1.0 / float(profile["hz"])
                       if profile.get("hz") else None),
            "samples": samples}


# -- process-wide singleton --------------------------------------------------

_sampler: Optional[StackSampler] = None
_sampler_lock = threading.Lock()


def start(hz: Optional[float] = None) -> Optional[StackSampler]:
    """Start (or return) the process sampler.  ``hz`` defaults to the
    ``perf_sampler_hz`` knob; <= 0 disables and returns None."""
    global _sampler
    if hz is None:
        hz = float(_config.get("perf_sampler_hz"))
    if hz <= 0:
        return None
    with _sampler_lock:
        if _sampler is None:
            _sampler = StackSampler(hz).start()  # raylint: allow(data-race) get_sampler's unlocked peek is a GIL-atomic read of the singleton
        return _sampler


def stop() -> None:
    global _sampler
    with _sampler_lock:
        s = _sampler
        _sampler = None  # raylint: allow(data-race) get_sampler's unlocked peek is a GIL-atomic read of the singleton
    if s is not None:
        s.stop()


def get_sampler() -> Optional[StackSampler]:
    return _sampler


def profile_snapshot() -> Optional[Dict[str, object]]:
    """The running sampler's cumulative profile, or None."""
    s = _sampler
    return s.snapshot() if s is not None else None
