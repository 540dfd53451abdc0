"""End-to-end distributed tracing: W3C-style context + span recording.

A trace is a ``trace_id`` minted at an entry point (task submit, serve
request, checkpoint save) plus a tree of spans, each ``(span_id,
parent_span_id)``.  The context travels three ways:

- **TaskSpec** — ``trace_id``/``parent_span_id`` fields, so a task's
  worker-side execute span joins the submit-side trace (``runtime.py``).
- **RPC envelope** — ``Envelope.trace`` carries ``"trace_id:span_id"``;
  the server adopts it around handler dispatch (``_private/rpc.py``).
- **RTF5 frame index** — an optional trailing blob in the frame index
  (``_private/framing.py``) stamps serialized objects with the trace
  that produced them, so a striped fetch can attribute the bytes it
  moved.  Absent trace keeps frames byte-identical to the pre-trace
  format (checkpoint chunk dedup depends on this).

Spans land in the process-local :class:`~ray_tpu._private.profiling.Profiler`
ring; the dashboard head federates every host's ring into one merged
chrome://tracing timeline (``/api/timeline``, ``/api/trace?id=X``).

Cost model mirrors :mod:`ray_tpu.chaos`: a module-level ``ENABLED`` bool
is the only thing the hot paths touch when tracing is off (guarded by
``bench_micro.py``'s ``trace_overhead_pct`` gate).  ``enable()`` flips it
and installs the chaos observer so injected faults appear as instant
events inside the traces they perturb.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.profiling import get_profiler
from ray_tpu_torch.observability import sampler as _sampler

# Fast-path switch: hot paths check this module bool and nothing else
# when tracing is off (same pattern as chaos.ENABLED).
ENABLED: bool = bool(_config.get("tracing_enabled"))

# chrome-tracing process label for spans recorded in this process;
# daemons relabel to "node:<hex8>" at startup so the merged timeline
# separates hosts.
_pid_label: str = "driver"

_ctx_var: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("ray_tpu_obs_ctx", default=None)

# Fallback context sources (the runtime registers one that reads its
# per-task thread-local / async ContextVar), consulted when no explicit
# span context is active.  Registration instead of an import keeps
# observability import-light and cycle-free (runtime imports us).
_providers: list = []

Context = Tuple[str, str]  # (trace_id, span_id)


def register_context_provider(fn: Callable[[], Optional[Context]]) -> None:
    if fn not in _providers:
        _providers.append(fn)  # raylint: allow(data-race) providers registered during process bootstrap; iteration sees a GIL-atomic list snapshot


def set_process_label(label: str) -> None:
    global _pid_label
    _pid_label = label  # raylint: allow(data-race) process label set once at bootstrap; plain string store is GIL-atomic


def process_label() -> str:
    return _pid_label


def enable() -> None:
    """Turn tracing on (also flips the config knob so child runtimes and
    ``Profiler.enabled`` agree) and hook chaos instant events."""
    global ENABLED
    _config.set("tracing_enabled", True)
    ENABLED = True
    from ray_tpu_torch import chaos
    chaos.set_observer(_chaos_observer)


def disable() -> None:
    global ENABLED
    _config.set("tracing_enabled", False)
    ENABLED = False
    from ray_tpu_torch import chaos
    chaos.set_observer(None)


def mint_id() -> str:
    """A fresh 64-bit hex id (trace or span)."""
    return os.urandom(8).hex()


def current() -> Optional[Context]:
    """The active (trace_id, span_id), from the innermost enclosing
    ``span(...)`` or, failing that, a registered provider (task ctx)."""
    ctx = _ctx_var.get()
    if ctx is not None:
        return ctx
    for fn in _providers:
        got = fn()
        if got:
            return got
    return None


def current_trace_id() -> str:
    """The active trace id, or ``""``. Cheap enough for log records."""
    if not ENABLED:
        return ""
    ctx = current()
    return ctx[0] if ctx else ""


def set_current(trace_id: str, span_id: str):
    """Explicitly adopt a context; returns a token for :func:`reset`."""
    return _ctx_var.set((trace_id, span_id))


def reset(token) -> None:
    _ctx_var.reset(token)


# -- wire helpers -----------------------------------------------------------

def wire_context() -> str:
    """The active context encoded for the wire (``"trace_id:span_id"``),
    or ``""`` when tracing is off / no context is active."""
    if not ENABLED:
        return ""
    ctx = current()
    return f"{ctx[0]}:{ctx[1]}" if ctx else ""


def parse_wire(ctx_str: str) -> Optional[Context]:
    if not ctx_str:
        return None
    trace_id, sep, span_id = ctx_str.partition(":")
    if not sep or not trace_id:
        return None
    return (trace_id, span_id)


def adopt_wire(ctx_str: str):
    """Adopt a wire-encoded context for the current execution context.
    Returns a reset token, or ``None`` when ``ctx_str`` is empty/bad."""
    ctx = parse_wire(ctx_str)
    if ctx is None:
        return None
    return _ctx_var.set(ctx)


# -- span recording ---------------------------------------------------------

class span:
    """Record a timed span parented under the active context.

    Context-manager only (raylint R14 enforces this outside the
    observability package): the span closes on every exit path, and the
    context var is always reset.  Near-free when ``ENABLED`` is False —
    ``__enter__``/``__exit__`` return after one bool check.
    """

    __slots__ = ("name", "cat", "args", "pid", "_t0", "_ids", "_token",
                 "_tagged")

    def __init__(self, name: str, cat: str = "obs",
                 pid: Optional[str] = None, **args: Any):
        self.name = name
        self.cat = cat
        self.args = args
        self.pid = pid
        self._t0 = None
        self._token = None
        self._tagged = False

    def __enter__(self) -> "span":
        if not ENABLED:
            return self
        parent = current()
        if parent is None:
            trace_id, parent_span = mint_id(), ""
        else:
            trace_id, parent_span = parent
        span_id = mint_id()
        self._ids = (trace_id, span_id, parent_span)
        self._token = _ctx_var.set((trace_id, span_id))
        if _sampler.TAGGING:
            # stack-sampler attribution: samples landing on this thread
            # while the span is open are tagged with its trace id
            _sampler.note_span_enter(trace_id)
            self._tagged = True
        self._t0 = time.time()
        return self

    @property
    def trace_id(self) -> str:
        return self._ids[0] if self._t0 is not None else ""

    @property
    def span_id(self) -> str:
        return self._ids[1] if self._t0 is not None else ""

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._t0 is None:  # ENABLED was off at __enter__
            return
        try:
            dur = time.time() - self._t0
            trace_id, span_id, parent_span = self._ids
            args = dict(self.args)
            args.update(trace_id=trace_id, span_id=span_id,
                        parent_span_id=parent_span)
            if exc_type is not None:
                args["error"] = exc_type.__name__
            get_profiler().record(self.name, self.cat,
                                  pid=self.pid or _pid_label,
                                  start_s=self._t0, dur_s=dur, args=args)
        finally:
            if self._tagged:
                _sampler.note_span_exit()
                self._tagged = False
            _ctx_var.reset(self._token)
            self._t0 = None


def instant(name: str, cat: str = "obs", pid: Optional[str] = None,
            **args: Any) -> None:
    """Record a point-in-time event tagged with the active context."""
    if not ENABLED:
        return
    ctx = current()
    if ctx:
        args.setdefault("trace_id", ctx[0])
        args.setdefault("parent_span_id", ctx[1])
    get_profiler().instant(name, cat, pid=pid or _pid_label, args=args)


def _chaos_observer(point: str, labels: Dict[str, Any], action: str) -> None:
    """Installed into ray_tpu.chaos by enable(): every fired fault becomes
    an instant event carrying the fault spec, interleaved with the spans
    it perturbed."""
    args = {"action": action}
    for k, v in labels.items():
        args[k] = str(v)
    instant(f"chaos:{point}", cat="chaos", **args)


# -- trace querying ---------------------------------------------------------

def spans_for_trace(trace_id: str, events=None) -> list:
    """Filter chrome events down to one trace (spans whose args carry the
    trace_id, plus its instant events)."""
    if events is None:
        events = get_profiler().chrome_trace()
    return [e for e in events
            if (e.get("args") or {}).get("trace_id") == trace_id]
