"""Deterministic fault-injection engine.

A :class:`FaultSchedule` is a seeded, ordered list of rules compiled from a
spec string (``RAY_TPU_CHAOS=<seed>:<spec>``) or built programmatically.
Runtime choke points call :func:`ray_tpu.chaos.inject` with a *point name*
(e.g. ``rpc.client.send``) and labels (``peer=...``, ``method=...``); the
schedule decides — deterministically, as a pure function of the seed and the
sequence of matching events — whether to inject a fault there.

Spec grammar (rules separated by ``;``)::

    rule    := point[ "[" key "=" value-glob "]" ][ "@" trigger ] "=" action
    point   := fnmatch glob over injection-point names
    trigger := N          fire on the Nth matching event only (default 1)
             | N+         fire on the Nth and every later matching event
             | N%M        fire when (count - N) % M == 0 and count >= N
             | pP         fire each event with probability P (seeded RNG)
    action  := delay(SECONDS) | drop | reset | error | error(MSG) | exit
             | exit(CODE)

Examples::

    RAY_TPU_CHAOS="42:rpc.client.send@3=reset"
    RAY_TPU_CHAOS="7:state.call[method=HEARTBEAT]@2%5=drop;object.push@p0.1=delay(0.05)"

Determinism: each rule owns a ``random.Random`` seeded from
``(schedule seed, rule index)`` and a per-rule match counter; probability
rules consume exactly one RNG draw per *matching* event whether or not they
fire, so the decision stream depends only on the seed and the event
sequence. Every fired fault appends one line to an in-memory trace
(:meth:`FaultSchedule.trace_lines`) — two runs over the same event sequence
with the same seed produce byte-identical traces.

This module is intentionally stdlib-only: ``rpc.py`` (the lowest layer)
imports it, so it must not import any ``ray_tpu`` internals.  Chaos
exceptions subclass stdlib ``ConnectionError`` so call sites can translate
them through their normal error paths.
"""

from __future__ import annotations

import fnmatch
import os
import random
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ChaosError", "ChaosConnectionReset", "FaultRule", "FaultSchedule",
    "parse_spec", "parse_env", "register_exit_hook",
]

# Pre-death callbacks for the ``exit`` action, called (point, exit_code)
# right before ``os._exit``. Registration-hook pattern (same reason as the
# observer in ``chaos/__init__``): this module stays stdlib-only, yet the
# flight recorder can seal a crash bundle on the way down — ``exit`` is the
# deterministic stand-in for a SIGKILL'd host, and a hook here is the only
# cleanup that runs (``os._exit`` skips atexit/finally).
_exit_hooks: List = []


def register_exit_hook(fn) -> None:
    """Register ``fn(point, exit_code)`` to run before a chaos ``exit``
    kills the process. Hooks are best-effort: exceptions are swallowed
    (the process is dying either way) and must not block."""
    if fn not in _exit_hooks:
        _exit_hooks.append(fn)  # raylint: allow(data-race) GIL-atomic list append at setup; read once at injected process exit


class ChaosError(RuntimeError):
    """Injected generic failure (``error`` action)."""


class ChaosConnectionReset(ConnectionError):
    """Injected connection reset (``reset`` action).

    Subclasses ``ConnectionError`` so transport layers translate it exactly
    like a real peer reset (``RpcClient`` wraps it into
    ``RpcConnectionError``; the backoff policy classifies it retryable).
    """


_TRIGGER_RE = re.compile(r"^(?:(\d+)(\+)?|(\d+)%(\d+)|p(0?\.\d+|1(?:\.0*)?))$")
_ACTION_RE = re.compile(r"^(delay|drop|reset|error|exit)(?:\((.*)\))?$")


class FaultRule:
    """One compiled rule: point glob + optional label filter + trigger +
    action. Mutable state (match counter, armed flag, RNG) lives here and is
    only touched under the owning schedule's lock."""

    __slots__ = ("point_glob", "label_key", "label_glob", "trig_kind",
                 "trig_n", "trig_m", "trig_p", "action", "arg", "index",
                 "count", "armed", "rng", "spec")

    def __init__(self, point_glob: str, label_key: Optional[str],
                 label_glob: Optional[str], trig_kind: str, trig_n: int,
                 trig_m: int, trig_p: float, action: str, arg, index: int,
                 spec: str):
        self.point_glob = point_glob
        self.label_key = label_key
        self.label_glob = label_glob
        self.trig_kind = trig_kind    # "nth" | "from" | "every" | "prob"
        self.trig_n = trig_n
        self.trig_m = trig_m
        self.trig_p = trig_p
        self.action = action          # "delay"|"drop"|"reset"|"error"|"exit"
        self.arg = arg                # float seconds | str msg | int code
        self.index = index
        self.spec = spec              # original rule text (for traces)
        self.count = 0                # matching events seen so far
        self.armed = True             # one-shot "nth" rules disarm on fire
        self.rng = None               # seeded lazily by the schedule

    def matches(self, point: str, labels: Dict[str, str]) -> bool:
        if not fnmatch.fnmatchcase(point, self.point_glob):
            return False
        if self.label_key is not None:
            val = labels.get(self.label_key)
            if val is None or not fnmatch.fnmatchcase(str(val),
                                                      self.label_glob):
                return False
        return True

    def should_fire(self) -> bool:
        """Call once per matching event (under the schedule lock). Advances
        the counter / RNG stream; returns True when the fault fires."""
        self.count += 1
        k = self.trig_kind
        if k == "prob":
            # Always draw, even when disarmed impossible here (prob rules
            # never disarm): decision stream = f(seed, event ordinal).
            return self.rng.random() < self.trig_p
        if k == "nth":
            if self.armed and self.count == self.trig_n:
                self.armed = False
                return True
            return False
        if k == "from":
            return self.count >= self.trig_n
        # every: N, N+M, N+2M, ...
        return (self.count >= self.trig_n
                and (self.count - self.trig_n) % self.trig_m == 0)


def _parse_rule(text: str, index: int) -> FaultRule:
    src = text.strip()
    if "=" not in src:
        raise ValueError(f"chaos rule {src!r}: missing '=action'")
    lhs, _, action_src = src.partition("=")
    # The first '=' inside [...] belongs to the label filter; re-split if so.
    if "[" in lhs and "]" not in lhs:
        m = re.match(r"^([^\[]+\[[^\]]*\][^=]*)=(.*)$", src)
        if not m:
            raise ValueError(f"chaos rule {src!r}: unbalanced label filter")
        lhs, action_src = m.group(1), m.group(2)
    lhs = lhs.strip()
    action_src = action_src.strip()

    trig_src = "1"
    if "@" in lhs:
        lhs, _, trig_src = lhs.rpartition("@")
        lhs = lhs.strip()
        trig_src = trig_src.strip()

    label_key = label_glob = None
    m = re.match(r"^(.*?)\[([^=\]]+)=([^\]]*)\]$", lhs)
    if m:
        lhs, label_key, label_glob = (m.group(1).strip(), m.group(2).strip(),
                                      m.group(3).strip())
    if not lhs:
        raise ValueError(f"chaos rule {src!r}: empty point glob")

    tm = _TRIGGER_RE.match(trig_src)
    if not tm:
        raise ValueError(f"chaos rule {src!r}: bad trigger {trig_src!r} "
                         "(want N, N+, N%M, or pP)")
    trig_kind, trig_n, trig_m, trig_p = "nth", 1, 1, 0.0
    if tm.group(5) is not None:
        trig_kind, trig_p = "prob", float(tm.group(5))
    elif tm.group(3) is not None:
        trig_kind = "every"
        trig_n, trig_m = int(tm.group(3)), int(tm.group(4))
        if trig_m <= 0:
            raise ValueError(f"chaos rule {src!r}: modulus must be > 0")
    else:
        trig_n = int(tm.group(1))
        trig_kind = "from" if tm.group(2) else "nth"
    if trig_kind in ("nth", "from", "every") and trig_n <= 0:
        raise ValueError(f"chaos rule {src!r}: trigger ordinal must be >= 1")

    am = _ACTION_RE.match(action_src)
    if not am:
        raise ValueError(f"chaos rule {src!r}: bad action {action_src!r} "
                         "(want delay(s)|drop|reset|error[(msg)]|exit[(code)])")
    action, raw_arg = am.group(1), am.group(2)
    arg = None
    if action == "delay":
        if raw_arg is None:
            raise ValueError(f"chaos rule {src!r}: delay needs seconds")
        arg = float(raw_arg)
        if arg < 0:
            raise ValueError(f"chaos rule {src!r}: negative delay")
    elif action == "error":
        arg = raw_arg if raw_arg else "injected fault"
    elif action == "exit":
        arg = int(raw_arg) if raw_arg else 1
    elif raw_arg:
        raise ValueError(f"chaos rule {src!r}: {action} takes no argument")
    return FaultRule(lhs, label_key, label_glob, trig_kind, trig_n, trig_m,
                     trig_p, action, arg, index, src)


def parse_spec(seed: int, spec: str) -> "FaultSchedule":
    """Compile ``spec`` (rules separated by ``;``) into a schedule."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if part:
            rules.append(_parse_rule(part, len(rules)))
    if not rules:
        raise ValueError(f"chaos spec {spec!r}: no rules")
    return FaultSchedule(seed, rules)


def parse_env(value: str) -> "FaultSchedule":
    """Parse the ``RAY_TPU_CHAOS`` env value: ``<seed>:<spec>``."""
    seed_src, sep, spec = value.partition(":")
    if not sep or not seed_src.strip().isdigit():
        raise ValueError(
            f"RAY_TPU_CHAOS={value!r}: want '<seed>:<spec>', e.g. "
            "'42:rpc.client.send@3=reset'")
    return parse_spec(int(seed_src), spec)


class FaultSchedule:
    """Process-wide, seeded fault schedule.

    ``fire(point, labels)`` is the single entry point: it advances every
    matching rule's counter, executes the first rule that fires (rule order
    breaks ties), records a trace line, and returns/raises according to the
    action. Thread-safe; the decision + trace append happen atomically under
    one lock (the ``delay`` sleep happens outside it).
    """

    def __init__(self, seed: int, rules: List[FaultRule]):
        self.seed = seed
        self.rules = rules
        for r in rules:
            # str seeding hashes with sha512 — stable across processes and
            # Python versions (tuple seeding is deprecated since 3.9)
            r.rng = random.Random(f"{seed}:{r.index}")
        self._lock = threading.Lock()
        self._trace: List[str] = []
        self._events = 0
        self._trace_path = os.environ.get("RAY_TPU_CHAOS_TRACE") or None

    # -- bookkeeping --------------------------------------------------------

    def trace_lines(self) -> List[str]:
        with self._lock:
            return list(self._trace)

    def trace_text(self) -> str:
        return "".join(line + "\n" for line in self.trace_lines())

    def _record(self, line: str):
        self._trace.append(line)
        if self._trace_path:
            try:
                with open(self._trace_path, "a") as f:
                    f.write(f"[pid={os.getpid()}] {line}\n")
            except OSError:
                pass

    # -- the hot path -------------------------------------------------------

    def fire(self, point: str, labels: Dict[str, str]) -> Optional[str]:
        """Consult the schedule for one event. Returns the action name that
        fired (``"delay"``/``"drop"``), ``None`` when nothing fired, or
        raises (``reset``/``error``) / exits the process (``exit``)."""
        fired: Optional[FaultRule] = None
        delay_s = 0.0
        with self._lock:
            self._events += 1
            n = self._events
            for r in self.rules:
                if not r.matches(point, labels):
                    continue
                if r.should_fire() and fired is None:
                    fired = r
                    # keep advancing later matching rules' counters so their
                    # decision streams stay aligned with the event sequence
            if fired is None:
                return None
            lbl = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
            self._record(f"{n:06d} {point} [{lbl}] rule#{fired.index}"
                         f"<{fired.spec}> hit={fired.count}"
                         f" -> {fired.action}"
                         f"{'' if fired.arg is None else f'({fired.arg})'}")
            if fired.action == "delay":
                delay_s = fired.arg
        act = fired.action
        if act == "delay":
            if delay_s > 0:
                time.sleep(delay_s)
            return "delay"
        if act == "drop":
            return "drop"
        if act == "reset":
            raise ChaosConnectionReset(
                f"chaos: injected connection reset at {point}"
                + (f" ({labels})" if labels else ""))
        if act == "error":
            raise ChaosError(f"chaos: {fired.arg} at {point}")
        # exit: hard process death, like a SIGKILL'd host. Flush stderr so
        # the trace tail is visible in test logs, then die without cleanup.
        sys.stderr.write(f"chaos: injected process exit({fired.arg}) at "
                         f"{point} pid={os.getpid()}\n")
        sys.stderr.flush()
        for hook in list(_exit_hooks):
            try:
                hook(point, fired.arg)
            except BaseException:  # noqa: BLE001  # raylint: allow(swallow) dying process: sealing is best-effort
                pass
        os._exit(fired.arg)
