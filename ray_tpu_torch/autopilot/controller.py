"""The autopilot controller loop.

One :class:`Autopilot` per cluster, hosted by the dashboard head (the
process that already federates ``/api/perf`` + ``/api/goodput`` +
``/api/comms``): every tick it snapshots the three planes, runs the
policy catalog, routes surviving proposals through the guardrailed
actuator layer, and then *watches what it did* — each actuation arms an
SLO watch that compares the guarded metric against its pre-change
baseline for ``autopilot_watch_ticks`` ticks and rolls the knob back
(journaled, ``action="reverted"``) the moment it regresses beyond
``autopilot_revert_pct``.  Tick-driven with an event hook
(:meth:`poke`) like the autoscaler, so a plane can wake it early.

Safety ladder, outermost first:

1. policies are pure — a bad rule can only *propose*;
2. ``actuators.apply`` clamps to the registered bounds and restores the
   previous value on any actuation fault;
3. at most ``autopilot_max_changes_per_tick`` actuations per tick;
4. the post-change SLO watch auto-reverts regressions;
5. a knob actuated >= 3 times inside ``autopilot_flap_window_s`` is
   frozen for the remainder of the window (the doctor flags it too);
6. every one of the above leaves a journal record the doctor's
   ``--explain <knob>`` can replay.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import _config
from ray_tpu_torch.autopilot import actuators as _actuators
from ray_tpu_torch.autopilot import policies as _policies
from ray_tpu_torch.autopilot.journal import REVERTED, Journal

logger = logging.getLogger("ray_tpu")

#: knobs actuated at least this many times per flap window are frozen
FLAP_THRESHOLD = 3


def slo_value(snapshot: Dict[str, Any],
              slo: Dict[str, Any]) -> Optional[float]:
    """Evaluate one proposal's guarded metric on a snapshot.  Returns
    None when the metric is absent (watch keeps waiting — absence of
    telemetry is not evidence of regression)."""
    kind = slo.get("kind")
    if kind == "goodput_pct":
        jobs = (snapshot.get("goodput") or {}).get("jobs") or {}
        if slo.get("job") in jobs:
            return float(jobs[slo["job"]].get("goodput_pct") or 0.0)
        if not jobs:
            return None
        wall = sum(float(r.get("wall_s") or 0.0) for r in jobs.values())
        compute = sum(float((r.get("cats") or {}).get("compute") or 0.0)
                      for r in jobs.values())
        return 100.0 * compute / wall if wall > 0 else None
    if kind == "perf_p95":
        hist = ((snapshot.get("perf") or {}).get("cluster") or {}).get(
            slo.get("hist")) or {}
        if not hist.get("count"):
            return None
        return float(hist.get("p95_ms") or 0.0)
    return None


def slo_higher_is_better(slo: Dict[str, Any]) -> bool:
    return slo.get("kind") != "perf_p95"


class Autopilot:
    """See module docstring.  ``snapshot_fn`` returns the plane merge
    (``{"perf": ..., "goodput": ..., "comms": ...}`` — the dashboard
    head passes its own ``_perf/_goodput/_comms``); ``hazard_fn``
    optionally feeds the fleet hazard rate for the cadence policy."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 journal: Optional[Journal] = None,
                 reg: Optional[_actuators.ActuatorRegistry] = None,
                 hazard_fn: Optional[Callable[[], Optional[float]]] = None,
                 clock=time.time):
        self._snapshot_fn = snapshot_fn
        self.journal = journal or Journal(clock=clock)
        self.registry = reg or _actuators.registry()
        self._hazard_fn = hazard_fn
        self._clock = clock
        #: tick-thread state that status() reads from the dashboard's
        #: HTTP thread — everything below shares one guard
        self._lock = threading.Lock()
        # raylint: guarded-by(self._lock)
        self._watches: List[Dict[str, Any]] = []
        # raylint: guarded-by(self._lock)
        self.ticks = 0
        # raylint: guarded-by(self._lock)
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- knob access -----------------------------------------------------

    def _get(self, knob: str) -> Any:
        act = self.registry.get(knob)
        if act is not None:
            return act.get()
        return _config.get(knob)

    # -- one tick --------------------------------------------------------

    def tick(self, snapshot: Optional[Dict[str, Any]] = None) -> List[Any]:
        """One control cycle; returns the decisions journaled this tick
        (reverts first, then fresh actuations)."""
        with self._lock:
            self.ticks += 1
        if snapshot is None:
            snapshot = self._snapshot_fn()
        if self._hazard_fn is not None and \
                "hazard_rate_per_hour" not in snapshot:
            try:
                rate = self._hazard_fn()
                if rate is not None:
                    snapshot["hazard_rate_per_hour"] = rate
            except Exception as e:  # noqa: BLE001
                logger.debug("autopilot: hazard feed failed: %s", e)
        decisions: List[Any] = []
        decisions += self._check_watches(snapshot)
        frozen = self.journal.flapping(
            float(_config.get("autopilot_flap_window_s")),
            FLAP_THRESHOLD, now=self._clock())
        budget = int(_config.get("autopilot_max_changes_per_tick"))
        with self._lock:
            watched = {w["knob"] for w in self._watches}
        for proposal in _policies.propose(snapshot, self._get,
                                          self.registry.names()):
            if budget <= 0:
                break
            knob = proposal["knob"]
            if knob in frozen:
                logger.info("autopilot: %s frozen (%d changes in flap "
                            "window)", knob, frozen[knob])
                continue
            if knob in watched:
                continue  # one in-flight experiment per knob at a time
            baseline = slo_value(snapshot, proposal["slo"])
            try:
                dec = _actuators.apply(
                    knob, proposal["value"], proposal["evidence"],
                    journal=self.journal, reg=self.registry,
                    reason=proposal.get("reason", ""))
            except Exception as e:  # noqa: BLE001 — journaled by apply
                with self._lock:
                    self.last_error = repr(e)
                continue
            if dec is None:
                continue
            budget -= 1
            decisions.append(dec)
            watched.add(knob)
            with self._lock:
                self._watches.append({
                    "knob": knob, "old": dec.old, "new": dec.new,
                    "slo": dict(proposal["slo"]), "baseline": baseline,
                    "ticks_left": int(_config.get("autopilot_watch_ticks")),
                    "expires": (float(dec.ts) + float(dec.ttl_s))
                    if dec.ttl_s else None,
                })
        return decisions

    def _check_watches(self, snapshot: Dict[str, Any]) -> List[Any]:
        """Evaluate armed SLO watches; revert regressions, retire
        watches whose window (or decision TTL) elapsed."""
        revert_pct = float(_config.get("autopilot_revert_pct"))
        now = self._clock()
        decisions: List[Any] = []
        kept: List[Dict[str, Any]] = []
        # the tick thread is the sole mutator; the lock orders the list
        # swap against concurrent status() readers
        with self._lock:
            pending = list(self._watches)
        for w in pending:
            cur = slo_value(snapshot, w["slo"])
            baseline = w.get("baseline")
            regressed = False
            if cur is not None and baseline is not None and baseline > 0:
                if slo_higher_is_better(w["slo"]):
                    regressed = cur < baseline * (1.0 - revert_pct / 100.0)
                else:
                    regressed = cur > baseline * (1.0 + revert_pct / 100.0)
            if regressed:
                try:
                    dec = _actuators.apply(
                        w["knob"], w["old"],
                        {"slo": w["slo"], "baseline": baseline,
                         "observed": cur, "revert_pct": revert_pct},
                        journal=self.journal, reg=self.registry,
                        action=REVERTED,
                        reason=f"SLO regressed: {cur:.3f} vs baseline "
                               f"{baseline:.3f}")
                    if dec is not None:
                        decisions.append(dec)
                except Exception as e:  # noqa: BLE001
                    with self._lock:
                        self.last_error = repr(e)
                continue  # watch retires either way: the change is gone
            w["ticks_left"] -= 1
            expired = w["expires"] is not None and now >= w["expires"]
            if w["ticks_left"] > 0 and not expired:
                kept.append(w)
            # a watch that survives its window is a kept change: the
            # journal's applied record stands, nothing new to write
        with self._lock:
            self._watches = kept
        return decisions

    # -- hosting ---------------------------------------------------------

    def poke(self) -> None:
        """Event hook: wake the tick thread before its period elapses
        (a plane merge just saw something worth reacting to)."""
        self._wake.set()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="autopilot")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self.last_error = repr(e)
                logger.warning("autopilot tick failed: %s", e)
            self._wake.wait(float(_config.get("autopilot_tick_s")))
            self._wake.clear()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            ticks = self.ticks
            last_error = self.last_error
            watches = [{k: w[k] for k in
                        ("knob", "old", "new", "baseline", "ticks_left")}
                       for w in self._watches]
        return {
            "ticks": ticks,
            "actuators": self.registry.names(),
            "watches": watches,
            "flapping": self.journal.flapping(
                float(_config.get("autopilot_flap_window_s")),
                FLAP_THRESHOLD, now=self._clock()),
            "last_error": last_error,
            "journal": self.journal.tail(50),
        }
