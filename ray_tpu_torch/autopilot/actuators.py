"""The guardrailed actuator layer — the only path that moves a knob.

An :class:`Actuator` binds one autopilot-owned knob to a getter/setter
pair plus the guardrail bounds from :mod:`ray_tpu_torch.autopilot.knobs`.
:func:`apply` is the single write path: it clamps the proposal to
bounds, fires the ``autopilot.apply`` chaos point, performs the write,
and journals the decision (evidence snapshot, old -> new, bounds, TTL)
— on *any* actuation fault the previous value is restored before the
error propagates, so a half-applied decision can never survive.  The
raylint R26 rule enforces that runtime code outside this package never
writes an owned config knob directly.

Two actuator families exist:

- **config actuators** (:func:`config_actuator`) write through the
  process-wide ``_config`` registry.  Their consumers already re-read
  the knob on every use (``transport.streams_per_peer()``, the
  collective ``_resolve_config``, ``Dataset.iter_batches``'s prefetch
  default, the cadence controller's override consult), which is what
  makes a registry write *live* tuning rather than a restart request.
- **callback actuators** registered by subsystems that own non-registry
  state — the serve controller registers ``serve.<deployment>.*``
  actuators that push retuned batch config to live replicas.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import chaos
from ray_tpu_torch._private.config import _config
from ray_tpu_torch.autopilot import knobs as _knobs
from ray_tpu_torch.autopilot.journal import (APPLIED, CLAMPED, FAILED, REJECTED,
                                       Decision, Journal)

logger = logging.getLogger("ray_tpu")


@dataclass
class Actuator:
    """One tunable knob: accessors + the guardrails :func:`apply`
    enforces.  ``lo``/``hi`` clamp numeric values; ``choices`` validates
    enum values; exactly one family applies per actuator."""

    name: str
    get: Callable[[], Any]
    set: Callable[[Any], None]
    kind: str = "int"  # "int" | "float" | "enum"
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[Tuple[Any, ...]] = None

    def bounds(self) -> List[Any]:
        if self.kind == "enum":
            return list(self.choices or ())
        return [self.lo, self.hi]


class ActuatorRegistry:
    """Named actuators; thread-safe (subsystems register from their own
    control threads, the autopilot reads from its tick thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._actuators: Dict[str, Actuator] = {}  # raylint: guarded-by(self._lock)

    def register(self, actuator: Actuator) -> None:
        with self._lock:
            self._actuators[actuator.name] = actuator

    def unregister(self, name: str) -> None:
        with self._lock:
            self._actuators.pop(name, None)

    def get(self, name: str) -> Optional[Actuator]:
        with self._lock:
            return self._actuators.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._actuators)


#: the process-global registry the dashboard-hosted controller drives;
#: the A/B drill builds private registries instead
_REGISTRY = ActuatorRegistry()


def registry() -> ActuatorRegistry:
    return _REGISTRY


def apply(name: str, value: Any, evidence: Dict[str, Any], *,
          journal: Journal, reg: Optional[ActuatorRegistry] = None,
          ttl_s: Optional[float] = None, reason: str = "",
          action: str = APPLIED) -> Optional[Decision]:
    """THE guardrailed write path (see module docstring).

    Returns the journaled :class:`Decision`, or ``None`` when the
    clamped proposal equals the current value (no-ops are not
    journaled — a journal of non-changes would bury the real story).
    Raises on unknown actuator, invalid enum value, or actuation fault
    — after journaling, and after restoring the previous value.
    """
    reg = reg or _REGISTRY
    if ttl_s is None:
        ttl_s = float(_config.get("autopilot_decision_ttl_s"))
    act = reg.get(name)
    if act is None:
        journal.record(Decision(knob=name, old=None, new=value,
                                action=REJECTED, evidence=dict(evidence),
                                reason="unknown actuator"))
        raise KeyError(f"autopilot: no actuator registered for {name!r}")

    # guardrail: clamp numeric proposals, validate enum proposals
    clamped = value
    if act.kind == "enum":
        if act.choices and value not in act.choices:
            journal.record(Decision(
                knob=name, old=act.get(), new=value, action=REJECTED,
                evidence=dict(evidence), bounds=act.bounds(),
                reason=f"not in {act.choices}"))
            raise ValueError(
                f"autopilot: {name}={value!r} not in {act.choices}")
    else:
        caster = int if act.kind == "int" else float
        clamped = caster(value)
        if act.lo is not None and clamped < act.lo:
            clamped = caster(act.lo)
        if act.hi is not None and clamped > act.hi:
            clamped = caster(act.hi)
        if clamped != value and action == APPLIED:
            action = CLAMPED

    old = act.get()
    if clamped == old:
        return None

    try:
        if chaos.ENABLED:
            # the chaos point guards the write: an injected fault here
            # (tests: "autopilot.apply=error") must leave `old` intact
            chaos.inject("autopilot.apply", knob=name)
        act.set(clamped)
    except Exception as e:  # noqa: BLE001 — journal + restore, then raise
        try:
            act.set(old)
        except Exception as restore_err:  # noqa: BLE001
            logger.warning("autopilot: restore of %s failed: %s", name,
                           restore_err)
        journal.record(Decision(
            knob=name, old=old, new=clamped, action=FAILED,
            evidence=dict(evidence), bounds=act.bounds(), ttl_s=ttl_s,
            reason=repr(e)))
        raise
    return journal.record(Decision(
        knob=name, old=old, new=clamped, action=action,
        evidence=dict(evidence), bounds=act.bounds(), ttl_s=ttl_s,
        reason=reason))


def config_actuator(knob: str,
                    store: Optional[Dict[str, Any]] = None) -> Actuator:
    """Actuator for one :data:`~ray_tpu_torch.autopilot.knobs.OWNED_KNOBS`
    entry.  Default backing is the process ``_config`` registry (this
    module is the R26-allowlisted write path); pass ``store`` to back it
    with a plain dict instead (the A/B drill's isolated knob store)."""
    spec = _knobs.OWNED_KNOBS[knob]
    if store is None:
        def _get(k=knob):
            return _config.get(k)

        def _set(v, k=knob):
            _config.set(k, v)
    else:
        def _get(k=knob, s=store):
            return s[k]

        def _set(v, k=knob, s=store):
            s[k] = v
    return Actuator(name=knob, get=_get, set=_set,
                    kind=str(spec.get("kind", "int")),
                    lo=spec.get("lo"), hi=spec.get("hi"),
                    choices=tuple(spec["choices"])
                    if "choices" in spec else None)


def register_config_actuators(
        reg: Optional[ActuatorRegistry] = None,
        store: Optional[Dict[str, Any]] = None) -> List[str]:
    """Register an actuator for every owned config knob; returns the
    names.  Idempotent — re-registration replaces."""
    reg = reg or _REGISTRY
    names = []
    for knob in sorted(_knobs.OWNED_KNOBS):
        reg.register(config_actuator(knob, store=store))
        names.append(knob)
    return names
