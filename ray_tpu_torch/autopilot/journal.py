"""The autopilot decision journal.

Every knob change the controller makes — applied, clamped, reverted,
failed, rejected — is one :class:`Decision` record: the evidence
snapshot that motivated it, the old and new values, the guardrail
bounds in force, and a TTL after which the decision no longer claims
the knob.  Records are kept in a bounded in-process ring (always) and
written through the state-service KV under the ``autopilot`` namespace
(when a state client is attached), the same publish-and-read layout the
drain (``drain`` namespace) and preemption (``preempt`` namespace)
planes use — so the doctor can reconstruct *why any knob moved* from
any process that can reach the state service, long after the
controller's process is gone.

KV layout (namespace ``autopilot``)::

    decision:<ts_ms:013d>:<seq:06d>   -> Decision JSON
    knob:<name>                       -> latest Decision JSON for <name>

Keys sort chronologically, so ``kv_keys(prefix=b"decision:")`` replays
the journal in order.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ray_tpu")

NAMESPACE = b"autopilot"
DECISION_PREFIX = b"decision:"
KNOB_PREFIX = b"knob:"

#: in-process ring capacity — enough for the doctor's flap window at
#: aggressive tick rates without unbounded growth in a long-lived head
RING_CAP = 1024

#: journal record verbs (the ``action`` field)
APPLIED = "applied"      # proposal actuated as-is
CLAMPED = "clamped"      # proposal actuated after guardrail clamp
REVERTED = "reverted"    # post-actuation SLO watch rolled the knob back
FAILED = "failed"        # actuation faulted; previous value restored
REJECTED = "rejected"    # proposal refused outright (bad enum, unknown)


@dataclass
class Decision:
    """One journaled knob change (see module docstring)."""

    knob: str
    old: Any
    new: Any
    action: str = APPLIED
    reason: str = ""
    #: telemetry excerpt that motivated the change — small and JSON-safe
    evidence: Dict[str, Any] = field(default_factory=dict)
    #: guardrail bounds in force: [lo, hi] or the enum choices list
    bounds: Optional[List[Any]] = None
    #: seconds this decision claims the knob before it goes stale
    ttl_s: float = 0.0
    ts: float = 0.0
    seq: int = 0

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str, sort_keys=True)


class Journal:
    """Bounded in-process decision ring + state-KV write-through.

    ``state`` is a ``StateClient`` (or None for in-process use: unit
    tests, the A/B drill).  Writes never raise — a sick state service
    must not take the controller down with it; the local ring keeps the
    record either way.
    """

    def __init__(self, state: Optional[Any] = None,
                 clock=time.time):
        self._state = state
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: List[Decision] = []  # raylint: guarded-by(self._lock)
        self._seq = 0  # raylint: guarded-by(self._lock)

    def record(self, decision: Decision) -> Decision:
        """Stamp, ring-append and (best-effort) KV-publish one record."""
        with self._lock:
            self._seq += 1
            decision.seq = self._seq
            if not decision.ts:
                decision.ts = float(self._clock())
            self._ring.append(decision)
            del self._ring[:-RING_CAP]
        if self._state is not None:
            payload = decision.to_json().encode()
            key = DECISION_PREFIX + (
                f"{int(decision.ts * 1e3):013d}:{decision.seq:06d}"
                .encode())
            try:
                self._state.kv_put(key, payload, overwrite=True,
                                   namespace=NAMESPACE)
                self._state.kv_put(
                    KNOB_PREFIX + decision.knob.encode(), payload,
                    overwrite=True, namespace=NAMESPACE)
            except Exception as e:  # noqa: BLE001
                logger.debug("autopilot journal: KV publish failed: %s", e)
        return decision

    def records(self, knob: Optional[str] = None) -> List[Decision]:
        with self._lock:
            ring = list(self._ring)
        if knob is None:
            return ring
        return [d for d in ring if d.knob == knob]

    def tail(self, n: int = 50) -> List[Dict[str, Any]]:
        return [asdict(d) for d in self.records()[-n:]]

    def flapping(self, window_s: float, threshold: int = 3,
                 now: Optional[float] = None) -> Dict[str, int]:
        """Knobs that changed >= ``threshold`` times inside the last
        ``window_s`` — the oscillation signal both the controller's
        freeze guard and the doctor's flap flag consume."""
        return flap_counts([asdict(d) for d in self.records()],
                           window_s, threshold, now=now
                           if now is not None else self._clock())


def flap_counts(records: List[Dict[str, Any]], window_s: float,
                threshold: int = 3,
                now: Optional[float] = None) -> Dict[str, int]:
    """Pure flap math over record dicts (journal ring or KV read-back):
    count *actuations* (applied/clamped/reverted) per knob inside the
    window; return knobs at or over the threshold."""
    if now is None:
        now = time.time()
    cutoff = float(now) - float(window_s)
    counts: Dict[str, int] = {}
    for rec in records:
        if rec.get("action") not in (APPLIED, CLAMPED, REVERTED):
            continue
        if float(rec.get("ts") or 0.0) < cutoff:
            continue
        knob = str(rec.get("knob") or "")
        counts[knob] = counts.get(knob, 0) + 1
    return {k: n for k, n in sorted(counts.items()) if n >= threshold}


def read_from_state(state: Any,
                    knob: Optional[str] = None) -> List[Dict[str, Any]]:
    """Replay the journal out of the state KV (chronological — the key
    encoding sorts).  Malformed records are skipped, not fatal: the
    doctor must diagnose with whatever survived."""
    out: List[Dict[str, Any]] = []
    for key in sorted(state.kv_keys(prefix=DECISION_PREFIX,
                                    namespace=NAMESPACE)):
        val = state.kv_get(key, namespace=NAMESPACE)
        if not val:
            continue
        try:
            rec = json.loads(val)
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(rec, dict) and (knob is None
                                      or rec.get("knob") == knob):
            out.append(rec)
    return out
