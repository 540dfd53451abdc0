"""Preemption-hazard estimation for the elastic preemptible fleet.

Preemptible capacity is cheap because the provider may reclaim any node
with ~``preempt_lead_s`` of notice.  The drain made that survivable (the
notice starts a graceful drain); this module makes it *plannable*: every
``"preemption notice"`` drain is journaled into the state-service KV, and
the :class:`HazardEstimator` folds that history into a per-node hazard
score the autoscaler acts on **before** the next notice lands — a
proactive drain gets the full ``drain_deadline_s`` budget instead of the
provider's eviction lead.

KV layout (namespace ``preempt``; the journal is the cross-process
analogue of the ``drain`` namespace's progress records):

======================  ====================================================
key                     value (JSON)
======================  ====================================================
``event:<ts_ms>:<nid>`` one observed preemption notice: ``{"ts", "node",
                        "node_type", "reason"}`` — written by the drain
                        orchestrator when the drain reason carries
                        ``"preemption notice"``; pruned past
                        ``hazard_window_s``
``probe:<nid>``         the node's preemption-probe health: ``{"failures":
                        consecutive probe errors, "ts"}`` — written by the
                        host daemon's watcher, flagged by the doctor
``fleet:rate``          the estimator's published fleet hazard rate
                        (decayed preemptions/hour): ``{"rate_per_hour",
                        "ts"}`` — the cadence solver's risk input
======================  ====================================================

Hazard math — all pure functions, unit-tested in isolation:

- an event of age ``a`` contributes ``0.5 ** (a / hazard_halflife_s)``;
- a node type's rate is the decayed event count divided by the decay's
  mean lifetime (``halflife / ln 2``), in events/hour;
- a node's hazard is its type rate plus ``hazard_probe_weight`` per
  consecutive probe failure (a blind watcher may never see the real
  notice, so the node must be treated as riskier, not safer).
"""

from __future__ import annotations

import json
import logging
import math
import time
from typing import Dict, Iterable, List, Optional

from ray_tpu_torch._private.config import _config

logger = logging.getLogger("ray_tpu")

#: State-KV namespace shared by the journal, the probe-health records and
#: the published fleet rate.
NAMESPACE = b"preempt"
EVENT_PREFIX = b"event:"
PROBE_PREFIX = b"probe:"
FLEET_RATE_KEY = b"fleet:rate"


def decayed_rate_per_hour(ages_s: Iterable[float], halflife_s: float,
                          window_s: float) -> float:
    """Events/hour from a list of event ages, exponentially decayed.

    Each event inside ``window_s`` contributes ``0.5 ** (age/halflife)``;
    the decayed count is normalized by the decay's mean lifetime
    (``halflife / ln 2``) so one *fresh* event at half-life ``h`` reads
    as roughly ``3600 * ln2 / h`` events/hour.  Monotone in both inputs:
    more events ⇒ higher, fresher events ⇒ higher.
    """
    halflife_s = max(1.0, halflife_s)
    weight = sum(0.5 ** (age / halflife_s) for age in ages_s
                 if 0.0 <= age <= window_s)
    mean_lifetime_s = halflife_s / math.log(2)
    return weight * 3600.0 / mean_lifetime_s


def node_hazard_score(type_rate_per_hour: float, probe_failures: int = 0,
                      probe_weight: Optional[float] = None) -> float:
    """Fold the node type's historical rate and the node's probe health
    into one score (still in events/hour units)."""
    if probe_weight is None:
        probe_weight = _config.get("hazard_probe_weight")
    return type_rate_per_hour + probe_weight * max(0, int(probe_failures))


def journal_preemption(state, node_id_hex: str, node_type: str,
                       reason: str, ts: Optional[float] = None) -> None:
    """Append one observed preemption notice to the KV journal.

    Called by the drain orchestrator (``begin_drain``) when the drain
    reason carries ``"preemption notice"`` — i.e. only *real* notices
    (chaos or metadata probe) are history; proactive hazard drains are
    not, else the estimator would feed on its own output."""
    ts = time.time() if ts is None else ts
    key = EVENT_PREFIX + f"{int(ts * 1e3):015d}:{node_id_hex}".encode()
    record = {"ts": ts, "node": node_id_hex,
              "node_type": node_type or "default", "reason": reason}
    state.kv_put(key, json.dumps(record).encode(), namespace=NAMESPACE)


def publish_probe_health(state, node_id_hex: str, failures: int) -> None:
    """Publish a node's consecutive preempt-probe failure count (host
    daemon's watcher; read back by the estimator and the doctor)."""
    record = {"failures": int(failures), "ts": time.time()}
    state.kv_put(PROBE_PREFIX + node_id_hex.encode(),
                 json.dumps(record).encode(), namespace=NAMESPACE)


def read_fleet_rate(state) -> Optional[float]:
    """The last published fleet hazard rate, or None (never published /
    state unreachable). Callers fall back to hazard_rate_floor_per_hour."""
    try:
        raw = state.kv_get(FLEET_RATE_KEY, namespace=NAMESPACE)
        if not raw:
            return None
        return float(json.loads(raw)["rate_per_hour"])
    except Exception as e:  # noqa: BLE001
        logger.debug("hazard: fleet rate read failed: %s", e)
        return None


class HazardEstimator:
    """Per-node-type preemption hazard from the KV journal.

    ``state`` is a StateClient (or None for a purely local estimator fed
    via :meth:`record` — the in-process runtime has no KV).  ``refresh()``
    re-reads the journal and garbage-collects events past the window;
    the autoscaler calls it once per reconciliation pass.
    """

    def __init__(self, state=None):
        self._state = state
        # [(ts, node_type, node_hex)] inside the window, newest last.
        self._events: List[tuple] = []
        self._probe_failures: Dict[str, int] = {}

    # ------------------------------------------------------------- intake

    def record(self, node_type: str, node_id_hex: str = "",
               ts: Optional[float] = None) -> None:
        """Feed one preemption event directly (tests / in-proc runtime)."""
        self._events.append((time.time() if ts is None else ts,
                             node_type or "default", node_id_hex))

    def refresh(self, now: Optional[float] = None) -> None:
        """Re-read the journal; prune (and KV-GC) events past the window."""
        now = time.time() if now is None else now
        window = _config.get("hazard_window_s")
        if self._state is not None:
            try:
                self._load_from_kv(now, window)
            except Exception as e:  # noqa: BLE001
                logger.debug("hazard: KV refresh failed (keeping last "
                             "view): %s", e)
        self._events = [e for e in self._events if now - e[0] <= window]

    def _load_from_kv(self, now: float, window: float) -> None:
        events: List[tuple] = []
        for key in self._state.kv_keys(prefix=EVENT_PREFIX,
                                       namespace=NAMESPACE):
            raw = self._state.kv_get(key, namespace=NAMESPACE)
            if not raw:
                continue
            try:
                rec = json.loads(raw)
                ts = float(rec["ts"])
            except (ValueError, KeyError, UnicodeDecodeError):
                continue
            if now - ts > window:
                # The journal outlives any one estimator; GC keeps the
                # namespace bounded at window-worth of events.
                self._state.kv_del(key, namespace=NAMESPACE)
                continue
            events.append((ts, rec.get("node_type") or "default",
                           rec.get("node") or ""))
        probes: Dict[str, int] = {}
        for key in self._state.kv_keys(prefix=PROBE_PREFIX,
                                       namespace=NAMESPACE):
            raw = self._state.kv_get(key, namespace=NAMESPACE)
            if not raw:
                continue
            try:
                probes[key[len(PROBE_PREFIX):].decode()] = int(
                    json.loads(raw).get("failures") or 0)
            except (ValueError, UnicodeDecodeError):
                continue
        events.sort()
        self._events = events
        self._probe_failures = probes

    # ------------------------------------------------------------- scores

    def type_rate(self, node_type: str, now: Optional[float] = None) -> float:
        """Decayed preemptions/hour observed for one node type."""
        now = time.time() if now is None else now
        ages = [now - ts for ts, t, _ in self._events
                if t == (node_type or "default")]
        return decayed_rate_per_hour(ages,
                                     _config.get("hazard_halflife_s"),
                                     _config.get("hazard_window_s"))

    def node_hazard(self, node_type: str, node_id_hex: str = "",
                    now: Optional[float] = None) -> float:
        """Per-node hazard: the type's historical rate plus the node's
        probe-blindness penalty."""
        return node_hazard_score(
            self.type_rate(node_type, now=now),
            self._probe_failures.get(node_id_hex, 0))

    def fleet_rate(self, now: Optional[float] = None) -> float:
        """Fleet-wide decayed preemptions/hour (all types), floored at
        ``hazard_rate_floor_per_hour`` so a cold fleet still plans with
        the provider's advertised rate."""
        now = time.time() if now is None else now
        ages = [now - ts for ts, _t, _n in self._events]
        rate = decayed_rate_per_hour(ages,
                                     _config.get("hazard_halflife_s"),
                                     _config.get("hazard_window_s"))
        return max(rate, _config.get("hazard_rate_floor_per_hour"))

    def publish_fleet_rate(self, now: Optional[float] = None) -> float:
        """Write the current fleet rate to the KV for the cadence solver
        (no-op without a state client). Returns the rate either way."""
        rate = self.fleet_rate(now=now)
        if self._state is not None:
            try:
                self._state.kv_put(
                    FLEET_RATE_KEY,
                    json.dumps({"rate_per_hour": rate,
                                "ts": time.time() if now is None
                                else now}).encode(),
                    namespace=NAMESPACE)
            except Exception as e:  # noqa: BLE001
                logger.debug("hazard: fleet rate publish failed: %s", e)
        return rate
