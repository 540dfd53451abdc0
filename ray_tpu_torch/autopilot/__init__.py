"""ray_tpu_torch.autopilot — the closed telemetry loop.

The cluster already *measures* everything that matters: the perf plane
times every serve queue and collective quantize, the goodput ledger
attributes every non-compute second, the comms ledger rates every link
and reduction.  Until now a human read those planes on the dashboard
and hand-set the knobs.  The autopilot closes the loop: a per-cluster
controller (hosted by the dashboard head, next to the plane merges it
consumes) that continuously retunes

- serve micro-batch linger from arrival shape and ``queue_wait`` p95,
- ``data_streams_per_peer`` / ``fetch_chunk_bytes`` from the per-peer
  link matrix — the lifelong successor to the one-shot startup probe,
- collective wire compression and hierarchy from ledgered busbw under
  the operator's relative-error budget,
- prefetch depth from the ledger's ``data_wait`` attribution,
- checkpoint cadence from the fleet hazard rate (the hazard loop,
  migrated here as the first journaled policy),

all through one guardrailed actuator layer: bounds-clamped, journaled
with the evidence that motivated each change, watched after actuation
and auto-reverted on SLO regression.  ``ray_tpu_torch.doctor --explain
<knob>`` replays the journal; raylint R26 keeps every other runtime
write path off the owned knobs.
"""

from __future__ import annotations

from ray_tpu_torch.autopilot.actuators import (Actuator, ActuatorRegistry, apply,
                                         config_actuator,
                                         register_config_actuators, registry)
from ray_tpu_torch.autopilot.controller import Autopilot
from ray_tpu_torch.autopilot.journal import (APPLIED, CLAMPED, FAILED, REJECTED,
                                       REVERTED, Decision, Journal,
                                       flap_counts, read_from_state)
from ray_tpu_torch.autopilot.knobs import OWNED_KNOBS

__all__ = [
    "Actuator", "ActuatorRegistry", "Autopilot", "Decision", "Journal",
    "OWNED_KNOBS", "APPLIED", "CLAMPED", "FAILED", "REJECTED", "REVERTED",
    "apply", "config_actuator", "flap_counts", "read_from_state",
    "register_config_actuators", "registry",
]
