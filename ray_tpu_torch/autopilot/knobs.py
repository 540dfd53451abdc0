"""Autopilot-owned knob registry — the single source of ownership truth.

Deliberately **import-free** (same contract as
``ray_tpu_torch/observability/metric_names.py``): the raylint R26
actuator-bypass rule ``exec``\\ s this file's source inside the static
analyzer, so importing anything here would drag the runtime (config
singleton, sockets, torch) into a lint process.

A knob listed in :data:`OWNED_KNOBS` is **owned by the autopilot**: once
the cluster controller is responsible for it, any runtime write outside
the guardrailed ``ray_tpu_torch.autopilot.actuators.apply()`` path would fork
control of the knob between the operator and the controller — the
controller's journal would no longer explain the knob's value, and its
SLO watch/revert guarantee would silently not cover the foreign write.
R26 flags such writes; tests may pin owned knobs under the scoped allow
profile in ``run_static_analysis.sh``.

Each entry carries the guardrail bounds the actuator layer enforces:
``lo``/``hi`` clamp numeric proposals, ``choices`` validates enum
proposals.  Bounds live here — next to ownership — so the linter, the
actuators and the doctor all read one table.
"""

# knob name -> guardrail spec
#   kind: "int" | "float" | "enum"
#   lo/hi: inclusive clamp bounds (numeric kinds)
#   choices: valid values (enum kind)
OWNED_KNOBS = {
    # transport: lifelong successor to the one-shot startup probe
    "data_streams_per_peer": {"kind": "int", "lo": 1, "hi": 16},
    "fetch_chunk_bytes": {"kind": "int", "lo": 256 * 1024,
                          "hi": 64 * 1024 * 1024},
    # collective wire scheme + hierarchy (per-group busbw evidence)
    "collective_compression": {"kind": "enum",
                               "choices": ("none", "q8", "fp8")},
    "collective_ranks_per_host": {"kind": "int", "lo": 0, "hi": 64},
    # data plane: prefetch depth from data_wait attribution
    "data_prefetch_batches": {"kind": "int", "lo": 0, "hi": 8},
    # checkpoint cadence override (the migrated hazard loop)
    "checkpoint_cadence_autopilot_steps": {"kind": "int", "lo": 0,
                                           "hi": 100_000},
}
