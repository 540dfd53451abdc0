"""Declared metric-name registry — the source of truth lint rule R22
checks call sites against.

A typo'd histogram name (``perf.observe("task.exeute", ...)``) does not
fail; it silently creates a parallel family that every consumer (head
quantiles, ``ray-tpu top``, doctor baselines) ignores.  Same for a
misspelled goodput ledger category, which would break the ledger's
exclusivity-sums-to-wall-clock invariant.  So: every literal name passed
to ``perf.observe(...)`` and every ledger category passed to
``goodput.account(...)`` / ``goodput.interval(...)`` must appear here
(or be imported from this module); raylint R22 flags the rest.

This module is deliberately import-free (no config, no runtime) so the
linter and the hot paths can both load it for nothing.
"""

from __future__ import annotations

# Goodput ledger categories, in display order.  Exclusive: every wall-
# clock second of a job lands in exactly one.  ``idle`` is derived
# (wall minus everything attributed), never accounted directly.
LEDGER_CATEGORIES = (
    "compute",
    "compile",
    "data_wait",
    "collective_wait",
    "ckpt_stall",
    "restart_downtime",
    "idle",
)

# Every perf-plane histogram family the runtime records.  Grouped by
# subsystem prefix (the ``--subsystem`` filter in ``ray-tpu top``).
PERF_HISTOGRAMS = frozenset({
    # rpc
    "rpc.call",
    "rpc.connect",
    # task plane
    "task.execute",
    "task.e2e",
    "task.sched",
    # object plane
    "fetch.object",
    "fetch.stripe",
    "push.object",
    # striped transport
    "transport.striped_run",
    "transport.chunk",
    # checkpoint engine
    "ckpt.save",
    "ckpt.hash",
    "ckpt.write",
    "ckpt.commit",
    # serve
    "serve.request",
    "serve.queue_wait",
    "serve.execute",
    "serve.serialize",
    "serve.ingress_put",
    "serve.route",  # handle call to replica admission (replica.py)
    # train loop
    "train.step",
    "train.report",
    "train.ckpt_enqueue",
    "train.optimizer",  # the optimizer phase's device time (train/step.py)
    # jit compile detection (goodput ledger's runtime mirror of R21)
    "jit.compile",
    # drain / lifecycle
    "drain.migrate",
    # comms plane (collective rendezvous phases; observability/comms.py)
    "collective.op",       # full API-layer op duration (collective.py seam)
    "collective.launch",   # last-arrival compute / compiled-program run
    "collective.collect",  # per-rank blocked time from arrival to result
    "collective.quantize",  # per-rank block-quantization cost (compression
                            # tier, collective/quantization.py)
})

# Comms-plane sample families.  Not literal-checked by a lint rule the
# way perf.observe names are — they are declared here so the exporters
# (observability/comms.py, collective/tensor_plane.py) and their
# consumers (dashboard head, doctor, tests) share one spelling.
COMMS_FAMILY = "raytpu_comms_bytes"
TPLANE_EPOCH_GAUGE = "tplane_epoch"
