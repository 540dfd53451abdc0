"""Developer tooling: framework-aware static analysis + runtime watchdogs.

Two enforcement layers for the concurrency invariants the runtime's design
depends on (threads-as-workers inside a single device-owner daemon, see
``_private/distributed.py``):

- :mod:`ray_tpu_torch.devtools.linter` — an AST lint engine with rules that know
  about this framework's idioms (blocking calls in async bodies, lock-order
  consistency, unguarded cross-thread state, silent exception swallows,
  host-device syncs reachable from jitted step loops, proto/pb2 drift).
  CLI: ``python -m ray_tpu_torch.devtools.lint ray_tpu_torch``; ``--rules`` with no
  value prints the machine-readable registry.
- :mod:`ray_tpu_torch.devtools.callgraph` — the whole-program symbol table +
  call graph (import/alias resolution, ``self.method`` and attribute-type
  inference, spawn/loop/call edge kinds) behind the interprocedural rules:
  R10 transitive async blocking, R11 cross-function lock-order cycles,
  R12 SPMD collective divergence, R13 config-knob / chaos-point drift.
  Unresolvable dynamic calls degrade to "unknown" edges — the analysis
  under-approximates rather than risk false positives.
- :mod:`ray_tpu_torch.devtools.lockwatch` — a runtime lock-order watchdog that
  wraps ``threading.Lock``/``RLock`` creation, builds the cross-thread
  lock-order graph actually exercised, and reports cycles (potential
  deadlocks) and over-threshold holds.  Activated by ``RAY_TPU_LOCKWATCH=1``
  so any test run doubles as its workload; its cycle report format is
  shared with R11 so static and runtime findings correlate one-to-one.
"""

from ray_tpu_torch.devtools.linter import LintEngine, Finding  # noqa: F401
