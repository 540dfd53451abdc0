"""Dashboard. Only the per-node reporter agent (``agent.py``), which every
host daemon runs, is ported so far; the dashboard head waits for ROADMAP
Queue 1's framework-neutral libraries."""

from ray_tpu_torch.dashboard.agent import NodeReporterAgent  # noqa: F401
