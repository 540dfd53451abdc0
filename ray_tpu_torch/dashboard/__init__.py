"""ray_tpu_torch.dashboard — cluster dashboard head + per-node reporter agent.

Port of ``ray_tpu/dashboard``: the head (``head.py``) is one stdlib HTTP
server that reads everything from the cluster's state service
(node/actor/PG/job tables plus the ``node_stats`` KV namespace) and fans
out to the host daemons for logs, metrics, timelines and forensics; the
agent (``agent.py``) is a daemon thread inside each host daemon sampling
/proc and publishing one JSON blob per heartbeat-ish interval. No external
UI build: ``/`` serves a self-contained HTML page that polls the JSON API.
"""

from ray_tpu_torch.dashboard.agent import NodeReporterAgent  # noqa: F401
from ray_tpu_torch.dashboard.head import DashboardHead, start_dashboard  # noqa: F401
