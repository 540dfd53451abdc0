"""GPU VM node provider (GCP Compute Engine).

Parity with ``python/ray/autoscaler/_private/gcp/node_provider.py``: the
cloud half of the autoscaler. A "node" here is one GPU VM (e.g.
``a3-highgpu-8g``, eight H100s) created through ``gcloud compute
instances create`` with ``--accelerator=type=nvidia-h100-80gb,count=N``;
its startup script runs ``python -m ray_tpu_torch.scripts.cluster start
--address=<head>`` so the VM's host daemon joins the cluster once the VM
is RUNNING. That script module is not in the package yet (ROADMAP Queue
1, the scripts item): until it is, a VM boots but does not join.

All cloud interaction goes through a pluggable ``command_runner`` (the
``gcloud`` CLI by default) so the provider is fully testable offline —
tests inject a fake runner that simulates PROVISIONING -> RUNNING
transitions; production uses the real CLI with no code change (same
swap-by-config philosophy as the reference's provider registry).
"""

from __future__ import annotations

import json
import shlex
import subprocess
import threading
import uuid
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

# instance states that count as "not terminated"
_LIVE_STATES = {"PROVISIONING", "STAGING", "RUNNING"}
# default boot image (family, project): CUDA drivers preinstalled
_IMAGE = ("common-cu124", "deeplearning-platform-release")


def _gcloud_runner(args: List[str]) -> str:
    """Default command runner: the gcloud CLI. Raises on failure."""
    proc = subprocess.run(["gcloud"] + args, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"gcloud {' '.join(map(shlex.quote, args))} failed: "
            f"{proc.stderr.strip()[:500]}")
    return proc.stdout


class GPUNodeProvider(NodeProvider):
    """Provisions/terminates GPU VMs via Compute Engine instances.

    ``provider_config``::

        {
          "project": "my-project",
          "zone": "us-central1-a",
          "image_family": "common-cu124",        # boot image
          "image_project": "deeplearning-platform-release",
          "cluster_address": "head-host:6379",   # state service to join
          "node_types": {
            "h100-8": {"machine_type": "a3-highgpu-8g",
                       "accelerator_type": "nvidia-h100-80gb",
                       "accelerator_count": 8,
                       "resources": {"CPU": 208, "GPU": 8}},
            "h100-1": {"machine_type": "a3-highgpu-1g",
                       "accelerator_type": "nvidia-h100-80gb",
                       "accelerator_count": 1,
                       "resources": {"CPU": 26, "GPU": 1}},
          },
        }
    """

    def __init__(self, provider_config: Optional[dict] = None,
                 command_runner: Optional[Callable[[List[str]], str]] = None):
        super().__init__(provider_config)
        cfg = self.provider_config
        for req in ("project", "zone", "node_types"):
            if req not in cfg:
                raise ValueError(f"GPU provider config missing {req!r}")
        self._run = command_runner or _gcloud_runner
        self._lock = threading.Lock()
        self._types: Dict[str, str] = {}  # instance name -> node type

    # -- helpers ---------------------------------------------------------
    def _scope(self) -> List[str]:
        cfg = self.provider_config
        return [f"--project={cfg['project']}", f"--zone={cfg['zone']}"]

    def _startup_script(self) -> str:
        addr = self.provider_config.get("cluster_address", "")
        if not addr:
            return ""
        # an authenticated cluster (the default) rejects tokenless joins;
        # the VM must present the head-minted secret
        token = self.provider_config.get("auth_token", "")
        export = (f"export RAY_TPU_AUTH_TOKEN={shlex.quote(token)}\n"
                  if token else "")
        return (f"#! /bin/bash\n{export}"
                f"python -m ray_tpu_torch.scripts.cluster start "
                f"--address={addr} --block &\n")

    # -- NodeProvider ----------------------------------------------------
    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        cfg = self.provider_config
        spec = cfg["node_types"].get(node_type)
        if spec is None:
            raise ValueError(f"unknown node type {node_type!r}; "
                             f"configured: {sorted(cfg['node_types'])}")
        created = []
        for _ in range(count):
            name = f"raytpu-{node_type}-{uuid.uuid4().hex[:8]}"
            args = ["compute", "instances", "create", name,
                    f"--machine-type={spec['machine_type']}",
                    f"--accelerator=type={spec['accelerator_type']},"
                    f"count={spec['accelerator_count']}",
                    "--maintenance-policy=TERMINATE",
                    f"--image-family={cfg.get('image_family', _IMAGE[0])}",
                    f"--image-project={cfg.get('image_project', _IMAGE[1])}",
                    *self._scope()]
            script = self._startup_script()
            if script:
                args.append(f"--metadata=startup-script={script}")
            if cfg.get("spot"):
                args.append("--provisioning-model=SPOT")
            self._run(args)
            with self._lock:
                self._types[name] = node_type
            created.append(name)
        return created

    def non_terminated_nodes(self) -> List[str]:
        out = self._run(["compute", "instances", "list", "--format=json",
                         f"--project={self.provider_config['project']}",
                         f"--zones={self.provider_config['zone']}"])
        live = []
        for entry in json.loads(out or "[]"):
            name = entry.get("name", "").rsplit("/", 1)[-1]
            state = entry.get("status", "")
            if state in _LIVE_STATES and name.startswith("raytpu-"):
                live.append(name)
                with self._lock:
                    # rediscover type for nodes created by a previous
                    # autoscaler incarnation: encoded in the name
                    if name not in self._types:
                        parts = name.split("-")
                        if len(parts) >= 3:
                            self._types[name] = "-".join(parts[1:-1])
        return live

    def terminate_node(self, provider_node_id: str) -> None:
        self._run(["compute", "instances", "delete", provider_node_id,
                   "--quiet", *self._scope()])
        with self._lock:
            self._types.pop(provider_node_id, None)

    def node_resources(self, provider_node_id: str) -> Dict[str, float]:
        with self._lock:
            t = self._types.get(provider_node_id)
        spec = self.provider_config["node_types"].get(t, {})
        return dict(spec.get("resources", {}))

    def node_type(self, provider_node_id: str) -> str:
        with self._lock:
            return self._types[provider_node_id]
