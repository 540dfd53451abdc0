"""Per-host process supervision: launch + babysit the cluster processes.

The production analogue of the reference's ``Node``
(``python/ray/_private/node.py:1061`` start_ray_processes /
process-failure policy): a head node runs the state service plus one
host daemon; a worker node runs one host daemon. The supervisor restarts
a crashed child with exponential backoff — the state service recovers
its tables from journal+snapshot, daemons simply re-register as fresh
nodes (their node identity is per-incarnation by design: objects and
actors they hosted are recovered by their owners' lineage/restart
machinery, test_distributed_cluster.py).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

logger = logging.getLogger("ray_tpu")


def spawn_daemon(state_addr: str, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 heartbeat_s: float = 1.0,
                 tp_cpu_devices: int = 0,
                 labels: Optional[Dict[str, str]] = None,
                 startup_timeout_s: float = 60.0,
                 env_overrides: Optional[Dict[str, str]] = None,
                 cards: Optional[Sequence[int]] = None
                 ) -> Tuple[subprocess.Popen, str]:
    """Start one host-daemon process; returns (process, rpc_address).

    ``cards``: the machine's CUDA device indices the daemon owns, given to
    it as ``CUDA_VISIBLE_DEVICES`` in its environment (CUDA reads it at
    initialisation, so it cannot be set later). An explicit
    ``num_gpus=0`` without ``cards`` hides every card; with neither, the
    daemon inherits this process's visible cards. ``tp_cpu_devices`` > 0
    puts the daemon's tensor-plane ranks on gloo
    (``RAY_TPU_TP_CPU_DEVICES``, see ``collective/tensor_plane.py``)."""
    from ray_tpu_torch._private.state_client import _package_env
    ready = tempfile.mktemp(prefix="raytpu_daemon_ready_")
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.host_daemon",
           "--state-addr", state_addr,
           "--resources", json.dumps(resources or {}),
           "--labels", json.dumps(labels or {}),
           "--heartbeat-interval-s", str(heartbeat_s),
           "--ready-file", ready]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if num_gpus is not None:
        cmd += ["--num-gpus", str(num_gpus)]
    env = _package_env()
    env.update(env_overrides or {})
    if tp_cpu_devices:
        env["RAY_TPU_TP_CPU_DEVICES"] = str(tp_cpu_devices)
    if cards is not None:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in cards)
    elif num_gpus == 0:
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.Popen(cmd, env=env)
    deadline = time.monotonic() + startup_timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(ready):
            with open(ready) as f:
                addr = f.read().strip()
            os.unlink(ready)
            return proc, addr
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon exited rc={proc.returncode} during startup")
        time.sleep(0.02)
    proc.kill()
    raise TimeoutError("daemon did not become ready")


class NodeSupervisor:
    """Runs in the foreground of a ``supervise`` process: owns the host's
    children and keeps them alive until told to stop."""

    RESTART_BACKOFF_S = (1.0, 2.0, 4.0, 8.0, 16.0, 30.0)
    STABLE_RESET_S = 60.0

    def __init__(self, run_dir: str, head: bool, state_addr: str = "",
                 num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 tp_cpu_devices: int = 0,
                 heartbeat_timeout_ms: float = 5000,
                 auth_token: str = ""):
        self.run_dir = run_dir
        self.head = head
        self.state_addr = state_addr
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus
        self.resources = resources or {}
        self.tp_cpu_devices = tp_cpu_devices
        self.heartbeat_timeout_ms = heartbeat_timeout_ms
        self.auth_token = auth_token
        self.state_proc: Optional[subprocess.Popen] = None
        self.daemon_proc: Optional[subprocess.Popen] = None
        self._stop = False
        os.makedirs(run_dir, exist_ok=True)

    # -- file plumbing -------------------------------------------------------

    def _write(self, name: str, value: str):
        path = os.path.join(self.run_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    # -- children ------------------------------------------------------------

    def _start_state_service(self):
        from ray_tpu_torch._private.state_client import start_state_service
        data_dir = os.path.join(self.run_dir, "state")
        # A RESTART must come back on the same port — peers and drivers
        # hold the old address, and journal+snapshot recovery is pointless
        # if nobody can reach the recovered service.
        port = 0
        if self.state_addr:
            port = int(self.state_addr.rsplit(":", 1)[1])
        self.state_proc, self.state_addr = start_state_service(
            port=port, data_dir=data_dir,
            heartbeat_timeout_ms=self.heartbeat_timeout_ms)
        self._write("address", self.state_addr)
        self._write("state.pid", str(self.state_proc.pid))

    def _start_daemon(self):
        self.daemon_proc, addr = spawn_daemon(
            self.state_addr, num_cpus=self.num_cpus, num_gpus=self.num_gpus,
            resources=self.resources, tp_cpu_devices=self.tp_cpu_devices)
        self._write("daemon.pid", str(self.daemon_proc.pid))
        self._write("daemon.addr", addr)

    # -- main loop -----------------------------------------------------------

    def run(self):
        if self.auth_token:
            # Children (state service via getenv, daemons via inherited
            # env) and our own clients all read the shared secret from the
            # environment; see rpc.default_auth_token.
            os.environ["RAY_TPU_AUTH_TOKEN"] = self.auth_token
        self._write("supervisor.pid", str(os.getpid()))
        signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_stop", True))
        signal.signal(signal.SIGINT, lambda *_: setattr(self, "_stop", True))
        if self.head:
            self._start_state_service()
        self._start_daemon()
        restarts = {"state": 0, "daemon": 0}
        last_restart = {"state": 0.0, "daemon": 0.0}
        logger.info("supervising %s node at %s (run dir %s)",
                    "head" if self.head else "worker", self.state_addr,
                    self.run_dir)
        while not self._stop:
            time.sleep(0.25)  # raylint: allow(bare-retry) liveness poll cadence; restarts pace via RESTART_BACKOFF_S
            now = time.monotonic()
            for name, proc, restart in (
                    ("state", self.state_proc,
                     self._start_state_service if self.head else None),
                    ("daemon", self.daemon_proc, self._start_daemon)):
                if restart is None or proc is None or proc.poll() is None:
                    continue
                if now - last_restart[name] > self.STABLE_RESET_S:
                    restarts[name] = 0
                backoff = self.RESTART_BACKOFF_S[
                    min(restarts[name], len(self.RESTART_BACKOFF_S) - 1)]
                logger.warning(
                    "%s exited rc=%s; restarting in %.1fs (attempt %d)",
                    name, proc.returncode, backoff, restarts[name] + 1)
                deadline = time.monotonic() + backoff
                while time.monotonic() < deadline and not self._stop:
                    time.sleep(0.1)  # raylint: allow(bare-retry) interruptible slice of the RESTART_BACKOFF_S wait
                if self._stop:
                    break
                try:
                    restart()
                    restarts[name] += 1
                    last_restart[name] = time.monotonic()
                except Exception:
                    logger.exception("restart of %s failed", name)
                    restarts[name] += 1
                    last_restart[name] = time.monotonic()
        self.shutdown()

    def shutdown(self):
        # The daemon first, and the state service only once it is gone: a
        # daemon whose state service died first spends its graceful window
        # retrying it and is killed at the timeout.
        for proc in (self.daemon_proc, self.state_proc):
            if proc is None:
                continue
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=10)
            except Exception as e:
                logger.debug("graceful stop timed out; killing: %s", e)
                proc.kill()
        for name in ("supervisor.pid", "daemon.pid", "state.pid",
                     "address", "daemon.addr"):
            try:
                os.unlink(os.path.join(self.run_dir, name))
            except OSError:
                pass
