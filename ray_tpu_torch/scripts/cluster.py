"""Cluster lifecycle CLI: ``ray_tpu_torch start / stop / status / supervise``.

Parity with the reference's cluster commands
(``python/ray/scripts/scripts.py:532`` ``ray start --head/--address`` and
``ray stop``): ``start --head`` boots a supervised head node (the state
service + host daemon) and writes the cluster address to the run dir;
``start --address=`` joins a worker node; both keep a supervisor process
behind that restarts crashed children (``_private/node.py``). Drivers
connect with ``ray_tpu_torch.init(address=...)``.

Usage:
  python -m ray_tpu_torch.scripts.cluster start --head [--num-cpus N] [--num-gpus N] [--block]
  python -m ray_tpu_torch.scripts.cluster start --address HOST:PORT [--num-cpus N]
  python -m ray_tpu_torch.scripts.cluster status [--run-dir DIR | --address A]
  python -m ray_tpu_torch.scripts.cluster stop [--run-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

#: the port's own run dir, apart from the JAX package's
#: ``$TMPDIR/ray_tpu/cluster``, so that neither package's ``status`` or
#: ``stop`` finds the other's node
DEFAULT_RUN_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                               "cluster")


def read_address(run_dir: str = DEFAULT_RUN_DIR,
                 timeout_s: float = 0.0) -> Optional[str]:
    path = os.path.join(run_dir, "address")
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with open(path) as f:
                addr = f.read().strip()
            if addr:
                return addr
        except OSError:
            pass
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.05)  # raylint: allow(bare-retry) local file-appearance poll, deadline-bounded


def start(head: bool = False, address: str = "",
          num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
          resources: Optional[Dict[str, float]] = None,
          tp_cpu_devices: int = 0, run_dir: str = DEFAULT_RUN_DIR,
          heartbeat_timeout_ms: float = 5000,
          auth: bool = True, auth_token: str = "",
          block: bool = False) -> str:
    """Start a supervised node; returns the cluster (state service) address.

    ``block=False`` leaves a detached ``supervise`` process running; stop
    it with ``stop(run_dir)``.

    ``auth`` (default on) protects every daemon/state connection with a
    shared secret: the head mints one (written to ``<run_dir>/token``,
    mode 0600) unless ``auth_token``/$RAY_TPU_AUTH_TOKEN supplies it;
    workers and drivers must present the same token (reference analogue:
    the redis password every raylet/driver needs).
    """
    if head == bool(address):
        raise ValueError("pass exactly one of head=True or address=...")
    os.makedirs(run_dir, exist_ok=True)
    if os.path.exists(os.path.join(run_dir, "supervisor.pid")):
        raise RuntimeError(
            f"a node is already running from {run_dir} (stale? run stop, "
            f"or remove supervisor.pid)")
    # A crashed previous run may have left address files behind; starting
    # must never hand out a dead address.
    for stale in ("address", "daemon.addr"):
        try:
            os.unlink(os.path.join(run_dir, stale))
        except OSError:
            pass
    token = ""
    if auth:
        token = (auth_token or os.environ.get("RAY_TPU_AUTH_TOKEN", ""))
        if not token:
            if head:
                import secrets
                token = secrets.token_hex(16)
            else:
                raise ValueError(
                    "joining an authenticated cluster needs its token: pass "
                    "auth_token=, set RAY_TPU_AUTH_TOKEN, or use auth=False "
                    "for an open cluster")
        token_path = os.path.join(run_dir, "token")
        fd = os.open(token_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(token)
    if block:
        from ray_tpu_torch._private.node import NodeSupervisor
        sup = NodeSupervisor(run_dir, head=head, state_addr=address,
                             num_cpus=num_cpus, num_gpus=num_gpus,
                             resources=resources,
                             tp_cpu_devices=tp_cpu_devices,
                             heartbeat_timeout_ms=heartbeat_timeout_ms,
                             auth_token=token)
        sup.run()  # returns on SIGTERM/SIGINT
        return read_address(run_dir) or address
    cmd = [sys.executable, "-m", "ray_tpu_torch.scripts.cluster", "supervise",
           "--run-dir", run_dir,
           "--heartbeat-timeout-ms", str(heartbeat_timeout_ms),
           "--resources", json.dumps(resources or {}),
           "--tp-cpu-devices", str(tp_cpu_devices)]
    if token:
        cmd += ["--token-file", os.path.join(run_dir, "token")]
    if head:
        cmd.append("--head")
    else:
        cmd += ["--address", address]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if num_gpus is not None:
        cmd += ["--num-gpus", str(num_gpus)]
    log_path = os.path.join(run_dir, "supervisor.log")
    with open(log_path, "ab") as log:
        subprocess.Popen(cmd, stdout=log, stderr=log,
                         start_new_session=True)
    if head:
        addr = read_address(run_dir, timeout_s=60)
        if addr is None:
            raise TimeoutError(
                f"head did not publish an address (see {log_path})")
    else:
        addr = address
    # Wait for this node's daemon to come up so `start` returning means
    # the node is usable.
    deadline = time.monotonic() + 90
    daemon_addr = None
    while time.monotonic() < deadline:
        try:
            with open(os.path.join(run_dir, "daemon.addr")) as f:
                daemon_addr = f.read().strip()
            if daemon_addr:
                break
        except OSError:
            time.sleep(0.1)  # raylint: allow(bare-retry) local file-appearance poll, deadline-bounded
    if not daemon_addr:
        raise TimeoutError(f"daemon did not start (see {log_path})")
    return addr


def _running(pid: int) -> bool:
    """Alive and not a zombie (an unreaped supervisor child of the caller
    keeps its pid; /proc state tells the truth)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state != "Z"
    except OSError:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False


def stop(run_dir: str = DEFAULT_RUN_DIR, timeout_s: float = 15.0) -> bool:
    """SIGTERM the supervisor (which tears its children down)."""
    pid_path = os.path.join(run_dir, "supervisor.pid")
    try:
        with open(pid_path) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return False
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        os.unlink(pid_path)
        return False
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not _running(pid):
            return True
        time.sleep(0.1)
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    return True


def status(address: Optional[str] = None,
           run_dir: str = DEFAULT_RUN_DIR) -> Dict:
    addr = address or read_address(run_dir)
    if addr is None:
        raise RuntimeError(f"no cluster address (run dir {run_dir})")
    # LOCAL cluster (addr from run_dir): its token file is authoritative.
    # An explicit address may be a different cluster — never assume the
    # local token, and never mutate process env from a status query.
    token = None
    token_path = os.path.join(run_dir, "token")
    if address is None and os.path.exists(token_path):
        with open(token_path) as f:
            token = f.read().strip().encode()
    from ray_tpu_torch._private.state_client import StateClient
    client = StateClient(addr, auth_token=token)
    try:
        nodes = client.list_nodes()
        out = {"address": addr, "nodes": []}
        for n in nodes:
            out["nodes"].append({
                "node_id": n.node_id.hex()[:16],
                "address": n.address,
                "alive": n.alive,
                "is_head": n.is_head,
                "total": dict(n.total.amounts),
                "available": dict(n.available.amounts),
            })
        return out
    finally:
        client.close()


# -- CLI ---------------------------------------------------------------------


def _read_token(path: str) -> str:
    """Token files are written with a trailing newline; strip the way the
    state service does (leading/trailing whitespace)."""
    if not path:
        return ""
    with open(path) as f:
        return f.read().strip()


def _cmd_start(args):
    token = _read_token(args.token_file)
    addr = start(head=args.head, address=args.address or "",
                 num_cpus=args.num_cpus, num_gpus=args.num_gpus,
                 resources=json.loads(args.resources),
                 tp_cpu_devices=args.tp_cpu_devices,
                 run_dir=args.run_dir,
                 heartbeat_timeout_ms=args.heartbeat_timeout_ms,
                 auth=not args.no_auth, auth_token=token,
                 block=args.block)
    print(f"ray_tpu_torch node up; cluster address: {addr}")
    if not args.no_auth:
        print(f"auth token: {os.path.join(args.run_dir, 'token')} "
              f"(workers/drivers need it: RAY_TPU_AUTH_TOKEN or "
              f"init(auth_token=...))")
    print(f'connect with ray_tpu_torch.init(address="{addr}")')


def _cmd_supervise(args):
    import logging
    logging.basicConfig(
        level="INFO",
        format="[supervisor %(asctime)s] %(levelname)s %(message)s")
    token = _read_token(args.token_file)
    from ray_tpu_torch._private.node import NodeSupervisor
    NodeSupervisor(args.run_dir, head=args.head,
                   state_addr=args.address or "",
                   num_cpus=args.num_cpus, num_gpus=args.num_gpus,
                   resources=json.loads(args.resources),
                   tp_cpu_devices=args.tp_cpu_devices,
                   heartbeat_timeout_ms=args.heartbeat_timeout_ms,
                   auth_token=token).run()


def _cmd_stop(args):
    if stop(args.run_dir):
        print("stopped")
    else:
        print("no running node found", file=sys.stderr)
        sys.exit(1)


def _cmd_status(args):
    info = status(address=args.address or None, run_dir=args.run_dir)
    print(f"cluster address: {info['address']}")
    alive = [n for n in info["nodes"] if n["alive"]]
    print(f"nodes: {len(alive)} alive / {len(info['nodes'])} total")
    for n in info["nodes"]:
        role = "head" if n["is_head"] else "worker"
        state = "ALIVE" if n["alive"] else "DEAD"
        print(f"  {n['node_id']} {role:6s} {state:5s} {n['address']:21s} "
              f"avail={n['available']} total={n['total']}")


def _add_node_args(p):
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default="",
                   help="state-service address of an existing cluster")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default="{}")
    p.add_argument("--tp-cpu-devices", type=int, default=0)
    p.add_argument("--run-dir", default=DEFAULT_RUN_DIR)
    p.add_argument("--heartbeat-timeout-ms", type=float, default=5000)
    p.add_argument("--token-file", default="",
                   help="shared-secret file (head generates one by default)")
    p.add_argument("--no-auth", action="store_true",
                   help="run an OPEN cluster (any socket can submit work)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="ray_tpu_torch cluster")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("start")
    _add_node_args(sp)
    sp.add_argument("--block", action="store_true",
                    help="supervise in the foreground")
    sp.set_defaults(fn=_cmd_start)
    vp = sub.add_parser("supervise")
    _add_node_args(vp)
    vp.set_defaults(fn=_cmd_supervise)
    tp = sub.add_parser("stop")
    tp.add_argument("--run-dir", default=DEFAULT_RUN_DIR)
    tp.set_defaults(fn=_cmd_stop)
    up = sub.add_parser("status")
    up.add_argument("--run-dir", default=DEFAULT_RUN_DIR)
    up.add_argument("--address", default="")
    up.set_defaults(fn=_cmd_status)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
