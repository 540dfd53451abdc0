"""In-process multi-node cluster for tests.

Parity with ``python/ray/cluster_utils.py:99`` (``Cluster.add_node`` :165):
spin up N virtual nodes under one runtime so multi-node scheduling, placement
groups, spilling, and failure handling run in CI without real hosts — the
same role the reference's Cluster plays for multi-raylet tests.

``ProcessCluster`` runs real state-service and host-daemon processes
instead (the multi-process runtime).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.resources import CPU, GPU, ResourceSet

logger = logging.getLogger("ray_tpu")


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None):
        self._worker = _worker.init(_create_default_node=False,
                                    ignore_reinit_error=False)
        self._nodes = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def runtime(self):
        return self._worker.runtime

    def add_node(self, num_cpus: Optional[float] = None,
                 num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 **kwargs):
        amounts: Dict[str, float] = {
            CPU: num_cpus if num_cpus is not None else float(os.cpu_count() or 1)}
        if num_gpus:
            amounts[GPU] = num_gpus
        if resources:
            amounts.update(resources)
        node = self.runtime.add_node(ResourceSet(amounts))
        self._nodes.append(node)
        return node

    def remove_node(self, node):
        self.runtime.remove_node(node.node_id)

    def shutdown(self):
        _worker.shutdown()


class ProcessCluster:
    """Real multi-process cluster: one state-service process plus N
    host-daemon processes, each a separate OS process speaking the wire
    protocol — the process-level analogue the reference gets from
    ``Cluster`` starting real raylets (``python/ray/cluster_utils.py:99``).

    Usage::

        cluster = ProcessCluster(num_daemons=2, num_cpus=2)
        cluster.add_daemon(num_gpus=1)   # owns the next free card
        ray_tpu_torch.init(address=cluster.address)
        ...
        cluster.kill_daemon(0)      # chaos: SIGKILL a host
        cluster.shutdown()
    """

    def __init__(self, num_daemons: int = 2, num_cpus: float = 2,
                 resources: Optional[Dict[str, float]] = None,
                 data_dir: str = "", heartbeat_timeout_ms: float = 3000,
                 daemon_heartbeat_s: float = 0.5,
                 tp_cpu_devices: int = 0,
                 daemon_env: Optional[Dict[str, str]] = None):
        """The ``num_daemons`` daemons own no card
        (``CUDA_VISIBLE_DEVICES=""``); ``add_daemon(num_gpus=n)`` adds one
        that owns n cards. ``tp_cpu_devices`` > 0 (the tensor plane's CPU
        collectives) raises ``NotImplementedError``: the tensor plane is
        not ported yet.

        ``daemon_env`` is merged into EVERY daemon's environment —
        including replacements the autoscaler's node provider launches
        later — so a cluster-wide chaos schedule (``RAY_TPU_CHAOS``
        preemption storm) keeps firing on gang-replaced nodes instead of
        silently ending with the first casualty."""
        import subprocess
        from ray_tpu_torch._private.state_client import start_state_service
        if tp_cpu_devices:
            raise NotImplementedError(
                "ProcessCluster(tp_cpu_devices=...) needs the tensor plane "
                "(collective/tensor_plane.py), which is not ported yet "
                "(ROADMAP Queue 1: the process half of collective/)")
        self._subprocess = subprocess
        self._data_dir = data_dir
        self._heartbeat_timeout_ms = heartbeat_timeout_ms
        self.state_proc, self.address = start_state_service(
            data_dir=data_dir, heartbeat_timeout_ms=heartbeat_timeout_ms)
        self.daemons = []
        self._daemon_args = dict(num_cpus=num_cpus,
                                 resources=resources or {},
                                 heartbeat_s=daemon_heartbeat_s,
                                 env=dict(daemon_env or {}))
        # The port's daemons import torch at start-up: start the first
        # ones side by side (they own no card), in index order.
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max(1, num_daemons)) as ex:
            futs = [ex.submit(self._spawn) for _ in range(num_daemons)]
        for f in futs:
            if f.exception() is None:
                self.daemons.append(f.result())
        failed = [f.exception() for f in futs if f.exception() is not None]
        if failed:
            self.shutdown()  # no process of a failed start outlives it
            raise failed[0]

    def node_provider(self, node_types: Dict[str, Dict[str, float]]
                      ) -> "ProcessClusterNodeProvider":
        """An autoscaler NodeProvider whose "cloud" is THIS cluster:
        create_node spawns a real daemon process (the multi-process
        analogue of the reference's fake_multi_node provider)."""
        return ProcessClusterNodeProvider(self, node_types)

    def restart_state_service(self):
        """SIGKILL the state service and restart it on the SAME port
        (journal-recovered when ``data_dir`` was set) — the GCS
        fault-tolerance chaos scenario: daemons and drivers must
        reconnect and re-register, not wedge."""
        from ray_tpu_torch._private.state_client import start_state_service
        port = int(self.address.rsplit(":", 1)[1])
        if self.state_proc.poll() is None:
            self.state_proc.kill()
            self.state_proc.wait(timeout=10)
        self.state_proc, addr = start_state_service(
            port=port, data_dir=self._data_dir,
            heartbeat_timeout_ms=self._heartbeat_timeout_ms)
        assert addr == self.address, (addr, self.address)

    def _machine_cards(self) -> List[str]:
        """The machine's CUDA devices as this process names them in
        ``CUDA_VISIBLE_DEVICES``: its own list where it has one, else
        every device it sees."""
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            return [c.strip() for c in visible.split(",") if c.strip()]
        import torch
        return [str(i) for i in range(torch.cuda.device_count())]

    def _free_cards(self) -> List[str]:
        held = {c for d in self.daemons if d["proc"].poll() is None
                for c in d["cards"]}
        return [c for c in self._machine_cards() if c not in held]

    def add_daemon(self, num_cpus: Optional[float] = None,
                   resources: Optional[Dict[str, float]] = None,
                   num_gpus: float = 0,
                   env: Optional[Dict[str, str]] = None,
                   labels: Optional[Dict[str, str]] = None):
        """Start one more daemon. With ``num_gpus`` > 0 it owns the next
        ``ceil(num_gpus)`` cards of the machine that no live daemon of this
        cluster holds, and raises ``ValueError`` when fewer are free;
        without, it sees no card."""
        cards: List[str] = []
        if num_gpus:
            free = self._free_cards()
            need = math.ceil(num_gpus)
            if need > len(free):
                raise ValueError(
                    f"add_daemon(num_gpus={num_gpus}) needs {need} free "
                    f"card(s); {len(free)} of the machine's "
                    f"{len(self._machine_cards())} are not held by a live "
                    "daemon of this cluster")
            cards = free[:need]
        record = self._spawn(num_cpus, resources, num_gpus, env, labels,
                             cards)
        self.daemons.append(record)
        return record["address"]

    def _spawn(self, num_cpus=None, resources=None, num_gpus: float = 0,
               env=None, labels=None, cards=()) -> dict:
        from ray_tpu_torch._private.node import spawn_daemon
        env_all = dict(self._daemon_args.get("env") or {})  # cluster-wide
        env_all.update(env or {})  # e.g. RAY_TPU_CHAOS / recorder knobs
        proc, addr = spawn_daemon(
            self.address,
            num_cpus=(num_cpus if num_cpus is not None
                      else self._daemon_args["num_cpus"]),
            num_gpus=num_gpus,
            resources=resources or self._daemon_args["resources"],
            heartbeat_s=self._daemon_args["heartbeat_s"],
            labels=labels,
            env_overrides=env_all,
            cards=list(cards))
        return {"proc": proc, "address": addr, "cards": list(cards)}

    def kill_daemon(self, index: int):
        """SIGKILL a host daemon (chaos testing — no graceful teardown)."""
        import signal as _signal
        d = self.daemons[index]
        if d["proc"].poll() is None:
            d["proc"].send_signal(_signal.SIGKILL)
            d["proc"].wait(timeout=10)

    def shutdown(self):
        for d in self.daemons:
            if d["proc"].poll() is None:
                d["proc"].terminate()
        for d in self.daemons:
            try:
                d["proc"].wait(timeout=10)
            except Exception as e:
                logger.debug("daemon stop timed out; killing: %s", e)
                d["proc"].kill()
        if self.state_proc.poll() is None:
            self.state_proc.terminate()
            try:
                self.state_proc.wait(timeout=10)
            except Exception as e:
                logger.debug("state service stop timed out; killing: %s", e)
                self.state_proc.kill()


class ProcessClusterNodeProvider:
    """Autoscaler NodeProvider over a live ``ProcessCluster``: launching
    a node spawns a real host-daemon PROCESS that registers with the
    state service (the reference's ``fake_multi_node`` provider, at
    process rather than in-process granularity). Lets the autoscaler
    loop drive an actual multi-process cluster in tests."""

    def __init__(self, cluster: "ProcessCluster",
                 node_types: Dict[str, Dict[str, float]]):
        import threading
        self._cluster = cluster
        self._node_types = dict(node_types)
        # the autoscaler's monitor thread drives this concurrently with
        # the test thread: all map access is locked (FakeNodeProvider
        # does the same)
        self._lock = threading.Lock()
        self._nodes: Dict[str, int] = {}   # provider id -> daemon index
        self._types: Dict[str, str] = {}
        self._addrs: Dict[str, str] = {}   # provider id -> daemon address
        self._node_ids: Dict[str, object] = {}  # provider id -> NodeID

    def non_terminated_nodes(self):
        with self._lock:
            items = list(self._nodes.items())
        return [pid for pid, idx in items
                if self._cluster.daemons[idx]["proc"].poll() is None]

    def create_node(self, node_type: str, count: int = 1):
        import uuid as _uuid
        if node_type not in self._node_types:
            raise ValueError(f"unknown node type {node_type!r}")
        res = dict(self._node_types[node_type])
        created = []
        for _ in range(count):
            cpus = res.get("CPU", 1)
            extra = {k: v for k, v in res.items()
                     if k not in ("CPU", "GPU")}
            with self._lock:
                # The type label rides on the daemon so hazard journaling
                # (distributed.begin_drain) and per-type rate estimation
                # can attribute preemptions to the node type that had them.
                addr = self._cluster.add_daemon(
                    num_cpus=cpus, resources=extra,
                    num_gpus=res.get("GPU", 0),
                    labels={"autoscaler-node-type": node_type})
                idx = next(i for i, d in enumerate(self._cluster.daemons)
                           if d["address"] == addr)
                pid = f"proc-{node_type}-{_uuid.uuid4().hex[:6]}"
                self._nodes[pid] = idx
                self._types[pid] = node_type
                self._addrs[pid] = addr
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str):
        with self._lock:
            idx = self._nodes.pop(provider_node_id, None)
            self._types.pop(provider_node_id, None)
            self._addrs.pop(provider_node_id, None)
            self._node_ids.pop(provider_node_id, None)
        if idx is not None:
            self._cluster.kill_daemon(idx)

    def node_resources(self, provider_node_id: str):
        with self._lock:
            t = self._types.get(provider_node_id)
        return dict(self._node_types.get(t, {}))

    def node_type(self, provider_node_id: str) -> str:
        with self._lock:
            return self._types[provider_node_id]

    def runtime_node_id(self, provider_node_id: str):
        """Runtime NodeID of the daemon (resolved from the state service
        by address) — _scale_down matches it against node utilization to
        find idle nodes; without it scale-down would silently no-op."""
        with self._lock:
            cached = self._node_ids.get(provider_node_id)
            addr = self._addrs.get(provider_node_id)
        if cached is not None:
            return cached
        from ray_tpu_torch._private.ids import NodeID
        from ray_tpu_torch._private.state_client import StateClient
        state = StateClient(self._cluster.address)
        try:
            for info in state.list_nodes():
                if info.address == addr:
                    nid = NodeID(info.node_id)
                    with self._lock:
                        self._node_ids[provider_node_id] = nid
                    return nid
        finally:
            state.close()
        raise KeyError(provider_node_id)
