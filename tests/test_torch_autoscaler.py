"""The port's autoscaler (``ray_tpu_torch.autoscaler``) against ``ray_tpu``'s.

- ``StandardAutoscaler`` over ``FakeNodeProvider``: the same demand
  sequence (a ``min_workers`` floor, GPU tasks that no node can run, a
  per-type cap, idle scale-down) under both packages gives the same
  ``update()`` decisions and the same nodes.
- ``GPUNodeProvider``, the counterpart of the reference's
  ``TPUPodSliceProvider``, offline through an injected ``command_runner``
  that plays a Compute Engine zone: its command lines, its lifecycle
  (PROVISIONING → STAGING → RUNNING → deleted) beside the TPU provider's
  over a queued-resources fake, rediscovery of the nodes of an earlier
  incarnation, and bad configs.
- One ``ProcessCluster`` (the port's): an infeasible task makes the
  autoscaler start a daemon process, the task runs there at its first
  push, and the idle daemon is terminated
  (``tests/test_distributed_cluster.py``'s case).
"""

import importlib
import json
import os
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.autoscaler.tpu_provider import TPUPodSliceProvider
from ray_tpu_torch.autoscaler import (AutoscalerConfig, GPUNodeProvider,
                                      StandardAutoscaler)

RUNTIMES = (ray_tpu, ray_tpu_torch)
NODE_TYPES = {"cpu-2": {"CPU": 2}, "gpu-1": {"CPU": 2, "GPU": 1}}


def sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _wait(pred, timeout=10.0, poll_s=0.01):
    """Whether ``pred()`` came true within ``timeout`` (each call counts:
    ``pred`` may act, as ``update()`` does)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


def _demand_sequence(rt):
    """Drive one autoscaler through a fixed demand sequence; -> each
    update()'s decisions with the provider's node types after it."""
    auto = sub(rt, "autoscaler")
    rt.shutdown()
    rt.init(num_cpus=1)
    try:
        runtime = sub(rt, "_private.worker").global_worker().runtime
        provider = auto.FakeNodeProvider(runtime, NODE_TYPES)
        scaler = auto.StandardAutoscaler(
            auto.AutoscalerConfig(node_types=NODE_TYPES, min_workers=1,
                                  max_workers=3, idle_timeout_s=0.0,
                                  max_workers_per_type={"gpu-1": 1}),
            provider, runtime=runtime)
        steps = []

        def step(what):
            out = scaler.update()
            steps.append((what, out, sorted(
                provider.node_type(p)
                for p in provider.non_terminated_nodes())))

        step("empty cluster: min_workers")
        gate = threading.Event()

        @rt.remote(num_gpus=1, num_cpus=1)
        def on_gpu(i):
            gate.wait(30)
            return i

        refs = [on_gpu.remote(i) for i in range(2)]
        _wait(lambda: len(scaler.load_metrics.pending_demands()) == 2)
        step("two GPU tasks, no GPU node")
        _wait(lambda: not scaler.load_metrics.pending_demands()
              or len(scaler.load_metrics.pending_demands()) == 1)
        step("one GPU node busy, one task queued: capped per type")
        gate.set()
        steps.append(("answers", sorted(rt.get(refs, timeout=30))))
        step("idle: down to min_workers")
        step("at min_workers")
        scaler.stop()
        return steps
    finally:
        rt.shutdown()


def test_update_decisions_match_jax():
    got, want = (_demand_sequence(ray_tpu_torch), _demand_sequence(ray_tpu))
    assert got == want
    assert [s[1]["launched"] for s in got if len(s) == 3] == [1, 1, 0, 0, 0]
    assert got[-1][2] == ["gpu-1"]


# -- the GPU provider, offline ----------------------------------------------

class FakeZone:
    """A Compute Engine zone behind ``gcloud compute instances``: each list
    moves every instance one state on (PROVISIONING → STAGING →
    RUNNING)."""

    NEXT = {"PROVISIONING": "STAGING", "STAGING": "RUNNING"}

    def __init__(self, instances=None):
        self.calls = []
        self.instances = dict(instances or {})   # name -> status

    def __call__(self, args):
        self.calls.append(list(args))
        verb = args[2]
        if verb == "create":
            self.instances[args[3]] = "PROVISIONING"
            return ""
        if verb == "delete":
            self.instances.pop(args[3])
            return ""
        assert verb == "list", args
        out = [{"name": f"projects/p/zones/z/instances/{n}", "status": s}
               for n, s in self.instances.items()]
        for n, s in self.instances.items():
            self.instances[n] = self.NEXT.get(s, s)
        return json.dumps(out)


class FakeQueuedResources:
    """The reference provider's cloud: queued resources that go
    PROVISIONING → ACTIVE."""

    def __init__(self):
        self.calls = []
        self.resources = {}

    def __call__(self, args):
        self.calls.append(list(args))
        verb = args[3]
        if verb == "create":
            self.resources[args[4]] = "PROVISIONING"
            return ""
        if verb == "delete":
            self.resources.pop(args[4])
            return ""
        out = [{"name": f"projects/p/locations/z/queuedResources/{n}",
                "state": {"state": s}} for n, s in self.resources.items()]
        for n in self.resources:
            self.resources[n] = "ACTIVE"
        return json.dumps(out)


GPU_CONFIG = {
    "project": "p", "zone": "us-central1-a",
    "cluster_address": "head:6379", "auth_token": "s3cret",
    "node_types": {
        "h100-8": {"machine_type": "a3-highgpu-8g",
                   "accelerator_type": "nvidia-h100-80gb",
                   "accelerator_count": 8,
                   "resources": {"CPU": 208, "GPU": 8}}}}
TPU_CONFIG = {
    "project": "p", "zone": "us-central2-b",
    "cluster_address": "head:6379", "auth_token": "s3cret",
    "node_types": {"v5e-8": {"accelerator_type": "v5litepod-8",
                             "resources": {"CPU": 208, "TPU": 8}}}}


def _lifecycle(provider, node_type):
    """Create, list until live, read back, terminate, list."""
    (pid,) = provider.create_node(node_type, 1)
    out = [pid.startswith(f"raytpu-{node_type}-"),
           [provider.non_terminated_nodes() == [pid] for _ in range(3)],
           provider.node_type(pid),
           sorted(provider.node_resources(pid).values())]
    provider.terminate_node(pid)
    out.append(provider.non_terminated_nodes())
    return out


def test_gpu_provider_lifecycle_matches_the_tpu_providers():
    zone = FakeZone()
    got = _lifecycle(GPUNodeProvider(GPU_CONFIG, command_runner=zone),
                     "h100-8")
    want = _lifecycle(TPUPodSliceProvider(
        TPU_CONFIG, command_runner=FakeQueuedResources()), "v5e-8")
    assert got[0] and want[0] and got[1] == want[1] == [True] * 3
    assert (got[2], want[2]) == ("h100-8", "v5e-8")
    assert got[3:] == want[3:] == [[8, 208], []]
    create, *_, delete, _ = zone.calls
    name = create[3]
    assert create == [
        "compute", "instances", "create", name,
        "--machine-type=a3-highgpu-8g",
        "--accelerator=type=nvidia-h100-80gb,count=8",
        "--maintenance-policy=TERMINATE",
        "--image-family=common-cu124",
        "--image-project=deeplearning-platform-release",
        "--project=p", "--zone=us-central1-a",
        "--metadata=startup-script=#! /bin/bash\n"
        "export RAY_TPU_AUTH_TOKEN=s3cret\n"
        "python -m ray_tpu_torch.scripts.cluster start "
        "--address=head:6379 --block &\n"]
    assert zone.calls[1] == ["compute", "instances", "list", "--format=json",
                             "--project=p", "--zones=us-central1-a"]
    assert delete == ["compute", "instances", "delete", name, "--quiet",
                      "--project=p", "--zone=us-central1-a"]


def test_gpu_provider_rediscovers_its_nodes_and_skips_others():
    zone = FakeZone({"raytpu-h100-8-0123abcd": "RUNNING",
                     "raytpu-h100-8-4567ef01": "TERMINATED",
                     "someone-elses-vm": "RUNNING",
                     "raytpu-h100-8-89ab2345": "STOPPING"})
    provider = GPUNodeProvider(GPU_CONFIG, command_runner=zone)
    assert provider.non_terminated_nodes() == ["raytpu-h100-8-0123abcd"]
    assert provider.node_type("raytpu-h100-8-0123abcd") == "h100-8"
    assert provider.node_resources("raytpu-h100-8-0123abcd") == {
        "CPU": 208, "GPU": 8}
    # the same for the reference's provider, over its own cloud
    qr = FakeQueuedResources()
    qr.resources = {"raytpu-v5e-8-0123abcd": "ACTIVE",
                    "raytpu-v5e-8-4567ef01": "DELETING"}
    tpu = TPUPodSliceProvider(TPU_CONFIG, command_runner=qr)
    assert tpu.non_terminated_nodes() == ["raytpu-v5e-8-0123abcd"]
    assert tpu.node_type("raytpu-v5e-8-0123abcd") == "v5e-8"


@pytest.mark.parametrize("missing", ["project", "zone", "node_types"])
def test_gpu_provider_refuses_bad_configs_as_the_tpu_provider_does(missing):
    for cls, cfg, word in ((GPUNodeProvider, GPU_CONFIG, "GPU"),
                           (TPUPodSliceProvider, TPU_CONFIG, "TPU")):
        bad = {k: v for k, v in cfg.items() if k != missing}
        with pytest.raises(ValueError,
                           match=f"{word} provider config missing"):
            cls(bad, command_runner=FakeZone())
        with pytest.raises(ValueError, match="unknown node type 'nope'"):
            cls(cfg, command_runner=FakeZone()).create_node("nope")


def test_gpu_provider_without_a_head_or_token_and_on_spot():
    zone = FakeZone()
    cfg = dict(GPU_CONFIG, spot=True)
    del cfg["cluster_address"]
    GPUNodeProvider(cfg, command_runner=zone).create_node("h100-8", 2)
    assert len(zone.calls) == 2
    for call in zone.calls:
        assert call[-1] == "--provisioning-model=SPOT"
        assert not any(a.startswith("--metadata") for a in call)
    cfg = dict(GPU_CONFIG)
    del cfg["auth_token"]
    zone = FakeZone()
    GPUNodeProvider(cfg, command_runner=zone).create_node("h100-8")
    assert zone.calls[0][-1] == (
        "--metadata=startup-script=#! /bin/bash\n"
        "python -m ray_tpu_torch.scripts.cluster start "
        "--address=head:6379 --block &\n")


def _launches_for_accelerator_demand(rt, provider, node_type, demand):
    """Three ``update()``s over a cloud provider while one task asks for
    more accelerators than any node has: -> their launch counts."""
    auto = sub(rt, "autoscaler")
    resources = provider.provider_config["node_types"][node_type][
        "resources"]
    rt.shutdown()
    rt.init(num_cpus=1)
    try:
        scaler = auto.StandardAutoscaler(
            auto.AutoscalerConfig(node_types={node_type: resources},
                                  max_workers=2), provider)
        ref = rt.remote(**demand)(lambda: 1).remote()
        assert _wait(lambda: scaler.load_metrics.pending_demands())
        out = [scaler.update()["launched"] for _ in range(3)]
        rt.cancel(ref)
        scaler.stop()
        return out
    finally:
        rt.shutdown()


def test_autoscaler_launches_gpu_vms_as_the_reference_launches_slices():
    """A task no node can run: each ``update()`` creates a VM of the type
    that fits until ``max_workers`` (a VM that has not joined yet leaves
    the demand unmet), as the reference's autoscaler creates slices."""
    zone = FakeZone()
    got = _launches_for_accelerator_demand(
        ray_tpu_torch, GPUNodeProvider(GPU_CONFIG, command_runner=zone),
        "h100-8", {"num_gpus": 4})
    want = _launches_for_accelerator_demand(
        ray_tpu, TPUPodSliceProvider(TPU_CONFIG,
                                     command_runner=FakeQueuedResources()),
        "v5e-8", {"num_tpus": 4})
    assert got == want == [1, 1, 0]
    assert [c[2] for c in zone.calls].count("create") == 2


# -- one ProcessCluster -----------------------------------------------------

def test_process_cluster_autoscales_a_daemon_up_and_down(tmp_path,
                                                        monkeypatch):
    from ray_tpu_torch.cluster_utils import ProcessCluster
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ray_tpu_torch.shutdown()
    cluster = ProcessCluster(num_daemons=1, num_cpus=2)
    try:
        ray_tpu_torch.init(address=cluster.address)
        rt = sub(ray_tpu_torch, "_private.worker").global_worker().runtime
        provider = cluster.node_provider({"big": {"CPU": 8}})
        scaler = StandardAutoscaler(
            AutoscalerConfig(min_workers=0, max_workers=2,
                             idle_timeout_s=0.5,
                             node_types={"big": {"CPU": 8}}),
            provider, runtime=rt)

        @ray_tpu_torch.remote(num_cpus=6)
        def heavy():
            return os.getpid()

        ref = heavy.remote()   # infeasible on the 2-CPU daemon
        assert _wait(lambda: scaler.update()["launched"] == 1, 60, 0.3)
        assert ray_tpu_torch.get(ref, timeout=90) == \
            cluster.daemons[-1]["proc"].pid
        # The task's first push to the new daemon succeeded: a daemon
        # listed before its handlers' state existed failed it, and its
        # address was shunned for 10 s (reference fault fixed in the port).
        assert cluster.daemons[-1]["address"] not in rt._suspect_addrs
        assert _wait(lambda: scaler.update()["terminated"] == 1, 60, 0.3)
        assert provider.non_terminated_nodes() == []
        scaler.stop()
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
