"""The port's dashboard head and state server.

One port ``ProcessCluster`` for the module, a driver joined with
``init(address=, include_dashboard=True)``, and its head's endpoints read
over HTTP. The JAX package's head, never started, reads the same cluster
through its API methods (both speak the same state-service and daemon
protocol), and the tables must agree. ``init(include_dashboard=True)``
without ``address=`` serves the state server the CLI attaches to.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu.dashboard.head import DashboardHead as JaxHead
from ray_tpu_torch import doctor
from ray_tpu_torch._private import state_server
from ray_tpu_torch._private.config import _config
from ray_tpu_torch.autopilot import actuators
from ray_tpu_torch.dashboard import DashboardHead, start_dashboard


def _get(port, path, raw=False):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        body = r.read()
    return body.decode() if raw else json.loads(body)


def test_init_include_dashboard_without_address_serves_the_state_server(
        capsys, monkeypatch, tmp_path):
    # a session of its own: other test files' drivers share the default
    monkeypatch.setattr(state_server, "SESSION_DIR", str(tmp_path))
    monkeypatch.setattr(state_server, "PORT_FILE", str(tmp_path / "port"))
    w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, include_dashboard=True)
    try:
        port = w.dashboard_port
        assert state_server.discover_port() == port

        @ray_tpu_torch.remote
        def served():
            return 1

        assert ray_tpu_torch.get([served.remote() for _ in range(2)]) == [1, 1]
        status = _get(port, "/api/status")
        assert status["initialized"]
        assert status["task_summary"]["total"] >= 2
        assert "# TYPE" in _get(port, "/metrics", raw=True)
        from ray_tpu_torch.scripts.cli import main
        main(["--port", str(port), "status"])
        assert "Nodes: 1 alive" in capsys.readouterr().out
        main(["status"])     # the port found through the session file
        assert "Nodes: 1 alive" in capsys.readouterr().out
    finally:
        ray_tpu_torch.shutdown()
    assert state_server.discover_port() is None
    with pytest.raises(urllib.error.URLError):
        _get(port, "/api/status")


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.cluster_utils import ProcessCluster
    c = ProcessCluster(num_daemons=2, num_cpus=2)
    w = ray_tpu_torch.init(address=c.address, include_dashboard=True)

    @ray_tpu_torch.remote
    class Counter:
        def ping(self):
            return 1

    counter = Counter.remote()
    assert ray_tpu_torch.get(counter.ping.remote(), timeout=60) == 1
    try:
        yield c, w
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def _until(fn, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while True:
        out = fn()
        if out or time.monotonic() > deadline:
            return out
        time.sleep(0.2)


def _check_cluster(payload, c):
    daemons = {d["address"] for d in c.daemons}
    nodes = [n for n in payload["nodes"] if n["address"] in daemons]
    assert len(nodes) == 2 and all(n["alive"] for n in nodes)
    assert all(n["total"]["CPU"] == 2.0 for n in nodes)
    stats = _until(lambda: all(n["stats"] for n in _get_cluster_nodes(
        payload["_port"], daemons)))
    assert stats, "no reporter stats"


def _get_cluster_nodes(port, daemons):
    return [n for n in _get(port, "/api/cluster")["nodes"]
            if n["address"] in daemons]


ENDPOINTS = ["/", "/api/cluster", "/api/actors", "/api/jobs", "/api/pgs",
             "/api/stats", "/api/perf", "/api/goodput", "/api/comms",
             "/api/autopilot", "/api/forensics", "/api/timeline",
             "/api/metrics", "/metrics", "/api/profile?seconds=0",
             "/api/actor", "/api/node_debug", "/api/trace"]


@pytest.mark.parametrize("path", ENDPOINTS)
def test_every_endpoint_of_the_head(cluster, path):
    c, w = cluster
    port = w.dashboard_port
    if path in ("/", "/metrics"):
        text = _get(port, path, raw=True)
        assert ("ray_tpu_torch cluster" in text and "n.total.GPU" in text
                if path == "/" else "# TYPE" in text)
        return
    if path == "/api/actor":
        (counter,) = [a for a in _get(port, "/api/actors")
                      if a["class_name"] == "Counter"]
        path += f"?id={counter['actor_id']}"
    elif path == "/api/node_debug":
        daemon = c.daemons[-1]["address"]
        (node,) = [n for n in _get(port, "/api/cluster")["nodes"]
                   if n["address"] == daemon]
        path += f"?node={node['node_id']}&lines=50"
    elif path == "/api/trace":
        assert "error" in _get(port, path)      # no ?id=
        events = _get(port, "/api/timeline")["traceEvents"]
        trace = next(e["args"]["trace_id"] for e in events
                     if (e.get("args") or {}).get("trace_id"))
        path += f"?id={trace}"
    payload = _get(port, path)
    assert not (isinstance(payload, dict) and "error" in payload), payload
    if path.startswith("/api/actor?"):
        assert payload["class_name"] == "Counter"
    elif path.startswith("/api/node_debug"):
        assert "logs" in payload and payload["address"] == daemon
    elif path.startswith("/api/trace"):
        assert payload["num_events"] >= 1
    if path == "/api/cluster":
        payload["_port"] = port
        _check_cluster(payload, c)
    elif path == "/api/actors":
        assert any(a["class_name"] == "Counter" and a["state"] == "ALIVE"
                   for a in payload), payload
    elif path == "/api/jobs":
        assert any(j["state"] == "RUNNING" for j in payload), payload
    elif path == "/api/perf":
        assert "head" in payload["nodes"] and payload["missing_hosts"] == []
        assert payload["cluster"]["rpc.call"]["count"] > 0
    elif path == "/api/autopilot":
        assert payload["enabled"] is False and payload["journal"] == []
    elif path == "/api/forensics":
        assert "stacks" in payload["head"]
        assert len(payload["nodes"]) >= 2 and payload["missing_hosts"] == []
    elif path in ("/api/timeline", "/api/metrics"):
        assert payload["missing_hosts"] == []


def test_the_jax_package_head_reads_the_same_tables(cluster):
    c, w = cluster
    ours, theirs = w.dashboard_head, JaxHead(c.address)
    try:
        assert ours._actors() == theirs._actors()
        assert ours._jobs() == theirs._jobs()
        assert ours._pgs() == theirs._pgs()
        strip = [{k: v for k, v in n.items() if k != "stats"}
                 for n in ours._cluster()["nodes"]]
        assert strip == [{k: v for k, v in n.items() if k != "stats"}
                         for n in theirs._cluster()["nodes"]]
        assert set(ours._forensics()["nodes"]) == \
            set(theirs._forensics()["nodes"])
    finally:
        theirs.stop()


def test_the_doctor_collects_through_the_port_head(cluster):
    c, _ = cluster
    collected = doctor.collect(address=c.address, seal=False)
    assert collected["errors"] == []
    cl = collected["cluster"]
    assert len([n for n in cl["nodes"]["nodes"] if n["alive"]]) >= 3
    assert cl["autopilot"]["decisions"] == []
    report = doctor.diagnose(collected)
    assert report["unreachable_hosts"] == []
    assert doctor.render_text(report).startswith("ray_tpu_torch doctor\n")


def test_an_autopilot_enabled_head_hosts_the_controller(cluster):
    c, _ = cluster
    was = _config.get("autopilot_enabled")
    _config.set("autopilot_enabled", True)
    try:
        head = start_dashboard(c.address)
    finally:
        _config.set("autopilot_enabled", was)
    try:
        assert head.autopilot is not None
        head.autopilot.poke()
        status = _until(lambda: (lambda s: s if s["ticks"] else None)(
            _get(head.port, "/api/autopilot")))
        assert status["enabled"] is True and status["ticks"] >= 1
        assert "data_prefetch_batches" in status["actuators"]
        assert status["last_error"] is None, status
    finally:
        head.stop()
        for name in list(actuators.registry().names()):
            if not name.startswith("serve."):
                actuators.registry().unregister(name)
    assert head.autopilot is None


def test_partial_federation_failure_gives_missing_hosts(cluster):
    """A daemon SIGKILLed while the state service still lists it alive:
    the federation endpoints answer with the survivors and name it in
    ``missing_hosts``. Run last: it kills one of the module's daemons."""
    c, w = cluster
    port = w.dashboard_port
    n_sources = len(_get(port, "/api/metrics")["snapshots"])
    dead = c.daemons[0]["address"]
    c.kill_daemon(0)
    for path in ("/api/timeline", "/api/metrics", "/api/perf",
                 "/api/forensics"):
        payload = _get(port, path)
        assert "error" not in payload, payload
        assert [m["address"] for m in payload["missing_hosts"]] == [dead], \
            (path, payload["missing_hosts"])
        assert payload["missing_hosts"][0]["error"]
    assert len(_get(port, "/api/metrics")["snapshots"]) == n_sources - 1
    assert "federation_missing_hosts{" in _get(port, "/metrics", raw=True)


def test_shutdown_stops_the_head(cluster):
    _, w = cluster
    port, head = w.dashboard_port, w.dashboard_head
    assert isinstance(head, DashboardHead)
    ray_tpu_torch.shutdown()
    with pytest.raises(urllib.error.URLError):
        _get(port, "/api/cluster")
