"""The port's cluster CLI (``scripts/cluster.py``) and command line
(``scripts/cli.py``).

A port head and a JAX-package head are started side by side by their own
``python -m ... start --head``, each in its package's default run dir
under one temporary ``TMPDIR``: neither package's ``status`` or ``stop``
sees the other's node. A driver attaches with the head's token, the GPU
node provider's startup script joins a node to the port head as written,
and a killed daemon comes back under its supervisor.
"""

import os
import re
import subprocess
import sys
import tempfile
import time

import pytest

import ray_tpu_torch
from ray_tpu._private import state_server as jax_state_server
from ray_tpu.scripts import cli as jax_cli
from ray_tpu.scripts import cluster as jax_cluster
from ray_tpu_torch._private import state_server
from ray_tpu_torch.scripts import cli
from ray_tpu_torch.scripts import cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_run_and_session_dirs_are_the_ports_own(monkeypatch,
                                                        tmp_path):
    tmp = tempfile.gettempdir()
    assert cluster.DEFAULT_RUN_DIR == os.path.join(tmp, "ray_tpu_torch",
                                                   "cluster")
    assert state_server.SESSION_DIR == os.path.join(tmp, "ray_tpu_torch")
    assert cluster.DEFAULT_RUN_DIR != jax_cluster.DEFAULT_RUN_DIR
    assert state_server.PORT_FILE != jax_state_server.PORT_FILE
    # the doctor's default flight dir, which it reads and seals, too
    from ray_tpu._private.config import _config as jax_config
    from ray_tpu_torch._private.config import _config
    flight = _config._defs["flight_recorder_dir"]
    assert flight[1] == os.path.join(tmp, "ray_tpu_torch", "flight")
    assert flight[1] != jax_config._defs["flight_recorder_dir"][1]
    # a session of its own: other test files' drivers share the default
    monkeypatch.setattr(state_server, "SESSION_DIR", str(tmp_path))
    monkeypatch.setattr(state_server, "PORT_FILE", str(tmp_path / "port"))
    port = state_server.start_state_server(0)
    try:
        assert state_server.discover_port() == port
        assert jax_state_server.discover_port() != port
    finally:
        state_server.stop_state_server()
    assert state_server.discover_port() is None


def _help(main, argv, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    text = capsys.readouterr().out
    return re.sub(r"\s+", " ", text.split("\n", 1)[1]) if "\n" in text \
        else text


@pytest.mark.parametrize("sub", ["status", "list", "summary", "memory",
                                 "timeline", "events", "doctor", "drain",
                                 "top", "dashboard"])
def test_cli_has_the_reference_subcommands_and_arguments(sub, capsys):
    want = _help(jax_cli.main, [sub, "--help"], capsys)
    got = _help(cli.main, [sub, "--help"], capsys)
    assert got == want
    top = _help(cli.main, ["--help"], capsys)
    assert top == _help(jax_cli.main, ["--help"], capsys)
    assert sub in top


def test_cluster_cli_renames_tpus_to_gpus(capsys):
    got = _help(cluster.main, ["start", "--help"], capsys)
    want = _help(jax_cluster.main, ["start", "--help"], capsys)
    assert "--num-gpus" in got and "--num-tpus" not in got
    assert got == want.replace("--num-tpus", "--num-gpus").replace(
        "NUM_TPUS", "NUM_GPUS")
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert capsys.readouterr().out.startswith("usage: ray_tpu_torch ")


def _env(tmp, **extra):
    env = dict(os.environ, TMPDIR=str(tmp), JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop("RAY_TPU_AUTH_TOKEN", None)
    env.update(extra)
    return env


def _cli(package, *args, env, timeout=120, check=True):
    p = subprocess.run([sys.executable, "-m", f"{package}.scripts.cluster",
                        *args], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    if check:
        assert p.returncode == 0, (args, p.stdout, p.stderr)
    return p


def _pids(run_dir):
    pids = []
    for name in ("supervisor.pid", "state.pid", "daemon.pid"):
        try:
            with open(os.path.join(run_dir, name)) as f:
                pids.append(int(f.read()))
        except (OSError, ValueError):
            pass
    return pids


def _gone(pids, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while any(cluster._running(p) for p in pids):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.1)
    return True


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    """Both packages' heads, side by side, each in its default run dir
    under one ``TMPDIR``."""
    tmp = tmp_path_factory.mktemp("clusters")
    env = _env(tmp)
    starts = [subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.scripts.cluster", "start", "--head",
         "--num-cpus=1", *extra], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg, extra in (("ray_tpu_torch", ["--num-gpus=0"]),
                           ("ray_tpu", []))]
    outs = [p.communicate(timeout=180) for p in starts]
    dirs = {"ray_tpu_torch": os.path.join(tmp, "ray_tpu_torch", "cluster"),
            "ray_tpu": os.path.join(tmp, "ray_tpu", "cluster")}
    try:
        for p, (out, err) in zip(starts, outs):
            assert p.returncode == 0, (out, err)
        yield tmp, env, dirs
    finally:
        for d in dirs.values():
            pids = _pids(d)
            cluster.stop(d)
            _gone(pids)


def _status(package, env):
    text = _cli(package, "status", env=env).stdout
    addr = re.search(r"cluster address: (\S+)", text).group(1)
    alive = int(re.search(r"nodes: (\d+) alive", text).group(1))
    return addr, alive


def test_side_by_side_clusters_see_only_their_own_node(heads):
    tmp, env, dirs = heads
    ours = _status("ray_tpu_torch", env)
    theirs = _status("ray_tpu", env)
    with open(os.path.join(dirs["ray_tpu_torch"], "address")) as f:
        assert ours == (f.read().strip(), 1)
    with open(os.path.join(dirs["ray_tpu"], "address")) as f:
        assert theirs == (f.read().strip(), 1)
    assert ours[0] != theirs[0]
    for d in dirs.values():
        mode = os.stat(os.path.join(d, "token")).st_mode & 0o777
        assert mode == 0o600, oct(mode)


def test_a_driver_attaches_with_the_heads_token(heads):
    _, _, dirs = heads
    d = dirs["ray_tpu_torch"]
    address = cluster.read_address(d)
    with open(os.path.join(d, "token")) as f:
        token = f.read().strip()
    ray_tpu_torch.init(address=address, auth_token=token)
    try:
        @ray_tpu_torch.remote
        def where():
            return os.getpid()

        assert ray_tpu_torch.get(where.remote(), timeout=60) in _pids(d)
    finally:
        ray_tpu_torch.shutdown()
    assert "RAY_TPU_AUTH_TOKEN" not in os.environ


def test_the_gpu_providers_startup_script_joins_a_node(heads, tmp_path):
    """The script a ``GPUNodeProvider`` VM boots with, run as written (its
    own ``TMPDIR``, as a VM has its own disk): a node joins the head."""
    from ray_tpu_torch.autoscaler.gpu_provider import GPUNodeProvider
    _, env, dirs = heads
    d = dirs["ray_tpu_torch"]
    with open(os.path.join(d, "token")) as f:
        token = f.read().strip()
    provider = GPUNodeProvider(
        {"project": "p", "zone": "z", "node_types": {},
         "cluster_address": cluster.read_address(d), "auth_token": token},
        command_runner=lambda args: "")
    script = tmp_path / "startup.sh"
    script.write_text(provider._startup_script())
    vm = tmp_path / "vm"
    vm.mkdir()
    subprocess.run(["bash", str(script)], env=_env(vm), cwd=REPO,
                   check=True, timeout=60, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    vm_dir = os.path.join(vm, "ray_tpu_torch", "cluster")
    try:
        deadline = time.monotonic() + 90
        while _status("ray_tpu_torch", env)[1] < 2:
            assert time.monotonic() < deadline, "the VM's node never joined"
            time.sleep(0.5)
        assert os.path.exists(os.path.join(vm_dir, "daemon.addr"))
    finally:
        pids = _pids(vm_dir)
        cluster.stop(vm_dir)
        assert _gone(pids), pids


def test_a_killed_daemon_is_restarted_by_its_supervisor(heads):
    _, env, dirs = heads
    d = dirs["ray_tpu_torch"]
    with open(os.path.join(d, "daemon.pid")) as f:
        old = int(f.read())
    os.kill(old, 9)
    deadline = time.monotonic() + 60
    while True:
        try:
            with open(os.path.join(d, "daemon.pid")) as f:
                new = int(f.read())
        except (OSError, ValueError):
            new = old
        if new != old and cluster._running(new):
            break
        assert time.monotonic() < deadline, "no restart"
        time.sleep(0.2)  # raylint: allow(bare-retry) deadline-bounded restart poll, not a failure retry
    # the restarted daemon registers as a fresh node
    client = cluster.status(run_dir=d)
    assert sum(n["alive"] for n in client["nodes"]) >= 1
    addrs = {n["address"] for n in client["nodes"] if n["alive"]}
    deadline = time.monotonic() + 60
    while True:
        with open(os.path.join(d, "daemon.addr")) as f:
            addr = f.read().strip()
        if addr in addrs:
            break
        assert time.monotonic() < deadline, (addr, addrs)
        time.sleep(0.2)
        addrs = {n["address"] for n in cluster.status(run_dir=d)["nodes"]
                 if n["alive"]}


def test_the_ports_stop_leaves_the_jax_package_running(heads):
    _, env, dirs = heads
    pids = _pids(dirs["ray_tpu_torch"])
    assert len(pids) == 3
    _cli("ray_tpu_torch", "stop", env=env)
    assert _gone(pids), pids
    assert _cli("ray_tpu_torch", "stop", env=env, check=False).returncode == 1
    assert _status("ray_tpu", env)[1] == 1
    assert all(cluster._running(p) for p in _pids(dirs["ray_tpu"]))


class _Proc:
    """A child process that records what its supervisor does to it."""

    def __init__(self, name, events):
        self.name, self.events, self.done = name, events, False

    def poll(self):
        return 0 if self.done else None

    def terminate(self):
        self.events.append(("terminate", self.name))

    def wait(self, timeout=None):
        self.events.append(("wait", self.name))
        self.done = True
        return 0

    def kill(self):
        self.events.append(("kill", self.name))


@pytest.mark.parametrize("package", ["ray_tpu_torch", "ray_tpu"])
def test_the_supervisor_stops_its_daemon_before_the_state_service(
        package, tmp_path):
    """The port's ``NodeSupervisor.shutdown`` waits for its daemon before
    it stops the state service. The JAX package's stops both at once, so
    its daemon spends its graceful window retrying a gone state service
    and is killed at the timeout (``stop`` takes ~10 s longer)."""
    import importlib
    node = importlib.import_module(f"{package}._private.node")
    events = []
    sup = node.NodeSupervisor(str(tmp_path), head=True)
    sup.daemon_proc = _Proc("daemon", events)
    sup.state_proc = _Proc("state", events)
    sup.shutdown()
    if package == "ray_tpu_torch":
        assert events == [("terminate", "daemon"), ("wait", "daemon"),
                          ("terminate", "state"), ("wait", "state")]
    else:
        assert events == [("terminate", "daemon"), ("terminate", "state"),
                          ("wait", "daemon"), ("wait", "state")]
