"""The port's lock-order watchdog (``ray_tpu_torch/devtools/lockwatch.py``)
against the JAX package's, and its hooks in ``ray_tpu_torch``.

The same scenarios run through both watchdogs (each with explicitly
wrapped locks, so neither needs installing) and must report the same
cycle text; the hooks are checked in subprocesses started with
``RAY_TPU_LOCKWATCH=1``, where ``import ray_tpu_torch`` installs the
watchdog before any of its modules creates a lock.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu.devtools import lockwatch as ref_lw
from ray_tpu_torch.devtools import lockwatch as port_lw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = pytest.mark.parametrize("lw", [ref_lw, port_lw],
                               ids=["ray_tpu", "ray_tpu_torch"])


@pytest.fixture(autouse=True)
def _fresh_graphs():
    ref_lw.reset()
    port_lw.reset()
    yield
    ref_lw.reset()
    port_lw.reset()


def _fresh():
    """Both graphs emptied. Under an ambient ``RAY_TPU_LOCKWATCH`` the
    JAX package's ``wrap`` builds its lock through the installed factory,
    so its scenario also records in the port's graph."""
    ref_lw.reset()
    port_lw.reset()


def _abba(lw, prefix):
    """Thread 1 takes A then B; thread 2, after it, B then A."""
    _fresh()
    a = lw.wrap(name=f"{prefix}:lock_a")
    b = lw.wrap(name=f"{prefix}:lock_b")
    first_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        first_done.set()

    def t2():
        first_done.wait(timeout=10)
        with b:
            with a:
                pass

    threads = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return [lw.format_cycle(c["kind"], c["sites"]) for c in lw.cycles()]


def test_abba_gives_the_same_cycle_text_in_both_watchdogs():
    ref = _abba(ref_lw, "fixture")
    port = _abba(port_lw, "fixture")
    assert ref == port == [
        "CYCLE (site-order): fixture:lock_a -> fixture:lock_b"]


def test_same_site_inversion_matches():
    def inversion(lw):
        _fresh()
        x = lw.wrap(name="fixture:node")
        y = lw.wrap(name="fixture:node")
        with x:
            with y:
                pass
        with y:
            with x:
                pass
        return [lw.format_cycle(c["kind"], c["sites"]) for c in lw.cycles()]

    assert inversion(ref_lw) == inversion(port_lw) == [
        "CYCLE (same-site-inversion): fixture:node"]


@BOTH
def test_consistent_order_is_quiet(lw):
    a = lw.wrap(name="fixture:ordered_a")
    b = lw.wrap(name="fixture:ordered_b")

    def use():
        with a:
            with b:
                pass

    threads = [threading.Thread(target=use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert lw.cycles() == []
    edges = lw.report()["edges"]
    assert [(e["from"], e["to"], e["count"]) for e in edges] == [
        ("fixture:ordered_a", "fixture:ordered_b", 2)]


@BOTH
def test_long_hold_is_reported(lw, monkeypatch):
    monkeypatch.setenv("RAY_TPU_LOCKWATCH_HOLD_S", "0.01")
    lk = lw.wrap(name="fixture:slow_lock")
    with lk:
        time.sleep(0.05)
    holds = lw.report()["long_holds"]
    assert [h["site"] for h in holds] == ["fixture:slow_lock"]


@BOTH
def test_rpc_pseudo_sites_close_the_cycle_r19_names(lw):
    lk = lw.wrap(name="fixture:client_lock")
    with lk:
        lw.rpc_client_wait("rpc:PING")     # lock -> wire
    token = lw.rpc_handler_enter("rpc:PING")
    with lk:                               # wire -> lock
        pass
    lw.rpc_handler_exit(token)
    assert [lw.format_cycle(c["kind"], c["sites"]) for c in lw.cycles()] \
        == ["CYCLE (site-order): fixture:client_lock -> rpc:PING"]


@BOTH
def test_guard_fires_on_unlocked_access_and_not_in_init(lw):
    class LeakyDemo:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []  # raylint: guarded-by(self._lock)
            self._items.append(0)      # construction write: unarmed

        def unlocked_peek(self):
            return len(self._items)

        def locked_peek(self):
            with self._lock:
                return len(self._items)

    assert lw.guard_class(LeakyDemo) is LeakyDemo
    box = LeakyDemo()
    assert box.locked_peek() == 1
    assert lw.guard_violations() == []
    box.unlocked_peek()
    (v,) = lw.guard_violations()
    assert (v["field"], v["lock"]) == ("LeakyDemo._items", "LeakyDemo._lock")
    assert lw.format_guard(v["field"], v["lock"]) == (
        "guarded-by(LeakyDemo._lock) violated: LeakyDemo._items accessed "
        "without LeakyDemo._lock held")


def _run(code, **env):
    """``python -c code`` from the repo root with ``env`` added; stdout
    and stderr."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("RAY_TPU_LOCKWATCH")}
    full.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
                PYTHONPATH=REPO, **env)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout, out.stderr


_HOOKS = """
import json, threading
import ray_tpu_torch
from ray_tpu_torch.devtools import lockwatch
from ray_tpu_torch._private import rpc
from ray_tpu_torch.protocol import pb

assert lockwatch.installed()
assert threading.Lock is lockwatch.Lock and threading.RLock is lockwatch.RLock
assert rpc._lockwatch is lockwatch
client_lock = lockwatch.wrap(name="fixture:client_lock")
handler_lock = lockwatch.wrap(name="fixture:client_lock")  # the same site


def handler(ctx):
    with handler_lock:                  # rpc:PING -> fixture:client_lock
        ctx.reply(b"pong")


server = rpc.RpcServer(handler)
client = rpc.RpcClient(f"127.0.0.1:{server.port}")
with client_lock:                       # fixture:client_lock -> rpc:PING
    assert client.call(pb.PING, b"ping", timeout=10).body == b"pong"
client.close()
server.close()
rep = lockwatch.report()
print("HOOKS " + json.dumps({
    "edges": sorted((e["from"], e["to"]) for e in rep["edges"]
                    if "rpc:" in e["from"] + e["to"]),
    "cycles": [lockwatch.format_cycle(c["kind"], c["sites"])
               for c in rep["cycles"]],
    "wrapped": rep["wrapped_locks"]}))
"""


def test_lockwatch_hooks_wrap_package_locks_and_rpc_sites(tmp_path):
    """``RAY_TPU_LOCKWATCH=1`` installs the watchdog at ``import
    ray_tpu_torch``; an RPC pair (no cluster) records the client's wait
    and the handler's run as ``rpc:PING`` pseudo-sites, so a lock held
    across the call that the handler's site takes again closes the
    cycle R19 reports statically. The JSON report lands at
    ``RAY_TPU_LOCKWATCH_OUT``, the summary on stderr."""
    report = tmp_path / "lw.json"
    out, err = _run(_HOOKS, RAY_TPU_LOCKWATCH="1",
                    RAY_TPU_LOCKWATCH_OUT=str(report))
    line = [ln for ln in out.splitlines() if ln.startswith("HOOKS ")][0]
    got = json.loads(line[len("HOOKS "):])
    edges = {tuple(e) for e in got["edges"]}
    assert {("fixture:client_lock", "rpc:PING"),
            ("rpc:PING", "fixture:client_lock")} <= edges, edges
    # the handler's reply takes the connection's own (wrapped) write lock
    assert any(a == "rpc:PING" and b.startswith("_private/rpc.py:")
               for a, b in edges), edges
    assert got["cycles"] == [
        "CYCLE (site-order): fixture:client_lock -> rpc:PING"]
    assert got["wrapped"] > 3      # the package's own module-level locks
    rep = json.loads(report.read_text())
    assert rep["cycles"] == [{"kind": "site-order",
                              "sites": ["fixture:client_lock", "rpc:PING"]}]
    assert "LOCKWATCH[ray_tpu_torch]: " in err
    assert "LOCKWATCH[ray_tpu_torch] CYCLE (site-order): " \
        "fixture:client_lock -> rpc:PING" in err


def test_without_the_variable_nothing_is_installed():
    out, _ = _run("import threading, ray_tpu_torch\n"
                  "from ray_tpu_torch._private import rpc\n"
                  "from ray_tpu_torch.devtools import lockwatch\n"
                  "print(lockwatch.installed(), rpc._lockwatch,\n"
                  "      threading.Lock.__module__)")
    assert out.split() == ["False", "None", "_thread"]


_BOTH_PACKAGES = """
import sys
if sys.argv[1] == "jax-first":
    import ray_tpu, ray_tpu_torch
else:
    import ray_tpu_torch, ray_tpu
from ray_tpu.devtools import lockwatch as ref_lw
from ray_tpu_torch.devtools import lockwatch as port_lw
import ray_tpu_torch as rt


@rt.remote
def inc(x):
    return x + 1


rt.init(num_cpus=2)
assert rt.get([inc.remote(i) for i in range(8)], timeout=60) == list(
    range(1, 9))
rt.shutdown()
print("SITES", sorted({e["from"].split(":")[0] for e in
                       port_lw.report()["edges"]}))
"""


@pytest.mark.parametrize("order", ["jax-first", "torch-first"])
def test_both_watchdogs_in_one_process(order):
    """The port's tests import both packages, and ``RAY_TPU_LOCKWATCH``
    installs both watchdogs, in either order. The port's still wraps
    its own locks from the raw primitives (never through the other's
    factory) and names its summary line."""
    out, err = _run(_BOTH_PACKAGES.replace("sys.argv[1]", repr(order)),
                    RAY_TPU_LOCKWATCH="1")
    summary = [ln for ln in err.splitlines()
               if ln.startswith("LOCKWATCH[ray_tpu_torch]: ")]
    assert len(summary) == 1, err[-2000:]
    assert ", 0 cycles," in summary[0], summary
    wrapped = int(summary[0].split(": ")[1].split()[0])
    assert wrapped > 10, summary
    # every order edge of the port's graph is between its own sites
    line = [ln for ln in out.splitlines() if ln.startswith("SITES ")][0]
    assert "devtools/lockwatch.py" not in line, line
    assert any(ln.startswith("LOCKWATCH: ") for ln in err.splitlines())
