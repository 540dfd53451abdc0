"""The multi-process runtime of the port against the JAX package's.

Each scenario runs under both packages, each on its own
``ProcessCluster(num_daemons=2, num_cpus=2)`` (a state-service process and
two host-daemon processes), with ``init(address=cluster.address)``; the
results are compared. Both packages' drivers live in this process at once
(their runtimes are separate), so each scenario runs under the two side by
side. The clusters are started once for the module and the scenarios run
in order: the last ones restart the state service, kill a daemon and
drain one.

Test daemons never see a card: ``CUDA_VISIBLE_DEVICES=""``.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ray_tpu
import ray_tpu.cluster_utils
import ray_tpu_torch
import ray_tpu_torch.cluster_utils

PKGS = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    for pkg in PKGS.values():
        pkg.shutdown()  # an earlier module's runtime must not leak in
    made = {}

    def start(name):
        made[name] = PKGS[name].cluster_utils.ProcessCluster(
            num_daemons=2, num_cpus=2, data_dir=str(root / name),
            heartbeat_timeout_ms=1500, daemon_heartbeat_s=0.25)

    threads = [threading.Thread(target=start, args=(n,)) for n in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert set(made) == set(PKGS), "a cluster failed to start"
        for name, c in made.items():
            PKGS[name].init(address=c.address)
        yield made
    finally:
        for name, c in made.items():
            PKGS[name].shutdown()
            c.shutdown()


def _both(clusters, scenario):
    """Run ``scenario(pkg, cluster)`` under both packages side by side."""
    out, errors = {}, {}

    def run(name):
        try:
            out[name] = scenario(PKGS[name], clusters[name])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[name] = e

    threads = [threading.Thread(target=run, args=(n,)) for n in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for name, e in errors.items():
        raise AssertionError(f"{name}: {type(e).__name__}: {e}") from e
    return out


def _runtime(pkg):
    return pkg._private.worker.global_worker().runtime


def _node_of(pkg, cluster, index):
    addr = cluster.daemons[index]["address"]
    for info in _runtime(pkg).state.list_nodes():
        if info.address == addr and info.alive:
            return info.node_id.hex()
    raise KeyError(addr)


def _pinned(pkg, node_hex, soft=False):
    mod = pkg.util.scheduling_strategies
    return mod.NodeAffinitySchedulingStrategy(node_id=node_hex, soft=soft)


# ------------------------------------------------------------- scenarios

def tasks_spread(pkg, cluster):
    @pkg.remote
    def where(x):
        return os.getpid(), x * 2

    results = pkg.get([where.remote(i) for i in range(24)], timeout=60)
    pids = {pid for pid, _ in results}
    return ([v for _, v in results], len(pids), os.getpid() in pids)


def put_get(pkg, cluster):
    data = np.arange(200000)  # ~1.6 MB: the daemon fetches it
    ref = pkg.put(data)
    small = pkg.put({"a": 1, "b": [2, 3]})

    @pkg.remote
    def total(arr):
        return int(arr.sum())

    @pkg.remote
    def nested(d):
        return int(pkg.get(d["ref"]).sum())

    @pkg.remote
    def produce():
        return np.full((1200, 1200), 3.0)  # ~11 MB: fetched by the driver

    @pkg.remote
    def consume(arr):
        return float(arr.sum())

    return (pkg.get(total.remote(ref), timeout=60),
            pkg.get(nested.remote({"ref": ref}), timeout=60),
            pkg.get(small, timeout=10),
            np.array_equal(pkg.get(ref, timeout=10), data),
            float(pkg.get(produce.remote(), timeout=60).sum()),
            pkg.get(consume.remote(produce.remote()), timeout=60))


def borrowing(pkg, cluster):
    """An object made on daemon 0 (its owner: the process that holds the
    primary copy) and passed, inside a container, to a task on daemon 1:
    the task registers a borrow with daemon 0 while it holds the ref, reads
    the object after the driver dropped its own ref. The borrow is then
    never released: the executing daemon keeps the pushed task's spec, and
    so its arguments, in its lineage table (a reference fault kept for
    parity, ROADMAP Queue 3), so both packages report it still held."""
    n0, n1 = _node_of(pkg, cluster, 0), _node_of(pkg, cluster, 1)

    @pkg.remote
    def produce():
        return os.getpid(), np.full((800, 800), 2.0)  # ~5 MB, not inlined

    @pkg.remote
    def borrowers(oid_bytes):
        """The borrowers this daemon's reference counter records."""
        rc = pkg._private.worker.global_worker().runtime.reference_counter
        return sorted(rc._borrows.get(pkg._private.ids.ObjectID(oid_bytes),
                                      {}))

    def borrowers_at_owner(oid):
        return pkg.get(borrowers.options(
            scheduling_strategy=_pinned(pkg, n0)).remote(oid.binary()),
            timeout=30)

    @pkg.remote
    def read_later(box, oid_bytes):
        """Holds the ref until the owner records the borrow, then reads."""
        deadline = time.monotonic() + 20
        seen = []
        at_owner = pkg.util.scheduling_strategies.\
            NodeAffinitySchedulingStrategy(node_id=n0, soft=False)
        while time.monotonic() < deadline and not seen:
            seen = pkg.get(borrowers.options(scheduling_strategy=at_owner
                                             ).remote(oid_bytes), timeout=30)
        return os.getpid(), seen, float(pkg.get(box["ref"])[1].sum())

    ref = produce.options(scheduling_strategy=_pinned(pkg, n0)).remote()
    pkg.wait([ref], timeout=60)
    oid = ref.id()
    producer_pid = pkg.get(ref, timeout=60)[0]
    reader = read_later.options(scheduling_strategy=_pinned(pkg, n1)
                                ).remote({"ref": ref}, oid.binary())
    del ref
    reader_pid, seen, value = pkg.get(reader, timeout=60)
    deadline = time.monotonic() + 3
    while time.monotonic() < deadline and borrowers_at_owner(oid):
        time.sleep(0.05)
    return (value, reader_pid != producer_pid,
            seen == [cluster.daemons[1]["address"]],
            borrowers_at_owner(oid) == [])


def actors(pkg, cluster):
    @pkg.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def where(self):
            return os.getpid()

    c = Counter.options(name="counter-parity").remote()
    ordered = pkg.get([c.inc.remote() for _ in range(20)], timeout=60)
    again = pkg.get_actor("counter-parity")
    after = pkg.get(again.inc.remote(), timeout=30)
    remote_pid = pkg.get(c.where.remote(), timeout=30) != os.getpid()
    pkg.kill(c)
    return ordered, after, remote_pid


def _as_numpy(x):
    """Values through numpy; bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bf16", x.view(torch.int16).numpy().view(np.uint16)
        return str(x.dtype).removeprefix("torch."), x.numpy()
    arr = np.asarray(x)
    if arr.dtype == jnp.bfloat16:
        return "bf16", arr.view(np.uint16)
    return str(arr.dtype), arr


def _on_default_device(x):
    if isinstance(x, torch.Tensor):
        default = (torch.device("cuda", 0) if torch.cuda.is_available()
                   else torch.device("cpu"))
        return x.device == default
    return x.devices() == {jax.devices()[0]}


def tensors(pkg, cluster):
    """Daemon tasks return f32 and bf16 arrays (inline and fetched); a
    driver put goes to a daemon task and comes back."""
    use_torch = pkg is ray_tpu_torch

    def make(shape, seed, bf16):
        # everything it uses is local: daemons cannot import this module
        x = np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32)
        if use_torch:
            t = torch.from_numpy(x)
            return t.to(torch.bfloat16) if bf16 else t
        return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)

    @pkg.remote
    def build(shape, seed, bf16):
        return make(shape, seed, bf16)

    @pkg.remote
    def double(x):
        return x * 2

    specs = [((8, 16), 0, False), ((8, 16), 1, True),
             ((512, 600), 2, False), ((700, 512), 3, True)]
    got = pkg.get([build.remote(*s) for s in specs], timeout=60)
    sent = pkg.put(make((300, 400), 4, True))
    back = pkg.get(double.remote(sent), timeout=60)
    values = [_as_numpy(x) for x in got + [back]]
    return ([(k, a.shape, a.tobytes()) for k, a in values],
            all(_on_default_device(x) for x in got + [back]))


def restart_state_service(pkg, cluster):
    @pkg.remote
    class Keeper:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    k = Keeper.remote()
    first = pkg.get(k.bump.remote(), timeout=60)
    cluster.restart_state_service()

    @pkg.remote
    def f(x):
        return x + 1

    deadline = time.monotonic() + 60
    out = None
    while time.monotonic() < deadline and out is None:
        try:
            out = pkg.get([f.remote(i) for i in range(4)], timeout=20)
        except Exception:  # noqa: BLE001 — the reconnection window
            time.sleep(0.5)
    second = pkg.get(k.bump.remote(), timeout=60)
    pkg.kill(k)
    return first, out, second


def kill_daemon(pkg, cluster):
    """SIGKILL daemon 0 under running tasks and a restartable actor on it:
    the tasks retry and the actor restarts on the survivor."""
    n0 = _node_of(pkg, cluster, 0)

    @pkg.remote(max_restarts=2)
    class Stateful:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return os.getpid(), self.n

    @pkg.remote(max_retries=3)
    def slow(i):
        time.sleep(1.0)
        return os.getpid(), i

    s = Stateful.options(scheduling_strategy=_pinned(pkg, n0, soft=True)
                         ).remote()
    pid1, _ = pkg.get(s.bump.remote(), timeout=60)
    refs = [slow.remote(i) for i in range(6)]
    time.sleep(0.5)  # pushes land on both daemons
    cluster.kill_daemon(0)
    results = pkg.get(refs, timeout=120)
    survivor = cluster.daemons[1]["proc"].pid
    deadline = time.monotonic() + 90
    bumped = None
    while time.monotonic() < deadline and bumped is None:
        try:
            bumped = pkg.get(s.bump.remote(), timeout=10)
        except pkg.exceptions.RayTpuError:
            time.sleep(0.5)
    pkg.kill(s)
    cluster.add_daemon()  # two live daemons again, for the drain
    return (sorted(i for _, i in results),
            all(pid == survivor for pid, _ in results),
            pid1 == cluster.daemons[0]["proc"].pid,
            bumped is not None and bumped[0] == survivor, bumped[1])


def drain_node(pkg, cluster):
    victim = _node_of(pkg, cluster, len(cluster.daemons) - 1)
    pkg.drain_node(victim, reason="parity drain", deadline_s=10.0)
    rt = _runtime(pkg)
    deadline = time.monotonic() + 60
    info = None
    while time.monotonic() < deadline:
        info = {n.node_id.hex(): n for n in rt.state.list_nodes()}[victim]
        if not info.alive:
            break
        time.sleep(0.2)

    @pkg.remote
    def where(x):
        return os.getpid(), x

    results = pkg.get([where.remote(i) for i in range(8)], timeout=60)
    survivor = cluster.daemons[1]["proc"].pid
    return (info.state, info.alive, [x for _, x in results],
            {pid for pid, _ in results} == {survivor})


SCENARIOS = [tasks_spread, put_get, borrowing, actors, tensors,
             restart_state_service, kill_daemon, drain_node]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(clusters, scenario):
    out = _both(clusters, scenario)
    assert out["torch"] == out["jax"]
    if scenario is tasks_spread:
        assert out["torch"][1:] == (2, False)
    elif scenario is borrowing:
        # released: False under both (the kept reference fault)
        assert out["torch"] == (800 * 800 * 2.0, True, True, False)
    elif scenario is tensors:
        assert out["torch"][1]
    elif scenario is kill_daemon:
        assert out["torch"] == (list(range(6)), True, True, True, 1)
    elif scenario is drain_node:
        assert out["torch"][:2] == ("DRAINED", False)


def test_daemons_see_no_card(clusters):
    pkg = ray_tpu_torch

    @pkg.remote
    def env():
        import torch as t
        return os.environ.get("CUDA_VISIBLE_DEVICES"), t.cuda.device_count()

    assert pkg.get([env.remote() for _ in range(4)], timeout=60) == [("", 0)] * 4
    assert "GPU" not in pkg.cluster_resources()


def test_tensor_written_after_put_is_refused_across_processes(clusters):
    pkg = ray_tpu_torch
    x = torch.arange(1000, dtype=torch.float32)
    ref = pkg.put(x)
    x.add_(1)

    @pkg.remote
    def total(t):
        return float(t.sum())

    with pytest.raises(pkg.RayTpuError, match="modified in place"):
        pkg.get(total.remote(ref), timeout=60)
    with pytest.raises(pkg.RayTpuError, match="modified in place"):
        pkg.get(ref, timeout=10)


def test_gpu_daemon_without_a_card_fails_at_start(clusters):
    from ray_tpu_torch._private.node import spawn_daemon
    with pytest.raises(RuntimeError, match="during startup"):
        spawn_daemon(clusters["torch"].address, num_cpus=1, num_gpus=1,
                     cards=[])
    with pytest.raises(ValueError, match="free card"):
        clusters["torch"].add_daemon(num_gpus=1)


def test_a_served_arena_is_dropped_promptly(tmp_path):
    """A daemon that loses the host-arena claim drops the arena it served;
    the teardown must not wait on ``accept()`` (ROADMAP Queue 3, fixed 6)."""
    from ray_tpu_torch._native import NativeObjectStore, NativeStoreClient
    if not NativeObjectStore.available():
        pytest.skip("no g++: the native arena is not built")
    store = NativeObjectStore(1 << 20)
    path = str(tmp_path / "arena.sock")
    assert store.serve(path)
    client = NativeStoreClient(path)
    assert client.capacity == 1 << 20
    client.close()
    done = threading.Event()

    def drop():
        store._lib.nps_destroy(store._handle)
        done.set()

    threading.Thread(target=drop, daemon=True).start()
    assert done.wait(5), "the served arena's teardown hung"
    store._handle = None


def test_an_actor_that_cannot_be_shipped_dies_with_the_cause(clusters):
    """An actor argument that cannot be pickled fails the actor's creation
    with the cause; the JAX package leaves it pending (ROADMAP Queue 3,
    fixed 7), so this case runs under the port only."""
    pkg = ray_tpu_torch

    @pkg.remote
    class Holder:
        def __init__(self, lock):
            self.lock = lock

        def ping(self):
            return True

    h = Holder.remote(threading.Lock())
    with pytest.raises(pkg.ActorDiedError, match="could not be created"):
        pkg.get(h.ping.remote(), timeout=60)


def test_tensor_plane_cluster_raises_until_ported():
    with pytest.raises(NotImplementedError, match="tensor plane"):
        ray_tpu_torch.cluster_utils.ProcessCluster(num_daemons=1,
                                                   tp_cpu_devices=2)
