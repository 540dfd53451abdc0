"""The port's in-process runtime (``ray_tpu_torch``) against ``ray_tpu``'s.

Each parity scenario is one function ``scenario(rt)``, run once with
``rt = ray_tpu`` and once with ``rt = ray_tpu_torch``, in turns (init →
scenario → shutdown; never both runtimes live at once). Their returned
values, and the class names of what they raise, must be equal. The
scenarios mirror ``tests/test_core.py``, ``test_actors.py``,
``test_scheduling.py``, ``test_reference_counting.py`` and
``test_util.py``. Then the device-object seam (a tensor against a
``jax.Array``) and the cases only the port has: the ``_version`` check,
GPU detection, the device grant, ``torch.profiler`` traces and the paths
that are not ported yet. Checks that need a card are in ``chip_smoke.py``'s
phase 15.
"""

import asyncio
import gc
import importlib
import os
import subprocess
import sys
import tempfile
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

RUNTIMES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


def sub(rt, name):
    """``rt``'s module ``name`` (``util.queue`` → ``ray_tpu.util.queue``)."""
    return importlib.import_module(f"{rt.__name__}.{name}")


@pytest.fixture(scope="module", autouse=True)
def runtime_dirs(tmp_path_factory):
    """Every runtime this module starts, ``Cluster``s included, keeps its
    files (flight recordings, spills, logs) under pytest's temporary
    directory, one root per package; the flags are restored afterwards."""
    saved, roots = [], {}
    for rt in RUNTIMES:
        config = sub(rt, "_private.config")._config
        saved.append((config, dict(config._values)))
        roots[rt.__name__] = tmp_path_factory.mktemp(rt.__name__)
        for flag in DIR_FLAGS:
            config.set(flag, str(roots[rt.__name__] / flag))
    yield roots
    for config, values in saved:
        config._values = values


def scenario(init=dict(num_cpus=4)):
    """Register a parity scenario; ``init=None`` means it builds its own
    ``Cluster``."""
    def register(fn):
        SCENARIOS[fn.__name__] = (fn, init)
        return fn
    return register


def raised(fn, *args, **kwargs):
    """The class name of what ``fn`` raises (``None`` if it returns)."""
    try:
        fn(*args, **kwargs)
    except Exception as e:
        return type(e).__name__
    return None


def run(rt, fn, init):
    rt.shutdown()
    if init is not None:
        rt.init(**init)
    try:
        return fn(rt)
    except Exception as e:
        return ("raised", type(e).__name__, str(e)[:200])
    finally:
        rt.shutdown()


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -- tasks and objects (tests/test_core.py) ---------------------------------

@scenario()
def put_get_and_numpy_zero_copy(rt):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = rt.get(rt.put(arr))
    values = [rt.get(rt.put(v)) for v in (1, "s", {"a": [1, 2]}, None)]
    return (values, got.tolist(), bool(np.shares_memory(got, arr)),
            got.flags.writeable, raised(rt.put, rt.put(1)))


@scenario()
def tasks_with_ref_args_and_num_returns(rt):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    r1 = add.remote(rt.put(10), 5)
    r2 = add.remote(r1, add.remote(1, 1))
    a, b, c = three.remote()
    kw = add.options(name="kw").remote(a=1, b=2)
    return rt.get(r2), rt.get([a, b, c]), rt.get(kw)


@scenario()
def errors_propagate_through_dependencies(rt):
    @rt.remote
    def boom():
        raise ValueError("root cause")

    @rt.remote
    def consume(x):
        return x

    out = []
    for ref in (boom.remote(), consume.remote(boom.remote())):
        try:
            rt.get(ref)
        except Exception as e:
            out.append((type(e).__name__, "root cause" in str(e)))
    return out


@scenario()
def retries_on_exception_only_when_asked(rt):
    counts = {"flaky": 0, "app": 0}
    lock = threading.Lock()

    @rt.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        with lock:
            counts["flaky"] += 1
            n = counts["flaky"]
        if n < 3:
            raise RuntimeError("transient")
        return "ok"

    @rt.remote
    def app_error():
        counts["app"] += 1
        raise RuntimeError("app error")

    return (rt.get(flaky.remote()), raised(rt.get, app_error.remote()),
            counts)


@scenario()
def wait_and_get_timeouts(rt):
    gate = threading.Event()

    @rt.remote
    def slow():
        gate.wait(30)
        return "slow"

    @rt.remote
    def fast():
        return "fast"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=5)
    out = [ready == [f], not_ready == [s]]
    ready, not_ready = rt.wait([s], num_returns=1, timeout=0.1)
    out.append((len(ready), len(not_ready)))
    out.append(raised(rt.get, s, timeout=0.1))
    out.append(raised(rt.wait, [s, s]))
    gate.set()
    out.append(rt.get([f, s], timeout=10))
    return out


@scenario()
def cancel_pending_task(rt):
    gate = threading.Event()

    @rt.remote(num_cpus=4)
    def hog():
        gate.wait(30)
        return "hog"

    @rt.remote(num_cpus=4)
    def queued():
        return 1

    h = hog.remote()
    q = queued.remote()  # cannot start: the CPUs are taken
    time.sleep(0.1)
    rt.cancel(q)
    err = raised(rt.get, q, timeout=5)
    gate.set()
    return err, rt.get(h, timeout=10)


@scenario()
def nested_tasks_and_refs_inside_containers(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    @rt.remote
    def unwrap(refs):
        # refs nested in a container are passed through, not resolved
        return [type(r).__name__ for r in refs], rt.get(refs)

    return rt.get(outer.remote(10)), rt.get(unwrap.remote([rt.put(3)]))


@scenario(init=dict(num_cpus=4, resources={"special": 2}))
def fractional_and_custom_resources(rt):
    @rt.remote(num_cpus=0.5)
    def half():
        return 0.5

    @rt.remote(resources={"special": 1})
    def special():
        return "special"

    out = (rt.get([half.remote() for _ in range(8)]),
           rt.get(special.remote()), rt.cluster_resources())
    total = rt.cluster_resources()
    settled = wait_until(lambda: rt.available_resources() == total)
    return out, settled


@scenario(init=dict(num_cpus=1))
def infeasible_request_errors(rt):
    @rt.remote(num_cpus=64)
    def impossible():
        return 1

    try:
        rt.get(impossible.remote(), timeout=10)
    except Exception as e:
        return type(e).__name__, "cannot be satisfied" in str(e)
    return None


@scenario()
def reference_counting_frees_dropped_objects(rt):
    runtime = sub(rt, "_private.worker").global_worker().runtime
    store = runtime.head_node.store
    ref = rt.put(np.zeros(1000))
    oid = ref.id()
    held = store.contains(oid)
    del ref
    gc.collect()
    freed = wait_until(lambda: not store.contains(oid))

    gate = threading.Event()

    @rt.remote
    def size_later(x):
        gate.wait(10)
        return x.size

    # the task's argument keeps the object alive after the driver drops it
    ref = rt.put(np.zeros(10))
    pending = size_later.remote(ref)
    del ref
    gc.collect()
    gate.set()
    return held, freed, rt.get(pending, timeout=10)


# -- actors (tests/test_actors.py) ------------------------------------------

@scenario()
def actor_state_and_errors(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self):
            self.n += 1
            return self.n

        def fail(self):
            raise ValueError("bad method")

    @rt.remote
    class BadInit:
        def __init__(self):
            raise ValueError("bad init")

        def ping(self):
            return 1

    c = Counter.remote(10)
    counts = rt.get([c.incr.remote() for _ in range(5)])
    err = raised(rt.get, c.fail.remote())
    after = rt.get(c.incr.remote())
    bad = BadInit.remote()
    return counts, err, after, raised(rt.get, bad.ping.remote(), timeout=10)


@scenario()
def actor_restart_and_kill(rt):
    @rt.remote(max_restarts=2)
    class Phoenix:
        def __init__(self):
            self.state = "fresh"

        def mark(self):
            self.state = "dirty"
            return self.state

        def get_state(self):
            return self.state

    p = Phoenix.remote()
    marked = rt.get(p.mark.remote())
    rt.kill(p, no_restart=False)
    time.sleep(0.3)
    restarted = rt.get(p.get_state.remote(), timeout=10)
    rt.kill(p)
    time.sleep(0.1)
    return marked, restarted, raised(rt.get, p.get_state.remote(), timeout=10)


@scenario()
def actor_max_concurrency_and_async(rt):
    @rt.remote(max_concurrency=2)
    class Rendezvous:
        def __init__(self):
            self.barrier = threading.Barrier(2, timeout=10)

        def meet(self, i):
            self.barrier.wait()  # deadlocks unless two calls run at once
            return i

    @rt.remote
    class AsyncWorker:
        async def work(self, i):
            await asyncio.sleep(0.05)
            return i

    r = Rendezvous.remote()
    met = rt.get([r.meet.remote(i) for i in range(2)], timeout=20)
    a = AsyncWorker.remote()
    return met, sorted(rt.get([a.work.remote(i) for i in range(4)]))


@scenario()
def named_actors(rt):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.options(name="counter").remote()
    rt.get(c.incr.remote())
    same = Counter.options(name="counter", get_if_exists=True).remote()
    by_name = rt.get_actor("counter")
    return (rt.get(same.incr.remote()), rt.get(by_name.incr.remote()),
            rt.get(c.ready(), timeout=10), raised(rt.get_actor, "missing"))


# -- scheduling and placement groups (tests/test_scheduling.py) -------------

def where(rt):
    @rt.remote(num_cpus=1)
    def node():
        return rt.get_runtime_context().node_id.hex()
    return node


@scenario(init=None)
def placement_groups(rt):
    cluster = sub(rt, "cluster_utils").Cluster(initialize_head=False)
    for _ in range(2):
        cluster.add_node(num_cpus=2)
    pgs = sub(rt, "util.placement_group")
    strategies = sub(rt, "util.scheduling_strategies")
    pg = pgs.placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_SPREAD")
    ok = pg.wait(10)
    table = pgs.placement_group_table()[pg.id.hex()]
    ran_on = [rt.get(where(rt).options(
        scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote())
        for i in range(2)]
    packed = pgs.placement_group([{"CPU": 1}], strategy="PACK")
    packed.wait(10)
    cpus_held = rt.available_resources().get("CPU", 0)
    pgs.remove_placement_group(packed)
    released = wait_until(
        lambda: rt.available_resources().get("CPU", 0) == cpus_held + 1)
    return (ok, table["state"], len(set(table["bundle_nodes"])),
            ran_on == table["bundle_nodes"], cpus_held, released)


@scenario(init=None)
def scheduling_strategies(rt):
    cluster = sub(rt, "cluster_utils").Cluster(initialize_head=False)
    nodes = [cluster.add_node(num_cpus=2) for _ in range(3)]
    cluster.add_node(num_cpus=2, resources={"special": 2})
    strategies = sub(rt, "util.scheduling_strategies")
    node = where(rt)
    spread = set(rt.get([node.options(scheduling_strategy="SPREAD").remote()
                         for _ in range(16)]))
    target = nodes[1].node_id.hex()
    pinned = rt.get([node.options(
        scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
            node_id=target, soft=False)).remote() for _ in range(5)])
    special = rt.get(node.options(resources={"special": 1}).remote())
    return (len(spread) >= 3, all(p == target for p in pinned),
            special == cluster._nodes[3].node_id.hex())


@scenario(init=None)
def cluster_with_two_nodes(rt):
    cluster = sub(rt, "cluster_utils").Cluster(initialize_head=False)
    cluster.add_node(num_cpus=2)
    second = cluster.add_node(num_cpus=3, resources={"side": 1})
    before = (len(rt.nodes()), rt.cluster_resources())
    cluster.remove_node(second)
    alive = [n["Alive"] for n in rt.nodes()]
    return before, alive, rt.cluster_resources()


# -- util/ and dag (tests/test_util.py) -------------------------------------

@scenario()
def actor_pool(rt):
    @rt.remote(num_cpus=0)
    class Doubler:
        def double(self, x):
            return 2 * x

    ActorPool = sub(rt, "util").ActorPool

    def pool():
        return ActorPool([Doubler.remote() for _ in range(2)])

    def double(a, v):
        return a.double.remote(v)

    ordered = list(pool().map(double, range(6)))
    unordered = sorted(pool().map_unordered(double, range(6)))
    p = pool()
    p.submit(double, 21)
    first = p.get_next(timeout=10), p.has_next()
    # A reference fault kept for parity (ROADMAP Queue 3): get_next after
    # map_unordered on the same pool looks for a result index that
    # get_next_unordered never advanced past.
    mixed = pool()
    list(mixed.map_unordered(double, range(2)))
    mixed.submit(double, 1)
    return ordered, unordered, first, raised(mixed.get_next, timeout=10)


@scenario()
def queue(rt):
    qmod = sub(rt, "util.queue")
    q = qmod.Queue(maxsize=2)
    q.put_nowait(1)
    q.put_nowait(2)
    full = (q.full(), raised(q.put_nowait, 3), raised(q.put, 3, timeout=0.05))
    first = q.get_nowait()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i, timeout=5)
        return n

    q2 = qmod.Queue()
    produced = rt.get(producer.remote(q2, 5))
    return (full, first, q.get_nowait(), raised(q.get, timeout=0.05),
            produced, [q2.get(timeout=5) for _ in range(5)])


@scenario()
def dag_bind_and_execute(rt):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def mul(a, b):
        return a * b

    dag = add.bind(mul.bind(2, 3), mul.bind(4, 5))
    out = dag.execute()
    return type(out).__name__, rt.get(out)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runtime_matches_ray_tpu(name):
    fn, init = SCENARIOS[name]
    want, got = (run(rt, fn, init) for rt in RUNTIMES)
    assert got == want
    assert not (isinstance(want, tuple) and want[:1] == ("raised",)), want


# -- device objects: a tensor where the JAX package has a jax.Array --------

@pytest.mark.parametrize("path", ["driver", "task_arg", "task_return"])
def test_device_object_is_stored_by_reference_like_jax(path):
    x_np = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    results = {}
    for rt, x in ((ray_tpu, jnp.asarray(x_np)),
                  (ray_tpu_torch, torch.from_numpy(x_np.copy()))):
        rt.shutdown()
        rt.init(num_cpus=2)
        try:
            @rt.remote
            def ident(v):
                return v

            ref = rt.put(x)
            if path == "driver":
                got = rt.get(ref)
            elif path == "task_arg":
                got = rt.get(ident.remote(ref))
            else:
                got = rt.get(ident.remote(x))
            stats = (sub(rt, "_private.worker").global_worker().runtime
                     .head_node.store.stats())
            results[rt.__name__] = (got is x, np.asarray(got),
                                    stats["host_bytes"])
        finally:
            rt.shutdown()
    (same_j, val_j, bytes_j), (same_t, val_t, bytes_t) = results.values()
    assert same_j and same_t
    assert bytes_j == bytes_t == 0
    np.testing.assert_array_equal(val_t, val_j)


def test_first_n_device_grant_matches_jax(monkeypatch):
    """A reference fault, kept for parity (ROADMAP Queue 3): every grant of
    n accelerators gets the node's first n devices, so two concurrent
    one-device actors on a two-device node share device 0, and a fractional
    grant gets none."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def grants(rt, accel):
        def granted():
            ctx = rt.get_runtime_context()
            if accel == "num_tpus":
                return [d.id for d in ctx.get_tpu_devices()]
            return [d.index for d in ctx.get_gpu_devices()]

        @rt.remote(**{accel: 1})
        class Holder:
            def devices(self):
                return granted()

        fractional = rt.get(rt.remote(**{accel: 0.5})(granted).remote(),
                            timeout=10)
        a, b = Holder.remote(), Holder.remote()
        return (rt.get([a.devices.remote(), b.devices.remote()], timeout=10),
                fractional)

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=2)
    try:
        want = grants(ray_tpu, "num_tpus")
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    try:
        cards = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(
            lambda: ray_tpu_torch.get_runtime_context().get_gpu_devices()
        ).remote(), timeout=10)
        got = grants(ray_tpu_torch, "num_gpus")
    finally:
        ray_tpu_torch.shutdown()
    assert got == want == ([[0], [0]], [])
    assert cards == [torch.device("cuda", 0)]


def test_accelerator_request_without_one_is_infeasible_like_jax():
    """On a machine without the accelerator: no TPU / GPU key, and a task
    that asks for one fails with the reference's infeasible error."""
    out = []
    for rt, accel in ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")):
        rt.shutdown()
        rt.init(num_cpus=2)
        try:
            f = rt.remote(**{accel: 1})(lambda: 1)
            try:
                rt.get(f.remote(), timeout=10)
                out.append(None)
            except rt.RayTpuError as e:
                out.append((type(e).__name__, rt.cluster_resources(),
                            "cannot be satisfied" in str(e)))
        finally:
            rt.shutdown()
    assert out[0] == out[1] == ("RayTpuError", {"CPU": 2.0}, True)


# -- the port's own seams ---------------------------------------------------

@pytest.fixture
def port():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("writer", ["putter", "getter", "task_arg"])
def test_mutated_device_object_is_refused(port, writer):
    x = torch.arange(6.0)
    ref = port.put(x)

    @port.remote
    def total(v):
        return float(v.sum())

    if writer == "putter":
        x.add_(1)
    elif writer == "getter":
        port.get(ref).mul_(2)
    else:
        assert port.get(total.remote(ref)) == 15.0
        x[0] = 100.0
    with pytest.raises(port.RayTpuError, match="modified in place"):
        port.get(ref)
    if writer == "task_arg":
        with pytest.raises(port.RayTpuError, match="modified in place"):
            port.get(total.remote(ref))
    assert port.get(port.put(x)) is x  # a new put seals the new version


def test_runtime_files_stay_under_their_configured_dirs(tmp_path):
    """The flight recorder lands where the flags say, and the flags'
    defaults lie under the process's temporary directory. The recorder
    records the process, so the first ``init`` of a process installs it
    and later ones keep it: it is checked in a process of its own, whose
    flag is set through the environment (another test module of this
    process may have installed it already, under its own flags)."""
    from ray_tpu_torch._private.config import _config
    want = tmp_path / "flight"
    code = ("import ray_tpu_torch as rt\n"
            "from ray_tpu_torch.observability import recorder\n"
            "rt.init(num_cpus=1)\n"
            "print(recorder.get_recorder().root)\n"
            "rt.shutdown()\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RAY_TPU_FLIGHT_RECORDER_DIR=str(want),
               CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == str(want)
    for flag in DIR_FLAGS:
        assert _config._defs[flag][1].startswith(tempfile.gettempdir())


def test_inference_tensor_is_stored_without_a_version(port):
    with torch.inference_mode():
        x = torch.ones(3)
    assert port.get(port.put(x)) is x


@pytest.mark.parametrize("how", ["plain", "object_ref"])
def test_tensor_argument_reaches_the_callee_without_a_copy(port, how):
    x = torch.arange(8.0)

    @port.remote
    def pointer(v):
        return v.data_ptr(), v is x

    arg = x if how == "plain" else port.put(x)
    assert port.get(pointer.remote(arg)) == (x.data_ptr(), True)


@pytest.mark.parametrize("max_concurrency", [1, 4])
def test_actor_threads_do_not_keep_arguments_or_a_killed_instance(
        port, max_concurrency):
    """Two faults of the JAX package fixed in the port (ROADMAP Queue 3):
    an idle actor thread kept its last call's arguments alive, and a killed
    actor kept its instance and init arguments, with all but one thread of
    its pool waiting forever."""
    import weakref

    @port.remote(max_concurrency=max_concurrency)
    class Holder:
        def __init__(self, w):
            self.w = w

        def total(self, extra):
            return float(self.w.sum() + extra.sum())

    def actor_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("actor-Holder")]

    w, extra = torch.ones(4), torch.ones(2)
    alive = (weakref.ref(w), weakref.ref(extra))
    actor = Holder.remote(w)
    assert port.get(actor.total.remote(extra), timeout=10) == 6.0
    assert wait_until(lambda: len(actor_threads()) == max_concurrency)
    del w, extra
    gc.collect()
    assert alive[1]() is None       # the call's argument, actor still up
    port.kill(actor)

    def released():
        gc.collect()
        return alive[0]() is None and not actor_threads()

    assert wait_until(released)
    with pytest.raises(port.ActorDiedError):
        port.get(actor.total.remote(torch.ones(1)), timeout=10)


@pytest.mark.parametrize("kwargs, want", [
    (dict(num_cpus=2), {"CPU": 2.0}),
    (dict(num_cpus=2, num_gpus=2), {"CPU": 2.0, "GPU": 2.0}),
])
def test_init_detects_gpus(kwargs, want):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(**kwargs)
    try:
        assert ray_tpu_torch.cluster_resources() == want
    finally:
        ray_tpu_torch.shutdown()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from ray_tpu_torch._private import profiling
    profiling.start_device_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        profiling.start_device_trace(str(tmp_path))
    torch.ones(64, 64) @ torch.ones(64, 64)
    assert profiling.stop_device_trace() == str(tmp_path)
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with pytest.raises(RuntimeError):
        profiling.stop_device_trace()


@pytest.mark.parametrize("call", [
    lambda: ray_tpu_torch.init(include_dashboard=True),
], ids=["dashboard"])
def test_paths_not_ported_yet_raise(call, monkeypatch, tmp_path):
    """The paths this test held as refused have since been ported: each
    now runs, and ``shutdown()`` leaves nothing behind (the dashboard: the
    state server's port file is gone)."""
    from ray_tpu_torch._private import state_server
    ray_tpu_torch.shutdown()
    # a session of its own: other test files' drivers share the default
    monkeypatch.setattr(state_server, "SESSION_DIR", str(tmp_path))
    monkeypatch.setattr(state_server, "PORT_FILE", str(tmp_path / "port"))
    w = call()
    try:
        assert w.dashboard_port == state_server.discover_port()
    finally:
        ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()
    assert state_server.discover_port() is None


def test_get_of_an_object_larger_than_the_store_returns_it():
    """A pickled object larger than the store's spill threshold is spilled
    at put; ``get`` restores it. The JAX package's restore spills it again
    at once and ``get`` returns None (ROADMAP Queue 3); the port pins the
    restored entry for its reader."""
    got = {}
    for rt in RUNTIMES:
        config = sub(rt, "_private.config")._config
        saved = dict(config._values)
        rt.shutdown()
        rt.init(num_cpus=2, _system_config={
            "object_store_memory_bytes": 1 << 20,
            "use_native_object_store": False})
        try:
            ref = rt.put({"blob": b"x" * (3 << 20)})
            got[rt.__name__] = rt.get(ref, timeout=30)
        finally:
            rt.shutdown()
            config._values = saved
    assert got["ray_tpu"] is None
    assert got["ray_tpu_torch"] == {"blob": b"x" * (3 << 20)}


def test_a_failed_tasks_locals_are_freed_after_get_raises():
    """``get`` of a failed task raises its error; once the caller drops its
    refs, the task's frames (and what they hold) must be freed. The JAX
    package raises the stored error object itself, so the raising frames
    (which hold the refs) join its traceback and pin it through the store
    (ROADMAP Queue 3); the port raises a copy."""
    import weakref
    alive = {}
    for rt in RUNTIMES:
        held = []

        @rt.remote
        def fails():
            blob = np.ones(1024)
            held.append(weakref.ref(blob))
            raise RuntimeError("boom")

        rt.shutdown()
        rt.init(num_cpus=2)
        try:
            def call():
                refs = [fails.remote()]
                rt.get(refs, timeout=30)

            name = raised(call)
            gc.collect()
            alive[rt.__name__] = (name, held[0]() is not None)
        finally:
            rt.shutdown()
    assert alive == {"ray_tpu": ("TaskError", True),
                     "ray_tpu_torch": ("TaskError", False)}
