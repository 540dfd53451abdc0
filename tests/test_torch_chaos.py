"""The port's fault-injection points, each driven through the code path
that declares it.

``ray_tpu_torch`` declares its chaos points where the JAX package does
(``chaos.inject("<point>", ...)``); the JAX package's chaos, transport,
checkpoint, collective, serve and autopilot suites exercise the
reference's. This file does the same for the port: every point fires
under a schedule, and the path's contract holds (a dropped reply times
out one call and the connection survives, a lost chunk write fails the
save loudly, a faulted quantization reaches every rank, a preemption
notice drains the node, ...). ``raylint``'s R13 holds the port to it:
a declared point no ``tests/test_torch_*.py`` file exercises is a
finding.

An autouse fixture snapshots and restores the process-wide schedule, so
these tests compose with an ambient ``RAY_TPU_CHAOS`` gate.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import chaos
from ray_tpu_torch._private.backoff import BackoffPolicy
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectLostError, ObjectStore
from ray_tpu_torch._private.rpc import (RpcClient, RpcConnectionError,
                                        RpcServer)
from ray_tpu_torch._private.state_client import StateClient
from ray_tpu_torch._private.state_service import StateService
from ray_tpu_torch.chaos.engine import ChaosError
from ray_tpu_torch.protocol import pb


@pytest.fixture(autouse=True)
def _isolate_chaos():
    prev = chaos.schedule()
    chaos.clear()
    yield
    if prev is not None:
        chaos.install(prev)
    else:
        chaos.clear()


# -- the RPC layer --------------------------------------------------------------

@pytest.fixture()
def echo_server():
    srv = RpcServer(lambda ctx: ctx.reply(ctx.body), auth_token=b"")
    yield srv
    srv.close()


def test_rpc_send_reset_fails_the_call_with_the_peer(echo_server):
    chaos.configure(3, "rpc.client.send@2=reset")
    client = RpcClient(echo_server.address, auth_token=b"")
    try:
        assert client.call(pb.PING, b"x", timeout=10).body == b"x"
        with pytest.raises(RpcConnectionError) as ei:
            client.call(pb.PING, b"y", timeout=10)
        assert echo_server.address in str(ei.value)
        assert client.closed
    finally:
        client.close()
    fresh = RpcClient(echo_server.address, auth_token=b"")
    try:
        assert fresh.call(pb.PING, b"z", timeout=10).body == b"z"
    finally:
        fresh.close()
    assert "rpc.client.send" in chaos.trace_text()


def test_rpc_connect_reset_names_the_peer(echo_server):
    chaos.configure(3, "rpc.client.connect@1=reset")
    with pytest.raises(RpcConnectionError) as ei:
        RpcClient(echo_server.address, auth_token=b"")
    assert echo_server.address in str(ei.value)


@pytest.mark.parametrize("spec", ["rpc.server.send@1=drop",
                                  "rpc.client.recv@1=drop",
                                  "rpc.server.recv@1=drop"])
def test_rpc_lost_frame_times_out_one_call(echo_server, spec):
    """A reply lost by the server, a reply lost in the client's reader, a
    request lost in the server's: the one call times out, and the
    connection serves the next."""
    point = spec.split("@")[0]
    chaos.configure(5, spec)
    client = RpcClient(echo_server.address, auth_token=b"")
    try:
        with pytest.raises(TimeoutError):
            client.call(pb.PING, b"x", timeout=0.5)
        assert client.call(pb.PING, b"y", timeout=10).body == b"y"
    finally:
        client.close()
    assert point in chaos.trace_text()


# -- the object store -----------------------------------------------------------

def test_store_get_drop_is_a_local_loss_once():
    store = ObjectStore(capacity_bytes=1 << 20)
    oid = ObjectID.from_random()
    store.put(oid, {"k": 1})
    chaos.configure(5, "object.store.get@1=drop")
    with pytest.raises(ObjectLostError) as ei:
        store.get(oid)
    assert "chaos" in str(ei.value)
    assert store.get(oid) == {"k": 1}
    assert "object.store.get" in chaos.trace_text()


# -- the state service and its client ---------------------------------------

def serving(fn):
    """``fn(service)`` on a thread while the state service's ``serve()``
    loop runs on this one, as on its own process's main thread; the
    service stops when ``fn`` returns. Returns ``fn``'s result."""
    svc = StateService(port=0)
    svc.start()
    out = {}

    def drive():
        try:
            out["value"] = fn(svc)
        except BaseException as e:  # raylint: allow(swallow) raised again below, on the test's thread
            out["error"] = e
        finally:
            svc.stop()

    t = threading.Thread(target=drive)
    t.start()
    svc.serve()
    t.join(timeout=60)
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_state_call_reset_is_retried():
    def drive(svc):
        client = StateClient(f"127.0.0.1:{svc.port}")
        try:
            client.kv_put(b"k", b"v1")
            chaos.configure(3, "state.call@2=reset; state.call@5=reset")
            got = [client.kv_get(b"k")]
            client.kv_put(b"k", b"v2")
            got.append(client.kv_get(b"k"))
            return got, chaos.trace_text()
        finally:
            client.close()

    got, trace = serving(drive)
    assert got == [b"v1", b"v2"]
    assert "state.call" in trace


def test_state_reconnect_point_fires_when_the_service_stays_down():
    srv = RpcServer(lambda ctx: ctx.reply(b""), auth_token=b"")
    client = StateClient(srv.address, auth_token=b"")
    try:
        srv.close()
        client._client.close()
        host, port = srv.address.rsplit(":", 1)
        state = BackoffPolicy(base_s=0.01, max_s=0.1, deadline_s=10.0).start()
        while True:
            try:
                socket.create_connection((host, int(port)),
                                         timeout=1.0).close()
            except OSError:
                break
            if not state.sleep():
                pytest.fail("listener never went down after srv.close()")
        chaos.configure(9, "state.reconnect@1=delay(0.001)")
        with pytest.raises((RpcConnectionError, OSError)):
            client._reconnect()
        assert "state.reconnect" in chaos.trace_text()
    finally:
        client.close()


# -- tasks, checkpoints, collectives, serve, the autopilot drill --------------

def test_task_execute_faults_are_retried():
    rt.shutdown()
    rt.init(num_cpus=2)
    try:
        chaos.configure(17, "task.execute@1=error(injected worker fault); "
                            "task.execute@3=error(injected worker fault)")

        @rt.remote(max_retries=5, retry_exceptions=[ChaosError])
        def f(i):
            return i * 10

        assert rt.get([f.remote(i) for i in range(6)], timeout=60) == [
            i * 10 for i in range(6)]
        assert len([ln for ln in chaos.trace_lines()
                    if "task.execute" in ln]) == 2
    finally:
        chaos.clear()
        rt.shutdown()


def test_checkpoint_faults_are_loud_and_keep_the_restore_point(tmp_path):
    """A lost chunk write fails the save at commit (torn), a fault before
    the manifest leaves no new commit, and a restore fault raises and is
    retryable: the previous checkpoint stays the restore point."""
    from ray_tpu_torch.checkpoint import (CheckpointEngine, CheckpointError,
                                          list_manifest_names, load)
    eng = CheckpointEngine(str(tmp_path))
    eng.save({"w": np.arange(4.0)}, step=1, wait=True)
    chaos.configure(3, "checkpoint.write@1=drop")
    with pytest.raises(CheckpointError, match="torn"):
        eng.save({"w": np.full(4, 7.0)}, step=2).result(timeout=30)
    chaos.configure(4, "checkpoint.commit[stage=manifest]@1=error")
    with pytest.raises(ChaosError, match="checkpoint.commit"):
        eng.save({"w": np.full(4, 8.0)}, step=3).result(timeout=30)
    chaos.clear()
    eng.close()
    assert len(list_manifest_names(str(tmp_path))) == 1
    chaos.configure(9, "checkpoint.restore@1=error")
    with pytest.raises(ChaosError):
        load(str(tmp_path))
    chaos.clear()
    np.testing.assert_array_equal(load(str(tmp_path))["w"], np.arange(4.0))


def _thread_allreduce(xs, gname, config=None):
    from ray_tpu_torch import collective as col
    outs, errs = [None] * len(xs), [None] * len(xs)

    def run(r):
        try:
            col.init_collective_group(len(xs), r, backend="cpu",
                                      group_name=gname, config=config)
            outs[r] = np.asarray(col.allreduce(xs[r].copy(), gname))
        except Exception as e:  # noqa: BLE001 # raylint: allow(swallow) returned to the test, which asserts on it
            errs[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in range(len(xs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return outs, errs


def test_collective_faults_reach_every_rank():
    """A fault on rank 1's quantization surfaces on every rank of the
    group (no rank strands at its timeout), and a delayed rank's op still
    completes with the right sum."""
    from ray_tpu_torch.collective.types import CollectiveConfig
    cfg = CollectiveConfig(compression="q8", quant_block_bytes=256)
    xs = [np.ones(2048, np.float32) * (r + 1) for r in range(2)]
    chaos.configure(7, "collective.quant[rank=1]@1=error")
    _outs, errs = _thread_allreduce(xs, "chaosq", cfg)
    assert all(isinstance(e, ChaosError) for e in errs), errs
    chaos.configure(8, "collective.op[rank=1]@1=delay(0.05)")
    outs, errs = _thread_allreduce(xs, "chaosop")
    assert errs == [None, None]
    np.testing.assert_array_equal(outs[0], np.full(2048, 3.0, np.float32))
    assert "collective.op" in chaos.trace_text()


def test_serve_replica_execute_fault_fails_one_request():
    from ray_tpu_torch import serve
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        serve.start()

        @serve.deployment(name="chaos_echo")
        def echo(x):
            return x * 2

        h = serve.run(echo.bind(), route_prefix=None)
        assert h.remote(1).result(timeout=60) == 2
        chaos.configure(21, "serve.replica.execute[deployment=chaos_echo]"
                            "@1=error(replica fault)")
        with pytest.raises(Exception, match="replica fault"):
            h.remote(2).result(timeout=60)
        assert h.remote(3).result(timeout=60) == 6
        assert "serve.replica.execute" in chaos.trace_text()
    finally:
        chaos.clear()
        serve.shutdown()
        rt.shutdown()


def test_drill_points_cost_what_the_drill_says():
    """The A/B drill's schedule is golden, and each of its two points
    adds its stall to the virtual step: the starved reader's data wait
    and the slow rank's collective skew."""
    from ray_tpu_torch.autopilot import drill
    assert drill.DRILL_SEED == 1303
    assert drill.DRILL_CHAOS_SPEC == \
        "drill.reader@1+=drop;drill.collective[rank=1]@1+=drop"
    store = dict(drill.DRILL_KNOBS)
    calm = drill._step_costs(store)
    chaos.configure(drill.DRILL_SEED,
                    "drill.reader@1+=drop;drill.collective[rank=1]@1+=drop")
    faulted = drill._step_costs(store)
    assert faulted["data_wait"] > calm["data_wait"]
    assert faulted["collective_wait"] > calm["collective_wait"]
    assert faulted["compute"] == calm["compute"]


# -- a multi-process cluster -----------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    """One ``ProcessCluster`` (a daemon of 2 CPUs) with the driver
    connected; the TCP object plane (no shared arena) in small chunks, so
    a fetch stripes over several streams. Heartbeats every 0.25 s, so the
    heartbeat exit comes ~2 s into a daemon's life; a node is dead after 5
    s without one (a loaded machine can stall a starting daemon for 2)."""
    from ray_tpu_torch.cluster_utils import ProcessCluster
    keys = ("arena_enabled", "fetch_chunk_bytes", "data_streams_per_peer")
    saved = {k: _config.get(k) for k in keys}
    _config.set("arena_enabled", False)
    _config.set("fetch_chunk_bytes", 64 * 1024)
    _config.set("data_streams_per_peer", 4)
    rt.shutdown()
    c = ProcessCluster(num_daemons=1, num_cpus=2, heartbeat_timeout_ms=5000,
                       daemon_heartbeat_s=0.25,
                       daemon_env={"RAY_TPU_ARENA_ENABLED": "0"})
    rt.init(address=c.address)
    c.state = StateClient(c.address)
    try:
        yield c
    finally:
        chaos.clear()
        c.state.close()
        rt.shutdown()
        c.shutdown()
        for k, v in saved.items():
            _config.set(k, v)


def test_object_fetch_drop_and_stream_resets_are_survived(cluster):
    """A result above the inline cutoff stays on the daemon; the driver's
    pull survives a dropped first fetch ("source didn't have it") and
    resets of striped chunk streams, and the bytes arrive intact."""
    @rt.remote
    def big():
        import numpy
        return numpy.random.RandomState(3).randint(
            0, 256, size=1 << 20, dtype=numpy.uint8)

    ref = big.remote()
    rt.wait([ref], timeout=120)
    chaos.configure(13, "object.fetch@1=drop; transport.stream@2%4=reset")
    data = rt.get(ref, timeout=120)
    trace = chaos.trace_text()
    chaos.clear()
    want = np.random.RandomState(3).randint(0, 256, size=1 << 20,
                                            dtype=np.uint8)
    np.testing.assert_array_equal(data, want)
    assert "object.fetch" in trace and "transport.stream" in trace


def test_object_push_drop_falls_back_to_pull(cluster):
    payload = rt.put(os.urandom(512 * 1024))   # above the push threshold
    chaos.configure(13, "object.push@1=drop")

    @rt.remote
    def size(b):
        return len(b)

    assert rt.get(size.remote(payload), timeout=120) == 512 * 1024
    assert "object.push" in chaos.trace_text()


def test_heartbeat_exit_kills_the_node(cluster):
    """A daemon whose schedule exits at its 8th heartbeat (the process
    death of a lost host) dies with the chaos exit code, and the state
    service marks it dead."""
    before = {n.node_id for n in cluster.state.list_nodes()}
    cluster.add_daemon(env={"RAY_TPU_CHAOS": "3:state.heartbeat@8=exit(41)"})
    doomed = cluster.daemons[-1]["proc"]
    assert doomed.wait(timeout=60) == 41
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        dead = [n for n in cluster.state.list_nodes()
                if n.node_id not in before and not n.alive]
        if dead:
            break
        time.sleep(0.2)  # raylint: allow(bare-retry) deadline-bounded state poll, not a failure retry
    assert dead, "the state service never marked the node dead"


def test_preemption_notice_drains_the_node(cluster):
    """A daemon whose preemption watcher gets a chaos notice on its first
    poll flips to DRAINING at the state service (a node with nothing to
    migrate may be DRAINED by the next poll; its drain reason stays)."""
    before = {n.node_id for n in cluster.state.list_nodes()}
    cluster.add_daemon(env={"RAY_TPU_CHAOS": "5:node.preempt@1%1000000=drop",
                            "RAY_TPU_PREEMPT_POLL_MS": "200",
                            "RAY_TPU_PREEMPT_LEAD_S": "30"})
    deadline = time.monotonic() + 60
    draining = []
    while time.monotonic() < deadline and not draining:
        draining = [n for n in cluster.state.list_nodes()
                    if n.node_id not in before and (
                        n.state in ("DRAINING", "DRAINED") or n.drain_reason)]
        time.sleep(0.1)  # raylint: allow(bare-retry) deadline-bounded state poll, not a failure retry
    assert draining, "the preemption notice never drained the node"


