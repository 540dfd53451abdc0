"""The port's Python state service against the JAX package's C++ one.

One scripted sequence of requests, covering every method of the C++
dispatch (``ray_tpu/_native/state_service.cc:415-470``), runs against both
services; their replies and the events they push must be equal field by
field once timestamps are masked. Then each service's heartbeat sweep
must publish the same ``NODE_DEAD``, the AUTH rule must treat the same
probes alike, and each service must recover the other's ``--data-dir``
to equal tables with the bumped epoch.

Both services are started once for the module, with the same flags, side
by side (the Python one imports torch at start-up, ~3 s).
"""

import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from ray_tpu._native.build import build_state_service
from ray_tpu_torch._private.rpc import (RpcClient, RpcRemoteError,
                                        frame_bytes)
from ray_tpu_torch.protocol import pb

TOKEN = b"state-service-parity-token"
HB_TIMEOUT_MS = 1500
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cmd(kind):
    if kind == "cpp":
        return [build_state_service()]
    return [sys.executable, "-m", "ray_tpu_torch._private.state_service"]


def _start(kind, data_dir, token_file):
    port_file = tempfile.mktemp(prefix="state_port_", dir=data_dir + "_x")
    cmd = _cmd(kind) + [
        "--port", "0", "--host", "127.0.0.1", "--port-file", port_file,
        "--heartbeat-timeout-ms", str(HB_TIMEOUT_MS),
        "--snapshot-interval-s", "300", "--data-dir", data_dir,
        "--token-file", token_file]
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RAY_TPU_AUTH_TOKEN", None)
    proc = subprocess.Popen(cmd, env=env, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                text = f.read().strip()
            if text:
                return proc, f"127.0.0.1:{text}"
        assert proc.poll() is None, f"{kind} service exited {proc.returncode}"
        time.sleep(0.02)
    proc.kill()
    raise TimeoutError(f"{kind} service did not start")


def _node(nid, addr, cpus, **labels):
    info = pb.NodeInfo(node_id=nid, address=addr)
    info.total.amounts["CPU"] = cpus
    info.available.amounts["CPU"] = cpus
    for k, v in labels.items():
        info.labels[k] = v
    return info


def _avail(**amounts):
    r = pb.Resources()
    for k, v in amounts.items():
        r.amounts[k] = v
    return r


def _actor(aid, name, state):
    return pb.ActorInfo(actor_id=aid, name=name, namespace="default",
                        class_name="Counter", state=state,
                        address="127.0.0.1:7001", node_id=b"n1" * 8)


def _pg(pid, state):
    info = pb.PgInfo(pg_id=pid, name="pg", strategy="PACK", state=state,
                     bundle_nodes=[b"n1" * 8])
    info.bundles.add().amounts["CPU"] = 1.0
    return info


N1, N2 = b"n1" * 8, b"n2" * 8

# (method, request, reply type): the scripted sequence. ``None`` as the
# request sends an empty body; bytes send the body as it is.
SEQUENCE = [
    (pb.PING, None, pb.PingReply),
    (pb.STATE_STATS, None, pb.StatsReply),
    (pb.REGISTER_NODE, pb.RegisterNodeRequest(
        info=_node(N1, "127.0.0.1:7001", 4.0)), pb.RegisterNodeReply),
    (pb.REGISTER_NODE, pb.RegisterNodeRequest(
        info=_node(N2, "127.0.0.1:7002", 2.0, zone="b")),
     pb.RegisterNodeReply),
    (pb.HEARTBEAT, pb.HeartbeatRequest(node_id=N1, available=_avail(CPU=3.0),
                                       seq=1), pb.HeartbeatReply),
    (pb.HEARTBEAT, pb.HeartbeatRequest(node_id=N1, available=_avail(CPU=3.0),
                                       seq=2), pb.HeartbeatReply),
    (pb.HEARTBEAT, pb.HeartbeatRequest(node_id=b"zz" * 8), pb.HeartbeatReply),
    (pb.HEARTBEAT, pb.HeartbeatRequest(node_id=N1, seq=3), pb.HeartbeatReply),
    (pb.LIST_NODES, None, pb.ListNodesReply),
    (pb.DRAIN_NODE, pb.DrainNodeRequest(node_id=N2, reason="maint",
                                        deadline_s=5.0), pb.Empty),
    (pb.DRAIN_NODE, pb.DrainNodeRequest(node_id=N2, reason="again",
                                        deadline_s=9.0), pb.Empty),
    (pb.DRAIN_NODE, pb.DrainNodeRequest(node_id=b"zz" * 8), pb.Empty),
    (pb.HEARTBEAT, pb.HeartbeatRequest(node_id=N2, seq=4), pb.HeartbeatReply),
    (pb.KV_PUT, pb.KvPutRequest(ns=b"ns1", key=b"k1", value=b"v1"),
     pb.KvPutReply),
    (pb.KV_PUT, pb.KvPutRequest(ns=b"ns1", key=b"k1", value=b"v2"),
     pb.KvPutReply),
    (pb.KV_PUT, pb.KvPutRequest(ns=b"ns1", key=b"k1", value=b"v3",
                                overwrite=True), pb.KvPutReply),
    (pb.KV_PUT, pb.KvPutRequest(ns=b"ns1", key=b"k2", value=b"x"),
     pb.KvPutReply),
    (pb.KV_PUT, pb.KvPutRequest(ns=b"ns2", key=b"k1", value=b"y"),
     pb.KvPutReply),
    (pb.KV_GET, pb.KvGetRequest(ns=b"ns1", key=b"k1"), pb.KvGetReply),
    (pb.KV_GET, pb.KvGetRequest(ns=b"ns1", key=b"nope"), pb.KvGetReply),
    (pb.KV_KEYS, pb.KvKeysRequest(ns=b"ns1", prefix=b"k"), pb.KvKeysReply),
    (pb.KV_KEYS, pb.KvKeysRequest(ns=b"ns1", prefix=b"x"), pb.KvKeysReply),
    (pb.KV_DEL, pb.KvDelRequest(ns=b"ns1", key=b"k2"), pb.KvDelReply),
    (pb.KV_DEL, pb.KvDelRequest(ns=b"ns1", key=b"k2"), pb.KvDelReply),
    (pb.PUBLISH, pb.PublishRequest(event=pb.Event(
        channel="custom", kind="HELLO", payload=b"p")), pb.Empty),
    (pb.ADD_LOCATION, pb.ObjectLocRequest(object_id=b"o1", node_id=N2,
                                          size=100), pb.Empty),
    (pb.ADD_LOCATION, pb.ObjectLocRequest(object_id=b"o1", node_id=N1),
     pb.Empty),
    (pb.ADD_LOCATION, pb.ObjectLocRequest(object_id=b"o2", node_id=N1,
                                          size=7), pb.Empty),
    (pb.GET_LOCATIONS, pb.GetLocationsRequest(object_id=b"o1"),
     pb.GetLocationsReply),
    (pb.GET_LOCATIONS, pb.GetLocationsRequest(object_id=b"o3"),
     pb.GetLocationsReply),
    (pb.REMOVE_LOCATION, pb.ObjectLocRequest(object_id=b"o2", node_id=N1),
     pb.Empty),
    (pb.GET_LOCATIONS, pb.GetLocationsRequest(object_id=b"o2"),
     pb.GetLocationsReply),
    (pb.REGISTER_ACTOR, pb.RegisterActorRequest(
        info=_actor(b"a1" * 8, "svc", "ALIVE")), pb.Empty),
    (pb.REGISTER_ACTOR, pb.RegisterActorRequest(
        info=_actor(b"a2" * 8, "svc", "PENDING")), pb.Empty),
    (pb.GET_ACTOR, pb.GetActorRequest(actor_id=b"a1" * 8), pb.ActorReply),
    (pb.GET_ACTOR, pb.GetActorRequest(actor_id=b"zz" * 8), pb.ActorReply),
    (pb.GET_NAMED_ACTOR, pb.GetNamedActorRequest(
        name="svc", namespace="default"), pb.ActorReply),
    (pb.UPDATE_ACTOR, pb.RegisterActorRequest(
        info=_actor(b"a1" * 8, "svc", "DEAD")), pb.Empty),
    (pb.GET_NAMED_ACTOR, pb.GetNamedActorRequest(
        name="svc", namespace="default"), pb.ActorReply),
    (pb.REGISTER_ACTOR, pb.RegisterActorRequest(
        info=_actor(b"a2" * 8, "svc", "ALIVE")), pb.Empty),
    (pb.LIST_ACTORS, None, pb.ListActorsReply),
    (pb.REGISTER_PG, pb.RegisterPgRequest(info=_pg(b"p1" * 8, "PENDING")),
     pb.Empty),
    (pb.UPDATE_PG, pb.RegisterPgRequest(info=_pg(b"p1" * 8, "CREATED")),
     pb.Empty),
    (pb.REGISTER_PG, pb.RegisterPgRequest(info=_pg(b"p2" * 8, "PENDING")),
     pb.Empty),
    (pb.REMOVE_PG, pb.RemovePgRequest(pg_id=b"p2" * 8), pb.Empty),
    (pb.LIST_PGS, None, pb.ListPgsReply),
    (pb.REGISTER_JOB, pb.RegisterJobRequest(info=pb.JobInfo(
        job_id=b"j1", driver_address="127.0.0.1:7009", state="RUNNING",
        start_ms=5.0, metadata={"user": "x"})), pb.Empty),
    (pb.LIST_JOBS, None, pb.ListJobsReply),
    (pb.CHECKPOINT, None, pb.Empty),
    # after the snapshot: replayed from the journal at recovery
    (pb.KV_PUT, pb.KvPutRequest(ns=b"ns1", key=b"k9", value=b"late"),
     pb.KvPutReply),
    (pb.REGISTER_JOB, pb.RegisterJobRequest(info=pb.JobInfo(
        job_id=b"j2", state="FINISHED")), pb.Empty),
    (pb.MARK_NODE_DEAD, pb.MarkNodeDeadRequest(node_id=N2, reason="gone"),
     pb.Empty),
    (pb.GET_LOCATIONS, pb.GetLocationsRequest(object_id=b"o1"),
     pb.GetLocationsReply),
    (pb.DRAIN_NODE, pb.DrainNodeRequest(node_id=N2), pb.Empty),
    (pb.HEARTBEAT, pb.HeartbeatRequest(node_id=N2), pb.HeartbeatReply),
    (pb.REGISTER_NODE, b"\xff\xff\xff", pb.RegisterNodeReply),
    (999, None, pb.Empty),
    (pb.LIST_NODES, None, pb.ListNodesReply),
    (pb.STATE_STATS, None, pb.StatsReply),
]

_TIME_FIELDS = ("server_time_ms", "time_ms", "last_heartbeat_ms",
                "drain_deadline_ms", "ts_ms")
_SORTED = {"nodes": "node_id", "actors": "actor_id", "pgs": "pg_id",
           "jobs": "job_id"}


def _mask(msg):
    """Timestamps cleared (recursively) and id-keyed lists sorted."""
    for fd, value in list(msg.ListFields()):
        if fd.name in _TIME_FIELDS:
            msg.ClearField(fd.name)
        elif fd.message_type is not None and not (
                fd.message_type.GetOptions().map_entry):
            items = [value] if hasattr(value, "ListFields") else list(value)
            for item in items:
                _mask(item)
            if fd.name in _SORTED:
                key = _SORTED[fd.name]
                ordered = sorted(items, key=lambda m: getattr(m, key))
                copies = [type(m)() for m in ordered]
                for c, m in zip(copies, ordered):
                    c.CopyFrom(m)
                msg.ClearField(fd.name)
                getattr(msg, fd.name).extend(copies)
    if isinstance(msg, pb.KvKeysReply):
        keys = sorted(msg.keys)
        del msg.keys[:]
        msg.keys.extend(keys)
    return msg


def _event(env):
    ev = pb.Event()
    ev.ParseFromString(env.body)
    payload = ev.payload
    if ev.channel == "nodes":
        payload = pb.NodeInfo()
        payload.ParseFromString(ev.payload)
        payload = _mask(payload)
    elif ev.channel == "actors":
        payload = pb.ActorInfo()
        payload.ParseFromString(ev.payload)
    return (ev.channel, ev.kind, payload)


def _call(client, method, req, reply_cls):
    body = b"" if req is None else (req if isinstance(req, bytes)
                                    else req.SerializeToString())
    try:
        env = client.call(method, body, timeout=10)
    except RpcRemoteError as e:
        return ("error", str(e))
    rep = reply_cls()
    rep.ParseFromString(env.body)
    return ("ok", _mask(rep))


def _raw_probe(addr, frames, extra=b""):
    """Send raw frames on a fresh socket: "closed" when the service drops
    the connection, else the method of the first reply."""
    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5)
    try:
        s.sendall(b"".join(frame_bytes(f) for f in frames) + extra)
        s.settimeout(3)
        head = b""
        while len(head) < 4:
            chunk = s.recv(4 - len(head))
            if not chunk:
                return "closed"
            head += chunk
        n = int.from_bytes(head, "big")
        body = b""
        while len(body) < n:
            body += s.recv(n - len(body))
        env = pb.Envelope()
        env.ParseFromString(body)
        return ("reply", env.method, env.reply)
    except (ConnectionResetError, BrokenPipeError):
        return "closed"
    finally:
        s.close()


AUTH_PROBES = {
    "no_auth": [pb.Envelope(seq=1, method=pb.PING)],
    "wrong_token": [pb.Envelope(method=pb.AUTH, body=b"wrong"),
                    pb.Envelope(seq=1, method=pb.PING)],
    "token_then_reauth": [pb.Envelope(method=pb.AUTH, body=TOKEN),
                          pb.Envelope(method=pb.AUTH, body=TOKEN),
                          pb.Envelope(seq=1, method=pb.PING)],
}


def _tables(client):
    out = {}
    for method, cls in ((pb.LIST_NODES, pb.ListNodesReply),
                        (pb.LIST_ACTORS, pb.ListActorsReply),
                        (pb.LIST_PGS, pb.ListPgsReply),
                        (pb.LIST_JOBS, pb.ListJobsReply)):
        out[pb.Method.Name(method)] = _call(client, method, None, cls)
    for ns in (b"ns1", b"ns2"):
        keys = _call(client, pb.KV_KEYS, pb.KvKeysRequest(ns=ns),
                     pb.KvKeysReply)[1].keys
        out[ns] = {k: _call(client, pb.KV_GET, pb.KvGetRequest(ns=ns, key=k),
                            pb.KvGetReply)[1].value for k in keys}
    out["named"] = _call(client, pb.GET_NAMED_ACTOR, pb.GetNamedActorRequest(
        name="svc", namespace="default"), pb.ActorReply)
    stats = _call(client, pb.STATE_STATS, None, pb.StatsReply)[1]
    out["epoch"] = stats.counters["cluster_epoch"]
    return out


def _drive(kind, addr, out):
    pushes, dead = [], threading.Event()

    def on_push(env):
        pushes.append(_event(env))
        if pushes[-1][1] == "NODE_DEAD" and pushes[-1][2].node_id == N1:
            dead.set()

    sub = RpcClient(addr, on_push=on_push, auth_token=TOKEN)
    client = RpcClient(addr, auth_token=TOKEN)
    try:
        sub.call(pb.SUBSCRIBE, pb.SubscribeRequest(
            channels=["nodes", "actors", "kv:ns1", "custom"]
        ).SerializeToString(), timeout=10)
        replies = [_call(client, m, req, cls) for m, req, cls in SEQUENCE]
        # N1's last heartbeat was in the sequence: the sweep expires it.
        expired = dead.wait(timeout=HB_TIMEOUT_MS / 1e3 + 5)
        time.sleep(0.3)  # the last pushes of the sequence are in
        out[kind] = {"replies": replies, "pushes": list(pushes),
                     "expired": expired, "tables": _tables(client)}
    finally:
        client.close()
        sub.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("state_parity")
    token_file = str(root / "token")
    with open(token_file, "wb") as f:
        f.write(TOKEN + b"\n")
    dirs = {k: str(root / k) for k in ("cpp", "py")}
    for d in dirs.values():
        os.makedirs(d + "_x")
    procs = {}
    out = {}
    try:
        addrs = {}
        for kind in ("py", "cpp"):  # the slow start first
            procs[kind], addrs[kind] = _start(kind, dirs[kind], token_file)
        threads = [threading.Thread(target=_drive, args=(k, addrs[k], out))
                   for k in addrs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        out["auth"] = {k: {name: _raw_probe(addrs[k], frames)
                           for name, frames in AUTH_PROBES.items()}
                       for k in addrs}
        for k in addrs:
            out["auth"][k]["oversized_pre_auth"] = _raw_probe(
                addrs[k], [], extra=(1 << 20).to_bytes(4, "big"))
        # Hard kill (the journal carries what follows the CHECKPOINT),
        # then each service recovers the other's data dir.
        for k, p in procs.items():
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=10)
        swapped = {"py": dirs["cpp"], "cpp": dirs["py"]}
        for kind in ("py", "cpp"):
            procs[kind], addrs[kind] = _start(kind, swapped[kind], token_file)
        out["recovered"] = {}
        for kind in ("py", "cpp"):
            c = RpcClient(addrs[kind], auth_token=TOKEN)
            try:
                out["recovered"][kind] = _tables(c)
            finally:
                c.close()
        # A clean stop writes a last snapshot and empties the journal.
        for k, p in procs.items():
            p.send_signal(signal.SIGTERM)
            out.setdefault("rc", {})[k] = p.wait(timeout=10)
        out["journal_sizes"] = {
            k: os.path.getsize(os.path.join(d, "state_journal.pb"))
            for k, d in swapped.items()}
        yield out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def _method_steps(method):
    return [i for i, (m, _, _) in enumerate(SEQUENCE) if m == method]


DISPATCH = [pb.REGISTER_NODE, pb.HEARTBEAT, pb.LIST_NODES, pb.MARK_NODE_DEAD,
            pb.DRAIN_NODE, pb.KV_PUT, pb.KV_GET, pb.KV_DEL, pb.KV_KEYS,
            pb.PUBLISH, pb.ADD_LOCATION, pb.REMOVE_LOCATION,
            pb.GET_LOCATIONS, pb.REGISTER_ACTOR, pb.UPDATE_ACTOR,
            pb.GET_ACTOR, pb.GET_NAMED_ACTOR, pb.LIST_ACTORS, pb.REGISTER_PG,
            pb.UPDATE_PG, pb.REMOVE_PG, pb.LIST_PGS, pb.REGISTER_JOB,
            pb.LIST_JOBS, pb.STATE_STATS, pb.CHECKPOINT, pb.PING, 999]


@pytest.mark.parametrize("method", DISPATCH, ids=lambda m: (
    pb.Method.Name(m) if m in pb.Method.values() else "unknown_method"))
def test_every_method_replies_as_the_cpp_service(runs, method):
    steps = _method_steps(method)
    assert steps, method
    py = [runs["py"]["replies"][i] for i in steps]
    cpp = [runs["cpp"]["replies"][i] for i in steps]
    assert py == cpp
    if method == 999:
        assert cpp == [("error", "unknown method")]


def test_subscribers_get_the_same_pushes_in_the_same_order(runs):
    py, cpp = runs["py"]["pushes"], runs["cpp"]["pushes"]
    kinds = [(ch, kind) for ch, kind, _ in cpp]
    assert ("nodes", "NODE_RESOURCES") in kinds
    assert ("nodes", "NODE_DRAINING") in kinds
    assert ("kv:ns1", "PUT") in kinds and ("custom", "HELLO") in kinds
    assert py == cpp


def test_heartbeat_expiry_publishes_the_same_node_dead(runs):
    for kind in ("py", "cpp"):
        assert runs[kind]["expired"], kind
    dead = {k: [p for p in runs[k]["pushes"] if p[1] == "NODE_DEAD"]
            for k in ("py", "cpp")}
    assert dead["py"] == dead["cpp"]
    assert dead["cpp"][-1][2].death_reason == "heartbeat timeout"
    assert not dead["cpp"][-1][2].alive
    assert runs["py"]["tables"] == runs["cpp"]["tables"]


def test_auth_rule_matches_the_cpp_service(runs):
    assert runs["auth"]["py"] == runs["auth"]["cpp"]
    assert runs["auth"]["cpp"]["no_auth"] == "closed"
    assert runs["auth"]["cpp"]["wrong_token"] == "closed"
    assert runs["auth"]["cpp"]["oversized_pre_auth"] == "closed"
    assert runs["auth"]["cpp"]["token_then_reauth"] == (
        "reply", pb.PING, True)


@pytest.mark.parametrize("reader", ["py", "cpp"])
def test_each_service_recovers_the_others_data_dir(runs, reader):
    writer = "cpp" if reader == "py" else "py"
    got = dict(runs["recovered"][reader])
    before = dict(runs[writer]["tables"])
    assert got.pop("epoch") == before.pop("epoch") + 1 == 2
    assert got == before
    assert got[b"ns1"] == {b"k1": b"v3", b"k9": b"late"}
    assert runs["rc"][reader] == 0
    assert runs["journal_sizes"][reader] == 0
