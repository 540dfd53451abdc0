"""The cluster state service: ``python -m ray_tpu_torch._private.state_service``.

The port's counterpart of the JAX package's C++ ``raytpu_state_service``
(``ray_tpu/_native/state_service.cc``), the reference's GCS server role: a
node table with heartbeat failure detection, the internal KV, pubsub pushed
on the subscriber's own connection, the object directory, the actor,
placement-group and job tables, and persistence through a journal and
snapshots. It speaks the same ``raytpu.proto`` frames, takes the same
command line and gives the same replies, and its ``--data-dir`` files have
the C++ service's layout, so either service recovers the other's.

It is Python because the C++ service needs ``protoc`` and ``libprotobuf``
to build, and a machine may have the ``google.protobuf`` Python package
without them. It runs on ``rpc.RpcServer``: one reader thread per
connection handles that connection's frames in order (``_StateBatcher``
in ``state_client.py`` relies on that), every table change happens under
one lock, and each connection's outgoing frames (replies and pushed
events) leave through that connection's own writer thread in the order
they were produced, as the C++ event loop's write buffers keep them. A
slow subscriber therefore holds up only its own frames.
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import signal
import socket
import struct
import sys
import threading
import time
from typing import Dict, Optional, Set

from ray_tpu_torch._private.rpc import RpcContext, RpcServer, frame_bytes
from ray_tpu_torch.protocol import pb

logger = logging.getLogger("ray_tpu")

_LEN = struct.Struct(">I")
SWEEP_INTERVAL_S = 0.25  # heartbeat sweep and snapshot check


def _now_ms() -> float:
    return time.time() * 1e3


def _mono_ms() -> float:
    return time.monotonic() * 1e3


class _Conn:
    """One client connection: its pubsub channels and its ordered outbox."""

    def __init__(self, conn_id: int, sock: socket.socket,
                 wlock: threading.Lock):
        self.conn_id = conn_id
        self.sock = sock
        self.wlock = wlock
        self.channels: Set[str] = set()
        self._frames: collections.deque = collections.deque()  # raylint: guarded-by(self._cv)
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._write_loop, daemon=True,
            name=f"state-writer-{conn_id}")
        self._thread.start()

    def send(self, data: bytes) -> None:
        with self._cv:
            if not self._closed:
                self._frames.append(data)
                self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._frames.clear()
            self._cv.notify()

    def _write_loop(self) -> None:
        while True:
            with self._cv:
                while not self._frames and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                data = self._frames.popleft()
            try:
                with self.wlock:
                    self.sock.sendall(data)
            except OSError:
                self.close()
                return


class StateService:
    """The tables and their handlers. ``serve()`` runs until ``stop()``."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 data_dir: str = "", heartbeat_timeout_ms: float = 10000,
                 snapshot_interval_s: float = 30,
                 auth_token: Optional[bytes] = None):
        self.host = host
        self.port = port
        self.data_dir = data_dir
        self.hb_timeout_ms = heartbeat_timeout_ms
        self.snapshot_interval_s = snapshot_interval_s
        self._auth_token = auth_token
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._server: Optional[RpcServer] = None
        self._journal = None
        self.cluster_epoch = 0
        self._conns: Dict[int, _Conn] = {}  # raylint: guarded-by(self._lock)
        self.nodes: Dict[bytes, pb.NodeInfo] = {}
        self.hb_deadline: Dict[bytes, float] = {}  # monotonic ms
        self.kv: Dict[bytes, Dict[bytes, bytes]] = {}
        self.actors: Dict[bytes, pb.ActorInfo] = {}
        self.named: Dict[tuple, bytes] = {}  # (namespace, name) -> actor id
        self.pgs: Dict[bytes, pb.PgInfo] = {}
        self.jobs: Dict[bytes, pb.JobInfo] = {}
        self.obj_dir: Dict[bytes, Set[bytes]] = {}
        self.obj_sizes: Dict[bytes, int] = {}
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self._handlers = {
            pb.REGISTER_NODE: self._register_node,
            pb.HEARTBEAT: self._heartbeat,
            pb.LIST_NODES: self._list_nodes,
            pb.MARK_NODE_DEAD: self._mark_node_dead,
            pb.DRAIN_NODE: self._drain_node,
            pb.KV_PUT: self._kv_put,
            pb.KV_GET: self._kv_get,
            pb.KV_DEL: self._kv_del,
            pb.KV_KEYS: self._kv_keys,
            pb.SUBSCRIBE: self._subscribe,
            pb.PUBLISH: self._publish_request,
            pb.ADD_LOCATION: self._add_location,
            pb.REMOVE_LOCATION: self._remove_location,
            pb.GET_LOCATIONS: self._get_locations,
            pb.REGISTER_ACTOR: self._upsert_actor,
            pb.UPDATE_ACTOR: self._upsert_actor,
            pb.GET_ACTOR: self._get_actor,
            pb.GET_NAMED_ACTOR: self._get_named_actor,
            pb.LIST_ACTORS: self._list_actors,
            pb.REGISTER_PG: self._upsert_pg,
            pb.UPDATE_PG: self._upsert_pg,
            pb.REMOVE_PG: self._remove_pg,
            pb.LIST_PGS: self._list_pgs,
            pb.REGISTER_JOB: self._register_job,
            pb.LIST_JOBS: self._list_jobs,
            pb.STATE_STATS: self._stats,
            pb.CHECKPOINT: self._checkpoint,
            pb.PING: self._ping,
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Recover ``data_dir`` (bumping the epoch) and start listening."""
        if self.data_dir:
            os.makedirs(self.data_dir, exist_ok=True)
            self._load_persisted()
            self.cluster_epoch += 1
            self._write_snapshot()  # persist the epoch bump immediately
        # Every method runs on its connection's reader thread: frames of
        # one connection are handled in the order they arrived.
        self._server = RpcServer(
            self._handle, host=self.host, port=self.port,
            inline_methods=set(pb.Method.values()),
            auth_token=self._auth_token)
        self._server.set_on_disconnect(self._on_disconnect)
        self.port = self._server.port

    def serve(self) -> None:
        """Sweep heartbeats and write snapshots until ``stop()``; then
        write a last snapshot and close."""
        last_snapshot = _mono_ms()
        while not self._stop.wait(SWEEP_INTERVAL_S):
            with self._lock:
                self._sweep_heartbeats()
                if (self.data_dir and _mono_ms() - last_snapshot
                        > self.snapshot_interval_s * 1e3):
                    self._write_snapshot()
                    last_snapshot = _mono_ms()
        self._server.close()
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()
            if self.data_dir:
                self._write_snapshot()
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------- transport

    def _conn_for(self, ctx: RpcContext) -> _Conn:
        """Under self._lock."""
        c = self._conns.get(ctx.conn_id)
        if c is None:
            c = _Conn(ctx.conn_id, ctx._sock, ctx._wlock)
            self._conns[ctx.conn_id] = c
        return c

    def _on_disconnect(self, conn_id: int) -> None:
        with self._lock:
            c = self._conns.pop(conn_id, None)
        if c is not None:
            c.close()

    def _reply(self, conn: _Conn, env_in, msg) -> None:
        conn.send(frame_bytes(pb.Envelope(
            seq=env_in.seq, method=env_in.method, reply=True,
            body=msg.SerializeToString())))

    def _reply_error(self, conn: _Conn, env_in, error: str) -> None:
        conn.send(frame_bytes(pb.Envelope(
            seq=env_in.seq, method=env_in.method, reply=True, error=error)))

    def _handle(self, ctx: RpcContext) -> None:
        with self._lock:
            conn = self._conn_for(ctx)
            self.counters["rpc_total"] += 1
            handler = self._handlers.get(ctx.method)
            if handler is None:
                self._reply_error(conn, ctx, "unknown method")
                return
            handler(conn, ctx)

    def _publish(self, channel: str, kind: str, payload: bytes) -> None:
        """Under self._lock."""
        data = frame_bytes(pb.Envelope(
            seq=0, method=pb.PUBLISH, body=pb.Event(
                channel=channel, kind=kind, payload=payload,
                ts_ms=_now_ms()).SerializeToString()))
        # raylint: allow(guarded-by) every caller holds self._lock: the handlers run from _handle's dispatch table under it, _sweep_heartbeats from serve() under it
        for c in self._conns.values():
            if channel in c.channels:
                c.send(data)
        self.counters["published"] += 1

    def _journal_record(self, method: int, body: bytes) -> None:
        if self._journal is None:
            return
        payload = pb.JournalRecord(method=method, body=body,
                                   ts_ms=_now_ms()).SerializeToString()
        self._journal.write(_LEN.pack(len(payload)) + payload)
        self._journal.flush()

    @staticmethod
    def _parse(msg_cls, body: bytes):
        msg = msg_cls()
        try:
            msg.ParseFromString(body)
        except Exception:  # raylint: allow(swallow) a malformed body gets the "bad <Request>" error reply
            return None
        return msg

    # ------------------------------------------------------------ node table

    def _apply_register_node(self, req: pb.RegisterNodeRequest) -> None:
        info = pb.NodeInfo()
        info.CopyFrom(req.info)
        info.alive = True
        info.last_heartbeat_ms = _now_ms()
        # A (re-)registration is a fresh lifecycle: a stale DRAINING or
        # DRAINED marker of an earlier incarnation is cleared.
        info.ClearField("state")
        info.ClearField("drain_deadline_ms")
        info.ClearField("drain_reason")
        self.nodes[info.node_id] = info
        self.hb_deadline[info.node_id] = _mono_ms() + self.hb_timeout_ms

    def _register_node(self, conn, env) -> None:
        req = self._parse(pb.RegisterNodeRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad RegisterNodeRequest")
        self._apply_register_node(req)
        self._journal_record(pb.REGISTER_NODE, env.body)
        # The applied copy (alive, heartbeat stamped) is what subscribers
        # cache in their views.
        self._publish("nodes", "NODE_ADDED",
                      self.nodes[req.info.node_id].SerializeToString())
        self._reply(conn, env, pb.RegisterNodeReply(
            server_time_ms=_now_ms(), cluster_epoch=self.cluster_epoch))

    def _heartbeat(self, conn, env) -> None:
        req = self._parse(pb.HeartbeatRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad HeartbeatRequest")
        # Clock-sync beacon: stamped even when the node is not recognized.
        rep = pb.HeartbeatReply(server_time_ms=_now_ms())
        info = self.nodes.get(req.node_id)
        if info is None or not info.alive:
            rep.recognized = False  # the node must re-register
        else:
            rep.recognized = True
            # The drain signal rides the ack as well as the pubsub push.
            if info.state:
                rep.node_state = info.state
                rep.drain_deadline_ms = info.drain_deadline_ms
                rep.drain_reason = info.drain_reason
            info.last_heartbeat_ms = _now_ms()
            if req.HasField("available"):
                # Changed availability is broadcast at once (compared entry
                # by entry); an unchanged heartbeat publishes nothing.
                changed = (dict(info.available.amounts)
                           != dict(req.available.amounts))
                info.available.CopyFrom(req.available)
                if changed:
                    self._publish("nodes", "NODE_RESOURCES",
                                  info.SerializeToString())
            self.hb_deadline[req.node_id] = _mono_ms() + self.hb_timeout_ms
        self._reply(conn, env, rep)

    def _list_nodes(self, conn, env) -> None:
        self._reply(conn, env, pb.ListNodesReply(nodes=self.nodes.values()))

    def _apply_mark_node_dead(self, req: pb.MarkNodeDeadRequest) -> None:
        info = self.nodes.get(req.node_id)
        if info is not None:
            info.alive = False
            info.death_reason = req.reason
            # A node that dies while DRAINING ends DRAINED either way; the
            # death reason tells a finished drain from a timeout.
            if info.state == "DRAINING":
                info.state = "DRAINED"
        self.hb_deadline.pop(req.node_id, None)
        # Objects on a dead node are gone.
        for oid in list(self.obj_dir):
            holders = self.obj_dir[oid]
            holders.discard(req.node_id)
            if not holders:
                del self.obj_dir[oid]
                self.obj_sizes.pop(oid, None)

    def _mark_dead(self, node_id: bytes, reason: str) -> None:
        req = pb.MarkNodeDeadRequest(node_id=node_id, reason=reason)
        self._apply_mark_node_dead(req)
        self._journal_record(pb.MARK_NODE_DEAD, req.SerializeToString())
        # The payload is a NodeInfo, as for NODE_ADDED, so subscribers get
        # the dead node's address.
        info = self.nodes.get(node_id)
        if info is None:
            info = pb.NodeInfo(node_id=node_id, alive=False,
                               death_reason=reason)
        self._publish("nodes", "NODE_DEAD", info.SerializeToString())
        self.counters["nodes_dead"] += 1

    def _apply_drain_node(self, req: pb.DrainNodeRequest) -> None:
        info = self.nodes.get(req.node_id)
        if info is None or not info.alive:
            return
        info.state = "DRAINING"
        info.drain_reason = req.reason
        info.drain_deadline_ms = _now_ms() + req.deadline_s * 1e3

    def _drain_node(self, conn, env) -> None:
        req = self._parse(pb.DrainNodeRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad DrainNodeRequest")
        info = self.nodes.get(req.node_id)
        if info is None:
            return self._reply_error(conn, env, "unknown node")
        if not info.alive:
            return self._reply_error(conn, env, "node already dead")
        was_draining = info.state == "DRAINING"
        self._apply_drain_node(req)
        # Idempotent: journaled and published once per transition.
        if not was_draining:
            self._journal_record(pb.DRAIN_NODE, env.body)
            self._publish("nodes", "NODE_DRAINING", info.SerializeToString())
            self.counters["nodes_draining"] += 1
        self._reply(conn, env, pb.Empty())

    def _mark_node_dead(self, conn, env) -> None:
        req = self._parse(pb.MarkNodeDeadRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad MarkNodeDeadRequest")
        self._mark_dead(req.node_id, req.reason)
        self._reply(conn, env, pb.Empty())

    def _sweep_heartbeats(self) -> None:
        """Under self._lock."""
        now = _mono_ms()
        for node_id in [n for n, d in self.hb_deadline.items() if now > d]:
            self._mark_dead(node_id, "heartbeat timeout")

    # -------------------------------------------------------------------- kv

    def _kv_put(self, conn, env) -> None:
        req = self._parse(pb.KvPutRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad KvPutRequest")
        ns = self.kv.setdefault(req.ns, {})
        rep = pb.KvPutReply()
        if not req.overwrite and req.key in ns:
            rep.added = False
        else:
            ns[req.key] = req.value
            rep.added = True
            self._journal_record(pb.KV_PUT, env.body)
            self._publish("kv:" + req.ns.decode("utf-8", "replace"), "PUT",
                          req.key)
        self._reply(conn, env, rep)

    def _kv_get(self, conn, env) -> None:
        req = self._parse(pb.KvGetRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad KvGetRequest")
        rep = pb.KvGetReply()
        value = self.kv.get(req.ns, {}).get(req.key)
        if value is not None:
            rep.found = True
            rep.value = value
        self._reply(conn, env, rep)

    def _kv_del(self, conn, env) -> None:
        req = self._parse(pb.KvDelRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad KvDelRequest")
        ns = self.kv.get(req.ns)
        rep = pb.KvDelReply(deleted=ns is not None
                            and ns.pop(req.key, None) is not None)
        if rep.deleted:
            self._journal_record(pb.KV_DEL, env.body)
        self._reply(conn, env, rep)

    def _kv_keys(self, conn, env) -> None:
        req = self._parse(pb.KvKeysRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad KvKeysRequest")
        self._reply(conn, env, pb.KvKeysReply(keys=[
            k for k in self.kv.get(req.ns, {}) if k.startswith(req.prefix)]))

    # ---------------------------------------------------------------- pubsub

    def _subscribe(self, conn, env) -> None:
        req = self._parse(pb.SubscribeRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad SubscribeRequest")
        conn.channels.update(req.channels)
        self._reply(conn, env, pb.Empty())

    def _publish_request(self, conn, env) -> None:
        req = self._parse(pb.PublishRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad PublishRequest")
        self._publish(req.event.channel, req.event.kind, req.event.payload)
        self._reply(conn, env, pb.Empty())

    # ------------------------------------------------------ object directory

    def _add_location(self, conn, env) -> None:
        req = self._parse(pb.ObjectLocRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad ObjectLocRequest")
        self.obj_dir.setdefault(req.object_id, set()).add(req.node_id)
        if req.size > 0:
            self.obj_sizes[req.object_id] = req.size
        self._reply(conn, env, pb.Empty())

    def _remove_location(self, conn, env) -> None:
        req = self._parse(pb.ObjectLocRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad ObjectLocRequest")
        holders = self.obj_dir.get(req.object_id)
        if holders is not None:
            holders.discard(req.node_id)
            if not holders:
                del self.obj_dir[req.object_id]
                self.obj_sizes.pop(req.object_id, None)
        self._reply(conn, env, pb.Empty())

    def _get_locations(self, conn, env) -> None:
        req = self._parse(pb.GetLocationsRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad GetLocationsRequest")
        rep = pb.GetLocationsReply()
        for nid in sorted(self.obj_dir.get(req.object_id, ())):
            rep.node_ids.append(nid)
            info = self.nodes.get(nid)
            rep.addresses.append(info.address if info is not None else "")
        size = self.obj_sizes.get(req.object_id)
        if size is not None:
            rep.size = size
        self._reply(conn, env, rep)

    # ----------------------------------------------------------- actor table

    def _apply_upsert_actor(self, req: pb.RegisterActorRequest) -> None:
        info = req.info
        prev = self.actors.get(info.actor_id)
        if prev is not None and prev.name:
            self.named.pop((prev.namespace, prev.name), None)
        self.actors[info.actor_id] = info
        if info.name and info.state != "DEAD":
            self.named[(info.namespace, info.name)] = info.actor_id

    def _upsert_actor(self, conn, env) -> None:
        req = self._parse(pb.RegisterActorRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad RegisterActorRequest")
        info = req.info
        # Name collision check on first registration.
        if env.method == pb.REGISTER_ACTOR and info.name:
            holder = self.named.get((info.namespace, info.name))
            if holder is not None and holder != info.actor_id:
                other = self.actors.get(holder)
                if other is not None and other.state != "DEAD":
                    return self._reply_error(
                        conn, env, "actor name already taken: " + info.name)
        self._apply_upsert_actor(req)
        self._journal_record(env.method, env.body)
        self._publish("actors", info.state, info.SerializeToString())
        self._reply(conn, env, pb.Empty())

    def _get_actor(self, conn, env) -> None:
        req = self._parse(pb.GetActorRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad GetActorRequest")
        rep = pb.ActorReply()
        info = self.actors.get(req.actor_id)
        if info is not None:
            rep.found = True
            rep.info.CopyFrom(info)
        self._reply(conn, env, rep)

    def _get_named_actor(self, conn, env) -> None:
        req = self._parse(pb.GetNamedActorRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad GetNamedActorRequest")
        rep = pb.ActorReply()
        info = self.actors.get(self.named.get((req.namespace, req.name)))
        if info is not None:
            rep.found = True
            rep.info.CopyFrom(info)
        self._reply(conn, env, rep)

    def _list_actors(self, conn, env) -> None:
        self._reply(conn, env,
                    pb.ListActorsReply(actors=self.actors.values()))

    # ------------------------------------------------------------- pg and job

    def _upsert_pg(self, conn, env) -> None:
        req = self._parse(pb.RegisterPgRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad RegisterPgRequest")
        self.pgs[req.info.pg_id] = req.info
        self._journal_record(env.method, env.body)
        self._reply(conn, env, pb.Empty())

    def _remove_pg(self, conn, env) -> None:
        req = self._parse(pb.RemovePgRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad RemovePgRequest")
        self.pgs.pop(req.pg_id, None)
        self._journal_record(pb.REMOVE_PG, env.body)
        self._reply(conn, env, pb.Empty())

    def _list_pgs(self, conn, env) -> None:
        self._reply(conn, env, pb.ListPgsReply(pgs=self.pgs.values()))

    def _register_job(self, conn, env) -> None:
        req = self._parse(pb.RegisterJobRequest, env.body)
        if req is None:
            return self._reply_error(conn, env, "bad RegisterJobRequest")
        self.jobs[req.info.job_id] = req.info
        self._journal_record(pb.REGISTER_JOB, env.body)
        self._reply(conn, env, pb.Empty())

    def _list_jobs(self, conn, env) -> None:
        self._reply(conn, env, pb.ListJobsReply(jobs=self.jobs.values()))

    # ----------------------------------------------------------------- admin

    def _stats(self, conn, env) -> None:
        with self._server._conn_lock:
            n_conns = len(self._server._conns)
        rep = pb.StatsReply()
        m = rep.counters
        m["nodes_total"] = len(self.nodes)
        m["nodes_alive"] = sum(1 for n in self.nodes.values() if n.alive)
        m["actors"] = len(self.actors)
        m["pgs"] = len(self.pgs)
        m["jobs"] = len(self.jobs)
        m["objects_tracked"] = len(self.obj_dir)
        m["connections"] = n_conns
        m["cluster_epoch"] = self.cluster_epoch
        for k, v in self.counters.items():
            m[k] = v
        self._reply(conn, env, rep)

    def _checkpoint(self, conn, env) -> None:
        if self.data_dir:
            self._write_snapshot()
        self._reply(conn, env, pb.Empty())

    def _ping(self, conn, env) -> None:
        self._reply(conn, env, pb.PingReply(time_ms=_now_ms()))

    # ----------------------------------------------------------- persistence

    def _snapshot_path(self) -> str:
        return os.path.join(self.data_dir, "state_snapshot.pb")

    def _journal_path(self) -> str:
        return os.path.join(self.data_dir, "state_journal.pb")

    def _write_snapshot(self) -> None:
        """Snapshot the tables, then truncate the journal they cover."""
        snap = pb.StateSnapshot(
            nodes=self.nodes.values(), actors=self.actors.values(),
            pgs=self.pgs.values(), jobs=self.jobs.values(),
            cluster_epoch=self.cluster_epoch)
        for ns, entries in self.kv.items():
            for k, v in entries.items():
                snap.kv.add(ns=ns, key=k, value=v)
        tmp = self._snapshot_path() + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(snap.SerializeToString())
        except OSError as e:
            logger.warning("state snapshot write failed: %s", e)
            return
        os.replace(tmp, self._snapshot_path())
        if self._journal is not None:
            self._journal.close()
        self._journal = open(self._journal_path(), "wb")

    def _load_persisted(self) -> None:
        # 1. snapshot
        try:
            with open(self._snapshot_path(), "rb") as f:
                data = f.read()
        except OSError:
            data = None
        if data is not None:
            snap = pb.StateSnapshot()
            try:
                snap.ParseFromString(data)
            except Exception as e:  # raylint: allow(swallow) an unreadable snapshot is skipped, as the C++ service skips it
                logger.warning("state snapshot unreadable: %s", e)
                snap = None
            if snap is not None:
                for info in snap.nodes:
                    self.nodes[info.node_id] = info
                for info in snap.actors:
                    self.actors[info.actor_id] = info
                    if info.name and info.state != "DEAD":
                        self.named[(info.namespace, info.name)] = \
                            info.actor_id
                for info in snap.pgs:
                    self.pgs[info.pg_id] = info
                for info in snap.jobs:
                    self.jobs[info.job_id] = info
                for e in snap.kv:
                    self.kv.setdefault(e.ns, {})[e.key] = e.value
                self.cluster_epoch = snap.cluster_epoch
        # 2. journal replay; a torn tail record is dropped
        try:
            with open(self._journal_path(), "rb") as f:
                data = f.read()
        except OSError:
            data = b""
        off = 0
        while len(data) - off >= 4:
            (n,) = _LEN.unpack_from(data, off)
            if len(data) - off - 4 < n:
                break
            rec = self._parse(pb.JournalRecord, data[off + 4:off + 4 + n])
            if rec is not None:
                self._replay(rec)
            off += 4 + n
        # Restored nodes get a grace period to resume heartbeating.
        for node_id, info in self.nodes.items():
            if info.alive:
                self.hb_deadline[node_id] = (_mono_ms()
                                             + 2 * self.hb_timeout_ms)

    def _replay(self, rec: pb.JournalRecord) -> None:
        m = rec.method
        if m == pb.REGISTER_NODE:
            req = self._parse(pb.RegisterNodeRequest, rec.body)
            if req is not None:
                self._apply_register_node(req)
        elif m == pb.MARK_NODE_DEAD:
            req = self._parse(pb.MarkNodeDeadRequest, rec.body)
            if req is not None:
                self._apply_mark_node_dead(req)
        elif m == pb.DRAIN_NODE:
            req = self._parse(pb.DrainNodeRequest, rec.body)
            if req is not None:
                self._apply_drain_node(req)
        elif m == pb.KV_PUT:
            req = self._parse(pb.KvPutRequest, rec.body)
            if req is not None:
                self.kv.setdefault(req.ns, {})[req.key] = req.value
        elif m == pb.KV_DEL:
            req = self._parse(pb.KvDelRequest, rec.body)
            if req is not None:
                self.kv.get(req.ns, {}).pop(req.key, None)
        elif m in (pb.REGISTER_ACTOR, pb.UPDATE_ACTOR):
            req = self._parse(pb.RegisterActorRequest, rec.body)
            if req is not None:
                self._apply_upsert_actor(req)
        elif m in (pb.REGISTER_PG, pb.UPDATE_PG):
            req = self._parse(pb.RegisterPgRequest, rec.body)
            if req is not None:
                self.pgs[req.info.pg_id] = req.info
        elif m == pb.REMOVE_PG:
            req = self._parse(pb.RemovePgRequest, rec.body)
            if req is not None:
                self.pgs.pop(req.pg_id, None)
        elif m == pb.REGISTER_JOB:
            req = self._parse(pb.RegisterJobRequest, rec.body)
            if req is not None:
                self.jobs[req.info.job_id] = req.info


def _read_token_file(path: str) -> str:
    with open(path, "rb") as f:
        return f.read(4096).decode("utf-8", "replace").strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="ray_tpu_torch cluster state service")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--data-dir", default="")
    parser.add_argument("--port-file", default="")
    parser.add_argument("--heartbeat-timeout-ms", type=float, default=10000)
    parser.add_argument("--snapshot-interval-s", type=float, default=30)
    parser.add_argument("--token-file", default="")
    args = parser.parse_args(argv)
    try:
        socket.inet_pton(socket.AF_INET, args.host)
    except OSError:
        print(f"bad host {args.host}", file=sys.stderr)
        return 1
    if args.token_file:
        try:
            token = _read_token_file(args.token_file)
        except OSError:
            print(f"cannot read --token-file {args.token_file}",
                  file=sys.stderr)
            return 2
    else:
        token = os.environ.get("RAY_TPU_AUTH_TOKEN", "")
    svc = StateService(port=args.port, host=args.host,
                       data_dir=args.data_dir,
                       heartbeat_timeout_ms=args.heartbeat_timeout_ms,
                       snapshot_interval_s=args.snapshot_interval_s,
                       auth_token=token.encode())
    signal.signal(signal.SIGINT, lambda *_: svc.stop())
    signal.signal(signal.SIGTERM, lambda *_: svc.stop())
    try:
        svc.start()
    except OSError as e:
        print(f"bind: {e}", file=sys.stderr)
        return 1
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{svc.port}\n")
        os.replace(tmp, args.port_file)
    print(f"[state_service] listening on {args.host}:{svc.port} "
          f"epoch={svc.cluster_epoch}", file=sys.stderr, flush=True)
    svc.serve()
    print("[state_service] shutting down", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
