"""Client for the state service (the GcsClient role,
``src/ray/gcs/gcs_client/accessor.h`` + ``python/ray/_private/gcs_utils.py:226``).

Wraps one RpcClient connection with typed accessors for the node table,
internal KV, object directory, actor/PG/job tables, and pubsub. A second
dedicated connection carries subscriptions so pushed events never contend
with request/reply traffic.
"""

from __future__ import annotations

import logging
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import chaos
from ray_tpu_torch._private.backoff import BackoffPolicy
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.rpc import (RpcClient, RpcConnectionError,
                                  _method_name)
from ray_tpu_torch.protocol import pb

logger = logging.getLogger("ray_tpu")


def _package_env() -> Dict[str, str]:
    """This process's environment with the directory that holds
    ``ray_tpu_torch`` first on ``PYTHONPATH``, so a child started with
    ``python -m ray_tpu_torch...`` imports this checkout whatever its
    working directory."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def start_state_service(port: int = 0, host: str = "127.0.0.1",
                        data_dir: str = "", heartbeat_timeout_ms: float = 10000,
                        snapshot_interval_s: float = 30
                        ) -> Tuple[subprocess.Popen, str]:
    """Spawn the state-service daemon; returns (process, address).

    The service is the port's Python module
    (``python -m ray_tpu_torch._private.state_service``), where the JAX
    package builds and runs its C++ binary; the command line and the
    port-file handshake are the same."""
    import os
    import sys
    import tempfile
    port_file = tempfile.mktemp(prefix="raytpu_state_port_")
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.state_service",
           "--port", str(port), "--host", host,
           "--port-file", port_file,
           "--heartbeat-timeout-ms", str(heartbeat_timeout_ms),
           "--snapshot-interval-s", str(snapshot_interval_s)]
    if data_dir:
        cmd += ["--data-dir", data_dir]
    proc = subprocess.Popen(cmd, env=_package_env())
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                text = f.read().strip()
            if text:
                os.unlink(port_file)
                return proc, f"{host}:{text}"
        if proc.poll() is not None:
            raise RuntimeError(
                f"state service exited rc={proc.returncode} before listening")
        time.sleep(0.01)
    proc.kill()
    raise TimeoutError("state service did not start listening in time")


class _StateBatcher:
    """Coalesces object-directory upserts into write bursts.

    Every task completion and fetch landing publishes a location; at
    thousands of tasks/s those synchronous one-op RPCs dominate the state
    connection. Enqueued ops flush as ONE gather write (``call_burst``)
    when ``state_batch_max`` accumulate or ``state_batch_flush_ms``
    elapses, whichever first.

    Ordering: ops serialize into frames in enqueue order and go out on one
    connection; the state service's epoll loop processes frames
    per-connection in order, so UPDATE→REMOVE sequences for the same
    object are preserved. The single flusher thread retries a failed
    burst (reconnect + resend, the ops are idempotent upserts) BEFORE
    taking the next batch, which keeps that guarantee across a state-
    service restart."""

    def __init__(self, sc: "StateClient"):
        self.sc = sc
        self._cv = threading.Condition()
        self._ops: List[Tuple[int, bytes]] = []  # raylint: guarded-by(self._cv)
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0          # ops sent, reply not yet seen
        self._stopped = False
        self.flushes = 0            # bursts sent (observable in tests)

    def enqueue(self, method: int, body: bytes) -> None:
        with self._cv:
            if self._stopped:       # late op during shutdown: drop —
                return              # a dead directory entry, not a wedge
            self._ops.append((method, body))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._flush_loop, daemon=True,
                    name="state-batch")
                self._thread.start()
            self._cv.notify_all()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until everything enqueued so far is sent AND answered —
        the barrier synchronous readers (get_locations) use before
        trusting the directory."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._ops or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=left)
        return True

    def stop(self) -> None:
        self.flush(timeout=5.0)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # -- internals ---------------------------------------------------------

    def _flush_loop(self):
        max_ops = max(1, int(_config.get("state_batch_max")))
        wait_s = max(_config.get("state_batch_flush_ms"), 0.0) / 1e3
        while True:
            with self._cv:
                if not self._ops:
                    if self._stopped:
                        return
                    self._cv.wait(timeout=1.0)
                    continue
                # Linger briefly for the rest of a submission wave, but
                # never past the latency budget.
                if len(self._ops) < max_ops and not self._stopped:
                    self._cv.wait_for(
                        lambda: len(self._ops) >= max_ops or self._stopped,
                        timeout=wait_s)
                batch, self._ops = self._ops[:max_ops], self._ops[max_ops:]
                self._inflight = len(batch)  # raylint: guarded-by(self._cv)
            try:
                self._send(batch)
            finally:
                with self._cv:
                    self._inflight = 0
                    self._cv.notify_all()

    def _send(self, batch):
        """One burst; on transport failure reconnect and replay the WHOLE
        batch once (idempotent upserts), preserving op order."""
        for attempt in (0, 1):
            settle = threading.Event()
            state = {"left": len(batch), "conn_error": None}
            lock = threading.Lock()

            def _cb(_i, _env, error):
                with lock:
                    if (error is not None
                            and isinstance(error, (RpcConnectionError,
                                                   ConnectionError))
                            and state["conn_error"] is None):
                        state["conn_error"] = error
                    state["left"] -= 1
                    if state["left"] == 0:
                        settle.set()
            try:
                with self.sc._client_lock:
                    client = self.sc._client
                client.call_burst(batch, _cb)
            except Exception as e:
                logger.debug("state batch send failed: %s", e)
                with lock:
                    state["conn_error"] = state["conn_error"] or e
                settle.set()
            settle.wait(timeout=30.0)
            err = state["conn_error"]
            self.flushes += 1
            if err is None or attempt == 1:
                if err is not None:
                    logger.warning(
                        "dropping %d batched directory ops after retry: "
                        "%s (heartbeat re-publish will reconcile)",
                        len(batch), err)
                return
            try:
                self.sc._reconnect()
            except Exception as e:
                logger.debug("state batch reconnect failed: %s", e)


class StateClient:
    """GCS-fault-tolerant client: a state-service restart (new process,
    journal-recovered tables) breaks the TCP connections — calls
    transparently reconnect and retry once, and the pubsub connection
    re-subscribes its channels, so daemons and drivers SURVIVE a state
    service restart instead of wedging (the reference's GCS FT contract:
    raylets reconnect and re-register, which the heartbeat loop's
    unrecognized-node re-registration then completes)."""

    def __init__(self, address: str, auth_token=None):
        self.address = address
        self._auth_token = auth_token
        self._client = RpcClient(address, auth_token=auth_token)  # raylint: guarded-by(self._client_lock)
        self._client_lock = threading.Lock()
        self._sub_client: Optional[RpcClient] = None
        self._sub_lock = threading.Lock()      # subscription connection
        self._sub_channels: List[str] = []  # raylint: guarded-by(self._sub_lock)
        # handlers have their OWN lock: _on_push runs on the subscription
        # connection's reader thread, and blocking it on _sub_lock while a
        # SUBSCRIBE call awaits its reply on that same thread would stall
        # resubscription for the full call timeout
        self._handlers_lock = threading.Lock()
        self._handlers: Dict[str, List[Callable[[pb.Event], None]]] = {}  # raylint: guarded-by(self._handlers_lock)
        self._batcher = _StateBatcher(self)
        self._closed = False

    # ------------------------------------------------------------------ core

    def _call(self, method: int, msg=None, timeout: float = 30.0,
              retry: bool = True, deadline_s: Optional[float] = None) -> bytes:
        """``retry``: reconnect and re-send on a connection error —
        at-least-once semantics. The state service's mutating handlers
        are upserts and its subscribers handle duplicate events
        idempotently, so the retry is safe EXCEPT for compare-and-set
        writes (``kv_put(overwrite=False)``), which pass retry=False: a
        replayed CAS would misreport the original success as a loss.

        The first failure retries immediately (the common case: a completed
        service restart left a dead socket behind); further attempts are
        paced by the shared backoff policy until ``deadline_s`` (default:
        ``state_reconnect_deadline_s``) is spent, so calls issued DURING a
        restart ride it out instead of failing."""
        body = msg.SerializeToString() if msg is not None else b""
        state = None
        while True:
            try:
                if chaos.ENABLED:
                    chaos.inject("state.call", method=_method_name(method))
                with self._client_lock:
                    c = self._client
                return c.call(method, body, timeout=timeout).body
            except (RpcConnectionError, chaos.ChaosConnectionReset) as e:
                if self._closed or not retry:
                    raise
                if state is None:
                    if deadline_s is None:
                        deadline_s = _config.get("state_reconnect_deadline_s")
                    state = BackoffPolicy(deadline_s=deadline_s).start()
                elif not state.sleep():
                    raise RpcConnectionError(
                        f"state service at {self.address} unreachable after "
                        f"{state.attempt} attempts over "
                        f"{state.elapsed():.1f}s: {e}") from e
                try:
                    self._reconnect()
                except (RpcConnectionError, OSError) as re:
                    # still down — the next loop iteration fails fast on the
                    # dead client and burns backoff budget above
                    logger.debug("state reconnect attempt failed: %s", re)

    def _reconnect(self):
        """Replace the dead request connection (single flight: concurrent
        failers share one fresh connection) and revive pubsub."""
        with self._client_lock:
            if self._closed:
                raise RpcConnectionError("state client closed")
            try:
                # another thread may have already reconnected: probe
                self._client.call(pb.PING, b"", timeout=5.0)
                return
            except Exception as e:
                logger.debug("probe ping failed; reconnecting: %s", e)
            old = self._client
            if chaos.ENABLED:
                chaos.inject("state.reconnect", peer=self.address)
            self._client = RpcClient(self.address,
                                     auth_token=self._auth_token)
            try:
                old.close()
            except Exception as e:
                logger.debug("old client close failed: %s", e)
        with self._sub_lock:
            self._ensure_subscribed_locked(fresh=True)

    def _ensure_subscribed_locked(self, fresh: bool = False):
        """(Re)establish the pubsub connection for ``_sub_channels``.
        Invariant on exit: ``_sub_client`` is either a connection that
        acknowledged SUBSCRIBE, or None (a later subscribe()/_reconnect
        retries). Callers hold ``_sub_lock``."""
        if self._closed or not self._sub_channels:
            return
        if fresh and self._sub_client is not None:
            try:
                self._sub_client.close()
            except Exception as e:
                logger.debug("subscriber close failed: %s", e)
            self._sub_client = None  # raylint: guarded-by(self._sub_lock)
        if self._sub_client is None:
            try:
                self._sub_client = RpcClient(
                    self.address, on_push=self._on_push,
                    auth_token=self._auth_token)
            except Exception:
                logger.warning(
                    "pubsub reconnect to %s failed; events degrade to "
                    "view-refresh reconciliation until the next retry",
                    self.address)
                return
        try:
            self._sub_client.call(
                pb.SUBSCRIBE, pb.SubscribeRequest(
                    channels=list(self._sub_channels)).SerializeToString(),
                timeout=10.0)
        except Exception:
            try:
                self._sub_client.close()
            except Exception as e:
                logger.debug("subscriber close failed: %s", e)
            self._sub_client = None
            logger.warning(
                "pubsub resubscribe to %s failed; events degrade to "
                "view-refresh reconciliation until the next retry",
                self.address)

    def close(self):
        self._batcher.stop()  # drain queued directory ops first
        with self._client_lock:
            self._closed = True
            self._client.close()
        with self._sub_lock:
            if self._sub_client is not None:
                self._sub_client.close()
                self._sub_client = None

    def ping(self) -> float:
        rep = pb.PingReply()
        rep.ParseFromString(self._call(pb.PING))
        return rep.time_ms

    def stats(self) -> Dict[str, int]:
        rep = pb.StatsReply()
        rep.ParseFromString(self._call(pb.STATE_STATS))
        return dict(rep.counters)

    def checkpoint(self):
        self._call(pb.CHECKPOINT)

    # ----------------------------------------------------------------- nodes

    def register_node(self, info: pb.NodeInfo) -> pb.RegisterNodeReply:
        rep = pb.RegisterNodeReply()
        rep.ParseFromString(self._call(
            pb.REGISTER_NODE, pb.RegisterNodeRequest(info=info)))
        return rep

    def heartbeat(self, node_id: bytes,
                  available: Optional[Dict[str, float]] = None) -> bool:
        return self.heartbeat_ex(node_id, available).recognized

    def heartbeat_ex(self, node_id: bytes,
                     available: Optional[Dict[str, float]] = None
                     ) -> pb.HeartbeatReply:
        """Full heartbeat reply: ``recognized`` plus the drain signal
        (``node_state``/``drain_deadline_ms``/``drain_reason``) the
        service piggybacks on the ack."""
        req = pb.HeartbeatRequest(node_id=node_id)
        if available is not None:
            req.available.amounts.update(available)
        rep = pb.HeartbeatReply()
        # small retry budget: a missed beat is recoverable, so don't wedge
        # the heartbeat thread for the full reconnect deadline
        rep.ParseFromString(self._call(pb.HEARTBEAT, req, timeout=10.0,
                                       deadline_s=5.0))
        return rep

    def list_nodes(self) -> List[pb.NodeInfo]:
        rep = pb.ListNodesReply()
        rep.ParseFromString(self._call(pb.LIST_NODES))
        return list(rep.nodes)

    def mark_node_dead(self, node_id: bytes, reason: str = ""):
        self._call(pb.MARK_NODE_DEAD,
                   pb.MarkNodeDeadRequest(node_id=node_id, reason=reason))

    def drain_node(self, node_id: bytes, reason: str = "",
                   deadline_s: float = 0.0):
        """Flip a node to DRAINING at the state service. The service
        publishes NODE_DRAINING and repeats the signal on every heartbeat
        ack; the node's own drain orchestrator does the migration."""
        self._call(pb.DRAIN_NODE,
                   pb.DrainNodeRequest(node_id=node_id, reason=reason,
                                       deadline_s=deadline_s))

    # -------------------------------------------------------------------- kv

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               namespace: bytes = b"") -> bool:
        rep = pb.KvPutReply()
        # CAS (overwrite=False) must not auto-retry: a replayed request
        # whose original landed would report added=False to the winner
        rep.ParseFromString(self._call(
            pb.KV_PUT,
            pb.KvPutRequest(ns=namespace, key=key, value=value,
                            overwrite=overwrite),
            retry=overwrite))
        return rep.added

    def kv_get(self, key: bytes, namespace: bytes = b"") -> Optional[bytes]:
        rep = pb.KvGetReply()
        rep.ParseFromString(self._call(
            pb.KV_GET, pb.KvGetRequest(ns=namespace, key=key)))
        return rep.value if rep.found else None

    def kv_del(self, key: bytes, namespace: bytes = b"") -> bool:
        rep = pb.KvDelReply()
        rep.ParseFromString(self._call(
            pb.KV_DEL, pb.KvDelRequest(ns=namespace, key=key)))
        return rep.deleted

    def kv_keys(self, prefix: bytes = b"", namespace: bytes = b"") -> List[bytes]:
        rep = pb.KvKeysReply()
        rep.ParseFromString(self._call(
            pb.KV_KEYS, pb.KvKeysRequest(ns=namespace, prefix=prefix)))
        return list(rep.keys)

    # ---------------------------------------------------------------- pubsub

    def subscribe(self, channels: List[str],
                  handler: Callable[[pb.Event], None]):
        """Register a handler for pushed events on the given channels."""
        with self._handlers_lock:
            for ch in channels:
                self._handlers.setdefault(ch, []).append(handler)
        with self._sub_lock:
            for ch in channels:
                if ch not in self._sub_channels:
                    self._sub_channels.append(ch)
            self._ensure_subscribed_locked()
            if self._sub_client is None:
                # one immediate retry: the dead connection may predate a
                # completed state-service restart
                self._ensure_subscribed_locked()
            if self._sub_client is None:
                raise RpcConnectionError(
                    f"subscribe to {self.address} failed (service "
                    f"unreachable); channels are recorded and will "
                    f"resubscribe on the next reconnect")

    def _on_push(self, env: pb.Envelope):
        if env.method != pb.PUBLISH:
            return
        ev = pb.Event()
        ev.ParseFromString(env.body)
        with self._handlers_lock:
            handlers = list(self._handlers.get(ev.channel, []))
        for h in handlers:
            try:
                h(ev)
            except Exception:
                logger.exception("pubsub handler failed for %s", ev.channel)

    def publish(self, channel: str, kind: str, payload: bytes = b""):
        self._call(pb.PUBLISH, pb.PublishRequest(
            event=pb.Event(channel=channel, kind=kind, payload=payload)))

    # ------------------------------------------------------ object directory

    @staticmethod
    def _batching_on() -> bool:
        return _config.get("state_batch_flush_ms") > 0

    def add_location(self, object_id: bytes, node_id: bytes, size: int = 0):
        req = pb.ObjectLocRequest(object_id=object_id, node_id=node_id,
                                  size=size)
        if self._batching_on():
            self._batcher.enqueue(pb.ADD_LOCATION, req.SerializeToString())
        else:
            self._call(pb.ADD_LOCATION, req)

    def remove_location(self, object_id: bytes, node_id: bytes):
        # Routed through the SAME queue as add_location: an UPDATE→REMOVE
        # pair for one object must reach the service in order.
        req = pb.ObjectLocRequest(object_id=object_id, node_id=node_id)
        if self._batching_on():
            self._batcher.enqueue(pb.REMOVE_LOCATION,
                                  req.SerializeToString())
        else:
            self._call(pb.REMOVE_LOCATION, req)

    def flush_locations(self, timeout: float = 10.0) -> bool:
        """Barrier: directory ops enqueued before this call are applied
        (or dropped after a failed retry) when it returns True."""
        return self._batcher.flush(timeout=timeout)

    def get_locations(self, object_id: bytes) -> pb.GetLocationsReply:
        if self._batching_on():
            # Read-your-writes: a pull right after a task completes must
            # see the completion's batched add_location.
            self._batcher.flush(timeout=5.0)
        rep = pb.GetLocationsReply()
        rep.ParseFromString(self._call(
            pb.GET_LOCATIONS, pb.GetLocationsRequest(object_id=object_id)))
        return rep

    # ---------------------------------------------------------------- actors

    def register_actor(self, info: pb.ActorInfo):
        self._call(pb.REGISTER_ACTOR, pb.RegisterActorRequest(info=info))

    def update_actor(self, info: pb.ActorInfo):
        self._call(pb.UPDATE_ACTOR, pb.RegisterActorRequest(info=info))

    def get_actor(self, actor_id: bytes) -> Optional[pb.ActorInfo]:
        rep = pb.ActorReply()
        rep.ParseFromString(self._call(
            pb.GET_ACTOR, pb.GetActorRequest(actor_id=actor_id)))
        return rep.info if rep.found else None

    def get_named_actor(self, name: str,
                        namespace: str = "default") -> Optional[pb.ActorInfo]:
        rep = pb.ActorReply()
        rep.ParseFromString(self._call(pb.GET_NAMED_ACTOR, pb.GetNamedActorRequest(
            name=name, namespace=namespace)))
        return rep.info if rep.found else None

    def list_actors(self) -> List[pb.ActorInfo]:
        rep = pb.ListActorsReply()
        rep.ParseFromString(self._call(pb.LIST_ACTORS))
        return list(rep.actors)

    # ------------------------------------------------------------- pgs, jobs

    def register_pg(self, info: pb.PgInfo):
        self._call(pb.REGISTER_PG, pb.RegisterPgRequest(info=info))

    def update_pg(self, info: pb.PgInfo):
        self._call(pb.UPDATE_PG, pb.RegisterPgRequest(info=info))

    def remove_pg(self, pg_id: bytes):
        self._call(pb.REMOVE_PG, pb.RemovePgRequest(pg_id=pg_id))

    def list_pgs(self) -> List[pb.PgInfo]:
        rep = pb.ListPgsReply()
        rep.ParseFromString(self._call(pb.LIST_PGS))
        return list(rep.pgs)

    def register_job(self, info: pb.JobInfo):
        self._call(pb.REGISTER_JOB, pb.RegisterJobRequest(info=info))

    def list_jobs(self) -> List[pb.JobInfo]:
        rep = pb.ListJobsReply()
        rep.ParseFromString(self._call(pb.LIST_JOBS))
        return list(rep.jobs)
