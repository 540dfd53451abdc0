"""The multi-process distributed runtime.

Every process in a cluster — drivers and host daemons alike — runs
one ``DistributedRuntime``: a ``Runtime`` (the local execution engine:
thread-pool workers, object store, actor mailboxes) extended with the
cross-process layer the reference spreads over core_worker + raylet +
object_manager:

- **Submitter** (``CoreWorkerDirectTaskSubmitter`` role,
  ``src/ray/core_worker/transport/direct_task_transport.cc:365-534``):
  scheduling policies run submitter-side over a heartbeat-refreshed view of
  the cluster; the chosen daemon admits or answers SPILLBACK with its live
  availability, which updates the view and reschedules — the reference's
  spillback semantics without a central lease bottleneck.
- **Executor** (raylet + worker roles): a PUSH_TASK/ACTOR_CALL handler that
  admits against local resources, runs the task in the local engine, and
  replies on completion — the reply IS the completion notification, with
  small results inlined (the reference's in-band small returns,
  ``_raylet.pyx`` SealReturnObject) and large ones kept in the executing
  store with their location published to the object directory.
- **Object plane** (``object_manager.h:114``, ``pull_manager.h:47``):
  ``get_object`` resolves local store → in-flight future → owner address →
  object directory, then pulls the value in chunks over FETCH_OBJECT.
- **Borrowing refcount** (``reference_count.h:61``): serializing a ref emits
  a marker carrying (object, owner address, sender address); deserializing
  registers a borrow with the owner synchronously and releases the sender's
  serialize-time pin; the owner frees only when local refs + pins + borrows
  all reach zero, and drops borrows from processes that die.
- **Failure handling**: state-service heartbeats detect dead nodes
  (``gcs_heartbeat_manager.h:36``); in-flight pushes to a dead daemon fail
  over to resubmission (tasks retry per ``max_retries``, actors restart per
  ``max_restarts`` on surviving nodes), and lost objects reconstruct from
  lineage at their submitter.

GPU stance: the daemon is the device-owner process (it holds one CUDA
context over the cards its ``CUDA_VISIBLE_DEVICES`` names), so "worker
pool" remains threads inside it, and a GPU grant maps to the daemon's own
visible cards (``Runtime._assign_devices``: the first n, as in-process).
Only control messages and host bytes ride these sockets: a tensor that
leaves the process travels as dtype, shape and host bytes
(``framing.TensorPickler``; the version and CUDA-event rules of the object
store hold before its device-to-host copy) and lands on the receiver's
default device. CUDA IPC within a host is later speed work.
"""

from __future__ import annotations

import hashlib
import io
import json
from concurrent import futures
import logging
import os
import pickle
import queue
import struct as _struct
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle
import torch

from ray_tpu_torch import chaos, observability
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.observability import goodput, perf
from ray_tpu_torch._private import clocksync
from ray_tpu_torch._private.backoff import BackoffPolicy, BreakerBoard
from ray_tpu_torch._private.config import _config
from ray_tpu_torch._private.framing import (FRAME_MAGIC as _FRAME_MAGIC,
                                      FramedPayload, TensorPickler,
                                      dumps as _dumps_value, dumps_framed,
                                      loads_framed)
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID,
                                  PlacementGroupID, TaskID)
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.rpc import (ConnectionPool, RpcClient,
                                  RpcConnectionError, RpcContext,
                                  RpcRemoteError, RpcServer)
from ray_tpu_torch._private.runtime import (ActorState, Node, Runtime,
                                      task_context, _ref_ids_in)
from ray_tpu_torch._private.scheduler import Infeasible, NodeState
from ray_tpu_torch._private.state_client import StateClient
from ray_tpu_torch._private.task_spec import TaskOptions, TaskSpec
from ray_tpu_torch._private import transport
from ray_tpu_torch.protocol import pb
from ray_tpu_torch.util import metrics as _metrics

# raylint: hot-path  (bulk-transfer module: R8 flags hidden payload copies)

logger = logging.getLogger("ray_tpu")

INLINE_RESULT_MAX = 256 * 1024  # results below this ride in the reply
# First fetch request asks for at most this much: it exists to reveal
# total_size (and catch small objects in one round trip) — a full chunk
# here would be copied into the striped destination afterwards.
_FETCH_PROBE_BYTES = 256 * 1024
FN_NS = b"fun"  # KV namespace of the function table
NAMED_FN_NS = b"namedfn"  # cross-language named-function registry

# Framed-serialization helpers live in framing.py (single owner of the
# RTF5 layout); the old local names remain as aliases for callers/tests.
_dumps_framed = dumps_framed
_loads_framed = loads_framed


_breaker_counter_m = None


def _breaker_transitions():
    # Lazy singleton: metric objects are created at first use, not at
    # import (the registry may be cleared between tests).
    global _breaker_counter_m
    if _breaker_counter_m is None:
        _breaker_counter_m = _metrics.Counter(
            "circuit_breaker_transitions_total",
            "circuit-breaker state transitions by peer",
            tag_keys=("peer", "to"))
    return _breaker_counter_m


def _fn_key(payload: bytes) -> bytes:
    return hashlib.sha256(payload).digest()


# Pre-pickled constants for the task-push hot loop: the no-arg call shape
# and retry_exceptions=True are by far the commonest options, and pickling
# them fresh per push showed up in submission profiles.
_EMPTY_ARGS_PICKLE = cloudpickle.dumps(((), {}))
_RETRY_ALL_PICKLE = cloudpickle.dumps(True)


class _PgBundleKey:
    """Duck-typed stand-in for a PlacementGroup handle on the daemon side:
    `_allocation_target` only needs `.id`."""

    def __init__(self, pg_id: PlacementGroupID):
        self.id = pg_id


class _RemoteActorRecord:
    """Driver-side record of an actor hosted on another daemon. Duck-types
    the pieces of ActorState that ActorHandle paths touch."""

    def __init__(self, actor_id: ActorID, cls_name: str, address: str,
                 node_id: bytes, options, name: str, namespace: str,
                 spec_msg: Optional[pb.ActorSpecMsg] = None):
        self.actor_id = actor_id
        self.cls_name = cls_name
        self.address = address
        self.node_id = node_id
        self.options = options
        self.name = name
        self.namespace = namespace
        self.spec_msg = spec_msg  # for restarts (creator only)
        self.status = "ALIVE"
        self.restart_count = 0
        self.death_cause: Optional[BaseException] = None
        # RLock: a connection failure during a push made under this lock
        # settles synchronously and re-enters via _handle_remote_actor_death.
        self.lock = threading.RLock()

    @property
    def cls(self):
        return type(self.cls_name, (), {"__name__": self.cls_name})


def _deserialize_dist_ref(id_bytes: bytes, owner_addr: str,
                          sender_addr: str, managed: bool = False):
    """Unpickle hook for cross-process refs: register a borrow with the
    owner, bind locally. ``managed`` markers were produced by a task push;
    their serialize-time pin is released by the PUSHER when the attempt
    settles (so a receiver dying mid-deserialize cannot leak the pin);
    unmanaged markers release it here via RELEASE_PIN."""
    from ray_tpu_torch._private import worker as _worker
    from ray_tpu_torch.object_ref import ObjectRef
    oid = ObjectID(id_bytes)
    runtime = _worker.try_global_runtime()
    if isinstance(runtime, DistributedRuntime):
        runtime.register_incoming_ref(oid, owner_addr, sender_addr, managed)
    return ObjectRef(oid, owner=runtime)


class DistributedRuntime(Runtime):
    def __init__(self, state_addr: str, resources: ResourceSet,
                 job_id: Optional[JobID] = None, is_driver: bool = True,
                 listen_host: str = "127.0.0.1",
                 labels: Optional[dict] = None,
                 heartbeat_interval_s: float = 1.0,
                 view_refresh_s: float = 0.5,
                 namespace: str = "default"):
        # Before super().__init__: the base constructor starts the
        # dispatcher thread, whose pass-end hook reads these.
        self._push_batch: Dict[str, list] = {}  # raylint: guarded-by(self._push_batch_lock)
        self._push_batch_lock = threading.Lock()
        # Linger flusher for task-push batches: dispatch hooks only STAMP a
        # deadline; this thread ships the accumulated frame when it expires,
        # so a burst of submissions (inline path included) coalesces into
        # one frame per daemon instead of one per task.
        self._push_flush_cv = threading.Condition()
        self._push_flush_due: Optional[float] = None
        self._push_flusher: Optional[threading.Thread] = None
        super().__init__(job_id=job_id)
        self.is_driver = is_driver
        self.namespace = namespace
        self.state = StateClient(state_addr)
        self.state_addr = state_addr
        self.pool = ConnectionPool()
        self._hb_interval = heartbeat_interval_s
        self._view_refresh = view_refresh_s

        # Local execution node.
        self.local_node: Node = self.add_node(resources, labels=labels)

        # RPC server for peers. Enqueue-style methods run inline on the
        # reader thread so per-caller ordering holds (actor calls must hit
        # the mailbox in submission order).
        self.server = RpcServer(
            self._handle_rpc, host=listen_host, max_workers=256,
            inline_methods={pb.PUSH_TASK, pb.PUSH_TASK_BATCH,
                            pb.ACTOR_CALL, pb.ADD_BORROW,
                            pb.REMOVE_BORROW, pb.RELEASE_PIN, pb.PING,
                            pb.CANCEL_TASK, pb.RESERVE_BUNDLE,
                            pb.FREE_BUNDLE, pb.FREE_OBJECT},
            sock_buf_bytes=transport.data_sock_buf())
        self.address = self.server.address
        # Raw data connections for chunk striping (separate from `pool`,
        # whose one connection per peer is the multiplexed control lane).
        # The pool — and every bulk-bytes socket — lives in transport.py.
        self._data_streams = transport._DataStreamPool()

        # Cluster view: node_id bytes -> (pb.NodeInfo, NodeResources view).
        self._states_memo = None  # (monotonic_ts, [NodeState]) micro-TTL
        # Autoscaler hazard hints (node_id bytes): last-choice placement
        # for nodes the preemption estimator expects to drain soon.
        self._pending_drain_hints: frozenset = frozenset()
        self._view_lock = threading.Lock()
        self._view: Dict[bytes, pb.NodeInfo] = {}  # raylint: guarded-by(self._view_lock)
        self._view_avail: Dict[bytes, NodeResources] = {}  # raylint: guarded-by(self._view_lock)
        self._addr_by_node: Dict[bytes, str] = {}  # raylint: guarded-by(self._view_lock)

        # Ownership / borrow bookkeeping.
        self._owner_addr: Dict[ObjectID, str] = {}  # oid -> owner address
        self._location_hints: Dict[ObjectID, str] = {}  # oid -> fetch addr

        # Remote submission bookkeeping. In-flight pushes are keyed by
        # (task_id, attempt) so a late reply or failure signal for a
        # superseded attempt can never be confused with the current one
        # (the reference keys TaskManager bookkeeping by attempt_number,
        # task_manager.h:152).
        self._exported_fns: Dict[bytes, bytes] = {}  # hash -> payload
        self._fn_key_by_identity = weakref.WeakKeyDictionary()
        self._fn_cache: Dict[bytes, Any] = {}  # hash -> callable/class
        self._inflight_lock = threading.Lock()
        self._inflight_remote: Dict[Tuple[TaskID, int], dict] = {}  # raylint: guarded-by(self._inflight_lock)
        # Reverse index return-oid -> inflight info: get() probes this per
        # poll, and a linear scan over all in-flight pushes is O(n^2)
        # across a driver gathering n results.
        self._inflight_by_return: Dict[ObjectID, dict] = {}  # raylint: guarded-by(self._inflight_lock)
        self._completed_returns: set = set()  # return oids known done
        # Bulk p2p mailbox: (group, src, dst, seq) -> (dtype, shape,
        # bytes). Fed by P2P_DATA frames (tensor in the raw lane),
        # drained by XLAProcessGroup.recv.
        self._p2p_box: Dict[tuple, tuple] = {}  # raylint: guarded-by(self._p2p_cv)
        self._p2p_cv = threading.Condition()
        # Nodes whose death we already processed (signals arrive from both
        # the pubsub push and the view refresh; handling must be idempotent).
        self._dead_handled: set = set()  # raylint: guarded-by(self._view_lock)
        self._infeasible_grace_s = 10.0  # view may trail a joining node
        # Serialize-time pins created while building a task-push message are
        # collected here (thread-local) and released when the push attempt
        # settles — never left to the receiving process, whose death must
        # not leak them.
        self._pin_collect = threading.local()
        import itertools
        self._pin_seq = itertools.count()
        self._pin_heap: list = []
        self._pin_reaper = None
        self._pin_reaper_cv = threading.Condition()
        # One reply per task completion, shared by duplicate-push hooks
        # (rebuilding would race the first build's inline store.free).
        self._reply_bytes_cache: Dict[TaskID, bytes] = {}  # raylint: guarded-by(self.lock)

        # Remote actors this process created or uses.
        self.remote_actors: Dict[ActorID, _RemoteActorRecord] = {}
        self._dir_probe_at: Dict[ObjectID, float] = {}
        self._fetch_cache: Dict[ObjectID, bytes] = {}  # raylint: guarded-by(self._fetch_cache_lock)
        self._fetch_cache_lock = threading.Lock()
        # Addresses with recent connection failures are excluded from
        # selection until the deadline passes or the heartbeat sweep
        # settles their fate (the submitter-side analogue of the lease
        # policy avoiding known-bad raylets).
        self._suspect_addrs: Dict[str, float] = {}  # raylint: guarded-by(self._view_lock)
        # Per-peer circuit breakers: after circuit_failure_threshold
        # consecutive transport failures a peer's breaker OPENs, optional
        # traffic (object pushes) to it is shed immediately instead of
        # timing out, and the address is marked suspect for scheduling
        # until a half-open probe succeeds.
        self.breakers = BreakerBoard(on_open=self._on_breaker_open)
        # Control-plane health, dashboard-visible (not just log warnings).
        self.heartbeat_misses = 0          # consecutive failed beats
        self.heartbeat_last_success = 0.0  # epoch seconds of last ack
        node_tag = self.local_node.node_id.hex()[:8]
        if not is_driver:
            # obs spans recorded in this daemon (rpc dispatch, fetches,
            # checkpoint stages) group under the node's timeline row
            observability.set_process_label(f"node:{node_tag}")
        # Flight-recorder state provider: every spool tick carries this
        # runtime's identity + heartbeat health, so a sealed bundle shows
        # whether the control plane was already degraded before death.
        from ray_tpu_torch.observability import recorder as _flight
        _flight.register_state_provider(self._flight_state)
        self._hb_miss_gauge = _metrics.Gauge(
            "heartbeat_consecutive_misses",
            "consecutive failed heartbeats to the state service",
            tag_keys=("node",)).set_default_tags({"node": node_tag})
        self._hb_success_gauge = _metrics.Gauge(
            "heartbeat_last_success_timestamp",
            "epoch seconds of the last acknowledged heartbeat",
            tag_keys=("node",)).set_default_tags({"node": node_tag})
        self._breaker_gauge = _metrics.Gauge(
            "peer_breaker_state",
            "per-peer circuit breaker state (0=closed 1=half-open 2=open)",
            tag_keys=("peer",))
        # Node lifecycle: ALIVE -> DRAINING -> DRAINED/DEAD. begin_drain()
        # is the single entry point (DRAIN rpc, NODE_DRAINING pubsub,
        # heartbeat-ack signal, preemption watcher) and is idempotent.
        self._drain_lock = threading.Lock()
        self._drain_started = False
        self._drain_progress: Dict[str, Any] = {}
        self._node_state_gauge = _metrics.Gauge(
            "node_state",
            "node lifecycle state (0=alive 1=draining 2=drained)",
            tag_keys=("node",)).set_default_tags({"node": node_tag})
        self._node_state_gauge.set(0)
        self._drain_migrated_gauge = _metrics.Gauge(
            "drain_objects_migrated",
            "sole-copy objects re-replicated to healthy peers during drain",
            tag_keys=("node",)).set_default_tags({"node": node_tag})

        # Borrow-protocol messages (ADD_BORROW / RELEASE_PIN /
        # REMOVE_BORROW) run on one FIFO worker PER PEER so registration
        # never blocks the unpickle path, a REMOVE can never overtake its
        # ADD (both target the owner), and one slow peer cannot
        # head-of-line-block traffic to the others.
        self._borrow_qs: Dict[str, "queue.Queue"] = {}  # raylint: guarded-by(self._borrow_q_lock)
        self._borrow_q_lock = threading.Lock()
        self._borrow_registered: set = set()

        # Placement retry loops park here instead of fixed-interval
        # sleeping; _kick (task completion, resource release, view change)
        # wakes them immediately.
        self._placement_cv = threading.Condition()

        # Host-shared object plane: the first daemon on a host owns one shm
        # arena (memfd) and serves it over a UDS; same-host peers map the
        # SAME pages via fd-passing, so a local "transfer" is a shared-
        # memory read, not a TCP stream (reference: plasma store socket,
        # src/ray/object_manager/plasma/store.h).
        self.host_arena = None
        self.host_arena_key = ""
        self._arena_is_owner = False
        if _config.get("arena_enabled"):
            try:
                self._setup_host_arena(is_driver)
            except Exception as e:  # degrade to TCP pulls
                logger.debug("host arena unavailable: %s", e)
        # Proactive pushes of large task args to the executing daemon
        # (reference: push_manager.h), window-limited per peer.
        self._push_mgr = _PushManager(self)
        # In-flight incoming pushes: oid -> [store recv-buffer view,
        # bytes filled]. The view is the object's final resting place.
        self._incoming_pushes: Dict[ObjectID, list] = {}  # raylint: guarded-by(self._incoming_pushes_lock)
        self._incoming_push_seen: Dict[ObjectID, float] = {}  # raylint: guarded-by(self._incoming_pushes_lock)
        self._incoming_pushes_lock = threading.Lock()

        # OOM guard: executors shed admissions above the host/cgroup
        # memory threshold (memory_monitor.h role; drivers don't admit
        # pushed work, so they don't pay the sampler).
        self.memory_monitor = None
        if not is_driver:
            try:
                from ray_tpu_torch._private.memory_monitor import MemoryMonitor
                self.memory_monitor = MemoryMonitor()
                self.memory_monitor.start()
            except Exception:
                logger.debug("memory monitor unavailable", exc_info=True)

        # Register with the state service last: peers push tasks here as
        # soon as the node is listed, so every handler's state must exist.
        info = pb.NodeInfo(node_id=self.local_node.node_id.binary(),
                           address=self.address, is_head=is_driver)
        for k, v in self.local_node.resources.total.to_dict().items():
            info.total.amounts[k] = v
            info.available.amounts[k] = v
        for k, v in (labels or {}).items():
            info.labels[k] = str(v)
        self.state.register_node(info)
        if is_driver:
            self.state.register_job(pb.JobInfo(
                job_id=self.job_id.binary(), driver_address=self.address,
                state="RUNNING", start_ms=time.time() * 1e3))

        # Pubsub: node lifecycle.
        self.state.subscribe(["nodes"], self._on_node_event)
        self._refresh_view()

        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True, name="dist-heartbeat")
        self._hb_thread.start()
        self._view_thread = threading.Thread(target=self._view_loop,
                                             daemon=True, name="dist-view")
        self._view_thread.start()

    def _kick(self):
        super()._kick()
        cv = getattr(self, "_placement_cv", None)  # base init kicks early
        if cv is not None:
            with cv:
                cv.notify_all()

    def _placement_wait(self, timeout: float = 0.05):
        """Event-driven pause for placement retry loops: wakes on the next
        _kick (completion/release/view change), with ``timeout`` as the
        fallback so no wakeup is ever lost."""
        with self._placement_cv:
            self._placement_cv.wait(timeout=timeout)

    # ----------------------------------------------------- host arena plane

    def _setup_host_arena(self, is_driver: bool, _retry: bool = True):
        """Own or join this host's shared arena, brokered through the
        state-service KV (namespace ``arena``, key = machine id). Daemons
        race to own (CAS put); losers and drivers connect as clients. A
        stale entry (owner crashed, socket dead) is repaired: the joiner
        deletes it and re-runs the race so a healthy daemon can take over."""
        from ray_tpu_torch._native import NativeObjectStore, NativeStoreClient
        if not NativeObjectStore.available():
            return
        host_key = self._machine_id().encode()
        ns = b"arena"
        if not is_driver:
            path = os.path.join(
                tempfile.gettempdir(),
                f"ray_tpu_arena_{os.getpid()}_"
                f"{abs(hash(self.address)) % 100000}.sock")
            # Bind the socket BEFORE claiming the hostname: the KV entry
            # must never point at a not-yet-listening socket, or a racing
            # joiner would mistake the healthy owner-to-be for a dead one,
            # delete the claim, and usurp it (two arenas on one host).
            cap = _config.get("arena_capacity_mb") * (1 << 20)
            store = NativeObjectStore(cap)
            if store.serve(path) and self.state.kv_put(
                    host_key, path.encode(), overwrite=False, namespace=ns):
                self.host_arena = store  # raylint: allow(data-race) set once during __init__ before the runtime is shared
                self.host_arena_key = path  # raylint: allow(data-race) set once during __init__ before the runtime is shared
                self._arena_is_owner = True
                self._arena_host_key = host_key  # raylint: allow(data-race) set once during __init__ before the runtime is shared
                logger.debug("serving host arena at %s (%d MB)", path,
                             cap >> 20)
                return
            # lost the race (or no shared backing): release our arena and
            # fall through to join the winner's
            del store
            try:
                os.unlink(path)
            except OSError:
                pass
        existing = self.state.kv_get(host_key, namespace=ns)
        if existing:
            try:
                self.host_arena = NativeStoreClient(existing.decode())  # raylint: allow(data-race) set once during __init__ before the runtime is shared
                self.host_arena_key = existing.decode()  # raylint: allow(data-race) set once during __init__ before the runtime is shared
                logger.debug("joined host arena at %s", self.host_arena_key)
            except Exception:
                self.host_arena = None  # raylint: allow(data-race) set once during __init__ before the runtime is shared
                if not self._arena_owner_dead(existing.decode()):
                    # The claimed owner still looks alive: the connect
                    # failure is transient (or a cross-container /tmp).
                    # Deleting a healthy owner's claim would thrash
                    # ownership, so keep it and fall back to TCP — loudly.
                    logger.warning(
                        "host arena at %s unreachable but its owner "
                        "appears alive; falling back to TCP object "
                        "transfer", existing.decode())
                    return
                # stale entry from a dead owner: clear it and re-race once
                # (a daemon may now win ownership; a driver re-joins)
                try:
                    self.state.kv_del(host_key, namespace=ns)
                except Exception as e:
                    logger.debug("arena host-key cleanup failed: %s", e)
                    return
                if _retry:
                    self._setup_host_arena(is_driver, _retry=False)

    @staticmethod
    def _machine_id() -> str:
        """Arena claim key, unique per "set of processes that can share an
        arena socket": hostname alone collides across containers/pods that
        clone hostnames, and a cross-machine joiner must never usurp a
        healthy owner's claim. boot_id disambiguates
        machines; the temporary directory's (dev, inode) disambiguates
        same-kernel containers with isolated ones — those cannot reach each other's
        sockets, so each must run its own arena under its own key."""
        import socket as _socket
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                boot = f.read().strip()
        except OSError:
            boot = ""
        try:
            st = os.stat(tempfile.gettempdir())
            tmp_id = f"{st.st_dev}:{st.st_ino}"
        except OSError:
            tmp_id = ""
        return f"{_socket.gethostname()}|{boot}|{tmp_id}"

    @staticmethod
    def _arena_owner_dead(path: str) -> bool:
        """Is the claimed arena owner verifiably dead? The signal is a
        fresh connect to the claimed socket — a listener means a live
        owner (whatever made the join fail was past accept), and
        ENOENT/ECONNREFUSED mean no listener, i.e. a dead owner. This is
        immune to pid recycling AND to pid namespaces (a same-/tmp
        joiner in another pid namespace cannot see the owner's pid, so a
        pid probe would misjudge a healthy owner). Anything ambiguous
        (e.g. connect timeout under load) counts as alive: a dead
        owner's socket refuses instantly on the next attempt, while a
        wrongly-deleted healthy claim causes ownership thrash."""
        import socket as _socket
        s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        s.settimeout(1.0)
        try:
            s.connect(path)
            return False
        except (FileNotFoundError, ConnectionRefusedError):
            return True
        except OSError:
            return False
        finally:
            s.close()

    @staticmethod
    def _arena_payload_key(oid: ObjectID, payload) -> bytes:
        """Content-bound arena key: a reconstructed object whose bytes
        differ (e.g. a recomputed result embedding a fresh pid) must NOT
        alias the stale entry of its predecessor."""
        h = hashlib.blake2b(digest_size=16)
        h.update(oid.binary())
        ph = hashlib.blake2b(digest_size=16)
        if isinstance(payload, FramedPayload):
            # pieces cover [0, len) in order: hashing them sequentially
            # IS hashing the materialized frame
            for p in payload.pieces:
                ph.update(p)
        else:
            ph.update(payload)
        h.update(ph.digest())
        return h.digest()

    def _arena_put(self, key: bytes, payload) -> bool:
        """Best-effort drop of a serialized payload into the shared arena.
        The owner evicts LRU (sealed, unpinned) entries to make room; a
        client simply gives up on full (it cannot evict others' objects).
        ``payload`` is contiguous bytes or a ``FramedPayload`` (scatter-
        written into the arena slot without materializing the frame)."""
        arena = self.host_arena
        if arena is None:
            return False

        def _write():
            if isinstance(payload, FramedPayload):
                return arena.put_pieces(key, payload.pieces, len(payload))
            return arena.put(key, payload)

        try:
            return _write()
        except MemoryError:
            if not self._arena_is_owner:
                return False
            try:
                for victim in arena.evict_candidates(len(payload)):
                    arena.delete(victim)
                return _write()
            except MemoryError:
                return False
        except Exception as e:
            logger.debug("arena store failed: %s", e)
            return False

    def _arena_load(self, key: bytes):
        """Zero-copy read of a framed payload from the shared arena: the
        deserialized arrays are backed directly by the pinned arena pages;
        the pin is released when the last such array is collected (plasma
        client-pin semantics). Returns ``_FETCH_MISS`` when absent."""
        arena = self.host_arena
        if arena is None:
            return _FETCH_MISS
        try:
            view = arena.get(key)  # pins server-side
        except Exception as e:
            logger.debug("arena get failed: %s", e)
            return _FETCH_MISS
        if view is None:
            return _FETCH_MISS
        try:
            value, zero_copy = _loads_framed(view)
        except Exception as e:
            logger.debug("arena payload deserialization failed: %s", e)
            _release_arena_pin(arena, key)
            return _FETCH_MISS
        if zero_copy:
            try:
                # exporter of the view: collected only once every backed
                # array is gone — exactly when the pin may drop
                weakref.finalize(view.obj, _release_arena_pin, arena, key)
            except TypeError:
                pass  # not weakrefable: stay pinned (safe, never corrupt)
        else:
            _release_arena_pin(arena, key)
        return value

    # ------------------------------------------------------------- lifecycle

    def _heartbeat_loop(self):
        # Misses push the NEXT beat out by a jittered backoff on top of the
        # interval: a down state service is probed gently instead of being
        # hammered at full heartbeat rate by every node at once.
        miss_policy = BackoffPolicy(base_s=self._hb_interval,
                                    max_s=max(4 * self._hb_interval, 5.0),
                                    deadline_s=0)
        node_tag = self.local_node.node_id.hex()[:8]
        if not self.is_driver:
            # obs spans recorded in this daemon (rpc dispatch, fetches,
            # checkpoint stages) group under the node's timeline row
            observability.set_process_label(f"node:{node_tag}")
        while not self._hb_stop.wait(self._hb_interval):
            try:
                if chaos.ENABLED and chaos.inject(
                        "state.heartbeat", node=node_tag) == "drop":
                    raise RpcConnectionError("chaos: heartbeat dropped")
                # Explicit zeros for exhausted resources: ResourceSet
                # arithmetic drops zero entries, and an empty availability
                # map reads as "no update" at the state service — a fully
                # busy node would advertise full capacity forever.
                total = self.local_node.resources.total.to_dict()
                now = self.local_node.resources.available.to_dict()
                avail = {k: now.get(k, 0.0) for k in total}
                hb_send = time.time()
                hb = self.state.heartbeat_ex(
                    self.local_node.node_id.binary(), avail)
                if clocksync.ENABLED and hb.server_time_ms:
                    # NTP-style offset sample rides every ack; the
                    # estimator keeps the lowest-RTT one in its window.
                    clocksync.observe(hb_send, time.time(),
                                      hb.server_time_ms / 1e3)
                recognized = hb.recognized
                if recognized and hb.node_state == "DRAINING":
                    # Belt-and-braces drain delivery: the signal rides the
                    # heartbeat ack so a lost NODE_DRAINING pubsub push
                    # cannot strand a node in ALIVE while the scheduler
                    # already shuns it.
                    self.begin_drain(hb.drain_reason or "state service",
                                     deadline_ms=hb.drain_deadline_ms)
                if not recognized:
                    # State service restarted: re-register + re-publish our
                    # object locations (raylet-notify-GCS-restart analogue).
                    info = pb.NodeInfo(
                        node_id=self.local_node.node_id.binary(),
                        address=self.address, is_head=self.is_driver)
                    for k, v in self.local_node.resources.total.to_dict().items():
                        info.total.amounts[k] = v
                    for k, v in avail.items():
                        info.available.amounts[k] = v
                    self.state.register_node(info)
                    for oid in list(self.local_node.store.object_ids()):
                        try:
                            self.state.add_location(
                                oid.binary(), self.local_node.node_id.binary())
                        except Exception as e:
                            logger.debug("location re-publish failed: %s", e)
                            break
                self.heartbeat_misses = 0  # raylint: allow(data-race) single-writer heartbeat thread; debug reads are GIL-atomic snapshots
                self.heartbeat_last_success = time.time()  # raylint: allow(data-race) single-writer heartbeat thread; debug reads are GIL-atomic snapshots
                self._hb_miss_gauge.set(0)
                self._hb_success_gauge.set(self.heartbeat_last_success)
            except Exception:
                if self._hb_stop.is_set():
                    return
                self.heartbeat_misses += 1  # raylint: allow(data-race) single-writer heartbeat thread; debug reads are GIL-atomic snapshots
                self._hb_miss_gauge.set(self.heartbeat_misses)
                logger.warning("heartbeat to state service failed "
                               "(%d consecutive)", self.heartbeat_misses,
                               exc_info=True)
                extra = miss_policy.delay_for(self.heartbeat_misses - 1)
                if extra > 0 and self._hb_stop.wait(extra):
                    return
            for peer, code in self.breakers.snapshot().items():
                # raylint: allow(metrics-cardinality) one series per peer daemon, bounded by cluster size
                self._breaker_gauge.set(code, tags={"peer": peer})

    def _view_loop(self):
        while not self._hb_stop.wait(self._view_refresh):
            try:
                self._refresh_view()
            except Exception as e:
                logger.debug("cluster view refresh failed: %s", e)
                if self._hb_stop.is_set():
                    return

    def _refresh_view(self):
        nodes = self.state.list_nodes()
        my_id = self.local_node.node_id.binary()
        died: List[pb.NodeInfo] = []
        with self._view_lock:
            seen = set()
            for info in nodes:
                if info.node_id == my_id:
                    continue
                seen.add(info.node_id)
                prev = self._view.get(info.node_id)
                if info.alive:
                    self._dead_handled.discard(info.node_id)  # re-registered
                elif (info.node_id not in self._dead_handled
                        and (prev is None or prev.alive)):
                    died.append(info)  # missed/raced pubsub: reconcile here
                self._view[info.node_id] = info
                if info.address:
                    self._addr_by_node[info.node_id] = info.address
                if info.alive:
                    nr = NodeResources(ResourceSet(dict(info.total.amounts)))
                    nr.available = ResourceSet(dict(info.available.amounts))
                    self._view_avail[info.node_id] = nr
                else:
                    self._view_avail.pop(info.node_id, None)
            for nid in list(self._view):
                if nid not in seen:
                    del self._view[nid]
                    self._view_avail.pop(nid, None)
        for info in died:
            self._handle_remote_node_death(info)
        self._kick()

    def _on_node_event(self, ev: pb.Event):
        info = pb.NodeInfo()
        info.ParseFromString(ev.payload)
        if ev.kind == "NODE_DEAD":
            self._handle_remote_node_death(info)
        elif ev.kind == "NODE_DRAINING":
            if info.node_id == self.local_node.node_id.binary():
                self.begin_drain(info.drain_reason or "state service",
                                 deadline_ms=info.drain_deadline_ms)
            else:
                # Peer is draining: flip the cached view entry NOW so the
                # next placement pass shuns it (the polled view refresh
                # would take up to a second to notice).
                with self._view_lock:
                    known = self._view.get(info.node_id)
                    if known is not None:
                        known.state = "DRAINING"
                    else:
                        self._view[info.node_id] = info
                    self._states_memo = None  # raylint: allow(data-race) immutable tuple publish; the unlocked micro-TTL read re-validates within 2ms
                self._kick()
        elif ev.kind == "NODE_ADDED":
            if info.node_id != self.local_node.node_id.binary():
                with self._view_lock:
                    self._view[info.node_id] = info
                    self._addr_by_node[info.node_id] = info.address
                    nr = NodeResources(ResourceSet(dict(info.total.amounts)))
                    self._view_avail[info.node_id] = nr
                    # A once-dead node that re-registered (state-service
                    # restart sweep) must be eligible for death handling
                    # again.
                    self._dead_handled.discard(info.node_id)
            self._kick()
        elif ev.kind == "NODE_RESOURCES":
            # ray_syncer delta: a peer's availability changed — apply it
            # NOW instead of waiting out the polling view refresh, and
            # wake the dispatcher (capacity may have freed).
            if info.node_id != self.local_node.node_id.binary():
                with self._view_lock:
                    known = self._view.get(info.node_id)
                    if known is not None and known.alive:
                        nr = self._view_avail.get(info.node_id)
                        if nr is None:
                            nr = NodeResources(
                                ResourceSet(dict(info.total.amounts)))
                            self._view_avail[info.node_id] = nr
                        nr.available = ResourceSet(
                            dict(info.available.amounts))
                self._kick()

    def _handle_remote_node_death(self, info: pb.NodeInfo):
        """The single authority for a peer's death: fail its in-flight
        pushes, restart its actors, drop its borrows and object locations.
        Reached from the NODE_DEAD pubsub push AND the periodic view
        reconciliation; runs exactly once per node."""
        nid = info.node_id
        with self._view_lock:
            if nid in self._dead_handled:
                return
            self._dead_handled.add(nid)
            # The registration-time address is authoritative; event payloads
            # on a restarted state service may lack it.
            addr = self._addr_by_node.get(nid, "") or info.address
            entry = self._view.get(nid)
            if entry is not None:
                entry.alive = False
            self._view_avail.pop(nid, None)
        if addr:
            self.pool.drop(addr)
            # Drop borrows held by the dead process.
            self.reference_counter.remove_borrower(addr)
            # Fail in-flight pushes to it (connection close usually beats
            # this, but the pubsub path covers half-open connections).
            self._fail_inflight_to(addr, f"node {info.node_id.hex()[:8]} died")
            # Restart/kill actors we own that lived there.
            with self.lock:
                remote_recs = list(self.remote_actors.values())
            for rec in remote_recs:
                if rec.address == addr and rec.status == "ALIVE":
                    self._handle_remote_actor_death(
                        rec, exc.NodeDiedError(
                            f"node hosting actor died ({addr})"))
        # Drop location hints pointing at the dead node.
        for oid, hint in list(self._location_hints.items()):
            if hint == addr:
                del self._location_hints[oid]  # raylint: allow(data-race) GIL-atomic op on best-effort location hint; stale hint costs one extra directory probe
        self.emit_event("NODE_DEAD", node_id=info.node_id.hex())
        self._kick()

    # ------------------------------------------------------------------ drain

    @property
    def draining(self) -> bool:
        return self._drain_started

    def begin_drain(self, reason: str = "", deadline_ms: float = 0.0,
                    deadline_s: Optional[float] = None) -> bool:
        """Start this node's graceful drain (idempotent; first call wins).

        Reached from every delivery path — the DRAIN rpc, the
        NODE_DRAINING pubsub push, the drain signal riding the heartbeat
        ack, and the host daemon's preemption watcher. ``deadline_ms`` is
        epoch milliseconds (the state service's absolute form);
        ``deadline_s`` is a relative budget and wins when both are given.
        Returns True when this call started the drain."""
        with self._drain_lock:
            if self._drain_started:
                return False
            self._drain_started = True
        if deadline_s is not None and deadline_s > 0:
            budget = deadline_s
        elif deadline_ms > 0:
            budget = max(0.0, deadline_ms / 1e3 - time.time())
        else:
            budget = _config.get("drain_deadline_s")
        deadline = time.monotonic() + budget
        self.local_node.draining = True  # raylint: allow(data-race) GIL-atomic bool store on the long-lived node object; readers converge next pass
        with self._view_lock:
            self._states_memo = None  # placement must see the flip NOW  # raylint: allow(data-race) immutable tuple publish; the unlocked micro-TTL read re-validates within 2ms
        self._node_state_gauge.set(1)
        if observability.ENABLED:
            observability.instant("drain:begin", cat="drain", reason=reason,
                                  budget_s=round(budget, 3))
        self.emit_event("NODE_DRAINING",
                        node_id=self.local_node.node_id.hex(), reason=reason)
        try:
            # Tell the cluster (no-op re-drain when the signal came FROM
            # the state service): peers' schedulers shun us, the doctor
            # reports progress instead of a hang.
            self.state.drain_node(self.local_node.node_id.binary(), reason,
                                  deadline_s=budget)
        except Exception as e:
            logger.debug("drain_node publish failed: %s", e)
        if "preemption notice" in reason:
            # Journal the real notice (not proactive hazard drains) so the
            # autoscaler's hazard estimator learns this node type's
            # preemption rate (autoscaler/hazard.py KV layout).
            try:
                from ray_tpu_torch.autoscaler import hazard as _hazard
                _hazard.journal_preemption(
                    self.state, self.local_node.node_id.hex(),
                    self.local_node.labels.get("autoscaler-node-type",
                                               "default"), reason)
            except Exception as e:  # noqa: BLE001
                logger.debug("preemption journal failed: %s", e)
        t = threading.Thread(target=self._drain_worker,
                             args=(reason, deadline), daemon=True,
                             name="dist-drain")
        t.start()
        return True

    def _drain_worker(self, reason: str, deadline: float):
        """The drain orchestrator: quiesce -> checkpoint actors ->
        re-replicate sole-copy objects -> decommission. Every phase is
        bounded by the drain deadline; whatever does not finish in time is
        recovered by the existing node-death machinery (resubmission,
        actor restart) — slower, but never lost."""
        try:
            self._drain_progress = {
                "node": self.local_node.node_id.hex(), "reason": reason,
                "phase": "quiesce", "tasks_pending": 0,
                "actors_checkpointed": 0, "objects_migrated": 0,
                "started": time.time(),
                "deadline": time.time() + max(0.0,
                                              deadline - time.monotonic()),
            }
            self._publish_drain_progress()
            self._drain_quiesce_tasks(deadline)
            self._drain_progress["phase"] = "actors"
            self._publish_drain_progress()
            n_actors = self._drain_checkpoint_actors(reason, deadline)
            self._drain_progress["actors_checkpointed"] = n_actors
            self._drain_progress["phase"] = "objects"
            self._publish_drain_progress()
            n_objects = self._drain_migrate_objects(deadline)
            self._drain_progress["objects_migrated"] = n_objects
            self._drain_progress["phase"] = "decommission"
            self._publish_drain_progress()
        except Exception:
            logger.exception("drain orchestrator failed; decommissioning "
                             "anyway (node-death recovery takes over)")
        try:
            self.state.mark_node_dead(self.local_node.node_id.binary(),
                                      f"drained: {reason}" if reason
                                      else "drained")
        except Exception as e:
            logger.debug("drained mark_node_dead failed: %s", e)
        self._node_state_gauge.set(2)
        if observability.ENABLED:
            observability.instant("drain:decommission", cat="drain",
                                  reason=reason)
        self._decommission(reason)

    def _drain_quiesce_tasks(self, deadline: float):
        """Let admitted work finish: new pushes are already being spilled
        back (the callers' backoff path re-routes them), so this just
        waits for the local pending queue and running tasks to empty, up
        to the deadline."""
        poll = max(0.005, _config.get("drain_poll_ms") / 1e3)
        while time.monotonic() < deadline:
            with self._pending_cv:
                pending = len(self._pending) + self._dispatch_pass_n
            with self.lock:
                running = sum(1 for s in self.task_states.values()
                              if s in ("PENDING", "RUNNING", "RESUBMITTED"))
            self._drain_progress["tasks_pending"] = pending + running
            if pending == 0 and running == 0:
                if observability.ENABLED:
                    observability.instant("drain:quiesced", cat="drain")
                return
            time.sleep(poll)
        logger.warning("drain deadline hit with work still in flight; "
                       "callers will resubmit via the node-death path")

    def _drain_checkpoint_actors(self, reason: str, deadline: float) -> int:
        """Snapshot every hosted actor through the checkpoint engine and
        leave a pointer in the state KV (namespace ``drain``): the restart
        machinery re-places the actor on a healthy node, whose
        ``_restore_drained_actor`` hook resumes it from the snapshot
        instead of re-running ``__init__``."""
        import numpy as np
        from ray_tpu_torch.checkpoint import CheckpointEngine
        count = 0
        with self.lock:
            local_actors = list(self.actors.values())
        for state in local_actors:
            if state.instance is None or state.status != ActorState.ALIVE:
                continue
            if time.monotonic() > deadline:
                logger.warning("drain deadline hit before actor %s was "
                               "checkpointed; it restarts from __init__",
                               state.cls.__name__)
                break
            try:
                prep = getattr(state.instance, "prepare_for_shutdown", None)
                if callable(prep):
                    prep()
                blob = cloudpickle.dumps(state.instance)
                root = os.path.join(_config.get("drain_checkpoint_root"),
                                    state.actor_id.hex())
                eng = CheckpointEngine(root)
                handle = eng.save(
                    {"actor_pickle": np.frombuffer(blob, dtype=np.uint8)},
                    step=int(state.restart_count))
                # the commit gets exactly the budget the drain has left;
                # a blown deadline restarts this actor from __init__
                # rather than stalling every actor behind it
                manifest = handle.result(
                    timeout=max(0.0, deadline - time.monotonic()))
                # "ts" stamps when this actor went dark: the survivor's
                # restore computes the cross-process downtime gap from it
                # (wall clock — monotonic doesn't travel between hosts;
                # the clock-skew corrector bounds the error).
                rec = json.dumps({
                    "root": root, "manifest": manifest,
                    "cls": state.cls.__name__, "reason": reason,
                    "node": self.local_node.node_id.hex(),
                    "ts": time.time()}).encode()
                self.state.kv_put(b"actor:" + state.actor_id.binary(), rec,
                                  namespace=b"drain")
                count += 1
                if observability.ENABLED:
                    observability.instant(
                        "drain:actor_checkpointed", cat="drain",
                        actor=state.cls.__name__, bytes=len(blob))
            except Exception:
                logger.exception("drain checkpoint failed for actor %s; it "
                                 "restarts from __init__",
                                 state.cls.__name__)
        return count

    def _restore_drained_actor(self, state: ActorState):
        """Runtime hook (see runtime.py _init_and_loop): a restarting
        actor whose previous host drained resumes from its snapshot —
        migration, not reconstruction."""
        key = b"actor:" + state.actor_id.binary()
        try:
            rec = self.state.kv_get(key, namespace=b"drain")
        except Exception:  # noqa: BLE001  # raylint: allow(swallow) no KV record reachable -> fresh __init__ is the documented fallback
            return None
        if rec is None:
            return None
        try:
            meta = json.loads(rec.decode())
            from ray_tpu_torch.checkpoint import load as _ckpt_load
            tree = _ckpt_load(meta["root"], meta["manifest"])
            instance = cloudpickle.loads(tree["actor_pickle"].tobytes())
            resume = getattr(instance, "resume_after_drain", None)
            if callable(resume):
                resume()  # e.g. clear a drain-rejection flag
            self.state.kv_del(key, namespace=b"drain")
            if goodput.ENABLED:
                # checkpoint-stamp -> restore-here gap: the actor's
                # preemption downtime, attributed on the survivor
                ts = float(meta.get("ts") or 0.0)
                if ts > 0.0:
                    goodput.account("restart_downtime",
                                    max(0.0, time.time() - ts))
            self.emit_event("ACTOR_DRAIN_RESTORED",
                            actor=state.cls.__name__)
            if observability.ENABLED:
                observability.instant("drain:actor_restored", cat="drain",
                                      actor=state.cls.__name__)
            return instance
        except Exception:
            logger.exception("drained-actor restore failed for %s; "
                             "constructing fresh", state.cls.__name__)
            return None

    def _drain_migrate_objects(self, deadline: float) -> int:
        """Re-replicate objects whose ONLY live copy is here to healthy
        peers over the data plane (receiver registers itself as a location
        on eof) — migration instead of lineage re-execution."""
        my_id = self.local_node.node_id.binary()
        peers: List[Tuple[bytes, str]] = []
        holders_alive = set()
        with self._view_lock:
            for nid, info in self._view.items():
                if info.alive:
                    holders_alive.add(nid)
                    if info.state != "DRAINING" and info.address:
                        peers.append((nid, info.address))
        if not peers:
            logger.warning("drain: no healthy peer to migrate objects to")
            return 0
        migrated = 0
        skipped = 0
        oids = list(self.local_node.store.object_ids())
        # Sole-copy scan stays serial (cheap KV lookups); the pushes
        # themselves — the bulk-bytes work — run concurrently, each one
        # striped over the shared transport pool to its target peer.
        to_push: List[Tuple[ObjectID, str]] = []
        for i, oid in enumerate(oids):
            if time.monotonic() > deadline:
                skipped = len(oids) - i
                break
            try:
                if self.local_node.store.peek_error(oid) is not None:
                    continue  # error markers re-raise at the caller anyway
                locs = self.state.get_locations(oid.binary())
                if any(n != my_id and n in holders_alive
                       for n in locs.node_ids):
                    continue  # another live copy exists: nothing to do
                _nid, addr = peers[i % len(peers)]
                to_push.append((oid, addr))
            except Exception as e:
                logger.warning("drain migration failed for %s: %s",
                               oid.hex()[:8], e)
        if to_push:
            acct_lock = threading.Lock()

            def _push_one(oid: ObjectID, addr: str) -> None:
                nonlocal migrated
                t0 = time.monotonic() if perf.ENABLED else 0.0
                try:
                    pushed = self._drain_push_object(oid, addr)
                    if t0:
                        perf.observe("drain.migrate",
                                     (time.monotonic() - t0) * 1e3)
                    if pushed:
                        with acct_lock:
                            migrated += 1
                            self._drain_migrated_gauge.set(migrated)
                            self._drain_progress["objects_migrated"] = \
                                migrated
                except Exception as e:
                    logger.warning("drain migration failed for %s: %s",
                                   oid.hex()[:8], e)

            with futures.ThreadPoolExecutor(
                    max_workers=min(8, len(to_push)),
                    thread_name_prefix="drain-migrate") as ex:
                fs = [ex.submit(_push_one, oid, addr)
                      for oid, addr in to_push]
                not_done = futures.wait(
                    fs, timeout=max(0.0, deadline - time.monotonic()))[1]
                if not_done:
                    skipped += sum(1 for f in not_done if f.cancel())
        if observability.ENABLED:
            observability.instant("drain:objects_migrated", cat="drain",
                                  migrated=migrated, skipped=skipped)
        if skipped:
            logger.warning("drain deadline hit with %d objects unmigrated "
                           "(lineage re-execution covers them)", skipped)
        return migrated

    def _drain_push_object(self, oid: ObjectID, addr: str) -> bool:
        """Striped full-object push over the shared transport pool (the
        receiver accepts chunks in any order and seals once every byte
        landed): the orchestrator needs the success signal for its
        zero-loss accounting, so the first chunk goes synchronously — its
        rejection means the receiver already holds a copy — and every
        remaining chunk is pushed concurrently across the peer's data
        streams instead of round-tripping one chunk at a time."""
        payload = self._serialized_for_fetch(oid)
        total = len(payload)
        client = self.pool.get(addr)
        chunk_sz = transport.fetch_chunk_bytes()

        def _push_req(offset: int) -> bytes:
            end = min(total, offset + chunk_sz)
            return pb.PushObjectRequest(
                object_id=oid.binary(), offset=offset, total_size=total,
                eof=end >= total).SerializeToString()

        first_end = min(total, chunk_sz)
        rep = pb.PushObjectReply()
        rep.ParseFromString(client.call(
            pb.PUSH_OBJECT, _push_req(0), timeout=120,
            raw=payload.slices(0, first_end)).body)
        if not rep.accepted:
            return True  # receiver already holds it: a copy exists after all
        if first_end >= total:
            return True

        class _Rejected(Exception):
            pass

        def _submit(stream, off, done_cb):
            def cb(env, error):
                if error is None:
                    try:
                        crep = pb.PushObjectReply()
                        crep.ParseFromString(env.body)
                        if not crep.accepted:
                            error = _Rejected(f"chunk at {off} rejected")
                    except Exception as e:  # noqa: BLE001
                        error = e
                done_cb(error)
            stream.call_async(
                pb.PUSH_OBJECT, _push_req(off), cb,
                raw=payload.slices(off, min(total, off + chunk_sz)))

        xfer = transport.StripedTransfer(
            self._data_streams, addr, consumer="drain.migrate",
            fallback_client=client)
        try:
            xfer.run(range(first_end, total, chunk_sz), _submit,
                     fatal=(_Rejected,))
        except _Rejected:
            # A duplicate delivery after a lost reply can land on a buffer
            # the receiver already sealed: rejection is only a failure when
            # the object did NOT make it. Ask the receiver directly.
            wrep = pb.WaitObjectReply()
            wrep.ParseFromString(client.call(
                pb.WAIT_OBJECT, pb.WaitObjectRequest(
                    object_id=oid.binary(),
                    timeout_ms=1000.0).SerializeToString(),
                timeout=30).body)
            return bool(wrep.ready)
        return True

    def _publish_drain_progress(self):
        """Doctor-visible progress record in the state KV."""
        try:
            self.state.kv_put(
                b"progress:" + self.local_node.node_id.binary(),
                json.dumps(self._drain_progress).encode(),
                namespace=b"drain")
        except Exception as e:
            logger.debug("drain progress publish failed: %s", e)

    def _decommission(self, reason: str):
        """Orderly exit: stop accepting connections, let in-flight replies
        finish, close the flight recorder as a DELIBERATE shutdown (no
        crash bundle for a planned drain), then tear the runtime down."""
        try:
            self.server.quiesce()
        except Exception as e:
            logger.debug("server quiesce failed: %s", e)
        try:
            from ray_tpu_torch.observability import recorder as _flight
            rec = _flight.get_recorder()
            if rec is not None:
                rec.close(clean=True)
        except Exception as e:
            logger.debug("recorder close failed: %s", e)
        self.shutdown()

    def shutdown(self):
        # Idempotent: the drain orchestrator's decommission and the host
        # daemon's exit path both land here.
        with self._drain_lock:
            if getattr(self, "_shutdown_done", False):
                return
            self._shutdown_done = True
        self._hb_stop.set()
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        self._push_mgr.close()
        if self.host_arena is not None:
            if self._arena_is_owner:
                # release the hostname claim so a future daemon can own a
                # fresh arena, and remove the socket file — but only if
                # the claim is still OURS (a repair may have replaced it)
                try:
                    cur = self.state.kv_get(self._arena_host_key,
                                            namespace=b"arena")
                    if cur == self.host_arena_key.encode():
                        self.state.kv_del(self._arena_host_key,
                                          namespace=b"arena")
                except Exception as e:
                    logger.debug("arena kv de-registration failed: %s", e)
                try:
                    os.unlink(self.host_arena_key)
                except OSError:
                    pass
            else:
                try:
                    # keep the mapping: zero-copy fetched values may still
                    # be referenced by the application after shutdown
                    self.host_arena.close(unmap=False)
                except Exception as e:
                    logger.debug("arena close failed: %s", e)
        with self._borrow_q_lock:
            for q in self._borrow_qs.values():
                q.put(None)
        if self.is_driver:
            try:
                self.state.register_job(pb.JobInfo(
                    job_id=self.job_id.binary(), driver_address=self.address,
                    state="FINISHED"))
            except Exception as e:
                logger.debug("job FINISHED publish failed: %s", e)
        try:
            self.state.mark_node_dead(self.local_node.node_id.binary(),
                                      "graceful shutdown")
        except Exception as e:
            logger.debug("mark_node_dead failed: %s", e)
        super().shutdown()
        with self._push_flush_cv:
            self._push_flush_cv.notify_all()  # release the linger flusher
        try:
            self._flush_push_batches()  # don't strand queued pushes
        except Exception as e:  # raylint: allow(swallow) teardown
            logger.debug("shutdown push-batch flush failed: %s", e)
        self.server.close()
        self.pool.close_all()
        self._data_streams.close_all()
        try:
            self.state.close()
        except Exception as e:
            logger.debug("state client close failed: %s", e)

    # --------------------------------------------------------- borrow plane

    def reduce_ref(self, oid: ObjectID):
        """Cross-process ref reduction: pin locally, embed owner + sender
        addresses. When serialization happens inside a task push
        (_spec_to_msg installs a collector), the pin's lifetime belongs to
        the push attempt — released at settle — and the marker says so;
        otherwise the deserializer releases it via RELEASE_PIN."""
        self.reference_counter.pin_for_task(oid)
        collector = getattr(self._pin_collect, "pins", None)
        managed = collector is not None
        if managed:
            collector.append(oid)
        owner = self._owner_addr.get(oid, self.address)
        return (_deserialize_dist_ref,
                (oid.binary(), owner, self.address, managed))

    def register_incoming_ref(self, oid: ObjectID, owner_addr: str,
                              sender_addr: str, managed: bool = False):
        """Called from the unpickle hook: record ownership synchronously,
        move the wire traffic (ADD_BORROW to the owner, RELEASE_PIN to the
        sender) onto the borrow worker so deserialization never blocks on a
        peer. FIFO ordering guarantees the owner sees our ADD_BORROW before
        any REMOVE_BORROW we might emit later. ``managed`` pins are
        released by the pusher at attempt settle, not by us."""
        if owner_addr != self.address:
            self._owner_addr[oid] = owner_addr  # raylint: allow(data-race) GIL-atomic op on best-effort owner cache; mis-resolve falls back to broadcast lookup
            self._location_hints.setdefault(oid, owner_addr)  # raylint: allow(data-race) GIL-atomic op on best-effort location hint; stale hint costs one extra directory probe
            self._borrow_enqueue("add", oid, owner_addr)
        if managed:
            return
        # Release the sender's serialize-time pin.
        if sender_addr == self.address:
            self.reference_counter.unpin_for_task(oid)
        else:
            self._borrow_enqueue("release", oid, sender_addr)

    def _peer_presumed_dead(self, addr: str) -> bool:
        """True only when the view knows the address and NO entry for it is
        alive (a restarted daemon can reuse a dead predecessor's host:port;
        any alive match wins)."""
        matched = False
        with self._view_lock:
            for nid, info in self._view.items():
                if self._addr_by_node.get(nid) == addr:
                    if info.alive:
                        return False
                    matched = True
        return matched

    def _borrow_call(self, kind: str, oid: ObjectID, peer: str,
                     method: int, body: bytes) -> bool:
        """One borrow-protocol RPC with inline retries. A dropped
        REMOVE_BORROW would pin the object at the owner forever (borrows
        gate _on_zero), a dropped ADD_BORROW lets the owner free an object
        we hold — neither may be lost to a transient failure. Gives up only
        when the peer is (presumed) dead or the backoff budget is spent:
        node-death cleanup reclaims the state on both sides then."""
        policy = BackoffPolicy(base_s=0.2, max_s=2.0, deadline_s=5.0,
                               attempt_timeout_s=10.0)
        state = policy.start()
        while True:
            if self._hb_stop.is_set() or self._peer_presumed_dead(peer):
                return False
            try:
                self.pool.get(peer).call(method, body,
                                         timeout=state.attempt_timeout())
                self.breakers.record_success(peer)
                return True
            except Exception as e:
                logger.debug("borrow %s for %s to %s failed", kind, oid,
                             peer, exc_info=True)
                self.breakers.record_failure(peer)
                if not policy.classify(e) or not state.sleep():
                    break
        logger.warning("borrow %s for %s to live peer %s kept failing",
                       kind, oid, peer)
        return False

    def _borrow_enqueue(self, kind: str, oid: ObjectID, peer: str):
        with self._borrow_q_lock:
            q = self._borrow_qs.get(peer)
            if q is None:
                q = queue.Queue()
                self._borrow_qs[peer] = q
                threading.Thread(target=self._borrow_loop, args=(q,),
                                 daemon=True,
                                 name=f"dist-borrow-{peer}").start()
        q.put((kind, oid, peer))

    def _borrow_loop(self, q: "queue.Queue"):
        while not self._hb_stop.is_set():
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is None:
                return
            kind, oid, peer = item
            if kind == "add":
                # Idempotent per borrower: the owner tracks presence, our
                # own reference counter tracks multiplicity.
                if oid not in self._borrow_registered:
                    if self._borrow_call(
                            kind, oid, peer, pb.ADD_BORROW,
                            pb.BorrowRequest(
                                object_id=oid.binary(),
                                borrower=self.address).SerializeToString()):
                        self._borrow_registered.add(oid)
            elif kind == "release":
                self._borrow_call(
                    kind, oid, peer, pb.RELEASE_PIN,
                    pb.FreeObjectRequest(
                        object_id=oid.binary()).SerializeToString())
            elif kind == "remove":
                if oid in self._borrow_registered and self._borrow_call(
                        kind, oid, peer, pb.REMOVE_BORROW,
                        pb.BorrowRequest(
                            object_id=oid.binary(),
                            borrower=self.address).SerializeToString()):
                    self._borrow_registered.discard(oid)

    def _on_ref_zero(self, oid: ObjectID):
        owner = self._owner_addr.pop(oid, None) if hasattr(  # raylint: allow(data-race) GIL-atomic op on best-effort owner cache; mis-resolve falls back to broadcast lookup
            self, "_owner_addr") else None
        if owner is not None and owner != getattr(self, "address", None):
            # We were a borrower: tell the owner, drop local cache.
            self._borrow_enqueue("remove", oid, owner)
        remote_copy = (self._location_hints.get(oid)
                       if hasattr(self, "_location_hints") else None)
        super()._on_ref_zero(oid)
        if (owner is None or owner == getattr(self, "address", None)) and \
                remote_copy and remote_copy != getattr(self, "address", None):
            # Sender half of the FREE_OBJECT arm: the primary copy of a
            # non-inline result lives on the executing daemon; the owner
            # dropping its last ref must reclaim that memory too, or the
            # executor leaks it for the life of the process.
            try:
                self.pool.get(
                    remote_copy, on_close=self._on_peer_conn_close,
                ).call_async(
                    pb.FREE_OBJECT,
                    pb.FreeObjectRequest(
                        object_id=oid.binary()).SerializeToString(),
                    lambda _env, _err: None)
            except Exception:
                logger.debug("free propagation to %s failed",
                             remote_copy, exc_info=True)
        if hasattr(self, "_location_hints"):
            self._location_hints.pop(oid, None)  # raylint: allow(data-race) GIL-atomic op on best-effort location hint; stale hint costs one extra directory probe
            self._completed_returns.discard(oid)
            self._dir_probe_at.pop(oid, None)
            with self._fetch_cache_lock:
                self._fetch_cache.pop(oid, None)

    # --------------------------------------------------------- object plane

    # get_objects() overlaps blocking resolutions here: remote fetches
    # (striped across the data-stream pool) and pushed-task waits gain
    # real parallelism on the wire.
    _concurrent_get = True

    def put_object(self, value: Any, owner_node: Optional[Node] = None) -> ObjectID:
        oid = super().put_object(value, owner_node=self.local_node)
        self._owner_addr[oid] = self.address  # raylint: allow(data-race) GIL-atomic op on best-effort owner cache; mis-resolve falls back to broadcast lookup
        return oid

    def get_object(self, oid: ObjectID, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = 0.002
        while True:
            read_failed = False  # local sealed entry was unreadable
            # 1. Local store.
            if self.local_node.store.contains(oid):
                try:
                    return self.local_node.store.get(oid, timeout=0)
                except exc.RayTpuError:
                    raise
                except Exception as e:
                    logger.debug("local store read failed; trying remote: %s", e)
                    read_failed = True
            # 2. A task we pushed remotely may complete into local seal.
            info = self._inflight_for_return(oid)
            if info is not None:
                remaining = None if deadline is None else max(
                    0.0, deadline - time.monotonic())
                if not info["event"].wait(
                        timeout=min(0.2, remaining)
                        if remaining is not None else 0.2):
                    if deadline is not None and time.monotonic() > deadline:
                        raise exc.GetTimeoutError(f"get({oid}) timed out")
                    continue
                continue  # sealed now (value or error) -> loop re-checks
            # 3. Remote fetch: hint, then directory.
            value, found = self._try_remote_fetch(oid)
            if found:
                return value
            # 4. Local-mode semantics (lineage reconstruction etc).
            with self.lock:
                spec = self.lineage.get(oid)
                state = (self.task_states.get(spec.task_id)
                         if spec is not None else None)
            if spec is not None and state in ("FINISHED", "FAILED", None):
                if not read_failed and self.local_node.store.contains(oid):
                    continue  # sealed between steps 1 and 4: re-read
                if not self._try_reconstruct(oid):
                    raise exc.ObjectLostError(
                        f"object {oid} lost and not reconstructable")
            elif spec is None and not self._owner_addr.get(oid):
                # Unknown object: maybe producer hasn't sealed yet; poll
                # directory with backoff until timeout.
                pass
            if deadline is not None and time.monotonic() > deadline:
                raise exc.GetTimeoutError(f"get({oid}) timed out")
            # Event-driven: a local seal wakes us immediately; the backoff
            # bounds how often we re-probe REMOTE locations.
            self._wait_for_seal(lambda: self._sealed_locally(oid), backoff)
            backoff = min(backoff * 2, 0.1)

    def _sealed_locally(self, oid: ObjectID) -> bool:
        return (self.local_node.store.contains(oid)
                or oid in self._completed_returns)

    def _inflight_for_return(self, oid: ObjectID) -> Optional[dict]:
        with self._inflight_lock:
            return self._inflight_by_return.get(oid)

    def _index_inflight(self, info: dict) -> None:
        """Under _inflight_lock."""
        for rid in info["returns"]:
            self._inflight_by_return[rid] = info

    def _unindex_inflight(self, info: Optional[dict]) -> None:
        """Under _inflight_lock. Identity-checked: a retry attempt may
        have re-registered the same return ids with a newer info."""
        if info is None:
            return
        for rid in info["returns"]:
            if self._inflight_by_return.get(rid) is info:
                del self._inflight_by_return[rid]

    def _task_finalized(self, task_id: TaskID) -> bool:
        with self.lock:
            return self.task_states.get(task_id) in (
                "FINISHED", "FAILED", "CANCELLED")

    def _try_remote_fetch(self, oid: ObjectID) -> Tuple[Any, bool]:
        addrs: List[str] = []
        hint = self._location_hints.get(oid)
        if hint and hint != self.address:
            addrs.append(hint)
        owner = self._owner_addr.get(oid)
        if owner and owner != self.address and owner not in addrs:
            addrs.append(owner)
        try:
            rep = self.state.get_locations(oid.binary())
            for a in rep.addresses:
                if a and a != self.address and a not in addrs:
                    addrs.append(a)
        except Exception as e:
            logger.debug("get_locations failed: %s", e)
        if len(addrs) > 1:
            # Deprioritize (never skip: correctness first) sources whose
            # circuit breaker is open — a healthy replica answers without
            # paying a dead host's connect timeout first.
            addrs.sort(key=lambda a: self.breakers.get(a).state_code() == 2)
        for addr in addrs:
            try:
                if observability.ENABLED:
                    with observability.span("object.fetch", cat="data",
                                            peer=addr,
                                            object=oid.hex()[:8]):
                        value, err = self._fetch_from(addr, oid)
                else:
                    value, err = self._fetch_from(addr, oid)
                self.breakers.record_success(addr)
            except (RpcConnectionError, RpcRemoteError, TimeoutError) as e:
                if not isinstance(e, RpcRemoteError):
                    self.breakers.record_failure(addr)
                continue
            if err is not None:
                raise err
            if value is not _FETCH_MISS:
                # Cache locally + advertise (pull-through caching like the
                # reference's local plasma copy after a pull). A striped
                # fetch sealed the frame into the store already — put()
                # would re-serialize the value it just decoded.
                if not self.local_node.store.contains(oid):
                    self.local_node.store.put(oid, value)
                with self.lock:
                    self.object_locations[oid] = self.local_node.node_id
                self._location_hints[oid] = addr  # raylint: allow(data-race) GIL-atomic op on best-effort location hint; stale hint costs one extra directory probe
                try:
                    self.state.add_location(
                        oid.binary(), self.local_node.node_id.binary())
                except Exception as e:
                    logger.debug("add_location failed: %s", e)
                return value, True
        return None, False

    def _fetch_from(self, addr: str, oid: ObjectID):
        if not perf.ENABLED:
            return self._fetch_from_impl(addr, oid)
        t0 = time.monotonic()
        try:
            return self._fetch_from_impl(addr, oid)
        finally:
            perf.observe("fetch.object", (time.monotonic() - t0) * 1e3)

    def _fetch_from_impl(self, addr: str, oid: ObjectID):
        """Pull of a pickled object. Same-host owners serve through the
        shared arena (one shm read, zero payload bytes on the wire);
        otherwise chunked TCP: a small probe request reveals total_size,
        then ALL remaining chunks are requested concurrently, STRIPED
        round-robin across the peer's data-stream pool so a multi-GB pull
        is not serialized behind one socket's reader thread (the reference
        chunk-parallelizes transfers the same way, ``object_manager.cc``
        pull chunking). Chunks recv_into the object's final resting place
        — a store recv buffer (native arena when it fits) — and the store
        serves the sealed frame in place: zero reassembly copies, no
        decode+re-pickle on landing. A failed stream's chunks retry on the
        surviving/replenished streams (backoff-bounded), so one mid-
        transfer reset does not fail the pull.
        Returns (value | _FETCH_MISS, error_or_none)."""
        if chaos.ENABLED:
            try:
                if chaos.inject("object.fetch", peer=addr,
                                object=oid.hex()[:8]) == "drop":
                    return _FETCH_MISS, None  # "source didn't have it"
            except chaos.ChaosConnectionReset as e:
                raise RpcConnectionError(str(e)) from e
        client = self.pool.get(addr)
        arena_key = self.host_arena_key
        chunk_sz = transport.fetch_chunk_bytes()
        first_box: Dict[str, bytearray] = {}

        def _first_sink(n):
            first_box["buf"] = bytearray(n)
            return memoryview(first_box["buf"])

        while True:
            rep = pb.FetchObjectReply()
            rep.ParseFromString(client.call(
                pb.FETCH_OBJECT, pb.FetchObjectRequest(
                    object_id=oid.binary(), offset=0,
                    max_bytes=min(_FETCH_PROBE_BYTES, chunk_sz),
                    arena_key=arena_key).SerializeToString(),
                timeout=120, raw_sink=_first_sink).body)
            if not rep.found:
                return _FETCH_MISS, None
            if rep.error_pickle:
                return _FETCH_MISS, pickle.loads(rep.error_pickle)
            if rep.in_arena:
                value = self._arena_load(bytes(rep.arena_object_key))
                if value is not _FETCH_MISS:
                    return value, None
                # raced an eviction: retry over TCP
                arena_key = ""
                first_box.pop("buf", None)
                continue
            break
        first = first_box.get("buf")
        if first is None:
            first = rep.data  # pre-raw-lane peer
        total = rep.total_size or len(first)
        if rep.eof or len(first) >= total:
            value, _ = _loads_framed(first)
            return value, None
        # Destination. With data streams available the bytes land in a
        # store recv buffer (sealed in place at the end — the fetched
        # object is never re-serialized). Arena-dest sinks are handed ONLY
        # to stream connections we own: on failure we close them and join
        # their readers before reclaiming the slot, a guarantee the shared
        # control connection cannot give.
        store = self.local_node.store
        streams = self._data_streams.clients(addr)
        dest = store.create_recv_buffer(oid, total) if streams else None
        if dest is None:
            if store.contains(oid):  # sealed while we probed
                try:
                    return store.get(oid, timeout=0), None
                except Exception as e:
                    logger.debug("raced store read failed: %s", e)
            heap = bytearray(total)
            dest = memoryview(heap)
            streams = streams or [client]
        else:
            heap = None
        dest[:len(first)] = first
        # Striping, failover and the retry backoff live in the shared
        # transport layer (the same machinery drains pushes and checkpoint
        # chunk fetches). The probe connection is last-resort only for
        # heap dests: arena-dest sinks are handed ONLY to streams we own.
        xfer = transport.StripedTransfer(
            self._data_streams, addr, consumer="object.fetch",
            fallback_client=(None if heap is None else client),
            streams=streams)

        def _submit(stream, off, done_cb):
            t0 = time.monotonic() if perf.ENABLED else 0.0

            def cb(env, error):
                if t0:
                    perf.observe("fetch.stripe",
                                 (time.monotonic() - t0) * 1e3)
                try:
                    if error is None:
                        crep = pb.FetchObjectReply()
                        crep.ParseFromString(env.body)
                        if not crep.found:
                            error = RpcRemoteError(
                                f"object {oid} vanished mid-fetch")
                        elif crep.data:
                            # pre-raw-lane peer: bytes in the proto
                            dest[off:off + len(crep.data)] = crep.data
                except Exception as e:  # noqa: BLE001
                    error = e
                done_cb(error)

            # The raw sink lands each chunk's bytes DIRECTLY in its slot
            # of the destination from the stream's reader thread — zero
            # user-space payload copies.
            stream.call_async(
                pb.FETCH_OBJECT, pb.FetchObjectRequest(
                    object_id=oid.binary(), offset=off,
                    max_bytes=chunk_sz).SerializeToString(),
                cb, raw_sink=lambda n, _o=off: dest[_o:_o + n])

        sealed = False
        try:
            # RpcRemoteError (source lost the object) aborts immediately:
            # no retry helps.
            xfer.run(range(len(first), total, chunk_sz), _submit)
            if heap is None:
                store.seal_recv_buffer(oid)
                sealed = True
                return store.get(oid, timeout=0), None
            value, _ = _loads_framed(heap)
            return value, None
        finally:
            if heap is None and not sealed:
                # Quiesce our stream readers before reclaiming the slot:
                # a late recv_into against a deleted slot would scribble
                # over whatever the arena reuses that space for.
                self._data_streams.drop(addr)
                for c in xfer.streams:
                    if c is not client:
                        c.join_reader(timeout=5.0)
                store.abort_recv_buffer(oid)

    def fetch_ckpt_chunk(self, addr: str, chunk_id: str) -> Optional[bytes]:
        """Striped fetch of one content-addressed checkpoint chunk from a
        peer's serve roots — the ``fetch_from`` hook of
        ``ray_tpu.checkpoint.load`` for restores whose root is not the
        saver's filesystem. Same shape as ``_fetch_from``: a probe
        request reveals total_size, remaining chunks stripe concurrently
        over the shared pool with failover, bytes recv_into their final
        slot of one heap buffer, which is returned as-is (bytes-like;
        the engine hashes and writes it without copying, and framed
        decode seals it read-only). Returns None when the peer doesn't
        hold the chunk (the restore fails loudly upstream)."""
        client = self.pool.get(addr)
        chunk_sz = transport.fetch_chunk_bytes()
        key = "ckpt:" + chunk_id
        first_box: Dict[str, bytearray] = {}

        def _first_sink(n):
            first_box["buf"] = bytearray(n)
            return memoryview(first_box["buf"])

        rep = pb.FetchObjectReply()
        rep.ParseFromString(client.call(
            pb.FETCH_OBJECT, pb.FetchObjectRequest(
                offset=0, max_bytes=chunk_sz,
                arena_key=key).SerializeToString(),
            timeout=120, raw_sink=_first_sink).body)
        if not rep.found:
            return None
        first = first_box.get("buf") or rep.data or b""
        total = rep.total_size or len(first)
        if rep.eof or len(first) >= total:
            return first
        heap = bytearray(total)
        dest = memoryview(heap)
        dest[:len(first)] = first
        xfer = transport.StripedTransfer(
            self._data_streams, addr, consumer="ckpt.restore",
            fallback_client=client)

        def _submit(stream, off, done_cb):
            def cb(env, error):
                try:
                    if error is None:
                        crep = pb.FetchObjectReply()
                        crep.ParseFromString(env.body)
                        if not crep.found:
                            error = RpcRemoteError(
                                f"ckpt chunk {chunk_id[:12]}… vanished "
                                "mid-fetch")
                        elif crep.data:
                            dest[off:off + len(crep.data)] = crep.data
                except Exception as e:  # noqa: BLE001
                    error = e
                done_cb(error)
            stream.call_async(
                pb.FETCH_OBJECT, pb.FetchObjectRequest(
                    offset=off, max_bytes=chunk_sz,
                    arena_key=key).SerializeToString(),
                cb, raw_sink=lambda n, _o=off: dest[_o:_o + n])

        xfer.run(range(len(first), total, chunk_sz), _submit)
        return heap

    def ckpt_fetcher(self, addr: str):
        """Bind ``fetch_ckpt_chunk`` to one peer: the ``fetch_from``
        argument for ``ray_tpu.checkpoint.load``."""
        return lambda chunk_id: self.fetch_ckpt_chunk(addr, chunk_id)

    def object_ready(self, oid: ObjectID) -> bool:
        if self.local_node.store.contains(oid):
            return True
        if oid in self._completed_returns:
            return True
        node = self._locate(oid)
        if node is not None and node.store.contains(oid):
            return True
        # Remote? Throttled directory probe.
        now = time.monotonic()
        last = self._dir_probe_at.get(oid, 0.0)
        if now - last < 0.05:
            return False
        self._dir_probe_at[oid] = now
        if self._location_hints.get(oid):
            return True
        try:
            rep = self.state.get_locations(oid.binary())
            if rep.addresses:
                self._location_hints[oid] = next(  # raylint: allow(data-race) GIL-atomic op on best-effort location hint; stale hint costs one extra directory probe
                    (a for a in rep.addresses if a), "")
                return True
        except Exception as e:
            logger.debug("get_locations failed: %s", e)
        return False

    # ------------------------------------------------------------ scheduling

    def node_states(self) -> List[NodeState]:
        """Worker-facing cluster view (drives ``ray_tpu.nodes()`` etc.)."""
        with self._view_lock:
            dead = [NodeState(NodeID(nid), NodeResources(
                ResourceSet(dict(info.total.amounts))), False)
                for nid, info in self._view.items() if not info.alive]
        return self._cluster_states() + dead

    def set_pending_drain(self, node_id_hex: str, flag: bool) -> None:
        """Autoscaler hazard hint: treat a node as a last-choice placement
        (see scheduler.NodeState.pending_drain). Driver-local — the hints
        steer this process's schedulers, which is where the autoscaler's
        own placement decisions run."""
        nid = bytes.fromhex(node_id_hex)
        hints = self._pending_drain_hints
        if (nid in hints) == flag:
            return
        updated = (hints | {nid}) if flag else (hints - {nid})
        self._pending_drain_hints = updated  # raylint: allow(data-race) immutable frozenset publish; readers see old or new snapshot
        with self._view_lock:
            self._states_memo = None  # placement must see the hint  # raylint: allow(data-race) immutable tuple publish; the unlocked micro-TTL read re-validates within 2ms

    def _cluster_states(self, include_suspects: bool = False
                        ) -> List[NodeState]:
        now = time.monotonic()
        if not include_suspects:
            # Micro-TTL memo: the schedulers call this once PER TASK, and
            # rebuilding wrapper lists dominates the dispatch hot loop at
            # thousands of tasks/s. The memoized NodeState objects wrap
            # the SAME live NodeResources instances, so allocations made
            # through the memo stay visible; staleness is bounded at 2 ms
            # (vs the ~1 s heartbeat refresh feeding this view anyway).
            memo = self._states_memo
            if memo is not None and now - memo[0] < 0.002:
                return memo[1]
        states = [self.local_node.state()]
        with self._view_lock:
            for nid, info in self._view.items():
                if not info.alive:
                    continue
                if (not include_suspects
                        and self._suspect_addrs.get(info.address, 0) > now):
                    continue
                nr = self._view_avail.get(nid)
                if nr is None:
                    nr = NodeResources(ResourceSet(dict(info.total.amounts)))
                    self._view_avail[nid] = nr
                states.append(NodeState(
                    NodeID(nid), nr, True,
                    draining=info.state == "DRAINING",
                    pending_drain=nid in self._pending_drain_hints))
            if not include_suspects:
                self._states_memo = (now, states)  # raylint: allow(data-race) immutable tuple publish; the unlocked micro-TTL read re-validates within 2ms
        return states

    def _select_node(self, spec: TaskSpec) -> Optional[NodeID]:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)
        strategy = spec.options.scheduling_strategy
        request = spec.options.resources
        pg = spec.options.placement_group
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            spec.options.placement_group = pg
            spec.options.placement_group_bundle_index = (
                strategy.placement_group_bundle_index)
        states = self._cluster_states()
        if pg is not None:
            with self.lock:
                pg_state = self.placement_groups.get(pg.id)
            if pg_state is None or not pg_state.ready.is_set():
                return None
            if pg_state.bundle_nodes is None:
                return None
            idx = spec.options.placement_group_bundle_index
            candidates = (pg_state.bundle_nodes if idx < 0
                          else [pg_state.bundle_nodes[idx]])
            alive = {s.node_id for s in states if s.alive}
            for nid in candidates:
                if nid in alive:
                    return nid
            return None
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            from ray_tpu_torch._private.scheduler import NodeAffinityPolicy
            return NodeAffinityPolicy().select(states, request,
                                               strategy.node_id, strategy.soft)
        if strategy == "SPREAD":
            chosen = self.spread_policy.select(states, request)
        else:
            preferred = task_context.node_id or self.local_node.node_id
            chosen = self.hybrid_policy.select(states, request, preferred)
        if chosen is None and not any(
                n.alive and n.resources.could_ever_fit(request)
                for n in self._cluster_states(include_suspects=True)):
            raise Infeasible(
                f"request {request} cannot be satisfied by any node in the "
                f"cluster")
        return chosen

    def _try_dispatch(self, item: dict) -> str:
        spec: TaskSpec = item["spec"]
        cancel = item["cancel"]
        if cancel.is_set():
            for rid in spec.return_ids:
                self.seal_error(rid, exc.TaskCancelledError(spec.task_id),
                                self.local_node)
            self._unpin_args(spec)
            with self.lock:
                self.task_states[spec.task_id] = "CANCELLED"
            self._fire_completion(spec)
            return "done"
        if not self._deps_ready_dist(spec):
            return "wait"
        err = self._first_dep_error(spec)
        if err is not None:
            for rid in spec.return_ids:
                self.seal_error(rid, err, self.local_node)
            self._unpin_args(spec)
            with self.lock:
                self.task_states[spec.task_id] = "FAILED"
            self._fire_completion(spec)
            return "done"
        if getattr(spec, "_exec_local", False):
            # A peer pushed this task here after placing it: execute locally
            # or queue for local capacity — never re-forward through our own
            # (possibly stale) cluster view. Re-placement on failure is the
            # pusher's job (it holds the lineage and the retry budget).
            node_id = self.local_node.node_id
        else:
            node_id = self._select_node(spec)
        if node_id is None:
            return "wait"
        if node_id == self.local_node.node_id:
            node = self.local_node
            request = self._effective_request(spec)
            alloc_target = self._allocation_target(spec, node)
            if not alloc_target.can_fit(request):
                return "wait"
            alloc_target.allocate(request)
            with self.lock:
                self.task_states[spec.task_id] = "RUNNING"
            node.submit(self._execute_task, spec, node, request,
                        alloc_target, cancel)
            return "done"
        # Remote push.
        nid = node_id.binary()
        with self._view_lock:
            addr = self._addr_by_node.get(nid)
            nr = self._view_avail.get(nid)
        if addr is None:
            return "wait"
        request = self._effective_request(spec)
        alloc = None
        if nr is not None and nr.can_fit(request):
            # Optimistic debit, credited back when THIS attempt settles —
            # waiting for the ~1s heartbeat refresh to restore
            # availability caps throughput at (queue depth / heartbeat
            # period) regardless of how fast tasks actually finish.
            nr.allocate(request)
            alloc = (nid, request)
        self._push_task_remote(spec, addr, cancel, alloc=alloc,
                               batched=bool(_config.get(
                                   "task_push_batching")))
        with self.lock:
            self.task_states[spec.task_id] = "RUNNING"
        return "done"

    def _deps_ready_dist(self, spec: TaskSpec) -> bool:
        """A dep is ready if it exists anywhere reachable (it will be pulled
        at execution time); only truly-lost deps trigger reconstruction."""
        for oid in _ref_ids_in(spec.args, spec.kwargs):
            if self.object_ready(oid):
                continue
            if self._inflight_for_return(oid) is not None:
                return False  # still being produced remotely
            with self.lock:
                known = oid in self.object_locations
                dep_spec = self.lineage.get(oid)
                state = (self.task_states.get(dep_spec.task_id)
                         if dep_spec is not None else None)
            if (not known and dep_spec is not None
                    and state in ("FINISHED", "FAILED")):
                self._try_reconstruct(oid)
            return False
        return True

    def _allocation_target(self, spec: TaskSpec, node: Node):
        key = getattr(spec, "_dist_pg", None)
        if key is not None:
            pg_id, idx = key
            if idx >= 0:
                target = node.bundles.get((pg_id, idx))
                if target is not None:
                    return target
            for (pgid, i), br in node.bundles.items():
                if pgid == pg_id and br.can_fit(spec.options.resources):
                    return br
            for (pgid, i), br in node.bundles.items():
                if pgid == pg_id:
                    return br
            raise Infeasible("no bundle of placement group on this node")
        return super()._allocation_target(spec, node)

    # ---------------------------------------------------- remote submission

    def _export_callable(self, fn) -> bytes:
        # Hot path: re-pickling the SAME function object per submit just
        # to recompute its content key costs ~30us/task. Identity-keyed
        # weak cache short-circuits it (a mutated-in-place closure would
        # be missed, but cloudpickle captures by value at decoration time
        # anyway — the remote() wrapper pins one function object).
        try:
            key = self._fn_key_by_identity.get(fn)
        except TypeError:  # unhashable/unweakrefable callable
            key = None
        if key is not None:
            return key
        payload = cloudpickle.dumps(fn)
        key = _fn_key(payload)
        if key not in self._exported_fns:
            self.state.kv_put(key, payload, overwrite=False, namespace=FN_NS)
            self._exported_fns[key] = payload  # raylint: allow(data-race) idempotent content-addressed export cache; duplicate compute is harmless
        try:
            self._fn_key_by_identity[fn] = key  # raylint: allow(data-race) idempotent content-addressed export cache; duplicate compute is harmless
        except TypeError:
            pass
        return key

    def register_named_function(self, name: str, fn) -> None:
        """Publish ``fn`` under ``name`` for cross-language callers (the
        reference's cross-language function registration: a C++/Java
        driver names the function, the Python worker executes it).

        The registry maps the MUTABLE name to the content hash; payloads
        live content-addressed in the function table. Daemons cache by
        hash only, so re-registering a name takes effect on the next call
        cluster-wide (a name-keyed cache would pin the stale version)."""
        payload = cloudpickle.dumps(fn)
        key = _fn_key(payload)
        self.state.kv_put(key, payload, overwrite=False, namespace=FN_NS)
        self._fn_cache[key] = fn  # raylint: allow(data-race) idempotent content-addressed export cache; duplicate compute is harmless
        self.state.kv_put(name.encode(), key, overwrite=True,
                          namespace=NAMED_FN_NS)

    def _load_named_function(self, name: str):
        key = self.state.kv_get(name.encode(), namespace=NAMED_FN_NS)
        if key is None:
            raise exc.RayTpuError(
                f"named function {name!r} is not registered "
                f"(register_named_function)")
        return self._load_callable(bytes(key))

    def _load_callable(self, key: bytes):
        fn = self._fn_cache.get(key)
        if fn is None:
            payload = self.state.kv_get(key, namespace=FN_NS)
            if payload is None:
                raise exc.RayTpuError(
                    f"function {key.hex()[:12]} not in function table")
            fn = cloudpickle.loads(payload)
            self._fn_cache[key] = fn  # raylint: allow(data-race) idempotent content-addressed export cache; duplicate compute is harmless
        return fn

    def _spec_to_msg(self, spec: TaskSpec) -> Tuple[pb.TaskSpecMsg, list]:
        msg = pb.TaskSpecMsg(
            task_id=spec.task_id.binary(),
            job_id=spec.job_id.binary(),
            function_name=spec.function_name,
            num_returns=spec.options.num_returns,
            return_ids=[r.binary() for r in spec.return_ids],
            attempt=spec.attempt,
            max_retries=spec.options.max_retries,
            caller_address=self.address,
            name=spec.options.name or "",
        )
        if spec.trace_id:
            msg.trace_id = spec.trace_id
            msg.parent_span_id = spec.parent_span_id
        if spec.is_actor_task():
            msg.actor_id = spec.actor_id.binary()
            msg.method_name = spec.method_name or ""
        else:
            msg.fn_hash = self._export_callable(spec.function)
        if not spec.args and not spec.kwargs:
            # The commonest hot-loop shape (f.remote() with no args):
            # skip the pickler entirely — no refs, no pins.
            msg.args_pickle = _EMPTY_ARGS_PICKLE
            arg_pins = []
        else:
            self._pin_collect.pins = []
            try:
                msg.args_pickle = _dumps_value((spec.args, spec.kwargs))
                arg_pins = self._pin_collect.pins
            except BaseException:
                # Nothing ever reaches a receiver: release what we pinned.
                for oid in self._pin_collect.pins or []:
                    self.reference_counter.unpin_for_task(oid)
                raise
            finally:
                self._pin_collect.pins = None
        for k, v in spec.options.resources.to_dict().items():
            msg.resources.amounts[k] = v
        if spec.options.runtime_env:
            msg.runtime_env_json = json.dumps(
                spec.options.runtime_env).encode()
        re = spec.options.retry_exceptions
        if re is True:
            msg.retry_exceptions_pickle = _RETRY_ALL_PICKLE
        elif re not in (False, None):
            msg.retry_exceptions_pickle = cloudpickle.dumps(re)
        pg = spec.options.placement_group
        if pg is not None:
            msg.pg_id = pg.id.binary()
            msg.pg_bundle_index = spec.options.placement_group_bundle_index
        if spec.perf_submit_s:
            # Rebase the submit stamp onto the state-service timebase so
            # the executing host (different clock) can rebase it back and
            # measure task.e2e without cross-host skew.
            msg.perf_submit_s = clocksync.to_server_s(spec.perf_submit_s)
        return msg, arg_pins

    def _release_arg_pins(self, pins: list, delay_s: float = 0.0):
        """Release the serialize-time pins of one settled push attempt.

        A successful attempt defers the release briefly: the executor's
        ADD_BORROW for any ref it kept travels on a different connection
        than the task reply, and the pin must outlive that registration.
        Deferred releases share ONE reaper thread (a timer thread per task
        completion would not survive high task rates).
        """
        if not pins:
            return
        if delay_s <= 0:
            for oid in pins:
                self.reference_counter.unpin_for_task(oid)
            return
        import heapq
        with self._pin_reaper_cv:
            heapq.heappush(self._pin_heap,
                           (time.monotonic() + delay_s, next(self._pin_seq),
                            pins))
            if self._pin_reaper is None:
                self._pin_reaper = threading.Thread(
                    target=self._pin_reaper_loop, daemon=True,
                    name="dist-pin-reaper")
                self._pin_reaper.start()
            self._pin_reaper_cv.notify()

    def _pin_reaper_loop(self):
        import heapq
        while not self._hb_stop.is_set():
            with self._pin_reaper_cv:
                while not self._pin_heap and not self._hb_stop.is_set():
                    self._pin_reaper_cv.wait(timeout=1.0)
                if self._hb_stop.is_set():
                    return
                due_at = self._pin_heap[0][0]
                delay = due_at - time.monotonic()
                if delay > 0:
                    self._pin_reaper_cv.wait(timeout=delay)
                    continue
                _, _, pins = heapq.heappop(self._pin_heap)
            for oid in pins:
                self.reference_counter.unpin_for_task(oid)

    def _claim_pins(self, info: Optional[dict]) -> list:
        """Atomically claim an attempt's serialize-time pins: exactly one
        of the possibly-concurrent settle paths (success reply, connection
        error, NODE_DEAD sweep) gets them; the rest get []."""
        if info is None:
            return []
        with self._inflight_lock:
            if info.get("pins_claimed"):
                return []
            info["pins_claimed"] = True
            return info.get("arg_pins") or []

    def _transfer_stale_pins(self, spec: TaskSpec, pins: list):
        """Hand a settled attempt's pins to the task's NEXT incarnation:
        released only when the retry re-serializes (re-pinning) or the task
        reaches a terminal state (_unpin_args flushes) — never on a timer a
        long pending-queue wait could outlive."""
        if pins:
            stale = getattr(spec, "_stale_arg_pins", None) or []
            spec._stale_arg_pins = stale + pins

    def _unpin_args(self, spec: TaskSpec):
        stale = getattr(spec, "_stale_arg_pins", None)
        if stale:
            spec._stale_arg_pins = None
            for oid in stale:
                self.reference_counter.unpin_for_task(oid)
        super()._unpin_args(spec)

    def _push_task_remote(self, spec: TaskSpec, addr: str, cancel,
                          method: int = pb.PUSH_TASK, alloc=None,
                          batched: bool = False, premsg=None):
        # ``premsg``: (msg, arg_pins) built by the caller BEFORE taking a
        # per-actor lock — serialization must not run under rec.lock, or
        # every actor call pays its neighbours' pickling time.
        msg, arg_pins = premsg if premsg is not None else self._spec_to_msg(spec)
        # The re-serialization above re-pinned every arg ref; the previous
        # attempt's pins (held across the pending-queue wait) can go now.
        stale = getattr(spec, "_stale_arg_pins", None)
        if stale:
            spec._stale_arg_pins = None
            self._release_arg_pins(stale)
        attempt = spec.attempt
        key = (spec.task_id, attempt)
        info = {
            "spec": spec, "addr": addr, "cancel": cancel,
            "attempt": attempt, "arg_pins": arg_pins,
            "returns": set(spec.return_ids), "event": threading.Event(),
            "alloc": alloc,
        }
        with self._inflight_lock:
            self._inflight_remote[key] = info
            self._index_inflight(info)

        def _done(env, error):
            self._on_remote_reply(spec, attempt, addr, cancel, env, error)

        try:
            client = self.pool.get(
                addr, on_close=self._on_peer_conn_close)
            if batched and method == pb.PUSH_TASK:
                # Hot-loop batching: reserve the reply seq now, ship the
                # spec in the NEXT batch frame to this daemon (one
                # frame/syscall/reader-wakeup per dispatch pass, replies
                # still per-task).
                seq = client.allocate_pending(_done)
                with self._push_batch_lock:
                    group = self._push_batch.setdefault(addr, [])
                    group.append((client, seq, msg))
                    flush_now = len(group) >= 128
                if flush_now:
                    self._flush_push_batches(only_addr=addr)
            else:
                client.call_async(method, msg.SerializeToString(), _done)
        except Exception as e:  # connection refused etc.
            self._on_remote_reply(spec, attempt, addr, cancel, None, e)
            return
        # Proactively stream large arg objects to the executor (the
        # reference's push path) — skipped when the peer shares our host
        # arena, where the pull is already one shm read.
        threshold = int(_config.get("object_push_threshold_bytes"))
        if threshold > 0 and arg_pins and not (
                self.host_arena is not None and self._same_host(addr)):
            for oid in arg_pins:
                if self.local_node.store.contains(oid):
                    self._push_mgr.maybe_push(addr, oid, threshold)

    def _same_host(self, addr: str) -> bool:
        return (addr.rsplit(":", 1)[0]
                == self.address.rsplit(":", 1)[0])

    def p2p_wait(self, key: tuple, timeout_s: float):
        """Block for a P2P_DATA delivery; returns (dtype, shape, bytes)."""
        deadline = time.monotonic() + timeout_s
        with self._p2p_cv:
            while key not in self._p2p_box:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"p2p recv {key} timed out")
                self._p2p_cv.wait(remaining)
            return self._p2p_box.pop(key)[:3]

    def _flush_push_batches(self, only_addr: Optional[str] = None):
        """Ship queued task pushes, one TaskBatchMsg frame per daemon."""
        with self._push_batch_lock:
            if only_addr is not None:
                groups = {only_addr: self._push_batch.pop(only_addr, [])}
            else:
                groups, self._push_batch = self._push_batch, {}
        for addr, items in groups.items():
            if not items:
                continue
            by_client: Dict[Any, list] = {}
            for client, seq, msg in items:
                by_client.setdefault(client, []).append((seq, msg))
            for client, pairs in by_client.items():
                batch = pb.TaskBatchMsg(seqs=[s for s, _ in pairs])
                for _, msg in pairs:
                    batch.tasks.append(msg)
                try:
                    client.send_oneway(pb.PUSH_TASK_BATCH,
                                       batch.SerializeToString())
                except Exception as e:  # noqa: BLE001 - conn died
                    client.fail_pending([s for s, _ in pairs], e)

    def _flush_dispatch_batches(self):
        """Dispatch-pass hook: with a linger configured, queued pushes are
        NOT shipped inline — a deadline is stamped and the flusher thread
        sends one coalesced frame per daemon when it expires. A burst of
        inline dispatches (each of which calls this hook) therefore pays
        one syscall per linger window, not one per task; a lone task waits
        at most ``task_push_flush_ms``. Oversized groups still flush
        synchronously from ``_push_task_remote`` (>= 128 queued)."""
        linger = float(_config.get("task_push_flush_ms") or 0.0)
        if linger <= 0:
            self._flush_push_batches()
            return
        with self._push_batch_lock:
            if not any(self._push_batch.values()):
                return
        with self._push_flush_cv:
            if self._push_flush_due is None:
                self._push_flush_due = time.monotonic() + linger / 1000.0  # raylint: guarded-by(self._push_flush_cv)
            if self._push_flusher is None or not self._push_flusher.is_alive():
                self._push_flusher = threading.Thread(
                    target=self._push_flush_loop, name="push-flush",
                    daemon=True)
                self._push_flusher.start()
            self._push_flush_cv.notify()

    def _push_flush_loop(self):
        while not self._shutdown:
            with self._push_flush_cv:
                while self._push_flush_due is None and not self._shutdown:
                    self._push_flush_cv.wait(timeout=0.5)
                if self._shutdown:
                    break
                delay = self._push_flush_due - time.monotonic()
                if delay > 0:
                    self._push_flush_cv.wait(timeout=delay)
                    continue  # re-check: the deadline may have been re-armed
                self._push_flush_due = None
            try:
                self._flush_push_batches()
            except Exception:  # defensive: the flusher must survive
                logger.exception("lingered push-batch flush failed")
        # Drain on shutdown so no queued push strands its pending reply.
        try:
            self._flush_push_batches()
        except Exception as e:  # raylint: allow(swallow) teardown
            logger.debug("final push-batch flush failed: %s", e)

    def _settle_view_alloc(self, info, credit: bool):
        """Settle one push attempt's optimistic view debit, exactly once.
        ``credit=True`` returns the capacity to the cached view (task left
        the daemon); ``credit=False`` just discards the marker (a
        spillback reply overwrote the view with authoritative numbers —
        releasing on top would double-count). Any drift is self-
        correcting: overcounts spill back, undercounts heal at the next
        heartbeat refresh."""
        if info is None:
            return
        with self._inflight_lock:
            alloc = info.pop("alloc", None)
        if not alloc or not credit:
            return
        nid, request = alloc
        with self._view_lock:
            nr = self._view_avail.get(nid)
            if nr is not None:
                nr.release(request)

    def _on_remote_reply(self, spec: TaskSpec, attempt: int, addr: str,
                         cancel, env, error):
        """Reply/error callback for one push attempt. Failure handling only
        acts when this callback atomically removed the attempt's in-flight
        entry — connection-close and NODE_DEAD both funnel into the same
        pop-then-settle, so exactly one signal wins. Completion replies are
        accepted from any attempt, first final state wins."""
        key = (spec.task_id, attempt)
        if error is not None:
            # Pop first: the atomic removal IS the claim to be this
            # attempt's failure authority (NODE_DEAD raced us otherwise).
            with self._inflight_lock:
                info = self._inflight_remote.pop(key, None)
                self._unindex_inflight(info)
            if info is not None:
                self._settle_view_alloc(info, credit=True)
                try:
                    self._settle_push_failure(spec, attempt, addr, cancel,
                                              error, self._claim_pins(info))
                finally:
                    info["event"].set()
                    self._kick()
            return
        # Success/spillback: settle BEFORE removing the in-flight entry so
        # concurrent get()s keep blocking on its event rather than racing
        # the seal (they re-check the store once the event fires).
        with self._inflight_lock:
            info = self._inflight_remote.get(key)
        spilled = False
        try:
            with self._view_lock:
                self._suspect_addrs.pop(addr, None)  # proven alive
            self.breakers.record_success(addr)
            rep = pb.PushTaskReply()
            rep.ParseFromString(env.body)
            if rep.status == "spillback":
                if self._task_finalized(spec.task_id):
                    return  # superseded attempt
                # Correct the stale view and reschedule.
                with self._view_lock:
                    nrs = [nr for nid, nr in self._view_avail.items()
                           if self._addr_by_node.get(nid) == addr]
                    for nr in nrs:
                        nr.available = ResourceSet(dict(rep.available.amounts))
                spilled = True
                # Pins ride to the re-push (which re-serializes).
                self._transfer_stale_pins(spec, self._claim_pins(info))
                with self._pending_cv:
                    self._pending.append({"spec": spec, "cancel": cancel})
                    self._pending_cv.notify_all()
                return
            # Completion (value or application error). Seal under the
            # runtime lock with a first-writer-wins guard: a superseded
            # attempt that still ran to completion is a valid completion
            # (at-least-once execution), but only one outcome lands.
            with self.lock:
                if self._task_finalized(spec.task_id):
                    return
                if rep.error_pickle:
                    err = pickle.loads(rep.error_pickle)
                    for rid in spec.return_ids:
                        self.seal_error(rid, err, self.local_node)
                    self.task_states[spec.task_id] = "FAILED"
                else:
                    for i, rid in enumerate(spec.return_ids):
                        if i < len(rep.inline) and rep.inline[i]:
                            value = pickle.loads(rep.inline_results[i])
                            self.local_node.store.put(rid, value)
                            self.object_locations[rid] = self.local_node.node_id
                            self._owner_addr.setdefault(rid, self.address)  # raylint: allow(data-race) GIL-atomic op on best-effort owner cache; mis-resolve falls back to broadcast lookup
                        else:
                            self._location_hints[rid] = addr  # raylint: allow(data-race) GIL-atomic op on best-effort location hint; stale hint costs one extra directory probe
                            self._owner_addr.setdefault(rid, addr)  # raylint: allow(data-race) GIL-atomic op on best-effort owner cache; mis-resolve falls back to broadcast lookup
                        self._completed_returns.add(rid)  # raylint: allow(data-race) GIL-atomic op on monotone completion set; late reader just retries the fetch
                    self.task_states[spec.task_id] = "FINISHED"
            self._notify_sealed()  # wake get()/wait() blocked on the seal cv
            self._unpin_args(spec)
            self._fire_completion(spec)
        finally:
            with self._inflight_lock:
                self._inflight_remote.pop(key, None)
                self._unindex_inflight(info)
            # Spillback replies carry the daemon's authoritative
            # availability (already written to the view above): discard
            # the debit marker instead of crediting on top of it.
            self._settle_view_alloc(info, credit=not spilled)
            if info is not None:
                if not spilled:
                    # Grace period: the executor's ADD_BORROW for any ref
                    # it kept rides a different connection than this reply;
                    # the serialize pin must outlive that registration.
                    self._release_arg_pins(self._claim_pins(info),
                                           delay_s=10.0)
                info["event"].set()
            self._kick()

    def _settle_push_failure(self, spec: TaskSpec, attempt: int, addr: str,
                             cancel, error: Exception, arg_pins: list = ()):
        """The daemon died mid-task (connection error / NODE_DEAD): retry
        elsewhere. Caller must have removed the attempt's in-flight entry;
        stale signals for superseded attempts are dropped here. The
        attempt's serialize-time arg pins are handed to the retry (released
        at its re-serialization or terminal seal) — or released after a
        borrow-registration grace when the attempt is superseded."""
        # Mark the address suspect so resubmissions avoid it until the
        # heartbeat sweep settles its fate (view refresh keeps listing it
        # alive until then).
        with self._view_lock:
            self._suspect_addrs[addr] = time.monotonic() + 10.0
        self.breakers.record_failure(addr)
        with self.lock:
            if self._task_finalized(spec.task_id) or spec.attempt != attempt:
                # Superseded: our executor may still have deserialized the
                # args and be registering borrows — grace before release.
                self._release_arg_pins(list(arg_pins), delay_s=10.0)
                return
            self._transfer_stale_pins(spec, list(arg_pins))
        cause = exc.NodeDiedError(
            f"task {spec.function_name} lost to node failure at {addr}: "
            f"{error}")
        if spec.is_actor_task():
            # The connection failure is a death signal for the actor's host
            # — act on it now instead of waiting for the heartbeat sweep:
            # restart the actor if we own it, drop the stale record if not,
            # then replay the call within max_retries
            # (gcs_actor_manager.h:66 + max_task_retries replay).
            rec = self.remote_actors.get(spec.actor_id)
            if rec is not None and rec.address == addr:
                self._handle_remote_actor_death(rec, exc.NodeDiedError(
                    f"node hosting actor died ({addr})"))
            if spec.should_retry(cause) and not cancel.is_set():
                spec.attempt += 1
                self._after_backoff(
                    spec.attempt - 1,
                    lambda: self.offload(lambda: self.submit_actor_task(
                        spec.actor_id, spec)))
                return
            died = exc.ActorDiedError(
                f"actor call {spec.function_name} lost: {cause}")
            for rid in spec.return_ids:
                self.seal_error(rid, died, self.local_node)
            with self.lock:
                self.task_states[spec.task_id] = "FAILED"
            self._unpin_args(spec)
            self._fire_completion(spec)
            return
        if spec.should_retry(cause) and not cancel.is_set():
            spec.attempt += 1
            self.emit_event("TASK_RETRY", task=spec.function_name,
                            attempt=spec.attempt, reason="node_died")

            def _enqueue():
                with self._pending_cv:
                    self._pending.append({"spec": spec, "cancel": cancel})
                    self._pending_cv.notify_all()
            self._after_backoff(spec.attempt - 1, _enqueue)
            return
        for rid in spec.return_ids:
            self.seal_error(rid, cause, self.local_node)
        with self.lock:
            self.task_states[spec.task_id] = "FAILED"
        self._unpin_args(spec)
        self._fire_completion(spec)

    def _after_backoff(self, attempt: int, fn: Callable[[], None]):
        """Run ``fn`` after the shared resubmission backoff for retry
        number ``attempt`` (jittered exponential; immediate when zero).
        Timer-per-retry is fine here: node-death resubmissions are rare."""
        delay = self._retry_backoff.delay_for(attempt)
        if delay <= 0:
            fn()
            return
        t = threading.Timer(delay, fn)
        t.daemon = True
        t.start()

    def _on_breaker_open(self, addr: str):
        """A peer's circuit breaker just OPENed (consecutive transport
        failures): shed scheduling traffic to it until the half-open probe
        succeeds — the existing suspect-address exclusion is the mechanism."""
        logger.warning("circuit breaker OPEN for peer %s", addr)
        # raylint: allow(metrics-cardinality) one series per peer daemon, bounded by cluster size
        _breaker_transitions().inc(tags={"peer": addr, "to": "open"})
        if observability.ENABLED:
            observability.instant("breaker:open", cat="breaker", peer=addr)
        with self._view_lock:
            self._suspect_addrs[addr] = (time.monotonic()
                                         + _config.get("circuit_reset_s"))

    def _on_peer_conn_close(self, addr: str, error: Exception):
        # call_async callbacks fire individually; nothing global needed here.
        self.breakers.record_failure(addr)
        logger.debug("peer connection to %s closed: %s", addr, error)

    def _fail_inflight_to(self, addr: str, reason: str):
        with self._inflight_lock:
            items = [(key, info) for key, info in self._inflight_remote.items()
                     if info["addr"] == addr]
            for key, info in items:
                self._inflight_remote.pop(key, None)
                self._unindex_inflight(info)
        for (tid, attempt), info in items:
            try:
                self._settle_push_failure(info["spec"], attempt, addr,
                                          info["cancel"],
                                          RpcConnectionError(reason),
                                          self._claim_pins(info))
            except Exception:
                logger.exception("settle failed for %s", tid)
            finally:
                info["event"].set()

    # -------------------------------------------------------------- actors

    def create_actor(self, state: ActorState) -> None:
        # Register in the global actor table first (name collision check).
        info = pb.ActorInfo(
            actor_id=state.actor_id.binary(), name=state.name or "",
            namespace=state.namespace, class_name=state.cls.__name__,
            state="PENDING", owner_job=self.job_id.binary())
        try:
            self.state.register_actor(info)
        except RpcRemoteError as e:
            raise ValueError(str(e)) from e
        with self.lock:
            self.actors[state.actor_id] = state
            if state.name:
                self.named_actors[(state.namespace, state.name)] = state.actor_id
        self._util_pool.submit(self._place_actor_dist, state)

    def _place_actor_dist(self, state: ActorState, restart: bool = False):
        try:
            self._try_place_actor_dist(state, restart)
        except Exception as e:  # noqa: BLE001 — reported as the death cause
            # An actor whose class or arguments cannot be shipped (or any
            # other placement error) dies with the cause: left PENDING, its
            # callers would wait for it forever.
            logger.warning("placing actor %s failed", state.cls.__name__,
                           exc_info=True)
            self._mark_actor_dead(state, exc.ActorDiedError(
                f"actor {state.cls.__name__} could not be created: "
                f"{type(e).__name__}: {e}"))
            self._sync_actor_info(state)

    def _try_place_actor_dist(self, state: ActorState,
                              restart: bool = False):
        deadline = time.monotonic() + _config.get("worker_lease_timeout_s")
        request = state.options.resources
        spec_like = TaskSpec(
            task_id=TaskID.for_actor_task(self.job_id, state.actor_id),
            job_id=self.job_id, function=lambda: None,
            function_name=f"{state.cls.__name__}.__init__", args=state.args,
            kwargs=state.kwargs, options=state.options)
        while True:
            try:
                node_id = self._select_node(spec_like)
            except Infeasible as e:
                self._mark_actor_dead(state, exc.ActorDiedError(str(e)))
                self._sync_actor_info(state)
                return
            if node_id == self.local_node.node_id:
                node = self.local_node
                target = self._allocation_target(spec_like, node)
                if target.can_fit(request):
                    target.allocate(request)
                    state.node_id = node_id
                    state.devices = self._assign_devices(request, node)
                    self._start_actor_on_node(state, node, request)
                    self._sync_actor_info(state, address=self.address,
                                          wait_ready=True)
                    return
            elif node_id is not None:
                if self._create_actor_remote(state, node_id.binary()):
                    return
            if time.monotonic() > deadline:
                self._mark_actor_dead(state, exc.ActorDiedError(
                    f"could not place actor {state.cls.__name__} "
                    f"(resources {request})"))
                self._sync_actor_info(state)
                return
            self._placement_wait(0.05)

    def _create_actor_remote(self, state: ActorState, nid: bytes) -> bool:
        with self._view_lock:
            addr = self._addr_by_node.get(nid)
        if addr is None:
            return False
        msg = pb.ActorSpecMsg(
            actor_id=state.actor_id.binary(), job_id=self.job_id.binary(),
            class_name=state.cls.__name__,
            cls_hash=self._export_callable(state.cls),
            args_pickle=_dumps_value((state.args, state.kwargs)),
            options_pickle=cloudpickle.dumps(state.options),
            name=state.name or "", namespace=state.namespace,
            caller_address=self.address,
            restart_count=state.restart_count)
        try:
            env = self.pool.get(addr).call(
                pb.CREATE_ACTOR, msg.SerializeToString(), timeout=None)
        except (RpcConnectionError, TimeoutError):
            return False
        rep = pb.CreateActorReply()
        rep.ParseFromString(env.body)
        if rep.status == "spillback":
            return False
        if rep.status == "error":
            err = pickle.loads(rep.error_pickle)
            self._mark_actor_dead(state, err if isinstance(
                err, exc.ActorDiedError) else exc.ActorDiedError(str(err)))
            self._sync_actor_info(state)
            return True
        # Remote actor is alive. Track it, then hand any calls that were
        # queued locally while placement was in flight over to the daemon
        # (in mailbox order).
        rec = _RemoteActorRecord(
            state.actor_id, state.cls.__name__, addr, nid, state.options,
            state.name or "", state.namespace, spec_msg=msg)
        rec.restart_count = state.restart_count
        self.remote_actors[state.actor_id] = rec  # raylint: allow(data-race) GIL-atomic registry op; accessors use get/pop idioms and tolerate misses
        with state.lock:
            state.status = ActorState.ALIVE
            state.node_id = NodeID(nid)
            state.ready.set()
        self._forward_mailbox(state, rec)
        self._sync_actor_info(state, address=addr)
        return True

    def _forward_mailbox(self, state: ActorState, rec: _RemoteActorRecord):
        """Re-route calls enqueued in the local mailbox to the remote host
        (single drainer at a time preserves per-caller order)."""
        import queue as _q
        with rec.lock:
            while True:
                try:
                    item = state.mailbox.get_nowait()
                except _q.Empty:
                    return
                if item is None:
                    continue
                spec, cancel = item
                with self.lock:
                    self.task_states[spec.task_id] = "RUNNING"
                self._push_task_remote(spec, rec.address, cancel,
                                       method=pb.ACTOR_CALL)

    def _sync_actor_info(self, state: ActorState, address: str = "",
                         wait_ready: bool = False):
        def _do():
            if wait_ready:
                state.ready.wait(timeout=60)
            info = pb.ActorInfo(
                actor_id=state.actor_id.binary(), name=state.name or "",
                namespace=state.namespace, class_name=state.cls.__name__,
                state=state.status, address=address,
                restart_count=state.restart_count,
                owner_job=self.job_id.binary(),
                death_cause=str(state.death_cause or ""))
            if state.node_id is not None:
                info.node_id = (state.node_id.binary()
                                if hasattr(state.node_id, "binary")
                                else state.node_id)
            try:
                self.state.update_actor(info)
            except Exception as e:
                logger.debug("update_actor failed: %s", e)
        self.offload(_do)

    def _handle_remote_actor_death(self, rec: _RemoteActorRecord,
                                   cause: BaseException):
        """Idempotent: reachable from the NODE_DEAD pubsub push, the view
        reconciliation, and connection failures on actor calls — the first
        signal wins, the rest are no-ops."""
        with rec.lock:
            if rec.status == "DEAD":
                return
            rec.status = "DEAD"
        with self.lock:
            state = self.actors.get(rec.actor_id)
        self.remote_actors.pop(rec.actor_id, None)  # raylint: allow(data-race) GIL-atomic registry op; accessors use get/pop idioms and tolerate misses
        if state is None:
            return
        max_restarts = getattr(state.options, "max_restarts", 0)
        if max_restarts != -1 and state.restart_count >= max_restarts:
            self._mark_actor_dead(state, cause)
            self._sync_actor_info(state)
            return
        with state.lock:
            state.restart_count += 1
            state.status = ActorState.RESTARTING
            state.ready.clear()
        self.emit_event("ACTOR_RESTART", actor=state.cls.__name__,
                        attempt=state.restart_count)
        self._util_pool.submit(self._place_actor_dist, state, True)

    def _place_and_start_actor(self, state: ActorState, restart: bool = False):
        """Daemon-side / restart placement is local-only: cluster-wide actor
        placement always goes through the creator's ``_place_actor_dist``."""
        request = state.options.resources
        node = self.local_node
        deadline = time.monotonic() + _config.get("worker_lease_timeout_s")
        while True:
            with self.lock:
                if node.resources.can_fit(request):
                    node.resources.allocate(request)
                    break
            if time.monotonic() > deadline:
                self._mark_actor_dead(state, exc.ActorDiedError(
                    f"could not re-place actor {state.cls.__name__} locally"))
                return
            self._placement_wait(0.02)
        state.node_id = node.node_id
        state.devices = self._assign_devices(request, node)
        self._start_actor_on_node(state, node, request)

    def submit_actor_task(self, actor_id: ActorID, spec: TaskSpec):
        # Before any routing: the remote path returns without reaching
        # super()'s attach, and a cross-daemon actor call must carry the
        # trace context like every other hop.
        self._attach_trace(spec)
        rec = self.remote_actors.get(actor_id)
        with self.lock:
            state = self.actors.get(actor_id)
        if rec is None and state is None:
            # Maybe a named/foreign actor we learned about from the table
            # (e.g. a handle created by ANOTHER process, like a serve
            # controller's replica). A table entry that is still being
            # PLACED has no address yet — that is "not scheduled yet",
            # not "dead": wait (bounded) for placement instead of
            # sealing an ActorDiedError.
            deadline = (time.monotonic()
                        + _config.get("worker_lease_timeout_s"))
            while True:
                info = self.state.get_actor(actor_id.binary())
                if info is None or info.state == "DEAD":
                    break
                if info.address and info.address != self.address:
                    rec = _RemoteActorRecord(
                        actor_id, info.class_name, info.address,
                        info.node_id, None, info.name, info.namespace)
                    self.remote_actors[actor_id] = rec  # raylint: allow(data-race) GIL-atomic registry op; accessors use get/pop idioms and tolerate misses
                    break
                if info.address == self.address and info.address:
                    break  # ours after all; local path below
                if time.monotonic() > deadline:
                    break
                self._placement_wait(0.05)
        if rec is not None and rec.address != self.address:
            return self._submit_actor_remote(rec, actor_id, spec)
        ids = super().submit_actor_task(actor_id, spec)
        # Placement may have resolved to a remote node between our rec check
        # and the local enqueue: hand the mailbox over.
        rec = self.remote_actors.get(actor_id)
        if rec is not None and rec.address != self.address and state is not None:
            self._forward_mailbox(state, rec)
        return ids

    def _submit_actor_remote(self, rec: _RemoteActorRecord,
                             actor_id: ActorID, spec: TaskSpec):
        if not spec.return_ids:
            spec.return_ids = tuple(
                ObjectID.for_return(spec.task_id, i)
                for i in range(spec.options.num_returns))
        cancel = threading.Event()
        with self.lock:
            self.cancel_flags[spec.task_id] = cancel
            for rid in spec.return_ids:
                self.lineage[rid] = spec
            self.task_states[spec.task_id] = "RUNNING"
        for oid in _ref_ids_in(spec.args, spec.kwargs):
            self.reference_counter.pin_for_task(oid)
        spec.actor_id = actor_id
        premsg = self._spec_to_msg(spec)  # pickle OUTSIDE rec.lock: calls
        # to one actor must not serialize their neighbours' encoding time
        with rec.lock:  # order with any in-flight mailbox handoff
            self._push_task_remote(spec, rec.address, cancel,
                                   method=pb.ACTOR_CALL, premsg=premsg)
        return list(spec.return_ids)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        rec = self.remote_actors.get(actor_id)
        if rec is not None and rec.address != self.address:
            # The daemon always tears its instance down; restart semantics
            # live with the creator (us), so a single restart happens.
            try:
                self.pool.get(rec.address).call(
                    pb.KILL_ACTOR, pb.KillActorRequest(
                        actor_id=actor_id.binary(),
                        no_restart=True).SerializeToString(),
                    timeout=30)
            except (RpcConnectionError, TimeoutError, RpcRemoteError):
                pass
            rec.status = "DEAD"
            self.remote_actors.pop(actor_id, None)  # raylint: allow(data-race) GIL-atomic registry op; accessors use get/pop idioms and tolerate misses
            with self.lock:
                state = self.actors.get(actor_id)
            if state is not None:
                if no_restart:
                    self._mark_actor_dead(state, exc.ActorDiedError(
                        "actor was killed via ray_tpu.kill"))
                    self._sync_actor_info(state)
                else:
                    self._handle_remote_actor_death(
                        rec, exc.ActorDiedError("killed"))
            return
        super().kill_actor(actor_id, no_restart=no_restart)
        with self.lock:
            state = self.actors.get(actor_id)
        if state is not None:
            self._sync_actor_info(state)

    def cancel_task(self, task_id: TaskID, force: bool = False):
        super().cancel_task(task_id, force=force)
        # Sender half of the CANCEL_TASK arm: the local flag only stops
        # work this daemon still holds — a spec already pushed to a peer
        # must be cancelled where it runs, or it executes to completion.
        targets = set()
        with self._inflight_lock:
            for (tid, _attempt), info in self._inflight_remote.items():
                if tid == task_id:
                    targets.add(info["addr"])
        if not targets:
            return
        body = pb.CancelTaskRequest(task_id=task_id.binary(),
                                    force=force).SerializeToString()
        for addr in targets:
            try:
                self.pool.get(
                    addr, on_close=self._on_peer_conn_close,
                ).call_async(pb.CANCEL_TASK, body, lambda _env, _err: None)
            except Exception:
                logger.debug("cancel propagation to %s failed",
                             addr, exc_info=True)

    def get_named_actor(self, name: str, namespace: str = "default"):
        with self.lock:
            actor_id = self.named_actors.get((namespace, name))
            if actor_id is not None:
                state = self.actors.get(actor_id)
                if state is not None and state.status != ActorState.DEAD:
                    return state
        info = self.state.get_named_actor(name, namespace)
        if info is None or info.state == "DEAD":
            raise ValueError(
                f"no actor named {name!r} in namespace {namespace!r}")
        actor_id = ActorID(info.actor_id)
        rec = self.remote_actors.get(actor_id)
        if rec is None:
            rec = _RemoteActorRecord(actor_id, info.class_name, info.address,
                                     info.node_id, None, info.name,
                                     info.namespace)
            if info.address != self.address:
                self.remote_actors[actor_id] = rec  # raylint: allow(data-race) GIL-atomic registry op; accessors use get/pop idioms and tolerate misses
        return rec

    # ---------------------------------------------------- placement groups

    def _place_pg(self, pg):
        from ray_tpu_torch._private.scheduler import schedule_bundles
        deadline = time.monotonic() + _config.get("worker_lease_timeout_s")
        while time.monotonic() < deadline:
            states = self._cluster_states()
            assignment = schedule_bundles(states, pg.bundles, pg.strategy)
            if assignment is not None and self._reserve_bundles(pg, assignment):
                pg.bundle_nodes = assignment
                pg.state = "CREATED"
                pg.ready.set()
                self._register_pg_info(pg)
                self._kick()
                return
            self._placement_wait(0.05)
        pg.state = "INFEASIBLE"
        pg.ready.set()

    def _reserve_bundles(self, pg, assignment: List[NodeID]) -> bool:
        reserved: List[Tuple[int, NodeID]] = []
        ok = True
        for i, nid in enumerate(assignment):
            if nid == self.local_node.node_id:
                node = self.local_node
                with self.lock:
                    if node.resources.can_fit(pg.bundles[i]):
                        node.resources.allocate(pg.bundles[i])
                        node.bundles[(pg.pg_id, i)] = NodeResources(
                            pg.bundles[i])
                        reserved.append((i, nid))
                    else:
                        ok = False
                        break
            else:
                with self._view_lock:
                    addr = self._addr_by_node.get(nid.binary())
                if addr is None:
                    ok = False
                    break
                req = pb.BundleRequest(pg_id=pg.pg_id.binary(),
                                       bundle_index=i)
                for k, v in pg.bundles[i].to_dict().items():
                    req.resources.amounts[k] = v
                try:
                    env = self.pool.get(addr).call(
                        pb.RESERVE_BUNDLE, req.SerializeToString(), timeout=30)
                    rep = pb.BundleReply()
                    rep.ParseFromString(env.body)
                    if rep.ok:
                        reserved.append((i, nid))
                    else:
                        ok = False
                        break
                except (RpcConnectionError, TimeoutError, RpcRemoteError):
                    ok = False
                    break
        if ok:
            return True
        # Rollback.
        for i, nid in reserved:
            self._free_bundle(pg, i, nid)
        return False

    def _free_bundle(self, pg, index: int, nid: NodeID):
        if nid == self.local_node.node_id:
            node = self.local_node
            if node.bundles.pop((pg.pg_id, index), None) is not None:
                node.resources.release(pg.bundles[index])
            return
        with self._view_lock:
            addr = self._addr_by_node.get(nid.binary())
        if addr is None:
            return
        try:
            self.pool.get(addr).call(
                pb.FREE_BUNDLE, pb.BundleRequest(
                    pg_id=pg.pg_id.binary(),
                    bundle_index=index).SerializeToString(), timeout=30)
        except (RpcConnectionError, TimeoutError, RpcRemoteError):
            pass

    def remove_placement_group(self, pg_id: PlacementGroupID):
        with self.lock:
            pg = self.placement_groups.pop(pg_id, None)
        if pg is None:
            return
        if pg.bundle_nodes:
            for i, nid in enumerate(pg.bundle_nodes):
                self._free_bundle(pg, i, nid)
        try:
            self.state.remove_pg(pg_id.binary())
        except Exception as e:
            logger.debug("remove_pg failed: %s", e)
        self._kick()

    def _register_pg_info(self, pg):
        info = pb.PgInfo(pg_id=pg.pg_id.binary(), name=pg.name or "",
                         strategy=pg.strategy, state=pg.state,
                         creator_job=self.job_id.binary())
        for b in pg.bundles:
            rb = info.bundles.add()
            for k, v in b.to_dict().items():
                rb.amounts[k] = v
        for nid in (pg.bundle_nodes or []):
            info.bundle_nodes.append(nid.binary())
        try:
            self.state.register_pg(info)
        except Exception as e:
            logger.debug("register_pg failed: %s", e)

    # ------------------------------------------------------ inbound handler

    def _handle_rpc(self, ctx: RpcContext):
        method = ctx.method
        if method == pb.PING:
            ctx.reply(pb.PingReply(
                node_id=self.local_node.node_id.binary(),
                time_ms=time.time() * 1e3).SerializeToString())
        elif method == pb.PUSH_TASK:
            self._handle_push_task(ctx)
        elif method == pb.ACTOR_CALL:
            self._handle_actor_call(ctx)
        elif method == pb.CREATE_ACTOR:
            self._handle_create_actor(ctx)
        elif method == pb.KILL_ACTOR:
            req = pb.KillActorRequest()
            req.ParseFromString(ctx.body)
            super().kill_actor(ActorID(req.actor_id),
                               no_restart=req.no_restart)
            ctx.reply()
        elif method == pb.CANCEL_TASK:
            req = pb.CancelTaskRequest()
            req.ParseFromString(ctx.body)
            self.cancel_task(TaskID(req.task_id), force=req.force)
            ctx.reply()
        elif method == pb.FETCH_OBJECT:
            self._handle_fetch_object(ctx)
        elif method == pb.PUSH_OBJECT:
            self._handle_push_object(ctx)
        elif method == pb.GET_TIMELINE:
            self._handle_get_timeline(ctx)
        elif method == pb.NODE_DEBUG:
            self._handle_node_debug(ctx)
        elif method == pb.PUSH_TASK_BATCH:
            self._handle_push_task_batch(ctx)
        elif method == pb.P2P_DATA:
            req = pb.P2PDataMsg()
            req.ParseFromString(ctx.body)
            key = (req.group, req.src_rank, req.dst_rank, req.p2p_seq)
            now = time.monotonic()
            with self._p2p_cv:
                # ctx.raw is a fresh per-frame buffer: take ownership of
                # the tensor bytes instead of copying them (np.frombuffer
                # reads a bytearray just as well)
                self._p2p_box[key] = (req.dtype, tuple(req.shape),
                                      ctx.raw or b"", now)
                # TTL sweep: deliveries whose recv timed out (the
                # receiver's seq counter has moved past them) would
                # otherwise pin full tensors in memory forever.
                if len(self._p2p_box) > 8:
                    stale = [k for k, v in self._p2p_box.items()
                             if now - v[3] > 120.0]
                    for k in stale:
                        del self._p2p_box[k]
                self._p2p_cv.notify_all()
            ctx.reply()
        elif method == pb.RESERVE_BUNDLE:
            req = pb.BundleRequest()
            req.ParseFromString(ctx.body)
            resources = ResourceSet(dict(req.resources.amounts))
            pg_id = PlacementGroupID(req.pg_id)
            with self.lock:
                node = self.local_node
                if node.resources.can_fit(resources):
                    node.resources.allocate(resources)
                    node.bundles[(pg_id, req.bundle_index)] = NodeResources(
                        resources)
                    ok = True
                else:
                    ok = False
            ctx.reply(pb.BundleReply(ok=ok).SerializeToString())
            self._kick()
        elif method == pb.FREE_BUNDLE:
            req = pb.BundleRequest()
            req.ParseFromString(ctx.body)
            pg_id = PlacementGroupID(req.pg_id)
            with self.lock:
                node = self.local_node
                target = node.bundles.pop((pg_id, req.bundle_index), None)
                if target is not None:
                    node.resources.release(target.total)
            ctx.reply(pb.BundleReply(ok=True).SerializeToString())
            self._kick()
        elif method == pb.ADD_BORROW:
            req = pb.BorrowRequest()
            req.ParseFromString(ctx.body)
            self.reference_counter.add_borrow(ObjectID(req.object_id),
                                              req.borrower)
            ctx.reply()
        elif method == pb.REMOVE_BORROW:
            req = pb.BorrowRequest()
            req.ParseFromString(ctx.body)
            self.reference_counter.remove_borrow(ObjectID(req.object_id),
                                                 req.borrower)
            ctx.reply()
        elif method == pb.RELEASE_PIN:
            req = pb.FreeObjectRequest()
            req.ParseFromString(ctx.body)
            self.reference_counter.unpin_for_task(ObjectID(req.object_id))
            ctx.reply()
        elif method == pb.FREE_OBJECT:
            req = pb.FreeObjectRequest()
            req.ParseFromString(ctx.body)
            oid = ObjectID(req.object_id)
            self.local_node.store.free(oid)
            with self.lock:
                self.object_locations.pop(oid, None)
            ctx.reply()
        elif method == pb.WAIT_OBJECT:
            req = pb.WaitObjectRequest()
            req.ParseFromString(ctx.body)
            oid = ObjectID(req.object_id)
            deadline = time.monotonic() + req.timeout_ms / 1e3
            # Seal-event wait with BackoffPolicy pacing (not a fixed
            # 0.25s re-check): early attempts wake fast for objects that
            # land promptly, later ones settle toward the cap instead of
            # spinning a worker thread for the whole timeout.
            pace = BackoffPolicy(base_s=0.005, max_s=0.25, deadline_s=0,
                                 jitter=False)
            attempt = 0
            ready = False
            while time.monotonic() < deadline:
                if self.local_node.store.contains(oid):
                    ready = True
                    break
                self._wait_for_seal(
                    lambda: self.local_node.store.contains(oid),
                    min(max(0.001, pace.delay_for(attempt)),
                        max(0.0, deadline - time.monotonic())))
                attempt += 1
            ctx.reply(pb.WaitObjectReply(ready=ready).SerializeToString())
        # DRAIN is kept as an external compat surface: out-of-tree tooling
        # and older CLIs drain a daemon directly; in-tree drains ride
        # DRAIN_NODE via the state service.
        # raylint: allow(protocol) external/legacy direct-drain senders
        elif method == pb.DRAIN:
            # Graceful drain request straight to this daemon. An empty
            # body parses as the default DrainNodeRequest — the legacy
            # kill-style DRAIN — which now ALSO runs the orchestrator
            # (idle daemons decommission just as fast, busy ones stop
            # dropping in-flight work).
            req = pb.DrainNodeRequest()
            try:
                req.ParseFromString(ctx.body)
            except Exception:  # noqa: BLE001  # raylint: allow(swallow) legacy/garbage body: the default DrainNodeRequest is the kill-compatible drain
                pass
            ctx.reply()
            self.begin_drain(req.reason or "DRAIN rpc",
                             deadline_s=req.deadline_s or None)
        else:
            ctx.reply_error(f"unhandled method {method}")

    def _msg_to_spec(self, msg: pb.TaskSpecMsg) -> TaskSpec:
        if msg.named_function:
            # cross-language submission (C++ worker API): function by
            # registry name, language-neutral JSON positional args
            args = tuple(json.loads(bytes(msg.args_json).decode() or "[]"))
            kwargs = {}
        else:
            args, kwargs = cloudpickle.loads(msg.args_pickle)
        retry_exceptions: Any = False
        if msg.retry_exceptions_pickle:
            retry_exceptions = cloudpickle.loads(msg.retry_exceptions_pickle)
        runtime_env = (json.loads(msg.runtime_env_json.decode())
                       if msg.runtime_env_json else None)
        options = TaskOptions(
            num_returns=msg.num_returns,
            resources=ResourceSet(dict(msg.resources.amounts)),
            max_retries=msg.max_retries,
            retry_exceptions=retry_exceptions,
            runtime_env=runtime_env,
            name=msg.name or None,
        )
        spec = TaskSpec(
            task_id=TaskID(msg.task_id), job_id=JobID(msg.job_id),
            function=None, function_name=msg.function_name,
            args=args, kwargs=kwargs, options=options,
            return_ids=tuple(ObjectID(r) for r in msg.return_ids),
            attempt=msg.attempt,
            trace_id=msg.trace_id, parent_span_id=msg.parent_span_id,
            # Stamp arrives in the service timebase (see _spec_to_msg);
            # rebase onto this host's clock so the execute-site delta is
            # a plain local time.time() subtraction.
            perf_submit_s=(clocksync.to_local_s(msg.perf_submit_s)
                           if msg.perf_submit_s else 0.0))
        if msg.actor_id:
            spec.actor_id = ActorID(msg.actor_id)
            spec.method_name = msg.method_name
        elif msg.named_function:
            spec.function = self._load_named_function(msg.named_function)
            spec._json_results = bool(msg.json_results)
        else:
            spec.function = self._load_callable(bytes(msg.fn_hash))
        if msg.pg_id:
            spec._dist_pg = (PlacementGroupID(msg.pg_id), msg.pg_bundle_index)
        return spec

    def _admission_check(self, resources: ResourceSet) -> bool:
        """Could this request EVER fit here (totals, not availability)?"""
        return resources.is_subset_of(self.local_node.resources.total)

    def _spillback_reply(self, ctx: RpcContext, saturated: bool = False):
        """``saturated``: admission-queue spillback. The raw resource
        snapshot would not explain the rejection (CPUs may be free), and
        advertising it makes the caller re-select this daemon in a hot
        loop — advertise ZERO availability instead, so the caller's view
        deprioritizes us until the next heartbeat refresh (~0.5s), a
        natural backoff."""
        rep = pb.PushTaskReply(status="spillback")
        if not saturated:
            for k, v in (self.local_node.resources.available
                         .to_dict().items()):
                rep.available.amounts[k] = v
        ctx.reply(rep.SerializeToString())

    def _dedupe_pushed_task(self, ctx: RpcContext, msg: pb.TaskSpecMsg
                            ) -> bool:
        """A caller that saw a spurious failure signal may re-push an
        attempt we already admitted (the reference raylet drops duplicate
        leases the same way). Returns True when the push was absorbed:
        either attached as an extra reply hook to the still-running task or
        answered immediately from sealed results."""
        tid = TaskID(msg.task_id)
        return_ids = tuple(ObjectID(r) for r in msg.return_ids)
        shim = None
        cached = None
        with self.lock:
            st = self.task_states.get(tid)
            if st in ("PENDING", "RUNNING", "RESUBMITTED"):
                self.completion_hooks.setdefault(tid, []).append(
                    lambda s: self._reply_task_outcome(ctx, s))
                return True
            if st in ("FINISHED", "FAILED", "CANCELLED"):
                cached = self._reply_bytes_cache.get(tid)
                if cached is not None:
                    # Inline results were freed when the first reply was
                    # built — replay those exact bytes, never re-execute.
                    pass
                elif return_ids and all(self.local_node.store.contains(r)
                                        for r in return_ids):
                    shim = TaskSpec(
                        task_id=tid, job_id=JobID(msg.job_id), function=None,
                        function_name=msg.function_name, args=(), kwargs={},
                        options=TaskOptions(num_returns=msg.num_returns),
                        return_ids=return_ids)
                else:
                    # Results gone AND no cached reply (evicted):
                    # re-execute fresh.
                    self.task_states.pop(tid, None)
        if cached is not None:
            ctx.reply(cached)
            return True
        if shim is not None:
            self._reply_task_outcome(ctx, shim)
            return True
        return False

    def _handle_push_task_batch(self, ctx: RpcContext):
        """Fan a TaskBatchMsg out into per-task contexts: each task's
        admission outcome/completion replies on its caller-allocated seq
        exactly as an individually-pushed task would."""
        batch = pb.TaskBatchMsg()
        batch.ParseFromString(ctx.body)
        ctx._done = True  # the batch envelope itself gets no reply
        for seq, task in zip(batch.seqs, batch.tasks):
            child = ctx.child(seq, pb.PUSH_TASK)
            try:
                self._handle_push_task(child, msg=task)
            except Exception as e:  # noqa: BLE001 - isolate per task
                child.reply_error(f"{type(e).__name__}: {e}")

    def _handle_push_task(self, ctx: RpcContext, msg=None):
        if msg is None:
            msg = pb.TaskSpecMsg()
            msg.ParseFromString(ctx.body)
        if self._dedupe_pushed_task(ctx, msg):
            return
        try:
            spec = self._msg_to_spec(msg)
        except Exception as e:  # noqa: BLE001 — deserialization failure
            rep = pb.PushTaskReply(status="ok",
                                   error_pickle=pickle.dumps(
                                       exc.RayTpuError(
                                           f"task deserialization failed: "
                                           f"{type(e).__name__}: {e}")))
            if msg.json_results:
                # cross-language caller: it cannot unpickle the error
                rep.error_message = f"{type(e).__name__}: {e}"
            ctx.reply(rep.SerializeToString())
            return
        if self._drain_started:
            # DRAINING: hand the task straight back (saturated spillback
            # advertises zero availability, so the caller's view
            # deprioritizes us) — the backoff path re-routes it.
            self._spillback_reply(ctx, saturated=True)
            return
        if not self._admission_check(spec.options.resources):
            self._spillback_reply(ctx)
            return
        # OOM guard (memory_monitor.h role): a host above the memory
        # threshold sheds new work instead of letting the kernel kill
        # the device-owner daemon; the caller re-routes or retries.
        if (self.memory_monitor is not None
                and self.memory_monitor.is_over_threshold()):
            self._spillback_reply(ctx, saturated=True)
            return
        # Bounded admission (push_manager/backpressure half of the
        # reference's lease policy): a daemon whose pending queue is deep
        # spills back instead of absorbing unbounded work — the caller's
        # scheduler re-routes or retries with its grace period.
        with self._pending_cv:
            depth = len(self._pending) + self._dispatch_pass_n
        if depth >= _config.get("daemon_admission_queue_limit"):
            self._spillback_reply(ctx, saturated=True)
            return
        with self.lock:
            self.completion_hooks.setdefault(spec.task_id, []).append(
                lambda s: self._reply_task_outcome(ctx, s))
        # Execute here (the caller placed it) — never re-forward through
        # our own view; _exec_local pins dispatch to this node.
        spec._exec_local = True
        spec.options.scheduling_strategy = "DEFAULT"
        self.submit_task(spec)

    def _handle_actor_call(self, ctx: RpcContext):
        msg = pb.TaskSpecMsg()
        msg.ParseFromString(ctx.body)
        if self._dedupe_pushed_task(ctx, msg):
            return
        try:
            spec = self._msg_to_spec(msg)
        except Exception as e:  # noqa: BLE001
            rep = pb.PushTaskReply(status="ok", error_pickle=pickle.dumps(
                exc.RayTpuError(f"actor call deserialization failed: {e}")))
            ctx.reply(rep.SerializeToString())
            return
        with self.lock:
            self.completion_hooks.setdefault(spec.task_id, []).append(
                lambda s: self._reply_task_outcome(ctx, s))
        Runtime.submit_actor_task(self, spec.actor_id, spec)

    def _reply_task_outcome(self, ctx: RpcContext, spec: TaskSpec):
        """Completion hook: turn sealed local results into a PushTaskReply.

        The reply bytes are built ONCE per task and cached: a duplicate
        push attaches a second hook, and rebuilding would race the first
        build's store.free (inline results are freed on consumption) —
        the second reply would otherwise advertise a freed object."""
        with self.lock:
            cached = self._reply_bytes_cache.get(spec.task_id)
        if cached is not None:
            ctx.reply(cached)
            return
        rep = pb.PushTaskReply(status="ok")
        store = self.local_node.store
        err: Optional[BaseException] = None
        for rid in spec.return_ids:
            e = store.peek_error(rid)
            if e is not None:
                err = e
                break
        if err is not None:
            rep.error_message = f"{type(err).__name__}: {err}"
            try:
                rep.error_pickle = cloudpickle.dumps(err)
            except Exception as pe:
                rep.error_pickle = cloudpickle.dumps(
                    exc.RayTpuError(f"unpicklable error: {err!r} ({pe})"))
            # Error consumed by the caller; free local copies.
            for rid in spec.return_ids:
                store.free(rid)
        else:
            json_results = getattr(spec, "_json_results", False)
            for rid in spec.return_ids:
                payload: Optional[bytes] = None
                try:
                    value = store.get(rid, timeout=0)
                    if json_results:
                        # cross-language caller: language-neutral result,
                        # always inline (it cannot unpickle a fetch) — and
                        # an unserializable result must surface as an
                        # error, not linger unreachable in the store
                        try:
                            # allow_nan=False: Python would emit the
                            # non-standard NaN/Infinity tokens, which
                            # strict parsers in other languages reject
                            payload = json.dumps(
                                value, allow_nan=False).encode()
                        except (TypeError, ValueError):
                            rep.error_message = (
                                f"task result of type "
                                f"{type(value).__name__} is not "
                                f"JSON-serializable (cross-language "
                                f"callers require JSON results)")
                            for r2 in spec.return_ids:
                                store.free(r2)
                            del rep.inline[:]
                            del rep.inline_results[:]
                            break
                        rep.inline.append(True)
                        rep.inline_results.append(payload)
                        store.free(rid)
                        with self.lock:
                            self.object_locations.pop(rid, None)
                        continue
                    if (isinstance(value, torch.Tensor)
                            and value.nbytes > INLINE_RESULT_MAX):
                        # too large to inline: kept for FETCH_OBJECT,
                        # without a device-to-host copy just to measure it
                        payload = None
                    else:
                        payload = _dumps_value(value)
                except Exception as e:
                    logger.debug("result pickling failed; keeping non-inline: %s", e)
                    payload = None
                if payload is not None and len(payload) <= INLINE_RESULT_MAX:
                    rep.inline.append(True)
                    rep.inline_results.append(payload)
                    store.free(rid)
                    with self.lock:
                        self.object_locations.pop(rid, None)
                else:
                    rep.inline.append(False)
                    rep.inline_results.append(b"")
                    # Keep + advertise for remote fetch; the caller owns the
                    # ref lifetime, we hold the primary copy.
                    try:
                        self.state.add_location(
                            rid.binary(), self.local_node.node_id.binary())
                    except Exception as e:
                        logger.debug("add_location failed: %s", e)
        data = rep.SerializeToString()
        with self.lock:
            self._reply_bytes_cache[spec.task_id] = data
            while len(self._reply_bytes_cache) > 512:
                stale_key = next(iter(self._reply_bytes_cache), None)
                if stale_key is None:
                    break
                self._reply_bytes_cache.pop(stale_key, None)
        ctx.reply(data)

    def _actor_alloc_target(self, options, node):
        """Allocation source for a remotely-created actor: its placement
        group's bundle on this node, or the node free pool (mirrors
        _allocation_target for pushed tasks)."""
        pg = getattr(options, "placement_group", None)
        if pg is None:
            return node.resources
        idx = getattr(options, "placement_group_bundle_index", -1)
        if idx is not None and idx >= 0:
            return node.bundles.get((pg.id, idx))
        request = options.resources
        for (pgid, i), br in node.bundles.items():
            if pgid == pg.id and br.can_fit(request):
                return br
        for (pgid, i), br in node.bundles.items():
            if pgid == pg.id:
                return br
        return None

    def _handle_create_actor(self, ctx: RpcContext):
        msg = pb.ActorSpecMsg()
        msg.ParseFromString(ctx.body)
        if self._drain_started:
            # DRAINING: never host a new actor on a node about to die.
            ctx.reply(pb.CreateActorReply(
                status="spillback").SerializeToString())
            return
        try:
            cls = self._load_callable(bytes(msg.cls_hash))
            args, kwargs = cloudpickle.loads(msg.args_pickle)
            options = cloudpickle.loads(msg.options_pickle)
        except Exception as e:  # noqa: BLE001
            ctx.reply(pb.CreateActorReply(
                status="error", error_pickle=pickle.dumps(
                    exc.ActorDiedError(
                        f"actor deserialization failed: {e}"))
            ).SerializeToString())
            return
        request = options.resources
        if not request.is_subset_of(self.local_node.resources.total):
            rep = pb.CreateActorReply(status="spillback")
            for k, v in self.local_node.resources.available.to_dict().items():
                rep.available.amounts[k] = v
            ctx.reply(rep.SerializeToString())
            return
        state = ActorState(ActorID(msg.actor_id), cls, args, kwargs, options,
                           None, msg.namespace)  # name registered by creator
        state.restart_count = msg.restart_count
        with self.lock:
            self.actors[state.actor_id] = state
        node = self.local_node
        # Short capacity wait only: a busy node must spill back fast so the
        # creator can re-place on a peer instead of burning its whole lease
        # budget blocked on us (raylet-style immediate rejection).
        deadline = time.monotonic() + min(
            2.0, _config.get("worker_lease_timeout_s"))
        first_pass = True
        while True:
            with self.lock:
                # Placement-group actors draw from their RESERVED bundle
                # (the free pool was already debited at RESERVE_BUNDLE).
                target = self._actor_alloc_target(options, node)
                if first_pass:
                    first_pass = False
                    logger.debug("create %s: target=%r fit=%s", msg.class_name,
                                 target, target is not None
                                 and target.can_fit(request))
                if target is not None and target.can_fit(request):
                    target.allocate(request)
                    break
            if time.monotonic() > deadline:
                with self.lock:
                    self.actors.pop(state.actor_id, None)  # never hosted
                pg = getattr(options, "placement_group", None)
                logger.debug(
                    "spillback CREATE_ACTOR %s: request=%s pg=%s idx=%s "
                    "bundles=%s free=%s", msg.class_name, request,
                    pg.id.hex()[:8] if pg is not None else None,
                    getattr(options, "placement_group_bundle_index", None),
                    [(k[0].hex()[:8], k[1], str(v.available))
                     for k, v in node.bundles.items()],
                    node.resources.available)
                rep = pb.CreateActorReply(status="spillback")
                for k, v in node.resources.available.to_dict().items():
                    rep.available.amounts[k] = v
                ctx.reply(rep.SerializeToString())
                return
            self._placement_wait(0.02)
        state.node_id = node.node_id
        state.devices = self._assign_devices(request, node)
        self._start_actor_on_node(state, node, request)
        state.ready.wait(timeout=_config.get("worker_lease_timeout_s"))
        if state.status == ActorState.DEAD:
            ctx.reply(pb.CreateActorReply(
                status="error", error_pickle=pickle.dumps(
                    state.death_cause or exc.ActorDiedError("init failed"))
            ).SerializeToString())
            return
        ctx.reply(pb.CreateActorReply(status="ok").SerializeToString())

    def _serialized_for_fetch(self, oid: ObjectID) -> FramedPayload:
        """Serialize once per object for chunked pulls (small MRU cache so a
        multi-chunk fetch doesn't re-pickle per chunk). The payload is a
        ``FramedPayload``: array bytes stay in their source buffers and
        each served chunk leaves as a scatter-gather list — serving a
        multi-GB object never materializes the frame."""
        with self._fetch_cache_lock:
            hit = self._fetch_cache.get(oid)
            if hit is not None:
                return hit[0]
        value = self.local_node.store.get(oid, timeout=0)
        # Frame provenance: the serving trace is embedded ONCE, at frame
        # construction — the cached payload is shared across concurrent
        # fetch requests, so a per-request stamp would be wrong.
        trace = (observability.wire_context().encode("ascii")
                 if observability.ENABLED else b"")
        payload = FramedPayload(value, trace, pickler=TensorPickler)
        with self._fetch_cache_lock:
            self._fetch_cache[oid] = [payload, None]
            while len(self._fetch_cache) > 8:
                self._fetch_cache.pop(next(iter(self._fetch_cache)))
        return payload

    def _fetch_arena_key(self, oid: ObjectID, payload: bytes) -> bytes:
        """Content-bound arena key for a fetch payload, hashed ONCE per
        cached serialization: blake2b over a multi-MB payload costs more
        than the shm handoff itself, and the key is pure function of
        (oid, payload) — the cache entry dies with the payload, so a
        reconstructed object with different bytes gets a fresh key."""
        with self._fetch_cache_lock:
            entry = self._fetch_cache.get(oid)
            if entry is not None and entry[0] is payload \
                    and entry[1] is not None:
                return entry[1]
        key = self._arena_payload_key(oid, payload)
        with self._fetch_cache_lock:
            entry = self._fetch_cache.get(oid)
            if entry is not None and entry[0] is payload:
                entry[1] = key
        return key

    def _flight_state(self) -> Dict[str, Any]:
        """Per-tick flight-recorder state: who this runtime is and how its
        control-plane link looked at spool time (bundle forensics)."""
        return {
            "node_id": self.local_node.node_id.hex(),
            "heartbeat_misses": self.heartbeat_misses,
            "heartbeat_last_success": self.heartbeat_last_success,
            "hb_stopped": self._hb_stop.is_set(),
        }

    def _handle_node_debug(self, ctx: RpcContext):
        """Dashboard drill-down feed: recent log lines (in-process ring,
        ``log_ring.py``) + this daemon's task-state rows (the per-node
        half of ``dashboard/modules/log/log_agent.py:1`` and the task
        table the reference aggregates via GCS)."""
        from ray_tpu_torch._private import log_ring
        req = pb.NodeDebugRequest()
        req.ParseFromString(ctx.body)
        payload: Dict[str, Any] = {}
        if req.log_lines:
            payload["logs"] = log_ring.tail(int(req.log_lines),
                                            trace_id=req.trace_filter)
        if req.include_metrics:
            payload["metrics"] = _metrics.snapshot()
        if req.include_stacks:
            # live hang diagnosis: the doctor samples stacks of a host
            # whose heartbeats are missing but whose RPC plane still answers
            from ray_tpu_torch.observability import recorder as _flight
            payload["stacks"] = _flight.thread_stacks()
            payload["inflight"] = _flight.inflight_snapshot()
            # Sampling profiler (perf plane): cumulative folded-stack
            # profile rides the same reply, so /api/profile federates
            # without a new proto field (windows are diffed head-side).
            from ray_tpu_torch.observability import sampler as _sampler
            prof = _sampler.profile_snapshot()
            if prof is not None:
                payload["profile"] = prof
        if req.include_bundles:
            # cluster-wide forensics without a shared filesystem: each
            # daemon ships its host's recordings + sealed crash bundles
            from ray_tpu_torch.observability import recorder as _flight
            payload["forensics"] = _flight.disk_report()
        if req.include_tasks:
            cap = int(req.max_tasks) or 1000
            with self.lock:
                # most-recent N only: a long-lived daemon holds a row per
                # task it ever ran, and one drill-down click must not
                # JSON-encode (or ship) the full history
                items = list(self.task_states.items())[-cap:]
                wanted = {tid for tid, _ in items}
                names = {spec.task_id: spec.function_name
                         for spec in self.lineage.values()
                         if spec.task_id in wanted}
            payload["tasks"] = [
                {"task_id": tid.hex(), "state": st,
                 "name": names.get(tid, "?")}
                for tid, st in items]
        ctx.reply(pb.NodeDebugReply(
            payload_json=json.dumps(payload).encode()).SerializeToString())

    def _handle_get_timeline(self, ctx: RpcContext):
        """Span-buffer fetch/control (cross-process trace propagation:
        the driver's ``ray_tpu.timeline()`` merges every daemon's spans
        into one chrome-tracing file, the reference's ``ray timeline``
        over GCS-aggregated profile events)."""
        from ray_tpu_torch._private.profiling import get_profiler
        req = pb.TimelineRequest()
        req.ParseFromString(ctx.body)
        if req.set_enabled or req.set_tracing:
            # pure toggle: the caller discards the reply — don't JSON a
            # potentially multi-MB span buffer for nothing
            if req.set_enabled:
                _config.set("profiling_enabled", bool(req.enabled))
            if req.set_tracing:
                if req.tracing:
                    observability.enable()
                else:
                    observability.disable()
            ctx.reply(pb.TimelineReply(
                spans_json=b"[]").SerializeToString())
            return
        prof = get_profiler()
        spans = prof.chrome_trace()
        if req.clear:
            prof.clear()
        ctx.reply(pb.TimelineReply(
            spans_json=json.dumps(spans).encode()).SerializeToString())

    def set_cluster_profiling(self, enabled: bool) -> None:
        """Flip profiling on the driver AND every alive daemon."""
        _config.set("profiling_enabled", bool(enabled))
        for addr in self._alive_daemon_addrs():
            try:
                self.pool.get(addr).call(
                    pb.GET_TIMELINE, pb.TimelineRequest(
                        set_enabled=True,
                        enabled=bool(enabled)).SerializeToString(),
                    timeout=10)
            except Exception as e:
                logger.debug("timeline toggle push failed: %s", e)

    def set_cluster_tracing(self, enabled: bool) -> None:
        """Flip trace-context propagation on the driver AND every alive
        daemon (implies span recording: tracing without a ring to land
        spans in would be pure overhead)."""
        if enabled:
            observability.enable()
        else:
            observability.disable()
        for addr in self._alive_daemon_addrs():
            try:
                self.pool.get(addr).call(
                    pb.GET_TIMELINE, pb.TimelineRequest(
                        set_tracing=True,
                        tracing=bool(enabled)).SerializeToString(),
                    timeout=10)
            except Exception as e:
                logger.debug("tracing toggle push failed: %s", e)

    def cluster_timeline(self) -> list:
        """Local spans + every alive daemon's (distinct pids per node)."""
        from ray_tpu_torch._private.profiling import get_profiler
        spans = list(get_profiler().chrome_trace())
        for addr in self._alive_daemon_addrs():
            try:
                rep = pb.TimelineReply()
                rep.ParseFromString(self.pool.get(addr).call(
                    pb.GET_TIMELINE,
                    pb.TimelineRequest().SerializeToString(),
                    timeout=30).body)
                spans.extend(json.loads(bytes(rep.spans_json).decode()))
            except Exception as e:
                logger.debug("timeline fetch failed: %s", e)
        return spans

    def _alive_daemon_addrs(self) -> List[str]:
        # membership in the CURRENT view is required: _addr_by_node is an
        # append-only address cache, and treating its stale entries as
        # alive would aim RPCs (with long timeouts) at dead daemons
        with self._view_lock:
            return [a for nid, a in self._addr_by_node.items()
                    if a and a != self.address
                    and nid in self._view and self._view[nid].alive]

    def _handle_push_object(self, ctx: RpcContext):
        """Receiver half of the push path: chunks land DIRECTLY in the
        object's final resting place (an unsealed store recv buffer — the
        native arena when it fits); at EOF the buffer seals and the store
        serves the framed payload in place, exactly like a completed pull
        (location advertised), so the executor resolves it locally. No
        BytesIO accumulation, no decode+re-pickle round trip."""
        req = pb.PushObjectRequest()
        req.ParseFromString(ctx.body)
        oid = ObjectID(req.object_id)
        rep = pb.PushObjectReply(accepted=True)
        store = self.local_node.store

        def _drop_locked(o):
            if self._incoming_pushes.pop(o, None) is not None:
                store.abort_recv_buffer(o)
            self._incoming_push_seen.pop(o, None)

        if store.contains(oid):
            rep.accepted = False
            with self._incoming_pushes_lock:
                _drop_locked(oid)
            ctx.reply(rep.SerializeToString())
            return
        chunk = req.data or ctx.raw or b""
        done = False
        now = time.monotonic()
        with self._incoming_pushes_lock:
            # expire half-received streams whose sender died without eof —
            # they must not accumulate for the daemon's lifetime
            for stale in [o for o, t in self._incoming_push_seen.items()
                          if now - t > 60.0]:
                _drop_locked(stale)
            # rec = [dest_view, {offset: nbytes}, filled, eof_seen].
            # Chunks arrive in ANY order (striped senders interleave
            # streams) and may arrive twice (failover retries a chunk
            # whose reply was lost) — every chunk carries total_size, so
            # any chunk can open the buffer, and duplicate offsets are
            # idempotent overwrites. The buffer seals once an eof chunk
            # was seen AND every byte is accounted for.
            rec = self._incoming_pushes.get(oid)
            if rec is None:
                dest = store.create_recv_buffer(oid, req.total_size)
                if dest is None:      # sealed locally while we raced
                    rep.accepted = False
                    ctx.reply(rep.SerializeToString())
                    return
                rec = self._incoming_pushes[oid] = [dest, {}, 0, False]
            self._incoming_push_seen[oid] = now
            n = len(chunk)
            if (req.total_size != len(rec[0])
                    or req.offset + n > len(rec[0])):
                _drop_locked(oid)     # sender lied about total_size
                rep.accepted = False
                ctx.reply(rep.SerializeToString())
                return
            if n:
                prev = rec[1].get(req.offset)
                if prev is not None:
                    rec[2] -= prev    # duplicate delivery: replace, once
                rec[0][req.offset:req.offset + n] = chunk
                rec[1][req.offset] = n
                rec[2] += n
            if req.eof:
                rec[3] = True
            if rec[3] and rec[2] >= len(rec[0]):
                self._incoming_pushes.pop(oid, None)
                self._incoming_push_seen.pop(oid, None)
                done = True
        if done:
            store.seal_recv_buffer(oid)
            with self.lock:
                self.object_locations[oid] = self.local_node.node_id
            try:
                self.state.add_location(
                    oid.binary(), self.local_node.node_id.binary())
            except Exception as e:
                logger.debug("add_location failed: %s", e)
        ctx.reply(rep.SerializeToString())

    def _handle_fetch_object(self, ctx: RpcContext):
        req = pb.FetchObjectRequest()
        req.ParseFromString(ctx.body)
        if req.arena_key.startswith("ckpt:"):
            # Checkpoint restore rides the same FETCH_OBJECT bulk lane
            # (the pb schema is frozen without protoc): the arena_key
            # carries the content hash instead of naming a shared arena.
            self._handle_fetch_ckpt_chunk(ctx, req)
            return
        oid = ObjectID(req.object_id)
        store = self.local_node.store
        rep = pb.FetchObjectReply()
        if not store.contains(oid):
            rep.found = False
            ctx.reply(rep.SerializeToString())
            return
        err = store.peek_error(oid)
        if err is not None:
            rep.found = True
            try:
                rep.error_pickle = cloudpickle.dumps(err)
            except Exception as pe:
                rep.error_pickle = cloudpickle.dumps(
                    exc.RayTpuError(f"unpicklable error: {err!r} ({pe})"))
            ctx.reply(rep.SerializeToString())
            return
        try:
            payload = self._serialized_for_fetch(oid)
        except exc.RayTpuError as e:
            # A device object written in place after put: the fetcher gets
            # the error an in-process get raises.
            rep.found = True
            rep.error_pickle = cloudpickle.dumps(e)
            ctx.reply(rep.SerializeToString())
            return
        except Exception as e:  # noqa: BLE001 — freed underneath us
            logger.debug("object freed during fetch: %s", e)
            rep.found = False
            ctx.reply(rep.SerializeToString())
            return
        rep.found = True
        rep.total_size = len(payload)
        # Same-host requester: hand the payload over through the shared
        # arena instead of streaming it back over TCP.
        if (req.offset == 0 and req.arena_key
                and req.arena_key == self.host_arena_key
                and self.host_arena is not None):
            key = self._fetch_arena_key(oid, payload)
            if (self.host_arena.contains(key)
                    or self._arena_put(key, payload)):
                rep.in_arena = True
                rep.arena_object_key = key
                rep.eof = True
                ctx.reply(rep.SerializeToString())
                return
        end = min(len(payload),
                  req.offset + (req.max_bytes or transport.fetch_chunk_bytes()))
        rep.eof = end >= len(payload)
        # Bulk lane: the chunk leaves via gather-write (sendmsg) straight
        # from the source buffers of the cached FramedPayload — no slice
        # copy, no frame materialization, no protobuf copy (rep.data stays
        # empty; raw_len announces the bytes).
        ctx.reply(rep.SerializeToString(), raw=payload.slices(req.offset, end))

    def _handle_fetch_ckpt_chunk(self, ctx: RpcContext,
                                 req: "pb.FetchObjectRequest"):
        """Serve one content-addressed checkpoint chunk over the bulk
        lane. ``arena_key="ckpt:<sha256>"`` names the chunk; the engine
        validates the id (hex-only — no path traversal) and resolves it
        against its registered serve roots. ``max_bytes == 0`` means the
        whole chunk (restore stripes whole chunks, not chunk slices).
        Chunks are immutable once written, so a plain read is safe."""
        from ray_tpu_torch.checkpoint import engine as ckpt_engine
        rep = pb.FetchObjectReply()
        try:
            data = ckpt_engine.read_served_chunk(req.arena_key[5:])
        except Exception as e:  # noqa: BLE001 — disk trouble = not found
            logger.debug("ckpt chunk serve failed: %s", e)
            data = None
        if data is None:
            rep.found = False
            ctx.reply(rep.SerializeToString())
            return
        rep.found = True
        rep.total_size = len(data)
        end = (len(data) if not req.max_bytes
               else min(len(data), req.offset + req.max_bytes))
        rep.eof = end >= len(data)
        ctx.reply(rep.SerializeToString(),
                  raw=[memoryview(data)[req.offset:end]])


_FETCH_MISS = object()

# Framed out-of-band serialization lives in framing.py (RTF5 layout,
# shared with object_store.py's arena receive slots). Only the arena
# pin-release finalizer is local.


def _release_arena_pin(arena, key: bytes):
    try:
        arena.release(key)
    except Exception as e:
        logger.debug("arena pin release failed: %s", e)
        pass  # arena closed/shutdown: the pin died with the connection


class _PushManager:
    """Owner-side proactive object pushes with per-peer backpressure.

    The role of the reference's PushManager
    (``src/ray/object_manager/push_manager.h:29``): when a task is pushed
    to a remote daemon, its large argument objects are streamed there
    ahead of execution so the executor's ``_resolve_refs`` finds them
    locally instead of stalling on a pull. In-flight bytes per peer are
    capped (``object_push_window_bytes``); pushes are an optimization —
    any failure falls back silently to the authoritative pull path.
    """

    def __init__(self, rt: "DistributedRuntime"):
        from concurrent.futures import ThreadPoolExecutor
        self.rt = rt
        self.window = int(_config.get("object_push_window_bytes"))
        self._cv = threading.Condition()
        self._inflight: Dict[str, int] = {}       # addr -> bytes on the wire
        self._active: set = set()                 # (addr, oid) deduplication  # raylint: guarded-by(self._cv)
        self._pool = ThreadPoolExecutor(max_workers=4,
                                        thread_name_prefix="obj-push")
        self._closed = False
        self.pushes_initiated = 0  # monotone; observable in tests/metrics  # raylint: guarded-by(self._cv)

    def maybe_push(self, addr: str, oid: ObjectID, threshold: int):
        # Pushes are optional: shed them outright while the peer's circuit
        # breaker is open instead of tying up a push worker on timeouts
        # (the pull path stays authoritative if the peer is actually fine).
        # Passive state check, NOT allow(): a push must never claim the
        # half-open probe slot — task pushes are the probe traffic.
        if self.rt.breakers.get(addr).state_code() == 2:
            return
        with self._cv:
            if self._closed or (addr, oid) in self._active:
                return
            self._active.add((addr, oid))
            self.pushes_initiated += 1
        self._pool.submit(self._run, addr, oid, threshold)

    def _run(self, addr: str, oid: ObjectID, threshold: int):
        t0 = 0.0
        try:
            payload = self.rt._serialized_for_fetch(oid)
            total = len(payload)
            if total < threshold:
                return
            if perf.ENABLED:
                t0 = time.monotonic()
            # Bulk bytes ride a shared-pool data stream (one per object,
            # picked deterministically so chunks of the same object stay
            # ordered on one socket), keeping pushes off the multiplexed
            # control connection; pool disabled -> control lane fallback.
            streams = self.rt._data_streams.clients(addr)
            if streams:
                pick = int.from_bytes(oid.binary()[:4], "little")
                client = streams[pick % len(streams)]
            else:
                client = self.rt.pool.get(addr)
            chunk_sz = transport.fetch_chunk_bytes()
            offset = 0
            while offset < total or offset == 0:
                if chaos.ENABLED and chaos.inject(
                        "object.push", peer=addr,
                        object=oid.hex()[:8]) == "drop":
                    return  # abandon the push; pull path authoritative
                end = min(total, offset + chunk_sz)
                n = end - offset
                eof = end >= total
                with self._cv:
                    while (not self._closed
                           and self._inflight.get(addr, 0) + n > self.window
                           and self._inflight.get(addr, 0) > 0):
                        self._cv.wait(timeout=1.0)
                    if self._closed:
                        return
                    self._inflight[addr] = self._inflight.get(addr, 0) + n
                try:
                    rep = pb.PushObjectReply()
                    # Chunk rides the bulk lane as a gather list straight
                    # from the payload's source buffers — no slice copy,
                    # no protobuf copy (data stays empty).
                    rep.ParseFromString(client.call(
                        pb.PUSH_OBJECT, pb.PushObjectRequest(
                            object_id=oid.binary(), offset=offset,
                            total_size=total,
                            eof=eof).SerializeToString(), timeout=120,
                        raw=payload.slices(offset, end)).body)
                finally:
                    with self._cv:
                        self._inflight[addr] = max(
                            0, self._inflight.get(addr, 0) - n)
                        self._cv.notify_all()
                if not rep.accepted:
                    return  # receiver already has it
                offset = end
                if eof:
                    self.rt.breakers.record_success(addr)
                    return
        except Exception as e:
            logger.debug("object push failed; pull path authoritative: %s", e)
            if isinstance(e, (ConnectionError, TimeoutError, OSError)):
                self.rt.breakers.record_failure(addr)
        finally:
            if t0:
                perf.observe("push.object", (time.monotonic() - t0) * 1e3)
            with self._cv:
                self._active.discard((addr, oid))

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._pool.shutdown(wait=False, cancel_futures=True)
