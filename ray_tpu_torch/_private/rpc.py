"""RPC substrate: length-prefixed protobuf frames over TCP.

The L1 layer (the reference's ``src/ray/rpc/`` gRPC wrappers, redesigned):
one socket per client→server direction carries multiplexed request/reply
frames matched by ``seq``, plus unsolicited server pushes (``seq=0``) for
pubsub. Long-running requests (task pushes) keep their seq open until the
work finishes — the reply IS the completion notification, so there is no
separate polling or callback channel (the reference needs PushTask +
reply + pubsub for the same round trip).

Wire format: ``4-byte big-endian length | Envelope protobuf`` — see
``ray_tpu_torch/protocol/raytpu.proto`` (the JAX package's schema).
"""

from __future__ import annotations

import hmac
import logging
import os
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch import chaos, observability
from ray_tpu_torch._private.config import _config
from ray_tpu_torch.observability import perf
from ray_tpu_torch.protocol import pb

# raylint: hot-path  (payload plane: R8 flags hidden payload copies)
logger = logging.getLogger("ray_tpu")

# Runtime half of R19: under RAY_TPU_LOCKWATCH, synchronous RPC waits and
# handler executions become pseudo-lock sites (``rpc:<METHOD>``) in the
# lockwatch order graph, so a lock held across the wire closes the same
# CYCLE the static rule names. None (the default) keeps this a dead branch.
_lockwatch = None
if os.environ.get("RAY_TPU_LOCKWATCH"):
    from ray_tpu_torch.devtools import lockwatch as _lockwatch

MAX_FRAME = 1 << 31  # 2 GiB hard cap per frame
_LEN = struct.Struct(">I")


def default_auth_token() -> Optional[bytes]:
    """The cluster's shared secret, if one is set for this process.

    Minted by the head node at cluster start (scripts/cluster.py) and
    distributed out-of-band (run-dir token file / env) like the
    reference's redis password. Every daemon/state connection must open
    with it — an unauthenticated socket that can reach a daemon is
    remote code execution by design (PUSH_TASK carries cloudpickle)."""
    tok = os.environ.get("RAY_TPU_AUTH_TOKEN")
    return tok.encode() if tok else None


class RpcConnectionError(ConnectionError):
    pass


def _method_name(method: int) -> str:
    return (pb.Method.Name(method) if method in pb.Method.values()
            else str(method))


class RpcRemoteError(RuntimeError):
    """The peer's handler raised; message carries the remote error string."""


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes with recv_into — no per-chunk allocation
    or extend-copy (multi-MB fetch replies ride this path)."""
    buf = bytearray(n)
    recv_into_exact(sock, memoryview(buf))
    return buf


PRE_AUTH_MAX_FRAME = 1 << 16  # before auth, only a tiny AUTH frame is legal


def read_frame(sock: socket.socket,
               max_len: int = MAX_FRAME) -> pb.Envelope:
    (length,) = _LEN.unpack(_read_exact(sock, 4))
    if length > max_len:
        raise RpcConnectionError(f"frame too large: {length}")
    env = pb.Envelope()
    env.ParseFromString(_read_exact(sock, length))
    return env


def frame_bytes(env: pb.Envelope) -> bytes:
    payload = env.SerializeToString()
    return _LEN.pack(len(payload)) + payload


_IOV_GROUP = 512  # stay under IOV_MAX (1024 on Linux) per sendmsg


def _sendmsg_all(sock: socket.socket, pieces: list) -> None:
    """Drain a gather list fully (sendmsg may stop at any boundary)."""
    while pieces:
        sent = sock.sendmsg(pieces[:_IOV_GROUP])
        while pieces and sent >= len(pieces[0]):
            sent -= len(pieces[0])
            pieces.pop(0)
        if pieces and sent:
            pieces[0] = pieces[0][sent:]


def send_frame(sock: socket.socket, env: pb.Envelope,
               raw=None) -> None:
    """Write one frame with scatter-gather IO: the length prefix and the
    serialized envelope go out in one sendmsg, WITHOUT concatenating (the
    concat would copy every multi-MB payload a second time).

    ``raw`` rides the bulk lane: ``env.raw_len`` announces it, and its
    bytes follow the envelope frame in the SAME gather write — zero
    user-space copies of the payload on this side, and the receiver
    recv_into's it straight into its destination buffer. ``raw`` may be
    one bytes-like OR a list/tuple of bytes-likes: a scattered payload
    (e.g. pickle-5 out-of-band buffers still living in their source
    arrays) ships without ever being assembled contiguously."""
    raw_mvs = []
    if raw is not None:
        # byte-cast FIRST: len() of a structured memoryview counts
        # ELEMENTS of its first dimension, not bytes
        if isinstance(raw, (list, tuple)):
            raw_mvs = [memoryview(r).cast("B") for r in raw]
        else:
            raw_mvs = [memoryview(raw).cast("B")]
        env.raw_len = sum(len(mv) for mv in raw_mvs)
    payload = env.SerializeToString()
    pieces = [memoryview(_LEN.pack(len(payload))), memoryview(payload)]
    pieces.extend(mv for mv in raw_mvs if len(mv))
    _sendmsg_all(sock, pieces)


def recv_into_exact(sock: socket.socket, mv: memoryview) -> None:
    got, n = 0, len(mv)
    while got < n:
        r = sock.recv_into(mv[got:], n - got)
        if r == 0:
            raise RpcConnectionError("connection closed by peer")
        got += r


def _set_sock_bufs(sock: socket.socket, nbytes: int) -> None:
    """Best-effort SO_SNDBUF/SO_RCVBUF sizing (kernel clamps silently)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, nbytes)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, nbytes)
    except OSError as e:
        logger.debug("socket buffer sizing failed: %s", e)


class _Pending:
    __slots__ = ("event", "env", "callback", "raw_sink")

    def __init__(self):
        self.event = threading.Event()
        self.env: Optional[pb.Envelope] = None
        self.callback = None
        self.raw_sink = None  # fn(length) -> writable memoryview


class RpcClient:
    """One outgoing connection; thread-safe calls multiplexed by seq."""

    def __init__(self, address: str, connect_timeout: Optional[float] = None,
                 on_push: Optional[Callable[[pb.Envelope], None]] = None,
                 on_close: Optional[Callable[[Exception], None]] = None,
                 auth_token: Optional[bytes] = None,
                 sock_buf_bytes: int = 0):
        host, port = address.rsplit(":", 1)
        self.address = address
        if connect_timeout is None:
            connect_timeout = _config.get("rpc_connect_timeout_s")
        _t0 = time.monotonic() if perf.ENABLED else 0.0
        try:
            if chaos.ENABLED:
                chaos.inject("rpc.client.connect", peer=address)
            self._sock = socket.create_connection((host, int(port)),
                                                  timeout=connect_timeout)
        except OSError as e:
            raise RpcConnectionError(
                f"connect to {address} failed: {e}") from e
        try:
            if _t0:
                perf.observe("rpc.connect", (time.monotonic() - _t0) * 1e3)
            self._sock.settimeout(None)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if sock_buf_bytes > 0:
                # Data-plane connections size their kernel buffers to the
                # transfer chunk so one chunk stays in flight per stream
                # (defaults keep the first RTTs window-limited). Linux
                # auto-tunes past the initial SO_RCVBUF only when it is NOT
                # set explicitly, so this is opt-in per connection.
                _set_sock_bufs(self._sock, sock_buf_bytes)
            token = (auth_token if auth_token is not None
                     else default_auth_token())
            if token:
                # First frame of every connection: prove membership. The
                # server closes the socket on mismatch; the caller surfaces
                # that as a connection error on its first real call.
                try:
                    self._sock.sendall(frame_bytes(pb.Envelope(
                        seq=0, method=pb.AUTH, body=token)))
                except OSError as e:
                    raise RpcConnectionError(
                        f"auth handshake to {address} failed: {e}") from e
            self._wlock = threading.Lock()
            self._pending_lock = threading.Lock()
            self._pending: Dict[int, _Pending] = {}  # raylint: guarded-by(self._pending_lock)
            self._seq = 0  # raylint: guarded-by(self._pending_lock)
            self._on_push = on_push
            self._on_close = on_close
            self._closed = False
            self._close_exc: Optional[Exception] = None
            self._reader = threading.Thread(
                target=self._read_loop, daemon=True,
                name=f"rpc-client-{address}")
            self._reader.start()
        except Exception:
            # Constructor aborts after the connect must not strand the fd.
            try:
                self._sock.close()
            except OSError:
                pass
            raise

    # -- public ---------------------------------------------------------------

    def call(self, method: int, body: bytes = b"",
             timeout: Optional[float] = None,
             raw_sink=None, raw=None) -> pb.Envelope:
        """Send a request, block for its reply. Raises RpcRemoteError on a
        handler error, RpcConnectionError if the connection dies first.
        ``raw_sink(length) -> memoryview``: where to land the reply's
        bulk-lane bytes, filled before this returns (the caller keeps its
        own reference to the buffer the sink handed out). ``raw``:
        bulk-lane payload to ship WITH the request (gather-write, no
        protobuf copy)."""
        if timeout is None:
            # rpc_call_deadline_s=0 (the default) keeps unbounded waits:
            # task-push replies land at task completion, which can be
            # arbitrarily far out.
            default = _config.get("rpc_call_deadline_s")
            if default > 0:
                timeout = default
        pending = _Pending()
        pending.raw_sink = raw_sink
        with self._pending_lock:
            if self._closed:
                raise RpcConnectionError(
                    f"connection to {self.address} is closed: {self._close_exc}")
            self._seq += 1
            seq = self._seq
            self._pending[seq] = pending
        env = pb.Envelope(seq=seq, method=method, body=body)
        t0 = 0.0
        if observability.ENABLED:
            tctx = observability.wire_context()
            if tctx:
                env.trace = tctx
        if perf.ENABLED:
            t0 = time.monotonic()
        if _lockwatch is not None and _lockwatch.installed():
            _lockwatch.rpc_client_wait(f"rpc:{_method_name(method)}")
        try:
            self._send(env, raw=raw)
            if not pending.event.wait(timeout):
                raise TimeoutError(
                    f"rpc {pb.Method.Name(method)} to {self.address} timed out")
        finally:
            with self._pending_lock:
                self._pending.pop(seq, None)
        reply = pending.env
        if reply is None:
            raise RpcConnectionError(
                f"connection to {self.address} lost mid-call: {self._close_exc}")
        if reply.error:
            raise RpcRemoteError(reply.error)
        if t0:
            perf.observe("rpc.call", (time.monotonic() - t0) * 1e3)
        return reply

    def call_async(self, method: int, body: bytes,
                   callback: Callable[[Optional[pb.Envelope],
                                       Optional[Exception]], None],
                   raw_sink=None, raw=None) -> None:
        """Fire a request; invoke ``callback(reply, None)`` or
        ``callback(None, error)`` from the reader thread when done.
        ``raw_sink`` as in :meth:`call` — filled before the callback.
        ``raw``: bulk-lane payload (one bytes-like or a gather list)
        shipped with the request, no protobuf copy."""
        tctx = ""
        if observability.ENABLED:
            tctx = observability.wire_context()
        if perf.ENABLED:
            _t0, _cb = time.monotonic(), callback

            def callback(env, error, _cb=_cb, _t0=_t0):
                perf.observe("rpc.call", (time.monotonic() - _t0) * 1e3)
                _cb(env, error)

        pending = _Pending()
        pending.callback = callback  # type: ignore[attr-defined]
        pending.raw_sink = raw_sink
        with self._pending_lock:
            if self._closed:
                callback(None, RpcConnectionError(
                    f"connection to {self.address} is closed"))
                return
            self._seq += 1
            seq = self._seq
            self._pending[seq] = pending
        env = pb.Envelope(seq=seq, method=method, body=body)
        if tctx:
            env.trace = tctx
        try:
            self._send(env, raw=raw)
        except Exception as e:
            with self._pending_lock:
                self._pending.pop(seq, None)
            callback(None, e)

    def call_burst(self, items, callback) -> None:
        """Ship MANY small requests in ONE gather write (one syscall, one
        chaos site, one lock acquisition) — the control-plane batching
        primitive. ``items``: list of ``(method, body)``;
        ``callback(index, reply_env, error)`` fires per item from the
        reader thread as the peer answers each seq. Frames go out in list
        order on this single connection, so a peer that processes frames
        per-connection in order (the state service's epoll loop) observes
        the ops in exactly the order they were enqueued."""
        pendings = []
        with self._pending_lock:
            if self._closed:
                err = RpcConnectionError(
                    f"connection to {self.address} is closed")
                for i in range(len(items)):
                    callback(i, None, err)
                return
            for i, _ in enumerate(items):
                self._seq += 1
                pending = _Pending()
                pending.callback = (
                    lambda env, error, _i=i: callback(_i, env, error))
                self._pending[self._seq] = pending
                pendings.append(self._seq)
        # Tiny control bodies: one contiguous buffer beats a long iovec.
        tctx = observability.wire_context() if observability.ENABLED else ""
        buf = bytearray()
        for seq, (method, body) in zip(pendings, items):
            env = pb.Envelope(seq=seq, method=method, body=body)
            if tctx:
                env.trace = tctx
            payload = env.SerializeToString()
            buf += _LEN.pack(len(payload))
            buf += payload
        try:
            self._send_bytes(buf)
        except Exception as e:
            self.fail_pending(pendings, e)

    def send_oneway(self, method: int, body: bytes = b"") -> None:
        env = pb.Envelope(seq=0, method=method, body=body)
        if observability.ENABLED:
            tctx = observability.wire_context()
            if tctx:
                env.trace = tctx
        self._send(env)

    def allocate_pending(self, callback) -> int:
        """Reserve a reply seq with a callback but send NOTHING — the
        caller ships the seq inside a batch envelope (TaskBatchMsg) and
        the peer answers it like any ordinary reply. Pair with
        fail_pending when the batch send errors."""
        pending = _Pending()
        pending.callback = callback
        with self._pending_lock:
            if self._closed:
                raise RpcConnectionError(
                    f"connection to {self.address} is closed")
            self._seq += 1
            seq = self._seq
            self._pending[seq] = pending
        return seq

    def fail_pending(self, seqs, error: Exception) -> None:
        """Settle reserved seqs whose batch never reached the wire."""
        if (isinstance(error, RpcConnectionError)
                and self.address not in str(error)):
            error = RpcConnectionError(
                f"connection to {self.address}: {error}")
        for seq in seqs:
            with self._pending_lock:
                pending = self._pending.pop(seq, None)
            if pending is not None and pending.callback is not None:
                try:
                    pending.callback(None, error)
                except Exception:
                    logger.exception("rpc callback failed")

    def close(self):
        self._shutdown(RpcConnectionError("closed locally"))

    def join_reader(self, timeout: Optional[float] = None) -> None:
        """Wait for the reader thread to exit (after close): once it has,
        no raw sink handed to this connection can be written again —
        required before reclaiming a sink's destination buffer."""
        if self._reader is not threading.current_thread():
            self._reader.join(timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- internals ------------------------------------------------------------

    def _send(self, env: pb.Envelope, raw=None):
        if chaos.ENABLED:
            try:
                act = chaos.inject("rpc.client.send", peer=self.address,
                                   method=_method_name(env.method))
            except chaos.ChaosConnectionReset as e:
                # A real peer reset kills the whole connection, not one
                # frame — tear down so pending calls fail like the wire did.
                self._shutdown(e)
                raise RpcConnectionError(
                    f"send to {self.address} failed: {e}") from e
            if act == "drop":
                return  # frame "lost on the wire"; the caller times out
        with self._wlock:
            try:
                send_frame(self._sock, env, raw=raw)
            except OSError as e:
                raise RpcConnectionError(
                    f"send to {self.address} failed: {e}") from e

    def _send_bytes(self, buf) -> None:
        """Pre-framed burst write (call_burst); same chaos semantics as
        _send — a reset kills the connection, a drop loses the burst."""
        if chaos.ENABLED:
            try:
                act = chaos.inject("rpc.client.send", peer=self.address,
                                   method="BURST")
            except chaos.ChaosConnectionReset as e:
                self._shutdown(e)
                raise RpcConnectionError(
                    f"send to {self.address} failed: {e}") from e
            if act == "drop":
                return
        with self._wlock:
            try:
                self._sock.sendall(buf)
            except OSError as e:
                raise RpcConnectionError(
                    f"send to {self.address} failed: {e}") from e

    def _read_loop(self):
        try:
            while True:
                env = read_frame(self._sock)
                if chaos.ENABLED:
                    # reset raises -> caught below -> _shutdown, exactly a
                    # mid-stream peer reset; drop discards the frame (after
                    # draining its bulk lane to keep framing intact).
                    if chaos.inject("rpc.client.recv",
                                    peer=self.address) == "drop":
                        if env.raw_len:
                            _read_exact(self._sock, env.raw_len)
                        continue
                raw_pending = None
                if env.raw_len:
                    if env.raw_len > MAX_FRAME:
                        raise RpcConnectionError(
                            f"raw payload too large: {env.raw_len}")
                    with self._pending_lock:
                        raw_pending = self._pending.get(env.seq)
                    sink = (raw_pending.raw_sink
                            if raw_pending is not None else None)
                    mv = None
                    if sink is not None:
                        try:
                            mv = sink(env.raw_len)
                        except Exception:
                            logger.exception("raw sink failed")
                    if mv is not None and len(mv) == env.raw_len:
                        recv_into_exact(self._sock, memoryview(mv))
                    else:
                        # No usable sink: drain to keep framing intact.
                        _read_exact(self._sock, env.raw_len)
                if env.seq == 0 and not env.reply:
                    if self._on_push is not None:
                        try:
                            self._on_push(env)
                        except Exception:
                            logger.exception("push handler failed")
                    continue
                with self._pending_lock:
                    pending = self._pending.get(env.seq)
                if pending is None:
                    continue
                pending.env = env
                cb = getattr(pending, "callback", None)
                if cb is not None:
                    with self._pending_lock:
                        self._pending.pop(env.seq, None)
                    err = RpcRemoteError(env.error) if env.error else None
                    try:
                        cb(None if err else env, err)
                    except Exception:
                        logger.exception("rpc callback failed")
                else:
                    pending.event.set()
        except Exception as e:  # noqa: BLE001 — connection teardown
            self._shutdown(e)

    def _shutdown(self, exc: Exception):
        with self._pending_lock:
            if self._closed:
                return
            self._closed = True
            self._close_exc = exc  # raylint: allow(data-race) set under _pending_lock before pending events fire; post-wait readers see it via the event's happens-before edge
            pending, self._pending = dict(self._pending), {}
        try:
            self._sock.close()
        except OSError:
            pass
        err = RpcConnectionError(
            f"connection to {self.address} lost: {exc}")
        for p in pending.values():
            cb = getattr(p, "callback", None)
            if cb is not None:
                try:
                    cb(None, err)
                except Exception:
                    logger.exception("rpc callback failed on close")
            else:
                p.event.set()  # p.env stays None -> caller raises
        if self._on_close is not None:
            try:
                self._on_close(exc)
            except Exception:
                logger.exception("on_close handler failed")


class RpcContext:
    """Handed to server handlers; reply now or later (from any thread)."""

    def __init__(self, server: "RpcServer", sock: socket.socket,
                 wlock: threading.Lock, env: pb.Envelope):
        self._sock = sock
        self._wlock = wlock
        self.method = env.method
        self.seq = env.seq
        self.body = env.body
        self.trace = env.trace  # caller's "trace_id:span_id", or ""
        self.raw = None  # bulk-lane bytes of the REQUEST, if any
        self.peer = None  # set by server
        self._done = False

    def reply(self, body: bytes = b"", raw=None):
        """``raw``: bulk-lane payload (bytes-like); ships after the
        envelope via gather-write — no protobuf copy of the bulk."""
        self._reply(pb.Envelope(seq=self.seq, method=self.method,
                                reply=True, body=body), raw=raw)

    def child(self, seq: int, method: int, body: bytes = b""
              ) -> "RpcContext":
        """A sibling context on the SAME connection with its own reply
        seq — how one batch envelope fans out into per-item contexts
        whose replies multiplex like ordinary calls."""
        env = pb.Envelope(seq=seq, method=method, body=body)
        ctx = RpcContext(None, self._sock, self._wlock, env)
        ctx.conn_id = getattr(self, "conn_id", None)
        ctx.trace = self.trace  # batch items inherit the batch's context
        return ctx

    def reply_error(self, message: str):
        self._reply(pb.Envelope(seq=self.seq, method=self.method,
                                reply=True, error=message))

    def push(self, method: int, body: bytes):
        """Unsolicited push to this connection (pubsub delivery)."""
        with self._wlock:
            send_frame(self._sock,
                       pb.Envelope(seq=0, method=method, body=body))

    def _reply(self, env: pb.Envelope, raw=None):
        if self._done:
            return
        self._done = True
        if chaos.ENABLED:
            try:
                act = chaos.inject("rpc.server.send",
                                   method=_method_name(self.method))
            except chaos.ChaosConnectionReset:
                # kill the connection instead of replying: the client sees
                # a reset with this request in flight
                try:
                    self._sock.close()
                except OSError:
                    pass
                return
            if act == "drop":
                return  # reply "lost on the wire"; the caller times out
        try:
            with self._wlock:
                send_frame(self._sock, env, raw=raw)
        except OSError:
            pass  # caller vanished; nothing to do


Handler = Callable[[RpcContext], None]


class RpcServer:
    """Threaded frame server. The handler receives an RpcContext and MUST
    eventually call ctx.reply()/ctx.reply_error() (possibly from another
    thread — that is how task pushes defer their reply to completion)."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 64,
                 inline_methods: Optional[set] = None,
                 auth_token: Optional[bytes] = None,
                 sock_buf_bytes: int = 0):
        self._handler = handler
        self._auth_token = (auth_token if auth_token is not None
                            else default_auth_token())
        self._sock_buf_bytes = sock_buf_bytes
        # Methods handled synchronously on the connection's reader thread:
        # cheap enqueue-style handlers that need per-connection ordering
        # (actor mailbox inserts — the reference's actor sequencing queues,
        # transport/actor_scheduling_queue.cc). Everything else runs in the
        # worker pool.
        self._inline = inline_methods or set()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._pool = None
        try:
            self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._lsock.bind((host, port))
            self._lsock.listen(128)
            self.host, self.port = self._lsock.getsockname()
            self.address = f"{self.host}:{self.port}"
            self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                            thread_name_prefix="rpc-srv")
            self._conns: Dict[int, Tuple[socket.socket, threading.Lock]] = {}  # raylint: guarded-by(self._conn_lock)
            self._conn_lock = threading.Lock()
            self._closed = False
            self._quiesced = False
            self._on_disconnect: Optional[Callable[[int], None]] = None
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name=f"rpc-accept-{self.port}")
            self._accept_thread.start()
        except Exception:
            # bind() on a taken port (EADDRINUSE) is the common abort here;
            # without this the listener fd leaks on every retry.
            try:
                self._lsock.close()
            except OSError:
                pass
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            raise

    def set_on_disconnect(self, cb: Callable[[int], None]):
        self._on_disconnect = cb  # raylint: allow(data-race) callback installed once during server wiring before serving starts

    def quiesce(self):
        """Stop accepting NEW connections while established ones (and the
        worker pool) keep running: in-flight requests finish and reply
        normally. First phase of a graceful drain; ``close()`` stays the
        hard stop."""
        self._quiesced = True
        try:
            self._lsock.close()
        except OSError:
            pass

    def close(self):
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock, _ in conns:
            try:
                sock.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _accept_loop(self):
        conn_id = 0
        while not self._closed:
            try:
                sock, _addr = self._lsock.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._sock_buf_bytes > 0:
                _set_sock_bufs(sock, self._sock_buf_bytes)
            conn_id += 1
            wlock = threading.Lock()
            with self._conn_lock:
                self._conns[conn_id] = (sock, wlock)
            t = threading.Thread(target=self._conn_loop,
                                 args=(conn_id, sock, wlock), daemon=True,
                                 name=f"rpc-conn-{self.port}-{conn_id}")
            t.start()

    def _conn_loop(self, conn_id: int, sock: socket.socket,
                   wlock: threading.Lock):
        try:
            if self._auth_token:
                # Constant-time check of the connection's opening frame;
                # anything else (wrong token, other method, garbage) drops
                # the socket before a single byte reaches the handler.
                # Pre-auth frames are capped small so an unauthenticated
                # peer cannot make us buffer up to MAX_FRAME.
                env = read_frame(sock, max_len=PRE_AUTH_MAX_FRAME)
                if env.method != pb.AUTH or not hmac.compare_digest(
                        bytes(env.body), self._auth_token):
                    logger.warning("rejected unauthenticated connection")
                    return
            while True:
                env = read_frame(sock)
                raw = None
                if env.raw_len:
                    if env.raw_len > MAX_FRAME:
                        raise RpcConnectionError(
                            f"raw payload too large: {env.raw_len}")
                    raw = _read_exact(sock, env.raw_len)
                if chaos.ENABLED:
                    # reset raises -> finally below closes the socket, the
                    # server-side version of a mid-request peer reset
                    if chaos.inject("rpc.server.recv", conn=str(conn_id),
                                    method=_method_name(env.method)) == "drop":
                        continue  # request "never arrived"
                if env.method == pb.AUTH:
                    continue  # redundant re-auth: ignore
                ctx = RpcContext(self, sock, wlock, env)
                ctx.raw = raw
                ctx.conn_id = conn_id
                if env.method in self._inline:
                    self._run_handler(ctx)
                else:
                    self._pool.submit(self._run_handler, ctx)
        except Exception as e:  # noqa: BLE001 — normal disconnect path
            logger.debug("reader loop ended: %s", e)
        finally:
            with self._conn_lock:
                self._conns.pop(conn_id, None)
            try:
                sock.close()
            except OSError:
                pass
            if self._on_disconnect is not None:
                try:
                    self._on_disconnect(conn_id)
                except Exception:
                    logger.exception("on_disconnect failed")

    def _run_handler(self, ctx: RpcContext):
        # Adopt the caller's trace context around dispatch so spans the
        # handler opens (fetch, task execute, ...) join the caller's tree.
        token = None
        if observability.ENABLED and ctx.trace:
            token = observability.adopt_wire(ctx.trace)
        lw_token = None
        if _lockwatch is not None and _lockwatch.installed():
            lw_token = _lockwatch.rpc_handler_enter(
                f"rpc:{_method_name(ctx.method)}")
        try:
            if token is not None:
                with observability.span(f"rpc:{_method_name(ctx.method)}",
                                        cat="rpc"):
                    self._handler(ctx)
            else:
                self._handler(ctx)
        except Exception as e:  # noqa: BLE001 — report to caller
            logger.exception("rpc handler error for %s",
                             pb.Method.Name(ctx.method)
                             if ctx.method in pb.Method.values() else ctx.method)
            ctx.reply_error(f"{type(e).__name__}: {e}")
        finally:
            if lw_token is not None:
                _lockwatch.rpc_handler_exit(lw_token)
            if token is not None:
                observability.reset(token)


class ConnectionPool:
    """Shared per-process outgoing connections, keyed by address."""

    def __init__(self):
        self._lock = threading.Lock()
        self._clients: Dict[str, RpcClient] = {}  # raylint: guarded-by(self._lock)

    def get(self, address: str,
            on_close: Optional[Callable[[str, Exception], None]] = None
            ) -> RpcClient:
        with self._lock:
            client = self._clients.get(address)
            if client is not None and not client.closed:
                return client

            def _closed(exc: Exception, _addr=address):
                with self._lock:
                    cur = self._clients.get(_addr)
                    if cur is not None and cur.closed:
                        del self._clients[_addr]
                if on_close is not None:
                    on_close(_addr, exc)

            client = RpcClient(address, on_close=_closed)
            self._clients[address] = client
            return client

    def drop(self, address: str):
        with self._lock:
            client = self._clients.pop(address, None)
        if client is not None:
            client.close()

    def close_all(self):
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()
