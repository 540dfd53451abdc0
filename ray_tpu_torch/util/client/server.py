"""Server side: executes client requests against the in-process runtime.

Parity with ``python/ray/util/client/server/server.py`` (the dataservicer
running a real driver) and ``proxier.py`` (N clients multiplexed onto one
head — here each connection gets a thread, all sharing the runtime).
Object and actor ownership lives here: the server pins every ObjectRef a
client has been handed until that client releases it or disconnects
(reference: server-side reference tracking in ``server.py``).
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import uuid
from typing import Any, Dict

from ray_tpu_torch.util.client.protocol import recv_msg, send_msg

logger = logging.getLogger("ray_tpu")


class _ClientSession:
    """Per-connection state: the refs/actors this client holds."""

    def __init__(self):
        self.refs: Dict[str, Any] = {}       # ref id -> ObjectRef
        self.actors: Dict[str, Any] = {}     # actor key -> ActorHandle
        self.functions: Dict[str, Any] = {}  # fn id -> RemoteFunction
        self.classes: Dict[str, Any] = {}    # cls id -> ActorClass


class ClientServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                from ray_tpu_torch.util.client.protocol import (
                    _RESTORE_RESOLVER)
                session = _ClientSession()
                sock = self.request

                def resolve(ref_id: str):
                    try:
                        return session.refs[ref_id]
                    except KeyError:
                        raise ValueError(
                            f"client ref {ref_id[:8]} is unknown to this "
                            f"session (freed or from another session)")

                from concurrent.futures import ThreadPoolExecutor
                wlock = threading.Lock()
                pool = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="client-srv")

                def run_one(req, seq):
                    try:
                        payload = {"seq": seq,
                                   "ok": outer._dispatch(session, req)}
                    except BaseException as e:  # noqa: BLE001
                        payload = {"seq": seq, "error": e}
                    try:
                        with wlock:
                            send_msg(sock, payload)
                    except (ConnectionError, OSError):
                        pass
                    except BaseException as e:  # noqa: BLE001
                        # Unpicklable result/exception: the client must
                        # still get SOME reply or it blocks forever.
                        try:
                            with wlock:
                                send_msg(sock, {
                                    "seq": seq,
                                    "error": RuntimeError(
                                        "response serialization failed: "
                                        f"{type(e).__name__}: {e}")})
                        except BaseException:  # raylint: allow(swallow) socket dead: no channel left to report on
                            pass

                try:
                    while True:
                        # markers anywhere in the request swap for real
                        # refs DURING unpickling (protocol.RefMarker) —
                        # parsing stays on the reader thread so the
                        # resolver contextvar scopes correctly
                        token = _RESTORE_RESOLVER.set(resolve)
                        try:
                            req = recv_msg(sock)
                        finally:
                            _RESTORE_RESOLVER.reset(token)
                        if req is None:
                            break
                        # Each request dispatches on its own worker: a
                        # blocking get() must not serialize the client's
                        # other calls behind it.
                        pool.submit(run_one, req, req.get("seq"))
                except (ConnectionError, OSError):
                    pass
                finally:
                    pool.shutdown(wait=False)
                    # Disconnect releases everything the client held.
                    session.refs.clear()
                    session.actors.clear()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="client-server")
        self._thread.start()

    # -- op dispatch --------------------------------------------------------

    def _dispatch(self, session: _ClientSession, req: dict):
        import ray_tpu_torch as ray_tpu
        op = req["op"]
        if op == "ping":
            return {"initialized": ray_tpu.is_initialized()}
        if op == "put":
            ref = ray_tpu.put(req["value"])
            return self._track(session, [ref])[0]
        if op == "get":
            refs = [session.refs[r] for r in req["refs"]]
            return ray_tpu.get(refs, timeout=req.get("timeout"))
        if op == "wait":
            refs = [session.refs[r] for r in req["refs"]]
            by_id = {id(ref): rid for rid, ref in
                     zip(req["refs"], refs)}
            ready, pending = ray_tpu.wait(
                refs, num_returns=req["num_returns"],
                timeout=req.get("timeout"))
            return ([by_id[id(r)] for r in ready],
                    [by_id[id(r)] for r in pending])
        if op == "register_function":
            fn_id = uuid.uuid4().hex
            session.functions[fn_id] = ray_tpu.remote(req["function"]) \
                if not hasattr(req["function"], "remote") \
                else req["function"]
            return fn_id
        if op == "task":
            fn = session.functions[req["fn_id"]]
            if req.get("options"):
                fn = fn.options(**req["options"])
            out = fn.remote(*req["args"], **req["kwargs"])
            refs = out if isinstance(out, list) else [out]
            ids = self._track(session, refs)
            return ids if isinstance(out, list) else ids[0]
        if op == "register_class":
            cls_id = uuid.uuid4().hex
            session.classes[cls_id] = ray_tpu.remote(req["cls"])
            return cls_id
        if op == "actor_create":
            cls = session.classes[req["cls_id"]]
            if req.get("options"):
                cls = cls.options(**req["options"])
            handle = cls.remote(*req["args"], **req["kwargs"])
            actor_key = uuid.uuid4().hex
            session.actors[actor_key] = handle
            return actor_key
        if op == "actor_call":
            handle = session.actors[req["actor_key"]]
            ref = getattr(handle, req["method"]).remote(
                *req["args"], **req["kwargs"])
            return self._track(session, [ref])[0]
        if op == "get_actor":
            handle = ray_tpu.get_actor(req["name"],
                                       namespace=req.get("namespace"))
            actor_key = uuid.uuid4().hex
            session.actors[actor_key] = handle
            return actor_key
        if op == "kill":
            ray_tpu.kill(session.actors[req["actor_key"]],
                         no_restart=req.get("no_restart", True))
            return True
        if op == "release":
            for rid in req["refs"]:
                session.refs.pop(rid, None)
            return True
        if op == "cluster_resources":
            return ray_tpu.cluster_resources()
        raise ValueError(f"unknown op {op!r}")

    @staticmethod
    def _track(session: _ClientSession, refs) -> list:
        ids = []
        for ref in refs:
            rid = uuid.uuid4().hex
            session.refs[rid] = ref
            ids.append(rid)
        return ids

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
