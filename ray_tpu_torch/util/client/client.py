"""Client side: stubs that proxy the public API over the socket.

Parity with the stub layer of Ray Client (``util/client/common.py``
``ClientObjectRef``/``ClientActorHandle``/``ClientRemoteFunc``). One
socket, MULTIPLEXED: every request carries a seq, a reader thread
matches responses, and the server dispatches each request on its own
worker — so a second in-flight call (e.g. a quick ``put`` while a long
``get`` blocks) no longer waits for the first to finish (the
reference's ``proxier.py`` stream multiplexing role)."""

from __future__ import annotations

import socket
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.util.client.protocol import recv_msg, send_msg


class ClientObjectRef:
    def __init__(self, api: "ClientAPI", ref_id: str):
        self._api = api
        self.ref_id = ref_id

    def __repr__(self):
        return f"ClientObjectRef({self.ref_id[:8]})"

    def __reduce__(self):
        # On the wire a ref is just its server-side id; the server swaps
        # the marker for the real ObjectRef (args travel pickled).
        from ray_tpu_torch.util.client.protocol import RefMarker
        return (RefMarker, (self.ref_id,))


class _ClientActorMethod:
    def __init__(self, api: "ClientAPI", actor_key: str, method: str):
        self._api = api
        self._actor_key = actor_key
        self._method = method

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        rid = self._api._call({
            "op": "actor_call", "actor_key": self._actor_key,
            "method": self._method,
            "args": args, "kwargs": kwargs})
        return ClientObjectRef(self._api, rid)


class ClientActorHandle:
    def __init__(self, api: "ClientAPI", actor_key: str):
        self._api = api
        self._actor_key = actor_key

    def __getattr__(self, name: str) -> _ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClientActorMethod(self._api, self._actor_key, name)


class ClientRemoteFunction:
    def __init__(self, api: "ClientAPI", fn_id: str,
                 options: Optional[dict] = None):
        self._api = api
        self._fn_id = fn_id
        self._options = options

    def options(self, **opts) -> "ClientRemoteFunction":
        merged = dict(self._options or {})
        merged.update(opts)
        return ClientRemoteFunction(self._api, self._fn_id, merged)

    def remote(self, *args, **kwargs):
        out = self._api._call({
            "op": "task", "fn_id": self._fn_id,
            "options": self._options,
            "args": args, "kwargs": kwargs})
        if isinstance(out, list):
            return [ClientObjectRef(self._api, r) for r in out]
        return ClientObjectRef(self._api, out)


class ClientActorClass:
    def __init__(self, api: "ClientAPI", cls_id: str,
                 options: Optional[dict] = None):
        self._api = api
        self._cls_id = cls_id
        self._options = options

    def options(self, **opts) -> "ClientActorClass":
        merged = dict(self._options or {})
        merged.update(opts)
        return ClientActorClass(self._api, self._cls_id, merged)

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        key = self._api._call({
            "op": "actor_create", "cls_id": self._cls_id,
            "options": self._options,
            "args": args, "kwargs": kwargs})
        return ClientActorHandle(self._api, key)


class ClientAPI:
    """The ``ray_tpu_torch`` surface, proxied (get/put/wait/remote/...)."""

    def __init__(self, address: str, timeout: float = 30.0):
        host, _, port = address.partition(":")
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        try:
            self._sock.settimeout(None)
            self._send_lock = threading.Lock()
            self._pending_lock = threading.Lock()
            self._pending: Dict[int, list] = {}  # raylint: guarded-by(self._pending_lock)
            self._seq = 0
            self._closed: Optional[Exception] = None
            self._reader = threading.Thread(target=self._read_loop,
                                            daemon=True, name="client-reader")
            self._reader.start()
            assert self._call({"op": "ping"},
                              timeout=timeout)["initialized"], \
                "server head is not initialized"
        except Exception:
            # a failed handshake (wrong server, dead head) must close the fd
            try:
                self._sock.close()
            except OSError:
                pass
            raise

    def _read_loop(self):
        try:
            while True:
                resp = recv_msg(self._sock)
                if resp is None:
                    raise ConnectionError(
                        "client server closed the connection")
                with self._pending_lock:
                    slot = self._pending.pop(resp.get("seq"), None)
                if slot is not None:
                    slot[1] = resp
                    slot[0].set()
        except BaseException as e:  # noqa: BLE001 - teardown path
            with self._pending_lock:
                # raylint: allow(data-race) set under _pending_lock before slot events fire; post-wait readers see it via the event's happens-before edge
                self._closed = e if isinstance(e, Exception) else \
                    ConnectionError(str(e))
                pending, self._pending = dict(self._pending), {}
            for slot in pending.values():
                slot[0].set()

    def _call(self, req: dict, timeout: Optional[float] = None):
        slot = [threading.Event(), None]
        with self._pending_lock:
            if self._closed is not None:
                raise ConnectionError(
                    f"client connection closed: {self._closed}")
            self._seq += 1
            seq = self._seq
            self._pending[seq] = slot
        try:
            with self._send_lock:
                send_msg(self._sock, dict(req, seq=seq))
            if not slot[0].wait(timeout):
                raise TimeoutError(
                    f"no reply to {req.get('op')!r} within {timeout}s")
        finally:
            with self._pending_lock:
                self._pending.pop(seq, None)
        resp = slot[1]
        if resp is None:
            raise ConnectionError(
                f"client connection lost mid-call: {self._closed}")
        if "error" in resp:
            raise resp["error"]
        return resp["ok"]

    # -- API ----------------------------------------------------------------

    def remote(self, fn_or_class, **options):
        """Wrap a function or class for remote execution on the server."""
        if isinstance(fn_or_class, type):
            cls_id = self._call({"op": "register_class",
                                 "cls": fn_or_class})
            return ClientActorClass(self, cls_id, options or None)
        fn_id = self._call({"op": "register_function",
                            "function": fn_or_class})
        return ClientRemoteFunction(self, fn_id, options or None)

    def put(self, value: Any) -> ClientObjectRef:
        return ClientObjectRef(self, self._call({"op": "put",
                                                 "value": value}))

    def get(self, refs: Union[ClientObjectRef, Sequence[ClientObjectRef]],
            timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        values = self._call({"op": "get",
                             "refs": [r.ref_id for r in ref_list],
                             "timeout": timeout})
        return values[0] if single else values

    def wait(self, refs: Sequence[ClientObjectRef], *,
             num_returns: int = 1, timeout: Optional[float] = None):
        by_id: Dict[str, ClientObjectRef] = {r.ref_id: r for r in refs}
        ready, pending = self._call({
            "op": "wait", "refs": [r.ref_id for r in refs],
            "num_returns": num_returns, "timeout": timeout})
        return ([by_id[r] for r in ready], [by_id[r] for r in pending])

    def get_actor(self, name: str,
                  namespace: Optional[str] = None) -> ClientActorHandle:
        key = self._call({"op": "get_actor", "name": name,
                          "namespace": namespace})
        return ClientActorHandle(self, key)

    def kill(self, actor: ClientActorHandle, *, no_restart: bool = True):
        return self._call({"op": "kill", "actor_key": actor._actor_key,
                           "no_restart": no_restart})

    def release(self, refs: Sequence[ClientObjectRef]):
        """Drop the server-side pins for these refs."""
        self._call({"op": "release",
                    "refs": [r.ref_id for r in refs]})

    def cluster_resources(self) -> Dict[str, float]:
        return self._call({"op": "cluster_resources"})

    def disconnect(self):
        try:
            self._sock.close()
        except OSError:
            pass


def connect(address: str, timeout: float = 30.0) -> ClientAPI:
    """Connect to a ``ClientServer`` in a head process."""
    return ClientAPI(address, timeout=timeout)
