"""Wire framing shared by client and server.

Length-prefixed cloudpickle frames (the ``ray_client.proto`` role). Every
request carries an ``op`` and gets exactly one response frame:
``{"ok": value}`` or ``{"error": exception}``.

Frames pickle tensors as values that leave the process
(``_private/framing.dumps``): each lands on the receiver's ``cuda:0``, or on
the CPU in a process without a card (a client on a laptop, say), as a
``jax.Array`` does. ``RefMarker``s in a frame are swapped for refs while it
is unpickled, beside tensors or not.
"""

from __future__ import annotations

import contextvars
import socket
import struct

import cloudpickle

from ray_tpu_torch._private import framing

MAX_FRAME = 1 << 30

# Server-side: set to a ``ref_id -> ObjectRef`` resolver around request
# decoding, so markers are swapped for real refs DURING unpickling — at
# any depth of any object graph (lists, dict keys, dataclass attributes,
# ...), with no post-hoc container walk to keep complete.
_RESTORE_RESOLVER: "contextvars.ContextVar" = contextvars.ContextVar(
    "refmarker_resolver", default=None)


class RefMarker:
    """Wire stand-in for a ClientObjectRef inside pickled args: carries
    only the server-side ref id; the server swaps in the real ObjectRef
    (at reconstruction time when ``_RESTORE_RESOLVER`` is set)."""

    __slots__ = ("ref_id",)

    def __new__(cls, ref_id: str):
        resolver = _RESTORE_RESOLVER.get()
        if resolver is not None:
            return resolver(ref_id)  # replaces the marker in-place
        return super().__new__(cls)

    def __init__(self, ref_id: str):
        # skipped automatically when __new__ returned a non-RefMarker
        self.ref_id = ref_id


def send_msg(sock: socket.socket, payload) -> None:
    data = framing.dumps(payload)
    sock.sendall(struct.pack("!Q", len(data)) + data)


def recv_msg(sock: socket.socket):
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (length,) = struct.unpack("!Q", header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    data = _recv_exact(sock, length)
    if data is None:
        return None
    return cloudpickle.loads(data)


def _recv_exact(sock: socket.socket, n: int):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)
