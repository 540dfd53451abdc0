"""R19 fixture: distributed deadlock over the stitched call graph.

Positive cases: ``dispatch``'s FWD arm synchronously calls BACK whose
arm synchronously calls FWD back (a cross-daemon wait cycle), and
``send_while_locked`` holds ``_LOCK`` across a synchronous LOCKED send
whose handler re-acquires the same lock.  Clean twins: the SAFE arm
sends fire-and-forget (``call_async`` never waits), and
``send_after_unlock`` drops the lock before touching the wire.
"""

import threading

_LOCK = threading.Lock()


class pb:
    FWD = 1
    BACK = 2
    SAFE = 3
    LOCKED = 4


def dispatch(env, ctx, client):
    if env.method == pb.FWD:
        client.call(pb.BACK, b"")
        ctx.reply(b"")
    elif env.method == pb.BACK:
        client.call(pb.FWD, b"")
        ctx.reply(b"")
    elif env.method == pb.SAFE:
        client.call_async(pb.FWD, b"", None)
        ctx.reply(b"")
    else:
        ctx.reply_error("unknown method")


def send_safe(client):
    client.call_async(pb.SAFE, b"", None)


def locked_dispatch(env, ctx):
    if env.method == pb.LOCKED:
        with _LOCK:
            pass
        ctx.reply(b"")
    else:
        ctx.reply_error("unknown method")


def send_while_locked(client):
    with _LOCK:
        client.call(pb.LOCKED, b"")


def send_after_unlock(client):
    with _LOCK:
        body = b""
    client.call(pb.LOCKED, body)
