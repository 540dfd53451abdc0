"""R18 fixture: protocol vocabulary, reply discipline, node lifecycle.

Positive cases: ``send_orphan`` ships a method no dispatcher handles,
``dispatch`` guards a method nothing sends, ``handler_no_reply`` can
complete without replying, and ``promote_drained`` writes a transition
the declared NODE_LIFECYCLE table does not admit.  ``send_echo`` /
``dispatch``'s ECHO arm / ``demote_draining`` are the clean twins.
"""


class pb:
    ORPHAN_SEND = 1
    DEAD_ARM = 2
    ECHO = 3


def send_orphan(client):
    client.call(pb.ORPHAN_SEND, b"")


def send_echo(client):
    client.call(pb.ECHO, b"")


def dispatch(env, ctx):
    if env.method == pb.DEAD_ARM:
        ctx.reply(b"")
    elif env.method == pb.ECHO:
        ctx.reply(b"pong")
    else:
        ctx.reply_error("unknown method")


def handler_no_reply(env, ctx):
    if env.method == pb.ECHO:
        ctx.reply(b"pong")


def promote_drained(node):
    if node.state == "DRAINED":
        node.state = "ALIVE"


def demote_draining(node):
    if node.state == "DRAINING":
        node.state = "DRAINED"
