"""R20 fixture: unbounded blocking reachable from an RPC dispatch arm.

Positive case: the WORK arm reaches ``helper``'s bare ``ev.wait()`` —
a stalled handler pins a dispatch thread for every caller.  Clean
twins: the BOUNDED arm goes through ``scoped_helper``, whose
``deadline`` parameter is the budget fact that suppresses R20 (the
naked wait under it is R17's jurisdiction, allowed in place here), and
``capped_helper`` passes an explicit timeout so nothing is naked.
"""


class pb:
    WORK = 10
    BOUNDED = 11


def helper(ev):
    ev.wait()


def scoped_helper(ev, deadline):
    # raylint: allow(deadline-drop) fixture: the deadline fact itself is R20's suppression under test
    ev.wait()


def capped_helper(ev):
    ev.wait(1.0)


def dispatch(env, ctx, ev):
    if env.method == pb.WORK:
        helper(ev)
        ctx.reply(b"")
    elif env.method == pb.BOUNDED:
        scoped_helper(ev, 1.0)
        capped_helper(ev)
        ctx.reply(b"")
    else:
        ctx.reply_error("unknown method")


def send_work(client):
    client.call(pb.WORK, b"")


def send_bounded(client):
    client.call(pb.BOUNDED, b"")
