"""R11 fixture (half 2): the reverse acquisition order, plus a negative
case where the peer lock is only reached across a thread-spawn edge."""
import threading

from fixtures import r11_a

PEER_LOCK = threading.Lock()


def hold_b():
    with PEER_LOCK:
        pass


def hold_b_then_a():
    with PEER_LOCK:
        r11_a.hold_a()


def spawn_ok():
    # negative: locks are not held across a spawn edge — the new thread
    # starts with an empty hold set, so this creates no A->B edge
    t = threading.Thread(target=r11_a.hold_a, daemon=True)
    with PEER_LOCK:
        t.start()
