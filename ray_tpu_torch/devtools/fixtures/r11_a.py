"""R11 fixture (half 1): acquires ORDER_LOCK, then r11_b.PEER_LOCK via a
cross-module call — r11_b closes the cycle in the other direction."""
import threading

from fixtures import r11_b

ORDER_LOCK = threading.Lock()


def hold_a_then_b():
    with ORDER_LOCK:
        r11_b.hold_b()


def hold_a():
    with ORDER_LOCK:
        pass
