"""R25 fixture: both directions of guarded-by enforcement — a declared
field touched without its lock (positive a), a consistently-locked
multi-thread field missing its declaration (positive b), and a fully
declared-and-locked class that satisfies the contract (negative)."""
import threading


class LeakyBox:
    """Positive (a): ``peek`` reads the declared field lock-free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items = []  # raylint: guarded-by(self._lock)
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        with self._lock:
            self._items.append(1)

    def peek(self) -> int:
        return len(self._items)


class QuietBox:
    """Positive (b): every access locks, two thread contexts reach the
    field, but no declaration records the convention."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        with self._lock:
            self._items.append(1)

    def peek(self) -> int:
        with self._lock:
            return len(self._items)


class SealedBox:
    """Negative: declared, and every access site holds the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items = []  # raylint: guarded-by(self._lock)
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        with self._lock:
            self._items.append(1)

    def peek(self) -> int:
        with self._lock:
            return len(self._items)


def drain(a: LeakyBox, b: QuietBox, c: SealedBox) -> int:
    return a.peek() + b.peek() + c.peek()
