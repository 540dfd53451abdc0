"""R24 fixture: a read-modify-write whose halves each take the lock but
release it in between (positive), plus the widened-critical-section
shape that must stay quiet (negative)."""
import threading


class SplitQuota:
    """Positive: ``bump_stale`` snapshots under the lock, drops it, then
    writes back under a second acquisition — the grower thread can
    interleave and its increment is lost."""

    def __init__(self):
        self._lock = threading.Lock()
        self._used = 0  # raylint: guarded-by(self._lock)
        self._t = threading.Thread(target=self._grow, daemon=True)
        self._t.start()

    def _grow(self):
        with self._lock:
            self._used += 1

    def bump_stale(self):
        with self._lock:
            n = self._used
        with self._lock:
            self._used = n + 1


class WholeQuota:
    """Negative: one critical section covers the read and the dependent
    write, so no interleaving window exists."""

    def __init__(self):
        self._lock = threading.Lock()
        self._used = 0  # raylint: guarded-by(self._lock)
        self._t = threading.Thread(target=self._grow, daemon=True)
        self._t.start()

    def _grow(self):
        with self._lock:
            self._used += 1

    def bump(self):
        with self._lock:
            n = self._used
            self._used = n + 1


def drive(a: SplitQuota, b: WholeQuota) -> None:
    a.bump_stale()
    b.bump()
