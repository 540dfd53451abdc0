"""R23 fixture: unsynchronized cross-thread field access (positive) next
to the three suppression shapes the rule promises to honor (negative)."""
import threading


class RaceyGauge:
    """Positive: the drain thread writes ``level`` with no lock while
    main-context readers take unlocked snapshots."""

    def __init__(self):
        self.level = 0
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self):
        self.level = 1

    def read_level(self):
        return self.level


class GuardedGauge:
    """Negative: declared and consistently locked — R25 owns the
    contract, so R23 stays quiet."""

    def __init__(self):
        self._lock = threading.Lock()
        self.level = 0  # raylint: guarded-by(self._lock)
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self):
        with self._lock:
            self.level = 1

    def read_level(self):
        with self._lock:
            return self.level


class FlagStop:
    """Negative: bool fast-path flag — a pointer-sized constant store
    cannot tear, so the stop-flag idiom is exempt."""

    def __init__(self):
        self._stop = False
        self._t = threading.Thread(target=self._step, daemon=True)
        self._t.start()

    def _step(self):
        if not self._stop:
            self._work()

    def _work(self):
        pass

    def stop(self):
        self._stop = True


class Handoff:
    """Negative: single-writer-before-spawn — every write happens before
    ``Thread.start()`` publishes the object to the worker."""

    def __init__(self):
        self.payload = []
        self.payload.append(1)
        self._t = threading.Thread(target=self._consume, daemon=True)
        self._t.start()

    def _consume(self):
        return list(self.payload)


def poll(g: RaceyGauge, h: Handoff) -> int:
    return g.read_level() + len(h.payload)
