"""R17 fixture: no naked blocking under a deadline scope.

``drain_with_deadline`` promises to honor its ``deadline`` but reaches
``_flush_unbounded``'s bare ``Event.wait()`` — the witness path the
rule must report.  ``drain_bounded`` passes the budget down.
"""
import threading

DONE = threading.Event()


def drain_with_deadline(deadline):
    _flush_unbounded()
    return deadline


def _flush_unbounded():
    DONE.wait()


def drain_bounded(deadline):
    DONE.wait(deadline)
