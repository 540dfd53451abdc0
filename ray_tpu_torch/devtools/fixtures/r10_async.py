"""R10 fixture: an async handler reaches time.sleep through sync helpers."""
import threading
import time


def _backoff():
    time.sleep(0.2)


def _relay():
    _backoff()


async def handle():
    _relay()


async def spawned_ok():
    # negative: spawn edge — the sleep runs on its own thread, the event
    # loop never blocks
    threading.Thread(target=_backoff).start()


async def dynamic_ok(callback):
    # negative: unresolvable dynamic call must degrade to "unknown"
    callback()
