"""serve_queue_wait_ms: the mean of the program's ``serve.queue_wait``
histogram (the replica batcher's queue, admission to batch start) over the
window; the perf plane is on in traced runs only."""

from perfbench.core.readers import perf_mean_ms


def read(record):
    if record.get("kind") != "serve":
        return None
    return perf_mean_ms(record, "serve.queue_wait")
