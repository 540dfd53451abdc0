"""serve_p95_ms: the 95th percentile, over every request due in the window,
of the time from its due time to its answer; a request that failed counts
as the longest wait the run allows, slower than every answer."""

from perfbench.core.readers import p95


def read(record):
    if record.get("kind") != "serve" or not record["latencies_ms"]:
        return None
    return p95(record["latencies_ms"])
