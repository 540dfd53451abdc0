"""serve_tail_queue_pct: over the window's requests whose ``serve.request``
span (handle call to answer) is at or above the 95th percentile of them,
the sum of their ``serve.queue`` spans (the replica batcher's queue) over
the sum of their request spans, joined by ``request_id``, from the
program's span ring."""

from perfbench.core import spans


def read(record):
    if record.get("kind") != "serve":
        return None
    from ray_tpu_torch._private.profiling import get_profiler
    ring = get_profiler()
    return spans.tail_queue_pct(record, ring.chrome_trace(), ring.dropped)
