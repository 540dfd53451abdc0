"""serve_idle_queued_pct: the share of the traced window in which the
device ran no operation while at least one request was open (a
``serve.request`` span of the program's span ring, handle call to
answer): the part of ``device_idle_pct.serve`` that the program, not the
arrivals, leaves idle."""

from perfbench.core import spans


def read(record):
    if record.get("kind") != "serve":
        return None
    from ray_tpu_torch._private.profiling import get_profiler
    ring = get_profiler()
    return spans.idle_queued_pct(record, ring.chrome_trace(), ring.dropped)
