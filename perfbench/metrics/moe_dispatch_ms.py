"""moe_dispatch_ms: the mean of the program's ``moe.dispatch`` histogram
over the window: one MoE layer's forward routing (router, top-k, the sort
by expert, its one read of the counts on the host, the rows' gather) plus
its combine, timed on the device between CUDA events and read without a
synchronise (``models/moe.py``)."""

from perfbench.core.readers import perf_mean_ms


def read(record):
    if record.get("kind") != "train":
        return None
    return perf_mean_ms(record, "moe.dispatch")
