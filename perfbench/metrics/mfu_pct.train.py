"""mfu_pct.train: model FLOPs of the window's steps (``core.work``: 6 x
matmul parameters x tokens + 3 x the causal attention forward, no
recompute) over the window's time and the bf16 peak."""

from perfbench.core.work import mfu_pct


def read(record):
    if record.get("kind") != "train" or not record["window_s"]:
        return None
    return mfu_pct(record["flops"], record["window_s"])
