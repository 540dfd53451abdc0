"""mfu_pct.serve: forward FLOPs of the real tokens (blocks on every real
token, causal attention on each request's real length, the head on one
token a request) over the synchronised time the replica spent in forwards
and the bf16 peak."""

from perfbench.core.readers import serve_mfu_pct


def read(record):
    if record.get("kind") != "serve":
        return None
    return serve_mfu_pct(record)
