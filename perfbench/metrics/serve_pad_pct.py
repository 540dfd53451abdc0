"""serve_pad_pct: the deployment's own count over the window's batches:
padded tokens (to the length bucket, and the batcher's repeated rows) over
the tokens the forwards computed."""

from perfbench.core.readers import serve_pad_pct


def read(record):
    if record.get("kind") != "serve":
        return None
    return serve_pad_pct(record)
