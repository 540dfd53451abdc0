"""device_idle_pct: the share of the traced window in which the device ran
no operation (one minus the union of its operations' intervals)."""

from perfbench.core.readers import idle_pct


def read(record):
    if record.get("kind") != "serve":
        return None
    return idle_pct(record)
