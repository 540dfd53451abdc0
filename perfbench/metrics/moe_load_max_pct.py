"""moe_load_max_pct: over the window's MoE layer forwards, the mean of the
busiest held expert's assignments over the held experts' mean, in %, from
the program's expert-load counter (``models/moe.py``)."""


def read(record):
    load = record.get("moe_load")
    passes = sum(e["passes"] for e in (load or {}).values())
    if record.get("kind") != "train" or not passes:
        return None
    return 100.0 * sum(e["max_over_mean"] for e in load.values()) / passes
