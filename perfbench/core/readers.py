"""What the metric readers in ``metrics/`` share. Each reader takes a run's
record and returns a number, or None where the run has nothing for it to
read (another kind of traffic, no trace, no kernel matched)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from perfbench.core import spec, trace, work

_WORK = {"attn_fwd": work.attn_fwd_work, "attn_bwd": work.attn_bwd_work}


def perf_mean_ms(record: dict, name: str) -> Optional[float]:
    """Mean of one of the program's perf histograms over the window."""
    snap = record.get("perf")
    hist = (snap or {}).get("hists", {}).get(name)
    if not hist or not sum(hist["counts"]):
        return None
    return hist["sum_ms"] / sum(hist["counts"])


def least_seconds(record: dict, group: str) -> float:
    """The least time of the ``group`` work of the traced units, counted
    from their shapes alone."""
    m = record["dims"]
    return sum(work.least_seconds(*_WORK[group](B, L, m)) * calls
               for u in record["trace"]["units"]
               for B, L, calls in u.get(group, []))


def roofline_pct(record: dict, group: str,
                 patterns=None) -> Optional[float]:
    """``least_seconds`` over the device time of the kernels that the
    group's patterns name (``metrics/kernels/<group>/``), launched inside
    the traced units."""
    tr = record.get("trace")
    if not tr or not tr["units"]:
        return None
    if patterns is None:
        patterns = spec.kernel_patterns(group)
    spans = [(u["t0"], u["t1"]) for u in tr["units"]]
    kernel_s = trace.matching_seconds(tr["ops"], patterns, spans)
    least = least_seconds(record, group)
    if least == 0 or kernel_s == 0:
        return None
    return 100.0 * least / kernel_s


def idle_pct(record: dict) -> Optional[float]:
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def serve_mfu_pct(record: dict) -> Optional[float]:
    batches = record.get("batches") or []
    seconds = sum(b["t1"] - b["t0"] for b in batches) * 1e-9
    if seconds <= 0:
        return None
    m = record["dims"]
    flops = sum(work.serve_request_flops(m, n) for b in batches
                for n in b["lengths"])
    return work.mfu_pct(flops, seconds)


def serve_pad_pct(record: dict) -> Optional[float]:
    batches = record.get("batches") or []
    computed = sum(b["rows"] * b["len"] for b in batches)
    if not computed:
        return None
    real = sum(sum(b["lengths"]) for b in batches)
    return 100.0 * (computed - real) / computed


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=float), 95))
