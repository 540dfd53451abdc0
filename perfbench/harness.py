"""Run one cell once and build the result line.

``run_cell`` finds the cell's files by name (``core.spec``), hands the
traffic driver the cell's sizes and traffic parameters, and turns the
driver's record into the line the benchmark prints: ``correct``,
``attempted``, ``failed``, ``metrics`` (read by the metric readers),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from perfbench.core import compare, model, spec


@dataclass
class Ctx:
    cell: str
    traffic: dict
    dims: model.Dims
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


def granted_device(want: torch.device) -> torch.device:
    """The device a runtime worker computes on: the card the runtime
    granted it where the cell runs on ``cuda``, else ``want``. A worker
    that was granted no card raises, so no run falls back to the CPU."""
    if want.type != "cuda":
        return want
    import ray_tpu_torch as rt
    devices = rt.get_runtime_context().get_gpu_devices()
    if not devices:
        raise RuntimeError("the runtime granted this worker no GPU")
    return devices[0]


def make_ctx(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             base: Path = spec.BENCH_DIR) -> Ctx:
    work = spec.workload(cell, base)
    dims = model.dims(spec.config(work["config"], base))
    return Ctx(cell=cell, traffic=work["traffic"], dims=dims,
               seed=int(seed), seconds=float(seconds), trace=bool(trace),
               device=device, t_start=t_start)


def chips(bench: dict, cell: str) -> int:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return int(w["chips"])
    raise KeyError(f"{cell} is not a cell of BENCHMARK.json")


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             bench: Optional[dict] = None,
             base: Path = spec.BENCH_DIR) -> dict:
    bench = bench if bench is not None else spec.benchmark()
    work = spec.workload(cell, base)
    ctx = make_ctx(cell, seed, seconds, trace, device, t_start, base)
    record = spec.traffic(work["traffic"]["kind"]).run(ctx)
    correct, checks = compare.judge(record["numbers"], work["check"])
    correct = correct and record["failed"] == 0
    metrics = spec.metric_values(bench, cell, trace, record, base)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(record["peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics,
           "device": dev}
    tr = record.get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    if not correct:
        print(f"not correct: failed {record['failed']}", file=sys.stderr,
              flush=True)
    return out
