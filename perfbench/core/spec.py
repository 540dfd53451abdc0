"""Find a cell's files by name.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own under ``perfbench/``:

- ``workloads/<cell>.json``: the configuration's name, the traffic kind,
  the traffic parameters, the limits of the correctness check and ``why``;
- ``configs/<config>.json``: the model's published values as run;
- ``traffic/<kind>.py``: the driver of one traffic kind (``run(ctx)``);
- ``metrics/<metric>.py``: the reader of one metric (``read(record)``).

``BENCHMARK.json`` at the root of the checkout says which metrics a cell
reports. A new cell, configuration or metric is a new file and a new entry:
nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def workload(name: str, base: Path = BENCH_DIR) -> dict:
    return load_json(base / "workloads" / f"{check_name(name)}.json")


def config(name: str, base: Path = BENCH_DIR) -> dict:
    return load_json(base / "configs" / f"{check_name(name)}.json")


def traffic(kind: str):
    """The driver module of a traffic kind: ``perfbench.traffic.<kind>``."""
    return importlib.import_module(f"perfbench.traffic.{check_name(kind)}")


def reader(name: str,
           base: Path = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``: the metric's value, or
    None where the run has nothing for it to read."""
    path = base / "metrics" / f"{check_name(name)}.py"
    mod_name = "perfbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    with ``--trace 0``, its per-layer metrics with ``--trace 1``. An
    end-to-end entry without ``workloads`` applies to every cell; a
    per-layer entry lists its cells."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def kernel_patterns(group: str, base: Path = BENCH_DIR) -> List[re.Pattern]:
    """The device-kernel name patterns of ``metrics/kernels/<group>/``: one
    regular expression a line, in every ``.txt`` file there, ``#`` starting
    a comment. A new kernel that implements the same work adds a file."""
    patterns = []
    for path in sorted((base / "metrics" / "kernels" / group).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                patterns.append(re.compile(line))
    return patterns


def metric_values(bench: dict, cell: str, trace: bool, record: dict,
                  base: Path = BENCH_DIR) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` for each metric of the cell whose
    reader finds something to read."""
    out = {}
    for m in cell_metrics(bench, cell, trace):
        value = reader(m["name"], base)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
