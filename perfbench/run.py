"""Run one cell of the benchmark once, in this process, and print its line.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``); the last lines of
standard error are the numbers compared, each beside its limit. It exits
with another code than 0, and prints no result, where this process has
fewer CUDA cards than the cell asks for, or where ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the run is over.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")
# Kernel caches of the program stay in the checkout, at fixed paths.
CACHES = {"TRITON_CACHE_DIR": "build/perfbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/perfbench/torch_extensions"}


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def written_bytes() -> str:
    """What this process wrote: to storage, and through write calls."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
    except OSError as e:
        return f"unknown ({e})"
    return f"{io['write_bytes']} to storage, {io['wchar']} by write calls"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(REPO / rel)
    sys.path.insert(0, str(REPO))

    import torch
    from perfbench import harness
    from perfbench.core import compare, spec

    bench = spec.benchmark(REPO)
    need = harness.chips(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA card(s); this process "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; peaks: bf16 989 TFLOP/s, HBM 3.35 TB/s",
          file=sys.stderr, flush=True)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_START, bench)
    print(f"bytes written by this process: {written_bytes()}",
          file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    compare.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
