"""Readings that the limits of a ``train_moe`` cell's ``correct`` are set
from, on the chip, at the cell's own size (``calibrate.py`` for the
``train`` and ``serve`` kinds):

    python3 perfbench/calibrate_moe.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2] [--out readings.jsonl]

For each seed of ``--seeds``: the program's numbers (a run of the
program's check steps, the window left out), against the float32
reference, with ``route_diff``: the share of the reference's held
assignments that the program's expert-load counter shows moved. For each
seed of ``--control-seeds`` also, each put in the program's place:
- the control: the reference computed in fp8 (``reference.model``);
- the last pick left out: top ``k - 1`` routing;
- a capacity: at most 1.25 x tokens x k / experts assignments kept per
  expert, the rest dropped (what a switch layer with a capacity does).
One JSON line a reading. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FAULTS = (("control_fp8", {"precision": "fp8"}),
          ("fault_capacity_1.25", {"capacity_factor": 1.25}))


def readings(ctx, control: bool):
    from perfbench.core import compare
    from perfbench.traffic import train_moe as tm
    prog = tm.program(ctx)["prog"]
    ref = tm.reference(ctx)
    rows = [("program", {**tm.numbers(prog, ref), **tm.load_numbers(
        tm.per_step_loads(prog["loads"]), ref["loads"])})]
    if control:
        k = tm.sizes(ctx).k
        for what, kw in FAULTS + (("fault_last_pick_left_out",
                                   {"top_k": k - 1}),):
            got = tm.reference(ctx, **kw)
            rows.append((what, {**compare.train_numbers(got, ref),
                                **tm.load_numbers(got["loads"],
                                                  ref["loads"])}))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.make_ctx(args.workload, seed, 0.0, False,
                               torch.device("cuda", 0), time.perf_counter())
        for what, numbers in readings(ctx, seed in control):
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "what": what, **numbers})
            print(line, flush=True)
            if args.out is not None:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
