"""Readings that the limits of ``correct`` are set from, on the chip, at the
cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 15] [--out chiprun_out/x.jsonl]

For each seed of ``--seeds``: the program's numbers (a sound run, through
the window's own call), against the float32 reference. For each seed of
``--control-seeds`` also:
- the control: the reference computed in fp8 (``reference.model``), put in
  the program's place;
- training: half of each batch left out, the mean taken over the rest
  (planted in the reference put in the program's place); a state left
  unchanged reads 1 on ``change_gap`` by construction and needs no run;
- serving: each answer taken one token early (an answer altered where it
  is produced), and each answer handed to another request (part of the
  batch left out).
One JSON line a reading. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_readings(ctx, control: bool):
    from perfbench.core import compare
    from perfbench.traffic import train
    prog = train.program(ctx)["prog"]
    ref = train.reference(ctx)
    rows = [("program", compare.train_numbers(prog, ref))]
    if control:
        rows.append(("control_fp8", compare.train_numbers(
            train.reference(ctx, "fp8"), ref)))
        half = list(range(ctx.traffic["batch"] // 2))
        rows.append(("fault_half_batch", compare.train_numbers(
            train.reference(ctx, rows=half), ref)))
    return rows


def serve_readings(ctx, control: bool):
    import numpy as np
    import torch

    from perfbench.core import compare
    from perfbench.traffic import serve
    box = serve.program(ctx)
    missing = sum(a is None for a in box["answers"])
    picked = serve.sample(ctx, box)
    prompts = [box["reqs"][i]["tokens"] for i in picked]
    ref = serve.reference_logits(ctx, prompts)
    served = [torch.as_tensor(np.array(box["answers"][i])) for i in picked]
    rows = [("program", compare.serve_numbers(served, ref, missing))]
    if control:
        rows.append(("control_fp8", compare.serve_numbers(
            serve.reference_logits(ctx, prompts, "fp8"), ref, 0)))
        early = serve.reference_logits(ctx, [p[:-1] for p in prompts])
        rows.append(("fault_answer_altered",
                     compare.serve_numbers(early, ref, 0)))
        rows.append(("fault_rows_swapped", compare.serve_numbers(
            served[1:] + served[:1], ref, 0)))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from perfbench import harness
    from perfbench.core import spec

    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = spec.workload(args.workload)["traffic"]["kind"]
    readings = {"train": train_readings, "serve": serve_readings}[kind]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.make_ctx(args.workload, seed, args.seconds, False,
                               device, time.perf_counter())
        for what, numbers in readings(ctx, seed in control):
            _emit(args.out, {"cell": args.workload, "seed": seed,
                             "what": what, **numbers})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
