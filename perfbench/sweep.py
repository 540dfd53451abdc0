"""Find the knee of a serving cell once, on the chip: one deployment, one
seed, the cell's own schedule offered at each rate in turn for
``--seconds`` (by default the benchmark's ``run_seconds``):

    python3 perfbench/sweep.py --workload <cell> --rates 6,7,8,9 \\
        [--seconds 51] [--seed 7]

The schedule at each rate is the cell's (``traffic.serve.schedule``): the
same prompts in the same order, their gaps scaled by the rate. For each rate
one JSON line: requests due, answered inside the window, answered late
(after the window closed), latency p50 / p95 / max from the due time, the
mean latency of the window's first and last thirds, the served real
tokens/s (as ``serve_tokens_per_s`` reads them), the replica's forward time per request (what its
latency-guarded batch cap divides its budget by), and ``keeps_pace``: every request answered by ``LATE_S`` past the
close and the last third's mean latency at most ``GROWTH`` times the
first's. The knee is the highest rate that keeps pace with every lower
rate swept keeping pace too. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LATE_S = 2.0
GROWTH = 1.5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from perfbench import harness
    from perfbench.core import spec
    from perfbench.traffic import serve
    from ray_tpu_torch.observability import perf

    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    seconds = (args.seconds if args.seconds is not None
               else float(spec.benchmark()["run_seconds"]))
    ctx = harness.make_ctx(args.workload, args.seed, seconds, False,
                           torch.device("cuda", 0), T_START)
    handle = serve.deploy(ctx)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            c = dataclasses.replace(
                ctx, traffic={**ctx.traffic, "rate_per_s": rate})
            due, reqs = serve.requests(c.traffic, c.seconds, c.seed,
                                       c.dims.vocab)
            box: dict = {}
            serve.run_window(c, handle, due, reqs, box, perf)
            done = box["done"]
            lat = (done - due) * 1e3
            ok = ~np.isnan(done)
            third = len(due) // 3
            lengths = np.array([len(r["tokens"]) for r in reqs])
            in_time = ok & (done <= c.seconds)
            first = float(np.nanmean(lat[:third]))
            last = float(np.nanmean(lat[-third:]))
            last_answer_s = float(np.nanmax(done))
            batches = handle.take_batches.remote().result(timeout=60)
            print(json.dumps({
                "rate": rate, "due": len(due),
                "answered_in_window": int(in_time.sum()),
                "answered_late": int((ok & ~in_time).sum()),
                "failed": int((~ok).sum()),
                "p50_ms": float(np.nanpercentile(lat, 50)),
                "p95_ms": float(np.nanpercentile(lat, 95)),
                "max_ms": float(np.nanmax(lat)),
                "first_third_ms": first, "last_third_ms": last,
                "last_answer_s": last_answer_s,
                "keeps_pace": bool(ok.all()
                                   and last_answer_s <= c.seconds + LATE_S
                                   and last <= GROWTH * first),
                "tokens_per_s": float(lengths[ok].sum()
                                      / max(c.seconds, last_answer_s)),
                "batches": len(batches),
                "forward_ms_per_request": sum(
                    b["t1"] - b["t0"] for b in batches) / 1e6 / max(
                        1, sum(b["rows"] for b in batches))}), flush=True)
    finally:
        serve.undeploy(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
