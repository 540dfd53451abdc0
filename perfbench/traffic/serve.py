"""Serving traffic: prompt scoring through a Serve deployment of the port.

``ScoringLM`` is the deployment a user writes: it makes the seed's bf16
weights on the card its replica was granted, and answers each request (a
list of token ids) with the f32 logits at its last token, through
``air.TorchPredictor`` and the port's transformer. The replica's batcher
hands it batches padded to ``pad_batch_to`` (by repeating the last
request); the deployment right-pads the prompts to a length bucket
(``serve.batching.next_bucket``), which causal attention with a top-left
mask makes exact.

The load is an open loop: requests are sent by ``handle.remote`` at due
times from one schedule, each is timed from its due time to its answer, and
the generator's lateness is printed. The schedule (Poisson arrivals at
``rate_per_s``, lognormal prompt lengths) is drawn once from the mix's own
``schedule_seed``, so every run seed offers the same arrivals with the same
lengths in the same order; the run seed draws the token ids and the
weights. (The order decides which long prompts queue together: with it
drawn from the run seed, the p95 of four 40 s runs read 314-1558 ms.)
Arrivals are unit-rate gaps scaled by the rate and lengths come from a
stream of their own, so the mix at another rate offers the same prompts in
the same order, only closer together: the knee sweep (``sweep.py``) runs
the cell's own schedule at each rate.

After the window every answer due in it is awaited, the deployment is shut
down, and the reference scores a sample of the answered prompts (the
longest among them) from the same seed's weights in float32.
"""

from __future__ import annotations

import concurrent.futures
import functools
import gc
import sys
import time
from typing import List

import numpy as np
import torch

from perfbench import harness
from perfbench.core import compare, model, trace
from perfbench.reference.model import Reference, f32_matmuls


def schedule(tp: dict, seconds: float):
    """(due times in s, lengths) of the mix, the same for every seed."""
    gaps = np.random.default_rng([tp["schedule_seed"], 0])
    scale = 1.0 / tp["rate_per_s"]
    due, t = [], gaps.exponential() * scale
    while t < seconds:
        due.append(t)
        t += gaps.exponential() * scale
    raw = np.random.default_rng([tp["schedule_seed"], 1]).lognormal(
        np.log(tp["length_median"]), tp["length_sigma"], size=len(due))
    lengths = np.clip(np.rint(raw), tp["length_min"], tp["length_max"])
    return np.array(due), lengths.astype(np.int64)


def requests(tp: dict, seconds: float, seed: int, vocab: int):
    """(due times, requests): the run seed draws each prompt's ids."""
    due, lengths = schedule(tp, seconds)
    rng = np.random.default_rng(model.mix(seed, 2))
    reqs = [{"id": i, "tokens": rng.integers(0, vocab, size=int(n),
                                             dtype=np.int64)}
            for i, n in enumerate(lengths)]
    return due, reqs


def _last_token_logits(cfg, params, batch):
    from ray_tpu_torch.models import transformer
    x = transformer.backbone(params, batch["tokens"], cfg)
    x = x[torch.arange(x.shape[0], device=x.device), batch["last"]][:, None]
    return transformer.head(params, x, cfg)[:, 0]


class ScoringLM:
    """The served deployment (module note)."""

    def __init__(self, dims: model.Dims, seed: int, buckets, max_len: int,
                 device: str):
        from ray_tpu_torch.air import TorchPredictor
        from ray_tpu_torch.models.transformer import TransformerConfig

        self.device = harness.granted_device(torch.device(device))
        m = dims
        self.cfg = TransformerConfig(
            vocab_size=m.vocab, d_model=m.d, n_layers=m.layers,
            n_heads=m.heads, n_kv_heads=m.kv_heads, d_ff=m.ff,
            max_seq_len=max_len, dtype=torch.bfloat16, remat=False,
            use_flash=True, rope_theta=m.theta)
        self.buckets = tuple(buckets)
        self.predictor = TorchPredictor(
            model.make_tree(m, seed, self.device, torch.bfloat16),
            functools.partial(_last_token_logits, self.cfg),
            device=self.device)
        self.batches: List[dict] = []

    def _padded(self, prompts):
        from ray_tpu_torch.serve.batching import next_bucket
        L = next_bucket(max(len(p) for p in prompts), self.buckets)
        tokens = np.zeros((len(prompts), L), dtype=np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        last = np.array([len(p) - 1 for p in prompts], dtype=np.int64)
        return {"tokens": tokens, "last": last}

    def __call__(self, requests):
        t0 = time.time_ns()
        batch = self._padded([r["tokens"] for r in requests])
        out = self.predictor.predict(batch)
        t1 = time.time_ns()
        seen = {}
        for r in requests:  # the batcher pads by repeating the last one
            seen[r["id"]] = len(r["tokens"])
        self.batches.append({"t0": t0, "t1": t1, "rows": len(requests),
                             "len": int(batch["tokens"].shape[1]),
                             "lengths": list(seen.values())})
        return list(out)

    def warmup(self, rows, lengths):
        """One forward at every (rows, bucket) shape the traffic can
        form, the largest first."""
        for L in sorted(lengths, reverse=True):
            for b in sorted(rows, reverse=True):
                self.predictor.predict(self._padded([np.zeros(L, np.int64)]
                                                    * b))
        return len(rows) * len(lengths)

    def take_batches(self):
        out, self.batches = self.batches, []
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def deploy(ctx):
    """The runtime, the deployment from ``ctx.seed``, warmed up at every
    shape the traffic can form: a ready handle."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    tp, m = ctx.traffic, ctx.dims
    rt.init(num_cpus=8, _system_config={
        "serve_queue_deadline_ms": float(tp["queue_deadline_ms"])})
    dep = serve.deployment(
        ScoringLM, name="scoring", max_batch_size=tp["max_batch_size"],
        batch_wait_timeout_s=tp["batch_wait_timeout_s"],
        pad_batch_to=tuple(tp["pad_batch_to"]),
        target_latency_ms=float(tp["target_latency_ms"]),
        ray_actor_options=({"num_gpus": 1} if ctx.device.type == "cuda"
                           else {}))
    handle = serve.run(dep.bind(m, ctx.seed, tp["length_buckets"],
                                tp["length_max"], ctx.device.type),
                       route_prefix=None)
    handle.warmup.remote(tp["pad_batch_to"],
                         tp["length_buckets"]).result(timeout=900)
    handle.take_batches.remote().result(timeout=60)
    return handle


def undeploy(ctx) -> None:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    try:
        serve.shutdown()
    finally:
        rt.shutdown()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def program(ctx) -> dict:
    """The program's side of a run: deploy, the window, every answer due
    in it, the replica's batches; then the deployment is shut down."""
    from ray_tpu_torch.observability import perf

    due, reqs = requests(ctx.traffic, ctx.seconds, ctx.seed, ctx.dims.vocab)
    box: dict = {"due": due, "reqs": reqs}
    try:
        handle = deploy(ctx)
        run_window(ctx, handle, due, reqs, box, perf)
        box["batches"] = handle.take_batches.remote().result(timeout=60)
        if ctx.device.type == "cuda":
            box["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    finally:
        undeploy(ctx)
    return box


def run_window(ctx, handle, due, reqs, box, perf) -> None:
    tp, n = ctx.traffic, len(reqs)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    answers, errors = [None] * n, [None] * n
    cap_s = ctx.seconds + tp["answer_wait_s"]

    def wait(i, response, t0):
        try:
            answers[i] = response.result(
                timeout=max(0.0, t0 + cap_s - time.perf_counter()))
            done[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - counted as failed below
            errors[i] = repr(e)

    prof = None
    if ctx.trace:
        perf.enable()
        perf.reset()
        _sync(ctx.device)
        prof = trace.start_profiler()
        box["w0"] = time.time_ns()
    box["setup_s"] = time.perf_counter() - ctx.t_start
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=128)
    futures = []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            delay = t0 + due[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            sent[i] = time.perf_counter() - t0
            try:
                response = handle.remote(reqs[i])
            except Exception as e:  # noqa: BLE001 - refused: failed
                errors[i] = repr(e)
                continue
            futures.append(pool.submit(wait, i, response, t0))
        concurrent.futures.wait(futures, timeout=cap_s + 5.0)
    finally:
        pool.shutdown(wait=True)
    if ctx.trace:
        _sync(ctx.device)
        box["w1"] = time.time_ns()
        prof.stop()
        box["prof"] = prof
        box["perf"] = perf.snapshot()
        perf.disable()
    late = (sent - due) * 1e3
    print(f"generator lateness ms: max {np.nanmax(late):.3f} p95 "
          f"{np.nanpercentile(late, 95):.3f} over {n} requests",
          file=sys.stderr, flush=True)
    box.update(sent=sent, done=done, answers=answers, errors=errors,
               cap_s=cap_s)


def _trace_summary(box, m) -> dict:
    w0, w1 = box["w0"], box["w1"]
    inside = [b for b in box["batches"] if w0 <= b["t0"] and b["t1"] <= w1]
    spans = [("no forward running: arrivals, router, batcher linger",
              w0, w1)]
    spans += [("replica forward (host dispatch, device work, answer copy)",
               b["t0"], b["t1"]) for b in box["batches"]]
    summary = trace.summarize(box.pop("prof"), w0, w1, spans)
    summary["units"] = [{"t0": b["t0"], "t1": b["t1"],
                         "attn_fwd": [[1, n, m.layers] for n in b["lengths"]]}
                        for b in inside]
    return summary


def reference_logits(ctx, prompts, precision: str = "f32"):
    """The reference's last-token logits of ``prompts`` from the seed's
    bf16 weights, layer by layer."""
    m, dev = ctx.dims, ctx.device
    tree = model.make_tree(m, ctx.seed, dev, torch.bfloat16)
    blocks = tree["blocks"]

    def layer(i):
        a, f = blocks["attn"], blocks["mlp"]
        return dict(wq=a["wq"][i], wk=a["wk"][i], wv=a["wv"][i],
                    wo=a["wo"][i], wi=f["wi"][i], wg=f["wg"][i],
                    wo_mlp=f["wo"][i], ln1=blocks["ln1"][i],
                    ln2=blocks["ln2"][i])

    ref = Reference(m, precision)
    with torch.no_grad(), f32_matmuls():
        out = ref.last_token_logits(
            layer, tree["embed"], tree["ln_f"], tree["lm_head"],
            [torch.as_tensor(p, device=dev) for p in prompts])
    out = [o.cpu() for o in out]
    del tree, blocks
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def sample(ctx, box) -> List[int]:
    """The answered requests the check compares: the longest, and others
    drawn from the seed."""
    answered = [i for i, a in enumerate(box["answers"]) if a is not None]
    if not answered:
        return []
    k = min(ctx.traffic["check_sample"], len(answered))
    longest = max(answered, key=lambda i: len(box["reqs"][i]["tokens"]))
    rest = [i for i in answered if i != longest]
    rng = np.random.default_rng(model.mix(ctx.seed, 3))
    picked = rng.choice(len(rest), size=k - 1, replace=False) if k > 1 else []
    return [longest] + [rest[j] for j in picked]


def run(ctx) -> dict:
    box = program(ctx)
    m, n = ctx.dims, len(box["reqs"])
    lengths = np.array([len(r["tokens"]) for r in box["reqs"]])
    failed = [i for i in range(n) if box["answers"][i] is None]
    for i in failed[:5]:
        print(f"request {i} failed: {box['errors'][i]}", file=sys.stderr)
    latency_ms = np.where(np.isnan(box["done"]), box["cap_s"],
                          box["done"] - box["due"]) * 1e3
    answered = ~np.isnan(box["done"])
    # the window runs until the close or the last answer due in it
    span_s = max([ctx.seconds] + box["done"][answered].tolist())
    picked = sample(ctx, box)
    ref = reference_logits(ctx, [box["reqs"][i]["tokens"] for i in picked])
    served = [torch.from_numpy(np.array(box["answers"][i])) for i in picked]
    record = {
        "kind": "serve", "dims": m, "setup_s": box["setup_s"],
        "window_s": span_s, "latencies_ms": latency_ms.tolist(),
        "answered_tokens": int(lengths[answered].sum()),
        "attempted": n, "failed": len(failed),
        "batches": box["batches"], "peak_bytes": box.get("peak_bytes", 0),
        "perf": box.get("perf"), "trace": None,
        "numbers": compare.serve_numbers(served, ref, len(failed)),
    }
    if ctx.trace:
        record["trace"] = _trace_summary(box, m)
    return record
