"""Training traffic: the port's language-model step in a ``TorchTrainer``.

The loop a user hands ``TorchTrainer`` (one ``use_gpu`` worker): it builds
``make_lm_train_step`` on the session's mesh with AdamW, starts from the
seed's f32 weights, and calls ``session.report`` after every step. Set-up
drives the step through its first ``check_steps`` steps on batches that
all differ, and reads what the check compares; those steps also build the
kernels and warm the allocator. The window then runs steps on a pool of
further batches for ``--seconds``, each step ending in the loss's read.

After the window the program's state is freed and the reference
(``perfbench.reference``) follows the same first steps from the same seed
in float32; ``core.compare`` judges the readings.

Traffic parameters (``traffic`` in the workload file): ``batch`` rows of
``seq_len`` + 1 uniform tokens, ``lr``, ``weight_decay``, ``check_steps``,
``pool`` (batches the window cycles through) and ``trace_steps`` (steps in
the traced segment of a ``--trace 1`` run).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Optional

import torch

from perfbench import harness
from perfbench.core import compare, model, trace
from perfbench.core.work import train_step_flops
from perfbench.reference.model import Reference, adamw_step, f32_matmuls

BETA1 = 0.9


def _loop(config):
    """The training loop; runs in the train worker's thread."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import perf
    from ray_tpu_torch.train import adamw, make_lm_train_step, session

    ctx, box = config["ctx"], config["box"]
    m, tp, seed = ctx.dims, ctx.traffic, ctx.seed
    B, L = tp["batch"], tp["seq_len"]
    device = harness.granted_device(ctx.device)
    cfg = TransformerConfig(
        vocab_size=m.vocab, d_model=m.d, n_layers=m.layers, n_heads=m.heads,
        n_kv_heads=m.kv_heads, d_ff=m.ff, max_seq_len=L,
        dtype=torch.bfloat16, remat=True, use_flash=True, rope_theta=m.theta)
    mesh = session.get_mesh()
    init_fn, step_fn, shard = make_lm_train_step(
        cfg, mesh, optimizer=adamw(tp["lr"], tp["weight_decay"]),
        device=device)
    feed = session.shard_batch if mesh is not None else shard
    state = init_fn(params=model.make_tree(m, seed, device, torch.float32))
    gc.collect()
    opt = state[1]
    leaves = [p for g in opt.param_groups for p in g["params"]]

    def step(tokens):
        nonlocal state
        state, metrics = step_fn(state, feed(tokens))
        loss = metrics["loss"].item()
        session.report({"loss": loss})
        return loss

    losses, grad_norms = [], None
    for i in range(tp["check_steps"]):
        losses.append(step(model.tokens(seed, i, (B, L + 1), m.vocab,
                                        device)))
        if i == 0:  # a leaf the optimizer did not step has no moment
            grad_norms = [n / (1 - BETA1) for n in compare.leaf_norms(
                [opt.state.get(p, {}).get("exp_avg", torch.zeros(()))
                 for p in leaves])]
    with torch.no_grad():
        change_norms = [
            float(torch.linalg.vector_norm(
                p - model.make_leaf(m, j, seed, device, torch.float32)))
            for j, p in enumerate(leaves)]
    box["prog"] = {"loss": losses, "grad_norms": grad_norms,
                   "change_norms": change_norms}
    pool = [model.tokens(seed, tp["check_steps"] + k, (B, L + 1), m.vocab,
                         device) for k in range(tp["pool"])]
    if ctx.trace:
        box["trace"] = _traced_segment(ctx, step, pool, device)
        perf.enable()
        perf.reset()
    _sync(device)
    box["setup_s"] = time.perf_counter() - ctx.t_start
    t0 = time.perf_counter()
    n, bad = 0, 0
    while ctx.seconds > 0:
        loss = step(pool[n % len(pool)])
        bad += not math.isfinite(loss)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    _sync(device)
    box["window_s"] = time.perf_counter() - t0
    box["steps"], box["nonfinite"] = n, bad
    if device.type == "cuda":
        box["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if ctx.trace:
        box["perf"] = perf.snapshot()
        perf.disable()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced_segment(ctx, step, pool, device) -> dict:
    """``trace_steps`` steps under the profiler, before the window; each
    step's host spans are marked on the wall clock."""
    tp, m = ctx.traffic, ctx.dims
    _sync(device)
    prof = trace.start_profiler()
    spans, units = [], []
    w0 = time.time_ns()
    for k in range(tp["trace_steps"]):
        a = time.time_ns()
        step(pool[k % len(pool)])
        b = time.time_ns()
        spans.append(("train step: dispatch, loss read, session.report",
                      a, b))
        shapes = [[tp["batch"], tp["seq_len"], m.layers]]
        units.append({"t0": a, "t1": b, "attn_fwd": shapes,
                      "attn_bwd": shapes})
    _sync(device)
    w1 = time.time_ns()
    prof.stop()
    summary = trace.summarize(prof, w0, w1, spans)
    summary["units"] = units
    return summary


def program(ctx) -> dict:
    """The program's side of a run: ``TorchTrainer.fit`` of ``_loop``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    box: dict = {}
    cuda = ctx.device.type == "cuda"
    rt.init(num_cpus=4)
    try:
        trainer = TorchTrainer(
            _loop, train_loop_config={"ctx": ctx, "box": box},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=cuda),
            collective_backend="nccl" if cuda else "cpu")
        result = trainer.fit()
    finally:
        rt.shutdown()
    if result.error is not None:
        raise result.error
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return box


def reference(ctx, precision: str = "f32", rows=None,
              steps: Optional[int] = None) -> dict:
    """The reference's readings over the first steps from the same seed:
    ``precision`` "fp8" is the control; ``rows`` keeps only those rows of
    each batch (a fault: part of the batch left out)."""
    m, tp, seed, dev = ctx.dims, ctx.traffic, ctx.seed, ctx.device
    B, L = tp["batch"], tp["seq_len"]
    ref = Reference(m, precision)
    n = len(model.leaf_specs(m))
    leaves = [model.make_leaf(m, i, seed, dev, torch.float32)
              .requires_grad_() for i in range(n)]
    exp_avg = [torch.zeros_like(p) for p in leaves]
    exp_avg_sq = [torch.zeros_like(p) for p in leaves]
    losses, grad_norms = [], None
    with f32_matmuls():
        for t in range(steps or tp["check_steps"]):
            tokens = model.tokens(seed, t, (B, L + 1), m.vocab, dev)
            loss = ref.loss(leaves, tokens, rows)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.item())
            if t == 0:
                grad_norms = compare.leaf_norms(grads)
            with torch.no_grad():
                adamw_step(leaves, grads, exp_avg, exp_avg_sq, t + 1,
                           tp["lr"], tp["weight_decay"])
            del grads, loss
        del exp_avg, exp_avg_sq
        with torch.no_grad():
            change_norms = [
                float(torch.linalg.vector_norm(
                    p - model.make_leaf(m, j, seed, dev, torch.float32)))
                for j, p in enumerate(leaves)]
    del leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad_norms": grad_norms,
            "change_norms": change_norms}


def run(ctx) -> dict:
    box = program(ctx)
    ref = reference(ctx)
    m, tp = ctx.dims, ctx.traffic
    tokens_per_step = tp["batch"] * tp["seq_len"]
    return {
        "kind": "train", "dims": m, "setup_s": box["setup_s"],
        "window_s": box["window_s"], "steps": box["steps"],
        "tokens": box["steps"] * tokens_per_step,
        "flops": box["steps"] * train_step_flops(m, tp["batch"],
                                                 tp["seq_len"]),
        "attempted": box["steps"], "failed": box["nonfinite"],
        "peak_bytes": box.get("peak_bytes", 0),
        "perf": box.get("perf"), "trace": box.get("trace"),
        "numbers": compare.train_numbers(box["prog"], ref),
    }
