"""Mixture-of-experts training traffic: the port's language-model step on a
DeepSeekMoE configuration in a ``TorchTrainer``.

The loop is ``traffic.train``'s (one ``use_gpu`` worker,
``make_lm_train_step`` on the session's mesh with AdamW, the seed's f32
weights, ``session.report`` after every step, check steps in set-up, then
the window), with one step on each batch of the pool in set-up besides: a
dropless layer's buffers take each batch's own row counts, on the MoE tree (``core.moe_model``) and Zipf-distributed
token ids: skewed ids give the uneven expert load that text gives, which
uniform ids through random weights do not.

The program's perf plane is on through the check steps and, in a
``--trace 1`` run, through the traced steps and the window; a ``--trace 0``
window runs with it off. Its expert-load counter (``models.moe``) gives,
per check step, each held expert's assignments by layer (``load_gap``
holds them against the reference's own routing), the assignments of the
traced steps (the experts' roofline) and, over the window, the load
imbalance.

Traffic parameters: ``traffic.train``'s (``batch`` rows of ``seq_len`` + 1
tokens, ``lr``, ``weight_decay``, ``check_steps``, ``pool``,
``trace_steps``), ``zipf_exponent`` and ``warmup_steps``: AdamW's rate
rises linearly from 0 to ``lr`` over that many steps (``rate``), as a
training run starts; the program and the reference step at the same rate.

``calibrate_moe.py`` reads the program, the control and the faults
through ``program``, ``reference`` and ``load_numbers``.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import List, Optional

import torch

from perfbench import harness
from perfbench.core import compare, moe_model, spec
from perfbench.core.moe_work import train_step_flops
from perfbench.reference.model import adamw_step, f32_matmuls
from perfbench.reference.moe import MoEReference
from perfbench.traffic import train


def sizes(ctx):
    """The cell's expert sizes (``ctx.dims`` holds the rest), from the
    files under ``spec.BENCH_DIR`` as it is at the call."""
    base = spec.BENCH_DIR
    return moe_model.experts(
        spec.config(spec.workload(ctx.cell, base)["config"], base))


def port_config(m: Dims, x: Experts, **kw):
    """The port's ``TransformerConfig`` of these sizes; ``kw`` adds the
    run's settings (``max_seq_len``, ``dtype``, ``remat``, ...)."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        vocab_size=m.vocab, d_model=m.d, n_layers=m.layers, n_heads=m.heads,
        n_kv_heads=m.kv_heads, d_ff=m.ff, rope_theta=m.theta,
        n_experts=x.router, n_experts_held=x.held, first_expert=x.first,
        experts_per_token=x.k, d_expert=x.width, d_shared=x.shared,
        n_dense_layers=x.dense_layers, norm_topk_prob=x.norm_topk,
        routed_scaling_factor=x.scale, aux_loss_alpha=x.alpha, **kw)


def rate(tp: dict, step: int) -> float:
    """AdamW's rate at ``step`` (from 1): the linear warm-up to ``lr``."""
    return tp["lr"] * min(1.0, step / tp["warmup_steps"])


def batch(ctx, stream: int) -> torch.Tensor:
    tp, m = ctx.traffic, ctx.dims
    return moe_model.zipf_tokens(ctx.seed, stream,
                                 (tp["batch"], tp["seq_len"] + 1), m.vocab,
                                 tp["zipf_exponent"], ctx.device)


def _loop(config):
    """The training loop; runs in the train worker's thread."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.observability import perf
    from ray_tpu_torch.train import adamw, make_lm_train_step, session

    ctx, box = config["ctx"], config["box"]
    m, tp, seed, x = ctx.dims, ctx.traffic, ctx.seed, config["experts"]
    device = harness.granted_device(ctx.device)
    ctx = harness.Ctx(**{**ctx.__dict__, "device": device})
    cfg = port_config(m, x, max_seq_len=tp["seq_len"],
                      dtype=torch.bfloat16, remat=True,
                      use_flash=True)
    mesh = session.get_mesh()
    init_fn, step_fn, shard = make_lm_train_step(
        cfg, mesh, optimizer=adamw(tp["lr"], tp["weight_decay"]),
        device=device)
    feed = session.shard_batch if mesh is not None else shard
    state = init_fn(params=moe_model.make_tree(m, x, seed, device,
                                               torch.float32))
    gc.collect()
    opt = state[1]
    leaves = [p for g in opt.param_groups for p in g["params"]]
    done = 0

    def step(tokens):
        nonlocal state, done
        done += 1
        for group in opt.param_groups:
            group["lr"] = rate(tp, done)
        state, metrics = step_fn(state, feed(tokens))
        loss = metrics["loss"].item()
        session.report({"loss": loss})
        return loss

    perf.enable()
    losses, grad_norms, loads = [], None, []
    for i in range(tp["check_steps"]):
        moe.reset_expert_load()
        losses.append(step(batch(ctx, i)))
        loads.append(moe.expert_load())
        if i == 0:  # a leaf the optimizer did not step has no moment
            grad_norms = [n / (1 - train.BETA1) for n in compare.leaf_norms(
                [opt.state.get(p, {}).get("exp_avg", torch.zeros(()))
                 for p in leaves])]
    with torch.no_grad():
        change_norms = [
            float(torch.linalg.vector_norm(
                p - moe_model.make_leaf(m, x, j, seed, device,
                                        torch.float32)))
            for j, p in enumerate(leaves)]
    box["prog"] = {"loss": losses, "grad_norms": grad_norms,
                   "change_norms": change_norms, "loads": loads}
    pool = [batch(ctx, tp["check_steps"] + k) for k in range(tp["pool"])]
    for tokens in pool:  # each batch routes its own row counts: warm them
        step(tokens)
    if ctx.trace:
        moe.reset_expert_load()
        box["trace"] = train._traced_segment(ctx, step, pool, device)
        box["trace_load"] = moe.expert_load()
        moe.settle_dispatch()
        perf.reset()
        moe.reset_expert_load()
    else:
        perf.disable()
    train._sync(device)
    box["setup_s"] = time.perf_counter() - ctx.t_start
    t0 = time.perf_counter()
    n, bad = 0, 0
    while ctx.seconds > 0:
        loss = step(pool[n % len(pool)])
        bad += not math.isfinite(loss)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    train._sync(device)
    box["window_s"] = time.perf_counter() - t0
    box["steps"], box["nonfinite"] = n, bad
    if device.type == "cuda":
        box["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if ctx.trace:
        moe.settle_dispatch()
        box["perf"] = perf.snapshot()
        box["window_load"] = moe.expert_load()
    perf.disable()


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
            _loop, train_loop_config={"ctx": ctx, "box": box,
                                      "experts": sizes(ctx)},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=cuda),
            collective_backend="nccl" if cuda else "cpu")
        result = trainer.fit()
    finally:
        rt.shutdown()
    if result.error is not None:
        raise result.error
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return box


def reference(ctx, precision: str = "f32", top_k: Optional[int] = None,
              capacity_factor: Optional[float] = None) -> dict:
    """The reference's readings over the check steps from the same seed:
    ``precision`` "fp8" is the control; ``top_k`` and ``capacity_factor``
    plant a fault (``reference.moe``)."""
    m, tp, seed, dev = ctx.dims, ctx.traffic, ctx.seed, ctx.device
    x = sizes(ctx)
    ref = MoEReference(m, x, precision, top_k=top_k,
                       capacity_factor=capacity_factor)
    n = len(moe_model.leaf_specs(m, x))
    leaves = [moe_model.make_leaf(m, x, i, seed, dev, torch.float32)
              .requires_grad_() for i in range(n)]
    exp_avg = [torch.zeros_like(p) for p in leaves]
    exp_avg_sq = [torch.zeros_like(p) for p in leaves]
    losses, grad_norms, loads = [], None, []
    with f32_matmuls():
        for t in range(tp["check_steps"]):
            loss = ref.loss(leaves, batch(ctx, t))
            loads.append(ref.loads)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.item())
            if t == 0:
                grad_norms = compare.leaf_norms(grads)
            with torch.no_grad():
                adamw_step(leaves, grads, exp_avg, exp_avg_sq, t + 1,
                           rate(tp, t + 1), tp["weight_decay"])
            del grads, loss
        del exp_avg, exp_avg_sq
        with torch.no_grad():
            change_norms = [
                float(torch.linalg.vector_norm(
                    p - moe_model.make_leaf(m, x, j, seed, dev,
                                            torch.float32)))
                for j, p in enumerate(leaves)]
    del leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad_norms": grad_norms,
            "change_norms": change_norms, "loads": loads}


def per_step_loads(prog_loads: List[dict]) -> List[List[List[float]]]:
    """The program's counter of each check step as [layer][expert]
    assignments of that step's forward."""
    return [[[c / load[layer]["passes"] for c in load[layer]["held"]]
             for layer in sorted(load)] for load in prog_loads]


def load_numbers(prog: List[List[List[float]]],
                 ref: List[List[List[int]]]) -> dict:
    """``load_gap``: over the check steps, MoE layers and held experts, the
    largest gap between the program's count of an expert's assignments and
    the reference's, over the larger of the reference's count and that
    layer's mean; ``route_diff``: the share of the reference's held
    assignments that the counts show moved (half the summed gaps)."""
    gap, moved, total = 0.0, 0.0, 0
    for p_step, r_step in zip(prog, ref):
        if len(p_step) != len(r_step):
            return {"load_gap": math.inf, "route_diff": math.inf}
        for p, r in zip(p_step, r_step):
            floor = max(statistics.mean(r), 1.0)
            gap = max([gap] + [abs(a - b) / max(b, floor)
                               for a, b in zip(p, r)])
            moved += sum(abs(a - b) for a, b in zip(p, r)) / 2
            total += sum(r)
    return {"load_gap": gap, "route_diff": moved / max(total, 1)}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: ``core.compare``'s training
    gaps and ``load_gap``."""
    out = compare.train_numbers(prog, ref)
    out["load_gap"] = load_numbers(per_step_loads(prog["loads"]),
                                   ref["loads"])["load_gap"]
    return out


def traced_assignments(load: dict, steps: int) -> float:
    """Held assignments of the traced steps, over all MoE layers: the
    counter's count per forward pass times the steps (a recompute repeats
    its forward's routing)."""
    total = sum(sum(e["held"]) for e in load.values())
    passes = sum(e["passes"] for e in load.values())
    return total * steps * len(load) / passes if passes else 0.0


def run(ctx) -> dict:
    box = program(ctx)
    ref = reference(ctx)
    m, tp, x = ctx.dims, ctx.traffic, sizes(ctx)
    tokens_per_step = tp["batch"] * tp["seq_len"]
    out = {
        "kind": "train", "dims": m, "experts": x, "setup_s": box["setup_s"],
        "window_s": box["window_s"], "steps": box["steps"],
        "tokens": box["steps"] * tokens_per_step,
        "flops": box["steps"] * train_step_flops(m, x, tp["batch"],
                                                 tp["seq_len"]),
        "attempted": box["steps"], "failed": box["nonfinite"],
        "peak_bytes": box.get("peak_bytes", 0),
        "perf": box.get("perf"), "trace": box.get("trace"),
        "moe_load": box.get("window_load"),
        "numbers": numbers(box["prog"], ref),
    }
    if out["trace"] is not None:
        out["trace"]["moe_assignments"] = traced_assignments(
            box["trace_load"], tp["trace_steps"])
    return out
