#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which asserts:
1. device: a CUDA card is present; print its name and power limit;
2. build: compile every CUDA kernel of the path from ``ray_tpu_torch/ops/csrc``
   and print ptxas's registers and spills for each instantiation;
3. kernels: hold the flash-attention forward kernels (f32: FMA; bf16:
   tensor cores) against their plain PyTorch version (O and LSE) over head
   dims 16/32/64/128, f32 and bf16, causal and full, L = 256, 1024 and a
   ragged 200, and Lq != Lk;
4. entry: run ``ray_tpu_torch.entry``'s flagship forward once;
5. serve: answer 16 requests of 1..1024 tokens through ``@serve.batch`` and
   a ``TorchPredictor`` at the width of ``bench.py``'s transformer (d_model
   1024, 12 layers, 16 heads, d_ff 4096, vocab 32000; ~268 M parameters,
   random weights from a seed). In f32 each answer must match a one-request,
   unpadded run of the dense-attention model; in bf16 answers must be
   finite. Every attention call must have gone through the kernel;
6. times: the kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` at the serving shape, beside the
   kernel's bound, and the bf16 serving rate;
7. backward kernels: dQ, dK and dV of the dq and dkv kernels (f32: FMA;
   bf16: both on the tensor cores) against the plain backward over the
   cases of phase 3, and the same cases through the autograd Function
   against autograd of the plain forward;
8. training parity: 3 f32 steps of ``make_lm_train_step`` at the width of
   phase 5 cut to 2 layers, batch 2 x 513 tokens, through the kernels and
   through dense attention from the same weights; loss and grad norm agree
   step by step;
9. training (the kernels line's launches are counted here): the
   transformer of phase 5 at full depth, bf16, remat on, default AdamW,
   batch 8 x 1025 tokens: 1 warm-up step and 5 measured steps on one seeded
   batch; losses finite and falling, 2 x n_layers forward and n_layers dq
   and dkv launches a step; step time, tokens/s, peak memory; a
   ``torch.profiler`` trace of 3 steps: the device's busy share and the
   operators that take its time;
10. backward times: each backward kernel, the plain backward and PyTorch's
   SDPA backward at the training shape, beside each kernel's bound, and the
   attention kernels' share of a training step;
11. ResNet parity: ``resnet18(num_classes=10)`` in f32 (TF32 off), batch 4
   at 64 x 64 and 37 x 37, from the same weights on the card and on the
   CPU: logits, loss and every gradient agree (the CPU tests hold the CPU
   run against the JAX package);
12. ResNet training (the image path; no attention kernel on it, so the
   launch counts stay 0): ResNet-50 at batch 128 x 224 x 224 and ResNet-18
   at batch 256, bf16, SGD(0.1, momentum 0.9), one seeded batch: 1 warm-up
   step, in which every convolution's tensors must be ``channels_last``,
   then 10 measured steps; losses finite, and the first update lowers the
   loss (the recipe overshoots later on this batch); step time, images/s,
   model TFLOP/s and MFU (``bench.py``'s FLOP count), peak memory, and a
   trace as in phase 9;
13. bench: ``python3 -m ray_tpu_torch.bench`` as a user runs it, in a
   subprocess; it exits 0, its headline has every device figure and no
   error but ``ppo``'s, and its transformer section launched the three
   kernels 2 x n_layers / n_layers / n_layers times a step;
14. sharded step (``ray_tpu_torch.parallel``): (a) ``dryrun_multichip`` over
   every card of the machine on NCCL, one rank per card; (b) in this
   process, an NCCL world of one rank and a mesh whose every axis is 1: 3 f32
   steps of the sharded ``make_lm_train_step`` at phase 8's width, batch
   and weights follow phase 8's one-device trajectory through the kernels
   (loss and grad norm at ``TRAIN_RTOL``); (c) phase 9's bf16 training
   (same width, depth, batch and weights) through the sharded step: 1
   warm-up and 5 measured steps, losses finite and falling, 2 x n_layers /
   n_layers / n_layers kernel launches a step, and the step time beside
   phase 9's (the cost of the DTensor path at world size 1); (d) the
   one-device and the sharded step timed in turns in this process;
15. runtime (``ray_tpu_torch``'s in-process runtime): (a) ``init(num_cpus=8)``
   detects the card as ``GPU: 1.0``; whether the native object arena and
   scheduling library loaded; (b) a bf16 [8192, 8192] tensor produced on a
   side stream (behind ~50 ms of spinning) and ``put``: ``get`` from another
   task returns the same object, device memory is unchanged, and its values
   equal a host-synchronised copy (the put's event was waited on); an
   in-place write makes ``get`` refuse it; the put/get round trip (host
   clock, median of 100); (c) phase 5's deployment, weights and requests in
   a ``num_gpus=1`` actor granted ``[cuda:0]``: f32 answers against the
   dense run as in phase 5, then bf16 (1 warm-up and 3 measured passes),
   ``n_layers`` forward launches per batch, requests/s beside phase 5's;
   (d) a ``num_gpus=1`` task over a CUDA tensor (as an ObjectRef and as an
   argument: same ``data_ptr``) returns the product on the card, and a
   request for more GPUs than the node has is infeasible; (e) ``shutdown``
   and a second ``init`` in the same process;
16. Serve plane (``ray_tpu_torch.serve``: controller, replicas, router,
   handles, HTTP proxy) on ``init(num_cpus=8)``: phase 5's weights and
   requests, served by one deployment whose replicas batch requests
   themselves (``max_batch_size=8``, ``pad_batch_to`` the batch buckets):
   (a) ``serve.run`` with ``ray_actor_options={"num_gpus": 1}``, f32, the 16
   requests from 16 threads through ``handle.remote(r).result()``: the
   replica was granted ``[cuda:0]``, answers match the dense run at 1e-3,
   ``n_layers`` forward launches per batch; (c) ``start_http_proxy``: the
   same requests POSTed as JSON token lists, each answer the JSON logit row,
   checked the same way; ``/-/healthz`` 200, ``/-/routes`` lists the route,
   an unknown route 404; (b) a rolling update to bf16: 1 warm-up and 3
   measured passes by handle from 16 threads, then 3 from one thread (as
   phase 15 submits), answers finite, requests/s beside phases 5 and 15,
   with the replica's batch sizes and the seconds it spent answering; (d)
   a rolling update to two ``num_gpus=0.5`` replicas (granted no device,
   user code on ``cuda``) answering the replica's tag and the row as a CUDA
   tensor: both replicas serve; (e) ``serve.shutdown`` and
   ``shutdown``: no serve thread left, and device memory back within 1 MiB
   of its value before the phase. Each ``serve.run``'s seconds and each
   sub-phase's are printed;
17. training plane (``ray_tpu_torch.train.TorchTrainer`` on
   ``init(num_cpus=8)``): (a) phase 9's model, weights and batch in one
   ``use_gpu`` worker on the ``nccl`` group, whose loop builds
   ``make_lm_train_step`` on ``session.get_mesh()`` (a ``data=1`` mesh over
   a world of one) and feeds ``session.shard_batch``: 1 + 5 steps, each
   reported, every third with the full f32 state (parameters and AdamW
   moments, 3.2 GB) checkpointed into the git-ignored build/trainer (two
   kept; the free space is checked first, and the directory deleted at
   the end); losses finite and falling, 2 x n_layers / n_layers /
   n_layers launches every step, the committed state restored byte for
   byte against the host copy of its step; the trainer's step beside
   phase 9's, ``session.report`` ms, the checkpoint's enqueue ms, commit
   s, bytes and restore s, and the goodput ledger; (b) phase 8's model and
   batch, a checkpoint every step, the first attempt raising after step
   3: the restart resumes from the last commit (AdamW step restored, the
   step count carried, restart downtime accounted), steps 4-6 match an
   uninterrupted run at ``TRAIN_RTOL``, and device memory after ``fit``
   equals its value before; (c) two ``num_gpus=0.5`` workers on half of
   phase 8's batch each, allreducing gradients over the ``nccl`` group
   folded onto the card: the trajectory matches phase 8's at
   ``TRAIN_RTOL``, each result a new CUDA tensor of the input's dtype;
   allreduce and step ms; (d) the ``nccl`` group over distinct cards,
   which needs two or more (with one, the phase says it did not run);
18. multi-process runtime (``ray_tpu_torch.cluster_utils.ProcessCluster``:
   the port's Python state service and host-daemon processes): (a) a
   cluster of one CPU daemon (``num_cpus=4``) plus ``add_daemon(num_gpus=1)``
   and ``init(address=cluster.address)``: ``GPU: 1.0`` in
   ``cluster_resources()``; a ``num_gpus=1`` task runs in another process
   whose ``CUDA_VISIBLE_DEVICES`` names the card; the seconds until each
   daemon registered; (b) a seeded bf16 [8192, 8192] tensor made in the
   daemon reaches the driver on its own ``cuda:0`` bit-equal to the same
   seeded build in the driver, a driver ``put`` reaches a daemon task
   bit-equal, a put tensor written in place is refused across processes;
   bytes and host-clock ms of each hop (median of 5); (c) phase 5's
   deployment in a ``num_gpus=1`` actor inside the daemon: the weights
   ``put`` by the driver as host numpy (f32, ~1.07 GB) and fetched by the
   actor (bytes and seconds); f32 answers to phase 5's 16 requests against
   the dense run at 1e-3; a switch to bf16, 1 warm-up and 3 measured passes
   from 16 threads and 3 from one, answers finite; requests/s beside phases
   5, 15 and 16; the actor's own forward launch count (``n_layers`` per
   batch, in the daemon's process) goes into the kernels line; (d)
   ``kill_daemon`` of the GPU daemon: a call on the actor raises
   ``ActorDiedError`` within the heartbeat timeout, the node is dead in the
   state service, the card's free memory returns to within 64 MiB of its
   value before (a), and a new ``add_daemon(num_gpus=1)`` takes the card
   back and a fresh actor there answers one f32 batch correctly; (e)
   ``shutdown()`` and ``cluster.shutdown()``: no daemon or state-service
   process is left;
19. tensor plane (``collective/tensor_plane.py`` and ``NCCLProcessGroup``:
   collective groups whose ranks are daemon processes): (a) a
   ``ProcessCluster`` of one CPU daemon plus ``add_daemon(num_gpus=1)``,
   ``init(address=)``, and ``TorchTrainer(num_workers=1, use_gpu=True)``
   on the default ``nccl`` backend: its worker, in the GPU daemon, joins
   the plane (world 1, NCCL, coordinator read from the state-service KV)
   and gets the ``data=1`` mesh over it; phase 9's model from phase 9's
   seed, 1 + 5 steps, each reported; step 0's loss equals phase 9's first
   at ``TRAIN_RTOL``, losses finite and falling, 2 x n_layers / n_layers /
   n_layers launches a step counted in the daemon's process (into the
   kernels line); the last step reports the parameters (f32, ~1.07 GB),
   which the engine commits under the git-ignored build/plane; the step's
   ms beside phases 9 and 17 (a), the report's ms, the commit's seconds;
   (b) ``serve.run`` of a ``num_gpus=1`` deployment in the GPU daemon from
   the dict form of (a)'s ``CheckpointRef``: f32 answers to phase 5's
   requests match a dense forward here on the same checkpoint at 1e-3;
   then a bf16 deployment from it, 1 warm-up and 3 measured passes from 16
   threads and 3 from one, requests/s beside phases 16 and 18 (c), the
   replica's forward launches counted in the daemon (into the kernels
   line); (c) a gloo plane over two CPU daemons: allreduce, reduce,
   broadcast, allgather, reducescatter and barrier on seeded tensors
   against numpy, an 8 MB bulk-lane send each way bit-equal, nothing of
   the group left under the p2p namespace of the KV, each op's ms; (d) an
   NCCL plane over two GPU daemons on distinct cards, which needs two or
   more (with one, the phase says it did not run); (e) ``serve.shutdown``,
   ``shutdown`` and ``cluster.shutdown``: no process left, the card's free
   memory back within 64 MiB of its value before (a), the checkpoint
   directory deleted.

Kernel times (phases 6 and 10) are device times: ``time_ms`` enqueues n
calls back to back between two CUDA events and divides, so a kernel is not
charged its wrapper's host path.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import importlib
import json
import math
import pathlib
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

SEED = 0
N_REQUESTS = 16
SERVE_RUNS = 3       # measured bf16 passes over the requests
LENGTH_BUCKETS = (128, 256, 512, 1024)
BATCH_BUCKETS = (1, 2, 4, 8)
# The transformer of bench.py:141-145, the widest the repository runs.
SERVE_WIDTH = dict(vocab_size=32000, d_model=1024, n_layers=12, n_heads=16,
                   d_ff=4096, max_seq_len=1024)
# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Gradients: f32 at the reference's grad tolerance (tests/test_ops.py). bf16
# at GRAD_REL_BF16 of the largest |grad| in the case: kernel and plain
# version compute in f32 from the same bf16 inputs and round each gradient
# once to bf16, so they differ by about one bf16 step (2^-7 relative) of the
# largest value, plus f32 summation order.
GRAD_TOL_F32 = 2e-4
GRAD_REL_BF16 = 1e-2
# Training: phase 8 cuts SERVE_WIDTH to 2 layers; phase 9 runs it in full.
PARITY_WIDTH = dict(SERVE_WIDTH, n_layers=2)
PARITY_BATCH = (2, 513)
PARITY_STEPS = 3
TRAIN_RTOL = 1e-4
TRAIN_BATCH = (8, 1025)
TRAIN_STEPS = 5      # measured, after one warm-up step
STEP_PAIRS = 5       # phase 14 (d): rounds of the two step paths in turns
# ResNet: phase 11 (f32 parity, card vs CPU) and phase 12 (bf16 training).
RESNET_PARITY_SIDES = (64, 37)
RESNET_PARITY_BATCH = 4
# f32 with TF32 off: cuDNN and the CPU sum in other orders, and batch norm
# divides by small standard deviations, so each value is held at
# RESNET_RTOL of itself plus RESNET_RTOL of its tensor's largest |value|.
RESNET_RTOL = 1e-3
RESNET_TRAIN = (("resnet50", 128), ("resnet18", 256))
RESNET_STEPS = 10    # measured, after one warm-up step
BENCH_TIMEOUT_S = 600
# Phase 15: the in-process runtime. A bf16 [8192, 8192] device object, put
# while its product is still queued behind SIDE_STREAM_SLEEP_CYCLES (~50 ms
# at the H100's boost clock) of spinning on a side stream; its put/get round
# trip timed PUT_GET_RUNS times. Runtime files go under the git-ignored
# build/ rather than the temporary directory.
OBJECT_SIDE = 8192
SIDE_STREAM_SLEEP_CYCLES = 100_000_000
PUT_GET_RUNS = 100
RUNTIME_CONFIG = {"flight_recorder_dir": "build/runtime/flight",
                  "object_spilling_dir": "build/runtime/spill"}
# Phase 16: the Serve plane. Every deployment holds a latency budget far
# above an f32 batch's time: at the default 100 ms the replica batcher would
# cap f32 batches below max_batch_size and the router would shed.
SERVE_ROUTE = "/lm"
SERVE_BUDGET_MS = 10_000.0
SERVE_MEMORY_SLACK = 2**20
# Phase 17: TorchTrainer. Its checkpoints go under the git-ignored build/
# and are deleted at the end; a fit() that blocks longer than this fails.
TRAINER_DIR = "build/trainer"
TRAINER_TIMEOUT_S = 600
# Phase 18: the multi-process runtime. A bf16 [OBJECT_SIDE]^2 tensor crosses
# processes each way HOP_RUNS times; after the GPU daemon is killed the
# card's free memory must come back to within PROCESS_MEMORY_SLACK of its
# value before the phase.
HOP_RUNS = 5
PROCESS_MEMORY_SLACK = 64 * 2**20
# Phase 19: the tensor plane. The trainer's checkpoint goes under the
# git-ignored build/ and is deleted at the end; each bulk-lane send of (c)
# is this many f32 values (8 MB). The state service's own default heartbeat
# timeout: the GPU daemon pickles the 1.07 GB reported checkpoint for the
# driver on its interpreter lock, which starves its heartbeat thread for
# about as long as ProcessCluster's 3 s test timeout.
PLANE_DIR = "build/plane"
PLANE_BULK_ELEMS = 2 * 1024 * 1024
PLANE_HEARTBEAT_TIMEOUT_MS = 10_000
REPO = pathlib.Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel symbol: the identifier,
    prefixed by its length, that ends in ``_kernel``, and the template
    arguments after it (a length prefix may follow other digits)."""
    for run in re.finditer(r"\d+", mangled):
        digits = run.group()
        for i in range(len(digits)):
            name = mangled[run.end():run.end() + int(digits[i:])]
            if name.endswith("_kernel") and name[:1].isalpha():
                args = mangled[run.end() + len(name):].split("EEv")[0]
                return name + args.replace("I", "<", 1) + ">"
    return mangled


def ptxas_summary(build_log: str):
    """One line per compiled kernel: its registers and spills."""
    name, spills = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spills}"


def time_ms(fn, windows: int = 10, window_ms: float = 5.0,
            warmup: int = 3) -> float:
    """Device time of one ``fn()`` call, in ms: after the warm-up, each of
    ``windows`` windows enqueues n calls back to back between one pair of
    CUDA events (n chosen so that a window lasts at least ``window_ms``),
    and the result is the median over windows of elapsed / n. Back to back,
    the host's work for call i + 1 overlaps the device's work for call i,
    so a kernel is not charged its wrapper's host path."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(1, math.ceil(window_ms / max(start.elapsed_time(end), 1e-3)))
    per_call = []
    for _ in range(windows):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def _bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kept_pairs(Lq, Lk, causal):
    """(row, col) pairs a head that the mask keeps (top-left causal)."""
    return sum(min(r + 1, Lk) for r in range(Lq)) if causal else Lq * Lk


def attention_bound(B, Lq, Lk, H, D, dtype, causal):
    """Least time (ms) an H100 needs for the forward: the larger of the bytes
    (q, k, v read once; O and the f32 LSE written once) over the HBM rate
    and the two dots' operations on the (row, col) pairs the mask keeps
    over the peak rate for the input type."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * (2 * B * Lq * H * D + 2 * B * Lk * H * D) + 4 * B * H * Lq
    flops = 4.0 * B * H * D * _kept_pairs(Lq, Lk, causal)
    return _bound(nbytes, flops, dtype)


def backward_bounds(B, Lq, Lk, H, D, dtype, causal):
    """Least time (ms) an H100 needs for each backward kernel, as
    ``{"dq": (ms, by), "dkv": (ms, by)}``. Both read q, k, v, dO and the f32
    LSE and Delta once; dq writes dQ (three dots: S, dP, dQ), dkv writes dK
    and dV (four dots: S, dP, dV, dK), on the pairs the mask keeps."""
    elt = torch.tensor([], dtype=dtype).element_size()
    reads = elt * (2 * B * Lq * H * D + 2 * B * Lk * H * D) + 8 * B * H * Lq
    dot = 2.0 * B * H * D * _kept_pairs(Lq, Lk, causal)
    return {"dq": _bound(reads + elt * B * Lq * H * D, 3 * dot, dtype),
            "dkv": _bound(reads + 2 * elt * B * Lk * H * D, 4 * dot, dtype)}


def random_qkv(gen, B, Lq, Lk, H, D, dtype, device):
    def draw(L):
        return torch.randn((B, L, H, D), generator=gen, device=device
                           ).to(dtype)
    return draw(Lq), draw(Lk), draw(Lk)


def kernel_cases():
    """(B, Lq, Lk, H, D, dtype, causal) of the kernel-vs-plain phases."""
    cases = [(2, L, L, 2, D, dt, c)
             for D in (16, 32, 64, 128)
             for L in (256, 1024, 200)
             for dt in (torch.float32, torch.bfloat16)
             for c in (True, False)]
    cases += [(1, Lq, Lk, 2, 64, dt, c)
              for (Lq, Lk) in ((200, 333), (384, 128))
              for dt in (torch.float32, torch.bfloat16)
              for c in (True, False)]
    return cases


def check_kernel(fa, device) -> None:
    """Phase 3: kernel against the plain version, O and LSE."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = kernel_cases()
    before = fa.launches
    worst = {}
    for (B, Lq, Lk, H, D, dt, causal) in cases:
        q, k, v = random_qkv(gen, B, Lq, Lk, H, D, dt, device)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        tol = TOL[dt]
        case = f"B={B} Lq={Lq} Lk={Lk} H={H} D={D} {dt} causal={causal}"
        assert o.dtype == dt and lse.dtype == torch.float32, case
        assert lse.shape == (B, H, Lq), case
        torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"O differs, {case}: {m}")
        torch.testing.assert_close(lse, rlse, rtol=tol, atol=tol,
                                   msg=lambda m: f"LSE differs, {case}: {m}")
        err = (o.float() - ro.float()).abs().max().item()
        worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
    assert fa.launches == before + len(cases), (fa.launches, before)
    log(f"[kernels] {len(cases)} cases agree with the plain version "
        f"(O and LSE; f32 at {TOL[torch.float32]}, bf16 at "
        f"{TOL[torch.bfloat16]}); largest |dO| {worst}")


def last_token_logits(cfg, params, batch):
    """f32 logits at each row's last real token (``batch["last"]``)."""
    from ray_tpu_torch.models import transformer
    tokens, last = batch["tokens"], batch["last"]
    x = transformer.backbone(params, tokens, cfg)
    x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return transformer.head(params, x, cfg)[:, 0]


def make_deployment(cfg, params, device):
    """User code: a deployment class over the port's serving path."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.air import TorchPredictor
    # A local, so the class body reads it from this function's closure:
    # pickled by value (phase 18 ships this function to a daemon), the
    # function carries only the globals its own code names.
    buckets = BATCH_BUCKETS

    class LMDeployment:
        def __init__(self):
            self.predictor = TorchPredictor(
                params, functools.partial(last_token_logits, cfg),
                device=device)
            self.batches = 0

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01,
                     pad_batch_to=buckets)
        def __call__(self, requests):
            self.batches += 1
            return list(self.predictor.predict(pad_requests(requests)))

    return LMDeployment()


def pad_requests(requests):
    """Right-pad every request to the batch's length bucket: ``{"tokens",
    "last"}`` as numpy. This is exact only because attention is causal with
    a top-left mask and RoPE positions start at 0: a real token never sees
    the pad tokens to its right, and its position does not move."""
    from ray_tpu_torch.serve.batching import next_bucket
    L = next_bucket(max(len(r) for r in requests), LENGTH_BUCKETS)
    tokens = np.zeros((len(requests), L), dtype=np.int64)
    for i, r in enumerate(requests):
        tokens[i, :len(r)] = r
    last = np.array([len(r) - 1 for r in requests], dtype=np.int64)
    return {"tokens": tokens, "last": last}


def serve_all(deployment, requests, timeout_s: float = 300.0):
    """Submit every request from its own thread; (answers, seconds)."""
    answers = [None] * len(requests)
    errors = []

    def call(i):
        try:
            answers[i] = deployment(requests[i])
        except BaseException as e:  # reported after the join below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    seconds = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "requests timed out"
    if errors:
        raise errors[0]
    return answers, seconds


def seeded_requests(width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """The seeded requests of phases 5 and 15: (the rng after them,
    lengths, requests)."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, width["max_seq_len"] + 1, size=n_requests)
    requests = [rng.integers(0, width["vocab_size"], size=n).tolist()
                for n in lengths]
    return rng, lengths, requests


def serve_inputs(device, width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """The seeded requests and f32 weights of phases 5 and 15: (the rng
    after the requests, lengths, requests, f32 config, params)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig

    rng, lengths, requests = seeded_requests(width, n_requests)
    cfg32 = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    return (rng, lengths, requests, cfg32,
            transformer.init_params(cfg32, gen, device))


def check_dense(cfg32, params, requests, answers, device):
    """Every f32 answer against a one-request, unpadded dense-attention run
    at rtol = atol = 1e-3."""
    from ray_tpu_torch.models import transformer
    dense = dataclasses.replace(cfg32, use_flash=False)
    with torch.inference_mode():
        for req, got in zip(requests, answers):
            tokens = torch.tensor([req], device=device)
            want = transformer.apply(params, tokens, dense)[0, -1]
            np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-3,
                                       atol=1e-3)


def serve_phase(fa, device, width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """Phase 5. Returns the bf16 runs' launches, batches, median seconds,
    real tokens per run, and the time of one full-batch forward."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig

    rng, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                         n_requests)
    n_tokens = int(lengths.sum())
    log(f"[serve] {transformer.num_params(params) / 1e6:.1f} M parameters, "
        f"{n_requests} requests, lengths {lengths.tolist()}")

    # f32: every answer against a one-request, unpadded dense-attention run.
    dep = make_deployment(cfg32, params, device)
    fa.launches = 0
    ans32, _ = serve_all(dep, requests)
    assert fa.launches == cfg32.n_layers * dep.batches, (
        fa.launches, dep.batches)
    check_dense(cfg32, params, requests, ans32, device)
    log(f"[serve] f32: {n_requests} answers in {dep.batches} batches match "
        f"the unpadded dense run at rtol=atol=1e-3; kernel launches "
        f"{cfg32.n_layers} per batch")

    # bf16, weights cast once: warm up, then the measured runs.
    cfg16 = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    params16 = transformer.cast_params(params, torch.bfloat16)
    dep = make_deployment(cfg16, params16, device)
    serve_all(dep, requests)
    dep.batches = 0
    fa.launches = 0
    runs = [serve_all(dep, requests) for _ in range(SERVE_RUNS)]
    launches = fa.launches
    assert launches == cfg16.n_layers * dep.batches, (launches, dep.batches)
    for ans16, _ in runs:
        assert all(np.isfinite(a).all() for a in ans16), "non-finite logits"
        assert all(a.shape == (width["vocab_size"],) for a in ans16)
    delta = max(float(np.abs(a - b).max()) for a, b in zip(runs[0][0], ans32))
    log(f"[serve] bf16: {n_requests} finite answers x {SERVE_RUNS} runs in "
        f"{dep.batches} batches; largest |logit(bf16) - logit(f32)| = "
        f"{delta:.4f}")

    # One full batch (8 x 1024) through the forward, for the time split.
    B, L = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1]
    batch = {"tokens": torch.tensor(rng.integers(0, width["vocab_size"],
                                                 size=(B, L)), device=device),
             "last": torch.full((B,), L - 1, device=device)}
    with torch.inference_mode():
        forward_ms = time_ms(lambda: last_token_logits(cfg16, params16, batch),
                             windows=5, warmup=1)
    return dict(launches=launches, batches=dep.batches,
                seconds=statistics.median(t for _, t in runs),
                n_tokens=n_tokens, forward_ms=forward_ms,
                n_layers=cfg16.n_layers)


def runtime_phase(fa, device, card, direct_rps, width=SERVE_WIDTH,
                  n_requests=N_REQUESTS, side=OBJECT_SIDE):
    """Phase 15: the in-process runtime (``ray_tpu_torch.init`` → tasks,
    actors, the object store) on the card. Returns the put/get round trip
    in µs and the actor path's bf16 requests/s."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import scheduler, worker

    # (a) init with no GPU argument: the card is detected.
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        res = rt.cluster_resources()
        assert res.get("GPU") == torch.cuda.device_count(), res
        store = worker.global_worker().runtime.head_node.store
        arena = store.stats()["native_arena"]
        sched = scheduler._native() is not None
        log(f"[runtime] init(num_cpus=8): {res}; native object arena "
            f"{'loaded' if arena else 'NOT loaded (heap store)'}, native "
            f"scheduling library "
            f"{'loaded' if sched else 'NOT loaded (Python policy)'}")
        put_get_us = device_objects(rt, device, card, side)
        actor_rps = actor_serving(rt, fa, device, card, direct_rps, width,
                                  n_requests)
        gpu_task(rt, device)
    finally:
        rt.shutdown()
    # (e) a second runtime in the same process.
    rt.init(num_cpus=2)
    try:
        assert rt.get(rt.remote(lambda: 7).remote(), timeout=60) == 7
        assert rt.cluster_resources().get("GPU") == torch.cuda.device_count()
    finally:
        rt.shutdown()
    log("[runtime] shutdown(), then a second init() in the same process "
        "ran a task")
    return dict(put_get_us=put_get_us, actor_rps=actor_rps)


def device_objects(rt, device, card, side=OBJECT_SIDE):
    """Phase 15 (b): a CUDA tensor is a device object, by reference, ready
    for its getter, and refused once written in place. Returns the put/get
    round trip's median in µs (host clock)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    a, b = (torch.randn(side, side, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        # The product is queued behind ~50 ms of spinning, so a reader
        # that did not wait for the put's event would read it unfinished.
        torch.cuda._sleep(SIDE_STREAM_SLEEP_CYCLES)
        x = a @ b
        allocated = torch.cuda.memory_allocated(device)
        ref = rt.put(x)

    @rt.remote
    def fetch(refs):
        return rt.get(refs[0])   # a nested ref: this task gets it itself

    got = rt.get(fetch.remote([ref]))
    assert got is x
    assert torch.cuda.memory_allocated(device) == allocated
    early = got.cpu()            # on this thread's stream, no host sync
    torch.cuda.synchronize()
    assert torch.equal(early, x.cpu()), "get returned the object unfinished"
    log(f"[runtime] a bf16 [{side}, {side}] tensor written on a side stream "
        f"and put: get from another task returns the same object, device "
        f"memory unchanged ({allocated} bytes), and its values equal a "
        f"host-synchronised copy")

    x.add_(1)
    try:
        rt.get(ref)
    except rt.RayTpuError as e:
        assert "modified in place" in str(e), e
    else:
        raise AssertionError("get of an object written in place succeeded")
    log("[runtime] after an in-place write, get refuses the object")

    times = []
    for _ in range(PUT_GET_RUNS):
        t0 = time.perf_counter()
        assert rt.get(rt.put(x)) is x
        times.append(time.perf_counter() - t0)
    assert torch.cuda.memory_allocated(device) == allocated
    us = statistics.median(times) * 1e6
    log(f"[times] {card}: put/get round trip of that tensor {us:.1f} µs "
        f"(host clock, median of {PUT_GET_RUNS}); device memory unchanged")
    del a, b, x, got, early
    torch.cuda.empty_cache()
    return us


def actor_serving(rt, fa, device, card, direct_rps, width=SERVE_WIDTH,
                  n_requests=N_REQUESTS):
    """Phase 15 (c): phase 5's deployment, weights and requests, served
    from a ``num_gpus=1`` actor. Returns the bf16 requests/s."""
    from ray_tpu_torch.models import transformer

    _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                       n_requests)

    @rt.remote(num_gpus=1, max_concurrency=n_requests)
    class LMServer:
        """User code: the deployment inside a GPU actor."""

        def __init__(self, cfg, params):
            self.deployment = make_deployment(cfg, params, device)

        def devices(self):
            return rt.get_runtime_context().get_gpu_devices()

        def batches(self):
            return self.deployment.batches

        def __call__(self, request):
            return self.deployment(request)

    def serve_pass(server):
        # The handle refuses dunder attributes (``server.__call__`` is the
        # handle's own), so the method is named through ActorMethod.
        call = rt.ActorMethod(server, "__call__")
        t0 = time.perf_counter()
        answers = rt.get([call.remote(r) for r in requests], timeout=600)
        return answers, time.perf_counter() - t0

    server = LMServer.remote(cfg32, params)
    devices = rt.get(server.devices.remote(), timeout=600)
    assert devices == [torch.device("cuda", 0)], devices
    fa.launches = 0
    ans32, _ = serve_pass(server)
    batches = rt.get(server.batches.remote())
    assert fa.launches == cfg32.n_layers * batches, (fa.launches, batches)
    check_dense(cfg32, params, requests, ans32, device)
    log(f"[runtime] f32 from a num_gpus=1 actor granted {devices}: "
        f"{n_requests} answers in {batches} batches match the unpadded "
        f"dense run at rtol=atol=1e-3; kernel launches {cfg32.n_layers} per "
        f"batch")
    rt.kill(server)

    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params16 = transformer.cast_params(params, torch.bfloat16)
    del params
    server = LMServer.remote(cfg16, params16)
    serve_pass(server)
    before = rt.get(server.batches.remote(), timeout=600)
    fa.launches = 0
    runs = [serve_pass(server) for _ in range(SERVE_RUNS)]
    launches = fa.launches
    batches = rt.get(server.batches.remote()) - before
    assert launches == cfg16.n_layers * batches, (launches, batches)
    for answers, _ in runs:
        assert all(np.isfinite(a).all() for a in answers), "non-finite logits"
        assert all(a.shape == (width["vocab_size"],) for a in answers)
    seconds = statistics.median(t for _, t in runs)
    rps = n_requests / seconds
    log(f"[runtime] bf16 from the actor: {n_requests} finite answers x "
        f"{SERVE_RUNS} passes in {batches} batches; kernel launches "
        f"{cfg16.n_layers} per batch")
    log(f"[times] {card}: bf16 serving from a num_gpus=1 actor {rps:.2f} "
        f"requests/s, {int(lengths.sum()) / seconds:.0f} tokens/s (median "
        f"of {SERVE_RUNS} passes, {seconds:.4f} s); phase 5 direct "
        f"{direct_rps:.2f} requests/s")
    rt.kill(server)
    return rps


def gpu_task(rt, device):
    """Phase 15 (d): a ``num_gpus=1`` task over a CUDA tensor, given as an
    ObjectRef and as a plain argument, and a GPU request no node can meet."""
    @rt.remote(num_gpus=1, num_returns=2)
    def gram(t):
        return t @ t.T, t.data_ptr()

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    z = torch.randn(1024, 1024, generator=gen, device=device)
    want = z @ z.T
    for arg in (rt.put(z), z):
        out, ptr = rt.get(list(gram.remote(arg)), timeout=60)
        assert ptr == z.data_ptr() and out.device == z.device, (ptr, out)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    too_many = torch.cuda.device_count() + 1
    try:
        rt.get(rt.remote(num_gpus=too_many)(lambda: 1).remote(), timeout=60)
    except rt.RayTpuError as e:
        assert "cannot be satisfied" in str(e), e
    else:
        raise AssertionError(f"a task asking for {too_many} GPUs ran")
    log(f"[runtime] a num_gpus=1 task got the CUDA tensor with no copy (as "
        f"an ObjectRef and as an argument) and returned z @ z.T on "
        f"{out.device}, equal to the direct product at 1e-5; a task asking "
        f"for {too_many} GPUs is infeasible")


class ServedLM:
    """User code for phase 16: phase 5's model as a Serve deployment whose
    replica batches requests itself (``max_batch_size`` on the deployment),
    so ``__call__`` takes a list. ``answer`` picks what a request gets back:
    its logit row as numpy ("numpy"), as a list for JSON ("list"), or the
    replica's tag with the row as a CUDA tensor ("tensor")."""

    def __init__(self, cfg, params, answer, device):
        import uuid

        import ray_tpu_torch
        from ray_tpu_torch.air import TorchPredictor
        self.granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
        # A fractional grant names no device: the replica picks the card.
        self.predictor = TorchPredictor(
            params, functools.partial(last_token_logits, cfg),
            device=self.granted[0] if self.granted else device)
        self.cfg, self.answer = cfg, answer
        self.tag = uuid.uuid4().hex[:8]
        self.sizes, self.busy_s = [], 0.0

    def __call__(self, requests):
        t0 = time.perf_counter()
        try:
            return self._answer(requests)
        finally:
            self.sizes.append(len(requests))
            self.busy_s += time.perf_counter() - t0

    def _answer(self, requests):
        batch = pad_requests(requests)
        if self.answer == "tensor":
            dev = self.predictor.device
            with torch.no_grad():
                rows = last_token_logits(
                    self.cfg, self.predictor.params,
                    {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()})
            return [(self.tag, row.clone()) for row in rows]
        rows = self.predictor.predict(batch)
        return [r.tolist() for r in rows] if self.answer == "list" \
            else list(rows)

    def devices(self):
        return self.granted

    def stats(self):
        """(batch sizes, seconds spent answering batches) so far."""
        return list(self.sizes), self.busy_s


def free_device_caches():
    """Collect garbage and return cached blocks, cuBLAS's workspaces too
    (one per handle and stream, allocated through the caching allocator),
    so ``memory_allocated`` counts live tensors only."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def http_post(url, body, timeout_s=300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        return json.loads(r.read())


def http_status(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_thread_names():
    return [t for t in threading.enumerate() if t.name.startswith("serve-")]


def serve_plane_phase(fa, device, card, direct_rps, actor_rps,
                      width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """Phase 16: phase 5's weights and requests through the Serve plane
    (controller, replicas, router, handles, HTTP proxy) on the in-process
    runtime; then teardown: no serve thread is left and device memory
    returns to where it was."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    free_device_caches()
    before = torch.cuda.memory_allocated(device)
    # Earlier phases' @serve.batch queues keep their own threads.
    threads_before = set(serve_thread_names())
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        res = rt.cluster_resources()
        assert res.get("GPU") == torch.cuda.device_count(), res
        rates = serve_plane_paths(rt, serve, fa, device, card, direct_rps,
                                  actor_rps, width, n_requests)
    finally:
        t0 = time.perf_counter()
        serve.shutdown()
        rt.shutdown()
    # (e) teardown
    deadline = time.monotonic() + 10.0
    while (set(serve_thread_names()) - threads_before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    left = set(serve_thread_names()) - threads_before
    assert not left, left
    free_device_caches()
    after = torch.cuda.memory_allocated(device)
    assert abs(after - before) <= SERVE_MEMORY_SLACK, (before, after)
    log(f"[serve-plane] (e) serve.shutdown() and shutdown() in "
        f"{time.perf_counter() - t0:.2f} s: no serve thread left; device "
        f"memory {before} bytes before the phase, {after} after (the "
        f"replicas' weights went with their actors)")
    return rates


def serve_plane_paths(rt, serve, fa, device, card, direct_rps, actor_rps,
                      width, n_requests):
    """Phase 16 (a)-(d), on one deployment named "lm" at ``SERVE_ROUTE``:
    f32 from a ``num_gpus=1`` replica by handle and by HTTP, a rolling
    update to bf16, and one to two ``num_gpus=0.5`` replicas. Keeping one
    deployment keeps every router and the proxy's handle live until
    ``serve.shutdown``, whose delete then wakes their long polls."""
    from ray_tpu_torch.models import transformer

    _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                       n_requests)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    n_layers, n_tokens = cfg32.n_layers, int(lengths.sum())
    lm = serve.deployment(
        ServedLM, name="lm", max_batch_size=8, batch_wait_timeout_s=0.01,
        pad_batch_to=BATCH_BUCKETS, target_latency_ms=SERVE_BUDGET_MS,
        ray_actor_options={"num_gpus": 1})

    def deploy(app, what):
        t0 = time.perf_counter()
        handle = serve.run(app, route_prefix=SERVE_ROUTE)
        log(f"[serve-plane] serve.run ({what}) returned a ready handle in "
            f"{time.perf_counter() - t0:.2f} s")
        return handle

    def by_handle(handle):
        return serve_all(lambda r: handle.remote(r).result(timeout=300),
                         requests)

    def batches(handle):
        return len(handle.stats.remote().result(timeout=60)[0])

    # (a) handle, f32, one num_gpus=1 replica
    t0 = time.perf_counter()
    h = deploy(lm.bind(cfg32, params, "list", device), "f32, num_gpus=1")
    devices = h.devices.remote().result(timeout=60)
    assert devices == [torch.device("cuda", 0)], devices
    fa.launches, b0 = 0, batches(h)
    answers, _ = by_handle(h)
    ran = batches(h) - b0
    assert fa.launches == n_layers * ran, (fa.launches, ran)
    check_dense(cfg32, params, requests, answers, device)
    f32_s = statistics.median(by_handle(h)[1] for _ in range(SERVE_RUNS))
    log(f"[serve-plane] (a) f32 by handle from a num_gpus=1 replica granted "
        f"{devices}: {n_requests} answers in {ran} batches match the "
        f"unpadded dense run at rtol=atol=1e-3; kernel launches {n_layers} "
        f"per batch ({time.perf_counter() - t0:.2f} s)")

    # (c) HTTP, f32, the same replica
    t0 = time.perf_counter()
    base = serve.start_http_proxy()
    url = base + SERVE_ROUTE
    fa.launches, b0 = 0, batches(h)
    answers, _ = serve_all(lambda r: http_post(url, r), requests)
    ran = batches(h) - b0
    assert fa.launches == n_layers * ran, (fa.launches, ran)
    check_dense(cfg32, params, requests, answers, device)
    assert http_status(base + "/-/healthz")[0] == 200
    code, body = http_status(base + "/-/routes")
    assert code == 200 and json.loads(body) == {SERVE_ROUTE: "lm"}, body
    assert http_status(base + "/no-such-route")[0] == 404
    http_s = statistics.median(
        serve_all(lambda r: http_post(url, r), requests)[1]
        for _ in range(SERVE_RUNS))
    log(f"[serve-plane] (c) f32 by HTTP POST to {SERVE_ROUTE}: {n_requests} "
        f"JSON logit rows in {ran} batches match the dense run at 1e-3; "
        f"/-/healthz 200, /-/routes lists the route, an unknown route 404 "
        f"({time.perf_counter() - t0:.2f} s)")
    log(f"[times] {card}: f32 serving through the Serve plane, answers as "
        f"lists: by handle {n_requests / f32_s:.2f} requests/s, by HTTP "
        f"{n_requests / http_s:.2f} requests/s (medians of {SERVE_RUNS} "
        f"passes, {f32_s:.4f} / {http_s:.4f} s)")

    # (b) handle, bf16: a rolling update of the same deployment
    t0 = time.perf_counter()
    params16 = transformer.cast_params(params, torch.bfloat16)
    del params
    h = deploy(lm.bind(cfg16, params16, "numpy", device),
               "rolling update to bf16")
    by_handle(h)

    def measured(submit):
        """``SERVE_RUNS`` passes: (median seconds, batch sizes, seconds the
        replica spent answering them, seconds of all the passes)."""
        fa.launches = 0
        sizes0, busy0 = h.stats.remote().result(timeout=60)
        runs = [submit() for _ in range(SERVE_RUNS)]
        sizes, busy = h.stats.remote().result(timeout=60)
        sizes = sizes[len(sizes0):]
        assert fa.launches == n_layers * len(sizes), (fa.launches, sizes)
        for answers, _ in runs:
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            assert all(a.shape == (width["vocab_size"],) for a in answers)
        return (statistics.median(t for _, t in runs), sizes, busy - busy0,
                sum(t for _, t in runs))

    def one_thread():
        t0 = time.perf_counter()
        responses = [h.remote(r) for r in requests]
        answers = [r.result(timeout=300) for r in responses]
        return answers, time.perf_counter() - t0

    threads = measured(lambda: by_handle(h))
    single = measured(one_thread)
    log(f"[serve-plane] (b) bf16 by handle: {n_requests} finite answers x "
        f"{SERVE_RUNS} passes from {n_requests} threads and x {SERVE_RUNS} "
        f"from one thread; kernel launches {n_layers} per batch "
        f"({time.perf_counter() - t0:.2f} s)")
    for what, (seconds, sizes, busy, total) in (
            (f"from {n_requests} threads", threads),
            ("from one thread", single)):
        log(f"[times] {card}: bf16 serving through the Serve plane {what} "
            f"{n_requests / seconds:.2f} requests/s, "
            f"{n_tokens / seconds:.0f} tokens/s (median of {SERVE_RUNS} "
            f"passes, {seconds:.4f} s); the replica answered batches of "
            f"{sizes} for {busy:.4f} s of the passes' {total:.4f} s (host "
            f"clock)")
    log(f"[times] {card}: phase 5 direct {direct_rps:.2f}, phase 15 actor "
        f"{actor_rps:.2f} requests/s")

    # (d) two num_gpus=0.5 replicas on the card
    t0 = time.perf_counter()
    h = deploy(lm.options(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
               .bind(cfg16, params16, "tensor", device),
               "rolling update to 2 replicas, num_gpus=0.5")
    fa.launches = 0
    answers, seconds = by_handle(h)
    served = collections.Counter(tag for tag, _ in answers)
    assert len(served) == 2, served
    for _, row in answers:
        assert row.is_cuda and row.shape == (width["vocab_size"],), row.shape
        assert torch.isfinite(row).all().item(), "non-finite logits"
    assert fa.launches >= 2 * n_layers and fa.launches % n_layers == 0, \
        fa.launches
    log(f"[serve-plane] (d) bf16 from two num_gpus=0.5 replicas (no device "
        f"granted; user code on {answers[0][1].device}): requests served "
        f"{sorted(served.values())}, answers finite CUDA tensors read on the "
        f"callers' threads; {fa.launches // n_layers} batches in one pass "
        f"({seconds:.4f} s; {time.perf_counter() - t0:.2f} s)")
    return {"threads": n_requests / threads[0],
            "single": n_requests / single[0]}


def assert_grads_close(got, want, dtype, case):
    """Check each gradient at GRAD_TOL_F32 (f32) or GRAD_REL_BF16 of its
    largest |value| (bf16). Returns ``{name: (largest |error|, largest
    share of the allowed error atol + rtol * |want|)}``."""
    out = {}
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, (name, case)
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            tol = dict(rtol=GRAD_TOL_F32, atol=GRAD_TOL_F32)
        else:
            tol = dict(rtol=GRAD_REL_BF16,
                       atol=GRAD_REL_BF16 * w.abs().max().item())
        torch.testing.assert_close(g, w, **tol,
                                   msg=lambda m: f"{name} differs, {case}: "
                                                 f"{m}")
        err = (g - w).abs()
        allowed = (tol["atol"] + tol["rtol"] * w.abs()).clamp_min(1e-30)
        out[name] = (err.max().item(), (err / allowed).max().item())
    return out


def _merge_worst(worst, dtype, errs):
    """Keep, per (dtype, gradient), the largest error and tolerance share."""
    for name, (err, share) in errs.items():
        e, s = worst.get(f"{dtype} {name}", (0.0, 0.0))
        worst[f"{dtype} {name}"] = (max(e, err), max(s, share))


def _fmt_worst(worst):
    return "; ".join(f"{k} {e:.4g} ({s:.2f})" for k, (e, s) in worst.items())


def check_backward(fa, device) -> None:
    """Phase 7: the dq and dkv kernels against the plain backward; then the
    same cases through ``_FlashAttention`` against autograd of the plain
    forward."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cases = kernel_cases()
    worst = {}
    before = (fa.dq_launches, fa.dkv_launches)
    for (B, Lq, Lk, H, D, dt, causal) in cases:
        case = f"B={B} Lq={Lq} Lk={Lk} H={H} D={D} {dt} causal={causal}"
        q, k, v = random_qkv(gen, B, Lq, Lk, H, D, dt, device)
        do = torch.randn(q.shape, generator=gen, device=device).to(dt)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        _merge_worst(worst, dt, assert_grads_close(got, want, dt, case))
        if causal and Lk > Lq:  # K rows no query reaches: exact zeros
            assert not got[1][:, Lq:].any(), case
            assert not got[2][:, Lq:].any(), case
    assert (fa.dq_launches, fa.dkv_launches) == (
        before[0] + len(cases), before[1] + len(cases)), before
    log(f"[backward] {len(cases)} cases: dq and dkv kernels agree with the "
        f"plain backward (f32 at {GRAD_TOL_F32}, bf16 at {GRAD_REL_BF16} of "
        f"the largest |grad|); largest |error| (share of the tolerance): "
        f"{_fmt_worst(worst)}")

    worst = {}
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    for (B, Lq, Lk, H, D, dt, causal) in cases:
        case = f"autograd B={B} Lq={Lq} Lk={Lk} D={D} {dt} causal={causal}"
        q, k, v = (t.requires_grad_() for t in
                   random_qkv(gen, B, Lq, Lk, H, D, dt, device))
        do = torch.randn(q.shape, generator=gen, device=device).to(dt)
        out = fa.flash_attention(q, k, v, causal)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        got = torch.autograd.grad(out, (q, k, v), do)
        ref, _ = fa.flash_attention_reference(q, k, v, causal)
        want = torch.autograd.grad(ref, (q, k, v), do)
        torch.cuda.synchronize()
        _merge_worst(worst, dt, assert_grads_close(got, want, dt, case))
    n = len(cases)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0] + n, before[1] + n, before[2] + n), before
    log(f"[backward] the same {n} cases through the autograd Function agree "
        f"with autograd of the plain forward; largest |error| (share of "
        f"the tolerance): {_fmt_worst(worst)}")


def train_trajectory(cfg, params, tokens, steps, device, mesh=None):
    """(loss, grad_norm) of ``steps`` steps of ``make_lm_train_step`` (over
    ``mesh`` when given) from a copy of ``params`` on one batch."""
    from ray_tpu_torch.train import make_lm_train_step
    init_fn, step_fn, shard_batch = make_lm_train_step(cfg, mesh,
                                                       device=device)
    state = init_fn(params=params)
    batch = shard_batch(tokens)
    out = []
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
        out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
    return out


def parity_inputs(device, width=PARITY_WIDTH, batch=PARITY_BATCH):
    """Phase 8's f32 flash config, weights and token batch."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    tokens = np.random.default_rng(SEED + 3).integers(
        0, width["vocab_size"], size=batch)
    flash = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    params = transformer.init_params(
        flash, torch.Generator(device=device).manual_seed(SEED + 3), device)
    return flash, params, tokens


def train_parity_phase(device, width=PARITY_WIDTH, batch=PARITY_BATCH,
                       steps=PARITY_STEPS):
    """Phase 8: f32 steps through the kernels against dense attention (TF32
    off), from the same weights on the same batch. Returns the trajectory
    through the kernels."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    flash, params, tokens = parity_inputs(device, width, batch)
    dense = TransformerConfig(**width, dtype=torch.float32, use_flash=False)
    got = train_trajectory(flash, params, tokens, steps, device)
    want = train_trajectory(dense, params, tokens, steps, device)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    log(f"[train] f32 parity, {width['n_layers']} layers at d_model "
        f"{width['d_model']}, batch {batch[0]} x {batch[1]}: (loss, grad "
        f"norm) through the kernels {got} vs dense attention {want}, "
        f"rtol {TRAIN_RTOL}")
    return got


def launch_counts(fa):
    return (fa.launches, fa.dq_launches, fa.dkv_launches)


def train_phase(fa, device, width=SERVE_WIDTH, batch=TRAIN_BATCH,
                steps=TRAIN_STEPS, mesh=None, profile=True):
    """Phase 9, the training path: bf16 steps at full depth with remat
    (phase 14 (c): the same through the sharded step over ``mesh``)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    assert cfg.remat
    n = cfg.n_layers
    per_step = (2 * n, n, n)  # remat recomputes each block's forward
    init_fn, step_fn, shard_batch = make_lm_train_step(cfg, mesh,
                                                       device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(SEED))
    n_params = transformer.num_params(state[0])
    tokens = shard_batch(np.random.default_rng(SEED + 4).integers(
        0, width["vocab_size"], size=batch))

    def one_step(state):
        before = launch_counts(fa)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = tuple(a - b for a, b in zip(launch_counts(fa), before))
        assert got == per_step, (got, per_step)
        return state, loss, grad_norm, seconds

    state, loss, grad_norm, warm_s = one_step(state)     # warm-up
    losses, norms, times = [loss], [grad_norm], []
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    for _ in range(steps):
        state, loss, grad_norm, seconds = one_step(state)
        losses.append(loss)
        norms.append(grad_norm)
        times.append(seconds)
    launches = launch_counts(fa)
    assert launches == tuple(steps * c for c in per_step), launches
    assert all(np.isfinite(losses + norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    step_s = statistics.median(times)
    n_tokens = batch[0] * (batch[1] - 1)
    out = dict(launches=launches, step_ms=step_s * 1e3,
               tokens_per_s=n_tokens / step_s,
               # bench.py's count: 6 FLOPs a parameter a token (2 forward,
               # 4 backward), remat's recompute not counted.
               model_tflops=6.0 * n_params * n_tokens / step_s / 1e12,
               peak_bytes=torch.cuda.max_memory_allocated(), n_layers=n,
               losses=losses)
    where = "" if mesh is None else f" (sharded, mesh {mesh.shape})"
    log(f"[train] bf16{where}, {n_params / 1e6:.1f} M parameters, {n} layers,"
        f" remat, batch {batch[0]} x {batch[1]}: losses {losses}, grad norms "
        f"{norms}; warm-up step {warm_s:.3f} s; launches a step "
        f"{per_step} (forward, dq, dkv); {launches} in {steps} steps")
    if profile:
        log_profile("transformer training step",
                    profile_steps(lambda: step_fn(state, tokens)))
    return out


def sharded_phase(fa, device, parity_want, phase9_ms):
    """Phase 14: the sharded step. (a) ``dryrun_multichip`` on every card;
    (b) f32 parity with phase 8 and (c) phase 9's bf16 training, both
    through ``make_lm_train_step`` over a mesh of one rank in this
    process. Returns (c)'s results."""
    import torch.distributed as dist
    from ray_tpu_torch.entry import dryrun_multichip
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    t0 = time.perf_counter()
    out = dryrun_multichip(n_cards, device=device)
    log(f"[sharded] (a) dryrun_multichip({n_cards}) over "
        f"{'NCCL' if device.type == 'cuda' else 'gloo'} in "
        f"{time.perf_counter() - t0:.1f} s: losses {out}")
    assert out and all(np.isfinite(v) for v in out.values()), out

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
        **({"device_id": torch.device("cuda", torch.cuda.current_device())}
           if device.type == "cuda" else {}))
    try:
        mesh = build_mesh(MeshConfig(data=1), device)
        assert set(mesh.shape.values()) == {1}, mesh.shape
        # (b) f32 through the kernels, against phase 8's one-device run.
        flash, params, tokens = parity_inputs(device)
        got = train_trajectory(flash, params, tokens, PARITY_STEPS, device,
                               mesh=mesh)
        np.testing.assert_allclose(got, parity_want, rtol=TRAIN_RTOL)
        log(f"[sharded] (b) f32 parity over mesh {mesh.shape}: (loss, grad "
            f"norm) {got} vs phase 8's one-device {parity_want}, rtol "
            f"{TRAIN_RTOL}")
        del params
        # (c) bf16 at full width, phase 9's weights and batch.
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        res = train_phase(fa, device, mesh=mesh, profile=False)
        log(f"[sharded] (c) bf16 sharded step {res['step_ms']:.3f} ms "
            f"(median of {TRAIN_STEPS}) against phase 9's {phase9_ms:.3f} ms "
            f"in this run; {res['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{res['peak_bytes'] / 2**30:.2f} GiB; launches "
            f"{res['launches']}")
        res["paired"] = paired_step_times(device, mesh)
    finally:
        dist.destroy_process_group()
    return res


def paired_step_times(device, mesh, width=SERVE_WIDTH, batch=TRAIN_BATCH,
                      rounds=STEP_PAIRS):
    """Phase 14 (d): the one-device and the sharded bf16 step (phase 9's
    model, weights and batch) timed in turns, one-device, sharded, sharded,
    one-device in each round, after one warm-up step each, so that the
    host's drift falls on both. Returns each path's step times (ms)."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    tokens = np.random.default_rng(SEED + 4).integers(
        0, width["vocab_size"], size=batch)
    paths = {}
    for name, m in (("one-device", None), ("sharded", mesh)):
        init_fn, step_fn, shard_batch = make_lm_train_step(cfg, m,
                                                           device=device)
        state = init_fn(torch.Generator(device=device).manual_seed(SEED))
        paths[name] = [step_fn, state, shard_batch(tokens)]
    times = {name: [] for name in paths}
    order = ["one-device", "sharded"] + ["one-device", "sharded", "sharded",
                                         "one-device"] * rounds
    for i, name in enumerate(order):
        step_fn, state, batch_ = paths[name]
        t0 = time.perf_counter()
        paths[name][1], metrics = step_fn(state, batch_)
        metrics["loss"].item()
        torch.cuda.synchronize()
        if i >= 2:                               # the first two warm up
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[sharded] (d) bf16 step in turns, {rounds} rounds of one-device, "
        f"sharded, sharded, one-device: median one-device "
        f"{med['one-device']:.3f} ms, sharded {med['sharded']:.3f} ms; all "
        f"(ms): " + "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                              for k, v in times.items()))
    return times


def backward_times(fa, device, B, L, H, D, dt):
    """Phase 10: each backward kernel, the plain backward and the SDPA
    backward (``torch.autograd.grad`` on its output: the yardstick for the
    pair, never called by the port) on one causal input, with the kernels'
    largest |error| against the plain backward and their bounds."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    q, k, v = random_qkv(gen, B, L, L, H, D, dt, device)
    do = torch.randn(q.shape, generator=gen, device=device).to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    errs = assert_grads_close(got, want, dt, "training shape")
    del got, want
    scale = 1.0 / D ** 0.5
    delta = fa.attention_delta(out, do)
    res = dict(dq_err=errs["dq"][0],
               dkv_err=max(errs["dk"][0], errs["dv"][0]))
    res["dq_ms"] = time_ms(lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                                 True, scale))
    res["dkv_ms"] = time_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                                   True, scale))
    res["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, True), windows=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    res["library_ms"] = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    bounds = backward_bounds(B, L, L, H, D, dt, True)
    res["dq_bound"], res["dkv_bound"] = bounds["dq"], bounds["dkv"]
    return res


def conv_layouts(fn):
    """Run ``fn()`` and return ``(its result, forward convs, backward convs,
    tensors not channels_last)``: every 4-d input and output of each
    ``aten.convolution`` and ``aten.convolution_backward`` it dispatches is
    checked with ``is_contiguous(memory_format=torch.channels_last)``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    seen = {"fwd": 0, "bwd": 0}
    bad = []

    def check(name, tensors):
        for i, t in enumerate(tensors):
            if (isinstance(t, torch.Tensor) and t.dim() == 4 and
                    not t.is_contiguous(memory_format=torch.channels_last)):
                bad.append(f"{name}[{i}] {tuple(t.shape)} {t.stride()}")

    class Layouts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.convolution.default:
                seen["fwd"] += 1
                check("convolution", (*args[:2], out))
            elif func is aten.convolution_backward.default:
                seen["bwd"] += 1
                check("convolution_backward", (*args[:2], out[0]))
            return out

    with Layouts():
        result = fn()
    return result, seen["fwd"], seen["bwd"], bad


def _assert_close_scaled(got, want, what, tol=RESNET_RTOL):
    """Hold ``got`` (card) against ``want`` (CPU) at ``tol`` of each value
    plus ``tol`` of the largest |want|; returns the largest share of that
    allowed error."""
    got, want = got.detach().cpu().double(), want.detach().double()
    atol = tol * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=tol, atol=atol,
                               msg=lambda m: f"{what} differs: {m}")
    return ((got - want).abs() / (atol + tol * want.abs())).max().item()


def resnet_parity_phase(device, sides=RESNET_PARITY_SIDES,
                        batch=RESNET_PARITY_BATCH):
    """Phase 11: f32 ResNet-18 on the card against the port's CPU run, from
    the same weights: logits, loss and every gradient."""
    from ray_tpu_torch.models import resnet
    cfg = dataclasses.replace(resnet.resnet18(num_classes=10),
                              dtype=torch.float32)
    cpu = torch.device("cpu")

    def run(dev, images, labels):
        params = resnet.init_params(
            cfg, torch.Generator().manual_seed(SEED + 6), dev)
        leaves = resnet.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        x, y = torch.tensor(images, device=dev), torch.tensor(labels,
                                                              device=dev)
        logits = resnet.apply(params, x, cfg)
        loss = resnet.loss_fn(params, x, y, cfg)
        return [logits, loss, *torch.autograd.grad(loss, leaves)]

    worst = {}
    for side in sides:
        rng = np.random.default_rng(SEED + side)
        images = rng.standard_normal((batch, side, side, 3), dtype=np.float32)
        labels = rng.integers(0, cfg.num_classes, size=batch)
        got = run(device, images, labels)
        want = run(cpu, images, labels)
        assert len(got) == len(want) == 2 + len(resnet.leaves(
            resnet.param_shapes(cfg)))
        names = ["logits", "loss"] + [f"grad {i}" for i in
                                      range(len(got) - 2)]
        shares = [_assert_close_scaled(g, w, f"{n} at {side}x{side}")
                  for g, w, n in zip(got, want, names)]
        worst[side] = (shares[0], shares[1], max(shares[2:]))
    log(f"[resnet] f32 parity, resnet18 (10 classes), batch {batch}: card "
        f"against CPU at rtol {RESNET_RTOL} plus {RESNET_RTOL} of each "
        f"tensor's largest |value|; largest share of that tolerance "
        f"(logits, loss, gradients) by side: {worst}")


def resnet_train_phase(device, name, batch, steps=RESNET_STEPS):
    """Phase 12 for one model: bf16 training on one seeded batch; returns
    step ms, images/s, model TFLOP/s, MFU and peak memory."""
    from ray_tpu_torch import bench
    step, cfg, n_params = bench.resnet_train_step(name, batch=batch,
                                                  device=device)
    t0 = time.perf_counter()
    loss, n_fwd, n_bwd, bad = conv_layouts(step)     # warm-up
    losses = [loss.item()]
    warm_s = time.perf_counter() - t0
    assert n_fwd > 0 and n_bwd == n_fwd, (n_fwd, n_bwd)
    assert not bad, f"convolution tensors not channels_last: {bad[:8]}"
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step().item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    assert all(np.isfinite(losses)), losses
    # Falling: the first update lowers the loss. SGD(0.1, momentum 0.9)
    # with no warm-up, on one batch of noise with random labels, overshoots
    # a few steps later at full width (in JAX too), so the last loss is
    # not held below the first.
    assert losses[1] < losses[0], losses
    step_s = statistics.median(times)
    flops = 3 * bench.FORWARD_FLOPS_PER_IMAGE[name] * batch / step_s
    peak = bench.peak_bf16_flops(torch.cuda.get_device_name(0))
    out = dict(step_ms=step_s * 1e3, images_per_s=batch / step_s,
               model_tflops=flops / 1e12,
               mfu_pct=None if peak is None else 100 * flops / peak,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[resnet] {name} bf16, {n_params / 1e6:.2f} M parameters, batch "
        f"{batch} x 224 x 224: losses {[round(x, 4) for x in losses]}; "
        f"warm-up step {warm_s:.3f} s; {n_fwd} convolutions forward and "
        f"{n_bwd} backward, every tensor channels_last")
    log_profile(name, profile_steps(step))
    return out


def profile_steps(step, steps=3, top=8):
    """Where a step's time goes: ``torch.profiler`` over ``steps`` calls of
    ``step()``. Returns the host seconds of the window, the share of it in
    which the device ran a kernel (union of kernel intervals), and the
    ``top`` operators by the device time of the kernels they launched
    themselves, each with its share of all kernel time and its calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    assert spans, "the profiler saw no device activity"
    busy, end = 0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    ops = [(a.key, a.self_device_time_total, a.count)
           for a in prof.key_averages()
           if a.device_type == DeviceType.CPU and a.self_device_time_total]
    total = sum(us for _, us, _ in ops)
    ranked = sorted(ops, key=lambda o: -o[1])[:top]
    return dict(wall_s=wall_s, busy_share=busy * 1e-6 / wall_s,
                top=[(key, us / total, n) for key, us, n in ranked])


def log_profile(what, prof):
    top = "; ".join(f"{k} {100 * s:.1f}% ({n})" for k, s, n in prof["top"])
    log(f"[profile] {what}: 3 steps in {prof['wall_s']:.3f} s, device busy "
        f"{100 * prof['busy_share']:.1f}% of it; operators by the device "
        f"time of their own kernels (share of all kernel time, calls): {top}")


def bench_phase(timeout_s=BENCH_TIMEOUT_S):
    """Phase 13: the port's bench in a subprocess, as a user runs it.
    Returns its headline and its transformer section's progress line."""
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout_s)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[bench] {line}")
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    head = json.loads(lines[-1])
    sections = {d["metric"]: d for d in map(json.loads, lines[:-1])
                if d.get("unit") == "progress"}
    ex = head["extras"]
    assert head["backend_available"] is True, head
    assert head["probe_failed"] is False, head
    for value in (head["value"], head["mfu_pct"],
                  ex["resnet18_images_per_sec"],
                  ex["transformer_tokens_per_sec"],
                  ex["transformer_mfu_pct"]):
        assert value is not None and value > 0, head
    assert set(head["errors"]) == {"ppo"}, (head["errors"],
                                           proc.stderr[-4000:])
    return head, sections["section_transformer"]


# -- phase 17: TorchTrainer ---------------------------------------------------


def _numpy_tree_to_torch(tree, device="cpu"):
    """A numpy tree (a restored checkpoint, host weights) with its arrays
    as tensors on ``device``."""
    from ray_tpu_torch._private.host import from_numpy
    if isinstance(tree, dict):
        return {k: _numpy_tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree_to_torch(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return from_numpy(tree, None, device)
    return tree


def lm_trainer_loop(config):
    """Phase 17 (a) and (b): the training loop a user hands ``TorchTrainer``.
    It runs in a train worker: it builds ``make_lm_train_step`` on the
    session's mesh, starts from ``config["seed"]``'s weights or from
    ``session.get_checkpoint()`` (parameters, AdamW state and step), and
    reports every step; every ``config["ckpt_every"]``-th report carries the
    full state. ``config["fail_at"]``: the first attempt raises after that
    step's report. ``config["timings"]``: a list the loop appends each
    report's host-clock ms to (the workers are threads of this process)."""
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step, session

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    device = torch.device(config["device"])
    cfg = TransformerConfig(**config["width"], dtype=config["dtype"],
                            use_flash=True)
    mesh = session.get_mesh()
    if device.type == "cuda":
        # the mesh rule: one worker granted a whole card
        assert mesh is not None and set(mesh.shape.values()) == {1}, mesh
    init_fn, step_fn, shard = make_lm_train_step(cfg, mesh, device=device)
    restored = session.get_checkpoint()
    if restored is None:
        state = init_fn(torch.Generator(device=device).manual_seed(
            config["seed"]))
        start = 0
    else:
        saved = _numpy_tree_to_torch(restored.to_dict())
        state = init_fn(params=saved["params"])
        for s in saved["opt"]["state"].values():
            # the engine stores a 0-d leaf as shape (1,), as the JAX
            # package's does (np.ascontiguousarray)
            s["step"] = s["step"].reshape(())
        state[1].load_state_dict(saved["opt"])
        start = int(saved["step"])
        adam_steps = {float(s["step"]) for s in state[1].state.values()}
        assert adam_steps == {float(start)}, (adam_steps, start)
    tokens = (shard if mesh is None else session.shard_batch)(
        config["tokens"])
    for step in range(start + 1, config["steps"] + 1):
        before = launch_counts(fa)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - b for a, b in zip(launch_counts(fa), before))
        ckpt = None
        if step % config["ckpt_every"] == 0:
            params, opt = state
            ckpt = Checkpoint.from_dict({
                "params": transformer._tree_map(
                    lambda p: p.to_local() if isinstance(p, DTensor) else p,
                    params),
                "opt": opt.state_dict(), "step": step})
        t1 = time.perf_counter()
        session.report({"step": step, "loss": loss, "grad_norm": grad_norm,
                        "step_ms": step_ms, "launches": launched,
                        "resumed_from": start}, checkpoint=ckpt)
        config["timings"].append((step, ckpt is not None,
                                  (time.perf_counter() - t1) * 1e3))
        if step == config.get("fail_at") and restored is None:
            raise RuntimeError(f"simulated worker crash after step {step}")


def _count_params(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_count_params(v) for v in shapes.values())
    return math.prod(shapes)


def _chunk_bytes(root: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in (root / "chunks").rglob("*")
               if f.is_file())


def _perf_mean_ms(snap, name):
    h = snap["hists"].get(name)
    return None if h is None else h["sum_ms"] / max(1, sum(h["counts"]))


def _assert_same_bytes(got, want, path="state"):
    """``got`` (restored numpy tree) holds ``want``'s (host tensor tree)
    values byte for byte, dtype and shape included (a 0-d leaf comes back
    as shape (1,): the engine stores it so, as the JAX package's does)."""
    from ray_tpu_torch._private.host import to_numpy
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same_bytes(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_bytes(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        w = to_numpy(want)
        shape = (1,) if w.ndim == 0 else w.shape
        assert got.dtype == w.dtype and got.shape == shape, (
            path, got.dtype, w.dtype, got.shape, w.shape)
        assert np.ascontiguousarray(got).tobytes() == \
            np.ascontiguousarray(w).tobytes(), path
    else:
        assert got == want, (path, got, want)


def trainer_full_phase(rt, fa, device, card, phase9_ms, root,
                       width=SERVE_WIDTH, batch=TRAIN_BATCH,
                       steps=TRAIN_STEPS):
    """Phase 17 (a): phase 9's model, weights and batch trained by
    ``TorchTrainer`` in one ``use_gpu`` worker on the ``nccl`` group, 1 + 5
    steps, the full state checkpointed at every third report (two kept);
    then the committed state restored and held against the host copy taken
    at that step. Returns the launches of the run and its median step ms."""
    from ray_tpu_torch.air import (Checkpoint, CheckpointConfig, RunConfig,
                                   ScalingConfig)
    from ray_tpu_torch.checkpoint import list_manifest_names, read_manifest
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import goodput, perf
    from ray_tpu_torch.train import TorchTrainer

    cfg = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    assert cfg.remat
    n = cfg.n_layers
    per_step = (2 * n, n, n)
    n_params = _count_params(transformer.param_shapes(cfg))
    state_bytes = 3 * 4 * n_params       # f32 parameters and two moments
    free = shutil.disk_usage(root.parent).free
    # two commits kept, a reported state spilled by the object store (it
    # is larger than the store), and slack
    need = 3 * state_bytes + 2**31
    if free < need:
        raise RuntimeError(
            f"phase 17 (a) keeps two checkpoints of {state_bytes / 1e9:.2f} "
            f"GB: it needs {need / 1e9:.2f} GB free under {root.parent}, "
            f"which has {free / 1e9:.2f} GB")
    timings = []
    config = dict(width=width, dtype=torch.bfloat16, device=str(device),
                  seed=SEED, steps=1 + steps, ckpt_every=3, timings=timings,
                  tokens=np.random.default_rng(SEED + 4).integers(
                      0, width["vocab_size"], size=batch))
    trainer = TorchTrainer(
        lm_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device.type == "cuda"),
        run_config=RunConfig(name="full", storage_path=str(root),
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=2)),
        results_timeout_s=TRAINER_TIMEOUT_S)
    perf_was = perf.ENABLED
    perf.enable()
    perf.reset()
    goodput.reset()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    launches = launch_counts(fa)
    snap, ledger = perf.snapshot(), goodput.snapshot()
    if not perf_was:
        perf.disable()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(1, steps + 2)), hist
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    assert all(np.isfinite(losses + norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    assert all(m["launches"] == per_step for m in hist), \
        [m["launches"] for m in hist]
    assert launches == tuple((steps + 1) * c for c in per_step), launches
    step_ms = statistics.median(m["step_ms"] for m in hist[1:])
    report_ms = [ms for _, saved, ms in timings if not saved]
    enqueue_ms = [ms for _, saved, ms in timings if saved]
    # (a) the committed state, restored, against the host copy of step 6
    ckpt_root = root / "full" / "checkpoints"
    names = list_manifest_names(str(ckpt_root))
    manifests = [read_manifest(str(ckpt_root), nm) for nm in names]
    # the engine numbers commits by reported checkpoint: steps 3 and 6
    assert sorted(m.step for m in manifests) == [1, 2], [m.step for m in
                                                         manifests]
    t0 = time.perf_counter()
    restored = Checkpoint.from_manifest(str(ckpt_root)).to_dict()
    restore_s = time.perf_counter() - t0
    want = result.checkpoint.to_dict()
    assert want["step"] == 6 and restored["step"] == 6
    _assert_same_bytes(restored, want)
    commit_bytes = [sum(e.nbytes for s in m.shards for e in s.arrays)
                    for m in manifests]
    cats = ledger["jobs"]["default"]["cats"]
    log(f"[trainer] (a) {free / 1e9:.1f} GB free under {root.parent} at the "
        f"start; TorchTrainer, 1 use_gpu worker on the nccl group, "
        f"mesh data=1: bf16, {n_params / 1e6:.1f} M parameters, {n} layers, "
        f"remat, batch {batch[0]} x {batch[1]}: losses {losses}, grad norms "
        f"{norms}; launches a step {per_step} (forward, dq, dkv), {launches} "
        f"in {steps + 1} steps; fit() {fit_s:.1f} s")
    log(f"[times] {card}: TorchTrainer bf16 step {step_ms:.3f} ms (median of "
        f"{steps}; steps in ms: "
        + ", ".join(f"{m['step_ms']:.1f}" for m in hist)
        + f"), phase 9's direct step {phase9_ms:.3f} ms in this run; "
        f"session.report {statistics.median(report_ms):.3f} ms without a "
        f"checkpoint (median of {len(report_ms)}), "
        + ", ".join(f"{ms:.1f}" for ms in enqueue_ms)
        + " ms with one (the host snapshot and the engine's enqueue)")
    log(f"[times] {card}: checkpoint of {state_bytes / 1e9:.3f} GB (f32 "
        f"parameters and AdamW moments): engine enqueue mean "
        f"{_perf_mean_ms(snap, 'train.ckpt_enqueue'):.1f} ms, commit (hash, "
        f"write, manifest) mean {_perf_mean_ms(snap, 'ckpt.save') / 1e3:.3f}"
        f" s, hash per chunk mean {_perf_mean_ms(snap, 'ckpt.hash'):.1f} ms,"
        f" write per chunk mean {_perf_mean_ms(snap, 'ckpt.write'):.1f} ms; "
        f"bytes per commit {commit_bytes}, on disk {_chunk_bytes(ckpt_root)}"
        f"; restore of step 6 {restore_s:.3f} s, byte for byte equal to the "
        f"host copy taken at that step")
    log(f"[trainer] (a) goodput ledger (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(cats.items()))
        + f"; compiles {ledger['jobs']['default']['compile_count']}")
    return launches, step_ms


def trainer_restart_phase(rt, fa, device, root, width=PARITY_WIDTH,
                          batch=PARITY_BATCH, steps=6, fail_at=3):
    """Phase 17 (b): phase 8's model, weights and batch in one ``use_gpu``
    worker, a checkpoint at every report; the first attempt raises after
    step ``fail_at``'s report and the trainer restarts it from the last
    committed manifest. Steps after the restart follow an uninterrupted
    direct run at ``TRAIN_RTOL``, and device memory returns to its value
    before ``fit``. Returns the launches of the run."""
    from ray_tpu_torch.air import (CheckpointConfig, FailureConfig,
                                   RunConfig, ScalingConfig)
    from ray_tpu_torch.checkpoint import list_manifest_names, read_manifest
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import goodput
    from ray_tpu_torch.train import TorchTrainer

    flash, params, tokens = parity_inputs(device, width, batch)
    want = train_trajectory(flash, params, tokens, steps, device)
    del params
    per_step = ((2 if flash.remat else 1) * width["n_layers"],
                width["n_layers"], width["n_layers"])
    free_device_caches()
    before = torch.cuda.memory_allocated(device)
    config = dict(width=width, dtype=torch.float32, device=str(device),
                  seed=SEED + 3, steps=steps, ckpt_every=1, fail_at=fail_at,
                  timings=[], tokens=tokens)
    trainer = TorchTrainer(
        lm_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device.type == "cuda"),
        run_config=RunConfig(
            name="restart", storage_path=str(root),
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(num_to_keep=2)),
        results_timeout_s=TRAINER_TIMEOUT_S)
    goodput.reset()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    result = trainer.fit()
    launches = launch_counts(fa)
    downtime = goodput.snapshot()["jobs"]["default"]["cats"].get(
        "restart_downtime", 0.0)
    assert result.error is None, result.error
    hist = result.metrics_history
    first = [m for m in hist if m["resumed_from"] == 0]
    resumed = [m for m in hist if m["resumed_from"] > 0]
    assert [m["step"] for m in first] == list(range(1, fail_at + 1)), hist
    start = resumed[0]["resumed_from"]
    assert 1 <= start <= fail_at, start
    assert [m["step"] for m in resumed] == list(range(start + 1, steps + 1))
    assert all(m["launches"] == per_step for m in hist), hist
    assert downtime > 0.0, downtime
    ckpt_root = root / "restart" / "checkpoints"
    kept = sorted(read_manifest(str(ckpt_root), nm).step
                  for nm in list_manifest_names(str(ckpt_root)))
    # base_step carried: the resumed attempt numbers its saves after the
    # committed one, so the newest commit is the last step
    assert kept[-1] == steps, kept
    got = {m["step"]: (m["loss"], m["grad_norm"]) for m in resumed}
    after = [got[s] for s in range(fail_at + 1, steps + 1)]
    np.testing.assert_allclose(after, want[fail_at:], rtol=TRAIN_RTOL)
    worst = max(abs(g - w) / abs(w) for pair_g, pair_w in
                zip(after, want[fail_at:]) for g, w in zip(pair_g, pair_w))
    del result, trainer, config
    free_device_caches()
    after_bytes = torch.cuda.memory_allocated(device)
    assert abs(after_bytes - before) <= SERVE_MEMORY_SLACK, (before,
                                                             after_bytes)
    log(f"[trainer] (b) failure and restart, f32, {width['n_layers']} "
        f"layers, batch {batch[0]} x {batch[1]}, a checkpoint every report: "
        f"the first attempt raised after step {fail_at}; the restart "
        f"resumed from the committed step {start} (AdamW step restored) "
        f"after {downtime:.3f} s of restart downtime; kept commits {kept}; "
        f"(loss, grad norm) of steps {fail_at + 1}-{steps} {after} vs an "
        f"uninterrupted run {want[fail_at:]}, largest relative difference "
        f"{worst:.3g} (rtol {TRAIN_RTOL}); device memory {before} bytes "
        f"before fit(), {after_bytes} after")
    return launches


def halves_loop(config):
    """Phase 17 (c): one of two workers sharing the card. Each trains phase
    8's model on its half of phase 8's batch, allreduces its gradients on
    the ``nccl`` group (SUM, then / 2), steps AdamW, and reports the
    allreduce's result pointer, dtype and device beside its times."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import adamw, session

    rank, world = session.get_world_rank(), session.get_world_size()
    group = session.get_collective_group_name()
    assert session.get_mesh() is None      # threads share one process
    device = torch.device(config["device"])   # a half grant names no card
    cfg = TransformerConfig(**config["width"], dtype=torch.float32,
                            use_flash=True)
    params = transformer._tree_map(
        lambda t: t.detach().to(device, torch.float32, copy=True)
        .requires_grad_(True), config["params"])
    leaves = transformer.leaves(params)
    opt = adamw()(leaves)
    tokens = torch.as_tensor(config["tokens"][rank::world]).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    for step in range(1, config["steps"] + 1):
        t0 = time.perf_counter()
        loss = transformer.loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        sync()
        t1 = time.perf_counter()
        summed = collective.allreduce(flat, group)
        sync()
        allreduce_ms = (time.perf_counter() - t1) * 1e3
        mean = summed / world
        with torch.no_grad():
            offset = 0
            for p in leaves:
                p.grad = mean[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
            grad_norm = mean[:-1].norm().item()
            opt.step()
            for p in leaves:
                p.grad = None
        sync()
        session.report({
            "step": step, "loss": mean[-1].item(), "grad_norm": grad_norm,
            "allreduce_ms": allreduce_ms,
            "step_ms": (time.perf_counter() - t0) * 1e3,
            "values": flat.numel(),
            "out": (summed.data_ptr(), str(summed.dtype), str(summed.device)),
            "in": (flat.data_ptr(), str(flat.dtype), str(flat.device))})


def trainer_halves_phase(rt, fa, device, card, parity_want,
                         width=PARITY_WIDTH, batch=PARITY_BATCH,
                         steps=PARITY_STEPS):
    """Phase 17 (c): two workers of ``num_gpus=0.5`` on one card, the
    ``nccl`` group folding both ranks onto it: the allreduced trajectory
    follows phase 8's one-worker full-batch run at ``TRAIN_RTOL``. Returns
    the launches of the run."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    flash, params, tokens = parity_inputs(device, width, batch)
    config = dict(width=width, device=str(device), params=params,
                  tokens=tokens, steps=steps)
    trainer = TorchTrainer(
        halves_loop, train_loop_config=config,
        scaling_config=ScalingConfig(
            num_workers=2, resources_per_worker=(
                {"CPU": 1, "GPU": 0.5} if device.type == "cuda"
                else {"CPU": 1})),
        results_timeout_s=TRAINER_TIMEOUT_S)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    result = trainer.fit()
    launches = launch_counts(fa)
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == 2 * steps, hist
    by_step = collections.defaultdict(list)
    for m in hist:
        by_step[m["step"]].append(m)
    got = []
    for s in range(1, steps + 1):
        ranks = by_step[s]
        assert len(ranks) == 2, ranks
        for m in ranks:
            # a CUDA tensor of the input's dtype, on the input's device
            assert m["out"][1:] == m["in"][1:], m
            assert m["out"][2].startswith(device.type), m
        outs = {m["out"][0] for m in ranks}
        assert len(outs) == 2 and not outs & {m["in"][0] for m in ranks}, \
            ranks                   # no rank's output aliases another's
        assert ranks[0]["loss"] == ranks[1]["loss"], ranks
        got.append((ranks[0]["loss"], ranks[0]["grad_norm"]))
    np.testing.assert_allclose(got, parity_want, rtol=TRAIN_RTOL)
    n = width["n_layers"]
    per_step = ((2 if flash.remat else 1) * n, n, n)
    assert launches == tuple(2 * steps * c for c in per_step), launches
    ar = [m["allreduce_ms"] for m in hist]
    st = [m["step_ms"] for m in hist]
    log(f"[trainer] (c) two num_gpus=0.5 workers on one card, nccl group "
        f"folded onto {device}: (loss, grad norm) {got} vs phase 8's "
        f"one-worker full batch {parity_want}, rtol {TRAIN_RTOL}; each "
        f"result a new {hist[0]['out'][1]} tensor on {hist[0]['out'][2]}")
    log(f"[times] {card}: two half-card workers, f32, {n} layers, batch 1 x "
        f"{batch[1]} each: allreduce of {hist[0]['values']} f32 values {statistics.median(ar):.3f} ms (synchronized, median "
        f"of {len(ar)}: " + ", ".join(f"{v:.2f}" for v in ar)
        + f"), step {statistics.median(st):.3f} ms (median of {len(st)})")
    return launches


def nccl_distinct_phase(device):
    """Phase 17 (d): the nccl group over distinct cards, one rank per card
    (one ``torch.cuda.nccl`` call per op). It needs two or more cards."""
    from ray_tpu_torch import collective
    n = min(torch.cuda.device_count(), 4) if device.type == "cuda" else 1
    if n < 2:
        log(f"[trainer] (d) not run: the nccl group over distinct cards "
            f"needs two or more, and this machine has {n}")
        return
    outs = [None] * n
    errors = []

    def rank_body(r):
        try:
            dev = torch.device("cuda", r)
            collective.init_collective_group(n, r, "nccl", "distinct")
            x = torch.full((1024,), float(r + 1), device=dev)
            outs[r] = (collective.allreduce(x, "distinct"),
                       collective.allgather(x, "distinct"))
            collective.destroy_collective_group("distinct")
        except Exception as e:      # surfaced below, after every join
            errors.append(e)

    threads = [threading.Thread(target=rank_body, args=(r,))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and all(o is not None for o in outs), errors
    total = n * (n + 1) / 2
    for r, (red, gathered) in enumerate(outs):
        assert red.device == torch.device("cuda", r), red.device
        assert torch.all(red == total).item()
        assert gathered.shape == (n, 1024)
    log(f"[trainer] (d) nccl group over {n} distinct cards: allreduce and "
        f"allgather right on every rank")


def trainer_phase(fa, device, card, phase9_ms, parity_want):
    """Phase 17: ``TorchTrainer`` on ``init(num_cpus=8)`` with the card
    detected: (a) full width, (b) failure and restart, (c) two workers
    sharing the card, (d) distinct cards (needs two). The checkpoint
    directory is made under the git-ignored build/ and deleted at the end.
    Returns the launches of (a), (b) and (c), summed, and (a)'s median
    step ms."""
    import ray_tpu_torch as rt
    root = REPO / TRAINER_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        res = rt.cluster_resources()
        assert res.get("GPU", 0) == torch.cuda.device_count(), res
        launches, full_ms = trainer_full_phase(rt, fa, device, card,
                                               phase9_ms, root)
        totals = [launches]
        torch.cuda.empty_cache()
        totals.append(trainer_restart_phase(rt, fa, device, root))
        totals.append(trainer_halves_phase(rt, fa, device, card,
                                           parity_want))
        nccl_distinct_phase(device)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return tuple(map(sum, zip(*totals))), full_ms


# -- phase 18: the multi-process runtime --------------------------------------


def seeded_bf16(side, seed, device):
    """A bf16 [side, side] tensor from a seeded generator on ``device``: the
    same bits in every process on the same card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(side, side, generator=gen, device=device,
                       dtype=torch.bfloat16)


def _torch_tree_to_numpy(tree):
    """A parameter tree with its tensors as host numpy arrays."""
    if isinstance(tree, dict):
        return {k: _torch_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def _tree_nbytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    return tree.nbytes


class TensorKeeper:
    """User code for phase 18 (b): an actor in the GPU daemon that builds
    the seeded tensor on its own card."""

    def __init__(self, side, seed, device):
        self.t = seeded_bf16(side, seed, device)

    def tensor(self):
        return self.t

    def matches(self, x):
        """Whether ``x`` (a driver put, fetched by this process) equals the
        tensor built here, and the device it landed on."""
        return torch.equal(x, self.t), str(x.device)


class DaemonLM:
    """User code for phase 18 (c): phase 5's deployment in an actor of the
    GPU daemon. The f32 weights come as host numpy through the object plane
    (``refs[0]``, fetched here and timed); ``switch`` casts them in place of
    a rolling update, since the daemon's one card holds one such actor."""

    def __init__(self, cfg, refs, device):
        import ray_tpu_torch
        # TF32 off for the f32 check, as in this script's process. Imported
        # here: a ``torch.backends`` submodule named through the global
        # ``torch`` would make this class unpicklable by value.
        from torch.backends.cuda import matmul
        from torch.backends import cudnn
        matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        host = ray_tpu_torch.get(refs[0])
        self.fetch = (time.perf_counter() - t0, _tree_nbytes(host))
        self.device = device
        self.params = {"float32": _numpy_tree_to_torch(host, device)}
        self.cfg = cfg
        self.deployment = make_deployment(cfg, self.params["float32"], device)
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def loaded(self):
        """(seconds, bytes) of the weights' fetch, and where this runs."""
        import os

        import ray_tpu_torch
        return (self.fetch, os.getpid(),
                ray_tpu_torch.get_runtime_context().get_gpu_devices())

    def switch(self, dtype_name):
        from ray_tpu_torch.models import transformer
        dtype = getattr(torch, dtype_name)
        self.cfg = dataclasses.replace(self.cfg, dtype=dtype)
        self.params[dtype_name] = transformer.cast_params(
            self.params["float32"], dtype)
        self.deployment = make_deployment(self.cfg, self.params[dtype_name],
                                          self.device)

    def reset_counts(self):
        self.fa.launches = 0
        self.deployment.batches = 0

    def counts(self):
        """(forward-kernel launches in this process, batches served) since
        the last ``reset_counts``."""
        return self.fa.launches, self.deployment.batches

    def __call__(self, request):
        return self.deployment(request)


def process_runtime_phase(fa, device, card, rates, width=SERVE_WIDTH,
                          n_requests=N_REQUESTS, side=OBJECT_SIDE, gpus=1):
    """Phase 18: the multi-process runtime on the card. ``rates``: phases
    5, 15 and 16's bf16 requests/s, printed beside this phase's. Returns
    the flash forward kernel's launches counted in the daemon's process
    and (c)'s bf16 requests/s from 16 threads and from one."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import ProcessCluster

    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    t0 = time.perf_counter()
    cluster = ProcessCluster(num_daemons=1, num_cpus=4)
    cpu_s = time.perf_counter() - t0
    procs = [cluster.state_proc]
    try:
        t0 = time.perf_counter()
        gpu_index = len(cluster.daemons)
        cluster.add_daemon(num_gpus=gpus)
        gpu_s = time.perf_counter() - t0
        procs += [d["proc"] for d in cluster.daemons]
        rt.init(address=cluster.address)
        try:
            launches, served = process_runtime_paths(
                rt, cluster, gpu_index, fa, device, card, rates, width,
                n_requests, side, gpus, cpu_s, gpu_s, free_before, procs)
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()
    # (e) nothing of the cluster outlives it
    procs += [d["proc"] for d in cluster.daemons]
    left = [p.pid for p in procs if p.poll() is None]
    assert not left, left
    log(f"[process-runtime] (e) shutdown() and cluster.shutdown(): none of "
        f"the {len(set(procs))} state-service and daemon processes is left")
    return launches, served


def process_runtime_paths(rt, cluster, gpu_index, fa, device, card, rates,
                          width, n_requests, side, gpus, cpu_s, gpu_s,
                          free_before, procs):
    """Phase 18 (a)-(d) on a live cluster, with this process its driver."""
    import os

    from ray_tpu_torch._private import worker

    on_card = device.type == "cuda"
    # (a) the GPU daemon owns the card, in a process of its own
    res = rt.cluster_resources()
    assert res.get("GPU", 0.0) == float(gpus), res
    cards = cluster.daemons[gpu_index]["cards"]

    @rt.remote(num_gpus=gpus)
    def where():
        import os as _os

        import ray_tpu_torch
        return (_os.getpid(), _os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.get_device_name() if torch.cuda.is_available()
                else None,
                ray_tpu_torch.get_runtime_context().get_gpu_devices())

    pid, visible, name, granted = rt.get(where.remote(), timeout=300)
    assert pid != os.getpid(), pid
    if gpus:
        assert visible == ",".join(cards) and granted == [
            torch.device("cuda", 0)], (visible, cards, granted)
        assert name == torch.cuda.get_device_name(0), name
    log(f"[process-runtime] (a) ProcessCluster on the Python state service: "
        f"a CPU daemon registered {cpu_s:.2f} s after the cluster's start "
        f"(state service included), the GPU daemon "
        f"{gpu_s:.2f} s after add_daemon(num_gpus={gpus}); "
        f"cluster_resources() {res}; a num_gpus={gpus} task ran in pid {pid} "
        f"(the driver is {os.getpid()}) with CUDA_VISIBLE_DEVICES={visible!r}"
        f" on {name}, granted {granted}")

    # (b) tensors between processes
    keeper = rt.remote(num_gpus=gpus)(TensorKeeper).remote(side, SEED + 4,
                                                            device)
    want = seeded_bf16(side, SEED + 4, device)
    got = rt.get(keeper.tensor.remote(), timeout=300)  # warm-up
    nbytes = want.numel() * want.element_size()
    from_daemon = []
    for _ in range(HOP_RUNS):
        t0 = time.perf_counter()
        got = rt.get(keeper.tensor.remote(), timeout=300)
        from_daemon.append(time.perf_counter() - t0)
    assert got.device == want.device and torch.equal(got, want), got.device
    to_daemon = []
    for _ in range(HOP_RUNS):
        ref = rt.put(want)
        t0 = time.perf_counter()
        equal, landed = rt.get(keeper.matches.remote(ref), timeout=300)
        to_daemon.append(time.perf_counter() - t0)
        assert equal, "a driver put arrived changed"
        del ref
    assert landed == ("cuda:0" if on_card else "cpu"), landed
    written = want.clone()
    ref = rt.put(written)
    written.add_(1)
    try:
        rt.get(keeper.matches.remote(ref), timeout=300)
    except rt.RayTpuError as e:
        assert "modified in place" in str(e), e
    else:
        raise AssertionError("a put tensor written in place crossed over")
    del ref, written, got
    rt.kill(keeper)
    log(f"[process-runtime] (b) a seeded bf16 [{side}, {side}] tensor made "
        f"in the daemon arrived on the driver's {want.device} bit-equal to "
        f"the same seeded build here; a driver put arrived on the daemon's "
        f"{landed} bit-equal; a put tensor written in place was refused "
        f"across processes")
    log(f"[times] {card}: tensor hops of {nbytes} bytes (host clock, median "
        f"of {HOP_RUNS}): daemon -> driver "
        f"{statistics.median(from_daemon) * 1e3:.1f} ms, driver -> daemon "
        f"{statistics.median(to_daemon) * 1e3:.1f} ms (a task round trip "
        f"each)")
    del want

    # (c) phase 5's deployment in a GPU actor of the daemon
    from ray_tpu_torch.models import transformer
    _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                       n_requests)
    n_layers, n_tokens = cfg32.n_layers, int(lengths.sum())
    host = _torch_tree_to_numpy(params)
    t0 = time.perf_counter()
    params_ref = rt.put(host)
    put_s = time.perf_counter() - t0
    server_cls = rt.remote(num_gpus=gpus, max_concurrency=n_requests)(
        DaemonLM)
    server = server_cls.remote(cfg32, [params_ref], device)
    (fetch_s, fetched), server_pid, granted = rt.get(server.loaded.remote(),
                                                     timeout=300)
    assert server_pid == pid and fetched == _tree_nbytes(host), (
        server_pid, fetched)
    call = rt.ActorMethod(server, "__call__")
    counted = 0

    def counts():
        nonlocal counted
        launches, batches = rt.get(server.counts.remote(), timeout=60)
        if on_card:
            assert launches == n_layers * batches, (launches, batches)
        counted += launches
        return batches

    def one_thread():
        t0 = time.perf_counter()
        answers = rt.get([call.remote(r) for r in requests], timeout=600)
        return answers, time.perf_counter() - t0

    def threads():
        return serve_all(lambda r: rt.get(call.remote(r), timeout=600),
                         requests)

    rt.get(server.reset_counts.remote(), timeout=60)
    ans32, _ = one_thread()
    batches = counts()
    check_dense(cfg32, params, requests, ans32, device)
    log(f"[process-runtime] (c) the driver put the f32 weights as host numpy"
        f" ({_tree_nbytes(host)} bytes, {put_s:.2f} s); the actor in the "
        f"daemon (pid {server_pid}, granted {granted}) fetched them over the "
        f"object plane: {fetched} bytes in {fetch_s:.2f} s; f32: "
        f"{n_requests} answers in {batches} batches match the unpadded dense"
        f" run at rtol=atol=1e-3; kernel launches {n_layers} per batch, "
        f"counted in the daemon's process")
    rt.get(server.switch.remote("bfloat16"), timeout=600)
    threads()                                             # warm-up
    measured = {}
    for what, submit in ((f"from {n_requests} threads", threads),
                         ("from one thread", one_thread)):
        rt.get(server.reset_counts.remote(), timeout=60)
        runs = [submit() for _ in range(SERVE_RUNS)]
        batches = counts()
        for answers, _ in runs:
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            assert all(a.shape == (width["vocab_size"],) for a in answers)
        measured[what] = (statistics.median(t for _, t in runs), batches)
    log(f"[process-runtime] (c) bf16 after the switch: {n_requests} finite "
        f"answers x {SERVE_RUNS} passes from {n_requests} threads and x "
        f"{SERVE_RUNS} from one; kernel launches {n_layers} per batch in the "
        f"daemon, {counted} in all")
    for what, (seconds, batches) in measured.items():
        log(f"[times] {card}: bf16 serving from a num_gpus={gpus} actor in a "
            f"daemon process {what} {n_requests / seconds:.2f} requests/s, "
            f"{n_tokens / seconds:.0f} tokens/s (median of {SERVE_RUNS} "
            f"passes, {seconds:.4f} s, {batches} batches)")
    log(f"[times] {card}: beside phase 5 direct {rates['direct']:.2f}, phase"
        f" 15 in-process actor {rates['actor']:.2f}, phase 16 Serve plane "
        f"{rates['plane_threads']:.2f} (16 threads) / "
        f"{rates['plane_single']:.2f} (one thread) requests/s")
    free_serving = torch.cuda.mem_get_info(device)[0]

    # (d) the GPU daemon dies
    gpu_addr = cluster.daemons[gpu_index]["address"]
    timeout_s = cluster._heartbeat_timeout_ms / 1e3
    t0 = time.perf_counter()
    cluster.kill_daemon(gpu_index)
    try:
        rt.get(server.counts.remote(), timeout=60)
    except rt.ActorDiedError as e:
        died_s = time.perf_counter() - t0
        reason = str(e).splitlines()[0][:120]
    else:
        raise AssertionError("a call on the killed daemon's actor returned")
    assert died_s <= timeout_s, (died_s, timeout_s)
    state = worker.global_worker().runtime.state
    deadline = time.monotonic() + timeout_s + 5
    dead = None
    while time.monotonic() < deadline:
        dead = [n for n in state.list_nodes() if n.address == gpu_addr]
        if dead and not dead[0].alive:
            break
        time.sleep(0.1)
    assert dead and not dead[0].alive, dead
    del params, ans32
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[process-runtime] (d) kill_daemon: a call on the actor raised "
        f"ActorDiedError after {died_s:.2f} s (heartbeat timeout "
        f"{timeout_s:.1f} s): {reason!r}; the state service lists the node "
        f"dead ({dead[0].death_reason!r}); the card's free memory: "
        f"{free_before} bytes before (a), {free_serving} while the daemon "
        f"served, {free_after} after the kill")
    t0 = time.perf_counter()
    cluster.add_daemon(num_gpus=gpus)
    new = cluster.daemons[-1]
    procs.append(new["proc"])
    assert new["cards"] == cards, (new["cards"], cards)
    server = server_cls.remote(cfg32, [params_ref], device)
    call = rt.ActorMethod(server, "__call__")
    batch = requests[:BATCH_BUCKETS[-1]]
    answers = rt.get([call.remote(r) for r in batch], timeout=600)
    params = _numpy_tree_to_torch(host, device)
    check_dense(cfg32, params, batch, answers, device)
    rt.kill(server)
    del params
    log(f"[process-runtime] (d) a new add_daemon(num_gpus={gpus}) took the "
        f"freed card {new['cards']}; a fresh actor there answered "
        f"{len(batch)} f32 requests matching the dense run at 1e-3 "
        f"({time.perf_counter() - t0:.2f} s)")
    return counted, {what: n_requests / seconds
                     for what, (seconds, _) in measured.items()}


# -- phase 19: the tensor plane; training and serving in daemons -------------


class PlaneRank:
    """User code for phase 19 (c) and (d): one rank of a collective group
    in a daemon process. Each op returns its result as host numpy (bf16 as
    f32) with the op's ms, timed here on the host clock."""

    def plane(self):
        import os

        from ray_tpu_torch.collective.tensor_plane import current_plane
        return current_plane(), os.getpid()

    def op(self, name, x, **kw):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.tensor_plane import current_plane
        device = torch.device(current_plane()["device"])
        args = () if x is None else (torch.as_tensor(x).to(device),)
        t0 = time.perf_counter()
        out = getattr(col, name)(*args, group_name=kw.pop("group"), **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if out is None:
            return None, str(device), ms
        assert out.device == device, (out.device, device)
        return out.float().cpu().numpy(), str(device), ms

    def send(self, seed, n, peer, group):
        from ray_tpu_torch import collective as col
        x = torch.randn(n, generator=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        col.send(x.reshape(-1, 1024), peer, group)
        return (time.perf_counter() - t0) * 1e3

    def recv(self, seed, n, peer, group):
        """Whether the tensor received equals the seeded build here, bit
        for bit, and the recv's ms."""
        from ray_tpu_torch import collective as col
        t0 = time.perf_counter()
        got = col.recv(peer, group)
        ms = (time.perf_counter() - t0) * 1e3
        want = torch.randn(n, generator=torch.Generator().manual_seed(seed))
        return torch.equal(got.cpu(), want.reshape(-1, 1024)), ms

    def destroy(self, group):
        from ray_tpu_torch import collective as col
        col.destroy_collective_group(group)


class CheckpointLM(ServedLM):
    """User code for phase 19 (b): phase 16's deployment whose weights come
    from the checkpoint engine: the replica receives (a)'s committed
    parameters as ``checkpoint=`` (host numpy, loaded on the replica) and
    casts them to its config's dtype on its card. Its forward launches are
    counted in its own process."""

    def __init__(self, cfg, answer, device, checkpoint):
        import ray_tpu_torch
        from ray_tpu_torch.models import transformer
        granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
        dev = granted[0] if granted else device
        params = _numpy_tree_to_torch(checkpoint["params"], dev)
        if cfg.dtype != torch.float32:
            params = transformer.cast_params(params, cfg.dtype)
        super().__init__(cfg, params, answer, device)
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def counts(self):
        """(forward launches in this process, batches answered)."""
        return self.fa.launches, len(self.sizes)


def plane_trainer_loop(config):
    """Phase 19 (a): the training loop a user hands ``TorchTrainer``, run by
    a worker inside a GPU daemon. It checks that it joined the tensor plane
    (NCCL, world 1) and got its mesh, builds phase 9's model from phase 9's
    seed on its granted card, takes ``config["steps"]`` steps on
    ``session.shard_batch``, reports each, and at the last step reports the
    parameters as a checkpoint (the engine commits them). A final report
    carries what only this process can measure: each report's ms, the
    kernels' launches counted here, the commit's time."""
    import os

    from torch.distributed.tensor import DTensor

    import ray_tpu_torch
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.collective.tensor_plane import current_plane
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import perf
    from ray_tpu_torch.train import make_lm_train_step, session

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
    assert granted and granted[0].type == "cuda", granted
    device = granted[0]
    plane, mesh = current_plane(), session.get_mesh()
    assert plane is not None and plane["backend"] == "nccl" \
        and plane["world"] == 1 and plane["device"] == str(device), plane
    assert mesh is not None and mesh.device_type == "cuda" \
        and mesh.size == 1, mesh
    cfg = TransformerConfig(**config["width"], dtype=torch.bfloat16,
                            use_flash=True)
    init_fn, step_fn, _ = make_lm_train_step(cfg, mesh, device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(
        config["seed"]))
    tokens = session.shard_batch(config["tokens"])
    perf.enable()
    perf.reset()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    report_ms = []
    for step in range(config["steps"]):
        before = launch_counts(fa)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - b for a, b in zip(launch_counts(fa), before))
        ckpt = None
        if step == config["steps"] - 1:
            ckpt = Checkpoint.from_dict({"params": transformer._tree_map(
                lambda p: p.to_local() if isinstance(p, DTensor) else p,
                state[0])})
        t1 = time.perf_counter()
        session.report({"step": step, "loss": loss, "grad_norm": grad_norm,
                        "step_ms": step_ms, "launches": launched},
                       checkpoint=ckpt)
        report_ms.append((time.perf_counter() - t1) * 1e3)
    t0 = time.perf_counter()
    committed = session._get_session()._engine().flush(timeout=600)
    flush_s = time.perf_counter() - t0
    snap = perf.snapshot()
    perf.disable()
    session.report({"summary": True, "report_ms": report_ms,
                    "launches": launch_counts(fa), "committed": committed,
                    "flush_s": flush_s,
                    "enqueue_ms": _perf_mean_ms(snap, "train.ckpt_enqueue"),
                    "save_ms": _perf_mean_ms(snap, "ckpt.save"),
                    "pid": os.getpid(), "plane": plane,
                    "mesh": dict(mesh.shape),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def tensor_plane_phase(fa, device, card, phase9, phase17_ms, rates,
                       width=SERVE_WIDTH, batch=TRAIN_BATCH,
                       steps=TRAIN_STEPS, n_requests=N_REQUESTS):
    """Phase 19: the tensor plane, ``TorchTrainer`` workers training in a
    GPU daemon, and a Serve deployment in that daemon from their
    checkpoint. ``phase9``: phase 9's results (its first loss and step ms);
    ``phase17_ms``: phase 17 (a)'s step ms; ``rates``: phases 16 and 18's
    bf16 requests/s. Returns the launches counted in the daemon: (forward,
    dq, dkv) of (a) plus (b)'s forward."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import ProcessCluster

    root = REPO / PLANE_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    cluster = ProcessCluster(num_daemons=1, num_cpus=4,
                             heartbeat_timeout_ms=PLANE_HEARTBEAT_TIMEOUT_MS)
    procs = [cluster.state_proc]
    try:
        gpu_index = len(cluster.daemons)
        cluster.add_daemon(num_gpus=1)
        procs += [d["proc"] for d in cluster.daemons]
        rt.init(address=cluster.address)
        try:
            launches = tensor_plane_paths(
                rt, serve, cluster, gpu_index, fa, device, card, phase9,
                phase17_ms, rates, root, width, batch, steps, n_requests,
                procs)
        finally:
            serve.shutdown()
            rt.shutdown()
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    # (e) nothing of the cluster outlives it, and the card's memory is back
    procs += [d["proc"] for d in cluster.daemons]
    left = [p.pid for p in procs if p.poll() is None]
    assert not left, left
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[plane] (e) serve.shutdown(), shutdown() and cluster.shutdown(): "
        f"none of the {len(set(procs))} state-service and daemon processes"
        f" is left; the card's free memory {free_before} bytes before (a), "
        f"{free_after} after; the checkpoint directory is deleted")
    return launches


def tensor_plane_paths(rt, serve, cluster, gpu_index, fa, device, card,
                       phase9, phase17_ms, rates, root, width, batch, steps,
                       n_requests, procs):
    """Phase 19 (a)-(d) on a live cluster, with this process its driver."""
    from ray_tpu_torch.air import CheckpointConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.checkpoint import CheckpointRef, resolve_latest
    from ray_tpu_torch.collective import create_collective_group
    from ray_tpu_torch.collective.collective_group.nccl_process_group import (
        P2P_NS)
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    n = width["n_layers"]
    per_step = (2 * n, n, n)
    # (a) TorchTrainer: one use_gpu worker in the GPU daemon
    config = dict(width=width, seed=SEED, steps=1 + steps,
                  tokens=np.random.default_rng(SEED + 4).integers(
                      0, width["vocab_size"], size=batch))
    trainer = TorchTrainer(
        plane_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="plane", storage_path=str(root),
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=1)),
        results_timeout_s=TRAINER_TIMEOUT_S)
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        state = rt._private.worker.global_worker().runtime.state
        log("[plane] (a) failed; nodes: " + "; ".join(
            f"{n.address} alive={n.alive} {n.death_reason!r}"
            for n in state.list_nodes()))
    assert result.error is None, result.error
    hist = [m for m in result.metrics_history if "summary" not in m]
    summary = next(m for m in result.metrics_history if "summary" in m)
    assert [m["step"] for m in hist] == list(range(1 + steps)), hist
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    assert all(np.isfinite(losses + norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses[0], phase9["losses"][0],
                               rtol=TRAIN_RTOL)
    assert all(m["launches"] == per_step for m in hist), \
        [m["launches"] for m in hist]
    launches = tuple(summary["launches"])
    assert launches == tuple((1 + steps) * c for c in per_step), launches
    cards = cluster.daemons[gpu_index]["cards"]
    assert summary["pid"] == cluster.daemons[gpu_index]["proc"].pid and \
        summary["visible"] == ",".join(cards), summary
    assert summary["committed"], "the engine did not commit the parameters"
    step_ms = statistics.median(m["step_ms"] for m in hist[1:])
    ckpt_root = root / "plane" / "checkpoints"
    ref = CheckpointRef(str(ckpt_root), resolve_latest(str(ckpt_root)))
    log(f"[plane] (a) TorchTrainer, 1 use_gpu worker in the GPU daemon (pid "
        f"{summary['pid']}, CUDA_VISIBLE_DEVICES={summary['visible']!r}) on "
        f"the tensor plane {summary['plane']}, mesh {summary['mesh']}: bf16,"
        f" {n} layers, remat, batch {batch[0]} x {batch[1]}: losses "
        f"{losses} (step 0 against phase 9's {phase9['losses'][0]} at "
        f"rtol {TRAIN_RTOL}), grad norms {norms}; launches a step "
        f"{per_step} (forward, dq, dkv) counted in the daemon's process, "
        f"{launches} in {1 + steps} steps; the parameters committed as "
        f"{ref.manifest_name}; fit() {fit_s:.1f} s")
    log(f"[times] {card}: TorchTrainer bf16 step in a GPU daemon "
        f"{step_ms:.3f} ms (median of {steps}; steps in ms: "
        + ", ".join(f"{m['step_ms']:.1f}" for m in hist)
        + f"), phase 9's direct step {phase9['step_ms']:.3f} ms, phase 17 "
        f"(a)'s in-process trainer step {phase17_ms:.3f} ms in this run; "
        f"session.report "
        f"{statistics.median(summary['report_ms'][:-1]):.3f} ms without a "
        f"checkpoint (median of {steps}), {summary['report_ms'][-1]:.1f} ms"
        f" with the parameters (the host snapshot and the engine's enqueue "
        f"{summary['enqueue_ms']:.1f} ms); the commit (hash, write, "
        f"manifest) {summary['save_ms'] / 1e3:.3f} s, waited "
        f"{summary['flush_s']:.3f} s after the last report")

    # (b) serve.run from the CheckpointRef: a num_gpus=1 replica in the
    # GPU daemon
    _, lengths, requests = seeded_requests(width, n_requests)
    cfg32 = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    n_tokens = int(lengths.sum())
    lm = serve.deployment(
        CheckpointLM, name="lm19", max_batch_size=8,
        batch_wait_timeout_s=0.01, pad_batch_to=BATCH_BUCKETS,
        target_latency_ms=SERVE_BUDGET_MS, ray_actor_options={"num_gpus": 1},
        checkpoint=dataclasses.asdict(ref))
    t0 = time.perf_counter()
    h = serve.run(lm.bind(cfg32, "numpy", device), route_prefix=None)
    run_s = time.perf_counter() - t0
    assert h.devices.remote().result(timeout=60) == [
        torch.device("cuda", 0)]
    counted = 0

    def served(run):
        """``run()`` under the replica's own counts: (its result, batches);
        the forward launches it made in the daemon go into ``counted``."""
        nonlocal counted
        l0, b0 = h.counts.remote().result(timeout=60)
        out = run()
        l1, b1 = h.counts.remote().result(timeout=60)
        assert l1 - l0 == n * (b1 - b0), (l1 - l0, b1 - b0)
        counted += l1 - l0
        return out, b1 - b0

    (answers, _), ran = served(lambda: serve_all(
        lambda r: h.remote(r).result(timeout=300), requests))
    params = _numpy_tree_to_torch(ref.load()["params"], device)
    check_dense(cfg32, params, requests, answers, device)
    del params
    log(f"[plane] (b) serve.run from the dict form of (a)'s CheckpointRef "
        f"returned in {run_s:.2f} s: a num_gpus=1 replica in the GPU daemon "
        f"loaded the committed parameters; f32: {n_requests} answers in "
        f"{ran} batches match a dense forward here on the same checkpoint "
        f"at rtol=atol=1e-3; kernel launches {n} per batch, counted in the "
        f"daemon")
    h.shutdown()
    serve.delete("lm19")
    h = serve.run(lm.bind(cfg16, "numpy", device), route_prefix=None)
    serve_all(lambda r: h.remote(r).result(timeout=300), requests)  # warm-up

    def threads():
        return serve_all(lambda r: h.remote(r).result(timeout=300), requests)

    def one_thread():
        t0 = time.perf_counter()
        responses = [h.remote(r) for r in requests]
        answers = [r.result(timeout=300) for r in responses]
        return answers, time.perf_counter() - t0

    measured = {}
    for what, submit in ((f"from {n_requests} threads", threads),
                         ("from one thread", one_thread)):
        runs, batches = served(lambda: [submit()
                                        for _ in range(SERVE_RUNS)])
        for answers, _ in runs:
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            assert all(a.shape == (width["vocab_size"],) for a in answers)
        measured[what] = (statistics.median(t for _, t in runs), batches)
    h.shutdown()
    serve.delete("lm19")      # its replica's card is (d)'s
    log(f"[plane] (b) bf16 from the same checkpoint (the f32 deployment "
        f"deleted, a bf16 one run): {n_requests} finite answers x "
        f"{SERVE_RUNS} passes from {n_requests} threads and x {SERVE_RUNS} "
        f"from one; forward launches in the daemon {counted} in all")
    for what, (secs, batches) in measured.items():
        log(f"[times] {card}: bf16 serving from a Serve replica in a daemon, "
            f"deployed from a CheckpointRef, {what} "
            f"{n_requests / secs:.2f} requests/s, {n_tokens / secs:.0f} "
            f"tokens/s (median of {SERVE_RUNS} passes, {secs:.4f} s, "
            f"{batches} batches)")
    log(f"[times] {card}: beside phase 16's in-process Serve plane "
        f"{rates['plane_threads']:.2f} / {rates['plane_single']:.2f} and "
        f"phase 18 (c)'s actor in a daemon {rates['daemon_threads']:.2f} / "
        f"{rates['daemon_single']:.2f} requests/s (16 threads / one)")
    launches = (launches[0] + counted,) + launches[1:]

    # (c) a gloo plane over two CPU daemons
    cluster.add_daemon()
    procs.append(cluster.daemons[-1]["proc"])
    state = rt._private.worker.global_worker().runtime.state
    cpu_addrs = [d["address"] for d in cluster.daemons if not d["cards"]]
    nodes = {i.address: i.node_id.hex() for i in state.list_nodes()
             if i.alive}
    rank_cls = rt.remote(num_cpus=1)(PlaneRank)
    ranks = [rank_cls.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=nodes[a], soft=False)).remote() for a in cpu_addrs[:2]]
    group = "plane-cpu"
    t0 = time.perf_counter()
    create_collective_group(ranks, 2, [0, 1], backend="nccl",
                            group_name=group)
    form_s = time.perf_counter() - t0
    planes = rt.get([r.plane.remote() for r in ranks], timeout=120)
    assert [p["backend"] for p, _ in planes] == ["gloo", "gloo"] and \
        len({pid for _, pid in planes}) == 2, planes
    rng = np.random.default_rng(SEED + 19)
    xs = [rng.standard_normal((4, 1024)).astype(np.float32) for _ in range(2)]
    expect = {
        "allreduce": ({}, [xs[0] + xs[1]] * 2),
        "reduce": ({"dst_rank": 1}, [xs[0], xs[0] + xs[1]]),
        "broadcast": ({"src_rank": 1}, [xs[1], xs[1]]),
        "allgather": ({}, [np.stack(xs)] * 2),
        "reducescatter": ({}, [(xs[0] + xs[1])[:2], (xs[0] + xs[1])[2:]]),
        "barrier": ({}, [None, None]),
    }
    op_ms = {}
    for name, (kw, want) in expect.items():
        args = [None, None] if name == "barrier" else xs
        outs = rt.get([r.op.remote(name, x, group=group, **kw)
                       for r, x in zip(ranks, args)], timeout=120)
        for (got, where, _), w in zip(outs, want):
            assert where == "cpu", where
            if w is None:
                assert got is None
            else:
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
        op_ms[name] = max(ms for _, _, ms in outs)
    hops = []
    for src, dst in ((0, 1), (1, 0)):
        seed = SEED + 20 + src
        got = ranks[dst].recv.remote(seed, PLANE_BULK_ELEMS, src, group)
        sent_ms = rt.get(ranks[src].send.remote(seed, PLANE_BULK_ELEMS, dst,
                                                group), timeout=120)
        equal, recv_ms = rt.get(got, timeout=120)
        assert equal, f"the bulk lane changed the tensor {src} -> {dst}"
        hops.append((sent_ms, recv_ms))
    rt.get([r.destroy.remote(group) for r in ranks], timeout=60)
    left = [k for k in state.kv_keys(namespace=P2P_NS)
            if k.startswith(group.encode())]
    assert left == [], left
    for r in ranks:
        rt.kill(r)
    log(f"[plane] (c) a gloo plane over two CPU daemons (pids "
        f"{[pid for _, pid in planes]}), formed in {form_s:.2f} s: "
        f"allreduce, reduce, broadcast, allgather, reducescatter and barrier "
        f"on seeded [4, 1024] f32 tensors match numpy; "
        f"{PLANE_BULK_ELEMS * 4} bytes sent on the bulk lane each way arrived"
        f" bit-equal; nothing of the group is left under {P2P_NS!r}")
    log(f"[times] {card}: gloo plane op ms (host clock, slower rank): "
        + ", ".join(f"{k} {v:.3f}" for k, v in op_ms.items())
        + "; bulk lane " + ", ".join(
            f"{a}->{b} send {s:.1f} / recv {r:.1f}" for (a, b), (s, r) in
            zip(((0, 1), (1, 0)), hops)))

    # (d) an NCCL plane over two GPU daemons on distinct cards
    if torch.cuda.device_count() < 2:
        log(f"[plane] (d) did not run: an NCCL plane over distinct cards "
            f"needs two or more, this machine has "
            f"{torch.cuda.device_count()}")
        return launches
    cluster.add_daemon(num_gpus=1)
    procs.append(cluster.daemons[-1]["proc"])
    gpu_addrs = [d["address"] for d in cluster.daemons if d["cards"]
                 and d["proc"].poll() is None]
    nodes = {i.address: i.node_id.hex() for i in state.list_nodes()
             if i.alive}
    ranks = [rt.remote(num_gpus=1)(PlaneRank).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=nodes[a], soft=False)).remote() for a in gpu_addrs[:2]]
    create_collective_group(ranks, 2, [0, 1], backend="nccl",
                            group_name="plane-gpu")
    outs = rt.get([r.op.remote("allreduce", x, group="plane-gpu")
                   for r, x in zip(ranks, xs)], timeout=120)
    for got, where, _ in outs:
        assert where == "cuda:0", where
        np.testing.assert_allclose(got, xs[0] + xs[1], rtol=1e-6, atol=1e-6)
    rt.get([r.destroy.remote("plane-gpu") for r in ranks], timeout=60)
    for r in ranks:
        rt.kill(r)
    log(f"[plane] (d) an NCCL plane over two GPU daemons on cards "
        f"{[d['cards'] for d in cluster.daemons if d['cards']]}: allreduce "
        f"matches numpy; ms {[round(ms, 3) for _, _, ms in outs]}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device
    card = card_line()
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    # 2. build
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    results = _build.build()
    for r in results.values():
        log(f"[build] {r.name}: {r.seconds:.1f} s -> {r.path.name}")
        for line in ptxas_summary(r.log):
            log(f"[build]   {line}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    check_kernel(fa, device)

    # 4. entry point
    from ray_tpu_torch.entry import CONFIG, entry
    fn, args = entry()
    before = fa.launches
    logits = fn(*args)
    torch.cuda.synchronize()
    assert logits.shape == (4, 512, CONFIG.vocab_size), logits.shape
    assert torch.isfinite(logits).all().item()
    assert fa.launches == before + CONFIG.n_layers
    log(f"[entry] flagship forward {tuple(logits.shape)} finite, "
        f"{CONFIG.n_layers} kernel launches")
    del fn, args, logits

    # 5. the serving path (the main path; launches counted here)
    served = serve_phase(fa, device)
    seconds = served["seconds"]
    log(f"[times] {card}: bf16 serving {N_REQUESTS / seconds:.2f} requests/s,"
        f" {served['n_tokens'] / seconds:.0f} tokens/s (median of "
        f"{SERVE_RUNS} runs of {N_REQUESTS} requests, {served['n_tokens']} "
        f"real tokens each, {seconds:.4f} s); one 8 x 1024 batch forward "
        f"{served['forward_ms']:.3f} ms")

    # 6. kernel times at the serving shape
    B, L, H = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1], SERVE_WIDTH["n_heads"]
    D, dt = SERVE_WIDTH["d_model"] // H, torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    q, k, v = random_qkv(gen, B, L, L, H, D, dt, device)
    o, _ = fa.flash_attention_fwd(q, k, v, True)
    ro, _ = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=TOL[dt],
                               atol=TOL[dt])
    max_abs_err = (o.float() - ro.float()).abs().max().item()
    del o, ro
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                       windows=5)
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bound_ms, bound_by = attention_bound(B, L, L, H, D, dt, True)
    log(f"[times] {card}: flash_attention_fwd B={B} L={L} H={H} D={D} bf16 "
        f"causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{served['n_layers']} launches = "
        f"{100 * served['n_layers'] * ms / served['forward_ms']:.1f}% of "
        f"the batch forward")
    del q, k, v, qt, kt, vt

    # 7. backward kernels against their plain versions
    check_backward(fa, device)

    # 8. f32 training through the kernels against dense attention
    parity = train_parity_phase(device)

    # 9. the training path (the kernels line's launches are counted here)
    trained = train_phase(fa, device)
    log(f"[times] {card}: bf16 training step {trained['step_ms']:.3f} ms "
        f"(median of {TRAIN_STEPS}), {trained['tokens_per_s']:.0f} tokens/s,"
        f" {trained['model_tflops']:.1f} model TFLOP/s (6 x params x tokens),"
        f" peak memory {trained['peak_bytes'] / 2**30:.2f} GiB")

    # 10. backward kernel times at the training shape
    bwd = backward_times(fa, device, B, L, H, D, dt)
    n, step_ms = trained["n_layers"], trained["step_ms"]
    parts = {"forward": 2 * n * ms, "dq": n * bwd["dq_ms"],
             "dkv": n * bwd["dkv_ms"]}
    share = sum(parts.values()) / step_ms
    split = ", ".join(f"{k} {v:.3f} ms ({100 * v / step_ms:.1f}%)"
                      for k, v in parts.items())
    log(f"[times] {card}: backward B={B} L={L} H={H} D={D} bf16 causal: "
        f"dq kernel {bwd['dq_ms']:.4f} ms (bound {bwd['dq_bound'][0]:.4f} "
        f"ms, {bwd['dq_bound'][1]}), dkv kernel {bwd['dkv_ms']:.4f} ms "
        f"(bound {bwd['dkv_bound'][0]:.4f} ms, {bwd['dkv_bound'][1]}), plain"
        f" backward {bwd['plain_ms']:.4f} ms, SDPA backward "
        f"{bwd['library_ms']:.4f} ms; per training step {2 * n} forward + "
        f"{n} dq + {n} dkv launches = {100 * share:.1f}% of the "
        f"{step_ms:.3f} ms step: {split}")

    # 11. ResNet, card against CPU in f32 (TF32 is off above)
    resnet_parity_phase(device)

    # 12. ResNet training at full width (the image path; no flash kernel)
    torch.backends.cudnn.benchmark = True   # the bench's setting
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    for name, batch in RESNET_TRAIN:
        r = resnet_train_phase(device, name, batch)
        mfu = "not known" if r["mfu_pct"] is None else f"{r['mfu_pct']:.2f}%"
        log(f"[times] {card}: {name} bf16 training step {r['step_ms']:.3f} "
            f"ms (median of {RESNET_STEPS}), {r['images_per_s']:.1f} "
            f"images/s, {r['model_tflops']:.1f} model TFLOP/s, MFU {mfu}, "
            f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB")
    assert launch_counts(fa) == (0, 0, 0), launch_counts(fa)
    torch.cuda.empty_cache()    # the bench's process needs the memory

    # 13. the port's bench, as a user runs it
    from ray_tpu_torch import bench
    head, lm = bench_phase()
    per_step = (2 * n, n, n)
    got = tuple(lm["launches"][k] for k in ("fwd", "dq", "dkv"))
    assert got == tuple(lm["steps_run"] * c for c in per_step), (got, lm)
    log(f"[bench] {card}: transformer section {lm['step_ms']:.3f} ms a step "
        f"(median of {lm['runs']} runs of {bench.TRANSFORMER_STEPS}), phase "
        f"9 {step_ms:.3f} ms; launches (forward, dq, dkv) {got} in "
        f"{lm['steps_run']} steps")
    log(json.dumps(head))

    # 14. the sharded step: dry run on every card, then a world of one
    torch.cuda.empty_cache()
    sharded = sharded_phase(fa, device, parity, step_ms)
    paired = {k: statistics.median(v) for k, v in sharded["paired"].items()}
    log(f"[times] {card}: bf16 training step, sharded path (world size 1) "
        f"{sharded['step_ms']:.3f} ms, one-device path (phase 9) "
        f"{step_ms:.3f} ms; in turns (median of {2 * STEP_PAIRS} each): "
        f"sharded {paired['sharded']:.3f} ms, one-device "
        f"{paired['one-device']:.3f} ms")

    # 15. the in-process runtime: device objects, the serving path from a
    # GPU actor (launches counted there), a GPU task
    torch.cuda.empty_cache()
    runtime = runtime_phase(fa, device, card, N_REQUESTS / seconds)

    # 16. the Serve plane: controller, replicas, router, handles and the
    # HTTP proxy (launches counted in each sub-phase)
    t0 = time.perf_counter()
    plane = serve_plane_phase(fa, device, card, N_REQUESTS / seconds,
                              runtime["actor_rps"])
    log(f"[serve-plane] phase 16 in {time.perf_counter() - t0:.1f} s")

    # 17. TorchTrainer: the training path from GPU train workers (launches
    # counted in each of (a)-(c))
    t0 = time.perf_counter()
    free_device_caches()
    trainer_launches, trainer_ms = trainer_phase(fa, device, card, step_ms,
                                                 parity)
    log(f"[trainer] phase 17 in {time.perf_counter() - t0:.1f} s")

    # 18. the multi-process runtime: the serving path from a GPU actor in a
    # daemon process (its launches counted in that process)
    t0 = time.perf_counter()
    free_device_caches()
    daemon_launches, daemon_rates = process_runtime_phase(fa, device, card, {
        "direct": N_REQUESTS / seconds, "actor": runtime["actor_rps"],
        "plane_threads": plane["threads"], "plane_single": plane["single"]})
    log(f"[process-runtime] phase 18 in {time.perf_counter() - t0:.1f} s")

    # 19. the tensor plane: TorchTrainer training in a GPU daemon, a Serve
    # replica there from its checkpoint (launches counted in the daemon),
    # and collective groups across daemon processes
    t0 = time.perf_counter()
    free_device_caches()
    plane_launches = tensor_plane_phase(fa, device, card, trained,
                                        trainer_ms, {
        "plane_threads": plane["threads"], "plane_single": plane["single"],
        "daemon_threads": daemon_rates[f"from {N_REQUESTS} threads"],
        "daemon_single": daemon_rates["from one thread"]})
    log(f"[plane] phase 19 in {time.perf_counter() - t0:.1f} s")

    fwd_launches, dq_launches, dkv_launches = (
        a + b + c for a, b, c in zip(trained["launches"], trainer_launches,
                                     plane_launches))
    fwd_launches += daemon_launches
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:45",
        "launches": fwd_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "flash_attention_dq",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:144",
        "launches": dq_launches,
        "max_abs_err": bwd["dq_err"],
        "ms": bwd["dq_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dq_bound"][0],
        "bound_by": bwd["dq_bound"][1],
        "library_ms": bwd["library_ms"],
    }, {
        "name": "flash_attention_dkv",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:190",
        "launches": dkv_launches,
        "max_abs_err": bwd["dkv_err"],
        "ms": bwd["dkv_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dkv_bound"][0],
        "bound_by": bwd["dkv_bound"][1],
        "library_ms": bwd["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
