"""Entry points: the flagship forward on one card, and the multi-device
dry run.

``entry()`` is the counterpart of ``__graft_entry__.entry``: the same
transformer configuration (vocab 32000, d_model 512, 8 layers, 8 heads,
bf16, flash attention) and tokens of shape (4, 512).

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: on ``n`` ranks it runs one full
training step (forward, backward, AdamW) with dp/tp/pp composed as
``_mesh_plan`` factors ``n``, a second step with sequence parallelism (ring
attention) when ``n`` is a multiple of 4, and the gradient of an
expert-parallel MoE (``all_to_all``) when ``n`` >= 2. It runs on ``n``
cards over NCCL, or on ``n`` CPU processes over gloo when the caller asks
for ``device="cpu"``; with fewer cards than ``n`` it raises (the reference
falls back to a virtual CPU mesh; the port does not).

Weights and tokens are random, drawn from seeded ``torch.Generator``s.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    vocab_size=32000, d_model=512, n_layers=8, n_heads=8, max_seq_len=1024,
    dtype=torch.bfloat16, use_flash=True)


def entry(device: DeviceLike = None):
    """(fn, example_args): the flagship forward ``fn(params, tokens)``."""
    device = resolve_device(device)
    cfg = CONFIG
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)

    def fn(params, tokens):
        with torch.inference_mode():
            return transformer.apply(params, tokens, cfg)

    return fn, (params, tokens)


def _mesh_plan(n: int) -> Dict[str, int]:
    """Factor n into (pipe, data, tensor) preferring all three > 1."""
    plans = {
        1: dict(data=1),
        2: dict(data=2),
        4: dict(data=2, tensor=2),
        8: dict(pipe=2, data=2, tensor=2),
        16: dict(pipe=2, data=2, fsdp=2, tensor=2),
        32: dict(pipe=2, data=2, fsdp=2, tensor=4),
    }
    if n in plans:
        return plans[n]
    # fallback: all data-parallel
    return dict(data=n)


# The dry run's model (``__graft_entry__._dryrun_body``): small, f32, dense
# attention, no remat.
DRYRUN_CONFIG = TransformerConfig(
    vocab_size=512, d_model=128, n_layers=4, n_heads=4, max_seq_len=128,
    dtype=torch.float32, use_flash=False, remat=False)


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     timeout_s: float = 600.0) -> Dict[str, float]:
    """Run the multi-device dry run on ``n_devices`` new ranks (see the
    module note); prints its lines and returns rank 0's losses."""
    from ray_tpu_torch.parallel import run_spmd
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on cuda needs {n_devices} cards, "
            f"this process sees {torch.cuda.device_count()}; pass "
            "device='cpu' to run it over CPU processes")
    return run_spmd(_dryrun_body, n_devices, device, timeout_s,
                    args=(n_devices, device.type))


def _dryrun_body(n_devices: int, device_type: str) -> Dict[str, float]:
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, moe_apply
    from ray_tpu_torch.train import adamw, make_lm_train_step
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    device = resolve_device(device_type)
    rank = dist.get_rank()
    out: Dict[str, float] = {}

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    def train_step(mesh, init_seed, tokens_seed, batch, num_microbatches=4):
        cfg = DRYRUN_CONFIG
        init_fn, step_fn, shard_batch = make_lm_train_step(
            cfg, mesh, optimizer=adamw(1e-3, weight_decay=1e-4),
            num_microbatches=num_microbatches, device=device)
        state = init_fn(torch.Generator().manual_seed(init_seed))
        tokens = shard_batch(torch.randint(
            0, cfg.vocab_size, batch,
            generator=torch.Generator().manual_seed(tokens_seed)))
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        return loss

    # ---- main step: dp × tp × pp (fsdp joins at n>=16) ---------------------
    mesh = build_mesh(MeshConfig(**_mesh_plan(n_devices)), device)
    out["main"] = train_step(mesh, 0, 1, (8, 65), num_microbatches=2)
    log(f"[dryrun] mesh={mesh.shape} train step OK, loss={out['main']:.4f}")

    # ---- second step: sequence parallel (ring attention) -------------------
    if n_devices >= 4 and n_devices % 4 == 0:
        mesh_sp = build_mesh(MeshConfig(data=n_devices // 4, seq=4), device)
        out["seq"] = train_step(mesh_sp, 2, 3, (4, 65))
        log(f"[dryrun] mesh={mesh_sp.shape} seq-parallel step OK, "
            f"loss={out['seq']:.4f}")

    # ---- third step: expert parallel (MoE all_to_all) ----------------------
    if n_devices >= 2:
        ep = min(4, n_devices)
        mesh_ep = build_mesh(MeshConfig(data=1, expert=ep), device,
                             ranks=range(ep))
        if rank < ep:
            dm = mesh_ep.device_mesh
            rep = [Replicate()] * len(mesh_ep.axis_names)
            by_expert = list(rep)
            by_expert[mesh_ep.dim("expert")] = Shard(0)

            def draw(seed, shape, scale=1.0):
                return torch.randn(shape, generator=torch.Generator(
                    ).manual_seed(seed)).to(device) * scale

            router = distribute_tensor(draw(4, (16, ep)), dm, rep)
            w = distribute_tensor(draw(5, (ep, 16, 16), 0.1), dm, by_expert)
            x = distribute_tensor(draw(6, (64, 16)), dm, rep)
            router.requires_grad_(True)
            w.requires_grad_(True)
            # raylint: allow(collective-divergence) the MoE's all_to_all runs over mesh_ep's groups, whose members are exactly the ranks < ep
            y = moe_apply(x, router, {"w": w},
                          lambda p, t: torch.tanh(t @ p["w"]), mesh_ep,
                          capacity_factor=2.0)
            loss = torch.mean(y.to_local() ** 2)
            grads = torch.autograd.grad(loss, (router, w))
            if not (math.isfinite(loss.item()) and all(
                    torch.isfinite(g.to_local()).all().item()
                    for g in grads)):
                raise RuntimeError("non-finite expert-parallel loss or grad")
            out["moe"] = loss.item()
            log(f"[dryrun] mesh={mesh_ep.shape} expert-parallel grad OK")

    log("[dryrun] all multichip paths executed")
    return out
