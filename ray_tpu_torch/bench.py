"""The port's bench: ResNet-50 training throughput per card, with MFU.

Port of the repository's root ``bench.py`` to PyTorch on a CUDA card:

    python3 -m ray_tpu_torch.bench

It keeps that script's JSON-line contract: one progress line per section
as soon as the section ends, then one headline line with the same keys
(``metric: resnet50_train_images_per_sec_per_chip``, ``value``, ``unit``,
``vs_baseline``, ``mfu_pct``, ``device_kind``, ``peak_bf16_tflops``,
``backend_available``, ``probe_failed``, ``errors``, ``extras``), and exit 0
whatever failed. Sections:

- ``ppo``: PPO on CartPole at ``bench.py``'s schedule (8 envs x 100
  steps, train batch 800, minibatch 256, 8 SGD passes, lr 3e-4, seed 0):
  rollouts on the CPU, the learner on the card, in a subprocess as
  ``bench.py`` runs it; one warm-up iteration, then 3 timed ones, whose
  env-steps/s fill ``extras.ppo_env_steps_per_sec``;
- ``resnet50``: batch 128 x 224 x 224 x 3, bf16, SGD(0.1, momentum 0.9) on
  one seeded batch of images and labels;
- ``transformer``: the flagship decoder at ``bench.py``'s width (d_model
  1024, 12 layers, 16 heads, d_ff 4096, vocab 32000) with flash attention,
  so every step runs the forward, dq and dkv kernels; tokens 8 x 1025,
  ``make_lm_train_step`` with AdamW(1e-3, weight decay 1e-4);
- ``resnet18``: as ``resnet50`` at batch 256.

Timing is the counterpart of ``_timed_scan``: one warm-up run of the
section's steps (its seconds go into the progress line), then runs of the
same eager steps, each ending in ``torch.cuda.synchronize()``, until 0.5 s
or at least 2 runs (at most 20); the median run counts. FLOP counts are
``bench.py``'s: 3 x 4.09 / 1.82 GFLOP an image for ResNet-50 / -18 at 224,
and 6 x parameters x tokens for the transformer. MFU is against the card's
dense bf16 peak, looked up by ``torch.cuda.get_device_name()``; an unknown
card gets ``None``. Without a card (``torch.cuda.is_available()`` false) no
section runs: the headline has ``value: null``, ``backend_available:
false`` and ``probe_failed: true``.

The section functions take ``device=`` and keyword-only sizes (defaults:
the bench's), so that a test can run them tiny on the CPU.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import resnet, transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.train import adamw, make_lm_train_step, sgd

BASELINE_IMAGES_PER_SEC_PER_CHIP = 746.29 / 16  # T4, benchmarks.rst:171-174

MEASURE_STEPS = 20
TRANSFORMER_STEPS = 10
# The transformer of bench.py:141-145 (d_ff: the JAX config's 4 x d_model).
TRANSFORMER_WIDTH = dict(vocab_size=32000, d_model=1024, n_layers=12,
                         n_heads=16, d_ff=4096, max_seq_len=1024)
# Forward GFLOP an image at 224 x 224 (bench.py's analytic counts).
FORWARD_FLOPS_PER_IMAGE = {"resnet50": 4.09e9, "resnet18": 1.82e9}
# Dense bf16 peak FLOP/s by torch.cuda.get_device_name(): NVIDIA's H100
# SXM data sheet (at its 700 W limit).
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
# PPO at bench.py:188-195's schedule; 1 warm-up iteration, then 3 timed.
PPO_CONFIG = dict(num_envs_per_worker=8, rollout_fragment_length=100,
                  train_batch_size=800, sgd_minibatch_size=256,
                  num_sgd_iter=8, lr=3e-4)
PPO_TIMED_ITERS = 3
PPO_TIMEOUT_S = 600
REPO = pathlib.Path(__file__).resolve().parents[1]


def peak_bf16_flops(device_name: str) -> Optional[float]:
    """Dense bf16 FLOP/s of the named card, or ``None`` if not known."""
    return PEAK_BF16.get(device_name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_steps(step: Callable[[], object], n_steps: int,
                device: torch.device, min_measure_s: float = 0.5):
    """Run ``n_steps`` steps once to warm up, then in runs of ``n_steps``
    until ``min_measure_s`` of runs or at least 2 runs (at most 20), each
    run ending in a synchronise. Returns ``(median seconds a run, warm-up
    seconds, number of runs)``."""
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    _sync(device)
    warmup_s = time.perf_counter() - t0
    times = []
    while sum(times) < min_measure_s or len(times) < 2:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        _sync(device)
        times.append(time.perf_counter() - t0)
        if len(times) >= 20:
            break
    return statistics.median(times), warmup_s, len(times)


def resnet_train_step(cfg_name: str, *, batch: int, image_size: int = 224,
                      device: DeviceLike = None):
    """``(step, cfg, n_params)`` for bf16 training of ``resnet18`` or
    ``resnet50`` (1000 classes) with SGD(0.1, momentum 0.9) on one seeded
    batch of normal bf16 images and uniform labels. ``step()`` updates the
    parameters in place and returns the loss before the update."""
    device = resolve_device(device)
    cfg = getattr(resnet, cfg_name)(num_classes=1000)
    gen = torch.Generator(device=device).manual_seed(0)
    params = resnet.init_params(cfg, gen, device)
    leaves = resnet.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = sgd(0.1, momentum=0.9)(leaves)
    images = torch.randn((batch, image_size, image_size, 3), generator=gen,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=device)

    def step() -> torch.Tensor:
        loss = resnet.loss_fn(params, images, labels, cfg)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step, cfg, resnet.num_params(params)


def bench_resnet(cfg_name: str, *, batch: int, image_size: int = 224,
                 steps: int = MEASURE_STEPS,
                 device: DeviceLike = None) -> Dict[str, float]:
    """Images/s and achieved FLOP/s of ResNet training (``bench_resnet``).
    The FLOP count scales ``bench.py``'s 224 x 224 one by the image area."""
    device = resolve_device(device)
    step, _, _ = resnet_train_step(cfg_name, batch=batch,
                                   image_size=image_size, device=device)
    run_s, warmup_s, runs = timed_steps(step, steps, device)
    per_image = (3 * FORWARD_FLOPS_PER_IMAGE[cfg_name]
                 * (image_size / 224) ** 2)
    return {"images_per_sec": batch * steps / run_s,
            "flops_per_sec": per_image * batch * steps / run_s,
            "step_ms": 1e3 * run_s / steps, "warmup_s": warmup_s,
            "runs": runs}


def _launch_counts():
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    return {"fwd": fa.launches, "dq": fa.dq_launches,
            "dkv": fa.dkv_launches}


def bench_transformer(*, batch: int = 8, seq: int = 1024,
                      width: Optional[dict] = None,
                      steps: int = TRANSFORMER_STEPS,
                      device: DeviceLike = None) -> Dict[str, object]:
    """Tokens/s and achieved FLOP/s of a decoder-LM train step on the
    flagship transformer (``bench_transformer``), bf16, flash attention.
    ``launches`` counts the attention kernels over the section's
    ``steps_run`` steps (warm-up included); the CPU launches none."""
    device = resolve_device(device)
    cfg = TransformerConfig(**(width or TRANSFORMER_WIDTH),
                            dtype=torch.bfloat16, use_flash=True)
    init_fn, step_fn, shard_batch = make_lm_train_step(
        cfg, optimizer=adamw(1e-3, weight_decay=1e-4), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_fn(gen)
    n_params = transformer.num_params(state[0])
    tokens = shard_batch(torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                       generator=gen, device=device))
    box = [state]

    def step():
        box[0], _ = step_fn(box[0], tokens)

    before = _launch_counts()
    run_s, warmup_s, runs = timed_steps(step, steps, device)
    after = _launch_counts()
    return {"tokens_per_sec": batch * seq * steps / run_s,
            "flops_per_sec": 6.0 * n_params * batch * seq * steps / run_s,
            "params": n_params, "step_ms": 1e3 * run_s / steps,
            "warmup_s": warmup_s, "runs": runs,
            "steps_run": steps * (runs + 1),
            "launches": {k: after[k] - before[k] for k in after}}


def ppo_env_steps(device: DeviceLike = None, *,
                  timed_iters: int = PPO_TIMED_ITERS) -> Dict[str, object]:
    """PPO's env-steps/s in this process: ``PPO_CONFIG`` on CartPole-v1,
    the learner on ``device``, one warm-up iteration (``algo.step()``, as
    ``bench.py``), then ``timed_iters`` timed ones on the host clock. The
    learner reads its metrics back to the host every iteration, so each
    timed iteration ends with its device work."""
    from ray_tpu_torch.rl import PPO
    device = resolve_device(device)
    c = PPO_CONFIG
    algo = (PPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0,
                      num_envs_per_worker=c["num_envs_per_worker"],
                      rollout_fragment_length=c["rollout_fragment_length"])
            .training(train_batch_size=c["train_batch_size"],
                      sgd_minibatch_size=c["sgd_minibatch_size"],
                      num_sgd_iter=c["num_sgd_iter"], lr=c["lr"])
            .resources(device=str(device))
            .debugging(seed=0)
            .build())
    try:
        t0 = time.perf_counter()
        algo.step()
        warmup_s = time.perf_counter() - t0
        steps = 0
        t0 = time.perf_counter()
        for _ in range(timed_iters):
            steps += algo.step().get("timesteps_this_iter", 0)
        seconds = time.perf_counter() - t0
    finally:
        algo.stop()
        shutil.rmtree(algo.logdir, ignore_errors=True)
    return {"env_steps_per_sec": steps / seconds, "env_steps": steps,
            "seconds": seconds, "warmup_s": warmup_s,
            "learner_device": str(algo.learner.device)}


def bench_ppo(device: DeviceLike = None, *,
              timed_iters: int = PPO_TIMED_ITERS,
              timeout_s: float = PPO_TIMEOUT_S) -> Dict[str, object]:
    """``ppo_env_steps`` in a subprocess (``bench.py`` runs its PPO section
    in one): the card's context and the learner's allocations end with it.
    """
    device = resolve_device(device)
    code = ("import json, sys\n"
            "from ray_tpu_torch.bench import ppo_env_steps\n"
            "out = ppo_env_steps(sys.argv[1], timed_iters=int(sys.argv[2]))\n"
            "print('PPO_RESULT', json.dumps(out), flush=True)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(device), str(timed_iters)],
        cwd=REPO, capture_output=True, text=True, timeout=timeout_s)
    for line in proc.stdout.splitlines():
        if line.startswith("PPO_RESULT "):
            return json.loads(line[len("PPO_RESULT "):])
    raise RuntimeError(f"ppo bench failed (exit {proc.returncode}): "
                       f"{proc.stderr[-600:]}")


def _emit(obj) -> None:
    """Progress line: flushed immediately so a crash later loses nothing."""
    print(json.dumps(obj), flush=True)


def _section(name: str, fn: Callable[[], dict], errors: dict):
    """Run one section; emit its result, or record and emit its failure."""
    t0 = time.perf_counter()
    value = error = None
    try:
        value = fn()
    except Exception as exc:  # noqa: BLE001 - partial success by design
        traceback.print_exc()
        error = errors[name] = f"{type(exc).__name__}: {exc}"
    line = {"metric": f"section_{name}", "unit": "progress",
            "value": None if error else "ok", "error": error,
            "elapsed_s": round(time.perf_counter() - t0, 1)}
    line.update(value or {})
    _emit(line)
    return value


def headline(r50=None, lm=None, r18=None, kind="", peak=None,
             backend_ok=False, errors=None, ppo=None) -> dict:
    """The final line, with exactly ``bench.py``'s keys."""
    def mfu(section):
        if peak is None or section is None:
            return None
        return round(100.0 * section["flops_per_sec"] / peak, 2)

    def rounded(section, key):
        return None if section is None else round(section[key], 2)

    r50_ips = rounded(r50, "images_per_sec")
    return {
        "metric": "resnet50_train_images_per_sec_per_chip",
        "value": r50_ips,
        "unit": "images/sec",
        "vs_baseline": (None if r50_ips is None else
                        round(r50_ips / BASELINE_IMAGES_PER_SEC_PER_CHIP, 2)),
        "mfu_pct": mfu(r50),
        "device_kind": kind,
        "peak_bf16_tflops": None if peak is None else round(peak / 1e12, 1),
        "backend_available": backend_ok,
        "probe_failed": not backend_ok,
        "errors": errors or None,
        "extras": {
            "resnet18_images_per_sec": rounded(r18, "images_per_sec"),
            "transformer_tokens_per_sec": rounded(lm, "tokens_per_sec"),
            "transformer_mfu_pct": mfu(lm),
            "transformer_params_m": (None if lm is None else
                                     round(lm["params"] / 1e6, 1)),
            "ppo_env_steps_per_sec": rounded(ppo, "env_steps_per_sec"),
        },
    }


def main() -> None:
    errors: dict = {}
    backend_ok = torch.cuda.is_available()
    kind, peak = "", None
    r50 = lm = r18 = ppo = None
    if not backend_ok:
        _emit({"metric": "backend_probe_failed", "unit": "error",
               "value": "torch.cuda.is_available() is false"})
    else:
        torch.backends.cudnn.benchmark = True  # XLA autotunes its convs too
        kind = torch.cuda.get_device_name(0)
        peak = peak_bf16_flops(kind)
        ppo = _section("ppo", bench_ppo, errors)
        r50 = _section("resnet50",
                       lambda: bench_resnet("resnet50", batch=128), errors)
        lm = _section("transformer", bench_transformer, errors)
        r18 = _section("resnet18",
                       lambda: bench_resnet("resnet18", batch=256), errors)
    _emit(headline(r50, lm, r18, kind, peak, backend_ok, errors, ppo))


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # noqa: BLE001 - the last line is the result
        traceback.print_exc()
        _emit(headline(errors={"harness": f"{type(exc).__name__}: {exc}"}))
    sys.exit(0)
