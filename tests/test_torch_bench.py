"""The port's bench (``python -m ray_tpu_torch.bench``) on a machine without
a card: its sections run tiny on the CPU when asked to, and the module run
as a user runs it keeps the root ``bench.py``'s headline contract."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch import bench

REPO = pathlib.Path(__file__).resolve().parents[1]
# The keys of bench.py's headline (bench.py:371-395).
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu_pct",
                 "device_kind", "peak_bf16_tflops", "backend_available",
                 "probe_failed", "errors", "extras"}
EXTRAS_KEYS = {"resnet18_images_per_sec", "transformer_tokens_per_sec",
               "transformer_mfu_pct", "transformer_params_m",
               "ppo_env_steps_per_sec"}
TINY_LM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
               max_seq_len=32)


@pytest.mark.parametrize("name", ("resnet18", "resnet50"))
def test_resnet_section_runs_tiny_on_cpu(name):
    out = bench.bench_resnet(name, batch=2, image_size=32, steps=1,
                             device="cpu")
    assert 2 <= out["runs"] <= 20
    assert out["images_per_sec"] > 0 and out["flops_per_sec"] > 0
    assert out["step_ms"] > 0 and out["warmup_s"] > 0
    # bench.py's count, scaled to the image area.
    per_image = out["flops_per_sec"] / out["images_per_sec"]
    want = 3 * bench.FORWARD_FLOPS_PER_IMAGE[name] * (32 / 224) ** 2
    assert per_image == pytest.approx(want)


def test_transformer_section_runs_tiny_on_cpu():
    out = bench.bench_transformer(batch=2, seq=16, width=TINY_LM, steps=1,
                                  device="cpu")
    assert out["tokens_per_sec"] > 0 and out["flops_per_sec"] > 0
    assert out["flops_per_sec"] == pytest.approx(
        6.0 * out["params"] * out["tokens_per_sec"])
    assert out["steps_run"] == 1 * (out["runs"] + 1)
    # Kernel wrappers take their plain versions on CPU tensors.
    assert out["launches"] == {"fwd": 0, "dq": 0, "dkv": 0}


def test_resnet_train_step_lowers_the_loss():
    step, cfg, n_params = bench.resnet_train_step(
        "resnet18", batch=4, image_size=32, device="cpu")
    assert cfg.dtype == torch.bfloat16 and cfg.num_classes == 1000
    assert 11e6 < n_params < 12e6
    first, second = step().item(), step().item()
    assert second < first


def test_timed_steps_warms_up_then_takes_the_median_run():
    calls = []
    median_s, warmup_s, runs = bench.timed_steps(
        lambda: calls.append(1), 3, torch.device("cpu"), min_measure_s=0.0)
    assert runs == 2 and len(calls) == 3 * (1 + runs)
    assert median_s >= 0 and warmup_s >= 0


def test_peak_lookup():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.peak_bf16_flops("NVIDIA A100-SXM4-80GB") is None
    assert bench.peak_bf16_flops("") is None


def test_sections_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_resnet("resnet18", batch=2)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_transformer()
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_ppo()


def test_bench_without_a_card_prints_the_headline():
    """Run as a user runs it: exit 0 and a last line with exactly bench.py's
    keys that says the card is missing. No section runs on the CPU, ``ppo``
    included: its learner is on the card."""
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    head = lines[-1]
    assert set(head) == HEADLINE_KEYS
    assert set(head["extras"]) == EXTRAS_KEYS
    assert head["metric"] == "resnet50_train_images_per_sec_per_chip"
    assert head["value"] is None and head["mfu_pct"] is None
    assert head["backend_available"] is False and head["probe_failed"] is True
    assert all(v is None for v in head["extras"].values())
    assert head["errors"] is None
    sections = [d["metric"] for d in lines if d.get("unit") == "progress"]
    assert sections == []


def test_headline_figures():
    r50 = {"images_per_sec": 2000.0, "flops_per_sec": 2000.0 * 12.27e9}
    lm = {"tokens_per_sec": 80000.0, "flops_per_sec": 1.3e14,
          "params": 266_900_000}
    r18 = {"images_per_sec": 6000.0}
    ppo = {"env_steps_per_sec": 1234.567}
    head = bench.headline(r50, lm, r18, "NVIDIA H100 80GB HBM3", 989e12,
                          True, {"x": "y"}, ppo)
    assert set(head) == HEADLINE_KEYS
    assert head["value"] == 2000.0
    assert head["vs_baseline"] == round(2000.0 / (746.29 / 16), 2)
    assert head["mfu_pct"] == round(100 * 2000.0 * 12.27e9 / 989e12, 2)
    assert head["peak_bf16_tflops"] == 989.0
    assert head["extras"]["transformer_params_m"] == 266.9
    assert head["extras"]["transformer_mfu_pct"] == round(
        100 * 1.3e14 / 989e12, 2)
    assert head["extras"]["ppo_env_steps_per_sec"] == 1234.57
    assert head["probe_failed"] is False
