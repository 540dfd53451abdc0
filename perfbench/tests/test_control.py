"""The control comes out not correct: the reference computed in fp8 (the
precision below the cells' bf16), put in the program's place, judged by
the cells' limits. On the CPU at a tiny width (the tiny cells' limits); on a
card at the cell's own size (``cuda``; ``perfbench/calibrate.py`` reads it on
many seeds)."""

import pytest
import torch

from perfbench import harness
from perfbench.core import compare, spec
from perfbench.tests import tiny
from perfbench.traffic import serve, train


def _train_control(ctx, limits):
    ref = train.reference(ctx)
    numbers = compare.train_numbers(train.reference(ctx, "fp8"), ref)
    return compare.judge(numbers, limits)


def _serve_control(ctx, limits, n):
    _, reqs = serve.requests(ctx.traffic, 60.0, ctx.seed, ctx.dims.vocab)
    prompts = sorted((r["tokens"] for r in reqs), key=len)[-n:]
    ref = serve.reference_logits(ctx, prompts)
    numbers = compare.serve_numbers(
        serve.reference_logits(ctx, prompts, "fp8"), ref, 0)
    return compare.judge(numbers, limits)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_at_a_tiny_width(tmp_path, seed):
    base = tiny.make_base(tmp_path)
    cpu = torch.device("cpu")
    ctx = harness.make_ctx("tiny.train", seed, 0, False, cpu, 0.0, base)
    correct, checks = _train_control(ctx, spec.workload("tiny.train", base)
                                     ["check"])
    assert not correct, checks
    ctx = harness.make_ctx("tiny.serve", seed, 0, False, cpu, 0.0, base)
    correct, checks = _serve_control(ctx, spec.workload("tiny.serve", base)
                                     ["check"], 4)
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["deepseek7b.train.s4k",
                                  "mistral7b.serve.poisson",
                                  "mistral7b.train.s16k"])
def test_control_fails_at_the_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    ctx = harness.make_ctx(cell, 77, 0, False, torch.device("cuda", 0), 0.0)
    limits = spec.workload(cell)["check"]
    if ctx.traffic["kind"] == "train":
        correct, checks = _train_control(ctx, limits)
    else:
        correct, checks = _serve_control(ctx, limits, 4)
    assert not correct, checks
