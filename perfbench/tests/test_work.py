"""The work arithmetic against hand counts, and the rooflines' count
against the kernel-name patterns."""

import re

import pytest

from perfbench.core import readers, trace, work
from perfbench.core.model import Dims

M = Dims(vocab=10, d=16, layers=3, heads=2, kv_heads=1, ff=24, theta=1e4,
         eps=1e-6)   # head_dim 8


def test_kept_pairs_against_a_count():
    for lq in range(1, 9):
        for lk in range(1, 9):
            want = sum(1 for r in range(lq) for c in range(lk) if c <= r)
            assert work.kept_pairs(lq, lk) == want


def test_attention_work_by_hand():
    # B=1, L=4: 10 kept pairs; q and O 64 elements, K and V 32 each.
    flops, nbytes = work.attn_fwd_work(1, 4, M)
    assert flops == 2 * 2 * 10 * 8 * 2       # two dots, 2 heads
    assert nbytes == 2 * (64 + 32 + 32 + 64) + 4 * 2 * 4
    flops, nbytes = work.attn_bwd_work(1, 4, M)
    assert flops == 5 * 2 * 10 * 8 * 2      # five dots
    # read Q, K, V, O, dO and the LSE; write dQ, dK, dV
    assert nbytes == 2 * (64 + 32 + 32 + 64 + 64) + 4 * 2 * 4 + \
        2 * (64 + 32 + 32)


def test_model_flops_by_hand():
    block = 16 * 16 + 2 * 16 * 8 + 16 * 16 + 3 * 16 * 24
    assert work.block_params(M) == block
    assert work.matmul_params(M) == 3 * block + 16 * 10
    attn = 3 * work.attn_fwd_work(2, 5, M)[0]
    assert work.train_step_flops(M, 2, 5) == \
        6 * (3 * block + 160) * 10 + 3 * attn
    assert work.serve_request_flops(M, 5) == \
        2 * 3 * block * 5 + 3 * work.attn_fwd_work(1, 5, M)[0] + 2 * 160
    assert work.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.mfu_pct(989e12, 2.0) == pytest.approx(50.0)


def _record():
    ops = [("_Z15fwd_bf16_kernelILi128EEv6Params", 100, 300),
           ("_Z14dq_bf16_kernelILi128EEv6Params", 300, 400),
           ("_Z10new_kernelv", 400, 500),
           ("void at::native::elementwise_kernel<x>(int)", 500, 900),
           ("_Z15fwd_bf16_kernelILi128EEv6Params", 2000, 2100)]
    units = [{"t0": 0, "t1": 1000, "attn_fwd": [[2, 64, 3]],
              "attn_bwd": [[2, 64, 3]]}]
    return {"kind": "train", "dims": M,
            "trace": {"ops": ops, "units": units, "window_s": 1e-6,
                      "busy_s": 8e-7}}


def test_roofline_count_does_not_follow_the_patterns():
    rec = _record()
    least = readers.least_seconds(rec, "attn_fwd")
    assert least == pytest.approx(
        3 * work.least_seconds(*work.attn_fwd_work(2, 64, M)))
    own = readers.roofline_pct(rec, "attn_fwd")
    assert own == pytest.approx(100 * least / 200e-9)  # the op past t1 is out
    both = readers.roofline_pct(
        rec, "attn_fwd", [re.compile("fwd_bf16_kernel"),
                          re.compile("new_kernel")])
    assert both == pytest.approx(100 * least / 300e-9)
    assert readers.least_seconds(rec, "attn_fwd") == least
    assert readers.roofline_pct(rec, "attn_fwd", [re.compile("nothing")]) \
        is None


def test_patterns_name_the_port_kernels_only():
    fwd = readers.spec.kernel_patterns("attn_fwd")
    bwd = readers.spec.kernel_patterns("attn_bwd")
    hit = lambda ps, n: any(p.search(n) for p in ps)  # noqa: E731
    assert hit(fwd, "_Z15fwd_bf16_kernelILi128EEv6Params")
    assert hit(fwd, "_Z10fwd_kernelILi64EEv6Params")
    assert not hit(fwd, "_Z14dq_bf16_kernelILi128EEv6Params")
    assert not hit(fwd, "void flash_fwd_kernel<x>()")
    assert hit(bwd, "_Z15dkv_bf16_kernelILi128EEv6Params")
    assert hit(bwd, "_Z9dq_kernelILi64EEv6Params")
    assert not hit(bwd, "_Z15fwd_bf16_kernelILi128EEv6Params")


def test_trace_reduction():
    rec = _record()
    ops = rec["trace"]["ops"]
    assert trace.busy_ns(ops) == 800 + 100
    gaps = trace.idle_gaps(ops, 0, 2200, [("step", 0, 1000),
                                          ("report", 900, 2000)])
    assert gaps[0] == ["report", pytest.approx(1100e-9)]
    assert gaps[1] == ["step", pytest.approx(100e-9)]
    top = trace.top_ops(ops)
    assert top[0] == ["at::native::elementwise_kernel<x>",
                      pytest.approx(400e-9)]
    assert readers.idle_pct(rec) == pytest.approx(20.0)
