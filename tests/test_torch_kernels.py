"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit, and skips without
them. This file imports neither jax nor ray_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, B, Lq, Lk, H, D, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal((B, L, H, D),
                                                  dtype=np.float32),
                              device=device).to(dtype)
                 for L in (Lq, Lk, Lk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_matches_plain(causal, D, dtype, tol):
    """Ragged Lq and Lk that differ: masking of pad rows and columns and the
    top-left causal alignment."""
    device = _cuda_or_skip()
    q, k, v = _qkv(0, 2, 200, 333, 2, D, dtype, device)
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    assert fa.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_fwd_kernel_takes_strided_views():
    """q, k, v as views into one packed [B, L, 3, H, D] tensor."""
    device = _cuda_or_skip()
    packed = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 160, 3, 4, 64), dtype=np.float32), device=device)
    q, k, v = packed.unbind(2)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(out, ref_out, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-5, atol=2e-5)


def _do(seed, q):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(tuple(q.shape), dtype=np.float32),
                        device=q.device).to(q.dtype)


def _assert_grads_close(got, want, dtype):
    """f32 at 2e-4, the reference's grad tolerance. bf16 at 1e-2 of the
    largest |grad|: kernel and plain version compute in f32 from the same
    bf16 inputs and round once to bf16, so they differ by about one bf16
    step (2^-7 relative) of the largest value, plus f32 summation order."""
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        if dtype == torch.float32:
            tol = dict(rtol=2e-4, atol=2e-4)
        else:
            tol = dict(rtol=1e-2, atol=1e-2 * w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_plain(causal, D, dtype):
    """dq and dkv kernels against the plain backward, ragged Lq < Lk: under
    the causal mask K rows >= Lq see no query, and their dK and dV must be
    written as exact zeros."""
    device = _cuda_or_skip()
    q, k, v = _qkv(3, 2, 200, 333, 2, D, dtype, device)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    do = _do(4, q)
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    _assert_grads_close(got, want, dtype)
    if causal:
        assert not got[1][:, 200:].any() and not got[2][:, 200:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Lq,Lk", [(384, 128), (1024, 1024)])
def test_flash_bwd_kernels_other_lengths(Lq, Lk, dtype):
    """Query rows past Lk (every dq row past 128 sums all of K) and the
    diagonal of a full 1024 x 1024 causal square."""
    device = _cuda_or_skip()
    q, k, v = _qkv(5, 1, Lq, Lk, 2, 64, dtype, device)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    do = _do(6, q)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    _assert_grads_close(got, want, dtype)


@pytest.mark.cuda
def test_flash_bwd_kernels_bf16_head_dim_128():
    """bf16 at head_dim 128 over full-length causal rows: the instantiation
    whose dQ accumulator takes the most registers (32-row K/V tiles)."""
    device = _cuda_or_skip()
    q, k, v = _qkv(16, 2, 1024, 1024, 4, 128, torch.bfloat16, device)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    do = _do(17, q)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    _assert_grads_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_flash_bwd_takes_do_strided_in_d():
    """A dO that is not contiguous in D is made contiguous, explicitly."""
    device = _cuda_or_skip()
    q, k, v = _qkv(7, 1, 96, 96, 2, 32, torch.float32, device)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    do = _do(8, q.transpose(-1, -2).contiguous()).transpose(-1, -2)
    assert do.stride(-1) != 1
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                            do.contiguous(), True)
    _assert_grads_close(got, want, torch.float32)


@pytest.mark.cuda
def test_flash_kernel_gradient_runs_through_the_kernels():
    """A CUDA gradient goes through ``_FlashAttention``: one forward launch,
    then one dq and one dkv launch in the backward, with autograd's grads of
    the plain forward as the answer."""
    device = _cuda_or_skip()
    q, k, v = (t.requires_grad_() for t in
               _qkv(2, 1, 64, 64, 1, 64, torch.float32, device))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    do = _do(9, q)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref, _ = fa.flash_attention_reference(q, k, v)
    want = torch.autograd.grad(ref, (q, k, v), do)
    _assert_grads_close(got, want, torch.float32)


def _packed_bf16(seed, B, L, H, D, device):
    """q, k, v as views into one packed [B, L, 3, H, D] bf16 tensor."""
    packed = torch.tensor(np.random.default_rng(seed).standard_normal(
        (B, L, 3, H, D), dtype=np.float32), device=device).bfloat16()
    return packed.unbind(2)


@pytest.mark.cuda
def test_flash_fwd_kernel_takes_strided_bf16_views():
    """The tensor-core forward on q, k, v unbound from one packed tensor:
    16-byte aligned, row strides of 3 * H * D elements."""
    device = _cuda_or_skip()
    q, k, v = _packed_bf16(10, 2, 160, 4, 64, device)
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_bwd_kernels_take_strided_bf16_views():
    device = _cuda_or_skip()
    q, k, v = _packed_bf16(11, 2, 160, 4, 64, device)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    do = _do(12, q)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    _assert_grads_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_kernels_at_the_timing_shape(which):
    """bf16 at the shape chip_smoke.py times (B 8, L 1024, H 16, D 64,
    causal): every diagonal tile across 2048 blocks."""
    device = _cuda_or_skip()
    q, k, v = _qkv(13, 8, 1024, 1024, 16, 64, torch.bfloat16, device)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    if which == "fwd":
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, True)
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(lse, ref_lse, rtol=2e-2, atol=2e-2)
        return
    do = _do(14, q)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    _assert_grads_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_flash_kernel_rejects_misaligned_bf16():
    """A bf16 input whose base pointer is off the 16-byte grid raises before
    any launch; so does a row stride that is not a multiple of 8."""
    device = _cuda_or_skip()
    q, k, v = _qkv(15, 1, 64, 64, 2, 64, torch.bfloat16, device)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=device)
    shifted = flat[1:].view(q.shape)
    assert shifted.data_ptr() % 16 != 0
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd(shifted, k, v, True)
    odd = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16,
                      device=device)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd(odd, k, v, True)
    assert fa.launches == before
