"""Port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch versions and the JAX
kernels run in interpret mode, as ``tests/test_ops.py`` runs them; the same
numpy inputs go through both. The cases mirror ``tests/test_ops.py`` at its
tolerances (2e-5 forward, 2e-4 gradients, 2e-2 for bf16). Gradients go
through the port's ``_FlashAttention`` against the JAX custom VJP. The CUDA
kernels themselves are held against the plain versions in
``tests/test_torch_kernels.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash_attention
from ray_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
from ray_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                               flash_attention_bwd_reference,
                               flash_attention_fwd, flash_attention_reference)

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")


def _qkv(seed, B, Lq, H, D, Lk=None):
    rng = np.random.default_rng(seed)
    Lk = Lq if Lk is None else Lk
    return (rng.standard_normal((B, Lq, H, D), dtype=np.float32),
            rng.standard_normal((B, Lk, H, D), dtype=np.float32),
            rng.standard_normal((B, Lk, H, D), dtype=np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    return flash_attention(*(torch.tensor(x).to(dtype) for x in (q, k, v)),
                           causal=causal)


def _jax(q, k, v, causal, dtype=jnp.float32):
    return jax_flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                               causal=causal, block_q=128, block_k=128)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_forward(causal):
    q, k, v = _qkv(0, 2, 256, 2, 64)
    np.testing.assert_allclose(_port(q, k, v, causal).numpy(),
                               np.asarray(_jax(q, k, v, causal)),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_multi_block_seq():
    q, k, v = _qkv(3, 1, 512, 1, 64)
    np.testing.assert_allclose(_port(q, k, v, True).numpy(),
                               np.asarray(_jax(q, k, v, True)),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    q, k, v = _qkv(2, 2, 128, 2, 64)
    out = _port(q, k, v, True, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = _jax(q, k, v, True, jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_seqlen(causal):
    """Seqlen not divisible by the block size: pad columns must not leak."""
    q, k, v = _qkv(4, 1, 200, 2, 32)
    np.testing.assert_allclose(_port(q, k, v, causal).numpy(),
                               np.asarray(_jax(q, k, v, causal)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 256, 2, 64), (1, 200, 200, 2, 32),
                                   (1, 128, 256, 1, 16),
                                   (1, 256, 128, 2, 16)])
def test_flash_attention_lse_matches_pallas(shape, causal):
    """O and LSE against ``_flash_fwd`` in interpret mode, Lq != Lk included
    (the causal mask is top-left: row >= col)."""
    B, Lq, Lk, H, D = shape
    q, k, v = _qkv(5, B, Lq, H, D, Lk)
    out, lse = flash_attention_fwd(*(torch.tensor(x) for x in (q, k, v)),
                                   causal=causal)
    assert lse.shape == (B, H, Lq) and lse.dtype == torch.float32

    def bhld(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            B * H, x.shape[1], D)

    ref_out, ref_lse = _flash_fwd(bhld(q), bhld(k), bhld(v), 1.0 / np.sqrt(D),
                                  causal, 128, 128, True)
    ref_out = np.asarray(ref_out).reshape(B, H, Lq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.reshape(B * H, Lq).numpy(),
                               np.asarray(ref_lse), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.tensor(x) for x in _qkv(6, 1, 64, 2, 48))
    before = fa.launches
    out, lse = flash_attention_fwd(q, k, v, causal=True, scale=0.3)
    ref_out, ref_lse = flash_attention_reference(q, k, v, True, 0.3)
    assert fa.launches == before  # only a kernel launch counts
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)


def test_plain_version_is_differentiable_on_cpu():
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(7, 1, 32, 1, 16))
    flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.tensor(x) for x in _qkv(8, 1, 16, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1], v)                 # heads differ
    with pytest.raises(ValueError):
        flash_attention(q, k, v.double())                  # dtypes differ
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])                  # not 4-D
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(*meta)


def test_kernel_input_checks():
    """What the CUDA kernel does not take raises before any launch."""
    q, k, v = (torch.tensor(x) for x in _qkv(9, 1, 16, 2, 64))
    fa._check_kernel_inputs(q, k, v)
    fa._check_kernel_inputs(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError):
        fa._check_kernel_inputs(q.half(), k.half(), v.half())
    q48, k48, v48 = (torch.tensor(x) for x in _qkv(9, 1, 16, 2, 48))
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_kernel_inputs(q48, k48, v48)
    strided = torch.zeros(1, 16, 2, 128)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_kernel_inputs(strided, k, v)
    # Inputs that need a gradient are taken: the backward kernels exist.
    fa._check_kernel_inputs(q.requires_grad_(), k, v)


def _port_grads(q, k, v, causal):
    """Grads of sum(out**2) through the port's Function."""
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*ts, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    return [g.numpy() for g in torch.autograd.grad(out.square().sum(), ts)]


def _jax_grads(q, k, v, causal):
    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal,
                                           block_q=128, block_k=128) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grad(causal):
    """Mirrors ``tests/test_ops.py:44-63`` against the JAX custom VJP."""
    q, k, v = _qkv(10, 1, 256, 2, 32)
    for got, want, name in zip(_port_grads(q, k, v, causal),
                               _jax_grads(q, k, v, causal), "qkv"):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"grad of {name}")


def test_flash_attention_ragged_grad():
    """Mirrors ``tests/test_ops.py:92-102`` (L 200, not a block multiple);
    all three gradients, where the JAX test checks dq."""
    q, k, v = _qkv(11, 1, 200, 1, 32)
    for got, want, name in zip(_port_grads(q, k, v, False),
                               _jax_grads(q, k, v, False), "qkv"):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"grad of {name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 200, 200, 2, 32), (1, 128, 256, 1, 16),
                                   (1, 256, 128, 2, 16)])
def test_flash_bwd_reference_matches_pallas(shape, causal):
    """The plain backward against ``_flash_bwd`` (both Pallas kernels, in
    interpret mode) on the same residuals, Lq != Lk included. With causal
    and Lk > Lq, K rows >= Lq see no query: dK and dV there are 0."""
    B, Lq, Lk, H, D = shape
    q, k, v = _qkv(12, B, Lq, H, D, Lk)
    do = np.random.default_rng(13).standard_normal((B, Lq, H, D),
                                                   dtype=np.float32)
    scale = 1.0 / np.sqrt(D)

    def bhld(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            B * H, x.shape[1], D)

    def blhd(x):
        x = np.asarray(x)
        return x.reshape(B, H, x.shape[1], D).transpose(0, 2, 1, 3)

    out, lse = _flash_fwd(bhld(q), bhld(k), bhld(v), scale, causal, 128, 128,
                          True)
    want = _flash_bwd(scale, causal, 128, 128, True,
                      (bhld(q), bhld(k), bhld(v), out, lse), bhld(do))
    got = flash_attention_bwd(
        *(torch.tensor(x) for x in (q, k, v, blhd(out))),
        torch.tensor(np.asarray(lse)).reshape(B, H, Lq), torch.tensor(do),
        causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), blhd(w), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")
    if causal and Lk > Lq:
        assert not got[1][:, Lq:].any() and not got[2][:, Lq:].any()


def test_cpu_grad_goes_through_the_function_without_launches():
    """On CPU tensors the Function runs the plain forward and backward; no
    kernel counter moves."""
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(14, 1, 96, 2, 16))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = flash_attention(q, k, v, causal=True, scale=0.3)
    do = torch.tensor(np.random.default_rng(15).standard_normal(
        out.shape, dtype=np.float32))
    got = torch.autograd.grad(out, (q, k, v), do)
    ref_out, lse = flash_attention_reference(q.detach(), k.detach(),
                                             v.detach(), True, 0.3)
    want = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                         ref_out, lse, do, True, 0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before


def test_plain_backward_matches_autograd_of_plain_forward():
    """The plain backward's formulas against autograd of the plain forward,
    bf16 O rounding aside (f32 here)."""
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(16, 2, 80, 2, 16, 112))
    do = torch.tensor(np.random.default_rng(17).standard_normal(
        (2, 80, 2, 16), dtype=np.float32))
    for causal in (True, False):
        out, lse = flash_attention_reference(q, k, v, causal)
        want = torch.autograd.grad(out, (q, k, v), do)
        got = flash_attention_bwd_reference(
            q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(),
            do, causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_no_grad_and_inference_mode_save_nothing():
    """The serving path: without a recorded gradient the call runs the
    forward alone; nothing is saved for a backward."""
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(18, 1, 32, 2, 16))
    with torch.inference_mode():
        assert flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None


def test_bwd_rejects_bad_residuals():
    q, k, v = (torch.tensor(x) for x in _qkv(19, 1, 16, 2, 16))
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :1], out)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, k, v, out[:, :8], lse, out)
    with pytest.raises(ValueError, match="must be"):
        flash_attention_bwd(q, k, v, out, lse, out.double())
    meta = [t.to("meta") for t in (q, k, v, out, lse, out)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(*meta)


def test_kernel_alignment_checks():
    """bf16 inputs must sit on the 16-byte grid the tensor-core kernels'
    16-byte copies need; f32 inputs take any layout contiguous in D."""
    q, k, v = (torch.tensor(x).bfloat16() for x in _qkv(20, 1, 16, 2, 64))
    packed = torch.zeros(1, 16, 3, 2, 64, dtype=torch.bfloat16)
    fa._check_kernel_inputs(*packed.unbind(2))
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_kernel_inputs(shifted.view(q.shape), k, v)
    odd_rows = torch.zeros(1, 16, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_kernel_inputs(q, odd_rows, v)
    # One head: its stride is never used, so it need not be aligned.
    fa._check_kernel_inputs(*(torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16)
                              .as_strided((1, 16, 1, 64), (1024, 64, 3, 1))
                              for _ in range(3)))
    f32 = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    fa._check_kernel_inputs(f32, f32, f32)


def _tc_forward(q, k, v, causal, scale, block_k=64):
    """Plain emulation of the bf16 tensor-core forward: S from bf16 operands
    with f32 sums, the online softmax over 64-column tiles, and P rounded
    to bf16 before P V. Returns (O in bf16, LSE f32 [B, H, Lq])."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    m = torch.full((B, H, Lq), -1e30)
    l = torch.zeros((B, H, Lq))
    acc = torch.zeros((B, H, Lq, D))
    rows = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * scale
        mask = torch.ones((Lq, kt.shape[1]), dtype=torch.bool)
        if causal:
            mask = rows >= torch.arange(k0, k0 + kt.shape[1])[None, :]
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).transpose(1, 2).bfloat16()
    return out, m + torch.log(l)


def _tc_backward(q, k, v, out, lse, do, causal, scale):
    """Plain emulation of the bf16 backward kernels: P and dS in f32 from
    bf16 operands; dkv rounds P (before P^T dO) and dS (before dS^T Q) to
    bf16, and dq rounds dS to bf16 before dS K."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    Lq, Lk = q.shape[1], k.shape[1]
    delta = fa.attention_delta(out, do)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    if causal:
        mask = torch.ones((Lq, Lk), dtype=torch.bool).tril()
        p, ds = torch.where(mask, p, 0.0), torch.where(mask, ds, 0.0)
    ds16 = ds.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    return tuple(g.bfloat16() for g in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 200, 333, 2, 16), (1, 256, 128, 2, 64),
                                   (2, 192, 192, 1, 64),
                                   (1, 384, 128, 2, 128)])
def test_tensor_core_rounding_fits_the_bf16_tolerance(shape, causal):
    """The bf16 kernels round P (forward P V, dkv's P^T dO) and dS (dq's
    dS K, dkv's dS^T Q) to bf16 before those dots, where the TPU kernels
    keep them in f32. Emulated in plain PyTorch, that rounding stays inside
    the port's bf16 tolerances against ``_flash_fwd`` and ``_flash_bwd``
    (interpret mode) on the same bf16 inputs: O and LSE at 2e-2, gradients
    at 1e-2 of the largest |grad|."""
    B, Lq, Lk, H, D = shape
    q, k, v = _qkv(21, B, Lq, H, D, Lk)
    do = np.random.default_rng(22).standard_normal((B, Lq, H, D),
                                                   dtype=np.float32)
    scale = 1.0 / np.sqrt(D)

    def bhld(x):
        return jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3).reshape(
            B * H, x.shape[1], D)

    def blhd(x):
        x = np.asarray(x, dtype=np.float32)
        return torch.tensor(x.reshape(B, H, x.shape[1], D).transpose(
            0, 2, 1, 3))

    ref_out, ref_lse = _flash_fwd(bhld(q), bhld(k), bhld(v), scale, causal,
                                  128, 128, True)
    ref_grads = _flash_bwd(scale, causal, 128, 128, True,
                           (bhld(q), bhld(k), bhld(v), ref_out, ref_lse),
                           bhld(do))
    tq, tk, tv, tdo = (torch.tensor(x).bfloat16() for x in (q, k, v, do))
    out, lse = _tc_forward(tq, tk, tv, causal, scale)
    torch.testing.assert_close(out.float(), blhd(ref_out), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, torch.tensor(np.asarray(
        ref_lse)).reshape(B, H, Lq), rtol=2e-2, atol=2e-2)
    # The backward from the reference's own residuals, as the kernels get
    # them from the forward.
    grads = _tc_backward(tq, tk, tv, blhd(ref_out).bfloat16(),
                         torch.tensor(np.asarray(ref_lse)).reshape(B, H, Lq),
                         tdo, causal, scale)
    for g, w, name in zip(grads, ref_grads, "qkv"):
        w = blhd(w)
        torch.testing.assert_close(
            g.float(), w, rtol=1e-2, atol=1e-2 * w.abs().max().item(),
            msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("D", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_launches_hand_each_entry_point_its_arguments(monkeypatch, dtype, D):
    """The forward, dq and dkv launches hand their C entry points as many
    tensors as ``_ENTRY_POINTS`` binds pointers, and three strides for each
    [B, L, H, D] one, as many as it binds int64s; each launch is counted
    once. The launch itself is stubbed: CPU tensors reach the launchers
    only here."""
    handed = []
    monkeypatch.setattr(
        fa, "_run_kernel",
        lambda symbol, tensors, q, k, causal, scale:
        handed.append((symbol, tensors, causal, scale)))
    B, Lq, Lk, H = 2, 200, 333, 3
    q = torch.zeros((B, Lq, H, D), dtype=dtype)
    k = v = torch.zeros((B, Lk, H, D), dtype=dtype)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out, lse = fa._launch(q, k, v, True, 0.125)
    assert (out.shape, out.dtype) == (q.shape, dtype)
    assert (lse.shape, lse.dtype) == ((B, H, Lq), torch.float32)
    dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, torch.zeros_like(q),
                                True, 0.125)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    assert [h[0] for h in handed] == list(fa._ENTRY_POINTS)
    for symbol, tensors, causal, scale in handed:
        _, n_ptr, n_strides = fa._ENTRY_POINTS[symbol]
        assert len(tensors) == n_ptr, symbol
        assert 3 * sum(t.dim() == 4 for t in tensors) == n_strides, symbol
        assert all(a is b for a, b in zip(tensors, (q, k, v))), symbol
        assert (causal, scale) == (True, 0.125), symbol
