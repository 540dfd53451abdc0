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
aw = importlib.import_module("ray_tpu_torch.ops.adamw")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, B, Lq, Lk, H, D, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal((B, L, H, D),
                                                  dtype=np.float32),
                              device=device).to(dtype)
                 for L in (Lq, Lk, Lk))


def _reference_by_heads(q, k, v, causal):
    """``flash_attention_reference`` over groups of heads, each group's
    [B, heads, Lq, Lk] f32 scores at most 1 GiB, so the cells' shapes fit
    on the card."""
    B, Lq, H, _ = q.shape
    per = max(1, 2**30 // (4 * B * Lq * k.shape[1]))
    parts = [fa.flash_attention_reference(q[:, :, h:h + per],
                                          k[:, :, h:h + per],
                                          v[:, :, h:h + per], causal)
             for h in range(0, H, per)]
    return (torch.cat([o for o, _ in parts], 2),
            torch.cat([lse for _, lse in parts], 1))


def _fwd_cases():
    """(B, Lq, Lk, H, D, dtype, causal, packed) of the forward kernel
    against the plain version; ``packed`` takes q, k, v as views into one
    [B, L, 3, H, D] tensor."""
    f32, bf16 = torch.float32, torch.bfloat16
    # Ragged Lq and Lk that differ, every head dim, both dtypes: masking of
    # pad rows and columns and the top-left causal alignment.
    cases = [(2, 200, 333, 2, D, dt, causal, False)
             for causal in (True, False) for D in (16, 32, 64, 128)
             for dt in (f32, bf16)]
    cases += [
        # The training cells, ragged by one row past a 128-row tile.
        (2, 4097, 4097, 32, 128, bf16, True, False),
        (2, 16385, 16385, 32, 128, bf16, True, False),
        # L mod 128 = 1, 64 and 127, over many heads and over few.
        (2, 385, 385, 32, 128, bf16, True, False),
        (2, 129, 129, 32, 128, bf16, True, False),
        (2, 192, 192, 48, 128, bf16, True, False),
        (2, 192, 192, 2, 128, bf16, False, False),
        (3, 255, 255, 32, 128, bf16, True, False),
        (1, 255, 255, 4, 128, bf16, False, False),
        # Lq != Lk: query rows past Lk, and Lk past Lq.
        (2, 384, 128, 32, 128, bf16, True, False),
        (2, 384, 128, 2, 128, bf16, False, False),
        (4, 200, 333, 32, 128, bf16, True, False),
        (4, 200, 333, 32, 64, bf16, False, False),
        # The serving buckets: B 1 and 8 at L 128 and 4096.
        (1, 128, 128, 32, 128, bf16, True, False),
        (8, 128, 128, 32, 128, bf16, True, False),
        (1, 4096, 4096, 32, 128, bf16, True, False),
        (8, 4096, 4096, 32, 128, bf16, True, False),
        # Strided views: row strides of 3 * H * D elements, f32 and bf16.
        (2, 160, 160, 4, 64, f32, True, True),
        (2, 160, 160, 4, 64, bf16, True, True),
        (2, 1024, 1024, 32, 128, bf16, True, True),
    ]
    return cases


def _fwd_case_id(case):
    B, Lq, Lk, H, D, dt, causal, packed = case
    name = "f32" if dt == torch.float32 else "bf16"
    return (f"B{B}-L{Lq}x{Lk}-H{H}-D{D}-{name}"
            f"{'-causal' if causal else ''}{'-packed' if packed else ''}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", _fwd_cases(), ids=_fwd_case_id)
def test_flash_fwd_kernel_matches_plain(case):
    """O and LSE of one launch against the plain version, f32 at 2e-5 and
    bf16 at 2e-2 elementwise. bf16 also within its rounding over the whole
    tensor: LSE to ``BF16_LSE_ATOL`` (the kernel sums l in f32 from the
    same exact scores) and O to ``BF16_O_REL_L2`` in relative L2 (O and P
    rounded to bf16, the reference's O too). At L=16385 a row's |O| is
    about 0.02, under the elementwise 2e-2, while one 128-column K/V tile
    left out of a row moves its LSE by at least 128 / 16385 = 0.008 and,
    over rows of random scores, O by sqrt(128 / L) = 0.09 of |O| or more."""
    B, Lq, Lk, H, D, dtype, causal, packed = case
    device = _cuda_or_skip()
    if packed:
        assert Lq == Lk
        packed_qkv = torch.tensor(np.random.default_rng(1).standard_normal(
            (B, Lq, 3, H, D), dtype=np.float32), device=device).to(dtype)
        q, k, v = packed_qkv.unbind(2)
        assert not q.is_contiguous()
    else:
        q, k, v = _qkv(0, B, Lq, Lk, H, D, dtype, device)
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    assert fa.launches == before + 1
    ref_out, ref_lse = _reference_by_heads(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        lse_err, o_rel = _bf16_fwd_errors(out, lse, ref_out, ref_lse)
        assert lse_err <= BF16_LSE_ATOL, lse_err
        assert o_rel <= BF16_O_REL_L2, o_rel


# The bf16 forward against its plain version over a whole launch: the
# largest |LSE error| and the relative L2 error of O (readings in PERF.md).
BF16_LSE_ATOL = 1e-4
BF16_O_REL_L2 = 1e-2


def _bf16_fwd_errors(out, lse, ref_out, ref_lse):
    """(largest |LSE - ref|, ||O - ref||_2 / ||ref||_2)."""
    diff = (out.float() - ref_out.float()).norm()
    return ((lse - ref_lse).abs().max().item(),
            (diff / ref_out.float().norm()).item())


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
@pytest.mark.parametrize("B,L,H,D,dtype", [
    (1, 64, 1, 64, torch.float32),
    (1, 4097, 8, 128, torch.bfloat16),
], ids=["f32-L64", "bf16-L4097"])
def test_flash_kernel_gradient_runs_through_the_kernels(B, L, H, D, dtype):
    """A CUDA gradient goes through ``_FlashAttention``: one forward launch,
    then one dq and one dkv launch in the backward, which read the
    forward's O and LSE. The answer: in f32 autograd's grads of the plain
    forward; in bf16 the plain path end to end (the plain forward's O and
    LSE into the plain backward), as a CPU tensor runs it."""
    device = _cuda_or_skip()
    q, k, v = (t.requires_grad_() for t in
               _qkv(2, B, L, L, H, D, dtype, device))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    do = _do(9, q)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    if dtype == torch.float32:
        ref, _ = fa.flash_attention_reference(q, k, v)
        want = torch.autograd.grad(ref, (q, k, v), do)
    else:
        q, k, v = q.detach(), k.detach(), v.detach()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        want = fa.flash_attention_bwd_reference(q, k, v, ref_out, ref_lse,
                                                do)
    _assert_grads_close(got, want, dtype)


def _packed_bf16(seed, B, L, H, D, device):
    """q, k, v as views into one packed [B, L, 3, H, D] bf16 tensor."""
    packed = torch.tensor(np.random.default_rng(seed).standard_normal(
        (B, L, 3, H, D), dtype=np.float32), device=device).bfloat16()
    return packed.unbind(2)


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


def _adamw_leaves(seed, device, sizes, offset_leaf=None):
    """(p, g, m, v) per leaf, f32, from a seed; p at a model's initial
    scale (std 0.02), so that an update of lr ~1e-3 is far above p's ulp
    and a coefficient off by a part in a thousand shows; the moments as
    after a few steps (m about g's scale, v positive). Leaf ``offset_leaf``
    is a view one element into a larger buffer: off the 16-byte grid."""
    rng = np.random.default_rng(seed)
    leaves = []
    for i, n in enumerate(sizes):
        parts = (0.02 * rng.standard_normal(n, dtype=np.float32),
                 rng.standard_normal(n, dtype=np.float32),
                 0.1 * rng.standard_normal(n, dtype=np.float32),
                 1e-3 * np.abs(rng.standard_normal(n, dtype=np.float32)))
        leaf = []
        for x in parts:
            t = torch.tensor(x, device=device)
            if i == offset_leaf:
                buf = torch.empty(n + 1, dtype=torch.float32, device=device)
                buf[1:] = t
                t = buf[1:]
            leaf.append(t)
        leaves.append(tuple(leaf))
    return leaves


def _assert_adamw_close(got, want, what):
    """f32, 1e-6 relative: the kernel's compiler may fuse a multiply and an
    add into one FMA where torch's passes round between them (about an ulp
    a step); near zero, 1e-6 of the tensor's largest magnitude."""
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * want.abs().max().item(),
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
def test_adamw_kernel_matches_plain():
    """Three steps of the one-pass kernel against ``adamw_reference`` on
    the card, the rate changing between steps: ragged lengths (past a chunk
    and within one), a leaf one element off the 16-byte grid (the scalar
    path), a 1-element leaf. Params and both moments, and each leaf's sum
    of g*g; one launch a step, every element counted."""
    device = _cuda_or_skip()
    sizes = [3 * 16384 + 5, 4096, 1, 1023, 70001, 16384 + 2]
    got = _adamw_leaves(21, device, sizes, offset_leaf=4)
    want = [tuple(t.clone() for t in leaf) for leaf in got]
    assert got[4][0].data_ptr() % 16 != 0
    for step, lr in enumerate((3e-4, 1e-3, 2e-4), start=1):
        coefs = [aw.coefficients(step, lr, 0.9, 0.999, 1e-8, 0.01)] * len(sizes)
        before = (aw.adamw_launches, aw.adamw_elements)
        sums = aw.adamw_step(*zip(*got), coefs)
        torch.cuda.synchronize()
        assert (aw.adamw_launches, aw.adamw_elements) == (
            before[0] + 1, before[1] + sum(sizes))
        want_sums = aw.adamw_reference(*zip(*want), coefs)
        torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=0)
        for i, (g_leaf, w_leaf) in enumerate(zip(got, want)):
            for name, a, b in zip(("param", "grad", "exp_avg", "exp_avg_sq"),
                                  g_leaf, w_leaf):
                _assert_adamw_close(a, b, f"step {step} leaf {i} {name}")


@pytest.mark.cuda
def test_adamw_kernel_splits_leaves_past_one_table():
    """More leaves than one launch's table takes: one launch each table,
    each leaf's sum in its own slot."""
    device = _cuda_or_skip()
    sizes = [7 + i for i in range(aw.MAX_LEAVES + 3)]
    got = _adamw_leaves(22, device, sizes)
    want = [tuple(t.clone() for t in leaf) for leaf in got]
    coefs = [aw.coefficients(1, 1e-3, 0.9, 0.999, 1e-8, 0.01)] * len(sizes)
    before = aw.adamw_launches
    sums = aw.adamw_step(*zip(*got), coefs)
    assert aw.adamw_launches == before + 2
    torch.testing.assert_close(sums, aw.adamw_reference(*zip(*want), coefs),
                               rtol=1e-5, atol=0)
    for g_leaf, w_leaf in zip(got, want):
        for a, b in zip(g_leaf, w_leaf):
            _assert_adamw_close(a, b, "leaf")


@pytest.mark.cuda
def test_adamw_kernel_refuses_what_it_does_not_take():
    """A bf16 leaf and a strided one raise before any launch."""
    device = _cuda_or_skip()
    p, g, m, v = _adamw_leaves(23, device, [64])[0]
    coefs = [aw.coefficients(1, 1e-3, 0.9, 0.999, 1e-8, 0.01)]
    before = aw.adamw_launches
    with pytest.raises(TypeError, match="float32"):
        aw.adamw_step([p.bfloat16()], [g.bfloat16()], [m], [v], coefs)
    wide = torch.zeros(64, 2, device=device)
    with pytest.raises(TypeError, match="contiguous"):
        aw.adamw_step([wide[:, 0]], [g], [m], [v], coefs)
    assert aw.adamw_launches == before


@pytest.mark.cuda
def test_one_pass_adamw_on_the_card_follows_torch_adamw():
    """The training step's optimizer on CUDA leaves against
    ``torch.optim.AdamW``'s foreach passes from the same state, 3 steps at
    changing rates; ``grad_sq`` against each gradient's square sum."""
    from ray_tpu_torch.train import adamw
    device = _cuda_or_skip()
    rng = np.random.default_rng(24)
    shapes = [(4096, 3), (1,), (1023,), (8, 513)]
    w0 = [torch.tensor(rng.standard_normal(s, dtype=np.float32),
                       device=device) for s in shapes]
    ours = [w.clone().requires_grad_() for w in w0]
    theirs = [w.clone().requires_grad_() for w in w0]
    opt = adamw()(ours)
    ref = torch.optim.AdamW(theirs, lr=3e-4, weight_decay=0.01,
                            foreach=True)
    before = aw.adamw_launches
    for lr in (3e-4, 1e-3, 5e-4):
        gs = [torch.tensor(rng.standard_normal(s, dtype=np.float32),
                           device=device) for s in shapes]
        for o, ts in ((opt, ours), (ref, theirs)):
            for group in o.param_groups:
                group["lr"] = lr
            for t, g in zip(ts, gs):
                t.grad = g.clone()
            o.step()
        torch.testing.assert_close(
            opt.grad_sq, torch.stack([g.square().sum() for g in gs]),
            rtol=1e-5, atol=0)
    assert aw.adamw_launches == before + 3
    for a, b in zip(ours, theirs):
        _assert_adamw_close(a.detach(), b.detach(), "param")
        for key in ("exp_avg", "exp_avg_sq"):
            _assert_adamw_close(opt.state[a][key], ref.state[b][key], key)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["allreduce", "reduce", "broadcast",
                                "allgather", "reducescatter", "sendrecv"])
def test_nccl_group_over_distinct_cards(op):
    """The ``nccl`` collective group with one rank per card: each op is one
    ``torch.cuda.nccl`` call over the ranks' tensors (send and recv are
    peer copies), each result a new tensor on its rank's card."""
    import threading
    from ray_tpu_torch import collective
    _cuda_or_skip()
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip(f"needs two or more cards, this machine has {n}")
    name = f"distinct-{op}"
    xs = [torch.arange(8 * n, dtype=torch.float32, device=f"cuda:{r}") + r
          for r in range(n)]
    outs, errors = [None] * n, []

    def rank(r):
        try:
            collective.init_collective_group(n, r, "nccl", name)
            if op == "allreduce":
                outs[r] = collective.allreduce(xs[r], name)
            elif op == "reduce":
                outs[r] = collective.reduce(xs[r], 1, name)
            elif op == "broadcast":
                outs[r] = collective.broadcast(xs[r], 1, name)
            elif op == "allgather":
                outs[r] = collective.allgather(xs[r], name)
            elif op == "reducescatter":
                outs[r] = collective.reducescatter(xs[r], name)
            elif r == 0:
                collective.send(xs[0], 1, name)
            elif r == 1:
                outs[r] = collective.recv(0, name)
            collective.destroy_collective_group(name)
        except Exception as e:      # raised below, after every join
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    host = [x.cpu() for x in xs]
    total = sum(host)
    want = {"allreduce": [total] * n,
            "reduce": [total if r == 1 else host[r] for r in range(n)],
            "broadcast": [host[1]] * n,
            "allgather": [torch.stack(host)] * n,
            "reducescatter": list(total.chunk(n)),
            "sendrecv": [None, host[0]] + [None] * (n - 2)}[op]
    for r, (got, w) in enumerate(zip(outs, want)):
        if w is None:
            assert got is None
            continue
        assert got.device == torch.device("cuda", r), got.device
        torch.testing.assert_close(got.cpu(), w)
    ptrs = [o.data_ptr() for o in outs if o is not None]
    assert len(set(ptrs)) == len(ptrs)
