"""The plain reference against the port's dense path at a tiny width, and
the reference's AdamW against torch's."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.core import model
from perfbench.reference.model import (Reference, adamw_step, f32_matmuls,
                                       fp8_round)

DIMS = model.Dims(vocab=48, d=64, layers=2, heads=4, kv_heads=2, ff=96,
                  theta=1e4, eps=1e-6)


def _port_cfg(m):
    from ray_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=m.vocab, d_model=m.d,
                             n_layers=m.layers, n_heads=m.heads,
                             n_kv_heads=m.kv_heads, d_ff=m.ff,
                             dtype=torch.float32, remat=False,
                             use_flash=False, rope_theta=m.theta)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_loss_and_grads_match_the_port_dense_path(kv_heads):
    from ray_tpu_torch.models import transformer
    m = dataclasses.replace(DIMS, kv_heads=kv_heads)
    tree = model.make_tree(m, 5, "cpu", torch.float32)
    leaves = [t.requires_grad_() for t in model.tree_leaves(tree, m)]
    tokens = model.tokens(5, 0, (2, 17), m.vocab, "cpu")
    with f32_matmuls():
        want = transformer.loss_fn(tree, tokens, _port_cfg(m))
        want_g = torch.autograd.grad(want, leaves)
        got = Reference(m, attn_block=5, loss_block=7).loss(leaves, tokens)
        got_g = torch.autograd.grad(got, leaves)
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_last_token_logits_match_the_port():
    from ray_tpu_torch.models import transformer
    tree = model.make_tree(DIMS, 9, "cpu", torch.bfloat16)
    prompts = [torch.randint(0, DIMS.vocab, (n,)) for n in (1, 7, 20)]
    b = tree["blocks"]

    def layer(i):
        a, f = b["attn"], b["mlp"]
        return dict(wq=a["wq"][i], wk=a["wk"][i], wv=a["wv"][i],
                    wo=a["wo"][i], wi=f["wi"][i], wg=f["wg"][i],
                    wo_mlp=f["wo"][i], ln1=b["ln1"][i], ln2=b["ln2"][i])

    with torch.no_grad():
        got = Reference(DIMS).last_token_logits(
            layer, tree["embed"], tree["ln_f"], tree["lm_head"], prompts)
        tree32 = transformer._tree_map(lambda t: t.float(), tree)
        for p, g in zip(prompts, got):
            want = transformer.apply(tree32, p[None], _port_cfg(DIMS))[0, -1]
            torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5)


def test_rows_keeps_part_of_the_batch():
    tree = model.make_tree(DIMS, 1, "cpu", torch.float32)
    leaves = model.tree_leaves(tree, DIMS)
    tokens = model.tokens(1, 0, (2, 9), DIMS.vocab, "cpu")
    ref = Reference(DIMS)
    with torch.no_grad():
        assert ref.loss(leaves, tokens, [0]).item() == pytest.approx(
            ref.loss(leaves, tokens[:1]).item())


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = [torch.randn(5, 3, generator=g), torch.randn(4, generator=g)]
    grads = [[torch.randn_like(p) for p in p0] for _ in range(3)]
    ours = [p.clone() for p in p0]
    m = [torch.zeros_like(p) for p in p0]
    v = [torch.zeros_like(p) for p in p0]
    theirs = [p.clone().requires_grad_() for p in p0]
    opt = torch.optim.AdamW(theirs, lr=3e-4, weight_decay=0.01,
                            foreach=False)
    for t, gs in enumerate(grads):
        adamw_step(ours, gs, m, v, t + 1, 3e-4, 0.01)
        for p, gg in zip(theirs, gs):
            p.grad = gg
        opt.step()
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=1e-7)


def test_fp8_rounding_is_coarse_but_bounded():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(3))
    err = (fp8_round(x, torch.float8_e4m3fn, -1) - x).abs() / x.abs().amax(
        -1, keepdim=True)
    assert 1e-3 < err.max().item() < 2 ** -4
    assert np.isfinite(err.numpy()).all()
