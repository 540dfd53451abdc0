"""The port's mixture-of-experts model (``models/moe.py`` in
``models/transformer.py``) against the plain float32 reference
(``perfbench/reference/moe.py``: plain ``torch``, a loop over the experts,
routing on its own scores), on the CPU at a tiny size: one dense layer, two
MoE layers, 8 routed experts, top-2 and one shared expert.

Tolerances: both sides compute in float32 from the same weights, in
another order of operations (the reference's attention in blocks of
queries, its experts one at a time), so they agree to float32 round-off
over a few layers: relative 1e-5 on a loss, 1e-4 (atol 1e-6) on a logit or
a gradient element, whose sums run over more terms. The routing is the
same on both sides: no score of these inputs lies within round-off of
another at the top-k boundary.
"""

import dataclasses
import math
import types

import pytest
import torch

from perfbench.core import model, moe_model
from perfbench.reference.model import Reference, f32_matmuls
from perfbench.reference.moe import MoEReference
from ray_tpu_torch.models import moe, transformer
from ray_tpu_torch.observability import perf

DIMS = model.Dims(vocab=48, d=32, layers=3, heads=4, kv_heads=4, ff=48,
                  theta=1e4, eps=1e-6)
UNCUT = moe_model.Experts(router=8, held=8, first=0, k=2, width=16,
                          shared=24, dense_layers=1, norm_topk=False,
                          scale=1.0, alpha=0.01)
# A rank's share: experts 2-5 of the 8 the router scores.
SHARE = dataclasses.replace(UNCUT, held=4, first=2)
SEED = 2 ** 31 + 7


def port_cfg(x, m=DIMS, **kw):
    kw = {"dtype": torch.float32, "remat": False, "use_flash": False, **kw}
    return transformer.TransformerConfig(
        vocab_size=m.vocab, d_model=m.d, n_layers=m.layers, n_heads=m.heads,
        n_kv_heads=m.kv_heads, d_ff=m.ff, rope_theta=m.theta,
        n_experts=x.router, n_experts_held=x.held, first_expert=x.first,
        experts_per_token=x.k, d_expert=x.width, d_shared=x.shared,
        n_dense_layers=x.dense_layers, norm_topk_prob=x.norm_topk,
        routed_scaling_factor=x.scale, aux_loss_alpha=x.alpha, **kw)


def tree_and_leaves(x, seed=SEED):
    tree = moe_model.make_tree(DIMS, x, seed, "cpu", torch.float32)
    return tree, [t.requires_grad_() for t in transformer.leaves(tree)]


def tokens(seed=SEED, shape=(2, 13)):
    return moe_model.zipf_tokens(seed, 0, shape, DIMS.vocab, 1.0, "cpu")


@pytest.fixture
def perf_on():
    perf.enable()
    perf.reset()
    moe.reset_expert_load()
    yield
    perf.disable()
    perf.reset()
    moe.reset_expert_load()


def test_tree_follows_the_reference_layout():
    tree, _ = tree_and_leaves(SHARE)
    shapes = transformer._tree_map(lambda t: tuple(t.shape), tree)
    assert shapes == transformer.param_shapes(port_cfg(SHARE))
    got = [tuple(t.shape) for t in transformer.leaves(tree)]
    assert got == [s for _, s, *_ in moe_model.leaf_specs(DIMS, SHARE)]
    axes = transformer.logical_axes(port_cfg(SHARE))["moe_blocks"]
    assert axes["experts"]["wi"] == ("layers", "expert", "embed", "mlp")


@pytest.mark.parametrize("x", [UNCUT, SHARE,
                               dataclasses.replace(SHARE, norm_topk=True,
                                                   scale=2.5)],
                         ids=["uncut", "share", "renormalised"])
def test_logits_loss_and_grads_match_the_reference(x):
    tree, leaves = tree_and_leaves(x)
    toks = tokens()
    ref = MoEReference(DIMS, x, attn_block=5, loss_block=7)
    cfg = port_cfg(x)
    with f32_matmuls():
        with torch.no_grad():
            torch.testing.assert_close(
                transformer.apply(tree, toks[:, :-1], cfg),
                ref.logits(leaves, toks[:, :-1]), rtol=1e-4, atol=1e-6)
        want = transformer.loss_fn(tree, toks, cfg)
        want_g = torch.autograd.grad(want, leaves)
        got = ref.loss(leaves, toks)
        got_g = torch.autograd.grad(got, leaves)
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    for path, g, w in zip(moe_model.leaf_specs(DIMS, x), got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6, msg=path[0])


def test_balance_loss_is_part_of_the_loss():
    tree, _ = tree_and_leaves(UNCUT)
    toks = tokens()
    with torch.no_grad():
        with_aux = transformer.loss_fn(tree, toks, port_cfg(UNCUT))
        without = transformer.loss_fn(
            tree, toks, port_cfg(dataclasses.replace(UNCUT, alpha=0.0)))
    # Each layer's balance loss is at least alpha (equality when the picks
    # follow the scores evenly) and at most alpha * router.
    gap = (with_aux - without).item()
    assert 2 * UNCUT.alpha * 0.99 < gap < 2 * UNCUT.alpha * UNCUT.router


def _layer(tree, i=0):
    return transformer._tree_map(lambda t: t[i], tree["moe_blocks"])


def _routed_only(x):
    return dataclasses.replace(x, shared=0)


@pytest.mark.parametrize("shares", [4, 2])
def test_shares_add_up_to_the_uncut_layer(shares):
    """Guide's share test: the routed parts of every share, plus the shared
    experts counted once, give the uncut reference layer."""
    tree, _ = tree_and_leaves(UNCUT)
    layer = _layer(tree)
    u = torch.randn(2, 11, DIMS.d, generator=torch.Generator().manual_seed(3))
    per = UNCUT.router // shares
    total = torch.zeros_like(u)
    with torch.no_grad():
        for s in range(shares):
            x = dataclasses.replace(_routed_only(UNCUT), held=per,
                                    first=s * per)
            part = {**layer, "experts": transformer._tree_map(
                lambda t: t[s * per:(s + 1) * per], layer["experts"])}
            total += moe.moe_ffn(part, u, port_cfg(x))[0]
        sh = layer["shared"]
        total += (torch.nn.functional.silu(u @ sh["wi"]) * (u @ sh["wg"])
                  ) @ sh["wo"]
        ref = MoEReference(DIMS, UNCUT)
        w = {"router": layer["router"], "ewi": layer["experts"]["wi"],
             "ewg": layer["experts"]["wg"], "ewo": layer["experts"]["wo"],
             "swi": sh["wi"], "swg": sh["wg"], "swo": sh["wo"]}
        want = ref.moe_ffn(w, u)[0]
    torch.testing.assert_close(total, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_dropless_under_skew(k, perf_on):
    """Inputs that nearly all route to expert 3 lose no token: each held
    expert computes every assignment it gets, as the reference does."""
    x = dataclasses.replace(_routed_only(UNCUT), k=k)
    tree, _ = tree_and_leaves(x)
    layer = _layer(tree)
    g = torch.Generator().manual_seed(5)
    u = 1.0 + 0.1 * torch.randn(3, 40, DIMS.d, generator=g)
    layer["router"] = layer["router"].detach().clone()
    layer["router"][:, 3] += 2.0  # every token's top pick
    with torch.no_grad():
        got = moe.moe_ffn(layer, u, port_cfg(x), layer=1)[0]
        ref = MoEReference(DIMS, x)
        w = {"router": layer["router"], "ewi": layer["experts"]["wi"],
             "ewg": layer["experts"]["wg"], "ewo": layer["experts"]["wo"]}
        want, _, counts = ref.moe_ffn(w, u)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    load = moe.expert_load()[1]
    assert load["held"] == counts and sum(counts) == u.shape[0] * \
        u.shape[1] * k
    assert load["held"][3] == u.shape[0] * u.shape[1]
    assert load["passes"] == 1 and load["elsewhere"] == 0
    assert load["max_over_mean"] == pytest.approx(
        max(counts) * x.held / sum(counts))


def test_counter_counts_held_and_elsewhere(perf_on):
    tree, _ = tree_and_leaves(SHARE)
    toks = tokens()
    ref = MoEReference(DIMS, SHARE)
    with torch.no_grad():
        transformer.loss_fn(tree, toks, port_cfg(SHARE))
        ref.loss(transformer.leaves(tree), toks)
    load = moe.expert_load()
    assert sorted(load) == [1, 2]
    T = toks.shape[0] * (toks.shape[1] - 1)
    for layer, counts in zip((1, 2), ref.loads):
        assert load[layer]["held"] == counts
        assert load[layer]["held"] and load[layer]["passes"] == 1
        assert sum(counts) + load[layer]["elsewhere"] == T * SHARE.k
    hist = perf.get("moe.dispatch")
    assert hist.count() == 2 and hist.merged()[1] > 0


@pytest.mark.parametrize("x", [UNCUT, SHARE], ids=["uncut", "share"])
def test_remat_equals_no_remat(x):
    tree, leaves = tree_and_leaves(x)
    toks = tokens()
    out = []
    for remat in (False, True):
        loss = transformer.loss_fn(tree, toks, port_cfg(x, remat=remat))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (a, ga), (b, gb) = out
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for g, h in zip(ga, gb):
        torch.testing.assert_close(g, h, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_path_equals_the_loop(dtype):
    """``torch._grouped_mm`` over ragged groups (an empty one among them)
    against the loop over experts, forward and gradients."""
    g = torch.Generator().manual_seed(11)
    counts = [5, 0, 17, 3]
    d, f, E = 32, 16, len(counts)
    ends = torch.tensor(counts).cumsum(0).to(torch.int32)

    def make(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(dtype)

    x = make(sum(counts), d)
    ws = [make(E, d, f, s=d ** -0.5), make(E, d, f, s=d ** -0.5),
          make(E, f, d, s=f ** -0.5)]
    scale = make(sum(counts), 1).abs()
    out = []
    for path in (moe._grouped_swiglu, moe._looped_swiglu):
        args = [t.detach().requires_grad_() for t in [x, *ws, scale]]
        y = path(args[0], ends if path is moe._grouped_swiglu else counts,
                 *args[1:])
        out.append((y, torch.autograd.grad(y.float().square().sum(), args)))
    tol = {"rtol": 1e-5, "atol": 1e-6} if dtype == torch.float32 else \
        {"rtol": 2e-2, "atol": 2e-2}  # bf16 products, other sum orders
    torch.testing.assert_close(out[0][0], out[1][0], **tol)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, **tol)


def _dense_cfg():
    return transformer.TransformerConfig(
        vocab_size=DIMS.vocab, d_model=DIMS.d, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=DIMS.ff, dtype=torch.float32, remat=False,
        use_flash=False, rope_theta=DIMS.theta)


def test_dense_tree_and_init_are_unchanged():
    cfg = _dense_cfg()
    d, n, f, hd = cfg.d_model, cfg.n_layers, cfg.ff_dim, cfg.head_dim
    assert transformer.param_shapes(cfg) == {
        "embed": (cfg.vocab_size, d),
        "blocks": {
            "attn": {"wq": (n, d, 4, hd), "wk": (n, d, 2, hd),
                     "wv": (n, d, 2, hd), "wo": (n, 4, hd, d)},
            "mlp": {"wi": (n, d, f), "wg": (n, d, f), "wo": (n, f, d)},
            "ln1": (n, d), "ln2": (n, d)},
        "ln_f": (d,), "lm_head": (d, cfg.vocab_size)}
    got = transformer.init_params(cfg, torch.Generator().manual_seed(4),
                                  "cpu")
    # The dense recipe: draws in this order, at these scales.
    g = torch.Generator().manual_seed(4)
    want = []
    for shape, std in (((cfg.vocab_size, d), 0.02),
                       ((n, d, 4, hd), d ** -0.5), ((n, d, 2, hd), d ** -0.5),
                       ((n, d, 2, hd), d ** -0.5), ((n, 4, hd, d),
                                                    (4 * hd) ** -0.5),
                       ((n, d, f), d ** -0.5), ((n, d, f), d ** -0.5),
                       ((n, f, d), f ** -0.5), ((d, cfg.vocab_size),
                                                d ** -0.5)):
        want.append(torch.randn(shape, generator=g) * std)
    leaves = transformer.leaves(got)
    drawn = leaves[:8] + leaves[-1:]
    for a, b in zip(drawn, want):
        assert torch.equal(a, b)
    assert all(torch.equal(t, torch.ones_like(t)) for t in leaves[8:11])


def test_dense_logits_match_the_dense_reference():
    cfg = _dense_cfg()
    m = dataclasses.replace(DIMS, layers=2, kv_heads=2)
    tree = model.make_tree(m, SEED, "cpu", torch.float32)
    toks = model.tokens(SEED, 0, (2, 9), m.vocab, "cpu")
    ref = Reference(m, attn_block=4)
    b = tree["blocks"]
    with torch.no_grad(), f32_matmuls():
        x = tree["embed"][toks]
        for i in range(2):
            a, f_ = b["attn"], b["mlp"]
            x = ref.block(dict(wq=a["wq"][i], wk=a["wk"][i], wv=a["wv"][i],
                               wo=a["wo"][i], wi=f_["wi"][i],
                               wg=f_["wg"][i], wo_mlp=f_["wo"][i],
                               ln1=b["ln1"][i], ln2=b["ln2"][i]), x)
        torch.testing.assert_close(
            transformer.apply(tree, toks, cfg),
            ref.head(x, tree["ln_f"], tree["lm_head"]), rtol=1e-4,
            atol=1e-6)
    assert not cfg.moe and "moe_blocks" not in transformer.param_shapes(cfg)


@pytest.mark.parametrize("moe_model_", [False, True], ids=["dense", "moe"])
def test_embedding_cast_order(moe_model_):
    """A dense model casts the table, then gathers (the JAX code's order);
    an MoE model gathers the f32 rows, then casts. The rows are the same;
    the gradient of a repeated id is added in bf16 by the first and in f32
    by the second."""
    cfg = dataclasses.replace(
        port_cfg(SHARE) if moe_model_ else _dense_cfg(),
        dtype=torch.bfloat16)
    table = torch.randn(DIMS.vocab, DIMS.d,
                        generator=torch.Generator().manual_seed(2))
    toks = torch.tensor([[3] * 300 + [5, 7]])  # id 3 repeats
    cot = torch.randn(1, 302, DIMS.d, generator=torch.Generator()
                      .manual_seed(9)).to(torch.bfloat16)
    grads = []
    for order in ("port", "cast_first", "gather_first"):
        w = table.clone().requires_grad_()
        rows = {"port": lambda: transformer.embed({"embed": w}, toks, cfg),
                "cast_first": lambda: w.to(torch.bfloat16)[toks],
                "gather_first": lambda: w[toks].to(torch.bfloat16)}[order]()
        grads.append(torch.autograd.grad((rows * cot).sum(), w)[0])
    port, cast_first, gather_first = grads
    assert torch.equal(port, gather_first if moe_model_ else cast_first)
    exact = torch.zeros_like(table).index_add_(0, toks[0], cot[0].float())
    err = [float((g - exact)[3].norm() / exact[3].norm())
           for g in (cast_first, gather_first)]
    assert err[1] < 1e-6 < err[0]


@pytest.mark.parametrize("axis", ["tensor", "pipe", "seq", "expert"])
def test_a_mesh_that_splits_more_than_data_raises(axis):
    from ray_tpu_torch.train import make_lm_train_step
    mesh = types.SimpleNamespace(shape={"data": 2, "fsdp": 1, axis: 2},
                                 device_type="cpu")
    with pytest.raises(ValueError, match="data and fsdp axes only"):
        make_lm_train_step(port_cfg(SHARE), mesh, device="cpu")
    moe.check_mesh(types.SimpleNamespace(shape={"data": 4, "fsdp": 2}))


@pytest.mark.parametrize("bad", [dict(experts_per_token=9),
                                 dict(first_expert=6),
                                 dict(n_dense_layers=4)])
def test_inconsistent_expert_fields_raise(bad):
    with pytest.raises(ValueError, match="inconsistent mixture"):
        dataclasses.replace(port_cfg(SHARE), **bad)


def test_train_step_runs_the_moe_model():
    from ray_tpu_torch.train import adamw, make_lm_train_step
    init_fn, step_fn, shard = make_lm_train_step(
        port_cfg(SHARE), optimizer=adamw(1e-3), device="cpu")
    tree, _ = tree_and_leaves(SHARE)
    state = init_fn(params=tree)
    losses = []
    for _ in range(3):
        state, m = step_fn(state, shard(tokens()))
        losses.append(m["loss"].item())
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
