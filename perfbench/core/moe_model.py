"""A mixture-of-experts configuration's sizes, its weight tree, and Zipf
token ids made from ``--seed``.

The tree has the port's layout for a DeepSeekMoE model
(``transformer.param_shapes`` with ``n_experts`` set): the dense stack
``blocks`` (``first_k_dense_replace`` layers, SwiGLU of
``intermediate_size``), then ``moe_blocks``: attention, the router over
every routed expert, the experts held here (``[n, held, ...]``) and the
shared experts (one SwiGLU of ``n_shared_experts`` x
``moe_intermediate_size``). As in ``core.model``, each leaf has a
generator of its own, seeded from the run's seed and the leaf's index, and
is made here, never by the port. The embedding is drawn N(0, 1)
(``EMBED_STD``), the matmuls N(0, 1/fan-in), the norms ones.

A configuration file states the experts held here as ``n_routed_experts``
(listed in ``reduced``), the router's width as ``router_experts`` (the
published ``n_routed_experts``) and the first held expert's index as
``first_held_expert``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from perfbench.core import model
from perfbench.core.model import Dims


# N(0, 1): PyTorch's ``nn.Embedding`` default. At 0.02 a token's own state
# is small beside what causal attention averages over a Zipf-skewed context,
# every token's router input is nearly the same, and every token routes to
# the same few experts (the busiest held expert took 7.9 x the held mean).
EMBED_STD = 1.0


@dataclass(frozen=True)
class Experts:
    router: int        # routed experts the router scores
    held: int          # routed experts held here
    first: int         # the first held expert's index
    k: int             # experts per token
    width: int         # a routed expert's SwiGLU width
    shared: int        # the shared experts' width (one SwiGLU)
    dense_layers: int  # leading layers with the dense MLP
    norm_topk: bool
    scale: float       # routed_scaling_factor
    alpha: float       # balance loss weight

    def moe_layers(self, m: Dims) -> int:
        return m.layers - self.dense_layers


def experts(config: dict) -> Experts:
    if config.get("scoring_func", "softmax") != "softmax" or \
            config.get("topk_method", "greedy") != "greedy" or \
            config.get("moe_layer_freq", 1) != 1:
        raise ValueError("softmax scores, greedy top-k and an MoE FFN in "
                         "every layer after the dense ones are what runs")
    return Experts(router=int(config["router_experts"]),
                   held=int(config["n_routed_experts"]),
                   first=int(config.get("first_held_expert", 0)),
                   k=int(config["num_experts_per_tok"]),
                   width=int(config["moe_intermediate_size"]),
                   shared=int(config["n_shared_experts"])
                   * int(config["moe_intermediate_size"]),
                   dense_layers=int(config["first_k_dense_replace"]),
                   norm_topk=bool(config["norm_topk_prob"]),
                   scale=float(config.get("routed_scaling_factor", 1.0)),
                   alpha=float(config["aux_loss_alpha"]))


def leaf_specs(m: Dims, x: Experts
               ) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``(path, shape, kind, scale)`` of each leaf in the port's leaf
    order, as ``core.model.leaf_specs``."""
    d, h, kv, hd = m.d, m.heads, m.kv_heads, m.head_dim
    nd, nm = x.dense_layers, x.moe_layers(m)
    dense = lambda fan_in: 1.0 / math.sqrt(fan_in)  # noqa: E731

    def attn(stack, n):
        return [(f"{stack}.attn.wq", (n, d, h, hd), "normal", dense(d)),
                (f"{stack}.attn.wk", (n, d, kv, hd), "normal", dense(d)),
                (f"{stack}.attn.wv", (n, d, kv, hd), "normal", dense(d)),
                (f"{stack}.attn.wo", (n, h, hd, d), "normal",
                 dense(h * hd))]

    def swiglu(path, lead, f):
        return [(f"{path}.wi", (*lead, d, f), "normal", dense(d)),
                (f"{path}.wg", (*lead, d, f), "normal", dense(d)),
                (f"{path}.wo", (*lead, f, d), "normal", dense(f))]

    def norms(stack, n):
        return [(f"{stack}.ln1", (n, d), "ones", 1.0),
                (f"{stack}.ln2", (n, d), "ones", 1.0)]

    return ([("embed", (m.vocab, d), "normal", EMBED_STD)]
            + attn("blocks", nd) + swiglu("blocks.mlp", (nd,), m.ff)
            + norms("blocks", nd)
            + attn("moe_blocks", nm)
            + [("moe_blocks.router", (nm, d, x.router), "normal", dense(d))]
            + swiglu("moe_blocks.experts", (nm, x.held), x.width)
            + (swiglu("moe_blocks.shared", (nm,), x.shared) if x.shared
               else [])
            + norms("moe_blocks", nm)
            + [("ln_f", (d,), "ones", 1.0),
               ("lm_head", (d, m.vocab), "normal", dense(d))])


def make_leaf(m: Dims, x: Experts, index: int, seed: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    _, shape, kind, scale = leaf_specs(m, x)[index]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(model.mix(seed, index))
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return t.mul_(scale)


def make_tree(m: Dims, x: Experts, seed: int, device,
              dtype: torch.dtype) -> Dict:
    """The whole tree in the port's layout, nested by the paths' dots."""
    tree: Dict = {}
    for i, (path, *_) in enumerate(leaf_specs(m, x)):
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = make_leaf(m, x, i, seed, device, dtype)
    return tree


def zipf_tokens(seed: int, stream: int, shape, vocab: int, exponent: float,
                device) -> torch.Tensor:
    """Token ids of one batch (``stream``) drawn on ``device`` from a Zipf
    law over the ranks ``1..vocab`` (``P(r) ~ r^-exponent``). Each batch
    maps ranks to ids by a permutation of its own, drawn from the seed and
    the stream: within a batch the hot ids are those of one text, with the
    expert load they skew; across the batches of a run the hot ids differ,
    so the run's held share does not rest on where one map's few hottest
    ids route."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    probs = ranks.pow(-float(exponent))
    g = torch.Generator(device=device).manual_seed(
        model.mix(seed, 2_000 + stream))
    ids = torch.randperm(vocab, generator=g, device=device)
    g = torch.Generator(device=device).manual_seed(
        model.mix(seed, 1_000 + stream))
    n = math.prod(shape)
    drawn = torch.multinomial(probs / probs.sum(), n, replacement=True,
                              generator=g)
    return ids[drawn].view(tuple(shape))
