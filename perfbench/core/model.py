"""A configuration file's sizes, and the inputs made from ``--seed``.

The weight tree has the port's layout (``transformer.param_shapes``: blocks
stacked on a leading ``[n_layers, ...]`` dim), but is made here, from the
seed, and never by the port's ``init_params``. Each leaf has a generator of
its own, seeded from the run's seed and the leaf's index, so any one leaf
can be made again alone (the reference and the checks do so). Weights and
tokens are drawn on the device, in the type they are used in, one call a
leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch


@dataclass(frozen=True)
class Dims:
    vocab: int
    d: int
    layers: int
    heads: int
    kv_heads: int
    ff: int
    theta: float
    eps: float

    @property
    def head_dim(self) -> int:
        return self.d // self.heads


def dims(config: dict) -> Dims:
    """The sizes of a Hugging Face style ``config.json``."""
    return Dims(vocab=int(config["vocab_size"]), d=int(config["hidden_size"]),
                layers=int(config["num_hidden_layers"]),
                heads=int(config["num_attention_heads"]),
                kv_heads=int(config.get("num_key_value_heads")
                             or config["num_attention_heads"]),
                ff=int(config["intermediate_size"]),
                theta=float(config["rope_theta"]),
                eps=float(config["rms_norm_eps"]))


def leaf_specs(m: Dims) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``(path, shape, kind, scale)`` of each leaf, in the port's leaf
    order (``transformer.leaves``). ``normal``: N(0, scale²); ``ones``."""
    d, n, h, kv, hd, f = m.d, m.layers, m.heads, m.kv_heads, m.head_dim, m.ff
    dense = lambda fan_in: 1.0 / math.sqrt(fan_in)  # noqa: E731
    return [
        ("embed", (m.vocab, d), "normal", 0.02),
        ("blocks.attn.wq", (n, d, h, hd), "normal", dense(d)),
        ("blocks.attn.wk", (n, d, kv, hd), "normal", dense(d)),
        ("blocks.attn.wv", (n, d, kv, hd), "normal", dense(d)),
        ("blocks.attn.wo", (n, h, hd, d), "normal", dense(h * hd)),
        ("blocks.mlp.wi", (n, d, f), "normal", dense(d)),
        ("blocks.mlp.wg", (n, d, f), "normal", dense(d)),
        ("blocks.mlp.wo", (n, f, d), "normal", dense(f)),
        ("blocks.ln1", (n, d), "ones", 1.0),
        ("blocks.ln2", (n, d), "ones", 1.0),
        ("ln_f", (d,), "ones", 1.0),
        ("lm_head", (d, m.vocab), "normal", dense(d)),
    ]


def mix(seed: int, stream: int) -> int:
    """A generator seed for one stream of a run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63)


def make_leaf(m: Dims, index: int, seed: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    _, shape, kind, scale = leaf_specs(m)[index]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(mix(seed, index))
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return t.mul_(scale)


def make_tree(m: Dims, seed: int, device, dtype: torch.dtype) -> Dict:
    """The whole tree in the port's layout, nested by the paths' dots."""
    tree: Dict = {}
    for i, (path, *_) in enumerate(leaf_specs(m)):
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = make_leaf(m, i, seed, device, dtype)
    return tree


def tree_leaves(tree: Dict, m: Dims) -> List[torch.Tensor]:
    """The tree's leaves in ``leaf_specs`` order."""
    out = []
    for path, *_ in leaf_specs(m):
        node = tree
        for p in path.split("."):
            node = node[p]
        out.append(node)
    return out


def tokens(seed: int, stream: int, shape, vocab: int,
           device) -> torch.Tensor:
    """Uniform token ids for one batch, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(mix(seed, 1_000 + stream))
    return torch.randint(0, vocab, tuple(shape), generator=g, device=device)
