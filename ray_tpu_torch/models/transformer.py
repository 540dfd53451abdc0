"""Flagship model: decoder-only transformer in PyTorch, forward and loss.

Port of ``ray_tpu/models/transformer.py`` with the same numerics:
- the parameter tree keeps the JAX layout, blocks stacked on a leading
  ``[n_layers, ...]`` dim (what ``jax.vmap(layer)`` makes), so
  ``params_from_numpy`` carries JAX weights across unchanged;
- bf16 activations with f32 RMSNorm and softmax, RoPE (half-split
  rotation), SwiGLU MLP (``wi`` gate, ``wg`` up), untied f32-logit head;
- attention runs the CUDA flash-attention kernels (``ray_tpu_torch.ops``;
  forward, and dq/dkv under a gradient) when ``use_flash`` is set, or the
  dense path of the JAX code otherwise;
- ``loss_fn``/``head_and_loss``: next-token cross entropy on f32 logits.

Weights are f32 master copies, cast to ``cfg.dtype`` at every use as the
JAX code does, so gradients reach the f32 masters through the casts.
``cast_params`` casts them once instead (for serving); the per-use casts
are then no-ops and the numbers are identical, since a cast of the same
f32 value always gives the same bf16 value.

``jax.lax.scan`` over the stacked layers is a Python loop over their
``unbind``. ``remat`` (``jax.checkpoint`` per block) is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per block
when a gradient is being recorded: each block's activations are recomputed
in the backward, so its attention forward runs twice per training step.

With ``mesh`` (a ``ray_tpu_torch.parallel.Mesh``), ``backbone``, ``apply``
and ``loss_fn`` are per-rank bodies, as inside the reference's
``shard_map``s (``train.make_lm_train_step`` calls them so): ``params`` are
this rank's compute views and ``tokens`` its batch block at full length.
- ``seq`` > 1: each rank computes its ``L / seq`` chunk of the sequence
  (RoPE positions offset to the chunk), and attention is
  ``parallel.ring_attention`` over the chunks (the reference's switch);
  ``apply`` returns the chunk's logits and ``loss_fn`` the chunk's mean.
- heads (and the SwiGLU hidden dim) split over ``tensor``: a block's
  weights hold this rank's heads and hidden columns, and the two output
  projections end in a ``psum`` over ``tensor`` (Megatron's row-parallel
  layers), so the block's result is whole on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.sequence import ring_attention
from ray_tpu_torch.parallel.spmd import psum

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: Optional[int] = None     # GQA; defaults to n_heads
    d_ff: Optional[int] = None           # defaults to 4 * d_model (SwiGLU 8/3)
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    use_flash: bool = True
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's shapes; blocks are stacked ``[n_layers, ...]``."""
    d, h, kvh, hd, f, n = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                           cfg.head_dim, cfg.ff_dim, cfg.n_layers)
    return {
        "embed": (cfg.vocab_size, d),
        "blocks": {
            "attn": {"wq": (n, d, h, hd), "wk": (n, d, kvh, hd),
                     "wv": (n, d, kvh, hd), "wo": (n, h, hd, d)},
            "mlp": {"wi": (n, d, f),       # gate
                    "wg": (n, d, f),       # up
                    "wo": (n, f, d)},
            "ln1": (n, d),
            "ln2": (n, d),
        },
        "ln_f": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical-axis tree mirroring ``init_params`` output (leaves = tuples
    of logical names consumed by ``ShardingRules``). The leading "layers" dim
    of the stacked blocks maps to the pipeline axis when pipe > 1."""
    blk = {
        "attn": {
            "wq": ("layers", "embed", "heads", "kv"),
            "wk": ("layers", "embed", "heads", "kv"),
            "wv": ("layers", "embed", "heads", "kv"),
            "wo": ("layers", "heads", "kv", "embed"),
        },
        "mlp": {
            "wi": ("layers", "embed", "mlp"),
            "wg": ("layers", "embed", "mlp"),
            "wo": ("layers", "mlp", "embed"),
        },
        "ln1": ("layers", None),
        "ln2": ("layers", None),
    }
    return {
        "embed": ("vocab", "embed"),
        "blocks": blk,
        "ln_f": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Initialize the parameter tree (float32 master copy) on ``device``.

    Same shapes and scales as the JAX ``init_params``; the values are drawn
    from ``generator`` on its own device and differ from JAX's.
    """
    device = resolve_device(device)
    s = param_shapes(cfg)
    a, m = s["blocks"]["attn"], s["blocks"]["mlp"]
    d, f, hd = cfg.d_model, cfg.ff_dim, cfg.n_heads * cfg.head_dim

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(device)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    return {
        "embed": normal(s["embed"], 0.02),
        "blocks": {
            "attn": {"wq": dense(a["wq"], d), "wk": dense(a["wk"], d),
                     "wv": dense(a["wv"], d), "wo": dense(a["wo"], hd)},
            "mlp": {"wi": dense(m["wi"], d), "wg": dense(m["wg"], d),
                    "wo": dense(m["wo"], f)},
            "ln1": torch.ones(s["blocks"]["ln1"], device=device),
            "ln2": torch.ones(s["blocks"]["ln2"], device=device),
        },
        "ln_f": torch.ones(s["ln_f"], device=device),
        "lm_head": dense(s["lm_head"], d),
    }


def params_from_numpy(tree: Params, cfg: TransformerConfig,
                      device: DeviceLike = None) -> Params:
    """Carry a JAX parameter tree across: ``tree`` is the JAX params as numpy
    (``jax.tree.map(np.asarray, params)``); returns float32 tensors on
    ``device``. Shapes are checked against ``cfg``."""
    device = resolve_device(device)
    got = _tree_map(lambda x: tuple(np.shape(x)), tree)
    if got != param_shapes(cfg):
        raise ValueError(f"parameter tree does not match {cfg}: got {got}, "
                         f"expected {param_shapes(cfg)}")
    return _tree_map(lambda x: torch.tensor(
        np.asarray(x, dtype=np.float32), device=device), tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast every leaf once (e.g. to bf16 for serving); see module note."""
    return _tree_map(lambda t: t.to(dtype), params)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * w.to(x.dtype)


def _rope(x: torch.Tensor, theta: float, positions: torch.Tensor
          ) -> torch.Tensor:
    """x: [B, L, H, D]; rotate the two halves of D."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[:, :, None, None].float() * freqs      # B L 1 half
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _attention(q, k, v, cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    if mesh is not None and "seq" in mesh.axis_names and mesh.shape["seq"] > 1:
        return ring_attention(q, k, v, mesh, causal=True)
    if cfg.use_flash:
        return flash_attention(q, k, v, causal=True)
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    L, Lk = q.shape[1], k.shape[1]
    mask = torch.ones((L, Lk), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _block(params: Params, x: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    B, L, d = x.shape
    dt, hd = x.dtype, cfg.head_dim
    attn_p, mlp_p = params["attn"], params["mlp"]
    h = _rmsnorm(x, params["ln1"])
    # -1 heads: this rank's heads when they are split over ``tensor``.
    q = (h @ attn_p["wq"].to(dt).reshape(d, -1)).view(B, L, -1, hd)
    k = (h @ attn_p["wk"].to(dt).reshape(d, -1)).view(B, L, -1, hd)
    v = (h @ attn_p["wv"].to(dt).reshape(d, -1)).view(B, L, -1, hd)
    q = _rope(q, cfg.rope_theta, positions)
    k = _rope(k, cfg.rope_theta, positions)
    if cfg.kv_heads != cfg.n_heads:  # GQA: jnp.repeat, i.e. interleaved
        rep = cfg.n_heads // cfg.kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    attn = _attention(q, k, v, cfg, mesh)
    out = attn.reshape(B, L, -1) @ attn_p["wo"].to(dt).reshape(-1, d)
    if q.shape[2] != cfg.n_heads:   # heads split over tensor: partial sums
        out = psum(out, mesh, "tensor")
    x = x + out
    h = _rmsnorm(x, params["ln2"])
    gate = h @ mlp_p["wi"].to(dt)
    up = h @ mlp_p["wg"].to(dt)
    out = (F.silu(gate) * up) @ mlp_p["wo"].to(dt)
    if gate.shape[-1] != cfg.ff_dim:   # hidden split over tensor
        out = psum(out, mesh, "tensor")
    return x + out


def seq_chunk(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's chunk of dim 1 (the sequence) when ``seq`` > 1."""
    if mesh is None or mesh.shape.get("seq", 1) == 1:
        return x
    n = mesh.shape["seq"]
    if x.shape[1] % n:
        raise ValueError(f"sequence of {x.shape[1]} does not split over "
                         f"seq={n}")
    return x.chunk(n, dim=1)[mesh.axis_index("seq")]


def positions_for(B: int, L: int, mesh, device) -> torch.Tensor:
    """RoPE positions ``[B, L]`` of this rank's chunk of ``L`` tokens."""
    start = 0
    if mesh is not None and mesh.shape.get("seq", 1) > 1:
        start = mesh.axis_index("seq") * L
    return torch.arange(start, start + L, device=device)[None].expand(B, L)


def embed(params: Params, tokens: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].to(cfg.dtype)[tokens.long()]


def backbone(params: Params, tokens: torch.Tensor,
             cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """Embedding + all transformer blocks; returns pre-final-norm states
    (of this rank's sequence chunk, with a mesh)."""
    tokens = seq_chunk(tokens, mesh)
    B, L = tokens.shape
    x = embed(params, tokens, cfg)
    positions = positions_for(B, L, mesh, tokens.device)
    return run_blocks(params["blocks"], x, positions, cfg, mesh)


def run_blocks(blocks: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """``x`` through the stacked ``blocks`` (however many layers they hold:
    all of them, or a pipeline stage's), each under remat when set."""
    # One unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing would scatter each layer into a full-size zero.
    blocks = _tree_map(lambda t: t.unbind(0), blocks)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(len(blocks["ln1"])):
        layer = _tree_map(lambda t: t[i], blocks)
        if remat:
            x = checkpoint(_block, layer, x, positions, cfg, mesh,
                           use_reentrant=False)
        else:
            x = _block(layer, x, positions, cfg, mesh)
    return x


def head(params: Params, x: torch.Tensor,
         cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + lm-head projection -> float32 logits."""
    x = _rmsnorm(x, params["ln_f"])
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def apply(params: Params, tokens: torch.Tensor,
          cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens: [B, L] integer -> logits [B, L, vocab] (float32); with a
    ``seq`` axis, the logits of this rank's chunk."""
    return head(params, backbone(params, tokens, cfg, mesh), cfg)


def head_and_loss(params: Params, x: torch.Tensor, targets: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + lm head + next-token cross entropy (mean over tokens),
    on float32 logits."""
    logp = torch.log_softmax(head(params, x, cfg), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean()


def loss_fn(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """Next-token cross entropy: tokens ``[B, L+1]`` serve as their own
    labels (``tokens[:, 1:]`` given ``tokens[:, :-1]``); with a ``seq``
    axis, the mean over this rank's chunk."""
    x = backbone(params, tokens[:, :-1], cfg, mesh)
    return head_and_loss(params, x, seq_chunk(tokens[:, 1:], mesh), cfg)


def leaves(params: Params):
    """The parameter tree's tensors, in a fixed order."""
    return list(_leaves(params))


def num_params(params: Params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))
