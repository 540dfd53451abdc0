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

A mixture-of-experts model (``n_experts`` > 0; DeepSeekMoE) has two stacks:
``blocks``, its ``n_dense_layers`` leading layers with the dense SwiGLU of
``d_ff``, and ``moe_blocks``, the rest, whose FFN is ``moe.moe_ffn``: a
router over ``n_experts``, the ``experts_held`` routed experts of this rank
(``[n, E_held, ...]`` on the logical ``expert`` axis) and the shared
experts. ``loss_fn`` adds the MoE layers' balance losses. With every MoE
field at its default the tree, the kernels launched and the numbers are
the dense model's. One departure from the JAX numerics, in MoE models only:
``embed`` gathers the f32 rows and then casts, where the dense model (and
the JAX code) casts the table and then gathers. The values are the same;
the backward adds the gradients of an id that repeats in float32 instead
of ``cfg.dtype``. Under skewed token ids, the thousands of bf16 rows of a
frequent id lose their small terms (a 13% smaller gradient norm).

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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import moe
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
    # Mixture of experts (module note); a dense model with n_experts 0.
    n_experts: int = 0                   # the router's width
    n_experts_held: Optional[int] = None  # held here; defaults to n_experts
    first_expert: int = 0                # index of the first held expert
    experts_per_token: int = 1
    d_expert: Optional[int] = None       # a routed expert's width; d_ff
    d_shared: int = 0                    # the shared experts' width; 0: none
    n_dense_layers: int = 0              # leading layers with a dense MLP
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    aux_loss_alpha: float = 0.0

    def __post_init__(self):
        if self.moe and not (
                0 < self.experts_per_token <= self.n_experts
                and 0 <= self.first_expert
                and self.first_expert + self.experts_held <= self.n_experts
                and 0 <= self.n_dense_layers <= self.n_layers):
            raise ValueError(f"inconsistent mixture of experts: {self}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def experts_held(self) -> int:
        return self.n_experts_held or self.n_experts

    @property
    def expert_dim(self) -> int:
        return self.d_expert or self.ff_dim

    @property
    def dense_layers(self) -> int:
        """Layers in the ``blocks`` stack: all of them in a dense model."""
        return self.n_dense_layers if self.moe else self.n_layers

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
    """The parameter tree's shapes; blocks are stacked ``[n_layers, ...]``,
    the MoE layers' in ``moe_blocks`` (module note)."""
    d, h, kvh, hd, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.ff_dim)

    def attn(n):
        return {"wq": (n, d, h, hd), "wk": (n, d, kvh, hd),
                "wv": (n, d, kvh, hd), "wo": (n, h, hd, d)}

    def swiglu(*lead, width):
        return {"wi": (*lead, d, width),       # gate
                "wg": (*lead, d, width),       # up
                "wo": (*lead, width, d)}

    n = cfg.dense_layers
    shapes = {
        "embed": (cfg.vocab_size, d),
        "blocks": {"attn": attn(n), "mlp": swiglu(n, width=f),
                   "ln1": (n, d), "ln2": (n, d)},
    }
    if cfg.moe:
        n = cfg.n_layers - cfg.n_dense_layers
        shapes["moe_blocks"] = {
            "attn": attn(n),
            "router": (n, d, cfg.n_experts),
            "experts": swiglu(n, cfg.experts_held, width=cfg.expert_dim),
            **({"shared": swiglu(n, width=cfg.d_shared)}
               if cfg.d_shared else {}),
            "ln1": (n, d), "ln2": (n, d)}
    shapes["ln_f"] = (d,)
    shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical-axis tree mirroring ``init_params`` output (leaves = tuples
    of logical names consumed by ``ShardingRules``). The leading "layers" dim
    of the stacked blocks maps to the pipeline axis when pipe > 1; routed
    experts lie on the "expert" axis."""
    attn = {
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "heads", "kv"),
        "wv": ("layers", "embed", "heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
    }
    mlp = {
        "wi": ("layers", "embed", "mlp"),
        "wg": ("layers", "embed", "mlp"),
        "wo": ("layers", "mlp", "embed"),
    }
    blk = {"attn": attn, "mlp": mlp, "ln1": ("layers", None),
           "ln2": ("layers", None)}
    axes = {"embed": ("vocab", "embed"), "blocks": blk}
    if cfg.moe:
        axes["moe_blocks"] = {
            "attn": attn,
            "router": ("layers", "embed", None),
            "experts": {k: (v[0], "expert") + v[1:] for k, v in mlp.items()},
            **({"shared": mlp} if cfg.d_shared else {}),
            "ln1": ("layers", None), "ln2": ("layers", None)}
    axes["ln_f"] = (None,)
    axes["lm_head"] = ("embed", "vocab")
    return axes


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Initialize the parameter tree (float32 master copy) on ``device``.

    Same shapes and scales as the JAX ``init_params``; the values are drawn
    from ``generator`` on its own device and differ from JAX's. Leaves are
    drawn in the tree's order: the embedding N(0, 0.02²), every matmul
    N(0, 1/fan-in), norms ones.
    """
    device = resolve_device(device)

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(device)

    def init(path, shape):
        if path[-1].startswith("ln"):
            return torch.ones(shape, device=device)
        if path == ("embed",):
            return normal(shape, 0.02)
        if "attn" in path:  # [n, d, heads, hd] in; [n, heads, hd, d] out
            fan_in = shape[1] * shape[2] if path[-1] == "wo" else shape[1]
        else:               # [..., fan-in, fan-out]
            fan_in = shape[-2]
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return init(path, node)

    return walk((), param_shapes(cfg))


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


def _attend(params: Params, x: torch.Tensor, positions: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """``x + Attn(RMSNorm(x))``: a block's attention half."""
    B, L, d = x.shape
    dt, hd = x.dtype, cfg.head_dim
    attn_p = params["attn"]
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
    return x + out


def _block(params: Params, x: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    x = _attend(params, x, positions, cfg, mesh)
    dt, mlp_p = x.dtype, params["mlp"]
    h = _rmsnorm(x, params["ln2"])
    gate = h @ mlp_p["wi"].to(dt)
    up = h @ mlp_p["wg"].to(dt)
    out = (F.silu(gate) * up) @ mlp_p["wo"].to(dt)
    if gate.shape[-1] != cfg.ff_dim:   # hidden split over tensor
        out = psum(out, mesh, "tensor")
    return x + out


def _moe_block(params: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: TransformerConfig, layer: int, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An MoE layer: its output and its balance loss."""
    x = _attend(params, x, positions, cfg, mesh)
    y, aux = moe.moe_ffn(params, _rmsnorm(x, params["ln2"]), cfg, layer)
    return x + y, aux


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
    if cfg.moe:
        # Gather the f32 rows, then cast: the same values, but the backward
        # adds an id's gradients in float32 (module note).
        return params["embed"][tokens.long()].to(cfg.dtype)
    return params["embed"].to(cfg.dtype)[tokens.long()]


def backbone(params: Params, tokens: torch.Tensor,
             cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """Embedding + all transformer blocks; returns pre-final-norm states
    (of this rank's sequence chunk, with a mesh)."""
    return _backbone(params, tokens, cfg, mesh)[0]


def _backbone(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
              mesh=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``backbone``'s states and the MoE layers' summed balance loss (None
    in a dense model)."""
    tokens = seq_chunk(tokens, mesh)
    B, L = tokens.shape
    x = embed(params, tokens, cfg)
    positions = positions_for(B, L, mesh, tokens.device)
    x = run_blocks(params["blocks"], x, positions, cfg, mesh)
    if not cfg.moe:
        return x, None
    return run_moe_blocks(params["moe_blocks"], x, positions, cfg, mesh)


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


def run_moe_blocks(blocks: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: TransformerConfig, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` through the stacked ``moe_blocks``, each under remat when set
    (its routing recomputed from the same input, so the same), and the sum
    of their balance losses."""
    blocks = _tree_map(lambda t: t.unbind(0), blocks)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(len(blocks["ln1"])):
        layer = _tree_map(lambda t: t[i], blocks)
        args = (layer, x, positions, cfg, cfg.n_dense_layers + i, mesh)
        if remat:
            x, a = checkpoint(_moe_block, *args, use_reentrant=False)
        else:
            x, a = _moe_block(*args)
        aux = aux + a
    return x, aux


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
    axis, the mean over this rank's chunk. A mixture-of-experts model adds
    its layers' balance losses."""
    x, aux = _backbone(params, tokens[:, :-1], cfg, mesh)
    loss = head_and_loss(params, x, seq_chunk(tokens[:, 1:], mesh), cfg)
    return loss if aux is None else loss + aux


def leaves(params: Params):
    """The parameter tree's tensors, in a fixed order."""
    return list(_leaves(params))


def num_params(params: Params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))
