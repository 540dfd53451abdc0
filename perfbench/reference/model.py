"""The plain reference of the cells' model, in PyTorch, written apart from
the program.

A Llama-style decoder as the published configurations describe it:
RMSNorm (f32), rotary embeddings on the two halves of each head, causal
softmax attention with grouped K/V heads (query head ``j`` reads K/V head
``j // (heads / kv_heads)``), a SwiGLU MLP (``silu(x W_gate) * (x W_up)``),
an untied head and next-token cross entropy. It takes the weight tree of
``perfbench.core.model`` (the port's layout) and nothing the program made.

``precision``:
- ``"f32"``: every product in float32 with TF32 off (the caller turns TF32
  off; ``f32_matmuls`` does so for a block of code);
- ``"fp8"``: the control. Both operands of every matmul (the blocks' and
  the head's) are rounded to e4m3 with a scale for each row of the left
  operand and each column of the right one, as an fp8 GEMM with row-wise
  scales takes them; in training their gradient is rounded to e5m2 the
  same way. Q, K and V are rounded to e4m3 before attention. Products are
  summed in float32.

Attention runs over blocks of queries, and the head and loss over blocks of
rows, each block under ``checkpoint`` when a gradient is wanted, so that a
16k-token sequence fits beside the program's freed state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.core.model import Dims

_FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def f32_matmuls():
    """float32 products without TF32 inside the block."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32)
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor, fmt: torch.dtype, dim: int) -> torch.Tensor:
    """``x`` rounded to ``fmt`` with one scale for each slice that reduces
    over ``dim``, and back to ``x``'s type."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = _FP8[fmt] / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = fp8_round(a, torch.float8_e4m3fn, -1)
        qb = fp8_round(b, torch.float8_e4m3fn, 0)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g, torch.float8_e5m2, -1)
        da = qg @ qb.t()
        db = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return da, db


class _Fp8Straight(torch.autograd.Function):
    """e4m3 rounding of an attention input; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn, -1)

    @staticmethod
    def backward(ctx, g):
        return g


class Reference:
    def __init__(self, m: Dims, precision: str = "f32",
                 attn_block: int = 1024, loss_block: int = 4096):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.m, self.precision = m, precision
        self.attn_block, self.loss_block = attn_block, loss_block

    def _mm(self, a, b):
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def _rmsnorm(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.m.eps) * w

    def _rope(self, x, start: int):
        L, half = x.shape[1], x.shape[-1] // 2
        inv = self.m.theta ** (-torch.arange(half, dtype=torch.float64,
                                             device=x.device) / half)
        pos = torch.arange(start, start + L, dtype=torch.float64,
                           device=x.device)
        ang = (pos[:, None] * inv[None]).to(x.dtype)[None, :, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    @staticmethod
    def _attn_block(q, k, v, start: int):
        """Causal attention of the queries at rows ``start..`` over the
        keys ``0..start + len``: [B, l, h, hd] each."""
        hd = q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        rows = torch.arange(start, start + q.shape[1], device=q.device)
        cols = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    def _attention(self, q, k, v):
        rep = self.m.heads // self.m.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if self.precision == "fp8":
            q, k, v = (_Fp8Straight.apply(t) for t in (q, k, v))
        L, out = q.shape[1], []
        for s in range(0, L, self.attn_block):
            e = min(L, s + self.attn_block)
            args = (q[:, s:e], k[:, :e], v[:, :e], s)
            if torch.is_grad_enabled():
                out.append(checkpoint(self._attn_block, *args,
                                      use_reentrant=False))
            else:
                out.append(self._attn_block(*args))
        return torch.cat(out, 1)

    def block(self, w: Dict[str, torch.Tensor], x: torch.Tensor,
              start: int = 0) -> torch.Tensor:
        """One layer on ``x`` [B, L, d] (f32), at positions ``start..``.
        ``w``: the layer's ``wq wk wv wo wi wg wo_mlp ln1 ln2``."""
        B, L, d = x.shape
        hd = self.m.head_dim
        h = self._rmsnorm(x, w["ln1"])
        q = self._mm(h, w["wq"].reshape(d, -1)).view(B, L, -1, hd)
        k = self._mm(h, w["wk"].reshape(d, -1)).view(B, L, -1, hd)
        v = self._mm(h, w["wv"].reshape(d, -1)).view(B, L, -1, hd)
        a = self._attention(self._rope(q, start), self._rope(k, start), v)
        x = x + self._mm(a.reshape(B, L, -1), w["wo"].reshape(-1, d))
        h = self._rmsnorm(x, w["ln2"])
        u = F.silu(self._mm(h, w["wi"])) * self._mm(h, w["wg"])
        return x + self._mm(u, w["wo_mlp"])

    def head(self, x, ln_f, lm_head):
        """f32 logits of ``x`` [..., d]."""
        return self._mm(self._rmsnorm(x, ln_f), lm_head)

    # -- training ------------------------------------------------------

    def loss(self, leaves: Sequence[torch.Tensor], tokens: torch.Tensor,
             rows=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``tokens`` [B, L + 1] under the
        f32 ``leaves`` (``core.model.leaf_specs`` order); ``rows`` keeps
        only those rows of the batch."""
        if rows is not None:
            tokens = tokens[rows]
        (embed, wq, wk, wv, wo, wi, wg, wo_mlp, ln1, ln2, ln_f,
         lm_head) = leaves
        x = embed[tokens[:, :-1]]
        # One unbind a stacked leaf: its backward stacks the layers'
        # gradients once, where indexing would add a full-size zero a layer.
        per_layer = list(zip(*(t.unbind(0) for t in
                               (wq, wk, wv, wo, wi, wg, wo_mlp, ln1, ln2))))
        for w in per_layer:
            if torch.is_grad_enabled():
                x = checkpoint(self._block_args, x, *w, use_reentrant=False)
            else:
                x = self._block_args(x, *w)
        x = x.reshape(-1, x.shape[-1])
        targets = tokens[:, 1:].reshape(-1)
        total = x.new_zeros(())
        for s in range(0, x.shape[0], self.loss_block):
            args = (x[s:s + self.loss_block], ln_f, lm_head,
                    targets[s:s + self.loss_block])
            if torch.is_grad_enabled():
                total = total + checkpoint(self._nll_sum, *args,
                                           use_reentrant=False)
            else:
                total = total + self._nll_sum(*args)
        return total / x.shape[0]

    def _block_args(self, x, wq, wk, wv, wo, wi, wg, wo_mlp, ln1, ln2):
        return self.block(dict(wq=wq, wk=wk, wv=wv, wo=wo, wi=wi, wg=wg,
                               wo_mlp=wo_mlp, ln1=ln1, ln2=ln2), x)

    def _nll_sum(self, x, ln_f, lm_head, targets):
        logp = torch.log_softmax(self.head(x, ln_f, lm_head), -1)
        return -logp.gather(-1, targets[:, None]).sum()

    # -- scoring -------------------------------------------------------

    def last_token_logits(self, layer_weights, embed, ln_f, lm_head,
                          prompts: List[torch.Tensor]) -> List[torch.Tensor]:
        """f32 logits at the last token of each prompt (unpadded, one at a
        time), layer by layer: ``layer_weights(i)`` gives layer ``i``'s
        weights, which are made and cast once for all prompts."""
        xs = [embed[p.long()][None].float() for p in prompts]
        for i in range(self.m.layers):
            w = {k: t.float() for k, t in layer_weights(i).items()}
            xs = [self.block(w, x) for x in xs]
            del w
        return [self.head(x[0, -1], ln_f.float(), lm_head.float())
                for x in xs]


def adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               exp_avg: Sequence[torch.Tensor],
               exp_avg_sq: Sequence[torch.Tensor], step: int, lr: float,
               weight_decay: float, betas=(0.9, 0.999),
               eps: float = 1e-8) -> None:
    """AdamW (decoupled weight decay, bias-corrected moments) in place."""
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, m, v in zip(params, grads, exp_avg, exp_avg_sq):
        p.mul_(1 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(bc2)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / bc1)
