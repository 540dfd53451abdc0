"""Sequence/context parallelism: ring attention over the ``seq`` mesh axis.

Port of ``ray_tpu/parallel/sequence.py``. The sequence dimension is
sharded across ranks; keys/values rotate around the ring via ``ppermute``
while each rank's queries accumulate attention with streaming
(online-softmax) statistics, so the full O(L²) score matrix never
materializes. The inner block is the reference's einsum, in f32; no flash
kernel runs in the ring (the reference runs none there either).

``ring_attention`` takes DTensors (batch sharded over ``data_axis``,
sequence over ``axis``) and returns one placed the same way; given plain
tensors it is the per-rank body itself, as the transformer calls it on
this rank's sequence chunk.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.spmd import from_local, ppermute, to_local

_NEG_INF = -1e30


def _block_attn_update(q, k, v, m, l, acc, mask, scale):
    """One online-softmax accumulation step for a kv block.

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D]; m/l: [B, H, Lq]; acc like q.
    mask: [Lq, Lk] boolean (True = attend) or None.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    m_blk = torch.amax(scores, dim=-1)
    m_new = torch.maximum(m, m_blk)
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None].transpose(1, 2) + torch.einsum(
        "bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, acc_new


def _finish(acc, l, dtype):
    return (acc / torch.clamp(l, min=1e-20)[..., None].transpose(1, 2)
            ).to(dtype)


def _ring_local(q, k, v, mesh, axis, causal, scale):
    """The per-rank ring: this rank's q, k, v chunks ``[B, L/n, H, D]``."""
    n_shards = mesh.shape[axis]
    my = mesh.axis_index(axis)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qf = q.float()
    m = torch.full((B, H, Lq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=q.device)
    tril = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    kc, vc = k, v
    for s in range(n_shards):
        src = (my - s) % n_shards   # which kv block this rank holds now
        if not causal or src < my:
            mask = None             # full attention
        elif src == my:
            mask = tril             # lower-triangular
        else:
            mask = torch.zeros_like(tril)   # fully masked
        m, l, acc = _block_attn_update(qf, kc.float(), vc.float(), m, l,
                                       acc, mask, scale)
        if s + 1 < n_shards:        # the last rotation's blocks go unused
            kc = ppermute(kc, mesh, axis, perm)
            vc = ppermute(vc, mesh, axis, perm)
    return _finish(acc, l, q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "seq", causal: bool = True,
                   scale: Optional[float] = None,
                   data_axis: Optional[str] = "data") -> torch.Tensor:
    """Attention over sequence sharded on ``axis``.

    q, k, v: [batch, seqlen, heads, head_dim], seqlen sharded over ``axis``
    (and batch optionally over ``data_axis``). Returns same-sharded output.
    ``data_axis`` only says how a DTensor's batch is placed: the ring runs
    within each rank's batch block, whatever it is.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    placements = q.placements if isinstance(q, DTensor) else None
    q, k, v = to_local(q), to_local(k), to_local(v)

    # One shard is one causal (or full) block and no collective: the
    # reference's n_shards == 1 short-circuit.
    out = _ring_local(q, k, v, mesh, axis, causal, scale)
    return out if placements is None else from_local(out, mesh, placements)
