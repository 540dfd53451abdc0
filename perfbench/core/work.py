"""The work a cell needs, counted from its shapes, and the chip's peaks.

Nothing here depends on the kernels the program launches: the counts come
from the model's sizes and the batch's shapes, so a kernel that does less
work reads closer to its bound and one that does more (a recompute, a
repeated K/V head, padding) reads further from it.

Attention (causal, top-left mask, one call per layer):
- forward: two dots (S = QKᵀ and O = PV) on the kept (row, col) pairs;
  Q, K and V read once, K and V at the model's KV-head count, O written
  once, and the f32 log-sum-exp row written once;
- backward: five dots (S recomputed once, dP, dV, dQ, dK); Q, K, V, O, dO
  and the log-sum-exp read once, dQ, dK and dV written once.
Model FLOPs of a training step: 6 × the matmul parameters (blocks and
head; the embedding is a gather) × tokens, plus 3 × the causal attention
forward. No recompute is counted.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

from perfbench.core.model import Dims

PEAKS: Dict[str, float] = json.loads(
    (Path(__file__).with_name("peaks.json")).read_text())["h100_sxm"]


def kept_pairs(Lq: int, Lk: int) -> int:
    """(row, col) pairs of one head that a top-left causal mask keeps."""
    if Lq <= Lk:
        return Lq * (Lq + 1) // 2
    return Lk * (Lk + 1) // 2 + (Lq - Lk) * Lk


def attn_fwd_work(B: int, L: int, m: Dims,
                  elt: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's causal attention forward."""
    q = B * L * m.heads * m.head_dim
    kv = B * L * m.kv_heads * m.head_dim
    flops = 4.0 * B * m.heads * m.head_dim * kept_pairs(L, L)
    nbytes = elt * (q + 2 * kv + q) + 4 * B * m.heads * L
    return flops, float(nbytes)


def attn_bwd_work(B: int, L: int, m: Dims,
                  elt: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's causal attention backward."""
    q = B * L * m.heads * m.head_dim
    kv = B * L * m.kv_heads * m.head_dim
    flops = 10.0 * B * m.heads * m.head_dim * kept_pairs(L, L)
    reads = elt * (q + 2 * kv + q + q) + 4 * B * m.heads * L
    writes = elt * (q + 2 * kv)
    return flops, float(reads + writes)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time an H100 needs: the larger of the bf16 operations over
    the tensor-core peak and the bytes over the HBM rate."""
    return max(flops / PEAKS["bf16_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def block_params(m: Dims) -> int:
    """Matmul parameters of one block."""
    hd = m.head_dim
    return (m.d * m.heads * hd + 2 * m.d * m.kv_heads * hd
            + m.heads * hd * m.d + 3 * m.d * m.ff)


def matmul_params(m: Dims) -> int:
    """Matmul parameters of the model: every block and the head."""
    return m.layers * block_params(m) + m.d * m.vocab


def train_step_flops(m: Dims, B: int, L: int) -> float:
    """Model FLOPs of one training step on ``B`` rows of ``L`` predicted
    tokens (module note)."""
    attn = m.layers * attn_fwd_work(B, L, m)[0]
    return 6.0 * matmul_params(m) * B * L + 3.0 * attn


def serve_request_flops(m: Dims, length: int) -> float:
    """Forward FLOPs of one scored prompt: the blocks on every real token,
    causal attention on its real length, the head on its last token."""
    return (2.0 * m.layers * block_params(m) * length
            + m.layers * attn_fwd_work(1, length, m)[0]
            + 2.0 * m.d * m.vocab)


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAKS["bf16_flops_per_s"]
