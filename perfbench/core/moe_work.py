"""The work of a mixture-of-experts training step, counted from its shapes
and the routing's assignment count.

Routed experts (``moe_experts``: the grouped GEMMs), per assignment of a
token to a held expert: three GEMMs of ``2 d f`` FLOPs forward (gate, up,
down), twice that backward; a recompute is not counted. Bytes, in bf16:
each pass (forward, backward) reads each held expert's three weights once
and the backward writes their gradients once; the forward reads each
assignment's input row and writes its output row once, the backward reads
the input and the output's gradient and writes the input's gradient once.

Model FLOPs of a step, as ``core.work``: 6 x the matmul parameters a token
passes through x tokens, plus 3 x the causal attention forward. A token
passes through the router, the shared experts and, on average, ``k x held /
router`` held routed experts of each MoE layer.
"""

from __future__ import annotations

from typing import Tuple

from perfbench.core import work
from perfbench.core.model import Dims
from perfbench.core.moe_model import Experts


def expert_work(assignments: float, layer_steps: int, m: Dims, x: Experts,
                elt: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of the routed experts over ``layer_steps`` training
    steps of one MoE layer each (forward and backward), with
    ``assignments`` held assignments among them."""
    d, f = m.d, x.width
    flops = 3 * 3 * 2.0 * d * f * assignments
    weights = 3 * d * f * x.held * layer_steps
    nbytes = elt * (2 * weights + weights        # read twice, grads once
                    + 2 * d * assignments        # forward: in, out
                    + 3 * d * assignments)       # backward: in, dy, dx
    return flops, float(nbytes)


def moe_token_params(m: Dims, x: Experts) -> float:
    """Matmul parameters one token passes through in one MoE layer, routed
    experts at their mean share."""
    hd = m.head_dim
    attn = (m.d * m.heads * hd + 2 * m.d * m.kv_heads * hd
            + m.heads * hd * m.d)
    routed = x.k * x.held / x.router * 3 * m.d * x.width
    return attn + m.d * x.router + 3 * m.d * x.shared + routed


def train_step_flops(m: Dims, x: Experts, B: int, L: int) -> float:
    """Model FLOPs of one training step on ``B`` rows of ``L`` predicted
    tokens (module note)."""
    params = (x.dense_layers * work.block_params(m)
              + x.moe_layers(m) * moe_token_params(m, x) + m.d * m.vocab)
    attn = m.layers * work.attn_fwd_work(B, L, m)[0]
    return 6.0 * params * B * L + 3.0 * attn
