"""The plain reference of a DeepSeekMoE model (arXiv:2401.06066), in
PyTorch, written apart from the program.

The dense parts (RMSNorm, rotary embeddings, causal attention, the dense
SwiGLU, the head and the ``fp8`` control) are ``reference.model``'s. Each
MoE layer after the ``first_k_dense_replace`` dense ones is
``x + Attn(RMSNorm(x))`` followed by, on ``u = RMSNorm(h)``:
- ``s = softmax(u W_g)`` over all ``router`` routed experts;
- the greedy top ``k`` of ``s``, weights ``g_i = s_i`` (renormalised over
  the picks with ``norm_topk``), times ``scale``;
- ``y = sum over held picks of g_i * SwiGLU_i(u) + SwiGLU_shared(u)``: the
  experts held here, ``first .. first + held - 1``, each by a loop that
  selects the tokens that picked it, and the shared experts on every
  token;
- the balance loss ``alpha * mean_b sum_i f_bi P_bi``: ``f_bi`` the picks
  of expert ``i`` in sequence ``b`` over ``L k / router``, ``P_bi`` the
  mean of ``s_i`` over the sequence.
The loss is the mean next-token cross entropy plus every MoE layer's
balance loss. The reference routes on its own scores: nothing of the
program's routing reaches it.

Faults, for the calibration only: ``top_k`` picks fewer experts than the
configuration's ``k`` (a pick left out), and ``capacity_factor`` keeps at
most ``capacity_factor x tokens x k / router`` of each expert's
assignments, in token order, and drops the rest, as a switch layer with a
capacity does.

``loads``: after each ``loss``, the count of each held expert's
assignments that were computed, by MoE layer, in the forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.core.model import Dims
from perfbench.core.moe_model import Experts
from perfbench.reference.model import Reference

_ATTN = ("wq", "wk", "wv", "wo")


class MoEReference(Reference):
    def __init__(self, m: Dims, x: Experts, precision: str = "f32",
                 top_k: Optional[int] = None,
                 capacity_factor: Optional[float] = None, **blocks):
        super().__init__(m, precision, **blocks)
        self.x = x
        self.top_k = top_k or x.k
        self.capacity_factor = capacity_factor
        self.loads: List[List[int]] = []

    def attend(self, w: Dict[str, torch.Tensor], x: torch.Tensor
               ) -> torch.Tensor:
        """``x + Attn(RMSNorm(x))`` of one layer."""
        B, L, d = x.shape
        hd = self.m.head_dim
        h = self._rmsnorm(x, w["ln1"])
        q = self._mm(h, w["wq"].reshape(d, -1)).view(B, L, -1, hd)
        k = self._mm(h, w["wk"].reshape(d, -1)).view(B, L, -1, hd)
        v = self._mm(h, w["wv"].reshape(d, -1)).view(B, L, -1, hd)
        a = self._attention(self._rope(q, 0), self._rope(k, 0), v)
        return x + self._mm(a.reshape(B, L, -1), w["wo"].reshape(-1, d))

    def _swiglu(self, u, wi, wg, wo):
        return self._mm(F.silu(self._mm(u, wi)) * self._mm(u, wg), wo)

    def moe_ffn(self, w: Dict[str, torch.Tensor], u: torch.Tensor):
        """The MoE FFN of ``u`` [B, L, d] (normed): its output, its balance
        loss and each held expert's computed assignments."""
        x = self.x
        B, L, d = u.shape
        flat = u.reshape(B * L, d)
        scores = torch.softmax(self._mm(flat, w["router"]), -1)
        gates, picks = torch.topk(scores, self.top_k, dim=-1)
        if x.norm_topk:
            gates = gates / gates.sum(-1, keepdim=True)
        gates = gates * x.scale
        with torch.no_grad():
            f = F.one_hot(picks.view(B, -1), x.router).sum(1).float()
            f = f * (x.router / (L * self.top_k))
        aux = x.alpha * (f * scores.view(B, L, -1).mean(1)).sum(1).mean()
        y = torch.zeros_like(flat)
        cap = None
        if self.capacity_factor is not None:
            cap = int(self.capacity_factor * B * L * x.k / x.router)
        counts = []
        for e in range(x.held):
            token, slot = (picks == x.first + e).nonzero(as_tuple=True)
            if cap is not None:
                token, slot = token[:cap], slot[:cap]
            counts.append(int(token.numel()))
            out = self._swiglu(flat[token], w["ewi"][e], w["ewg"][e],
                               w["ewo"][e])
            y = y.index_add(0, token, gates[token, slot][:, None] * out)
        if x.shared:
            y = y + self._swiglu(flat, w["swi"], w["swg"], w["swo"])
        return y.view(B, L, d), aux, counts

    def moe_block(self, x_in, *weights):
        keys = (_ATTN + ("router", "ewi", "ewg", "ewo")
                + (("swi", "swg", "swo") if self.x.shared else ())
                + ("ln1", "ln2"))
        w = dict(zip(keys, weights))
        x = self.attend(w, x_in)
        y, aux, counts = self.moe_ffn(w, self._rmsnorm(x, w["ln2"]))
        return x + y, aux, counts

    def backbone(self, leaves: Sequence[torch.Tensor], inputs: torch.Tensor):
        """The pre-final-norm states of ``inputs`` [B, L] under the f32
        ``leaves`` (``core.moe_model.leaf_specs`` order), and the MoE
        layers' summed balance loss; ``loads`` is set."""
        n_moe = 4 + 4 + (3 if self.x.shared else 0) + 2
        embed, dense, moe = leaves[0], leaves[1:10], leaves[10:10 + n_moe]
        x = embed[inputs]
        for w in zip(*(t.unbind(0) for t in dense)):
            x = self._run(self._block_args, x, *w)
        aux, self.loads = x.new_zeros(()), []
        for w in zip(*(t.unbind(0) for t in moe)):
            x, a, counts = self._run(self.moe_block, x, *w)
            aux = aux + a
            self.loads.append(counts)
        return x, aux

    def logits(self, leaves: Sequence[torch.Tensor], inputs: torch.Tensor
               ) -> torch.Tensor:
        return self.head(self.backbone(leaves, inputs)[0], *leaves[-2:])

    def loss(self, leaves: Sequence[torch.Tensor], tokens: torch.Tensor,
             rows=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``tokens`` [B, L + 1] plus the
        balance losses, under the f32 ``leaves``; ``rows`` keeps only
        those rows of the batch."""
        if rows is not None:
            tokens = tokens[rows]
        x, aux = self.backbone(leaves, tokens[:, :-1])
        ln_f, lm_head = leaves[-2:]
        x = x.reshape(-1, x.shape[-1])
        targets = tokens[:, 1:].reshape(-1)
        total = x.new_zeros(())
        for s in range(0, x.shape[0], self.loss_block):
            total = total + self._run(
                self._nll_sum, x[s:s + self.loss_block], ln_f, lm_head,
                targets[s:s + self.loss_block])
        return total / x.shape[0] + aux

    @staticmethod
    def _run(fn, *args):
        """``fn(*args)``, under ``checkpoint`` when a gradient is wanted."""
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)
