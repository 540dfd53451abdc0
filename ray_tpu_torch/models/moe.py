"""Mixture-of-experts feed-forward: dropless top-k routing over every routed
expert, computed for the experts this rank holds, beside shared experts.

The DeepSeekMoE block (arXiv:2401.06066), on ``u = RMSNorm(h)`` of one MoE
layer (``transformer`` calls ``moe_ffn``):
- ``s = softmax(u W_g)`` over all ``n_experts`` routed experts. Logits and
  scores are float32 whatever the compute type: the port keeps norms and
  softmax in f32;
- the top ``experts_per_token`` of ``s`` (greedy), weights ``g_i = s_i``,
  renormalised over the picks when ``norm_topk_prob``, times
  ``routed_scaling_factor``;
- ``y = sum over held picks of g_i * SwiGLU_i(u)``, plus
  ``SwiGLU_shared(u)`` (the shared experts, one SwiGLU of width
  ``d_shared``) on every token.
No token is dropped: every assignment to a held expert is computed.

A layer holds ``experts_held`` experts from ``first_expert`` on: the share
of one rank under expert parallelism. The router still scores and picks
over all experts; picks of experts held elsewhere are left out here, as
the ranks that hold them would compute them.

The balance loss of a layer (DeepSeekMoE's per-sequence form):
``alpha * mean_b sum_i f_bi * P_bi``, ``f_bi`` the picks of expert ``i`` in
sequence ``b`` over ``L * k / n_experts``, ``P_bi`` the mean of ``s_i``
over the sequence.

One layer's forward, in ``record_function`` ranges:
- ``moe.route``: router, top-k, and the assignments on held experts sorted
  by expert on the device (a stable sort of the expert index, with the
  picks of other ranks' experts last). The host reads the count of each
  held expert's assignments once a layer, and the buffers are sized by it
  exactly. Without it every buffer would be bounded by the tokens times
  ``min(k, experts_held)`` rows, four times the held assignments at a
  quarter of 64 experts, and every pass over the rows would move four
  times the bytes. The counts are copied without waiting and the shared
  experts are queued before the host waits for the copy, so the card
  computes them meanwhile and does not drain its queue at the read;
- ``moe.shared``: the shared experts, on every token;
- ``moe.route`` again: the held assignments' rows gathered by the counts;
- ``moe.experts``: the held assignments' rows in expert order through the
  three expert matmuls as grouped GEMMs over ragged groups
  (``torch._grouped_mm``, on a CUDA card in bf16), or a loop over the
  experts elsewhere; each row's gate weight scales its hidden row before
  the down projection;
- ``moe.combine``: the rows added back to their tokens, onto the shared
  experts' output (``index_add``).

With the perf plane on (``observability.perf``), each forward pass of a
layer, recomputed ones included, feeds:
- the ``moe.dispatch`` histogram: route plus combine, on a card between
  CUDA events on the current stream, read once complete (at a later layer
  or ``settle_dispatch``), so nothing waits for the device; elsewhere on
  the host clock;
- the expert-load counter (``expert_load``): by layer, the passes, each
  held expert's assignments, the assignments to experts held elsewhere and
  the sum over passes of the busiest held expert's count over the held
  experts' mean.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ray_tpu_torch.observability import perf

_load_lock = threading.Lock()
_load: Dict[int, dict] = {}  # raylint: guarded-by(_load_lock)
_pending = threading.local()


def check_mesh(mesh) -> None:
    """MoE layers run unsharded within a rank: over ``data`` and ``fsdp``
    only. Expert parallelism across ranks (an ``all_to_all``) is not
    built."""
    if mesh is None:
        return
    split = {a: n for a, n in mesh.shape.items()
             if n > 1 and a not in ("data", "fsdp")}
    if split:
        raise ValueError(f"a mixture-of-experts model runs over the data and "
                         f"fsdp axes only; this mesh splits {split}")


def balance_loss(scores: torch.Tensor, picks: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """Per-sequence balance loss (module note): ``scores`` [B, L, E] f32,
    ``picks`` [B, L, k] expert indices."""
    B, L, E = scores.shape
    k = picks.shape[-1]
    with torch.no_grad():
        f = torch.zeros((B, E), dtype=scores.dtype, device=scores.device)
        f.scatter_add_(1, picks.reshape(B, L * k),
                       torch.ones((B, L * k), dtype=scores.dtype,
                                  device=scores.device))
        f.mul_(E / (L * k))
    return alpha * (f * scores.mean(1)).sum(1).mean()


def route(u: torch.Tensor, router: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``scores`` [T, E], and the top-k ``gates`` (f32) and ``picks``
    [T, k] of ``u`` [T, d]."""
    scores = torch.softmax(u.float() @ router.float(), dim=-1)
    gates, picks = torch.topk(scores, cfg.experts_per_token, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True)
    return scores, gates * cfg.routed_scaling_factor, picks


def sort_assignments(picks: torch.Tensor, first: int, held: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every assignment (an index into ``picks.reshape(-1)``) sorted by
    expert, stably, the held experts ``first .. first + held - 1`` first
    and the others' after them; the count of each held expert's followed
    by that of the others' (on the device); and the held groups' ends
    (int32, ``torch._grouped_mm``'s ``offs``)."""
    local = picks.reshape(-1) - first
    key = local.masked_fill((local < 0) | (local >= held), held)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.long, device=key.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    ends = counts[:held].cumsum(0).to(torch.int32)
    return order, counts, ends


class _HostCounts:
    """The counts on their way to the host: on a card, a copy into pinned
    memory behind an event, so that ``get`` waits for that copy alone and
    not for the work queued after it."""

    __slots__ = ("host", "copied")

    def __init__(self, counts: torch.Tensor):
        self.host, self.copied = counts, None
        if counts.is_cuda:
            self.host = torch.empty(counts.shape, dtype=counts.dtype,
                                    pin_memory=True)
            self.host.copy_(counts, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(torch.cuda.current_stream(counts.device))

    def get(self) -> List[int]:
        if self.copied is not None:
            self.copied.synchronize()
        return self.host.tolist()


def _swiglu(x, wi, wg, wo):
    return (F.silu(x @ wi) * (x @ wg)) @ wo


def expert_swiglu(x: torch.Tensor, counts: List[int], ends: torch.Tensor,
                  wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """``scale[r] * SwiGLU_e(x[r])`` of each row ``r`` of ``x`` [H, d]: rows
    in expert order, ``counts[e]`` of them for held expert ``e``, whose
    group ends at row ``ends[e]`` (device, int32); ``wi``, ``wg``
    [E_held, d, f], ``wo`` [E_held, f, d]. The scale multiplies the hidden
    rows, before the down projection. On a CUDA card in bf16 each matmul is
    one grouped GEMM over the ragged groups; otherwise a loop over the
    experts."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _grouped_swiglu(x, ends, wi, wg, wo, scale[:, None])
    return _looped_swiglu(x, counts, wi, wg, wo, scale[:, None])


def _grouped_swiglu(x, ends, wi, wg, wo, scale):
    def mm(a, b):
        return torch._grouped_mm(a, b, offs=ends)
    return mm(F.silu(mm(x, wi)) * mm(x, wg) * scale, wo)


def _looped_swiglu(x, counts, wi, wg, wo, scale):
    out, start = [], 0
    for e, n in enumerate(counts):
        rows = x[start:start + n]
        h = F.silu(rows @ wi[e]) * (rows @ wg[e]) * scale[start:start + n]
        out.append(h @ wo[e])
        start += n
    return torch.cat(out) if out else x.new_zeros((0, wo.shape[-1]))


def moe_ffn(p: dict, h: torch.Tensor, cfg, layer: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer's FFN on ``h`` [B, L, d] (already normed): its output
    in ``h``'s type and its balance loss (f32). ``p``: the layer's
    ``router`` [d, E], ``experts`` (``wi``, ``wg``, ``wo``) and, with
    ``cfg.d_shared``, ``shared``."""
    B, L, d = h.shape
    k, held, dt = cfg.experts_per_token, cfg.experts_held, h.dtype
    u = h.reshape(B * L, d)
    timer = _DispatchTimer(u.device) if perf.ENABLED else None
    with record_function("moe.route"):
        scores, gates, picks = route(u, p["router"], cfg)
        aux = balance_loss(scores.view(B, L, -1), picks.view(B, L, k),
                           cfg.aux_loss_alpha)
        order, counts, ends = sort_assignments(picks, cfg.first_expert,
                                               held)
        counts = _HostCounts(counts)
        if timer:
            timer.mark()
    # Queued before the host waits for the counts: the card computes the
    # shared experts while the counts cross.
    if cfg.d_shared:
        with record_function("moe.shared"):
            sh = p["shared"]
            y = _swiglu(u, sh["wi"].to(dt), sh["wg"].to(dt), sh["wo"].to(dt))
    else:
        y = torch.zeros_like(u)
    with record_function("moe.route"):
        if timer:
            timer.mark()
        counts = counts.get()
        order = order[:sum(counts[:held])]
        tokens = order // k
        rows = u.index_select(0, tokens)
        weights = gates.reshape(-1).index_select(0, order).to(dt)
        if timer:
            timer.mark()
    with record_function("moe.experts"):
        ex = p["experts"]
        y_rows = expert_swiglu(rows, counts[:held], ends, ex["wi"].to(dt),
                               ex["wg"].to(dt), ex["wo"].to(dt), weights)
    with record_function("moe.combine"):
        if timer:
            timer.mark()
        y = y.index_add(0, tokens, y_rows)
        if timer:
            timer.mark()
            _count_load(layer, counts, held)
    return y.view(B, L, d), aux


class _DispatchTimer:
    """Route plus combine of one layer's forward into ``moe.dispatch``:
    ``mark`` at the ends and starts of the route's two parts (before and
    after the shared experts) and of the combine."""

    __slots__ = ("device", "marks")

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: list = []
        self.mark()

    def mark(self) -> None:
        cuda = self.device.type == "cuda"
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter() * 1e3)
        if len(self.marks) < 6:
            return
        if not cuda:
            perf.observe("moe.dispatch", self.ms())
            return
        settle_dispatch()
        if not hasattr(_pending, "timers"):
            _pending.timers = []
        _pending.timers.append(self)

    def ms(self) -> float:
        pairs = zip(self.marks[0::2], self.marks[1::2])
        if self.device.type == "cuda":
            return sum(a.elapsed_time(b) for a, b in pairs)
        return sum(b - a for a, b in pairs)


def settle_dispatch() -> None:
    """Feed this thread's finished ``moe.dispatch`` timings on a card to the
    histogram; unfinished ones wait for a later call. Never waits for the
    device."""
    timers = getattr(_pending, "timers", None)
    if not timers:
        return
    waiting = []
    for t in timers:
        if t.marks[-1].query():
            perf.observe("moe.dispatch", t.ms())
        else:
            waiting.append(t)
    _pending.timers = waiting


def _count_load(layer: int, counts: List[int], held: int) -> None:
    mine = counts[:held]
    total = sum(mine)
    with _load_lock:
        entry = _load.setdefault(layer, {"passes": 0, "held": [0] * held,
                                         "elsewhere": 0,
                                         "max_over_mean": 0.0})
        entry["passes"] += 1
        entry["held"] = [a + b for a, b in zip(entry["held"], mine)]
        entry["elsewhere"] += counts[held]
        if total:
            entry["max_over_mean"] += max(mine) * held / total


def expert_load() -> Dict[int, dict]:
    """The expert-load counter by layer (module note), a copy."""
    with _load_lock:
        return {layer: dict(e, held=list(e["held"]))
                for layer, e in _load.items()}


def reset_expert_load() -> None:
    with _load_lock:
        _load.clear()
