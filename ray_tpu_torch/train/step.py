"""The training step of the flagship transformer: on one device, or sharded
over a ``parallel`` mesh.

Port of ``ray_tpu/train/step.py:make_lm_train_step``. It keeps the
contract: ``(init_fn, step_fn, shard_batch)``, with
``step_fn(state, tokens) -> (state, {"loss", "grad_norm"})`` and
``state = (params, opt_state)``. What differs from the JAX step:

- ``init_fn`` takes a ``torch.Generator`` in place of a PRNG key, or the
  weights to start from (``params=``, e.g. from ``params_from_numpy``);
- ``opt_state`` is the ``torch.optim.Optimizer`` over the parameter
  leaves, and ``step_fn`` updates params and optimizer in place and returns
  the same state: the counterpart of ``donate_argnums=(0,)``;
- the default optimizer, ``OnePassAdamW``, steps every leaf in one pass of
  ``ops.adamw`` (a CUDA kernel on a card) that also sums each leaf's g*g,
  so the gradient norm takes no pass of its own; where XLA fused
  ``optax.adamw`` and ``global_norm`` into the jitted step;
- no ``jit``: PyTorch runs eagerly. ``step_fn`` is wrapped in
  ``goodput.instrument_jit`` as the reference's is, so its first call per
  (state, tokens) signature lands in the goodput ledger's ``compile``
  category: here that call carries the kernels' lazy build and the
  allocator's warm-up.

With a mesh, the state is sharded: every parameter, its gradient and its
AdamW moments are DTensors placed by ``transformer.logical_axes`` and the
rules (``pipe`` > 1 maps the stacked "layers" dim to ``pipe``). The step
is one per-rank body, as the reference's ``jit`` of a ``shard_map``-ed
loss would be:
- each parameter is redistributed to its compute view, gathered over every
  mesh dim but two: a block weight keeps its ``tensor`` shard (heads and
  SwiGLU columns; Megatron-style, ``transformer._block``) when ``pipe`` is
  1, and its ``pipe`` shard (its stage's layers). The embedding and the
  head are gathered whole (an embedding gather and a vocab-sharded
  softmax are not split here). The view's backward reduces the gradient
  back to the parameter's placements (all-reduce or reduce-scatter);
- the batch is sharded over ``data`` and ``fsdp``, the sequence over
  ``seq`` (ring attention); ``pipe`` > 1 runs the blocks under
  ``pipeline_apply`` on the ``data`` block of the batch (gathered over
  ``fsdp``), unsharded over ``tensor``, with embed and head on every
  stage, as the reference's ``in_specs`` have it;
- each rank differentiates its local mean loss divided by the number of
  ranks, so the reduced gradients are those of the global-batch mean; the
  reported ``loss`` is that mean, and ``grad_norm`` the norm of the whole
  gradient (a replicated element counted once).

A step is three ``record_function`` ranges, ``train.forward``,
``train.backward`` and ``train.optimizer`` (the gradient norm and the
optimizer's step), which group the kernels of a device trace. With the
perf plane on, the optimizer phase's time also feeds the
``train.optimizer`` histogram: on a card, the elapsed time between two
CUDA events recorded on the step's stream at the phase's edges, read once
both are complete (at the thread's next step or at ``session.report``),
so nothing waits for the device; elsewhere the host clock's.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.profiler import record_function

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import moe, transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.observability import goodput, perf
from ray_tpu_torch.ops.adamw import adamw_step, coefficients
from ray_tpu_torch.parallel import (ShardingRules, batch_sharding,
                                    pipeline_apply, shard_pytree)
from ray_tpu_torch.parallel.sharding import place_local
from ray_tpu_torch.parallel.spmd import all_gather, partial_grads

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

# Each thread's unread pair of optimizer-phase events, by card: at most one
# step's (module note).
_phase_events = threading.local()


def settle_optimizer_phase() -> None:
    """Feed the thread's last optimizer phase on a card to the
    ``train.optimizer`` histogram if both its events are complete; an
    incomplete pair stays for the next call. Never waits for the device."""
    pending = getattr(_phase_events, "pending", None)
    if not pending:
        return
    for index, (start, end) in list(pending.items()):
        if start.query() and end.query():
            del pending[index]
            perf.observe("train.optimizer", start.elapsed_time(end))


class _optimizer_phase:
    """The optimizer phase of one step (module note)."""

    __slots__ = ("device", "_range", "_t0", "_events")

    def __init__(self, device: torch.device):
        self.device = device
        self._range = record_function("train.optimizer")
        self._t0 = 0.0
        self._events = None

    def __enter__(self) -> "_optimizer_phase":
        if perf.ENABLED:
            if self.device.type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(torch.cuda.current_stream(self.device))
            else:
                self._t0 = time.perf_counter()
        self._range.__enter__()
        return self

    def __exit__(self, *exc_info) -> None:
        self._range.__exit__(*exc_info)
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
            # The step before's pair, if the card has finished it; if not,
            # it is dropped for this one.
            settle_optimizer_phase()
            if not hasattr(_phase_events, "pending"):
                _phase_events.pending = {}
            _phase_events.pending[self.device.index] = self._events
        elif self._t0:
            perf.observe("train.optimizer",
                         (time.perf_counter() - self._t0) * 1e3)


class OnePassAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose step is one pass of ``ops.adamw`` over
    every leaf: the kernel on a card, its plain version on the CPU.

    ``param_groups`` and ``state[p]`` (``step``, ``exp_avg``,
    ``exp_avg_sq``) are torch's, so a ``state_dict`` loads into either
    class. Each group's ``lr`` is read at every step. The pass also sums
    each leaf's g*g as it reads g: ``grad_sq`` holds those sums after a
    step, one f32 entry a parameter in ``param_groups`` order (0 for a
    parameter that had no grad and was skipped). ``amsgrad``,
    ``maximize``, ``capturable``, ``differentiable`` and ``fused`` are
    refused: the pass computes none of them."""

    REFUSED = ("amsgrad", "maximize", "capturable", "differentiable",
               "fused")

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2, **options):
        self._refuse(options)
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, **options)
        self.grad_sq: Optional[torch.Tensor] = None

    @classmethod
    def _refuse(cls, options) -> None:
        named = [k for k in cls.REFUSED if options.get(k)]
        if named:
            raise ValueError(f"OnePassAdamW does not take {named}: the "
                             f"one-pass kernel computes plain AdamW only")

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params, grads, exp_avgs, exp_avg_sqs, coefs, slots = \
            [], [], [], [], [], []
        n = 0
        for group in self.param_groups:
            self._refuse(group)   # a loaded state_dict may name them
            beta1, beta2 = group["betas"]
            lr = float(group["lr"])
            for p in group["params"]:
                n += 1
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:   # as torch.optim.AdamW lays it out
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                params.append(p)
                grads.append(p.grad)
                exp_avgs.append(state["exp_avg"])
                exp_avg_sqs.append(state["exp_avg_sq"])
                coefs.append(coefficients(
                    state["step"].item() + 1, lr, beta1, beta2,
                    group["eps"], group["weight_decay"]))
                slots.append(n - 1)
        sums = adamw_step(params, grads, exp_avgs, exp_avg_sqs, coefs)
        # Counted once the pass has run: leaves it refused keep their step
        # counts, and so their bias corrections.
        for p in params:
            self.state[p]["step"] += 1
        if len(slots) < n:
            full = sums.new_zeros(n)
            full[slots] = sums
            sums = full
        self.grad_sq = sums
        return loss


def adamw(lr: float = 3e-4, weight_decay: float = 0.01) -> OptimizerFactory:
    """``optax.adamw(lr, weight_decay=...)`` as a torch optimizer factory:
    betas (0.9, 0.999), eps 1e-8, decoupled decay on every leaf (norms
    included: optax applies no mask). The optimizer is ``OnePassAdamW``."""
    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return OnePassAdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return make


def sgd(lr: float, momentum: float = 0.0) -> OptimizerFactory:
    """``optax.sgd(lr, momentum=...)`` as a torch optimizer factory: the
    trace ``t = g + momentum * t`` from ``t = 0`` and ``p -= lr * t``, which
    is ``torch.optim.SGD`` with dampening 0 and no Nesterov (its first step
    sets ``t = g``, the same value)."""
    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               dampening=0.0, nesterov=False)
    return make


def make_lm_train_step(cfg: TransformerConfig, mesh: Any = None,
                       rules: Optional[ShardingRules] = None,
                       optimizer: Optional[OptimizerFactory] = None,
                       num_microbatches: int = 4,
                       device: DeviceLike = None):
    """Build ``(init_fn, step_fn, shard_batch)`` for language-model training
    on ``device`` (default ``cuda``), sharded over ``mesh`` when one is
    given (see the module note).

    ``optimizer`` builds a torch optimizer from the list of parameter
    leaves; the default is ``adamw()``, the JAX step's
    ``optax.adamw(3e-4, weight_decay=0.01)``. ``num_microbatches`` is the
    pipeline's, used when ``mesh.shape["pipe"] > 1``.
    """
    if mesh is None and rules is not None:
        raise ValueError("sharding rules need a mesh")
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")
    device = resolve_device(device)
    make_optimizer = optimizer or adamw()
    sharded = None if mesh is None else _Sharded(cfg, mesh, rules,
                                                 num_microbatches, device)

    def init_fn(key: Optional[torch.Generator] = None, *,
                params: Optional[transformer.Params] = None
                ) -> Tuple[transformer.Params, torch.optim.Optimizer]:
        """State from a generator (random init) or from given weights,
        which are copied: the state owns its parameters."""
        if (key is None) == (params is None):
            raise ValueError("init_fn takes a torch.Generator or params=, "
                             "exactly one of them")
        if params is None:
            params = transformer.init_params(cfg, key, device)
        else:
            shapes = transformer._tree_map(lambda t: tuple(t.shape), params)
            if shapes != transformer.param_shapes(cfg):
                raise ValueError(f"params do not match {cfg}: got {shapes}")
            params = transformer._tree_map(
                lambda t: t.detach().to(device, torch.float32, copy=True),
                params)
        if sharded is not None:
            params = sharded.place(params)
        leaves = transformer.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        if sharded is not None:
            # The optimizer steps each rank's shards in place (views of the
            # DTensors' local tensors), so its moments are the local shards
            # of moments placed like their parameters. AdamW is elementwise:
            # run on DTensors it would only add DTensor's per-op dispatch.
            with torch.no_grad():
                leaves = [t.to_local() for t in leaves]
        return params, make_optimizer(leaves)

    def step_fn(state, tokens: torch.Tensor
                ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        params, opt = state
        settle_optimizer_phase()
        leaves = transformer.leaves(params)
        with record_function("train.forward"):
            loss = (transformer.loss_fn(params, tokens, cfg) if sharded is None
                    else sharded.local_loss(params, tokens))
        with record_function("train.backward"):
            grads = torch.autograd.grad(
                loss if sharded is None else loss / sharded.mesh.size, leaves)
        with _optimizer_phase(device), torch.no_grad():
            if sharded is not None:
                # The optimizer holds the local shards (init_fn).
                leaves = [p for group in opt.param_groups
                          for p in group["params"]]
                grads = [g.to_local() for g in grads]
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            for p in leaves:
                p.grad = None
            # optax.global_norm of the raw grads, from each leaf's sum of
            # g*g: an optimizer with ``grad_sq`` (OnePassAdamW) summed them
            # as it stepped; for any other they take a pass of their own.
            leaf_sq = getattr(opt, "grad_sq", None)
            if leaf_sq is None:
                leaf_sq = torch.stack([g.float().square().sum()
                                       for g in grads])
            if sharded is None:
                grad_norm = torch.sqrt(leaf_sq.sum())
            else:
                loss, grad_norm = sharded.loss_and_norm(loss, leaf_sq)
        return (params, opt), {"loss": loss.detach(), "grad_norm": grad_norm}

    def shard_batch(tokens) -> torch.Tensor:
        """Place a token batch (numpy or tensor) on the step's device; with
        a mesh, as a DTensor sharded over ``data`` and ``fsdp``."""
        tokens = torch.as_tensor(tokens).to(device)
        if sharded is None:
            return tokens
        return place_local(tokens, mesh,
                           batch_sharding(mesh, sharded.rules, ndim=2))

    # Goodput compile detection: the first call per (state, tokens)
    # signature lands in the ledger's ``compile`` category; a new tokens
    # shape mid-run is a recompile (reference ``step.py:100-106``).
    return init_fn, goodput.instrument_jit(step_fn, name="train.step_fn"), \
        shard_batch


class _Sharded:
    """The mesh half of ``make_lm_train_step``: placement, compute views,
    the per-rank loss and the reductions (module note)."""

    def __init__(self, cfg: TransformerConfig, mesh, rules, num_microbatches,
                 device: torch.device):
        if device.type != mesh.device_type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the step "
                             f"on {device}")
        if cfg.moe:
            moe.check_mesh(mesh)
        self.cfg, self.mesh, self.device = cfg, mesh, device
        self.num_microbatches = num_microbatches
        self.rules = rules or ShardingRules()
        self.pipe = mesh.shape.get("pipe", 1)
        if self.pipe > 1:
            if cfg.n_layers % self.pipe != 0:
                raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                                 f"pipe={self.pipe}")
            # Stage-shard the stacked layer dim so each stage holds only
            # its layers' params.
            self.rules = self.rules.with_overrides(layers="pipe")
        tensor = mesh.shape.get("tensor", 1)
        # Heads and SwiGLU columns split over tensor outside the pipeline;
        # inside it the blocks run unsharded over tensor (reference
        # pipeline.py's in_specs).
        self.tensor_parallel = tensor > 1 and self.pipe == 1
        if self.tensor_parallel and (cfg.n_heads % tensor or
                                     cfg.kv_heads % tensor or
                                     cfg.ff_dim % tensor):
            raise ValueError(f"heads {cfg.n_heads}, kv heads {cfg.kv_heads} "
                             f"and d_ff {cfg.ff_dim} must split over "
                             f"tensor={tensor}")
        self.axes = [a for a in mesh.axis_names if mesh.shape[a] > 1]
        self.copies: Optional[torch.Tensor] = None

    def place(self, params):
        params = shard_pytree(params, transformer.logical_axes(self.cfg),
                              self.mesh, self.rules)
        # Each leaf's replica count over the mesh, in leaf order (its
        # gradient is placed as it is): the norm counts a leaf's g*g once.
        self.copies = torch.tensor(
            [math.prod(self.mesh.shape[a] for a, pl in
                       zip(self.mesh.axis_names, p.placements)
                       if isinstance(pl, Replicate))
             for p in transformer.leaves(params)],
            dtype=torch.float32, device=self.device)
        return params

    def _view(self, p: DTensor, block: bool) -> torch.Tensor:
        """The compute view of a parameter, whose backward reduces the
        local gradient back to the parameter's placements."""
        kept = ("pipe", "tensor") if self.tensor_parallel else ("pipe",)
        target = [pl if block and isinstance(pl, Shard) and a in kept
                  else Replicate()
                  for a, pl in zip(self.mesh.axis_names, p.placements)]
        return p.redistribute(self.mesh.device_mesh, target).to_local(
            grad_placements=partial_grads(target, self.mesh.device_mesh))

    def _local_loss(self, views, tokens: torch.Tensor) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        if self.pipe == 1:
            return transformer.loss_fn(views, tokens, cfg, mesh)
        # Pipeline path: embed -> pipelined blocks -> head, on the data
        # block of the batch (the stages see it whole over fsdp).
        with torch.no_grad():
            tokens = all_gather(tokens, mesh, "fsdp", dim=0)
        inputs = transformer.seq_chunk(tokens[:, :-1], mesh)
        targets = transformer.seq_chunk(tokens[:, 1:], mesh)
        x = transformer.embed(views, inputs, cfg)
        L = x.shape[1]

        def stage_fn(stage_params, h):
            positions = transformer.positions_for(h.shape[0], L, mesh,
                                                  h.device)
            return transformer.run_blocks(stage_params, h, positions, cfg,
                                          mesh)

        # blocks: this stage's [n_layers / pipe, ...] -> [1, ...] stage dim
        stage_params = transformer._tree_map(lambda t: t[None],
                                             views["blocks"])
        x = pipeline_apply(stage_fn, stage_params, x, mesh,
                           num_microbatches=self.num_microbatches)
        return transformer.head_and_loss(views, x, targets, cfg)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank of the mesh."""
        for a in self.axes:
            dist.all_reduce(t, group=self.mesh.group(a))
        return t

    def views(self, params):
        """The compute views of a placed parameter tree."""
        return {k: transformer._tree_map(
                    lambda p: self._view(p, k in ("blocks", "moe_blocks")), v)
                for k, v in params.items()}

    def local_loss(self, params, tokens):
        """This rank's mean loss, through the compute views; the step
        differentiates it over the number of ranks."""
        if isinstance(tokens, DTensor):
            tokens = tokens.to_local()
        return self._local_loss(self.views(params), tokens)

    def loss_and_norm(self, loss, leaf_sq):
        """The global-batch mean loss and the whole gradient's norm, in one
        reduction. ``leaf_sq``: each leaf's local sum of g*g, in leaf
        order."""
        sq = (leaf_sq / self.copies).sum()
        stats = self._reduce(torch.stack([loss.detach() / self.mesh.size,
                                          sq]))
        return stats[0], torch.sqrt(stats[1])
