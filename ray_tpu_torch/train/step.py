"""The training step of the flagship transformer, on one device.

Port of ``ray_tpu/train/step.py:make_lm_train_step``. It keeps the
contract: ``(init_fn, step_fn, shard_batch)``, with
``step_fn(state, tokens) -> (state, {"loss", "grad_norm"})`` and
``state = (params, opt_state)``. What differs from the JAX step:

- one device only: the ``mesh``, ``rules`` and ``num_microbatches``
  arguments wait for ``ray_tpu_torch.parallel`` and raise if given;
- ``init_fn`` takes a ``torch.Generator`` in place of a PRNG key, or the
  weights to start from (``params=``, e.g. from ``params_from_numpy``);
- ``opt_state`` is the ``torch.optim.Optimizer`` over the parameter
  leaves, and ``step_fn`` updates params and optimizer in place and returns
  the same state: the counterpart of ``donate_argnums=(0,)``;
- no ``jit``: PyTorch runs eagerly. ``goodput.instrument_jit`` waits for
  the port of ``observability/``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def adamw(lr: float = 3e-4, weight_decay: float = 0.01) -> OptimizerFactory:
    """``optax.adamw(lr, weight_decay=...)`` as a torch optimizer factory:
    betas (0.9, 0.999), eps 1e-8, decoupled decay on every leaf (norms
    included: optax applies no mask)."""
    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
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
                       rules: Any = None,
                       optimizer: Optional[OptimizerFactory] = None,
                       num_microbatches: Optional[int] = None,
                       device: DeviceLike = None):
    """Build ``(init_fn, step_fn, shard_batch)`` for language-model training
    on ``device`` (default ``cuda``).

    ``optimizer`` builds a torch optimizer from the list of parameter
    leaves; the default is ``adamw()``, the JAX step's
    ``optax.adamw(3e-4, weight_decay=0.01)``.
    """
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "sharded training (mesh, rules) waits for ray_tpu_torch.parallel;"
            " this step runs on one device")
    if num_microbatches is not None:
        raise NotImplementedError(
            "pipeline microbatches wait for ray_tpu_torch.parallel; this "
            "step runs on one device")
    device = resolve_device(device)
    make_optimizer = optimizer or adamw()

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
        leaves = transformer.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return params, make_optimizer(leaves)

    def step_fn(state, tokens: torch.Tensor
                ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        params, opt = state
        leaves = transformer.leaves(params)
        loss = transformer.loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            # optax.global_norm: the L2 norm over every leaf of the raw grads.
            grad_norm = torch.sqrt(sum(g.square().sum() for g in grads))
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            for p in leaves:
                p.grad = None
        return (params, opt), {"loss": loss.detach(), "grad_norm": grad_norm}

    def shard_batch(tokens) -> torch.Tensor:
        """Place a token batch (numpy or tensor) on the step's device."""
        return torch.as_tensor(tokens).to(device)

    return init_fn, step_fn, shard_batch
