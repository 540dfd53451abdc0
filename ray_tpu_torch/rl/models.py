"""Policy/value networks and action distributions in PyTorch.

Port of ``ray_tpu/rl/models.py``. Parity with ``rllib/models/``
(``catalog.py`` fcnet defaults, ``torch/torch_action_dist.py``
Categorical/DiagGaussian). Networks are (init, apply) pairs over a
functional tree of tensors, the JAX package's layout
(``{"pi": {"layers": [{"w", "b"}]}, "vf": ..., "log_std"}``, weights
``[in, out]``), so that ``params_from_numpy`` carries the JAX package's
weights across and the learner steps the same leaves.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

_LOG_2PI = math.log(2 * math.pi)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves``'s order (dict keys
    sorted), so that two trees of one structure built in different key
    orders (a JAX tree carried across, a tree built here) pair leaf by
    leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree: Any, device) -> Any:
    """A tree of numpy arrays (the JAX package's ``jax.device_get`` of its
    parameters, or this module's ``to_numpy``) as fresh tensors on
    ``device``. Tensors are copied too, so the result aliases nothing."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        return torch.tensor(np.asarray(x), device=device)
    return tree_map(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """A host copy of a tree of tensors (what ``jax.device_get`` returns)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def mlp_init(generator: torch.Generator, in_dim: int, hidden: Sequence[int],
             out_dim: int, out_scale: float = 0.01,
             device=None) -> Dict[str, Any]:
    """Orthogonal-init MLP; small final layer like RLlib's fcnet. Draws
    from ``generator``, which lives on ``device``."""
    sizes = [in_dim, *hidden, out_dim]
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.empty((a, b), dtype=torch.float32, device=device)
        torch.nn.init.orthogonal_(
            w, gain=math.sqrt(2.0) if i < len(sizes) - 2 else out_scale,
            generator=generator)
        layers.append({"w": w, "b": torch.zeros((b,), dtype=torch.float32,
                                                device=device)})
    return {"layers": layers}


def mlp_apply(params: Dict[str, Any], x: torch.Tensor,
              activation: str = "tanh") -> torch.Tensor:
    act = torch.tanh if activation == "tanh" else torch.relu
    *hidden_layers, last = params["layers"]
    for lyr in hidden_layers:
        x = act(x @ lyr["w"] + lyr["b"])
    return x @ last["w"] + last["b"]


def actor_critic_init(generator: torch.Generator, obs_dim: int,
                      action_dim: int, hidden: Sequence[int] = (64, 64),
                      continuous: bool = False,
                      device=None) -> Dict[str, Any]:
    params = {
        "pi": mlp_init(generator, obs_dim, hidden, action_dim, device=device),
        "vf": mlp_init(generator, obs_dim, hidden, 1, out_scale=1.0,
                       device=device),
    }
    if continuous:
        params["log_std"] = torch.zeros((action_dim,), dtype=torch.float32,
                                        device=device)
    return params


def actor_critic_apply(params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (distribution inputs [B, A], value estimates [B])."""
    logits = mlp_apply(params["pi"], obs)
    values = mlp_apply(params["vf"], obs)[..., 0]
    return logits, values


def ppo_surrogate_loss(dist, values, batch, cfg, kl_coeff):
    """The PPO loss body: clipped surrogate + clipped vf error + entropy
    bonus + logp-ratio KL penalty (one copy of the math, as in the JAX
    package).

    ``batch`` needs OBS-aligned ACTIONS / ACTION_LOGP / ADVANTAGES /
    VALUE_TARGETS. Returns (total_loss, aux dict of 0-d tensors).
    """
    from ray_tpu_torch.rl.sample_batch import SampleBatch
    logp = dist.logp(batch[SampleBatch.ACTIONS])
    ratio = torch.exp(logp - batch[SampleBatch.ACTION_LOGP])
    surrogate = clipped_surrogate(ratio, batch[SampleBatch.ADVANTAGES],
                                  cfg.clip_param)
    vf_err = ((values - batch[SampleBatch.VALUE_TARGETS]) ** 2).clamp(
        max=cfg.vf_clip_param ** 2)
    entropy = dist.entropy()
    # Adaptive-KL penalty vs the behavior logp (the logp-ratio estimator
    # E[logp_old - logp], as the JAX package uses).
    kl = (batch[SampleBatch.ACTION_LOGP] - logp).clamp(min=-10.0)
    total = (-surrogate.mean()
             + cfg.vf_loss_coeff * 0.5 * vf_err.mean()
             - cfg.entropy_coeff * entropy.mean()
             + kl_coeff * kl.mean())
    aux = {"policy_loss": -surrogate.mean(),
           "vf_loss": 0.5 * vf_err.mean(),
           "entropy": entropy.mean(),
           "kl": kl.mean()}
    return total, aux


class Categorical:
    """Categorical over logits (rllib TorchCategorical equivalent)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max draws, as ``jax.random.categorical`` makes them."""
        u = torch.rand(self.logits.shape, generator=generator,
                       device=self.logits.device,
                       dtype=self.logits.dtype)
        u = u.clamp(min=torch.finfo(u.dtype).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1,
                            actions[..., None].long())[..., 0]

    def entropy(self) -> torch.Tensor:
        p = torch.exp(self.logits)
        return -torch.sum(p * self.logits, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        p = torch.exp(self.logits)
        return torch.sum(p * (self.logits - other.logits), dim=-1)

    def deterministic(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


class DiagGaussian:
    """Diagonal gaussian with state-independent log_std."""

    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean = mean
        self.log_std = torch.broadcast_to(log_std, mean.shape)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(self.log_std) * noise

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2 * self.log_std)
        ll = (-0.5 * ((actions - self.mean) ** 2 / var)
              - self.log_std - 0.5 * _LOG_2PI)
        return torch.sum(ll, dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        v0, v1 = torch.exp(2 * self.log_std), torch.exp(2 * other.log_std)
        return torch.sum(other.log_std - self.log_std
                         + (v0 + (self.mean - other.mean) ** 2) / (2 * v1)
                         - 0.5, dim=-1)

    def deterministic(self) -> torch.Tensor:
        return self.mean


def make_distribution(params: Dict[str, Any], dist_inputs: torch.Tensor,
                      continuous: bool):
    if continuous:
        return DiagGaussian(dist_inputs, params["log_std"])
    return Categorical(dist_inputs)


def clipped_surrogate(ratio: torch.Tensor, advantages: torch.Tensor,
                      clip_param: float) -> torch.Tensor:
    """PPO's pessimistic clipped objective, elementwise."""
    return torch.minimum(
        ratio * advantages,
        torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * advantages)


def num_params(params: Any) -> int:
    return int(sum(np.prod(p.shape) for p in tree_leaves(params)))
