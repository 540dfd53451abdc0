"""Policy: parameters + action computation on one device.

Port of ``ray_tpu/rl/policy.py``. Parity with ``rllib/policy/policy.py`` +
``torch_policy.py`` (``compute_actions`` ``torch_policy.py:231``,
``get/set_weights``). Parameters are one functional tree of tensors on the
policy's device (``models.py``); ``get_weights`` returns a host numpy copy,
as ``jax.device_get`` does in the JAX package, so that weight syncs and
checkpoints carry no device tensors.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.env import Box, EnvSpec


class Policy:
    """Actor-critic policy over an MLP; subclass for custom networks.

    ``device`` holds the parameters and runs the networks; ``None`` means
    ``cuda``. Rollout workers pass ``"cpu"`` (``algorithm.py``)."""

    def __init__(self, spec: EnvSpec, config: Optional[dict] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.spec = spec
        self.config = dict(config or {})
        self.device = resolve_device(device)
        self.continuous = isinstance(spec.action_space, Box)
        obs_dim = int(np.prod(spec.observation_space.shape))
        if self.continuous:
            self.action_dim = int(np.prod(spec.action_space.shape))
        else:
            self.action_dim = spec.action_space.n
        hidden = tuple(self.config.get("fcnet_hiddens", (64, 64)))
        self.params = _models.actor_critic_init(
            torch.Generator(device=self.device).manual_seed(seed), obs_dim,
            self.action_dim, hidden, continuous=self.continuous,
            device=self.device)
        # The JAX package's jax.random.key(seed + 1).
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)

    def _obs(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    # -- acting ------------------------------------------------------------

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (actions, action_logp, vf_preds), all host numpy."""
        dist_inputs, values = _models.actor_critic_apply(self.params,
                                                         self._obs(obs))
        dist = _models.make_distribution(self.params, dist_inputs,
                                         self.continuous)
        if explore:
            actions = dist.sample(self._generator)
        else:
            actions = dist.deterministic()
        logp = dist.logp(actions)
        actions = actions.cpu().numpy()
        if self.continuous:
            lo = self.spec.action_space.low
            hi = self.spec.action_space.high
            actions = np.clip(actions, lo, hi)
        return actions, logp.cpu().numpy(), values.cpu().numpy()

    @torch.no_grad()
    def value(self, obs: np.ndarray) -> np.ndarray:
        _, values = _models.actor_critic_apply(self.params, self._obs(obs))
        return values.cpu().numpy()

    # -- weights -----------------------------------------------------------

    def get_weights(self) -> Any:
        return _models.to_numpy(self.params)

    def set_weights(self, weights: Any) -> None:
        self.params = _models.params_from_numpy(weights, self.device)
