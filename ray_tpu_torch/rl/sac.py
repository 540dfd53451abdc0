"""Soft Actor-Critic for continuous control.

Port of ``ray_tpu/rl/sac.py``. Parity with ``rllib/algorithms/sac/sac.py``
(training_step: sample -> replay -> critic/actor/alpha updates -> polyak
target sync) and ``sac_torch_policy.py`` (twin soft-Q losses,
reparameterized squashed-Gaussian actor, automatic entropy temperature).

As in the JAX package, critic, actor and temperature are ONE loss over
one parameter tree, stepped by one clip + Adam (the reference runs three
torch optimizers), then the polyak blend of the target critics; here the
update runs eagerly on the learner's device. Its two standard-normal
draws come from the learner's generator, or from the caller
(``SACLearner.update``), so that a test can feed the JAX learner's.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import Box
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.ppo import (adam_init, clip_adam_step_,
                                  opt_state_from_numpy, opt_state_to_numpy)
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.rl.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
AUX_KEYS = ("critic_loss", "actor_loss", "alpha", "entropy")
_USED = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
         SampleBatch.NEXT_OBS, SampleBatch.TERMINATEDS)


def _squash(u: torch.Tensor, scale: torch.Tensor,
            center: torch.Tensor) -> torch.Tensor:
    return torch.tanh(u) * scale + center


def _sample_squashed(actor_params, obs, noise, scale, center):
    """Reparameterized squashed-Gaussian sample -> (action, logp), from
    ``noise``, standard normal draws of the action's shape.

    logp includes the tanh change-of-variables correction
    (``sac_torch_policy.py`` SquashedGaussian logp).
    """
    out = _models.mlp_apply(actor_params, obs, activation="relu")
    mean, log_std = out.chunk(2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    u = mean + std * noise
    logp_u = torch.sum(
        -0.5 * ((u - mean) / std) ** 2 - log_std
        - 0.5 * math.log(2 * math.pi), dim=-1)
    # d tanh(u)/du = 1 - tanh(u)^2; scaled by the action range
    correction = torch.sum(
        torch.log(scale * (1 - torch.tanh(u) ** 2) + 1e-6), dim=-1)
    return _squash(u, scale, center), logp_u - correction


def action_box(spec, action_dim: int):
    """(scale, center) of a Box action space, per dimension, float32 numpy:
    ``Box.low``/``high`` may be scalars or arrays."""
    lo = np.broadcast_to(np.asarray(spec.action_space.low,
                                    np.float32).reshape(-1), (action_dim,))
    hi = np.broadcast_to(np.asarray(spec.action_space.high,
                                    np.float32).reshape(-1), (action_dim,))
    return ((hi - lo) / 2.0).astype(np.float32), \
        ((hi + lo) / 2.0).astype(np.float32)


class SquashedGaussianPolicy(Policy):
    """Tanh-squashed Gaussian actor with state-dependent std.

    Rollout workers hold only the actor; the twin critics live in the
    learner (they never act)."""

    def __init__(self, spec, config=None, seed: int = 0,
                 device: DeviceLike = None):
        # deliberately not calling Policy.__init__: SAC's parameter layout
        # (actor-only, 2*A outputs) differs from the shared actor-critic
        self.spec = spec
        self.config = dict(config or {})
        if not isinstance(spec.action_space, Box):
            raise ValueError("SAC requires a continuous (Box) action space")
        self.device = resolve_device(device)
        self.continuous = True
        obs_dim = int(np.prod(spec.observation_space.shape))
        self.action_dim = int(np.prod(spec.action_space.shape))
        hidden = tuple(self.config.get("fcnet_hiddens", (256, 256)))
        self._scale, self._center = action_box(spec, self.action_dim)
        self._scale_t = torch.as_tensor(self._scale, device=self.device)
        self._center_t = torch.as_tensor(self._center, device=self.device)
        self.params = {"actor": _models.mlp_init(
            torch.Generator(device=self.device).manual_seed(seed), obs_dim,
            hidden, 2 * self.action_dim, out_scale=0.01, device=self.device)}
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)

    @torch.no_grad()
    def compute_actions(self, obs, explore: bool = True):
        obs = self._obs(obs)
        if explore:
            shape = (obs.shape[0], self.action_dim)
            noise = torch.randn(shape, generator=self._generator,
                                device=self.device)
            actions, logp = _sample_squashed(
                self.params["actor"], obs, noise, self._scale_t,
                self._center_t)
        else:
            out = _models.mlp_apply(self.params["actor"], obs,
                                    activation="relu")
            mean, _ = out.chunk(2, dim=-1)
            actions = _squash(mean, self._scale_t, self._center_t)
            logp = torch.zeros(mean.shape[:-1], device=self.device)
        zeros = np.zeros(len(logp), np.float32)
        return actions.cpu().numpy(), logp.cpu().numpy(), zeros

    def value(self, obs):  # SAC workers have no value head
        return np.zeros(len(np.asarray(obs)), np.float32)


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.lr = 3e-4            # shared by actor/critic/alpha
        self.tau = 0.005          # polyak target blend
        self.initial_alpha = 1.0
        self.target_entropy = "auto"   # -action_dim
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 500
        self.n_updates_per_iter = 16
        # fragment > 1: add_next_obs drops the boundary row of each
        # fragment, so a length-1 fragment would yield zero transitions
        self.rollout_fragment_length = 8
        self.grad_clip = 40.0
        self.model = {"fcnet_hiddens": (256, 256)}


def q_apply(qp, obs, act):
    return _models.mlp_apply(qp, torch.cat([obs, act], dim=-1),
                             activation="relu")[..., 0]


def polyak_(target, online, tau: float) -> None:
    """target ← (1 − tau)·target + tau·online, in place, leaf by leaf."""
    with torch.no_grad():
        t = _models.tree_leaves(target)
        torch._foreach_mul_(t, 1 - tau)
        torch._foreach_add_(t, _models.tree_leaves(online), alpha=tau)


class SACLearner:
    """Twin soft-Q + squashed actor + auto temperature on one device."""

    def __init__(self, actor_params, obs_dim: int, action_dim: int,
                 scale: np.ndarray, center: np.ndarray, cfg: SACConfig,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.action_dim = action_dim
        hidden = tuple(cfg.model.get("fcnet_hiddens", (256, 256)))
        # the JAX package's jax.random.key(cfg.seed + 13) for both critics
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 13)
        q_in = obs_dim + action_dim
        params = {
            "actor": actor_params["actor"],
            "q1": _models.mlp_init(gen, q_in, hidden, 1, out_scale=1.0,
                                   device=self.device),
            "q2": _models.mlp_init(gen, q_in, hidden, 1, out_scale=1.0,
                                   device=self.device),
            "log_alpha": np.asarray(np.log(cfg.initial_alpha), np.float32),
        }
        if cfg.target_entropy == "auto":
            self.target_entropy = -float(action_dim)
        else:
            self.target_entropy = float(cfg.target_entropy)
        self._scale = torch.as_tensor(np.asarray(scale, np.float32),
                                      device=self.device)
        self._center = torch.as_tensor(np.asarray(center, np.float32),
                                       device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 4099)
        self.set_state((params, {"q1": params["q1"], "q2": params["q2"]},
                        None))

    def _loss(self, batch, noise_pi, y):
        p = self.params
        obs = batch[SampleBatch.OBS]
        acts = batch[SampleBatch.ACTIONS]
        q1 = q_apply(p["q1"], obs, acts)
        q2 = q_apply(p["q2"], obs, acts)
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)
        pi_a, pi_logp = _sample_squashed(p["actor"], obs, noise_pi,
                                         self._scale, self._center)
        # actor maximizes min-Q with entropy bonus; the critics are frozen
        # inside this term — the joint step must not let actor gradients
        # leak into Q
        detached = {k: _models.tree_map(torch.Tensor.detach, p[k])
                    for k in ("q1", "q2")}
        q_pi = torch.minimum(q_apply(detached["q1"], obs, pi_a),
                             q_apply(detached["q2"], obs, pi_a))
        cur_alpha = torch.exp(p["log_alpha"]).detach()
        actor_loss = torch.mean(cur_alpha * pi_logp - q_pi)
        alpha_loss = -p["log_alpha"] * torch.mean(
            pi_logp.detach() + self.target_entropy)
        total = critic_loss + actor_loss + alpha_loss
        aux = (critic_loss, actor_loss, torch.exp(p["log_alpha"]),
               -torch.mean(pi_logp))
        return total, aux

    def update(self, batch: Dict[str, torch.Tensor], noise_next: torch.Tensor,
               noise_pi: torch.Tensor) -> torch.Tensor:
        """One update on a batch already on the device, with the standard
        normal draws of the next action (``noise_next``) and of the
        policy's action (``noise_pi``), each [B, action_dim]. Returns the
        metrics (``AUX_KEYS``) as one tensor on the device."""
        p = self.params
        with torch.no_grad():
            # soft target: y = r + gamma (1-d) [min_i tQ_i(s',a') - a logp']
            next_obs = batch[SampleBatch.NEXT_OBS]
            next_a, next_logp = _sample_squashed(
                p["actor"], next_obs, noise_next, self._scale, self._center)
            alpha = torch.exp(p["log_alpha"])
            tq = torch.minimum(q_apply(self.target_q["q1"], next_obs, next_a),
                               q_apply(self.target_q["q2"], next_obs, next_a))
            not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
            y = (batch[SampleBatch.REWARDS]
                 + self.cfg.gamma * not_done * (tq - alpha * next_logp))
        leaves = _models.tree_leaves(p)
        loss, aux = self._loss(batch, noise_pi, y)
        grads = torch.autograd.grad(loss, leaves)
        clip_adam_step_(leaves, grads, self.opt_state, self.cfg.grad_clip,
                        self.cfg.lr)
        polyak_(self.target_q, {"q1": p["q1"], "q2": p["q2"]}, self.cfg.tau)
        return torch.stack([a.detach() for a in aux])

    def train(self, batch: SampleBatch) -> Dict[str, float]:
        arrays = batch_to_device(
            {k: v for k, v in batch.items() if k in _USED}, self.device)
        shape = (arrays[SampleBatch.OBS].shape[0], self.action_dim)
        noise_next, noise_pi = (
            torch.randn(shape, generator=self.generator, device=self.device)
            for _ in range(2))
        aux = self.update(arrays, noise_next, noise_pi)
        return dict(zip(AUX_KEYS, aux.tolist()))

    def actor_weights(self):
        return {"actor": _models.to_numpy(self.params["actor"])}

    def state(self):
        return (_models.to_numpy(self.params),
                _models.to_numpy(self.target_q),
                opt_state_to_numpy(self.opt_state))

    def set_state(self, state):
        p, t, o = state
        self.params = _models.params_from_numpy(p, self.device)
        for leaf in _models.tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.target_q = _models.params_from_numpy(t, self.device)
        self.opt_state = (adam_init(self.params) if o is None
                          else opt_state_from_numpy(o, self.device))


class SAC(Algorithm):
    _config_cls = SACConfig

    @classmethod
    def get_default_config(cls) -> SACConfig:
        return SACConfig(cls)

    def _needs_advantages(self) -> bool:
        return False

    def _worker_kwargs(self):
        kw = super()._worker_kwargs()
        kw["policy_cls"] = SquashedGaussianPolicy
        return kw

    def _make_learner(self) -> SACLearner:
        cfg = self.algo_config
        lw = self.workers.local_worker
        spec = lw.get_spec()
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        obs_dim = int(np.prod(spec.observation_space.shape))
        action_dim = int(np.prod(spec.action_space.shape))
        pol = lw.policy
        return SACLearner(lw.get_weights(), obs_dim, action_dim,
                          pol._scale, pol._center, cfg, device=self.device)

    def training_step(self) -> Dict[str, Any]:
        return replay_training_step(self)

    def _learner_state(self):
        return {"learner": self.learner.state()}

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state["learner"])


def replay_training_step(algo: Algorithm) -> Dict[str, Any]:
    """SAC's and TD3's ``training_step``: one sampling round into the
    replay buffer, then ``n_updates_per_iter`` updates on replayed batches
    once enough steps are stored, then the actor's weights to the local
    worker."""
    from ray_tpu_torch.rl.postprocessing import add_next_obs
    cfg = algo.algo_config
    algo.workers.sync_weights()
    batch = synchronous_parallel_sample(algo.workers, max_env_steps=1)
    batch = add_next_obs(batch)
    algo.replay.add(batch)
    algo._timesteps_total += len(batch)
    metrics: Dict[str, Any] = {"timesteps_this_iter": len(batch)}
    if algo._timesteps_total < cfg.num_steps_sampled_before_learning_starts:
        metrics["learning"] = False
        return metrics
    auxes = []
    for _ in range(cfg.n_updates_per_iter):
        auxes.append(algo.learner.train(
            algo.replay.sample(cfg.train_batch_size)))
    algo.workers.local_worker.set_weights(algo.learner.actor_weights())
    metrics.update(learning=True, replay_size=len(algo.replay),
                   **{k: float(np.mean([a[k] for a in auxes]))
                      for k in auxes[-1]})
    return metrics
