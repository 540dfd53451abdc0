"""Twin Delayed DDPG (TD3) for continuous control.

Port of ``ray_tpu/rl/td3.py``. Parity with ``rllib/algorithms/td3`` (DDPG
with the three TD3 fixes: twin critics with min-target, target policy
smoothing, delayed policy updates). Shares SAC's runtime shape
(``sac.py``): replay-driven training with the critic, actor and target
updates of one step run eagerly on the learner's device. The delayed
actor update is a host-side branch on the step count (the JAX package
compiles two variants of one program); a critic-only step touches neither
the actor, nor its optimizer state, nor the targets.
"""

from __future__ import annotations

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
from ray_tpu_torch.rl.sac import (_USED, _squash, action_box, polyak_,
                                  q_apply, replay_training_step)
from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device

AUX_KEYS = ("critic_loss", "actor_loss", "q_mean")


class DeterministicPolicy(Policy):
    """tanh-squashed deterministic actor with additive Gaussian
    exploration noise (DDPG/TD3 behavior policy)."""

    def __init__(self, spec, config=None, seed: int = 0,
                 device: DeviceLike = None):
        self.spec = spec
        self.config = dict(config or {})
        if not isinstance(spec.action_space, Box):
            raise ValueError("TD3 requires a continuous (Box) action space")
        self.device = resolve_device(device)
        self.continuous = True
        obs_dim = int(np.prod(spec.observation_space.shape))
        self.action_dim = int(np.prod(spec.action_space.shape))
        hidden = tuple(self.config.get("fcnet_hiddens", (256, 256)))
        self._scale, self._center = action_box(spec, self.action_dim)
        self._scale_t = torch.as_tensor(self._scale, device=self.device)
        self._center_t = torch.as_tensor(self._center, device=self.device)
        self.explore_noise = float(self.config.get("explore_noise", 0.1))
        self.params = {"actor": _models.mlp_init(
            torch.Generator(device=self.device).manual_seed(seed), obs_dim,
            hidden, self.action_dim, out_scale=0.01, device=self.device)}
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)

    @torch.no_grad()
    def compute_actions(self, obs, explore: bool = True):
        scale, center = self._scale_t, self._center_t
        u = _models.mlp_apply(self.params["actor"], self._obs(obs),
                              activation="relu")
        a = _squash(u, scale, center)
        if explore:
            noise = self.explore_noise * scale * torch.randn(
                a.shape, generator=self._generator, device=self.device)
            a = torch.clamp(a + noise, center - scale, center + scale)
        actions = a.cpu().numpy()
        zeros = np.zeros(len(actions), np.float32)
        return actions, zeros, zeros

    def value(self, obs):
        return np.zeros(len(np.asarray(obs)), np.float32)


class TD3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        # original-paper values (lr 1e-3); tau doubled because targets
        # advance only on delayed (every policy_delay-th) steps here
        self.lr = 1e-3
        self.tau = 0.01
        self.policy_delay = 2          # critic steps per actor step
        self.target_noise = 0.2        # target policy smoothing std
        self.target_noise_clip = 0.5
        self.twin_q = True             # False = plain DDPG critic
        self.explore_noise = 0.1
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 500
        self.n_updates_per_iter = 16
        self.rollout_fragment_length = 8
        self.grad_clip = 40.0
        self.model = {"fcnet_hiddens": (256, 256)}


class TD3Learner:
    """Twin critics + delayed deterministic actor on one device, with two
    clip + Adam optimizers: the delayed actor update must not advance any
    optimizer state on critic-only steps (a shared Adam would keep moving
    the actor on decayed momentum)."""

    def __init__(self, actor_params, obs_dim: int, action_dim: int,
                 scale: np.ndarray, center: np.ndarray, cfg: TD3Config,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        hidden = tuple(cfg.model.get("fcnet_hiddens", (256, 256)))
        # the JAX package's jax.random.key(cfg.seed + 17) for both critics
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 17)
        q_in = obs_dim + action_dim
        cparams = {
            "q1": _models.mlp_init(gen, q_in, hidden, 1, out_scale=1.0,
                                   device=self.device),
            "q2": _models.mlp_init(gen, q_in, hidden, 1, out_scale=1.0,
                                   device=self.device),
        }
        aparams = {"actor": actor_params["actor"]}
        self._scale = torch.as_tensor(np.asarray(scale, np.float32),
                                      device=self.device)
        self._center = torch.as_tensor(np.asarray(center, np.float32),
                                       device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 5077)
        self.set_state((cparams, aparams, {**cparams, **aparams}, None, None,
                        0))

    def _actor_apply(self, ap, obs):
        return _squash(_models.mlp_apply(ap, obs, activation="relu"),
                       self._scale, self._center)

    def update(self, batch: Dict[str, torch.Tensor], noise: torch.Tensor,
               do_actor: bool) -> torch.Tensor:
        """One critic step, and the actor's and the targets' when
        ``do_actor``, on a batch already on the device; ``noise`` is the
        standard normal draw of the target action's smoothing noise, [B,
        action_dim]. Returns the metrics (``AUX_KEYS``) as one tensor."""
        cfg = self.cfg
        obs = batch[SampleBatch.OBS]
        nxt = batch[SampleBatch.NEXT_OBS]
        scale, center = self._scale, self._center
        with torch.no_grad():
            # target policy smoothing: clipped noise on the target action
            ta = self._actor_apply(self.target["actor"], nxt)
            tn, tn_clip = cfg.target_noise, cfg.target_noise_clip
            noise = torch.clamp(tn * scale * noise, -tn_clip * scale,
                                tn_clip * scale)
            ta = torch.clamp(ta + noise, center - scale, center + scale)
            # DDPG (twin_q=False) bootstraps and regresses a single critic;
            # TD3 takes the min of twins.
            tq = q_apply(self.target["q1"], nxt, ta)
            if cfg.twin_q:
                tq = torch.minimum(tq, q_apply(self.target["q2"], nxt, ta))
            not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
            y = batch[SampleBatch.REWARDS] + cfg.gamma * not_done * tq
        cp = self.cparams
        q1 = q_apply(cp["q1"], obs, batch[SampleBatch.ACTIONS])
        closs = torch.mean((q1 - y) ** 2)
        # the critic step's leaves: DDPG's q2 takes no part in its loss
        # and gets a zero gradient, as under jax.grad
        if cfg.twin_q:
            q2 = q_apply(cp["q2"], obs, batch[SampleBatch.ACTIONS])
            closs = closs + torch.mean((q2 - y) ** 2)
        cleaves = _models.tree_leaves(cp)
        cgrads = torch.autograd.grad(closs, cleaves, allow_unused=True,
                                     materialize_grads=True)
        clip_adam_step_(cleaves, cgrads, self.copt_state, cfg.grad_clip,
                        cfg.lr)
        aloss = torch.zeros((), device=self.device)
        if do_actor:
            # the actor's loss reads q1 AFTER this step's critic update
            aleaves = _models.tree_leaves(self.aparams)
            pi_a = self._actor_apply(self.aparams["actor"], obs)
            aloss = -torch.mean(q_apply(cp["q1"], obs, pi_a))
            agrads = torch.autograd.grad(aloss, aleaves)
            clip_adam_step_(aleaves, agrads, self.aopt_state, cfg.grad_clip,
                            cfg.lr)
            # targets advance only on delayed steps (original TD3)
            polyak_(self.target, {**cp, **self.aparams}, cfg.tau)
        return torch.stack([closs.detach(), aloss.detach(),
                            q1.detach().mean()])

    def train(self, batch: SampleBatch) -> Dict[str, float]:
        self._step_count += 1
        do_actor = self._step_count % self.cfg.policy_delay == 0
        arrays = batch_to_device(
            {k: v for k, v in batch.items() if k in _USED}, self.device)
        noise = torch.randn(arrays[SampleBatch.ACTIONS].shape,
                            generator=self.generator, device=self.device)
        aux = self.update(arrays, noise, do_actor)
        return dict(zip(AUX_KEYS, aux.tolist()))

    def actor_weights(self):
        return {"actor": _models.to_numpy(self.aparams["actor"])}

    def state(self):
        return (_models.to_numpy(self.cparams),
                _models.to_numpy(self.aparams),
                _models.to_numpy(self.target),
                opt_state_to_numpy(self.copt_state),
                opt_state_to_numpy(self.aopt_state), self._step_count)

    def set_state(self, state):
        cp, ap, t, co, ao, c = state
        self.cparams = _models.params_from_numpy(cp, self.device)
        self.aparams = _models.params_from_numpy(ap, self.device)
        for leaf in _models.tree_leaves((self.cparams, self.aparams)):
            leaf.requires_grad_(True)
        self.target = _models.params_from_numpy(t, self.device)
        self.copt_state = (adam_init(self.cparams) if co is None
                           else opt_state_from_numpy(co, self.device))
        self.aopt_state = (adam_init(self.aparams) if ao is None
                           else opt_state_from_numpy(ao, self.device))
        self._step_count = int(c)


class TD3(Algorithm):
    _config_cls = TD3Config

    @classmethod
    def get_default_config(cls) -> TD3Config:
        return TD3Config(cls)

    def _needs_advantages(self) -> bool:
        return False

    def _worker_kwargs(self):
        kw = super()._worker_kwargs()
        kw["policy_cls"] = DeterministicPolicy
        cfg = dict(kw.get("policy_config") or {})
        cfg.setdefault("explore_noise", self.algo_config.explore_noise)
        kw["policy_config"] = cfg
        return kw

    def _make_learner(self) -> TD3Learner:
        cfg = self.algo_config
        lw = self.workers.local_worker
        spec = lw.get_spec()
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        obs_dim = int(np.prod(spec.observation_space.shape))
        action_dim = int(np.prod(spec.action_space.shape))
        pol = lw.policy
        return TD3Learner(lw.get_weights(), obs_dim, action_dim,
                          pol._scale, pol._center, cfg, device=self.device)

    def training_step(self) -> Dict[str, Any]:
        return replay_training_step(self)

    def _learner_state(self):
        return {"learner": self.learner.state()}

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state["learner"])
