"""Deep Q-Networks with replay and target network.

Port of ``ray_tpu/rl/dqn.py``. Parity with ``rllib/algorithms/dqn/dqn.py``
(training_step: sample -> store -> replay-sample -> TD update -> target
sync every ``target_network_update_freq``) with double-Q and prioritized
replay. The TD update runs eagerly on the learner's device; the target
network is a second parameter tree there. Each update reads its loss and
TD errors back to the host in one copy, for the replay priorities
(``DQNLearner.host_reads`` counts them).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.ppo import (adam_init, clip_adam_step_,
                                  opt_state_from_numpy, opt_state_to_numpy)
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            ReplayBuffer)
from ray_tpu_torch.rl.rollout_worker import synchronous_parallel_sample
from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device

_USED = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
         SampleBatch.NEXT_OBS, SampleBatch.TERMINATEDS, "weights")


class EpsilonGreedyPolicy(Policy):
    """Q-network policy with epsilon-greedy exploration."""

    def __init__(self, spec, config=None, seed: int = 0, device=None):
        super().__init__(spec, config, seed, device=device)
        if self.continuous:
            raise ValueError("DQN requires a discrete action space")
        self.epsilon = float((config or {}).get("initial_epsilon", 1.0))

    @torch.no_grad()
    def compute_actions(self, obs, explore: bool = True):
        q = _models.mlp_apply(self.params["pi"], self._obs(obs),
                              activation="relu")
        greedy = torch.argmax(q, dim=-1)
        eps = self.epsilon if explore else 0.0
        rand = torch.randint(0, q.shape[-1], greedy.shape,
                             generator=self._generator, device=self.device)
        explore_mask = torch.rand(greedy.shape, generator=self._generator,
                                  device=self.device) < eps
        actions = torch.where(explore_mask, rand, greedy).cpu().numpy()
        zeros = np.zeros(len(actions), np.float32)
        return actions, zeros, zeros

    def set_epsilon(self, epsilon: float) -> None:
        self.epsilon = float(epsilon)


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 1000
        # Gradient updates between target-net syncs. Too-frequent syncing
        # silently destroys learning (bootstrap chases itself): an ablation
        # on random-policy CartPole replay gives greedy return 9.8 at
        # freq=16 vs 185 at freq=64.
        self.target_network_update_freq = 200
        self.double_q = True
        self.n_updates_per_iter = 8
        self.epsilon_timesteps = 10_000
        self.final_epsilon = 0.02
        self.rollout_fragment_length = 4
        self.grad_clip = 40.0


def huber_loss(predictions: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """``optax.huber_loss`` with δ = 1, elementwise: 0.5·min(|e|, 1)² +
    (|e| − min(|e|, 1))."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp(abs_errors, max=1.0)
    return 0.5 * quadratic ** 2 + (abs_errors - quadratic)


class DQNLearner:
    """The TD update on one device: online and target Q-networks and the
    clip + Adam state."""

    def __init__(self, init_params, cfg: DQNConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.host_reads = 0
        self.set_state((init_params, init_params, None))

    def _loss(self, batch):
        p = self.params
        q = _models.mlp_apply(p["pi"], batch[SampleBatch.OBS],
                              activation="relu")
        qa = torch.gather(q, -1, batch[SampleBatch.ACTIONS][:, None].long()
                          )[:, 0]
        with torch.no_grad():
            q_next_t = _models.mlp_apply(
                self.target_params["pi"], batch[SampleBatch.NEXT_OBS],
                activation="relu")
            if self.cfg.double_q:   # the online net picks the action
                best = torch.argmax(_models.mlp_apply(
                    p["pi"], batch[SampleBatch.NEXT_OBS], activation="relu"),
                    dim=-1)
            else:
                best = torch.argmax(q_next_t, dim=-1)
            q_next = torch.gather(q_next_t, -1, best[:, None])[:, 0]
            not_done = 1.0 - batch[SampleBatch.TERMINATEDS].float()
            target = (batch[SampleBatch.REWARDS]
                      + self.cfg.gamma * not_done * q_next)
        td_error = qa.detach() - target
        weights = batch.get("weights")
        loss = huber_loss(qa, target)
        if weights is not None:
            loss = weights * loss
        return loss.mean(), td_error

    def update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One TD update on a batch already on the device. Returns [loss,
        td_error...] as one tensor on the device."""
        leaves = _models.tree_leaves(self.params)
        loss, td_error = self._loss(batch)
        # the value head ("vf") takes no part: a zero gradient, as under
        # jax.grad, which leaves it where it is
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        clip_adam_step_(leaves, grads, self.opt_state, self.cfg.grad_clip,
                        self.cfg.lr)
        return torch.cat([loss.detach()[None], td_error])

    def train(self, batch: SampleBatch):
        """-> (loss, TD errors as numpy): one device->host read."""
        used = {k: v for k, v in batch.items() if k in _USED}
        out = self.update(batch_to_device(used, self.device)).cpu().numpy()
        self.host_reads += 1
        return float(out[0]), out[1:]

    def update_target(self) -> None:
        with torch.no_grad():
            torch._foreach_copy_(_models.tree_leaves(self.target_params),
                                 _models.tree_leaves(self.params))

    def get_weights(self):
        return _models.to_numpy(self.params)

    def state(self):
        return (self.get_weights(), _models.to_numpy(self.target_params),
                opt_state_to_numpy(self.opt_state))

    def set_state(self, state):
        p, t, o = state
        self.params = _models.params_from_numpy(p, self.device)
        for leaf in _models.tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.target_params = _models.params_from_numpy(t, self.device)
        self.opt_state = (adam_init(self.params) if o is None
                          else opt_state_from_numpy(o, self.device))


class DQN(Algorithm):
    _config_cls = DQNConfig

    @classmethod
    def get_default_config(cls) -> DQNConfig:
        return DQNConfig(cls)

    def _needs_advantages(self) -> bool:
        return False

    def _worker_kwargs(self):
        kw = super()._worker_kwargs()
        kw["policy_cls"] = EpsilonGreedyPolicy
        return kw

    def _make_learner(self) -> DQNLearner:
        cfg = self.algo_config
        self._steps_since_target_sync = 0
        if cfg.prioritized_replay:
            self.replay = PrioritizedReplayBuffer(
                cfg.replay_buffer_capacity, cfg.prioritized_replay_alpha,
                seed=cfg.seed)
        else:
            self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                       seed=cfg.seed)
        return DQNLearner(self.workers.local_worker.get_weights(), cfg,
                          device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        self.workers.sync_weights()
        self._update_epsilon()
        batch = synchronous_parallel_sample(self.workers, max_env_steps=1)
        batch = self._with_next_obs(batch)
        self.replay.add(batch)
        self._timesteps_total += len(batch)
        metrics: Dict[str, Any] = {"timesteps_this_iter": len(batch)}
        if self._timesteps_total < cfg.num_steps_sampled_before_learning_starts:
            metrics["learning"] = False
            return metrics
        losses = []
        for _ in range(cfg.n_updates_per_iter):
            if cfg.prioritized_replay:
                train_batch = self.replay.sample(
                    cfg.train_batch_size, beta=cfg.prioritized_replay_beta)
            else:
                train_batch = self.replay.sample(cfg.train_batch_size)
            loss, td_error = self.learner.train(train_batch)
            if cfg.prioritized_replay:
                self.replay.update_priorities(
                    train_batch["batch_indexes"], td_error)
            losses.append(loss)
            self._steps_since_target_sync += 1
            if self._steps_since_target_sync >= cfg.target_network_update_freq:
                self.learner.update_target()
                self._steps_since_target_sync = 0
        self.workers.local_worker.set_weights(self.learner.get_weights())
        metrics.update(learning=True, mean_td_loss=float(np.mean(losses)),
                       epsilon=self.workers.local_worker.policy.epsilon,
                       replay_size=len(self.replay))
        return metrics

    def _update_epsilon(self) -> None:
        cfg = self.algo_config
        frac = min(1.0, self._timesteps_total / max(1, cfg.epsilon_timesteps))
        eps = 1.0 + frac * (cfg.final_epsilon - 1.0)

        def setter(w, eps=eps):
            w.policy.set_epsilon(eps)

        self.workers.local_worker.policy.set_epsilon(eps)
        if self.workers.remote_workers:
            import ray_tpu_torch
            ray_tpu_torch.get([w.apply.remote(setter)
                               for w in self.workers.remote_workers])

    def _with_next_obs(self, batch: SampleBatch) -> SampleBatch:
        from ray_tpu_torch.rl.postprocessing import add_next_obs
        return add_next_obs(batch)

    def _learner_state(self):
        return {"learner": self.learner.state(),
                "target_sync": self._steps_since_target_sync}

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state["learner"])
            self._steps_since_target_sync = state["target_sync"]
