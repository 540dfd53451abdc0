"""Advantage Actor-Critic (synchronous A2C).

Port of ``ray_tpu/rl/a2c.py``, copied. Parity with ``rllib/algorithms/a2c``:
synchronous on-policy rollouts, one vanilla policy-gradient pass per batch
with a value-function baseline and entropy bonus.

Implementation: the PPO learner evaluated at its fixed point. With ONE
sgd pass over freshly collected data, ``logp == logp_old`` so the
importance ratio is 1 everywhere; the gradient of ``ratio * adv`` then
equals ``grad logp * adv`` — the exact vanilla-PG estimator — and an
unbounded clip range plus ``kl_coeff=0`` removes the trust-region
machinery. A2C is therefore a CONFIG of the PPO learner, not a second
learner to maintain (same minibatch schedule, ``ppo.py``).
"""

from __future__ import annotations

from ray_tpu_torch.rl.ppo import PPO, PPOConfig


class A2CConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A2C)
        self.lr = 1e-3
        # ONE full-batch step per (small, frequent) batch — A2C's
        # classic shape. With minibatches, passes after the first would
        # run off-policy with no clip (unbounded ratio): the vanilla-PG
        # equivalence only holds at batch granularity.
        self.train_batch_size = 200
        self.sgd_minibatch_size = 200
        self.num_sgd_iter = 1       # single pass => exact vanilla PG
        self.clip_param = 1e9       # ratio is 1 on the first pass anyway
        self.kl_coeff = 0.0
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.rollout_fragment_length = 25


class A2C(PPO):
    _config_cls = A2CConfig

    @classmethod
    def get_default_config(cls) -> A2CConfig:
        return A2CConfig(cls)
