"""Deep Deterministic Policy Gradient.

Port of ``ray_tpu/rl/ddpg.py``, copied. Parity with
``rllib/algorithms/ddpg`` (Lillicrap et al. 2016). TD3 is DDPG plus
three fixes (twin critics, target smoothing, delayed actor); this runtime
expresses the ancestor the same way APPO is expressed over IMPALA
(``impala.py``): DDPG IS the TD3 machinery configured back to the
original algorithm — single critic (``twin_q=False``), no target-policy
smoothing (``target_noise=0``), actor updated every step
(``policy_delay=1``), per-step soft target updates (tau halved back).
One code path, both papers, the same update (``TD3Learner``).
"""

from __future__ import annotations

from ray_tpu_torch.rl.td3 import TD3, TD3Config


class DDPGConfig(TD3Config):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0
        self.target_noise_clip = 0.0
        self.tau = 0.005  # per-step soft updates (TD3 doubles for delay)


class DDPG(TD3):
    _config_cls = DDPGConfig

    @classmethod
    def get_default_config(cls) -> DDPGConfig:
        return DDPGConfig(cls)
