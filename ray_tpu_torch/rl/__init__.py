"""ray_tpu_torch.rl — reinforcement learning with a PyTorch learner.

Port of ``ray_tpu/rl`` (the reference's RLlib, ``rllib/``, SURVEY §2.6):
``Algorithm`` is a Tune ``Trainable`` whose ``training_step`` composes
rollout collection from CPU env actors with a learner on one device (the
card unless ``resources(device="cpu")``). The numpy modules (envs, sample
batches, GAE, connectors, the external env, replay buffers, the rollout
workers, the multi-agent envs and worker, the offline dataset IO, ``a2c``,
``ddpg`` and ``es``) are copied; ``models``, ``policy`` and the learners
are written in torch, each holding its parameters and optimizer state in
the JAX package's tree layout: PPO and A2C, the memory models
(``use_lstm`` / ``use_attention``, ``recurrent``) for PPO and IMPALA,
IMPALA/APPO, DQN, SAC, TD3/DDPG, ES/ARS (numpy only: no learner, no
device), DD-PPO (each worker actor a learner, gradients allreduced through
``ray_tpu_torch.collective``), independent multi-agent PPO (a PPO learner
a policy), QMIX, and the offline BC, MARWIL and CQL. Where the JAX package
shards a PPO learner's batch over a device mesh, ``resources(mesh=)`` runs
it SPMD over the ranks of a ``torch.distributed`` world
(``parallel.run_spmd``): replicated parameters, each minibatch's rows split
over the mesh's data axes, the gradient summed over them.
"""

from ray_tpu_torch.rl.a2c import A2C, A2CConfig
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.connectors import (ClipActions, ClipObs, Connector,
                                   ConnectorPipeline, FlattenObs,
                                   FrameStack, NormalizeObs, ScaleActions,
                                   build_connectors, register_connector)
from ray_tpu_torch.rl.ddpg import DDPG, DDPGConfig
from ray_tpu_torch.rl.ddppo import DDPPO, DDPPOConfig
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.env import (CartPoleEnv, EnvSpec, MemoryCueEnv, PendulumEnv,
                            VectorEnv, make_env, register_env)
from ray_tpu_torch.rl.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rl.external_env import ExternalEnv, ExternalEnvSampler
from ray_tpu_torch.rl.qmix import QMIX, QMIXConfig
from ray_tpu_torch.rl.recurrent import RecurrentPolicy
from ray_tpu_torch.rl.impala import (APPO, APPOConfig, Impala,
                               ImpalaConfig)
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.multi_agent import (CoordinationGameEnv, MultiAgentBatch,
                                    MultiAgentEnv, MultiAgentPPO,
                                    MultiAgentPPOConfig,
                                    MultiAgentRolloutWorker,
                                    RockPaperScissorsEnv,
                                    TwoStepCooperativeGameEnv,
                                    register_multi_agent_env)
from ray_tpu_torch.rl.offline import (BC, BCConfig, CQL, CQLConfig, MARWIL,
                                MARWILConfig, collect_dataset,
                                read_dataset, write_dataset)
from ray_tpu_torch.rl.sac import SAC, SACConfig
from ray_tpu_torch.rl.td3 import TD3, TD3Config
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rl.rollout_worker import (RolloutWorker, WorkerSet,
                                       synchronous_parallel_sample)
from ray_tpu_torch.rl.sample_batch import SampleBatch, concat_samples

__all__ = [
    "Algorithm", "AlgorithmConfig", "Policy", "SampleBatch", "concat_samples",
    "RolloutWorker", "WorkerSet", "synchronous_parallel_sample",
    "ReplayBuffer", "PrioritizedReplayBuffer",
    "PPO", "PPOConfig", "A2C", "A2CConfig", "DQN", "DQNConfig",
    "Impala", "ImpalaConfig", "APPO", "APPOConfig",
    "SAC", "SACConfig", "TD3", "TD3Config", "DDPG", "DDPGConfig",
    "DDPPO", "DDPPOConfig", "ES", "ESConfig", "ARS", "ARSConfig",
    "QMIX", "QMIXConfig", "RecurrentPolicy",
    "ExternalEnv", "ExternalEnvSampler",
    "Connector", "ConnectorPipeline", "build_connectors",
    "register_connector", "FlattenObs", "ClipObs", "NormalizeObs",
    "FrameStack", "ClipActions", "ScaleActions",
    "BC", "BCConfig", "CQL", "CQLConfig", "MARWIL", "MARWILConfig",
    "collect_dataset", "read_dataset", "write_dataset",
    "MultiAgentEnv", "MultiAgentBatch", "MultiAgentRolloutWorker",
    "MultiAgentPPO", "MultiAgentPPOConfig", "CoordinationGameEnv",
    "RockPaperScissorsEnv", "TwoStepCooperativeGameEnv",
    "register_multi_agent_env",
    "CartPoleEnv", "MemoryCueEnv", "PendulumEnv", "VectorEnv", "EnvSpec",
    "make_env", "register_env",
]
