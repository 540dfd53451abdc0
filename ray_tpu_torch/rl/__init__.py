"""ray_tpu_torch.rl — reinforcement learning with a PyTorch learner.

Port of ``ray_tpu/rl`` (the reference's RLlib, ``rllib/``, SURVEY §2.6):
``Algorithm`` is a Tune ``Trainable`` whose ``training_step`` composes
rollout collection from CPU env actors with a learner on one device (the
card unless ``resources(device="cpu")``). The numpy modules (envs, sample
batches, GAE, connectors, the external env, replay buffers, the rollout
workers) are copied; ``models``, ``policy`` and ``ppo`` are written in
torch. This slice ports PPO and A2C; the other algorithms of the JAX
package (``recurrent``, DD-PPO and the mesh learner, DQN, IMPALA/APPO,
SAC, TD3/DDPG, ES/ARS, QMIX, multi-agent, offline) are still to port
(ROADMAP Queue 1).
"""

from ray_tpu_torch.rl.a2c import A2C, A2CConfig
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.connectors import (ClipActions, ClipObs, Connector,
                                         ConnectorPipeline, FlattenObs,
                                         FrameStack, NormalizeObs,
                                         ScaleActions, build_connectors,
                                         register_connector)
from ray_tpu_torch.rl.env import (CartPoleEnv, EnvSpec, MemoryCueEnv,
                                  PendulumEnv, VectorEnv, make_env,
                                  register_env)
from ray_tpu_torch.rl.external_env import ExternalEnv, ExternalEnvSampler
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            ReplayBuffer)
from ray_tpu_torch.rl.rollout_worker import (RolloutWorker, WorkerSet,
                                             synchronous_parallel_sample)
from ray_tpu_torch.rl.sample_batch import SampleBatch, concat_samples

__all__ = [
    "Algorithm", "AlgorithmConfig", "Policy", "SampleBatch", "concat_samples",
    "RolloutWorker", "WorkerSet", "synchronous_parallel_sample",
    "ReplayBuffer", "PrioritizedReplayBuffer",
    "PPO", "PPOConfig", "A2C", "A2CConfig",
    "ExternalEnv", "ExternalEnvSampler",
    "Connector", "ConnectorPipeline", "build_connectors",
    "register_connector", "FlattenObs", "ClipObs", "NormalizeObs",
    "FrameStack", "ClipActions", "ScaleActions",
    "CartPoleEnv", "MemoryCueEnv", "PendulumEnv", "VectorEnv", "EnvSpec",
    "make_env", "register_env",
]
