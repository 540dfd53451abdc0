"""Algorithm base: config builder + Trainable integration.

Port of ``ray_tpu/rl/algorithm.py``. Parity with
``rllib/algorithms/algorithm.py`` (Algorithm is a Tune ``Trainable`` whose
``step`` drives ``training_step``) and ``algorithm_config.py`` (the fluent
``AlgorithmConfig`` builder: ``.environment().rollouts().training()
.resources()``).

Placement is stated, not inferred: ``resources(device=...)`` is where the
learner lives (``None``: ``cuda``, so ``build()`` raises without a card
unless ``device="cpu"`` is given), and every rollout worker's policy acts
on the CPU, local and remote alike (the reference's design: CPU rollout
actors feeding the learner). Remote workers are CPU actors with no GPU
grant. ``resources(mesh=...)`` (a ``parallel.Mesh``) puts a PPO learner
on every rank of the mesh: the device is then the mesh's (this rank's card,
or the CPU of a gloo mesh), and ``device=`` may only name the same.
"""

from __future__ import annotations

import pickle
import os
import time
from typing import Any, Dict, List, Optional, Type

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rl.rollout_worker import WorkerSet
from ray_tpu_torch.tune.trainable import Trainable


def learner_device(device=None, mesh=None) -> torch.device:
    """Where a learner lives: ``device`` (``None``: ``cuda``, raising
    without a card), or on a mesh this rank's device: its card (the
    current CUDA device, which ``parallel.run_spmd`` sets per rank) or the
    CPU of a gloo mesh. Raises if ``device`` names another than the
    mesh's."""
    if mesh is None:
        return resolve_device(device)
    own = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    if device is not None:
        asked = torch.device(device)
        if asked.type != own.type or asked.index not in (None, own.index):
            raise ValueError(f"device {asked} given for a learner on a mesh "
                             f"of {mesh.device_type}: this rank's device is "
                             f"{own}")
    return own


class AlgorithmConfig:
    """Fluent builder; ``.build()`` instantiates the algorithm."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        # environment()
        self.env = None
        self.env_config: Dict[str, Any] = {}
        # rollouts()
        self.num_rollout_workers = 0
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.num_cpus_per_worker = 1.0
        # training()
        self.gamma = 0.99
        self.lr = 5e-4
        self.train_batch_size = 4000
        self.model: Dict[str, Any] = {}
        self.seed = 0
        # framework/resources()
        self.mesh = None  # optional parallel.Mesh for the (PPO) learner
        self.device = None  # the learner's device; None: cuda (or the mesh's)
        self.extra: Dict[str, Any] = {}

    def environment(self, env=None, env_config: Optional[dict] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def rollouts(self, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 num_cpus_per_worker: Optional[float] = None
                 ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_cpus_per_worker is not None:
            self.num_cpus_per_worker = num_cpus_per_worker
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def resources(self, mesh=None, device=None) -> "AlgorithmConfig":
        if mesh is not None:
            self.mesh = mesh
        if device is not None:
            self.device = device
        return self

    def debugging(self, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("algo_class", "extra")}
        d.update(self.extra)
        return d

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("no algo_class bound to this config")
        return self.algo_class(config=self)


class Algorithm(Trainable):
    """Base RL algorithm. Subclasses override ``get_default_config`` and
    ``training_step`` (reference: ``algorithm.py`` ``training_step``)."""

    _config_cls = AlgorithmConfig

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls._config_cls(cls)

    def __init__(self, config=None, env=None, logdir: Optional[str] = None):
        if isinstance(config, AlgorithmConfig):
            self.algo_config = config
        else:
            self.algo_config = self.get_default_config()
            for k, v in (config or {}).items():
                if hasattr(self.algo_config, k):
                    setattr(self.algo_config, k, v)
                else:
                    self.algo_config.extra[k] = v
        if env is not None:
            self.algo_config.env = env
        self._episode_history: List[dict] = []
        self._timesteps_total = 0
        super().__init__(config=self.algo_config.to_dict(), logdir=logdir)

    # -- Trainable plumbing ----------------------------------------------

    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("AlgorithmConfig.environment(env=...) not set")
        # The learner's device first, so that build() without a card raises
        # before any rollout worker starts.
        self.device = learner_device(cfg.device, cfg.mesh)
        self.workers = self._make_worker_set()
        self.learner = self._make_learner()

    def _worker_kwargs(self) -> Dict[str, Any]:
        cfg = self.algo_config
        kw = dict(
            env_name_or_maker=cfg.env,
            env_config=cfg.env_config,
            num_envs=cfg.num_envs_per_worker,
            rollout_fragment_length=cfg.rollout_fragment_length,
            policy_config=dict(cfg.model),
            seed=cfg.seed,
            gamma=cfg.gamma,
            lambda_=getattr(cfg, "lambda_", 0.95),
            compute_advantages=self._needs_advantages(),
            device="cpu",
        )
        # Model catalog seam (rllib/models/catalog.py use_lstm /
        # use_attention): memory models swap in the stateful policy.
        from ray_tpu_torch.rl.recurrent import (RecurrentPolicy,
                                                uses_memory_model)
        if uses_memory_model(cfg.model):
            kw["policy_cls"] = RecurrentPolicy
        return kw

    def _needs_advantages(self) -> bool:
        return True

    def _make_worker_set(self) -> WorkerSet:
        cfg = self.algo_config
        return WorkerSet(cfg.num_rollout_workers, self._worker_kwargs(),
                         num_cpus_per_worker=cfg.num_cpus_per_worker)

    def _make_learner(self):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step() or {}
        episodes = self.workers.collect_metrics()
        self._episode_history.extend(episodes)
        self._episode_history = self._episode_history[-100:]
        if self._episode_history:
            rewards = [e["episode_reward"] for e in self._episode_history]
            lengths = [e["episode_len"] for e in self._episode_history]
            result["episode_reward_mean"] = float(np.mean(rewards))
            result["episode_reward_min"] = float(np.min(rewards))
            result["episode_reward_max"] = float(np.max(rewards))
            result["episode_len_mean"] = float(np.mean(lengths))
        result["episodes_this_iter"] = len(episodes)
        result["timesteps_total"] = self._timesteps_total
        result["sample_throughput"] = (
            result.get("timesteps_this_iter", 0) / max(1e-9, time.time() - t0))
        return result

    # -- checkpointing ----------------------------------------------------

    def get_weights(self):
        return self.workers.local_worker.get_weights()

    def set_weights(self, weights):
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights()

    def save_checkpoint(self, checkpoint_dir: str) -> Any:
        state = self.__getstate__()
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)
        return state

    def load_checkpoint(self, checkpoint: Any):
        if checkpoint is None:
            return
        if isinstance(checkpoint, str):
            with open(os.path.join(checkpoint, "algorithm_state.pkl"),
                      "rb") as f:
                checkpoint = pickle.load(f)
        self.__setstate__(checkpoint)

    def __getstate__(self) -> Dict[str, Any]:
        return {
            "weights": self.get_weights(),
            "learner_state": self._learner_state(),
            "timesteps_total": self._timesteps_total,
        }

    def __setstate__(self, state: Dict[str, Any]):
        self.set_weights(state["weights"])
        self._set_learner_state(state.get("learner_state"))
        self._timesteps_total = state.get("timesteps_total", 0)

    def _learner_state(self) -> Any:
        return None

    def _set_learner_state(self, state: Any) -> None:
        pass

    def cleanup(self):
        self.workers.stop()

    def stop(self):
        self.cleanup()
