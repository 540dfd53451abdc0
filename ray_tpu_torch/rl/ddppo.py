"""DD-PPO: decentralized distributed PPO.

Port of ``ray_tpu/rl/ddppo.py``. Parity with
``rllib/algorithms/ddppo/ddppo.py:91,131-152`` (Wijmans et al. 2020): there
is NO central learner — each rollout worker trains on its OWN
locally-collected batch and synchronizes by ALLREDUCING GRADIENTS with its
peers, so sample collection and SGD both scale with the worker count and no
batch or weight tensors ever flow through the driver. All workers start
from identical parameters and apply identical averaged updates, so their
policies stay bit-identical without any weight broadcast.

The gradient exchange rides this package's collective library
(``ray_tpu_torch.collective``): each DD-PPO worker joins one collective
group and allreduces its gradient, flattened in ``models.tree_leaves``
order (the JAX package's ``ravel_pytree``), every SGD iteration. The
``"cpu"`` backend (the default) sums host copies; ``"nccl"`` keeps the flat
gradient a tensor on the card. Each worker's learner sits on the
algorithm's learner device (``resources(device=)``, ``cuda`` by default):
the workers are in-process actors that ask only CPUs, so they share that
device, as the JAX package's share device 0. Rollouts act on the CPU.

The group's name is unique to the algorithm, and ``cleanup`` leaves it on
every worker before killing the actors (the JAX package names it
``ddppo-{id(self)}``, which a later algorithm can reuse, and never leaves
it).
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Any, Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import Algorithm, learner_device
from ray_tpu_torch.rl.env import Box, make_env
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.ppo import (_USED, AUX_KEYS, PPOConfig, adam_init,
                                  clip_adam_step_)
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.sample_batch import (SampleBatch, batch_to_device,
                                           concat_samples)

logger = logging.getLogger("ray_tpu")

_group_ids = itertools.count()


class DDPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPPO)
        self.num_rollout_workers = 2   # the gradient-allreduce world
        self.num_sgd_iter = 8
        self.sgd_minibatch_size = 0    # 0 = whole local batch per step
        self.train_batch_size = 512    # PER WORKER (DD-PPO semantics)
        self.collective_backend = "cpu"   # or "nccl": the gradient on the card


class _DDPPOWorker:
    """One decentralized worker: rollout sampling + local SGD with
    per-iteration gradient allreduce. Runs as a ``ray_tpu_torch`` actor
    (one thread: the collective group is bound to the thread that joins
    it)."""

    def __init__(self, worker_kwargs: Dict[str, Any], cfg_dict: Dict,
                 init_weights: Dict, rank: int, world_size: int,
                 group_name: str, device="cpu"):
        cfg = DDPPOConfig()
        for k, v in cfg_dict.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        self.cfg = cfg
        self.rank = rank
        self.world = world_size
        self.group = group_name
        self.device = torch.device(device)
        self.worker = RolloutWorker(worker_index=rank, **worker_kwargs)
        # identical start everywhere: decentralized sync only works if
        # every peer applies identical updates to identical params
        self.set_weights(init_weights)
        self._continuous = isinstance(
            self.worker.vector_env.spec.action_space, Box)
        from ray_tpu_torch import collective as col
        col.init_collective_group(
            world_size, rank, backend=cfg.collective_backend,
            group_name=group_name,
            devices=([self.device] if cfg.collective_backend == "nccl"
                     else None))

    def _loss(self, kl_coeff, batch):
        dist_in, values = _models.actor_critic_apply(
            self.params, batch[SampleBatch.OBS])
        dist = _models.make_distribution(self.params, dist_in,
                                         self._continuous)
        return _models.ppo_surrogate_loss(dist, values, batch, self.cfg,
                                          kl_coeff)

    def sgd_step(self, arrays: Dict[str, torch.Tensor],
                 kl_coeff: float) -> torch.Tensor:
        """One DD-PPO step on a batch already on the device: the local
        gradient, its mean over the group (gradients — not weights — cross
        workers), the same clip+Adam step on every worker. Returns the
        stacked ``AUX_KEYS`` of the local loss, on the device."""
        from ray_tpu_torch import collective as col
        leaves = _models.tree_leaves(self.params)
        loss, aux = self._loss(kl_coeff, arrays)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([g.reshape(-1) for g in grads])
        if self.cfg.collective_backend == "nccl":
            mean = col.allreduce(flat, group_name=self.group) / self.world
        else:
            summed = col.allreduce(flat.cpu().numpy(), group_name=self.group)
            mean = torch.from_numpy(summed).to(self.device) / self.world
        parts = mean.split([t.numel() for t in leaves])
        clip_adam_step_(leaves, [p.view_as(t) for p, t in zip(parts, leaves)],
                        self.opt_state, self.cfg.grad_clip, self.cfg.lr)
        return torch.stack([aux[k].detach() for k in AUX_KEYS])

    def run_iteration(self, kl_coeff: float) -> Dict[str, Any]:
        """One DD-PPO iteration: sample locally, then num_sgd_iter rounds
        of (local grad -> allreduce-mean -> identical apply)."""
        cfg = self.cfg
        batch = concat_samples(
            [self.worker.sample() for _ in range(
                max(1, cfg.train_batch_size
                    // max(1, cfg.rollout_fragment_length
                           * self.worker.vector_env.num_envs)))])
        t0 = time.perf_counter()
        arrays = batch_to_device(
            {k: v for k, v in batch.items() if k in _USED}, self.device)
        aux = None
        for _ in range(cfg.num_sgd_iter):
            aux = self.sgd_step(arrays, kl_coeff)
        metrics = ({} if aux is None
                   else dict(zip(AUX_KEYS, aux.tolist())))
        learn_s = time.perf_counter() - t0   # ends in the metrics' read
        self.worker.set_weights(self.get_weights())
        return {"steps": len(batch), "metrics": metrics,
                "episodes": self.worker.pop_metrics(), "learn_s": learn_s}

    def get_weights(self):
        return _models.to_numpy(self.params)

    def set_weights(self, weights):
        """Checkpoint restore: replace params everywhere they live; the
        optimizer restarts fresh (documented restore semantics)."""
        self.params = _models.params_from_numpy(weights, self.device)
        for t in _models.tree_leaves(self.params):
            t.requires_grad_(True)
        self.opt_state = adam_init(self.params)
        self.worker.set_weights(weights)
        return True

    def leave_group(self) -> None:
        from ray_tpu_torch import collective as col
        col.destroy_collective_group(self.group)


class DDPPO(Algorithm):
    _config_cls = DDPPOConfig

    @classmethod
    def get_default_config(cls) -> DDPPOConfig:
        return DDPPOConfig(cls)

    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("AlgorithmConfig.environment(env=...) not set")
        if cfg.num_rollout_workers < 2:
            raise ValueError("DD-PPO is a decentralized strategy: "
                             "num_rollout_workers must be >= 2")
        # the learners' device before any worker starts
        self.device = learner_device(cfg.device)
        wk = dict(
            env_name_or_maker=cfg.env, env_config=cfg.env_config,
            num_envs=cfg.num_envs_per_worker,
            rollout_fragment_length=cfg.rollout_fragment_length,
            policy_config=dict(cfg.model), seed=cfg.seed,
            gamma=cfg.gamma, lambda_=getattr(cfg, "lambda_", 0.95),
            compute_advantages=True, device="cpu")
        # identical init params, minted once
        probe = make_env(cfg.env, dict(cfg.env_config or {}))
        init = Policy(probe.spec, dict(cfg.model), seed=cfg.seed,
                      device="cpu").get_weights()
        n = cfg.num_rollout_workers
        group = f"ddppo-{os.getpid()}-{next(_group_ids)}"
        cls = ray_tpu_torch.remote(num_cpus=cfg.num_cpus_per_worker)(
            _DDPPOWorker)
        self._workers = [
            cls.remote(wk, cfg.to_dict(), init, rank, n, group,
                       str(self.device))
            for rank in range(n)]
        self._kl_coeff = cfg.kl_coeff
        # wait for construction (collective join is rendezvous-blocking)
        ray_tpu_torch.get([w.get_weights.remote() for w in self._workers],
                          timeout=120)

    def training_step(self) -> Dict[str, Any]:
        outs = ray_tpu_torch.get(
            [w.run_iteration.remote(self._kl_coeff)
             for w in self._workers], timeout=600)
        steps = sum(o["steps"] for o in outs)
        self._timesteps_total += steps
        for o in outs:
            self._episode_history.extend(o["episodes"])
        kl = float(np.mean([o["metrics"].get("kl", 0.0) for o in outs]))
        cfg = self.algo_config
        if kl > 2.0 * cfg.kl_target:
            self._kl_coeff *= 1.5
        elif kl < 0.5 * cfg.kl_target:
            self._kl_coeff *= 0.5
        agg = {k: float(np.mean([o["metrics"][k] for o in outs]))
               for k in outs[0]["metrics"]}
        # host seconds of the slowest worker's SGD (copy in, steps, read)
        agg.update(timesteps_this_iter=steps, kl_coeff=self._kl_coeff,
                   learn_time_s=max(o["learn_s"] for o in outs))
        return agg

    # workers ARE the learners; episode metrics flow through training_step
    def step(self) -> Dict[str, Any]:
        import time as _time
        t0 = _time.time()
        result = self.training_step()
        self._episode_history = self._episode_history[-100:]
        if self._episode_history:
            rewards = [e["episode_reward"] for e in self._episode_history]
            result["episode_reward_mean"] = float(np.mean(rewards))
        result["timesteps_total"] = self._timesteps_total
        result["sample_throughput"] = (
            result.get("timesteps_this_iter", 0)
            / max(1e-9, _time.time() - t0))
        return result

    def get_weights(self):
        return ray_tpu_torch.get(self._workers[0].get_weights.remote(),
                                 timeout=60)

    def set_weights(self, weights):
        """Broadcast identical weights to EVERY worker — the only write
        that preserves the lockstep invariant (each worker also resets
        its optimizer state, so peers stay bit-identical)."""
        ray_tpu_torch.get([w.set_weights.remote(weights)
                           for w in self._workers], timeout=120)

    def __getstate__(self):
        return {"weights": self.get_weights(),
                "timesteps_total": self._timesteps_total}

    def __setstate__(self, state):
        if state.get("weights") is not None:
            self.set_weights(state["weights"])
        self._timesteps_total = state.get("timesteps_total", 0)

    def cleanup(self):
        workers = getattr(self, "_workers", [])
        try:
            ray_tpu_torch.get([w.leave_group.remote() for w in workers],
                              timeout=60)
        except Exception as e:   # a dead worker must not stop the kills
            logger.debug("leaving the DD-PPO group failed: %s", e)
        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception as e:
                logger.debug("worker kill failed: %s", e)
