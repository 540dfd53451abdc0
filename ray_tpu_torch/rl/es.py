"""Evolution Strategies (OpenAI-ES) and Augmented Random Search.

Port of ``ray_tpu/rl/es.py``, copied: numpy only, no learner and no
device. Parity with ``rllib/algorithms/es`` (Salimans et al. 2017) and
``rllib/algorithms/ars`` (Mania et al. 2018): derivative-free policy
search by antithetic parameter perturbations —

- ES: rank-shaped fitness over ALL directions, gradient estimate
  ``lr/(n*std) * sum(shaped(r+) - shaped(r-)) * delta``.
- ARS (V2): observation normalization, TOP-k directions by
  ``max(r+, r-)``, update scaled by the std of the used returns.

Runtime shape: perturbation evaluations are full-episode rollouts and
embarrassingly parallel — each direction's (+/-) pair runs as a
``ray_tpu_torch`` remote task when ``num_rollout_workers > 0`` (the
reference's ES worker actors), or inline for ``0``. The policy is a
deterministic MLP over one flat parameter vector; the
perturbation/update math is plain numpy — there is no gradient tape
anywhere, which is the point of the algorithm family.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import Box, Discrete, make_env


def _mlp_shapes(obs_dim: int, hidden: Tuple[int, ...], out_dim: int):
    dims = (obs_dim,) + tuple(hidden) + (out_dim,)
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _param_size(shapes) -> int:
    return sum(i * o + o for i, o in shapes)


def _policy_act(theta: np.ndarray, shapes, obs: np.ndarray,
                discrete: bool, lo, hi) -> np.ndarray:
    """Deterministic MLP forward from the flat parameter vector."""
    x = obs
    off = 0
    for n, (i, o) in enumerate(shapes):
        w = theta[off:off + i * o].reshape(i, o)
        off += i * o
        b = theta[off:off + o]
        off += o
        x = x @ w + b
        if n < len(shapes) - 1:
            x = np.tanh(x)
    if discrete:
        return int(np.argmax(x))
    return np.clip(np.tanh(x) * (hi - lo) / 2 + (hi + lo) / 2, lo, hi)


def _rollout(env_name, env_config, theta, shapes, discrete, lo, hi,
             max_steps: int, obs_stats: Optional[tuple], seed: int):
    """One full episode; returns (return, steps, obs_sum, obs_sq, n)."""
    env = make_env(env_name, dict(env_config or {}, seed=seed))
    obs = np.asarray(env.reset(seed=seed), np.float64)
    mean, std = (obs_stats if obs_stats is not None
                 else (np.zeros_like(obs), np.ones_like(obs)))
    total = 0.0
    o_sum = np.zeros_like(obs)
    o_sq = np.zeros_like(obs)
    steps = 0
    for _ in range(max_steps):
        o_sum += obs
        o_sq += obs * obs
        norm = (obs - mean) / std
        a = _policy_act(theta, shapes, norm, discrete, lo, hi)
        obs, rew, terminated, truncated, _ = env.step(a)
        obs = np.asarray(obs, np.float64)
        total += float(rew)
        steps += 1
        if terminated or truncated:
            break
    return total, steps, o_sum, o_sq, steps


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self.num_perturbations = 16    # antithetic pairs per iteration
        self.noise_std = 0.1
        self.step_size = 0.05          # the "lr" of the ES update
        self.episode_horizon = 1000
        self.top_frac = 1.0            # ARS sets < 1
        self.observation_filter = False  # ARS sets True (V2)
        self.model = {"fcnet_hiddens": (32,)}
        self.num_rollout_workers = 0


class ES(Algorithm):
    """OpenAI-ES (``rllib/algorithms/es/es.py:1`` role)."""

    _config_cls = ESConfig

    @classmethod
    def get_default_config(cls) -> ESConfig:
        return ESConfig(cls)

    # ES has no gradient learner and no sampling worker set: setup builds
    # the flat parameter vector + env probe instead.
    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("AlgorithmConfig.environment(env=...) not set")
        probe = make_env(cfg.env, dict(cfg.env_config or {}))
        space = probe.spec.action_space
        self._discrete = isinstance(space, Discrete)
        if self._discrete:
            out_dim = space.n
            self._lo = self._hi = None
        elif isinstance(space, Box):
            out_dim = int(np.prod(space.shape))
            self._lo = np.asarray(space.low, np.float64).reshape(-1)
            self._hi = np.asarray(space.high, np.float64).reshape(-1)
        else:
            raise ValueError(f"unsupported action space {space}")
        obs_dim = int(np.prod(probe.spec.observation_space.shape))
        self._shapes = _mlp_shapes(
            obs_dim, tuple(cfg.model.get("fcnet_hiddens", (32,))), out_dim)
        self._rng = np.random.default_rng(cfg.seed or 0)
        self.theta = (self._rng.standard_normal(_param_size(self._shapes))
                      * 0.1)
        # running observation stats (ARS V2 normalization)
        self._obs_n = 1e-4
        self._obs_sum = np.zeros(obs_dim)
        self._obs_sq = np.ones(obs_dim) * 1e-4
        self._iter = 0
        self._remote_rollout = None
        if cfg.num_rollout_workers > 0:
            import ray_tpu_torch
            self._remote_rollout = ray_tpu_torch.remote(
                num_cpus=cfg.num_cpus_per_worker)(_rollout)

    def _obs_stats(self):
        if not self.algo_config.observation_filter:
            return None
        mean = self._obs_sum / self._obs_n
        var = np.maximum(self._obs_sq / self._obs_n - mean ** 2, 1e-8)
        return mean, np.sqrt(var)

    def _evaluate(self, thetas: List[np.ndarray]) -> List[tuple]:
        """Episode returns for each candidate, remote when configured."""
        cfg = self.algo_config
        stats = self._obs_stats()
        seed = (cfg.seed or 0) * 100_003 + self._iter
        args = [(cfg.env, cfg.env_config, th, self._shapes, self._discrete,
                 self._lo, self._hi, cfg.episode_horizon, stats, seed + i)
                for i, th in enumerate(thetas)]
        if self._remote_rollout is not None:
            import ray_tpu_torch
            return ray_tpu_torch.get(
                [self._remote_rollout.remote(*a) for a in args],
                timeout=600)
        return [_rollout(*a) for a in args]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        n = cfg.num_perturbations
        self._iter += 1
        deltas = self._rng.standard_normal((n, self.theta.size))
        cands = [self.theta + cfg.noise_std * d for d in deltas]
        cands += [self.theta - cfg.noise_std * d for d in deltas]
        results = self._evaluate(cands)
        r_pos = np.array([r[0] for r in results[:n]])
        r_neg = np.array([r[0] for r in results[n:]])
        steps = int(sum(r[1] for r in results))
        for _, _, o_sum, o_sq, cnt in results:
            self._obs_n += cnt
            self._obs_sum += o_sum
            self._obs_sq += o_sq
        self.theta = self._update(deltas, r_pos, r_neg)
        self._timesteps_total += steps
        # evaluation episode with the CURRENT (unperturbed) params
        ev = _rollout(cfg.env, cfg.env_config, self.theta, self._shapes,
                      self._discrete, self._lo, self._hi,
                      cfg.episode_horizon, self._obs_stats(),
                      seed=self._iter)
        self._episode_history.append(
            {"episode_reward": ev[0], "episode_len": ev[1]})
        return {"timesteps_this_iter": steps,
                "perturbation_reward_mean":
                    float(np.mean(np.concatenate([r_pos, r_neg])))}

    def _update(self, deltas, r_pos, r_neg) -> np.ndarray:
        """OpenAI-ES: centered-rank shaping over all 2n returns."""
        cfg = self.algo_config
        all_r = np.concatenate([r_pos, r_neg])
        ranks = np.empty(all_r.size)
        ranks[np.argsort(all_r)] = np.arange(all_r.size)
        shaped = ranks / (all_r.size - 1) - 0.5
        sp, sn = shaped[:len(r_pos)], shaped[len(r_pos):]
        grad = ((sp - sn)[:, None] * deltas).sum(0) / (
            len(r_pos) * cfg.noise_std)
        return self.theta + cfg.step_size * grad

    # ES reports its own episodes; no worker set exists.
    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step()
        self._episode_history = self._episode_history[-100:]
        rewards = [e["episode_reward"] for e in self._episode_history]
        lengths = [e["episode_len"] for e in self._episode_history]
        result["episode_reward_mean"] = float(np.mean(rewards))
        result["episode_reward_max"] = float(np.max(rewards))
        result["episode_len_mean"] = float(np.mean(lengths))
        result["episodes_this_iter"] = 1
        result["timesteps_total"] = self._timesteps_total
        result["sample_throughput"] = (
            result.get("timesteps_this_iter", 0)
            / max(1e-9, time.time() - t0))
        return result

    def get_weights(self):
        return {"theta": np.array(self.theta)}

    def set_weights(self, weights):
        self.theta = np.array(weights["theta"])

    def _learner_state(self):
        return {"obs_n": self._obs_n, "obs_sum": self._obs_sum,
                "obs_sq": self._obs_sq, "iter": self._iter}

    def _set_learner_state(self, state):
        if state:
            self._obs_n = state["obs_n"]
            self._obs_sum = state["obs_sum"]
            self._obs_sq = state["obs_sq"]
            self._iter = state["iter"]

    def cleanup(self):
        pass


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ARS)
        self.top_frac = 0.5
        self.observation_filter = True  # ARS V2
        self.noise_std = 0.03
        self.step_size = 0.02
        self.model = {"fcnet_hiddens": ()}  # linear policies (the paper)


class ARS(ES):
    """Augmented Random Search (``rllib/algorithms/ars/ars.py:1`` role)."""

    _config_cls = ARSConfig

    @classmethod
    def get_default_config(cls) -> ARSConfig:
        return ARSConfig(cls)

    def _update(self, deltas, r_pos, r_neg) -> np.ndarray:
        cfg = self.algo_config
        k = max(1, int(round(cfg.top_frac * len(r_pos))))
        order = np.argsort(np.maximum(r_pos, r_neg))[::-1][:k]
        used = np.concatenate([r_pos[order], r_neg[order]])
        sigma_r = used.std() or 1.0
        grad = ((r_pos[order] - r_neg[order])[:, None]
                * deltas[order]).sum(0) / (k * sigma_r)
        return self.theta + cfg.step_size * grad
