"""QMIX: monotonic value-function factorization for cooperative MARL.

Port of ``ray_tpu/rl/qmix.py``. Parity with ``rllib/algorithms/qmix``
(Rashid et al. 2018): per-agent utility networks Q_i(obs_i, a_i) combined
by a MIXING network whose weights are produced by hypernetworks
conditioned on the global state and constrained non-negative — so
argmax_a Q_tot decomposes into per-agent argmaxes (the IGM property) while
Q_tot can still represent non-additive team payoffs that defeat VDN.

Runtime shape (this package's DQN family): epsilon-greedy joint sampling
from a ``MultiAgentEnv``, transition replay over JOINT transitions (all
agents' obs/actions + the team reward at one step), and one update on the
learner's device fusing agent nets, hypernets, double-Q targets, and the
periodic target sync. Agents share one utility network with a one-hot
agent id appended to the observation (the reference's default parameter
sharing). Where the JAX package jits the update and the greedy Q-values,
here both run eagerly on the learner's device: ``act`` reads the
Q-values back once an env step (``act_reads``), ``train`` its metrics
once an update (``host_reads``). Replay, the epsilon schedule and the
index draws stay numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        learner_device)
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.ppo import (adam_init, clip_adam_step_,
                                  opt_state_from_numpy, opt_state_to_numpy)
from ray_tpu_torch.rl.sample_batch import batch_to_device

AUX_KEYS = ("loss", "q_tot_mean")
MAX_GRAD_NORM = 10.0


class QMIXConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or QMIX)
        self.lr = 2e-4
        self.mixing_embed_dim = 16
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 1000
        self.train_batch_size = 128
        self.replay_capacity = 10_000
        self.target_update_freq = 100  # learner steps between syncs
        self.episodes_per_iter = 8
        self.n_updates_per_iter = 16
        self.learning_starts = 200     # joint transitions before updates
        self.model = {"fcnet_hiddens": (64,)}
        self.double_q = True


class QMIXLearner:
    """Shared utility net + monotonic mixer, updated on one device."""

    def __init__(self, obs_dim: int, n_agents: int, n_actions: int,
                 state_dim: int, cfg: QMIXConfig, device=None):
        self.cfg = cfg
        self.device = learner_device(device)
        self.n_agents = n_agents
        self.embed = embed = cfg.mixing_embed_dim
        self.act_reads = 0    # device->host reads of act (one an env step)
        self.host_reads = 0   # of train (one an update)
        hidden = tuple(cfg.model.get("fcnet_hiddens", (64,)))
        # Drawn on the host and then placed, so that a seed gives the same
        # start on every device (as JAX's key does).
        gen = torch.Generator().manual_seed(cfg.seed or 0)
        in_dim = obs_dim + n_agents  # one-hot agent id appended

        def init(in_dim, hidden, out_dim):
            return _models.mlp_init(gen, in_dim, hidden, out_dim)

        params = {
            "agent": init(in_dim, hidden, n_actions),
            # hypernetworks: state -> mixer weights (abs() at use site)
            "hyper_w1": init(state_dim, (embed,), n_agents * embed),
            "hyper_b1": init(state_dim, (), embed),
            "hyper_w2": init(state_dim, (embed,), embed),
            "hyper_v": init(state_dim, (embed,), 1),
        }
        self.set_state((params, params, None, 0))
        self._eye = torch.eye(n_agents, device=self.device)

    def _agent_qs(self, p, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, n_agents, obs_dim] -> [B, n_agents, n_actions]."""
        ids = torch.broadcast_to(self._eye, obs.shape[:-2] + self._eye.shape)
        x = torch.cat([obs, ids], dim=-1)
        return _models.mlp_apply(p["agent"], x, activation="relu")

    def _mix(self, p, qs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """qs [B, n_agents] + state [B, state_dim] -> Q_tot [B]."""
        w1 = torch.abs(_models.mlp_apply(p["hyper_w1"], state)).reshape(
            state.shape[0], self.n_agents, self.embed)
        b1 = _models.mlp_apply(p["hyper_b1"], state)
        h = torch.nn.functional.elu(torch.einsum("ba,bae->be", qs, w1) + b1)
        w2 = torch.abs(_models.mlp_apply(p["hyper_w2"], state))
        v = _models.mlp_apply(p["hyper_v"], state)[..., 0]
        return torch.einsum("be,be->b", h, w2) + v

    def update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One double-Q TD update of the agent net and the hypernetworks on
        a joint-transition batch already on the device; the target network
        stays. Returns the stacked ``AUX_KEYS`` on the device."""
        p, target = self.params, self.target
        not_done = 1.0 - batch["dones"].float()
        with torch.no_grad():
            tq_all = self._agent_qs(target, batch["next_obs"])
            if self.cfg.double_q:
                sel = torch.argmax(self._agent_qs(p, batch["next_obs"]),
                                   dim=-1)
            else:
                sel = torch.argmax(tq_all, dim=-1)
            tq = torch.gather(tq_all, -1, sel[..., None])[..., 0]
            y = batch["rewards"] + self.cfg.gamma * not_done * self._mix(
                target, tq, batch["next_state"])
        q_all = self._agent_qs(p, batch["obs"])
        q = torch.gather(q_all, -1, batch["actions"][..., None].long()
                         )[..., 0]
        q_tot = self._mix(p, q, batch["state"])
        loss = torch.mean((q_tot - y) ** 2)
        leaves = _models.tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves)
        clip_adam_step_(leaves, grads, self.opt_state, MAX_GRAD_NORM,
                        self.cfg.lr)
        return torch.stack([loss.detach(), q_tot.detach().mean()])

    @torch.no_grad()
    def act(self, obs_stack: np.ndarray, epsilon: float,
            rng: np.random.Generator) -> np.ndarray:
        """Greedy per-agent argmax (IGM: joint argmax decomposes) with
        per-agent epsilon exploration. obs_stack [n_agents, obs_dim]. The
        Q-values come from the learner's device in one read."""
        obs = torch.as_tensor(np.asarray(obs_stack, np.float32)[None],
                              device=self.device)
        qs = self._agent_qs(self.params, obs)[0].cpu().numpy()
        self.act_reads += 1
        greedy = qs.argmax(axis=-1)
        explore = rng.random(len(greedy)) < epsilon
        random_a = rng.integers(0, qs.shape[-1], len(greedy))
        return np.where(explore, random_a, greedy)

    def train(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        self.steps += 1
        aux = self.update(batch_to_device(batch, self.device)).tolist()
        self.host_reads += 1
        if self.steps % self.cfg.target_update_freq == 0:
            self.update_target()
        return dict(zip(AUX_KEYS, aux))

    def update_target(self) -> None:
        with torch.no_grad():
            torch._foreach_copy_(_models.tree_leaves(self.target),
                                 _models.tree_leaves(self.params))

    def set_params(self, params) -> None:
        self.params = _models.params_from_numpy(params, self.device)
        for t in _models.tree_leaves(self.params):
            t.requires_grad_(True)

    def state(self):
        return (_models.to_numpy(self.params), _models.to_numpy(self.target),
                opt_state_to_numpy(self.opt_state), self.steps)

    def set_state(self, state):
        """``(params, target, opt_state, steps)`` as host trees, the JAX
        package's layout; the optimizer state as ``opt_state_to_numpy``
        gives it, or ``None`` for a fresh one."""
        p, t, o, s = state
        self.set_params(p)
        self.target = _models.params_from_numpy(t, self.device)
        self.opt_state = (adam_init(self.params) if o is None
                          else opt_state_from_numpy(o, self.device))
        self.steps = s


class QMIX(Algorithm):
    _config_cls = QMIXConfig

    @classmethod
    def get_default_config(cls) -> QMIXConfig:
        return QMIXConfig(cls)

    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("AlgorithmConfig.environment(env=...) not set")
        # the learner's device first: build() without a card raises here
        self.device = learner_device(cfg.device)
        self.env = make_env(cfg.env, dict(cfg.env_config or {}))
        self.agent_ids = tuple(self.env.agent_ids)
        first = self.agent_ids[0]
        self.obs_dim = int(np.prod(
            self.env.observation_spaces[first].shape))
        self.n_actions = int(self.env.action_spaces[first].n)
        self._state_fn = getattr(self.env, "get_state", None)
        if self._state_fn is not None:
            self.state_dim = int(np.prod(self._state_fn().shape))
        else:
            # default global state: concatenation of all agent obs
            self.state_dim = self.obs_dim * len(self.agent_ids)
        self.learner = QMIXLearner(self.obs_dim, len(self.agent_ids),
                                   self.n_actions, self.state_dim, cfg,
                                   device=self.device)
        self._replay: List[tuple] = []
        self._rng = np.random.default_rng(cfg.seed or 0)
        self._env_steps = 0

    def _global_state(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        if self._state_fn is not None:
            return np.asarray(self._state_fn(), np.float32).reshape(-1)
        return np.concatenate(
            [np.asarray(obs[a], np.float32).reshape(-1)
             for a in self.agent_ids])

    def _epsilon(self) -> float:
        cfg = self.algo_config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def _collect_episode(self) -> float:
        cfg = self.algo_config
        obs = self.env.reset(seed=int(self._rng.integers(1 << 31)))
        total = 0.0
        length = 0
        for _ in range(1000):
            stack = np.stack([np.asarray(obs[a], np.float32).reshape(-1)
                              for a in self.agent_ids])
            acts = self.learner.act(stack, self._epsilon(), self._rng)
            action_dict = {a: int(acts[i])
                           for i, a in enumerate(self.agent_ids)}
            state = self._global_state(obs)
            nxt, rews, terms, truncs, _ = self.env.step(action_dict)
            team_r = float(sum(rews.values())) / len(self.agent_ids)
            done = bool(terms.get("__all__")) or bool(truncs.get("__all__"))
            nxt_stack = np.stack(
                [np.asarray(nxt[a], np.float32).reshape(-1)
                 for a in self.agent_ids])
            self._replay.append((stack, acts, team_r, nxt_stack, state,
                                 self._global_state(nxt),
                                 bool(terms.get("__all__"))))
            if len(self._replay) > cfg.replay_capacity:
                del self._replay[: cfg.replay_capacity // 10]
            total += team_r
            length += 1
            self._env_steps += 1
            obs = nxt
            if done:
                break
        self._episode_history.append(
            {"episode_reward": total, "episode_len": length})
        return total

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self._replay),
                                 self.algo_config.train_batch_size)
        rows = [self._replay[i] for i in idx]
        return {
            "obs": np.stack([r[0] for r in rows]),
            "actions": np.stack([r[1] for r in rows]).astype(np.int32),
            "rewards": np.asarray([r[2] for r in rows], np.float32),
            "next_obs": np.stack([r[3] for r in rows]),
            "state": np.stack([r[4] for r in rows]),
            "next_state": np.stack([r[5] for r in rows]),
            "dones": np.asarray([r[6] for r in rows], np.float32),
        }

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        before = self._env_steps
        for _ in range(cfg.episodes_per_iter):
            self._collect_episode()
        metrics: Dict[str, Any] = {
            "timesteps_this_iter": self._env_steps - before,
            "epsilon": self._epsilon(),
        }
        self._timesteps_total = self._env_steps
        if len(self._replay) >= cfg.learning_starts:
            auxes = [self.learner.train(self._sample_batch())
                     for _ in range(cfg.n_updates_per_iter)]
            metrics.update({k: float(np.mean([a[k] for a in auxes]))
                            for k in auxes[-1]})
        return metrics

    # self-contained sampling: no worker set
    def step(self) -> Dict[str, Any]:
        import time as _time
        t0 = _time.time()
        result = self.training_step()
        self._episode_history = self._episode_history[-100:]
        rewards = [e["episode_reward"] for e in self._episode_history]
        result["episode_reward_mean"] = float(np.mean(rewards))
        result["episodes_this_iter"] = self.algo_config.episodes_per_iter
        result["timesteps_total"] = self._timesteps_total
        result["sample_throughput"] = (
            result.get("timesteps_this_iter", 0)
            / max(1e-9, _time.time() - t0))
        return result

    def get_weights(self):
        return {"params": _models.to_numpy(self.learner.params)}

    def set_weights(self, weights):
        self.learner.set_params(weights["params"])

    def _learner_state(self):
        return {"learner": self.learner.state(),
                "env_steps": self._env_steps}

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state["learner"])
            self._env_steps = state.get("env_steps", 0)

    def greedy_joint_return(self, episodes: int = 10) -> float:
        """Evaluation: greedy (epsilon=0) episodes, mean team return."""
        totals = []
        for _ in range(episodes):
            obs = self.env.reset(seed=int(self._rng.integers(1 << 31)))
            total = 0.0
            for _ in range(1000):
                stack = np.stack(
                    [np.asarray(obs[a], np.float32).reshape(-1)
                     for a in self.agent_ids])
                acts = self.learner.act(stack, 0.0, self._rng)
                obs, rews, terms, truncs, _ = self.env.step(
                    {a: int(acts[i])
                     for i, a in enumerate(self.agent_ids)})
                total += float(sum(rews.values())) / len(self.agent_ids)
                if terms.get("__all__") or truncs.get("__all__"):
                    break
            totals.append(total)
        return float(np.mean(totals))

    def cleanup(self):
        pass
