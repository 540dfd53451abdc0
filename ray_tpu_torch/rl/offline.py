"""Offline RL: dataset IO, Behavior Cloning, MARWIL and Conservative
Q-Learning.

Port of ``ray_tpu/rl/offline.py``. Parity with the reference's offline
stack (``rllib/offline/json_reader.py``/``json_writer.py`` — SampleBatch
datasets on disk; ``rllib/algorithms/bc/bc.py`` — supervised policy
cloning; ``rllib/algorithms/marwil``; ``rllib/algorithms/cql/cql.py`` — SAC
with the conservative Q regularizer for learning from fixed datasets
without online exploration).

An offline "rollout" is just a minibatch slice of the dataset, so training
is pure supervised/TD compute with no env in the loop. Datasets are
columnar ``.npz`` shards (numpy's native container); the dataset IO is
copied, so shards move between the two packages byte for byte. Each
algorithm's learner (``BCLearner``, ``MARWILLearner``, ``CQLLearner``)
holds its trees and ``optax.adam`` state on the learner's device and
takes one eager step a minibatch there, where the JAX package jits it.
The minibatch indices are drawn on the host from the algorithm's numpy
generator, as in the JAX package, so both see the same minibatches; an
iteration reads its metrics back once. Evaluation rollouts act with the
local worker's CPU policy.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        learner_device)
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.ppo import (adam_init, adam_step_,
                                  opt_state_from_numpy, opt_state_to_numpy)
from ray_tpu_torch.rl.sac import polyak_
from ray_tpu_torch.rl.sample_batch import (SampleBatch, batch_to_device,
                                           concat_samples)

# ---------------------------------------------------------------- dataset IO


def write_dataset(batch: SampleBatch, path: str) -> str:
    """Write one columnar shard (``json_writer.py`` role, npz format)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in batch.items()})
    return path


def read_dataset(path_or_glob: str) -> SampleBatch:
    """Read shard(s) into one SampleBatch (``json_reader.py`` role)."""
    paths = sorted(_glob.glob(path_or_glob)) or [path_or_glob]
    parts = []
    for p in paths:
        with np.load(p) as z:
            parts.append(SampleBatch({k: z[k] for k in z.files}))
    return concat_samples(parts)


def collect_dataset(env_name_or_maker, policy=None, n_steps: int = 1000,
                    seed: int = 0, env_config: Optional[dict] = None
                    ) -> SampleBatch:
    """Roll a (possibly random) behavior policy to build a dataset."""
    env = make_env(env_name_or_maker, env_config)
    rng = np.random.default_rng(seed)
    obs = env.reset(seed=seed)
    cols: Dict[str, List[Any]] = {k: [] for k in (
        SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
        SampleBatch.NEXT_OBS, SampleBatch.TERMINATEDS,
        SampleBatch.TRUNCATEDS)}
    for _ in range(n_steps):
        if policy is None:
            action = env.spec.action_space.sample(rng)
        else:
            a, _, _ = policy.compute_actions(obs[None])
            action = a[0]
        obs2, rew, term, trunc, _ = env.step(action)
        cols[SampleBatch.OBS].append(obs)
        cols[SampleBatch.ACTIONS].append(action)
        cols[SampleBatch.REWARDS].append(rew)
        cols[SampleBatch.NEXT_OBS].append(obs2)
        cols[SampleBatch.TERMINATEDS].append(term)
        cols[SampleBatch.TRUNCATEDS].append(trunc)
        obs = env.reset() if (term or trunc) else obs2
    if cols[SampleBatch.TERMINATEDS]:
        # collection may stop mid-episode: mark the seam, or return
        # computations over CONCATENATED datasets would leak rewards
        # across shard boundaries
        if not (cols[SampleBatch.TERMINATEDS][-1]
                or cols[SampleBatch.TRUNCATEDS][-1]):
            cols[SampleBatch.TRUNCATEDS][-1] = True
    return SampleBatch({k: np.asarray(v) for k, v in cols.items()})


# ---------------------------------------------------------------- BC


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.n_updates_per_iter = 32
        self.input_ = None   # SampleBatch | path/glob (reference: config.offline_data)
        self.model = {"fcnet_hiddens": (64, 64)}


def _grads(loss, leaves):
    """d loss / d leaves, zeros for a leaf the loss does not reach (the
    value head under BC's loss, as the JAX package's gradient has it)."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


class BCLearner:
    """Behavior cloning on one device: the actor-critic tree and its
    ``optax.adam`` state."""

    def __init__(self, init_params, cfg: BCConfig, continuous: bool,
                 device=None):
        self.cfg = cfg
        self.device = learner_device(device)
        self._continuous = continuous
        self.set_state((init_params, None))

    def _logp(self, obs, actions):
        dist_in, values = _models.actor_critic_apply(self.params, obs)
        dist = _models.make_distribution(self.params, dist_in,
                                         self._continuous)
        return dist.logp(actions), values

    def step(self, obs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """One Adam step on ``-mean(logp(actions))``; -> the loss (0-d, on
        the device)."""
        leaves = _models.tree_leaves(self.params)
        loss = -torch.mean(self._logp(obs, actions)[0])
        adam_step_(leaves, _grads(loss, leaves), self.opt_state, self.cfg.lr)
        return loss.detach()

    def get_weights(self):
        return _models.to_numpy(self.params)

    def state(self):
        return self.get_weights(), opt_state_to_numpy(self.opt_state)

    def set_state(self, state):
        params, opt_state = state[:2]
        self.params = _models.params_from_numpy(params, self.device)
        for t in _models.tree_leaves(self.params):
            t.requires_grad_(True)
        self.opt_state = (adam_init(self.params) if opt_state is None
                          else opt_state_from_numpy(opt_state, self.device))


class BC(Algorithm):
    """Behavior Cloning (``rllib/algorithms/bc``): supervised max-logp of
    dataset actions. No env interaction; ``env`` is only used for spaces
    (and optional evaluation)."""

    _config_cls = BCConfig

    @classmethod
    def get_default_config(cls) -> BCConfig:
        return BCConfig(cls)

    def _needs_advantages(self) -> bool:
        return False

    def _make_worker_set(self):
        # env workers exist only to expose spaces + run evaluation rollouts
        from ray_tpu_torch.rl.rollout_worker import WorkerSet
        kw = self._worker_kwargs()
        kw["rollout_fragment_length"] = 200
        return WorkerSet(0, kw)

    def _load_dataset(self) -> SampleBatch:
        inp = getattr(self.algo_config, "input_", None)
        if inp is None:
            raise ValueError("BC/CQL require .training(input_=...) — a "
                             "SampleBatch or an npz path/glob")
        if isinstance(inp, str):
            return read_dataset(inp)
        return inp

    def _make_learner(self):
        cfg = self.algo_config
        self.dataset = self._load_dataset()
        pol = self.workers.local_worker.policy
        self._continuous = pol.continuous
        self._rng = np.random.default_rng(cfg.seed)
        return BCLearner(pol.get_weights(), cfg, pol.continuous,
                         device=self.device)

    def _minibatch(self, idx, **columns) -> Dict[str, torch.Tensor]:
        """Rows ``idx`` of the dataset's columns (keyword -> column name)
        on the learner's device, float columns as float32."""
        return batch_to_device({k: np.asarray(self.dataset[c])[idx]
                                for k, c in columns.items()}, self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        n = len(self.dataset)
        losses = []
        for _ in range(cfg.n_updates_per_iter):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            b = self._minibatch(idx, obs=SampleBatch.OBS,
                                act=SampleBatch.ACTIONS)
            losses.append(self.learner.step(b["obs"], b["act"]))
        losses = torch.stack(losses).tolist()
        self._timesteps_total += cfg.n_updates_per_iter * cfg.train_batch_size
        self.workers.local_worker.set_weights(self.learner.get_weights())
        return {"bc_loss": float(np.mean(losses)),
                "timesteps_this_iter": cfg.n_updates_per_iter
                * cfg.train_batch_size,
                "dataset_size": n}

    def evaluate(self, n_episodes: int = 5) -> float:
        """Greedy rollout return of the cloned policy."""
        lw = self.workers.local_worker
        total = []
        for ep in range(n_episodes):
            env = lw.vector_env.envs[0]
            obs = env.reset(seed=1000 + ep)
            ep_ret, done = 0.0, False
            while not done:
                a, _, _ = lw.policy.compute_actions(obs[None], explore=False)
                obs, r, term, trunc, _ = env.step(a[0])
                ep_ret += r
                done = term or trunc
            total.append(ep_ret)
        return float(np.mean(total))

    def _learner_state(self):
        return self.learner.state()

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state)


# -------------------------------------------------------------- MARWIL


class MARWILConfig(BCConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.beta = 1.0       # 0.0 degenerates to plain BC (the paper)
        self.vf_coeff = 1.0
        self.max_weight = 20.0  # clip exp() advantage weights


class MARWILLearner(BCLearner):
    """BC's learner with the value head trained, the clipped exp advantage
    weights and the running second moment ``ms`` (a 0-d tensor on the
    device, 1.0 at the start)."""

    def step(self, obs: torch.Tensor, actions: torch.Tensor,
             returns: torch.Tensor) -> torch.Tensor:
        """One Adam step, ``ms`` moved on; -> [policy loss, vf loss] on the
        device."""
        cfg = self.cfg
        leaves = _models.tree_leaves(self.params)
        logp, values = self._logp(obs, actions)
        adv = returns - values
        # running second moment normalizes the exponent (paper's c^2;
        # without it exp() saturates)
        new_ms = (0.99 * self.ms + 0.01 * torch.mean(adv ** 2)).detach()
        # the normalizer is a running CONSTANT (paper's c^2): gradients
        # through it would teach the critic to game the imitation weight
        # instead of fitting returns
        w = torch.clamp(torch.exp(cfg.beta * adv.detach()
                                  / torch.sqrt(new_ms + 1e-8)),
                        max=cfg.max_weight)
        pg = -torch.mean(w * logp)
        vf = torch.mean(adv ** 2)
        loss = pg + cfg.vf_coeff * 0.5 * vf
        adam_step_(leaves, _grads(loss, leaves), self.opt_state, cfg.lr)
        self.ms = new_ms
        return torch.stack([pg.detach(), vf.detach()])

    def state(self):
        return (*super().state(), np.float32(self.ms.item()))

    def set_state(self, state):
        super().set_state(state)
        ms = state[2] if len(state) > 2 else 1.0
        self.ms = torch.tensor(ms, dtype=torch.float32, device=self.device)


class MARWIL(BC):
    """Monotonic Advantage Re-Weighted Imitation Learning
    (``rllib/algorithms/marwil``, Wang et al. 2018): behavior cloning
    where each transition's logp is weighted by
    ``exp(beta * normalized_advantage)`` — good trajectories in a mixed
    dataset pull the policy harder than bad ones. Advantages come from
    Monte-Carlo returns (episode boundaries in the dataset) minus a
    jointly-learned value function, normalized by a running second
    moment (the paper's c^2 update). ``beta=0`` reduces exactly to BC.
    """

    _config_cls = MARWILConfig

    @classmethod
    def get_default_config(cls) -> MARWILConfig:
        return MARWILConfig(cls)

    @staticmethod
    def _mc_returns(ds: SampleBatch, gamma: float) -> np.ndarray:
        rews = np.asarray(ds[SampleBatch.REWARDS], np.float64)
        ends = np.asarray(ds[SampleBatch.TERMINATEDS]).astype(bool)
        if SampleBatch.TRUNCATEDS in ds:  # older datasets lack it
            ends = ends | np.asarray(
                ds[SampleBatch.TRUNCATEDS]).astype(bool)
        out = np.zeros_like(rews)
        acc = 0.0
        for i in range(len(rews) - 1, -1, -1):
            if ends[i]:
                acc = 0.0
            acc = rews[i] + gamma * acc
            out[i] = acc
        return out.astype(np.float32)

    def _make_learner(self):
        cfg = self.algo_config
        self.dataset = self._load_dataset()
        self._returns = self._mc_returns(self.dataset, cfg.gamma)
        pol = self.workers.local_worker.policy
        self._continuous = pol.continuous
        self._rng = np.random.default_rng(cfg.seed)
        return MARWILLearner(pol.get_weights(), cfg, pol.continuous,
                             device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        n = len(self.dataset)
        auxes = []
        for _ in range(cfg.n_updates_per_iter):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            b = self._minibatch(idx, obs=SampleBatch.OBS,
                                act=SampleBatch.ACTIONS)
            ret = batch_to_device({"ret": self._returns[idx]},
                                  self.device)["ret"]
            auxes.append(self.learner.step(b["obs"], b["act"], ret))
        pgs, vfs = zip(*torch.stack(auxes).tolist())
        self._timesteps_total += (cfg.n_updates_per_iter
                                  * cfg.train_batch_size)
        self.workers.local_worker.set_weights(self.learner.get_weights())
        return {"policy_loss": float(np.mean(pgs)),
                "vf_loss": float(np.mean(vfs)),
                "timesteps_this_iter": cfg.n_updates_per_iter
                * cfg.train_batch_size,
                "dataset_size": n}


# ---------------------------------------------------------------- CQL


class CQLConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.lr = 3e-4
        self.train_batch_size = 256
        self.n_updates_per_iter = 32
        self.input_ = None
        self.cql_alpha = 1.0     # conservative penalty weight
        self.tau = 0.005
        self.model = {"fcnet_hiddens": (256, 256)}


class CQLLearner:
    """Conservative Q-learning on one device: the Q-network (the policy's
    ``pi`` head), its soft target and the ``optax.adam`` state."""

    def __init__(self, init_params, cfg: CQLConfig, device=None):
        self.cfg = cfg
        self.device = learner_device(device)
        self.set_state((init_params, init_params, None))

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One Adam step on TD + ``cql_alpha`` x the CQL(H) penalty, then
        the soft target update; -> [td loss, penalty] on the device."""
        cfg = self.cfg
        obs, rew, nxt = batch["obs"], batch["rew"], batch["nxt"]
        act = batch["act"].long()
        not_done = 1.0 - batch["done"].float()
        leaves = _models.tree_leaves(self.params)
        q = _models.mlp_apply(self.params["pi"], obs, activation="relu")
        qa = torch.gather(q, -1, act[:, None])[:, 0]
        with torch.no_grad():
            qn = _models.mlp_apply(self.target["pi"], nxt, activation="relu")
            y = rew + cfg.gamma * not_done * torch.max(qn, dim=-1).values
        td = torch.mean((qa - y) ** 2)
        # CQL(H): minimize logsumexp(Q) (OOD actions) while maximizing Q
        # of dataset actions
        cql = torch.mean(torch.logsumexp(q, dim=-1) - qa)
        loss = td + cfg.cql_alpha * cql
        adam_step_(leaves, _grads(loss, leaves), self.opt_state, cfg.lr)
        polyak_(self.target, self.params, cfg.tau)
        return torch.stack([td.detach(), cql.detach()])

    def get_weights(self):
        return _models.to_numpy(self.params)

    def state(self):
        return (self.get_weights(), _models.to_numpy(self.target),
                opt_state_to_numpy(self.opt_state))

    def set_state(self, state):
        p, t, o = state
        self.params = _models.params_from_numpy(p, self.device)
        for leaf in _models.tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.target = _models.params_from_numpy(t, self.device)
        self.opt_state = (adam_init(self.params) if o is None
                          else opt_state_from_numpy(o, self.device))


class CQL(Algorithm):
    """Conservative Q-Learning for discrete control
    (``rllib/algorithms/cql``): double-Q TD learning on the fixed dataset
    plus the CQL(H) regularizer ``logsumexp Q - Q(s, a_data)``, which
    pushes down out-of-distribution action values so the greedy policy
    stays inside the dataset's support."""

    _config_cls = CQLConfig

    @classmethod
    def get_default_config(cls) -> CQLConfig:
        return CQLConfig(cls)

    def _needs_advantages(self) -> bool:
        return False

    def _make_worker_set(self):
        from ray_tpu_torch.rl.dqn import EpsilonGreedyPolicy
        from ray_tpu_torch.rl.rollout_worker import WorkerSet
        kw = self._worker_kwargs()
        kw["policy_cls"] = EpsilonGreedyPolicy
        return WorkerSet(0, kw)

    def _make_learner(self):
        cfg = self.algo_config
        self.dataset = BC._load_dataset(self)
        self._rng = np.random.default_rng(cfg.seed)
        return CQLLearner(self.workers.local_worker.get_weights(), cfg,
                          device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        n = len(self.dataset)
        auxes = []
        for _ in range(cfg.n_updates_per_iter):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            batch = BC._minibatch(
                self, idx, obs=SampleBatch.OBS, act=SampleBatch.ACTIONS,
                rew=SampleBatch.REWARDS, nxt=SampleBatch.NEXT_OBS,
                done=SampleBatch.TERMINATEDS)
            auxes.append(self.learner.step(batch))
        tds, cqls = zip(*torch.stack(auxes).tolist())
        self._timesteps_total += cfg.n_updates_per_iter * cfg.train_batch_size
        self.workers.local_worker.set_weights(self.learner.get_weights())
        return {"td_loss": float(np.mean(tds)),
                "cql_penalty": float(np.mean(cqls)),
                "timesteps_this_iter": cfg.n_updates_per_iter
                * cfg.train_batch_size,
                "dataset_size": n}

    evaluate = BC.evaluate

    def _learner_state(self):
        return self.learner.state()

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state)
