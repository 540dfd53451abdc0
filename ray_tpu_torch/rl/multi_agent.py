"""Multi-agent environments and the independent-learner trainer.

Port of ``ray_tpu/rl/multi_agent.py``, copied but for devices: the rollout
worker's policies act on the device it is given (``MultiAgentPPO`` gives
``"cpu"``; ``None`` means ``cuda``, as for ``RolloutWorker``), and each
policy's ``PPOLearner`` sits on the algorithm's learner device (over
``resources(mesh=)`` when one is given). Parity with
``rllib/env/multi_agent_env.py`` (dict-keyed obs/action/reward protocol
with the ``__all__`` done flag) and the independent-policies multi-agent
path of ``rllib/algorithms/algorithm.py`` (``policies`` +
``policy_mapping_fn`` config, per-policy sample batches, one learner per
policy — RLlib's default when parameter sharing is off).

The trainer composes the existing single-agent machinery: each policy_id
gets its own ``PPOLearner`` (``ppo.py``) and the multi-agent rollout
worker demultiplexes the env's dict streams into per-policy
``SampleBatch`` fragments with per-agent GAE.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import Box, Discrete, EnvSpec
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.postprocessing import compute_gae, standardize
from ray_tpu_torch.rl.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rl.sample_batch import SampleBatch, concat_samples


class MultiAgentEnv:
    """Dict-keyed multi-agent protocol (``multi_agent_env.py:MultiAgentEnv``).

    ``reset`` returns ``{agent_id: obs}``; ``step(action_dict)`` returns
    ``(obs, rewards, terminateds, truncateds, infos)`` dicts. The
    terminateds/truncateds dicts carry the special ``"__all__"`` key that
    ends the episode for every agent.
    """

    agent_ids: Tuple[str, ...] = ()
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        raise NotImplementedError


class CoordinationGameEnv(MultiAgentEnv):
    """Repeated 2-player coordination game (independent-learner gate env).

    Both agents pick an action in {0, 1} each step; payoff 1.0 to both if
    both pick 0, 0.3 if both pick 1, 0 on mismatch — a unique
    payoff-dominant equilibrium that independent learners must find
    without communication. Observation is the one-hot of the previous
    joint action (4-dim), zeros on reset.
    """

    agent_ids = ("agent_0", "agent_1")

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        obs_space = Box(0.0, 1.0, (4,))
        self.observation_spaces = {a: obs_space for a in self.agent_ids}
        self.action_spaces = {a: Discrete(2) for a in self.agent_ids}
        self.episode_len = int(config.get("episode_len", 25))
        self._t = 0
        self._last = np.zeros(4, np.float32)

    def reset(self, seed: Optional[int] = None):
        self._t = 0
        self._last = np.zeros(4, np.float32)
        return {a: self._last.copy() for a in self.agent_ids}

    def step(self, actions: Dict[str, Any]):
        a0 = int(actions["agent_0"])
        a1 = int(actions["agent_1"])
        if a0 == 0 and a1 == 0:
            r = 1.0
        elif a0 == 1 and a1 == 1:
            r = 0.3
        else:
            r = 0.0
        self._last = np.zeros(4, np.float32)
        self._last[a0 * 2 + a1] = 1.0
        self._t += 1
        done = self._t >= self.episode_len
        obs = {a: self._last.copy() for a in self.agent_ids}
        rews = {a: r for a in self.agent_ids}
        terms = {a: False for a in self.agent_ids}
        truncs = {a: done for a in self.agent_ids}
        terms["__all__"] = False
        truncs["__all__"] = done
        return obs, rews, terms, truncs, {a: {} for a in self.agent_ids}


class TwoStepCooperativeGameEnv(MultiAgentEnv):
    """The QMIX paper's two-step cooperative matrix game (Rashid et al.
    2018, §6.1): agent_0's first action picks payoff matrix A or B; in
    the second step both agents act and the TEAM receives the matrix
    payoff. Matrix A pays 7 everywhere; matrix B pays [[0,1],[1,8]].
    The optimal joint policy (pick B, then both play 1) earns 8 — but a
    purely additive value factorization (VDN) converges to the safe 7,
    which is exactly the representational gap QMIX's monotonic mixing
    closes. Observation: one-hot of the phase (start/A/B) per agent;
    ``get_state()`` exposes the same as the mixer's global state."""

    agent_ids = ("agent_0", "agent_1")

    def __init__(self, config: Optional[dict] = None):
        obs_space = Box(0.0, 1.0, (3,))
        self.observation_spaces = {a: obs_space for a in self.agent_ids}
        self.action_spaces = {a: Discrete(2) for a in self.agent_ids}
        self._phase = 0  # 0 = start, 1 = matrix A, 2 = matrix B

    def _obs(self):
        o = np.zeros(3, np.float32)
        o[self._phase] = 1.0
        return {a: o.copy() for a in self.agent_ids}

    def get_state(self) -> np.ndarray:
        s = np.zeros(3, np.float32)
        s[self._phase] = 1.0
        return s

    def reset(self, seed: Optional[int] = None):
        self._phase = 0
        return self._obs()

    def step(self, actions: Dict[str, Any]):
        if self._phase == 0:
            self._phase = 1 if int(actions["agent_0"]) == 0 else 2
            r, done = 0.0, False
        else:
            a0, a1 = int(actions["agent_0"]), int(actions["agent_1"])
            if self._phase == 1:
                r = 7.0
            else:
                r = [[0.0, 1.0], [1.0, 8.0]][a0][a1]
            done = True
        obs = self._obs()
        rews = {a: r for a in self.agent_ids}
        terms = {a: done for a in self.agent_ids}
        truncs = {a: False for a in self.agent_ids}
        terms["__all__"] = done
        truncs["__all__"] = False
        return obs, rews, terms, truncs, {a: {} for a in self.agent_ids}


class RockPaperScissorsEnv(MultiAgentEnv):
    """Zero-sum repeated RPS (``rllib/examples/env/rock_paper_scissors``).

    API-coverage env: competitive rewards, per-agent observation of the
    opponent's last move.
    """

    agent_ids = ("player_0", "player_1")
    _BEATS = {0: 2, 1: 0, 2: 1}  # rock beats scissors, ...

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        obs_space = Box(0.0, 1.0, (3,))
        self.observation_spaces = {a: obs_space for a in self.agent_ids}
        self.action_spaces = {a: Discrete(3) for a in self.agent_ids}
        self.episode_len = int(config.get("episode_len", 10))
        self._t = 0
        self._last = {a: np.zeros(3, np.float32) for a in self.agent_ids}

    def reset(self, seed: Optional[int] = None):
        self._t = 0
        self._last = {a: np.zeros(3, np.float32) for a in self.agent_ids}
        return {a: v.copy() for a, v in self._last.items()}

    def step(self, actions):
        m0, m1 = int(actions["player_0"]), int(actions["player_1"])
        if m0 == m1:
            r0 = r1 = 0.0
        elif self._BEATS[m0] == m1:
            r0, r1 = 1.0, -1.0
        else:
            r0, r1 = -1.0, 1.0
        self._last["player_0"] = np.eye(3, dtype=np.float32)[m1]
        self._last["player_1"] = np.eye(3, dtype=np.float32)[m0]
        self._t += 1
        done = self._t >= self.episode_len
        obs = {a: v.copy() for a, v in self._last.items()}
        return (obs, {"player_0": r0, "player_1": r1},
                {"player_0": False, "player_1": False, "__all__": False},
                {"player_0": done, "player_1": done, "__all__": done},
                {a: {} for a in self.agent_ids})


class MultiAgentBatch(dict):
    """policy_id -> SampleBatch (reference ``sample_batch.MultiAgentBatch``)."""

    def __init__(self, *args, env_step_count: Optional[int] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._env_step_count = env_step_count

    @property
    def env_steps(self) -> int:
        """True environment steps — NOT agent rows (with shared policies a
        policy batch holds one row per agent per env step)."""
        if self._env_step_count is not None:
            return self._env_step_count
        return max((len(b) for b in self.values()), default=0)

    def agent_steps(self) -> int:
        return sum(len(b) for b in self.values())


class MultiAgentRolloutWorker:
    """Steps a MultiAgentEnv, demultiplexing per-policy SampleBatches.

    Plain class like ``RolloutWorker`` — works inline or as a
    ray_tpu_torch actor. One Policy instance per policy_id;
    ``policy_mapping_fn`` routes agent_ids to policies. ``device``: where
    the policies act (``None``: ``cuda``).
    """

    def __init__(self, env_maker: Callable[[dict], MultiAgentEnv],
                 env_config: Optional[dict] = None,
                 policy_mapping_fn: Optional[Callable[[str], str]] = None,
                 policies: Optional[Dict[str, dict]] = None,
                 rollout_fragment_length: int = 200,
                 policy_config: Optional[dict] = None, seed: int = 0,
                 worker_index: int = 0,
                 policy_cls: Callable[..., Policy] = Policy,
                 gamma: float = 0.99, lambda_: float = 0.95,
                 device=None):
        self.env = env_maker(dict(env_config or {}))
        self.mapping = policy_mapping_fn or (lambda aid: aid)
        self.fragment_length = rollout_fragment_length
        self.gamma, self.lambda_ = gamma, lambda_
        self.worker_index = worker_index
        policy_ids = sorted({self.mapping(a) for a in self.env.agent_ids})
        self.policies: Dict[str, Policy] = {}
        for k, pid in enumerate(policy_ids):
            # spec from any agent mapped to this policy
            aid = next(a for a in self.env.agent_ids
                       if self.mapping(a) == pid)
            spec = EnvSpec(self.env.observation_spaces[aid],
                           self.env.action_spaces[aid],
                           max_episode_steps=10_000)
            cfg = dict(policy_config or {})
            if policies and pid in policies:
                cfg.update(policies[pid] or {})
            self.policies[pid] = policy_cls(
                spec, cfg, seed=seed + worker_index * 10007 + k,
                device=device)
        self._obs = self.env.reset(seed=seed + worker_index * 10007)
        self._eps_id = 0
        self._eps_return = 0.0
        self._eps_len = 0
        self._completed: List[dict] = []

    def sample(self) -> MultiAgentBatch:
        # Collect per AGENT (not per policy): with shared policies, rows
        # from different agents must not interleave before GAE — the
        # values[t+1] recursion would pair one agent's step with the
        # other's. Group into policy batches only after advantages exist.
        keys = (SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
                SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS,
                SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS,
                SampleBatch.EPS_ID, "bootstrap_values")
        cols: Dict[str, Dict[str, list]] = {
            aid: {k: [] for k in keys} for aid in self.env.agent_ids}
        for _ in range(self.fragment_length):
            actions, logps, vfs = {}, {}, {}
            for aid, ob in self._obs.items():
                pid = self.mapping(aid)
                a, lp, vf = self.policies[pid].compute_actions(ob[None])
                actions[aid] = a[0]
                logps[aid], vfs[aid] = lp[0], vf[0]
            obs2, rews, terms, truncs, _ = self.env.step(actions)
            for aid in self._obs:
                c = cols[aid]
                term = terms.get(aid, False) or terms.get("__all__", False)
                trunc = truncs.get(aid, False) or truncs.get(
                    "__all__", False)
                # time-limit truncation bootstraps from V(terminal obs),
                # matching the single-agent path (rollout_worker.py)
                boot = 0.0
                if trunc and not term and aid in obs2:
                    boot = float(self.policies[self.mapping(aid)].value(
                        obs2[aid][None])[0])
                c[SampleBatch.OBS].append(self._obs[aid])
                c[SampleBatch.ACTIONS].append(actions[aid])
                c[SampleBatch.REWARDS].append(rews.get(aid, 0.0))
                c[SampleBatch.TERMINATEDS].append(term)
                c[SampleBatch.TRUNCATEDS].append(trunc)
                c[SampleBatch.ACTION_LOGP].append(logps[aid])
                c[SampleBatch.VF_PREDS].append(vfs[aid])
                c[SampleBatch.EPS_ID].append(self._eps_id)
                c["bootstrap_values"].append(boot)
            self._eps_return += float(np.mean(
                [rews.get(a, 0.0) for a in self._obs]))
            self._eps_len += 1
            done = terms.get("__all__", False) or truncs.get("__all__", False)
            if done:
                self._completed.append({
                    "episode_reward": self._eps_return,
                    "episode_len": self._eps_len})
                self._eps_return, self._eps_len = 0.0, 0
                self._eps_id += 1
                self._obs = self.env.reset()
            else:
                self._obs = obs2

        per_policy: Dict[str, List[SampleBatch]] = {
            pid: [] for pid in self.policies}
        for aid, c in cols.items():
            pid = self.mapping(aid)
            batch = SampleBatch({k: np.asarray(v) for k, v in c.items()})
            # GAE per episode segment; bootstrap the live tail with the
            # policy's value of this agent's current obs
            for frag in batch.split_by_episode():
                last_trunc = bool(frag[SampleBatch.TRUNCATEDS][-1])
                last_term = bool(frag[SampleBatch.TERMINATEDS][-1])
                if last_term or last_trunc:
                    last_v = 0.0  # compute_gae reads bootstrap_values
                else:
                    last_v = float(self.policies[pid].value(
                        self._obs[aid][None])[0])
                compute_gae(frag, last_v, self.gamma, self.lambda_)
                per_policy[pid].append(frag)
        return MultiAgentBatch(
            {pid: concat_samples(frags)
             for pid, frags in per_policy.items() if frags},
            env_step_count=self.fragment_length)

    def pop_metrics(self) -> List[dict]:
        out, self._completed = self._completed, []
        return out

    def get_weights(self) -> Dict[str, Any]:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            if pid in self.policies:
                self.policies[pid].set_weights(w)

    def apply(self, fn):
        return fn(self)

    def stop(self) -> None:
        pass


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MultiAgentPPO)
        self.policies: Dict[str, dict] = {}
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        self.train_batch_size = 400
        self.sgd_minibatch_size = 64
        self.num_sgd_iter = 10

    def multi_agent(self, policies: Optional[Dict[str, dict]] = None,
                    policy_mapping_fn: Optional[Callable[[str], str]] = None
                    ) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self


class MultiAgentPPO(Algorithm):
    """Independent PPO learners, one per policy_id (the reference's
    default multi-agent mode: no parameter sharing, per-policy updates)."""

    _config_cls = MultiAgentPPOConfig

    @classmethod
    def get_default_config(cls) -> MultiAgentPPOConfig:
        return MultiAgentPPOConfig(cls)

    def _make_worker_set(self):
        cfg = self.algo_config
        env = cfg.env
        maker = env if callable(env) else _ma_registry_maker(env)
        worker = MultiAgentRolloutWorker(
            maker, env_config=cfg.env_config,
            policy_mapping_fn=cfg.policy_mapping_fn,
            policies=cfg.policies,
            rollout_fragment_length=cfg.rollout_fragment_length,
            policy_config=dict(cfg.model), seed=cfg.seed,
            gamma=cfg.gamma, lambda_=getattr(cfg, "lambda_", 0.95),
            device="cpu")
        return _LocalOnlyWorkerSet(worker)

    def _make_learner(self) -> Dict[str, PPOLearner]:
        cfg = self.algo_config
        lw = self.workers.local_worker
        self.kl_coeff = {pid: cfg.kl_coeff for pid in lw.policies}
        return {pid: PPOLearner(pol.get_weights(), cfg, pol.continuous,
                                mesh=cfg.mesh, device=self.device)
                for pid, pol in lw.policies.items()}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        lw = self.workers.local_worker
        collected: Dict[str, List[SampleBatch]] = {
            pid: [] for pid in lw.policies}
        steps = 0
        while steps < cfg.train_batch_size:
            ma = lw.sample()
            steps += ma.env_steps
            for pid, b in ma.items():
                collected[pid].append(b)
        metrics: Dict[str, Any] = {"timesteps_this_iter": steps}
        self._timesteps_total += steps
        for pid, batches in collected.items():
            batch = concat_samples(batches)
            batch[SampleBatch.ADVANTAGES] = standardize(
                batch[SampleBatch.ADVANTAGES])
            n = (len(batch) // cfg.sgd_minibatch_size
                 ) * cfg.sgd_minibatch_size
            batch = (batch.slice(0, n) if n
                     else batch.pad_to(cfg.sgd_minibatch_size))
            m = self.learner[pid].train(batch, self.kl_coeff[pid])
            kl = m["kl"]
            if kl > 2.0 * cfg.kl_target:
                self.kl_coeff[pid] *= 1.5
            elif kl < 0.5 * cfg.kl_target:
                self.kl_coeff[pid] *= 0.5
            lw.policies[pid].set_weights(self.learner[pid].get_weights())
            metrics[pid] = m
        return metrics

    def _learner_state(self):
        return {"learners": {pid: ln.state()
                             for pid, ln in self.learner.items()},
                "kl_coeff": dict(self.kl_coeff)}

    def _set_learner_state(self, state):
        if state:
            for pid, s in state["learners"].items():
                self.learner[pid].set_state(s)
            self.kl_coeff = dict(state["kl_coeff"])

    def get_weights(self):
        return self.workers.local_worker.get_weights()

    def set_weights(self, weights):
        self.workers.local_worker.set_weights(weights)


class _LocalOnlyWorkerSet:
    """WorkerSet shim for the (local-only) multi-agent worker."""

    def __init__(self, worker: MultiAgentRolloutWorker):
        self.local_worker = worker
        self.remote_workers: list = []

    def sync_weights(self) -> None:
        pass

    def collect_metrics(self) -> List[dict]:
        return self.local_worker.pop_metrics()

    def stop(self) -> None:
        self.local_worker.stop()


_MA_REGISTRY: Dict[str, Callable[[dict], MultiAgentEnv]] = {
    "CoordinationGame": lambda c: CoordinationGameEnv(c),
    "RockPaperScissors": lambda c: RockPaperScissorsEnv(c),
}


def _ma_registry_maker(name: str) -> Callable[[dict], MultiAgentEnv]:
    if name not in _MA_REGISTRY:
        raise KeyError(f"Unknown multi-agent env {name!r}; registered: "
                       f"{sorted(_MA_REGISTRY)}")
    return _MA_REGISTRY[name]


def register_multi_agent_env(name: str,
                             maker: Callable[[dict], MultiAgentEnv]) -> None:
    _MA_REGISTRY[name] = maker
