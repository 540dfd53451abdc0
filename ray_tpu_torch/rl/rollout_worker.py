"""Rollout collection: env-stepping workers and the set that manages them.

Port of ``ray_tpu/rl/rollout_worker.py``, copied but for the policy's
device. Parity with ``rllib/evaluation/rollout_worker.py``
(``RolloutWorker.sample``), ``worker_set.py`` (``WorkerSet``,
``sync_weights``) and ``rllib/execution/rollout_ops.py:36``
(``synchronous_parallel_sample``). Workers are CPU actors stepping numpy
envs; the policy network runs on the device the worker is given
(``Algorithm`` gives ``"cpu"``). The learner never sees an env.
"""

from __future__ import annotations
import logging

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rl.env import VectorEnv, make_env
from ray_tpu_torch.rl.policy import Policy
from ray_tpu_torch.rl.postprocessing import compute_gae
from ray_tpu_torch.rl.sample_batch import SampleBatch, concat_samples

logger = logging.getLogger("ray_tpu")


class RolloutWorker:
    """Steps a VectorEnv with the current policy, emitting SampleBatches.

    Plain class — usable inline (local worker) or as a ``ray_tpu_torch`` actor
    (remote workers), same as the reference's dual-use RolloutWorker.
    """

    def __init__(self, env_name_or_maker, env_config: Optional[dict] = None,
                 num_envs: int = 1, rollout_fragment_length: int = 200,
                 policy_config: Optional[dict] = None, seed: int = 0,
                 worker_index: int = 0,
                 policy_cls: Callable[..., Policy] = Policy,
                 gamma: float = 0.99, lambda_: float = 0.95,
                 compute_advantages: bool = True, device=None):
        # device: where the policy acts (None: cuda, as every entry point)
        base_seed = seed + worker_index * 10007
        from ray_tpu_torch.rl.external_env import ExternalEnv, ExternalEnvSampler
        probe = make_env(env_name_or_maker, dict(env_config or {}))
        if isinstance(probe, ExternalEnv):
            # Application-driven env: sampling SERVICES its queue instead
            # of stepping it (reference external_env.py integration).
            from ray_tpu_torch.rl.connectors import ConnectorPipeline
            self.obs_connectors = ConnectorPipeline([])
            self.action_connectors = ConnectorPipeline([])
            self.policy = policy_cls(probe.spec, policy_config,
                                     seed=base_seed, device=device)
            self._external = ExternalEnvSampler(
                probe, self.policy, fragment_length=rollout_fragment_length,
                gamma=gamma, lambda_=lambda_,
                compute_advantages=compute_advantages)
            self.vector_env = None
            self.fragment_length = rollout_fragment_length
            self.gamma, self.lambda_ = gamma, lambda_
            self.compute_advantages = compute_advantages
            self.worker_index = worker_index
            self._spec = probe.spec
            return
        self._external = None
        self.vector_env = VectorEnv(
            lambda c: make_env(env_name_or_maker, c), num_envs,
            env_config, seed=base_seed)
        self.fragment_length = rollout_fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self.compute_advantages = compute_advantages
        self.worker_index = worker_index
        # Connector pipelines (rllib/connectors role): obs transforms on
        # the way in, action transforms on the way out, built per worker
        # from (name, kwargs) specs in the model config.
        from ray_tpu_torch.rl.connectors import ConnectorPipeline, build_connectors
        cfg = dict(policy_config or {})
        self.obs_connectors = ConnectorPipeline(
            build_connectors(cfg.get("obs_connectors")))
        self.action_connectors = ConnectorPipeline(
            build_connectors(cfg.get("action_connectors")))
        self.action_connectors.bind_space(self.vector_env.spec.action_space)
        self._obs = self._transform_obs(
            self.vector_env.reset(seed=base_seed))
        # Connectors may reshape observations (frame stacking): the
        # policy must be built against the TRANSFORMED shape.
        spec = self.vector_env.spec
        obs_shape = np.asarray(self._obs).shape[1:]
        if tuple(obs_shape) != tuple(spec.observation_space.shape):
            from dataclasses import replace as _dc_replace
            from ray_tpu_torch.rl.env import Box as _Box
            spec = _dc_replace(spec, observation_space=_Box(
                -np.inf, np.inf, tuple(obs_shape)))
        self.policy = policy_cls(spec, policy_config, seed=base_seed,
                                 device=device)
        self._eps_ids = np.arange(num_envs, dtype=np.int64)
        self._next_eps_id = num_envs
        self._eps_return = np.zeros(num_envs, np.float64)
        self._eps_len = np.zeros(num_envs, np.int64)
        self._completed: List[dict] = []

    def _transform_obs(self, obs):
        if not self.obs_connectors.connectors:
            return obs
        return self.obs_connectors(obs)

    def _peek_obs(self, obs):
        """Transform WITHOUT advancing connector state (bootstrap-value
        observations are side looks, not steps)."""
        if not self.obs_connectors.connectors:
            return obs
        return self.obs_connectors.peek(obs)

    def sample(self) -> SampleBatch:
        """Collect ``fragment_length`` steps per sub-env (column-major)."""
        if self._external is not None:
            return self._external.sample()
        n_envs = self.vector_env.num_envs
        T = self.fragment_length
        cols: Dict[str, list] = {k: [] for k in (
            SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
            SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS,
            SampleBatch.ACTION_LOGP, SampleBatch.VF_PREDS,
            SampleBatch.EPS_ID, "bootstrap_values")}
        # Stateful (recurrent/attention) policies: snapshot the per-env
        # recurrent state at fragment START — the learner replays each
        # fragment from it (rllib's state_in_0 / seq_lens contract).
        get_state = getattr(self.policy, "get_recurrent_state", None)
        state0 = get_state(n_envs) if get_state is not None else None
        for _ in range(T):
            actions, logp, values = self.policy.compute_actions(self._obs)
            env_actions = (self.action_connectors(actions)
                           if self.action_connectors.connectors
                           else actions)
            obs2, rews, terms, truncs, infos = self.vector_env.step(
                env_actions)
            boots = np.zeros(n_envs, np.float32)
            trunc_idx = [i for i in range(n_envs)
                         if truncs[i] and not terms[i]]
            if trunc_idx:
                term_obs = np.stack(
                    [infos[i]["terminal_obs"] for i in trunc_idx])
                term_obs = self._peek_obs(term_obs)
                if state0 is not None:
                    # stateful policy: value for a SUBSET of envs needs
                    # the matching state rows
                    vals = self.policy.value(term_obs,
                                             env_indices=trunc_idx)
                else:
                    vals = self.policy.value(term_obs)
                for j, i in enumerate(trunc_idx):
                    boots[i] = vals[j]
            cols[SampleBatch.OBS].append(self._obs)
            cols[SampleBatch.ACTIONS].append(actions)
            cols[SampleBatch.REWARDS].append(rews)
            cols[SampleBatch.TERMINATEDS].append(terms)
            cols[SampleBatch.TRUNCATEDS].append(truncs)
            cols[SampleBatch.ACTION_LOGP].append(logp)
            cols[SampleBatch.VF_PREDS].append(values)
            cols[SampleBatch.EPS_ID].append(self._eps_ids.copy())
            cols["bootstrap_values"].append(boots)
            self._eps_return += rews
            self._eps_len += 1
            done_idx = []
            for i in range(n_envs):
                if terms[i] or truncs[i]:
                    done_idx.append(i)
                    self._completed.append({
                        "episode_reward": float(self._eps_return[i]),
                        "episode_len": int(self._eps_len[i])})
                    self._eps_return[i] = 0.0
                    self._eps_len[i] = 0
                    self._eps_ids[i] = self._next_eps_id
                    self._next_eps_id += 1
            if done_idx:
                # recurrent policies must not carry memory across the
                # episode boundary (the sub-env auto-reset)
                reset_hook = getattr(self.policy, "on_episode_end", None)
                if reset_hook is not None:
                    reset_hook(done_idx)
                self.obs_connectors.on_episode_end(done_idx)
            self._obs = self._transform_obs(obs2)

        # Per-env fragments so GAE recursion never crosses env boundaries.
        stacked = {k: np.stack(v) for k, v in cols.items()}  # [T, n_envs,...]
        # Bootstrap obs for the step after the fragment end: the live obs,
        # or the pre-reset terminal obs if the final step truncated.
        boot_obs = np.asarray(self._obs).copy()
        for i in range(n_envs):
            if truncs[i] and not terms[i] and "terminal_obs" in infos[i]:
                # self._obs is already connector-transformed; a raw
                # terminal obs must go through the same (peeked) pipe
                boot_obs[i] = self._peek_obs(
                    np.asarray(infos[i]["terminal_obs"])[None])[0]
        last_values = self.policy.value(boot_obs)
        frags = []
        for i in range(n_envs):
            frag = SampleBatch({k: v[:, i] for k, v in stacked.items()})
            if state0 is not None:
                # broadcast per step so concat/shuffle stays rectangular;
                # the learner reads row 0 of each T-block
                frag["state_in"] = np.repeat(
                    np.asarray(state0[i])[None], T, 0)
            if self.compute_advantages:
                compute_gae(frag, float(last_values[i]),
                            self.gamma, self.lambda_)
            else:
                # Off-policy learners (V-trace) re-evaluate values with the
                # learner's own network; ship the bootstrap obs per step
                # (broadcast per fragment) so no worker-side values leak in.
                frag["bootstrap_obs"] = np.repeat(boot_obs[i][None], T, 0)
            frags.append(frag)
        return concat_samples(frags)

    def pop_metrics(self) -> List[dict]:
        if self._external is not None:
            return self._external.pop_metrics()
        out, self._completed = self._completed, []
        return out

    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def get_connector_state(self):
        return self.obs_connectors.state()

    def set_connector_state(self, state) -> None:
        self.obs_connectors.set_state(state)

    def get_spec(self):
        if self._external is not None:
            return self._spec
        return self.vector_env.spec

    def apply(self, fn: Callable[["RolloutWorker"], Any]) -> Any:
        return fn(self)

    def stop(self) -> None:
        pass


class WorkerSet:
    """A local worker + N remote worker actors (``worker_set.py``).

    Dead remote workers are transparently recreated and re-synced on the
    next operation that touches them (the reference's
    ``recreate_failed_workers``, ``worker_set.py``)."""

    def __init__(self, num_workers: int, worker_kwargs: Dict[str, Any],
                 num_cpus_per_worker: float = 1.0):
        import ray_tpu_torch
        self.local_worker = RolloutWorker(worker_index=0, **worker_kwargs)
        self._worker_kwargs = dict(worker_kwargs)
        self._num_cpus_per_worker = num_cpus_per_worker
        self._remote_cls = ray_tpu_torch.remote(RolloutWorker)
        self.remote_workers = [self._spawn(i + 1)
                               for i in range(num_workers)]

    def _spawn(self, worker_index: int):
        return self._remote_cls.options(
            num_cpus=self._num_cpus_per_worker).remote(
                worker_index=worker_index, **self._worker_kwargs)

    def recreate_failed_worker(self, worker) -> Any:
        """Replace a dead worker handle with a fresh actor carrying the
        local worker's current weights."""
        import ray_tpu_torch
        i = self.remote_workers.index(worker)
        fresh = self._spawn(i + 1)
        fresh.set_weights.remote(self.local_worker.get_weights())
        self.remote_workers[i] = fresh
        return fresh

    def sync_weights(self) -> None:
        """Broadcast local weights to remotes (``ppo.py:427-430``)."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ActorDiedError
        if not self.remote_workers:
            return
        weights_ref = ray_tpu_torch.put(self.local_worker.get_weights())
        for w, ref in [(w, w.set_weights.remote(weights_ref))
                       for w in list(self.remote_workers)]:
            try:
                ray_tpu_torch.get(ref)
            except ActorDiedError:
                self.recreate_failed_worker(w)
        # Connector statistics flow the OTHER way: the SAMPLING workers
        # own the running obs stats (they see the data); the local worker
        # adopts a sampler's stats so evaluation/learner-side transforms
        # match. Pushing local->remote would wipe the learned stats with
        # the local worker's empty ones every iteration.
        try:
            state = ray_tpu_torch.get(
                self.remote_workers[0].get_connector_state.remote())
            if state and any(s is not None for s in state):
                self.local_worker.set_connector_state(state)
        except (ActorDiedError, IndexError):
            pass

    def foreach_worker(self, fn: Callable[[RolloutWorker], Any]) -> List[Any]:
        import ray_tpu_torch
        results = [fn(self.local_worker)]
        if self.remote_workers:
            results += ray_tpu_torch.get(
                [w.apply.remote(fn) for w in self.remote_workers])
        return results

    def collect_metrics(self) -> List[dict]:
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ActorDiedError
        episodes = self.local_worker.pop_metrics()
        for w, ref in [(w, w.pop_metrics.remote())
                       for w in list(self.remote_workers)]:
            try:
                episodes.extend(ray_tpu_torch.get(ref))
            except ActorDiedError:
                self.recreate_failed_worker(w)
        return episodes

    def stop(self) -> None:
        import ray_tpu_torch
        for w in self.remote_workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception as e:
                logger.debug("worker kill failed: %s", e)
        self.remote_workers = []


def synchronous_parallel_sample(workers: WorkerSet,
                                max_env_steps: Optional[int] = None
                                ) -> SampleBatch:
    """Round-robin sample() across all workers until the step budget is met
    (reference: ``rollout_ops.py:36``)."""
    import ray_tpu_torch
    from ray_tpu_torch.exceptions import ActorDiedError
    batches: List[SampleBatch] = []
    total = 0
    while True:
        round_batches = []
        if workers.remote_workers:
            refs = [(w, w.sample.remote()) for w in workers.remote_workers]
            for w, ref in refs:
                try:
                    round_batches.append(ray_tpu_torch.get(ref))
                except ActorDiedError:
                    workers.recreate_failed_worker(w)
        else:
            round_batches = [workers.local_worker.sample()]
        for b in round_batches:
            batches.append(b)
            total += len(b)
        if max_env_steps is None or total >= max_env_steps:
            break
    return concat_samples(batches)
