"""External environments: the APPLICATION drives the loop.

Port of ``ray_tpu/rl/external_env.py``, copied (numpy).

Parity with ``rllib/env/external_env.py``: instead of the rollout
worker stepping a gym-style env, an external system (a simulator, a web
service, a live process) runs its own loop on its own thread and calls
INTO the policy —

    class MyEnv(ExternalEnv):
        def run(self):
            eid = self.start_episode()
            obs = external_system.reset()
            while True:
                action = self.get_action(eid, obs)
                obs, reward, done = external_system.step(action)
                self.log_returns(eid, reward)
                if done:
                    self.end_episode(eid, obs)
                    eid = self.start_episode()
                    obs = external_system.reset()

Sampling inverts: ``RolloutWorker.sample()`` SERVICES the env's queued
``get_action`` requests with the current policy and drains the logged
experiences into ordinary SampleBatches, so every learner (PPO, IMPALA,
...) trains from an external env unchanged. Off-policy logging
(``log_action``) records actions the external system chose itself.
"""

from __future__ import annotations

import queue
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rl.env import EnvSpec
from ray_tpu_torch.rl.sample_batch import SampleBatch, concat_samples


class _Episode:
    def __init__(self, eid: str):
        self.eid = eid
        self.obs: List[np.ndarray] = []
        self.actions: List[Any] = []
        self.logps: List[float] = []
        self.vf_preds: List[float] = []
        self.rewards: List[float] = []  # one slot per action; log_returns
        self.total = 0.0                # adds into the latest slot
        self.length = 0


class ExternalEnv(threading.Thread):
    """Subclass and implement ``run()`` (reference external_env.py:32).

    The thread starts lazily on the worker's first ``sample()``; calls
    block only in ``get_action`` (waiting for the policy's reply).
    """

    def __init__(self, spec: EnvSpec, max_queue: int = 1024):
        super().__init__(daemon=True, name=f"external-env-{id(self):x}")
        self.spec = spec
        self._requests: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._ext_started = False  # NOT _started: Thread owns that name

    # -- the user-facing protocol ---------------------------------------
    def run(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        eid = episode_id or uuid.uuid4().hex
        self._requests.put(("start", eid, None, None))
        return eid

    def get_action(self, episode_id: str, observation) -> Any:
        """Query the current policy; blocks until sample() services it."""
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._requests.put(("action", episode_id,
                            np.asarray(observation, np.float32), reply))
        return reply.get()

    def log_action(self, episode_id: str, observation, action) -> None:
        """Record an externally-chosen action (off-policy logging)."""
        self._requests.put(("log_action", episode_id,
                            (np.asarray(observation, np.float32), action),
                            None))

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._requests.put(("reward", episode_id, float(reward), None))

    def end_episode(self, episode_id: str, observation) -> None:
        self._requests.put(("end", episode_id,
                            np.asarray(observation, np.float32), None))


class ExternalEnvSampler:
    """Worker-side half: services the env's request queue with the
    policy and emits SampleBatches shaped exactly like RolloutWorker's
    (per-episode fragments, GAE when requested)."""

    def __init__(self, env: ExternalEnv, policy,
                 fragment_length: int = 200, gamma: float = 0.99,
                 lambda_: float = 0.95, compute_advantages: bool = True):
        self.env = env
        self.policy = policy
        self.fragment_length = fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self.compute_advantages = compute_advantages
        self._episodes: Dict[str, _Episode] = {}
        self._completed_frags: List[SampleBatch] = []
        self._metrics: List[dict] = []
        self._eps_seq = 0

    def _finish_episode(self, ep: _Episode, last_obs, terminated: bool):
        if ep.actions:
            self._completed_frags.append(
                self._to_batch(ep, 0.0 if terminated else float(
                    self.policy.value(np.asarray(last_obs)[None])[0]),
                    terminated))
        self._metrics.append({"episode_reward": ep.total,
                              "episode_len": ep.length})
        self._episodes.pop(ep.eid, None)

    def _to_batch(self, ep: _Episode, bootstrap: float,
                  terminated: bool) -> SampleBatch:
        from ray_tpu_torch.rl.postprocessing import compute_gae
        n = len(ep.actions)
        self._eps_seq += 1
        terms = np.zeros(n, bool)
        terms[-1] = terminated
        truncs = np.zeros(n, bool)
        truncs[-1] = not terminated
        boots = np.zeros(n, np.float32)
        if not terminated:
            # compute_gae's truncated branch reads bootstrap_values[-1];
            # a zero there would silently discard the real bootstrap
            boots[-1] = bootstrap
        frag = SampleBatch({
            SampleBatch.OBS: np.stack(ep.obs[:n]),
            SampleBatch.ACTIONS: np.asarray(ep.actions),
            SampleBatch.REWARDS: np.asarray(ep.rewards, np.float32),
            SampleBatch.TERMINATEDS: terms,
            SampleBatch.TRUNCATEDS: truncs,
            SampleBatch.ACTION_LOGP: np.asarray(ep.logps, np.float32),
            SampleBatch.VF_PREDS: np.asarray(ep.vf_preds, np.float32),
            SampleBatch.EPS_ID: np.full(n, self._eps_seq, np.int64),
            "bootstrap_values": boots,
        })
        if self.compute_advantages:
            compute_gae(frag, bootstrap, self.gamma, self.lambda_)
        else:
            frag["bootstrap_obs"] = np.repeat(
                np.asarray(ep.obs[n - 1])[None], n, 0)
        return frag

    def _handle(self, kind, eid, payload, reply) -> int:
        """Apply one request; returns the number of steps it added."""
        ep = self._episodes.get(eid)
        if kind == "start":
            self._episodes[eid] = _Episode(eid)
        elif kind == "action":
            if ep is None:
                ep = self._episodes[eid] = _Episode(eid)
            a, logp, vf = self.policy.compute_actions(payload[None])
            ep.obs.append(payload)
            ep.actions.append(a[0])
            ep.logps.append(float(logp[0]))
            ep.vf_preds.append(float(vf[0]))
            ep.rewards.append(0.0)  # log_returns fills it in
            ep.length += 1
            reply.put(a[0])
            return 1
        elif kind == "log_action":
            if ep is None:
                ep = self._episodes[eid] = _Episode(eid)
            obs, action = payload
            ep.obs.append(obs)
            ep.actions.append(action)
            ep.logps.append(0.0)
            ep.vf_preds.append(0.0)
            ep.rewards.append(0.0)
            ep.length += 1
            return 1
        elif kind == "reward":
            if ep is not None:
                # total always counts; the per-step slot only when one is
                # open (a reward racing a fragment boundary keeps the
                # metric right even though its step already shipped)
                ep.total += payload
                if ep.rewards:
                    ep.rewards[-1] += payload
        elif kind == "end":
            if ep is not None:
                self._finish_episode(ep, payload, terminated=True)
        return 0

    def sample(self) -> SampleBatch:
        """Service requests until fragment_length steps are drained."""
        import queue as _q
        if not self.env._ext_started:
            self.env._ext_started = True
            self.env.start()
        steps = 0
        while steps < self.fragment_length:
            try:
                item = self.env._requests.get(timeout=5.0)
            except _q.Empty:
                if not self.env.is_alive() and self.env._ext_started:
                    break  # finite external app: return what we have
                continue
            steps += self._handle(*item)
        # Drain already-queued trailing events (the rewards/episode-ends
        # belonging to the steps just collected) without blocking.
        while True:
            try:
                item = self.env._requests.get_nowait()
            except _q.Empty:
                break
            steps += self._handle(*item)
        out: List[SampleBatch] = list(self._completed_frags)
        self._completed_frags = []
        # open episodes contribute their collected prefix (truncated
        # fragment bootstrapped from the policy's value at the last obs)
        for ep in list(self._episodes.values()):
            if ep.actions:
                out.append(self._to_batch(
                    ep, float(self.policy.value(
                        np.asarray(ep.obs[-1])[None])[0]),
                    terminated=False))
                # keep the episode open but drop consumed transitions
                fresh = _Episode(ep.eid)
                fresh.total = ep.total
                fresh.length = ep.length
                self._episodes[ep.eid] = fresh
        return concat_samples(out) if out else SampleBatch({
            SampleBatch.OBS: np.zeros((0, 1), np.float32)})

    def pop_metrics(self) -> List[dict]:
        out, self._metrics = self._metrics, []
        return out
