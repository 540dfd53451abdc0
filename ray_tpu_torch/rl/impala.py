"""IMPALA: asynchronous actor-learner with V-trace off-policy correction.

Port of ``ray_tpu/rl/impala.py``. Parity with ``rllib/algorithms/impala/``
(async sampling into a central learner, ``vtrace_torch.py``): in-flight
``sample.remote()`` futures kept saturated per worker, and one V-trace
update on the learner's device, which the batch enters with one
host->device copy per column. Where the JAX package compiles the update
into one XLA program (V-trace's reverse ``lax.scan`` inside), here it is
eager: V-trace is a reverse loop over time, and the optimizer is optax's
arithmetic written on the tree (``clip_rmsprop_step_``, or
``clip_adam_step_`` for memory models).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rl import models as _models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.ppo import (adam_init, clip_adam_step_,
                                  clip_by_global_norm, opt_state_from_numpy,
                                  opt_state_to_numpy)
from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device

RMSPROP_DECAY, RMSPROP_EPS = 0.99, 0.1
AUX_KEYS = ("policy_loss", "vf_loss", "entropy")


class ImpalaConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or Impala)
        self.lr = 5e-4
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.num_rollout_workers = 2
        self.rollout_fragment_length = 50
        self.max_sample_requests_in_flight_per_worker = 2
        self.broadcast_interval = 1
        # None = vanilla V-trace PG; a float enables APPO's clipped
        # surrogate (declared here so .training(clip_param=) binds
        # instead of falling into the extras dict)
        self.clip_param = None


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           discounts, clip_rho: float = 1.0, clip_c: float = 1.0):
    """V-trace targets (Espeholt et al. 2018), time-major [T, B] inputs.

    Returns (vs, pg_advantages), outside any autograd graph (the JAX
    package's ``stop_gradient`` on both)."""
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = rhos.clamp(max=clip_rho)
    cs = rhos.clamp(max=clip_c)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = clipped_rhos * (rewards + discounts * vs_t_plus_1 - values)
    return vs, pg_adv


def rmsprop_init(params: Any) -> Dict[str, Any]:
    """optax.rmsprop's state on the tree: the second moment, from 0."""
    return {"nu": _models.tree_map(torch.zeros_like, params)}


@torch.no_grad()
def clip_rmsprop_step_(leaves, grads, opt_state: Dict[str, Any],
                       max_norm: float, lr: float) -> None:
    """One ``optax.chain(clip_by_global_norm(max_norm), rmsprop(lr,
    decay=0.99, eps=0.1))`` update, in place on ``leaves`` and
    ``opt_state``: ν ← decay·ν + (1 − decay)·g², p ← p − lr·g·rsqrt(ν +
    eps). optax puts eps INSIDE the square root and has no bias correction
    (``torch.optim.RMSprop`` adds eps outside it)."""
    grads = clip_by_global_norm(grads, max_norm)
    nu = _models.tree_leaves(opt_state["nu"])
    torch._foreach_mul_(nu, RMSPROP_DECAY)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - RMSPROP_DECAY)
    scaling = torch._foreach_add(nu, RMSPROP_EPS)
    torch._foreach_rsqrt_(scaling)
    torch._foreach_mul_(scaling, grads)
    torch._foreach_add_(list(leaves), scaling, alpha=-lr)


class ImpalaLearner:
    """V-trace learner on one device. ``clip_param`` switches the policy
    term from the vanilla V-trace PG estimator to APPO's clipped surrogate
    over the same V-trace advantages (``rllib/algorithms/appo``)."""

    def __init__(self, init_params, cfg: ImpalaConfig, continuous: bool,
                 clip_param: float = None, device=None):
        from ray_tpu_torch.rl.recurrent import uses_memory_model
        self.cfg = cfg
        self.device = resolve_device(device)
        self._continuous = continuous
        self._clip_param = clip_param
        self._model_cfg = dict(cfg.model)
        # The classic IMPALA rmsprop(eps=0.1) destabilizes the
        # gated-recurrence gradients (the JAX package measured CartPole
        # pinned at random under rmsprop): memory models get adam, like
        # the reference's recurrent tuned examples.
        self.recurrent = uses_memory_model(self._model_cfg)
        self.set_state((init_params, None))

    def _forward(self, batch):
        """-> (target_logp [T,B], values [T,B], entropy, boot_values [B]);
        memory models replay each fragment from its stored state,
        feedforward models evaluate flat."""
        p = self.params
        T, B = batch[SampleBatch.REWARDS].shape
        obs = batch[SampleBatch.OBS]
        actions = batch[SampleBatch.ACTIONS]
        if self.recurrent:
            from ray_tpu_torch.rl.recurrent import (memory_bootstrap_value,
                                                    memory_forward)
            boundary = (batch[SampleBatch.TERMINATEDS]
                        | batch[SampleBatch.TRUNCATEDS]).float()   # [T, B]
            resets = torch.cat([torch.zeros_like(boundary[:1]),
                                boundary[:-1]], dim=0)
            dist_in, values, final_state = memory_forward(
                p, self._model_cfg, obs.transpose(0, 1),
                batch["state_in"][0], resets.transpose(0, 1))
            dist = _models.make_distribution(p, dist_in.transpose(0, 1),
                                             self._continuous)
            boot_values = memory_bootstrap_value(
                p, self._model_cfg, batch["bootstrap_obs"][-1],
                final_state * (1.0 - boundary[-1][:, None]))
            return (dist.logp(actions), values.transpose(0, 1),
                    dist.entropy().mean(), boot_values)
        dist_in, values = _models.actor_critic_apply(
            p, obs.reshape((T * B,) + obs.shape[2:]))
        dist = _models.make_distribution(p, dist_in, self._continuous)
        flat_actions = actions.reshape((T * B,) + actions.shape[2:])
        return (dist.logp(flat_actions).reshape(T, B),
                values.reshape(T, B), dist.entropy().mean(),
                _models.actor_critic_apply(p, batch["bootstrap_obs"][-1])[1])

    def _loss(self, batch):
        cfg = self.cfg
        target_logp, values, entropy, boot_values = self._forward(batch)
        # Truncation cuts the recursion too: the next in-fragment row
        # belongs to the auto-reset episode (see the JAX package).
        boundary = (batch[SampleBatch.TERMINATEDS]
                    | batch[SampleBatch.TRUNCATEDS])
        discounts = cfg.gamma * (1.0 - boundary.float())
        vs, pg_adv = vtrace(
            batch[SampleBatch.ACTION_LOGP], target_logp.detach(),
            batch[SampleBatch.REWARDS], values.detach(),
            boot_values.detach(), discounts,
            cfg.vtrace_clip_rho_threshold, cfg.vtrace_clip_c_threshold)
        if self._clip_param is not None:
            # APPO: PPO's clipped surrogate with the importance ratio
            # against the BEHAVIOR policy, advantages from V-trace
            ratio = torch.exp(target_logp - batch[SampleBatch.ACTION_LOGP])
            pg_loss = -torch.mean(_models.clipped_surrogate(
                ratio, pg_adv, self._clip_param))
        else:
            pg_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = 0.5 * torch.mean((vs - values) ** 2)
        total = (pg_loss + cfg.vf_loss_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        return total, (pg_loss, vf_loss, entropy)

    def update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update on time-major columns already on the device. Returns
        the metrics (``AUX_KEYS``) as one tensor on the device."""
        leaves = _models.tree_leaves(self.params)
        loss, aux = self._loss(batch)
        grads = torch.autograd.grad(loss, leaves)
        if self.recurrent:
            clip_adam_step_(leaves, grads, self.opt_state,
                            self.cfg.grad_clip, self.cfg.lr)
        else:
            clip_rmsprop_step_(leaves, grads, self.opt_state,
                               self.cfg.grad_clip, self.cfg.lr)
        return torch.stack([a.detach() for a in aux])

    def train(self, batch_tm: Dict[str, np.ndarray]) -> Dict[str, float]:
        aux = self.update(batch_to_device(batch_tm, self.device))
        return dict(zip(AUX_KEYS, aux.tolist()))

    def get_weights(self):
        return _models.to_numpy(self.params)

    def state(self):
        return self.get_weights(), opt_state_to_numpy(self.opt_state)

    def set_state(self, state):
        params, opt_state = state
        self.params = _models.params_from_numpy(params, self.device)
        for t in _models.tree_leaves(self.params):
            t.requires_grad_(True)
        if opt_state is not None:
            self.opt_state = opt_state_from_numpy(opt_state, self.device)
        elif self.recurrent:
            self.opt_state = adam_init(self.params)
        else:
            self.opt_state = rmsprop_init(self.params)


def to_time_major(batch: SampleBatch, T: int) -> Dict[str, np.ndarray]:
    """The columns the learner reads, as time-major [T, B, ...] blocks of
    whole fragments of length ``T`` (a trailing partial one is dropped)."""
    n = (len(batch) // T) * T
    out = {}
    keys = [SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
            SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS,
            SampleBatch.ACTION_LOGP, "bootstrap_obs"]
    if "state_in" in batch:
        keys.append("state_in")  # memory models: fragment-start state
    for k in keys:
        v = batch[k][:n]
        out[k] = np.swapaxes(v.reshape((n // T, T) + v.shape[1:]), 0, 1)
    return out


class Impala(Algorithm):
    _config_cls = ImpalaConfig

    @classmethod
    def get_default_config(cls) -> ImpalaConfig:
        return ImpalaConfig(cls)

    def _needs_advantages(self) -> bool:
        return False

    def _make_learner(self) -> ImpalaLearner:
        cfg = self.algo_config
        lw = self.workers.local_worker
        self._in_flight: Dict[Any, Any] = {}
        self._broadcast_countdown = 0
        return ImpalaLearner(lw.get_weights(), cfg, lw.policy.continuous,
                             clip_param=cfg.clip_param, device=self.device)

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        cfg = self.algo_config
        metrics: Dict[str, Any] = {}
        if not self.workers.remote_workers:
            # Degenerate sync mode with only the local worker.
            batch = self.workers.local_worker.sample()
            batches = [batch]
        else:
            # Keep every worker saturated with in-flight sample requests.
            for w in self.workers.remote_workers:
                pending = sum(1 for ref, src in self._in_flight.items()
                              if src is w)
                for _ in range(
                        cfg.max_sample_requests_in_flight_per_worker
                        - pending):
                    self._in_flight[w.sample.remote()] = w
            ready, _ = ray_tpu_torch.wait(
                list(self._in_flight), num_returns=1, timeout=30.0)
            from ray_tpu_torch.exceptions import ActorDiedError
            batches = []
            stale_workers = set()
            for r in ready:
                w = self._in_flight.pop(r)
                try:
                    batches.append(ray_tpu_torch.get(r))
                    stale_workers.add(w)
                except ActorDiedError:
                    fresh = self.workers.recreate_failed_worker(w)
                    # Drop the dead worker's other in-flight refs.
                    for ref, src in list(self._in_flight.items()):
                        if src is w:
                            self._in_flight.pop(ref)
                    stale_workers.add(fresh)
            # Async weight push: only refresh the workers just harvested
            # (reference broadcast_interval semantics).
            self._broadcast_countdown -= 1
            if self._broadcast_countdown <= 0:
                weights_ref = ray_tpu_torch.put(self.learner.get_weights())
                for w in stale_workers:
                    w.set_weights.remote(weights_ref)
                self._broadcast_countdown = cfg.broadcast_interval
        total = 0
        per_batch: List[Dict[str, float]] = []
        for batch in batches:
            tm = to_time_major(batch, cfg.rollout_fragment_length)
            per_batch.append(self.learner.train(tm))
            total += len(batch)
        self._timesteps_total += total
        self.workers.local_worker.set_weights(self.learner.get_weights())
        if per_batch:
            metrics = {k: float(np.mean([m[k] for m in per_batch]))
                       for k in per_batch[0]}
        metrics["timesteps_this_iter"] = total
        return metrics

    def _learner_state(self):
        return {"learner": self.learner.state()}

    def _set_learner_state(self, state):
        if state:
            self.learner.set_state(state["learner"])


class APPOConfig(ImpalaConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.clip_param = 0.3
        self.lr = 3e-3          # rmsprop, small async batches
        self.entropy_coeff = 0.005


class APPO(Impala):
    """Asynchronous PPO (``rllib/algorithms/appo``): IMPALA's
    architecture — asynchronous rollout workers, V-trace off-policy
    correction — with PPO's clipped surrogate as the policy objective.
    Pure configuration of the IMPALA learner."""

    _config_cls = APPOConfig

    @classmethod
    def get_default_config(cls) -> APPOConfig:
        return APPOConfig(cls)
