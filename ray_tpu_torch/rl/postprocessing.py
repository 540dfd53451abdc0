"""Advantage estimation.

Port of ``ray_tpu/rl/postprocessing.py``, copied (numpy).

Parity with ``rllib/evaluation/postprocessing.py`` (``compute_advantages``,
``compute_gae_for_sample_batch``): GAE(lambda) over collected fragments,
with value bootstrapping at truncation boundaries.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


def compute_gae(batch: SampleBatch, last_value: float, gamma: float = 0.99,
                lambda_: float = 0.95,
                standardize_advantages: bool = False) -> SampleBatch:
    """Append ADVANTAGES and VALUE_TARGETS to ``batch`` (in place).

    ``terminateds`` zero the bootstrap (true episode end); ``truncateds``
    bootstrap from VF_PREDS of the *terminal* obs which the rollout worker
    stores as the step's own vf estimate continuation — we bootstrap from
    ``last_value`` only past the fragment end.
    """
    rewards = batch[SampleBatch.REWARDS].astype(np.float64)
    values = batch[SampleBatch.VF_PREDS].astype(np.float64)
    terminated = batch[SampleBatch.TERMINATEDS].astype(bool)
    truncated = batch.get(SampleBatch.TRUNCATEDS)
    truncated = (truncated.astype(bool) if truncated is not None
                 else np.zeros_like(terminated))
    bootstrap = batch.get("bootstrap_values")
    n = len(rewards)
    adv = np.zeros(n, np.float64)
    last_gae = 0.0
    for t in reversed(range(n)):
        if t == n - 1:
            if truncated[t] and bootstrap is not None:
                next_value = float(bootstrap[t])
            elif terminated[t]:
                next_value = 0.0
            else:
                next_value = last_value
        elif terminated[t] or truncated[t]:
            next_value = 0.0
        else:
            next_value = values[t + 1]
        # At episode boundaries inside the fragment the next state belongs
        # to a new episode: cut the recursion. For truncation, bootstrap
        # from the recorded terminal-state value if available.
        if t < n - 1 and truncated[t] and bootstrap is not None:
            next_value = float(bootstrap[t])
        nonterminal = 0.0 if terminated[t] else 1.0
        boundary = terminated[t] or truncated[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lambda_ * (0.0 if boundary else last_gae)
        adv[t] = last_gae
    targets = adv + values
    if standardize_advantages:
        adv = (adv - adv.mean()) / max(1e-4, adv.std())
    batch[SampleBatch.ADVANTAGES] = adv.astype(np.float32)
    batch[SampleBatch.VALUE_TARGETS] = targets.astype(np.float32)
    return batch


def standardize(x: np.ndarray) -> np.ndarray:
    """Reference: ``rllib/utils/numpy.py`` ``standardized`` (ppo.py:415)."""
    return (x - x.mean()) / max(1e-4, x.std())


def add_next_obs(batch: SampleBatch) -> SampleBatch:
    """Append NEXT_OBS from the obs column + episode boundaries, dropping
    fragment-boundary rows whose successor obs never made it into the
    fragment (standard discard; negligible at fragment_length >= 4).

    Shared by the replay-based learners (DQN/SAC): within an episode
    s'[t] = s[t+1]; at a non-terminal fragment/episode boundary the
    transition is dropped rather than paired with a bogus successor.
    """
    eps = batch[SampleBatch.EPS_ID]
    keep = np.ones(len(batch), bool)
    # zeros (not empty): rows at masked boundaries still pass through the
    # target net, and garbage floats there can overflow to inf and poison
    # 0 * inf = NaN targets.
    next_obs = np.zeros_like(batch[SampleBatch.OBS])
    next_obs[:-1] = batch[SampleBatch.OBS][1:]
    for t in range(len(batch)):
        last = t == len(batch) - 1 or eps[t + 1] != eps[t]
        if last and not batch[SampleBatch.TERMINATEDS][t]:
            keep[t] = False
    out = SampleBatch({**{k: v for k, v in batch.items()},
                       SampleBatch.NEXT_OBS: next_obs})
    idx = np.nonzero(keep)[0]
    return SampleBatch({k: v[idx] for k, v in out.items()})
