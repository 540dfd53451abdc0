"""BOHB: Bayesian-Optimization HyperBand.

Parity with the reference's BOHB pair — ``TuneBOHB``
(``python/ray/tune/search/bohb/bohb_search.py``, an HpBandSter wrapper)
plus ``HyperBandForBOHB`` (``python/ray/tune/schedulers/hb_bohb.py``) —
re-implemented natively on this package's TPE machinery instead of an
external dependency, exactly as ``tpe.py`` replaces Optuna/hyperopt
(Falkner et al. 2018: HyperBand for budget allocation, a TPE/KDE model
fit per budget for config selection).

Multi-fidelity rule (the BOHB paper's): observations are bucketed by the
budget (``time_attr`` value) they were measured at; the model for the
next suggestion is fit on the LARGEST budget that has at least
``min_points_in_model`` observations — results from cheap rungs guide
early, and get superseded by full-budget evidence as it accumulates.
With probability ``random_fraction`` a configuration is sampled at
random instead (keeps the bandit honest, per the paper).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.schedulers import HyperBandScheduler
from ray_tpu_torch.tune.tpe import TPESearcher


class BOHBSearcher(TPESearcher):
    """Model-based searcher for HyperBand-style multi-fidelity runs.

    Space compilation, Parzen proposal machinery, and the suggest loop
    are inherited from :class:`TPESearcher`; only observation management
    (per-budget buckets) and model selection differ. Use with
    ``HyperBandForBOHB`` (or any banded scheduler): the runner feeds
    every intermediate result through ``on_trial_result``, which is
    where the per-budget observation sets are built — completion-only
    feedback would discard exactly the low-budget evidence BOHB exists
    to exploit.
    """

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 num_samples: int = 64,
                 time_attr: str = "training_iteration",
                 min_points_in_model: int = 6,
                 gamma: float = 0.25, n_candidates: int = 24,
                 random_fraction: float = 1.0 / 3.0,
                 seed: Optional[int] = None):
        super().__init__(space, metric, mode, num_samples=num_samples,
                         gamma=gamma, n_candidates=n_candidates, seed=seed)
        self.time_attr = time_attr
        self.min_points = min_points_in_model
        self.random_fraction = random_fraction
        # budget -> list of (flat_config, score); scores normalized to
        # higher-is-better.
        self._obs_by_budget: Dict[float, List[Tuple[Dict, float]]] = {}

    # -- model selection (the TPESearcher seam) --------------------------
    def _model_obs(self) -> Optional[List[Tuple[Dict, float]]]:
        """Observations at the largest budget with enough points."""
        for budget in sorted(self._obs_by_budget, reverse=True):
            obs = self._obs_by_budget[budget]
            if len(obs) >= max(self.min_points, 2):
                return obs
        return None

    def _model_split(self):
        obs = self._model_obs()
        if obs is None or self._rng.random() < self.random_fraction:
            return None
        ranked = sorted(obs, key=lambda ov: ov[1], reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    # -- observe ---------------------------------------------------------
    def _record(self, trial_id: str, result: Dict[str, Any]):
        flat = self._pending.get(trial_id)
        if flat is None or not result:
            return
        if self.metric is None or self.metric not in result:
            return
        budget = float(result.get(self.time_attr, 0) or 0)
        v = float(result[self.metric])
        score = -v if self.mode == "min" else v
        bucket = self._obs_by_budget.setdefault(budget, [])
        # One observation per (trial, budget): a trial re-reporting at the
        # same budget (e.g. unchanged time_attr) replaces its entry.
        for i, (o, _) in enumerate(bucket):
            if o is flat:
                bucket[i] = (flat, score)
                return
        bucket.append((flat, score))

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False):
        if not error and result:
            self._record(trial_id, result)
        self._pending.pop(trial_id, None)


class HyperBandForBOHB(HyperBandScheduler):
    """Banded HyperBand paired with ``BOHBSearcher``
    (``python/ray/tune/schedulers/hb_bohb.py`` role).

    The synchronous band machinery is inherited unchanged: rung cutoffs
    define the budgets at which trials report, and those intermediate
    reports reach the searcher through the runner's per-result hook — no
    scheduler-to-searcher coupling is needed here (the reference couples
    them only because HpBandSter owns both halves in-process).
    """
