"""PB2: Population Based Bandits.

Parity with ``python/ray/tune/schedulers/pb2.py`` (+ ``pb2_utils.py``),
re-implemented on numpy instead of the reference's GPy dependency.

PB2 (Parker-Holder et al. 2020) keeps PBT's exploit step (bottom-quantile
trials clone a top performer's checkpoint) but replaces the random
perturbation of the explore step with a GP bandit: a Gaussian process is
fit on ``(time, hyperparameters) -> score improvement`` observations from
the whole population, and the next configuration is chosen by maximizing
the UCB acquisition over the bounded hyperparameter box. This gives
provable regret bounds where PBT's random explore can thrash.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.schedulers import PopulationBasedTraining
from ray_tpu_torch.tune.trial import Trial


class _TinyGP:
    """RBF-kernel GP regression, just enough for UCB over a box.

    The reference leans on GPy for the same few lines of algebra
    (``pb2_utils.py:normalize/optimize_acq``); zero-dependency here.
    """

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-3):
        self.ls = lengthscale
        self.noise = noise
        self._X: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._L: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray) -> bool:
        if len(X) < 2:
            return False
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        K = self._k(X, X) + self.noise * np.eye(len(X))
        try:
            self._L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return False
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn))
        self._X = X
        return True

    def predict(self, Xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xq, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return (mu * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


class PB2(PopulationBasedTraining):
    """Population Based Bandits scheduler.

    ``hyperparam_bounds``: dict of name -> ``[min, max]`` (continuous
    box, PB2's domain — categoricals stay with plain PBT). Exploit is
    inherited from PBT; explore fits the GP and picks the UCB argmax.
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: float = 5,
                 hyperparam_bounds: Optional[Dict[str, List[float]]] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 1.0,
                 n_candidates: int = 64,
                 max_history: int = 256,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds")
        super().__init__(metric, mode, time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={
                             k: list(v) for k, v in hyperparam_bounds.items()
                         },
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(v[0]), float(v[1]))
                       for k, v in hyperparam_bounds.items()}
        self._keys = sorted(self.bounds)
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self.max_history = max_history
        self._np_rng = np.random.default_rng(seed)
        # (t, config_vec) -> observed score improvement since the trial's
        # previous report: the GP's training data.
        self._data: List[Tuple[float, np.ndarray, float]] = []
        self._prev: Dict[str, Tuple[float, float]] = {}  # tid -> (t, score)
        self._t_max = 1.0

    # -- data collection -------------------------------------------------
    def _param_vec(self, config: Dict[str, Any]) -> np.ndarray:
        """Box-normalized hyperparameters only; the time feature is scaled
        AT FIT TIME from the stored raw t — normalizing it at append time
        with the then-current _t_max would leave every row on a different
        scale as training progresses."""
        vec = []
        for k in self._keys:
            lo, hi = self.bounds[k]
            x = float(config.get(k, lo))
            vec.append((x - lo) / ((hi - lo) or 1.0))
        return np.array(vec)

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        t = float(result.get(self.time_attr, 0) or 0)
        if score is not None:
            self._t_max = max(self._t_max, t)
            prev = self._prev.get(trial.trial_id)
            if prev is not None and t > prev[0]:
                gain = (score - prev[1]) / (t - prev[0])
                self._data.append(
                    (prev[0], self._param_vec(trial.config), gain))
                if len(self._data) > self.max_history:
                    self._data = self._data[-self.max_history:]
            self._prev[trial.trial_id] = (t, score)
        return super().on_trial_result(trial, result)

    # -- explore (replaces PBT's random perturb) -------------------------
    def _exploit(self, trial: Trial, donor_id: str):
        runner = self._runner
        donor = runner._trial_by_id(donor_id)
        if donor is None or donor.checkpoint is None:
            return
        new_config = dict(donor.config)
        new_config.update(self._select_config(donor.config))
        runner._exploit_trial(trial, donor, new_config)

    def _select_config(self, base: Dict[str, Any]) -> Dict[str, Any]:
        t_now = max(v[0] for v in self._prev.values()) if self._prev else 0.0
        X = y = None
        if self._data:
            tscale = self._t_max or 1.0
            X = np.array([[t / tscale, *v] for t, v, _ in self._data])
            y = np.array([g for _, _, g in self._data])
        gp = _TinyGP()
        # Candidate set: random box samples + jittered copies of the
        # donor's point (local exploration around a known-good config).
        n = self.n_candidates
        cand = self._np_rng.random((n, len(self._keys)))
        base_vec = self._param_vec(base)
        jitter = np.clip(
            base_vec + self._np_rng.normal(0, 0.1, (n // 4, len(self._keys))),
            0.0, 1.0)
        cand = np.vstack([cand, jitter])
        if X is not None and gp.fit(X, y):
            tq = np.full((len(cand), 1), t_now / (self._t_max or 1.0))
            mu, sigma = gp.predict(np.hstack([tq, cand]))
            best = cand[int(np.argmax(mu + self.kappa * sigma))]
        else:
            best = cand[self._np_rng.integers(len(cand))]
        out: Dict[str, Any] = {}
        for i, k in enumerate(self._keys):
            lo, hi = self.bounds[k]
            v = lo + float(best[i]) * (hi - lo)
            if isinstance(base.get(k), int):
                v = int(round(v))
            out[k] = v
        return out
