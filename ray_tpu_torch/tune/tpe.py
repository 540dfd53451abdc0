"""Tree-structured Parzen Estimator searcher.

A native Bayesian searcher filling the role of the reference's external
adapters (``python/ray/tune/search/optuna/optuna_search.py``,
``hyperopt/hyperopt_search.py``) without their dependencies — the
algorithm itself (Bergstra et al. 2011, the sampler behind both Optuna's
``TPESampler`` and hyperopt's ``tpe.suggest``):

- The first ``n_initial_points`` suggestions are random (space-filling).
- After that, observations are split at the ``gamma`` quantile into good
  (l) and bad (g) sets; each dimension gets a 1-D Parzen (kernel-density)
  estimator per set. Candidates are drawn from l and the one maximizing
  the acquisition ratio ``l(x)/g(x)`` — monotone in expected improvement
  under the TPE factorization — is suggested.
- Dimensions are modeled independently (the classic TPE factorization).
  Numeric dims use truncated-Gaussian mixtures (in log space for ``log``
  domains); categoricals use smoothed category frequencies.

Grid axes (``tune.grid_search``) are treated as categorical dimensions so
any space accepted by ``BasicVariantGenerator`` works here too.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.sample import (Categorical, Domain, Float, Integer,
                                       Quantized, _is_grid)
from ray_tpu_torch.tune.search import Searcher, _set_path, _walk


class _NumericDim:
    """Parzen-estimator dimension over a bounded numeric domain."""

    def __init__(self, lower: float, upper: float, log: bool,
                 integer: bool, q: Optional[float] = None):
        self.log = log
        self.integer = integer
        self.q = q
        if log:
            self.lo, self.hi = math.log(lower), math.log(upper)
        else:
            self.lo, self.hi = float(lower), float(upper)

    # latent <-> native -------------------------------------------------
    def to_latent(self, x: Any) -> float:
        x = float(x)
        return math.log(x) if self.log else x

    def to_native(self, z: float) -> Any:
        z = min(max(z, self.lo), self.hi)
        x = math.exp(z) if self.log else z
        if self.q:
            x = round(x / self.q) * self.q
        if self.integer:
            x = int(round(x))
        return x

    def random(self, rng: random.Random) -> float:
        return rng.uniform(self.lo, self.hi)

    # Parzen machinery ---------------------------------------------------
    def _bandwidths(self, pts: List[float]) -> List[float]:
        """Per-point bandwidth: distance to the farther sorted neighbor
        (hyperopt's heuristic), clipped so no kernel collapses or covers
        the whole range."""
        rng_width = self.hi - self.lo or 1.0
        if len(pts) == 1:
            return [rng_width / 2.0]
        order = sorted(range(len(pts)), key=lambda i: pts[i])
        bows = [0.0] * len(pts)
        for rank, i in enumerate(order):
            left = pts[order[rank - 1]] if rank > 0 else None
            right = pts[order[rank + 1]] if rank + 1 < len(order) else None
            cands = [abs(pts[i] - n) for n in (left, right) if n is not None]
            bows[i] = max(cands) if cands else rng_width / 2.0
        lo_bw = rng_width / min(100.0, 10.0 * len(pts) + 1)
        return [min(max(b, lo_bw), rng_width) for b in bows]

    def _logpdf(self, z: float, pts: List[float], bws: List[float]) -> float:
        """Mixture of the observation kernels plus ONE uniform-prior
        component (hyperopt's adaptive-Parzen construction) — the prior
        keeps densities positive everywhere and stops the estimator from
        collapsing when all observations coincide."""
        width = self.hi - self.lo or 1.0
        acc = 1.0 / width  # prior component
        for mu, bw in zip(pts, bws):
            t = (z - mu) / bw
            acc += math.exp(-0.5 * t * t) / (bw * math.sqrt(2 * math.pi))
        return math.log(acc / (len(pts) + 1))

    def propose(self, good: List[Any], bad: List[Any], n_candidates: int,
                rng: random.Random) -> Any:
        gpts = [self.to_latent(x) for x in good]
        bpts = [self.to_latent(x) for x in bad]
        gbw = self._bandwidths(gpts)
        bbw = self._bandwidths(bpts)
        best_z, best_score = None, -math.inf
        for _ in range(n_candidates):
            # draw from l including its prior component, so exploration
            # never dies even when the good set has collapsed to a point
            i = rng.randrange(len(gpts) + 1)
            if i < len(gpts):
                z = min(max(rng.gauss(gpts[i], gbw[i]), self.lo), self.hi)
            else:
                z = self.random(rng)
            score = (self._logpdf(z, gpts, gbw) -
                     self._logpdf(z, bpts, bbw))
            if score > best_score:
                best_z, best_score = z, score
        return self.to_native(best_z if best_z is not None
                              else self.random(rng))


class _CategoricalDim:
    """Smoothed-frequency dimension over a fixed category list."""

    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def _weights(self, observed: List[Any]) -> List[float]:
        counts = [1.0] * len(self.categories)  # +1 smoothing prior
        for x in observed:
            try:
                counts[self.categories.index(x)] += 1.0
            except ValueError:
                pass
        total = sum(counts)
        return [c / total for c in counts]

    def propose(self, good: List[Any], bad: List[Any], n_candidates: int,
                rng: random.Random) -> Any:
        wl = self._weights(good)
        wg = self._weights(bad)
        best_i = max(range(len(self.categories)),
                     key=lambda i: math.log(wl[i]) - math.log(wg[i]) +
                     1e-9 * rng.random())
        # sample from l but bias toward the best ratio: draw a few from l,
        # keep the max-ratio draw
        draws = rng.choices(range(len(self.categories)), weights=wl,
                            k=max(1, n_candidates // 4))
        draws.append(best_i)
        pick = max(draws, key=lambda i: math.log(wl[i]) - math.log(wg[i]))
        return self.categories[pick]


class TPESearcher(Searcher):
    """Bayesian search via Tree-structured Parzen Estimators.

    Drop-in ``Searcher``: pass as ``search_alg=`` to ``tune.run`` /
    ``Tuner`` with a space of ``tune.uniform/loguniform/randint/choice/
    grid_search`` values.
    """

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 num_samples: int = 32,
                 n_initial_points: int = 10, gamma: float = 0.15,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._rng = random.Random(seed)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._budget = num_samples
        self._suggested = 0
        self._dims: List[Tuple[Tuple, Any]] = []       # (path, dim model)
        self._passthrough: List[Tuple[Tuple, Any]] = []  # (path, const/fn)
        self._obs: List[Tuple[Dict[Tuple, Any], float]] = []
        self._pending: Dict[str, Dict[Tuple, Any]] = {}
        if space:
            self._compile(space)

    # -- space ----------------------------------------------------------
    def set_space(self, space: Optional[Dict[str, Any]],
                  num_samples: Optional[int] = None):
        """None leaves the corresponding constructor value in place."""
        if num_samples is not None:
            self._budget = num_samples
        if space:
            self._compile(space)

    def _compile(self, space: Dict[str, Any]):
        self._dims, self._passthrough = [], []
        for path, v in _walk(space):
            if _is_grid(v):
                self._dims.append((path, _CategoricalDim(v["grid_search"])))
            elif isinstance(v, Quantized):
                inner = v.inner
                # Integer domains are upper-EXCLUSIVE (randint semantics);
                # model the inclusive range [lower, upper-1] so TPE never
                # suggests a value random search could not produce
                upper = (inner.upper - 1 if isinstance(inner, Integer)
                         else inner.upper)
                self._dims.append((path, _NumericDim(
                    inner.lower, upper, getattr(inner, "log", False),
                    isinstance(inner, Integer), q=v.q)))
            elif isinstance(v, Float):
                self._dims.append((path, _NumericDim(
                    v.lower, v.upper, v.log, integer=False)))
            elif isinstance(v, Integer):
                self._dims.append((path, _NumericDim(
                    v.lower, v.upper - 1, v.log, integer=True)))
            elif isinstance(v, Categorical):
                self._dims.append((path, _CategoricalDim(v.categories)))
            else:
                # unbounded/opaque domains (Normal, Function, ...) are
                # sampled but not modeled; constants pass straight through
                self._passthrough.append((path, v))

    # -- suggest --------------------------------------------------------
    def _model_split(self):
        """(good, bad) observation lists to fit the proposal on, or None
        to sample randomly. The overridable seam for multi-fidelity
        variants (BOHB picks its budget bucket here)."""
        if len(self._obs) >= max(self.n_initial, 2):
            return self._split()
        return None

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self._budget:
            return None
        self._suggested += 1
        flat: Dict[Tuple, Any] = {}
        split = self._model_split()
        model_ready = split is not None
        good_obs, bad_obs = split if model_ready else ([], [])
        for path, dim in self._dims:
            if model_ready:
                good = [o[path] for o, _ in good_obs if path in o]
                bad = [o[path] for o, _ in bad_obs if path in o]
                flat[path] = dim.propose(good, bad, self.n_candidates,
                                         self._rng)
            elif isinstance(dim, _NumericDim):
                flat[path] = dim.to_native(dim.random(self._rng))
            else:
                flat[path] = self._rng.choice(dim.categories)
        cfg: Dict[str, Any] = {}
        for path, val in flat.items():
            _set_path(cfg, path, val)
        for path, v in self._passthrough:
            _set_path(cfg, path,
                      v.sample(self._rng) if isinstance(v, Domain) else v)
        self._pending[trial_id] = flat
        return cfg

    def _split(self):
        """Split observations at the gamma quantile (higher = better
        internally; mode is normalized in on_trial_complete)."""
        ranked = sorted(self._obs, key=lambda ov: ov[1], reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    # -- observe --------------------------------------------------------
    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False):
        flat = self._pending.pop(trial_id, None)
        if flat is None or error or not result:
            return
        metric = self.metric
        if metric is None or metric not in result:
            return
        v = float(result[metric])
        self._obs.append((flat, -v if self.mode == "min" else v))
