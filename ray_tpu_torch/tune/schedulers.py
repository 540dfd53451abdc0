"""Trial schedulers: FIFO, ASHA/HyperBand, median stopping, PBT.

Parity with ``python/ray/tune/schedulers/``:
- ``FIFOScheduler`` (fifo.py)
- ``AsyncHyperBandScheduler`` / ASHA (async_hyperband.py) — rung-based early
  stopping with reduction factor and brackets.
- ``HyperBandScheduler`` (hyperband.py) — synchronous banded variant; here
  implemented on the same rung machinery with band-synchronised cutoffs.
- ``MedianStoppingRule`` (median_stopping_rule.py)
- ``PopulationBasedTraining`` (pbt.py) — exploit (clone top performer's
  checkpoint) + explore (perturb hyperparams) at a fixed interval.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.sample import Domain
from ray_tpu_torch.tune.trial import Trial

CONTINUE = "CONTINUE"
PAUSE = "PAUSE"
STOP = "STOP"


class TrialScheduler:
    """``mode=None`` means "not configured": ``set_search_properties``
    fills it from ``run()``'s mode. A constructor-supplied ``mode='min'``
    must survive run()'s 'max' default (scores are negated for min)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        # set by the TrialRunner so schedulers that act on trials other
        # than the one currently reporting (PBT exploit, HyperBand band
        # cuts) can reach the executor
        self._runner = None

    def set_search_properties(self, metric: Optional[str], mode: Optional[str]):
        if self.metric is None:
            self.metric = metric
        if self.mode is None and mode:
            self.mode = mode

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        if self.metric is None or self.metric not in result:
            return None
        v = float(result[self.metric])
        return -v if self.mode == "min" else v

    def on_trial_add(self, trial: Trial):
        pass

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial, result: Dict[str, Any]):
        pass

    def on_trial_error(self, trial: Trial):
        pass

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        return None

    def may_resume(self, trial: Trial) -> bool:
        """Whether a PAUSED trial is eligible to restart now. Synchronous
        schedulers return False while the trial awaits a band cut."""
        return True

    def release_holds(self):
        """Called by the runner when no trial is runnable and every paused
        trial is held: resolve whatever synchronization is pending so the
        experiment can make progress."""
        pass


class FIFOScheduler(TrialScheduler):
    pass


class _Rung:
    def __init__(self, milestone: float):
        self.milestone = milestone
        self.scores: List[float] = []

    def cutoff(self, rf: float) -> Optional[float]:
        if not self.scores:
            return None
        s = sorted(self.scores)
        # top 1/rf survive: cutoff at the (1 - 1/rf) quantile
        k = int(len(s) * (1 - 1.0 / rf))
        k = min(max(k, 0), len(s) - 1)
        return s[k]


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference ``async_hyperband.py``): per-bracket rungs at
    ``grace_period * rf^k``; a trial reaching a rung is stopped if its score
    is below the rung's top-1/rf cutoff."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 max_t: float = 100, grace_period: float = 1,
                 reduction_factor: float = 4, brackets: int = 1):
        super().__init__(metric, mode, time_attr)
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self._brackets: List[List[_Rung]] = []
        for b in range(brackets):
            rungs = []
            t = grace_period * (reduction_factor ** b)
            while t < max_t:
                rungs.append(_Rung(t))
                t *= reduction_factor
            self._brackets.append(rungs)
        self._bracket_of: Dict[str, int] = {}
        self._next_bracket = 0

    def on_trial_add(self, trial: Trial):
        self._bracket_of[trial.trial_id] = (
            self._next_bracket % len(self._brackets))
        self._next_bracket += 1

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        t = result.get(self.time_attr)
        if score is None or t is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        rungs = self._brackets[self._bracket_of.get(trial.trial_id, 0)]
        action = CONTINUE
        for rung in rungs:
            if t >= rung.milestone and trial.trial_id not in getattr(
                    rung, "_seen", set()):
                seen = getattr(rung, "_seen", None)
                if seen is None:
                    rung._seen = set()
                rung._seen.add(trial.trial_id)
                cutoff = rung.cutoff(self.rf)
                rung.scores.append(score)
                if cutoff is not None and score < cutoff:
                    action = STOP
        return action


class _SyncBracket:
    """One successive-halving bracket of a HyperBand band.

    Starts ``n0`` trials at milestone ``r0``; every time all live trials
    have reported at the current milestone, keeps the top ``1/eta`` and
    multiplies the milestone by ``eta`` until it reaches ``max_t``.
    """

    def __init__(self, s: int, n0: int, r0: float, eta: float, max_t: float):
        self.s = s
        self.n0 = n0
        self.eta = eta
        self.max_t = max_t
        self.milestone = float(r0)
        self.members: List[str] = []     # all trial ids ever admitted
        self.live: set = set()           # not yet stopped/errored
        self.reported: Dict[str, float] = {}  # scores at current milestone

    def full(self) -> bool:
        return len(self.members) >= self.n0

    def add(self, trial_id: str):
        self.members.append(trial_id)
        self.live.add(trial_id)

    def cut_ready(self) -> bool:
        # A cut needs the bracket FULL as well as fully reported: trials
        # can be admitted lazily (searcher-driven), and halving over a
        # partially admitted bracket would break the exact-halving
        # contract. If admission stops early (searcher exhausted), the
        # runner's release_holds() fail-safe resolves the held trials.
        return (self.full() and bool(self.live)
                and set(self.reported) >= self.live)

    def perform_cut(self):
        """Returns (survivors, losers) and advances the milestone."""
        ranked = sorted(self.reported.items(), key=lambda kv: kv[1],
                        reverse=True)
        keep = max(1, int(math.ceil(len(ranked) / self.eta)))
        survivors = [tid for tid, _ in ranked[:keep]]
        losers = [tid for tid, _ in ranked[keep:]]
        for tid in losers:
            self.live.discard(tid)
        self.reported.clear()
        self.milestone = min(self.milestone * self.eta, self.max_t)
        return survivors, losers


class HyperBandScheduler(TrialScheduler):
    """Synchronized HyperBand (reference ``tune/schedulers/hyperband.py``).

    Bands of ``s_max+1`` brackets; bracket ``s`` admits
    ``ceil((s_max+1)/(s+1) * eta^s)`` trials starting at ``max_t / eta^s``
    iterations. Within a bracket, trials PAUSE at each milestone; when the
    last live trial reports, the bottom ``1 - 1/eta`` are terminated and
    the survivors resume toward the next milestone (successive halving).
    Unlike ASHA, cuts wait for every live trial — the original algorithm,
    which some workloads prefer for its exact halving guarantees.
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration", max_t: float = 81,
                 reduction_factor: float = 3, stop_last_trials: bool = True):
        super().__init__(metric, mode, time_attr)
        self.max_t = max_t
        self.eta = reduction_factor
        self.stop_last_trials = stop_last_trials
        self._s_max_1 = int(round(
            math.log(max_t) / math.log(reduction_factor))) + 1
        self._bands: List[List[_SyncBracket]] = []
        self._bracket_of: Dict[str, _SyncBracket] = {}
        self._held: set = set()   # paused, awaiting a band cut

    def _n0(self, s: int) -> int:
        return int(math.ceil(self._s_max_1 / (s + 1) * self.eta ** s))

    def _r0(self, s: int) -> float:
        return max(1.0, self.max_t * self.eta ** (-s))

    def _open_bracket(self) -> _SyncBracket:
        if self._bands:
            band = self._bands[-1]
            if not band[-1].full():
                return band[-1]
            if len(band) < self._s_max_1:
                s = band[-1].s - 1
                b = _SyncBracket(s, self._n0(s), self._r0(s), self.eta,
                                 self.max_t)
                band.append(b)
                return b
        # new band, starting from the most-aggressive bracket
        s = self._s_max_1 - 1
        b = _SyncBracket(s, self._n0(s), self._r0(s), self.eta, self.max_t)
        self._bands.append([b])
        return b

    def on_trial_add(self, trial: Trial):
        bracket = self._open_bracket()
        bracket.add(trial.trial_id)
        self._bracket_of[trial.trial_id] = bracket

    def may_resume(self, trial: Trial) -> bool:
        return trial.trial_id not in self._held

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        t = result.get(self.time_attr)
        bracket = self._bracket_of.get(trial.trial_id)
        if score is None or t is None or bracket is None:
            return CONTINUE
        if t >= self.max_t:
            bracket.live.discard(trial.trial_id)
            bracket.reported.pop(trial.trial_id, None)
            self._maybe_cut(bracket, exclude=trial.trial_id)
            return STOP if self.stop_last_trials else CONTINUE
        if t < bracket.milestone:
            return CONTINUE
        bracket.reported[trial.trial_id] = score
        if bracket.cut_ready():
            survivors, losers = bracket.perform_cut()
            self._apply_cut(survivors, losers, reporting=trial.trial_id)
            return STOP if trial.trial_id in losers else PAUSE
        self._held.add(trial.trial_id)
        return PAUSE

    def _apply_cut(self, survivors: List[str], losers: List[str],
                   reporting: Optional[str] = None):
        for tid in survivors:
            self._held.discard(tid)
        for tid in losers:
            self._held.discard(tid)
            if tid == reporting:
                continue  # runner stops it via the returned STOP
            if self._runner is not None:
                paused = self._runner._trial_by_id(tid)
                if paused is not None:
                    self._runner.terminate_trial(paused)

    def _drop(self, trial: Trial):
        bracket = self._bracket_of.get(trial.trial_id)
        if bracket is None:
            return
        bracket.live.discard(trial.trial_id)
        bracket.reported.pop(trial.trial_id, None)
        self._held.discard(trial.trial_id)
        self._maybe_cut(bracket, exclude=trial.trial_id)

    def _maybe_cut(self, bracket: _SyncBracket, exclude: Optional[str] = None):
        """A departure can leave the bracket cut-ready; fire the cut so the
        remaining paused trials are not held forever."""
        if bracket.cut_ready():
            survivors, losers = bracket.perform_cut()
            self._apply_cut(survivors, losers, reporting=exclude)

    def release_holds(self):
        """Force a cut from whatever has reported so far (invariant says
        cut_ready fires when the last live trial reports, so reaching this
        means some trial departed without bookkeeping — fail safe)."""
        for band in self._bands:
            for bracket in band:
                if bracket.reported:
                    survivors, losers = bracket.perform_cut()
                    self._apply_cut(survivors, losers)

    def on_trial_complete(self, trial: Trial, result: Dict[str, Any]):
        self._drop(trial)

    def on_trial_error(self, trial: Trial):
        self._drop(trial)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score so far is below the median of the
    running averages of other trials at the same time step
    (reference ``median_stopping_rule.py``)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 grace_period: float = 1, min_samples_required: int = 3):
        super().__init__(metric, mode, time_attr)
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        t = result.get(self.time_attr, 0)
        if score is None:
            return CONTINUE
        self._avgs.setdefault(trial.trial_id, []).append(score)
        if t < self.grace_period:
            return CONTINUE
        others = [sum(v) / len(v) for k, v in self._avgs.items()
                  if k != trial.trial_id and v]
        if len(others) < self.min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        best = max(self._avgs[trial.trial_id])
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference ``pbt.py``): every ``perturbation_interval`` time
    units, a bottom-quantile trial clones the checkpoint + config of a
    top-quantile trial and perturbs hyperparameters in
    ``hyperparam_mutations``."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = "training_iteration",
                 perturbation_interval: float = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode, time_attr)
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._last_perturb: Dict[str, float] = {}
        self._latest_score: Dict[str, float] = {}
        self._rng = random.Random(seed)
        # set by the runner so exploit can clone checkpoints
        self._runner = None

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        t = result.get(self.time_attr, 0)
        if score is not None:
            self._latest_score[trial.trial_id] = score
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval or len(self._latest_score) < 2:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        ranked = sorted(self._latest_score.items(), key=lambda kv: kv[1])
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id in bottom and self._runner is not None:
            donor_id = self._rng.choice(top)
            if donor_id != trial.trial_id:
                self._exploit(trial, donor_id)
        return CONTINUE

    def _exploit(self, trial: Trial, donor_id: str):
        runner = self._runner
        donor = runner._trial_by_id(donor_id)
        if donor is None or donor.checkpoint is None:
            return
        new_config = dict(donor.config)
        for key, spec in self.mutations.items():
            new_config[key] = self._perturb(new_config.get(key), spec)
        runner._exploit_trial(trial, donor, new_config)

    def _perturb(self, current: Any, spec: Any) -> Any:
        resample = current is None or self._rng.random() < self.resample_prob
        if isinstance(spec, Domain):
            return spec.sample(self._rng)
        if isinstance(spec, list):
            if resample or current not in spec:
                return self._rng.choice(spec)
            i = spec.index(current)
            i += self._rng.choice([-1, 1])
            return spec[max(0, min(len(spec) - 1, i))]
        if callable(spec):
            return spec()
        if isinstance(current, (int, float)):
            factor = self._rng.choice([0.8, 1.2])
            v = current * factor
            return int(v) if isinstance(current, int) else v
        return current
