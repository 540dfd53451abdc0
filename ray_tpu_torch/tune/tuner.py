"""``Tuner`` / ``tune.run`` driver APIs.

Parity with ``python/ray/tune/tuner.py`` and ``tune/tune.py``: expand the
param space into trials, drive them through the ``TrialRunner``, return a
``ResultGrid`` / ``ExperimentAnalysis``.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune.analysis import ExperimentAnalysis, ResultGrid
from ray_tpu_torch.tune.execution import TrialRunner
from ray_tpu_torch.tune.logger import (Callback, CSVLoggerCallback,
                                       JsonLoggerCallback)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trial import Trial


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: Optional[int] = None  # None = searcher's own budget, else 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[Any] = None
    search_alg: Optional[Searcher] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None


def run(trainable,
        config: Optional[Dict[str, Any]] = None,
        *,
        num_samples: Optional[int] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        stop: Optional[Any] = None,
        scheduler=None,
        search_alg: Optional[Searcher] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_concurrent_trials: Optional[int] = None,
        max_failures: int = 0,
        checkpoint_freq: int = 0,
        checkpoint_at_end: bool = False,
        callbacks: Optional[List[Callback]] = None,
        local_dir: Optional[str] = None,
        name: Optional[str] = None,
        time_budget_s: Optional[float] = None,
        verbose: int = 1,
        resume_from: Optional[str] = None,
        sync_config=None,
        seed: Optional[int] = None) -> ExperimentAnalysis:
    """Run an experiment (reference ``tune/tune.py:run``)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    name = name or f"{_trainable_name(trainable)}_{time.strftime('%Y%m%d_%H%M%S')}"
    searcher = None
    if resume_from:
        trials = TrialRunner.load_experiment_state(resume_from)
    elif search_alg is not None:
        # live searcher supplies configs during the run
        if hasattr(search_alg, "set_space") and (
                config or num_samples is not None):
            # an explicit run() config/num_samples overrides the
            # constructor-supplied space/budget; None leaves each in place
            search_alg.set_space(config or None, num_samples)
        trials = []
        searcher = search_alg
    else:
        gen = BasicVariantGenerator(config or {}, num_samples or 1, seed=seed)
        trials = []
        while True:
            cfg = gen.suggest(f"trial_{len(trials)}")
            if cfg is None:
                break
            trials.append(Trial(cfg, trial_id=f"trial_{len(trials)}"))
    callbacks = list(callbacks or [])
    if verbose:
        callbacks += [JsonLoggerCallback(), CSVLoggerCallback()]
    runner = TrialRunner(
        trainable, trials, scheduler=scheduler, stop=stop, metric=metric,
        mode=mode, max_concurrent_trials=max_concurrent_trials,
        max_failures=max_failures, checkpoint_freq=checkpoint_freq,
        checkpoint_at_end=checkpoint_at_end,
        resources_per_trial=resources_per_trial, callbacks=callbacks,
        local_dir=local_dir, experiment_name=name, searcher=searcher,
        time_budget_s=time_budget_s, sync_config=sync_config)
    finished = runner.run()
    return ExperimentAnalysis(finished, metric=metric, mode=mode)


def _trainable_name(trainable) -> str:
    return getattr(trainable, "__name__", "trainable")


class Tuner:
    """Reference ``tune/tuner.py:Tuner``."""

    def __init__(self, trainable, *, param_space: Optional[Dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_path: Optional[str] = None

    @classmethod
    def restore(cls, path: str, trainable) -> "Tuner":
        t = cls(trainable)
        t._restore_path = path
        return t

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        analysis = run(
            self._trainable,
            config=self.param_space,
            num_samples=tc.num_samples,
            metric=tc.metric,
            mode=tc.mode,
            scheduler=tc.scheduler,
            search_alg=tc.search_alg,
            max_concurrent_trials=tc.max_concurrent_trials,
            max_failures=self.run_config.failure_config.max_failures,
            checkpoint_freq=(
                self.run_config.checkpoint_config.checkpoint_frequency),
            local_dir=self.run_config.storage_path,
            name=self.run_config.name,
            time_budget_s=tc.time_budget_s,
            resume_from=self._restore_path,
            sync_config=getattr(self.run_config, "sync_config", None),
            seed=tc.seed,
        )
        return ResultGrid(analysis)
