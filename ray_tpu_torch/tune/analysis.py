"""Experiment analysis / result grid.

Parity with ``python/ray/tune/analysis/experiment_analysis.py`` and the
``ResultGrid`` returned by ``Tuner.fit`` (``tune/result_grid.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.trial import ERROR, TERMINATED, Trial


class ExperimentAnalysis:
    def __init__(self, trials: List[Trial], metric: Optional[str] = None,
                 mode: str = "max"):
        self.trials = trials
        self.default_metric = metric
        self.default_mode = mode

    def get_best_trial(self, metric: Optional[str] = None,
                       mode: Optional[str] = None,
                       scope: str = "last") -> Optional[Trial]:
        metric = metric or self.default_metric
        mode = mode or self.default_mode
        sign = 1 if mode == "max" else -1

        def score(t: Trial) -> float:
            vals = t.metric_history(metric)
            if not vals:
                return float("-inf")
            if scope == "last":
                return sign * vals[-1]
            if scope == "avg":
                return sign * sum(vals) / len(vals)
            return sign * max(sign * v for v in vals)  # "all": best ever

        candidates = [t for t in self.trials if t.metric_history(metric or "")]
        if not candidates:
            return None
        return max(candidates, key=score)

    def get_best_config(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Optional[Dict]:
        t = self.get_best_trial(metric, mode)
        return t.config if t else None

    def get_best_checkpoint(self, metric: Optional[str] = None,
                            mode: Optional[str] = None):
        t = self.get_best_trial(metric, mode)
        return t.checkpoint if t else None

    @property
    def best_trial(self) -> Optional[Trial]:
        return self.get_best_trial()

    @property
    def best_config(self) -> Optional[Dict]:
        return self.get_best_config()

    @property
    def best_result(self) -> Optional[Dict]:
        t = self.get_best_trial()
        return t.last_result if t else None

    def dataframe(self):
        import pandas as pd
        rows = []
        for t in self.trials:
            row = dict(t.last_result)
            row["trial_id"] = t.trial_id
            row["status"] = t.status
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)

    @property
    def results(self) -> Dict[str, Dict]:
        return {t.trial_id: t.last_result for t in self.trials}


class ResultGrid:
    """Tuner.fit() return value (reference ``tune/result_grid.py``)."""

    def __init__(self, analysis: ExperimentAnalysis):
        self._analysis = analysis

    def __len__(self):
        return len(self._analysis.trials)

    def __getitem__(self, i: int):
        t = self._analysis.trials[i]
        from ray_tpu_torch.air.config import Result
        return Result(metrics=t.last_result, checkpoint=t.checkpoint,
                      error=t.error, metrics_history=t.results)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None):
        t = self._analysis.get_best_trial(metric, mode)
        if t is None:
            return None
        from ray_tpu_torch.air.config import Result
        return Result(metrics=t.last_result, checkpoint=t.checkpoint,
                      error=t.error, metrics_history=t.results)

    def get_dataframe(self):
        return self._analysis.dataframe()

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._analysis.trials if t.status == ERROR]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._analysis.trials
                   if t.status == TERMINATED)
