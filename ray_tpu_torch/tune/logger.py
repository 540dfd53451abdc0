"""Result loggers / callbacks.

Parity with ``python/ray/tune/logger/`` (CSV/JSON/TBX logger callbacks) and
the callback interface in ``tune/callback.py``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, Optional


class Callback:
    def on_trial_start(self, trial):
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial):
        pass


def _flat(d: Dict[str, Any], prefix="") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


class JsonLoggerCallback(Callback):
    """Writes result.json (one JSON line per result) per trial."""

    def on_trial_result(self, trial, result):
        if not trial.logdir:
            return
        with open(os.path.join(trial.logdir, "result.json"), "a") as f:
            f.write(json.dumps(result, default=repr) + "\n")


class CSVLoggerCallback(Callback):
    """Writes progress.csv per trial."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}

    def on_trial_result(self, trial, result):
        if not trial.logdir:
            return
        flat = _flat(result)
        if trial.trial_id not in self._writers:
            f = open(os.path.join(trial.logdir, "progress.csv"), "w",
                     newline="")
            w = csv.DictWriter(f, fieldnames=sorted(flat.keys()),
                               extrasaction="ignore")
            w.writeheader()
            self._files[trial.trial_id] = f
            self._writers[trial.trial_id] = w
        self._writers[trial.trial_id].writerow(
            {k: flat.get(k) for k in self._writers[trial.trial_id].fieldnames})
        self._files[trial.trial_id].flush()

    def on_trial_complete(self, trial):
        f = self._files.pop(trial.trial_id, None)
        self._writers.pop(trial.trial_id, None)
        if f:
            f.close()


class TBXLoggerCallback(Callback):
    """TensorBoard via tensorboardX (reference ``tune/logger/tensorboardx.py``)."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}

    def on_trial_result(self, trial, result):
        if not trial.logdir:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        if trial.trial_id not in self._writers:
            self._writers[trial.trial_id] = SummaryWriter(trial.logdir)
        w = self._writers[trial.trial_id]
        step = result.get("training_iteration", 0)
        for k, v in _flat(result).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                w.add_scalar(k, v, step)

    def on_trial_complete(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w:
            w.close()
