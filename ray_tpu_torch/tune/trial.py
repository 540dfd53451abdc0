"""Trial state (reference ``python/ray/tune/experiment/trial.py``)."""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, config: Dict[str, Any], trial_id: Optional[str] = None,
                 experiment_tag: str = ""):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.config = config
        self.experiment_tag = experiment_tag
        self.status = PENDING
        self.results: List[Dict[str, Any]] = []
        self.last_result: Dict[str, Any] = {}
        self.checkpoint: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.num_failures = 0
        self.start_time: Optional[float] = None
        self.logdir: Optional[str] = None
        # runner-internal
        self._actor = None
        self._future = None

    def metric_history(self, metric: str) -> List[float]:
        return [r[metric] for r in self.results if metric in r]

    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"

    def summary(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "status": self.status,
            "config": _plain(self.config),
            "last_result": _plain(self.last_result),
            "error": self.error,
            "num_failures": self.num_failures,
        }


def _plain(v: Any):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return repr(v)
