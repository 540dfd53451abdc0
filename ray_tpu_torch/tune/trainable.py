"""Trainable APIs: class-based and function-based.

Parity with ``python/ray/tune/trainable/trainable.py`` (class API:
``setup``/``step``/``save_checkpoint``/``load_checkpoint``) and
``function_trainable.py`` (function API with a reporter thread pumping
``session.report`` results to the driver one ``train()`` call at a time).
"""

from __future__ import annotations
import logging

import os
import queue
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.tune import session as tune_session

logger = logging.getLogger("ray_tpu")

RESULT_DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Class API. Subclass and override ``setup/step/save_checkpoint/
    load_checkpoint`` (reference ``trainable.py``)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 logdir: Optional[str] = None):
        self.config = config or {}
        self._logdir = logdir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_results",
            f"trainable_{uuid.uuid4().hex[:8]}")
        os.makedirs(self._logdir, exist_ok=True)
        self._iteration = 0
        self._time_total = 0.0
        self.setup(self.config)

    # -- overridable ------------------------------------------------------
    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Any:
        """Return a dict (or write files under checkpoint_dir and return it)."""
        return {}

    def load_checkpoint(self, checkpoint: Any):
        pass

    def cleanup(self):
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable supports in-place config reset
        (used by PBT to avoid actor teardown)."""
        return False

    # -- driver-facing ----------------------------------------------------
    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def logdir(self) -> str:
        return self._logdir

    def train(self) -> Dict[str, Any]:
        start = time.time()
        result = self.step() or {}
        self._iteration += 1
        self._time_total += time.time() - start
        result.setdefault(RESULT_DONE, False)
        result[TRAINING_ITERATION] = self._iteration
        result["time_total_s"] = self._time_total
        result["time_this_iter_s"] = time.time() - start
        result["timestamp"] = time.time()
        return result

    def save(self) -> Dict[str, Any]:
        ckpt_dir = os.path.join(self._logdir,
                                f"checkpoint_{self._iteration:06d}")
        os.makedirs(ckpt_dir, exist_ok=True)
        data = self.save_checkpoint(ckpt_dir)
        return {"data": data, "iteration": self._iteration, "dir": ckpt_dir}

    def restore(self, payload: Dict[str, Any]):
        self._iteration = payload.get("iteration", 0)
        self.load_checkpoint(payload.get("data"))

    def stop(self):
        self.cleanup()

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
            self._iteration = 0
            self._time_total = 0.0
        return ok


class FunctionTrainable(Trainable):
    """Wraps ``fn(config)`` in a background thread; each ``train()`` call
    returns the next ``tune.report`` result (reference
    ``function_trainable.py``: reporter thread + result queue)."""

    _fn: Callable = None  # set by wrap_function subclass

    def setup(self, config: Dict[str, Any]):
        self._results: "queue.Queue" = queue.Queue()  # raylint: allow(data-race) assigned in setup() before the runner thread starts; queue.Queue is internally synchronized
        self._continue: "queue.Queue" = queue.Queue()
        self._finished = False
        self._last_metrics: Dict[str, Any] = {}
        self._last_checkpoint: Optional[Dict[str, Any]] = None
        self._restore_checkpoint: Optional[Dict[str, Any]] = None
        self._thread: Optional[threading.Thread] = None

    def _runner(self):
        tune_session._init_session(self)
        try:
            self._fn(self.config)
        except BaseException as e:  # noqa: BLE001 - propagated to driver
            self._results.put(e)  # raylint: allow(data-race) queue.Queue is internally synchronized
        finally:
            tune_session._shutdown_session()
            self._results.put(None)  # raylint: allow(data-race) queue.Queue is internally synchronized (sentinel: function returned)

    def _report(self, metrics: Dict[str, Any],
                checkpoint: Optional[Dict[str, Any]] = None):
        if checkpoint is not None:
            self._last_checkpoint = {"data": checkpoint,
                                     "iteration": self._iteration + 1}
        self._results.put(dict(metrics))  # raylint: allow(data-race) queue.Queue is internally synchronized
        self._continue.get()  # block until driver consumed (backpressure)

    def _get_checkpoint(self) -> Optional[Dict[str, Any]]:
        if self._restore_checkpoint is not None:
            return self._restore_checkpoint.get("data")
        return None

    def step(self) -> Dict[str, Any]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._runner, daemon=True)
            self._thread.start()
        item = self._results.get()
        if isinstance(item, BaseException):
            self._finished = True
            self._results.get()  # drain the completion sentinel
            raise item
        if item is None:
            self._finished = True
            # final result: the last reported metrics, marked done
            # (reference function_trainable.py final-result semantics)
            final = dict(self._last_metrics)
            final[RESULT_DONE] = True
            return final
        self._last_metrics = dict(item)
        self._continue.put(True)
        item.setdefault(RESULT_DONE, False)
        return item

    def save_checkpoint(self, checkpoint_dir: str):
        return (self._last_checkpoint or {}).get("data")

    def load_checkpoint(self, checkpoint: Any):
        self._restore_checkpoint = {"data": checkpoint}

    def cleanup(self):
        if self._thread is not None and self._thread.is_alive():
            # let the fn thread run to completion on next report
            try:
                self._continue.put_nowait(True)
            except Exception as e:
                logger.debug("continue signal failed: %s", e)


def wrap_function(fn: Callable) -> type:
    """Create a FunctionTrainable subclass bound to ``fn``."""
    return type(f"func_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})
