"""Trial execution: actor-per-trial event loop.

Parity with ``python/ray/tune/execution/trial_runner.py`` (``TrialRunner.step``
:234,853) and ``ray_trial_executor.py``: each trial runs as a ``ray_tpu_torch``
actor; the driver loop starts pending trials up to the resource-derived
concurrency cap, waits on in-flight ``train()`` futures, routes results
through the scheduler (CONTINUE/PAUSE/STOP), checkpoints trials, restarts
failed trials from their last checkpoint up to ``max_failures``, and
persists experiment state for resume (``trial_runner.py:671,1240``).
"""

from __future__ import annotations
import logging

import json
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import CONTINUE, PAUSE, STOP, FIFOScheduler
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.trial import (ERROR, PAUSED, PENDING, RUNNING,
                                      TERMINATED, Trial)

logger = logging.getLogger("ray_tpu")


@ray_tpu_torch.remote
class _TrainableActor:
    """Hosts one Trainable instance (the executor's trial actor)."""

    def __init__(self, trainable_cls_bytes: bytes, config: Dict[str, Any],
                 logdir: str, trial_id: str):
        import cloudpickle
        cls = cloudpickle.loads(trainable_cls_bytes)
        self._t = cls(config, logdir)
        self._t._trial_id = trial_id

    def train(self) -> Dict[str, Any]:
        return self._t.train()

    def save(self) -> Dict[str, Any]:
        return self._t.save()

    def restore(self, payload: Dict[str, Any]):
        self._t.restore(payload)

    def reset(self, new_config: Dict[str, Any]) -> bool:
        return self._t.reset(new_config)

    def stop(self):
        self._t.stop()


def _as_trainable_cls(trainable) -> type:
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable):
        return wrap_function(trainable)
    raise TypeError(f"not a trainable: {trainable!r}")


class TrialRunner:
    def __init__(self, trainable, trials: List[Trial],
                 scheduler=None,
                 stop: Optional[Any] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 max_concurrent_trials: Optional[int] = None,
                 max_failures: int = 0,
                 checkpoint_freq: int = 0,
                 checkpoint_at_end: bool = False,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 callbacks: Optional[List[Any]] = None,
                 local_dir: Optional[str] = None,
                 experiment_name: str = "experiment",
                 searcher=None,
                 time_budget_s: Optional[float] = None,
                 sync_config=None):
        import cloudpickle
        self._trainable_cls = _as_trainable_cls(trainable)
        self._trainable_bytes = cloudpickle.dumps(self._trainable_cls)
        self.trials = list(trials)
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(metric, mode)
        # schedulers that act on non-reporting trials (PBT exploit,
        # HyperBand band cuts) reach the executor through this backref
        self.scheduler._runner = self
        self.searcher = searcher
        # fill in only what each searcher was not configured with — a
        # searcher built with mode="min" must not be flipped by run()'s
        # "max" default. Walk wrapper chains (ConcurrencyLimiter/Repeater)
        # so the inner searcher actually doing the learning is reached.
        s = self.searcher
        while s is not None:
            if s.metric is None:
                s.metric = metric
            if s.mode is None:
                s.mode = mode
            s = getattr(s, "searcher", None)
        self._stop = stop
        self.metric, self.mode = metric, mode
        self.max_failures = max_failures
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_at_end = checkpoint_at_end
        self.resources_per_trial = resources_per_trial or {"cpu": 1}
        self.callbacks = callbacks or []
        self.time_budget_s = time_budget_s
        self._start_time: Optional[float] = None
        self.local_dir = local_dir or os.path.expanduser(
            "~/ray_tpu_results")
        self.experiment_dir = os.path.join(self.local_dir, experiment_name)
        os.makedirs(self.experiment_dir, exist_ok=True)
        if max_concurrent_trials:
            self._max_concurrent = max_concurrent_trials
        else:
            self._max_concurrent = self._derive_concurrency()
        from ray_tpu_torch.tune.syncer import _SyncerState
        self._syncer = _SyncerState(sync_config, self.experiment_dir,
                                    experiment_name)
        # Trial checkpoints live in one shared content-addressed store;
        # Trial.checkpoint holds a tiny picklable CheckpointRef, so
        # experiment state files and PBT exploits move manifest pointers,
        # not payload copies. Dedup makes PBT clone-heavy saves ~free.
        from ray_tpu_torch.checkpoint import CheckpointEngine
        self._ckpt_engine = CheckpointEngine(
            os.path.join(self.experiment_dir, "checkpoint_store"))
        self._ckpt_seq = 0
        for t in self.trials:
            self.scheduler.on_trial_add(t)

    def _save_trial_checkpoint(self, trial: Trial):
        """Snapshot a trial's state into the shared engine store; returns a
        CheckpointRef pinned to the committed manifest. Synchronous: a ref
        must never circulate (PBT exploit, state files) before its commit."""
        payload = ray_tpu_torch.get(trial._actor.save.remote())
        from ray_tpu_torch.checkpoint import CheckpointRef
        self._ckpt_seq += 1
        handle = self._ckpt_engine.save(
            payload, step=self._ckpt_seq,
            meta={"trial_id": trial.trial_id},
            save_key=f"{trial.trial_id}-{self._ckpt_seq:08d}")
        return CheckpointRef(self._ckpt_engine.root,
                             handle.result(timeout=self._budget_left()))

    def _budget_left(self) -> Optional[float]:
        """Remaining experiment time budget, with a one-minute grace floor:
        an in-flight checkpoint commit may finish past the budget (a ref
        must never circulate uncommitted) but not hang forever."""
        if self.time_budget_s is None or not self._start_time:
            return None
        return max(60.0,
                   self.time_budget_s - (time.time() - self._start_time))

    @staticmethod
    def _resolve_checkpoint(checkpoint):
        """A trial checkpoint is a CheckpointRef (engine manifest) or, for
        backward compatibility, a raw payload dict."""
        from ray_tpu_torch.checkpoint import CheckpointRef
        if isinstance(checkpoint, CheckpointRef):
            return checkpoint.load()
        return checkpoint

    def _derive_concurrency(self) -> int:
        try:
            avail = ray_tpu_torch.cluster_resources()
        except Exception as e:
            logger.debug("cluster_resources unavailable; defaulting: %s", e)
            return 4
        cpus = avail.get("CPU", 4)
        per = self.resources_per_trial.get(
            "cpu", self.resources_per_trial.get("CPU", 1)) or 1
        return max(1, int(cpus / per))

    # ------------------------------------------------------------------
    def _may_resume(self, trial: Trial) -> bool:
        # getattr: duck-typed user schedulers predating may_resume()
        fn = getattr(self.scheduler, "may_resume", None)
        return True if fn is None else fn(trial)

    def _trial_by_id(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def _start_trial(self, trial: Trial, restore: bool = True):
        trial.logdir = os.path.join(self.experiment_dir, trial.trial_id)
        os.makedirs(trial.logdir, exist_ok=True)
        cpu = self.resources_per_trial.get(
            "cpu", self.resources_per_trial.get("CPU", 1))
        # The JAX package maps "tpu" to num_tpus here; a trial's card is the
        # runtime's GPU grant (the node's first n cards).
        gpu = self.resources_per_trial.get(
            "gpu", self.resources_per_trial.get("GPU", 0))
        actor = _TrainableActor.options(
            num_cpus=cpu, num_gpus=gpu or None).remote(
                self._trainable_bytes, trial.config, trial.logdir,
                trial.trial_id)
        trial._actor = actor
        if restore and trial.checkpoint is not None:
            ray_tpu_torch.get(actor.restore.remote(
                self._resolve_checkpoint(trial.checkpoint)))
        trial.status = RUNNING
        if trial.start_time is None:
            trial.start_time = time.time()
        trial._future = actor.train.remote()
        for cb in self.callbacks:
            cb.on_trial_start(trial)

    def _stop_trial(self, trial: Trial, status: str = TERMINATED,
                    save: bool = False):
        if trial._actor is not None:
            try:
                if save:
                    trial.checkpoint = self._save_trial_checkpoint(trial)
                ray_tpu_torch.get(trial._actor.stop.remote())
            except Exception as e:
                logger.debug("trial save/stop failed: %s", e)
            try:
                ray_tpu_torch.kill(trial._actor)
            except Exception as e:
                logger.debug("trial actor kill failed: %s", e)
        trial._actor = None
        trial._future = None
        trial.status = status
        for cb in self.callbacks:
            cb.on_trial_complete(trial)

    def terminate_trial(self, trial: Trial):
        """Terminate a trial on a scheduler's behalf (e.g. a HyperBand band
        cut killing a PAUSED loser). Unlike a bare ``_stop_trial`` this
        also notifies the searcher, so ConcurrencyLimiter slots are freed
        and the model sees the loser's final score."""
        if trial.status == TERMINATED:
            return
        self._stop_trial(trial, status=TERMINATED)
        if self.searcher is not None:
            self.searcher.on_trial_complete(
                trial.trial_id, trial.last_result or None)

    def _exploit_trial(self, trial: Trial, donor: Trial,
                       new_config: Dict[str, Any]):
        """PBT exploit: replace trial's state with donor's checkpoint and a
        perturbed config (reference ``pbt.py _exploit``)."""
        if trial._actor is None:
            return
        reset_ok = False
        try:
            reset_ok = ray_tpu_torch.get(trial._actor.reset.remote(new_config))
        except Exception as e:
            logger.debug("trial reset failed; will restart: %s", e)
            reset_ok = False
        if not reset_ok:
            self._stop_trial(trial, status=PAUSED)
            trial.config = new_config
            trial.checkpoint = donor.checkpoint
            self._start_trial(trial, restore=True)
            return
        trial.config = new_config
        ray_tpu_torch.get(trial._actor.restore.remote(
            self._resolve_checkpoint(donor.checkpoint)))
        trial.checkpoint = donor.checkpoint
        trial._future = trial._actor.train.remote()

    def _should_stop_trial(self, trial: Trial, result: Dict[str, Any]) -> bool:
        if result.get("done"):
            return True
        s = self._stop
        if s is None:
            return False
        if callable(s):
            return bool(s(trial.trial_id, result))
        if isinstance(s, dict):
            for k, v in s.items():
                if k in result and result[k] >= v:
                    return True
        return False

    def _maybe_checkpoint(self, trial: Trial, result: Dict[str, Any]):
        it = result.get("training_iteration", 0)
        if self.checkpoint_freq and it % self.checkpoint_freq == 0:
            trial.checkpoint = self._save_trial_checkpoint(trial)

    # ------------------------------------------------------------------
    def run(self):
        self._start_time = time.time()
        while True:
            if self._over_budget():
                for t in self.trials:
                    if t.status == RUNNING:
                        self._stop_trial(t, save=self.checkpoint_at_end)
                break
            self._launch_pending()
            inflight = {t._future: t for t in self.trials
                        if t.status == RUNNING and t._future is not None}
            if not inflight:
                if any(t.status == PENDING or
                       (t.status == PAUSED and self._may_resume(t))
                       for t in self.trials):
                    continue
                held = [t for t in self.trials if t.status == PAUSED]
                if held:
                    # No runnable work and every paused trial is held by
                    # the scheduler: ask it to resolve the pending
                    # synchronization; if that frees nothing, the bracket
                    # is genuinely stuck — end the experiment rather than
                    # spin or violate the concurrency cap.
                    getattr(self.scheduler, "release_holds", lambda: None)()
                    if any(t.status == PAUSED and self._may_resume(t)
                           for t in self.trials):
                        continue
                    break
                break
            ready, _ = ray_tpu_torch.wait(list(inflight.keys()), num_returns=1,
                                    timeout=10.0)
            if not ready:
                continue
            trial = inflight[ready[0]]
            self._process_result(trial, ready[0])
            self._syncer.maybe_sync()
        self.save_experiment_state()
        self._ckpt_engine.close(timeout=5.0)
        self._syncer.maybe_sync(force=True)  # failure logged by the state
        return self.trials

    def _over_budget(self) -> bool:
        return (self.time_budget_s is not None and self._start_time and
                time.time() - self._start_time > self.time_budget_s)

    def _launch_pending(self):
        running = sum(1 for t in self.trials if t.status == RUNNING)
        for t in self.trials:
            if running >= self._max_concurrent:
                break
            if t.status == PENDING or (
                    t.status == PAUSED and self._may_resume(t)):
                self._start_trial(t)
                running += 1
        # pull more suggestions from a live searcher
        while (self.searcher is not None and
               running < self._max_concurrent):
            tid = f"trial_{len(self.trials)}"
            cfg = self.searcher.suggest(tid)
            if cfg is None:
                break
            t = Trial(cfg, trial_id=tid)
            self.trials.append(t)
            self.scheduler.on_trial_add(t)
            self._start_trial(t)
            running += 1

    def _process_result(self, trial: Trial, future):
        try:
            result = ray_tpu_torch.get(future)
        except Exception as e:  # trial actor failed
            trial.num_failures += 1
            trial.error = repr(e)
            self.scheduler.on_trial_error(trial)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, error=True)
            if trial.num_failures <= self.max_failures:
                # restart from last checkpoint (trial_runner.py:1240)
                # raylint: allow(collective-divergence) trial engine is driver-local (world_size=1): save() commits without a cross-rank barrier
                self._stop_trial(trial, status=PENDING)
            else:
                # raylint: allow(collective-divergence) trial engine is driver-local (world_size=1): save() commits without a cross-rank barrier
                self._stop_trial(trial, status=ERROR)
            return
        trial.results.append(result)
        trial.last_result = result
        for cb in self.callbacks:
            cb.on_trial_result(trial, result)
        if self.searcher is not None:
            self.searcher.on_trial_result(trial.trial_id, result)
        self._maybe_checkpoint(trial, result)
        decision = self.scheduler.on_trial_result(trial, result)
        if trial.status != RUNNING or trial._future is None:
            # scheduler (e.g. PBT exploit) already restarted the trial
            return
        if self._should_stop_trial(trial, result):
            decision = STOP
        if decision == STOP:
            if self.checkpoint_at_end:
                trial.checkpoint = self._save_trial_checkpoint(trial)
            self.scheduler.on_trial_complete(trial, result)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, result)
            self._stop_trial(trial, status=TERMINATED)
        elif decision == PAUSE:
            self._stop_trial(trial, status=PAUSED, save=True)
        else:
            trial._future = trial._actor.train.remote()

    # -- experiment persistence ----------------------------------------
    def save_experiment_state(self):
        state_path = os.path.join(self.experiment_dir, "experiment_state.json")
        ckpt_path = os.path.join(self.experiment_dir, "trial_checkpoints.pkl")
        with open(state_path, "w") as f:
            json.dump({"trials": [t.summary() for t in self.trials],
                       "timestamp": time.time()}, f, indent=2, default=repr)
        with open(ckpt_path, "wb") as f:
            pickle.dump({t.trial_id: t.checkpoint for t in self.trials}, f)

    @classmethod
    def load_experiment_state(cls, experiment_dir: str):
        with open(os.path.join(experiment_dir, "experiment_state.json")) as f:
            state = json.load(f)
        ckpts = {}
        p = os.path.join(experiment_dir, "trial_checkpoints.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                ckpts = pickle.load(f)
        trials = []
        for ts in state["trials"]:
            t = Trial(ts["config"], trial_id=ts["trial_id"])
            t.status = (TERMINATED if ts["status"] == TERMINATED
                        else PENDING)
            t.last_result = ts.get("last_result") or {}
            if t.last_result:
                t.results = [t.last_result]
            t.checkpoint = ckpts.get(t.trial_id)
            trials.append(t)
        return trials
