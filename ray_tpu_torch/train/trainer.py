"""TorchTrainer — the DataParallelTrainer equivalent.

Port of ``ray_tpu/train/trainer.py``'s ``JaxTrainer`` (parity with
``python/ray/train/data_parallel_trainer.py:50`` + ``base_trainer.py:327``):
``fit()`` spins up a worker group in a placement group, runs
``train_loop_per_worker`` on every worker, streams ``session.report``
rounds, and on worker failure restarts the group from the latest
checkpoint — the last committed engine manifest when ``storage_path`` is
set — up to ``FailureConfig.max_failures`` (``backend_executor.py:461-531``).
Inside the loop the user gets a mesh (``session.get_mesh``, see
``backend_executor``) and a collective group, ``nccl`` by default. Workers
in daemon processes (``init(address=)``) join the tensor plane with it: on
NCCL where the daemon owns a card, on gloo in a CPU daemon, as the JAX
package's ``xla`` backend runs on CPU daemons. ``datasets=`` splits each
``ray_tpu_torch.data`` Dataset over the workers (``streaming_split(n,
equal=True)``); a worker reads its shard through
``session.get_dataset_shard``.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.backoff import BackoffPolicy
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (FailureConfig, Result, RunConfig,
                                ScalingConfig)
from ray_tpu_torch.observability import goodput
from ray_tpu_torch.train.backend_executor import BackendExecutor

logger = logging.getLogger("ray_tpu")


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable[[Dict[str, Any]], None],
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 collective_backend: Optional[str] = "nccl",
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 results_timeout_s: Optional[float] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self._train_loop = train_loop_per_worker
        self._config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._collective_backend = collective_backend
        self._resume_from = resume_from_checkpoint
        self._results_timeout_s = results_timeout_s
        # name -> ray_tpu_torch.data.Dataset; each is streaming_split across
        # the worker group and handed out via session.get_dataset_shard
        # (reference: DataParallelTrainer datasets= + DataConfig)
        self._datasets = datasets or {}
        # Largest observed elastic-restart downtime (s); checkpoint specs
        # carry it so the "auto" cadence solver prices failures correctly.
        self._restart_cost_s = 0.0

    def _dataset_shards(self):
        if not self._datasets:
            return None
        n = self.scaling_config.num_workers
        shard_sets: list = [{} for _ in range(n)]
        for name, ds in self._datasets.items():
            for i, it in enumerate(ds.streaming_split(n, equal=True)):
                shard_sets[i][name] = it
        # The split's tasks (row counts, block slices) finish before the
        # workers take their resources: one still queued on a daemon that
        # the workers then fill would wait there for workers that wait for
        # it (ROADMAP Queue 3, fixed 14).
        refs = [r for shards in shard_sets for it in shards.values()
                for r in it._ds._execute()]
        if refs:
            ray_tpu_torch.wait(refs, num_returns=len(refs))
        return shard_sets

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        failures = 0
        restart_backoff = BackoffPolicy(base_s=0.1, max_s=2.0, deadline_s=0)
        max_failures = self.run_config.failure_config.max_failures
        checkpoint = self._resume_from
        history = []
        last_metrics: Dict[str, Any] = {}
        engine_root = self._engine_root()
        # Goodput: stamp of the failure that triggered the current restart
        # attempt; the gap until training is running again is the job's
        # elastic-restart downtime, attributed on the driver ledger.
        restart_t0: Optional[float] = None
        while True:
            executor = BackendExecutor(
                self.scaling_config.num_workers,
                self.scaling_config.worker_resources(),
                self.scaling_config.placement_strategy,
                self._collective_backend,
                results_timeout_s=self._results_timeout_s)
            try:
                # Split the datasets before the workers take their
                # resources (the JAX package splits after start()).
                shards = self._dataset_shards()
                executor.start()
                executor.start_training(self._train_loop, self._config,
                                        checkpoint,
                                        dataset_shards=shards,
                                        checkpoint_spec=self._checkpoint_spec(
                                            engine_root, checkpoint))
                if restart_t0 is not None:
                    dt = time.monotonic() - restart_t0
                    # Feeds the "auto" cadence solver on the NEXT spec:
                    # a failure costs its restart, so pricier restarts
                    # shift the optimum toward denser checkpoints.
                    self._restart_cost_s = max(self._restart_cost_s, dt)
                    if goodput.ENABLED:
                        goodput.account("restart_downtime", dt)
                    restart_t0 = None
                while True:
                    round_results = executor.get_next_results()
                    if round_results is None:
                        break
                    for r in round_results:
                        history.append(r["metrics"])
                        if r["checkpoint"] is not None and r["rank"] == 0:
                            checkpoint = r["checkpoint"]
                    if round_results:
                        last_metrics = round_results[0]["metrics"]
                finals = executor.get_final_checkpoints()
                if finals and finals[0] is not None:
                    checkpoint = finals[0]
                return Result(metrics=last_metrics, checkpoint=checkpoint,
                              metrics_history=history)
            except (exc.ActorDiedError, exc.NodeDiedError,
                    exc.TaskError) as e:
                if restart_t0 is None:
                    restart_t0 = time.monotonic()
                failures += 1
                if max_failures != -1 and failures > max_failures:
                    return Result(metrics=last_metrics, checkpoint=checkpoint,
                                  error=e, metrics_history=history)
                # Elastic restart from the last *committed* manifest when the
                # engine is on (reference: backend_executor.py:510-531). The
                # streamed in-memory checkpoint is the fallback — it may be
                # ahead of the last commit, but it dies with the driver.
                committed = self._committed_checkpoint(engine_root)
                if committed is not None:
                    checkpoint = committed
                time.sleep(restart_backoff.delay_for(failures - 1))
                continue
            finally:
                # Never leak the worker group / placement group, whatever
                # path exits the attempt.
                executor.shutdown()

    def _engine_root(self) -> Optional[str]:
        """Engine store under <storage_path>/<name>/checkpoints; None keeps
        checkpoints driver-memory-only (small runs, existing behavior)."""
        storage = self.run_config.storage_path
        if not storage:
            return None
        name = self.run_config.name or "experiment"
        return os.path.join(storage, name, "checkpoints")

    def _checkpoint_spec(self, engine_root: Optional[str], checkpoint=None):
        if engine_root is None:
            return None
        cfg = self.run_config.checkpoint_config
        # run_token namespaces pending/ save keys per attempt, so shard
        # indexes left by a crashed attempt can never join a new commit.
        # base_step carries the step counter across attempts: a restarted
        # session resumes numbering AFTER the last committed manifest, so
        # retention (which keeps the newest commits) and the LATEST
        # fallback scan see one monotonic step sequence instead of a
        # post-crash counter reset shadowed by stale pre-crash manifests.
        # frequency passes through verbatim — an int cadence, or "auto"
        # for the risk-tuned Young–Daly solver (checkpoint/cadence.py);
        # restart_cost_s feeds that solver's failure pricing.
        return {"root": engine_root,
                "num_to_keep": cfg.num_to_keep,
                "frequency": cfg.checkpoint_frequency,
                "base_step": self._base_step(engine_root, checkpoint),
                "run_token": uuid.uuid4().hex[:8],
                "restart_cost_s": self._restart_cost_s}

    def _base_step(self, engine_root: str, checkpoint) -> int:
        """The step an attempt's saves number after: that of the committed
        manifest it resumes from. The newest commit is not it when a failed
        attempt's writer thread commits a later step after the restart
        picked its checkpoint; numbering after that one would skip a step
        (the JAX package reads the newest commit here)."""
        ref = getattr(checkpoint, "manifest_ref", None)
        if ref is not None and ref.manifest_name is not None and \
                os.path.abspath(ref.root) == os.path.abspath(engine_root):
            from ray_tpu_torch.checkpoint import read_manifest
            return int(read_manifest(ref.root, ref.manifest_name).step)
        return self._committed_step(engine_root)

    def _committed_step(self, engine_root: str) -> int:
        from ray_tpu_torch.checkpoint import (CheckpointError, read_manifest,
                                        resolve_latest)
        try:
            name = resolve_latest(engine_root)
            if name is None:
                return 0
            return int(read_manifest(engine_root, name).step)
        except CheckpointError as e:
            logger.warning("could not read last committed step (restarting "
                           "the counter from 0): %s", e)
            return 0

    def _committed_checkpoint(self, engine_root: Optional[str]):
        if engine_root is None:
            return None
        from ray_tpu_torch.checkpoint import resolve_latest
        name = resolve_latest(engine_root)
        if name is None:
            return None
        logger.info("restarting from committed checkpoint manifest %s", name)
        return Checkpoint.from_manifest(engine_root, name)
