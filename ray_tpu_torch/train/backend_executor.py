"""Worker-group orchestration for distributed training.

Port of ``ray_tpu/train/backend_executor.py`` (parity with
``python/ray/train/_internal/backend_executor.py`` + ``worker_group.py``):
N training workers as actors inside a placement group, rendezvous/setup on
start (workers join a collective group, ``nccl`` by default, and may
receive a device mesh), results streamed per round, failure detection
surfaced to the trainer for restart-from-checkpoint
(``backend_executor.py:461-531``).

The mesh rule:
- Workers in daemon processes (``init(address=)``) join a process-spanning
  collective group (``NCCLProcessGroup``): the tensor plane owns the
  ``torch.distributed`` world, one rank per worker, and each worker's mesh
  is ``data=world`` over it, on its granted card, or on the CPU in a daemon
  without one. The gradient allreduce of a sharded step then spans the
  processes (the JAX package's global device mesh,
  ``ray_tpu/train/backend_executor.py:44-74``).
- Workers that are threads of one process: a run of ONE worker granted at
  least one whole card gets a ``data=1`` mesh over a world of one on its
  first granted card. The worker initializes that world only when the
  process has none, and destroys what it initialized at ``shutdown``. More
  workers get no mesh: ``torch.distributed``'s default world is
  process-wide, so threads cannot each hold one (the JAX package gives
  none either when workers outnumber devices); their data-parallel split
  is the collective group's job.
A mesh that the rule promises and that cannot be built raises.
"""

from __future__ import annotations
import logging

import os
import socket
import threading
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

logger = logging.getLogger("ray_tpu")

_FINISHED = "__finished__"
_GROUP_SEQ = 0
# How long shutdown waits for a worker to destroy its world.
_WORKER_SHUTDOWN_S = 10.0


@ray_tpu_torch.remote
class RayTrainWorker:
    """One training worker (reference: ``_internal/worker_group.py:16``)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.session = None
        self.thread = None
        self._owns_world = False

    def _local_mesh(self, devices: List[torch.device]):
        """The mesh rule (module note): a ``data=1`` mesh on the first
        granted card for a run of one worker, else None."""
        from ray_tpu_torch.parallel import MeshConfig, build_mesh
        if self.world_size != 1 or not devices:
            return None
        device = devices[0]
        if not dist.is_initialized():
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{port}", rank=0,
                world_size=1, device_id=device)
            self._owns_world = True
        return build_mesh(MeshConfig(data=1), device)

    def start_training(self, train_loop: Callable, config: Dict[str, Any],
                       checkpoint=None, group_name: Optional[str] = None,
                       dataset_shards=None, checkpoint_spec=None):
        from ray_tpu_torch._private.runtime import task_context
        from ray_tpu_torch.collective.collective import GroupManager
        from ray_tpu_torch.collective.collective_group.nccl_process_group import (  # noqa: E501
            NCCLProcessGroup)
        from ray_tpu_torch.parallel import MeshConfig, build_mesh
        from ray_tpu_torch.train import session as session_mod
        g = GroupManager.get_group(group_name) if group_name else None
        if isinstance(g, NCCLProcessGroup):
            # The tensor plane spans the worker PROCESSES: the mesh is the
            # plane's world (the reference's per-worker process group,
            # train/torch/config.py:54-96).
            device = g.device
            mesh = build_mesh(MeshConfig(data=self.world_size), device)
        else:
            devices = list(task_context.devices or [])
            mesh = self._local_mesh(devices)
            device = devices[0] if mesh is not None else None
        self.session = session_mod._init_session(
            world_rank=self.rank, world_size=self.world_size,
            checkpoint=checkpoint, mesh=mesh, config=config,
            collective_group_name=group_name,
            dataset_shards=dataset_shards, checkpoint_spec=checkpoint_spec,
            device=device)
        sess = self.session
        # Collective groups and task context are thread-local; hand the actor
        # thread's bindings (its device grant included) to the
        # training-loop thread.
        from ray_tpu_torch.collective.collective import _local_groups
        groups = GroupManager._groups()
        ctx = (task_context.node_id, task_context.actor_id,
               task_context.job_id, task_context.devices)

        def _run():
            from ray_tpu_torch.train import session as sm
            sm._session.s = sess  # bind session into the loop thread
            _local_groups.groups = groups
            (task_context.node_id, task_context.actor_id,
             task_context.job_id, task_context.devices) = ctx
            try:
                train_loop(config)
            except BaseException as e:  # noqa: BLE001
                sess.error = e
            finally:
                # Drain in-flight engine saves BEFORE the completion
                # sentinel: a result consumer must observe the last
                # checkpoint as committed, not queued.
                try:
                    sess._close_engine(had_error=sess.error is not None)
                except Exception as ce:
                    logger.warning("checkpoint engine close failed: %s", ce)
                sess.finished.set()
                sess.results.put(_FINISHED)

        self.thread = threading.Thread(target=_run, daemon=True)
        self.thread.start()
        return self.rank

    def next_result(self, timeout: Optional[float] = None):
        """Block until the next reported result (or completion sentinel).

        ``timeout=None`` blocks indefinitely: a slow epoch is not a failure.
        Worker death is still detected (the actor call raises), and the loop
        thread's completion sentinel always arrives via ``finally``.
        """
        import queue as _q
        try:
            item = self.session.results.get(timeout=timeout)
        except _q.Empty:
            raise TimeoutError(f"worker {self.rank} produced no result "
                               f"within {timeout}s")
        if item == _FINISHED:
            if self.session.error is not None:
                raise self.session.error
            return _FINISHED
        return item

    def get_final_checkpoint(self):
        return self.session.latest_checkpoint if self.session else None

    def ping(self):
        return "ok"

    def shutdown(self):
        """Destroy the ``torch.distributed`` world this worker initialized
        for its mesh (none otherwise)."""
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_world = False


class BackendExecutor:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 collective_backend: Optional[str] = None,
                 results_timeout_s: Optional[float] = None):
        self.num_workers = num_workers
        self.resources_per_worker = resources_per_worker
        self.placement_strategy = placement_strategy
        self.collective_backend = collective_backend
        self.results_timeout_s = results_timeout_s
        self.pg = None
        self.workers: List[Any] = []
        self.group_name: Optional[str] = None
        self._finished: set = set()

    def start(self):
        num_gpus = self.resources_per_worker.get("GPU", 0)
        if num_gpus and not torch.cuda.is_available():
            raise RuntimeError(
                f"train workers ask for {num_gpus} GPU each and this "
                "process sees no CUDA card")
        bundles = [dict(self.resources_per_worker)
                   for _ in range(self.num_workers)]
        self.pg = placement_group(bundles, strategy=self.placement_strategy)
        if not self.pg.wait(60):
            raise exc.PlacementGroupSchedulingError(
                f"could not place {self.num_workers} train workers with "
                f"{self.resources_per_worker} each")
        num_cpus = self.resources_per_worker.get("CPU", 1)
        num_gpus = self.resources_per_worker.get("GPU", 0)
        self.workers = [
            RayTrainWorker.options(
                num_cpus=num_cpus, num_gpus=num_gpus,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg,
                    placement_group_bundle_index=i),
            ).remote(i, self.num_workers)
            for i in range(self.num_workers)
        ]
        ray_tpu_torch.get([w.ping.remote() for w in self.workers])
        if self.collective_backend:
            from ray_tpu_torch.collective import create_collective_group
            global _GROUP_SEQ
            _GROUP_SEQ += 1
            # Unique per attempt AND per process lifetime: a recycled
            # id(self) must never alias a previous attempt's tensor-plane
            # rendezvous keys.
            self.group_name = f"train_{os.getpid()}_{_GROUP_SEQ}"
            create_collective_group(
                self.workers, self.num_workers,
                list(range(self.num_workers)),
                backend=self.collective_backend, group_name=self.group_name)

    def start_training(self, train_loop: Callable, config: Dict[str, Any],
                       checkpoint=None, dataset_shards=None,
                       checkpoint_spec=None):
        self._finished = set()
        ray_tpu_torch.get([
            w.start_training.remote(
                train_loop, config, checkpoint, self.group_name,
                dataset_shards[i] if dataset_shards else None,
                checkpoint_spec)
            for i, w in enumerate(self.workers)])

    def get_next_results(self, timeout: Optional[float] = None):
        """One result per still-running worker, or None once all finished.

        Workers that already hit their completion sentinel are not polled
        again (a worker reporting fewer rounds than its peers must not hang
        the round). Raises the training error (or ActorDiedError) for failed
        workers — callers use that signal for restart handling.
        """
        live = [(i, w) for i, w in enumerate(self.workers)
                if i not in self._finished]
        if not live:
            return None
        timeout = timeout if timeout is not None else self.results_timeout_s
        refs = [w.next_result.remote(timeout) for _, w in live]
        results = ray_tpu_torch.get(
            refs, timeout=None if timeout is None else timeout + 30)
        out = []
        for (i, _), r in zip(live, results):
            if r == _FINISHED:
                self._finished.add(i)
            else:
                out.append(r)
        if not out and len(self._finished) == len(self.workers):
            return None
        return out

    def get_final_checkpoints(self):
        """Final checkpoint per worker, None for workers that are dead or
        miss their deadline — one crashed worker must not hang shutdown."""
        from ray_tpu_torch._private.backoff import BackoffPolicy
        from ray_tpu_torch._private.config import _config
        policy = BackoffPolicy(
            deadline_s=float(_config.checkpoint_final_timeout_s))
        out = []
        for i, w in enumerate(self.workers):
            state = policy.start()
            try:
                out.append(ray_tpu_torch.get(w.get_final_checkpoint.remote(),
                                       timeout=state.attempt_timeout()))
            except Exception as e:
                logger.warning(
                    "final checkpoint from worker %d unavailable (%s: %s); "
                    "returning partial results", i, type(e).__name__, e)
                out.append(None)
        return out

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.get(w.shutdown.remote(),
                                  timeout=_WORKER_SHUTDOWN_S)
            except Exception as e:
                logger.debug("worker shutdown failed: %s", e)
            try:
                ray_tpu_torch.kill(w)
            except Exception as e:
                logger.debug("worker kill failed: %s", e)
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception as e:
                logger.debug("placement group removal failed: %s", e)
        self.workers = []
