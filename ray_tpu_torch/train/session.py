"""Per-worker training session.

Port of ``ray_tpu/train/session.py`` (parity with ``python/ray/air/session.py``
+ ``train/_internal/session.py:261``): ``report(metrics, checkpoint=...)``
streams results to the driver; ``get_checkpoint`` hands back the restore
point; rank/world accessors mirror the reference's. ``get_mesh()`` exposes
the worker's ``parallel.Mesh`` (or None) and ``shard_batch`` places a batch
on it.

``report`` snapshots a reported checkpoint's tensor leaves. JAX arrays are
immutable, so the JAX package hands the reported tree on as it is; here
the training step updates parameters in place, and a checkpoint the driver
already holds would change under it (the object store refuses a tensor
written after its put). With the checkpoint engine on, the snapshot is the
engine's host copy; without it, a clone on the tensor's device.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.observability import goodput, perf
from ray_tpu_torch.train.step import settle_optimizer_phase

logger = logging.getLogger("ray_tpu")


class _TrainSession:
    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0,
                 checkpoint=None, mesh=None, config=None,
                 collective_group_name: Optional[str] = None,
                 dataset_shards=None, checkpoint_spec=None,
                 device: Optional[torch.device] = None):
        self.dataset_shards = dataset_shards or {}
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.collective_group_name = collective_group_name
        self.results: "queue.Queue" = queue.Queue()
        self.checkpoint = checkpoint
        self.mesh = mesh
        # the device the mesh is on: the worker's granted card, or the CPU
        # of a daemon without one
        self.device = device
        self.config = config or {}
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self.latest_checkpoint = checkpoint
        # Engine-backed persistence (trainer passes a spec when
        # RunConfig.storage_path is set): every reported checkpoint is also
        # snapshotted asynchronously through ray_tpu_torch.checkpoint, so the
        # driver restarts from a committed manifest, not a driver-memory blob.
        self.checkpoint_spec = checkpoint_spec
        self.checkpoint_engine = None
        # Resume step numbering after the last committed manifest
        # (spec["base_step"], carried across elastic restarts by the
        # trainer) — a counter that restarted at 0 would write manifests
        # that sort BELOW the stale pre-crash ones, and retention would
        # reap the fresh commits instead of the stale ones.
        self._ckpt_seq = int((checkpoint_spec or {}).get("base_step") or 0)
        # Perf plane: monotonic stamp of the previous report(), so the
        # inter-report interval — the user's step wall time — lands in
        # the train.step histogram.
        self._last_report_s = 0.0
        # Risk-tuned cadence (checkpoint_frequency="auto"): the solver
        # needs measured step/ckpt costs, so the session keeps its own
        # report stamp (perf.ENABLED may be off) and gates engine saves
        # on seq distance — a modulo check breaks when the interval is
        # re-solved mid-run.
        self._cadence = None
        self._last_saved_seq: Optional[int] = None
        self._cadence_stamp_s = 0.0
        if (checkpoint_spec or {}).get("frequency") == "auto":
            from ray_tpu_torch.checkpoint import CadenceController
            self._cadence = CadenceController(
                restart_cost_s=float(
                    checkpoint_spec.get("restart_cost_s") or 0.0))

    def _engine(self):
        if self.checkpoint_engine is None and self.checkpoint_spec:
            from ray_tpu_torch.checkpoint import CheckpointEngine
            self.checkpoint_engine = CheckpointEngine(
                self.checkpoint_spec["root"],
                num_to_keep=self.checkpoint_spec.get("num_to_keep"))
        return self.checkpoint_engine

    def _engine_save(self, checkpoint) -> None:
        """Async engine snapshot of a reported checkpoint (already on the
        host: ``report`` snapshots it). The report call returns once the
        save is queued; commit happens on the engine's writer thread."""
        self._ckpt_seq += 1
        if self._cadence is not None:
            # Auto cadence: save when the re-solved interval has elapsed
            # since the last save (the first reported checkpoint always
            # anchors — restore needs an early committed manifest).
            interval = self._cadence.interval_steps()
            if (self._last_saved_seq is not None
                    and self._ckpt_seq - self._last_saved_seq < interval):
                return
        else:
            freq = max(1, int(self.checkpoint_spec.get("frequency") or 1))
            if (self._ckpt_seq - 1) % freq != 0:
                return
        self._last_saved_seq = self._ckpt_seq
        tree = checkpoint.to_dict() if hasattr(checkpoint, "to_dict") \
            else checkpoint
        token = self.checkpoint_spec.get("run_token", "run")
        t0 = time.monotonic() if self._cadence is not None else 0.0
        self._engine().save(
            tree, step=self._ckpt_seq, rank=self.world_rank,
            world_size=self.world_size,
            save_key=f"{token}-{self._ckpt_seq:08d}")
        if self._cadence is not None:
            self._cadence.observe_ckpt(time.monotonic() - t0)

    def _close_engine(self, had_error: bool) -> None:
        eng = self.checkpoint_engine
        if eng is None:
            return
        if had_error:
            # A crashed loop must not stall shutdown behind a commit that
            # waits on dead peers; committed manifests are already durable.
            eng.flush(timeout=0.5)
        else:
            if not eng.flush(timeout=60.0):
                logger.warning("checkpoint: in-flight save unfinished at "
                               "session close (rank %d)", self.world_rank)
            eng.close(timeout=1.0)


_session = threading.local()


def _init_session(**kwargs) -> _TrainSession:
    _session.s = _TrainSession(**kwargs)
    return _session.s


def _get_session() -> Optional[_TrainSession]:
    return getattr(_session, "s", None)


def _shutdown_session():
    _session.s = None


def _copy_tensors(tree: Any, host: bool) -> Any:
    """``tree`` with every tensor leaf copied: to the host, or on its
    device (dict, list and tuple containers are rebuilt)."""
    if isinstance(tree, dict):
        return {k: _copy_tensors(v, host) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tensors(v, host) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if host else t.clone()
    return tree


def _snapshot(checkpoint, host: bool):
    """``checkpoint`` (a dict-form ``Checkpoint`` or a plain tree) with its
    tensor leaves copied now; the directory and manifest forms hold none."""
    from ray_tpu_torch.air.checkpoint import Checkpoint
    if isinstance(checkpoint, Checkpoint):
        if checkpoint._data is None:
            return checkpoint
        return Checkpoint.from_dict(_copy_tensors(checkpoint._data, host))
    return _copy_tensors(checkpoint, host)


def report(metrics: Dict[str, Any], checkpoint=None) -> None:
    """Stream a result row (and optionally a checkpoint) to the driver.

    A checkpoint's tensor leaves are snapshotted here (module note): with
    the engine on they are copied to the host, and that copy is what the
    engine saves and what the driver gets; without it they are cloned on
    their device.

    Perf-plane breakdown per report: ``train.step`` (wall time since the
    previous report — the user's step loop), ``train.ckpt_enqueue`` (the
    synchronous share of the engine save: device->host copy + queueing;
    hash/write/commit stay on the writer thread), and ``train.report``
    (this call's own cost). It also reads the device time of the last
    step's optimizer phase, if the card has finished it
    (``step.settle_optimizer_phase``).

    Goodput ledger: each report closes one step — wall time since the
    previous mark that no explicit interval claimed (data_wait,
    collective_wait, ckpt_stall, compile are accounted at their own
    sites) is credited to ``compute`` via :func:`goodput.step_mark`."""
    s = _get_session()
    if s is None:
        raise RuntimeError("session.report() called outside a train worker")
    settle_optimizer_phase()
    t0 = time.monotonic() if perf.ENABLED else 0.0
    if t0 and s._last_report_s:
        perf.observe("train.step", (t0 - s._last_report_s) * 1e3)
    if s._cadence is not None:
        now_c = time.monotonic()
        if s._cadence_stamp_s:
            s._cadence.observe_step(now_c - s._cadence_stamp_s)
        s._cadence_stamp_s = now_c
    if goodput.ENABLED:
        goodput.step_mark()
    if checkpoint is not None:
        checkpoint = _snapshot(checkpoint, host=bool(s.checkpoint_spec))
        s.latest_checkpoint = checkpoint
        if s.checkpoint_spec:
            s._engine_save(checkpoint)
            if t0:
                perf.observe("train.ckpt_enqueue",
                             (time.monotonic() - t0) * 1e3)
    s.results.put({"metrics": dict(metrics), "checkpoint": checkpoint,
                   "rank": s.world_rank})
    if t0:
        now = time.monotonic()
        s._last_report_s = now
        perf.observe("train.report", (now - t0) * 1e3)


def get_checkpoint():
    s = _get_session()
    return s.checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    """This worker's split of ``TorchTrainer(datasets={name: ds})`` — a
    ``ray_tpu_torch.data.DataIterator`` over its equal share of the rows
    (reference ``session.get_dataset_shard``); None outside a session or
    for a name the trainer was not given."""
    s = _get_session()
    if s is None or name not in s.dataset_shards:
        return None
    return s.dataset_shards[name]


def get_world_rank() -> int:
    s = _get_session()
    return s.world_rank if s else 0


def get_world_size() -> int:
    s = _get_session()
    return s.world_size if s else 1


def get_local_rank() -> int:
    s = _get_session()
    return s.local_rank if s else 0


def get_mesh():
    """The ``parallel.Mesh`` assigned to this worker, or None. Workers in
    daemon processes get a ``data=world`` mesh over the tensor plane's
    world; a run of one in-process worker granted at least one whole card
    gets a ``data=1`` mesh over a world of one on its first granted card;
    workers that share the process get none (the default world is
    process-wide, so threads cannot each hold one). See
    ``backend_executor``'s mesh rule."""
    s = _get_session()
    return s.mesh if s else None


def get_config() -> Dict[str, Any]:
    s = _get_session()
    return dict(s.config) if s else {}


def get_collective_group_name() -> Optional[str]:
    """Name of the collective group the executor created for this worker
    group (None when the trainer was built with collective_backend=None)."""
    s = _get_session()
    return s.collective_group_name if s else None


def shard_batch(array, spec=None):
    """Contribute this worker's LOCAL batch (numpy or tensor) as its shard
    of the global batch on the session mesh, sharded over the mesh's
    data-parallel axes: the DTensor that ``make_lm_train_step(cfg,
    get_mesh())``'s step takes. Its global shape is the local one times
    the mesh's size along each sharded dim. On a process-spanning mesh
    each worker so trains on its own data, as the JAX package's
    ``jax.make_array_from_process_local_data`` (``session.py:228-255``).

    ``spec``: the DTensor placements (one per mesh dim); the default comes
    from the ``batch`` entry of the rules table (``("data", "fsdp")``),
    matching what ``train.step.batch_sharding`` gives the step.
    """
    from torch.distributed.tensor import DTensor, Shard

    from ray_tpu_torch.parallel.sharding import ShardingRules
    s = _get_session()
    if s is None or s.mesh is None:
        raise RuntimeError("shard_batch() needs a session with a mesh")
    t = torch.as_tensor(array if isinstance(array, torch.Tensor)
                        else np.asarray(array)).to(s.device).contiguous()
    if spec is None:
        spec = ShardingRules().sharding(
            s.mesh, ("batch",) + (None,) * (max(1, t.ndim) - 1))
    shape = list(t.shape)
    for axis, p in zip(s.mesh.axis_names, spec):
        if isinstance(p, Shard):
            shape[p.dim] *= s.mesh.shape[axis]
    shape = torch.Size(shape)
    return DTensor.from_local(t, s.mesh.device_mesh, spec, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())
