"""Serve configuration dataclasses.

Parity with the reference's ``python/ray/serve/config.py`` (DeploymentConfig,
AutoscalingConfig) — the knobs a deployment exposes: replica counts,
per-replica concurrency, autoscaling bounds, rolling-update rates, and
user_config pushed to live replicas.

Port of ``ray_tpu/serve/config.py``. One seam: the version hash digests a
``torch.Tensor`` argument by its values (see ``version_hash``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import pickle
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth-driven autoscaling (reference:
    ``serve/_private/autoscaling_policy.py``), plus the latency-SLO mode:
    with ``target_latency_ms > 0`` the controller scales on the
    EWMA-smoothed federated ``serve.queue_wait`` + execute p95 from the
    perf plane instead of instantaneous queue depth."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_num_ongoing_requests_per_replica: float = 1.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 30.0
    smoothing_factor: float = 1.0
    # Latency SLO (ms) the deployment should hold at p95; 0 keeps the
    # queue-depth policy above.
    target_latency_ms: float = 0.0

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        if current == 0:
            return max(1, self.min_replicas)
        per_replica = total_ongoing / current
        error = per_replica / max(
            self.target_num_ongoing_requests_per_replica, 1e-9)
        desired = current * (1.0 + self.smoothing_factor * (error - 1.0))
        import math
        desired = math.ceil(desired - 1e-9)
        return max(self.min_replicas, min(self.max_replicas, desired))

    def desired_replicas_for_latency(self, p95_ms: float,
                                     current: int) -> int:
        """SLO mode: same multiplicative controller as the queue policy,
        but the error signal is observed-p95 / SLO.  p95 == 0 (no recent
        traffic) drives toward ``min_replicas``."""
        if current == 0:
            return max(1, self.min_replicas)
        error = p95_ms / max(self.target_latency_ms, 1e-9)
        desired = current * (1.0 + self.smoothing_factor * (error - 1.0))
        import math
        desired = math.ceil(desired - 1e-9)
        return max(self.min_replicas, min(self.max_replicas, desired))


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 100
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 10.0
    graceful_shutdown_timeout_s: float = 20.0
    # Model weights source: a ray_tpu_torch.checkpoint.CheckpointRef (or
    # its {"root", "manifest_name"} dict form after config serialization).
    # Replicas cold-start by loading the manifest on the replica actor —
    # weights come from the content-addressed store, never through the
    # controller. Changing it is a version change (rolling update).
    checkpoint: Optional[Any] = None
    # Replica-side continuous batching: > 1 turns the replica into an
    # adaptive micro-batcher — __call__ (and function deployments) must
    # then accept a LIST of requests and return a list of equal length.
    max_batch_size: int = 1
    # Max linger the oldest queued request waits for its batch to fill.
    batch_wait_timeout_s: float = 0.005
    # Pad-to-bucket shapes: batches are padded (repeating the last item)
    # up to the next bucket so the forward sees only these static batch
    # sizes (what a CUDA graph or a compiled forward needs to avoid
    # recapturing per batch size).
    pad_batch_to: Optional[Tuple[int, ...]] = None
    # Per-request latency budget (ms) the batcher sizes batches against
    # and the router sheds over; 0 falls back to the global
    # serve_target_latency_ms knob.
    target_latency_ms: float = 0.0

    def effective_target_latency_ms(self) -> float:
        if self.target_latency_ms > 0:
            return float(self.target_latency_ms)
        from ray_tpu_torch._private.config import _config
        return float(_config.get("serve_target_latency_ms"))

    def version_hash(self, func_or_class, init_args, init_kwargs) -> str:
        """Code/config version: changing it triggers a rolling update;
        changing only user_config reconfigures replicas in place
        (reference: deployment_state version semantics).  The hash covers
        the callable's source (so edited code redeploys) plus init args,
        actor options, and the checkpoint manifest pin.

        A ``torch.Tensor`` anywhere in the arguments counts by its dtype,
        shape and values (``_TensorDigestPickler``), as a ``jax.Array``
        does in the JAX package: equal values give the same version and a
        changed value a new one, whatever storage or device holds them."""
        import hashlib
        import inspect
        try:
            code = inspect.getsource(func_or_class)
        except Exception:  # raylint: allow(swallow) source unavailable: fall back to qualname
            code = getattr(func_or_class, "__qualname__",
                           repr(func_or_class))
        ckpt = self.checkpoint
        if dataclasses.is_dataclass(ckpt):
            ckpt = dataclasses.asdict(ckpt)
        try:
            payload = _TensorDigestPickler.dumps(
                (code, init_args, init_kwargs, self.ray_actor_options,
                 ckpt))
        except Exception:  # raylint: allow(swallow) unpicklable config: fall back to repr
            payload = repr((code, init_args, init_kwargs, ckpt)).encode()
        return hashlib.sha1(payload).hexdigest()[:12]


class _TensorDigestPickler(pickle.Pickler):
    """``pickle.dumps`` for hashing only, with every tensor replaced by
    ``(dtype, shape, sha1 of its bytes)``. Pickling a tensor itself would
    write its whole storage (a view's too) with the storage's metadata,
    so equal values in two tensors could give two versions. The bytes are
    hashed one tensor at a time on the host: a deploy copies each tensor
    argument to the host once."""

    def persistent_id(self, obj):
        if not isinstance(obj, torch.Tensor):
            return None
        host = obj.detach().to("cpu").contiguous()
        digest = hashlib.sha1(
            host.reshape(-1).view(torch.uint8).numpy()).hexdigest()
        return ("tensor", str(obj.dtype), tuple(obj.shape), digest)

    @classmethod
    def dumps(cls, obj) -> bytes:
        buf = io.BytesIO()
        cls(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)
        return buf.getvalue()

