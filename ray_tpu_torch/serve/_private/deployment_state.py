"""Deployment reconciliation: target state -> running replica actors.

Parity with ``python/ray/serve/_private/deployment_state.py``: each
deployment has a target (code version, config, replica count); a reconcile
step starts/stops replica actors to converge, performs rolling updates when
the code version changes, reconfigures in place when only user_config
changes, and replaces dead replicas.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.observability import perf
from ray_tpu_torch.serve._private.replica import Replica
from ray_tpu_torch.serve.config import DeploymentConfig

logger = logging.getLogger("ray_tpu.serve")

_replica_counter = itertools.count()


class ReplicaInfo:
    healthy = False  # flips on the first successful health probe

    def __init__(self, tag: str, handle, version: str):
        self.tag = tag
        self.handle = handle
        self.version = version


class DeploymentState:
    def __init__(self, name: str):
        self.name = name
        self.func_or_class = None
        self.init_args: Tuple = ()
        self.init_kwargs: Dict = {}
        self.config = DeploymentConfig()
        self.target_version: Optional[str] = None
        self.target_replicas = 0
        self.replicas: List[ReplicaInfo] = []
        self.deleting = False
        self._last_health_check = 0.0
        # Last-seen cumulative perf counts per replica tag: the controller
        # federates WINDOWED (per-tick delta) histograms, so each tick's
        # p95 reflects recent traffic, not all history.
        self._prev_perf: Dict[str, Dict[str, List[int]]] = {}

    # -- target mutations -------------------------------------------------

    def set_target(self, func_or_class, init_args, init_kwargs,
                   config: DeploymentConfig) -> None:
        self.func_or_class = func_or_class
        self.init_args = init_args or ()
        self.init_kwargs = init_kwargs or {}
        new_version = config.version_hash(
            func_or_class, self.init_args, self.init_kwargs)
        version_changed = new_version != self.target_version
        user_config_changed = config.user_config != self.config.user_config
        self.target_version = new_version
        self.config = config
        self.target_replicas = (
            config.autoscaling_config.min_replicas
            if config.autoscaling_config else config.num_replicas)
        self.deleting = False
        if not version_changed and user_config_changed:
            # In-place reconfigure (reference: lightweight config update).
            for info in self.replicas:
                try:
                    ray_tpu.get(info.handle.reconfigure.remote(
                        config.user_config))
                except Exception as e:
                    logger.warning("in-place reconfigure failed: %s", e)

    def set_num_replicas(self, n: int) -> None:
        cfg = self.config.autoscaling_config
        if cfg is not None:
            n = max(cfg.min_replicas, min(cfg.max_replicas, n))
        self.target_replicas = n

    def delete(self) -> None:
        self.deleting = True
        self.target_replicas = 0

    def retune_batch(self, **cfg: Any) -> None:
        """Push a batch-config delta (linger, cap, pad buckets) to every
        live replica AND into the target config, so replicas started
        later inherit the retuned shape.  This is the serve actuator's
        write path — the autopilot tunes linger here from the federated
        ``serve.queue_wait`` p95, journaled like every other knob."""
        for key, value in cfg.items():
            if hasattr(self.config, key):
                setattr(self.config, key, value)
        for info in self.replicas:
            try:
                ray_tpu.get(info.handle.set_batch_config.remote(dict(cfg)))
            except Exception as e:  # noqa: BLE001 — next reconcile replaces
                logger.warning("batch retune of %s failed: %s",
                               info.tag, e)

    # -- reconciliation ---------------------------------------------------

    def _start_replica(self) -> ReplicaInfo:
        tag = f"{self.name}#{next(_replica_counter)}"
        opts = dict(self.config.ray_actor_options)
        opts.setdefault("max_concurrency",
                        max(2, self.config.max_concurrent_queries))
        batch_cfg = None
        if getattr(self.config, "max_batch_size", 1) > 1:
            batch_cfg = {
                "max_batch_size": self.config.max_batch_size,
                "batch_wait_timeout_s": self.config.batch_wait_timeout_s,
                "pad_batch_to": self.config.pad_batch_to,
                "target_latency_ms": self.config.target_latency_ms,
            }
        handle = ray_tpu.remote(Replica).options(**opts).remote(
            self.name, tag, self.func_or_class, self.init_args,
            self.init_kwargs, self.config.user_config,
            self.config.checkpoint, batch_cfg)
        return ReplicaInfo(tag, handle, self.target_version)

    def _stop_replica(self, info: ReplicaInfo) -> None:
        try:
            ray_tpu.get(info.handle.prepare_for_shutdown.remote(
                self.config.graceful_shutdown_timeout_s), timeout=None)
        except Exception as e:
            logger.debug("graceful replica shutdown failed: %s", e)
        try:
            ray_tpu.kill(info.handle)
        except Exception as e:
            logger.debug("replica kill failed: %s", e)

    def _check_health(self) -> List[ReplicaInfo]:
        """Probe all replicas concurrently; returns the live ones.

        A replica is dead only when its health ref resolves to an error
        (actor died); a slow-but-running replica whose ref isn't ready
        within the probe window stays live.  Runs at
        ``health_check_period_s`` cadence, not every control-loop tick.
        """
        import time as _time
        probes = []
        for info in self.replicas:
            try:
                probes.append((info, info.handle.check_health.remote()))
            except Exception as e:
                logger.debug("health probe submit failed: %s", e)
                probes.append((info, None))
        refs = [r for _, r in probes if r is not None]
        if refs:
            ray_tpu.wait(refs, num_returns=len(refs), timeout=2.0)
        live = []
        for info, ref in probes:
            if ref is None:
                logger.warning("replica %s unreachable; replacing", info.tag)
                continue
            ready, _ = ray_tpu.wait([ref], timeout=0)
            if not ready:
                live.append(info)  # slow, not dead
                continue
            try:
                ray_tpu.get(ref, timeout=0.1)
                info.healthy = True   # answered a probe: READY to serve
                live.append(info)
            except Exception:
                logger.warning("replica %s died; replacing", info.tag)
        self._last_health_check = _time.monotonic()
        return live

    def reconcile(self) -> bool:
        """One convergence step. Returns True if replica membership changed."""
        import time as _time
        changed = False

        # Replace dead replicas (failure recovery) on the configured
        # cadence — but while any replica has never answered a probe
        # (still placing / initializing), probe EVERY tick so readiness
        # (serve.run's wait) resolves promptly.
        if self.replicas and (
                any(not r.healthy for r in self.replicas)
                or _time.monotonic() - self._last_health_check
                >= self.config.health_check_period_s):
            live = self._check_health()
            if len(live) != len(self.replicas):
                changed = True
            self.replicas = live

        # Rolling update: retire at most one stale replica per step so
        # capacity never drops by more than one (reference semantics).
        stale = [r for r in self.replicas if r.version != self.target_version]
        if stale and self.func_or_class is not None:
            old = stale[0]
            if len(self.replicas) <= self.target_replicas:
                self.replicas.append(self._start_replica())
            self.replicas.remove(old)
            self._stop_replica(old)
            changed = True

        # Scale toward the target count.
        while len(self.replicas) < self.target_replicas:
            self.replicas.append(self._start_replica())
            changed = True
        while len(self.replicas) > self.target_replicas:
            info = self.replicas.pop()
            self._stop_replica(info)
            changed = True
        return changed

    # -- introspection ----------------------------------------------------

    def running_replica_handles(self) -> List[Any]:
        return [r.handle for r in self.replicas]

    def total_ongoing_requests(self) -> float:
        total = 0.0
        for info in self.replicas:
            try:
                m = ray_tpu.get(info.handle.get_metrics.remote(), timeout=5)
                total += m["num_ongoing_requests"]
            except Exception as e:
                logger.debug("replica metrics fetch failed: %s", e)
        return total

    @staticmethod
    def _window(cur: Optional[List[int]],
                prev: Optional[List[int]]) -> Optional[List[int]]:
        """Per-bucket delta of cumulative counts since the last tick.
        A restarted replica's counts reset below the previous snapshot —
        clamp at 0 instead of producing negative buckets."""
        if not cur:
            return None
        if not prev or len(prev) != len(cur):
            return list(cur)
        return [max(0, c - p) for c, p in zip(cur, prev)]

    def collect_metrics(self) -> dict:
        """One federated sensor sweep: fetch every replica's local
        histograms, window them against the previous tick, and compute

        - per-replica windowed ``execute`` p95 (published to routers for
          power-of-two-choices scoring) and ``queue_est_ms`` backpressure,
        - the deployment-wide windowed ``queue_wait`` + ``execute`` p95
          (summed: the time a newly admitted request should expect) that
          drives the SLO autoscaler,
        - total ongoing requests (the legacy queue-depth signal), all
          from a single ``get_metrics`` round-trip per replica.
        """
        probes = []
        for info in self.replicas:
            try:
                probes.append((info, info.handle.get_metrics.remote()))
            except Exception as e:
                logger.debug("replica metrics submit failed: %s", e)
        total_ongoing = 0.0
        per_replica: Dict[str, dict] = {}
        qw_windows: List[List[int]] = []
        ex_windows: List[List[int]] = []
        bounds = None
        new_prev: Dict[str, Dict[str, List[int]]] = {}
        for info, ref in probes:
            try:
                m = ray_tpu.get(ref, timeout=5)
            except Exception as e:
                logger.debug("replica metrics fetch failed: %s", e)
                continue
            total_ongoing += m.get("num_ongoing_requests", 0)
            p = m.get("perf") or {}
            bounds = p.get("bounds") or bounds
            qw = (p.get("queue_wait") or {}).get("counts")
            ex = (p.get("execute") or {}).get("counts")
            prev = self._prev_perf.get(info.tag, {})
            d_qw = self._window(qw, prev.get("queue_wait"))
            d_ex = self._window(ex, prev.get("execute"))
            new_prev[info.tag] = {"queue_wait": list(qw or []),
                                  "execute": list(ex or [])}
            exec_p95 = (perf.quantile(d_ex, 0.95, bounds)
                        if d_ex and sum(d_ex) else 0.0)
            per_replica[info.tag] = {
                "p95_ms": exec_p95,
                "queue_est_ms": float(m.get("queue_est_ms", 0.0)),
                "ongoing": int(m.get("num_ongoing_requests", 0)),
            }
            if d_qw:
                qw_windows.append(d_qw)
            if d_ex:
                ex_windows.append(d_ex)
        self._prev_perf = new_prev
        p95 = 0.0
        merged_qw = perf.merge_counts(qw_windows)
        if merged_qw and sum(merged_qw):
            p95 += perf.quantile(merged_qw, 0.95, bounds)
        merged_ex = perf.merge_counts(ex_windows)
        if merged_ex and sum(merged_ex):
            p95 += perf.quantile(merged_ex, 0.95, bounds)
        return {"total_ongoing": total_ongoing,
                "replicas": per_replica,
                "p95_ms": p95}

    def status(self) -> dict:
        return {
            "name": self.name,
            "target_replicas": self.target_replicas,
            "running_replicas": len(self.replicas),
            # replicas that have ANSWERED a health probe — running counts
            # only started handles, whose actors may still be placing or
            # initializing (serve.run readiness waits on this)
            "ready_replicas": sum(1 for r in self.replicas if r.healthy),
            "version": self.target_version,
            "deleting": self.deleting,
        }
