"""The Serve controller actor.

Parity with ``python/ray/serve/controller.py`` (``ServeController``
``:59,225``): the single control-loop actor that owns all deployment
targets, reconciles them to running replica actors
(`_private/deployment_state.py`), drives queue-metric autoscaling, and
pushes routing tables to handles/proxies via long-poll
(`_private/long_poll.py`).

Port of ``ray_tpu/serve/controller.py``. With ``autopilot_enabled`` on, a
batched deployment registers its linger and batch cap as autopilot
actuators (``serve.<name>.linger_ms``, ``serve.<name>.max_batch_size``) in
this process's registry (``ray_tpu_torch.autopilot``), as the JAX
package's controller does.
"""

from __future__ import annotations
import logging

import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import _config
from ray_tpu_torch.serve._private.deployment_state import DeploymentState
from ray_tpu_torch.serve._private.long_poll import LongPollHost
from ray_tpu_torch.serve.config import DeploymentConfig

logger = logging.getLogger("ray_tpu")

CONTROLLER_NAME = "SERVE_CONTROLLER"
ROUTE_TABLE_KEY = "route_table"


def _replica_key(deployment_name: str) -> str:
    return f"replicas::{deployment_name}"


class ServeController:
    def __init__(self, control_loop_period_s: float = 0.2):
        self._deployments: Dict[str, DeploymentState] = {}  # raylint: guarded-by(self._lock)
        self._routes: Dict[str, str] = {}  # route prefix -> deployment name
        self._long_poll = LongPollHost()
        self._lock = threading.RLock()
        self._period = control_loop_period_s
        self._shutdown = threading.Event()
        self._autoscale_state: Dict[str, float] = {}  # raylint: guarded-by(self._lock)
        self._loop_thread = threading.Thread(
            target=self._control_loop, daemon=True, name="serve-control-loop")
        self._loop_thread.start()

    # -- deploy API --------------------------------------------------------

    def deploy(self, name: str, func_or_class, init_args, init_kwargs,
               config_dict: dict, route_prefix: Optional[str] = None) -> None:
        config = DeploymentConfig(**config_dict)
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                state = self._deployments[name] = DeploymentState(name)
            state.set_target(func_or_class, init_args, init_kwargs, config)
            if route_prefix is not None:
                # A deployment owns one route: drop any previous prefix so a
                # retired route stops serving.
                self._routes = {p: d for p, d in self._routes.items()
                                if d != name}
                self._routes[route_prefix] = name
                self._long_poll.notify_changed(
                    ROUTE_TABLE_KEY, dict(self._routes))
            state.reconcile()
            self._notify_replicas(state)
        self._register_autopilot_actuators(name, config)

    def delete_deployment(self, name: str) -> None:
        self._unregister_autopilot_actuators(name)
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return
            state.delete()
            state.reconcile()
            self._notify_replicas(state)
            del self._deployments[name]
            for suffix in (":up", ":down", ":ewma"):
                self._autoscale_state.pop(f"{name}{suffix}", None)
            self._routes = {p: d for p, d in self._routes.items()
                            if d != name}
            self._long_poll.notify_changed(ROUTE_TABLE_KEY, dict(self._routes))

    def retune_deployment_batch(self, name: str, **cfg: Any) -> None:
        """Live batch retune (autopilot serve actuator target): pushes
        the delta to every running replica and into the target config."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                raise KeyError(f"No deployment named {name!r}")
            state.retune_batch(**cfg)

    # -- autopilot actuators ----------------------------------------------

    def _register_autopilot_actuators(self, name: str, config) -> None:
        """Expose the deployment's micro-batch shape to the autopilot:
        ``serve.<name>.linger_ms`` (the batch linger window, actuated
        from the federated queue_wait p95) and
        ``serve.<name>.max_batch_size``.  Only batched deployments are
        exposed, and only when the controller is autopilot-enabled —
        unregistered knobs are invisible to the policy layer."""
        if getattr(config, "max_batch_size", 1) <= 1 \
                or not _config.get("autopilot_enabled"):
            return
        from ray_tpu_torch.autopilot import actuators as _actuators

        def _get_linger(n=name):
            with self._lock:
                state = self._deployments.get(n)
                return (float(state.config.batch_wait_timeout_s) * 1e3
                        if state else 0.0)

        def _set_linger(ms, n=name):
            self.retune_deployment_batch(
                n, batch_wait_timeout_s=float(ms) / 1e3)

        def _get_max(n=name):
            with self._lock:
                state = self._deployments.get(n)
                return int(state.config.max_batch_size) if state else 1

        def _set_max(v, n=name):
            self.retune_deployment_batch(n, max_batch_size=int(v))

        reg = _actuators.registry()
        reg.register(_actuators.Actuator(
            name=f"serve.{name}.linger_ms", get=_get_linger,
            set=_set_linger, kind="float", lo=1.0, hi=1000.0))
        reg.register(_actuators.Actuator(
            name=f"serve.{name}.max_batch_size", get=_get_max,
            set=_set_max, kind="int", lo=1, hi=1024))

    def _unregister_autopilot_actuators(self, name: str) -> None:
        from ray_tpu_torch.autopilot import actuators as _actuators
        reg = _actuators.registry()
        reg.unregister(f"serve.{name}.linger_ms")
        reg.unregister(f"serve.{name}.max_batch_size")

    def _membership_info(self, state: DeploymentState,
                         metrics: Optional[dict] = None) -> dict:
        """Long-poll payload for one deployment: replica handles plus the
        router's scoring inputs — per-replica windowed execute p95 and
        queue_est_ms (rounded to whole ms so jitter doesn't fan no-op
        updates out to every router) and the shed budget."""
        info: Dict[str, Any] = {
            "handles": state.running_replica_handles(),
            "tags": [r.tag for r in state.replicas],
            "max_concurrent_queries": state.config.max_concurrent_queries,
            "target_latency_ms": state.config.effective_target_latency_ms(),
            "p95_ms": {},
            "queue_est_ms": {},
        }
        if metrics:
            live = {r.tag for r in state.replicas}
            for tag, m in metrics.get("replicas", {}).items():
                if tag not in live:
                    continue
                info["p95_ms"][tag] = round(m.get("p95_ms", 0.0))
                info["queue_est_ms"][tag] = round(m.get("queue_est_ms", 0.0))
        return info

    def _notify_replicas(self, state: DeploymentState,
                         metrics: Optional[dict] = None) -> None:
        self._long_poll.notify_if_changed(
            _replica_key(state.name), self._membership_info(state, metrics))

    # -- queries -----------------------------------------------------------

    def get_replica_handles(self, name: str):
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                raise KeyError(f"No deployment named {name!r}")
            return self._membership_info(state)

    def get_route_table(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def list_deployments(self) -> Dict[str, dict]:
        with self._lock:
            return {n: s.status() for n, s in self._deployments.items()}

    def listen_for_change(self, keys_to_snapshot_ids: Dict[str, int]):
        # Blocks on the host's condvar; safe because the controller actor
        # runs with max_concurrency and the control loop is its own thread.
        return self._long_poll.listen_for_change(keys_to_snapshot_ids)

    # -- control loop ------------------------------------------------------

    def _control_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                self._run_control_loop_once()
            except Exception as e:
                logger.warning("control loop iteration failed: %s", e)
            self._shutdown.wait(self._period)

    def _run_control_loop_once(self) -> None:
        with self._lock:
            states = list(self._deployments.values())
        for state in states:
            # One sensor sweep per deployment per tick: feeds the
            # autoscaler AND the router-facing membership publication.
            metrics = state.collect_metrics()
            self._autoscale(state, metrics)
            with self._lock:
                # A concurrent delete may have removed this deployment
                # between the snapshot and here; reconciling the stale
                # state would resurrect (and leak) replicas.
                if self._deployments.get(state.name) is not state:
                    continue
                state.reconcile()
                # notify_if_changed dedups, so publishing every tick only
                # fans out when membership or the rounded stats moved.
                self._notify_replicas(state, metrics)

    def _autoscale(self, state: DeploymentState,
                   metrics: Optional[dict] = None) -> None:
        cfg = state.config.autoscaling_config
        if cfg is None or state.deleting:
            return
        if metrics is None:
            metrics = state.collect_metrics()
        with self._lock:
            self._autoscale_locked(state, metrics, cfg)

    def _autoscale_locked(self, state: DeploymentState, metrics: dict,
                          cfg) -> None:
        # Scale from the TARGET count, not the live count: while a
        # scale-up is still starting replicas the live count lags, and
        # computing desired from it over-requests again every tick
        # (overshoot/oscillation).  The target already owns the in-flight
        # decision; new demand should be judged against it.
        current = max(1, state.target_replicas)
        if cfg.target_latency_ms > 0:
            # SLO mode: hold the federated windowed queue_wait+execute
            # p95 at the configured latency target.  EWMA smoothing keeps
            # one noisy tick (a single slow batch, an empty window) from
            # whipsawing the replica count.
            alpha = float(_config.get("serve_autoscale_ewma_alpha"))
            ewma_key = f"{state.name}:ewma"
            prev = self._autoscale_state.get(ewma_key)
            p95 = float(metrics.get("p95_ms", 0.0))
            smoothed = (p95 if prev is None
                        else prev + alpha * (p95 - prev))
            self._autoscale_state[ewma_key] = smoothed
            desired = cfg.desired_replicas_for_latency(smoothed, current)
        else:
            desired = cfg.desired_replicas(
                float(metrics.get("total_ongoing", 0.0)), current)
        now = time.monotonic()
        key = state.name
        if desired > state.target_replicas:
            # Upscale after upscale_delay_s of sustained demand.
            first = self._autoscale_state.setdefault(f"{key}:up", now)
            if now - first >= cfg.upscale_delay_s:
                state.set_num_replicas(desired)
                self._autoscale_state.pop(f"{key}:up", None)
            self._autoscale_state.pop(f"{key}:down", None)
        elif desired < state.target_replicas:
            first = self._autoscale_state.setdefault(f"{key}:down", now)
            if now - first >= cfg.downscale_delay_s:
                state.set_num_replicas(desired)
                self._autoscale_state.pop(f"{key}:down", None)
            self._autoscale_state.pop(f"{key}:up", None)
        else:
            self._autoscale_state.pop(f"{key}:up", None)
            self._autoscale_state.pop(f"{key}:down", None)

    def autoscale_tick(self) -> None:
        """Force one synchronous autoscale+reconcile pass (for tests)."""
        self._run_control_loop_once()

    # -- shutdown ----------------------------------------------------------

    def graceful_shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            names = list(self._deployments)
        for name in names:
            self.delete_deployment(name)
