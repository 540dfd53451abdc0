"""Public Serve API.

Parity with ``python/ray/serve/api.py``: ``@serve.deployment`` declares a
deployment, ``.bind()`` composes an application graph (bound deployments
passed as init args become ``DeploymentHandle``s at runtime, the
deployment-graph pattern of ``serve/deployment_graph.py``), ``serve.run``
deploys it, ``serve.start`` brings up the controller and HTTP proxy.

Replicas are actors of the in-process runtime: a deployment with
``ray_actor_options={"num_gpus": 1}`` gets a replica that holds a card.
"""

from __future__ import annotations
import inspect
import logging

import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as ray_tpu
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

logger = logging.getLogger("ray_tpu")

_client_lock = threading.Lock()
_controller = None
_proxy = None


def start(detached: bool = True, http_host: Optional[str] = "127.0.0.1",
          http_port: int = 0):
    """Start (or connect to) the Serve control plane."""
    global _controller
    with _client_lock:
        if _controller is None:
            if not ray_tpu.is_initialized():
                ray_tpu.init()
            try:
                _controller = ray_tpu.get_actor(CONTROLLER_NAME)
            except Exception:  # raylint: allow(swallow) no controller yet: create one below
                _controller = ray_tpu.remote(ServeController).options(
                    name=CONTROLLER_NAME, max_concurrency=64).remote()
                # Wait until the controller is live.
                ray_tpu.get(_controller.get_route_table.remote())
            from ray_tpu_torch._private.worker import register_shutdown_hook
            register_shutdown_hook(shutdown)
        return _controller


def _get_controller():
    if _controller is None:
        return start()
    return _controller


def start_http_proxy(host: str = "127.0.0.1", port: int = 0) -> str:
    """Start the in-process HTTP ingress; returns its base URL."""
    global _proxy
    from ray_tpu_torch.serve._private.http_proxy import HTTPProxy
    with _client_lock:
        if _proxy is None:
            _proxy = HTTPProxy(_get_controller(), host=host, port=port)
        return _proxy.address()


class Application:
    """A bound deployment graph ready for ``serve.run``."""

    def __init__(self, root: "DeploymentNode"):
        self.root = root


class DeploymentNode:
    def __init__(self, deployment: "Deployment", args, kwargs):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _collect(self, out: List["DeploymentNode"]) -> None:
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, DeploymentNode):
                a._collect(out)
        if self not in out:
            out.append(self)


class Deployment:
    def __init__(self, func_or_class, name: str, config: DeploymentConfig,
                 route_prefix: Optional[str] = None):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config
        self.route_prefix = route_prefix

    def options(self, **updates) -> "Deployment":
        import dataclasses
        cfg_fields = {f.name for f in dataclasses.fields(DeploymentConfig)}
        cfg_updates = {k: v for k, v in updates.items() if k in cfg_fields}
        if isinstance(cfg_updates.get("autoscaling_config"), dict):
            cfg_updates["autoscaling_config"] = AutoscalingConfig(
                **cfg_updates["autoscaling_config"])
        new_cfg = dataclasses.replace(self.config, **cfg_updates)
        return Deployment(
            self.func_or_class,
            updates.get("name", self.name),
            new_cfg,
            updates.get("route_prefix", self.route_prefix))

    def bind(self, *args, **kwargs) -> DeploymentNode:
        return DeploymentNode(self, args, kwargs)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_concurrent_queries: int = 100,
               user_config: Any = None,
               autoscaling_config: Optional[Any] = None,
               ray_actor_options: Optional[dict] = None,
               route_prefix: Optional[str] = None,
               health_check_period_s: float = 10.0,
               graceful_shutdown_timeout_s: float = 20.0,
               checkpoint: Any = None,
               max_batch_size: int = 1,
               batch_wait_timeout_s: float = 0.005,
               pad_batch_to: Optional[Any] = None,
               target_latency_ms: float = 0.0):
    """Decorator declaring a class or function as a Serve deployment.

    ``checkpoint`` accepts a ``ray_tpu_torch.checkpoint.CheckpointRef``
    (e.g. ``trainer_result.checkpoint.manifest_ref``): class replicas then
    cold-start with the restored tree injected as a ``checkpoint=`` init
    kwarg, loaded from the engine store on the replica itself.

    ``max_batch_size > 1`` turns each replica into an adaptive
    micro-batcher: ``__call__`` (or the deployed function) must accept a
    LIST of requests and return a list of equal length; ``pad_batch_to``
    (sorted bucket sizes) pads batches so the forward sees only those
    batch sizes; ``target_latency_ms`` is the per-request
    latency budget the batcher sizes against, the router sheds over, and
    — with ``AutoscalingConfig.target_latency_ms`` — the SLO the
    autoscaler holds (0 falls back to the ``serve_target_latency_ms``
    knob).
    """

    def wrap(func_or_class):
        if checkpoint is not None and inspect.isfunction(func_or_class):
            raise ValueError(
                "@serve.deployment(checkpoint=...) requires a class: the "
                "restored pytree is injected as the replica's checkpoint= "
                "init kwarg, which a function deployment cannot receive")
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            autoscaling_config=asc,
            ray_actor_options=ray_actor_options or {},
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            checkpoint=checkpoint,
            max_batch_size=max_batch_size,
            batch_wait_timeout_s=batch_wait_timeout_s,
            pad_batch_to=tuple(pad_batch_to) if pad_batch_to else None,
            target_latency_ms=target_latency_ms)
        return Deployment(func_or_class,
                          name or func_or_class.__name__, cfg, route_prefix)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def run(target, name: str = "default",
        route_prefix: Optional[str] = "/",
        ready_timeout_s: float = 300.0) -> DeploymentHandle:
    """Deploy an application (a bound deployment graph) and return a handle
    to its ingress deployment."""
    if isinstance(target, Application):
        root = target.root
    elif isinstance(target, DeploymentNode):
        root = target
    elif isinstance(target, Deployment):
        root = target.bind()
    else:
        raise TypeError(f"serve.run expects a bound deployment, got "
                        f"{type(target)}")
    controller = _get_controller()

    # Deploy dependencies first (topological from leaves), replacing bound
    # nodes in init args with DeploymentHandles.
    ordered: List[DeploymentNode] = []
    root._collect(ordered)

    def materialize(v):
        if isinstance(v, DeploymentNode):
            return DeploymentHandle(v.deployment.name, controller)
        return v

    for node in ordered:
        dep = node.deployment
        init_args = tuple(materialize(a) for a in node.args)
        init_kwargs = {k: materialize(v) for k, v in node.kwargs.items()}
        import dataclasses
        cfg_dict = dataclasses.asdict(dep.config)
        if cfg_dict.get("autoscaling_config") is not None:
            cfg_dict["autoscaling_config"] = AutoscalingConfig(
                **cfg_dict["autoscaling_config"])
        prefix = dep.route_prefix
        if node is root and prefix is None:
            prefix = route_prefix
        ray_tpu.get(controller.deploy.remote(
            dep.name, dep.func_or_class, init_args, init_kwargs,
            cfg_dict, prefix))
    # Reference semantics: serve.run blocks until the application is
    # ready — returning earlier hands out a handle whose first requests
    # race replica placement (observed on multi-process clusters, where
    # actor placement is not instantaneous).
    _wait_ready(controller, [n.deployment.name for n in ordered],
                timeout_s=ready_timeout_s)
    return DeploymentHandle(root.deployment.name, controller)


def _wait_ready(controller, names: List[str],
                timeout_s: float = 300.0) -> None:
    """Block until every deployment's replicas have ANSWERED a health
    probe (``ready_replicas``) — ``running_replicas`` counts only started
    actor handles, which are satisfied synchronously at deploy time while
    placement and __init__ still run in the background."""
    import time as _time
    deadline = _time.monotonic() + timeout_s
    pending = list(names)
    while _time.monotonic() < deadline:
        statuses = ray_tpu.get(controller.list_deployments.remote())
        pending = [n for n in names
                   if statuses.get(n, {}).get("ready_replicas", 0)
                   < statuses.get(n, {}).get("target_replicas", 1)]
        if not pending:
            return
        _time.sleep(0.1)
    raise TimeoutError(
        f"deployments not ready within {timeout_s}s: {pending}")


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _get_controller())


def delete(name: str) -> None:
    ray_tpu.get(_get_controller().delete_deployment.remote(name))


def status() -> Dict[str, dict]:
    return ray_tpu.get(_get_controller().list_deployments.remote())


def shutdown() -> None:
    """Stop the controller (and its control-loop thread) and the proxy.
    Registered as a worker shutdown hook so a bare ray_tpu.shutdown()
    cannot leave the loop running against a dead runtime."""
    global _controller, _proxy
    from ray_tpu_torch.serve._private.long_poll import stop_all_clients
    stop_all_clients()
    with _client_lock:
        if _proxy is not None:
            _proxy.shutdown()
            _proxy = None
        if _controller is not None:
            try:
                ray_tpu.get(_controller.graceful_shutdown.remote())
                ray_tpu.kill(_controller)
            except Exception as e:
                logger.debug("controller shutdown failed: %s", e)
            _controller = None
