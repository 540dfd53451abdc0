"""ray_tpu_torch.serve — model serving on actors (reference:
python/ray/serve/), the port of ``ray_tpu.serve``.

``serve.run`` deploys a bound class or function through the controller
actor, whose replicas are actors of the in-process runtime; a
``DeploymentHandle`` routes requests to them and ``start_http_proxy`` puts
an HTTP ingress in front. A replica started with
``ray_actor_options={"num_gpus": 1}`` holds a card, and with
``max_batch_size > 1`` it batches requests itself, padded to
``pad_batch_to`` buckets as ``@serve.batch`` does.
"""

from ray_tpu_torch.exceptions import (BatchExecutionError,  # noqa: F401
                                      ServeOverloadedError)
from ray_tpu_torch.serve.api import (Application, Deployment,  # noqa: F401
                                     delete, deployment,
                                     get_deployment_handle, run, shutdown,
                                     start, start_http_proxy, status)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.config import (AutoscalingConfig,  # noqa: F401
                                        DeploymentConfig)
from ray_tpu_torch.serve.handle import (DeploymentHandle,  # noqa: F401
                                        DeploymentResponse)

__all__ = ["deployment", "run", "start", "shutdown", "delete", "status",
           "batch", "start_http_proxy", "get_deployment_handle",
           "Application", "Deployment", "DeploymentHandle",
           "DeploymentResponse", "DeploymentConfig", "AutoscalingConfig",
           "ServeOverloadedError", "BatchExecutionError"]
