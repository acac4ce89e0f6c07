"""ray_tpu_torch.serve — model serving.

Reference: python/ray/serve/ — @serve.deployment + .bind() composition,
serve.run -> controller actor reconciling replica actors, DeploymentHandle
routing via power-of-two-choices, HTTP proxy, autoscaling on ongoing
requests (SURVEY §2.4).
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    http_port,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    deployment,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "batch",
    "DeploymentResponse",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "http_port",
    "run",
    "shutdown",
    "start",
    "status",
]
